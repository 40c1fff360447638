"""The readings that the limits of `correct` are set from.

    python3 -m perfbench.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, in one process: the cell's set-up and a short window at its
own load, then the comparisons twice: once of the program's outputs (the
lower reading), once with the reference itself in TF32, the nearest
precision below the configuration's fp32, in the program's place (the
control, the upper reading). One JSON line per seed. The benchmark's own
runs never run this.
"""
import argparse
import gc
import json
import sys
import time


def readings(name: str, seed: int, seconds: float, device="cuda") -> dict:
    import torch
    from perfbench.harness import Cell, Run
    cell = Cell.named(name)
    run = Run(cell, seed, seconds, False, device, time.perf_counter())
    driver = cell.driver().Driver(run)
    driver.setup()
    driver.window()
    driver.release()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed, "attempted": run.attempted}
    for kind, control in (("program", False), ("control", True)):
        run.checks.clear()
        driver.check(control=control)
        out[kind] = {n: v for n, v, _ in run.checks}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
