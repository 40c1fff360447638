"""Run one cell of the benchmark once and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. `--trace 0` prints the cell's end-to-end
metrics, measured with no profiler attached; `--trace 1` runs the same
traffic under `torch.profiler` and prints its per-layer metrics. The last
line of standard output is the result (JSON); the last lines of standard
error are the numbers held to the plain reference, each with its limit.
A run needs as many CUDA cards as the cell asks for, and fails without.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def powerLimit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from perfbench.harness import Cell, execute, loadedForbidden
    cell = Cell.named(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", STARTED)
    if args.trace:
        checks = result.pop("checks")
        result["card"] = powerLimit()
        result["checks"] = checks
    found = loadedForbidden()
    if found:
        print(f"the run loaded {found}: the benchmark measures the PyTorch port alone",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
