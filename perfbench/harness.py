"""One run of one cell: find its pieces by name, run its driver, reduce,
check, and assemble the result line.

Everything is found by name, so that a cell, a configuration, a traffic mix
or a per-layer metric is added as files and entries, never by an edit:
  * `BENCHMARK.json` names the cell's configuration, its traffic and its
    chips, and which metrics it reports;
  * `perfbench/configs/<config>.json` holds the configuration;
  * `perfbench/traffic/<traffic>.json` holds the traffic mix's parameters
    and names its driver, `perfbench/drivers/<driver>.py`, which builds the
    program and the inputs from the seed, warms up, drives the window and
    holds the outputs to the plain reference;
  * `perfbench/layers/<metric>.py` reads one per-layer metric (`read(run)`,
    None where the run has nothing for it to read).
"""
import contextlib
import gc
import importlib.util
import json
import sys
import time
from collections import defaultdict
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mcquic_tpu")


def loadModule(path: Path) -> ModuleType:
    """A module of the benchmark by its file; names may hold dots."""
    spec = importlib.util.spec_from_file_location(
        "perfbench._found." + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """A cell of `BENCHMARK.json` with its configuration, traffic and metrics."""

    def __init__(self, name: str, benchmark: dict):
        cells = {w["name"]: w for w in benchmark["workloads"]}
        if name not in cells:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(cells)})")
        entry = cells[name]
        configs = {c["name"]: c for c in benchmark["configs"]}
        self.name, self.chips = name, int(entry["chips"])
        self.configName, self.trafficName = entry["config"], entry["traffic"]
        self.config = json.loads((ROOT / configs[self.configName]["file"]).read_text())
        self.traffic = json.loads((HERE / "traffic" / f"{self.trafficName}.json").read_text())

        def mine(metric):
            return name in metric.get("workloads", [name])
        self.endToEnd = [m for m in benchmark["end_to_end"] if mine(m)]
        self.perLayer = [m for m in benchmark["per_layer"] if mine(m)]

    @classmethod
    def named(cls, name: str) -> "Cell":
        return cls(name, json.loads(BENCHMARK.read_text()))

    def driver(self) -> ModuleType:
        return loadModule(HERE / "drivers" / f"{self.traffic['driver']}.py")


class Run:
    """What a driver fills and the per-layer readers read."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float):
        self.config, self.traffic = cell.config, cell.traffic
        self.seed, self.seconds, self.traceOn, self.device = seed, seconds, trace, device
        self.t0 = t0
        self.setupSeconds: Optional[float] = None
        self.endToEnd: Dict[str, float] = {}
        self.spans: Dict[str, List[float]] = defaultdict(list)
        self.work: Dict[str, dict] = {}
        self.checks: List[tuple] = []
        self.attempted = 0
        self.failed = 0
        self.tracer = None
        self.trace = None

    def startWindow(self):
        """The first timed request is about to go: set-up ends here, and the
        peak of device memory is counted from here (set-up's workspace, such
        as cuDNN's search, is not what the traffic holds)."""
        if self.setupSeconds is None:
            self.setupSeconds = time.perf_counter() - self.t0
            import torch
            if torch.device(self.device).type == "cuda":
                torch.cuda.synchronize(self.device)
                torch.cuda.reset_peak_memory_stats(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        """A part of the window, annotated in the trace as `perfbench.<name>`."""
        if self.tracer is None:
            yield
            return
        from torch.profiler import record_function
        with record_function(f"perfbench.{name}"):
            yield

    def synchronize(self):
        import torch
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    def check(self, name: str, value: float, limit: float):
        """One number compared, with its limit: correct while value <= limit."""
        self.checks.append((name, float(value), float(limit)))


def loadedForbidden() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
            t0: float = None) -> dict:
    """Run the cell once and return its result line (a dict)."""
    import torch
    from perfbench.trace import Tracer
    run = Run(cell, seed, seconds, trace, device, time.perf_counter() if t0 is None else t0)
    driver = cell.driver().Driver(run)
    driver.setup()
    run.tracer = Tracer() if trace else None
    with run.tracer or contextlib.nullcontext():
        driver.window()
    run.synchronize()
    isCuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if isCuda else 0    # since startWindow
    if trace:
        run.trace = run.tracer.trace()
    driver.release()
    gc.collect()
    if isCuda:
        torch.cuda.empty_cache()
    driver.check()
    correct = bool(run.checks) and all(v <= limit for _, v, limit in run.checks)

    metrics = {}
    if trace:
        for metric in cell.perLayer:
            value = loadModule(HERE / "layers" / f"{metric['name']}.py").read(run)
            if value is not None:
                metrics[metric["name"]] = {"value": float(value), "unit": metric["unit"]}
    else:
        values = dict(run.endToEnd, setup_s=run.setupSeconds)
        for metric in cell.endToEnd:
            if values.get(metric["name"]) is None:
                raise RuntimeError(f"the driver measured no {metric['name']}")
            metrics[metric["name"]] = {"value": float(values[metric["name"]]),
                                       "unit": metric["unit"]}
    deviceInfo = {"platform": "gpu" if isCuda else "cpu",
                  "kind": torch.cuda.get_device_name(device) if isCuda else "cpu",
                  "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": deviceInfo}
    if trace:
        deviceInfo["window_s"] = run.trace.window()[1] - run.trace.window()[0]
        deviceInfo["busy_s"] = run.trace.busy()
        result["breakdown"] = {"device_ops": run.trace.topOps(), "idle_gaps": run.trace.idleGaps()}
    result["checks"] = {name: {"value": v, "limit": limit} for name, v, limit in run.checks}
    return result
