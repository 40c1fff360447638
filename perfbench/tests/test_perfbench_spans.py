"""The readers of the program's spans (`perfbench/spans.py`, seven files in
`perfbench/layers/`) on a timeline worked out by hand, and on a traced run
of each cell at a small width on the CPU."""
import sys
from types import SimpleNamespace

import pytest

from perfbench import spans
from perfbench.harness import HERE, execute, loadModule
from perfbench.tests.conftest import tinyCell
from perfbench.trace import Trace

B = 1_700_000_000.0          # seconds since the epoch, as the profiler's clock reads
READERS = ("dispatch_ms.compress", "dispatch_ms.decompress", "rans_ms.compress",
           "rans_ms.decompress", "sample_enqueue_ms.generate", "launches.generate",
           "idle_in_sampling.generate")


def record(name, start, end):
    """A span of the program's, its ends given in seconds after B."""
    return SimpleNamespace(name=name, start=int(B) * 10**9 + round(start * 1e9),
                           end=int(B) * 10**9 + round(end * 1e9))


SPANS = [
    record("engine.encodeDispatch", 1.0, 1.002), record("engine.ransEncode", 2.0, 2.010),
    record("engine.encodeDispatch", 3.0, 3.004), record("engine.ransEncode", 4.0, 4.030),
    record("engine.encodeDispatch", 50.0, 50.5),             # in no phase
    record("engine.ransDecode", 11.5, 11.508),
    record("engine.decodeDispatch", 11.0, 11.001), record("engine.decodeDispatch", 12.0, 12.003),
    record("engine.decodeDispatch", 13.0, 13.005),
    record("engine.encodeDispatch", 14.0, 14.1),             # in another phase than its own
    record("generator.sampleCodes", 21.0, 23.0), record("generator.sampleCodes", 25.0, 26.0),
]
EXPECTED = {
    # less the waits on a full launch queue: 1 ms inside the second batch;
    # 1 of 8 ms inside the third decode, the rest after it
    "dispatch_ms.compress": 2.5, "rans_ms.compress": 20.0,
    "dispatch_ms.decompress": 2.6667, "rans_ms.decompress": 8.0,
    "sample_enqueue_ms.generate": 1500.0,
    "launches.generate": 1.5,            # three launches inside the two calls
    # busy [20, 22.5], [25.5, 30], [35, 40]: idle (22.5, 25.5) and (30, 35), 8 s;
    # the calls [21, 23] and [25, 26] hold 0.5 + 0.5 s of it
    "idle_in_sampling.generate": 12.5,
}


def timeline() -> Trace:
    device = [("gemm", B + 20.0, B + 22.0), ("copy", B + 21.5, B + 22.5),
              ("gemm", B + 25.5, B + 30.0), ("conv", B + 35.0, B + 41.0)]
    host = [("aten::mm", B + 21.2, B + 21.3), ("cudaLaunchKernel", B + 21.5, B + 21.51),
            ("cuLaunchKernel", B + 22.0, B + 22.01), ("cudaLaunchKernelExC", B + 25.5, B + 25.6),
            ("cudaLaunchKernel", B + 24.0, B + 24.01),            # between the calls
            ("Command Buffer Full", B + 3.001, B + 3.002),
            ("Command Buffer Full", B + 12.002, B + 12.010),
            ("Command Buffer Full", B + 1.5, B + 1.6)]            # outside the spans
    phases = {"compress": (B, B + 10.0), "decompress": (B + 10.0, B + 20.0),
              "generate": (B + 20.0, B + 40.0)}
    return Trace(device, phases, host)


def reader(name):
    return loadModule(HERE / "layers" / f"{name}.py").read


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_its_spans_inside_the_phase(monkeypatch, name):
    monkeypatch.setattr(spans, "recorded", lambda: SPANS)
    value = reader(name)(SimpleNamespace(trace=timeline()))
    assert value == pytest.approx(EXPECTED[name], abs=1e-4)


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_nothing_without_spans_in_the_phase(monkeypatch, name):
    run = SimpleNamespace(trace=timeline())
    monkeypatch.setattr(spans, "recorded", lambda: [])
    assert reader(name)(run) is None
    later = [SimpleNamespace(name=s.name, start=s.start + 100 * 10**9, end=s.end + 100 * 10**9)
             for s in SPANS]
    monkeypatch.setattr(spans, "recorded", lambda: later)
    assert reader(name)(run) is None
    assert reader(name)(SimpleNamespace(trace=None)) is None


def test_a_program_without_spans_gives_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "mcquic_tpu_torch.utils.tracing", None)   # import fails
    assert spans.recorded() == []
    assert reader("dispatch_ms.compress")(SimpleNamespace(trace=timeline())) is None


def test_interval_helpers():
    assert spans.union([(3, 4), (0, 1), (0.5, 2), (2, 2.5)]) == [(0, 2.5), (3, 4)]
    assert spans.overlap([(0, 2), (3, 5)], [(1, 4)]) == pytest.approx(2.0)
    assert spans.overlap([], [(1, 4)]) == 0.0


@pytest.mark.parametrize("cell, names", [
    ("qp2-photos-b10", READERS[:4]),
    ("a800gen16-generate-b8", READERS[4:]),
])
def test_a_traced_run_reads_the_programs_spans(cell, names):
    result = execute(tinyCell(cell), 2**35 + 9, 1.0, True, "cpu")
    assert result["correct"], result["checks"]
    for name in names:
        assert name in result["metrics"], (name, sorted(result["metrics"]))
    metrics = {n: result["metrics"][n]["value"] for n in names}
    assert all(v >= 0 for v in metrics.values()), metrics
    assert all(not n.startswith(("engine.", "generator."))
               for n, _ in result["breakdown"]["device_ops"] + result["breakdown"]["idle_gaps"])
