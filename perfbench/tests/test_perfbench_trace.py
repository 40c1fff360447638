"""The trace's reductions on a timeline worked out by hand."""
import pytest

from perfbench.trace import Trace, _notWork


def timeline() -> Trace:
    device = [("gemm", 0.0, 1.0), ("copy", 0.5, 1.5), ("gemm", 2.0, 3.0), ("add", 5.0, 6.0)]
    host = [("outer", 0.5, 4.0), ("inner", 1.6, 1.9), ("late", 4.5, 5.5)]
    return Trace(device, {"all": (0.0, 7.0), "tail": (2.5, 7.0)}, host)


def test_busy_is_the_union_of_device_intervals():
    trace = timeline()
    assert trace.busy() == pytest.approx(3.5)          # [0, 1.5] + [2, 3] + [5, 6]
    assert trace.busy("tail") == pytest.approx(1.5)    # [2.5, 3] + [5, 6]


def test_kernel_seconds_and_top_ops_by_name():
    trace = timeline()
    assert trace.kernelSeconds(["gemm"]) == (pytest.approx(2.0), 2)
    assert trace.topOps(2) == [["gemm", pytest.approx(2.0)], ["copy", pytest.approx(1.0)]]


def test_idle_gaps_are_named_by_the_innermost_host_operation():
    gaps = dict(timeline().idleGaps())
    # (1.5, 2) at 1.75 in `inner`, (3, 5) at 4 at the end of `outer`, (6, 7) in none
    assert gaps == {"inner": pytest.approx(0.5), "outer": pytest.approx(2.0),
                    "host: Python between operations": pytest.approx(1.0)}


def test_annotations_and_runtime_calls_are_not_device_work():
    assert _notWork("perfbench.compress") and _notWork("cudaLaunchKernel")
    assert _notWork("Context Sync") and not _notWork("vqNearestKernel(Args)")
