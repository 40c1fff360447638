"""What the per-layer readers (`layers/<metric>.py`) share. Each returns
None where the run has nothing for it to read: no trace, no phase of that
name, no launch of the kernel, no work recorded."""
from typing import Optional, Sequence

from perfbench import count

K1 = ("vqNearestKernel", "vqUnpackKeysKernel")      # csrc/vq_encode.cu
K2 = ("thinHeadKernel",)                             # csrc/thin_head.cu
K3 = ("flashAttentionKernel", "mergeSplitsKernel")  # csrc/flash_attention.cu


def _phase(run, phase: Optional[str]) -> bool:
    return run.trace is not None and (phase is None or phase in run.trace.phases)


def roofline(run, phase: str, kernel: Sequence[str], key: str) -> Optional[float]:
    """% of the kernel's roofline over the phase: the least time its calls'
    operations and bytes allow (`count.bound`, summed over the calls) over
    the device time of its launches, found by name."""
    work = run.work.get(phase, {}).get(key)
    if not work or not _phase(run, phase):
        return None
    seconds, launches = run.trace.kernelSeconds(kernel, phase)
    if not launches:
        return None
    return 100.0 * sum(count.bound(f, b) for f, b in work) / seconds


def idleShare(run, phase: Optional[str]) -> Optional[float]:
    """% of the phase in which nothing ran on the device."""
    if not _phase(run, phase):
        return None
    start, end = run.trace.window(phase)
    return 100.0 * (1.0 - run.trace.busy(phase) / (end - start))


def mfu(run, phase: str) -> Optional[float]:
    """% of the card's peak: the reference's operations for the work of the
    phase over the phase's time at 495 TFLOP/s."""
    flops = run.work.get(phase, {}).get("flops")
    if not flops or not _phase(run, phase):
        return None
    start, end = run.trace.window(phase)
    return 100.0 * flops / ((end - start) * count.PEAK_FLOPS)


def spanMs(run, name: str) -> Optional[float]:
    """Mean ms of the benchmark's own span `name` per call."""
    spans = run.spans.get(name)
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
