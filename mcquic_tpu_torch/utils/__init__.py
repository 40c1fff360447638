"""Host utilities: device selection, the fp32 numerics guard, the version
gate for `.mcq` files and file hashing."""
import contextlib
import hashlib

import torch

__all__ = ["resolveDevice", "exactFp32", "versionCheck", "hashOfFile"]


def resolveDevice(device="cuda") -> torch.device:
    """The device an entry point runs on. CUDA is the default; asking for it
    where there is none raises instead of going on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for but torch.cuda.is_available() is "
                           "False; pass device='cpu' (--device cpu) to run on the CPU.")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"Unsupported device {device}")
    return device


@contextlib.contextmanager
def exactFp32(deterministic: bool = False):
    """fp32 convolutions and matmuls with TF32 off, for the duration of a call.
    With `deterministic`, cuDNN times and runs only its deterministic
    algorithms: the trainers' steps, so that a run repeats bit for bit in
    one process (`chip_smoke.py` phase 12 holds the NCCL run to the one
    without a process group).

    cuDNN runs fp32 convolutions in TF32 by default, which flips near-tie
    codes against the reference. cuDNN also times its candidate algorithms
    once per shape (`benchmark`): without that, its heuristic picks an FFT
    algorithm for some fp32 convolutions at 192 channels that launches one
    small complex GEMM per frequency, about 33,000 launches per convolution,
    which made a qp-12 encode 1.9 s of device time at batch 1 on the H100.
    `cudnn.flags` restores the previous settings on exit; its `enabled`
    defaults to False, so it is passed explicitly.
    """
    matmulTf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                        deterministic=deterministic, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmulTf32


def _parseVersion(v: str):
    try:
        return tuple(int(p) for p in v.split(".")[:3])
    except ValueError as e:
        raise ValueError(f"Cannot parse version string `{v}`.") from e


def versionCheck(versionStr: str) -> bool:
    """Major versions must match; an artifact from a newer minor version
    raises (the policy of `mcquic_tpu/utils/__init__.py::versionCheck`)."""
    from mcquic_tpu_torch import __version__
    mine = _parseVersion(__version__)
    theirs = _parseVersion(versionStr)
    if theirs[0] != mine[0]:
        raise ValueError(f"Version mismatch: artifact created by {versionStr}, library is {__version__}.")
    if theirs[:2] > mine[:2]:
        raise ValueError(f"Artifact from a newer library ({versionStr} > {__version__}); please upgrade.")
    return True


def hashOfFile(path) -> str:
    sha256 = hashlib.sha256()
    with open(path, "rb") as fp:
        for chunk in iter(lambda: fp.read(1 << 20), b""):
            sha256.update(chunk)
    return sha256.hexdigest()
