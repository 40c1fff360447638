"""Build native sources into shared libraries at first use.

Every library goes to `mcquic_tpu_torch/_build/` (listed in `.gitignore`),
named by a hash of its source, the shared headers beside it (`csrc/*.cuh`)
and its compiler command, so an edit of any of them rebuilds. The
compiler's report is kept beside it (`.log`: for the CUDA kernels, ptxas's
registers, shared memory and spills; `buildLog`). A failed build raises
with the compiler's stderr; nothing falls back to another implementation.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-DNDEBUG"]

_lock = threading.Lock()
_loaded = {}
_paths = {}


def findNvcc() -> str:
    """nvcc from $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    candidates = []
    cudaHome = os.environ.get("CUDA_HOME")
    if cudaHome:
        candidates.append(os.path.join(cudaHome, "bin", "nvcc"))
    onPath = shutil.which("nvcc")
    if onPath:
        candidates.append(onPath)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be built.")


def _libraryPath(stem: str, source: Path, command: List[str]) -> Path:
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update("\0".join(command).encode())
    return BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"


def buildShared(stem: str, source: Path, compiler: str, flags: List[str]) -> Path:
    """Compile `source` into a shared library unless the same build exists.

    Concurrent builders (pytest workers, several processes) each write a
    private temporary file and rename it into place, so a reader never sees
    a half-written library."""
    command = [os.path.basename(compiler), *flags]
    lib = _libraryPath(stem, source, command)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [compiler, *flags, str(source), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"Building {source.name} failed ({' '.join(cmd)}):\n"
                           f"{proc.stderr.strip()}\n{proc.stdout.strip()}")
    report = tmp.with_name(f"{tmp.name}.log")
    report.write_text(proc.stderr + proc.stdout)
    os.replace(report, lib.with_suffix(".log"))
    os.replace(tmp, lib)
    return lib


def loadLibrary(stem: str, source: Path, compiler: str, flags: List[str]) -> ctypes.CDLL:
    """Build (if needed) and load a library once per process. Builds of
    different libraries may run at the same time from several threads."""
    with _lock:
        if stem in _loaded:
            return _loaded[stem]
    path = buildShared(stem, source, compiler, flags)
    with _lock:
        _paths.setdefault(stem, path)
        return _loaded.setdefault(stem, ctypes.CDLL(str(path)))


def buildLog(stem: str) -> str:
    """The compiler's report of a library this process loaded ('' if none
    was kept)."""
    log = _paths[stem].with_suffix(".log")
    return log.read_text() if log.exists() else ""


def loadCudaLibrary(stem: str) -> ctypes.CDLL:
    """Build `csrc/<stem>.cu` with nvcc for sm_90a and load it."""
    return loadLibrary(stem, CSRC_DIR / f"{stem}.cu", findNvcc(), NVCC_FLAGS)


def checkCuda(lib: ctypes.CDLL, status: int, what: str):
    """Raise with the CUDA error string when a launcher returned non-zero."""
    if status != 0:
        lib.mcq_cuda_error_string.restype = ctypes.c_char_p
        lib.mcq_cuda_error_string.argtypes = [ctypes.c_int]
        message = lib.mcq_cuda_error_string(status).decode()
        raise RuntimeError(f"{what} failed: CUDA error {status} ({message})")
