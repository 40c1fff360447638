"""Build the native rANS runtime (csrc/mcquic_rans.cpp) with g++ into
`mcquic_tpu_torch/_build/` at first use. A failed build raises."""
import shutil

from mcquic_tpu_torch.utils.build import CSRC_DIR, GXX_FLAGS, loadLibrary

SOURCE = CSRC_DIR / "mcquic_rans.cpp"


def loadRansLibrary():
    compiler = shutil.which("g++")
    if compiler is None:
        raise RuntimeError("g++ not found; the rANS runtime cannot be built.")
    return loadLibrary("mcquic_rans", SOURCE, compiler, GXX_FLAGS)
