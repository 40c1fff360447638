"""The web demo (counterpart of `mcquic_tpu/service/stCompressService.py`,
reference `mcquic/service/stCompressService.py`): upload an image and get its
`.mcq`, upload a `.mcq` and get the restored PNG.

`handleUpload(engine, name, data)` is the page's logic as a plain function,
branch for branch the JAX page's (`:38-66`):
  * a name ending in `.mcq` is restored, tiled (`TiledFile.isTiled`) or
    whole, and offered as a PNG (`data/png.py::encodePng`) under the
    upload's stem;
  * anything else is read as an image by the package's decoders
    (`data/dataset.py`: PNG, JPEG, BMP, WebP); an image of more than MAX_PIXELS
    pixels is refused with the JAX page's text, the others are compressed,
    offered as `.mcq` bytes and previewed as restored.
It returns the text shown, the bytes offered, their file name and the
preview. The engine comes from `_engine()`: MCQUIC_MODEL names a local
exported model, else the zoo slot MCQUIC_QP (default 2), on the card.

    streamlit run mcquic_tpu_torch/service/stCompressService.py

streamlit is looked up by `main` only; without it `main` raises.
"""
import functools
import importlib
import os
from pathlib import Path
from typing import NamedTuple

import numpy as np

from mcquic_tpu_torch.container import File
from mcquic_tpu_torch.data.dataset import _decodeImage
from mcquic_tpu_torch.data.png import encodePng
from mcquic_tpu_torch.demo import loadModel
from mcquic_tpu_torch.models.tiling import TiledFile, decompressTiled

MAX_PIXELS = 3000 * 3000  # HF-space style size guard (reference :112-121)


class TooLarge(ValueError):
    """An uploaded image of more than MAX_PIXELS pixels."""


class Answer(NamedTuple):
    text: str               # what the page shows: the container's description
    data: bytes             # the download offered: a `.mcq` or a PNG
    fileName: str
    preview: np.ndarray     # the restored image, uint8 [H, W, 3]


@functools.lru_cache(maxsize=1)
def _engine():
    local = os.environ.get("MCQUIC_MODEL")
    qp = int(os.environ.get("MCQUIC_QP", "2"))
    return loadModel(qp=qp, local=local, device="cuda")


def handleUpload(engine, name: str, data: bytes) -> Answer:
    """One upload through the engine; raises `TooLarge` for an image past
    MAX_PIXELS and RuntimeError for one that does not decode."""
    stem = Path(name).stem
    if name.endswith(".mcq"):
        if TiledFile.isTiled(data):
            container = TiledFile.deserialize(data)
            restored = decompressTiled(engine, container)
        else:
            container = File.deserialize(data)
            restored = engine.decompressImage(container)
        return Answer(str(container), encodePng(restored), stem + ".png", restored)
    img = _decodeImage(data, name)
    if img is None:
        raise RuntimeError(f"Cannot decode {name}")
    if img.shape[0] * img.shape[1] > MAX_PIXELS:
        raise TooLarge(f"Image too large (> {MAX_PIXELS} pixels).")
    file = engine.compressImage(img)
    return Answer(str(file), file.serialize(), stem + ".mcq", engine.decompressImage(file))


def main():
    # streamlit is the page's own dependency, not the package's: it is looked
    # up when the page runs, and nothing else of the package needs it
    try:
        st = importlib.import_module("streamlit")
    except ImportError as e:
        raise RuntimeError("Install streamlit to run the web demo.") from e
    st.title("McQuic-TPU — neural image codec")
    upload = st.file_uploader("Image (png/jpg) to compress, or .mcq to restore")
    if upload is None:
        return
    try:
        answer = handleUpload(_engine(), upload.name, upload.read())
    except TooLarge as e:
        st.error(str(e))
        return
    st.text(answer.text)
    if answer.fileName.endswith(".png"):
        st.image(answer.preview)
        st.download_button("Download restored PNG", answer.data, file_name=answer.fileName)
    else:
        st.download_button("Download .mcq", answer.data, file_name=answer.fileName)
        st.image(answer.preview, caption="decoded preview")


if __name__ == "__main__":
    main()
