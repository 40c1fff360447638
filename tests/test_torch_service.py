"""The web demo's handler (`mcquic_tpu_torch/service/stCompressService.py`)
against the JAX package's page (`mcquic_tpu/service/stCompressService.py`),
both driven on the CPU with the tiny demo model through a stub streamlit
(`tests/test_service.py`'s; streamlit is not installed here).

Held: for an uploaded PNG, WebP (with alpha) or CMYK JPEG, the `.mcq`
bytes offered equal the JAX page's (which are
`engine.compressImage(img).serialize()` of PIL's decode), and so does the
text shown; for an uploaded `.mcq`, whole or tiled, the restored PNG decodes to
the JAX page's restore, and the preview of either branch is its restore.
Both pages run the model in fp32, where the decoder's convolutions sum in a
different order in XLA and in torch: a restored value may land one level
away (RESTORE_LEVELS, on at most RESTORE_SHARE of the values; one value in
about 50000 here). tests/test_torch_engine.py holds the restore exactly in
fp64; an image past MAX_PIXELS is
refused with the JAX page's text; the port's own page, on the same stub,
shows and offers what `handleUpload` returns; `service.cli` is the stub the
reference's is.
"""
import importlib
import io
import sys

import numpy as np
import pytest
from PIL import Image

from mcquic_tpu_torch.data.png import decodePng, encodePng, readPng
from mcquic_tpu_torch.demo import loadModel
from mcquic_tpu_torch.service import cli as serviceCli
from mcquic_tpu_torch.service import stCompressService as service
from test_service import MODEL, _StubStreamlit, _Upload
from test_torch_cli import ROOT

PHOTO = readPng(ROOT / "assets" / "photo_768x512.png")
RESTORE_LEVELS = 1
RESTORE_SHARE = 1e-4


def _assertRestore(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    gap = np.abs(got.astype(int) - want.astype(int))
    assert gap.max() <= RESTORE_LEVELS and (gap > 0).mean() <= RESTORE_SHARE, gap.max()


@pytest.fixture(scope="module")
def engines():
    from mcquic_tpu.models.tiling import compressTiled
    stub = _StubStreamlit()
    patch = pytest.MonkeyPatch()
    patch.setitem(sys.modules, "streamlit", stub)
    patch.setenv("MCQUIC_MODEL", str(ROOT / MODEL))
    sys.modules.pop("mcquic_tpu.service.stCompressService", None)
    jaxPage = importlib.import_module("mcquic_tpu.service.stCompressService")
    tiled = compressTiled(jaxPage._engine(), PHOTO[:150, :200], tile=128).serialize()
    yield jaxPage, stub, loadModel(local=ROOT / MODEL, device="cpu"), tiled
    sys.modules.pop("mcquic_tpu.service.stCompressService", None)
    patch.undo()


def _jaxPage(jaxPage, stub, name, data):
    stub.reset(_Upload(name, data))
    jaxPage.main()
    return stub.texts, stub.downloads, stub.images, stub.errors


def test_an_image_compresses_to_the_jax_pages_mcq(engines):
    jaxPage, stub, engine, _ = engines
    data = encodePng(PHOTO[64:192, 128:320])
    texts, downloads, images, _ = _jaxPage(jaxPage, stub, "photo.png", data)
    answer = service.handleUpload(engine, "photo.png", data)
    assert downloads == [("Download .mcq", answer.data, "photo.mcq")] and answer.fileName == "photo.mcq"
    assert texts == [answer.text]
    _assertRestore(answer.preview, images[0])


def _upload(kind: str) -> bytes:
    crop = PHOTO[96:224, 160:352]
    buffer = io.BytesIO()
    if kind == "webp":
        alpha = (np.arange(crop.shape[1])[None].repeat(crop.shape[0], 0) % 256).astype(np.uint8)
        Image.fromarray(np.dstack([crop, alpha]), "RGBA").save(buffer, format="WEBP", quality=80)
    else:
        Image.fromarray(crop).convert("CMYK").save(buffer, format="JPEG", quality=95)
    return buffer.getvalue()


@pytest.mark.parametrize("kind,name", [("webp", "photo.webp"), ("cmyk", "photo.jpg")])
def test_a_webp_and_a_cmyk_jpeg_compress_to_the_jax_pages_mcq(engines, kind, name):
    jaxPage, stub, engine, _ = engines
    data = _upload(kind)
    texts, downloads, images, _ = _jaxPage(jaxPage, stub, name, data)
    answer = service.handleUpload(engine, name, data)
    assert downloads == [("Download .mcq", answer.data, "photo.mcq")] and answer.fileName == "photo.mcq"
    assert texts == [answer.text]
    _assertRestore(answer.preview, images[0])


@pytest.mark.parametrize("tiledFile", [False, True], ids=["whole", "tiled"])
def test_an_mcq_restores_as_the_jax_page_restores_it(engines, tiledFile):
    jaxPage, stub, engine, tiled = engines
    blob = tiled if tiledFile else engine.compressImage(PHOTO[:128, :128]).serialize()
    texts, downloads, images, _ = _jaxPage(jaxPage, stub, "x.mcq", blob)
    answer = service.handleUpload(engine, "x.mcq", blob)
    assert answer.fileName == "x.png" and texts == [answer.text]
    (label, theirs, name), = downloads
    assert name == "x.png"
    _assertRestore(decodePng(answer.data), np.asarray(Image.open(io.BytesIO(theirs))))
    np.testing.assert_array_equal(decodePng(answer.data), answer.preview)
    _assertRestore(answer.preview, images[0])
    assert answer.preview.shape == ((150, 200, 3) if tiledFile else (128, 128, 3))


def test_an_image_past_max_pixels_is_refused_with_the_jax_text(engines):
    jaxPage, stub, engine, _ = engines
    assert service.MAX_PIXELS == jaxPage.MAX_PIXELS == 3000 * 3000
    huge = encodePng(np.zeros((service.MAX_PIXELS // 100 + 1, 100, 3), np.uint8))
    _, _, _, errors = _jaxPage(jaxPage, stub, "huge.png", huge)
    with pytest.raises(service.TooLarge) as refusal:
        service.handleUpload(engine, "huge.png", huge)
    assert [str(refusal.value)] == errors == ["Image too large (> 9000000 pixels)."]


def test_the_page_shows_what_the_handler_returns(engines, monkeypatch):
    """The port's `main` on the stub: the texts, images and downloads of
    each branch, and the refusal as an error."""
    _, stub, engine, _ = engines
    monkeypatch.setattr(service, "_engine", lambda: engine)
    data = encodePng(PHOTO[:64, :64])
    answer = service.handleUpload(engine, "a.png", data)
    stub.reset(_Upload("a.png", data))
    service.main()
    assert stub.texts == [answer.text] and stub.downloads == [("Download .mcq", answer.data,
                                                               "a.mcq")]
    np.testing.assert_array_equal(stub.images[0], answer.preview)
    stub.reset(_Upload("a.mcq", answer.data))
    service.main()
    assert stub.downloads[0][0] == "Download restored PNG" and stub.downloads[0][2] == "a.png"
    monkeypatch.setattr(service, "MAX_PIXELS", 100)
    stub.reset(_Upload("a.png", data))
    service.main()
    assert stub.errors == ["Image too large (> 100 pixels)."] and not stub.downloads


def test_main_needs_streamlit_and_the_cli_is_a_stub(monkeypatch):
    monkeypatch.setitem(sys.modules, "streamlit", None)
    with pytest.raises(RuntimeError, match="Install streamlit to run the web demo."):
        service.main()
    with pytest.raises(NotImplementedError, match="streamlit run mcquic_tpu_torch/service/"):
        serviceCli.main()
