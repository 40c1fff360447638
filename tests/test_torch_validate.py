"""The port's validation path against the JAX package's: metrics, the
metric half of the losses, the loader, the handlers, `Validator.validate`
and the `validate` CLI's export.

Tolerances: SSIM and MS-SSIM within 1e-5 and PSNR within 1e-4 dB. Both
packages compute the metrics in fp32, with depthwise convolutions and sums
that run in another order in XLA and in PyTorch, so they agree to fp32
rounding over a few thousand terms, not bit for bit. Codes, bpp and the
restored images are held exactly: `Validator.validate` runs both models in
fp64.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcquic_tpu import loss as jaxLoss
from mcquic_tpu.validate import metrics as jaxMetrics
from mcquic_tpu_torch import loss
from mcquic_tpu_torch.data import getValLoader
from mcquic_tpu_torch.data.png import readPng, writePng
from mcquic_tpu_torch.models.engine import CompressorEngine
from mcquic_tpu_torch.utils import convert
from mcquic_tpu_torch.validate import metrics
from mcquic_tpu_torch.validate.cli import loadEngine
from mcquic_tpu_torch.validate.validator import Validator, visualizeCodeMaps

ROOT = Path(__file__).resolve().parent.parent
TINY = ROOT / "assets" / "tiny_demo_672919fb.mcquic.npz"
PHOTO = ROOT / "assets" / "photo_768x512.png"
SSIM_ATOL = 1e-5
PSNR_ATOL = 1e-4


def _pair(n, h, w, seed):
    """Two uint8-valued float NHWC batches, the second a noisy copy."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=(n, h, w, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 20, size=x.shape), 0, 255).round().astype(np.float32)
    return x, y


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("n,h,w", [(2, 64, 80), (1, 200, 180), (1, 33, 40)])
def test_metrics_match_jax(n, h, w):
    x, y = _pair(n, h, w, seed=h)
    for name, atol in (("ssim", SSIM_ATOL), ("msSSIM", SSIM_ATOL), ("psnr", PSNR_ATOL)):
        ours, theirs = getattr(metrics, name), getattr(jaxMetrics, name)
        for average in (True, False):
            got = ours(_nchw(x), _nchw(y), sizeAverage=average).numpy()
            want = np.asarray(theirs(jnp.asarray(x), jnp.asarray(y), sizeAverage=average))
            assert got.shape == want.shape, name
            np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)
    assert float(metrics.psnr(_nchw(x), _nchw(x))) == pytest.approx(10 * np.log10(255.0 ** 2 / 1e-12))


def test_loss_metric_half_matches_jax():
    x, y = _pair(2, 64, 64, seed=1)
    x, y = x / 127.5 - 1, y / 127.5 - 1                          # images in [-1, 1]
    for name, atol in (("MsSSIM", SSIM_ATOL), ("PSNR", 1e-7)):
        ours, theirs = getattr(loss, name)(), getattr(jaxLoss, name)()
        got = float(ours(_nchw(x), _nchw(y)))
        want = float(theirs(jnp.asarray(x), jnp.asarray(y)))
        assert got == pytest.approx(want, abs=atol), name
        assert float(ours.formatDistortion(torch.tensor(got))) == pytest.approx(
            float(theirs.formatDistortion(jnp.asarray(got))), rel=1e-6), name
    codebooks = [np.random.default_rng(2).normal(size=(2, 40, 8)).astype(np.float32)]
    for gamma in (0.0, 0.5):
        got = float(loss.BasicRate(gamma)(None, [torch.from_numpy(c) for c in codebooks]))
        want = float(jaxLoss.BasicRate(gamma)(None, [jnp.asarray(c) for c in codebooks]))
        assert got == pytest.approx(want, rel=1e-5)


@pytest.fixture(scope="module")
def valFolder(tmp_path_factory):
    """Two photo crops (one of them 300 x 270, cropped to 256 x 256 by the
    loader), and a 100 x 100 image the loader skips."""
    folder = tmp_path_factory.mktemp("val")
    photo = readPng(PHOTO)
    writePng(folder / "a.png", photo[100:400, 200:470])
    writePng(folder / "b.png", photo[:256, 500:756])
    writePng(folder / "small.png", photo[:100, :100])
    return folder


def test_val_loader_matches_jax(valFolder):
    from mcquic_tpu.data import getValLoader as jaxGetValLoader
    ours, theirs = list(getValLoader(str(valFolder))()), list(jaxGetValLoader(str(valFolder))())
    assert [stem for _, stem in ours] == [stem for _, stem in theirs] == ["a", "b"]
    for (a, _), (b, _) in zip(ours, theirs):
        assert a.shape == (1, 256, 256, 3)
        np.testing.assert_array_equal(a, b)


def test_val_loader_skips_what_it_cannot_decode(tmp_path, caplog):
    """JPEGs, BMPs and WebPs are read as the JAX loader reads them, a CMYK
    JPEG among them; a corrupt JPEG raises (`Cannot decode`, as the JAX
    `BasicFolder`), and a progressive one whose scans leave bits unsent is
    read as the JAX loader reads it (libjpeg smooths its blocks)."""
    import io
    from PIL import Image
    from mcquic_tpu.data import getValLoader as jaxGetValLoader
    photo = readPng(PHOTO)
    writePng(tmp_path / "a.png", photo[:256, :300])
    Image.fromarray(photo[100:400, 200:520]).save(tmp_path / "b.jpg", quality=92)
    Image.fromarray(photo[200:460, :256]).save(tmp_path / "c.jpeg", quality=95, subsampling=0)
    Image.fromarray(photo[100:400, 300:600]).save(tmp_path / "d.bmp")
    Image.fromarray(photo[150:420, 260:560]).save(tmp_path / "e.webp", quality=75)
    Image.fromarray(photo[210:480, 40:330]).convert("CMYK").save(tmp_path / "g.jpg", quality=95)
    theirs = list(jaxGetValLoader(str(tmp_path))())
    with caplog.at_level("WARNING"):
        got = list(getValLoader(str(tmp_path))())
    assert [stem for _, stem in got] == [stem for _, stem in theirs] == ["a", "b", "c", "d", "e", "g"]
    for (x, _), (y, _) in zip(got, theirs):
        np.testing.assert_array_equal(x, y)
    assert "e.webp" not in caplog.text and "d.bmp" not in caplog.text
    (tmp_path / "f.jpg").write_bytes(b"\xff\xd8\xff\xe0\x00\x10JFIF")
    with pytest.raises(RuntimeError, match="Cannot decode .*f.jpg"):
        list(getValLoader(str(tmp_path))())
    progressive = io.BytesIO()
    Image.fromarray(photo[:256, :256]).save(progressive, format="JPEG", progressive=True)
    data = progressive.getvalue()
    (tmp_path / "f.jpg").write_bytes(data[:data.rindex(b"\xff\xda")] + b"\xff\xd9")
    got, theirs = list(getValLoader(str(tmp_path))()), list(jaxGetValLoader(str(tmp_path))())
    assert [stem for _, stem in got] == [stem for _, stem in theirs]
    for (x, _), (y, _) in zip(got, theirs):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def validated(valFolder):
    """`Validator.validate` of the tiny demo model, fp64, in both packages."""
    from mcquic_tpu.data import getValLoader as jaxGetValLoader
    from mcquic_tpu.models.compressor import Compressor as JaxCompressor
    from mcquic_tpu.models.engine import CompressorEngine as JaxEngine
    from mcquic_tpu.train.saver import loadTree, upcastBf16
    from mcquic_tpu.validate.validator import Validator as JaxValidator
    tree, meta = loadTree(TINY)
    tree = upcastBf16(tree)
    geometry = meta["config"]["model"]["params"]
    module = JaxCompressor(channel=geometry["channel"], m=geometry["m"], k=tuple(geometry["k"]),
                           dtype=jnp.float64)
    with jax.enable_x64():
        jaxEngine = JaxEngine(module, {"params": tree["params"], "coder": tree["coder"]}, qp="tiny")
        jaxValidator = JaxValidator(jaxEngine)
        theirs = jaxValidator.validate(jaxGetValLoader(str(valFolder)))
    engine, _, _ = loadEngine(TINY, device="cpu")
    validator = Validator(CompressorEngine(engine.model.double(), qp="tiny", device="cpu"))
    ours = validator.validate(getValLoader(str(valFolder)))
    return ours, theirs, validator, jaxValidator


def test_validate_matches_jax(validated):
    ours, theirs, _, _ = validated
    assert ours["images"] == theirs["images"] == 2
    assert ours["bpp"] == theirs["bpp"] > 0
    assert ours["idealBpp"] == pytest.approx(theirs["idealBpp"], rel=1e-12)
    assert ours["psnr"] == pytest.approx(theirs["psnr"], abs=PSNR_ATOL)
    assert ours["msssim"] == pytest.approx(theirs["msssim"], abs=SSIM_ATOL)


def test_validate_collects_the_same_images_and_code_maps(validated):
    _, _, validator, jaxValidator = validated
    from mcquic_tpu.validate.validator import visualizeCodeMaps as jaxVisualize
    pairs, jaxPairs = validator.collected["pairs"], jaxValidator.collected["pairs"]
    assert len(pairs) == len(jaxPairs) == 2
    for (a, b), (c, d) in zip(pairs, jaxPairs):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    codes = validator.collected["codes"]
    for ours, theirs in zip(visualizeCodeMaps(codes), jaxVisualize(jaxValidator.collected["codes"])):
        assert ours.dtype == np.uint8 and ours.shape[-1] == 3
        np.testing.assert_array_equal(ours, theirs)


def test_float32_to_bf16_matches_ml_dtypes():
    import ml_dtypes
    rng = np.random.default_rng(0)
    values = np.concatenate([rng.normal(size=4096) * 10.0 ** rng.integers(-30, 30, 4096),
                             [0.0, -0.0, np.inf, -np.inf, 1e-40, 1.00390625, 1.01171875]])
    values = values.astype(np.float32)
    np.testing.assert_array_equal(convert.float32ToBf16(values),
                                  values.astype(ml_dtypes.bfloat16).view(np.uint16))


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_validate_cli_export_loads_in_jax(tmp_path, monkeypatch, capsys, valFolder, bf16):
    """`python -m mcquic_tpu_torch validate -e` writes a deploy model that
    the JAX package's `loadAnyCheckpoint` reads back (bf16 as `key@bf16`),
    before the speed run; the speed run here is cut to one small call."""
    import ml_dtypes
    from mcquic_tpu.validate.cli import loadAnyCheckpoint
    from mcquic_tpu_torch.cli import main
    speed = Validator.speed
    monkeypatch.setattr(Validator, "speed", lambda self: speed(self, iters=1, batch=1, h=128, w=128))
    args = ["validate", "--device", "cpu", "-e", str(tmp_path / "out.npz"), str(TINY),
            str(valFolder)]
    assert main(args + (["--bf16"] if bf16 else [])) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    results, exported, timed = json.loads(lines[0]), Path(lines[1]), json.loads(lines[2])
    assert results["images"] == 2 and results["bpp"] > 0
    assert timed["device"] == "cpu" and timed["encodeMpps"] > 0 and timed["decodeMpps"] > 0
    assert exported.name.startswith("out_") and exported.name.endswith(".mcquic.npz")
    assert exported.with_suffix(".json").exists()

    variables, config, meta = loadAnyCheckpoint(exported)
    assert meta["qp"] == "tiny" and config.serialize()["model"]["params"]["k"] == [1024, 512]
    flat, _ = convert.readExport(TINY)
    got = {"params": variables["params"], "coder": variables["coder"]}

    def leaves(tree, prefix=""):
        for key, value in tree.items():
            if isinstance(value, dict):
                yield from leaves(value, f"{prefix}{key}/")
            else:
                yield prefix + key, np.asarray(value)

    seen = 0
    for key, value in leaves(got):
        want = flat[key]
        if bf16 and key.startswith("params/"):
            want = want.astype(ml_dtypes.bfloat16).astype(np.float32)
        np.testing.assert_array_equal(value, want, err_msg=key)
        seen += 1
    assert seen == len(flat)
    with np.load(exported) as z:
        assert any(k.endswith("@bf16") for k in z.files) == bf16
        assert not any(k.startswith("coder/") and k.endswith("@bf16") for k in z.files)
