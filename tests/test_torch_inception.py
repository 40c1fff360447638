"""The Inception Score of the port against the JAX package's
(`mcquic_tpu/validate/inception.py`, `inception_v3.py`), on the CPU.

No InceptionV3 weights are in the repository, so both networks load one
numpy-seeded state dict in torchvision's layout
(`validate/inception_v3.py::seededStateDict`). The score depends on the
weights, what is compared does not.
"""
import numpy as np
import pytest
import torch
from PIL import Image

from mcquic_tpu.validate import inception_v3 as jaxV3
from mcquic_tpu.validate.inception import InceptionScoreHandler as JaxHandler
from mcquic_tpu_torch.validate import inception_v3 as v3
from mcquic_tpu_torch.validate.inception import InceptionScoreHandler, resizeBilinear

# logits, fp32 both sides (XLA's and oneDNN's convolutions sum in other
# orders): relative to the largest logit's magnitude
LOGITS_RTOL = 1e-4
IS_RTOL = 1e-5
BATCH = 2


@pytest.mark.parametrize("edge", [256, 512, 200])
def test_resize_is_pils_bilinear(edge):
    """256 -> 299 (upscaling, support 1), 512 -> 299 (downscaling, the
    support widened by the scale) and a non-square 200 x 333 image: at most
    1 level from PIL's `BILINEAR`; the count of differing values is printed
    and is 0 on these images."""
    rng = np.random.default_rng(edge)
    height, width = edge, edge if edge != 200 else 333
    smooth = rng.integers(0, 256, (3, height // 8 + 1, width // 8 + 1, 3)).astype(np.float64)
    images = np.stack([np.repeat(np.repeat(s, 8, 0), 8, 1)[:height, :width] for s in smooth])
    images[1] = rng.integers(0, 256, images[1].shape)          # noise: every weight matters
    images = images.astype(np.uint8)
    want = np.stack([np.asarray(Image.fromarray(im).resize((299, 299), Image.BILINEAR))
                     for im in images])
    got = resizeBilinear(images).numpy()
    assert got.shape == want.shape == (3, 299, 299, 3) and got.dtype == np.uint8
    gap = np.abs(got.astype(np.int16) - want.astype(np.int16))
    print(f"resize {height}x{width} -> 299: {int((gap > 0).sum())} of {gap.size} values differ, "
          f"max {int(gap.max())}")
    assert gap.max() <= 1
    assert int((gap > 0).sum()) == 0


@pytest.fixture(scope="module")
def networks():
    sd = v3.seededStateDict()
    jaxParams = jaxV3.convertTorchInception({k: v.numpy() for k, v in sd.items()})
    model = v3.inceptionFromStateDict(sd, "cpu")
    return sd, jaxParams, model


def test_inception_logits_equal_the_jax_network(networks):
    """The same uint8 batch of 2 through the flax InceptionV3 and the port's,
    fp32: logits within LOGITS_RTOL of the largest; the folded scale and
    shift equal the JAX converter's bit for bit."""
    import jax
    sd, jaxParams, model = networks
    state = model.state_dict()
    for prefix in ("Conv2d_1a_3x3", "Mixed_6b.branch7x7dbl_4", "Mixed_7c.branch_pool"):
        node = jaxParams
        for part in prefix.split("."):
            node = node[part]
        np.testing.assert_array_equal(state[f"{prefix}.scale"].numpy(), node["scale"])
        np.testing.assert_array_equal(state[f"{prefix}.shift"].numpy(), node["shift"])
    images = np.random.default_rng(3).integers(0, 256, (BATCH, 299, 299, 3), dtype=np.uint8)
    x = np.asarray(images, np.float32) / 255.0 * 2.0 - 1.0
    want = np.asarray(jax.jit(lambda p, v: jaxV3.InceptionV3().apply({"params": p}, v))(
        jaxParams, x))
    got = v3.classifierOf(model)(images).numpy()
    assert got.shape == want.shape == (BATCH, 1000)
    scale = float(np.abs(want).max())
    gap = float(np.abs(got - want).max())
    print(f"logits: max gap {gap:.3e} of max |logit| {scale:.3e}")
    assert np.isfinite(got).all() and gap <= LOGITS_RTOL * scale
    assert float(np.std(want)) > 0.1 * scale           # the logits are not flat


def test_inception_score_equals_the_jax_handler(networks, monkeypatch, tmp_path):
    """Weights found through MCQUIC_INCEPTION_WEIGHTS; four 256 x 256
    images in two calls, two splits: the score within IS_RTOL of the JAX
    handler's on the same weights. Without weights both handlers refuse."""
    sd, _, _ = networks
    path = tmp_path / "inception_v3.pth"
    torch.save(sd, path)
    monkeypatch.setenv("MCQUIC_INCEPTION_WEIGHTS", str(path))
    images = np.random.default_rng(4).integers(0, 256, (4, 256, 256, 3), dtype=np.uint8)
    ours, theirs = InceptionScoreHandler("cpu", splits=2), JaxHandler(splits=2)
    for handler in (ours, theirs):
        handler(restored=images[:2])
        handler(restored=images[2:])
    want, got = theirs.result(), ours.result()
    print(f"Inception Score: port {got!r}, JAX {want!r}")
    assert np.isfinite(got) and got >= 1.0
    assert abs(got - want) <= IS_RTOL * abs(want)
    ours.reset()
    assert np.isnan(ours.result())

    monkeypatch.delenv("MCQUIC_INCEPTION_WEIGHTS")
    monkeypatch.setenv("HOME", str(tmp_path))
    assert v3.makeInceptionClassifier("cpu") is None
    for handler in (InceptionScoreHandler("cpu"), JaxHandler()):
        with pytest.raises(RuntimeError, match="classifier"):
            handler(restored=images[:1])
