"""The text-conditioned generator (`GeneratorV3SelfAttention(textConditioned=
True)`: a `capProj` Linear from a [n, capDim] caption embedding in place of
the class table) against the JAX package's, fp64, at the geometry of
tests/test_generator.py::test_text_conditioned_generator (channel 8, k 16,
size (2, 1, 1), hidden 32, depth 1, 4 heads, capDim 12), on numpy-seeded
caption embeddings.

Every flax leaf is numpy-seeded (`test_torch_generator.seededLeaf`) and
carried into the port by `fromJaxGeneratorParams`; the inverse map gives the
same leaves back, and the JAX apply takes exactly them. Held: the teacher-forced pass (`forward`) on 32x32 images,
its codes bit-identical and its logits, loss and per-level CE within 16 fp32
ulps of their magnitude (the JAX package rounds RMSNorm, attention and the
logits to fp32 even in fp64); sampling at top-k 4 with the JAX run's Gumbel
noise handed to the port (`test_torch_generator_var.recordGumbel`): codes at
every level bit-identical, and the restored image to 16 fp32 ulps.

The refusals that stay, by their messages: class ids for a text-conditioned
model (the `generate` CLI, `sample`) and `train -G` of one; the JAX model
raises flax's ScopeParamShapeError on class ids, and no trainer or CLI of
either package feeds it captions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcquic_tpu.models.generator import GeneratorV3SelfAttention as JaxGenerator
from mcquic_tpu_torch.generate import (conditionOf, generatorConfig, loadGenerator, main, sample,
                                       writeSeededGenerator)
from mcquic_tpu_torch.models.generator import GeneratorV3SelfAttention
from mcquic_tpu_torch.train.genTrainer import checkGenerator
from mcquic_tpu_torch.utils.convert import (fromJaxGeneratorParams, generatorGeometry,
                                            toJaxGeneratorParams)
from test_torch_generator import FP32_ROUNDED, seededLeaf, unflattenTree
from test_torch_generator_var import recordGumbel

TEXT = dict(channel=8, k=16, size=(2, 1, 1), hiddenSize=32, depth=1, nHeads=4,
            textConditioned=True, capDim=12)


def _assertClose(got, want, label=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, label
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=FP32_ROUNDED * scale, err_msg=label)


@pytest.fixture(scope="module")
def tiny():
    # the flax names and shapes through the port's inverse map (tracing the
    # flax init costs seconds); the JAX apply needs every one of them
    shapes = toJaxGeneratorParams(GeneratorV3SelfAttention(**TEXT).state_dict(),
                                  [True, True, False], TEXT["depth"], textConditioned=True)
    rng = np.random.default_rng(21)
    flat = {key: seededLeaf(key, value.shape, rng) for key, value in sorted(shapes.items())}
    model = GeneratorV3SelfAttention(**TEXT)
    model.load_state_dict(fromJaxGeneratorParams(flat), strict=True)
    captions = np.random.default_rng(2).normal(size=(3, TEXT["capDim"]))
    return JaxGenerator(**TEXT, dtype=jnp.float64), unflattenTree(flat), model.double().eval(), \
        flat, captions


def test_caption_projection_is_mapped_both_ways(tiny):
    _, _, model, flat, _ = tiny
    assert "params/capProj/kernel" in flat and "params/classEmbed" not in flat
    assert not hasattr(model, "classEmbed") and model.capProj.weight.shape == (32, 12)
    geometry = generatorGeometry(flat)
    assert geometry == {"halving": [True, True, False], "depth": 1, "useAda": True,
                        "qkNorm": True, "textConditioned": True}
    back = toJaxGeneratorParams(model.state_dict(), geometry["halving"], 1, textConditioned=True)
    assert back.keys() == flat.keys()
    for key, value in flat.items():      # loaded into fp32 parameters, then cast to fp64
        np.testing.assert_array_equal(back[key], value.astype(np.float32), err_msg=key)


def test_teacher_forced_pass_matches(tiny):
    module, variables, model, _, captions = tiny
    images = np.random.default_rng(5).uniform(-1, 1, size=(3, 32, 32, 3))
    with jax.enable_x64():
        predictions, loss, codes, _, perLevel = jax.jit(
            lambda v, x, c: module.apply(v, x, c, train=True))(variables, images, captions)
    with torch.no_grad():
        ours = model(torch.from_numpy(images.transpose(0, 3, 1, 2).copy()),
                     torch.from_numpy(captions))
    for level, (a, b) in enumerate(zip(ours[2], codes)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).transpose(0, 3, 1, 2),
                                      err_msg=f"codes level {level}")
    for level, (a, b) in enumerate(zip(ours[0], predictions)):
        _assertClose(a.numpy(), b, f"logits level {level}")
    _assertClose(float(ours[1]), float(loss), "loss")
    for level, (a, b) in enumerate(zip(ours[4], perLevel)):
        _assertClose(float(a), float(b), f"CE level {level}")


def test_sampling_with_the_jax_gumbel_noise_matches(tiny):
    module, variables, model, _, captions = tiny
    with jax.enable_x64(), recordGumbel() as noises:
        def run(v, c):
            codes, restored = module.apply(v, c, jax.random.PRNGKey(9), topK=4,
                                           method=module.generate)
            return codes, restored, list(noises)
        codes, restored, noises = jax.jit(run)(variables, jnp.asarray(captions))
    assert len(noises) == 3
    queue = [np.asarray(g) for g in noises]
    with torch.no_grad():
        ours, ourRestored = model.generate(torch.from_numpy(captions), topK=4,
                                           gumbel=lambda shape: torch.from_numpy(queue.pop(0).copy()))
    assert not queue
    for level, (a, b) in enumerate(zip(ours, codes)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[..., 0][:, None],
                                      err_msg=f"level {level}")
    _assertClose(ourRestored.numpy().transpose(0, 2, 3, 1), restored, "restored")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    geometry = {k: list(v) if isinstance(v, tuple) else v for k, v in TEXT.items()}
    path = writeSeededGenerator(tmp_path_factory.mktemp("text") / "text.npz", geometry)
    return geometry, path, loadGenerator(path, device="cpu")


def test_a_seeded_text_checkpoint_loads_and_samples_from_captions(checkpoint):
    geometry, _, model = checkpoint
    key, kwargs = generatorConfig({"config": {"model": {"key": "GeneratorV3SelfAttention",
                                                        "params": geometry}}})
    assert kwargs["textConditioned"] and kwargs["capDim"] == 12
    assert model.textConditioned
    captions = np.random.default_rng(0).normal(size=(2, 12)).astype(np.float32)
    codes, images = sample(model, captions, seed=3, topK=4)
    assert [tuple(c.shape) for c in codes] == [(2, 1, 1, 1), (2, 1, 1, 1), (2, 1, 2, 2)]
    assert images.shape == (2, 32, 32, 3) and images.dtype == np.uint8
    again = sample(model, captions, seed=3, topK=4)[0]
    assert all(torch.equal(a, b) for a, b in zip(codes, again))


def test_class_ids_and_training_are_refused_with_the_reason(checkpoint, tmp_path):
    geometry, path, model = checkpoint
    with pytest.raises(ValueError, match="text-conditioned: its condition is a float caption "
                                         "embedding \\[n, 12\\].*ScopeParamShapeError"):
        main(path, [1, 2], tmp_path / "out", device="cpu")
    assert not (tmp_path / "out").exists()
    with pytest.raises(ValueError, match="text-conditioned"):
        conditionOf(model, np.zeros((2, 5)), "cpu")
    with pytest.raises(ValueError, match="textConditioned=True takes \\[n, capDim\\] caption "
                                         "embeddings.*reads no captions"):
        checkGenerator("GeneratorV3SelfAttention", geometry)
