"""The port's generator checkpoint loader and `generate` entry points
(`mcquic_tpu_torch/generate.py`, `python -m mcquic_tpu_torch generate`).

Checkpoints are written by the JAX package's own `saveTree`, the format its
trainer and exporter use: a flat npz of the flax tree with bf16 leaves as
uint16 under `key@bf16`, and a json sidecar holding the config.
"""
import json

import ml_dtypes
import numpy as np
import pytest
import torch

from mcquic_tpu.train.saver import saveTree
from mcquic_tpu_torch.cli import main as cliMain
from mcquic_tpu_torch.data.png import readPng
from mcquic_tpu_torch.generate import generatorConfig, loadGenerator, sample
from mcquic_tpu_torch.models.generator import GeneratorV3SelfAttention
from mcquic_tpu_torch.utils.convert import fromJaxGeneratorParams
from test_torch_generator import TINY, portGenerate, portGenerator, seededGeneratorFlat, unflattenTree

BF16_LEAF = "params/classEmbed"


def tinyConfig(key="GeneratorV3SelfAttention", **extra):
    params = {k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()}
    params.update({"loadFrom": ".scratch/neon/latest/saved.ckpt.npz"}, **extra)
    return {"model": {"key": key, "params": params}}


def writeTinyCheckpoint(path, seed=0, config=None):
    """A seeded tiny generator checkpoint as a trainer writes it (with step,
    optimizer state and rng beside the variables) and one bf16 leaf.
    Returns the flat fp64 variables the loader must reproduce."""
    flat = seededGeneratorFlat(TINY, seed=seed)
    tree = unflattenTree({k: (v.astype(ml_dtypes.bfloat16) if k == BF16_LEAF
                              else v.astype(np.float32)) for k, v in flat.items()})
    tree.update({"step": np.asarray(3), "optState": {"00000": np.zeros(4, np.float32)},
                 "rng": np.zeros(2, np.uint32)})
    saveTree(path, tree, {"config": config or tinyConfig(), "version": "0.1.40"})
    return flat


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("gen") / "saved.ckpt.npz"
    return path, writeTinyCheckpoint(path)


def test_export_format_round_trips_into_the_loader(checkpoint):
    path, flat = checkpoint
    with np.load(path) as z:
        assert BF16_LEAF + "@bf16" in z.files and z[BF16_LEAF + "@bf16"].dtype == np.uint16
    model = loadGenerator(path, device="cpu")
    state = model.state_dict()
    want = fromJaxGeneratorParams({k: (v.astype(ml_dtypes.bfloat16) if k == BF16_LEAF else v)
                                   .astype(np.float32) for k, v in flat.items()})
    assert set(want) <= set(state)
    for key, value in want.items():
        assert state[key].dtype == torch.float32, key
        torch.testing.assert_close(state[key], value, rtol=0, atol=0, msg=key)
    assert not model.training and not any(p.requires_grad for p in model.parameters())


def test_loaded_generator_greedy_codes_match_the_jax_package(checkpoint):
    """The fp32 loaded model (bf16 leaf upcast) against JAX on the same values."""
    import jax
    import jax.numpy as jnp
    from mcquic_tpu.models.generator import GeneratorV3SelfAttention as JaxGenerator
    from mcquic_tpu.train.saver import loadTree, upcastBf16
    from test_torch_generator import jaxGenerate
    path, _ = checkpoint
    tree, _ = loadTree(path)
    variables = upcastBf16({"params": tree["params"], "coder": tree["coder"]})
    want, _, _ = jaxGenerate(JaxGenerator(**TINY), jax.tree_util.tree_map(jnp.asarray, variables),
                             np.array([1, 4]), True)
    codes, _, _ = portGenerate(loadGenerator(path, device="cpu"), np.array([1, 4]), True)
    for a, b in zip(codes, want):
        np.testing.assert_array_equal(a, b.transpose(0, 3, 1, 2))


def test_sample_returns_uint8_images(checkpoint):
    codes, images = sample(loadGenerator(checkpoint[0], device="cpu"), [1, 4], topK=2)
    assert [tuple(c.shape) for c in codes] == [(2, 1, 1, 1), (2, 1, 1, 1), (2, 1, 2, 2)]
    assert images.shape == (2, 32, 32, 3) and images.dtype == np.uint8


def test_seeded_sampling_repeats_and_depends_on_the_seed(checkpoint):
    model = loadGenerator(checkpoint[0], device="cpu")
    first = sample(model, [0, 1, 2, 3], seed=11)[0]
    again = sample(model, [0, 1, 2, 3], seed=11)[0]
    other = sample(model, [0, 1, 2, 3], seed=12)[0]
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert not all(torch.equal(a, b) for a, b in zip(first, other))


def test_config_keys_the_port_lacks_are_refused():
    with pytest.raises(NotImplementedError, match="GeneratorV2"):
        generatorConfig({"config": tinyConfig("GeneratorV2")})
    # GeneratorVAR is ported; like the JAX package's loader, it drops what it does not take
    key, kwargs = generatorConfig({"config": tinyConfig("GeneratorVAR")})
    assert key == "GeneratorVAR" and "hiddenSize" not in kwargs and kwargs["k"] == 16
    # text conditioning and denseNorm load; class ids for a text-conditioned
    # model are what stays refused (tests/test_torch_text_generator.py)
    key, kwargs = generatorConfig({"config": tinyConfig(textConditioned=True, capDim=12)})
    assert kwargs["textConditioned"] and kwargs["capDim"] == 12
    model = GeneratorV3SelfAttention(**kwargs)
    with pytest.raises(ValueError, match="text-conditioned: its condition is a float caption"):
        sample(model, [1, 2])
    key, kwargs = generatorConfig({"config": tinyConfig(denseNorm=True, channel=32)})
    assert kwargs["denseNorm"] and GeneratorV3SelfAttention(**kwargs).compressor.denseNorm
    with pytest.raises(ValueError, match="not taken"):
        generatorConfig({"config": tinyConfig(mystery=1)})
    key, kwargs = generatorConfig({"config": tinyConfig("GeneratorV3SelfAttentionNoAda")})
    assert key == "GeneratorV3SelfAttentionNoAda" and "loadFrom" not in kwargs
    with pytest.raises(RuntimeError, match="config"):
        generatorConfig({"version": "0.1.40"})


def test_class_ids_past_the_table_are_refused(checkpoint):
    with pytest.raises(ValueError, match="past the model's 10 classes"):
        sample(loadGenerator(checkpoint[0], device="cpu"), [3, 11])


def test_generate_cli_writes_one_png_per_class(checkpoint, tmp_path, capsys):
    path, _ = checkpoint
    out = tmp_path / "samples"
    assert cliMain(["generate", "-c", "1,7,-1", "--top-k", "4", "--temperature", "0.8",
                    "--seed", "5", "--device", "cpu", str(path), str(out)]) == 0
    names = sorted(p.name for p in out.iterdir())
    assert names == ["class-1_2.png", "class1_0.png", "class7_1.png"]
    assert readPng(out / "class7_1.png").shape == (32, 32, 3)
    assert str(out / "class1_0.png") in capsys.readouterr().out


def test_generate_cli_defaults_to_cuda(checkpoint, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        cliMain(["generate", "-c", "1", str(checkpoint[0]), str(tmp_path / "out")])


def test_sidecar_config_is_the_trainer_format(checkpoint):
    meta = json.loads(checkpoint[0].with_suffix(".json").read_text())
    assert meta["config"]["model"]["key"] == "GeneratorV3SelfAttention"


def test_to_jax_inverts_from_jax_and_the_jax_loader_reads_the_export(tmp_path):
    from mcquic_tpu.train.saver import loadTree
    from mcquic_tpu_torch.utils.convert import (generatorGeometry, readExport,
                                                toJaxGeneratorParams, writeExport)
    flat = seededGeneratorFlat(TINY, seed=7)
    back = toJaxGeneratorParams(fromJaxGeneratorParams(flat), **generatorGeometry(flat))
    assert set(back) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    path = writeExport(tmp_path / "gen.npz", back, {"config": tinyConfig()})
    tree, meta = loadTree(path)
    assert meta["config"]["model"]["params"]["hiddenSize"] == 32
    np.testing.assert_array_equal(tree["params"]["transformer"]["posEmbed"],
                                  flat["params/transformer/posEmbed"])
    reread, _ = readExport(path)
    assert set(reread) == set(flat)
