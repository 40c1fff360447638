"""Weights of the JAX package in the PyTorch port (mcquic_tpu_torch/utils/convert.py).

Also holds the helpers the other port tests share: a numpy-seeded state
dict in the reference McQuic names at the scales a trained model has, and
the JAX variables made from it by the JAX package's own converter
(`mcquic_tpu/utils/convert.py::convertCompressor`), so that both packages
run the same weights without a (slow) flax init.
"""
import hashlib
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from mcquic_tpu.utils.convert import convertCompressor
from mcquic_tpu_torch.models.compressor import Compressor
from mcquic_tpu_torch.utils import convert

ROOT = Path(__file__).resolve().parent.parent
ZOO_QP2 = ROOT / "assets" / "zoo" / "qp_2_msssim_ec233f2c.mcquic.npz"
SMALL = {"channel": 16, "m": 2, "k": [64, 32, 16]}


def randomValue(key, shape, rng, codebookStd=0.1):
    """One reference-named tensor from numpy: convs at torch's default scale
    U(+-1/sqrt(fan_in)), GDN reparams near their init, codebooks at the JAX
    init scale, positive normalized code frequencies."""
    if key.endswith("._codebook"):
        return rng.normal(size=shape) * codebookStd
    if key.endswith("._temperature"):
        return 1 + rng.uniform(0, 0.1, size=shape)
    if "._freqEMA." in key:
        value = rng.uniform(0.1, 1.0, size=shape)
        return value / value.sum(-1, keepdims=True)
    if key.endswith("beta"):
        return 1 + rng.uniform(0, 0.1, size=shape)
    if key.endswith("gamma"):
        return np.sqrt(0.1) * np.eye(shape[0]) + rng.uniform(0, 0.05, size=shape)
    if key.endswith("weight"):
        return rng.uniform(-1, 1, size=shape) / np.sqrt(int(np.prod(shape[1:])))
    if key.endswith("bias"):
        return rng.uniform(-0.1, 0.1, size=shape)
    raise KeyError(key)


def randomStateDict(channel, m, k, seed=0):
    """A whole v1 Compressor's state dict in the reference names (numpy)."""
    rng = np.random.default_rng(seed)
    std = np.sqrt(2 / (5 * channel / m))
    return {key: randomValue(key, tuple(v.shape), rng, std)
            for key, v in Compressor(channel, m, k).state_dict().items()}


def flattenTree(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flattenTree(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(value)
    return out


def jaxVariables(stateDict, channel, m, k):
    """flax variables {'params', 'coder'} of the same weights, via the JAX
    package's converter."""
    return convertCompressor(stateDict, channel, m, list(k))


def portModel(stateDict, channel, m, k, dtype=torch.float64):
    """The port's Compressor with the weights loaded through fromJaxParams."""
    flat = flattenTree(jaxVariables(stateDict, channel, m, k))
    model = Compressor(channel, m, k).to(dtype)
    model.load_state_dict(convert.fromJaxParams(flat))
    return model.eval()


def test_from_jax_params_inverts_the_jax_converter():
    sd = randomStateDict(**SMALL)
    flat = flattenTree(jaxVariables(sd, **SMALL))
    back = convert.fromJaxParams(flat)
    assert set(back) == set(sd)
    for key, value in sd.items():
        np.testing.assert_array_equal(back[key].numpy(), value, err_msg=key)


def test_from_jax_params_rejects_missing_and_unused_keys():
    flat = flattenTree(jaxVariables(randomStateDict(**SMALL), **SMALL))
    broken = dict(flat)
    broken.pop("params/_encoder/Conv_0/Conv_0/kernel")
    with pytest.raises(KeyError, match="1 parameters missing"):
        convert.fromJaxParams(broken)
    with pytest.raises(KeyError, match="1 not used"):
        convert.fromJaxParams({**flat, "params/extra": np.zeros(1)})


def test_map_matches_the_jax_map_for_every_zoo_geometry():
    from mcquic_tpu.utils.convert import buildCompressorMap
    for channel, m, k in ((128, 2, [8192, 2048, 512]), (32, 1, [1024, 512]), (16, 2, [64, 32, 16])):
        jaxMap = {"/".join(path): torchKey
                  for path, (torchKey, _) in buildCompressorMap(channel, m, k).entries.items()}
        ours = {flaxKey: torchKey for torchKey, (flaxKey, _) in convert.compressorMap(len(k)).entries.items()}
        assert ours == jaxMap


def test_bf16_upcast_matches_ml_dtypes():
    import ml_dtypes
    rng = np.random.default_rng(0)
    values = np.concatenate([rng.normal(size=4096) * 10.0 ** rng.integers(-30, 30, 4096),
                             [0.0, -0.0, np.inf, -np.inf, 1e-40]]).astype(np.float32)
    bits = values.astype(ml_dtypes.bfloat16).view(np.uint16)
    want = bits.view(ml_dtypes.bfloat16).astype(np.float32)
    got = convert.bf16ToFloat32(bits)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    allBits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    finite = np.isfinite(allBits.view(ml_dtypes.bfloat16).astype(np.float32))
    np.testing.assert_array_equal(convert.bf16ToFloat32(allBits)[finite],
                                  allBits.view(ml_dtypes.bfloat16).astype(np.float32)[finite])


def test_load_zoo_qp2_maps_all_669_keys():
    from mcquic_tpu.train.saver import loadTree, upcastBf16
    stateDict, meta = convert.loadZoo(ZOO_QP2)
    geometry = convert.modelGeometry(meta)
    assert geometry == {"channel": 128, "m": 2, "k": [8192, 2048, 512]}
    assert len(stateDict) == 669
    model = Compressor(**geometry)
    want = model.state_dict()
    assert set(stateDict) == set(want)
    for key, value in stateDict.items():
        assert value.shape == want[key].shape, key
        assert value.dtype == torch.float32, key
    model.load_state_dict(stateDict, strict=True)
    # the same numbers as the JAX package's loader
    tree, _ = loadTree(ZOO_QP2)
    jaxFlat = flattenTree(upcastBf16(tree))
    for torchKey, (flaxKey, fn) in convert.compressorMap(3).entries.items():
        np.testing.assert_array_equal(stateDict[torchKey].numpy(), fn(jaxFlat[flaxKey]),
                                      err_msg=torchKey)


def test_zoo_hash_is_checked(tmp_path):
    assert convert.zooSlot(ZOO_QP2) == "qp_2_msssim"
    digest = hashlib.sha256(ZOO_QP2.read_bytes()).hexdigest()
    assert digest.startswith(convert.modelsHash()["qp_2_msssim"])
    fake = tmp_path / "qp_2_msssim_ec233f2c.mcquic.npz"
    np.savez(fake, x=np.zeros(3))
    shutil.copy(ZOO_QP2.with_suffix(".json"), fake.with_suffix(".json"))
    with pytest.raises(RuntimeError, match="does not match the registered hash"):
        convert.loadZoo(fake)
    unknown = tmp_path / "qp_9_msssim_00000000.mcquic.npz"
    np.savez(unknown, x=np.zeros(3))
    with pytest.raises(RuntimeError, match="no registered zoo slot"):
        convert.loadZoo(unknown)


def test_model_geometry_from_sidecar():
    meta = json.loads(ZOO_QP2.with_suffix(".json").read_text())
    assert convert.modelGeometry(meta) == {"channel": 128, "m": 2, "k": [8192, 2048, 512]}
    legacy = {"config": {"model": {"key": "Compressor",
                                   "params": {"channel": 8, "m": [2, 2], "k": [16, 8]}}}}
    assert convert.modelGeometry(legacy) == {"channel": 8, "m": 2, "k": [16, 8]}
    # a `size` pyramid means Neon whatever the key says; a list-valued k is read at its first entry
    neon = {"config": {"model": {"key": "Compressor",
                                 "params": {"channel": 8, "k": [16], "size": [4, 2, 2]}}}}
    assert convert.modelGeometry(neon) == {"channel": 8, "k": 16, "size": [4, 2, 2]}
    # denseNorm is kept where it is set (the GroupNorm blocks are ported)
    dense = {"config": {"model": {"key": "Neon", "params": {"channel": 8, "k": 16, "size": [4, 2, 2],
                                                             "denseNorm": True}}}}
    assert convert.modelGeometry(dense) == {"channel": 8, "k": 16, "size": [4, 2, 2],
                                            "denseNorm": True}


def test_models_hash_copy_matches_the_jax_package():
    ours = json.loads((ROOT / "mcquic_tpu_torch" / "models_hash.json").read_text())
    theirs = json.loads((ROOT / "mcquic_tpu" / "models_hash.json").read_text())
    assert ours == theirs
