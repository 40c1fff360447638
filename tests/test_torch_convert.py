"""Reference (PyTorch) checkpoints into the port, on the CPU, against the
JAX package's converter (`mcquic_tpu/utils/convert.py:267-363`) and its
stage-2 `loadFrom` (`mcquic_tpu/train/genTrainer.py:97-129`).

No reference checkpoint is in the repository, so each is a `torch.save` of
a numpy-seeded state dict under the reference names
(`models/compressor.py::seededModel`, whose modules carry them), in the
three shapes a reference file takes: the raw state dict, a trainer's
`{'trainer': {'_model': ...}}` with the `module._compressor.` prefix and an
LPIPS key beside, and an exported `{'model': ...}`.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mcquic_tpu_torch.models.compressor import seededModel
from mcquic_tpu_torch.utils import convert
from mcquic_tpu_torch.utils.convert import readExport

ROOT = Path(__file__).resolve().parent.parent
TINY_V1 = dict(channel=8, m=2, k=[16, 8])
TINY_NEON = dict(channel=8, k=16, size=[16, 8, 4, 2, 2])
# denseNorm puts 32-group GroupNorms in the Neon's wide stages: channel 32 at least
DENSE_NEON = dict(channel=32, k=16, size=[2, 1, 1], denseNorm=True)
SHAPES = ("raw", "trainer", "model")


def referenceCheckpoint(path: Path, geometry: dict, shape: str) -> Path:
    """A seeded state dict of `geometry` saved in one reference shape."""
    stateDict = {k: v.clone() for k, v in seededModel(geometry, seed=7).state_dict().items()}
    if shape == "trainer":
        payload = {"module._compressor." + k: v for k, v in stateDict.items()}
        payload["module._compressor._lpips.net.0.weight"] = torch.zeros(2)
        payload["module._other"] = torch.zeros(1)
        stateDict = {"trainer": {"_model": payload, "_step": 10}}
    elif shape == "model":
        stateDict = {"model": stateDict}
    torch.save(stateDict, path)
    return path


def geometryArgs(geometry: dict) -> list:
    args = ["--channel", str(geometry["channel"]), "--k", ",".join(map(str, np.atleast_1d(
        geometry["k"])))]
    if "size" in geometry:
        return args + ["--size", ",".join(map(str, geometry["size"]))] + (
            ["--denseNorm"] if geometry.get("denseNorm") else [])
    return args + ["--m", str(geometry["m"])]


def jaxConvert(monkeypatch, capsys, argv) -> Path:
    from mcquic_tpu.utils.convert import main as jaxMain
    monkeypatch.setattr(sys, "argv", ["convert", *argv])
    jaxMain()
    return Path(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name,shape", [("v1", s) for s in SHAPES] + [("neon", s) for s in SHAPES]
                         + [("neon denseNorm", "trainer")])
def test_exports_equal_the_jax_converter(tmp_path, monkeypatch, capsys, name, shape):
    """The port's `main` and the JAX package's write exports with equal
    arrays, an equal config and the same qp from the same checkpoint; with
    `--denseNorm`, every residual block's `_branch.2` GroupNorm lands on the
    JAX converter's `GroupNorm_0` (`buildNeonMap(..., denseNorm=True)`)."""
    geometry = {"v1": TINY_V1, "neon": TINY_NEON, "neon denseNorm": DENSE_NEON}[name]
    ckpt = referenceCheckpoint(tmp_path / "ref.ckpt", geometry, shape)
    args = geometryArgs(geometry) + ["--qp", "3"]
    theirs = jaxConvert(monkeypatch, capsys, [str(ckpt), str(tmp_path / "jax" / "out.npz"), *args])
    ours = convert.main([str(ckpt), str(tmp_path / "port" / "out.npz"), *args])
    assert ours.name.endswith(".mcquic.npz") and ours.exists()
    want, wantMeta = readExport(theirs)
    got, gotMeta = readExport(ours)
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
        assert got[key].dtype == value.dtype, key
    assert gotMeta["config"] == wantMeta["config"] and gotMeta["qp"] == wantMeta["qp"] == "3"


def test_geometry_from_a_config_and_the_refusals(tmp_path, monkeypatch, capsys):
    """`--config` reads the geometry (a uniform list m read as its int) as
    the JAX CLI does; a missing geometry, a v1 geometry without m and a
    non-uniform m are refused before the checkpoint is read; a missing key
    raises."""
    ckpt = referenceCheckpoint(tmp_path / "ref.ckpt", TINY_V1, "raw")
    config = tmp_path / "cfg.yaml"
    config.write_text("model: {key: Compressor, params: {channel: 8, m: [2, 2], k: [16, 8]}}\n")
    theirs = jaxConvert(monkeypatch, capsys, [str(ckpt), str(tmp_path / "a.npz"),
                                              "--config", str(config)])
    ours = convert.main([str(ckpt), str(tmp_path / "b.npz"), "--config", str(config)])
    assert readExport(ours)[1]["config"] == readExport(theirs)[1]["config"]
    missing = str(tmp_path / "absent.ckpt")
    for argv, message in (([], "provide --config or --channel/--k"),
                          (["--channel", "8", "--k", "16,8"], "--m is required")):
        with pytest.raises(SystemExit):
            convert.main([missing, str(tmp_path / "c.npz"), *argv])
        assert message in capsys.readouterr().err
    config.write_text("model: {key: Compressor, params: {channel: 8, m: [2, 1], k: [16, 8]}}\n")
    with pytest.raises(SystemExit):
        convert.main([missing, str(tmp_path / "c.npz"), "--config", str(config)])
    assert "per-level m [2, 1] is not supported" in capsys.readouterr().err
    partial = {k: v for k, v in torch.load(ckpt).items() if not k.startswith("_decoder.")}
    torch.save(partial, tmp_path / "partial.ckpt")
    with pytest.raises(RuntimeError, match="Missing key"):
        convert.main([str(tmp_path / "partial.ckpt"), str(tmp_path / "d.npz"),
                      *geometryArgs(TINY_V1)])


def test_converted_v1_compresses_as_the_jax_package(tmp_path, monkeypatch, capsys):
    """The converted v1 export compresses a crop of the photo through the
    port's CLI (`--local`, CPU) to the `.mcq` bytes the JAX package's demo
    writes from its own conversion of the same checkpoint."""
    from mcquic_tpu.demo import main as jaxDemo
    from mcquic_tpu_torch.cli import main as cli
    from mcquic_tpu_torch.data.png import readPng, writePng
    ckpt = referenceCheckpoint(tmp_path / "ref.ckpt", TINY_V1, "trainer")
    args = geometryArgs(TINY_V1) + ["--qp", "2"]
    theirs = jaxConvert(monkeypatch, capsys, [str(ckpt), str(tmp_path / "jax.npz"), *args])
    ours = convert.main([str(ckpt), str(tmp_path / "port.npz"), *args])
    image = tmp_path / "crop.png"
    writePng(image, readPng(ROOT / "assets" / "photo_768x512.png")[128:256, 256:384])
    jaxDemo(None, str(theirs), True, False, False, image, tmp_path / "jax.mcq")
    assert cli(["--device", "cpu", "--local", str(ours), str(image), str(tmp_path / "port.mcq")]) == 0
    assert (tmp_path / "port.mcq").read_bytes() == (tmp_path / "jax.mcq").read_bytes()


def test_stage2_loads_a_reference_stage1_checkpoint(tmp_path):
    """`train -G` with `loadFrom` a reference trainer checkpoint: the tiny
    generator trains over the Neon the checkpoint holds (its tokenizer, in
    the trained checkpoint, equals the reference weights), and the loader
    refuses what the JAX package refuses, in its words."""
    from test_torch_train_cli import tinyGenConfig
    from mcquic_tpu_torch.train.cli import main as train
    from mcquic_tpu_torch.train.genTrainer import loadCompressorParams
    ckpt = referenceCheckpoint(tmp_path / "ref.ckpt", TINY_NEON, "trainer")
    checkpoint = train(tinyGenConfig(tmp_path, ckpt), gen=True, device="cpu")
    flat, _ = readExport(checkpoint)
    want = convert.convertReference(convert.loadTorchStateDict(ckpt), TINY_NEON)
    assert len(want) > 100
    for key, value in want.items():
        head, rest = key.split("/", 1)
        np.testing.assert_array_equal(flat[f"{head}/compressor/{rest}"], value, err_msg=key)
    assert int(flat["step"]) == 2
    with pytest.raises(ValueError, match="needs the generator config's channel/k/size"):
        loadCompressorParams(ckpt, {"channel": 8, "k": 16})
    (tmp_path / "junk.ckpt").write_bytes(b"neither")
    with pytest.raises(ValueError, match="is neither a readable npz export"):
        loadCompressorParams(tmp_path / "junk.ckpt", dict(TINY_NEON))
