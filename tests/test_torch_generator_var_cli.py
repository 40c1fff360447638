"""`GeneratorVAR` checkpoints across both packages and `generate --cfg`, on
the CPU.

  * A port VAR checkpoint written by `python -m mcquic_tpu_torch train -G`
    (a tiny VAR, depth 2, embedDim 64, over a tiny Neon, 256x256 crops of
    class folders) loads in `mcquic_tpu.generate.loadGenerator`, whose leaves
    the VAR map reads into the port's state dict unchanged (the map's leaves
    are the JAX init's: `test_torch_generator_var.py::test_var_map_reads_every_leaf`);
  * a JAX VAR checkpoint (`mcquic_tpu.train.saver.saveTree`) loads in the
    port's `loadGenerator` with every leaf equal;
  * `python -m mcquic_tpu_torch generate --device cpu --cfg 1.5` writes one
    PNG per class from the port's checkpoint.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from mcquic_tpu_torch.utils.convert import fromJaxGeneratorParams
from test_torch_generator import seededGeneratorFlat, unflattenTree
from test_torch_generator_var import TINY_VAR
from test_torch_weights import flattenTree

ROOT = Path(__file__).resolve().parent.parent


def _varConfig(tmp: Path) -> Path:
    """Two class folders of PNG crops and a 2-step VAR recipe over them."""
    from mcquic_tpu_torch.data.png import readPng, writePng
    img = readPng(ROOT / "assets" / "photo_768x512.png")
    for j, wnid in enumerate(["n01440764", "n02099601"]):
        folder = tmp / "classes" / wnid
        folder.mkdir(parents=True, exist_ok=True)
        for i in range(2):
            writePng(folder / f"{i}.png", img[j * 150 + i * 40:j * 150 + i * 40 + 260,
                                              i * 200:i * 200 + 300])
    config = tmp / "var.yaml"
    config.write_text(f"""model: {{key: GeneratorVAR, params: {{channel: 8, k: 16,
  size: [16, 8, 4, 2, 2], depth: 2, embedDim: 64, nHeads: 4, numClasses: 1000, qk_norm: true}}}}
train:
  totalStep: 2
  batchSize: 2
  epoch: 100
  valFreq: 2
  trainSet: {tmp / 'classes'}
  valSet: {tmp / 'classes'}
  saveDir: {tmp / 'var'}
  target: MsSSIM
  optim: {{key: Adam, params: {{lr: 1.0e-4}}}}
  schdr:
    key: CosineAnnealingWarmupRestarts
    params: {{first_cycle_steps: 10, warmup_steps: 1, lrScaleRatio: 0.001}}
  gpu: {{gpus: 1, vRam: -1, wantsMore: false}}
""")
    return config


def _port(*args, cwd):
    proc = subprocess.run([sys.executable, "-m", "mcquic_tpu_torch", *map(str, args)], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout.strip().splitlines()


def test_checkpoints_cross_both_packages_and_generate_cfg_writes_pngs(tmp_path):
    from mcquic_tpu.generate import loadGenerator as jaxLoadGenerator
    from mcquic_tpu.train.saver import saveTree
    from mcquic_tpu_torch.data.png import readPng
    from mcquic_tpu_torch.generate import loadGenerator
    checkpoint = Path(_port("train", "-G", _varConfig(tmp_path), "--device", "cpu",
                            cwd=ROOT)[-1])
    module, variables = jaxLoadGenerator(checkpoint)      # the leaves the VAR map names
    assert type(module).__name__ == "GeneratorVAR" and module.embedDim == 64
    ours = loadGenerator(checkpoint, device="cpu")
    got = flattenTree(variables)
    for key, value in fromJaxGeneratorParams(got).items():
        np.testing.assert_array_equal(ours.state_dict()[key].numpy(), value.numpy(), err_msg=key)

    # the JAX package's VAR checkpoint in the port
    import mcquic_tpu.models.generator_var as jaxVar
    flat = seededGeneratorFlat(TINY_VAR, jaxClass=jaxVar.GeneratorVAR)
    config = {"model": {"key": "GeneratorVAR", "params": dict(TINY_VAR, size=[2, 1, 1])}}
    jaxCkpt = tmp_path / "jax_var.ckpt.npz"
    saveTree(jaxCkpt, unflattenTree({k: np.asarray(v, np.float32) for k, v in flat.items()}),
             {"config": config})
    port = loadGenerator(jaxCkpt, device="cpu")
    for key, value in fromJaxGeneratorParams(flat).items():
        np.testing.assert_array_equal(port.state_dict()[key].numpy(),
                                      value.numpy().astype(np.float32), err_msg=key)
    lines = _port("generate", "-c", "1,207", "--cfg", "1.5", "--top-k", "4", "--device", "cpu",
                  checkpoint, tmp_path / "out", cwd=ROOT)
    pngs = sorted((tmp_path / "out").iterdir())
    assert [p.name for p in pngs] == ["class1_0.png", "class207_1.png"]
    assert lines[-2:] == [str(p) for p in pngs]
    for png in pngs:
        assert readPng(png).shape == (256, 256, 3)
