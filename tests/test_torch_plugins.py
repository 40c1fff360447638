"""Plugins, the train module's entry, `--disable-gpu` and the console scripts
of the port (counterparts of `mcquic_tpu/train/cli.py:22-31`,
`mcquic_tpu/train/__main__.py`, `mcquic_tpu/cli.py:68` and
`pyproject.toml`'s scripts), on the CPU at the tiny geometry of
`test_torch_train_cli.tinyConfig`:

  * a config's `externalLib` file registers a hook, a learning-rate
    schedule, an optimizer and a loss in `utils/registry.py`, and a two-step
    run through the train CLI uses each of them;
  * a plugin that imports the JAX package fails at that import where the
    JAX package is absent (`tests/test_torch_imports.py`'s guard);
  * `python -m mcquic_tpu_torch.train CONFIG [-r]` and `-G` train as
    `python -m mcquic_tpu_torch train` does;
  * `--disable-gpu` writes the `.mcq` that `--device cpu` writes, and without
    either the codec CLI asks for the card;
  * the port's four console scripts stand beside the JAX package's four and
    resolve to the port's CLI.
"""
import json
import subprocess
import sys
import tomllib
from pathlib import Path

import numpy as np
import pytest

from mcquic_tpu.train.saver import loadTree
from mcquic_tpu_torch.config import Config
from mcquic_tpu_torch.data.png import readPng, writePng
from mcquic_tpu_torch.utils.registry import (HookRegistry, LossRegistry, LrSchedulerRegistry,
                                             OptimizerRegistry, Registry)
from test_torch_imports import BLOCKED, GUARD
from test_torch_train_cli import tinyConfig, tinyGenConfig

ROOT = Path(__file__).resolve().parent.parent
TINY = ROOT / "assets" / "tiny_demo_672919fb.mcquic.npz"

PLUGIN = '''
"""Registers a hook, a schedule, an optimizer and a loss, and logs their calls."""
import json
from pathlib import Path

from mcquic_tpu_torch.loss import PSNR
from mcquic_tpu_torch.train.hooks import HookType
from mcquic_tpu_torch.train.optim import SGD
from mcquic_tpu_torch.utils.registry import (HookRegistry, LossRegistry, LrSchedulerRegistry,
                                             OptimizerRegistry)

LOG = Path({log!r})


def record(*entry):
    with LOG.open("a") as f:
        f.write(json.dumps(entry) + "\\n")


@HookRegistry.register(key="PluginCountSteps")
class CountSteps:
    hookType = HookType.StepFinishHook

    def __init__(self, tag):
        self.tag = tag

    def __call__(self, trainer, step):
        record("hook", self.tag, step)


@LrSchedulerRegistry.register(key="PluginHalfLr")
def halfLr(baseLr, **_):
    return lambda step: baseLr / 2


@OptimizerRegistry.register(key="PluginSGD")
def pluginSgd(params, schedule, momentum=0.0, **_):
    record("optimizer", schedule(0), len(params), momentum)
    return SGD(params, schedule, momentum=momentum)


@LossRegistry.register(key="PluginPSNR")
class PluginPSNR(PSNR):
    def __call__(self, restored, image, codes=None, logits=None):
        record("loss", list(restored.shape))
        return super().__call__(restored, image, codes, logits)
'''


def pluginConfig(tmp: Path, plugin: Path) -> Path:
    """tinyConfig with the plugin's hook, schedule, optimizer and loss."""
    text = tinyConfig(tmp).read_text()
    config = tmp / "plugin.yaml"
    config.write_text(
        text.replace("target: PSNR", "target: PluginPSNR")
        .replace("optim: {key: Adam, params: {lr: 1.0e-4}}",
                 "optim: {key: PluginSGD, params: {lr: 1.0e-3, momentum: 0.9}}")
        .replace("key: CosineAnnealingWarmupRestarts", "key: PluginHalfLr")
        .replace("{key: CodebookReassign, params: {freq: 1}}",
                 "{key: PluginCountSteps, params: {tag: counted}}")
        + f"  externalLib: [{plugin}]\n")
    return config


def test_registry_keeps_the_jax_wording():
    registry = Registry("Thing")
    registry.register(len)
    registry.register(key="Other")(abs)
    assert registry.get("len") is len and registry.get("Other") is abs
    with pytest.raises(KeyError, match=r"`missing` not found in Thing registry. Available: "
                                       r"\['Other', 'len'\]"):
        registry.get("missing")


def test_a_plugin_registers_what_a_two_step_run_uses(tmp_path):
    from mcquic_tpu_torch.train.cli import main
    log = tmp_path / "calls.jsonl"
    plugin = tmp_path / "torch_plugin_a.py"
    plugin.write_text(PLUGIN.format(log=str(log)))
    config = pluginConfig(tmp_path, plugin)
    export = main(config, device="cpu")
    assert export.exists()
    baseLr = Config.load(str(config)).Train.scaledOptim(1).Params["lr"]
    for registry, key in ((HookRegistry, "PluginCountSteps"), (LossRegistry, "PluginPSNR"),
                          (LrSchedulerRegistry, "PluginHalfLr"), (OptimizerRegistry, "PluginSGD")):
        assert key in registry
    calls = [json.loads(line) for line in log.read_text().splitlines()]
    assert calls[0][0] == "optimizer" and calls[0][1:] == [baseLr / 2, calls[0][2], 0.9]
    assert [c for c in calls if c[0] == "hook"] == [["hook", "counted", 1], ["hook", "counted", 2]]
    assert [c for c in calls if c[0] == "loss"] == [["loss", [2, 3, 64, 64]]] * 2
    tree, _ = loadTree(tmp_path / "saved" / "latest" / "saved.ckpt.npz")
    assert int(tree["step"]) == 2
    leaves = tree["optState"]
    # SGD with momentum: optax's trace leaves and a count, against Adam's 2n + 2
    assert int(leaves[sorted(leaves)[-1]]) == 2 and len(leaves) == calls[0][2] + 1


def test_a_plugin_of_the_jax_package_fails_at_its_import(tmp_path):
    plugin = tmp_path / "jax_plugin.py"
    plugin.write_text("from mcquic_tpu.utils.registry import HookRegistry\n")
    config = tinyConfig(tmp_path)
    config.write_text(config.read_text() + f"  externalLib: [{plugin}]\n")
    script = GUARD.format(blocked=BLOCKED, root=str(ROOT),
                          runs=[["train", "--device", "cpu", str(config)]])
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert "mcquic_tpu is not on the machine with the card" in proc.stderr
    assert str(plugin) in proc.stderr and not (tmp_path / "saved" / "latest").exists()


def test_the_train_module_entry_trains_both_stages(tmp_path):
    from mcquic_tpu_torch.demo import writeSeededExport
    config = tinyConfig(tmp_path)
    run = [sys.executable, "-m", "mcquic_tpu_torch.train"]
    proc = subprocess.run([*run, str(config), "-r", "--device", "cpu"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    export = Path(proc.stdout.strip().splitlines()[-1])
    assert export.exists() and export.parent == tmp_path / "saved"
    neon = writeSeededExport(tmp_path / "neon.npz", "Neon",
                             {"channel": 8, "k": 16, "size": [16, 8, 4, 2, 2]})
    proc = subprocess.run([*run, str(tinyGenConfig(tmp_path, neon)), "-G", "--device", "cpu"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    checkpoint = Path(proc.stdout.strip().splitlines()[-1])
    tree, _ = loadTree(checkpoint)
    assert checkpoint == tmp_path / "gen" / "latest" / "saved.ckpt.npz" and int(tree["step"]) == 2


def test_disable_gpu_is_device_cpu(tmp_path):
    from mcquic_tpu_torch.cli import main
    image = readPng(ROOT / "assets" / "photo_768x512.png")[100:196, 200:328]
    writePng(tmp_path / "in.png", image)
    assert main(["--disable-gpu", "--local", str(TINY), str(tmp_path / "in.png"),
                 str(tmp_path / "a.mcq")]) == 0
    assert main(["--device", "cpu", "--local", str(TINY), str(tmp_path / "in.png"),
                 str(tmp_path / "b.mcq")]) == 0
    assert (tmp_path / "a.mcq").read_bytes() == (tmp_path / "b.mcq").read_bytes()
    for flag in (["--disable-gpu"], ["--device", "cpu"]):
        assert main([*flag, "--local", str(TINY), str(tmp_path / "a.mcq"),
                     str(tmp_path / f"{flag[-1]}.png")]) == 0
    restored = readPng(tmp_path / "--disable-gpu.png")
    assert restored.shape == image.shape
    np.testing.assert_array_equal(restored, readPng(tmp_path / "cpu.png"))
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        main(["--local", str(TINY), str(tmp_path / "in.png"), str(tmp_path / "c.mcq")])


def test_console_scripts_resolve_to_the_port(monkeypatch, capsys):
    import importlib
    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]["scripts"]
    assert {k: v for k, v in scripts.items() if not k.startswith("mcquic-torch")} == {
        "mcquic": "mcquic_tpu.cli:entryPoint", "mcquic-train": "mcquic_tpu.cli:train",
        "mcquic-validate": "mcquic_tpu.cli:validate", "mcquic-dataset": "mcquic_tpu.cli:dataset"}
    ours = {k: v for k, v in scripts.items() if k.startswith("mcquic-torch")}
    assert ours == {"mcquic-torch": "mcquic_tpu_torch.cli:main",
                    "mcquic-torch-train": "mcquic_tpu_torch.cli:train",
                    "mcquic-torch-validate": "mcquic_tpu_torch.cli:validate",
                    "mcquic-torch-dataset": "mcquic_tpu_torch.cli:dataset"}
    for name, target in ours.items():
        module, function = target.split(":")
        entry = getattr(importlib.import_module(module), function)
        monkeypatch.setattr(sys, "argv", [name, "-h"])
        with pytest.raises(SystemExit) as exit:
            entry()
        assert exit.value.code == 0
        usage = capsys.readouterr().out
        command = name.removeprefix("mcquic-torch").lstrip("-")
        assert usage.startswith(f"usage: python -m mcquic_tpu_torch {command}".rstrip())
