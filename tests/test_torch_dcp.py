"""MCQUIC_CKPT_BACKEND=orbax: the stage-1 trainer's sharded checkpoints
through `torch.distributed.checkpoint` (`train/dcp_saver.py`), on the CPU
over gloo.

This file is also its own worker:

    python tests/test_torch_dcp.py RANK WORLD PORT CASE OUTDIR

joins a gloo group of WORLD processes on localhost:PORT through the port's
three variables (one process without them where WORLD is 1) and runs CASE
with MCQUIC_CKPT_BACKEND=orbax:
  * `run`: the tiny v1 Compressor (fp64, drawn from SEED) through
    `Trainer.train` for STEPS steps at the global batch GLOBAL_BATCH, each
    rank on its slice, the optimizer's state sharded (ZeRO), a DCP step
    saved after every step (MCQUIC_SAVE_FREQ=1, asynchronous); it writes the
    rank's state after step RESUME_AT and at the end;
  * `resume`: the same trainer over a saveDir holding only the run's step
    RESUME_AT (`dcp/RESUME_AT`), resumed by `tryResume` and trained to
    STEPS; it writes the state right after the resume and at the end.
Each state is OUTDIR/CASE_WORLD/rank{RANK}_{when}.npz: the model's state
dict (parameters and code frequencies), the optimizer's whole slots
(`Optimizer.wholeSlot`), its count, the step and the torch generator's
state.

The tests hold the resumes to the uninterrupted world-2 run: at world 2
everything is bit-identical, right after the resume and at the end; at
world 1 (each slot read whole from the two ranks' shards) the resumed state
is bit-identical, and the end within STATE_RTOL and RTOL of the two ranks'
(one process sums the global batch in another order, the tolerances of
`tests/test_torch_ddp.py`). In process: retention bounded by `maxItems`,
an asynchronous save copied before `save` returns, a step on disk skipped
unless forced, the JAX run's `orbax/` refused and `GenTrainer` refusing the
backend.
"""
import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from mcquic_tpu_torch import parallel  # noqa: E402
from mcquic_tpu_torch.config import Config  # noqa: E402

SEED = 3407
STEPS = 4
RESUME_AT = 2
GLOBAL_BATCH = 4
EDGE = 64
RTOL = 1e-9              # code frequencies and counts (tests/test_torch_ddp.py)
STATE_RTOL = 1e-5        # parameters and moments, of each tensor's largest magnitude
WORKER_TIMEOUT = 240


def writeConfig(folder: Path, world: int) -> Path:
    folder.mkdir(parents=True, exist_ok=True)
    config = folder / "config.yaml"
    config.write_text(f"""model: {{key: Compressor, params: {{channel: 8, m: 2, k: [16, 8]}}}}
train:
  totalStep: {STEPS}
  batchSize: {GLOBAL_BATCH // world}
  epoch: 100
  valFreq: 1000
  trainSet: {folder}
  valSet: {folder}
  saveDir: {folder / 'saved'}
  target: PSNR
  optim: {{key: Adam, params: {{lr: 1.0e-3}}}}
  schdr:
    key: CosineAnnealingWarmupRestarts
    params: {{first_cycle_steps: 10, warmup_steps: 1, lrScaleRatio: 0.001}}
  gpu: {{gpus: 1, vRam: -1, wantsMore: false}}
""")
    return config


def buildTrainer(config: Path):
    from mcquic_tpu_torch.models.compressor import buildModel, initialize
    from mcquic_tpu_torch.train.trainer import Trainer, resolveStage1Model
    cfg = Config.load(str(config))
    _, geometry = resolveStage1Model(cfg)
    model = initialize(buildModel(geometry), torch.Generator().manual_seed(SEED)).double()
    return Trainer(cfg, model=model, device="cpu", lpipsFn=False)


def dump(trainer, out: Path):
    arrays = {f"state/{k}": v.detach().numpy() for k, v in trainer.model.state_dict().items()}
    optimizer = trainer.optimizer
    for slot in optimizer.state:
        for i in range(len(optimizer.params)):
            arrays[f"opt/{slot}/{i:04d}"] = optimizer.wholeSlot(slot, i).detach().numpy()
    arrays["rng"] = trainer._generator.get_state().numpy()
    np.savez(out, **arrays)
    out.with_suffix(".json").write_text(json.dumps({"step": trainer.step,
                                                    "count": optimizer.count}))


def runCase(case: str, folder: Path):
    rank, world = parallel.rank(), parallel.world()
    trainer = buildTrainer(folder / "config.yaml")
    images = np.random.default_rng(0).integers(0, 256, (STEPS, GLOBAL_BATCH, EDGE, EDGE, 3),
                                               dtype=np.uint8)
    n = GLOBAL_BATCH // world
    rows = slice(rank * n, (rank + 1) * n)
    if case == "resume":
        assert trainer.tryResume()
        dump(trainer, folder / f"rank{rank}_restored.npz")
    else:
        trainStep = trainer.trainStep

        def dumpAtResume(batch):
            metrics = trainStep(batch)
            if trainer.step == RESUME_AT:
                dump(trainer, folder / f"rank{rank}_restored.npz")
            return metrics

        trainer.trainStep = dumpAtResume

    def loaderFn():
        for s in range(trainer.step, STEPS):
            yield images[s, rows]

    trainer.train(loaderFn)
    dump(trainer, folder / f"rank{rank}_final.npz")


def _worker(argv):
    rank, world, port, case, outdir = argv
    os.environ.update(MCQUIC_CKPT_BACKEND="orbax", MCQUIC_SAVE_FREQ="1")
    if int(world) > 1:
        os.environ.update(MCQUIC_COORDINATOR=f"localhost:{port}", MCQUIC_NUM_PROCESSES=world,
                          MCQUIC_PROCESS_ID=rank)
    torch.set_num_threads(1)
    parallel.initDistributed("cpu")
    try:
        runCase(case, Path(outdir) / f"{case}_{world}")
    finally:
        parallel.destroy()


if __name__ == "__main__":
    _worker(sys.argv[1:])
    sys.exit(0)


# ----------------------------------------------------------------- the tests
import pytest  # noqa: E402


def freePort() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(world: int, case: str, outdir: Path):
    writeConfig(outdir / f"{case}_{world}", world)
    port = freePort()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), str(r), str(world),
                              str(port), case, str(outdir)], cwd=ROOT, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]


def join(procs):
    for proc in procs:
        try:
            _, err = proc.communicate(timeout=WORKER_TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
        assert proc.returncode == 0, err[-4000:]


def load(path: Path):
    return dict(np.load(path)), json.loads(path.with_suffix(".json").read_text())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dcp")
    join(spawn(2, "run", out))
    steps = sorted(p.name for p in (out / "run_2" / "saved" / "dcp").iterdir())
    resumes = []
    for world in (2, 1):
        dcpDir = out / f"resume_{world}" / "saved" / "dcp"
        dcpDir.mkdir(parents=True)
        shutil.copytree(out / "run_2" / "saved" / "dcp" / str(RESUME_AT), dcpDir / str(RESUME_AT))
        resumes += spawn(world, "resume", out)
    join(resumes)
    return out, steps


def test_every_step_was_saved_by_both_ranks(runs):
    out, steps = runs
    assert steps == [str(s) for s in range(1, STEPS + 1)]
    step = out / "run_2" / "saved" / "dcp" / str(RESUME_AT)
    assert sorted(p.name for p in step.iterdir()) == [".metadata", "__0_0.distcp", "__1_0.distcp"]
    assert not (out / "run_2" / "saved" / "latest" / "saved.ckpt.npz").exists()


@pytest.mark.parametrize("world", [2, 1])
def test_resume_reads_the_saved_state_exactly(runs, world):
    out, _ = runs
    saved, savedMeta = load(out / "run_2" / "rank0_restored.npz")
    for rank in range(world):
        restored, meta = load(out / f"resume_{world}" / f"rank{rank}_restored.npz")
        assert meta == savedMeta == {"step": RESUME_AT, "count": RESUME_AT}
        assert set(restored) == set(saved)
        for key in saved:
            np.testing.assert_array_equal(restored[key], saved[key], err_msg=key)


def test_resume_at_world_2_continues_bit_for_bit(runs):
    out, _ = runs
    for rank in range(2):
        theirs, theirMeta = load(out / "run_2" / f"rank{rank}_final.npz")
        ours, meta = load(out / "resume_2" / f"rank{rank}_final.npz")
        assert meta == theirMeta == {"step": STEPS, "count": STEPS}
        for key in theirs:
            np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)


def test_resume_at_world_1_continues_as_the_two_ranks(runs):
    out, _ = runs
    theirs, theirMeta = load(out / "run_2" / "rank0_final.npz")
    ours, meta = load(out / "resume_1" / "rank0_final.npz")
    assert meta == theirMeta == {"step": STEPS, "count": STEPS}
    np.testing.assert_array_equal(ours["rng"], theirs["rng"])
    for key in theirs:
        if "_freqEMA" in key:
            np.testing.assert_allclose(ours[key], theirs[key], rtol=RTOL, err_msg=key)
        elif key != "rng":
            scale = max(float(np.abs(theirs[key]).max()), 1e-30)
            np.testing.assert_allclose(ours[key], theirs[key], rtol=0, atol=STATE_RTOL * scale,
                                       err_msg=key)


def test_retention_keeps_the_newest_steps(tmp_path):
    from mcquic_tpu_torch.train.dcp_saver import DcpSaver
    saver = DcpSaver(tmp_path, maxItems=3)
    value = torch.zeros(8)
    for step in range(1, 7):
        value.fill_(step)
        assert saver.save(step, {"step": step, "value": value})
        value.fill_(-1.0)                    # the save copied the state before returning
    saver.waitUntilFinished()
    assert saver.steps() == [4, 5, 6] and saver.latestStep() == 6
    template = {"step": 0, "value": torch.empty(8)}
    saver.restore(template, 5)
    assert template["step"] == 5 and torch.equal(template["value"], torch.full((8,), 5.0))
    assert not saver.save(6, {"step": 6, "value": value})
    assert saver.save(6, {"step": 6, "value": value}, force=True)
    saver.close()
    saver.restore(template)
    assert template["step"] == 6 and torch.equal(template["value"], torch.full((8,), -1.0))
    assert saver.steps() == [4, 5, 6]


def test_a_jax_runs_orbax_directory_is_refused(tmp_path, monkeypatch):
    monkeypatch.setenv("MCQUIC_CKPT_BACKEND", "orbax")
    (tmp_path / "saved" / "orbax" / "7").mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax checkpoint"):
        buildTrainer(writeConfig(tmp_path, 1))
    monkeypatch.delenv("MCQUIC_CKPT_BACKEND")
    from mcquic_tpu_torch.train.trainer import Trainer
    with pytest.raises(ValueError, match="orbax checkpoint"):
        Trainer(Config.load(str(writeConfig(tmp_path, 1))), device="cpu", lpipsFn=False,
                ckptBackend="orbax")


def test_the_gen_trainer_refuses_the_backend(tmp_path, monkeypatch):
    from mcquic_tpu_torch.train.genTrainer import GenTrainer
    config = tmp_path / "gen.yaml"
    config.write_text(f"""model: {{key: GeneratorV3SelfAttention, params: {{channel: 8, k: 16,
  size: [2, 1, 1], hiddenSize: 32, depth: 1, nHeads: 4, numClasses: 10}}}}
train:
  totalStep: 2
  batchSize: 2
  epoch: 1
  valFreq: 100
  trainSet: {tmp_path}
  valSet: {tmp_path}
  saveDir: {tmp_path / 'saved'}
  target: MsSSIM
  optim: {{key: Adam, params: {{lr: 1.0e-4}}}}
  schdr: {{key: Placeholder, params: {{}}}}
  gpu: {{gpus: 1, vRam: -1, wantsMore: false}}
""")
    monkeypatch.setenv("MCQUIC_CKPT_BACKEND", "orbax")
    with pytest.raises(NotImplementedError, match="GenTrainer has no such backend"):
        GenTrainer(Config.load(str(config)), device="cpu")
