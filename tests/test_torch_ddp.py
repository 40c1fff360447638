"""Data-parallel training of the port across processes, on the CPU over gloo.

This file is also its own worker:

    python tests/test_torch_ddp.py RANK WORLD PORT CASES OUTDIR

sets MCQUIC_COORDINATOR=localhost:PORT, MCQUIC_NUM_PROCESSES=WORLD and
MCQUIC_PROCESS_ID=RANK, starts the process group with
`parallel.initDistributed("cpu")` (gloo), and runs each comma-separated
case in turn: `reduce` (the flat-buffer mean), or a model trained for two
steps through the port's trainers on its slice of the global batch, from
OUTDIR/CASE_WORLD/config.yaml, its state written to
OUTDIR/CASE_WORLD/rank{RANK}.npz. One module fixture (`runs`) starts two
ranks through every case and four through v1, and runs the one-process
references meanwhile. The workers import torch, numpy
and the port only, and `tests/conftest.py` is not loaded in them.

`test_ranks_equal_one_process_at_the_global_batch` runs, for the tiny v1
`Compressor` (2 ranks x batch 2 and 4 ranks x batch 1, with a validation on
rank 0), the tiny Neon (remat, a reassign forced by zeroed frequencies) and
the tiny stage-2 generator over a tiny Neon, in fp64:
  * the ranks' parameters, `freqEMA`, optimizer state and logged metrics
    after 2 steps equal one process's at the global batch of 4 on the same
    4 images per step from the same seed, within the tolerances stated at
    RTOL (sums taken in another order);
  * the ranks' parameters and optimizer state (its shards gathered,
    `Optimizer.wholeSlot`) are bit-identical to each other;
  * only rank 0 held the save directory (its lock file names rank 0's
    process), validated and wrote `latest/`, and its checkpoint resumes in a
    one-process trainer.
The one-process v1 step at batch 1..4 is itself held to the JAX package's
step (`tests/test_torch_train_step.py`), so the chain from the ranks reaches
the JAX package's sharded step, which is one program at the global batch.

The train CLI runs as two processes under the three variables on two tar
shards, each rank reading its own (`-D` logs which), and writes one export;
`MCQUIC_MULTIHOST=auto` is refused; the loaders split shards and class files
by host as the JAX loaders do, and the stage-1 folder loader does not
split; `allReduceMean_` averages tensors of mixed shapes and dtypes (an
empty list too) and is a no-op without a process group.
"""
import json
import os
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

GLOBAL_BATCH = 4
STEPS = 2
SEED = 3407
# The models run in fp64 except where the port rounds to fp32 as the JAX
# package does (GDN's normalizer; the generator's RMSNorm, attention and
# logits). The ranks sum the global batch in another order than one
# process, so the tolerances follow what each value passes through:
#  * RTOL, 1e-9 relative: the stage-1 metrics (fp64 sums; measured at most
#    2e-15) and the code frequencies (sums of exact counts);
#  * GEN_METRIC_RTOL, 16 fp32 ulps (ROADMAP C7's generator tolerance): the
#    generator's loss and per-level CE, fp32 sums of fp32 logits (measured
#    1.3e-7);
#  * STATE_RTOL, 1e-5 of each tensor's largest magnitude: parameters and
#    optimizer moments, whose gradients behind an fp32 rounding are fp32
#    sums over batch x pixels with cancellation (measured 1.6e-6, Adam's
#    first moment of a GDN-fed convolution, v1 at 4 ranks).
RTOL = 1e-9
GEN_METRIC_RTOL = 16 * 2.0 ** -24
STATE_RTOL = 1e-5
WORKER_TIMEOUT = 240
CASES = {
    "v1": "{key: Compressor, params: {channel: 8, m: 2, k: [16, 8]}}",
    "neon": "{key: Neon, params: {channel: 8, k: 16, size: [1, 1]}}",
    "gen": ("{key: GeneratorV3SelfAttention, params: {channel: 8, k: 16, size: [2, 1, 1], "
            "hiddenSize: 32, depth: 1, nHeads: 4, numClasses: 10}}"),
}
EDGE = {"v1": 64, "neon": 16, "gen": 32}


def writeConfig(folder: Path, case: str, world: int, valSet: Path) -> Path:
    """folder/config.yaml: the case at batch GLOBAL_BATCH / world, saving to
    folder/saved, the reassign hook every step for the stage-1 models (it
    fires after step 1), a validation at step 2 for v1."""
    folder.mkdir(parents=True, exist_ok=True)
    hooks = "" if case == "gen" else "  hooks:\n    - {key: CodebookReassign, params: {freq: 1}}\n"
    config = folder / "config.yaml"
    config.write_text(f"""model: {CASES[case]}
train:
  totalStep: {STEPS}
  batchSize: {GLOBAL_BATCH // world}
  epoch: 100
  valFreq: {2 if case == 'v1' else 1000}
  trainSet: {valSet}
  valSet: {valSet}
  saveDir: {folder / 'saved'}
  target: PSNR
  optim: {{key: Adam, params: {{lr: 1.0e-3}}}}
  schdr:
    key: CosineAnnealingWarmupRestarts
    params: {{first_cycle_steps: 10, warmup_steps: 1, lrScaleRatio: 0.001}}
{hooks}  gpu: {{gpus: 1, vRam: -1, wantsMore: false}}
""")
    return config


def batches(case: str):
    """STEPS global batches of uint8 NHWC images (and class ids)."""
    rng = np.random.default_rng(0)
    edge = EDGE[case]
    images = rng.integers(0, 256, (STEPS, GLOBAL_BATCH, edge, edge, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, (STEPS, GLOBAL_BATCH)).astype(np.int32)
    return images, labels


def buildTrainer(case: str, config: Path):
    """The case's trainer on the CPU, its model drawn from SEED in fp64."""
    cfg = Config.load(str(config))
    if case == "gen":
        from mcquic_tpu_torch.train.genTrainer import (GenTrainer, constructGenerator,
                                                       initializeGenerator)
        params = dict(cfg.Model.Params)
        model = initializeGenerator(constructGenerator(cfg.Model.Key, params),
                                    torch.Generator().manual_seed(SEED)).double()
        return GenTrainer(cfg, model=model, device="cpu")
    from mcquic_tpu_torch.models.compressor import buildModel, initialize
    from mcquic_tpu_torch.train.trainer import Trainer, resolveStage1Model
    _, geometry = resolveStage1Model(cfg)
    model = initialize(buildModel(geometry), torch.Generator().manual_seed(SEED)).double()
    if case == "neon":
        with torch.no_grad():                # every other codeword starts dead
            for freq in model._quantizer.frequencies():
                freq[:, ::2] = 0.0
    return Trainer(cfg, model=model, device="cpu", lpipsFn=False)


def runCase(case: str, config: Path, out: Path):
    """Train the case for STEPS steps on this rank's slice of each global
    batch and write the rank's state to `out` (npz, json beside)."""
    rank, world = parallel.rank(), parallel.world()
    trainer = buildTrainer(case, config)
    images, labels = batches(case)
    n = GLOBAL_BATCH // world
    rows = slice(rank * n, (rank + 1) * n)
    metrics, reassigned, validations = [], [], []

    trainStep = trainer.trainStep

    def recordStep(*args):
        m = trainStep(*args)
        metrics.append({k: float(v) for k, v in m.items()})
        return m

    trainer.trainStep = recordStep
    if case != "gen":
        reassign, validate = trainer.reassignCodebooks, trainer.validate

        def recordReassign():
            reassigned.append(reassign())
            return reassigned[-1]

        def recordValidate(loader):
            validations.append(rank)
            return validate(loader)

        trainer.reassignCodebooks, trainer.validate = recordReassign, recordValidate

    def loaderFn():
        for s in range(STEPS):
            yield (images[s, rows], labels[s, rows]) if case == "gen" else images[s, rows]

    if case == "v1":
        from mcquic_tpu_torch.data import getValLoader
        trainer.train(loaderFn, valLoader=getValLoader(Config.load(str(config)).Train.ValSet))
    else:
        trainer.train(loaderFn)
    arrays = {f"state/{k}": v.detach().numpy() for k, v in trainer.model.state_dict().items()}
    optimizer = trainer.optimizer               # each rank holds its shards: gather them
    for slot in optimizer.state:
        for i in range(len(optimizer.params)):
            arrays[f"opt/{slot}/{i:04d}"] = optimizer.wholeSlot(slot, i).detach().numpy()
    np.savez(out, **arrays)
    out.with_suffix(".json").write_text(json.dumps({
        "pid": os.getpid(), "saver": trainer._saver is not None, "metrics": metrics,
        "count": trainer.optimizer.count, "reassigned": reassigned,
        "validations": validations}))


def _worker(argv):
    """RANK WORLD PORT CASES OUTDIR: join the group, then run each of the
    comma-separated CASES in turn, each from OUTDIR/CASE_WORLD."""
    rank, world, port, cases, outdir = argv
    os.environ.update(MCQUIC_COORDINATOR=f"localhost:{port}", MCQUIC_NUM_PROCESSES=world,
                      MCQUIC_PROCESS_ID=rank)
    torch.set_num_threads(1)
    assert parallel.initDistributed("cpu")
    try:
        for case in cases.split(","):
            folder = Path(outdir) / f"{case}_{world}"
            if case == "reduce":
                _reduce(folder)
            else:
                runCase(case, folder / "config.yaml", folder / f"rank{rank}.npz")
    finally:
        parallel.destroy()


def _reduce(folder: Path):
    """Rank r averages r + 1 in three tensors of mixed shapes and dtypes, and
    an empty list."""
    r = parallel.rank()
    tensors = [torch.full((2, 3), r + 1.0), torch.full((5,), 10.0 * (r + 1), dtype=torch.float64),
               torch.full((), r + 1.0), torch.zeros(0)]
    assert parallel.allReduceMean_([]) == []
    parallel.allReduceMean_(tensors)
    folder.mkdir(parents=True, exist_ok=True)
    np.savez(folder / f"rank{r}.npz", *[t.numpy() for t in tensors])


if __name__ == "__main__":
    _worker(sys.argv[1:])
    sys.exit(0)


# ----------------------------------------------------------------- the tests
import pytest  # noqa: E402


def freePort() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(world: int, cases: str, outdir: Path):
    port = freePort()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), str(r), str(world),
                              str(port), cases, str(outdir)], cwd=ROOT, env=env,
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


def _load(path: Path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}, json.loads(path.with_suffix(".json").read_text())


def _close(got, want, label, rtol):
    """The largest gap within rtol x the largest magnitude of `want`."""
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    gap = float(np.abs(np.asarray(got) - np.asarray(want)).max(initial=0.0))
    assert gap <= rtol * scale, f"{label}: max gap {gap:.3e} against {rtol:.1e} x {scale:.3e}"


def _rtol(case: str, key: str) -> float:
    """The tolerance of one compared value (see RTOL)."""
    if key.startswith("metric/"):
        return GEN_METRIC_RTOL if case == "gen" else RTOL
    if "._freqEMA." in key:
        return RTOL
    return STATE_RTOL


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's ranks and its one-process reference, run once: two
    ranks through reduce, v1, Neon and the generator in turn, four ranks
    through v1, and the references in this process meanwhile. Returns the
    folder holding `{case}_{world}/`."""
    from mcquic_tpu_torch.data.png import readPng, writePng
    root = tmp_path_factory.mktemp("ddp")
    valSet = root / "val"
    valSet.mkdir()
    writePng(valSet / "0.png", readPng(ROOT / "assets" / "photo_768x512.png")[:256, :256])
    for case, world in (("v1", 2), ("neon", 2), ("gen", 2), ("v1", 4), ("v1", 1), ("neon", 1),
                        ("gen", 1)):
        writeConfig(root / f"{case}_{world}", case, world, valSet)
    procs = spawn(2, "reduce,v1,neon,gen", root) + spawn(4, "v1", root)
    try:
        for case in ("v1", "neon", "gen"):
            runCase(case, root / f"{case}_1" / "config.yaml", root / f"{case}_1" / "rank0.npz")
    finally:
        join(procs)
    return root


@pytest.mark.parametrize("case,world", [("v1", 2), ("v1", 4), ("neon", 2), ("gen", 2)])
def test_ranks_equal_one_process_at_the_global_batch(runs, tmp_path, case, world):
    want, wantInfo = _load(runs / f"{case}_1" / "rank0.npz")
    ranks = [_load(runs / f"{case}_{world}" / f"rank{r}.npz") for r in range(world)]
    first, info = ranks[0]

    assert set(first) == set(want)
    for key in want:
        _close(first[key], want[key], key, _rtol(case, key))
    assert info["count"] == wantInfo["count"] == STEPS
    assert len(info["metrics"]) == len(wantInfo["metrics"]) == STEPS
    for s, (got, ref) in enumerate(zip(info["metrics"], wantInfo["metrics"])):
        assert got["skipped"] == ref["skipped"] == 0.0
        for key, value in ref.items():
            _close(got[key], value, f"step {s} {key}", _rtol(case, f"metric/{key}"))
    for other, otherInfo in ranks[1:]:
        for key in first:
            np.testing.assert_array_equal(other[key], first[key], err_msg=key)
        assert otherInfo["metrics"] == info["metrics"]
        assert otherInfo["reassigned"] == info["reassigned"]
        assert not otherInfo["saver"] and not otherInfo["validations"]
    if case != "gen":
        assert len(info["reassigned"]) == 1              # after step 1, not the terminal step
        _close(info["reassigned"][0], wantInfo["reassigned"][0], "reassigned", RTOL)
    if case == "neon":
        assert info["reassigned"][0] > 0                 # the dead codewords moved
    assert info["saver"] and info["validations"] == ([0] if case == "v1" else [])

    # rank 0 held the directory and wrote latest/; one process resumes it
    saved = runs / f"{case}_{world}" / "saved"
    assert (saved / ".lock").read_text() == str(info["pid"])
    best = ["best.ckpt.json", "best.ckpt.npz"] if case == "v1" else []
    assert sorted(p.name for p in (saved / "latest").iterdir()) == best + ["saved.ckpt.json",
                                                                         "saved.ckpt.npz"]
    config = writeConfig(tmp_path, case, 1, runs / "val")
    config.write_text(config.read_text().replace(f"saveDir: {tmp_path / 'saved'}",
                                                 f"saveDir: {saved}"))
    resumer = buildTrainer(case, config)
    try:
        assert resumer.tryResume() and resumer.step == STEPS
        state = resumer.model.state_dict()
        for key, value in first.items():
            if key.startswith("state/"):
                np.testing.assert_array_equal(state[key[6:]].numpy(), value, err_msg=key)
        for slot, tensors in resumer.optimizer.state.items():        # saved as fp32 leaves
            for i, t in enumerate(tensors):
                np.testing.assert_array_equal(
                    t.numpy(), first[f"opt/{slot}/{i:04d}"].astype(np.float32).astype(t.numpy().dtype))
    finally:
        resumer.close()


def test_all_reduce_mean_mixed_shapes_and_no_group(runs):
    """No process group: the helpers are no-ops and report rank 0 of 1. Two
    gloo ranks: the mean of r + 1 over ranks 0 and 1 is 1.5 in every tensor
    of every shape and dtype, and an empty list stays empty."""
    assert not parallel.initialized()
    assert (parallel.rank(), parallel.world(), parallel.isMain()) == (0, 1, True)
    tensors = [torch.ones(2, 3), torch.full((5,), 2.0, dtype=torch.float64), torch.tensor(3.0),
               torch.zeros(0)]
    before = [t.clone() for t in tensors]
    assert parallel.allReduceMean_(tensors) == tensors and parallel.allReduceMean_([]) == []
    assert parallel.allReduceSum_(tensors) == tensors
    for t, b in zip(tensors, before):
        assert torch.equal(t, b)
    parallel.barrier()
    assert parallel.broadcastObject("x") == "x"
    draw = parallel.shardedRows(lambda shape: torch.zeros(shape))
    assert draw((3, 2)).shape == (3, 2)

    for r in range(2):
        with np.load(runs / "reduce_2" / f"rank{r}.npz") as z:
            got = [z[f"arr_{i}"] for i in range(4)]
        np.testing.assert_array_equal(got[0], np.full((2, 3), 1.5, np.float32))
        np.testing.assert_array_equal(got[1], np.full((5,), 15.0))
        assert got[1].dtype == np.float64 and got[2].shape == () and float(got[2]) == 1.5
        assert got[3].shape == (0,)


def test_multihost_auto_is_refused(monkeypatch):
    monkeypatch.setenv("MCQUIC_MULTIHOST", "auto")
    with pytest.raises(NotImplementedError, match="MCQUIC_COORDINATOR, MCQUIC_NUM_PROCESSES, "
                                                  "MCQUIC_PROCESS_ID"):
        parallel.initDistributed("cpu")
    from mcquic_tpu_torch.train.cli import main
    with pytest.raises(NotImplementedError, match="MCQUIC_MULTIHOST=auto"):
        main(ROOT / "configs" / "rd3" / "rd_qp2.yaml", device="cpu")
    monkeypatch.delenv("MCQUIC_MULTIHOST")
    monkeypatch.setenv("MCQUIC_COORDINATOR", "localhost:1")
    with pytest.raises(ValueError, match="MCQUIC_NUM_PROCESSES, MCQUIC_PROCESS_ID"):
        parallel.initDistributed("cpu")
    assert not parallel.initialized()
