"""ZeRO: the optimizer's state sharded across processes, on the CPU over gloo.

This file is also its own worker:

    python tests/test_torch_zero.py RANK WORLD PORT CASES OUTDIR

joins a gloo group of WORLD processes on localhost:PORT through the port's
three variables (`parallel.initDistributed("cpu")`) and runs each
comma-separated case in turn, writing OUTDIR/CASE_WORLD/rank{RANK}.npz
(json beside):
  * `optim`: every update rule (RULES) over the tiny v1 Compressor's
    parameters (fp32, drawn from SEED) for STEPS steps, fed the same
    gradients on every rank, as the step's all-reduce leaves them (`gradsAt`);
    it writes the parameters, the whole slots (`Optimizer.wholeSlot`), the
    slot bytes the rank holds, and on rank 0 the checkpoint's optimizer
    leaves (`OptaxLayout.leaves`);
  * `resume`: Adam and SGD resumed from the world-2 run's checkpoint
    (its parameters and leaves, through `OptaxLayout.load`) for STEPS more
    steps;
  * `neon`: the tiny Neon trained for 2 steps through the stage-1 trainer
    (`tests/test_torch_ddp.py`'s case, the shared-codebook reassign after
    step 1) with its state sharded, then again with `parallel.zeroSpec`
    replaced by a function that shards nothing, each saving a checkpoint;
  * `sigterm`: the tiny v1 trained for up to 50 steps, SIGTERM sent to rank
    1 alone during step 2.

The tests hold them to one process: the unsharded optimizer fed the same
gradients (the reference, built here), bit-identical for Adam, AdamW and
SGD (elementwise rules) and within LAMB_RTOL for LAMB, whose trust ratio
takes a sharded tensor's norm from the ranks' sums of squares. The
checkpoints' leaves are fp32 (optax's), so the optimizer cases run in fp32;
the Neon case runs in fp64 as the DDP tests do.
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
for path in (ROOT, ROOT / "tests"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

from mcquic_tpu_torch import parallel  # noqa: E402
from mcquic_tpu_torch.models.compressor import Compressor, initialize  # noqa: E402
from mcquic_tpu_torch.train import optim  # noqa: E402
from mcquic_tpu_torch.train.saver import OptaxLayout  # noqa: E402
from mcquic_tpu_torch.utils.convert import compressorMap  # noqa: E402

SEED = 3407
STEPS = 2
TINY_V1 = dict(channel=8, m=2, k=[16, 8])
RULES = {"adam": ("Adam", {}), "adamw": ("AdamW", {"weight_decay": 0.01}),
         "sgd": ("SGD", {"momentum": 0.9, "weight_decay": 1e-3}),
         "nesterov": ("SGD", {"momentum": 0.9, "nesterov": True}),
         "lamb": ("Lamb", {"weight_decay": 0.01})}
RESUMED = ("adam", "sgd")
# LAMB: a sharded tensor's norms are sqrt(sum over ranks of the squared
# norms of the slices), the unsharded one's one fp32 norm, a few ulps apart;
# the trust ratio carries that into the update. Relative to each tensor's
# largest magnitude.
LAMB_RTOL = 1e-6
WORKER_TIMEOUT = 240


def schedule(count: int) -> float:
    return 1e-2 / (1 + count)


def tinyV1():
    """The tiny v1 Compressor drawn from SEED (fp32) and its name map."""
    model = initialize(Compressor(**TINY_V1), torch.Generator().manual_seed(SEED))
    return model, compressorMap(len(TINY_V1["k"]))


def makeOptimizer(rule: str, params):
    key, kwargs = RULES[rule]
    return optim.getOptimizer(key, schedule, dict(kwargs, lr=1e-2), params)


def gradsAt(step: int, params):
    """Step `step`'s gradients, the same on every rank (seeded by the step)."""
    rng = np.random.default_rng(1000 + step)
    return [torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
            for p in params]


def stepThrough(optimizer, first: int, last: int):
    for s in range(first, last):
        optimizer.step(gradsAt(s, optimizer.params))


def collect(model, optimizer, layout) -> dict:
    """The parameters, the whole slots, and on rank 0 the optimizer's
    checkpoint leaves (every rank takes part in the gathers)."""
    arrays = {f"param/{k}": v.detach().numpy().copy() for k, v in model.state_dict().items()}
    for slot in optimizer.state:
        for i in range(len(optimizer.params)):
            arrays[f"slot/{slot}/{i:04d}"] = optimizer.wholeSlot(slot, i).detach().numpy().copy()
    leaves = layout.leaves(optimizer, model.state_dict())
    arrays.update(leaves or {})
    return arrays


def stateInfo(optimizer) -> dict:
    sharded = sum(t.numel() * t.element_size() for ts in optimizer.state.values()
                  for t, axis in zip(ts, optimizer.axes) if axis is not None)
    return {"bytes": optimizer.stateBytes(), "shardedBytes": sharded, "axes": optimizer.axes,
            "count": optimizer.count}


def runOptim(rule: str):
    model, mp = tinyV1()
    names = [n for n, _ in model.named_parameters()]
    optimizer = makeOptimizer(rule, list(model.parameters()))
    stepThrough(optimizer, 0, STEPS)
    return collect(model, optimizer, OptaxLayout(mp, names)), stateInfo(optimizer)


def runResume(rule: str, checkpoint: dict):
    """The tiny v1 at the checkpoint's parameters, its optimizer from the
    checkpoint's leaves, STEPS more steps."""
    model, mp = tinyV1()
    with torch.no_grad():
        for key, value in model.state_dict().items():
            value.copy_(torch.from_numpy(checkpoint[f"param/{key}"]))
    names = [n for n, _ in model.named_parameters()]
    layout = OptaxLayout(mp, names)
    optimizer = makeOptimizer(rule, list(model.parameters()))
    layout.load(optimizer, model.state_dict(),
                {k: v for k, v in checkpoint.items() if k.startswith("optState/")})
    stepThrough(optimizer, STEPS, 2 * STEPS)
    return collect(model, optimizer, layout), stateInfo(optimizer)


def runNeon(folder: Path, valSet: Path):
    """The tiny Neon trained sharded, then with nothing sharded; the rank's
    slot bytes of each."""
    import test_torch_ddp as ddp
    info = {}
    original = parallel.zeroSpec
    for name in ("sharded", "unsharded"):
        config = ddp.writeConfig(folder / name, "neon", parallel.world(), valSet)
        if name == "unsharded":
            parallel.zeroSpec = lambda shape, world: None
        try:
            trainer = ddp.buildTrainer("neon", config)
        finally:
            parallel.zeroSpec = original
        images, _ = ddp.batches("neon")
        n = ddp.GLOBAL_BATCH // parallel.world()
        rows = slice(parallel.rank() * n, (parallel.rank() + 1) * n)
        reassigned = []
        reassign = trainer.reassignCodebooks
        trainer.reassignCodebooks = lambda: reassigned.append(reassign()) or reassigned[-1]
        trainer.train(lambda: (images[s, rows] for s in range(ddp.STEPS)))
        info[name] = {**stateInfo(trainer.optimizer), "reassigned": reassigned}
    return info


def runSigterm(folder: Path, valSet: Path) -> dict:
    """The tiny v1 trained for up to 50 steps; rank 1 alone receives
    SIGTERM during step 2. Returns the step each rank stopped at and how."""
    import signal
    import test_torch_ddp as ddp
    config = ddp.writeConfig(folder, "v1", parallel.world(), valSet)
    config.write_text(config.read_text().replace("totalStep: 2", "totalStep: 50"))
    trainer = ddp.buildTrainer("v1", config)
    images, _ = ddp.batches("v1")
    n = ddp.GLOBAL_BATCH // parallel.world()
    rows = slice(parallel.rank() * n, (parallel.rank() + 1) * n)
    trainStep = trainer.trainStep

    def step(batch):
        if parallel.rank() == 1 and trainer.step == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return trainStep(batch)

    trainer.trainStep = step
    try:
        trainer.train(lambda: (images[s % ddp.STEPS, rows] for s in range(100)))
        code = 0
    except SystemExit as exit:
        code = exit.code
    return {"step": trainer.step, "code": code}


def _worker(argv):
    rank, world, port, cases, outdir = argv
    os.environ.update(MCQUIC_COORDINATOR=f"localhost:{port}", MCQUIC_NUM_PROCESSES=world,
                      MCQUIC_PROCESS_ID=rank)
    torch.set_num_threads(1)
    assert parallel.initDistributed("cpu")
    outdir = Path(outdir)
    try:
        for case in cases.split(","):
            folder = outdir / f"{case}_{world}"
            folder.mkdir(parents=True, exist_ok=True)
            if case in ("neon", "sigterm"):
                info = (runNeon if case == "neon" else runSigterm)(folder, outdir / "val")
                (folder / f"rank{rank}.json").write_text(json.dumps(info))
                continue
            for rule in (RESUMED if case == "resume" else RULES):
                if case == "resume":
                    with np.load(outdir / "optim_2" / f"{rule}_rank0.npz") as z:
                        arrays, info = runResume(rule, {k: z[k] for k in z.files})
                else:
                    arrays, info = runOptim(rule)
                np.savez(folder / f"{rule}_rank{rank}.npz", **arrays)
                (folder / f"{rule}_rank{rank}.json").write_text(json.dumps(info))
    finally:
        parallel.destroy()


if __name__ == "__main__":
    _worker(sys.argv[1:])
    sys.exit(0)


# ----------------------------------------------------------------- the tests
import pytest  # noqa: E402


def spawn(world: int, cases: str, outdir: Path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
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


def load(path: Path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}, json.loads(path.with_suffix(".json").read_text())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """World 2 through the optimizer and Neon cases, then world 4 through
    the resume from world 2's checkpoint, while this process runs the
    unsharded references. Returns the folder holding `{case}_{world}/`."""
    from mcquic_tpu_torch.data.png import readPng, writePng
    root = tmp_path_factory.mktemp("zero")
    (root / "val").mkdir()
    writePng(root / "val" / "0.png", readPng(ROOT / "assets" / "photo_768x512.png")[:64, :64])
    procs = spawn(2, "optim,neon,sigterm", root)
    references = {}
    try:
        for rule in RULES:
            references[rule] = runOptim(rule)
            model, mp = tinyV1()
            optimizer = makeOptimizer(rule, list(model.parameters()))
            stepThrough(optimizer, 0, 2 * STEPS)
            names = [n for n, _ in model.named_parameters()]
            references[rule + "/uninterrupted"] = collect(model, optimizer, OptaxLayout(mp, names))
    finally:
        join(procs)
    procs = spawn(4, "resume", root)
    try:
        for rule in RESUMED:
            arrays, _ = load(root / "optim_2" / f"{rule}_rank0.npz")
            references[rule + "/resumed_1"] = runResume(rule, arrays)[0]
    finally:
        join(procs)
    return root, references


def _axis(spec) -> object:
    spec = tuple(spec)
    return spec.index("data") if "data" in spec else None


def _leafShapes(name: str):
    """The torch parameters' shapes and the flax leaves' shapes of a tiny
    geometry."""
    from mcquic_tpu_torch.models.compressor import Neon
    from mcquic_tpu_torch.models.generator import GeneratorV3SelfAttention
    from mcquic_tpu_torch.models.generator_var import GeneratorVAR
    from mcquic_tpu_torch.utils.convert import toJaxGeneratorParams, toJaxParams, halvingOf
    if name == "v1":
        model = Compressor(**TINY_V1)
        flat = toJaxParams(model.state_dict(), TINY_V1)
    elif name == "neon":
        geometry = dict(channel=8, k=16, size=[16, 8, 4, 2, 2])
        model = Neon(**geometry)
        flat = toJaxParams(model.state_dict(), geometry)
    elif name == "generator":
        model = GeneratorV3SelfAttention(channel=8, k=16, size=(2, 1, 1), hiddenSize=32, depth=1,
                                         nHeads=4, numClasses=10)
        flat = toJaxGeneratorParams(model.state_dict(), halvingOf(model.size), 1)
    else:
        model = GeneratorVAR(channel=8, k=16, size=(2, 1, 1), depth=2, embedDim=64, nHeads=4,
                             numClasses=10)
        flat = toJaxGeneratorParams(model.state_dict(), halvingOf(model.size), 2, var=True)
    return [tuple(p.shape) for p in model.parameters()] + [tuple(v.shape) for v in flat.values()]


@pytest.mark.parametrize("geometry", ["v1", "neon", "generator", "var"])
def test_zero_spec_is_the_jax_rule(geometry):
    """`zeroSpec` picks the axis of `mcquic_tpu.parallel._zeroSpecForLeaf`
    on every torch parameter and every flax leaf, at worlds 2, 3 and 4."""
    from mcquic_tpu.parallel import _zeroSpecForLeaf
    shapes = _leafShapes(geometry)
    sharded = 0
    for world in (2, 3, 4):
        for shape in shapes:
            want = _axis(_zeroSpecForLeaf(np.empty(shape, np.float32), world))
            assert parallel.zeroSpec(shape, world) == want, (shape, world)
            sharded += want is not None
    assert sharded > len(shapes)                  # most leaves shard somewhere
    assert parallel.zeroSpec((), 2) is None and parallel.zeroSpec((6, 6), 4) is None
    assert parallel.zeroSpec((8, 8), 2) == 1 and parallel.zeroSpec((3, 8, 4), 4) == 1


@pytest.mark.parametrize("rule", list(RULES))
def test_sharded_optimizer_equals_unsharded(runs, rule):
    """At world 2 the gathered parameters, the whole slots and the
    checkpoint's leaves equal the unsharded optimizer's on the same
    gradients: bit for bit, LAMB within LAMB_RTOL; the ranks agree bit for
    bit."""
    root, references = runs
    want, _ = references[rule]
    ranks = [load(root / "optim_2" / f"{rule}_rank{r}.npz") for r in range(2)]
    (first, info), (second, _) = ranks
    assert info["count"] == STEPS
    assert set(first) == set(want)
    assert not any(k.startswith("optState/") for k in second)
    assert set(second) == {k for k in want if not k.startswith("optState/")}
    for key, value in want.items():
        if rule == "lamb":
            scale = max(float(np.abs(value).max(initial=0.0)), 1e-30)
            assert float(np.abs(first[key] - value).max(initial=0.0)) <= LAMB_RTOL * scale, key
        else:
            np.testing.assert_array_equal(first[key], value, err_msg=key)
        if key in second:
            np.testing.assert_array_equal(second[key], first[key], err_msg=key)


def test_slot_bytes_shrink_by_the_world(runs):
    """Each rank holds 1/world of the sharded parameters' slots and the
    replicated ones whole; SGD without momentum has no slot to shard."""
    root, references = runs
    for rule in RULES:
        whole = references[rule][1]
        assert whole["axes"] == [None] * len(whole["axes"]) and whole["shardedBytes"] == 0
        for r in range(2):
            _, info = load(root / "optim_2" / f"{rule}_rank{r}.npz")
            axes = info["axes"]
            assert sum(a is not None for a in axes) > 0.9 * len(axes)
            model, _ = tinyV1()
            slots = len(optim.getOptimizer(RULES[rule][0], schedule, dict(RULES[rule][1]),
                                           list(model.parameters())).state)
            full = [p.numel() * 4 * slots for p in model.parameters()]
            shardedFull = sum(f for f, a in zip(full, axes) if a is not None)
            assert info["shardedBytes"] * 2 == shardedFull
            assert info["bytes"] == whole["bytes"] - shardedFull // 2
    sgd = optim.getOptimizer("SGD", schedule, {}, list(tinyV1()[0].parameters()))
    assert sgd.stateBytes() == 0


@pytest.mark.parametrize("world", [1, 4])
def test_world_2_checkpoint_resumes_at_another_world(runs, world):
    """World 2's checkpoint resumes at world 1 and at world 4 and continues
    as the uninterrupted unsharded run does, bit for bit (Adam and SGD):
    parameters, whole slots and leaves."""
    root, references = runs
    for rule in RESUMED:
        want = references[rule + "/uninterrupted"]
        if world == 1:
            got = references[rule + "/resumed_1"]
        else:
            got, info = load(root / "resume_4" / f"{rule}_rank0.npz")
            assert info["count"] == 2 * STEPS and any(a is not None for a in info["axes"])
            for r in range(1, 4):
                other, _ = load(root / "resume_4" / f"{rule}_rank{r}.npz")
                for key in other:
                    np.testing.assert_array_equal(other[key], got[key], err_msg=key)
        assert set(got) == set(want)
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value, err_msg=f"{rule} {key}")


def test_neon_trains_sharded_as_unsharded(runs):
    """The tiny Neon trained by two ranks with its state sharded (the
    shared-codebook reassign after step 1) writes a checkpoint whose every
    array equals the same run's with nothing sharded; each rank held about
    half the sharded slots."""
    root, _ = runs
    sharded, _ = load_checkpoint(root / "neon_2" / "sharded")
    unsharded, _ = load_checkpoint(root / "neon_2" / "unsharded")
    assert set(sharded) == set(unsharded) and any(k.startswith("optState/") for k in sharded)
    for key, value in unsharded.items():
        np.testing.assert_array_equal(sharded[key], value, err_msg=key)
    for r in range(2):
        info = json.loads((root / "neon_2" / f"rank{r}.json").read_text())
        assert info["sharded"]["reassigned"] == info["unsharded"]["reassigned"]
        assert len(info["sharded"]["reassigned"]) == 1 and info["sharded"]["reassigned"][0] > 0
        assert info["unsharded"]["shardedBytes"] == 0
        assert info["sharded"]["shardedBytes"] > 0
        assert (info["unsharded"]["bytes"] - info["sharded"]["bytes"]
                == info["sharded"]["shardedBytes"])


def load_checkpoint(folder: Path):
    from mcquic_tpu_torch.utils.convert import readExport
    return readExport(folder / "saved" / "latest" / "saved.ckpt.npz")


def test_sigterm_on_one_rank_saves_at_the_end_of_the_step(runs):
    """SIGTERM on one rank of two: both stop after the same step with exit
    code 143 (the save gathers from every rank, so they agree to stop at the
    end of a step), and rank 0's checkpoint of that step resumes."""
    from mcquic_tpu_torch.utils.convert import readExport
    root, _ = runs
    infos = [json.loads((root / "sigterm_2" / f"rank{r}.json").read_text()) for r in range(2)]
    assert infos[0] == infos[1] == {"step": 2, "code": 143}
    flat, _ = readExport(root / "sigterm_2" / "saved" / "latest" / "saved.ckpt.npz")
    assert int(flat["step"]) == 2 and any(k.startswith("optState/") for k in flat)
