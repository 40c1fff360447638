"""The KV-cached sampling loop replayed from CUDA graphs against the eager
loop, on a card (`models/generator.py::LevelGraphs`).

Every test here is marked `cuda` and skips where torch sees no CUDA card.
Like tests/test_torch_kernels_cuda.py this file imports only torch and the
port, so it also runs without the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sample_graphs_cuda.py

The eager side is the same model called with autograd on, which leaves the
loop eager; the replayed side is its third and later calls under
`inference_mode`. Codes must be bit-identical: the graphs replay the eager
pass's kernels in its order, in fp32 with TF32 off.
"""
import pytest
import torch

from mcquic_tpu_torch.generate import seededGeneratorState
from mcquic_tpu_torch.models.generator import GeneratorV3SelfAttention
from mcquic_tpu_torch.ops.attention_cuda import flashAttention
from mcquic_tpu_torch.utils import exactFp32

pytestmark = pytest.mark.cuda

GEOMETRY = dict(channel=16, k=64, size=[8, 4, 4, 2, 2, 1, 1], hiddenSize=96, depth=3, nHeads=4,
                numClasses=10)
LEVELS = len(GEOMETRY["size"])
TEXT = dict(GEOMETRY, textConditioned=True, capDim=24)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs have no CPU form)")
    return torch.device("cuda")


def seeded(device, geometry=GEOMETRY, seed=0):
    with torch.device(device):
        model = GeneratorV3SelfAttention(**geometry)
    model.load_state_dict(seededGeneratorState(geometry, seed), strict=True)
    return model.eval().requires_grad_(False)


def conditionFor(model, bs, salt, device):
    if model.textConditioned:
        g = torch.Generator().manual_seed(salt)
        return torch.randn((bs, model.capDim), generator=g).to(device)
    return torch.tensor([(salt * 7 + 3 * i) % model.numClasses for i in range(bs)], device=device)


def draw(model, condition, mode, seed, grad=False):
    """Codes of one call: greedy, topK 1 or a seeded draw; with `grad`,
    autograd on, which leaves the loop eager."""
    generator = None if mode == "greedy" else \
        torch.Generator(device=condition.device).manual_seed(seed)
    with exactFp32(), torch.enable_grad() if grad else torch.inference_mode():
        return model.sampleCodes(condition, generator, 1.0, 1 if mode == "top1" else 0)


def same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def entry(model, bs):
    return next(e for k, e in model._graphs.entries.items() if k[0] == bs)


@pytest.mark.parametrize("bs", [8, 3])
@pytest.mark.parametrize("mode", ["greedy", "top1", "drawn"])
def test_replayed_codes_are_bit_identical_to_the_eager_loop(cuda, bs, mode):
    model = seeded(cuda)
    stages = []
    for salt in range(4):
        condition = conditionFor(model, bs, salt, cuda)
        got = draw(model, condition, mode, 100 + salt)
        stages.append(all(g is not None for g in entry(model, bs).graphs))
        assert same(got, draw(model, condition, mode, 100 + salt, grad=True)), salt
    assert stages == [False, True, True, True]


def test_a_text_conditioned_generator_replays(cuda):
    model = seeded(cuda, TEXT)
    for salt in range(3):
        condition = conditionFor(model, 4, salt, cuda)
        assert same(draw(model, condition, "drawn", salt),
                    draw(model, condition, "drawn", salt, grad=True))
    assert all(g is not None for g in entry(model, 4).graphs)


def test_the_replay_follows_weights_loaded_by_assignment(cuda):
    model = seeded(cuda)
    condition = conditionFor(model, 5, 0, cuda)
    for _ in range(3):
        draw(model, condition, "greedy", 0)
    first = entry(model, 5)
    other = seeded(cuda, seed=7)
    model.load_state_dict(other.state_dict(), assign=True)
    for _ in range(3):
        got = draw(model, condition, "greedy", 0)
        assert same(got, draw(other, condition, "greedy", 0, grad=True))
    assert entry(model, 5) is not first and all(g is not None for g in entry(model, 5).graphs)
    model.load_state_dict(seeded(cuda, seed=9).state_dict())      # in place: replayed as is
    assert same(draw(model, condition, "greedy", 0),
                draw(seeded(cuda, seed=9), condition, "greedy", 0, grad=True))


def test_k3_launches_per_replayed_generate_are_depth_times_levels(cuda):
    model = seeded(cuda)
    condition = conditionFor(model, 8, 0, cuda)
    per = []
    for _ in range(4):
        before = flashAttention.launches
        with exactFp32(), torch.inference_mode():
            model.generate(condition)
        per.append(flashAttention.launches - before)
    assert per == [GEOMETRY["depth"] * LEVELS] * 4


def test_replay_memory_stays_under_the_eager_peak_plus_the_graph_pool(cuda):
    model = seeded(cuda)
    condition = conditionFor(model, 8, 0, cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    draw(model, condition, "greedy", 0, grad=True)
    torch.cuda.synchronize()
    eager = torch.cuda.max_memory_allocated()
    for _ in range(2):
        draw(model, condition, "greedy", 0)
    pool = entry(model, 8).pool
    poolBytes = sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                    if tuple(s.get("segment_pool_id", ())) == tuple(pool))
    assert poolBytes > 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    draw(model, condition, "greedy", 0)
    torch.cuda.synchronize()
    replayed = torch.cuda.max_memory_allocated()
    assert replayed <= eager + poolBytes, (replayed, eager, poolBytes)
