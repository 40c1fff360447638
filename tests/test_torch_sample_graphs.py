"""The KV-cached sampling loop run from persistent buffers and per-level
graphs (`models/generator.py::LevelGraphs`), on the CPU.

A CUDA graph needs a card, so these tests engage the mechanism on the CPU
(`graphsEngage` patched to take the CPU) with a stand-in for the capture:
its "graph" reruns the captured pass into the pass's output buffer, leaving
the K3 launch counter alone as a real replay does. Everything else is the
program's own: the fixed caches, condition, tokens and logits, the
eager-capture-replay order of calls, the key and its invalidation, the K3
count a replay adds and the span's `levels` / `replayed` counts. Codes are
held bit-identical in fp64 to a fresh model's eager loop and to the uncached
loop. `tests/test_torch_sample_graphs_cuda.py` holds real graphs on a card.
"""
import copy
import pickle

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mcquic_tpu_torch.generate import seededGeneratorState
from mcquic_tpu_torch.models import generator as generatorModule
from mcquic_tpu_torch.models.generator import (GeneratorV3SelfAttention, LevelGraphCache,
                                               LevelGraphs, graphsEngage)
from mcquic_tpu_torch.ops import attention_cuda
from mcquic_tpu_torch.ops.attention import flashAttentionPlain
from mcquic_tpu_torch.utils import tracing

GEOMETRY = dict(channel=8, k=16, size=[4, 2, 2, 1, 1], hiddenSize=32, depth=2, nHeads=4,
                numClasses=10)
LEVELS = len(GEOMETRY["size"])
TEXT = dict(GEOMETRY, textConditioned=True, capDim=12)


class StandIn:
    """A CPU graph: `replay` reruns the captured pass into its output."""

    def __init__(self, forward):
        self.forward = forward
        self.out = forward()

    def replay(self):
        k3 = attention_cuda.flashAttention
        before = k3.launches
        self.out.copy_(self.forward())
        k3.launches = before          # a replay does not pass through the wrapper


def standInCapture(self, forward):
    graph = StandIn(forward)
    return graph, graph.out


def engage(monkeypatch):
    """The mechanism on the CPU: engaged as on a card, with stand-in graphs."""
    monkeypatch.setattr(generatorModule, "graphsEngage",
                        lambda device, kvCache: kvCache and not torch.is_grad_enabled())
    monkeypatch.setattr(LevelGraphs, "_capture", standInCapture)


@pytest.fixture
def engaged(monkeypatch):
    engage(monkeypatch)


def seeded(geometry=GEOMETRY, seed=0, dtype=torch.float64):
    model = GeneratorV3SelfAttention(**geometry)
    model.load_state_dict(seededGeneratorState(geometry, seed), strict=True)
    return model.to(dtype).eval().requires_grad_(False)


def conditionFor(model, bs, salt):
    if model.textConditioned:
        g = torch.Generator().manual_seed(salt)
        return torch.randn((bs, model.capDim), generator=g, dtype=torch.float64)
    return torch.tensor([(salt * 7 + 3 * i) % (model.numClasses + 1) - 1 for i in range(bs)])


def gumbelFrom(seed):
    g = torch.Generator().manual_seed(seed)
    return lambda shape: -torch.log(-torch.log(
        torch.rand(shape, generator=g, dtype=torch.float64).clamp_min(1e-12)))


def draw(model, condition, mode, seed, kvCache=True, grad=False):
    """Codes of one call: greedy, topK 1, a seeded draw or Gumbel noise;
    with `grad`, autograd on, which leaves the loop eager."""
    with torch.enable_grad() if grad else torch.inference_mode():
        if mode == "greedy":
            return model.sampleCodes(condition, kvCache=kvCache)
        if mode == "top1":
            return model.sampleCodes(condition, torch.Generator().manual_seed(seed), topK=1,
                                     kvCache=kvCache)
        if mode == "drawn":
            return model.sampleCodes(condition, torch.Generator().manual_seed(seed),
                                     temperature=0.9, topK=5, kvCache=kvCache)
        return model.sampleCodes(condition, kvCache=kvCache, gumbel=gumbelFrom(seed))


def entry(model, bs):
    return next(e for k, e in model._graphs.entries.items() if k[0] == bs)


def same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("mode", ["greedy", "top1", "drawn", "gumbel"])
def test_codes_from_persistent_buffers_match_a_fresh_model_and_the_uncached_loop(engaged, mode):
    model, fresh = seeded(), seeded()
    calls = [(3, 1), (3, 2), (2, 3), (3, 4), (2, 5), (2, 6), (3, 7), (2, 8)]
    stages = {}
    for bs, salt in calls:
        condition = conditionFor(model, bs, salt)
        got = draw(model, condition, mode, salt)
        stages.setdefault(bs, []).append(entry(model, bs).graphs[0] is not None)
        assert same(got, draw(fresh, condition, mode, salt, grad=True)), (bs, salt)
        assert same(got, draw(model, condition, mode, salt, kvCache=False)), (bs, salt)
        assert torch.cat([c.flatten() for c in got]).unique().numel() > 1
    # each batch size: eager, then captured, then replayed
    assert stages == {3: [False, True, True, True], 2: [False, True, True, True]}
    assert not fresh._graphs.entries


def test_a_stale_cache_is_never_read(engaged):
    """A later call with other classes and a smaller prefix of its own reads
    only what it wrote: its codes equal those of a model that never ran."""
    model = seeded()
    for salt in range(4):
        draw(model, conditionFor(model, 3, salt), "greedy", 0)
    for ck, _ in entry(model, 3).caches:
        assert ck.abs().sum() > 0
    condition = conditionFor(model, 3, 11)
    assert same(draw(model, condition, "greedy", 0),
                draw(seeded(), condition, "greedy", 0, grad=True))


def test_a_text_conditioned_generator_runs_from_graphs(engaged):
    model, fresh = seeded(TEXT), seeded(TEXT)
    for salt in range(3):
        condition = conditionFor(model, 2, salt)
        assert same(draw(model, condition, "drawn", salt),
                    draw(fresh, condition, "drawn", salt, grad=True))
        assert same(draw(model, condition, "greedy", salt),
                    draw(model, condition, "greedy", salt, kvCache=False))
    assert all(g is not None for g in entry(model, 2).graphs)


def test_state_dict_keys_and_copies_are_unchanged(engaged):
    model = seeded()
    before = list(model.state_dict())
    for salt in range(3):
        draw(model, conditionFor(model, 2, salt), "greedy", 0)
    assert model._graphs.entries
    assert list(model.state_dict()) == before == list(seeded().state_dict())
    assert not any("graph" in key.lower() for key in before)
    for twin in (copy.deepcopy(model), pickle.loads(pickle.dumps(model))):
        assert isinstance(twin._graphs, LevelGraphCache) and not twin._graphs.entries
        condition = conditionFor(model, 2, 9)
        assert same(draw(twin, condition, "greedy", 0), draw(model, condition, "greedy", 0))


def test_graphs_engage_only_for_kv_cached_calls_on_a_card_without_autograd():
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    with torch.inference_mode():
        assert graphsEngage(cuda, True) and not graphsEngage(cuda, False)
        assert not graphsEngage(cpu, True)
    with torch.no_grad():
        assert graphsEngage(cuda, True)
    with torch.enable_grad():
        assert not graphsEngage(cuda, True)


def test_nothing_is_captured_on_the_cpu():
    model = seeded()
    with torch.inference_mode():
        for salt in range(3):
            model.sampleCodes(conditionFor(model, 2, salt))
    assert not model._graphs.entries


def test_nothing_is_captured_uncached_or_under_grad(engaged):
    model = seeded()
    for salt in range(3):
        draw(model, conditionFor(model, 2, salt), "greedy", 0, kvCache=False)
        with torch.enable_grad():
            model.sampleCodes(conditionFor(model, 2, salt))
    assert not model._graphs.entries
    with torch.no_grad():                      # no_grad engages as inference_mode does
        for salt in range(3):
            model.sampleCodes(conditionFor(model, 2, salt))
    assert all(g is not None for g in entry(model, 2).graphs)


def test_replaced_weights_and_dtype_are_recaptured(engaged):
    model = seeded()
    condition = conditionFor(model, 2, 1)
    for _ in range(3):
        draw(model, condition, "greedy", 0)
    first = entry(model, 2)

    # in place: the same storage, the same graphs, the new values
    other = seeded(seed=5)
    model.load_state_dict(other.state_dict())
    assert same(draw(model, condition, "greedy", 0), draw(other, condition, "greedy", 0, grad=True))
    assert entry(model, 2) is first

    # assigned: new storage, so every graph goes and the key starts over
    third = seeded(seed=6)
    model.load_state_dict(third.state_dict(), assign=True)
    codes = draw(model, condition, "greedy", 0)
    second = entry(model, 2)
    assert second is not first and not any(second.graphs)
    assert same(codes, draw(third, condition, "greedy", 0, grad=True))
    draw(model, condition, "greedy", 0)
    assert all(g is not None for g in second.graphs)

    # another dtype: new storage and another key
    model.to(torch.float32)
    draw(model, condition.clone(), "greedy", 0)
    (key,) = model._graphs.entries
    assert key[2] == torch.float32 and entry(model, 2).tokens[0].dtype == torch.float32


def test_the_key_holds_the_tf32_flags_and_the_cache_is_bounded(engaged):
    model = seeded()
    flag = torch.backends.cuda.matmul.allow_tf32
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            draw(model, conditionFor(model, 2, 0), "greedy", 0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    assert sorted(k[3] for k in model._graphs.entries) == [False, True]
    for bs in range(1, LevelGraphCache.KEPT + 3):
        draw(model, conditionFor(model, bs, 0), "greedy", 0)
    kept = [k[0] for k in model._graphs.entries]
    assert kept == list(range(3, LevelGraphCache.KEPT + 3))


def test_a_replay_adds_the_captured_k3_launches_and_a_capture_none(engaged, monkeypatch):
    """The card's wrapper counts each launch; a capture's count is undone and
    every replay adds it, so each call counts depth x levels."""
    k3 = attention_cuda.flashAttention

    def counted(q, k, v, mask=None, scale=None):
        k3.launches += 1
        return flashAttentionPlain(q, k, v, mask, scale)
    monkeypatch.setattr(generatorModule, "flashAttention", counted)
    monkeypatch.setattr(k3, "launches", 0)
    model = seeded()
    condition = conditionFor(model, 2, 0)
    per = []
    for _ in range(4):
        before = k3.launches
        draw(model, condition, "greedy", 0)
        per.append(k3.launches - before)
    assert per == [GEOMETRY["depth"] * LEVELS] * 4
    assert entry(model, 2).k3 == [GEOMETRY["depth"]] * LEVELS


@pytest.mark.parametrize("engaged", [True, False], ids=["engaged", "cpu"])
def test_the_span_counts_levels_and_replayed_levels(monkeypatch, engaged):
    if engaged:
        engage(monkeypatch)
    model = seeded()
    condition = conditionFor(model, 2, 0)
    tracing.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(3):
                draw(model, condition, "greedy", 0)
            draw(model, condition, "greedy", 0, kvCache=False)
        calls = [s.counts for s in tracing.spans() if s.name == "generator.sampleCodes"]
    finally:
        tracing.clear()
    replayed = [0, LEVELS, LEVELS, 0] if engaged else [0, 0, 0, 0]
    assert [c["levels"] for c in calls] == [LEVELS] * 4
    assert [c["replayed"] for c in calls] == replayed
