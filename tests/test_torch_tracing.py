"""The port's spans (`mcquic_tpu_torch/utils/tracing.py`): they record only
while `torch.profiler` records, where the codec engine and the generator do
their work, on the profiler's own clock, and never as profiler events.
CPU only: a tiny seeded compressor on a CPU engine and a tiny generator."""
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from mcquic_tpu_torch.models.compressor import seededCompressor
from mcquic_tpu_torch.models.engine import CompressorEngine
from mcquic_tpu_torch.models.generator import GeneratorV3SelfAttention
from mcquic_tpu_torch.utils import tracing
from mcquic_tpu_torch.utils.profiling import spanTable, unionLength

NAMES = ("engine.encodeDispatch", "engine.decodeDispatch", "engine.ransEncode",
         "engine.ransDecode", "generator.sampleCodes")


def profiler():
    return profile(activities=[ProfilerActivity.CPU])


def named(name):
    return [s for s in tracing.spans() if s.name == name]


@pytest.fixture(autouse=True)
def empty():
    tracing.clear()
    yield
    tracing.clear()


@pytest.fixture(scope="module")
def engine():
    return CompressorEngine(seededCompressor(8, 2, [16, 8], seed=3), qp="1", device="cpu")


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, (2, 48, 64, 3), dtype=np.uint8) for _ in range(3)]


@pytest.fixture(scope="module")
def generator():
    torch.manual_seed(0)
    return GeneratorV3SelfAttention(channel=8, k=16, size=[2, 1, 1], hiddenSize=32, depth=2,
                                    nHeads=4, numClasses=10).eval().requires_grad_(False)


def test_without_a_profiler_spans_record_nothing():
    for i in range(10_000):
        with tracing.span("engine.encodeDispatch", images=i) as record:
            assert record is None
    assert tracing.spans() == []
    # the off path hands out one shared context, allocating none
    assert tracing.span("a") is tracing.span("b", images=1)


def test_compress_many_links_each_rans_span_to_its_dispatch_across_threads(engine, batches):
    with profiler():
        written = engine.compressMany(batches)
    dispatches, rans = named("engine.encodeDispatch"), named("engine.ransEncode")
    assert len(dispatches) == len(rans) == 3
    for dispatch, coded, (binaries, _) in zip(dispatches, rans, written):
        assert coded.thread != dispatch.thread and dispatch.thread == threading.get_native_id()
        assert coded.parent == dispatch.id and coded.batch == dispatch.batch == dispatch.id
        assert dispatch.parent is None
        assert dispatch.counts == {"images": 2, "bytes": 2 * 128 * 128 * 3}   # padded to 128
        assert coded.counts == {"images": 2,
                                "bytes": sum(len(b) for image in binaries for b in image)}
        assert dispatch.start <= dispatch.end <= coded.start <= coded.end
    assert len({s.batch for s in dispatches}) == 3


def test_decompress_many_records_rans_then_dispatch_per_batch(engine, batches):
    written = engine.compressMany(batches)
    assert tracing.spans() == []
    with profiler():
        engine.decompressMany(written)
    rans, dispatches = named("engine.ransDecode"), named("engine.decodeDispatch")
    assert len(rans) == len(dispatches) == 3
    for coded, dispatch, (binaries, headers) in zip(rans, dispatches, written):
        assert coded.counts == {"images": 2,
                                "bytes": sum(len(b) for image in binaries for b in image)}
        size = headers[0].CodeSize
        codeSymbols = sum(m * h * w for m, h, w in zip(size.m, size.heights, size.widths))
        assert dispatch.counts == {"images": 2, "bytes": 2 * 2 * codeSymbols}   # 16-bit codes
        assert dispatch.parent == coded.id and dispatch.batch == coded.batch
        assert coded.end <= dispatch.start


def test_single_batch_compress_and_decompress_link_their_spans(engine, batches):
    with profiler():
        _, binaries, headers = engine.compress(batches[0])
        engine.decompress(binaries, headers)
    (encode,), (coded,) = named("engine.encodeDispatch"), named("engine.ransEncode")
    (decoded,), (decode,) = named("engine.ransDecode"), named("engine.decodeDispatch")
    assert coded.parent == encode.id and coded.thread == encode.thread
    assert decode.parent == decoded.id and decode.batch == decoded.batch != encode.batch


def test_sample_codes_records_one_span_per_call(generator):
    condition = torch.tensor([1, 7, 3])
    with profiler():
        for _ in range(2):
            generator.sampleCodes(condition, torch.Generator().manual_seed(1))
        generator.generate(condition)
    calls = named("generator.sampleCodes")
    assert len(calls) == len(tracing.spans()) == 3
    assert all(s.counts == {"images": 3, "tokens": 3 * (4 + 1 + 1)} for s in calls)
    assert len({s.batch for s in calls}) == 3 and all(s.parent is None for s in calls)


def test_spans_share_the_profilers_clock():
    with profiler() as prof:
        with tracing.span("generator.sampleCodes", images=1) as record:
            time.sleep(0.002)
            with record_function("probe.inside"):
                torch.ones(64).sum()
            time.sleep(0.002)
    (event,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "probe.inside"]
    start, end = event.start_ns(), event.start_ns() + event.duration_ns()
    assert record.start - 1_000_000 <= start and end <= record.end + 1_000_000
    assert start >= record.start + 1_000_000 and end <= record.end - 1_000_000   # inside it


def test_no_profiler_event_carries_a_span_name(engine, batches, generator):
    with profiler() as prof:
        engine.decompressMany(engine.compressMany(batches[:2]))
        generator.sampleCodes(torch.tensor([2]))
    assert {s.name for s in tracing.spans()} == set(NAMES)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert names and not names & set(NAMES)
    assert not {e.name for e in prof.events()} & set(NAMES)


def test_nested_spans_take_the_open_span_as_parent_and_the_buffer_is_bounded():
    with profiler():
        with tracing.span("outer") as outer:
            with tracing.span("inner", outer, tokens=4) as inner:
                pass
            with tracing.span("unlinked") as unlinked:     # no parent unless handed one
                pass
        for _ in range(tracing.CAPACITY + 5):
            with tracing.span("filler"):
                pass
        with pytest.raises(KeyError):
            with tracing.span("failing"):
                raise KeyError("x")
    assert inner.parent == outer.id and inner.batch == outer.batch == outer.id
    assert unlinked.parent is None and unlinked.batch == unlinked.id != outer.batch
    assert outer.start <= inner.start <= inner.end <= outer.end
    kept = tracing.spans()
    assert len(kept) == tracing.CAPACITY and kept[-1].name == "failing"
    assert kept[-1].end is not None
    with tracing.span("after"):
        pass
    assert len(tracing.spans()) == tracing.CAPACITY
    tracing.clear()
    assert tracing.spans() == []


def test_spans_from_many_threads_are_all_kept_with_unique_ids():
    threads, each = 16, 400
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiler():
            def work(i):
                for _ in range(each):
                    with tracing.span("outer", images=i) as outer:
                        with tracing.span("inner", outer):
                            pass
            workers = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
            assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    kept = tracing.spans()
    assert len(kept) == 2 * threads * each and len({s.id for s in kept}) == len(kept)
    outer = {s.id: s for s in kept if s.name == "outer"}
    for s in kept:
        if s.name == "inner":        # each thread's inner span under its own outer span
            assert outer[s.parent].thread == s.thread and outer[s.parent].batch == s.batch


def test_span_table_counts_total_and_self_time():
    """`report`'s table: per name the count, total ms (no span of the port
    nests another, so a span's self time is its total), the spans on
    another thread and the summed counts; per batch, first start to last end."""
    def span(name, start, end, ident, batch, thread=7, **counts):
        return tracing.Span(name, start, end, ident, None, batch, thread, counts)
    spans = [span("dispatch", 0, 10_000_000, 1, 1, images=2, bytes=600),
             span("rans", 12_000_000, 20_000_000, 2, 1, thread=9, images=2, bytes=40),
             span("dispatch", 30_000_000, 34_000_000, 3, 3, images=3, bytes=900),
             span("rans", 35_000_000, 36_000_000, 4, 3, images=3, bytes=70)]
    table, batches = spanTable(spans, caller=7)
    assert table["dispatch"] == (2, pytest.approx(14.0), {"images": 5, "bytes": 1500}, 0)
    assert table["rans"] == (2, pytest.approx(9.0), {"images": 5, "bytes": 110}, 1)
    assert batches == [pytest.approx(20.0), pytest.approx(6.0)]
    assert spanTable([], caller=7) == ({}, [])
    assert unionLength([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == pytest.approx(4.0)
    assert unionLength([]) == 0.0
