"""`graphed_share.generate` on spans worked out by hand: the replayed levels
over the levels of the generate phase's `generator.sampleCodes` spans."""
from types import SimpleNamespace

import pytest

from perfbench import spans
from perfbench.harness import HERE, loadModule
from perfbench.trace import Trace

B = 1_700_000_000.0          # seconds since the epoch, as the profiler's clock reads


def record(name, start, end, **counts):
    return SimpleNamespace(name=name, start=int(B) * 10**9 + round(start * 1e9),
                           end=int(B) * 10**9 + round(end * 1e9), counts=counts)


def run():
    phases = {"compress": (B, B + 10.0), "generate": (B + 20.0, B + 40.0)}
    return SimpleNamespace(trace=Trace([("gemm", B + 20.0, B + 22.0)], phases, []))


def read(monkeypatch, recorded):
    monkeypatch.setattr(spans, "recorded", lambda: recorded)
    return loadModule(HERE / "layers" / "graphed_share.generate.py").read(run())


def test_the_share_of_levels_replayed_in_the_phase(monkeypatch):
    recorded = [
        record("generator.sampleCodes", 21.0, 21.5, images=8, levels=17, replayed=0),
        record("generator.sampleCodes", 22.0, 22.5, images=8, levels=17, replayed=17),
        record("generator.sampleCodes", 23.0, 23.5, images=8, levels=17, replayed=17),
        record("generator.sampleCodes", 24.0, 24.5, images=8, levels=17, replayed=16),
        record("generator.sampleCodes", 5.0, 5.5, levels=17, replayed=0),      # another phase
        record("engine.encodeDispatch", 25.0, 25.5, levels=3, replayed=0),     # another span
    ]
    assert read(monkeypatch, recorded) == pytest.approx(100.0 * 50 / 68)
    assert read(monkeypatch, recorded[1:3]) == pytest.approx(100.0)


def test_nothing_to_read_gives_none(monkeypatch):
    # spans without the counts: a program that does not count its levels
    assert read(monkeypatch, [record("generator.sampleCodes", 21.0, 21.5, images=8)]) is None
    assert read(monkeypatch, [SimpleNamespace(name="generator.sampleCodes", start=int(B + 21) * 10**9,
                                              end=int(B + 22) * 10**9)]) is None
    assert read(monkeypatch, [record("generator.sampleCodes", 5.0, 5.5, levels=17,
                                     replayed=17)]) is None
    assert read(monkeypatch, []) is None
    reader = loadModule(HERE / "layers" / "graphed_share.generate.py").read
    assert reader(SimpleNamespace(trace=None)) is None
