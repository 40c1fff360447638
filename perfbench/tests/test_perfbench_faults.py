"""A run whose timed path is broken underneath comes out not correct. The
cells run here on the CPU at a small width (the look for a card is the
command's, not the harness's); each fault is planted in the program where
its output is produced, and each sound run comes out correct."""
import numpy as np
import pytest
import torch

from perfbench.harness import execute
from perfbench.tests.conftest import tinyCell

SEED = 2**33 + 17


def run(cell: str, seconds: float = 1.5) -> dict:
    return execute(tinyCell(cell), SEED, seconds, False, "cpu")


def failing(result) -> set:
    return {n for n, c in result["checks"].items() if c["value"] > c["limit"]}


@pytest.mark.parametrize("cell", ["qp2-photos-b10", "a800gen16-generate-b8"])
def test_a_sound_run_is_correct(cell):
    result = run(cell)
    assert result["correct"], result["checks"]


def test_an_altered_code_fails(monkeypatch):
    from mcquic_tpu_torch.models import quantizer
    plain = quantizer.vqEncode

    def altered(x, codebook):
        codes = plain(x, codebook).clone()
        codes[0, 0, 0, 0] = (codes[0, 0, 0, 0] + 1) % codebook.shape[1]
        return codes
    monkeypatch.setattr(quantizer, "vqEncode", altered)
    assert "code_gap" in failing(run("qp2-photos-b10"))


def test_half_the_batch_left_out_fails(monkeypatch):
    from mcquic_tpu_torch.models.compressor import Compressor
    plain = Compressor.encode

    def halved(self, x):
        half = x[:max(1, x.shape[0] // 2)]
        return [c.repeat_interleave(2, 0)[:x.shape[0]] for c in plain(self, half)]
    monkeypatch.setattr(Compressor, "encode", halved)
    assert "code_gap" in failing(run("qp2-photos-b10"))


def test_an_altered_restoration_fails(monkeypatch):
    from mcquic_tpu_torch.models.compressor import Compressor
    plain = Compressor.decode
    monkeypatch.setattr(Compressor, "decode", lambda self, codes: plain(self, codes) * 0.97)
    assert "decode_err" in failing(run("qp2-photos-b10"))


def test_a_stream_cut_short_fails(monkeypatch):
    from mcquic_tpu_torch.coding import RansCoder
    plain = RansCoder.compress

    def cut(self, codes):
        binaries, sizes = plain(self, codes)
        return [[b[:-4] for b in image] for image in binaries], sizes
    monkeypatch.setattr(RansCoder, "compress", cut)
    monkeypatch.setattr(RansCoder, "decompress", lambda self, binaries, sizes: [
        np.zeros((len(binaries), s, h, w), np.int32)
        for s, h, w in zip(sizes[0].m, sizes[0].heights, sizes[0].widths)])
    assert "stream_faults" in failing(run("qp2-photos-b10"))


def test_an_altered_token_fails(monkeypatch):
    from mcquic_tpu_torch.models.generator import GeneratorV3SelfAttention
    plain = GeneratorV3SelfAttention.sampleCodes

    def altered(self, *args, **kwargs):
        codes = plain(self, *args, **kwargs)
        codes[-1] = codes[-1].clone()
        codes[-1][0, 0, 0, 0] = (codes[-1][0, 0, 0, 0] + 1) % self.k
        return codes
    monkeypatch.setattr(GeneratorV3SelfAttention, "sampleCodes", altered)
    assert "greedy_gap" in failing(run("a800gen16-generate-b8"))


def test_an_altered_image_fails(monkeypatch):
    from mcquic_tpu_torch.models.compressor import Neon
    plain = Neon.decode
    monkeypatch.setattr(Neon, "decode", lambda self, codes: plain(self, codes) + 0.02)
    assert "image_err" in failing(run("a800gen16-generate-b8"))


def test_half_the_generated_batch_left_out_fails(monkeypatch):
    from mcquic_tpu_torch.models.generator import GeneratorV3SelfAttention
    plain = GeneratorV3SelfAttention.sampleCodes

    def halved(self, condition, *args, **kwargs):
        n = condition.shape[0]
        codes = plain(self, condition[:max(1, n // 2)], *args, **kwargs)
        return [c.repeat_interleave(2, 0)[:n] for c in codes]
    monkeypatch.setattr(GeneratorV3SelfAttention, "sampleCodes", halved)
    assert "greedy_gap" in failing(run("a800gen16-generate-b8"))
