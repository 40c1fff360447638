"""The plain reference agrees with the program on the CPU at a small size:
the published qp-2 codec on a 256x256 crop of the photo, Neon and the
generator at depth 2 on seeded weights."""
import numpy as np
import torch

from perfbench import codec, images, weights
from perfbench.harness import ROOT, Cell
from perfbench.reference import generator as refGenerator, precision, rans


def test_qp2_codes_streams_and_decode_agree():
    from mcquic_tpu_torch.demo import loadModel
    config = Cell.named("qp2-photos-b10").config
    engine = loadModel(qp=2, device="cpu")
    crop = images.readPng()[128:384, 256:512][None]
    codes, binaries, headers = engine.compress(crop)
    judge = codec.Judge(codec.reference(config, 0, "cpu"), "cpu")
    with precision():
        mine = judge.batchCodes(headers, binaries, 256, 256)
        assert judge.streamFaults == 0
        assert all(np.array_equal(a.numpy(), b) for a, b in zip(mine, codes))
        judge.gap(crop, mine)
        assert judge.codeGap < 1e-6
        restored = engine.decode(codes)
        assert np.abs(judge.decode(mine, 256, 256) - restored).max() < 1e-4


def test_rans_decode_refuses_a_broken_stream():
    cdfs = rans.levelCdfs(np.full((1, 8), 1 / 8))
    from mcquic_tpu_torch.coding import RansCoder
    coder = RansCoder([1], [8])
    symbols = np.arange(16).reshape(1, 1, 4, 4) % 8
    (stream,), = coder.compress([symbols])[0]
    assert np.array_equal(rans.decode(stream, np.zeros(16, int), cdfs), symbols.ravel())
    try:
        rans.decode(stream[:-4] if len(stream) > 8 else stream + b"\0\0\0\1",
                    np.zeros(16, int), cdfs)
    except ValueError:
        return
    raise AssertionError("a cut stream decoded")


def test_generator_and_neon_agree_at_depth_2():
    from mcquic_tpu_torch.models.generator import GeneratorV3SelfAttention
    geometry = dict(channel=32, k=64, size=[16, 8, 8, 4, 4, 2, 2, 1, 1], hiddenSize=64,
                    depth=2, nHeads=4, numClasses=10)
    state = weights.seeded(weights.shapesOf(lambda: refGenerator.Generator(**geometry)), 7, "cpu")
    program = GeneratorV3SelfAttention(**geometry)
    program.load_state_dict(state, strict=True)
    ref = refGenerator.Generator(**geometry)
    ref.load_state_dict(state, strict=True)
    classes = torch.tensor([3, 9])
    with precision(), torch.inference_mode():
        codes = program.eval().sampleCodes(classes)               # greedy, KV-cached
        for logits, code in zip(ref.eval().logits(codes, classes), codes):
            chosen = logits.gather(-1, code.reshape(2, -1, 1).long())
            assert float((logits.max(-1, keepdim=True).values - chosen).max()) < 1e-4
        a, b = program.compressor.decode(codes), ref.compressor.decode(codes)
        assert float((a - b).abs().max()) < 1e-4
        assert [c.shape[-1] for c in ref.compressor.encode(b)] == sorted(geometry["size"])
