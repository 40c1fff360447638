"""The port's rANS coder: golden streams, and byte-identical output with the
JAX package's coder (mcquic_tpu_torch/coding/)."""
import json
from pathlib import Path

import numpy as np
import pytest

from mcquic_tpu.coding import RansCoder as JaxRansCoder
from mcquic_tpu_torch.coding import RansCoder, pyrans, rans

GOLDEN = Path(__file__).resolve().parent / "golden" / "rans_golden.json"


def _golden():
    return json.loads(GOLDEN.read_text())["cases"]


@pytest.mark.parametrize("case", range(4))
def test_streams_match_the_golden_file(case):
    c = _golden()[case]
    cdfMat, _ = rans.packCdfs(c["cdfs"])
    args = (np.asarray(c["indexes"]), cdfMat, np.asarray(c["cdfSizes"]), np.asarray(c["offsets"]))
    encoded = rans.encodeNp(np.asarray(c["symbols"]), *args)
    assert encoded.hex() == c["encodedHex"]
    assert encoded == pyrans.encodeWithIndexes(np.asarray(c["symbols"]), *args)
    np.testing.assert_array_equal(rans.decodeNp(encoded, *args), c["symbols"])
    # the LUT builder reads cdfSizes entries of each row; cases 0-1 declare one
    # more than their CDFs hold, so pad rows with the total, as RansCoder does
    padded = np.pad(cdfMat, ((0, 0), (0, 1)), constant_values=1 << 16)
    luts = rans.buildDecodeLuts(padded, np.asarray(c["cdfSizes"]))
    np.testing.assert_array_equal(
        rans.decodeNp(encoded, args[0], padded, *args[2:], luts=luts), c["symbols"])


def test_quantized_cdfs_match_the_jax_package():
    from mcquic_tpu.coding import rans as jaxRans
    rng = np.random.default_rng(0)
    for _ in range(20):
        pmf = rng.dirichlet(np.full(int(rng.integers(2, 300)), 0.3)).astype(np.float32)
        pmf[rng.integers(0, pmf.size)] = 0.0
        assert rans.pmfToQuantizedCDF(pmf.tolist(), 16) == jaxRans.pmfToQuantizedCDF(pmf.tolist(), 16)


def test_coder_is_byte_identical_with_the_jax_package():
    rng = np.random.default_rng(1)
    m, k = [2, 2, 2], [64, 32, 16]
    freqs = [rng.uniform(0, 1, size=(2, ki)) ** 3 for ki in k]
    codes = [rng.integers(0, ki, size=(3, 2, 8 >> lv, 6 >> lv)).astype(np.int32)
             for lv, ki in enumerate(k)]
    ours, theirs = RansCoder(m, k), JaxRansCoder(m, k)
    ours.updateFreq(freqs)
    theirs.updateFreq(freqs)
    ourBins, ourSizes = ours.compress(codes)
    theirBins, theirSizes = theirs.compress(codes)
    assert ourBins == theirBins
    assert [vars(s) for s in ourSizes] == [vars(s) for s in theirSizes]
    for a, b in zip(ours.decompress(theirBins, ourSizes), codes):
        np.testing.assert_array_equal(a, b)


def test_uniform_frequencies_by_default():
    coder = RansCoder([1], [8])
    codes = [np.arange(8, dtype=np.int32).reshape(1, 1, 2, 4)]
    binaries, sizes = coder.compress(codes)
    np.testing.assert_array_equal(coder.decompress(binaries, sizes)[0], codes[0])
    with pytest.raises(ValueError, match="level count"):
        coder.updateFreq([np.ones((1, 8)), np.ones((1, 8))])
