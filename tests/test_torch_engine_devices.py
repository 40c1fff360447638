"""The port's engine over a list of devices, held to the JAX engine over a
mesh (`tests/test_engine_sharded.py`'s four checks) and to the port's engine
on one device.

The JAX engine runs on the 8-device virtual CPU mesh of `tests/conftest.py`
in fp64 (`jax.enable_x64`); the port's on `["cpu", "cpu"]`, one replica of
the same weights per entry. A batch of 8 is sharded over the mesh and split
in two along its rows in the port; a batch of 3 is replicated on the mesh
and runs whole on the port's first replica. Codes and `.mcq` bytes must be
identical; restored images equal the one-device port's exactly and the JAX
engine's within 1e-9. `updateModel` / `refreshFreq` are held to
`tests/test_engine_freq.py::test_engine_refresh_freq_resets_cdfs`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcquic_tpu.models.compressor import Compressor as JaxCompressor
from mcquic_tpu.models.engine import CompressorEngine as JaxEngine
from mcquic_tpu.parallel import makeMesh
from mcquic_tpu_torch.models.engine import CompressorEngine
from test_torch_weights import SMALL, jaxVariables, portModel, randomStateDict

DEVICES = ["cpu", "cpu"]
RESTORE_ATOL = 1e-9


def jaxEngine(stateDict, mesh=None):
    module = JaxCompressor(channel=SMALL["channel"], m=SMALL["m"], k=tuple(SMALL["k"]),
                           dtype=jnp.float64)
    with jax.enable_x64():
        return JaxEngine(module, jaxVariables(stateDict, **SMALL), qp="2", mesh=mesh)


@pytest.fixture(scope="module")
def engines():
    stateDict = randomStateDict(**SMALL, seed=4)
    mesh = makeMesh(dataParallel=len(jax.devices()), modelParallel=1)
    return (jaxEngine(stateDict, mesh),
            CompressorEngine(portModel(stateDict, **SMALL), qp="2", device="cpu"),
            CompressorEngine(portModel(stateDict, **SMALL), qp="2", devices=DEVICES))


def floatBatch(n, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 64, 64, 3))


class RowsSeen:
    """Records the rows each replica's encode and decode are given."""

    def __init__(self, engine, monkeypatch):
        self.encode = [[] for _ in engine.replicas]
        self.decode = [[] for _ in engine.replicas]
        for i, replica in enumerate(engine.replicas):
            for name, seen in (("encode", self.encode[i]), ("decode", self.decode[i])):
                original = getattr(replica, name)

                def record(x, original=original, seen=seen):
                    seen.append(int(x.shape[0] if torch.is_tensor(x) else x[0].shape[0]))
                    return original(x)

                monkeypatch.setattr(replica, name, record)


def test_a_replica_per_entry(engines):
    _, _, multi = engines
    assert multi.devices == [torch.device("cpu")] * 2
    first, second = multi.replicas
    assert first is multi.model and second is not first
    for a, b in zip(first.parameters(), second.parameters()):
        assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)


def test_codes_equal_one_device_and_the_jax_mesh(engines):
    jaxSharded, single, multi = engines
    img = floatBatch(8, 0)
    with jax.enable_x64():
        theirs = jaxSharded.encode(img)
    ours = multi.encode(img)
    for a, b, c in zip(ours, single.encode(img), theirs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_the_batch_is_really_split(engines, monkeypatch):
    jaxSharded, _, multi = engines
    img = floatBatch(8, 1)
    with jax.enable_x64():
        placed = jaxSharded._putBatch(img)
    assert placed.addressable_shards[0].data.shape[0] == 8 // len(jax.devices())
    seen = RowsSeen(multi, monkeypatch)
    _, binaries, headers = multi.compress(img)
    multi.decompress(binaries, headers)
    assert seen.encode == [[4], [4]] and seen.decode == [[4], [4]]


def test_a_batch_that_does_not_divide(engines, monkeypatch):
    jaxSharded, single, multi = engines
    img = floatBatch(3, 2)
    seen = RowsSeen(multi, monkeypatch)
    codes, binaries, headers = multi.compress(img)
    restored = multi.decompress(binaries, headers)
    assert seen.encode == [[3], []] and seen.decode == [[3], []]
    refCodes, refBinaries, _ = single.compress(img)
    with jax.enable_x64():
        _, theirBinaries, _ = jaxSharded.compress(img)
        theirRestored = jaxSharded.decompress(theirBinaries, headers)
    assert binaries == refBinaries == theirBinaries
    for a, b in zip(codes, refCodes):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(restored, single.decompress(refBinaries, headers))
    np.testing.assert_allclose(restored, theirRestored, rtol=0, atol=RESTORE_ATOL)


def test_uint8_image_wrappers(engines):
    jaxSharded, single, multi = engines
    img = np.random.default_rng(3).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    file = multi.compressImage(img)
    with jax.enable_x64():
        theirs = jaxSharded.compressImage(img)
        theirRestored = jaxSharded.decompressImage(theirs)
    assert file.serialize() == single.compressImage(img).serialize() == theirs.serialize()
    restored = multi.decompressImage(file)
    np.testing.assert_array_equal(restored, single.decompressImage(file))
    np.testing.assert_array_equal(restored, theirRestored)


def test_split_batches_equal_one_device_and_the_jax_mesh(engines):
    """A uint8 batch of 8 through the split, both directions, against the
    mesh and one device."""
    jaxSharded, single, multi = engines
    img = np.random.default_rng(5).integers(0, 256, (8, 64, 64, 3), dtype=np.uint8)
    _, binaries, headers = multi.compress(img)
    _, refBinaries, _ = single.compress(img)
    with jax.enable_x64():
        _, theirBinaries, _ = jaxSharded.compress(img)
        theirRestored = jaxSharded.decompress(theirBinaries, headers)
    assert binaries == refBinaries == theirBinaries
    images = multi.decompress(binaries, headers, toImage=True)
    np.testing.assert_array_equal(images, single.decompress(binaries, headers, toImage=True))
    np.testing.assert_allclose(multi.decompress(binaries, headers), theirRestored, rtol=0,
                               atol=RESTORE_ATOL)


def test_pipelined_batches_go_through_the_split(engines, monkeypatch):
    _, single, multi = engines
    batches = [floatBatch(n, 10 + n) for n in (4, 3, 2)]
    seen = RowsSeen(multi, monkeypatch)
    many = multi.compressMany(batches)
    assert many == [single.compress(b)[1:] for b in batches]
    restored = multi.decompressMany(many)
    for a, b in zip(restored, single.decompressMany(many)):
        np.testing.assert_array_equal(a, b)
    assert seen.encode == [[2, 3, 1], [2, 1]] and seen.decode == [[2, 3, 1], [2, 1]]


def test_update_model_reaches_every_replica_and_refreshes_the_tables():
    """New weights and frequencies (`test_engine_refresh_freq_resets_cdfs`'s
    perturbation, f * linspace(0.5, 2, k)) through `updateModel`: the rANS
    tables move, and the bytes equal the JAX engine's after
    `updateVariables` and the one-device port's built on the new weights."""
    stateDict = randomStateDict(**SMALL, seed=6)
    with jax.enable_x64():
        theirs = jaxEngine(stateDict, makeMesh(dataParallel=len(jax.devices()), modelParallel=1))
    multi = CompressorEngine(portModel(stateDict, **SMALL), qp="2", devices=DEVICES)
    before = [f.copy() for f in multi.coder.NormalizedFreq]
    updated = dict(stateDict)
    for key, value in stateDict.items():
        if "._freqEMA." in key:
            updated[key] = value * np.linspace(0.5, 2.0, value.shape[-1])
        elif key.endswith("weight"):
            updated[key] = value * 1.01
    newModel = portModel(updated, **SMALL)
    multi.updateModel(newModel.state_dict())
    with jax.enable_x64():
        theirs.updateVariables(jaxVariables(updated, **SMALL))
    assert any(not np.allclose(a, b) for a, b in zip(before, multi.coder.NormalizedFreq))
    for a, b in zip(multi.coder.NormalizedFreq, theirs.coder.NormalizedFreq):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    for replica in multi.replicas:
        for (name, a), b in zip(replica.state_dict().items(), newModel.state_dict().values()):
            assert torch.equal(a, b), name
    img = floatBatch(8, 7)
    _, binaries, _ = multi.compress(img)
    with jax.enable_x64():
        _, theirBinaries, _ = theirs.compress(img)
    assert binaries == theirBinaries
    assert binaries == CompressorEngine(newModel, qp="2", device="cpu").compress(img)[1]


def test_refresh_freq_reads_the_live_frequencies():
    """A trainer moves `freqEMA` in place; the tables keep a copy until
    `refreshFreq` installs the new values."""
    stateDict = randomStateDict(**SMALL, seed=8)
    engine = CompressorEngine(portModel(stateDict, **SMALL), qp="2", devices=DEVICES)
    freq = engine.model._quantizer.frequencies()[0]
    with torch.no_grad():
        freq.mul_(torch.linspace(0.5, 2.0, freq.shape[-1], dtype=freq.dtype))
    assert not np.allclose(engine.coder.NormalizedFreq[0], (freq / freq.sum(-1, keepdim=True)).numpy())
    engine.refreshFreq()
    np.testing.assert_allclose(engine.coder.NormalizedFreq[0],
                               (freq / freq.sum(-1, keepdim=True)).numpy(), rtol=1e-15)
