"""Zoo resolution of the port against the JAX package's
(`mcquic_tpu/demo.py:36-129`), on the CPU: the same environment variables
(MCQUIC_MODELS_HASH_FILE, MCQUIC_BUNDLED_ZOO, MCQUIC_CACHE and
MCQUIC_MODELS_URL, here a `file://` mirror) give the same files, and the
same cases are refused. The zoo's files are copies of the tiny demo model
under slot names; a hash file in a temporary directory registers them.
"""
import hashlib
import json
import shutil
from pathlib import Path

import pytest

from mcquic_tpu.demo import fetchZooModel
from mcquic_tpu_torch.demo import zooPath

ROOT = Path(__file__).resolve().parent.parent
TINY = ROOT / "assets" / "tiny_demo_672919fb.mcquic.npz"


def publish(folder: Path, slot: str, payload: bytes = None, sidecar: bool = True) -> str:
    """The tiny model as `folder/{slot}_{sha8}.mcquic.npz` (and its json);
    returns the registered prefix."""
    payload = TINY.read_bytes() if payload is None else payload
    digest = hashlib.sha256(payload).hexdigest()[:8]
    folder.mkdir(parents=True, exist_ok=True)
    (folder / f"{slot}_{digest}.mcquic.npz").write_bytes(payload)
    if sidecar:
        shutil.copy(TINY.with_suffix(".json"), folder / f"{slot}_{digest}.mcquic.json")
    return digest


@pytest.fixture
def zoo(tmp_path, monkeypatch):
    """A hash file, an empty bundled zoo, a mirror and a cache per package."""
    mirror = tmp_path / "mirror"
    hashes = {"qp_3_msssim": publish(mirror, "qp_3_msssim"),
              "qp_3_mse": publish(mirror, "qp_3_mse", TINY.read_bytes() + b"\0")}
    hashes["qp_4_msssim"] = publish(mirror, "qp_4_msssim", TINY.read_bytes() + b"\1",
                                    sidecar=False)
    # qp 5: the mirror's file is not the registered one
    publish(mirror, "qp_5_msssim")
    wrong = next(mirror.glob("qp_5_msssim_*.mcquic.npz"))
    hashes["qp_5_msssim"] = "00000000"
    wrong.rename(mirror / "qp_5_msssim_00000000.mcquic.npz")
    wrong.with_suffix(".json").rename(mirror / "qp_5_msssim_00000000.mcquic.json")
    hashFile = tmp_path / "hashes.json"
    hashFile.write_text(json.dumps(hashes))
    monkeypatch.setenv("MCQUIC_MODELS_HASH_FILE", str(hashFile))
    monkeypatch.setenv("MCQUIC_BUNDLED_ZOO", str(tmp_path / "bundled"))
    monkeypatch.setenv("MCQUIC_MODELS_URL", mirror.as_uri())
    return tmp_path, hashes


def both(monkeypatch, tmp: Path, qp: int, mse: bool = False):
    """Each package's resolution from a cache of its own."""
    out = []
    for name, fn in (("jax", fetchZooModel), ("port", zooPath)):
        monkeypatch.setenv("MCQUIC_CACHE", str(tmp / f"cache_{name}"))
        out.append(fn(qp, mse=mse))
    return out


@pytest.mark.parametrize("mse", [False, True])
def test_mirror_fills_the_cache_as_the_jax_package(zoo, monkeypatch, mse):
    """A slot fetched from the `file://` mirror lands in MCQUIC_CACHE/zoo
    under the same name with the same bytes and sidecar; a second call finds
    it in the cache; `--mse` selects the `qp_N_mse` slot."""
    tmp, hashes = zoo
    theirs, ours = both(monkeypatch, tmp, 3, mse)
    slot = "qp_3_mse" if mse else "qp_3_msssim"
    assert ours.name == theirs.name == f"{slot}_{hashes[slot]}.mcquic.npz"
    assert ours.parent == tmp / "cache_port" / "zoo"
    assert ours.read_bytes() == theirs.read_bytes()
    assert ours.with_suffix(".json").read_bytes() == theirs.with_suffix(".json").read_bytes()
    monkeypatch.delenv("MCQUIC_MODELS_URL")
    assert zooPath(3, mse=mse) == ours                 # cached: no URL needed


def test_bundled_zoo_is_checked_in_place(zoo, monkeypatch):
    """A file in MCQUIC_BUNDLED_ZOO is returned where it lies; one without
    its sidecar is refused by both packages."""
    tmp, hashes = zoo
    bundled = tmp / "bundled"
    publish(bundled, "qp_3_msssim")
    theirs, ours = both(monkeypatch, tmp, 3)
    assert ours == theirs == bundled / f"qp_3_msssim_{hashes['qp_3_msssim']}.mcquic.npz"
    ours.with_suffix(".json").unlink()
    for fn in (fetchZooModel, zooPath):
        with pytest.raises(RuntimeError, match="lacks its metadata sidecar"):
            fn(3)


def test_the_same_cases_are_refused(zoo, monkeypatch):
    """An unregistered slot; a payload whose sidecar the mirror lacks
    (removed from the cache); a hash mismatch (removed); no URL."""
    tmp, _ = zoo
    for fn, name in ((fetchZooModel, "jax"), (zooPath, "port")):
        cache = tmp / f"cache_{name}"
        monkeypatch.setenv("MCQUIC_CACHE", str(cache))
        with pytest.raises(RuntimeError, match="No model registered for slot `qp_7_msssim`"):
            fn(7)
        with pytest.raises(RuntimeError, match="No model registered for slot `qp_4_mse`"):
            fn(4, mse=True)
        with pytest.raises(RuntimeError, match="Failed to fetch model metadata sidecar"):
            fn(4)
        assert not list((cache / "zoo").glob("qp_4_*.npz"))
        with pytest.raises(RuntimeError, match="Hash mismatch for qp_5_msssim_00000000"):
            fn(5)
        assert not list((cache / "zoo").glob("qp_5_*.npz"))
        monkeypatch.delenv("MCQUIC_MODELS_URL")
        with pytest.raises(RuntimeError, match="Model zoo URL not configured"):
            fn(3)
        monkeypatch.setenv("MCQUIC_MODELS_URL", (tmp / "mirror").as_uri())


def test_codec_cli_takes_a_slot_from_the_mirror(zoo, monkeypatch, tmp_path):
    """`-qp 3 --mse` through the port's CLI: the slot is fetched from the
    mirror and compresses a crop; `-D` and `-q` are accepted."""
    from mcquic_tpu_torch.cli import main
    from mcquic_tpu_torch.container import File
    from mcquic_tpu_torch.data.png import readPng, writePng
    monkeypatch.setenv("MCQUIC_CACHE", str(tmp_path / "cache_cli"))
    writePng(tmp_path / "in.png", readPng(ROOT / "assets" / "photo_768x512.png")[:64, :128])
    assert main(["-q", "--device", "cpu", "-qp", "3", "--mse", str(tmp_path / "in.png"),
                 str(tmp_path / "out.mcq")]) == 0
    assert list((tmp_path / "cache_cli" / "zoo").glob("qp_3_mse_*.mcquic.npz"))
    size = File.deserialize((tmp_path / "out.mcq").read_bytes()).FileHeader.ImageSize
    assert (size.height, size.width) == (64, 128)
    assert main(["-D", "--device", "cpu", "--local", str(TINY), str(tmp_path / "out.mcq"),
                 str(tmp_path / "out.png")]) == 0
    assert readPng(tmp_path / "out.png").shape == (64, 128, 3)
