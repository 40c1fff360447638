"""The port's shard writer (`python -m mcquic_tpu_torch dataset`,
`mcquic_tpu_torch/data/cli.py`) against the JAX package's
(`mcquic_tpu.data.cli.main`) on the same folder: with -j 1 and 3, with -G,
and with more jobs than images, every shard's tar bytes (compared after
gzip decompression: the deflate bytes depend on the zlib build) and
`metadata.json` are equal. The folder holds 512x512 crops of the photo as
PNG, JPEG, BMP, a CMYK JPEG, a WebP with alpha and an RLE8 BMP (the port
reads each as the JAX writer reads it through PIL), an image under the
filter's 512 px, a corrupt JPEG and a corrupt WebP, which both writers drop.

`tests/golden/torch_jpeg/photo.json` holds what `chip_smoke.py` holds the
card host to: the digests of PIL's q95 bytes of the photo and of its decode
of them, and of the JAX writer's shards (-j 2) of the script's 512x512 crops
with PIL's decode of their members. A test here recomputes it with PIL and
the JAX writer, and checks that the port's codec and writer give it too.
"""
import gzip
import hashlib
import importlib.util
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from mcquic_tpu_torch.data import cli as portCli
from mcquic_tpu_torch.data.png import readPng, writePng
from test_torch_images import encodeRle8

ROOT = Path(__file__).resolve().parent.parent
PHOTO_JSON = ROOT / "tests" / "golden" / "torch_jpeg" / "photo.json"


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    folder = tmp_path_factory.mktemp("images")
    photo = readPng(ROOT / "assets" / "photo_768x512.png")
    for i, left in enumerate((0, 64, 128, 256)):
        writePng(folder / f"crop_{i}.png", photo[:, left:left + 512])
    Image.fromarray(photo[:, 200:712][:, ::-1]).save(folder / "mirrored_photo.jpg", quality=90)
    writePng(folder / "small.png", photo[:300, :600])
    (folder / "broken.jpg").write_bytes(b"\xff\xd8\xff\xe0\x00\x10JFIF")
    Image.fromarray(photo[:, 100:612]).save(folder / "crop_bmp.bmp")
    Image.fromarray(photo[:, 150:662]).convert("CMYK").save(folder / "crop_cmyk.jpg", quality=95)
    alpha = np.dstack([photo[:, 30:542], (np.arange(512)[None].repeat(512, 0) % 256).astype(np.uint8)])
    Image.fromarray(alpha, "RGBA").save(folder / "crop_alpha.webp", quality=80)
    (folder / "crop_rle8.bmp").write_bytes(encodeRle8(photo[:, 220:732]))
    (folder / "skipped.webp").write_bytes(b"RIFF")
    return folder


def _tars(folder: Path) -> dict:
    return {p.name: gzip.decompress(p.read_bytes()) for p in sorted(folder.glob("*.tar.gz"))}


def _both(images: Path, tmp: Path, jobs: int, gen: bool):
    from mcquic_tpu.data import cli as jaxCli
    theirs, ours = tmp / "jax", tmp / "port"
    nTheirs = jaxCli.main(images, theirs, jobs=jobs, gen=gen)
    nOurs = portCli.main(images, ours, jobs=jobs, gen=gen)
    return nOurs, nTheirs, ours, theirs


@pytest.mark.parametrize("jobs,gen", [(1, False), (3, False), (2, True), (12, False)],
                         ids=["j1", "j3", "j2 -G", "more jobs than images"])
def test_shards_equal_the_jax_writers(images, tmp_path, jobs, gen):
    nOurs, nTheirs, ours, theirs = _both(images, tmp_path, jobs, gen)
    assert nOurs == nTheirs == 9
    a, b = _tars(ours), _tars(theirs)
    assert list(a) == list(b) == [f"mcquic_DATA_{i:05d}.tar.gz" for i in range(min(jobs, 9))]
    for name in a:
        assert a[name] == b[name], name
    assert (ours / "metadata.json").read_text() == (theirs / "metadata.json").read_text()
    assert json.loads((ours / "metadata.json").read_text()) == {
        "count": 9, "shards": min(jobs, 9), "imageText": gen}
    assert not list(ours.glob("split*"))


def test_dataset_command_writes_shards_and_names_what_it_skips(images, tmp_path):
    """`python -m mcquic_tpu_torch dataset -j 2 IMAGES OUTPUT` in a
    subprocess: it prints the count (the corrupt WebP and JPEG dropped, as
    the JAX writer drops them; the CMYK JPEG, the WebP and the RLE8 BMP
    kept), and its members are `{key}.jpg` in key order across the shards."""
    import tarfile
    proc = subprocess.run([sys.executable, "-m", "mcquic_tpu_torch", "dataset", "-j", "2",
                           str(images), str(tmp_path / "out")], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "9"
    names = []
    for shard in sorted((tmp_path / "out").glob("*.tar.gz")):
        with tarfile.open(shard, "r:gz") as tf:
            names += [m.name for m in tf]
    assert names == [f"{k:09d}.jpg" for k in range(9)]
    first = tarfile.open(sorted((tmp_path / "out").glob("*.tar.gz"))[0], "r:gz")
    data = first.extractfile(first.getmember("000000000.jpg")).read()
    assert np.asarray(Image.open(io.BytesIO(data))).shape == (512, 512, 3)


def _chipSmoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _pilDecode(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def photoDigests(tmp: Path) -> dict:
    """photo.json's content, from PIL and the JAX writer. Run once with a
    temporary folder to write `tests/golden/torch_jpeg/photo.json`."""
    from mcquic_tpu.data import cli as jaxCli
    smoke = _chipSmoke()
    photo = readPng(ROOT / "assets" / "photo_768x512.png")
    buf = io.BytesIO()
    Image.fromarray(photo).save(buf, format="JPEG", quality=95)
    data = buf.getvalue()
    images = tmp / "crops"
    images.mkdir()
    for name, crop in smoke.shardCrops(photo).items():
        Image.fromarray(np.ascontiguousarray(crop)).save(images / name)
    assert jaxCli.main(images, tmp / "jax", jobs=2) == smoke.SHARD_CROPS
    return {"photo_q95": {"sha256": hashlib.sha256(data).hexdigest(),
                          "decode_sha256": hashlib.sha256(_pilDecode(data).tobytes()).hexdigest()},
            "shard_crops": smoke.shardDigests(tmp / "jax", _pilDecode)}


def test_card_digests_are_pils_and_the_jax_writers_and_the_ports(tmp_path):
    from mcquic_tpu_torch.data.jpeg import encodeJpeg, readJpeg
    want = json.loads(PHOTO_JSON.read_text())
    assert photoDigests(tmp_path) == want
    smoke = _chipSmoke()
    photo = readPng(ROOT / "assets" / "photo_768x512.png")
    data = encodeJpeg(photo, 95)
    assert {"sha256": hashlib.sha256(data).hexdigest(),
            "decode_sha256": hashlib.sha256(readJpeg(data).tobytes()).hexdigest()} == want["photo_q95"]
    assert portCli.main(tmp_path / "crops", tmp_path / "port", jobs=2) == smoke.SHARD_CROPS
    assert smoke.shardDigests(tmp_path / "port", readJpeg) == want["shard_crops"]
