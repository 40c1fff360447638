"""The port's shard and JPEG loaders against the JAX package's, for two
epochs each: the batches come in the same sample order with the same labels,
and their crops are within the tolerance that
`test_torch_train_functional.py::test_random_resized_crop_is_pil_bilinear_within_one_level`
states for `randomResizedCrop` (one level, under a quarter of the values):

  * `getTrainLoader` on a glob of shards the JAX writer built
    (`mcquic_tpu.data.cli.main`, `{key}.jpg` members at q95), and on a
    folder of PNG and JPEG files;
  * `TarShards` directly: the shard order of each pass and the member order,
    pixel-exact against the JAX package's (PIL) decode;
  * `getGenLoader` on wnid-keyed shards (`{wnid}_{n}.jpg`; the JAX writer
    keys samples by number, so these are written here) with and without a
    `classes.json` sidecar, and on class folders of `.JPEG` files, a CMYK
    `.JPEG` and a `.webp` among them;
  * a folder and a shard mixing PNG, a CMYK JPEG, a WebP with alpha and an
    RLE8 BMP: `getTrainLoader`'s batches, and `TarShards` pixel-exact.
"""
import io
import json
import tarfile
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from mcquic_tpu_torch.data import TarShards, getTrainLoader
from mcquic_tpu_torch.data.imagenet_classes import getGenLoader, shardClassIndex
from mcquic_tpu_torch.data.png import readPng, writePng
from test_torch_images import encodeRle8

ROOT = Path(__file__).resolve().parent.parent
PHOTO = readPng(ROOT / "assets" / "photo_768x512.png")
WNIDS = ["n02099601", "n01440764", "n04592741"]


def _close(ours, theirs, what):
    assert ours.dtype == theirs.dtype == np.uint8 and ours.shape == theirs.shape, what
    diff = np.abs(ours.astype(np.int16) - theirs.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.25, what


def _jpeg(img, quality=95) -> bytes:
    buffer = io.BytesIO()
    Image.fromarray(img).save(buffer, format="JPEG", quality=quality)
    return buffer.getvalue()


@pytest.fixture(scope="module")
def jaxShards(tmp_path_factory):
    """Shards of 7 photo crops (mirrored and shifted), written by the JAX
    writer with -j 3."""
    from mcquic_tpu.data.cli import main
    tmp = tmp_path_factory.mktemp("shards")
    (tmp / "images").mkdir()
    for i, left in enumerate((0, 40, 96, 128, 180, 220, 256)):
        crop = PHOTO[:, left:left + 512]
        writePng(tmp / "images" / f"{i}.png", crop[:, ::-1] if i % 2 else crop)
    assert main(tmp / "images", tmp / "out", jobs=3) == 7
    return tmp / "out"


@pytest.mark.parametrize("pattern", ["*.tar.gz", "mcquic_DATA_00001.tar.gz"])
def test_train_loader_on_jax_shards_equals_jax(jaxShards, pattern):
    from mcquic_tpu.data import getTrainLoader as jaxGetTrainLoader
    source = str(jaxShards / pattern)
    ours = getTrainLoader(source, 2, cropSize=64, seed=3)
    theirs = jaxGetTrainLoader(source, 2, cropSize=64, seed=3)
    for epoch in range(2):
        a, b = list(ours()), list(theirs())
        assert len(a) == len(b) == (3 if pattern.startswith("*") else 1)
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"epoch {epoch} batch {i}")


def test_tar_shards_equal_jax_in_shard_and_member_order(jaxShards):
    from mcquic_tpu.data.dataset import TarShards as JaxTarShards
    ours, theirs = TarShards(str(jaxShards / "*.tar.gz"), seed=4), JaxTarShards(
        str(jaxShards / "*.tar.gz"), seed=4)
    for _ in range(2):                              # each pass reshuffles the shards
        a, b = list(ours), list(theirs)
        assert len(a) == len(b) == 7
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_train_loader_on_a_jpeg_and_png_folder_equals_jax(tmp_path):
    from mcquic_tpu.data import getTrainLoader as jaxGetTrainLoader
    for i in range(5):
        crop = PHOTO[i * 60:i * 60 + 200, i * 100:i * 100 + 260]
        if i % 2:
            (tmp_path / f"{i}.jpg").write_bytes(_jpeg(crop, 90))
        else:
            writePng(tmp_path / f"{i}.png", crop)
    ours = getTrainLoader(tmp_path, 2, cropSize=48, seed=1)
    theirs = jaxGetTrainLoader(str(tmp_path), 2, cropSize=48, seed=1)
    for epoch in range(2):
        a, b = list(ours()), list(theirs())
        assert len(a) == len(b) == 2
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"epoch {epoch} batch {i}")


def _mixed(i: int):
    """(name, bytes) of crop i in the forms the JAX package reads through
    PIL: PNG, CMYK JPEG, WebP with alpha, RLE8 BMP."""
    from mcquic_tpu_torch.data.png import encodePng
    crop = np.ascontiguousarray(PHOTO[i * 50:i * 50 + 200, i * 90:i * 90 + 260])
    buffer = io.BytesIO()
    kind = i % 4
    if kind == 0:
        return f"{i}.png", encodePng(crop)
    if kind == 1:
        Image.fromarray(crop).convert("CMYK").save(buffer, format="JPEG", quality=90)
        return f"{i}.jpg", buffer.getvalue()
    if kind == 2:
        alpha = (np.arange(crop.shape[1])[None].repeat(crop.shape[0], 0) % 256).astype(np.uint8)
        Image.fromarray(np.dstack([crop, alpha]), "RGBA").save(buffer, format="WEBP", quality=80)
        return f"{i}.webp", buffer.getvalue()
    return f"{i}.bmp", encodeRle8(crop)


def test_train_loader_on_a_mixed_folder_equals_jax(tmp_path):
    from mcquic_tpu.data import getTrainLoader as jaxGetTrainLoader
    for i in range(6):
        name, data = _mixed(i)
        (tmp_path / name).write_bytes(data)
    ours = getTrainLoader(tmp_path, 2, cropSize=48, seed=5)
    theirs = jaxGetTrainLoader(str(tmp_path), 2, cropSize=48, seed=5)
    for epoch in range(2):
        a, b = list(ours()), list(theirs())
        assert len(a) == len(b) == 3
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"epoch {epoch} batch {i}")


def test_tar_shards_of_mixed_members_equal_jax(tmp_path):
    from mcquic_tpu.data.dataset import TarShards as JaxTarShards
    with tarfile.open(tmp_path / "mixed.tar", "w") as tf:
        for i in range(4):
            name, data = _mixed(i)
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    ours, theirs = list(TarShards(str(tmp_path / "mixed.tar"))), list(JaxTarShards(str(tmp_path / "mixed.tar")))
    assert len(ours) == len(theirs) == 4
    for x, y in zip(ours, theirs):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def genShards(tmp_path_factory):
    """Two wnid-keyed shards: `{wnid}_{n}.jpg` members, a `.txt` member and
    a member of a wnid outside the sidecar's classes."""
    tmp = tmp_path_factory.mktemp("genShards")
    n = 0
    for s in range(2):
        with tarfile.open(tmp / f"gen_{s}.tar", "w") as tf:
            for j in range(5):
                wnid = WNIDS[(s + j) % 3] if j != 4 else "n09999999"
                crop = PHOTO[j * 50:j * 50 + 180, s * 200 + j * 40:s * 200 + j * 40 + 220]
                for name, data in ((f"{wnid}_{n}.jpg", _jpeg(crop)), (f"{wnid}_{n}.txt", b"a")):
                    info = tarfile.TarInfo(name)
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
                n += 1
    return tmp


@pytest.mark.parametrize("sidecar", [False, True])
def test_gen_loader_on_wnid_shards_equals_jax(genShards, tmp_path, sidecar):
    from mcquic_tpu.data import imagenet_classes as jaxClasses
    folder = genShards
    if sidecar:
        folder = tmp_path
        for shard in genShards.glob("*.tar"):
            (tmp_path / shard.name).write_bytes(shard.read_bytes())
        (tmp_path / "classes.json").write_text(json.dumps(sorted(WNIDS)))
    pattern = str(folder / "*.tar")
    assert shardClassIndex(pattern) == jaxClasses.shardClassIndex(pattern)
    assert len(shardClassIndex(pattern)) == (3 if sidecar else 4)
    ours = getGenLoader(pattern, 2, cropSize=64, seed=2)
    theirs = jaxClasses.getGenLoader(pattern, 2, cropSize=64, seed=2)
    for epoch in range(2):
        a, b = list(ours()), list(theirs())
        assert len(a) == len(b) == (4 if sidecar else 5)
        for i, ((x, lx), (y, ly)) in enumerate(zip(a, b)):
            np.testing.assert_array_equal(lx, ly, err_msg=f"epoch {epoch} batch {i}")
            _close(x, y, f"epoch {epoch} batch {i}")


def test_gen_loader_on_jpeg_class_folders_equals_jax(tmp_path):
    from mcquic_tpu.data import imagenet_classes as jaxClasses
    for c, wnid in enumerate(WNIDS):
        (tmp_path / wnid).mkdir()
        for i in range(2 + c):
            crop = PHOTO[c * 100 + i * 30:c * 100 + i * 30 + 160, i * 90:i * 90 + 200]
            (tmp_path / wnid / f"{wnid}_{i}.JPEG").write_bytes(_jpeg(crop))
    cmyk, webp = io.BytesIO(), io.BytesIO()
    Image.fromarray(PHOTO[300:480, 400:620]).convert("CMYK").save(cmyk, format="JPEG", quality=92)
    Image.fromarray(PHOTO[250:420, 500:700]).save(webp, format="WEBP")
    (tmp_path / WNIDS[0] / f"{WNIDS[0]}_cmyk.JPEG").write_bytes(cmyk.getvalue())
    (tmp_path / WNIDS[1] / f"{WNIDS[1]}_w.webp").write_bytes(webp.getvalue())
    ours = getGenLoader(tmp_path, 3, cropSize=64, seed=7)
    theirs = jaxClasses.getGenLoader(str(tmp_path), 3, cropSize=64, seed=7)
    for epoch in range(2):
        a, b = list(ours()), list(theirs())
        assert len(a) == len(b) == 3
        for i, ((x, lx), (y, ly)) in enumerate(zip(a, b)):
            np.testing.assert_array_equal(lx, ly, err_msg=f"epoch {epoch} batch {i}")
            _close(x, y, f"epoch {epoch} batch {i}")


def test_tar_shards_skip_what_is_corrupt_and_name_what_is_unsupported(tmp_path):
    """A truncated JPEG, a truncated PNG and a non-image member are skipped, as
    the JAX package's `TarShards` skips them; BMP and palette PNG members
    are read and equal the JAX `TarShards`' (PIL's); a BMP whose
    uncompressed pixels are labelled RLE8, which PIL cannot read either, is
    skipped as the JAX `TarShards` skips it."""
    from mcquic_tpu.data.dataset import TarShards as JaxTarShards
    from mcquic_tpu_torch.data.png import encodePng
    good = [PHOTO[:120, :160], PHOTO[200:320, 300:460]]
    members = [("0.jpg", _jpeg(good[0])), ("1.jpg", _jpeg(good[1])[:300]),
               ("2.png", encodePng(good[1])), ("3.png", encodePng(good[0])[:2000]),
               ("4.txt", b"caption")]

    def shard(path, members):
        with tarfile.open(path, "w") as tf:
            for name, data in members:
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    shard(tmp_path / "a.tar", members)
    ours, theirs = list(TarShards(str(tmp_path / "a.tar"))), list(JaxTarShards(str(tmp_path / "a.tar")))
    assert len(ours) == len(theirs) == 2
    for x, y in zip(ours, theirs):
        np.testing.assert_array_equal(x, y)

    palette = io.BytesIO()
    Image.fromarray(good[0]).convert("P").save(palette, format="PNG")
    bmp = io.BytesIO()
    Image.fromarray(good[1]).save(bmp, format="BMP")
    shard(tmp_path / "b.tar", (("5.bmp", bmp.getvalue()), ("6.png", palette.getvalue())))
    ours, theirs = list(TarShards(str(tmp_path / "b.tar"))), list(JaxTarShards(str(tmp_path / "b.tar")))
    assert len(ours) == len(theirs) == 2
    for x, y in zip(ours, theirs):
        np.testing.assert_array_equal(x, y)

    rle = io.BytesIO()
    Image.fromarray(good[0]).convert("P").save(rle, format="BMP")
    rle = bytearray(rle.getvalue())
    rle[30:34] = (1).to_bytes(4, "little")               # BI_RLE8
    shard(tmp_path / "c.tar", (("7.bmp", bytes(rle)), ("8.jpg", _jpeg(good[1]))))
    ours, theirs = list(TarShards(str(tmp_path / "c.tar"))), list(JaxTarShards(str(tmp_path / "c.tar")))
    assert len(ours) == len(theirs) == 1
    np.testing.assert_array_equal(ours[0], theirs[0])


# ------------------------------------------------------------ split by host

@pytest.mark.parametrize("hostCount", [2, 3])
def test_tar_shards_split_by_host_as_jax(jaxShards, hostCount):
    """Host h of n reads shards[h::n], as the JAX package's `TarShards`: the
    hosts' shard lists are disjoint, their union is every shard, and each
    host's samples equal the JAX package's for that host."""
    from mcquic_tpu.data.dataset import TarShards as JaxTarShards
    pattern = str(jaxShards / "*.tar.gz")
    splits = [TarShards(pattern, seed=4, hostId=h, hostCount=hostCount) for h in range(hostCount)]
    names = [s._shards for s in splits]
    assert sorted(sum(names, [])) == sorted(str(p) for p in jaxShards.glob("*.tar.gz"))
    assert len(set(sum(names, []))) == sum(len(n) for n in names)
    for h, ours in enumerate(splits):
        theirs = JaxTarShards(pattern, hostId=h, hostCount=hostCount, seed=4)
        assert ours._shards == theirs._shards
        for x, y in zip(list(ours), list(theirs)):
            np.testing.assert_array_equal(x, y)


def test_train_loader_splits_shards_but_reads_a_folder_whole_on_every_host(jaxShards, tmp_path):
    """`getTrainLoader` hands hostId / hostCount to the shards only: on
    shards each host's batches equal the JAX loader's for that host, and the
    hosts' samples add up to all 7; on a folder every host reads the whole
    folder with the same seed, as the JAX loader does."""
    from mcquic_tpu.data import getTrainLoader as jaxGetTrainLoader
    pattern = str(jaxShards / "*.tar.gz")
    total = 0
    for h in range(2):
        ours = getTrainLoader(pattern, 1, cropSize=48, seed=3, hostId=h, hostCount=2)()
        theirs = jaxGetTrainLoader(pattern, 1, cropSize=48, seed=3, hostId=h, hostCount=2)()
        a, b = list(ours), list(theirs)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, f"host {h}")
        total += len(a)
    assert total == 7
    for i in range(3):
        writePng(tmp_path / f"{i}.png", PHOTO[i * 60:i * 60 + 200, i * 100:i * 100 + 260])
    whole = list(getTrainLoader(tmp_path, 1, cropSize=48, seed=1)())
    for h in range(2):
        host = list(getTrainLoader(tmp_path, 1, cropSize=48, seed=1, hostId=h, hostCount=2)())
        theirs = list(jaxGetTrainLoader(str(tmp_path), 1, cropSize=48, seed=1, hostId=h,
                                        hostCount=2)())
        assert len(host) == len(whole) == len(theirs) == 3
        for x, y, z in zip(host, whole, theirs):
            np.testing.assert_array_equal(x, y)
            _close(x, z, f"folder, host {h}")


def test_gen_loader_splits_shards_and_class_files_by_host_as_jax(genShards, tmp_path):
    """`getGenLoader` on wnid-keyed shards and on class folders: each host's
    batches equal the JAX loader's for that host (labels exact), the hosts'
    samples add up to all of them, and a host with no shard is refused as
    the JAX loader refuses it."""
    from mcquic_tpu.data import imagenet_classes as jaxClasses
    for c, wnid in enumerate(WNIDS):
        (tmp_path / wnid).mkdir()
        for i in range(2 + c):
            crop = PHOTO[c * 100 + i * 30:c * 100 + i * 30 + 160, i * 90:i * 90 + 200]
            (tmp_path / wnid / f"{wnid}_{i}.JPEG").write_bytes(_jpeg(crop))
    for source, count in ((str(genShards / "*.tar"), 10), (tmp_path, 9)):
        total = 0
        for h in range(2):
            a = list(getGenLoader(source, 1, cropSize=64, seed=2, hostId=h, hostCount=2)())
            b = list(jaxClasses.getGenLoader(str(source), 1, cropSize=64, seed=2, hostId=h,
                                             hostCount=2)())
            assert len(a) == len(b) > 0
            for (x, lx), (y, ly) in zip(a, b):
                np.testing.assert_array_equal(lx, ly)
                _close(x, y, f"{source} host {h}")
            total += len(a)
        assert total == count
    with pytest.raises(FileNotFoundError, match="No shards for host 2 in"):
        getGenLoader(str(genShards / "*.tar"), 1, hostId=2, hostCount=3)
    with pytest.raises(FileNotFoundError, match="No shards for host 2 in"):
        jaxClasses.getGenLoader(str(genShards / "*.tar"), 1, hostId=2, hostCount=3)
