"""The generator's data path against the JAX package's: class ids from the
sorted wnids, the class-folder loader's labels and epoch order
(`mcquic_tpu/data/imagenet_classes.py::getGenLoader`, whose crops PIL
resizes: the port's are held within one level), the generator's transform
(`augment.trainingTransform(gen=True)`: the gamma and the jitter, no flips)
on the same draws, tar shards and JPEG class folders read as the JAX loader
reads them, with BMP, CMYK JPEG, WebP and progressive JPEG files among them."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcquic_tpu.data import augment as jaxAugment
from mcquic_tpu.data import imagenet_classes as jaxClasses
from mcquic_tpu_torch.data import imagenet_classes
from mcquic_tpu_torch.data.augment import trainingTransform
from mcquic_tpu_torch.data.png import readPng, writePng
from test_torch_train_functional import _jaxDraws

ROOT = Path(__file__).resolve().parent.parent
WNIDS = ["n02099601", "n01440764", "n04592741"]


@pytest.fixture(scope="module")
def classes(tmp_path_factory):
    """Three wnid folders of PNG crops (one too small to use) and a stray
    directory that is no wnid."""
    root = tmp_path_factory.mktemp("classes")
    img = readPng(ROOT / "assets" / "photo_768x512.png")
    for j, wnid in enumerate(WNIDS):
        (root / wnid).mkdir()
        for i in range(3 + j):
            size = 50 if (j, i) == (1, 0) else 200 + 17 * i
            writePng(root / wnid / f"{i}.png", img[j * 90 + i * 13:j * 90 + i * 13 + size,
                                                   i * 70:i * 70 + size + 20])
    (root / "not_a_class").mkdir()
    return root


def test_class_index_is_the_sorted_wnids(classes):
    shuffled = ["n04592741", "n01440764", "n02099601", "n01440764"]
    assert imagenet_classes.classIndexFromWnids(shuffled) == jaxClasses.classIndexFromWnids(shuffled)
    assert imagenet_classes.folderClassIndex(classes) == jaxClasses.folderClassIndex(classes) == {
        w: i for i, w in enumerate(sorted(WNIDS))}


def test_loader_labels_and_epoch_order_equal_jax(classes):
    ours = imagenet_classes.getGenLoader(classes, 2, cropSize=128, seed=5)
    theirs = jaxClasses.getGenLoader(str(classes), 2, cropSize=128, seed=5)
    for epoch in range(2):
        a, b = list(ours()), list(theirs())
        assert len(a) == len(b) == 5                  # 11 usable images, batch 2
        for (imgA, lblA), (imgB, lblB) in zip(a, b):
            np.testing.assert_array_equal(lblA, lblB, err_msg=f"epoch {epoch}")
            assert imgA.dtype == imgB.dtype == np.uint8 and imgA.shape == imgB.shape
            assert np.abs(imgA.astype(int) - imgB.astype(int)).max() <= 1
        assert {int(l) for _, lbl in a for l in lbl} == {0, 1, 2}


def test_gen_transform_equals_jax_and_never_flips():
    batch = np.random.default_rng(3).integers(0, 256, size=(4, 16, 24, 3), dtype=np.uint8)
    seen = set()
    for seed in range(40):
        if len(seen) == 4 and seed >= 8:
            break
        key = jax.random.PRNGKey(seed)
        draws = _jaxDraws(key, batch.shape[0])
        seen.add(draws.gammaChoice)
        theirs = np.asarray(jaxAugment.trainingTransform(key, jnp.asarray(batch), gen=True))
        ours = trainingTransform(torch.from_numpy(batch), draws, gen=True)
        np.testing.assert_allclose(ours.numpy().transpose(0, 2, 3, 1), theirs, rtol=0, atol=1e-6)
        flipsAll = draws._replace(flipH=torch.zeros(4), flipV=torch.zeros(4))
        assert torch.equal(trainingTransform(torch.from_numpy(batch), flipsAll, gen=True), ours)
    assert seen == {0, 1, 2, 3}


def test_shards_and_jpeg_are_refused(classes, tmp_path):
    """Tar shards and JPEG class folders are read and match the JAX loader
    (labels equal, crops within one level), a progressive JPEG and a BMP
    among them; a progressive JPEG whose scans leave bits unsent (libjpeg
    smooths its blocks), a CMYK JPEG and a WebP are read as the JAX loader
    reads them, and a corrupt WebP is skipped as it skips it."""
    import io
    import tarfile
    from PIL import Image
    from mcquic_tpu_torch.data.jpeg import encodeJpeg
    img = readPng(ROOT / "assets" / "photo_768x512.png")
    (tmp_path / "shards").mkdir()
    with tarfile.open(tmp_path / "shards" / "a.tar.gz", "w:gz") as tf:
        for i in range(4):
            data = encodeJpeg(img[i * 50:i * 50 + 200, i * 80:i * 80 + 240], 95)
            info = tarfile.TarInfo(f"{WNIDS[i % 3]}_{i}.jpg")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    jpeg = tmp_path / "jpeg"
    for i, wnid in enumerate(WNIDS):
        (jpeg / wnid).mkdir(parents=True)
        (jpeg / wnid / f"{i}.JPEG").write_bytes(encodeJpeg(img[i * 90:i * 90 + 200, :260], 95))
    writePng(jpeg / WNIDS[0] / "a.png", img[200:400, 300:560])
    for source in (str(tmp_path / "shards" / "*.tar.gz"), str(tmp_path / "shards" / "a.tar.gz"),
                   jpeg):
        ours = list(imagenet_classes.getGenLoader(source, 2, cropSize=128, seed=1)())
        theirs = list(jaxClasses.getGenLoader(str(source), 2, cropSize=128, seed=1)())
        assert len(ours) == len(theirs) == 2
        for (imgA, lblA), (imgB, lblB) in zip(ours, theirs):
            np.testing.assert_array_equal(lblA, lblB)
            assert np.abs(imgA.astype(int) - imgB.astype(int)).max() <= 1

    # a progressive JPEG and a BMP are read, as the JAX loader reads them through PIL
    progressive = io.BytesIO()
    Image.fromarray(img[:200, :200]).save(progressive, format="JPEG", progressive=True)
    (jpeg / WNIDS[1] / "p.JPEG").write_bytes(progressive.getvalue())
    Image.fromarray(img[250:460, 100:330]).save(jpeg / WNIDS[1] / "q.bmp")
    ours = list(imagenet_classes.getGenLoader(jpeg, 2, cropSize=128, seed=1)())
    theirs = list(jaxClasses.getGenLoader(str(jpeg), 2, cropSize=128, seed=1)())
    assert len(ours) == len(theirs) == 3
    for (imgA, lblA), (imgB, lblB) in zip(ours, theirs):
        np.testing.assert_array_equal(lblA, lblB)
        assert np.abs(imgA.astype(int) - imgB.astype(int)).max() <= 1
    # one whose scans leave bits unsent, a CMYK JPEG and a WebP are read; a
    # corrupt WebP is skipped
    data = progressive.getvalue()
    (jpeg / WNIDS[1] / "p.JPEG").write_bytes(data[:data.rindex(b"\xff\xda")] + b"\xff\xd9")
    cmyk, webp = io.BytesIO(), io.BytesIO()
    Image.fromarray(img[300:500, 400:640]).convert("CMYK").save(cmyk, format="JPEG", quality=90)
    Image.fromarray(img[200:400, 500:740]).save(webp, format="WEBP", quality=70)
    (jpeg / WNIDS[2] / "c.JPEG").write_bytes(cmyk.getvalue())
    (jpeg / WNIDS[0] / "w.webp").write_bytes(webp.getvalue())
    (jpeg / WNIDS[0] / "b.webp").write_bytes(b"RIFF")
    ours = list(imagenet_classes.getGenLoader(jpeg, 2, cropSize=128, seed=1)())
    theirs = list(jaxClasses.getGenLoader(str(jpeg), 2, cropSize=128, seed=1)())
    assert len(ours) == len(theirs) == 4
    for (imgA, lblA), (imgB, lblB) in zip(ours, theirs):
        np.testing.assert_array_equal(lblA, lblB)
        assert np.abs(imgA.astype(int) - imgB.astype(int)).max() <= 1
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        imagenet_classes.getGenLoader(tmp_path / "empty", 2)
    with pytest.raises(FileNotFoundError, match="No shards match"):
        imagenet_classes.getGenLoader(str(tmp_path / "none" / "*.tar"), 2)
