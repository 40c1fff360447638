"""The generator's data path against the JAX package's: class ids from the
sorted wnids, the class-folder loader's labels and epoch order
(`mcquic_tpu/data/imagenet_classes.py::getGenLoader`, whose crops PIL
resizes: the port's are held within one level), the generator's transform
(`augment.trainingTransform(gen=True)`: the gamma and the jitter, no flips)
on the same draws, and the refusal of tar shards and JPEG files."""
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
    with pytest.raises(ValueError, match="tar shards"):
        imagenet_classes.getGenLoader(str(tmp_path / "shards" / "*.tar"), 2)
    with pytest.raises(ValueError, match="tar shards"):
        imagenet_classes.getGenLoader(str(tmp_path / "train.tar.gz"), 2)
    jpeg = tmp_path / "jpeg"
    (jpeg / WNIDS[0]).mkdir(parents=True)
    writePng(jpeg / WNIDS[0] / "a.png", np.zeros((200, 200, 3), np.uint8))
    (jpeg / WNIDS[0] / "b.JPEG").write_bytes(b"\xff\xd8\xff")
    with pytest.raises(ValueError, match="non-PNG"):
        imagenet_classes.getGenLoader(jpeg, 2)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        imagenet_classes.getGenLoader(tmp_path / "empty", 2)
