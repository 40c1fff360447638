"""Every input of a run comes from its seed: the same seed gives the same
inputs, another seed others, and every seed the same amount of work."""
import numpy as np
import pytest
import torch

from perfbench import images, weights
from perfbench.drivers import codec_batches, generate
from perfbench.reference.v1 import Compressor

SEEDS = (2**31 + 11, 2**33 + 5)


@pytest.fixture(scope="module")
def photo():
    return images.readPng()


def test_the_photo_decodes_to_its_size(photo):
    assert photo.shape == (512, 768, 3) and photo.dtype == np.uint8
    assert 40 < photo.mean() < 215


def test_photo_variants_follow_the_seed(photo):
    a, b = (images.variants(photo, 3, SEEDS[0], "cpu") for _ in range(2))
    c = images.variants(photo, 3, SEEDS[1], "cpu")
    assert a.shape == (3, 512, 768, 3) and np.array_equal(a, b) and not np.array_equal(a, c)


def test_batch_order_follows_the_seed():
    a, b, c = (codec_batches.order(64, s) for s in (SEEDS[0], SEEDS[0], SEEDS[1]))
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert sorted(a[:64]) == list(range(64)) == sorted(c[:64])


def test_generation_calls_follow_the_seed():
    a, b, c = (generate.calls(1000, 8, 4, s) for s in (SEEDS[0], SEEDS[0], SEEDS[1]))
    assert a == b and a != c
    assert [greedy for _, _, greedy in a[:8]] == [False, False, False, True] * 2
    assert all(0 <= k < 1000 for classes, _, _ in a for k in classes)


def test_seeded_weights_follow_the_seed():
    shapes = weights.shapesOf(lambda: Compressor(16, 2, [64, 32, 16]))
    a, b = (weights.seeded(shapes, SEEDS[0], "cpu") for _ in range(2))
    c = weights.seeded(shapes, SEEDS[1], "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not any(torch.equal(a[k], c[k]) for k in a if a[k].numel() > 4)
