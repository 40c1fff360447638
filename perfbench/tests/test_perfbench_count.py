"""The operation and byte counts, each against a value worked out by hand."""
import pytest
import torch

from perfbench import count


def test_k1_at_qp2_level_0():
    # 2 groups x 1536 tokens x 8192 codewords x d 64, 2 operations each;
    # tokens, codebook and codes 4 bytes each: 2*1536*64 + 2*8192*64 + 2*1536
    assert count.k1(2, 1536, 8192, 64) == (3_221_225_472, 4 * 1_248_256)


def test_k2_at_the_photo_head():
    # 256 x 384 outputs of 12 channels, 128 x 9 taps each, plus the bias;
    # input 128*256*384, weights 12*128*9 + 12, output 12*256*384 floats
    assert count.k2(1, 128, 256, 384, 3, 2) == (2_719_088_640, 4 * 13_776_396)


def test_k3_at_the_largest_level():
    # 8 images x 8 heads, 256 queries against 426 keys of width 64: two products
    assert count.k3(8, 8, 256, 426, 64) == (1_786_773_504, 4 * 8 * 8 * 64 * (512 + 852))


def test_bound_is_the_slower_of_operations_and_bytes():
    assert count.bound(495e9, 0) == pytest.approx(1e-3)
    assert count.bound(0, 3.35e9) == pytest.approx(1e-3)
    assert count.bound(495e9, 6.7e9) == pytest.approx(2e-3)


def test_model_operations_are_counted_on_meta_tensors():
    # 4 x 4 outputs of 8 channels, 3 x 3 x 3 taps, 2 operations each
    flops = count.modelFlops(lambda: torch.nn.Conv2d(3, 8, 3, padding=1),
                             lambda conv: conv(torch.zeros(1, 3, 4, 4)))
    assert flops == 2 * 16 * 8 * 27
