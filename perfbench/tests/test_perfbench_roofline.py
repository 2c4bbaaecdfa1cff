"""The roofline counts against a case worked by hand."""

import pytest

from perfbench import peaks, roofline


def test_kernel_b_counts_the_payload_not_a_buffer():
    # 2 stripes of 3 blocks: 6 x 64 pixel bytes, payloads of 13 and 7
    # bytes, 2 x 4 bytes of stripe lengths, 6 x 2 bytes of index
    nbytes, ops = roofline.kernel_b(6, 2, 20, True)
    assert nbytes == 384 + 20 + 8 + 12
    assert ops == 6 * (16 * 34 + 64)
    assert roofline.kernel_b(6, 2, 20, False)[0] == 384 + 20 + 8


def test_kernel_d_and_c():
    # 4 blocks in 2 stripes, 30 payload bytes: 30 + 4 x 2 index + 2 x
    # (8 + 4) starts and status + 4 x 64 x 2 coefficients
    assert roofline.kernel_d(4, 2, 30) == (30 + 8 + 24 + 512, 0)
    assert roofline.kernel_c(4) == (4 * 64 * 3, 4 * 608)


def test_bytes_bound_the_three_kernels():
    nb, ops = roofline.kernel_b(1000, 10, 0, False)
    assert roofline.seconds(nb, ops, peaks.INT8_OPS_PER_S) == pytest.approx(
        nb / peaks.HBM_BYTES_PER_S)
    nb, ops = roofline.kernel_c(1000)
    assert roofline.seconds(nb, ops, peaks.FP32_FLOPS_PER_S) == pytest.approx(
        nb / peaks.HBM_BYTES_PER_S)
