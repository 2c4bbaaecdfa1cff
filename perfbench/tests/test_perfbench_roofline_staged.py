"""Kernels A's and E's roofline counts against cases worked by hand."""

import pytest

from perfbench import peaks, roofline, roofline_staged


def test_kernel_a_counts_pixels_in_and_int16_coefficients_out():
    # 5 blocks: 5 x 64 pixel bytes, 5 x 64 x 2 coefficient bytes
    assert roofline_staged.kernel_a(5) == (5 * 64 + 5 * 128,
                                           5 * (16 * 34 + 64))
    assert roofline_staged.kernel_a(1)[0] == 192


def test_kernel_e_counts_the_words_it_is_handed_and_the_payload():
    # 2 stripes of 3 blocks: 6 x 64 positions x 3 words of 8 bytes in;
    # payloads of 13 and 7 bytes and 2 x 4 bytes of stripe lengths out
    chunks = 6 * 64 * 3
    assert roofline_staged.kernel_e(chunks, 2, 20) == (chunks * 8 + 20 + 8,
                                                       0)


def test_bytes_bind_a_and_e():
    nb, ops = roofline_staged.kernel_a(1000)
    assert roofline.seconds(nb, ops, peaks.INT8_OPS_PER_S) == pytest.approx(
        nb / peaks.HBM_BYTES_PER_S)
    nb, ops = roofline_staged.kernel_e(1000 * 192, 10, 5000)
    assert roofline.seconds(nb, ops, peaks.INT8_OPS_PER_S) == pytest.approx(
        nb / peaks.HBM_BYTES_PER_S)
