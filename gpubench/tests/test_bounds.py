"""The frozen bound arithmetic on shapes counted by hand."""

import pytest

from gpubench import bounds


def test_peaks():
    assert bounds.INT32_OPS_PER_S == pytest.approx(132 * 64 * 1.98e9)
    assert bounds.F32_OPS_PER_S == pytest.approx(132 * 128 * 1.98e9)


def test_gather_bound():
    # 1,000,000 distinct rows of 68 words: 272 MB at 3.35 TB/s
    assert bounds.gather_bound_s(1_000_000, 68) == pytest.approx(272e6 / 3.35e12)


def test_b4_score_pass_is_bound_by_operations():
    # 512 pairs of 150 rows, band 128, packed, score only: 76,800 rows x 128
    # cells x 8 ALU operations at 64 a clock on 132 SMs at 1.98 GHz
    t = bounds.b4_bound_s(512 * 150, 512, 256, 128, plane=False, packed=True)
    alu = 512 * 150 * 128 * 8 / (132 * 64 * 1.98e9)
    all_ops = 512 * 150 * 128 * 11 / (132 * 128 * 1.98e9)
    assert t == pytest.approx(max(alu, all_ops)) and alu > all_ops


def test_b4_plane_pass_is_bound_by_bytes():
    # the plane: 4 bytes a band cell of every row, 4,096 x 160 x 128 x 4
    p, l, band = 4096, 160, 128
    nbytes = p * l + 4 * p + 2 * p * (l + band) + 8 * p + 4 * p * l * band
    t = bounds.b4_bound_s(p * l, p, l, band, plane=True, packed=False)
    assert t == pytest.approx(nbytes / 3.35e12)


def test_b4_packed_bytes():
    p, l, band = 256, 256, 128
    nbytes = p * (64 + 4 + 96 + 8 + 8)
    assert bounds.b4_bound_s(0, p, l, band, plane=False, packed=True) == pytest.approx(nbytes / 3.35e12)
