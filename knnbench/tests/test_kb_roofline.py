"""The roofline's arithmetic against numbers worked by hand."""

import pytest

from knnbench import roofline


def test_sift_batch_is_bound_by_operations():
    # 2 · 10,000 · 10⁶ · 128 = 2.56·10¹² at 989·10¹²/s
    assert roofline.search_flops(10_000, 10**6, 128) == 2.56e12
    assert roofline.least_seconds(10_000, 10**6, 128, 10) == pytest.approx(
        2.56e12 / 989e12, rel=1e-12)
    assert roofline.least_seconds(10_000, 10**6, 128, 10) == pytest.approx(
        2.5885e-3, rel=1e-4)
    assert roofline.search_flops(10_000, 10**6, 128) / roofline.PEAK_FLOPS > (
        roofline.search_bytes(10_000, 10**6, 128, 10) / roofline.PEAK_BYTES)
    # (10⁶ + 10⁴) · 128 · 4 + 10⁴ · 10 · 12 bytes
    assert roofline.search_bytes(10_000, 10**6, 128, 10) == 518_320_000


def test_gist_batch_is_bound_by_operations():
    assert roofline.least_seconds(1_000, 10**6, 960, 10) == pytest.approx(
        1.92e12 / 989e12, rel=1e-12)
    assert roofline.least_seconds(1_000, 10**6, 960, 10) == pytest.approx(
        1.9414e-3, rel=1e-4)
    assert roofline.search_bytes(1_000, 10**6, 960, 10) == 3_843_960_000


def test_single_queries_are_bound_by_bytes():
    # one query: 512,000,512 bytes in, 120 out, at 3.35·10¹² B/s
    assert roofline.search_flops(1, 10**6, 128) / roofline.PEAK_FLOPS < (
        roofline.search_bytes(1, 10**6, 128, 10) / roofline.PEAK_BYTES)
    assert roofline.least_seconds(1, 10**6, 128, 10) == pytest.approx(
        512_000_632 / 3.35e12, rel=1e-12)
    assert roofline.least_seconds(1, 10**6, 960, 10) == pytest.approx(
        1.1463e-3, rel=1e-4)


def test_k_beyond_n_writes_n_answers():
    assert roofline.search_bytes(2, 5, 4, 10) == (5 + 2) * 4 * 4 + 2 * 5 * 12
