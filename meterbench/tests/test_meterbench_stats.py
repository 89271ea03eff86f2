"""Percentiles, interval unions, and the roofline counts."""

from __future__ import annotations

import numpy as np
import pytest

from meterbench import roofline, stats


def test_percentile_matches_numpy_linear():
    rng = np.random.default_rng(1)
    xs = rng.standard_normal(357)
    for q in (0, 5, 50, 95, 99, 100):
        assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12, abs=1e-12)
    assert stats.percentile([3.0], 95) == 3.0
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_union_gaps_and_cover():
    merged = stats.union([(5, 7), (0, 2), (1, 3), (6, 9), (10, 10)])
    assert merged == [(0, 3), (5, 9)]
    assert stats.covered([(0, 2), (1, 3), (5, 9)]) == 7
    assert stats.gaps(merged, -1, 12) == [(-1, 0), (3, 5), (9, 12)]



def test_byte_counts_reproduce_the_recorded_bounds():
    """B1a and B2 at S=8192 (2048/64, 256-frame blocks): 0.0628 and 0.2914
    ms of bytes at 3.35 TB/s, as ``chip_smoke.py`` phases 3 and 6 read."""
    assert round(roofline.least_ms(*roofline.sliding_hop_cost(8192, 2048, 64, 256)), 4) == 0.0628
    assert round(roofline.least_ms(*roofline.reassigned_hop_cost(8192, 2048, 64, 256)), 4) == 0.2914
    moved, flops = roofline.sliding_hop_cost(8192, 2048, 64, 256)
    assert moved / roofline.PEAK_BYTES > flops / roofline.PEAK_FLOPS  # bound by bytes
