"""The traffic's pool: made from the seed alone."""

from __future__ import annotations

import numpy as np

from meterbench import pool


def test_same_seed_same_pool_and_sources():
    a = pool.make_pool(2**31 + 7, 2, 2.0, "cpu")
    b = pool.make_pool(2**31 + 7, 2, 2.0, "cpu")
    assert a.shape == (2, 96_000, 2) and a.dtype == np.float32 and a.flags.c_contiguous
    assert np.array_equal(a, b)
    sa = pool.stream_sources(2**31 + 7, 16, 2, 96_000)
    sb = pool.stream_sources(2**31 + 7, 16, 2, 96_000)
    assert all(np.array_equal(x, y) for x, y in zip(sa, sb))


def test_seeds_differ():
    a = pool.make_pool(11, 2, 2.0, "cpu")
    b = pool.make_pool(12, 2, 2.0, "cpu")
    assert not np.array_equal(a, b)
    assert not np.array_equal(pool.stream_sources(11, 64, 2, 96_000)[1], pool.stream_sources(12, 64, 2, 96_000)[1])


def test_pool_is_programme_like():
    a = pool.make_pool(5, 4, 10.0, "cpu")
    assert np.isfinite(a).all()
    rms_db = 10 * np.log10(np.mean(a.astype(np.float64) ** 2, axis=(1, 2)))
    assert (rms_db > -90).all() and (rms_db < -5).all()
    assert np.abs(a).max() < 1.0


def test_sampled_streams_spread_over_the_batch():
    idx = pool.sample_streams(3, 8192, 16)
    assert len(set(idx.tolist())) == 16
    assert all(512 * i <= s < 512 * (i + 1) for i, s in enumerate(idx))
    assert np.array_equal(pool.sample_streams(3, 4, 16), np.arange(4))


def test_stream_samples_wrap_the_clip():
    p = np.arange(2 * 10 * 2, dtype=np.float32).reshape(2, 10, 2)
    x = pool.stream_samples(p, 1, 8, 5)
    assert np.array_equal(x[:, 0], np.array([36, 38, 20, 22, 24], np.float32))
