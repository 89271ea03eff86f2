"""The plain references against cases with known answers."""

from __future__ import annotations

import math

import numpy as np
import pytest

from meterbench.reference import loudness, round_tf32, spectrogram

RATE = 48_000


def test_ebu_tech_3341_case_1():
    """A stereo 1 kHz sine at -23 dBFS reads -23.0 LUFS, +-0.1."""
    n = 20 * RATE
    a = 10 ** (-23 / 20)
    x = np.repeat((a * np.sin(2 * np.pi * 1000 * np.arange(n) / RATE))[:, None], 2, axis=1)
    hops = np.array([n // 256 - 1])
    out = loudness.series(x, hops)
    for field in ("momentary_lufs", "short_term_lufs", "integrated_lufs"):
        assert abs(out[field][0] + 23.0) <= 0.1, (field, out[field])
    # a sine's true peak is its amplitude; K-weighted RMS of the 1 kHz tone is near -23 - 3 dB + 0.7
    assert np.allclose(out["true_peak_db"][0], -23.0, atol=0.01)
    assert abs(out["lra_lu"][0]) < 0.1


def test_gating_drops_the_quiet_part():
    """Integrated loudness of -23 dBFS then -90 dBFS (below the absolute
    gate) is the loud part's; the loudness range of a steady tone is 0."""
    a, q = 10 ** (-23 / 20), 10 ** (-90 / 20)
    t = np.arange(20 * RATE) / RATE
    x = np.sin(2 * np.pi * 1000 * t)
    x = np.where(t < 10, a * x, q * x)
    out = loudness.series(np.stack([x, x], 1), np.array([20 * RATE // 256 - 1]))
    assert abs(out["integrated_lufs"][0] + 23.0) <= 0.1


def test_tone_column_matches_its_closed_form():
    """A tone on bin k0 of a Hann frame reads its amplitude in dB at k0
    and 6.02 dB less at k0 +- 1."""
    n, k0, amp = 2048, 100, 0.25
    frames = 40 * 256
    mid = amp * np.cos(2 * np.pi * k0 * np.arange(frames) / n)
    x = np.stack([mid, mid], 1)
    hop = frames // 256 - 1
    out = spectrogram.expected(x, [hop], {"fft_size": n, "hop_size": 64, "use_reassignment": False})
    codes, valid = out["codes"][0], out["valid"][0]
    assert valid.all() and codes.shape == (4, n // 2 + 1)

    def code(db):
        return round((db + 144.0) * 65535.0 / 156.0)

    assert np.all(codes[:, k0] == code(20 * math.log10(amp)))
    assert np.all(np.abs(codes[:, k0 + 1] - code(20 * math.log10(amp / 2))) <= 1)


def test_first_columns_are_invalid_until_a_whole_frame_has_arrived():
    starts = spectrogram.schedule([6, 7, 8], 2048, 64)
    assert starts[0][1] == 0 and starts[1][1] == 1 and starts[2][1] == 4
    assert list(starts[2][0]) == [2304 - 2240 + 64 * k for k in range(4)]


def test_round_tf32_keeps_ten_mantissa_bits():
    x = np.array([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-12, -3.0e-3])
    r = round_tf32(x)
    assert r[0] == 1.0 + 2**-10 and r[1] == 1.0 and r[2] == 1.0 + 2**-10
    assert abs(r[3] / -3.0e-3 - 1) < 2**-11


def test_control_departs_from_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((200 * 256, 2)) * 0.05
    f64 = loudness.series(x, np.array([150, 199]))
    t32 = loudness.series(x, np.array([150, 199]), "tf32")
    assert loudness.gaps(t32, f64)["momentary_gap_lu"] > 1e-3
    assert loudness.gaps(f64, f64)["momentary_gap_lu"] == 0.0


def test_gated_gaps_take_the_nearest_knife_edge():
    """A rising level puts one short-term block 1e-7 LU above a bin edge; a
    program whose block lands 1e-7 LU below it reads a loudness range a
    bin's width off the nominal one, and within rounding of a knife-edge
    reading.  A real departure, or a NaN, still reads its full gap."""
    chunks = 300
    levels = -30.0 + 0.0137 * np.arange(chunks)
    energy = 10 ** ((levels - loudness.OFFSET) / 10)
    cs = np.concatenate([[0.0], np.cumsum(energy)])
    blocks = loudness._lufs((cs[30:] - cs[:-30]) / 30)
    j = len(blocks) // 10  # near the 10th percentile
    edge = loudness.BIN_LO + round((blocks[j] - loudness.BIN_LO) / loudness.BIN_WIDTH) * loudness.BIN_WIDTH
    levels = levels + edge + 1e-7 - blocks[j]
    below = levels.copy()
    below[j + 29] -= 30 * 2e-7  # the chunk that closes block j
    hops = np.arange(chunks * loudness.CHUNK // 256)

    def gated(lv):
        return loudness._gated(np.repeat(10 ** ((lv - loudness.OFFSET) / 10), loudness.CHUNK), hops)

    want_i, want_l = gated(levels)
    got_i, got_l = gated(below)
    want = {"lra_lu": want_l[:, 0], "lra_lu_ties": want_l,
            "integrated_lufs": want_i[:, 0], "integrated_lufs_ties": want_i}
    assert np.abs(got_l[:, 0] - want_l[:, 0]).max() > 0.05
    found = loudness.gaps({"lra_lu": got_l[:, 0], "integrated_lufs": got_i[:, 0]}, want)
    assert found["lra_gap_lu"] < 1e-6 and found["integrated_gap_lu"] < 1e-6
    assert loudness.gaps({"lra_lu": got_l[:, 0] + 0.2}, want)["lra_gap_lu"] > 0.1
    assert loudness.gaps({"lra_lu": np.full(len(hops), np.nan)}, want)["lra_gap_lu"] == math.inf


def test_references_are_found_by_analyzer_and_settings():
    from meterbench import check

    assert check.reference("loudness", {}) is loudness
    assert check.reference("spectrogram", {"use_reassignment": False}) is spectrogram
    for analyzer, cfg in (("spectrogram", {}), ("loudness", {"gating": False}), ("oscilloscope", {})):
        with pytest.raises(NotImplementedError):
            check.reference(analyzer, cfg)
