"""The classic spectrogram's columns against float64 across level drops.

The flagship's classic 2048/64 spectrogram computes each column from its
own frame (``ops/classic_columns.py``; on the CPU its plain version).  A
sliding DFT keeps an f32 state and windows it in the frequency domain, so
after a drop of 60 dB or more it carries the loud section's rounding into
the quiet columns until its next re-anchor, a batch-wide one every 32 hops:
dozens to thousands of codes off within 60 dB of the column's peak.  Here
every column of every hop is held within 2 codes of a float64 rFFT at the
bins within 60 dB of its peak, with the drop placed 1 to 31 hops after
such a re-anchor; each stream's columns do not depend on its neighbours;
and a carry that still holds the sliding state (a checkpoint written
before, or the JAX package's carry) restores and steps within the same bar,
the JAX package's own columns held to the port by ROADMAP's 1.5x rule.
Also the kernel's real-FFT split, emulated in float64 against
``numpy.fft.rfft``.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from openmeters_tpu_torch.analyzers.spectrogram import SpectrogramAnalyzer, SpectrogramConfig

N, HOP, B = 2048, 64, 256
REFRESH = 32  # the batch-wide re-anchor period of the sliding DFT
CODES = 2
RESOLVED = round(60.0 * 65535 / 156)  # codes within 60 dB of a column's peak
CLASSIC = SpectrogramConfig(fft_size=N, hop_size=HOP, use_reassignment=False)


def programme(rng, frames: int, rms: float) -> np.ndarray:
    """Three tones (40 Hz-8 kHz) and white noise at ``rms``."""
    t = np.arange(frames) / 48_000.0
    x = 0.5 * rng.standard_normal(frames)
    for _ in range(3):
        f = math.exp(rng.uniform(math.log(40.0), math.log(8000.0)))
        x += rng.uniform(0.3, 1.0) * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
    return x * (rms / np.sqrt(np.mean(x * x))) if frames else x


def stepped(seed: int, hops: int, at: int, step_db: float, rms: float = 1.0) -> np.ndarray:
    """``hops`` blocks of programme audio at ``rms``, its level stepped by
    ``step_db`` at sample ``at``, then new programme, as float32 values."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([programme(rng, at, rms), programme(rng, hops * B - at, rms * 10 ** (step_db / 20))])
    return x.astype(np.float32).astype(np.float64)


def starts(hops: int):
    """Each hop's column frame starts, counted from the stream's first
    sample, and its ready count: the framing's schedule."""
    cols = (B - 1) // HOP + 1
    cap = -(-(N + B + HOP) // B) * B
    avail = 0
    for h in range(hops):
        avail_p = min(avail + B, cap)
        ready = min(max((avail_p - N) // HOP + 1 if avail_p >= N else 0, 0), cols)
        yield [(h + 1) * B - avail_p + min(k, max(ready - 1, 0)) * HOP for k in range(cols)], ready
        avail = avail_p - ready * HOP


def exact_codes(x: np.ndarray, hops: int):
    """``[hops, cols, bins]`` codes and ``[hops, cols]`` valid flags of the
    mono stream ``x`` in float64."""
    w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(N) / N)
    norm = np.full(N // 2 + 1, 4.0 / w.sum() ** 2)
    norm[0] = norm[-1] = 1.0 / w.sum() ** 2
    padded = np.concatenate([np.zeros(N), x])
    codes, valid = [], []
    for st, ready in starts(hops):
        frames = np.stack([padded[s + N:s + 2 * N] for s in st])
        spec = np.fft.rfft((frames - frames.mean(-1, keepdims=True)) * w, axis=-1)
        power = (spec.real ** 2 + spec.imag ** 2) * norm
        db = np.maximum(10 * np.log10(np.maximum(power, 1e-300)), -140.0)
        codes.append(np.clip(np.round((db + 144.0) * 65535 / 156), 0, 65535))
        valid.append([k < ready and s >= 0 for k, s in enumerate(st)])
    return np.stack(codes), np.array(valid)


def port_codes(x: np.ndarray, hops: int, analyzer=None, carry=None, first: int = 0):
    """The port's codes and valid flags of ``x [S, frames]`` (CPU), hops
    ``first`` to ``hops``, from ``carry``."""
    an = analyzer or SpectrogramAnalyzer(CLASSIC)
    carry = carry if carry is not None else an.init(x.shape[0], device="cpu")
    xt = torch.from_numpy(x.astype(np.float32))
    codes, valid = [], []
    for h in range(first, hops):
        carry, out = an.step(carry, xt[:, h * B:(h + 1) * B])
        codes.append(out.codes.numpy().astype(np.float64))
        valid.append(out.valid.numpy())
    return np.stack(codes, 1), np.stack(valid, 1), carry


def worst_gap(got, want, valid) -> float:
    """The largest code gap at valid bins within 60 dB of their column's
    peak (float64 codes)."""
    near = valid[..., None] & (want >= want.max(-1, keepdims=True) - RESOLVED)
    return float(np.where(near, np.abs(got - want), 0.0).max())


@pytest.mark.parametrize("step_db", [-60.0, -80.0, -20.0, -6.0, 20.0], ids=lambda d: f"{d:+g}dB")
@pytest.mark.parametrize("after", [1, 7, 13, 19, 25, 31])
def test_columns_hold_float64_at_every_hop_across_a_step(after, step_db):
    """0 dBFS programme audio stepped by ``step_db`` a few samples into the
    hop ``after`` hops past a re-anchor of the sliding DFT (hop 64): every
    valid column of every hop, through the whole window's exit and past the
    next re-anchor, within 2 codes of float64."""
    hops = 2 * REFRESH + after + 48
    at = (2 * REFRESH + after) * B + 37
    x = stepped(1000 * after + int(abs(step_db)), hops, at, step_db)
    got, valid, _ = port_codes(x[None], hops)
    want, want_valid = exact_codes(x, hops)
    assert np.array_equal(valid[0], want_valid)
    per_hop = [worst_gap(got[0, h], want[h], want_valid[h]) for h in range(hops)]
    assert max(per_hop) <= CODES, {h: g for h, g in enumerate(per_hop) if g > CODES}


def test_each_stream_stands_alone():
    """A batch where one stream drops 80 dB and its neighbours hold their
    level: each stream's columns are bit for bit those of that stream
    stepped alone, and the classic carry holds no sliding state."""
    hops = 120
    x = np.stack([stepped(7, hops, hops * B, 0.0), stepped(8, hops, 70 * B + 5, -80.0),
                  stepped(9, hops, hops * B, 0.0, rms=0.1), stepped(10, hops, 40 * B, 12.0, rms=0.05)])
    got, valid, carry = port_codes(x, hops)
    assert set(carry) == {"fb"}
    for i in range(len(x)):
        alone, alone_valid, _ = port_codes(x[i:i + 1], hops)
        assert np.array_equal(got[i], alone[0]) and np.array_equal(valid[i], alone_valid[0]), i
    want, want_valid = exact_codes(x[1], hops)
    assert max(worst_gap(got[1, h], want[h], want_valid[h]) for h in range(hops)) <= CODES


def _with_sliding_state(carry: dict, s: int) -> dict:
    """``carry`` as a version that slid the classic columns stored it: the
    spectrogram's ``sdft`` subtree beside its ring."""
    sdft = {"re": torch.randn((s, N // 2 + 1)), "im": torch.randn((s, N // 2 + 1)), "count": 77, "anchored": True}
    return {**carry, "spectrogram": {**carry["spectrogram"], "sdft": sdft}}


def test_a_checkpoint_with_the_sliding_state_restores(tmp_path):
    """A checkpoint whose carry holds the classic spectrogram's sliding
    state, as one written before this change, restores (the state
    dropped) and steps on as the uninterrupted carry does: the same
    snapshots, within 2 codes of float64 across an 80 dB drop."""
    from openmeters_tpu_torch import checkpoint
    from openmeters_tpu_torch.engine import EngineConfig, MeterEngine, StreamMeta

    engine = MeterEngine(EngineConfig(channels=2, spectrogram=CLASSIC, spectrum=None, oscilloscope=None,
                                      stereometer=None, waveform=None))
    s, hops, cut = 2, 110, 60
    mono = np.stack([stepped(21, hops, 66 * B + 3, -80.0), stepped(22, hops, hops * B, 0.0, rms=0.2)])
    blocks = torch.from_numpy(np.repeat(mono[..., None], 2, axis=-1).astype(np.float32))
    meta = StreamMeta.default(s, channels=2, pad_channels=2)
    carry = engine.init(s, device="cpu")
    for h in range(cut):
        carry, _ = engine.step(carry, blocks[:, h * B:(h + 1) * B], meta)
    path = str(tmp_path / "before.npz")
    checkpoint.save_state(path, engine, _with_sliding_state(carry, s))
    restored = checkpoint.load_state(path, engine, device="cpu")
    assert set(restored["spectrogram"]) == {"fb"}
    want, want_valid = exact_codes(mono[0], hops)
    for h in range(cut, hops):
        blk = blocks[:, h * B:(h + 1) * B]
        carry, a = engine.step(carry, blk, meta)
        restored, b = engine.step(restored, blk, meta)
        assert torch.equal(a["spectrogram"].codes, b["spectrogram"].codes), h
        assert worst_gap(b["spectrogram"].codes[0].numpy().astype(np.float64), want[h], want_valid[h]) <= CODES, h


def test_a_jax_carry_restores_and_holds_the_bar_beside_the_jax_package():
    """The JAX package steps 60 hops of audio that drops 80 dB at hop 66;
    its carry (with its classic sliding state) comes into the port through
    ``convert.carry_from_jax`` and both step on 50 hops.  The port holds 2
    codes of float64 at every hop; the JAX package's sliding columns part
    from float64 there, and the port stays within ROADMAP's 1.5x rule of
    them."""
    import jax
    import jax.numpy as jnp
    from openmeters_tpu.analyzers.spectrogram import SpectrogramAnalyzer as JAnalyzer
    from openmeters_tpu.analyzers.spectrogram import SpectrogramConfig as JConfig

    from openmeters_tpu_torch import convert
    from openmeters_tpu_torch.engine import EngineConfig, MeterEngine

    hops, cut, s = 110, 60, 3
    mono = np.stack([stepped(31 + i, hops, 66 * B + 11 * i, -80.0) for i in range(s)])
    ja = JAnalyzer(JConfig(fft_size=N, hop_size=HOP, use_reassignment=False))
    jstep = jax.jit(ja.step)
    jc = ja.init(s)
    xj = mono.astype(np.float32)
    for h in range(cut):
        jc, _ = jstep(jc, jnp.asarray(xj[:, h * B:(h + 1) * B]))
    assert "sdft" in jc
    engine = MeterEngine(EngineConfig(channels=2, spectrogram=CLASSIC, spectrum=None, oscilloscope=None,
                                      stereometer=None, waveform=None, loudness=None))
    carry = convert.carry_from_jax({"spectrogram": jax.device_get(jc)}, engine, device="cpu")["spectrogram"]
    assert set(carry) == {"fb"}
    got, valid, _ = port_codes(mono, hops, carry=carry, first=cut)
    jgot = []
    for h in range(cut, hops):
        jc, jo = jstep(jc, jnp.asarray(xj[:, h * B:(h + 1) * B]))
        jgot.append(np.asarray(jo.codes, np.float64))
    jgot = np.stack(jgot, 1)
    port_worst = jax_worst = 0.0
    for i in range(s):
        want, want_valid = exact_codes(mono[i], hops)
        assert np.array_equal(valid[i], want_valid[cut:])
        for j, h in enumerate(range(cut, hops)):
            port_worst = max(port_worst, worst_gap(got[i, j], want[h], want_valid[h]))
            jax_worst = max(jax_worst, worst_gap(jgot[i, j], want[h], want_valid[h]))
    assert port_worst <= CODES, port_worst
    assert jax_worst > CODES, jax_worst  # the sliding state's carried rounding
    assert port_worst <= max(CODES, 1.5 * jax_worst)


@pytest.mark.parametrize("n", [64, 2048, 32768])
def test_the_kernels_real_split_is_the_rfft(n):
    """The kernel's arithmetic in float64: the frame as ``n/2`` complex
    points ``x[2m] + i x[2m+1]``, their FFT, and the split
    ``X[k] = E + W^k O``, ``X[n/2-k] = conj(E - W^k O)`` with ``X[0]`` and
    ``X[n/2]`` from ``Z[0]``, equal ``numpy.fft.rfft``."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n)
    z = np.fft.fft(x[0::2] + 1j * x[1::2])
    h = n // 2
    k = np.arange(1, h // 2 + 1)
    zk, zc = z[k], z[h - k]
    e = 0.5 * (zk + np.conj(zc))
    o = (zk - np.conj(zc)) / 2j
    wo = np.exp(-2j * np.pi * k / n) * o
    out = np.zeros(h + 1, complex)
    out[0], out[h] = z[0].real + z[0].imag, z[0].real - z[0].imag
    out[k], out[h - k] = e + wo, np.conj(e - wo)
    np.testing.assert_allclose(out, np.fft.rfft(x), rtol=0, atol=1e-9 * np.sqrt(n))
