"""PyTorch port on a CUDA card: each kernel against its plain version on the
same card tensors.  Imports no JAX, so it also runs where only torch is
installed (``python -m pytest --noconftest tests/test_torch_cuda.py``).
Every test here skips where no card is present."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openmeters_tpu_torch.analyzers import oscilloscope as tosc  # noqa: E402
from openmeters_tpu_torch.ops import corr as tcorr  # noqa: E402
from openmeters_tpu_torch.ops import reassigned_columns as rcols  # noqa: E402
from openmeters_tpu_torch.ops import reassigned_hop as rhop  # noqa: E402
from openmeters_tpu_torch.ops import rows as trows  # noqa: E402
from openmeters_tpu_torch.ops import sliding_hop as thop  # noqa: E402
from openmeters_tpu_torch.ops.sliding_reassigned import SlidingReassigned  # noqa: E402
from openmeters_tpu_torch.ops.sliding_stft import SlidingSTFT  # noqa: E402
from openmeters_tpu_torch.utils.level import DB_FLOOR  # noqa: E402
from openmeters_tpu_torch.utils.parity import (  # noqa: E402
    check_corr,
    check_oscilloscope,
    check_reassigned,
    corr_errors,
    oscilloscope_errors,
    position_bar,
    reassigned_errors,
)
from openmeters_tpu_torch.utils.windows import (  # noqa: E402
    WindowKind,
    fft_bin_normalization,
    window_coefficients,
)

RESOLVED_CODES = round(60.0 * 65535 / 156)  # see tests/test_torch_sliding.py


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "fft,hop,block,window,s",
    [(2048, 64, 256, "hann", 100), (256, 32, 256, "blackman_harris", 37), (64, 16, 64, "blackman", 9),
     (256, 12, 256, "hann", 37), (2048, 64, 256, "blackman_harris", 8203)],
)
def test_sliding_hop_kernel_matches_plain(card, fft, hop, block, window, s):
    """B1a at the tensor-core tiles' edges too: hop 12 pads K to 16 and
    gives 22 columns, so the last pass of 4 holds 2; 37 and 8203 streams
    leave a part of the last 16-stream tile empty."""
    sl = SlidingSTFT(fft, hop, block, WindowKind(window))
    cols = sl.frames.cols_cap
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((s, fft + cols * hop)) * 0.3).astype(np.float32)
    spec = np.fft.rfft(x[:, :fft].astype(np.float64), axis=-1)
    deltas = np.stack(
        [x[:, fft + k * hop : fft + (k + 1) * hop] - x[:, k * hop : (k + 1) * hop] for k in range(cols)],
        axis=1,
    )
    fr, fi, deltas = (
        torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(card)
        for a in (spec.real, spec.imag, deltas)
    )
    rot_r, rot_i, dc = sl._rows(card)
    upd_r, upd_i = sl._updates(card)
    norm = torch.from_numpy(
        fft_bin_normalization(window_coefficients(WindowKind(window), fft), fft)
    ).to(card)
    coeffs = tuple(float(a) for a in sl._stencil())
    args = (fr, fi, deltas, upd_r, upd_i, rot_r, rot_i, dc, norm)
    kw = dict(n=fft, coeffs=coeffs, floor_db=DB_FLOOR)
    for ready in sorted({0, 1, cols}):
        before = thop.sliding_hop.launches
        kr, ki, kc = thop.sliding_hop(ready, *args, **kw)
        assert thop.sliding_hop.launches == before + 1
        rr, ri, rc = thop.sliding_hop_reference(ready, *args, **kw)
        torch.cuda.synchronize()
        assert kc.dtype == torch.uint16 and kc.shape == rc.shape
        scale = torch.amax(torch.hypot(rr, ri), dim=1, keepdim=True)
        err = torch.maximum((kr - rr).abs(), (ki - ri).abs()) / scale
        assert float(err.max()) <= 1e-5, ready
        ref = rc.to(torch.int32)
        held = ref >= ref.amax(dim=-1, keepdim=True) - RESOLVED_CODES
        assert int(((kc.to(torch.int32) - ref).abs() * held).max()) <= 2, ready
        if ready == 0:
            assert torch.equal(kr, fr) and torch.equal(ki, fi)


@pytest.mark.cuda
def test_sliding_hop_rejects_bad_inputs(card):
    sl = SlidingSTFT(256, 32, 256, WindowKind.HANN)
    rot_r, rot_i, dc = sl._rows(card)
    upd_r, upd_i = sl._updates(card)
    fr = torch.zeros((4, sl.bins), device=card)
    deltas = torch.zeros((4, 8, 32), device=card)
    norm = torch.ones((sl.bins,), device=card)
    kw = dict(n=256, coeffs=(0.5, -0.5), floor_db=DB_FLOOR)
    with pytest.raises(ValueError):  # a CPU tensor among CUDA ones
        thop.sliding_hop(1, fr, fr, deltas.cpu(), upd_r, upd_i, rot_r, rot_i, dc, norm, **kw)
    with pytest.raises(ValueError):  # not contiguous
        thop.sliding_hop(1, fr, fr, deltas.transpose(1, 2).contiguous().transpose(1, 2),
                         upd_r, upd_i, rot_r, rot_i, dc, norm, **kw)
    with pytest.raises(ValueError):  # a stencil wider than the kernel's halo
        thop.sliding_hop(1, fr, fr, deltas, upd_r, upd_i, rot_r, rot_i, dc, norm,
                         n=256, coeffs=(0.3, 0.2, 0.2, 0.2, 0.1), floor_db=DB_FLOOR)


def _assert_reassigned_close(ours, ref):
    """Kernel against plain, one hop apart from nothing: the bars of
    ``utils/parity.py`` without drift (0.01 hop within 60 dB)."""
    valid = torch.ones(ref[0].shape[:-1], dtype=torch.bool, device=ref[0].device)
    errors, held = reassigned_errors(ours, ref, valid, drift=False)
    assert bool(held.any())
    check_reassigned(errors)


def _analytic(rng, s, length):
    """``[2, s, length]``: two sines per stream plus faint noise, and their
    Hilbert transform plus faint noise."""
    t = np.arange(length) / 48_000.0
    f0 = rng.uniform(200.0, 16_000.0, size=(2, s, 1))
    ph = rng.uniform(0.0, 2 * np.pi, size=(2, s, 1))
    amp = np.array([0.4, 0.1])[:, None, None]
    arg = 2 * np.pi * f0 * t + ph
    x = np.stack([(amp * np.sin(arg)).sum(0), -(amp * np.cos(arg)).sum(0)])
    return x + 0.005 * rng.standard_normal(x.shape)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,hop,zpf,window,s",
    [(2048, 64, 1, "hann", 100), (512, 64, 2, "blackman_harris", 37), (512, 128, 1, "blackman", 9),
     (1024, 48, 1, "hann", 37), (2048, 128, 2, "hann", 100), (512, 64, 1, "hann", 8195)],
)
def test_reassigned_hop_kernel_matches_plain(card, n, hop, zpf, window, s):
    """B2 at the tensor-core tiles' edges too: hop 48 is K = 96 and 6
    columns (a pass of 4, then one of 2); hop 128 is 2 columns; 37, 100 and
    8195 streams leave a part of the last 8-stream tile empty."""
    sl = SlidingReassigned(n, hop, 256, WindowKind(window), 48_000.0, zpf=zpf)
    cols = sl.cols_cap
    x = _analytic(np.random.default_rng(6), s, n + cols * hop)
    ramp = np.arange(n) - (n - 1) * 0.5
    states = []
    for sig in (x[0, :, :n], x[1, :, :n], x[0, :, :n] * ramp, x[1, :, :n] * ramp):
        spec = np.fft.rfft(sig, n=sl.pfft, axis=-1)
        states += [spec.real, spec.imag]

    def deltas(sig):
        return np.stack(
            [np.concatenate([sig[:, n + k * hop : n + (k + 1) * hop], sig[:, k * hop : (k + 1) * hop]], -1)
             for k in range(cols)],
            axis=1,
        )

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(card)

    states = tuple(dev(a) for a in states)
    t = sl._tensors(card)
    args = (states, dev(deltas(x[0])), dev(deltas(x[1])), t["upd"], t["rot_r"], t["rot_i"],
            t["normq"], t["freqb"])
    kw = dict(n=n, zpf=zpf, coeffs=sl.coeffs(), inv_2pi=48_000.0 / (2.0 * np.pi),
              inv_hop=1.0 / hop, latency_hops=sl.center / hop)
    for ready in sorted({0, 1, cols}):
        before = rhop.reassigned_sliding_hop.launches
        kst, kf, kt, kp = rhop.reassigned_sliding_hop(ready, *args, **kw)
        assert rhop.reassigned_sliding_hop.launches == before + 1
        rst, rf, rt, rp = rhop.reassigned_sliding_hop_reference(ready, *args, **kw)
        torch.cuda.synchronize()
        for i in range(0, 8, 2):  # each complex state against its row maximum
            scale = torch.hypot(rst[i], rst[i + 1]).amax(1, keepdim=True)
            for j in (i, i + 1):
                assert float(((kst[j] - rst[j]).abs() / scale).max()) <= 1e-5, (ready, j)
        if ready == 0:
            assert all(torch.equal(a, b) for a, b in zip(kst, states))
        assert kf.shape == (s, cols, sl.bins)
        # the corrections against the plain version in float64: at bins 60 dB
        # down they amplify the products' rounding, and two f32 results that
        # round apart differ by about each one's own distance from the exact
        # value (chip_smoke.py phase 6)
        exact = rhop.reassigned_sliding_hop_reference(
            ready, tuple(a.double() for a in states), *(a.double() for a in args[1:]), **kw
        )[1:]
        _assert_reassigned_close((kf, kt, kp), tuple(a.float() for a in exact))


@pytest.mark.cuda
@pytest.mark.parametrize("n,window", [(512, "hann"), (2048, "blackman_harris"), (8192, "hann")])
def test_reassigned_columns_kernel_matches_plain(card, n, window):
    h, rows = 2 * n, 64
    frames = torch.from_numpy(_analytic(np.random.default_rng(n), rows, h)[0].astype(np.float32)).to(card)
    kw = dict(n=n, h=h, coeffs=WindowKind(window).cosine_coefficients, sample_rate=48_000.0, hop=n // 4)
    assert rcols.kernel_supports(n, h, len(kw["coeffs"]))
    before = rcols.reassigned_columns.launches
    out = rcols.reassigned_columns(frames, **kw)
    assert rcols.reassigned_columns.launches == before + 1
    ref = rcols.reassigned_columns_reference(frames, **kw)
    torch.cuda.synchronize()
    assert all(o.shape == (rows, n // 2 + 1) and o.dtype == torch.float32 for o in out)
    _assert_reassigned_close(out, ref)


@pytest.mark.cuda
def test_reassigned_kernels_reject_unsupported(card):
    with pytest.raises(ValueError):  # wider than one block's shared memory
        rcols.reassigned_columns(torch.zeros((2, 32768), device=card), n=16384, h=32768,
                                 coeffs=(0.5, -0.5), sample_rate=48_000.0, hop=4096)
    with pytest.raises(ValueError):  # not a power of two
        rcols.reassigned_columns(torch.zeros((2, 1000), device=card), n=500, h=1000,
                                 coeffs=(0.5, -0.5), sample_rate=48_000.0, hop=125)
    sl = SlidingReassigned(512, 64, 256, WindowKind.HANN, 48_000.0)
    t = sl._tensors(card)
    st = tuple(torch.zeros((4, sl.bins), device=card) for _ in range(8))
    d = torch.zeros((4, 4, 128), device=card)
    kw = dict(n=512, zpf=1, coeffs=(0.5, -0.5), inv_2pi=1.0, inv_hop=1.0, latency_hops=1.0)
    args = (t["upd"], t["rot_r"], t["rot_i"], t["normq"], t["freqb"])
    with pytest.raises(ValueError):  # a CPU tensor among CUDA ones
        rhop.reassigned_sliding_hop(1, st, d.cpu(), d, *args, **kw)
    with pytest.raises(ValueError):  # a stencil wider than the kernel's halo
        rhop.reassigned_sliding_hop(1, st, d, d, *args, **{**kw, "coeffs": (0.3, 0.2, 0.2, 0.2, 0.1)})


# the search's shapes at 48 kHz (buffer in shared memory) and 192 kHz (in
# global scratch): ring lanes, template cap, window cap, nfft, offsets
SEARCH_SHAPES = {48_000: (19456, 4800, 7200, 8192, 2401), 192_000: (77312, 19200, 28800, 32768, 9601)}
# the kernel design's edges, each with out_len = wcap + 1: the smallest n
# (one pass each way), an odd stage count (11 and 10 stages: passes of 4, 4,
# 3 and 4, 3, 3), the largest n in shared memory (96 kHz: twice the
# products a thread stages before the inverse), and 192 kHz (the inverse's
# input in shared memory beside the scratch row)
SEARCH_EDGES = {
    "n16": (40, 6, 12, 16, 13),
    "n2048": (4000, 1200, 1800, 2048, 1801),
    "n16384": (38912, 9600, 14400, 16384, 14401),
    "n32768": (77312, 19200, 28800, 32768, 28801),
}


def _search_inputs(card, s, lanes=19456, kcap=4800):
    """Ring, starts (clamp cases included), template, klen, wlen and shift
    as the oscilloscope hands them to the search, from a seed."""
    rng = np.random.default_rng(s)
    ring = rng.standard_normal((s, lanes)).astype(np.float32)
    starts = rng.integers(-5, lanes, s).astype(np.int32)
    starts[:4] = [0, 127, 9727, 12256]
    klen = rng.integers(2 * kcap // 5, kcap + 1, s).astype(np.int32)
    tmpl = (rng.standard_normal((s, kcap)) * (np.abs(np.arange(kcap) - kcap // 2) < klen[:, None] // 2))
    wlen = (klen + rng.integers(1, klen // 2 + 1)).astype(np.int32)
    shift = -((kcap - klen) // 2).astype(np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, a.dtype if a.dtype != np.float64 else np.float32)).to(card)
                 for a in (ring, starts, tmpl, klen, wlen, shift))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "s,rate", [(37, 48_000), (256, 48_000), (300, 192_000), *((40, edge) for edge in SEARCH_EDGES)]
)
def test_corr_search_kernels_match_plain(card, s, rate):
    lanes, kcap, wcap, nfft, out = SEARCH_SHAPES[rate] if rate in SEARCH_SHAPES else SEARCH_EDGES[rate]
    ring, starts, tmpl, klen, wlen, shift = _search_inputs(card, s, lanes, kcap)
    before = tcorr.corr_dots_sums_ring.launches
    got = tcorr.corr_dots_sums_ring(ring, starts, tmpl, klen, wlen, shift, nfft, out, wcap)
    assert tcorr.corr_dots_sums_ring.launches == before + 1
    ref = tcorr.corr_dots_sums_ring_reference(ring, starts, tmpl, klen, wlen, shift, nfft, out, wcap)
    torch.cuda.synchronize()
    check_corr(corr_errors(got, ref), "corr_dots_sums_ring")

    work = trows.window_rows_reference(ring, starts.long().clamp(0, lanes - wcap), wcap).contiguous()
    got = tcorr.corr_dots_sums(work, tmpl, klen, wlen, shift, nfft, out)
    check_corr(corr_errors(got, tcorr.corr_dots_sums_reference(work, tmpl, klen, wlen, shift, nfft, out)),
               "corr_dots_sums")
    dots = tcorr.corr_dots(work, tmpl, shift, nfft, out)
    check_corr(corr_errors(dots, tcorr.corr_dots_reference(work, tmpl, shift, nfft, out)), "corr_dots")
    assert tcorr.corr_dots.launches >= 1 and tcorr.corr_dots_sums.launches >= 1


@pytest.mark.cuda
def test_corr_search_quiet_window(card):
    """A window 60 dB below its template: the kernel balances the two
    before packing them into one transform, so the dots keep their bar."""
    ring, starts, tmpl, klen, wlen, shift = _search_inputs(card, 16)
    ring = ring * 1e-3
    got = tcorr.corr_dots_sums_ring(ring, starts, tmpl, klen, wlen, shift, 8192, 2401, 7200)
    ref = tcorr.corr_dots_sums_ring_reference(ring, starts, tmpl, klen, wlen, shift, 8192, 2401, 7200)
    check_corr(corr_errors(got, ref), "quiet window")


def _carry_to(carry, dev):
    if isinstance(carry, dict):
        return {k: _carry_to(v, dev) for k, v in carry.items()}
    if isinstance(carry, tuple):
        return tuple(_carry_to(v, dev) for v in carry)
    return carry.to(dev) if isinstance(carry, torch.Tensor) else carry


@pytest.mark.cuda
def test_oscilloscope_at_192k_card_matches_cpu(card, record_property):
    """At 192 kHz the search's 32768-point buffer is in global scratch: the
    analyzer on the card launches the kernel every hop and, one step at a
    time from the CPU's carry, matches the CPU.  Runs of many hops part: at
    this rate the correlation peak is 16 times flatter per sample, so two
    f32 paths' refined positions differ by hundredths of a sample and their
    discrete decisions flip on near-ties.  One such tie is held apart: two
    peaks one period apart that score alike (the 440 Hz stream at hop 117,
    where the plain path on the CPU and the JAX package part too).  A
    capture that lands a whole period from the CPU's, same phase, counts as
    that flip; the lock and period must still agree."""
    rate = 192_000.0
    osc = tosc.OscilloscopeAnalyzer(tosc.OscilloscopeConfig(sample_rate=rate))
    assert osc.corr_fft == 32768
    b, hops = osc.config.block_frames, 170
    t = np.arange(hops * b) / rate
    rng = np.random.default_rng(192)
    left = np.stack([0.6 * np.sin(2 * np.pi * 110.0 * t), 0.5 * np.sin(2 * np.pi * 440.0 * t)])
    audio = np.stack([left, 0.8 * left], -1) + 1e-4 * rng.standard_normal((2, hops * b, 2))
    audio = torch.from_numpy(audio.astype(np.float32))
    carry = osc.init(2, device="cpu")
    before = tcorr.corr_dots_sums_ring.launches
    keys = ("has_period", "missed", "reference", "pspec_re", "pspec_im")
    worst = {"position": 0.0, "reference": 0.0, "period": 0.0}
    locked = flips = 0
    for i in range(hops):
        blk = audio[:, i * b : (i + 1) * b]
        on_card, snap_card = osc.step(_carry_to(carry, card), blk.to(card))
        carry, snap = osc.step(carry, blk)
        err = oscilloscope_errors(snap_card, snap, *({k: c[k] for k in keys} for c in (on_card, carry)))
        gap = ((snap_card.start.cpu() - snap.start).double() + (snap_card.frac.cpu() - snap.frac).double()).abs()
        whole = torch.round(gap / snap.period.double().clamp_min(1.0))
        flip = snap.locked & (whole >= 1) & ((gap - whole * snap.period.double()).abs() <= position_bar(rate))
        if bool(flip.any()):
            flips += 1
            assert set(err["mismatch"]) <= {"start", "samples"} and err["period"] <= 1e-4, (i, err)
            continue
        check_oscilloscope(err, f"192 kHz hop {i}", sample_rate=rate)
        worst = {k: max(v, err[k]) for k, v in worst.items()}
        locked += int(snap.locked.sum())
    for k, v in worst.items():
        record_property(k, v)
    record_property("period_flips", flips)
    assert flips <= 2
    assert tcorr.corr_dots_sums_ring.launches == before + hops
    assert locked > 0


@pytest.mark.cuda
@pytest.mark.parametrize("length,windows", [(4800, 0), (4802, 0), (300, 3)])
def test_window_rows_kernel_is_exact(card, length, windows):
    rng = np.random.default_rng(length)
    s, n = 64, 19456
    x = torch.from_numpy(rng.standard_normal((s, n)).astype(np.float32)).to(card)
    shape = (s,) if windows == 0 else (s, windows)
    starts = torch.from_numpy(rng.integers(-10, n + 10, shape).astype(np.int32)).to(card)
    before = trows.window_rows.launches
    got = trows.window_rows(x, starts, length)
    assert trows.window_rows.launches == before + 1
    assert torch.equal(got, trows.window_rows_reference(x, starts, length))


@pytest.mark.cuda
def test_oscilloscope_kernels_reject_bad_inputs(card):
    ring, starts, tmpl, klen, wlen, shift = _search_inputs(card, 4)
    with pytest.raises(ValueError):  # a CPU tensor among CUDA ones
        tcorr.corr_dots_sums_ring(ring, starts.cpu(), tmpl, klen, wlen, shift, 8192, 2401, 7200)
    with pytest.raises(ValueError):  # a transform length not a power of two
        tcorr.corr_dots(ring, tmpl, shift, 12000, 2401)
    with pytest.raises(ValueError):  # not contiguous
        trows.window_rows(ring.t().contiguous().t(), starts, 100)


def _slide_inputs(card, fft, hop, window, s, cols, seed):
    """A real frame's spectrum state, ``cols`` columns of sample deltas and
    the hop's constant rows, on the card, from a seed."""
    sl = SlidingSTFT(fft, hop, 256, WindowKind(window))
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((s, fft + cols * hop)) * 0.3).astype(np.float32)
    spec = np.fft.rfft(x[:, :fft].astype(np.float64), axis=-1)
    deltas = np.stack(
        [x[:, fft + k * hop : fft + (k + 1) * hop] - x[:, k * hop : (k + 1) * hop] for k in range(cols)],
        axis=1,
    )
    fr, fi, deltas = (
        torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(card)
        for a in (spec.real, spec.imag, deltas)
    )
    norm = torch.from_numpy(fft_bin_normalization(window_coefficients(WindowKind(window), fft), fft)).to(card)
    kw = dict(n=fft, coeffs=tuple(float(a) for a in sl._stencil()), floor_db=DB_FLOOR)
    return sl, fr, fi, deltas, norm, kw


def _assert_hop_close(kr, ki, kout, rr, ri, rout, emit_codes, where):
    """Kernel against plain for one hop: the state within 1e-5 of its row's
    largest bin; codes within 2 at bins within 60 dB of the column's peak,
    or power within 1e-5 of the column's peak amplitude."""
    scale = torch.amax(torch.hypot(rr, ri), dim=1, keepdim=True)
    err = torch.maximum((kr - rr).abs(), (ki - ri).abs()) / scale
    assert float(err.max()) <= 1e-5, where
    assert kout.shape == rout.shape and kout.dtype == rout.dtype, where
    if emit_codes:
        ref = rout.to(torch.int32)
        held = ref >= ref.amax(dim=-1, keepdim=True) - RESOLVED_CODES
        assert int(((kout.to(torch.int32) - ref).abs() * held).max()) <= 2, where
    else:
        amp = (kout.sqrt() - rout.sqrt()).abs() / rout.sqrt().amax(dim=-1, keepdim=True)
        assert float(amp.max()) <= 1e-5, where


@pytest.mark.cuda
@pytest.mark.parametrize(
    "fft,hop,window,s,cols",
    [(16384, 512, "hann", 20, 1), (16384, 128, "hann", 9, 2), (4096, 2048, "blackman_harris", 17, 1),
     (64, 16, "blackman_harris", 11, 3), (2048, 1024, "hann", 8, 2), (512, 24, "blackman", 5, 4),
     (128, 4, "hann", 6, 2), (256, 8, "blackman_harris", 7, 2)],
)
def test_sliding_hop_spectra_kernel_matches_plain(card, fft, hop, window, s, cols):
    """B1b's whole-row kernel in both output modes, every ``ready``, at the
    edges of its design: 16384 points (17 bins a thread, the Nyquist bin
    alone in the last), the smallest n (4 bins of 512 threads busy), hop =
    n/2 (R = 2: the transforms r = 0 and the self-paired r = R/2 only), 4
    columns of a hop that is not a power of two (24, zero-padded to 32), and
    transforms shorter than the layout's 16-point groups (17 of 4 and of 8
    points, whose area ends inside a group)."""
    sl, fr, fi, deltas, norm, kw = _slide_inputs(card, fft, hop, window, s, cols, fft + hop)
    assert thop.block_fits(fft)
    rot_r, rot_i, dc = sl._rows(card)
    for emit_codes in (False, True):
        for ready in range(cols + 1):
            args = (ready, fr, fi, deltas, rot_r, rot_i, dc, norm)
            before = thop.sliding_hop_spectra.launches
            got = thop.sliding_hop_spectra(*args, **kw, emit_codes=emit_codes)
            assert thop.sliding_hop_spectra.launches == before + 1
            ref = thop.sliding_hop_spectra_reference(*args, **kw, emit_codes=emit_codes)
            torch.cuda.synchronize()
            _assert_hop_close(*got, *ref, emit_codes, (emit_codes, ready))
            if ready == 0:
                assert torch.equal(got[0], fr) and torch.equal(got[1], fi)


@pytest.mark.cuda
@pytest.mark.parametrize("fft,hop,window,s,cols", [(32768, 1024, "blackman_harris", 10, 2)])
def test_sliding_hop_spectra_tiled_route_matches_plain(card, fft, hop, window, s, cols):
    """Past ``BLOCK_MAX_N`` the wrapper takes the deltas' rFFT and the
    bin-tiled kernel: 16385 = 134 * 122 + 37 bins."""
    sl, fr, fi, deltas, norm, kw = _slide_inputs(card, fft, hop, window, s, cols, fft + hop)
    assert not thop.block_fits(fft)
    rot_r, rot_i, dc = sl._rows(card)
    for emit_codes in (False, True):
        for ready in range(cols + 1):
            args = (ready, fr, fi, deltas, rot_r, rot_i, dc, norm)
            got = thop.sliding_hop_spectra(*args, **kw, emit_codes=emit_codes)
            ref = thop.sliding_hop_spectra_reference(*args, **kw, emit_codes=emit_codes)
            torch.cuda.synchronize()
            _assert_hop_close(*got, *ref, emit_codes, (emit_codes, ready))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "fft,hop,window,s", [(8192, 128, "hann", 13), (64, 16, "blackman", 9), (8192, 128, "hann", 100)]
)
def test_sliding_hop_power_mode_matches_plain(card, fft, hop, window, s):
    """B1a with float32 power out (the spectrum's small sliding configs);
    at 8192/128 two columns of 4 in a pass, 4097 bins over 34 tiles."""
    sl, fr, fi, deltas, norm, kw = _slide_inputs(card, fft, hop, window, s, 2, fft)
    rot_r, rot_i, dc = sl._rows(card)
    upd_r, upd_i = sl._updates(card)
    for ready in (0, 1, 2):
        args = (ready, fr, fi, deltas, upd_r, upd_i, rot_r, rot_i, dc, norm)
        got = thop.sliding_hop(*args, **kw, emit_codes=False)
        ref = thop.sliding_hop_reference(*args, **kw, emit_codes=False)
        torch.cuda.synchronize()
        _assert_hop_close(*got, *ref, False, ready)


@pytest.mark.cuda
def test_sliding_hop_spectra_rejects_bad_inputs(card):
    sl, fr, fi, deltas, norm, kw = _slide_inputs(card, 256, 16, "hann", 4, 2, 0)
    rot_r, rot_i, dc = sl._rows(card)
    with pytest.raises(ValueError):  # delta spectra, not sample deltas
        thop.sliding_hop_spectra(1, fr, fi, torch.fft.rfft(deltas, n=256), rot_r, rot_i, dc, norm,
                                 **kw, emit_codes=False)
    with pytest.raises(ValueError):  # a CPU tensor among CUDA ones
        thop.sliding_hop_spectra(1, fr, fi, deltas.cpu(), rot_r, rot_i, dc, norm, **kw, emit_codes=False)
    with pytest.raises(ValueError):  # a hop longer than half the FFT
        wide = torch.zeros((4, 2, 129), device=card)
        thop.sliding_hop_spectra(1, fr, fi, wide, rot_r, rot_i, dc, norm, **kw, emit_codes=False)


@pytest.mark.cuda
@pytest.mark.parametrize("cascade_n,cascade_high", [(1, False), (2, True)])
def test_three_band_kernel_matches_plain(card, cascade_n, cascade_high):
    """The crossover kernel against its plain per-sample loop, with NaN and
    infinite samples: every product and sum rounds alone in both, so the
    two agree to the bit."""
    from openmeters_tpu_torch.ops import iir

    rng = np.random.default_rng(cascade_n)
    lanes = (37, 2)
    x = (rng.standard_normal((3, 256, *lanes)) * 0.3).astype(np.float32)
    x[1, 10, 1, 0], x[1, 50, 2, 1], x[1, 200, 0, 0] = np.nan, np.inf, -np.inf
    x[2, :, 5, 1] = np.nan
    state = iir.three_band_init(lanes, cascade_n, device=card)
    ref_state = state.clone()
    for blk in torch.from_numpy(x).to(card):
        before = iir.three_band_scan.launches
        got, state = iir.three_band_scan(blk, state, 48_000.0, cascade_n=cascade_n, cascade_high=cascade_high)
        assert iir.three_band_scan.launches == before + 1
        ref, ref_state = iir.three_band_scan_reference(blk, ref_state, 48_000.0, cascade_n=cascade_n,
                                                       cascade_high=cascade_high)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        assert torch.equal(got, ref), float((got - ref).abs().max())
        assert torch.equal(state, ref_state)


def _run_card_and_cpu(analyzer, audio, b, resets, compare):
    """Step ``analyzer`` over ``audio [S, n, 2]`` on the card and on the
    CPU, ``resets`` ``{hop: mask}``, calling ``compare(card carry, card
    snapshot, cpu carry, cpu snapshot, hop)`` each hop."""
    s = audio.shape[0]
    on_card, on_cpu = analyzer.init(s, device="cuda"), analyzer.init(s, device="cpu")
    for i in range(audio.shape[1] // b):
        blk = torch.from_numpy(audio[:, i * b : (i + 1) * b])
        rm = resets.get(i)
        on_card, snap_card = analyzer.step(on_card, blk.cuda(), reset_mask=None if rm is None else rm.cuda())
        on_cpu, snap_cpu = analyzer.step(on_cpu, blk, reset_mask=rm)
        compare(on_card, snap_card, on_cpu, snap_cpu, i)


def _stereo_audio(s, n, seed, bad=False):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48_000.0
    f = rng.uniform(50.0, 8000.0, (s, 1))
    left = 0.3 * np.sin(2 * np.pi * f * t) + 0.01 * rng.standard_normal((s, n))
    right = 0.5 * left + 0.1 * np.sin(2 * np.pi * 1.7 * f * t)
    audio = np.stack([left, right], -1).astype(np.float32)
    if bad:
        audio[0, 3000, 0], audio[1, 7000, 1], audio[0, 9001, :] = np.nan, np.inf, -np.inf
    return audio


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kw,hops",
    [(dict(fft_size=16384, hop_size=512, block_frames=512, averaging="exponential"), 60),
     (dict(fft_size=16384, hop_size=128, source="left", secondary_source="right", averaging="peak_hold"), 90),
     (dict(fft_size=8192, hop_size=128), 70)],
    ids=["b1b_16384_512", "b1b_16384_128_dual", "b1a_8192_128"],
)
def test_spectrum_card_matches_cpu(card, kw, hops):
    """The spectrum on the card (B1b or B1a's power mode every hop) against
    the CPU, with a reset, by the bars of ``utils/parity.py``."""
    from openmeters_tpu_torch.analyzers import spectrum as tsp
    from openmeters_tpu_torch.utils.channels import Channel
    from openmeters_tpu_torch.utils.parity import check_spectrum, spectrum_errors

    kw = {k: (tsp.AveragingMode(v) if k == "averaging" else Channel(v) if "source" in k else v)
          for k, v in kw.items()}
    an = tsp.SpectrumAnalyzer(tsp.SpectrumConfig(**kw))
    counter = thop.sliding_hop if an._sliding.whole_row else thop.sliding_hop_spectra
    before = counter.launches
    b = an.config.block_frames
    flips = []

    def compare(cc, sc, cp, sp, i):
        err = spectrum_errors(cc["smoothed"], cp["smoothed"], sc, sp, an.state_floor)
        check_spectrum(err, f"hop {i}")
        flips.append(err["floor_flips"])

    _run_card_and_cpu(an, _stereo_audio(3, hops * b, seed=hops), b, {hops // 2: torch.tensor([False, True, False])},
                      compare)
    assert counter.launches == before + hops and sum(flips) <= 2


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["stereometer_bands", "waveform"])
def test_stereometer_waveform_card_matches_cpu(card, which):
    """The stereometer with its LR4 bands and the waveform on the card (the
    crossover kernel every hop) against the CPU, with a reset and
    non-finite samples, by the bars of ``utils/parity.py``."""
    from openmeters_tpu_torch.analyzers import stereometer as tst
    from openmeters_tpu_torch.analyzers import waveform as tw
    from openmeters_tpu_torch.ops import iir
    from openmeters_tpu_torch.utils.parity import check_snapshot, snapshot_errors

    an = (tst.StereometerAnalyzer(tst.StereometerConfig(analyze_bands=True)) if which != "waveform"
          else tw.WaveformAnalyzer(tw.WaveformConfig(track_history=True)))
    before = iir.three_band_scan.launches
    hops = 60

    def compare(cc, sc, cp, sp, i):
        check_snapshot(snapshot_errors(sc, sp), f"hop {i}")

    _run_card_and_cpu(an, _stereo_audio(3, hops * 256, seed=17, bad=True), 256,
                      {30: torch.tensor([False, True, False])}, compare)
    assert iir.three_band_scan.launches == before + hops


@pytest.mark.cuda
def test_meter_server_card_matches_cpu(card):
    """``MeterServer`` on the card against one on the CPU, S=4, 30 advances
    of the same pushed PCM (a generation reset on stream 1 at advance 12):
    every advance's fetched meters and the display-rate spectrum, by the
    bars of ``utils/parity.py``."""
    from openmeters_tpu_torch.analyzers.spectrogram import SpectrogramConfig
    from openmeters_tpu_torch.analyzers.spectrum import SpectrumConfig
    from openmeters_tpu_torch.engine import EngineConfig
    from openmeters_tpu_torch.serve import MeterServer, ServeConfig
    from openmeters_tpu_torch.utils.parity import check_meters, check_spectrum, spectrum_errors

    engine = EngineConfig(
        channels=2, spectrogram=SpectrogramConfig(fft_size=256, hop_size=64, use_reassignment=False),
        spectrum=SpectrumConfig(fft_size=1024, hop_size=1024), oscilloscope=None, stereometer=None,
        waveform=None,
    )
    cfg = ServeConfig(n_streams=4, engine=engine, realtime=False, fetch="full", fetch_every=1,
                      coalesce_blocks=1)
    servers = [MeterServer(cfg, device=card), MeterServer(cfg, device="cpu")]
    audio = _stereo_audio(4, 30 * 256, seed=19)
    try:
        for i in range(30):
            for srv in servers:
                if i == 12:
                    srv.transport.set_generation(1, 2)
                for st in range(4):
                    srv.transport.push_pcm(st, audio[st, i * 256 : (i + 1) * 256], int(i * 256 / 48e3 * 1e9))
                srv.advance()
            on_card, on_cpu = (srv.last_meters() for srv in servers)
            check_meters(on_card, on_cpu, f"advance {i}")
        check_spectrum(spectrum_errors(None, None, *(srv.fetch_spectrum() for srv in servers)), "spectrum")
        assert servers[0].stats.resets == servers[1].stats.resets == 5
    finally:
        for srv in servers:
            srv.close()
