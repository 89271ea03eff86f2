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


@pytest.mark.cuda
@pytest.mark.parametrize(
    "fft,hop,window,s",
    [(2048, 64, "hann", 300), (64, 16, "blackman_harris", 9), (256, 512, "hann", 5), (1024, 48, "blackman", 37),
     (32768, 1024, "hann", 3)],
)
def test_classic_columns_kernel_matches_plain(card, fft, hop, window, s):
    """The classic columns from the ring against the plain version on the
    frames ``extract`` takes (f32 and float64), for every ``ready`` and a
    base near the ring's end: noise 80 dB down with a loud stretch, so some
    windows hold its edge.  Codes within 2 at bins within 60 dB of the
    column's peak, against both."""
    from openmeters_tpu_torch.ops import classic_columns as cc
    from openmeters_tpu_torch.ops.framing import FrameBuffer

    fb = FrameBuffer(fft, hop, 256)
    gen = torch.Generator(device=card).manual_seed(fft + hop)
    buf = torch.randn((s, fb.ring_len), generator=gen, device=card) * 1e-4
    buf[:, fb.cap - fft // 3:fb.cap] = torch.randn((s, fft // 3), generator=gen, device=card)
    kind = WindowKind(window)
    w = torch.from_numpy(window_coefficients(kind, fft)).to(card)
    norm = torch.from_numpy(fft_bin_normalization(window_coefficients(kind, fft), fft)).to(card)
    for base in (0, fb.cap - fft // 2, fb.cap - 1):
        for ready in sorted({0, 1, fb.cols_cap}):
            info = {"buf": buf, "base": base, "ready": ready}
            before = cc.classic_columns.launches
            got = cc.classic_columns(fb, info, w, norm, floor_db=DB_FLOOR)
            assert cc.classic_columns.launches == before + 1
            assert got.shape == (s, fb.cols_cap, fft // 2 + 1) and got.dtype == torch.uint16
            frames = fb.extract(info)
            for ref in (cc.classic_columns_reference(frames, w, norm, floor_db=DB_FLOOR),
                        cc.classic_columns_reference(frames.double(), w.double(), norm.double(), floor_db=DB_FLOOR)):
                ref = ref.to(torch.int64)
                held = ref >= ref.amax(-1, keepdim=True) - RESOLVED_CODES
                d = (got.to(torch.int64) - ref).abs()
                assert int((d * held).max()) <= 2, (base, ready, int((d * held).max()))


@pytest.mark.cuda
def test_classic_columns_rejects_bad_inputs(card):
    from openmeters_tpu_torch.ops import classic_columns as cc
    from openmeters_tpu_torch.ops.framing import FrameBuffer

    fb = FrameBuffer(256, 64, 256)
    buf = torch.zeros((4, fb.ring_len), device=card)
    w, norm = torch.ones((256,), device=card), torch.ones((129,), device=card)
    info = {"buf": buf, "base": 0, "ready": 4}
    with pytest.raises(ValueError):  # a CPU tensor among CUDA ones
        cc.classic_columns(fb, info, w.cpu(), norm, floor_db=DB_FLOOR)
    with pytest.raises(ValueError):  # a ring of another length
        cc.classic_columns(fb, {**info, "buf": buf[:, 1:].contiguous()}, w, norm, floor_db=DB_FLOOR)
    with pytest.raises(ValueError):  # not a power of two
        cc.classic_columns(FrameBuffer(250, 50, 256), info, w, norm, floor_db=DB_FLOOR)


@pytest.mark.cuda
def test_classic_spectrogram_card_matches_cpu_across_a_drop(card):
    """The flagship's classic 2048/64 spectrogram on the card against the
    CPU (S=6, 120 hops of programme-like audio, four streams dropping 60 to
    80 dB at different hops, a reset at hop 90): valid flags equal, codes
    within 2 at bins within 60 dB of the peak."""
    from openmeters_tpu_torch.analyzers.spectrogram import SpectrogramAnalyzer, SpectrogramConfig

    an = SpectrogramAnalyzer(SpectrogramConfig(fft_size=2048, hop_size=64, use_reassignment=False))
    s, hops = 6, 120
    rng = np.random.default_rng(19)
    t = np.arange(hops * 256) / 48_000.0
    x = np.sin(2 * np.pi * rng.uniform(60, 6000, (s, 1)) * t) + 0.3 * rng.standard_normal((s, hops * 256))
    for i, (h, db) in enumerate(((40, -60.0), (55, -80.0), (71, -70.0), (100, -80.0))):
        x[i, h * 256 + 17 * i:] *= 10 ** (db / 20)
    x = torch.from_numpy(x.astype(np.float32))
    carries = {d: an.init(s, device=d) for d in (card, "cpu")}
    for h in range(hops):
        reset = torch.tensor([False, False, False, False, True, False]) if h == 90 else None
        outs = {}
        for d in carries:
            carries[d], outs[d] = an.step(carries[d], x[:, h * 256:(h + 1) * 256].to(d),
                                          None if reset is None else reset.to(d))
        valid = outs["cpu"].valid
        assert torch.equal(outs[card].valid.cpu(), valid), h
        ref = outs["cpu"].codes.to(torch.int64)
        held = valid[..., None] & (ref >= ref.amax(-1, keepdim=True) - RESOLVED_CODES)
        d = (outs[card].codes.cpu().to(torch.int64) - ref).abs()
        assert int((d * held).max()) <= 2, (h, int((d * held).max()))


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
@pytest.mark.parametrize("lanes", [(37, 2), (1, 1), (16, 2), (33, 2)])
@pytest.mark.parametrize("t", [235, 256, 1024])
@pytest.mark.parametrize("cascade_n,cascade_high", [(1, False), (2, True)])
def test_three_band_kernel_matches_plain(card, cascade_n, cascade_high, t, lanes):
    """The crossover kernel against its plain per-sample loop over three
    blocks, the state carried, with NaN and infinite samples on both sides
    of the 16-sample chunk boundaries and in the last lane: every product
    and sum rounds alone in both, so the two agree to the bit.  74, 1 and
    66 lanes leave a part of the last 32-lane tile empty and rows that are
    not 16-byte aligned; 235 samples end on a short chunk."""
    from openmeters_tpu_torch.ops import iir

    rng = np.random.default_rng(cascade_n)
    n = int(np.prod(lanes))
    x = (rng.standard_normal((3, t, n)) * 0.3).astype(np.float32)
    x[1, 15, n - 1], x[1, 16, 0], x[1, 32, n // 2] = np.nan, np.inf, -np.inf
    x[1, t - 1, n - 1], x[1, 128, 0] = -np.inf, np.nan
    x[2, :, n - 1] = np.nan
    state = iir.three_band_init(lanes, cascade_n, device=card)
    ref_state = state.clone()
    for blk in torch.from_numpy(x.reshape(3, t, *lanes)).to(card):
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


@pytest.mark.cuda
def test_cli_selftest_on_the_card(card, capsys):
    from openmeters_tpu_torch.__main__ import main

    assert main(["selftest"]) == 0
    assert "(OK)" in capsys.readouterr().out


@pytest.mark.cuda
def test_cli_analyze_card_matches_cpu(card, tmp_path, capsys):
    """``analyze`` of a stereo WAV under ``EngineConfig()`` with the
    spectrum at hop 512 (a settings file), on the card and with ``--device
    cpu``: every field within its bar (``check_analyze``)."""
    import dataclasses
    import json

    from openmeters_tpu_torch.__main__ import main
    from openmeters_tpu_torch.analyzers.spectrum import SpectrumConfig
    from openmeters_tpu_torch.engine import EngineConfig
    from openmeters_tpu_torch.io.wav import write_wav
    from openmeters_tpu_torch.persistence import encode_settings, write_json_atomic
    from openmeters_tpu_torch.utils.parity import check_analyze

    rng = np.random.default_rng(8)
    t = np.arange(48_000) / 48_000.0
    left = 0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.1 * np.sin(2 * np.pi * 1700.0 * t)
    left += 0.01 * rng.standard_normal(t.shape)
    wav, settings = str(tmp_path / "in.wav"), str(tmp_path / "settings.json")
    write_wav(wav, np.stack([left, 0.6 * left], -1).astype(np.float32), 48_000.0)
    write_json_atomic(settings, encode_settings(dataclasses.replace(EngineConfig(),
                                                                    spectrum=SpectrumConfig(hop_size=512))))
    outs = []
    for device in ("cuda", "cpu"):
        assert main(["analyze", wav, "--settings", settings, "--compact", "--device", device]) == 0
        outs.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    check_analyze(*outs, "card against cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("reassigned", [False, True], ids=["classic", "reassigned"])
def test_render_series_cuda_snapshots_equal_their_cpu_copies(card, tmp_path, reassigned):
    """``render_series`` of a series on the card (stream 1 of 2) writes the
    same bytes as of the series' ``.cpu()`` copies: ``host_series`` moves
    what is read in one copy, and the rasterizers see the same numpy."""
    from openmeters_tpu_torch.analyzers.spectrogram import SpectrogramConfig
    from openmeters_tpu_torch.api import analyze
    from openmeters_tpu_torch.engine import EngineConfig
    from openmeters_tpu_torch.render import render_series

    cfg = EngineConfig(spectrogram=SpectrogramConfig(fft_size=1024, hop_size=256, use_reassignment=reassigned))
    series = analyze(_stereo_audio(2, 24_000, seed=23), 48_000.0, cfg, device=card)
    copies = [{k: type(v)(*(x.cpu() for x in v)) for k, v in hop.items()} for hop in series]
    out = {}
    for name, s in (("card", series), ("cpu", copies)):
        paths = render_series(s, cfg, tmp_path / name, stream=1, width=160, height=90)
        out[name] = {p.rsplit("/", 1)[-1]: open(p, "rb").read() for p in paths}
    assert len(out["card"]) == 6 and out["card"] == out["cpu"]


@pytest.mark.cuda
def test_tui_keys_drive_a_card_server(card):
    """``attach_key_controls`` on a ``MeterServer`` on the card: ``2``
    toggles the spectrogram off and on (each engine warmed on the card and
    adopted at a hop boundary, the stash restoring its settings), ``p``
    pauses and resumes, and the TUI paints the served meters."""
    import contextlib
    import io
    import os
    import time

    from openmeters_tpu_torch.analyzers.spectrogram import SpectrogramConfig
    from openmeters_tpu_torch.engine import EngineConfig
    from openmeters_tpu_torch.serve import MeterServer, ServeConfig
    from openmeters_tpu_torch.tui import attach_key_controls, serve_tui_callback

    engine = EngineConfig(channels=2, spectrogram=SpectrogramConfig(fft_size=512, hop_size=128,
                                                                    use_reassignment=False),
                          spectrum=None, oscilloscope=None, stereometer=None, waveform=None)
    server = MeterServer(ServeConfig(n_streams=4, channels=2, engine=engine, realtime=False, fetch="meters",
                                     fetch_every=1), device=card)
    server.on_drain = serve_tui_callback(stream=2, min_interval=0.0)
    r, w = os.pipe()
    rf = os.fdopen(r, "rb", buffering=0)
    audio = _stereo_audio(4, 800 * 256, seed=29)
    i = [0]
    paint = io.StringIO()

    def hops_until(pred, bound=600):
        for _ in range(bound):
            for st in range(4):
                server.transport.push_pcm(st, audio[st, i[0] * 256 : (i[0] + 1) * 256], int(i[0] * 256 / 48e3 * 1e9))
            i[0] += 1
            with contextlib.redirect_stderr(paint):
                server.on_tick(server)
                server.advance()
            if pred():
                return True
            if server.reconfig_pending:
                time.sleep(0.02)
        return False

    try:
        attach_key_controls(server, source=rf, view=server.on_drain.view)
        os.write(w, b"2")
        assert hops_until(lambda: not server.reconfig_pending and "spectrogram" not in server.engine.analyzers)
        os.write(w, b"2")
        assert hops_until(lambda: not server.reconfig_pending and "spectrogram" in server.engine.analyzers)
        assert server.engine.config.spectrogram.fft_size == 512
        leaves = torch.utils._pytree.tree_leaves(server.carry["spectrogram"])
        assert {t.device.type for t in leaves if isinstance(t, torch.Tensor)} == {"cuda"}
        os.write(w, b"p")
        assert hops_until(lambda: server.paused, bound=3)
        hops = server.stats.hops
        hops_until(lambda: False, bound=5)
        assert server.stats.hops == hops
        os.write(w, b"p")
        assert hops_until(lambda: not server.paused and server.stats.hops > hops, bound=5)
    finally:
        rf.close()
        os.close(w)
        server.close()
    assert "stream #2" in paint.getvalue() and "LUFS" in paint.getvalue()


# -- the loudness step's CUDA graphs ------------------------------------------------


def _loudness_only(**kw):
    from openmeters_tpu_torch.engine import EngineConfig

    return EngineConfig(channels=2, spectrogram=None, spectrum=None, oscilloscope=None, stereometer=None,
                        waveform=None, **kw)


def _loudness_leaves(carry, snap):
    leaves = torch.utils._pytree.tree_flatten_with_path(carry)[0]
    return [(torch.utils._pytree.keystr(p), v) for p, v in leaves] + list(snap._asdict().items())


def _assert_same_loudness(ours, ref, where):
    for (name, a), (_, b) in zip(_loudness_leaves(*ours), _loudness_leaves(*ref), strict=True):
        if isinstance(a, torch.Tensor):
            gap = float((a.double() - b.double()).abs().max())
            assert a.device == b.device and torch.equal(a, b), (where, name, gap)
        else:
            assert a == b, (where, name)


def _graphs_against_eager(card, hops, resets, s=37, between=None):
    """``hops`` engine hops on the card (the loudness step replayed from its
    graphs) against the analyzer's eager step on the card, leaf for leaf,
    bit for bit, every hop; ``between(i, carry)`` may replace the engine's
    carry before hop ``i``."""
    from openmeters_tpu_torch.engine import MeterEngine, StreamMeta

    engine = MeterEngine(_loudness_only())
    analyzer = engine.analyzers["loudness"]
    meta = StreamMeta(*(t.to(card) for t in StreamMeta.default(s, channels=2, pad_channels=2)))
    audio = torch.from_numpy(_stereo_audio(s, hops * 256, seed=41)).to(card)
    carry, ref = engine.init(s, device=card), analyzer.init(s, device=card)
    for i in range(hops):
        if between is not None:
            carry = between(i, engine, carry)
        blk = audio[:, i * 256 : (i + 1) * 256].contiguous()
        rm = resets.get(i)
        carry, snaps = engine.step(carry, blk, meta, None if rm is None else rm.to(card))
        ref, ref_snap = analyzer.step(ref, blk, meta.weights, None if rm is None else rm.to(card))
        _assert_same_loudness((carry["loudness"], snaps["loudness"]), (ref, ref_snap), f"hop {i}")
    return engine.loudness_graphs.counts


@pytest.mark.cuda
def test_loudness_graphs_replay_matches_eager(card):
    """300 hops at S=37, reset masks at hops 40, 41 and 200: every hop a
    replay, the same bits as the eager step (the same kernels), every
    pattern recorded once."""
    resets = {40: torch.arange(37) % 3 == 0, 41: torch.arange(37) == 5, 200: torch.arange(37) >= 30}
    counts = _graphs_against_eager(card, 300, resets)
    assert counts == {"replays": 300, "eager": 0, "captures": 8, "rebinds": 1}


@pytest.mark.cuda
def test_loudness_graphs_rebind_after_a_restore(card, tmp_path):
    """A checkpoint written and restored at hop 150 of 250: the restored
    carry is copied into the graphs' static carry (a rebind), and the run
    goes on bit for bit with the uninterrupted eager one."""
    from openmeters_tpu_torch.checkpoint import load_state, save_state

    path = str(tmp_path / "carry.npz")

    def restore(i, engine, carry):
        if i != 150:
            return carry
        save_state(path, engine, carry)
        return load_state(path, engine, device=card)

    counts = _graphs_against_eager(card, 250, {100: torch.arange(37) == 2}, between=restore)
    assert counts == {"replays": 250, "eager": 0, "captures": 8, "rebinds": 2}


@pytest.mark.cuda
def test_loudness_graphs_snapshot_outlives_the_next_hop(card):
    """A snapshot held across the next replays keeps its values (each
    replay hands out a copy of the packed meters), over a chunk crossing,
    where the integrated loudness the carry holds moves."""
    from openmeters_tpu_torch.engine import MeterEngine, StreamMeta

    s = 6
    engine = MeterEngine(_loudness_only())
    meta = StreamMeta(*(t.to(card) for t in StreamMeta.default(s, channels=2, pad_channels=2)))
    audio = torch.from_numpy(_stereo_audio(s, 120 * 256, seed=43)).to(card)
    carry = engine.init(s, device=card)
    held = []
    for i in range(120):
        carry, snaps = engine.step(carry, audio[:, i * 256 : (i + 1) * 256].contiguous(), meta)
        held.append((snaps["loudness"], [t.clone() for t in snaps["loudness"]]))
    for i, (snap, copy) in enumerate(held):
        for a, b in zip(snap, copy, strict=True):
            assert torch.equal(a, b), i
    integrated = {tuple(copy[5].tolist()) for _, copy in held}
    assert len(integrated) > 2  # the integrated loudness moved during the run


@pytest.mark.cuda
def test_loudness_graphs_follow_settings_and_layout(card):
    """A card server (its loudness replayed) against a CPU one, S=8, every
    advance's meters by the bars of ``utils/parity.py``: a floor change by
    ``apply_settings`` at advance 40 (the migrated carry rebinds the new
    engine's graphs), a ``set_stream_layout`` at 60 (the weights that reach
    the graphs), and at 90 an ``apply_settings_async`` whose graphs are
    recorded on its own thread while the server serves."""
    import dataclasses

    from openmeters_tpu_torch.analyzers.loudness import LoudnessConfig
    from openmeters_tpu_torch.serve import MeterServer, ServeConfig
    from openmeters_tpu_torch.utils.parity import check_meters

    s = 8
    engine = _loudness_only()
    cfg = ServeConfig(n_streams=s, engine=engine, realtime=False, fetch="meters", fetch_every=1, coalesce_blocks=1)
    servers = [MeterServer(cfg, device=card), MeterServer(cfg, device="cpu")]
    audio = _stereo_audio(s, 400 * 256, seed=47)
    threads, served_while_recording = [], 0

    def with_floor(db):
        return dataclasses.replace(engine, loudness=LoudnessConfig(floor_db=db))

    try:
        for i in range(400):
            if i == 40:
                for srv in servers:
                    srv.apply_settings(with_floor(-95.0))
                # recorded and warmed by apply_settings; the migrated carry rebinds on the next hop
                assert servers[0].engine.loudness_graphs.counts == {"replays": 2, "eager": 0, "captures": 8,
                                                                    "rebinds": 1}
            if i == 60:
                for srv in servers:
                    srv.set_stream_layout(3, 1)
            if i == 90:
                threads = [srv.apply_settings_async(with_floor(-90.0)) for srv in servers]
            if threads and threads[0].is_alive():
                served_while_recording += 1
            for srv in servers:
                for st in range(s):
                    srv.transport.push_pcm(st, audio[st, i * 256 : (i + 1) * 256], int(i * 256 / 48e3 * 1e9))
                srv.advance()
            check_meters(*(srv.last_meters() for srv in servers), f"advance {i}")
            if i > 100 and not any(srv.reconfig_pending for srv in servers):
                break
        counts = servers[0].report()["loudness_graphs"]
    finally:
        for t in threads:
            t.join(timeout=60)
        for srv in servers:
            srv.close()
    assert all(srv.engine.config.loudness.floor_db == -90.0 for srv in servers)
    assert served_while_recording > 0
    # the new engine: recorded on its thread, warmed there (one rebind), then
    # the migrated live carry (one more)
    assert counts["captures"] == 8 and counts["rebinds"] == 2 and counts["replays"] > 2 and counts["eager"] == 0


@pytest.mark.cuda
def test_loudness_graphs_on_a_two_shard_mesh_of_one_card(card):
    """Two shards of one card each take a graph set of their own: the
    served meters against an unsharded CPU server's, 60 advances."""
    from openmeters_tpu_torch.engine.sharding import StreamMesh
    from openmeters_tpu_torch.serve import MeterServer, ServeConfig
    from openmeters_tpu_torch.utils.parity import check_meters

    s = 8
    cfg = ServeConfig(n_streams=s, engine=_loudness_only(), realtime=False, fetch="meters", fetch_every=1,
                      coalesce_blocks=1)
    servers = [MeterServer(cfg, mesh=StreamMesh(["cuda:0"] * 2), device=card), MeterServer(cfg, device="cpu")]
    audio = _stereo_audio(s, 60 * 256, seed=53)
    try:
        for i in range(60):
            for srv in servers:
                for st in range(s):
                    srv.transport.push_pcm(st, audio[st, i * 256 : (i + 1) * 256], int(i * 256 / 48e3 * 1e9))
                srv.advance()
            check_meters(*(srv.last_meters() for srv in servers), f"advance {i}")
        graphs = servers[0].engine.loudness_graphs
    finally:
        for srv in servers:
            srv.close()
    assert len(graphs._sets[(torch.device("cuda", 0), s // 2)]) == 2  # noqa: SLF001
    # warm-up: one set a shard (two rebinds); serving: the live carries (two
    # more); the eager steps are the meta-device shape probes of the layout
    counts = {k: graphs.counts[k] for k in ("replays", "captures", "rebinds")}
    assert counts == {"replays": 2 * 2 + 2 * 60, "captures": 16, "rebinds": 4}


# -- the hop's rows gathered from the transport's rings -------------------------------


def _gather_case(rows, row_len, arena_len, seed):
    """Pinned arena, staging rows and descriptors of every kind: one
    segment at 8-byte and at 4-byte alignment, partial rows, the ring's
    wrap (two segments), staged rows and zero rows."""
    rng = np.random.default_rng(seed)
    arena = torch.from_numpy(rng.standard_normal(arena_len).astype(np.float32)).pin_memory()
    staging = torch.from_numpy(rng.standard_normal((rows, row_len)).astype(np.float32)).pin_memory()
    kind = rng.integers(0, 6, rows)
    off0 = rng.integers(0, arena_len - 2 * row_len, rows)
    off0 = np.where(kind == 1, off0 | 1, off0 & ~1)  # kind 1: 4-byte aligned only
    n0 = np.where(kind == 2, rng.integers(1, row_len, rows), row_len)  # kind 2: zeros after
    n0 = np.where(kind == 3, rng.integers(1, row_len // 2, rows) * 2, n0)  # kind 3: a wrap
    n1 = np.where(kind == 3, row_len - n0, 0)
    off1 = np.where(kind == 3, rng.integers(0, row_len, rows) * 2, 0)
    n0 = np.where(kind == 4, -1, np.where(kind == 5, 0, n0))  # 4: staged, 5: zero
    desc = torch.from_numpy(np.stack([off0, n0, off1, n1], 1).astype(np.int64)).pin_memory()
    return arena, staging, desc


@pytest.mark.cuda
@pytest.mark.parametrize("s", [7, 513, 8192])
def test_ring_gather_kernel_matches_plain(card, s):
    """The kernel against the plain gather, bit for bit, for the served
    rows (256 frames x 2 channels): fewer rows than a block has warps, one
    past a sweep of the grid, and S=8192 (16 sweeps); also in two shards'
    parts, once with addresses looked up beforehand."""
    from openmeters_tpu_torch.ops import ring_gather as rg

    b, c = 256, 2
    arena, staging, desc = _gather_case(s, b * c, 1 << 22, seed=40)
    want = rg.ring_gather_reference(arena, staging, desc, torch.empty((s, b, c)))
    before = rg.ring_gather.launches
    got = rg.ring_gather(arena, staging, desc, torch.full((s, b, c), float("nan"), device=card))
    parts = torch.full((s, b, c), float("nan"), device=card)
    half = s // 2
    rg.ring_gather(arena, staging, desc, parts[:half], row0=0)
    rg.ring_gather(arena, staging, desc, parts[half:], row0=half, mapped=rg.mapped_addresses(arena, staging, desc))
    torch.cuda.synchronize()
    assert rg.ring_gather.launches == before + 3
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    assert torch.equal(parts.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_ring_gather_reads_a_registered_transport(card):
    """A transport's arena registered for the card: rows in one segment,
    across the ring's end, staged (a mono stream) and zero, gathered on the
    card as on the CPU, hop after hop."""
    from openmeters_tpu_torch.ingest import Transport
    from openmeters_tpu_torch.ops.ring_gather import ring_gather

    s, b = 64, 256
    tp = Transport(s, 2, b, 48_000.0, ring_seconds=(5 * b + 37.5) / 48_000.0)
    tp.pin_arena([card])
    try:
        tp.set_channels(3, 1)
        arena = tp.arena_tensor()
        bufs = [[torch.from_numpy(a).pin_memory() for a in tp.make_desc_buffers()] for _ in range(2)]
        audio = _stereo_audio(s, 40 * b, seed=41)
        pos = np.zeros(s, np.int64)
        for hop in range(40):
            slot = hop % 2
            for st in range(s):
                if st % 7 == 5 or (st == 9 and 10 <= hop < 20):
                    continue  # idle streams: zero rows
                n = b + (st % 3 - 1) * 9
                x = audio[st, pos[st] : pos[st] + n]
                tp.push_pcm(st, x[:, :1].copy() if st == 3 else x, int(pos[st] / 48e3 * 1e9))
                pos[st] += n
            staging, reset, underrun, desc = bufs[slot]
            tp.assemble_desc((staging.numpy(), reset.numpy(), underrun.numpy(), desc.numpy()), slot)
            got = ring_gather(arena, staging, desc, torch.empty((s, b, 2), device=card))
            want = ring_gather(arena, staging, desc, torch.empty((s, b, 2)))
            assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)), f"hop {hop}"
        rows = dict(zip(("one", "two", "staged", "zero"), tp.ingest_rows.tolist()))
        assert min(rows.values()) > 0, rows
    finally:
        tp.unpin_arena()


@pytest.mark.cuda
def test_meter_server_card_blocks_match_cpu(card):
    """``MeterServer`` on the card and on the CPU fed the same pushes
    (partial spans, a gap, a mono stream, an idle stream, a generation
    change): the device blocks each hop steps are identical, over 50 hops,
    with one gather launch a hop."""
    from openmeters_tpu_torch.engine import EngineConfig
    from openmeters_tpu_torch.ops import ring_gather as rg
    from openmeters_tpu_torch.serve import MeterServer, ServeConfig

    s, b = 8, 256
    engine = EngineConfig(channels=2, spectrogram=None, spectrum=None, oscilloscope=None, stereometer=None,
                          waveform=None)
    cfg = ServeConfig(n_streams=s, engine=engine, realtime=False, fetch="meters", coalesce_blocks=1)
    servers = [MeterServer(cfg, device=card), MeterServer(cfg, device="cpu")]
    audio = _stereo_audio(s, 60 * b, seed=42)
    before = rg.ring_gather.launches
    try:
        for srv in servers:
            srv.transport.set_channels(4, 1)
        pos = np.zeros(s, np.int64)
        for hop in range(50):
            pushes = []
            for st in range(s):
                if st == 6 or (st == 2 and hop % 5 == 0):
                    continue
                n = b + (7 if hop % 2 else -7) * (st % 2)
                gap = 40 if (st == 1 and hop == 20) else 0
                x = audio[st, pos[st] : pos[st] + n]
                pushes.append((st, x[:, :1].copy() if st == 4 else x, int((pos[st] + gap) / 48e3 * 1e9)))
                pos[st] += n + gap
            for srv in servers:
                if hop == 30:
                    srv.transport.set_generation(5, 2)
                for p in pushes:
                    srv.transport.push_pcm(*p)
                srv.advance()
            on_card, on_cpu = (srv._shards[0].blocks[srv._buf_i ^ 1] for srv in servers)  # noqa: SLF001
            assert torch.equal(on_card.cpu().view(torch.int32), on_cpu.view(torch.int32)), f"hop {hop}"
        assert rg.ring_gather.launches - before == 50
        rows = servers[0].report()["ingest_rows"]
        assert rows == servers[1].report()["ingest_rows"] and rows["staged"] > 0, rows
    finally:
        for srv in servers:
            srv.close()
