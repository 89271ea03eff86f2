"""PyTorch port on a CUDA card: each kernel against its plain version on the
same card tensors.  Imports no JAX, so it also runs where only torch is
installed (``python -m pytest --noconftest tests/test_torch_cuda.py``).
Every test here skips where no card is present."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openmeters_tpu_torch.ops import reassigned_columns as rcols  # noqa: E402
from openmeters_tpu_torch.ops import reassigned_hop as rhop  # noqa: E402
from openmeters_tpu_torch.ops import sliding_hop as thop  # noqa: E402
from openmeters_tpu_torch.ops.sliding_reassigned import SlidingReassigned  # noqa: E402
from openmeters_tpu_torch.ops.sliding_stft import SlidingSTFT  # noqa: E402
from openmeters_tpu_torch.utils.level import DB_FLOOR  # noqa: E402
from openmeters_tpu_torch.utils.parity import check_reassigned, reassigned_errors  # noqa: E402
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
    [(2048, 64, 256, "hann", 100), (256, 32, 256, "blackman_harris", 37), (64, 16, 64, "blackman", 9)],
)
def test_sliding_hop_kernel_matches_plain(card, fft, hop, block, window, s):
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
    rot_r, rot_i, upd_r, upd_i, dc = sl._tensors(card)
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
    rot_r, rot_i, upd_r, upd_i, dc = sl._tensors(card)
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
    [(2048, 64, 1, "hann", 100), (512, 64, 2, "blackman_harris", 37), (512, 128, 1, "blackman", 9)],
)
def test_reassigned_hop_kernel_matches_plain(card, n, hop, zpf, window, s):
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
        _assert_reassigned_close((kf, kt, kp), (rf, rt, rp))


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
