"""The transform plans of the B1b, B3 and B4-B6 kernels, emulated in float64
on the CPU against ``torch.fft`` and the plain versions.

``csrc/fft_block.cuh`` runs a block's FFTs as passes of up to 2^MAXB points
in registers over a swizzled shared buffer; ``csrc/sliding_hop.cu`` (B1b)
computes each column's delta spectrum ``rfft(d, n)`` from its ``hop``
samples as R = n / P twiddled P-point transforms (P = hop rounded up to a
power of two), of which only r = 0..R/2 run; ``csrc/reassigned_columns.cu``
(B3) runs the frame's real FFT as a half-length complex FFT and a split
step, and the analytic inverse as two parity transforms cropped to the
centre; ``csrc/corr_search.cu`` (B4-B6) packs window and template into one
complex transform, splits the product spectrum by Hermitian symmetry with
an integer-reduced anchor phase, folds it into a half-length inverse's
input at compacted bit-reversed points, and scans the window's prefix sums
in odd serial chunks.  Here each plan is emulated step by step with the
kernels' own index algebra -- group and twiddle indices of every pass, the
swizzled layout, bit-reversed positions, the conjugate symmetry, the crop,
the fold's points, the scan's chunks -- in float64, so an index fault
shows as an O(1) error.  Also: the B1b wrapper's
route by config, and ``SlidingSTFT.step_fused``'s control flow on the B1b
path (``torch.fft.rfft`` on refresh hops only).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openmeters_tpu_torch.ops import corr as tcorr  # noqa: E402
from openmeters_tpu_torch.ops import sliding_hop as thop  # noqa: E402
from openmeters_tpu_torch.ops.block_fft import plan_passes, plan_twiddles  # noqa: E402
from openmeters_tpu_torch.ops import sliding_stft as tstft  # noqa: E402
from openmeters_tpu_torch.ops.reassigned_columns import FFT_STAGES, kernel_supports  # noqa: E402
from openmeters_tpu_torch.ops.sliding_stft import SlidingSTFT  # noqa: E402
from openmeters_tpu_torch.utils.windows import WindowKind  # noqa: E402

C128 = torch.complex128
TOL = 1e-9  # float64 plans against torch.fft, relative to the largest output


# -- fft_block.cuh -----------------------------------------------------------------


def slot_of(i):
    """The header's swizzled layout: the low nibble XOR the fold of the
    higher ones."""
    return i ^ (((i >> 4) ^ (i >> 8) ^ (i >> 12)) & 15)


def twiddles(T: int) -> torch.Tensor:
    """``exp(-2 pi i k / T)``, ``k < T/2``."""
    return torch.exp(-2j * math.pi * torch.arange(T // 2, dtype=torch.float64) / T)


def bit_reverse(i, bits: int):
    i = torch.as_tensor(i)
    out = torch.zeros_like(i)
    for b in range(bits):
        out |= ((i >> b) & 1) << (bits - 1 - b)
    return out


def _group(r, lq, groups):
    g = torch.arange(groups)
    q = g & ((1 << lq) - 1)
    b = ((g >> lq) << (lq + r)) | q
    return q, b


def dif_pass(z, r, lq, groups, ptw, inverse):
    R, Q = 1 << r, 1 << lq
    q, b = _group(r, lq, groups)
    idx = [slot_of(b + j * Q) for j in range(R)]
    x = [z[..., i] for i in idx]
    off = q
    for s in range(r):
        half = R >> (s + 1)
        for j in range(R):
            if j & half:
                continue
            w = ptw[off + (j & (half - 1)) * Q]
            w = w.conj() if inverse else w
            u, v = x[j], x[j + half]
            x[j], x[j + half] = u + v, (u - v) * w
        off = off + half * Q
    for i, v in zip(idx, x):
        z[..., i] = v


def dit_pass(z, r, l0, groups, ptw, inverse):
    R, Q = 1 << r, 1 << l0
    q, b = _group(r, l0, groups)
    idx = [slot_of(b + j * Q) for j in range(R)]
    x = [z[..., i] for i in idx]
    off = q
    for s in range(r):
        half = 1 << s
        for j in range(R):
            if j & half:
                continue
            w = ptw[off + (j & (half - 1)) * Q]
            w = w.conj() if inverse else w
            t, u = x[j + half] * w, x[j]
            x[j], x[j + half] = u + t, u - t
        off = off + half * Q
    for i, v in zip(idx, x):
        z[..., i] = v


def _plan(log2n, maxb, dit):
    """The plan's passes and its table (float64), as the kernels read them."""
    t = torch.from_numpy(plan_twiddles(log2n, maxb, dit, np.float64))
    return plan_passes(log2n, maxb, dit), torch.complex(t[:, 0], t[:, 1])


def block_fft_dif(z, log2n, count, maxb, inverse=False):
    passes, ptw = _plan(log2n, maxb, False)
    for r, lq in passes:
        dif_pass(z, r, lq, count << (log2n - r), ptw, inverse)
        ptw = ptw[((1 << r) - 1) << lq :]


def block_fft_dit(z, log2n, count, maxb, inverse=False):
    passes, ptw = _plan(log2n, maxb, True)
    for r, l0 in passes:
        dit_pass(z, r, l0, count << (log2n - r), ptw, inverse)
        ptw = ptw[((1 << r) - 1) << l0 :]


def _natural(z, n, count=1):
    """The points of ``count`` transforms out of the swizzled buffer."""
    return z[..., slot_of(torch.arange(count * n))]


@pytest.mark.parametrize("log2n,count,maxb", [(13, 1, 4), (13, 2, 4), (9, 17, 3), (7, 3, 3), (4, 2, 4), (1, 3, 3)])
def test_block_fft_passes_match_torch_fft(log2n, count, maxb):
    """Both decimations of the header, every pass split, against torch.fft:
    DIF natural in, bit-reversed out; DIT bit-reversed in, natural out; the
    inverse unscaled."""
    n = 1 << log2n
    rng = np.random.default_rng(log2n * 10 + count)
    x = torch.from_numpy(rng.standard_normal((2, count, n)) + 1j * rng.standard_normal((2, count, n)))
    ref = torch.fft.fft(x)
    rev = bit_reverse(torch.arange(n), log2n)
    z = torch.zeros((2, count * n), dtype=C128)
    z[..., slot_of(torch.arange(count * n))] = x.reshape(2, -1)
    block_fft_dif(z, log2n, count, maxb)
    got = _natural(z, n, count).reshape(2, count, n)[..., rev]
    assert float((got - ref).abs().max()) <= TOL * float(ref.abs().max())
    z[..., slot_of(torch.arange(count * n))] = x[..., rev].reshape(2, -1)
    block_fft_dit(z, log2n, count, maxb, inverse=True)
    got = _natural(z, n, count).reshape(2, count, n)
    ref = torch.fft.ifft(x) * n
    assert float((got - ref).abs().max()) <= TOL * float(ref.abs().max())


@pytest.mark.parametrize("log2n,maxb,dit", [(13, 4, False), (13, 4, True), (9, 3, False), (7, 3, False)])
def test_plan_tables_equal_the_full_table(log2n, maxb, dit):
    """Each plan's f32 table holds, entry for entry, the f32 twiddle of the
    full table ``exp(-2 pi i k / T)`` that the radix-2 passes read, so the
    passes round as the radix-2 passes did."""
    T = 2 << log2n
    k = np.arange(T // 2, dtype=np.float64)
    full = np.stack([np.cos(-2.0 * np.pi * k / T), np.sin(-2.0 * np.pi * k / T)], -1).astype(np.float32)
    want = []
    for r, l in plan_passes(log2n, maxb, dit):
        R, Q = 1 << r, 1 << l
        for s in range(r):
            half = 1 << s if dit else R >> (s + 1)
            span = l + s + 1 if dit else l + r - s
            for jj in range(half):
                want.append(full[(np.arange(Q) + jj * Q) << (log2n + 1 - span)])
    np.testing.assert_array_equal(plan_twiddles(log2n, maxb, dit), np.concatenate(want))


# -- B1b: the pruned delta transform ---------------------------------------------


def delta_spectra_plan(d: torch.Tensor, n: int, chunk: int) -> torch.Tensor:
    """``rfft(d, n)`` of ``[..., hop]`` real deltas as ``sliding_hop.cu``
    computes it, ``chunk`` transforms at a time in its buffer."""
    hop = d.shape[-1]
    lp = max(hop - 1, 0).bit_length()
    pts = 1 << lp
    lr = int(math.log2(n)) - lp
    R = 1 << lr
    count = R // 2 + 1
    build, _ = thop._block_tables(n, hop, torch.device("cpu"))
    tw = twiddles(2 * n)  # exp(-2 pi i k / n) at 2k
    g = torch.arange(count * pts)
    r, m = g >> lp, g & (pts - 1)
    assert torch.equal(build, torch.stack([tw[2 * m * r].real, tw[2 * m * r].imag], -1).float())
    b = torch.arange(n // 2 + 1)
    r, q = b & (R - 1), b >> lr
    low = 2 * r <= R
    rr = torch.where(low, r, R - r)
    out = torch.zeros((*d.shape[:-1], n // 2 + 1), dtype=C128)
    for r0 in range(0, count, chunk):
        r1 = min(count, r0 + chunk)
        g = torch.arange((r1 - r0) * pts)
        m = g & (pts - 1)
        dm = torch.where(m < hop, d[..., torch.clamp_max(m, hop - 1)], 0.0)
        z = torch.zeros((*d.shape[:-1], -(-chunk * pts // 16) * 16), dtype=C128)  # 16-point groups
        z[..., slot_of(g)] = dm * tw[2 * m * (r0 + (g >> lp))]
        block_fft_dif(z, lp, r1 - r0, maxb=thop.BLOCK_FFT_STAGES)
        here = (rr >= r0) & (rr < r1)
        pos = ((rr - r0) << lp) + bit_reverse(torch.where(low, q, pts - 1 - q), lp)
        dv = z[..., slot_of(torch.where(here, pos, 0))]
        out = torch.where(here, torch.where(low, dv, dv.conj()), out)
    return out


@pytest.mark.parametrize("chunk", [None, 5])
@pytest.mark.parametrize(
    "n,hop", [(16384, 512), (16384, 128), (4096, 2048), (2048, 1024), (64, 16), (512, 24), (128, 4), (256, 8)]
)
def test_b1b_delta_transform_plan(n, hop, chunk):
    """The B1b configs of chip_smoke.py phase 14, the smallest B1b config
    (2048/1024: R = 2), the smallest n of the card tests, a hop that is
    not a power of two (zero-padded to 32), and transforms shorter than
    the swizzle's 16-point groups (17 of 4 and of 8 points: the buffer
    rounded up to whole groups); all transforms in one pass over the
    buffer, or 5 at a time (the last pass partial)."""
    rng = np.random.default_rng(n + hop)
    d = torch.from_numpy(rng.standard_normal((2, 2, hop)))
    ref = torch.fft.rfft(d, n=n)
    lp = (hop - 1).bit_length()
    got = delta_spectra_plan(d, n, chunk or (n >> lp) // 2 + 1)
    assert float((got - ref).abs().max()) <= TOL * float(ref.abs().max())


# -- B3: the real split and the pruned analytic inverse ----------------------------


def reassigned_plan(x: torch.Tensor, n: int):
    """``(crop, U, V)`` of ``[..., 2n]`` real frames as
    ``reassigned_columns.cu`` computes them: the second transform's point i
    at ``slot_of(n + i)``."""
    h, L = 2 * n, int(math.log2(n))
    tw = twiddles(h)
    batch = x.shape[:-1]
    z = torch.zeros((*batch, 2 * n), dtype=C128)
    m = torch.arange(n)
    z[..., slot_of(m)] = torch.complex(x[..., 0::2], x[..., 1::2])
    block_fft_dif(z, L, 1, maxb=FFT_STAGES)
    # the split, k = 0..n/2, at bit-reversed positions
    rk = bit_reverse(0, L)
    xn = z[..., slot_of(rk)].real - z[..., slot_of(rk)].imag
    z[..., slot_of(rk)], z[..., slot_of(n + rk)] = xn + 0j, -xn + 0j
    k = torch.arange(1, n // 2 + 1)
    rk, rc = bit_reverse(k, L), bit_reverse(n - k, L)
    zk, zc = z[..., slot_of(rk)], z[..., slot_of(rc)]
    e = 0.5 * (zk + zc.conj())
    o = -0.5j * (zk - zc.conj())
    wk, wc = tw[k], tw[n - k]
    xk = e + wk * o
    xc = (e - wk * o).conj()
    z[..., slot_of(rk)], z[..., slot_of(n + rk)] = xk, xk * wk.conj()
    keep = k != n // 2
    rc = rc[keep]
    z[..., slot_of(rc)], z[..., slot_of(n + rc)] = xc[..., keep], (xc * wc.conj())[..., keep]
    block_fft_dit(z, L, 2, maxb=FFT_STAGES, inverse=True)
    # the centre crop from the two parities, scaled
    crop = z[..., slot_of((m & 1) * n + n // 4 + (m >> 1))] / h
    r = bit_reverse(m, L)
    z[..., slot_of(r)] = crop
    z[..., slot_of(n + r)] = crop * (m.double() - 0.5 * (n - 1))
    block_fft_dit(z, L, 2, maxb=FFT_STAGES)
    return crop, z[..., slot_of(m)], z[..., slot_of(n + m)]


@pytest.mark.parametrize("n", [16, 512, 2048, 8192])
def test_b3_transform_plan(n):
    """Against ``reassigned_columns_reference``'s float64 chain: the centre
    crop of the analytic signal, U = FFT(crop), V = FFT(ramp * crop)."""
    h = 2 * n
    assert kernel_supports(n, h)
    rng = np.random.default_rng(n)
    t = np.arange(h)
    x = torch.from_numpy(np.stack([
        np.sin(2 * np.pi * 0.0123 * t) + 0.01 * rng.standard_normal(h),
        rng.standard_normal(h),
    ]))
    spec = torch.fft.rfft(x, n=h)
    spec[..., 0] = 0.0
    full = torch.zeros((2, h), dtype=C128)
    full[..., : h // 2 + 1] = spec
    a = torch.fft.ifft(full)[..., (h - n) // 2 : (h - n) // 2 + n]
    ramp = torch.arange(n, dtype=torch.float64) - (n - 1) * 0.5
    crop, u, v = reassigned_plan(x, n)
    for got, ref in ((crop, a), (u, torch.fft.fft(a)), (v, torch.fft.fft(a * ramp))):
        assert float((got - ref).abs().max()) <= TOL * float(ref.abs().max())


# -- B4-B6: the correlation search ---------------------------------------------------

CORR_THREADS = 512  # threads a block of csrc/corr_search.cu (THREADS)


def ilogb(x: np.ndarray) -> np.ndarray:
    return np.frexp(x)[1] - 1


def corr_search_plan(work: torch.Tensor, tmpl: torch.Tensor, shift: torch.Tensor, nfft: int, out_len: int):
    """``dots[S, out_len]`` of float64 ``[S, wcap]`` windows and ``[S, L]``
    templates as ``corr_search.cu`` computes them: the packing with its
    power-of-two balance, the forward plan over the swizzled layout, the
    products of each bin quadruple with the integer-reduced anchor phase,
    their fold into the half-length inverse's input at compacted
    bit-reversed points, the inverse plan, and ``dots[o]`` from point
    ``o >> 1``."""
    s, wl = work.shape
    n, L = nfft, nfft.bit_length() - 1
    nw, ntm = min(wl, n), min(tmpl.shape[1], n)
    pw = work[:, :nw].abs().amax(1).numpy()
    pt = tmpl[:, :ntm].abs().amax(1).numpy() if ntm else np.zeros(s)
    e = np.where((pw > 0) & (pt > 0), np.clip(ilogb(pw) - ilogb(np.where(pt > 0, pt, 1.0)), -64, 64), 0)
    bal = torch.from_numpy(np.exp2(e.astype(np.float64)))[:, None]
    packed = torch.zeros((s, n), dtype=C128)
    packed[:, :nw] += work[:, :nw]
    packed[:, :ntm] += 1j * tmpl[:, :ntm] * bal
    z = torch.zeros((s, n), dtype=C128)
    z[:, slot_of(torch.arange(n))] = packed
    block_fft_dif(z, L, 1, maxb=tcorr.FFT_STAGES)

    def cross(zk, zm):  # W conj(T) of the bin pair (k, n - k)
        w, t = 0.5 * (zk + zm.conj()), -0.5j * (zk - zm.conj())
        return w * t.conj()

    def fold(lo, hi, tw):
        return (lo + hi) + 1j * tw * (lo - hi)

    sh = shift.long()[:, None]
    sgn = 1.0 - 2.0 * (sh & 1).double()
    k = torch.arange(1, n // 4 + 1)
    ra, rb = bit_reverse(k, L), bit_reverse(n - k, L)
    m = torch.remainder(k[None, :] * sh, n)  # the kernel's (k shift) & (n - 1)
    ph = torch.exp(1j * math.pi * (2.0 * m.double() / n))
    pk = cross(z[:, slot_of(ra)], z[:, slot_of(rb)]) * ph
    pk2 = cross(z[:, slot_of(ra + 1)], z[:, slot_of(rb - 1)]) * ph * sgn
    # the twist: the forward plan's entries k < n/2 are exp(-2 pi i k / n), in order
    table = torch.from_numpy(plan_twiddles(L, tcorr.FFT_STAGES, False, np.float64))[: n // 2]
    full = torch.exp(-2j * math.pi * torch.arange(n // 2, dtype=torch.float64) / n)
    assert float((torch.complex(table[:, 0], table[:, 1]) - full).abs().max()) <= 1e-15
    tw = torch.complex(table[k, 0], -table[k, 1])
    qa, qb = fold(pk, pk2, tw), fold(pk2.conj(), pk.conj(), -tw.conj())
    q0 = fold(cross(z[:, 0], z[:, 0]), cross(z[:, 1], z[:, 1]) * sgn[:, 0], 1.0)
    keep = k != n // 4
    pos = torch.cat([torch.zeros(1, dtype=torch.int64), ra >> 1, (rb >> 1)[keep]])
    assert torch.equal(torch.sort(pos).values, torch.arange(n // 2))  # each inverse point once
    q = z.clone()  # in place: every read above happens before the writes
    q[:, slot_of(pos)] = torch.cat([q0[:, None], qa, qb[:, keep]], dim=1)
    block_fft_dit(q, L - 1, 1, maxb=tcorr.FFT_STAGES, inverse=True)
    o = torch.arange(out_len)
    y = q[:, slot_of(o >> 1)]
    return torch.where((o & 1).bool(), y.imag, y.real) * torch.from_numpy(np.exp2(-(e + L).astype(np.float64)))[:, None]


@pytest.mark.parametrize("threads", [256, 512])
def test_corr_first_pass_holds_whole_groups(threads):
    """At n = 8192 ``corr_search.cu`` runs the forward's first pass (4
    stages, Q = 512, groups g < 512 of the points g + 512 j) on the packed
    signal in registers: thread t holds point t + it * threads at register
    it, and takes group g = t + h * threads from registers h + j G (G =
    512 / threads).  Those are the group's points, and the groups of all
    threads cover the 8192 points once."""
    assert plan_passes(13, tcorr.FFT_STAGES, False)[0] == (4, 9)
    G = 512 // threads
    t = torch.arange(threads)[:, None, None]
    h = torch.arange(G)[None, :, None]
    j = torch.arange(16)[None, None, :]
    held = t + (h + j * G) * threads  # the point in register h + j G of thread t
    want = (t + h * threads) + 512 * j  # point j of group t + h threads
    assert torch.equal(held, want.expand_as(held))
    assert torch.equal(torch.sort(held.flatten()).values, torch.arange(8192))


def corr_sums_plan(work: torch.Tensor, klen, wlen, out_len: int):
    """``(sx, sxx, wmean)`` as ``corr_search.cu`` computes them: (x, x^2)
    at points 1..wcap, scanned by ``CORR_THREADS`` serial chunks of an odd
    length, each chunk offset by the totals of those before it."""
    s, wl = work.shape
    ab = torch.zeros((s, wl + 1, 2), dtype=torch.float64)
    ab[:, 1:, 0], ab[:, 1:, 1] = work, work * work
    chunk = -(-wl // CORR_THREADS) | 1
    bounds = [(min(1 + t * chunk, wl + 1), min(1 + t * chunk + chunk, wl + 1)) for t in range(CORR_THREADS)]
    covered = torch.zeros(wl + 1, dtype=torch.int64)
    for lo, hi in bounds:
        covered[lo:hi] += 1
    assert covered[0] == 0 and bool((covered[1:] == 1).all())  # each point in one chunk
    total = torch.zeros((s, 2), dtype=torch.float64)
    for lo, hi in bounds:
        part = torch.cumsum(ab[:, lo:hi], dim=1)
        ab[:, lo:hi] = total[:, None] + part
        if hi > lo:
            total = total + part[:, -1]
    kl = klen.long().clamp(0, wl + 1 - out_len)
    o = torch.arange(out_len)[None, :]
    hi, lo = ab[torch.arange(s)[:, None], o + kl[:, None]], ab[:, :out_len]
    w = wlen.long()
    inside = (w >= 0) & (w <= wl)
    wmean = torch.where(inside, ab[torch.arange(s), w.clamp(0, wl), 0], 0.0) / w.double().clamp_min(1.0)
    return hi[..., 0] - lo[..., 0], hi[..., 1] - lo[..., 1], wmean


def direct_dots(work: np.ndarray, tmpl: np.ndarray, shift: np.ndarray, nfft: int, offsets: np.ndarray):
    """``sum_k work[(o + shift + k) mod nfft] tmpl[k]`` at the given
    offsets, summed term by term in float64."""
    w = np.zeros((work.shape[0], nfft))
    w[:, : min(work.shape[1], nfft)] = work[:, :nfft]
    t = np.zeros((tmpl.shape[0], nfft))
    t[:, : min(tmpl.shape[1], nfft)] = tmpl[:, :nfft]
    kk = np.arange(nfft)
    idx = (offsets[None, :, None] + shift[:, None, None] + kk[None, None, :]) % nfft
    return np.einsum("sok,sk->so", np.take_along_axis(w[:, None, :], idx, axis=2), t)


@pytest.mark.parametrize(
    "nfft,wcap,tlen,out_len,sums,zero_tmpl",
    [
        (16, 12, 7, 16, False, False),  # the smallest n; out_len = nfft
        (16, 12, 20, 13, True, False),  # a template longer than nfft; out_len = wcap + 1
        (32, 40, 9, 32, True, False),  # a window longer than nfft (its prefix past the transform)
        (32, 20, 10, 21, True, True),  # an all-zero template (e = 0)
        (8192, 7200, 4800, 2401, True, False),  # the main path's shape
        (8192, 7200, 4800, 7201, True, False),
        (32768, 28800, 19200, 9601, True, False),  # 192 kHz
        (32768, 28800, 19200, 28801, True, True),
    ],
)
def test_corr_search_plan(nfft, wcap, tlen, out_len, sums, zero_tmpl):
    """The correlation search's plan against ``corr_dots_reference`` (f32,
    within ``DOTS_REL`` of the peak) and a term-by-term float64
    correlation; with sums, its prefix scan against the plain version
    (``SUMS_REL``) and a float64 cumsum.  Shifts: the oscilloscope's
    negative anchor offsets, a large positive and a large negative one."""
    from openmeters_tpu_torch.utils.parity import DOTS_REL, SUMS_REL

    rng = np.random.default_rng(nfft + wcap + out_len)
    s = 4
    work = rng.standard_normal((s, wcap)).astype(np.float32)
    tmpl = np.zeros((s, tlen), np.float32) if zero_tmpl else rng.standard_normal((s, tlen)).astype(np.float32)
    tmpl[1] *= 1e-3  # a template 60 dB below its window: e balances them
    shift = np.array([-(tlen // 3), 0, 2**30 + 12345, -(2**31) + 7], np.int32)
    klen = rng.integers(0, wcap + 2, s).astype(np.int32)
    wlen = np.array([0, wcap, wcap // 2 + 1, wcap + 1], np.int32)
    w64, t64 = torch.from_numpy(work).double(), torch.from_numpy(tmpl).double()
    got = corr_search_plan(w64, t64, torch.from_numpy(shift), nfft, out_len)

    offsets = np.arange(out_len) if nfft <= 64 else rng.choice(out_len, 40, replace=False)
    exact = direct_dots(work.astype(np.float64), tmpl.astype(np.float64), shift.astype(np.int64), nfft, offsets)
    ref = tcorr.corr_dots_reference(torch.from_numpy(work), torch.from_numpy(tmpl), torch.from_numpy(shift),
                                    nfft, out_len).double()
    peak = float(ref.abs().max())
    if zero_tmpl:
        # the exact dots are 0; the template's spectrum, separated from the
        # window's, is the rounding of the window's own: held against the
        # window's energy, the dots' scale were the template the window
        assert peak == 0.0 and not exact.any()
        scale = float((w64[:, :nfft] ** 2).sum(1).max())
        assert float(got.abs().max()) <= TOL * scale
    else:
        assert float(np.abs(got.numpy()[:, offsets] - exact).max()) <= TOL * float(np.abs(exact).max())
        assert float((got - ref).abs().max()) <= DOTS_REL * peak
    if not sums:
        return
    sx, sxx, wmean = corr_sums_plan(w64, torch.from_numpy(klen), torch.from_numpy(wlen), out_len)
    _, rsx, rsxx, rwmean = tcorr.corr_dots_sums_reference(
        torch.from_numpy(work), torch.from_numpy(tmpl), torch.from_numpy(klen), torch.from_numpy(wlen),
        torch.from_numpy(shift), nfft, out_len,
    )
    cs = np.concatenate([np.zeros((s, 1)), np.cumsum(work.astype(np.float64), 1)], 1)
    cs2 = np.concatenate([np.zeros((s, 1)), np.cumsum(work.astype(np.float64) ** 2, 1)], 1)
    kl = np.clip(klen, 0, wcap + 1 - out_len)
    o = np.arange(out_len)
    rows = np.arange(s)[:, None]
    for ours, plain, exact in (
        (sx, rsx, cs[rows, o + kl[:, None]] - cs[:, :out_len]),
        (sxx, rsxx, cs2[rows, o + kl[:, None]] - cs2[:, :out_len]),
        (wmean, rwmean, np.where(wlen <= wcap, cs[np.arange(s), np.clip(wlen, 0, wcap)], 0.0) / np.maximum(wlen, 1)),
    ):
        assert float(np.abs(ours.numpy() - exact).max()) <= TOL * max(float(np.abs(exact).max()), 1.0)
        assert float((ours - plain.double()).abs().max()) <= SUMS_REL * max(float(plain.abs().max()), 1.0)


# -- the B1b wrapper's route and the step's control flow ---------------------------


@pytest.mark.parametrize("n,block", [(2048, True), (16384, True), (32768, False), (65536, False)])
def test_b1b_route_follows_the_config(n, block):
    """Rows up to 16384 points take the whole-row kernel; larger ones the
    deltas' rFFT and the bin-tiled kernel."""
    assert thop.block_fits(n) == block


def test_b1b_step_runs_rfft_on_refresh_hops_only(monkeypatch):
    """On the B1b path a steady hop hands the sample deltas to the kernel
    wrapper and calls no ``torch.fft.rfft``; a refresh hop (the first ready
    one, then every 32nd) calls it once, for the exact frame spectrum, and
    hands the wrapper column 0's deltas zeroed (the anchor lands on that
    spectrum whatever the kernel's own delta spectra)."""
    sl = SlidingSTFT(2048, 1024, 1024, WindowKind.HANN)
    assert not sl.whole_row and sl.supported
    s, hops = 3, 70
    calls, seen = [], []
    rfft = torch.fft.rfft

    def counting_rfft(*args, **kw):
        calls[-1] += 1
        return rfft(*args, **kw)

    def recorder(ready, fr, fi, deltas, *rows, n, coeffs, floor_db, emit_codes):
        seen.append((ready, tuple(deltas.shape), deltas.dtype, bool((deltas[:, 0] == 0).all())))
        return fr.clone(), fi.clone(), torch.zeros((s, deltas.shape[1], fr.shape[1]))

    monkeypatch.setattr(torch.fft, "rfft", counting_rfft)
    monkeypatch.setattr(tstft, "sliding_hop_spectra", recorder)
    fb = sl.frames
    carry, sdft = fb.init(s), sl.init(s)
    norm = torch.ones((sl.bins,))
    rng = np.random.default_rng(3)
    expected, first = [], None
    for i in range(hops):
        carry, info = fb.advance(carry, torch.from_numpy(rng.standard_normal((s, 1024)).astype(np.float32)))
        calls.append(0)
        sdft, _ = sl.step_fused(sdft, info, norm, -120.0, emit_codes=False)
        if info["ready"] > 0 and first is None:
            first = i
        expected.append(1 if info["ready"] > 0 and (i == first or i % 32 == 0) else 0)
    assert calls == expected
    assert sum(c > 0 for c in calls) == 3  # hops 1, 32 and 64
    assert len(seen) == hops and all(sh == (s, 1, 1024) and dt == torch.float32 for _, sh, dt, _ in seen)
    # column 0 zeroed on refresh hops only (before the first, the ring is still empty)
    assert [zero for ready, *_, zero in seen if ready] == [c > 0 for (ready, *_), c in zip(seen, calls) if ready]
