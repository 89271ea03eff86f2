"""Why the two sliding hops' delta products run as 3xTF32 on the tensor cores,
pinned on the CPU.

The B1a (``csrc/sliding_hop_deltas.cu``) and B2 (``csrc/reassigned_hop.cu``)
kernels split each f32 operand into TF32 hi and lo parts (round to nearest)
and sum ``a_lo b_hi + a_hi b_lo + a_hi b_hi``, a chunk of K at a time, the
chunks added in f32.  Here that arithmetic is emulated in numpy -- the
split, exact products, f32 sums of the chunks in order of K -- beside the
same emulation of bf16x3 (the JAX package's split on the TPU) and of a
plain f32 FMA chain, and one hop of each kernel's plain column code
(``_slide_columns``, ``slide_reassigned`` and its ``_column``) runs on each
way's products against a float64 hop.  3xTF32 stays within 1.5 times plain
f32's state and time-correction errors and within the kernel-against-plain
bars of ``chip_smoke.py`` phases 3 and 6; bf16x3 lands further off, which
is why it was not taken.  Also: the update matrices' tile image that both
kernels stage (``ops/update_tiles.py``) against a decode of its layout.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openmeters_tpu_torch.ops.reassigned_hop import hop_tiles as reassigned_tiles  # noqa: E402
from openmeters_tpu_torch.ops.reassigned_hop import slide_reassigned  # noqa: E402
from openmeters_tpu_torch.ops.sliding_hop import _slide_columns  # noqa: E402
from openmeters_tpu_torch.ops.sliding_hop import hop_tiles as sliding_tiles  # noqa: E402
from openmeters_tpu_torch.ops.sliding_reassigned import SlidingReassigned  # noqa: E402
from openmeters_tpu_torch.ops.sliding_stft import SlidingSTFT  # noqa: E402
from openmeters_tpu_torch.ops.update_tiles import KC  # noqa: E402
from openmeters_tpu_torch.utils.level import DB_FLOOR  # noqa: E402
from openmeters_tpu_torch.utils.parity import check_reassigned, reassigned_errors  # noqa: E402
from openmeters_tpu_torch.utils.windows import (  # noqa: E402
    WindowKind,
    fft_bin_normalization,
    window_coefficients,
)

S = 64  # streams
RESOLVED_CODES = round(60.0 * 65535 / 156)  # see tests/test_torch_sliding.py
CASES = {
    "b1a 2048/64 hann": ("b1a", 2048, 64, 1, "hann"),
    "b2 2048/64 hann": ("b2", 2048, 64, 1, "hann"),
    "b2 512/64 blackman-harris zpf 2": ("b2", 512, 64, 2, "blackman_harris"),
}


def _tf32(x: np.ndarray) -> np.ndarray:
    """Round f32 to TF32 (10 mantissa bits), to nearest, ties away from
    zero (``cvt.rna.tf32.f32``)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _bf16(x: np.ndarray) -> np.ndarray:
    """Round f32 to bf16 (7 mantissa bits), to nearest even."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    b = b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))
    return (b & np.uint32(0xFFFF0000)).view(np.float32)


def products(a: np.ndarray, b: np.ndarray, way: str) -> np.ndarray:
    """``a [R, K] @ b [K, N]`` as ``way`` computes it: "exact" in float64;
    "f32" as an FMA chain over K; "3xtf32" / "bf16x3" as the kernels sum
    three split products a_lo b_hi + a_hi b_lo + a_hi b_hi: each product
    exact, the products of each chunk of ``KC`` values of K summed and
    rounded to f32 (a model of the tensor cores' sum within a chunk, taken
    as exact), the chunks' sums added in f32 in order."""
    if way == "exact":
        return a.astype(np.float64) @ b.astype(np.float64)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    if way == "f32":
        for k in range(a.shape[1]):
            acc = (acc + a[:, k, None].astype(np.float64) * b[None, k]).astype(np.float32)
        return acc
    rnd = {"3xtf32": _tf32, "bf16x3": _bf16}[way]
    a_hi, b_hi = rnd(a), rnd(b)
    a_lo, b_lo = rnd(a - a_hi), rnd(b - b_hi)
    for k0 in range(0, a.shape[1], KC):
        c = slice(k0, k0 + KC)
        chunk = sum(x[:, c].astype(np.float64) @ y[c].astype(np.float64)
                    for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)))
        acc = acc + chunk.astype(np.float32)
    return acc


def _analytic(rng, s, length):
    """Two sines a stream and their Hilbert transform, plus 1e-3 noise."""
    t = np.arange(length) / 48_000.0
    f0 = rng.uniform(200.0, 16_000.0, size=(2, s, 1))
    ph = rng.uniform(0.0, 2 * np.pi, size=(2, s, 1))
    amp = np.array([0.4, 0.1])[:, None, None]
    arg = 2 * np.pi * f0 * t + ph
    x = np.stack([(amp * np.sin(arg)).sum(0), -(amp * np.cos(arg)).sum(0)])
    return (x + 1e-3 * rng.standard_normal(x.shape)).astype(np.float32)


def _b1a_hop(n, hop, window):
    """``{way: (state error, codes)}`` of one B1a hop against float64."""
    sl = SlidingSTFT(n, hop, 256, WindowKind(window))
    cols = sl.frames.cols_cap
    x = _analytic(np.random.default_rng(n + hop), S, n + cols * hop)[0]
    spec = np.fft.rfft(x[:, :n].astype(np.float64), axis=-1)
    deltas = np.stack([x[:, n + k * hop : n + (k + 1) * hop] - x[:, k * hop : (k + 1) * hop]
                       for k in range(cols)], axis=1)
    _, _, upd_r, upd_i = sl._consts()
    upd = np.concatenate([upd_r, upd_i], axis=1)
    rot_r, rot_i, dc = sl._rows(torch.device("cpu"))
    norm = torch.from_numpy(fft_bin_normalization(window_coefficients(sl.window, n), n))
    coeffs = tuple(float(a) for a in sl._stencil())
    out = {}
    for way in ("exact", "f32", "3xtf32", "bf16x3"):
        dtype = torch.float64 if way == "exact" else torch.float32
        d = torch.from_numpy(products(deltas.reshape(-1, hop), upd, way)).to(dtype).reshape(S, cols, -1)
        fr, fi = (torch.from_numpy(np.ascontiguousarray(p, np.float32)).to(dtype) for p in (spec.real, spec.imag))
        fr2, fi2, codes = _slide_columns(cols, fr, fi, d[..., : sl.bins], d[..., sl.bins :],
                                         rot_r.to(dtype), rot_i.to(dtype), dc.to(dtype), norm.to(dtype),
                                         n, coeffs, DB_FLOOR, True)
        out[way] = (fr2.double(), fi2.double(), codes.to(torch.int32))
    er, ei, ec = out.pop("exact")
    scale = torch.hypot(er, ei).amax(dim=1, keepdim=True)
    held = ec >= ec.amax(dim=-1, keepdim=True) - RESOLVED_CODES
    return {
        way: {"state": float(torch.maximum((r - er).abs(), (i - ei).abs()).div(scale).max()),
              "codes": int(((c - ec).abs() * held).max())}
        for way, (r, i, c) in out.items()
    }


def _b2_hop(n, hop, zpf, window):
    """``{way: errors}`` of one B2 hop against float64: the state error and
    ``reassigned_errors`` of the corrections."""
    sl = SlidingReassigned(n, hop, 256, WindowKind(window), 48_000.0, zpf=zpf)
    cols = sl.cols_cap
    x = _analytic(np.random.default_rng(n + zpf), S, n + cols * hop)
    ramp = np.arange(n) - (n - 1) * 0.5
    states = []
    for sig in (x[0, :, :n], x[1, :, :n], x[0, :, :n] * ramp, x[1, :, :n] * ramp):
        spec = np.fft.rfft(sig.astype(np.float64), n=sl.pfft, axis=-1)
        states += [spec.real, spec.imag]

    def deltas(sig):
        return np.stack([np.concatenate([sig[:, n + k * hop : n + (k + 1) * hop], sig[:, k * hop : (k + 1) * hop]], -1)
                         for k in range(cols)], axis=1).reshape(-1, 2 * hop)

    t = sl._tensors(torch.device("cpu"))
    upd = t["upd"].numpy()
    kw = dict(hop=hop, n=n, zpf=zpf, coeffs=sl.coeffs(), inv_2pi=48_000.0 / (2.0 * np.pi),
              inv_hop=1.0 / hop, latency_hops=sl.center / hop)
    out = {}
    for way in ("exact", "f32", "3xtf32", "bf16x3"):
        dtype = torch.float64 if way == "exact" else torch.float32
        ax, ah = (torch.from_numpy(products(deltas(sig), upd, way)).to(dtype).reshape(S, cols, -1) for sig in x)
        st = tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype) for a in states)
        rows = (t[k].to(dtype) for k in ("rot_r", "rot_i", "normq", "freqb"))
        new, *corr = slide_reassigned(cols, st, ax, ah, *rows, **kw)
        out[way] = (tuple(a.double() for a in new), tuple(a.float() for a in corr))
    est, ecorr = out.pop("exact")
    valid = torch.ones((S, cols), dtype=torch.bool)
    result = {}
    for way, (st, corr) in out.items():
        state = max(
            float(((st[j] - est[j]).abs() / torch.hypot(est[i], est[i + 1]).amax(1, keepdim=True)).max())
            for i in range(0, 8, 2) for j in (i, i + 1)
        )
        result[way] = {"state": state, **reassigned_errors(corr, ecorr, valid, drift=False)[0]}
    return result


@functools.lru_cache(maxsize=None)
def _hop_errors(case: str) -> dict:
    kind, n, hop, zpf, window = CASES[case]
    return _b1a_hop(n, hop, window) if kind == "b1a" else _b2_hop(n, hop, zpf, window)


@pytest.mark.parametrize("case", list(CASES))
def test_3xtf32_keeps_f32_precision(case, record_property):
    """3xTF32 within 1.5 times plain f32's distance from the float64 hop, and
    within the bars the kernel is held to against its plain version."""
    err = _hop_errors(case)
    for way, e in err.items():
        for key, value in e.items():
            record_property(f"{way}_{key}", value)
    tc, f32 = err["3xtf32"], err["f32"]
    assert tc["state"] <= 1.5 * f32["state"] and tc["state"] <= 1e-5, err
    if "codes" in tc:
        assert tc["codes"] <= 2, err
    else:
        assert tc["time_hops"] <= 1.5 * f32["time_hops"], err
        check_reassigned(tc, case)


@pytest.mark.parametrize("case", list(CASES))
def test_bf16x3_lands_further_off(case):
    """bf16x3, the TPU kernels' split: its products keep 16 bits of each
    operand where 3xTF32's keep 22, and one hop already lands several times
    further from float64 than 3xTF32's or f32's."""
    err = _hop_errors(case)
    assert err["bf16x3"]["state"] > 2 * max(err["3xtf32"]["state"], err["f32"]["state"]), err


def _core_offset(r: int, k: int) -> int:
    return (((r >> 3) * (KC // 4) + (k >> 2)) << 5) + ((r & 7) << 2) + (k & 3)


@pytest.mark.parametrize("which,k,bins", [("b1a", 12, 129), ("b1a", 64, 300), ("b2", 96, 257)])
def test_update_tiles_layout(which, k, bins):
    """Each staged value of the tile image is the update matrix's value at
    its bin, part and K row (zero past the edges), by the layout the
    kernels address: tile, half, chunk, then the core-matrix order."""
    rng = np.random.default_rng(k)
    parts, halo = (2, 3) if which == "b1a" else (4, 6)
    upd = torch.from_numpy(rng.standard_normal((k, parts * bins)).astype(np.float32))
    tiles = (sliding_tiles(upd[:, :bins], upd[:, bins:]) if which == "b1a" else reassigned_tiles(upd)).numpy()
    ext, half = 128, 64
    tile = ext - 2 * halo
    assert tiles.shape == (-(-bins // tile), 2, -(-k // KC), parts * half * KC)
    for bt in range(tiles.shape[0]):
        for h in range(2):
            for p in range(parts):
                for j in range(half):
                    g = bt * tile - halo + h * half + j
                    want = np.zeros(tiles.shape[2] * KC, np.float32)
                    if 0 <= g < bins:
                        want[:k] = upd[:, p * bins + g].numpy()
                    got = [tiles[bt, h, kk // KC, _core_offset(p * half + j, kk % KC)] for kk in range(want.size)]
                    np.testing.assert_array_equal(got, want)
