"""PyTorch port, sliding-DFT spectrogram hop: the plain version of the CUDA
kernel against the JAX package's Pallas kernel (interpret mode on the CPU),
and the port's SlidingSTFT against the JAX one over a re-anchor.

u16 codes are compared within 2 codes (0.005 dB) at every bin within 60 dB
of its column's peak.  Deeper bins are below what an f32 sliding state
resolves (its rounding is ~1e-7 of the row's largest bin, summed over the
32 hops between exact re-anchors); there two f32 implementations, or either
one and an exact float64 transform, part by tens of codes, so those bins
are not held to the code bound.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from openmeters_tpu.analyzers.spectrogram import pack_classic_db  # noqa: E402
from openmeters_tpu.ops import pallas_sliding as jpallas  # noqa: E402
from openmeters_tpu.ops import sliding_stft as jsliding  # noqa: E402
from openmeters_tpu.utils.level import DB_FLOOR, power_to_db  # noqa: E402
from openmeters_tpu.utils.windows import WindowKind as JWindowKind  # noqa: E402
from openmeters_tpu.utils.windows import fft_bin_normalization  # noqa: E402
from openmeters_tpu.utils.windows import window_coefficients  # noqa: E402
from openmeters_tpu_torch.ops import sliding_hop as thop  # noqa: E402
from openmeters_tpu_torch.ops import sliding_stft as tsliding  # noqa: E402
from openmeters_tpu_torch.ops.framing import FrameBuffer  # noqa: E402
from openmeters_tpu_torch.utils.windows import WindowKind  # noqa: E402

RESOLVED_CODES = round(60.0 * 65535 / 156)  # 60 dB in u16 code steps


def code_diff(ours, ref, valid=None) -> int:
    """Max |code difference| over bins within 60 dB of their column peak."""
    ours, ref = np.asarray(ours).astype(np.int64), np.asarray(ref).astype(np.int64)
    held = ref >= ref.max(axis=-1, keepdims=True) - RESOLVED_CODES
    if valid is not None:
        held &= np.asarray(valid)[..., None]
    return int((np.abs(ours - ref) * held).max())


def _pallas_interpret(fn):
    """Run ``fn`` with the Pallas interpreter on, restoring the env after."""
    old = os.environ.get("OPENMETERS_PALLAS_INTERPRET")
    os.environ["OPENMETERS_PALLAS_INTERPRET"] = "1"
    jax.clear_caches()
    try:
        return fn()
    finally:
        if old is None:
            os.environ.pop("OPENMETERS_PALLAS_INTERPRET", None)
        else:
            os.environ["OPENMETERS_PALLAS_INTERPRET"] = old
        jax.clear_caches()


def _hop_inputs(sl, s, seed):
    """A state that is the spectrum of a real frame, and fresh deltas."""
    rng = np.random.default_rng(seed)
    n, h, cols = sl.fft_size, sl.hop, sl.frames.cols_cap
    x = (rng.standard_normal((s, n + cols * h)) * 0.3).astype(np.float32)
    spec = np.fft.rfft(x[:, :n].astype(np.float64), axis=-1)
    fr, fi = spec.real.astype(np.float32), spec.imag.astype(np.float32)
    deltas = np.stack(
        [x[:, n + k * h : n + (k + 1) * h] - x[:, k * h : (k + 1) * h] for k in range(cols)],
        axis=1,
    )
    return fr, fi, deltas


@pytest.mark.parametrize("ready", [0, 2, 4])
@pytest.mark.parametrize("window", ["hann", "blackman_harris"])
def test_reference_hop_matches_pallas_kernel(window, ready):
    n, hop, s = 64, 16, 8
    jsl = jsliding.SlidingSTFT(n, hop, 64, JWindowKind(window))
    tsl = tsliding.SlidingSTFT(n, hop, 64, WindowKind(window))
    cols, bins = jsl.frames.cols_cap, jsl.bins
    assert cols == 4
    fr, fi, deltas = _hop_inputs(tsl, s, seed=17)
    rot_r, rot_i, upd_r, upd_i = jsl._consts()
    dc = jsl._dc_corr_vector()
    norm = fft_bin_normalization(window_coefficients(JWindowKind(window), n), n)
    coeffs = tuple(float(a) for a in jsl._stencil())

    jr, ji, jcodes = _pallas_interpret(lambda: jax.device_get(jpallas.sliding_hop(
        ready, jnp.asarray(fr), jnp.asarray(fi), jnp.asarray(deltas),
        jnp.asarray(upd_r), jnp.asarray(upd_i), jnp.asarray(rot_r)[None],
        jnp.asarray(rot_i)[None], jnp.asarray(dc)[None], jnp.asarray(norm)[None],
        cols=cols, hop=hop, bins=bins, n=n, coeffs=coeffs, floor_db=DB_FLOOR,
        emit_codes=True,
    )))
    t = [torch.from_numpy(a) for a in (fr, fi, deltas, upd_r, upd_i, rot_r, rot_i, dc, norm)]
    tr, ti, tcodes = thop.sliding_hop(ready, *t, n=n, coeffs=coeffs, floor_db=DB_FLOOR)

    assert tcodes.dtype == torch.uint16 and tuple(tcodes.shape) == (s, cols, bins)
    assert code_diff(tcodes.numpy(), jcodes) <= 2
    rowmax = np.max(np.hypot(jr, ji), axis=1, keepdims=True)
    err = np.maximum(np.abs(tr.numpy() - jr), np.abs(ti.numpy() - ji)) / rowmax
    assert float(err.max()) <= 1e-5
    if ready == 0:  # the state is held and every column reads it
        np.testing.assert_array_equal(tr.numpy(), fr)
        assert np.all(tcodes.numpy() == tcodes.numpy()[:, :1])


@pytest.mark.parametrize(
    "fft,hop,block,window", [(2048, 64, 256, "hann"), (256, 32, 64, "blackman_harris")]
)
def test_step_fused_matches_jax_sliding_stft(fft, hop, block, window):
    """40 hops, crossing the exact re-anchor at hop 32: the port's fused
    hop (plain version on the CPU) against JAX ``SlidingSTFT.step`` plus
    dB and u16 packing, the reference's CPU path."""
    rng = np.random.default_rng(23)
    s = 3
    jsl = jsliding.SlidingSTFT(fft, hop, block, JWindowKind(window))
    tsl = tsliding.SlidingSTFT(fft, hop, block, WindowKind(window))
    jfb, tfb = jsl.frames, FrameBuffer(fft, hop, block)
    norm = fft_bin_normalization(window_coefficients(JWindowKind(window), fft), fft)
    jfc, tfc = jfb.init(s), tfb.init(s)
    jst, tst = jsl.init(s), tsl.init(s)
    jstep = jax.jit(jsl.step)
    anchors = 0
    for i in range(40 + fft // block):
        blk = (rng.standard_normal((s, block)) * 0.2).astype(np.float32)
        jfc, jinfo = jfb.advance(jfc, jnp.asarray(blk))
        tfc, tinfo = tfb.advance(tfc, torch.from_numpy(blk))
        jst, power = jstep(jst, jinfo)
        jcodes = pack_classic_db(power_to_db(power * norm, DB_FLOOR))
        anchors += int(not tst["anchored"] or tst["count"] % 32 == 0) * (tinfo["ready"] > 0)
        tst, tcodes = tsl.step_fused(tst, tinfo, torch.from_numpy(norm), DB_FLOOR, emit_codes=True)
        assert tst["count"] == int(jst["count"]) and tst["anchored"] == bool(jst["anchored"])
        valid = np.asarray(jinfo["valid"])
        np.testing.assert_array_equal(tinfo["valid"].numpy(), valid)
        if valid.any():
            assert code_diff(tcodes.numpy(), np.asarray(jcodes), valid) <= 2, i
    assert anchors >= 2  # the first anchor and at least one periodic one


def test_sliding_hop_rejects_other_devices():
    t = torch.zeros((2, 33), device="meta")
    with pytest.raises(ValueError):
        thop.sliding_hop(
            1, t, t, torch.zeros((2, 4, 16), device="meta"),
            *([torch.zeros((16, 33), device="meta")] * 2),
            *([torch.zeros((33,), device="meta")] * 4),
            n=64, coeffs=(0.5, -0.5), floor_db=DB_FLOOR,
        )
