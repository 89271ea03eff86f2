"""PyTorch port, building blocks: the same seeded inputs through the JAX
package and the port, compared at stated tolerances (JAX on the CPU)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from openmeters_tpu.ops import framing as jframing  # noqa: E402
from openmeters_tpu.ops import gating as jgating  # noqa: E402
from openmeters_tpu.ops import iir as jiir  # noqa: E402
from openmeters_tpu.ops import sliding_stft as jsliding  # noqa: E402
from openmeters_tpu.ops import truepeak as jtruepeak  # noqa: E402
from openmeters_tpu.ops import windowed as jwindowed  # noqa: E402
from openmeters_tpu.utils import channels as jchannels  # noqa: E402
from openmeters_tpu.utils import level as jlevel  # noqa: E402
from openmeters_tpu.utils import weighting as jweighting  # noqa: E402
from openmeters_tpu.utils import windows as jwindows  # noqa: E402
from openmeters_tpu_torch.ops import framing as tframing  # noqa: E402
from openmeters_tpu_torch.ops import gating as tgating  # noqa: E402
from openmeters_tpu_torch.ops import iir as tiir  # noqa: E402
from openmeters_tpu_torch.ops import sliding_stft as tsliding  # noqa: E402
from openmeters_tpu_torch.ops import truepeak as ttruepeak  # noqa: E402
from openmeters_tpu_torch.ops import windowed as twindowed  # noqa: E402
from openmeters_tpu_torch.utils import channels as tchannels  # noqa: E402
from openmeters_tpu_torch.utils import level as tlevel  # noqa: E402
from openmeters_tpu_torch.utils import weighting as tweighting  # noqa: E402
from openmeters_tpu_torch.utils import windows as twindows  # noqa: E402


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(a, b, floor=1e-12):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), floor)))


# -- numpy constant helpers: bit-identical to the reference -----------------

WINDOW_KINDS = [k.value for k in jwindows.WindowKind]


def _const_pairs(name):
    if name == "levels":
        return [
            (tlevel.DB_FLOOR, jlevel.DB_FLOOR),
            (tlevel.LN_TO_DB, jlevel.LN_TO_DB),
            (tlevel.FLUSH_F32, jlevel.FLUSH_F32),
        ] + [(tlevel.sanitize_sample_rate(r), jlevel.sanitize_sample_rate(r))
             for r in (0.0, -5.0, float("nan"), 44_100.0, 1e9, 0.5)]
    if name == "windows":
        out = []
        for kind in WINDOW_KINDS:
            for n in (1, 2, 64, 256, 2048):
                tw = twindows.window_coefficients(twindows.WindowKind(kind), n)
                jw = jwindows.window_coefficients(jwindows.WindowKind(kind), n)
                out.append((tw, jw))
                out.append((twindows.fft_bin_normalization(tw, n),
                            jwindows.fft_bin_normalization(jw, n)))
            out.append((twindows.WindowKind(kind).cosine_coefficients,
                        jwindows.WindowKind(kind).cosine_coefficients))
        return out
    if name == "channels":
        out = [(tchannels.MAX_AUDIO_CHANNELS, jchannels.MAX_AUDIO_CHANNELS)]
        for c in range(1, 9):
            tp, jp = tchannels.channel_fallback(c), jchannels.channel_fallback(c)
            out.append(([p.value for p in tp], [p.value for p in jp]))
            out.append((tchannels.stereo_matrix(c, tp), jchannels.stereo_matrix(c, jp)))
            out.append((tchannels.channel_weights(tp), jchannels.channel_weights(jp)))
        return out
    if name == "weighting":
        return [(tweighting.k_weighting_sos(r), jweighting.k_weighting_sos(r))
                for r in (8_000.0, 44_100.0, 48_000.0, 96_000.0, 192_000.0)]
    if name == "truepeak":
        return [(ttruepeak.polyphase_taps(f), jtruepeak.polyphase_taps(f)) for f in (4, 2)]
    if name == "lifted":
        sos = jweighting.k_weighting_sos(48_000.0)
        sections = tuple((s[0], s[1], s[2], s[4], s[5]) for s in sos)
        return [(a, b) for lift in (1, 32, 256)
                for a, b in zip(tiir._lifted_mats(sections, lift),
                                jiir._lifted_mats(sections, lift))]
    if name == "spectrum":
        freqs = np.array([-1.0, 0.0, 10.0, 1000.0, 12345.6, 24000.0])
        out = [(tweighting.a_weight_db(freqs), jweighting.a_weight_db(freqs))]
        out += [(tlevel.db_to_power_host(db), jlevel.db_to_power_host(db)) for db in (-100.0, -101.3, 0.0, 6.5)]
        out += [(tlevel.sanitize_negative_db(db, -100.0), jlevel.sanitize_negative_db(db, -100.0))
                for db in (-60.0, 0.0, 3.0, float("nan"), float("-inf"))]
        return out
    if name == "crossover":
        return [(np.array(tiir._crossover_coeffs(rate, splits, n)), np.array(jiir._crossover_coeffs(rate, splits, n)))
                for rate in (44_100.0, 48_000.0, 192_000.0) for splits in ((200.0, 2000.0), (80.0, 30_000.0))
                for n in (1, 2)]
    if name == "sliding":
        out = []
        for kind in ("hann", "blackman_harris"):
            t = tsliding.SlidingSTFT(2048, 64, 256, twindows.WindowKind(kind))
            j = jsliding.SlidingSTFT(2048, 64, 256, jwindows.WindowKind(kind))
            out += list(zip(t._consts(), j._consts()))
            out.append((t._dc_corr_vector(), j._dc_corr_vector()))
        return out
    raise KeyError(name)


@pytest.mark.parametrize(
    "name",
    ["levels", "windows", "channels", "weighting", "truepeak", "lifted", "sliding", "spectrum", "crossover"],
)
def test_constant_helpers_bit_identical(name):
    for ours, ref in _const_pairs(name):
        a, b = np.asarray(ours), np.asarray(ref)
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


# -- levels -----------------------------------------------------------------


def test_power_to_db_matches():
    rng = np.random.default_rng(11)
    p = (10.0 ** rng.uniform(-20, 3, size=4096)).astype(np.float32)
    p[:16] = [0.0, -1.0, 1e-45, 1e-38, np.inf, 1.0, 1e-14, 1e-15] * 2
    for floor in (-140.0, -99.9):
        ours = tlevel.power_to_db(torch.from_numpy(p), floor).numpy()
        ref = np.asarray(jlevel.power_to_db(jnp.asarray(p), floor))
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    # exp2 of arguments up to |46.5| turns their f32 rounding (ulp 3.8e-6)
    # into up to ~3e-6 relative: one ulp of the argument, not of the result
    db = rng.uniform(-140, 20, size=256).astype(np.float32)
    np.testing.assert_allclose(
        tlevel.db_to_power(torch.from_numpy(db)).numpy(),
        np.asarray(jlevel.db_to_power(jnp.asarray(db))), rtol=4e-6,
    )


# -- framing ----------------------------------------------------------------


@pytest.mark.parametrize("read_len,hop,block", [(128, 32, 64), (128, 96, 64)])
def test_frame_buffer_bitwise(read_len, hop, block):
    rng = np.random.default_rng(5)
    lanes = 3
    jfb = jframing.FrameBuffer(read_len, hop, block)
    tfb = tframing.FrameBuffer(read_len, hop, block)
    jc, tc = jfb.init(lanes), tfb.init(lanes)
    steps = 3 * jfb.cap // block + 2  # several ring wraps
    for i in range(steps):
        blk = rng.standard_normal((lanes, block)).astype(np.float32)
        reset = np.array([i == 7, False, i in (3, 11)])
        jc, jinfo = jfb.advance(jc, jnp.asarray(blk), jnp.asarray(reset))
        tc, tinfo = tfb.advance(tc, torch.from_numpy(blk), torch.from_numpy(reset))
        np.testing.assert_array_equal(tc["buf"].numpy(), np.asarray(jc["buf"]))
        for key in ("origin", "avail"):
            assert tc[key] == int(jc[key]), (i, key)
        np.testing.assert_array_equal(tc["fresh"].numpy(), np.asarray(jc["fresh"]))
        for key in ("base", "ready", "avail", "origin_next"):
            assert tinfo[key] == int(jinfo[key]), (i, key)
        np.testing.assert_array_equal(tinfo["valid"].numpy(), np.asarray(jinfo["valid"]))
        np.testing.assert_array_equal(tfb.extract(tinfo).numpy(), np.asarray(jfb.extract(jinfo)))
        for off in (-hop, 0, hop, read_len - hop):
            np.testing.assert_array_equal(
                tfb.slice(tinfo, off, hop).numpy(), np.asarray(jfb.slice(jinfo, off, hop))
            )


# -- K-weighting ------------------------------------------------------------


def _kw_sections(rate=48_000.0):
    sos = jweighting.k_weighting_sos(rate)
    return tuple((float(s[0]), float(s[1]), float(s[2]), float(s[4]), float(s[5])) for s in sos)


def test_lifted_k_weighting_matches():
    """The lifted hop against the JAX package's lifted hop, and against the
    port's sequential scan run in float64 (the exact recurrence; in f32 the
    RLB high-pass's poles near z=1 put the sequential form itself ~1e-5 off)."""
    rng = np.random.default_rng(3)
    sections = _kw_sections()
    lanes = (3, 2)
    jstate = jnp.zeros((4, *lanes), jnp.float32)
    tstate = torch.zeros((4, *lanes))
    sstate = torch.zeros((2, 2, *lanes), dtype=torch.float64)
    for hop in range(4):
        x = (rng.standard_normal((256, *lanes)) * 0.3).astype(np.float32)
        jy, jstate = jiir.lifted_iir_scan(jnp.asarray(x), jstate, sections, lift=256)
        ty, tstate = tiir.lifted_iir_scan(torch.from_numpy(x), tstate, sections, lift=256)
        sy, sstate = tiir.biquad_cascade_scan(
            torch.from_numpy(x).double(), sstate, sections
        )
        jy = np.asarray(jy)
        scale = np.max(np.abs(jy))
        assert np.max(np.abs(ty.numpy() - jy)) <= 1e-5 * scale, hop
        assert np.max(np.abs(ty.numpy() - sy.numpy())) <= 1e-5 * scale, hop
        # each package carries its own state: hops 1-3 hold it to the bound


def test_lifted_remainder_block_matches():
    """100 samples at lift 32: three whole blocks and a 4-sample remainder."""
    rng = np.random.default_rng(4)
    sections = _kw_sections(44_100.0)
    x = rng.standard_normal((100, 5)).astype(np.float32)
    jy, js = jiir.lifted_iir_scan(jnp.asarray(x), jnp.zeros((4, 5)), sections, lift=32)
    ty, ts = tiir.lifted_iir_scan(torch.from_numpy(x), torch.zeros((4, 5)), sections, lift=32)
    sy, ss = tiir.biquad_cascade_scan(
        torch.from_numpy(x).double(), torch.zeros((2, 2, 5), dtype=torch.float64),
        sections,
    )
    jy, ss = np.asarray(jy), torch.cat([ss[0], ss[1]]).numpy()
    assert np.max(np.abs(ty.numpy() - jy)) <= 1e-5 * np.max(np.abs(jy))
    assert np.max(np.abs(ty.numpy() - sy.numpy())) <= 1e-5 * np.max(np.abs(jy))
    # the carried state against the exact recurrence's
    assert np.max(np.abs(ts.numpy() - ss)) <= 1e-5 * np.max(np.abs(ss))


def _rbj_sections(kind, freq: float, sections: int):
    """``(b, a)`` of ``sections`` RBJ biquads at 48 kHz multiplied out into
    one direct form."""
    c = tiir.biquad_rbj(kind, 48_000.0, freq)
    b, a = np.ones(1), np.ones(1)
    for _ in range(sections):
        b, a = np.convolve(b, c[:3]), np.convolve(a, [1.0, *c[3:]])
    return tuple(b.tolist()), tuple(a[1:].tolist())


DF2T_FILTERS = {
    1: ((0.05, 0.0), (-0.95,)),  # one pole at 0.95
    2: _rbj_sections(tiir.FilterKind.LOW_PASS, 8000.0, 1),
    4: _rbj_sections(tiir.FilterKind.LOW_PASS, 8000.0, 2),
}


def _df2t_inputs(order: int, zero_state: bool = False):
    rng = np.random.default_rng(40 + order)
    x = rng.standard_normal((1500, 3, 2)).astype(np.float32)
    state = np.zeros((order, 3, 2), np.float32) if zero_state else (0.1 * rng.standard_normal((order, 3, 2)))
    return x, state.astype(np.float32)


@pytest.mark.parametrize("order", [1, 2, 4])
def test_iir_df2t_scan_matches(order):
    """``iir_df2t_scan`` against the JAX package's on ``[T, 3, 2]`` lanes
    from a non-zero state (order 1: a pole at 0.95; 2 and 4: one and two
    RBJ low-pass sections at 8 kHz multiplied out): output and final state
    within 1e-6 of the output's scale."""
    b, a = DF2T_FILTERS[order]
    x, state = _df2t_inputs(order)
    jy, js = jiir.iir_df2t_scan(jnp.asarray(x), jnp.asarray(state), b, a)
    ty, ts = tiir.iir_df2t_scan(torch.from_numpy(x), torch.from_numpy(state), b, a)
    assert ty.shape == x.shape and ts.shape == state.shape and ty.dtype == torch.float32
    scale = float(np.abs(np.asarray(jy)).max())
    assert float(np.abs(ty.numpy() - np.asarray(jy)).max()) <= 1e-6 * scale
    assert float(np.abs(ts.numpy() - np.asarray(js)).max()) <= 1e-6 * scale
    with pytest.raises(ValueError, match="numerator taps"):
        tiir.iir_df2t_scan(torch.from_numpy(x), torch.from_numpy(state), b[:-1], a)


@pytest.mark.parametrize("case", ["highpass_200hz", "k_weighting"])
def test_iir_df2t_scan_ill_conditioned(case):
    """Poles near z = 1 amplify each package's f32 rounding: from a
    non-zero state the two part by 1.2e-5 of the output's scale (an RBJ
    high-pass at 200 Hz) and 6.7e-3 (BS.1770's K-weighting as one
    fourth-order direct form), and sit 3.4e-5 / 3.8e-5 and 2.5e-2 / 2.6e-2
    (port / JAX) from the same recurrence in float64.  The port is held to
    at most 1.5 times the JAX package's distance from float64, output and
    state; and, from a zero state, to the JAX package's own K-weighting bar:
    mean square within 2e-3 dB of ``tests/golden.py``."""
    if case == "k_weighting":
        bb, aa = jweighting.k_weighting_ba(48_000.0)
        b, a = tuple(bb.tolist()), tuple(aa[1:].tolist())
    else:
        b, a = _rbj_sections(tiir.FilterKind.HIGH_PASS, 200.0, 1)
    x, state = _df2t_inputs(len(a))
    jy, js = jiir.iir_df2t_scan(jnp.asarray(x), jnp.asarray(state), b, a)
    ty, ts = tiir.iir_df2t_scan(torch.from_numpy(x), torch.from_numpy(state), b, a)
    ey, es = tiir.iir_df2t_scan(torch.from_numpy(x).double(), torch.from_numpy(state).double(), b, a)
    for ours, ref, exact in ((ty, jy, ey), (ts, js, es)):
        exact = exact.numpy()
        assert np.abs(ours.numpy() - exact).max() <= 1.5 * np.abs(np.asarray(ref, np.float64) - exact).max()
    if case == "k_weighting":
        import golden

        sig = np.random.default_rng(7).standard_normal(2048).astype(np.float32)
        ref = golden.k_weight(sig, 48_000.0)
        got, _ = tiir.iir_df2t_scan(torch.from_numpy(sig[:, None]), torch.zeros((4, 1)), b, a)
        ms = np.mean(got.numpy()[:, 0].astype(np.float64) ** 2)
        assert abs(10 * np.log10(ms / np.mean(ref**2))) < 2e-3


def test_flush_denormal_state():
    x = np.array([1e-21, -1e-21, 1e-19, 0.0, -2.0], np.float32)
    np.testing.assert_array_equal(
        tiir.flush_denormal_state(torch.from_numpy(x)).numpy(),
        np.asarray(jiir.flush_denormal_state(jnp.asarray(x))),
    )


# -- windowed means and true peak -------------------------------------------


def test_block_windowed_means_matches():
    rng = np.random.default_rng(9)
    b, lanes = 64, (4, 2)
    lengths = (1000, 200, 130, 192)  # ring of 16 blocks wraps in 70 pushes
    jw = jwindowed.BlockWindowedMeans(b, lengths)
    tw = twindowed.BlockWindowedMeans(b, lengths)
    jc, tc = jw.init(lanes), tw.init(lanes)
    jpush, jmeans = jax.jit(jw.push_block), jax.jit(jw.means)
    for i in range(70):  # crosses the exact re-reduction at 32 and 64
        v = (rng.standard_normal((b, *lanes)) ** 2).astype(np.float32)
        if i == 20:
            v[3, 0, 0] = np.nan
        reset = np.zeros(lanes, bool)
        if i == 40:
            reset[1] = True
        jc = jpush(jc, jnp.asarray(v), jnp.asarray(reset))
        tc = tw.push_block(tc, torch.from_numpy(v), torch.from_numpy(reset))
        assert tc["head"] == int(jc["head"])
        assert _rel(tw.means(tc), np.asarray(jmeans(jc))) <= 1e-6, i
        assert _rel(tc["sums"] + tc["comp"], np.asarray(jc["sums"] + jc["comp"])) <= 1e-6, i


@pytest.mark.parametrize("rate", [48_000.0, 96_000.0])
def test_true_peak_matches(rate):
    rng = np.random.default_rng(12)
    lanes = (3, 2)
    jk = jtruepeak.TruePeakKernel(rate)
    tk = ttruepeak.TruePeakKernel(rate)
    jc, tc = jk.init(lanes), tk.init(lanes)
    for i in range(70):
        x = (rng.standard_normal((64, *lanes)) * 0.5).astype(np.float32)
        reset = np.zeros(lanes, bool)
        reset[2] = i == 30
        jc, jp = jk.process_block(jc, jnp.asarray(x), jnp.asarray(reset))
        tc, tp = tk.process_block(tc, torch.from_numpy(x), torch.from_numpy(reset))
        assert _rel(tp, np.asarray(jp)) <= 1e-6, i
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


# -- gating -----------------------------------------------------------------


@pytest.mark.parametrize("rate", [8_000.0, 48_000.0])
def test_gated_loudness_matches(rate):
    """120 hops; at 8 kHz the 3 s short-term blocks close within the run, so
    LRA is live as well as integrated loudness."""
    rng = np.random.default_rng(21)
    s, b = 5, 256
    jg = jgating.GatedLoudness(sample_rate=rate, block_frames=b)
    tg = tgating.GatedLoudness(sample_rate=rate, block_frames=b)
    jc, tc = jg.init(s), tg.init(s)
    jpush = jax.jit(jg.push_block)
    gains = np.array([1.0, 0.1, 1e-4, 0.5, 2.0], np.float32)[:, None]
    lra_seen = 0.0
    for i in range(120):
        env = 1.0 + 0.8 * np.sin(2 * np.pi * i / 37.0 + np.arange(s))[:, None]
        wk2 = (rng.standard_normal((s, b)) ** 2 * gains * env * 0.05).astype(np.float32)
        reset = np.zeros(s, bool)
        reset[3] = i == 50
        jc = jpush(jc, jnp.asarray(wk2), jnp.asarray(reset))
        tc = tg.push_block(tc, torch.from_numpy(wk2), torch.from_numpy(reset))
        assert tc["chunk_pos"] == int(jc["chunk_pos"]) and tc["ring_idx"] == int(jc["ring_idx"])
        for key in ("integrated", "lra"):
            d = np.max(np.abs(tc[key].numpy() - np.asarray(jc[key])))
            assert d <= 0.01, (i, key, d)
        lra_seen = max(lra_seen, float(tc["lra"].max()))
        np.testing.assert_array_equal(tc["hist_m_n"].numpy(), np.asarray(jc["hist_m_n"]))
    assert float(tc["integrated"].max()) > -70.0
    if rate == 8_000.0:
        assert lra_seen > 0.0
