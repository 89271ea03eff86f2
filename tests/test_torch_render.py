"""The port's renderer (``render.py``) and live render consumer
(``render_live.py``) against the JAX package's, on the CPU.

Where both packages draw from the same numpy inputs (the rasterizers, a
snapshot series converted to numpy, a server's drained meters and host
histories replayed into both consumers) the images and PNG bytes are
identical.  Where each package computes its own meters (``analyze``, the
CLI's ``render``, a ``MeterServer`` each), the images are held to the pixel
bar of ``openmeters_tpu_torch/utils/parity.py``.
"""

import collections
import contextlib
import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_pairs import to_jax, unaligned  # noqa: E402

import openmeters_tpu.render as jrender  # noqa: E402
import openmeters_tpu.render_live as jlive  # noqa: E402
import openmeters_tpu.themes as jthemes  # noqa: E402
import openmeters_tpu.views as jviews  # noqa: E402
import openmeters_tpu_torch.render as trender  # noqa: E402
import openmeters_tpu_torch.render_live as tlive  # noqa: E402
import openmeters_tpu_torch.themes as tthemes  # noqa: E402
import openmeters_tpu_torch.views as tviews  # noqa: E402
from openmeters_tpu import serve as jserve  # noqa: E402
from openmeters_tpu_torch.analyzers.oscilloscope import OscilloscopeConfig  # noqa: E402
from openmeters_tpu_torch.analyzers.spectrogram import SpectrogramConfig  # noqa: E402
from openmeters_tpu_torch.analyzers.spectrum import SpectrumConfig  # noqa: E402
from openmeters_tpu_torch.analyzers.stereometer import StereometerConfig  # noqa: E402
from openmeters_tpu_torch.analyzers.waveform import WaveformConfig  # noqa: E402
from openmeters_tpu_torch.engine import EngineConfig  # noqa: E402
from openmeters_tpu_torch.serve import MeterServer, ServeConfig  # noqa: E402
from openmeters_tpu_torch.utils.frequency import FrequencyScale  # noqa: E402
from openmeters_tpu_torch.utils.parity import SPLAT_FLOOR_DB, check_image, image_errors  # noqa: E402

PACKAGES = {"jax": (jrender, jviews), "torch": (trender, tviews)}
Osc = collections.namedtuple("Osc", "samples trace_valid span start frac period locked")


def canvas_out(cv) -> list:
    return [cv.buf, cv.to_srgb_u8()]


# -- the rasterizers on the same numpy inputs: tests/test_render.py's cases ---------


def case_png(R, V):
    rng = np.random.default_rng(7)
    out = []
    for ch in (3, 4):
        img = rng.integers(0, 256, size=(13, 17, ch), dtype=np.uint8)
        data = R.encode_png(img)
        out += [np.frombuffer(data, np.uint8), R.decode_png(data)]
    return out


def case_shade_db(R, V):
    grid = np.linspace(-150.0, 10.0, 64, dtype=np.float32).reshape(8, 8)
    return [R.shade_db(np.float32(db), -140.0, V.HEAT_RAMP) for db in (-140.0, 0.0, -70.0)] + [
        R.shade_db(grid, -100.0, V.HEAT_RAMP)
    ]


def case_canvas_quad(R, V):
    cv = R.Canvas(8, 8, background=(0, 0, 0, 1))
    cv.gradient_quad(2, 2, 6, 6, (1, 0, 0, 1))
    first = cv.to_srgb_u8()
    cv.gradient_quad(2, 2, 6, 6, (0, 0, 1, 0.5))
    cv.gradient_quad(0.5, 1.25, 7.5, 6.75, (0, 1, 0, 0.3), (1, 1, 0, 0.8))
    return [first, *canvas_out(cv)]


def case_canvas_lines(R, V):
    out = []
    for y in (16.5, 16.0):
        cv = R.Canvas(32, 32)
        cv.polyline([(4, y), (28, y)], (1, 1, 1, 1), width=1.0)
        out += canvas_out(cv)
    cv = R.Canvas(40, 30)
    cv.polyline([(2, 3), (20, 27.5), (37, 4), (np.nan, 5)], (0.2, 0.9, 1, 0.8), width=2.5,
                color_end=(1, 0.2, 0.1, 1))
    cv.dots([(5.5, 5.5), (30.2, 20.7), (-3, -3)], 2.5, (1, 1, 1, 0.7))
    cv.baseline_fill([2, 10, 25, 38], [5, 20, 12, 28], 15.0, (0.3, 0.9, 1, 0.2), (1, 0, 0, 0.4))
    return out + canvas_out(cv)


def case_classic_spectrogram(R, V):
    rate, fft = 48_000.0, 2048
    db = np.full((8, fft // 2 + 1), -140.0, np.float32)
    db[:, 100] = 0.0
    db[3:, 400] = -40.0
    flat = np.full((4, fft // 2 + 1), -60.0, np.float32)
    kw = dict(sample_rate=rate, fft_size=fft)
    return [
        R.render_spectrogram_classic(db, width=64, height=256, **kw),
        R.render_spectrogram_classic(flat, width=32, height=128, **kw),
        R.render_spectrogram_classic(flat, width=32, height=128, tilt_db=3.0, **kw),
        R.render_spectrogram_classic(db, width=50, height=90, uv_y_range=(0.2, 0.7), floor_db=-100.0,
                                     palette=V.GradientPalette.make([[0, 0, 0, 0], [1, 0, 0, 1]]), **kw),
    ]


def case_reassigned_spectrogram(R, V):
    rng = np.random.default_rng(11)
    n = 400
    freq = np.exp(rng.uniform(np.log(10.0), np.log(22_000.0), n)).astype(np.float32)
    t = rng.uniform(-2.0, 18.0, n).astype(np.float32)
    p = (10.0 ** rng.uniform(-14, 0, n)).astype(np.float32)
    ok = rng.random(n) < 0.9
    one = R.render_spectrogram_reassigned(np.array([1000.0], np.float32), np.zeros(1, np.float32),
                                          np.ones(1, np.float32), np.array([True]), width=16, height=64)
    return [one,
            R.render_spectrogram_reassigned(freq, t, p, ok, width=16, height=64, power_scale=0.5),
            R.render_spectrogram_reassigned(freq, t, p, ok, width=24, height=48, tilt_db=4.5)]


def case_spectrum_frame(R, V):
    bins = np.arange(1025, dtype=np.float32) * 48_000.0 / 2048
    db = np.full(1025, -90.0, np.float32)
    db[40:46] = [-30.0, -12.0, -3.0, -6.0, -20.0, -40.0]
    scale = FrequencyScale.LOGARITHMIC
    pts, valid = V.spectrum_points(db, bins, scale, floor_db=-96.0)
    peak = V.SpectrumPeakLabel(floor_db=-96.0)
    peak.update(bins, db, scale)
    cv = R.Canvas(120, 80)
    R.render_spectrum_frame(cv, pts, valid, ticks=V.spectrum_grid_ticks(20.0, float(bins[-1]), scale),
                            peak_marker=peak.marker_pos if peak.content else None, peak_opacity=peak.opacity)
    cv2 = R.Canvas(64, 48)
    line = np.stack([np.linspace(0, 1, 32), np.full(32, 0.5, np.float32)], axis=-1).astype(np.float32)
    R.render_spectrum_frame(cv2, line, np.ones(32, bool))
    return canvas_out(cv) + canvas_out(cv2)


def case_stereometer_frame(R, V):
    rng = np.random.default_rng(3)
    xy = rng.normal(0, 0.8, size=(128, 2)).astype(np.float32)
    out = []
    for compress in (True, False):
        cv = R.Canvas(64, 64)
        R.render_stereometer_frame(cv, xy, rng.random(128) < 0.8, compress=compress)
        out += canvas_out(cv)
    return out


def case_waveform_frame(R, V):
    cols = [
        {"min": np.float32(-1.0), "max": np.float32(1.0), "color": (1, 0, 0)},
        {"min": np.float32(-0.1), "max": np.float32(0.1), "color": (0, 1, 0)},
        {"min": np.array([-0.4, -0.2], np.float32), "max": np.array([0.3, 0.5], np.float32),
         "color": np.array([[0.2, 0.4, 0.9], [0.9, 0.4, 0.2]], np.float32)},
        {"min": np.float32(-0.6), "max": np.float32(0.2)},
    ]
    cv = R.Canvas(8, 64)
    R.render_waveform_frame(cv, cols)
    return canvas_out(cv)


def case_loudness_frame(R, V):
    out = []
    for db, tp in ((-40.0, -38.0), (-12.0, -10.0), (-70.0, float("inf"))):
        cv = R.Canvas(240, 120)
        R.render_loudness_frame(cv, momentary_lufs=db, short_term_lufs=db + 1.5, integrated_lufs=db - 2.0,
                                true_peak_db=tp)
        out += canvas_out(cv)
    return out


def case_oscilloscope_frame(R, V):
    n = 400
    wave = np.sin(np.linspace(0, 6 * np.pi, n)).astype(np.float32)
    snap = Osc(
        samples=np.stack([wave, 0.5 * np.cos(np.linspace(0, 9 * np.pi, n)).astype(np.float32)])[None],
        trace_valid=np.array([[True, True]]),
        span=np.array([[n - 2.0, n - 40.0]], np.float32),
        start=np.zeros((1, 2), np.int32),
        frac=np.array([[0.0, 0.37]], np.float32),
        period=np.zeros((1, 2), np.float32),
        locked=np.zeros((1, 2), bool),
    )
    out = []
    for stacked in (True, False):
        cv = R.Canvas(128, 96)
        R.render_oscilloscope_frame(cv, snap, stacked=stacked)
        out += canvas_out(cv)
    return out


def case_compose_rgba(R, V):
    rgba = np.zeros((2, 2, 4), np.float32)
    rgba[0, 0] = [0.5, 0.0, 0.0, 0.5]
    rgba[1, 0] = [0.1, 0.7, 0.2, 0.9]
    return [R.compose_rgba(rgba, background=(0.0, 0.0, 1.0, 1.0)), R.compose_rgba(rgba)]


def case_correlation_meter(R, V):
    tr = V.CorrelationTrail()
    for i in range(V.CORR_TRAIL_LEN + 5):
        tr.push_front(np.sin(i / 3.0))
    alpha, marker = V.correlation_trail_alpha(tr, 100, edge=6.0)
    cv = R.Canvas(32, 100)
    R.render_correlation_meter(cv, tr, x0=24.0, x1=30.0)
    return [np.asarray(tr.values), tr.segment_opacities(), alpha, np.float32(marker), *canvas_out(cv)]


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rasterizer_identical_to_jax(case):
    """Each rasterizer of the JAX package's tests/test_render.py, given the
    same numpy inputs in both packages: identical arrays, and for the u8
    frames identical PNG bytes."""
    jout, tout = (CASES[case](*PACKAGES[p]) for p in ("jax", "torch"))
    assert len(jout) == len(tout) > 0
    for a, b in zip(jout, tout):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        if b.dtype == np.uint8 and b.ndim == 3:
            assert jrender.encode_png(a) == trender.encode_png(b)


# -- render_series ----------------------------------------------------------------


def series_config(reassigned: bool) -> EngineConfig:
    """tests/test_render.py's end-to-end config: all six analyzers at 8 kHz."""
    return EngineConfig.at_rate(8_000.0, spectrogram=SpectrogramConfig(fft_size=256, hop_size=64,
                                                                       use_reassignment=reassigned))


def series_audio(rate: float = 8_000.0, seconds: float = 1.0) -> np.ndarray:
    """Two tones over a noise floor 40 dB down (see PIXEL_SHARE in
    ``utils/parity.py``: a pane drawn from no noise floor shows the
    transforms' rounding, which no bar holds)."""
    t = np.arange(int(rate * seconds)) / rate
    tone = 0.5 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * np.sin(2 * np.pi * 1900.0 * t)
    tone += 0.01 * np.random.default_rng(8).standard_normal(t.shape)
    return np.stack([tone, 0.7 * tone], -1).astype(np.float32)


def port_types(series: list) -> list:
    """A series of the JAX package's snapshot types as the port's, by name."""
    from openmeters_tpu_torch.utils.parity import _snapshot_classes

    classes = {c.__name__: c for group in _snapshot_classes().values() for c in group}
    return [{k: classes[type(v).__name__](*v) for k, v in hop.items()} for hop in series]


def read_pngs(paths) -> dict:
    return {os.path.basename(p): open(p, "rb").read() for p in paths}


@pytest.fixture(scope="module", params=[False, True], ids=["classic", "reassigned"])
def analyzed(request):
    """One recording analyzed by both packages: ``(config, jax series, port
    series)``, the JAX package's as numpy, the port's as CPU tensors."""
    from openmeters_tpu.api import analyze as janalyze
    from openmeters_tpu_torch.api import analyze as tanalyze

    cfg = series_config(request.param)
    audio = series_audio()
    jseries = [{k: type(v)(*(np.asarray(x) for x in v)) for k, v in hop.items()}
               for hop in janalyze(audio, 8_000.0, to_jax(cfg))]
    return cfg, jseries, tanalyze(audio, 8_000.0, cfg, device="cpu")


def test_render_series_identical_on_jax_snapshots(analyzed, tmp_path):
    """The JAX package's snapshot series, as numpy, rendered by both
    packages: the same panes, byte-identical PNGs."""
    cfg, jseries, _ = analyzed
    jout = read_pngs(jrender.render_series(jseries, to_jax(cfg), tmp_path / "jax", width=120, height=80))
    tout = read_pngs(trender.render_series(port_types(jseries), cfg, tmp_path / "torch", width=120, height=80))
    assert set(jout) == {f"{n}.png" for n in jthemes.VISUALS}
    assert jout == tout


def test_render_series_tensors_equal_numpy(analyzed, tmp_path):
    """The port's series as tensors and converted to numpy render the same
    bytes (``host_series`` moves what is read in one copy)."""
    cfg, _, tseries = analyzed
    as_numpy = [{k: type(v)(*(x.numpy() for x in v)) for k, v in hop.items()} for hop in tseries]
    a = read_pngs(trender.render_series(tseries, cfg, tmp_path / "tensors", width=120, height=80))
    b = read_pngs(trender.render_series(as_numpy, cfg, tmp_path / "numpy", width=120, height=80))
    assert a == b and len(a) == 6


def test_render_series_within_pixel_bar_of_jax(analyzed, tmp_path, record_property):
    """Each package's own analysis of one recording, rendered: every pane
    within the pixel bar (the end-to-end case of tests/test_render.py)."""
    cfg, jseries, tseries = analyzed
    jout = read_pngs(jrender.render_series(jseries, to_jax(cfg), tmp_path / "jax", width=120, height=80))
    tout = read_pngs(trender.render_series(tseries, cfg, tmp_path / "torch", width=120, height=80))
    assert set(jout) == set(tout)
    for name in jout:
        err = image_errors(trender.decode_png(tout[name]), jrender.decode_png(jout[name]))
        record_property(f"{name}_off_share", err["off_share"])
        check_image(err, name)
        assert trender.decode_png(tout[name]).max() > 0


def splats_above(series: list, floor_db: float) -> list:
    """A numpy series with the reassigned points below ``floor_db`` of
    their column's peak power left out (``point_valid`` cleared)."""
    out = []
    for hop in series:
        sg = hop["spectrogram"]
        peak = sg.power.max(axis=-1, keepdims=True)
        out.append({**hop, "spectrogram": sg._replace(
            point_valid=sg.point_valid & (sg.power >= peak * np.float32(10.0 ** (floor_db / 10.0))))})
    return out


@pytest.mark.parametrize("reassigned", [False, True], ids=["classic", "reassigned"])
def test_render_series_pure_tone_within_pixel_bar_of_jax(reassigned, tmp_path, record_property):
    """tests/test_render.py's end-to-end audio, a pure 440 Hz tone at 8
    kHz, analyzed by each package and rendered: every pane within the pixel
    bar.  The reassigned pane is held with the points below SPLAT_FLOOR_DB
    of their column's peak left out of both series (below it the splats
    draw the transforms' rounding, ``utils/parity.py``); its reading
    without the mask is recorded."""
    from openmeters_tpu.api import analyze as janalyze
    from openmeters_tpu_torch.api import analyze as tanalyze

    cfg = series_config(reassigned)
    t = np.arange(8_000) / 8_000.0
    tone = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    audio = np.stack([tone, tone], -1)
    jseries = [{k: type(v)(*(np.asarray(x) for x in v)) for k, v in hop.items()}
               for hop in janalyze(audio, 8_000.0, to_jax(cfg))]
    tseries = [{k: type(v)(*(x.numpy() for x in v)) for k, v in hop.items()}
               for hop in tanalyze(audio, 8_000.0, cfg, device="cpu")]

    def render(series, name):
        jout = read_pngs(jrender.render_series(series[0], to_jax(cfg), tmp_path / name / "jax", width=120, height=80))
        tout = read_pngs(trender.render_series(series[1], cfg, tmp_path / name / "torch", width=120, height=80))
        assert set(jout) == set(tout) == {f"{n}.png" for n in jthemes.VISUALS}
        assert all(trender.decode_png(png).max() > 0 for png in tout.values())
        return {n: image_errors(trender.decode_png(tout[n]), jrender.decode_png(jout[n])) for n in jout}

    errs = render((jseries, tseries), "all")
    if reassigned:
        record_property("spectrogram.png_unmasked_off_share", errs["spectrogram.png"]["off_share"])
        masked = render((splats_above(jseries, SPLAT_FLOOR_DB), splats_above(tseries, SPLAT_FLOOR_DB)), "masked")
        errs["spectrogram.png"] = masked["spectrogram.png"]
    for name, err in errs.items():
        record_property(f"{name}_off_share", err["off_share"])
        check_image(err, name)


def test_host_series_moves_only_what_is_read():
    """``host_series``: one stream, a leading axis of 1, the fields the
    renderer does not read left ``None``, and the last hop's instantaneous
    fields only on the last hop."""
    from openmeters_tpu_torch.api import analyze

    cfg = series_config(False)
    series = analyze(np.stack([series_audio(), series_audio()[:, ::-1]]), 8_000.0, cfg, device="cpu")
    host = trender.host_series(series, stream=1)
    assert len(host) == len(series)
    last, first = host[-1], host[0]
    np.testing.assert_array_equal(last["loudness"].momentary_lufs, series[-1]["loudness"].momentary_lufs[1:2].numpy())
    assert last["loudness"].lra_lu is None and first["loudness"].momentary_lufs is None
    for i in (0, len(series) // 2, len(series) - 1):
        np.testing.assert_array_equal(host[i]["spectrogram"].codes, series[i]["spectrogram"].codes[1:2].numpy())
        np.testing.assert_array_equal(host[i]["waveform"].col_color, series[i]["waveform"].col_color[1:2].numpy())
    assert last["waveform"].preview_min is None
    assert last["oscilloscope"].samples.shape == (1, *series[-1]["oscilloscope"].samples.shape[1:])


# -- the CLI's render, end to end ------------------------------------------------------


@pytest.mark.parametrize("reassigned", [False, True], ids=["classic", "reassigned"])
def test_cli_render_within_pixel_bar_of_jax(tmp_path, reassigned, record_property):
    """``render`` through both CLIs' ``main()`` on a 0.4 s stereo WAV at 48
    kHz (loudness plus a 1024/256 spectrogram): the same panes, each within
    the pixel bar; the port on the CPU."""
    from openmeters_tpu.__main__ import main as jmain
    from openmeters_tpu_torch.__main__ import main as tmain
    from openmeters_tpu_torch.io.wav import write_wav
    from openmeters_tpu_torch.persistence import encode_settings, write_json_atomic

    rng = np.random.default_rng(5)
    t = np.arange(int(0.4 * 48_000)) / 48_000.0
    left = 0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.1 * np.sin(2 * np.pi * 1700.0 * t)
    left += 0.01 * rng.standard_normal(t.shape)
    wav, settings = str(tmp_path / "in.wav"), str(tmp_path / "s.json")
    write_wav(wav, np.stack([left, 0.6 * left], -1).astype(np.float32), 48_000.0)
    cfg = EngineConfig(spectrogram=SpectrogramConfig(fft_size=1024, hop_size=256, use_reassignment=reassigned),
                       spectrum=None, oscilloscope=None, stereometer=None, waveform=None)
    write_json_atomic(settings, encode_settings(cfg))
    out = {}
    for name, main, extra in (("jax", jmain, []), ("torch", tmain, ["--device", "cpu"])):
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            assert main(["render", wav, str(tmp_path / name), "--settings", settings, *extra]) == 0
        out[name] = read_pngs(buf.getvalue().split())
    assert set(out["jax"]) == set(out["torch"]) == {"loudness.png", "spectrogram.png"}
    for name in out["jax"]:
        err = image_errors(trender.decode_png(out["torch"][name]), jrender.decode_png(out["jax"][name]))
        record_property(f"{name}_off_share", err["off_share"])
        check_image(err, name)


# -- the live render consumer: tests/test_render_live.py's cases -----------------------

RATE, BLOCK = 8_000.0, 64
PANE_SIZES = {"stereometer": (64, 64), "loudness": (64, 240)}


def live_engine(reassigned: bool, all_six: bool = True) -> EngineConfig:
    kw = dict(sample_rate=RATE, block_frames=BLOCK, channels=2,
              spectrogram=SpectrogramConfig(fft_size=128, hop_size=32, use_reassignment=reassigned))
    if all_six:
        kw.update(spectrum=SpectrumConfig(fft_size=128, hop_size=128), oscilloscope=OscilloscopeConfig(),
                  stereometer=StereometerConfig(), waveform=WaveformConfig(track_history=True))
    else:
        kw.update(spectrum=None, oscilloscope=None, stereometer=None, waveform=None)
    return EngineConfig(**kw)


def live_pair(engine: EngineConfig, fetch: str, streams: int = 2):
    cfg = ServeConfig(n_streams=streams, channels=2, engine=engine, realtime=False, fetch=fetch, fetch_every=1,
                      coalesce_blocks=1)
    jax_server = jserve.MeterServer(to_jax(cfg))
    # see tests/test_torch_serve.py::pair: the JAX server's host buffers off
    # the alignment at which jax.device_put aliases them
    jax_server._buffers = [tuple(unaligned(a) for a in bufs) for bufs in jax_server._buffers]
    return jax_server, MeterServer(cfg, device="cpu")


def run_live(servers, renderers, n_blocks: int = 48) -> None:
    t = np.arange(0, n_blocks * BLOCK, dtype=np.float64) / RATE
    noise = 0.01 * np.random.default_rng(9).standard_normal(t.shape)  # a floor 40 dB down, as series_audio
    x = (0.5 * np.sin(2.0 * np.pi * 440.0 * t) + noise).astype(np.float32)
    stereo = np.stack([x, 0.5 * x], axis=-1)
    for i in range(n_blocks):
        blk = np.ascontiguousarray(stereo[i * BLOCK : (i + 1) * BLOCK])
        for srv in servers:
            for st in range(srv.config.n_streams):
                srv.transport.push_pcm(st, blk, int(i * BLOCK / RATE * 1e9))
            srv.advance()
    for srv in servers:
        while srv._inflight:
            srv._drain_one()
    for r in renderers:
        r.render()


def compare_live(out: dict, panes, record_property=None) -> dict:
    """Each pane written by both consumers, of the reference's size, within
    the pixel bar; returns the decoded port images."""
    images = {}
    for name in panes:
        paths = {k: os.path.join(d, f"{name}.png") for k, d in out.items()}
        assert all(os.path.exists(p) for p in paths.values()), f"{name} never rendered"
        assert not os.path.exists(paths["torch"] + ".tmp")
        j, t = (trender.decode_png(open(paths[k], "rb").read()) for k in ("jax", "torch"))
        err = image_errors(t, j)
        if record_property is not None:
            record_property(f"{name}_off_share", err["off_share"])
        check_image(err, name)
        images[name] = t
    return images


@pytest.mark.parametrize("case", ["classic_all_panes", "reassigned_splat", "meters_mode"])
def test_live_consumer_within_pixel_bar_of_jax(tmp_path, case, record_property):
    """A consumer on each package's server, the same pushed PCM: every pane
    the JAX consumer writes, the port's writes too, of the same size and
    within the pixel bar.  Meter mode composes with an existing drain
    callback and draws the packed-leaf panes only."""
    reassigned = case == "reassigned_splat"
    fetch = "meters" if case == "meters_mode" else "full"
    servers = live_pair(live_engine(reassigned, all_six=not reassigned), fetch)
    seen = {k: [] for k in ("jax", "torch")}
    if fetch == "meters":
        for k, srv in zip(seen, servers):
            srv.on_drain = lambda s, k=k: seen[k].append(s.stats.hops)
    width, height = (64, 48) if reassigned or fetch == "meters" else (96, 64)
    out = {k: str(tmp_path / k) for k in ("jax", "torch")}
    try:
        renderers = [pkg.attach_render_consumer(srv, out[k], every=0.0, width=width, height=height)
                     for pkg, k, srv in ((jlive, "jax", servers[0]), (tlive, "torch", servers[1]))]
        if fetch == "full" and not reassigned:
            assert servers[1]._view_histories["spectrogram"].columns == width
        run_live(servers, renderers, n_blocks=24 if fetch == "meters" else 48)
    finally:
        for srv in servers:
            srv.close()
    written = {k: sorted(f for f in os.listdir(d) if f.endswith(".png")) for k, d in out.items()}
    assert written["jax"] == written["torch"]
    assert renderers[1].frames == renderers[0].frames >= 2
    images = compare_live(out, [f[:-4] for f in written["jax"]], record_property)
    if fetch == "meters":
        assert set(images) == {"loudness", "stereometer", "spectrum", "oscilloscope"}
        assert seen["torch"] and len(seen["torch"]) == len(seen["jax"])
        assert len(renderers[1]._trail.values) == len(renderers[0]._trail.values) > 0
    elif reassigned:
        assert set(images) == {"loudness", "spectrogram"}
        assert renderers[1]._reassigned.shape == (64, 48) and renderers[1]._reassigned.max() > 0
    else:
        assert set(images) == set(jthemes.VISUALS)
        for name, img in images.items():
            assert img.shape[:2] == PANE_SIZES.get(name, (64, 96))


def test_live_consumer_theme_within_pixel_bar_of_jax(tmp_path):
    """A red spectrogram ramp and spectrum stroke (each package's own
    ``Theme``): the port's panes within the pixel bar of the JAX package's,
    and red where they have content."""
    red = [[0, 0, 0, 0], [1.0, 0.0, 0.0, 1.0]]
    themes = {k: pkg.Theme("red", palettes={v: views.GradientPalette.make(red) for v in ("spectrogram", "spectrum")})
              for k, pkg, views in (("jax", jthemes, jviews), ("torch", tthemes, tviews))}
    servers = live_pair(live_engine(False), "full", streams=1)
    out = {k: str(tmp_path / k) for k in ("jax", "torch")}
    try:
        renderers = [pkg.attach_render_consumer(srv, out[k], every=0.0, width=64, height=48, theme=themes[k])
                     for pkg, k, srv in ((jlive, "jax", servers[0]), (tlive, "torch", servers[1]))]
        run_live(servers, renderers, n_blocks=24)
    finally:
        for srv in servers:
            srv.close()
    images = compare_live(out, ("spectrogram", "spectrum"))
    for img in images.values():
        img = img.astype(np.int32)
        lit = img[..., :3].max(-1) > 8
        assert lit.any() and (img[..., 0][lit] >= img[..., 1][lit]).all()


class Replay:
    """A server as a consumer reads it, holding another server's host
    state: its engine and histories, a drained fetch set by the caller, its
    spectrum and traces fetched once (numpy)."""

    def __init__(self, src):
        self.engine, self.config = src.engine, src.config
        self._view_histories = src._view_histories
        self.meters = None
        self.spectrum = type(s := src.fetch_spectrum())(*(np.asarray(x) for x in s))
        self.traces = type(o := src.fetch_osc_traces())(*(np.asarray(x) for x in o))

    def declare_view(self, **kw):
        return {}

    def last_meters(self):
        return self.meters

    @staticmethod
    def _rows(snap, stream):
        return snap if stream is None else type(snap)(*(x[stream : stream + 1] for x in snap))

    def fetch_spectrum(self, stream=None):
        return self._rows(self.spectrum, stream)

    def fetch_osc_traces(self, stream=None):
        return self._rows(self.traces, stream)


@pytest.mark.parametrize("reassigned", [False, True], ids=["classic", "reassigned"])
def test_live_consumer_identical_on_replayed_state(tmp_path, reassigned):
    """The JAX server's every drained fetch, then its histories, spectrum
    and traces, replayed into both packages' consumers (stream 1): every
    pane byte-identical."""
    engine = live_engine(reassigned)
    cfg = ServeConfig(n_streams=2, channels=2, engine=engine, realtime=False, fetch="full", fetch_every=1,
                      coalesce_blocks=1)
    src = jserve.MeterServer(to_jax(cfg))
    src._buffers = [tuple(unaligned(a) for a in bufs) for bufs in src._buffers]
    drains = []
    src.on_drain = lambda s: drains.append({k: np.array(v) for k, v in s.last_meters().items()})
    jlive.LiveRenderer(src, str(tmp_path / "declare"), stream=1, width=80, height=60)  # declares the rings
    try:
        run_live([src], [], n_blocks=40)
        stubs = {k: Replay(src) for k in ("jax", "torch")}
    finally:
        src.close()
    out = {}
    for k, pkg in (("jax", jlive), ("torch", tlive)):
        r = pkg.LiveRenderer(stubs[k], str(tmp_path / k), stream=1, width=80, height=60)
        for meters in drains:
            stubs[k].meters = meters
            r.feed(stubs[k])
        out[k] = read_pngs(r.render())
    assert len(drains) > 10
    assert set(out["jax"]) == {f"{n}.png" for n in jthemes.VISUALS}
    assert out["jax"] == out["torch"]
