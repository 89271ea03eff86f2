"""PyTorch port, the host layers: ``utils/frequency.py``,
``utils/musical.py``, ``io/wav.py``, the spectrogram's history helpers,
``views.py``, ``persistence.py`` and ``ingest/backoff.py`` /
``ingest/directory.py`` against the JAX package's, on the same inputs made
from a numpy seed.  These are numpy code in both packages, so outputs are
held equal (bit for bit where the arithmetic is the same)."""

import dataclasses
import enum
import json
import logging
import struct
import time

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from torch_pairs import to_jax  # noqa: E402

from openmeters_tpu import persistence as jpers  # noqa: E402
from openmeters_tpu import views as jviews  # noqa: E402
from openmeters_tpu.analyzers import spectrogram as jsg  # noqa: E402
from openmeters_tpu.ingest import backoff as jbackoff  # noqa: E402
from openmeters_tpu.ingest import directory as jdirectory  # noqa: E402
from openmeters_tpu.io import wav as jwav  # noqa: E402
from openmeters_tpu.utils import frequency as jfreq  # noqa: E402
from openmeters_tpu.utils import musical as jmusical  # noqa: E402
from openmeters_tpu_torch import persistence as tpers  # noqa: E402
from openmeters_tpu_torch import views as tviews  # noqa: E402
from openmeters_tpu_torch.analyzers import spectrogram as tsg  # noqa: E402
from openmeters_tpu_torch.analyzers.oscilloscope import OscilloscopeConfig, TriggerMode  # noqa: E402
from openmeters_tpu_torch.analyzers.spectrum import AveragingMode, SpectrumConfig  # noqa: E402
from openmeters_tpu_torch.engine import EngineConfig  # noqa: E402
from openmeters_tpu_torch.ingest import backoff as tbackoff  # noqa: E402
from openmeters_tpu_torch.ingest import directory as tdirectory  # noqa: E402
from openmeters_tpu_torch.io import wav as twav  # noqa: E402
from openmeters_tpu_torch.utils import frequency as tfreq  # noqa: E402
from openmeters_tpu_torch.utils import musical as tmusical  # noqa: E402
from openmeters_tpu_torch.utils.channels import Channel  # noqa: E402
from openmeters_tpu_torch.utils.windows import WindowKind  # noqa: E402

SEED = 97
# (views module, its FrequencyScale) of each package
SIDES = ((jviews, jfreq.FrequencyScale), (tviews, tfreq.FrequencyScale))


def assert_same(a, b, path="out"):
    """Equal outputs across the packages: arrays equal in dtype, shape and
    value (NaN where NaN); dataclasses, enums and named tuples by class
    name and fields; containers element by element."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"), path
    elif isinstance(a, enum.Enum):
        assert type(a).__name__ == type(b).__name__ and a.value == b.value, path
    elif dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), (path, a.keys(), b.keys())
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a).__name__ == type(b).__name__ and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float) and np.isnan(a):
        assert np.isnan(b), path
    elif hasattr(a, "__dict__") and not isinstance(a, (int, float, str, bool)):
        assert type(a).__name__ == type(b).__name__, path
        assert_same(vars(a), vars(b), path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


# -- utils/frequency.py, utils/musical.py ------------------------------------------


@pytest.mark.parametrize("scale", ["linear", "logarithmic", "erb"])
def test_frequency_scale_matches(scale):
    rng = np.random.default_rng(SEED)
    hz = np.concatenate([[0.0, 20.0, 24_000.0], rng.uniform(0.0, 96_000.0, 257)]).astype(np.float32)
    t = rng.uniform(0.0, 1.0, 129)
    outs = []
    for fs in (jfreq.FrequencyScale, tfreq.FrequencyScale):
        s = fs(scale)
        outs.append([s.scale(hz), s.unscale(s.scale(hz)), s.freq_at(20.0, 20_000.0, t),
                     s.pos_of(20.0, 20_000.0, hz), s.pos_of(50.0, 50.0, hz)])
    assert_same(*outs)


def test_musical_notes_match():
    rng = np.random.default_rng(SEED)
    freqs = [0.0, -3.0, float("nan"), float("inf"), 1e-30, 16.35, 440.0, 997.0, 27.5, 4186.0]
    freqs += list(rng.uniform(10.0, 20_000.0, 200))
    outs = []
    for m in (jmusical, tmusical):
        rows = []
        for f in freqs:
            note, info = m.MusicalNote.from_frequency(f), m.NoteInfo.from_frequency(f)
            rows.append(None if note is None else (note.midi_number, note.name, note.octave, str(note),
                                                   note.is_black, note.to_frequency()))
            rows.append(None if info is None else (info.cents, info.fmt_note_cents()))
        outs.append(rows)
    assert outs[0] == outs[1]


# -- io/wav.py ----------------------------------------------------------------------


def _pcm_file(path, x: np.ndarray, rate: int, fmt: str) -> None:
    """``x [frames, channels]`` in [-1, 1) as a PCM (16/24/32-bit) or an
    extensible float32 WAV."""
    frames, channels = x.shape
    if fmt == "pcm16":
        data, bits, tag = np.round(x * 32767).astype("<i2").tobytes(), 16, 1
    elif fmt == "pcm32":
        data, bits, tag = np.round(x * 2**31 * 0.999).astype("<i4").tobytes(), 32, 1
    elif fmt == "pcm24":
        v = np.round(x * (2**23 - 1)).astype(np.int32).reshape(-1)
        data = np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF], -1).astype(np.uint8).tobytes()
        bits, tag = 24, 1
    else:
        data, bits, tag = x.astype("<f4").tobytes(), 32, 0xFFFE
    align = channels * bits // 8
    fmt_chunk = struct.pack("<HHIIHH", tag, channels, rate, rate * align, align, bits)
    if tag == 0xFFFE:
        fmt_chunk += struct.pack("<HHI", 22, bits, 0x3) + struct.pack("<H", 3) + bytes(14)
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 4 + 8 + len(fmt_chunk) + 8 + len(data), b"WAVE"))
        f.write(struct.pack("<4sI", b"fmt ", len(fmt_chunk)) + fmt_chunk)
        f.write(struct.pack("<4sI", b"data", len(data)) + data)


@pytest.mark.parametrize("fmt", ["float32", "pcm16", "pcm24", "pcm32", "extensible"])
def test_wav_matches(tmp_path, fmt):
    """The port's file read back by both packages, and files of every
    supported format read alike by both."""
    rng = np.random.default_rng(SEED)
    x = rng.uniform(-1.0, 1.0, (1001, 3)).astype(np.float32)
    path = str(tmp_path / f"{fmt}.wav")
    if fmt == "float32":
        twav.write_wav(path, x, 44_100.0)
        jpath = str(tmp_path / "jax.wav")
        jwav.write_wav(jpath, x, 44_100.0)
        assert open(path, "rb").read() == open(jpath, "rb").read()
        y, rate = twav.read_wav(path)
        assert rate == 44_100.0 and np.array_equal(y, x)
    else:
        _pcm_file(path, x, 44_100, fmt)
    assert_same(twav.read_wav(path), jwav.read_wav(path))


def test_wav_rejects_alike(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFX" + bytes(8))
    for m in (twav, jwav):
        with pytest.raises(ValueError, match="not a RIFF/WAVE"):
            m.read_wav(str(bad))


# -- the spectrogram's history helpers -------------------------------------------------


def test_unpack_classic_db_every_code():
    codes = np.arange(65536, dtype=np.uint16).reshape(256, 256)
    ours = tsg.unpack_classic_db(codes)
    assert ours.dtype == np.float32
    assert np.array_equal(ours, np.asarray(jsg.unpack_classic_db(codes)))


def test_history_columns_matches():
    rng = np.random.default_rng(SEED)
    for reassigned in (False, True):
        for points in (1, 2, 513, 1025, 4097, 8193, 65537):
            for req in [0, 1, 100, 8192, 9000, *rng.integers(-5, 20_000, 8).tolist()]:
                assert tsg.history_columns(reassigned, points, int(req)) == jsg.history_columns(
                    reassigned, points, int(req)
                )


@pytest.mark.parametrize("kw", [
    {}, {"fft_size": 0}, {"hop_size": 0}, {"fft_size": 32, "hop_size": 0}, {"sample_rate": -1.0},
    {"sample_rate": float("nan")}, {"sample_rate": 1e7}, {"zero_padding_factor": 0},
    {"fft_size": 8192, "hop_size": 512, "zero_padding_factor": 4, "window": WindowKind.BLACKMAN},
])
def test_spectrogram_normalized_matches(kw):
    cfg = tsg.SpectrogramConfig(**kw)
    assert_same(to_jax(cfg.normalized()), to_jax(cfg).normalized())


# -- views.py: every public class and function ----------------------------------------


def _peak_hold(v, fs, rng):
    ph = v.PeakHold.new((3,), -99.9, now=0.0)
    out = []
    for k in range(40):
        out.append(ph.update(rng.uniform(-80.0, 0.0, 3).astype(np.float32), 0.25 * k).copy())
    return out, ph


def _blend(v, fs, rng):
    prev, cur = rng.standard_normal(64).astype(np.float32), rng.standard_normal(64).astype(np.float32)
    return [v.persistence_blend(prev, cur, p) for p in (-1.0, 0.0, 0.5, 0.98, 2.0)] + [
        v.persistence_blend(None, cur, 0.5)]


def _decimate(v, fs, rng):
    pts = np.stack([np.linspace(0, 1, 5000), rng.standard_normal(5000)], -1).astype(np.float32)
    return [v.decimate_minmax_line(pts, n) for n in (2, 3, 64, 257, 4999, 5000, 9000)]


def _palette(v, fs, rng):
    spreads = [v.sanitize_stop_spreads(s, 5) for s in (None, [1.0] * 5, [-1, np.nan, 0.5, 3.0, 9.0], [0.5, 2.0])]
    pal = v.GradientPalette.make(rng.uniform(0, 1, (5, 4)), [0.0, 0.1, 0.5, 0.7, 1.0], [1.0, 0.5, 2.0, 1.0, 1.5])
    t = np.concatenate([[-0.5, 0.0, 1.0, 1.5, np.nan], rng.uniform(0, 1, 300)]).astype(np.float32)
    return spreads, pal, pal.evaluate(t), v.HEAT_RAMP.evaluate(t)


def _stereo(v, fs, rng):
    x, y = rng.uniform(-1.5, 1.5, (2, 500)).astype(np.float32)
    return v.stereometer_scaled_compression(np.append(x, 0.0), np.append(y, 0.0))


def _scroll_clock(v, fs, rng):
    clock, out = v.WaveformScrollClock(), []
    now = 0.0
    for k in range(60):
        now += float(rng.uniform(0.0, 0.15))
        if k % 7 == 0:
            clock.mark_snapshot(now)
        out.append(clock.progress(now, float(rng.uniform(0, 1)), float(rng.uniform(-5, 40))))
    return out, clock


def _trail(v, fs, rng):
    trail, out = v.CorrelationTrail(cap=12), []
    out.append(v.correlation_trail_alpha(trail, 40))
    for k in range(20):
        trail.push_front(float(rng.uniform(-1, 1)))
        out.append((trail.values.copy(), trail.segment_opacities(), v.correlation_trail_alpha(trail, 120)))
    trail.reset()
    out.append(trail.segment_opacities())
    return out


def _accumulate(v, fs, rng):
    shape = (6, 129)
    freq = rng.uniform(0, 24_000, shape).astype(np.float32)
    tof = rng.uniform(-2, 2, shape).astype(np.float32)
    power = rng.exponential(1.0, shape).astype(np.float32)
    ok = rng.uniform(0, 1, shape) > 0.2
    return [v.reassigned_accumulate(freq, tof, power, ok, time_bins=8, freq_lo_hz=20.0, freq_hi_hz=20_000.0,
                                    freq_bins=64, scale=s, time_origin=0.5, power_scale=0.7)
            for s in (None, fs.LOGARITHMIC, fs.ERB)]


def _resample(v, fs, rng):
    w = rng.standard_normal(4000).astype(np.float32)
    return [v.resample_trace(w, span, frac, n) for span, frac, n in
            ((400.0, 0.0, 4096), (3999.5, 0.25, 512), (10.0, 0.9, 64), (0.0, 0.0, 16))]


def _waveform_snapshot(rng, s=3, k=5):
    import collections

    snap = collections.namedtuple("WaveformSnapshot", "col_valid col_min col_max col_color col_rms_db")
    return snap(rng.uniform(0, 1, (s, k)) > 0.4, *rng.standard_normal((2, s, k, 2)).astype(np.float32),
                rng.uniform(0, 1, (s, k, 3)).astype(np.float32), rng.uniform(-60, 0, (s, k)).astype(np.float32))


def _waveform_history(v, fs, rng):
    hist, out = v.WaveformHistory(max_columns=7), []
    for k in range(6):
        snap = _waveform_snapshot(rng)
        out.append(hist.push_snapshot(snap, stream=k % 3))
        meters = {f"['waveform'].{f}": np.asarray(getattr(snap, f), np.float32) for f in snap._fields}
        meters["['loudness'].momentary_lufs"] = np.zeros(3, np.float32)
        cols = v.waveform_columns_from_meters(meters, 1)
        hist.push_columns(cols)
        out.append(cols)
        if k == 3:
            hist.resize(3)
    out.append(v.waveform_columns_from_meters({"['waveform'].col_valid": np.ones((3, 5))}, 0))
    return out, hist.max_columns, hist.columns, v.WaveformHistory(max_columns=10**9).max_columns


def _spectrogram_history(v, fs, rng):
    hist, out = v.SpectrogramHistory(bins=9, columns=5), []
    for k in (1, 3, 2, 7, 1):
        hist.push(rng.integers(0, 65536, (k, 9)).astype(np.uint16))
        out.append(hist.view().copy())
    hist.push(rng.integers(0, 65536, 9).astype(np.uint16))
    for cols in (8, 8, 2, 4):
        hist.resize(cols)
        out.append((hist.view().copy(), hist.filled, hist.columns))
    return out


def _spectrum_math(v, fs, rng):
    bins = np.linspace(0, 24_000, 1025).astype(np.float32)
    db = rng.uniform(-120, 0, (2, 1025)).astype(np.float32)
    db[0, 5] = np.nan
    db[1, 7] = -np.inf
    out = [v.fmt_freq(f) for f in (3.0, 99.99, 100.0, 999.0, 1000.0, 12_345.0)]
    out += [v.spectrum_value_at(bins, db, f) for f in (0.0, 10.0, 997.3, 23_999.0, 30_000.0)]
    for scale in (fs.LINEAR, fs.LOGARITHMIC, fs.ERB):
        out.append(v.spectrum_x_cache(bins, scale))
        out.append(v.spectrum_points(db[1], bins, scale, -100.0, reverse=True))
        out.append(v.spectrum_points(db[0], bins, scale, -100.0, max_f=12_000.0))
        for mode in ("max", "sample"):
            out.append(v.spectrum_rebin_display(db, bins, scale, 200, mode=mode))
            out.append(v.spectrum_rebin_display(db, bins, scale, 4000, max_f=20_000.0, mode=mode))
        out.append(v.spectrum_grid_ticks(20.0, 20_000.0, scale))
        out.append(v.spectrum_grid_ticks(5.0, 90.0, scale))
    out += [v.spectrum_interpolated_peak(bins, db[1], i) for i in (0, 1, 300, 1023, 1024)]
    label = v.SpectrumPeakLabel()
    tone = np.full(1025, -100.0, np.float32)
    for k in range(30):
        frame = tone if k % 9 == 8 else db[1] * 0.3 + np.where(np.arange(1025) == 40 + k, 60.0, 0.0)
        label.update(bins, frame, fs.LOGARITHMIC, reverse=k % 2 == 1, unit="dB")
        out.append(dataclasses.replace(label))
    return out


def _spectrogram_ui(v, fs, rng):
    out = [v.spectrogram_display_axis(r) for r in (44_100.0, 48_000.0, 192_000.0)]
    out += [v.spectrogram_uv_y_range(z, p) for z, p in ((1.0, 0.0), (4.0, 0.3), (0.5, -1.0), (64.0, 2.0))]
    out += [v.spectrogram_zoom_at(z, p, y, f) for z, p, y, f in ((1.0, 0.0, 0.5, 2.0), (8.0, 0.7, 0.1, 0.5),
                                                                (1.0, 0.0, 0.9, 0.01))]
    out += [v.spectrogram_freq_axis_norm(x, y, r) for x, y in ((0.2, 0.7), (1.0, 0.0)) for r in range(4)]
    uv = v.spectrogram_uv_y_range(3.0, 0.2)
    for scale in (fs.LINEAR, fs.LOGARITHMIC, fs.ERB):
        out += [v.spectrogram_frequency_at(t, uv, 48_000.0, scale) for t in (-0.1, 0.0, 0.37, 1.0, 1.2)]
        out.append(v.crosshair_readout(0.3, 0.6, uv_range=uv, sample_rate=48_000.0, scale=scale, rotation=1,
                                       col_count=400, hop_size=64, age_px=120.0))
        out.append(v.crosshair_readout(0.9, 0.05, uv_range=(0.0, 1.0), sample_rate=44_100.0, scale=scale))
        out.append(v.piano_roll_keys(uv, 48_000.0, scale))
        out.append(v.piano_roll_keys((0.0, 1.0), 44_100.0, scale))
    out += [v.spectrogram_time_ago(a, c, h, 48_000.0) for a, c, h in ((0.0, 0, 64), (10.0, 100, 64),
                                                                       (500.0, 100, 256))]
    return out


VIEW_CASES = {
    "peak_hold": _peak_hold, "persistence_blend": _blend, "decimate_minmax_line": _decimate,
    "gradient_palette": _palette, "stereometer_scaled_compression": _stereo,
    "waveform_scroll_clock": _scroll_clock, "correlation_trail": _trail,
    "reassigned_accumulate": _accumulate, "resample_trace": _resample,
    "waveform_history": _waveform_history, "spectrogram_history": _spectrogram_history,
    "spectrum_display": _spectrum_math, "spectrogram_interaction": _spectrogram_ui,
}


@pytest.mark.parametrize("case", sorted(VIEW_CASES))
def test_views_match(case):
    outs = [VIEW_CASES[case](v, fs, np.random.default_rng(SEED)) for v, fs in SIDES]
    assert_same(*outs)


def test_views_public_names_match():
    public = {n for n in dir(jviews) if not n.startswith("_") and n not in ("annotations", "dataclasses", "np")}
    assert public <= set(dir(tviews))
    covered = {"PeakHold", "persistence_blend", "decimate_minmax_line", "sanitize_stop_spreads",
               "GradientPalette", "HEAT_RAMP", "stereometer_scaled_compression", "WaveformScrollClock",
               "CorrelationTrail", "correlation_trail_alpha", "reassigned_accumulate", "resample_trace",
               "WaveformHistory", "waveform_columns_from_meters", "SpectrogramHistory", "fmt_freq",
               "spectrum_value_at", "spectrum_x_cache", "spectrum_points", "spectrum_rebin_display",
               "spectrum_grid_ticks", "spectrum_interpolated_peak", "SpectrumPeakLabel",
               "spectrogram_display_axis", "spectrogram_uv_y_range", "spectrogram_zoom_at",
               "spectrogram_freq_axis_norm", "spectrogram_frequency_at", "spectrogram_time_ago",
               "crosshair_readout", "piano_roll_keys"}
    callables = {n for n in public if callable(getattr(jviews, n))}
    assert callables - covered == set()
    for name in public - callables:
        assert_same(getattr(jviews, name), getattr(tviews, name), name)


# -- persistence.py -------------------------------------------------------------------


def _configs():
    """Port configs: the default, the serve flagship, and edited ones."""
    return [
        EngineConfig(),
        EngineConfig(channels=2, spectrogram=tsg.SpectrogramConfig(2048, 64, use_reassignment=False),
                     spectrum=None, oscilloscope=None, stereometer=None, waveform=None),
        dataclasses.replace(
            EngineConfig(sample_rate=44_100.0, block_frames=235),
            spectrum=SpectrumConfig(hop_size=512, averaging=AveragingMode.PEAK_HOLD, window=WindowKind.BLACKMAN),
            oscilloscope=OscilloscopeConfig(trigger_mode=TriggerMode.STABLE, channel_2=Channel.RIGHT),
            stereometer=None,
        ),
    ]


@pytest.mark.parametrize("k", range(3))
def test_settings_encode_decode_match(k):
    cfg = _configs()[k]
    doc = tpers.encode_settings(cfg)
    assert doc == jpers.encode_settings(to_jax(cfg))
    assert json.dumps(doc, indent=2) == json.dumps(jpers.encode_settings(to_jax(cfg)), indent=2)
    assert_same(to_jax(tpers.decode_settings(doc)), jpers.decode_settings(doc))
    assert tpers.decode_settings(json.loads(json.dumps(doc))) == cfg


_enum_values = {
    "window": [w.value for w in WindowKind], "averaging": [a.value for a in AveragingMode],
    "trigger_mode": [m.value for m in TriggerMode], "source": [c.value for c in Channel],
    "secondary_source": [c.value for c in Channel], "trigger_source": [c.value for c in Channel],
    "channel_1": [c.value for c in Channel], "channel_2": [c.value for c in Channel],
}


@st.composite
def _edited_docs(draw):
    """A settings document of the default config with some fields edited:
    valid values, wrong types, unknown keys and disabled sections."""
    doc = tpers.encode_settings(EngineConfig())
    for name in ("spectrogram", "spectrum", "oscilloscope", "loudness", "stereometer", "waveform"):
        section = doc[name]
        for key in draw(st.lists(st.sampled_from(sorted(section)), max_size=3, unique=True)):
            value = section[key]
            if key in _enum_values:
                options = st.sampled_from(_enum_values[key] + ["bogus"])
            elif isinstance(value, bool):
                options = st.one_of(st.booleans(), st.just("yes"))
            elif isinstance(value, int):
                options = st.one_of(st.integers(1, 1 << 14), st.just("x"), st.just(True))
            elif isinstance(value, float):
                options = st.one_of(st.floats(-200.0, 200.0, allow_nan=False), st.just([1]))
            else:
                options = st.just(value)
            section[key] = draw(options)
        if draw(st.booleans()):
            section["unknown_field"] = 1
        doc["enabled"][name] = draw(st.sampled_from([True, True, False]))
    if draw(st.booleans()):
        doc["mystery"] = {}
    doc["sample_rate"] = draw(st.sampled_from([44_100.0, 48_000.0, "fast"]))
    return doc


@settings(max_examples=40, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.function_scoped_fixture])
@given(doc=_edited_docs())
def test_settings_lossy_decode_matches(doc, caplog):
    """The lossy schema in both packages: the same configuration and the
    same warnings from an edited document."""
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        ours = tpers.decode_settings(doc)
    ours_log = [r.getMessage() for r in caplog.records if r.name == "openmeters_tpu_torch.settings"]
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        ref = jpers.decode_settings(doc)
    ref_log = [r.getMessage() for r in caplog.records if r.name == "openmeters_tpu.settings"]
    assert_same(to_jax(ours), ref)
    assert ours_log == ref_log
    assert tpers.encode_settings(ours) == jpers.encode_settings(ref)


def test_settings_file_read_by_both(tmp_path):
    """One file, written by each package's debounced saver (and by
    ``flush``), byte for byte alike and read back alike, UI section
    included; an unreadable file falls back alike."""
    cfg = _configs()[2]
    ui = tpers.UiSettings(theme="night", pane_layout=(("spectrum",), ("loudness", "waveform")))
    tpath, jpath = tmp_path / "port.json", tmp_path / "jax.json"
    th, jh = tpers.SettingsHandle(str(tpath)), jpers.SettingsHandle(str(jpath))
    assert th.config == EngineConfig() and not tpath.exists()
    th.update(cfg)
    th.update_ui(ui)
    jh.update(to_jax(cfg))
    jh.update_ui(jpers.UiSettings(theme=ui.theme, pane_layout=ui.pane_layout))
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline and not (tpath.exists() and jpath.exists()):
        time.sleep(0.05)
    assert tpath.read_bytes() == jpath.read_bytes()  # the debounced save
    th.flush()
    jh.flush()
    assert tpath.read_bytes() == jpath.read_bytes()
    for path in (tpath, jpath):
        assert tpers.SettingsHandle.load_or_default(str(path)) == cfg
        assert_same(to_jax(tpers.SettingsHandle.load_or_default(str(path))),
                    jpers.SettingsHandle.load_or_default(str(path)))
        assert tpers.SettingsHandle.load_ui_or_default(str(path)) == ui
        assert_same(tpers.SettingsHandle(str(path)).ui, jpers.SettingsHandle(str(path)).ui)
    bad = tmp_path / "bad.json"
    bad.write_text("{ not json")
    assert tpers.SettingsHandle.load_or_default(str(bad)) == EngineConfig()
    assert_same(tpers.SettingsHandle.load_ui_or_default(str(bad)), jpers.SettingsHandle.load_ui_or_default(str(bad)))


@pytest.mark.parametrize("raw", [
    None, "dark", {"theme": 3}, {"theme": "x", "pane_layout": "rows"},
    {"pane_layout": [["spectrum", "bogus"], "row", [], ["waveform"]]}, {"pane_layout": [["bogus"]], "extra": 1},
])
def test_ui_decode_matches(raw):
    assert_same(tpers.decode_ui(raw), jpers.decode_ui(raw))
    assert tpers.encode_ui(tpers.decode_ui(raw)) == jpers.encode_ui(jpers.decode_ui(raw))


# -- ingest/backoff.py, ingest/directory.py --------------------------------------------


def test_backoff_matches():
    steps = np.random.default_rng(SEED).uniform(0.0, 3.0, 40)
    outs = []
    for m in (jbackoff, tbackoff):
        rows = []
        for b in (m.Backoff.session(), m.Backoff.resource(), m.Backoff(0.1, 1.0, 3.0)):
            now = 100.0
            for step in steps:
                now += float(step)
                op = len(rows) % 7
                if op == 6:
                    b.success()
                    rows.append(None)
                else:
                    rows.append((b.failure(now), b.ready(now), b.ready(now + 40.0)))
        outs.append(rows)
    assert outs[0] == outs[1]


def test_directory_matches():
    """A seeded run of acquires and releases over more identities than
    slots, with remembered slots, LRU eviction and truncation."""
    rng = np.random.default_rng(SEED)
    ops = [(bool(rng.uniform() < 0.6), int(rng.integers(0, 24)), int(rng.integers(0, 4))) for _ in range(400)]
    outs = []
    for m in (jdirectory, tdirectory):
        d, rows = m.StreamDirectory(6, remember_limit=5), []
        for acquire, who, kind in ops:
            ident = m.StreamIdentity(**{("app_id", "app_name", "media_name", "node_name")[kind]: f"id{who}"})
            rows.append((ident.key, d.acquire(ident) if acquire else d.release(ident.key)))
        view = d.view()
        del view["timestamp"]
        rows.append(view)
        rows.append(m.StreamIdentity().key)
        outs.append(rows)
    assert outs[0] == outs[1]
