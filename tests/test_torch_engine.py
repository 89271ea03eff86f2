"""PyTorch port, the flagship slice end to end: the same seeded audio through
the JAX package's API and the port's, on the CPU.

Tolerances: loudness fields within 0.01 LU/dB, true peak within 1e-3 dB;
spectrogram codes within 2 (0.005 dB) at valid bins within 60 dB of their
column's peak (see tests/test_torch_sliding.py for why deeper bins are not
held to it); valid masks equal.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from openmeters_tpu import api as japi  # noqa: E402
from openmeters_tpu.analyzers.spectrogram import SpectrogramConfig as JSpecConfig  # noqa: E402
from openmeters_tpu.engine import EngineConfig as JEngineConfig  # noqa: E402
from openmeters_tpu.engine import MeterEngine as JMeterEngine  # noqa: E402
from openmeters_tpu.engine import StreamMeta as JStreamMeta  # noqa: E402
from openmeters_tpu.utils.windows import WindowKind as JWindowKind  # noqa: E402
from openmeters_tpu_torch import api as tapi  # noqa: E402
from openmeters_tpu_torch import convert  # noqa: E402
from openmeters_tpu_torch.analyzers.spectrogram import SpectrogramConfig  # noqa: E402
from openmeters_tpu_torch.analyzers.spectrum import SpectrumConfig  # noqa: E402
from openmeters_tpu_torch.engine import EngineConfig, MeterEngine, StreamMeta  # noqa: E402
from openmeters_tpu_torch.utils.windows import WindowKind  # noqa: E402

RESOLVED_CODES = round(60.0 * 65535 / 156)
REPO = Path(__file__).resolve().parents[1]


def _configs(fft=2048, hop=64, window="hann", channels=2):
    kw = dict(spectrum=None, oscilloscope=None, stereometer=None, waveform=None,
              channels=channels)
    return (
        JEngineConfig(spectrogram=JSpecConfig(fft_size=fft, hop_size=hop, window=JWindowKind(window),
                                              use_reassignment=False), **kw),
        EngineConfig(spectrogram=SpectrogramConfig(fft_size=fft, hop_size=hop, window=WindowKind(window),
                                                   use_reassignment=False), **kw),
    )


def _audio(s, hops, channels, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(hops * 256) / 48_000.0
    freqs = rng.uniform(60.0, 6000.0, size=(s, 1, 1))
    audio = 0.25 * np.sin(2 * np.pi * freqs * t[None, :, None]) + 0.05 * rng.standard_normal(
        (s, hops * 256, channels)
    )
    audio *= rng.uniform(0.01, 1.0, size=(s, 1, channels))
    return audio.astype(np.float32)


def assert_snapshots_match(jsnaps, tsnaps, hop):
    jl, tl = jsnaps["loudness"], tsnaps["loudness"]
    for field in jl._fields:
        ours = getattr(tl, field).cpu().numpy()
        ref = np.asarray(getattr(jl, field))
        assert ours.shape == ref.shape, (hop, field)
        tol = 1e-3 if field == "true_peak_db" else 0.01
        np.testing.assert_allclose(ours, ref, rtol=0, atol=tol, err_msg=f"hop {hop} {field}")
    jc, tc = jsnaps["spectrogram"], tsnaps["spectrogram"]
    valid = np.asarray(jc.valid)
    np.testing.assert_array_equal(tc.valid.cpu().numpy(), valid, err_msg=f"hop {hop}")
    ref = np.asarray(jc.codes).astype(np.int64)
    ours = tc.codes.cpu().numpy().astype(np.int64)
    assert tc.codes.dtype == torch.uint16 and ours.shape == ref.shape
    held = valid[..., None] & (ref >= ref.max(axis=-1, keepdims=True) - RESOLVED_CODES)
    worst = int((np.abs(ours - ref) * held).max())
    assert worst <= 2, f"hop {hop}: codes differ by {worst}"


def _run_sessions(jcfg, tcfg, audio, resets=None, jmeta=None, tmeta=None):
    s = audio.shape[0]
    jsess = japi.AnalysisSession(JMeterEngine(jcfg), s, meta=jmeta)
    tsess = tapi.AnalysisSession(MeterEngine(tcfg), s, "cpu", meta=tmeta)
    for i in range(audio.shape[1] // 256):
        blk = audio[:, i * 256 : (i + 1) * 256]
        reset = None if resets is None else resets.get(i)
        assert_snapshots_match(jsess.feed(blk, reset), tsess.feed(blk, reset), i)
    return jsess, tsess


def test_flagship_analyze_matches():
    jcfg, tcfg = _configs()
    audio = _audio(4, 96, 2, seed=31)
    jout = japi.analyze(audio, config=jcfg)
    tout = tapi.analyze(audio, config=tcfg, device="cpu")
    assert len(jout) == len(tout) == 96
    for i, (js, ts) in enumerate(zip(jout, tout)):
        assert ts["loudness"].integrated_lufs.device.type == "cpu"
        assert_snapshots_match(js, ts, i)
    assert float(tout[-1]["loudness"].integrated_lufs.min()) > -70.0


def test_flagship_session_with_reset_matches():
    jcfg, tcfg = _configs()
    audio = _audio(4, 96, 2, seed=32)
    reset = np.array([False, True, False, True])
    _run_sessions(jcfg, tcfg, audio, resets={40: reset})


def test_reduced_surround_config_matches():
    """fft 256, hop 32 (8 columns a hop), Blackman-Harris, 8 channels
    padded from a 5.1 layout (LFE weight 0, surrounds 1.41)."""
    jcfg, tcfg = _configs(fft=256, hop=32, window="blackman_harris", channels=8)
    s = 3
    audio = _audio(s, 60, 8, seed=33)
    audio[:, :, 6:] = 0.0
    jmeta = JStreamMeta.default(s, channels=6, pad_channels=8)
    tmeta = StreamMeta.default(s, channels=6, pad_channels=8)
    np.testing.assert_array_equal(tmeta.weights.numpy(), np.asarray(jmeta.weights))
    _run_sessions(jcfg, tcfg, audio, resets={25: np.array([False, False, True])},
                  jmeta=jmeta, tmeta=tmeta)


def _continue_from_jax_carry(jcfg, tcfg, s, before, after, seed, resets=None):
    """JAX runs ``before`` hops; its carry comes into the port through
    ``convert.carry_from_jax`` (and back out leaf for leaf, a sliding state
    cut to ``bins``), and both continue to hop ``after``, held hop by hop
    by ``check_snapshots``.  The port session starts with no spectrum
    snapshot of its own: a cadenced spectrum is held from the first
    spectrum hop the port computes, its averaging state and sliding
    counters with it.  Returns ``(jax carry, port session, spectrum hops
    held)``."""
    from openmeters_tpu_torch.utils.parity import check_snapshots, check_spectrum, spectrum_errors

    audio = _audio(s, after, 2, seed=seed)
    audio = np.pad(audio, ((0, 0), (0, 0), (0, tcfg.channels - 2)))  # as analyze pads
    jsess = japi.AnalysisSession(JMeterEngine(jcfg), s)
    for i in range(before):
        jsess.feed(audio[:, i * 256 : (i + 1) * 256])
    assert not jsess._pending_blocks  # the carry is taken on a spectrum-hop boundary
    carry_np = jax.device_get(jsess.carry)
    tsess = tapi.AnalysisSession(MeterEngine(tcfg), s, "cpu")
    tsess.carry = convert.carry_from_jax(carry_np, tsess.engine, device="cpu")

    back = convert.carry_to_numpy(tsess.carry)
    # the port holds no classic-spectrogram sliding state (convert.RETIRED)
    flat_j = [(path, leaf) for path, leaf in jax.tree_util.tree_leaves_with_path(carry_np)
              if not jax.tree_util.keystr(path).startswith("['spectrogram']['sdft']")]
    flat_t = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        ours, ref = flat_t[path], np.asarray(leaf)
        if jax.tree_util.keystr(path).endswith(("['sdft']['re']", "['sdft']['im']")):
            ref = ref[..., : ours.shape[-1]]  # the JAX kernel's tile padding
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, path
        np.testing.assert_array_equal(ours, ref, err_msg=str(path))

    r = tsess.engine.spectrum_cadence
    held = 0
    for i in range(before, after):
        blk = audio[:, i * 256 : (i + 1) * 256]
        reset = None if resets is None else resets.get(i)
        jsnaps, tsnaps = jsess.feed(blk, reset), tsess.feed(blk, reset)
        if "spectrum" in jsnaps and "spectrum" not in tsnaps:
            assert i < before + r - 1, i  # only before the port's first spectrum hop
            jsnaps = {k: v for k, v in jsnaps.items() if k != "spectrum"}
        check_snapshots(tsnaps, jsnaps, f"hop {i}")
        if "spectrum" in tsnaps and (i + 1) % r == 0:
            tsp, jsp = tsess.carry["spectrum"], jsess.carry["spectrum"]
            err = spectrum_errors(tsp["smoothed"], np.asarray(jsp["smoothed"]), tsnaps["spectrum"],
                                  jsnaps["spectrum"], tsess.engine.analyzers["spectrum"].state_floor)
            check_spectrum(err, f"hop {i} spectrum state")
            if "sdft" in tsp:
                assert tsp["sdft"]["count"] == int(jsp["sdft"]["count"])
                assert tsp["sdft"]["anchored"] == bool(jsp["sdft"]["anchored"])
            held += 1
    return carry_np, tsess, held


def _spectrum_only(spectrum):
    return dict(spectrum=spectrum, spectrogram=None, oscilloscope=None, stereometer=None,
                waveform=None, channels=2)


@pytest.mark.parametrize("case", ["flagship_oscilloscope", "default", "sliding_16384_512"])
def test_carry_from_jax_continues(case, monkeypatch):
    """JAX runs some hops; both packages continue from its carry.

    - ``flagship_oscilloscope``: the flagship plus the default oscilloscope
      (whose carry holds a tuple of rings and host scalars), S=3; JAX runs
      50 hops, both continue 30 more.
    - ``default``: the literal ``EngineConfig()``.  JAX runs 68 hops (its
      spectrum's first column lands at hop 63); both continue 24 more, six
      spectrum hops at cadence 4.
    - ``sliding_16384_512``: loudness and the spectrum at 16384/512
      (cadence 2, the B1b path), the JAX package's kernel run in interpret
      mode, which stores its sliding state padded to 512-bin tiles.  JAX
      runs 72 hops (the first column lands at hop 63); both continue 28
      more, fourteen sliding spectrum hops, with a reset at hop 90.
    """
    from openmeters_tpu.analyzers.oscilloscope import OscilloscopeConfig as JOscConfig
    from openmeters_tpu.analyzers.spectrum import SpectrumConfig as JSpectrumConfig
    from openmeters_tpu_torch.analyzers.oscilloscope import OscilloscopeConfig

    resets = None
    if case == "flagship_oscilloscope":
        jcfg, tcfg = _configs()
        jcfg = dataclasses.replace(jcfg, oscilloscope=JOscConfig())
        tcfg = dataclasses.replace(tcfg, oscilloscope=OscilloscopeConfig())
        s, before, after, seed = 3, 50, 80, 34
    elif case == "default":
        jcfg, tcfg = JEngineConfig(), EngineConfig()
        s, before, after, seed = 2, 68, 92, 35
    else:
        monkeypatch.setenv("OPENMETERS_PALLAS_INTERPRET", "1")
        jax.clear_caches()
        jcfg = JEngineConfig(**_spectrum_only(JSpectrumConfig(hop_size=512)))
        tcfg = EngineConfig(**_spectrum_only(SpectrumConfig(hop_size=512)))
        s, before, after, seed = 2, 72, 100, 35
        resets = {90: np.array([False, True])}
    try:
        carry_np, tsess, held = _continue_from_jax_carry(jcfg, tcfg, s, before, after, seed, resets)
    finally:
        jax.clear_caches()
    r = tsess.engine.spectrum_cadence
    if case == "flagship_oscilloscope":
        assert held == 0 and isinstance(tsess.carry["oscilloscope"]["hist"], tuple)
        assert isinstance(tsess.carry["oscilloscope"]["origin"], int)
        return
    assert held == (after - before) // r
    assert isinstance(tsess.carry["spectrum"]["fb"]["avail"], int)
    assert bool(tsess.carry["spectrum"]["smoothed"].any())
    if case == "default":
        assert r == 4 and isinstance(tsess.carry["waveform"]["ring_head"], int)
    else:
        assert r == 2 and carry_np["spectrum"]["sdft"]["re"].shape == (s, 17 * 512)  # tile-padded
        assert tuple(tsess.carry["spectrum"]["sdft"]["re"].shape) == (s, 8193)
        assert not tsess.engine.analyzers["spectrum"]._sliding.whole_row  # B1b


def test_carry_from_jax_cuts_tile_padding():
    """A sliding state the JAX package stores padded to its kernel's 512-bin
    tiles (as it does where its kernels run) comes in cut to ``bins``."""
    from openmeters_tpu_torch.analyzers.spectrum import SpectrumConfig

    cfg = EngineConfig(loudness=None, spectrogram=None, oscilloscope=None, stereometer=None,
                       waveform=None, spectrum=SpectrumConfig(hop_size=512))
    engine = MeterEngine(cfg)
    carry = convert.carry_to_numpy(engine.init(2, device="cpu"))
    sdft = carry["spectrum"]["sdft"]
    rng = np.random.default_rng(0)
    re = rng.standard_normal((2, 8193)).astype(np.float32)
    sdft["re"] = np.pad(re, ((0, 0), (0, 17 * 512 - 8193)))
    sdft["im"] = np.pad(-re, ((0, 0), (0, 17 * 512 - 8193)))
    back = convert.carry_from_jax(carry, engine, device="cpu")["spectrum"]["sdft"]
    assert tuple(back["re"].shape) == (2, 8193) and back["count"] == 0
    np.testing.assert_array_equal(back["re"].numpy(), re)
    np.testing.assert_array_equal(back["im"].numpy(), -re)


def test_default_engine_builds_all_six():
    engine = MeterEngine(EngineConfig())
    assert list(engine.analyzers) == [
        "loudness", "spectrogram", "spectrum", "oscilloscope", "stereometer", "waveform"
    ]
    assert engine.config.spectrogram.use_reassignment
    assert engine.spectrum_cadence == 4
    assert engine.analyzers["spectrum"].config.block_frames == 1024
    assert not engine.analyzers["spectrum"].use_sliding  # 16384/1024 takes the direct rFFT
    carry = engine.init(1, device="meta")
    assert set(carry["spectrogram"]) == {"fb", "srs"}
    assert "cap" in carry["oscilloscope"] and "snap" not in carry["oscilloscope"]
    assert set(carry["spectrum"]) == {"fb", "smoothed"}
    assert carry["waveform"]["ring_head"] == 0 and "tb" not in carry["stereometer"]
    sliding = MeterEngine(dataclasses.replace(EngineConfig(), spectrum=SpectrumConfig(hop_size=512)))
    assert sliding.spectrum_cadence == 2 and sliding.analyzers["spectrum"].use_sliding
    assert not sliding.analyzers["spectrum"]._sliding.whole_row  # B1b
    _, tcfg = _configs()
    assert MeterEngine(tcfg).config.spectrogram.sample_rate == 48_000.0


def test_configs_share_fields_and_defaults():
    """A settings dict means the same thing in both packages."""
    import dataclasses

    from openmeters_tpu.analyzers import oscilloscope as jo
    from openmeters_tpu.analyzers import spectrum as jsp
    from openmeters_tpu.analyzers import stereometer as jst
    from openmeters_tpu.analyzers import waveform as jw
    from openmeters_tpu.analyzers.loudness import LoudnessConfig as JLoud
    from openmeters_tpu_torch.analyzers import oscilloscope as to
    from openmeters_tpu_torch.analyzers import spectrum as tsp
    from openmeters_tpu_torch.analyzers import stereometer as tst
    from openmeters_tpu_torch.analyzers import waveform as tw
    from openmeters_tpu_torch.analyzers.loudness import LoudnessConfig as TLoud

    def as_plain(cfg):
        out = {}
        for f in dataclasses.fields(cfg):
            v = getattr(cfg, f.name)
            out[f.name] = as_plain(v) if dataclasses.is_dataclass(v) else getattr(v, "value", v)
        return out

    pairs = [
        (JEngineConfig(), EngineConfig()), (JLoud(), TLoud()), (JSpecConfig(), SpectrogramConfig()),
        (jsp.SpectrumConfig(), tsp.SpectrumConfig()), (jo.OscilloscopeConfig(), to.OscilloscopeConfig()),
        (jst.StereometerConfig(), tst.StereometerConfig()), (jw.WaveformConfig(), tw.WaveformConfig()),
    ]
    for jcfg, tcfg in pairs:
        assert as_plain(tcfg) == as_plain(jcfg), type(tcfg).__name__
    assert as_plain(EngineConfig().resolve()) == as_plain(JEngineConfig().resolve())


def test_cuda_device_is_explicit():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, tcfg = _configs()
    with pytest.raises((RuntimeError, AssertionError)):
        tapi.analyze(np.zeros((1, 256, 2), np.float32), config=tcfg, device="cuda")


def test_port_imports_no_jax():
    code = (
        "import sys, json, numpy as np\n"
        "from openmeters_tpu_torch import api, EngineConfig\n"
        "from openmeters_tpu_torch.analyzers.spectrogram import SpectrogramConfig\n"
        "cfg = EngineConfig(spectrogram=SpectrogramConfig(fft_size=256, hop_size=64,\n"
        "                                                  use_reassignment=False),\n"
        "                   spectrum=None, oscilloscope=None, stereometer=None, waveform=None)\n"
        "out = api.analyze(np.zeros((2, 2048, 2), np.float32), config=cfg, device='cpu')\n"
        "cfg = EngineConfig(spectrum=None, oscilloscope=None, stereometer=None, waveform=None)\n"
        "re = api.analyze(np.ones((2, 2048, 2), np.float32), config=cfg, device='cpu')\n"
        "assert type(re[-1]['spectrogram']).__name__ == 'ReassignedColumns'\n"
        "cfg = EngineConfig(spectrum=None, stereometer=None, waveform=None)\n"
        "osc = api.analyze(np.ones((2, 2048, 2), np.float32), config=cfg, device='cpu')\n"
        "assert type(osc[-1]['oscilloscope']).__name__ == 'OscilloscopeSnapshot'\n"
        "full = api.analyze(np.ones((2, 2048, 2), np.float32), device='cpu')\n"
        "assert sorted(full[-1]) == ['loudness', 'oscilloscope', 'spectrogram', 'spectrum',\n"
        "                            'stereometer', 'waveform']\n"
        "import openmeters_tpu_torch.ops.corr, openmeters_tpu_torch.ops.rows\n"
        "import openmeters_tpu_torch.__main__, openmeters_tpu_torch.persistence\n"
        "import openmeters_tpu_torch.views, openmeters_tpu_torch.ingest.runtime\n"
        "import tempfile\n"
        "from openmeters_tpu_torch import render, render_live, themes, tui\n"
        "pngs = render.render_series(full, EngineConfig(), tempfile.mkdtemp(), width=64, height=48)\n"
        "assert len(pngs) == 5 and themes.ThemeStore(tempfile.mkdtemp()).load('heat').name == 'heat'\n"
        "assert tui.TuiView().render({}, 0.0) == '' and render_live.attach_render_consumer\n"
        "mods = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'openmeters_tpu.'))\n"
        "        or m == 'openmeters_tpu']\n"
        "print(json.dumps({'hops': len(out), 'mods': mods}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result == {"hops": 8, "mods": []}
