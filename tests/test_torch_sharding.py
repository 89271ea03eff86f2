"""The port's stream mesh (``openmeters_tpu_torch/engine/sharding.py``) on
the CPU, against the unsharded port and the JAX package's ``shard_map``
path on the conftest's virtual 8-device mesh.

A port mesh here lists the CPU once a shard (``StreamMesh([cpu] * 4)``):
each shard owns its tensors and steps its own streams, as on a mesh of
cards.  Snapshots are held by the bars of ``utils/parity.py``; the audio
comes from numpy seeds.
"""

import ast
import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_pairs import NONE, stereo_audio, tiny_engine, to_jax, unaligned  # noqa: E402

from openmeters_tpu import serve as jserve  # noqa: E402
from openmeters_tpu.engine import MeterEngine as JMeterEngine  # noqa: E402
from openmeters_tpu.engine import StreamMeta as JStreamMeta  # noqa: E402
from openmeters_tpu.engine import sharding as jsharding  # noqa: E402
from openmeters_tpu_torch.analyzers.loudness import LoudnessConfig  # noqa: E402
from openmeters_tpu_torch.analyzers.oscilloscope import OscilloscopeConfig  # noqa: E402
from openmeters_tpu_torch.analyzers.spectrogram import SpectrogramConfig  # noqa: E402
from openmeters_tpu_torch.analyzers.spectrum import AveragingMode, SpectrumConfig  # noqa: E402
from openmeters_tpu_torch.analyzers.stereometer import StereometerConfig  # noqa: E402
from openmeters_tpu_torch.analyzers.waveform import WaveformConfig  # noqa: E402
from openmeters_tpu_torch.checkpoint import load_state, save_state  # noqa: E402
from openmeters_tpu_torch.convert import carry_from_jax  # noqa: E402
from openmeters_tpu_torch.engine import (  # noqa: E402
    STREAM_AXIS,
    EngineConfig,
    MeterEngine,
    StreamMesh,
    StreamMeta,
    make_mesh,
    make_multihost_mesh,
    sharded_step,
)
from openmeters_tpu_torch.engine.sharding import (  # noqa: E402
    derive_stream_dims,
    gather_carry,
    gather_snapshots,
    place_carry,
    scan_last_snapshot_fn,
    sharded_scan_step,
    sharded_spectrum_step,
)
from openmeters_tpu_torch.serve import MeterServer, ServeConfig  # noqa: E402
from openmeters_tpu_torch.utils.channels import Channel  # noqa: E402
from openmeters_tpu_torch.utils.migrate import carry_device  # noqa: E402
from openmeters_tpu_torch.utils.parity import check_meters, check_snapshots  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
B = 256


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions' small ops run fastest on one thread, which
    leaves the cores to the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def graft_config() -> EngineConfig:
    """The multi-device dry run's config (``__graft_entry__.py:106-113``):
    all six analyzers at 8 kHz, small transforms, at two channels."""
    return EngineConfig(
        sample_rate=8_000.0, channels=2,
        spectrogram=SpectrogramConfig(fft_size=256, hop_size=64),
        spectrum=SpectrumConfig(fft_size=256, hop_size=64),
        oscilloscope=OscilloscopeConfig(),
        stereometer=StereometerConfig(analyze_bands=True, emit_band_points=True),
        waveform=WaveformConfig(track_history=True),
    )


def flagship_small(**kw) -> EngineConfig:
    """The flagship's analyzers (loudness, classic spectrogram) at 256/64."""
    return tiny_engine(**kw)


def metas(s: int):
    return (StreamMeta.default(s, channels=2, pad_channels=2),
            JStreamMeta.default(s, channels=2, pad_channels=2))


def with_traces(engine, snaps: dict, carry: dict) -> dict:
    """``snaps`` with the oscilloscope's capture windows of ``carry``."""
    if "oscilloscope" not in snaps:
        return snaps
    return dict(snaps, oscilloscope=engine.extract_oscilloscope(carry))


def joined(engine, step, snaps: list, carry) -> dict:
    """A sharded step's snapshots as one, the oscilloscope's windows
    extracted shard by shard."""
    out = gather_snapshots(snaps, step.snapshot_dims)
    if "oscilloscope" in out:
        traces = [engine.extract_oscilloscope(c) for c in carry]
        out["oscilloscope"] = gather_snapshots(traces, step.snapshot_dims["oscilloscope"])
    return out


# -- (1) the mesh ----------------------------------------------------------------


def test_make_mesh_raises_without_cards():
    """No card here: ``make_mesh`` names the count it found and never falls
    back to the CPU; a mesh built directly may list one device per shard."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for make, args in ((make_mesh, (1,)), (make_mesh, ()), (make_multihost_mesh, (2, 2))):
        with pytest.raises(ValueError, match="only 0 CUDA device"):
            make(*args)
    mesh = StreamMesh([CPU] * 8)
    assert mesh.size == 8 and mesh.shape == {STREAM_AXIS: 8}
    grid = StreamMesh([[CPU, CPU], [CPU, CPU]], ("dcn", "ici"))
    assert grid.shape == {"dcn": 2, "ici": 2} and len(grid.shard_devices(("dcn", "ici"))) == 4
    with pytest.raises(ValueError, match="name every axis"):
        grid.shard_devices("ici")


# -- (2) stream dims ---------------------------------------------------------------


def _flat_port(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat_port(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, tuple):
        return {k: v for i, x in enumerate(tree) for k, v in _flat_port(x, f"{path}/{i}").items()}
    return {path: tree}


def _flat_jax(tree, axis, path=""):
    from jax.sharding import PartitionSpec as P

    if isinstance(tree, P):
        return {path: tree.index(axis) if axis in tree else None}
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat_jax(tree[key], axis, f"{path}/{key}").items()}
    return {k: v for i, x in enumerate(tree) for k, v in _flat_jax(x, axis, f"{path}/{i}").items()}


DIM_CONFIGS = {
    "literal default": EngineConfig(),
    "flagship": EngineConfig(
        spectrogram=SpectrogramConfig(fft_size=2048, hop_size=64, use_reassignment=False),
        spectrum=None, oscilloscope=None, stereometer=None, waveform=None, channels=2,
    ),
    "reassigned default": EngineConfig(spectrum=None, oscilloscope=None, stereometer=None, waveform=None,
                                       channels=2),
    "8192/512 per column": EngineConfig(
        spectrogram=SpectrogramConfig(fft_size=8192, hop_size=512), spectrum=None, oscilloscope=None,
        stereometer=None, waveform=None, channels=2,
    ),
    "spectrum hop > block": EngineConfig(channels=2, **{**NONE, "spectrum": SpectrumConfig(
        fft_size=1024, hop_size=512, averaging=AveragingMode.PEAK_HOLD)}),
    "spectrum held, dual trace": dataclasses.replace(graft_config(), spectrum=SpectrumConfig(
        fft_size=8192, hop_size=384, secondary_source=Channel.SIDE), sample_rate=48_000.0),
    "gating off, oscilloscope every 2nd hop": dataclasses.replace(
        graft_config(), loudness=LoudnessConfig(gating=False), oscilloscope=OscilloscopeConfig(trigger_every=2)),
    "oscilloscope with the probe slide, bands": graft_config(),
}


@pytest.mark.parametrize("name", list(DIM_CONFIGS))
def test_carry_stream_dims_match_jax_pspecs(name):
    """Path by path, each carry leaf's stream dim is the position of the
    JAX package's stream axis in its ``carry_pspecs`` (host scalars
    ``None``), and the three-point derivation from ``init`` shapes finds
    the same dims.  The port holds no classic-spectrogram sliding state,
    which the JAX package carries (``convert.RETIRED``)."""
    cfg = DIM_CONFIGS[name]
    engine = MeterEngine(cfg)
    dims = _flat_port(engine.carry_stream_dims())
    want = _flat_jax(JMeterEngine(to_jax(cfg)).carry_pspecs(STREAM_AXIS), STREAM_AXIS)
    assert dims == {k: v for k, v in want.items() if not k.startswith("/spectrogram/sdft/")}
    derived = _flat_port(derive_stream_dims(lambda s: engine.init(s, device="meta")))
    assert derived == dims
    assert set(dims) == set(_flat_port(engine.init(1, device="meta")))


def test_derive_stream_dims_refuses_an_affine_dim():
    """A dim of ``S + 1`` would join to the wrong shape: refused, named."""
    with pytest.raises(ValueError, match="leaf/x.*not in proportion"):
        derive_stream_dims(lambda s: {"leaf": {"x": torch.zeros((4, s + 1), device="meta")}})
    with pytest.raises(ValueError, match="in dims"):
        derive_stream_dims(lambda s: {"y": torch.zeros((s, 2 * s), device="meta")})


# -- (3) the sharded step ------------------------------------------------------------


@pytest.mark.parametrize("layout", ["streams", "dcn x ici"])
def test_sharded_step_matches_unsharded_and_jax(layout):
    """S=8 over four CPU shards for 40 hops, two streams of shard 1 reset
    at hop 20: every hop's snapshots against the unsharded port and the JAX
    package's ``sharded_step`` on its virtual mesh; the replicated host
    scalars stay equal on every shard and equal the unsharded carry's."""
    # the stereometer's bands off: its per-sample crossover loop is most of a
    # CPU step (the waveform's bands stay, with their [4, 1, 2, S, 2] state)
    cfg, s, hops = dataclasses.replace(graft_config(), stereometer=StereometerConfig()), 8, 40
    engine, jengine = MeterEngine(cfg), JMeterEngine(to_jax(cfg))
    if layout == "streams":
        mesh, axis, jmesh = StreamMesh([CPU] * 4), STREAM_AXIS, jsharding.make_mesh(4)
    else:
        axis = ("dcn", "ici")
        mesh, jmesh = StreamMesh([[CPU, CPU], [CPU, CPU]], axis), jsharding.make_multihost_mesh(2, 2)
    step, place = sharded_step(engine, mesh, axis=axis)
    jstep, jplace = jsharding.sharded_step(jengine, jmesh, axis=axis)
    carry, ref, jc = place(engine.init(s, device="cpu")), engine.init(s, device="cpu"), jplace(jengine.init(s))
    assert carry_device(carry) == [CPU] * 4 and len(carry) == 4
    meta, jmeta = metas(s)
    # finite audio: the reassigned bar does not hold columns of NaN power (the
    # served test below runs NaN samples through the classic spectrogram)
    audio = stereo_audio(s, hops * B, seed=31)
    for h in range(hops):
        block = np.ascontiguousarray(audio[:, h * B : (h + 1) * B])
        reset = np.zeros((s,), bool)
        if h == 20:
            reset[[2, 3]] = True
        rst = torch.from_numpy(reset) if reset.any() else None
        carry, snaps = step(carry, torch.from_numpy(block), meta, rst)
        ref, rsnaps = engine.step(ref, torch.from_numpy(block), meta, rst)
        jc, jsnaps = jstep(jc, block, jmeta, reset)
        ours = joined(engine, step, snaps, carry)
        check_snapshots(ours, with_traces(engine, rsnaps, ref), f"hop {h}, unsharded")
        jsnaps = jax.device_get(dict(jsnaps, oscilloscope=jengine.extract_oscilloscope(jc)))
        check_snapshots(ours, jsnaps, f"hop {h}, JAX")
    whole = gather_carry(engine, carry)
    for path, leaf in _flat_port(ref).items():
        if not isinstance(leaf, torch.Tensor):
            assert _flat_port(whole)[path] == leaf, path


def test_sharded_spectrum_and_scan_steps_match_unsharded_and_jax():
    """The cadenced spectrum (1024/512, two engine blocks a hop) through
    ``sharded_spectrum_step`` for 10 spectrum hops with per-hop reset masks
    in shard 2, and ``sharded_scan_step`` at ``scan_hops=4`` for 6
    advances, each against the unsharded port and the JAX package's."""
    cfg = EngineConfig(channels=2, **{**NONE, "loudness": LoudnessConfig(),
                                      "spectrum": SpectrumConfig(fft_size=1024, hop_size=512)})
    engine, jengine = MeterEngine(cfg), JMeterEngine(to_jax(cfg))
    assert engine.spectrum_cadence == 2
    s, mesh, jmesh = 8, StreamMesh([CPU] * 4), jsharding.make_mesh(4)
    meta, jmeta = metas(s)
    audio = stereo_audio(s, 44 * B, seed=32)

    step, place = sharded_step(engine, mesh)
    spec = sharded_spectrum_step(engine, mesh)
    jstep, jplace = jsharding.sharded_step(jengine, jmesh)
    jspec = jsharding.sharded_spectrum_step(jengine, jmesh)
    carry, ref, jc = place(engine.init(s, device="cpu")), engine.init(s, device="cpu"), jplace(jengine.init(s))
    for g in range(10):
        blocks = np.ascontiguousarray(audio[:, 2 * g * B : (2 * g + 2) * B].reshape(s, 2, B, 2).transpose(1, 0, 2, 3))
        resets = np.zeros((2, s), bool)
        if g == 5:
            resets[1, [4, 5]] = True
        for j in range(2):
            rst = torch.from_numpy(resets[j]) if resets[j].any() else None
            carry, _ = step(carry, torch.from_numpy(blocks[j]), meta, rst)
            ref, _ = engine.step(ref, torch.from_numpy(blocks[j]), meta, rst)
            jc, _ = jstep(jc, blocks[j], jmeta, resets[j])
        tb, tr = torch.from_numpy(blocks), torch.from_numpy(resets)
        sps, snaps = spec([c["spectrum"] for c in carry], tb, meta, tr)
        for c, sp in zip(carry, sps):
            c["spectrum"] = sp
        ref["spectrum"], rsnap = engine.spectrum_step(ref["spectrum"], tb, meta, tr)
        jsp, jsnap = jspec(jc["spectrum"], blocks, jmeta, resets)
        jc = dict(jc, spectrum=jsp)
        ours = {"spectrum": gather_snapshots(snaps, spec.snapshot_dims)}
        check_snapshots(ours, {"spectrum": rsnap}, f"spectrum hop {g}, unsharded")
        check_snapshots(ours, {"spectrum": jax.device_get(jsnap)}, f"spectrum hop {g}, JAX")

    scan, place = sharded_scan_step(engine, mesh, 4)
    jscan, jplace = jsharding.sharded_scan_step(jengine, jmesh, 4)
    inner = scan_last_snapshot_fn(engine)
    carry, ref, jc = place(engine.init(s, device="cpu")), engine.init(s, device="cpu"), jplace(jengine.init(s))
    for a in range(6):
        blocks = np.ascontiguousarray(audio[:, 4 * a * B : (4 * a + 4) * B].reshape(s, 4, B, 2).transpose(1, 0, 2, 3))
        resets = np.zeros((4, s), bool)
        if a == 3:
            resets[2, 6] = True
        tb, tr = torch.from_numpy(blocks), torch.from_numpy(resets)
        carry, snaps = scan(carry, tb, meta, tr)
        ref, rsnaps = inner(ref, tb, meta, tr)
        jc, jsnaps = jscan(jc, blocks, jmeta, resets)
        ours = gather_snapshots(snaps, scan.snapshot_dims)
        check_snapshots(ours, rsnaps, f"scan advance {a}, unsharded")
        check_snapshots(ours, jax.device_get(jsnaps), f"scan advance {a}, JAX")
    gather_carry(engine, carry)


def test_held_spectrum_advances_alike_on_every_shard():
    """The spectrum at hop 384 over 256-frame blocks holds its dB outputs
    between columns and slides, advancing its sliding ``count``, on a hop
    with a column or a reset anywhere in the batch.  A reset in shard 1 on
    a hop without a column (hop 7) slides every shard, so ``count`` stays
    one value across the shards, equal to the unsharded port's and the JAX
    package's unsharded step's; every hop's snapshot within the bars of
    both."""
    cfg = EngineConfig(channels=2, **{**NONE, "spectrum": SpectrumConfig(fft_size=1024, hop_size=384)})
    engine, jengine = MeterEngine(cfg), JMeterEngine(to_jax(cfg))
    s = 8
    meta, jmeta = metas(s)
    step, place = sharded_step(engine, StreamMesh([CPU] * 4))
    carry, ref, jc = place(engine.init(s, device="cpu")), engine.init(s, device="cpu"), jengine.init(s)
    audio = stereo_audio(s, 16 * B, seed=36)
    counts = []
    for h in range(16):
        block = np.ascontiguousarray(audio[:, h * B : (h + 1) * B])
        reset = np.zeros((s,), bool)
        if h in (7, 12):
            reset[[3] if h == 7 else [6]] = True
        rst = torch.from_numpy(reset) if reset.any() else None
        carry, snaps = step(carry, torch.from_numpy(block), meta, rst)
        ref, rsnaps = engine.step(ref, torch.from_numpy(block), meta, rst)
        jc, jsnaps = jengine.step(jc, block, jmeta, reset if reset.any() else None)
        ours = gather_snapshots(snaps, step.snapshot_dims)
        check_snapshots(ours, rsnaps, f"hop {h}, unsharded")
        check_snapshots(ours, jax.device_get(jsnaps), f"hop {h}, JAX")
        whole = gather_carry(engine, carry)  # raises if a shard's count left the others'
        count = whole["spectrum"]["sdft"]["count"]
        assert count == ref["spectrum"]["sdft"]["count"] == int(jc["spectrum"]["sdft"]["count"]), h
        counts.append(count)
    assert counts[7] == counts[6] + 1 and engine.analyzers["spectrum"]._held  # hop 7 slid on its reset


# -- (5) a JAX carry onto a port mesh ---------------------------------------------------


def test_jax_mesh_carry_continues_on_a_port_mesh():
    """A carry advanced 24 hops by the JAX ``sharded_step`` on an 8-device
    mesh, converted (``carry_from_jax``) and placed on four port shards,
    continues 16 hops as the JAX run does."""
    cfg = flagship_small(stereometer=StereometerConfig(), waveform=WaveformConfig())
    engine, jengine = MeterEngine(cfg), JMeterEngine(to_jax(cfg))
    s = 8
    meta, jmeta = metas(s)
    jstep, jplace = jsharding.sharded_step(jengine, jsharding.make_mesh(8))
    jc = jplace(jengine.init(s))
    audio = stereo_audio(s, 40 * B, seed=33)
    no_reset = np.zeros((s,), bool)
    for h in range(24):
        jc, _ = jstep(jc, np.ascontiguousarray(audio[:, h * B : (h + 1) * B]), jmeta, no_reset)
    mesh = StreamMesh([CPU] * 4)
    step, _ = sharded_step(engine, mesh)
    carry = place_carry(engine, mesh, carry_from_jax(jax.device_get(jc), engine, device="cpu"))
    for h in range(24, 40):
        block = np.ascontiguousarray(audio[:, h * B : (h + 1) * B])
        carry, snaps = step(carry, torch.from_numpy(block), meta)
        jc, jsnaps = jstep(jc, block, jmeta, no_reset)
        check_snapshots(gather_snapshots(snaps, step.snapshot_dims), jax.device_get(jsnaps), f"hop {h}")


# -- (6) the server over a mesh ----------------------------------------------------------


def served_config(**kw) -> EngineConfig:
    """Loudness, the classic 256/64 spectrogram, the spectrum at cadence 2,
    the stereometer and the waveform, at two channels."""
    kw = {"spectrum": SpectrumConfig(fft_size=1024, hop_size=512), "stereometer": StereometerConfig(),
          "waveform": WaveformConfig(), **kw}
    return tiny_engine(**kw)


def push(servers, i: int, audio: np.ndarray) -> None:
    ts = int(i * B / 48_000.0 * 1e9)
    for srv in servers:
        for st in range(audio.shape[0]):
            srv.transport.push_pcm(st, np.ascontiguousarray(audio[st, i * B : (i + 1) * B]), ts)


def jax_server(cfg: ServeConfig, n: int):
    """The JAX server on an ``n``-device mesh, its host buffers moved off
    64-byte alignment (see ``tests/test_torch_serve.py::pair``)."""
    srv = jserve.MeterServer(to_jax(cfg), mesh=jsharding.make_mesh(n))
    srv._buffers = [tuple(unaligned(a) for a in bufs) for bufs in srv._buffers]
    return srv


def test_sharded_server_matches_unsharded_and_jax(tmp_path):
    """``MeterServer`` over two CPU shards against one unsharded and the
    JAX server on a 2-device mesh, fed the same PCM (S=4, ``fetch="full"``,
    24 advances): the same ``last_meters`` layout and values at every
    advance, a generation reset in shard 1 at advance 6, an
    ``apply_settings_async`` adopted at advance 10, a declared view of a
    stream of shard 1, the display-clock spectrum and traces; then a
    checkpoint of a four-shard server restored into a two-shard one, which
    continues as an unsharded server restored from it and the JAX server on
    a 2-device mesh restored from it do."""
    s = 4
    cfg = ServeConfig(n_streams=s, channels=2, engine=served_config(oscilloscope=OscilloscopeConfig()),
                      realtime=False, fetch="full", fetch_every=2)
    sharded = MeterServer(cfg, mesh=StreamMesh([CPU] * 2), device="cpu")
    servers = [sharded, MeterServer(cfg, device="cpu"), jax_server(cfg, 2)]
    audio = stereo_audio(s, 40 * B, seed=34, bad=True)
    views = [srv.declare_view(stream=3, spectrogram_columns=64, waveform_columns=32) for srv in servers[:2]]
    assert views[0] == views[1]
    changed = served_config(oscilloscope=OscilloscopeConfig(), loudness=LoudnessConfig(floor_db=-60.0),
                            spectrum=SpectrumConfig(fft_size=1024, hop_size=512,
                                                    averaging=AveragingMode.PEAK_HOLD))
    try:
        assert [(sh.lo, sh.hi) for sh in sharded._shards] == [(0, 2), (2, 4)]
        for i in range(24):
            if i == 6:
                for srv in servers:
                    srv.transport.set_generation(3, 2)
            if i == 10:
                threads = [srv.apply_settings_async(dataclasses.replace(changed, channels=2))
                           for srv in servers[:2]]
                threads.append(servers[2].apply_settings_async(to_jax(changed)))
                for t in threads:
                    t.join()
            push(servers, i, audio)
            for srv in servers:
                srv.advance()
            ours, unsharded, ref = (srv.fetch_meters_now() for srv in servers)
            assert [k for k in ours] == [k for k in unsharded] == [k for k in ref]
            assert all(ours[k].shape == ref[k].shape for k in ref)
            check_meters(ours, unsharded, f"advance {i}, unsharded")
            check_meters(ours, ref, f"advance {i}, JAX")
        assert not sharded.reconfig_pending and sharded.engine.config.loudness.floor_db == -60.0
        assert sharded.stats.resets == servers[1].stats.resets == s + 1
        spectra = [srv.fetch_spectrum() for srv in servers[:2]]
        check_snapshots({"spectrum": spectra[0]}, {"spectrum": spectra[1]}, "fetch_spectrum")
        one = sharded.fetch_spectrum(stream=3)
        assert all(np.array_equal(a, b[3:4]) for a, b in zip(one, spectra[0]))
        traces = [srv.fetch_osc_traces() for srv in servers[:2]]
        check_snapshots({"oscilloscope": traces[0]}, {"oscilloscope": traces[1]}, "fetch_osc_traces")
        hists = [srv._view_histories for srv in servers[:2]]
        assert np.array_equal(hists[0]["spectrogram"].view(), hists[1]["spectrogram"].view())
        assert len(hists[0]["waveform"].columns) == len(hists[1]["waveform"].columns) > 0
    finally:
        for srv in servers:
            srv.close()

    # a four-shard server's checkpoint onto two shards, one device and the JAX mesh
    cfg4 = dataclasses.replace(cfg, engine=served_config(), fetch="meters")
    four = MeterServer(cfg4, mesh=StreamMesh([CPU] * 4), device="cpu")
    try:
        for i in range(12):
            push([four], i, audio)
            four.advance()
        path = str(tmp_path / "four.npz")
        four.checkpoint(path)
    finally:
        four.close()
    restored = [MeterServer(cfg4, mesh=StreamMesh([CPU] * 2), device="cpu"), MeterServer(cfg4, device="cpu"),
                jax_server(cfg4, 2)]
    try:
        for srv in restored:
            srv.restore(path)
        for i in range(12, 20):
            push(restored, i, audio)
            for srv in restored:
                srv.advance()
            ours, unsharded, ref = (srv.fetch_meters_now() for srv in restored)
            check_meters(ours, unsharded, f"restored, advance {i}, unsharded")
            check_meters(ours, ref, f"restored, advance {i}, JAX")
        assert restored[0].stats.resets == 0  # the restarted transport's first reset is the resume
    finally:
        for srv in restored:
            srv.close()


def test_sharded_server_refuses_an_uneven_cut():
    with pytest.raises(ValueError, match="do not divide over 2 shards"):
        MeterServer(ServeConfig(n_streams=3, engine=tiny_engine()), mesh=StreamMesh([CPU] * 2), device="cpu")
    engine = MeterEngine(tiny_engine())
    with pytest.raises(ValueError, match="do not divide over 4 shards"):
        place_carry(engine, StreamMesh([CPU] * 4), engine.init(6, device="cpu"))
    step, place = sharded_step(engine, StreamMesh([CPU] * 2))
    carry = place(engine.init(2, device="cpu"))
    with pytest.raises(ValueError, match="do not divide over 2 shards"):
        step(carry, torch.zeros((3, B, 2)), StreamMeta.default(3, channels=2, pad_channels=2))


def test_checkpoint_moves_across_mesh_sizes(tmp_path):
    """``save_state`` gathers a sharded carry; ``load_state`` then
    ``place_carry`` puts it on a mesh of another size, which continues as
    the uninterrupted run does (the JAX package's
    ``tests/test_views_cli.py::test_checkpoint_migrates_across_mesh_sizes``)."""
    cfg = flagship_small()
    engine, s = MeterEngine(cfg), 8
    meta, _ = metas(s)
    step4, place4 = sharded_step(engine, StreamMesh([CPU] * 4))
    step2, place2 = sharded_step(engine, StreamMesh([CPU] * 2))
    carry = place4(engine.init(s, device="cpu"))
    audio = stereo_audio(s, 30 * B, seed=35)
    blocks = [torch.from_numpy(np.ascontiguousarray(audio[:, h * B : (h + 1) * B])) for h in range(30)]
    for h in range(20):
        carry, _ = step4(carry, blocks[h], meta)
    path = str(tmp_path / "mesh4.npz")
    save_state(path, engine, carry)
    moved = place2(load_state(path, engine, device="cpu"))
    for h in range(20, 30):
        carry, snaps = step4(carry, blocks[h], meta)
        moved, msnaps = step2(moved, blocks[h], meta)
        check_snapshots(gather_snapshots(msnaps, step2.snapshot_dims),
                        gather_snapshots(snaps, step4.snapshot_dims), f"hop {h}")


# -- (7) replicated scalars --------------------------------------------------------------


def test_gather_carry_names_a_replicated_scalar_that_differs():
    engine = MeterEngine(graft_config())
    carry = place_carry(engine, StreamMesh([CPU] * 2), engine.init(4, device="cpu"))
    whole = gather_carry(engine, carry)
    assert whole["loudness"]["kw"].shape == engine.init(4, device="meta")["loudness"]["kw"].shape
    carry[1]["oscilloscope"]["tick"] += 1
    with pytest.raises(ValueError, match="/oscilloscope/tick is replicated but differs"):
        gather_carry(engine, carry)
    carry[1]["oscilloscope"]["tick"] -= 1
    carry[0]["spectrum"]["fb"]["origin"] = 5
    with pytest.raises(ValueError, match="/spectrum/fb/origin"):
        save_state("unused.npz", engine, carry)


# -- (8) the kernel wrappers' streams ------------------------------------------------------


def test_kernel_wrappers_launch_on_their_inputs_device_and_stream():
    """Every ``torch.cuda.current_stream`` call under
    ``openmeters_tpu_torch/ops/`` names a device, inside ``with
    torch.cuda.device(...)`` of that same device: a shard issued while
    another card is current still launches on its own card's stream."""
    calls = 0
    for path in sorted((REPO / "openmeters_tpu_torch" / "ops").glob("*.py")):
        tree = ast.parse(path.read_text())
        guarded = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.With):
                for item in node.items:
                    call = item.context_expr
                    if isinstance(call, ast.Call) and ast.unparse(call.func) == "torch.cuda.device":
                        dev = ast.unparse(call.args[0])
                        guarded |= {(id(n), dev) for stmt in node.body for n in ast.walk(stmt)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and ast.unparse(node.func).endswith("current_stream"):
                calls += 1
                where = f"{path.name}:{node.lineno}"
                assert node.args, f"{where}: current_stream() without a device"
                assert (id(node), ast.unparse(node.args[0])) in guarded, \
                    f"{where}: not under torch.cuda.device({ast.unparse(node.args[0])})"
    assert calls >= 7
