"""PyTorch port, the serving loop (``serve.py``): ``MeterServer(...,
device="cpu")`` against the JAX package's ``MeterServer``, both fed the
same deterministic pushes, mirroring the JAX package's own tests in
``tests/test_serve.py``.  Fetched meters are held to each other by the bars
of ``utils/parity.py`` (``check_meters``).  Nothing here waits on the wall
clock: ``realtime=False``, one pushed block an advance, and ``join()`` on
a reconfiguration's thread."""

import dataclasses
import hashlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_ingest_scenarios import SCENARIOS, assert_same_hops, run_copying, run_descriptors  # noqa: E402
from torch_pairs import NONE, stereo_audio, tiny_engine, to_jax, unaligned  # noqa: E402

from openmeters_tpu import serve as jserve  # noqa: E402
from openmeters_tpu import tracing as jtracing  # noqa: E402
from openmeters_tpu.ingest import transport as jingest  # noqa: E402
from openmeters_tpu_torch import serve as tserve  # noqa: E402
from openmeters_tpu_torch import tracing as ttracing  # noqa: E402
from openmeters_tpu_torch.analyzers.loudness import LoudnessConfig  # noqa: E402
from openmeters_tpu_torch.analyzers.spectrum import SpectrumConfig  # noqa: E402
from openmeters_tpu_torch.engine import EngineConfig, StreamMesh  # noqa: E402
from openmeters_tpu_torch.ingest import Transport  # noqa: E402
from openmeters_tpu_torch.serve import MeterServer, MultiRateMeterServer, ServeConfig  # noqa: E402
from openmeters_tpu_torch.utils.parity import (  # noqa: E402
    check_meters,
    check_spectrum,
    spectrum_errors,
)

REPO = Path(__file__).resolve().parents[1]
RATE, B = 48_000.0, 256


def pair(cfg: ServeConfig):
    """The JAX package's server and the port's on the CPU, one config.

    On the CPU ``jax.device_put`` of a 64-byte-aligned numpy array aliases
    it instead of copying, so the JAX server's device batches (and the
    blocks a cadenced spectrum holds for R hops) would change under it when
    the assembler refills its host buffers two advances later, and whether
    they do depends on where ``np.zeros`` happened to land.  Its host
    buffers are therefore moved off that alignment: every ``device_put``
    then copies, as it does onto an accelerator."""
    jax_server = jserve.MeterServer(to_jax(cfg))
    jax_server._buffers = [tuple(unaligned(a) for a in bufs) for bufs in jax_server._buffers]
    return jax_server, MeterServer(cfg, device="cpu")


def push(servers, i: int, block: np.ndarray) -> None:
    """Block ``i`` of each stream (``block [S, B, 2]``) into every server."""
    ts = int(i * B / RATE * 1e9)
    for srv in servers:
        for st in range(block.shape[0]):
            srv.transport.push_pcm(st, np.ascontiguousarray(block[st]), ts)


def hop(servers, i: int, block: np.ndarray, fetch: bool = True):
    push(servers, i, block)
    for srv in servers:
        srv.advance()
    return [srv.fetch_meters_now() for srv in servers] if fetch else None


def loudness_only(**kw) -> EngineConfig:
    return EngineConfig(channels=2, **{**NONE, "loudness": LoudnessConfig(), **kw})


def test_serve_end_to_end_matches_jax():
    """Display-rate drains every 4th hop, a generation reset on two
    streams at advance 20: the same drained meters, hop and reset counts."""
    cfg = ServeConfig(n_streams=8, engine=tiny_engine(), realtime=False, fetch="meters", fetch_every=4)
    servers = pair(cfg)
    drained = [[], []]
    for k, srv in enumerate(servers):
        srv.on_drain = lambda s, k=k: drained[k].append(s.last_meters())
    audio = stereo_audio(8, 40 * B, seed=21, bad=True)
    try:
        for i in range(40):
            if i == 20:
                for srv in servers:
                    for st in (2, 5):
                        srv.transport.set_generation(st, 2)
            hop(servers, i, audio[:, i * B : (i + 1) * B], fetch=False)
        reports = [srv.report() for srv in servers]
    finally:
        for srv in servers:
            srv.close()
    assert len(drained[0]) == len(drained[1]) == 10
    for n, (jm, tm) in enumerate(zip(*drained)):
        check_meters(tm, jm, f"drain {n}")
    for key in ("hops", "resets", "underruns", "streams", "audio_seconds"):
        assert reports[0][key] == reports[1][key], key
    assert reports[1]["resets"] == 8 + 2 and reports[1]["latency_ms_p50"] is not None
    assert servers[1].last_snapshot.size > 0


def test_serve_scan_hops_matches_jax():
    """Four engine steps an advance, the last snapshot kept."""
    cfg = ServeConfig(n_streams=4, engine=tiny_engine(), realtime=False, scan_hops=4, fetch="full",
                      fetch_every=8)
    servers = pair(cfg)
    audio = stereo_audio(4, 48 * B, seed=22)
    try:
        for a in range(12):
            push(servers, 4 * a, audio[:, 4 * a * B : (4 * a + 1) * B])
            for j in range(1, 4):
                push(servers, 4 * a + j, audio[:, (4 * a + j) * B : (4 * a + j + 1) * B])
            for srv in servers:
                srv.advance()
            jm, tm = (srv.fetch_meters_now() for srv in servers)
            check_meters(tm, jm, f"advance {a}")
        assert servers[1].stats.hops == servers[0].stats.hops == 48
    finally:
        for srv in servers:
            srv.close()


def test_serve_pause_gates_consumption():
    server = MeterServer(ServeConfig(n_streams=4, engine=tiny_engine(), realtime=False), device="cpu")
    try:
        server.set_paused(True)
        server.advance()
        assert server.stats.hops == 0
        server.set_paused(False)
        server.advance()
        assert server.stats.hops >= 1
    finally:
        server.close()


def test_serve_checkpoint_resume_continuous_lufs_matches_jax(tmp_path):
    """Checkpoint a server after 90 hops of a loud tone; a fresh server
    restores it and reads the loud window on through two quiet hops, where
    one that did not restore reads ~20 LU lower.  Both packages, and the
    port restoring the JAX package's checkpoint."""
    cfg = ServeConfig(n_streams=2, engine=loudness_only(), realtime=False, fetch="none")

    def tone(i: int, amp: float) -> np.ndarray:
        t = np.arange(i * B, (i + 1) * B, dtype=np.float64) / RATE
        x = (amp * np.sin(2.0 * np.pi * 997.0 * t)).astype(np.float32)
        return np.broadcast_to(np.stack([x, x], -1), (2, B, 2))

    key = "['loudness'].momentary_lufs"
    s1 = pair(cfg)
    for i in range(90):
        m = hop(s1, i, tone(i, 0.25))
    l1 = [np.asarray(x[key]) for x in m]
    check_meters(m[1], m[0], "before the checkpoint")
    paths = [str(tmp_path / f"{name}.npz") for name in ("jax", "port")]
    for srv, path in zip(s1, paths):
        srv.checkpoint(path)
        srv.close()
    s2 = pair(cfg)  # restarted processes
    s2[0].restore(paths[0])
    s2[1].restore(paths[1])
    from_jax = MeterServer(cfg, device="cpu")
    from_jax.restore(paths[0])
    control = MeterServer(cfg, device="cpu")  # no restore: the window starts empty
    servers = [*s2, from_jax, control]
    for i in range(90, 92):
        m = hop(servers, i, tone(i, 0.025))
    for srv in servers:
        srv.close()
    check_meters(m[1], m[0], "after the restore")
    check_meters(m[2], m[0], "the port restored from the JAX checkpoint")
    l2, l3 = np.asarray(m[1][key]), np.asarray(m[3][key])
    assert np.all(np.abs(l2 - l1[1]) < 0.3), (l1, l2)
    assert np.all(l3 < l1[1] - 15.0), (l1, l3)
    assert servers[1].stats.resets == 0  # the restarted transport's first reset is the resume


def test_serve_cadenced_spectrum_updates_every_r_hops_matches_jax():
    engine = EngineConfig(channels=2, **{**NONE, "loudness": LoudnessConfig(),
                                         "spectrum": SpectrumConfig(fft_size=1024, hop_size=1024)})
    cfg = ServeConfig(n_streams=2, engine=engine, realtime=False, fetch="full", fetch_every=1,
                      coalesce_blocks=1)
    servers = pair(cfg)
    assert servers[1].engine.spectrum_cadence == 4
    t = np.arange(0, 24 * B, dtype=np.float64) / RATE
    x = (0.5 * np.sin(2.0 * np.pi * 3000.0 * t)).astype(np.float32)
    stereo = np.stack([x, x], axis=-1)
    updated, raws = [], []
    try:
        for i in range(24):
            amp = 0.25 * (1 + i // 4)  # a new level each spectrum hop
            blk = amp * stereo[i * B : (i + 1) * B]
            jm, tm = hop(servers, i, np.broadcast_to(blk, (2, B, 2)))
            check_meters(tm, jm, f"hop {i}")
            updated.append(bool(tm["['spectrum'].updated"][0]))
            raws.append(tm["['spectrum'].raw_db"].copy())
    finally:
        for srv in servers:
            srv.close()
    assert updated == [i >= 3 for i in range(24)], updated
    for i in range(3):
        np.testing.assert_array_equal(raws[i], engine.spectrum.floor_db)
    for i in range(3, 24):
        np.testing.assert_array_equal(raws[i], raws[3 + 4 * ((i - 3) // 4)])
    peak = int(np.argmax(raws[-1][0, 0]))
    assert abs(np.fft.rfftfreq(1024, 1.0 / RATE)[peak] - 3000.0) < 100.0


def floor_change_setup():
    engine = EngineConfig(channels=2, **{**NONE, "loudness": LoudnessConfig(),
                                         "spectrum": SpectrumConfig(fft_size=1024, hop_size=1024)})
    cfg = ServeConfig(n_streams=2, engine=engine, realtime=False, fetch="full", fetch_every=1,
                      coalesce_blocks=1)
    t = np.arange(0, 48 * B, dtype=np.float64) / RATE
    x = (0.5 * np.sin(2.0 * np.pi * 997.0 * t)).astype(np.float32)
    stereo = np.stack([x, x], axis=-1)
    return engine, cfg, [np.broadcast_to(stereo[i * B : (i + 1) * B], (2, B, 2)) for i in range(48)]


def test_serve_apply_settings_live_floor_change_matches_jax():
    """A live floor change keeps the loudness window and the spectrum's PCM;
    the next spectrum hop re-emits the tone at the new floor."""
    engine, cfg, blocks = floor_change_setup()
    servers = pair(cfg)
    mom, raw = "['loudness'].momentary_lufs", "['spectrum'].raw_db"
    try:
        for i in range(16):
            m = hop(servers, i, blocks[i])
        before = float(m[1][mom][0])
        assert before > -10 and float(m[1][raw][0, 0].max()) > -30
        new = dataclasses.replace(engine, spectrum=dataclasses.replace(engine.spectrum, floor_db=-90.0))
        servers[0].apply_settings(to_jax(new))
        servers[1].apply_settings(new)
        assert servers[1].engine.config.spectrum.floor_db == -90.0
        for i in range(16, 24):
            m = hop(servers, i, blocks[i])
            check_meters(m[1], m[0], f"hop {i}")
            if i == 16:
                assert abs(float(m[1][mom][0]) - before) < 0.1
    finally:
        for srv in servers:
            srv.close()
    assert float(m[1][raw][0, 0].max()) > -30
    assert float(m[1][raw][0, 0].min()) == pytest.approx(-90.0)
    assert float(m[1][mom][0]) > -10


def test_serve_apply_settings_rejects_rate_change():
    engine = loudness_only()
    server = MeterServer(ServeConfig(n_streams=1, engine=engine, realtime=False), device="cpu")
    try:
        with pytest.raises(ValueError, match="sample_rate"):
            server.apply_settings(dataclasses.replace(engine, sample_rate=96_000.0, block_frames=512))
    finally:
        server.close()


def test_serve_apply_settings_async_swaps_at_hop_boundary_matches_jax():
    """The old engine serves while the new one warms on its own thread; the
    next advance adopts it with the carry kept."""
    engine, cfg, blocks = floor_change_setup()
    servers = pair(cfg)
    mom, raw = "['loudness'].momentary_lufs", "['spectrum'].raw_db"
    try:
        for i in range(16):
            m = hop(servers, i, blocks[i])
        before = float(m[1][mom][0])
        new = dataclasses.replace(engine, spectrum=dataclasses.replace(engine.spectrum, floor_db=-90.0))
        threads = [servers[0].apply_settings_async(to_jax(new)), servers[1].apply_settings_async(new)]
        assert servers[1].reconfig_pending
        with pytest.raises(RuntimeError, match="already in flight"):
            servers[1].apply_settings_async(engine)
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
        assert servers[1].reconfig_pending and servers[1].engine.config.spectrum.floor_db == -100.0
        for i in range(16, 26):
            m = hop(servers, i, blocks[i])  # hop 16 adopts the staged swap
            check_meters(m[1], m[0], f"hop {i}")
            assert not servers[1].reconfig_pending
        assert servers[1].engine.config.spectrum.floor_db == -90.0
    finally:
        for srv in servers:
            srv.close()
    assert abs(float(m[1][mom][0]) - before) < 0.5
    assert float(m[1][raw][0, 0].min()) == pytest.approx(-90.0)


def test_serve_apply_settings_async_validation_is_synchronous():
    server = MeterServer(ServeConfig(n_streams=1, engine=tiny_engine(), realtime=False), device="cpu")
    try:
        with pytest.raises(ValueError, match="sample_rate"):
            server.apply_settings_async(dataclasses.replace(tiny_engine(), sample_rate=96_000.0,
                                                            block_frames=512))
        assert not server.reconfig_pending
    finally:
        server.close()


@pytest.mark.parametrize("hop_size", [256, 1024], ids=["fused", "cadenced"])
def test_fetch_spectrum_display_clock_matches_jax(hop_size):
    engine = tiny_engine(spectrum=SpectrumConfig(fft_size=2048, hop_size=hop_size))
    servers = pair(ServeConfig(n_streams=2, engine=engine, realtime=False, fetch="meters"))
    t = np.arange(B * 80) / RATE
    x = (0.5 * np.sin(2 * np.pi * 997.0 * t)).astype(np.float32)
    audio = np.broadcast_to(np.stack([x, x], -1), (2, B * 80, 2))
    try:
        for i in range(80):
            hop(servers, i, audio[:, i * B : (i + 1) * B], fetch=False)
        jsnap, tsnap = (srv.fetch_spectrum() for srv in servers)
    finally:
        for srv in servers:
            srv.close()
    check_spectrum(spectrum_errors(None, None, tsnap, jsnap), f"hop {hop_size}")
    raw = tsnap.raw_db
    assert isinstance(raw, np.ndarray) and raw.shape == (2, 1, 1025) and np.isfinite(raw).all()
    assert abs(int(np.argmax(raw[0, 0])) - 42.5) < 2.0


def test_fetch_spectrum_and_traces_without_their_analyzers():
    server = MeterServer(ServeConfig(n_streams=1, engine=tiny_engine(), realtime=False, fetch="none"),
                         device="cpu")
    try:
        assert server.fetch_spectrum() is None and server.fetch_osc_traces() is None
    finally:
        server.close()


def test_multirate_lufs_both_buckets_matches_jax():
    """One engine a rate: a 44.1 kHz and a 48 kHz producer each read their
    level (a 44.1 kHz stream through a 48 kHz engine would read ~0.4 LU
    off).  The producers push into their bucket's transport directly (the
    socket runtime is not ported)."""
    cfg = ServeConfig(n_streams=2, engine=loudness_only(), realtime=False, fetch="meters", fetch_every=2)
    servers = [jserve.MultiRateMeterServer(to_jax(cfg), rates=(44_100.0, 48_000.0)),
               MultiRateMeterServer(cfg, rates=(44_100.0, 48_000.0), device="cpu")]
    for srv in servers[0].servers.values():  # see pair()
        srv._buffers = [tuple(unaligned(a) for a in bufs) for bufs in srv._buffers]
    key = "['loudness'].momentary_lufs"
    try:
        for i in range(100):
            for m in servers:
                for rate, srv in m.servers.items():
                    b = srv.engine.config.block_frames
                    t = np.arange(i * b, (i + 1) * b, dtype=np.float64) / rate
                    x = (0.5 * np.sin(2 * np.pi * 997.0 * t)).astype(np.float32)
                    srv.transport.push_pcm(0, np.stack([x, x], -1), int(i * b / rate * 1e9))
            for m in servers:
                m.advance()
        meters = {rate: [m.servers[rate].fetch_meters_now() for m in servers] for rate in (44_100.0, 48_000.0)}
        reports = [m.report() for m in servers]
    finally:
        for m in servers:
            m.close()
    assert set(reports[1]) == {44_100.0, 48_000.0}
    assert servers[1].servers[44_100.0].engine.config.block_frames == 235
    for rate, (jm, tm) in meters.items():
        check_meters(tm, jm, f"{rate} Hz")
        assert abs(float(tm[key][0]) + 6.0) < 0.5, (rate, tm[key])
        assert reports[1][rate]["hops"] == reports[0][rate]["hops"] == 100


def test_multirate_apply_settings_per_bucket(tmp_path):
    cfg = ServeConfig(n_streams=1, engine=tiny_engine(), realtime=False)
    server = MultiRateMeterServer(cfg, rates=(48_000.0, 44_100.0), device="cpu")
    try:
        blocks = {r: s.engine.config.block_frames for r, s in server.servers.items()}
        server.apply_settings(tiny_engine(spectrogram=None))
        for r, s in server.servers.items():
            assert "spectrogram" not in s.engine.analyzers
            assert s.engine.config.sample_rate == r and s.engine.config.block_frames == blocks[r]
            assert not s.reconfig_pending
    finally:
        server.close()
    # the socket runtime serves both buckets (tests/test_torch_cli.py drives it)
    sock = tmp_path / "x.sock"
    server = MultiRateMeterServer(cfg, rates=(48_000.0, 44_100.0), socket_path=str(sock), device="cpu")
    try:
        assert sock.exists() and set(server.runtime.view()["rates"]) == {44_100.0, 48_000.0}
    finally:
        server.close()
    assert not sock.exists()
    # a mesh cuts each bucket's streams over its shards
    # (tests/test_torch_sharding.py holds the meters against an unsharded server's)
    server = MultiRateMeterServer(dataclasses.replace(cfg, n_streams=2), rates=(48_000.0, 44_100.0),
                                  mesh=StreamMesh(["cpu", "cpu"]), device="cpu")
    try:
        server.advance()
        for s in server.servers.values():
            assert [(sh.lo, sh.hi) for sh in s._shards] == [(0, 1), (1, 2)]
            assert s.fetch_meters_now()["['loudness'].momentary_lufs"].shape == (2,)
    finally:
        server.close()


@pytest.mark.parametrize("fetch", ["full", "meters"])
def test_last_meters_layout_matches_jax_for_the_literal_default(fetch):
    """The literal ``EngineConfig()`` at S=2 (two channels): the port's
    fetched leaves, by name and shape in order, are the JAX package's,
    whose layout comes from the shapes of its step and spectrum step."""
    import jax

    from openmeters_tpu.engine import MeterEngine as JMeterEngine
    from openmeters_tpu.engine import StreamMeta as JStreamMeta

    s = 2
    server = MeterServer(ServeConfig(n_streams=s, engine=EngineConfig(), fetch=fetch), device="cpu")
    server.close()
    je = JMeterEngine(to_jax(dataclasses.replace(EngineConfig(), channels=2)))
    meta = JStreamMeta.default(s, channels=2, pad_channels=2)
    carry = jax.eval_shape(lambda: je.init(s))
    _, snaps = jax.eval_shape(je.step, carry, jax.ShapeDtypeStruct((s, B, 2), np.float32), meta)
    _, sp = jax.eval_shape(je.spectrum_step, carry["spectrum"],
                           jax.ShapeDtypeStruct((je.spectrum_cadence, s, B, 2), np.float32), meta)
    snaps = dict(snaps, spectrum=sp)
    mask = jserve._meter_leaf_mask(snaps, s)
    picked = [True] * len(mask) if fetch == "full" else mask
    paths, _ = jax.tree_util.tree_flatten_with_path(snaps)
    want = [(jax.tree_util.keystr(p), tuple(leaf.shape)) for (p, leaf), m in zip(paths, picked) if m]
    assert server._packed_layout == want


@pytest.mark.parametrize("channels,names", [(2, ["FR", "FR"]), (6, ["FL", "UNKNOWN", "FL", "LFE"]),
                                            (8, []), (3, ["AUX0", "MONO", "AUX0"])])
def test_normalize_positions_matches_jax(channels, names):
    from openmeters_tpu.utils.channels import ChannelPosition as JPos
    from openmeters_tpu.utils.channels import normalize_positions as jnorm
    from openmeters_tpu_torch.utils.channels import ChannelPosition, normalize_positions

    ours = normalize_positions(channels, [ChannelPosition(n) for n in names])
    ref = jnorm(channels, [JPos(n) for n in names])
    assert [p.value for p in ours] == [p.value for p in ref]


def test_serve_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeterServer(ServeConfig(n_streams=1, engine=tiny_engine()))
    # nor over a mesh: a server never falls back to the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeterServer(ServeConfig(n_streams=2, engine=tiny_engine()), mesh=StreamMesh(["cpu", "cpu"]))
    with pytest.raises(ValueError, match="a mesh of"):
        MeterServer(ServeConfig(n_streams=2, engine=tiny_engine()), mesh=StreamMesh(["cuda:0"] * 2), device="cpu")


def test_set_stream_layout_matches_jax():
    """A producer renegotiates stream 1 to mono: its fold and weights change
    on the next hop in both packages."""
    from openmeters_tpu.utils.channels import ChannelPosition as JPos
    from openmeters_tpu_torch.utils.channels import ChannelPosition

    cfg = ServeConfig(n_streams=2, engine=loudness_only(), realtime=False, fetch="meters")
    servers = pair(cfg)
    audio = stereo_audio(2, 30 * B, seed=23)
    try:
        servers[0].set_stream_layout(1, 2, [JPos.FRONT_RIGHT, JPos.FRONT_RIGHT])
        servers[1].set_stream_layout(1, 2, [ChannelPosition.FRONT_RIGHT, ChannelPosition.FRONT_RIGHT])
        assert servers[1]._meta_fold.tolist() == np.asarray(servers[0]._meta_fold).tolist()
        for i in range(30):
            m = hop(servers, i, audio[:, i * B : (i + 1) * B])
            check_meters(m[1], m[0], f"hop {i}")
    finally:
        for srv in servers:
            srv.close()


# -- copies of the JAX package's host code -----------------------------------------


@pytest.mark.parametrize("name", ["feeder.cpp"])
def test_ingest_sources_are_byte_identical(name):
    ours = (REPO / "openmeters_tpu_torch" / "ingest" / name).read_bytes()
    ref = (REPO / "openmeters_tpu" / "ingest" / name).read_bytes()
    assert hashlib.sha256(ours).digest() == hashlib.sha256(ref).digest()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_transport_matches_jax(name):
    """The port's ``transport.cpp`` parts from the JAX package's by design
    (one ring arena, the descriptor pass, deferred release): fed the same
    pushes, its descriptor pass with the plain gather gives the JAX
    package's batches, masks, live counts and push results, hop by hop."""
    script = SCENARIOS[name]()
    ref = run_copying(jingest.Transport(**script.transport), script)
    assert_same_hops(run_descriptors(Transport(**script.transport), script), ref, f"{name}, descriptors")


def test_serve_config_fields_and_defaults_match():
    ours = [(f.name, f.default) for f in dataclasses.fields(ServeConfig)]
    ref = [(f.name, f.default) for f in dataclasses.fields(jserve.ServeConfig)]
    assert ours == ref


def test_ingest_benchmark_runs_and_reports_the_same_keys():
    ours = tserve.ingest_benchmark(n_streams=8, duration_s=0.2, feeder_threads=1)
    ref = jserve.ingest_benchmark(n_streams=8, duration_s=0.2, feeder_threads=1)
    assert set(ours) == set(ref)
    assert ours["hops"] > 0 and ours["faults"] == 0


def test_tracing_matches_jax():
    ours, ref = ttracing.EngineStats(), jtracing.EngineStats()
    for stats in (ours, ref):
        for r in range(5):
            stats.record(8, 256, 48_000.0, resets=r % 2, underruns=1, wall_dt=0.001)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.realtime_factor == ref.realtime_factor
