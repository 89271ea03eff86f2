"""The loudness step with its ring indices on the device
(``LoudnessAnalyzer.step`` with ``cadence``'s index tensor): held to the
host-int step it replaced (``torch_loudness_hostint.py``), bit for bit
where the arithmetic is the same; the branch patterns and indices against
a plain host computation; and the graph runner's eager route, its counts
and its spans off a card (its graphs are held to the eager step on the
card, in ``test_torch_cuda.py``)."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from torch_loudness_hostint import loudness_step

from openmeters_tpu_torch.analyzers.loudness import (
    DEFAULT_WINDOWS_SECONDS,
    LoudnessAnalyzer,
    LoudnessConfig,
    window_length,
)
from openmeters_tpu_torch.engine import EngineConfig, MeterEngine, StreamMeta

S = 5
EPS = float(np.finfo(np.float32).eps)
# the chunk energies: the boundary's partial sum is a masked sum over the
# whole hop where the host-int step summed a slice, so its rounding may
# differ (at 48 kHz every boundary offset is a multiple of 64 and the two
# sums agree bit for bit)
CHUNK_ENERGIES = ("['gate']['chunk_e']", "['gate']['ring']")


def _hops(rate, block, hops, seed):
    rng = np.random.default_rng(seed)
    gains = 10.0 ** rng.uniform(-4.0, 0.0, (hops, S, 1, 1))
    audio = (rng.standard_normal((hops, S, block, 2)) * gains).astype(np.float32)
    resets = {70: [True, True, False, False, True], 71: [False, True, False, False, False],
              120: [False, False, True, False, False]}
    return [(torch.from_numpy(audio[i]), torch.tensor(resets[i]) if i in resets else None) for i in range(hops)]


def _leaves(carry, snap):
    return [(pytree.keystr(p), v) for p, v in pytree.tree_flatten_with_path(carry)[0]] + list(snap._asdict().items())


@pytest.mark.parametrize("rate,block,gating", [(48_000.0, 256, True), (48_000.0, 256, False), (44_100.0, 235, True)])
def test_indexed_step_matches_the_host_int_step(rate, block, gating):
    """160 hops at S=5, a reset mask at hops 70, 71 and 120: every carry and
    snapshot leaf of every hop, over each re-reduction and each chunk
    crossing (at 48 kHz every boundary offset, 64 to 256 frames)."""
    an = LoudnessAnalyzer(LoudnessConfig(sample_rate=rate, block_frames=block, channels=2, gating=gating))
    weights = torch.tensor([[1.0, 1.0], [1.0, 1.41], [1.41, 0.0], [1.0, 1.0], [0.5, 1.0]])
    ours, ref = an.init(S), an.init(S)
    patterns, offsets = set(), set()
    for i, (blk, rst) in enumerate(_hops(rate, block, 160, seed=int(rate) + block)):
        pattern, ints = an.cadence(ours)
        patterns.add((*pattern, rst is not None))
        if gating and pattern[1]:
            offsets.add(ints[an._windows.n_indices])  # noqa: SLF001
        ours, snap = an.step(ours, blk, weights, rst)
        ref, ref_snap = loudness_step(an, ref, blk, weights, rst)
        for (name, a), (_, b) in zip(_leaves(ours, snap), _leaves(ref, ref_snap), strict=True):
            if not isinstance(a, torch.Tensor):
                assert a == b, (i, name)
            elif name in CHUNK_ENERGIES:
                # within one rounding of the stream's closed-chunk energy
                scale = torch.maximum(ref["gate"]["ring"].abs().amax(dim=1), ref["gate"]["chunk_e"].abs())
                scale = scale if a.dim() == 1 else scale[:, None]
                assert bool(((a - b).abs() <= EPS * scale).all()), (i, name)
            else:
                assert torch.equal(a, b), (i, name)
    assert {p[0] for p in patterns} == {False, True}
    assert {p[-1] for p in patterns} == {False, True}
    if gating:
        assert {p[1] for p in patterns} == {False, True}
    if rate == 48_000.0 and gating:
        assert offsets == {64, 128, 192, 256}


def test_cadence_matches_a_plain_host_computation():
    """The pattern and the indices of 2,400 hops (the common period of the
    32-push re-reduction and the 75-hop cycle of the chunk boundary at
    48 kHz), from the analyzer's host ints, against the same numbers
    computed plainly from the hop count."""
    b, cl, k_ring = 256, 4800, 30
    an = LoudnessAnalyzer(LoudnessConfig(channels=2))
    lengths = [window_length(48_000.0, sec) for sec in DEFAULT_WINDOWS_SECONDS]
    qr = [(w // b, w % b) for w in lengths]
    k = max(q + 1 for q, _ in qr)
    carry = {"wm": {"head": 0}, "gate": {"chunk_pos": 0, "ring_idx": 0}}
    pos = ring = 0
    crossings = set()
    for n in range(2400):
        pattern, ints = an.cadence(carry)
        leave = [(n - q) % k for q, _ in qr if q > 0]
        pick = [((n - q) % k) * len(qr) + w for w, (q, r) in enumerate(qr) if r > 0]
        crossing = pos + b >= cl
        assert pattern == ((n + 1) % 32 == 0, crossing), n
        assert ints == [n % k, *leave, *pick, cl - pos, *((ring - j) % k_ring for j in range(4))], n
        if crossing:
            crossings.add(cl - pos)
            pos, ring = pos + b - cl, (ring + 1) % k_ring
        else:
            pos += b
        carry = an.advanced(carry, carry)
        assert carry == {"wm": {"head": n + 1}, "gate": {"chunk_pos": pos, "ring_idx": ring}}, n
    assert len(crossings) == 4 and math.gcd(b, cl) == 64


def test_engine_steps_loudness_eagerly_off_a_card():
    """On the CPU the engine's loudness step is the analyzer's, counted as
    eager and named ``analyzers.loudness.eager`` under a profiler; the
    server's report carries the counts."""
    from torch.profiler import profile

    from openmeters_tpu_torch.serve import MeterServer, ServeConfig

    engine = MeterEngine(EngineConfig(spectrogram=None, spectrum=None, oscilloscope=None, stereometer=None,
                                      waveform=None, channels=2))
    meta = StreamMeta.default(S, channels=2, pad_channels=2)
    analyzer = engine.analyzers["loudness"]
    carry, ref = engine.init(S, device="cpu"), analyzer.init(S)
    with profile() as prof:
        for blk, _ in _hops(48_000.0, 256, 3, seed=5):
            carry, snaps = engine.step(carry, blk, meta)
            ref, ref_snap = analyzer.step(ref, blk, meta.weights)
    names = [e.name for e in prof.events()]
    assert names.count("analyzers.loudness.eager") == names.count("analyzers.loudness") == 3
    assert "analyzers.loudness.replay" not in names
    assert engine.loudness_graphs.counts == {"replays": 0, "eager": 3, "captures": 0, "rebinds": 0}
    for (name, a), (_, b) in zip(_leaves(carry["loudness"], snaps["loudness"]), _leaves(ref, ref_snap), strict=True):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, name

    cfg = ServeConfig(n_streams=4, engine=engine.config, realtime=False, coalesce_blocks=1)
    server = MeterServer(cfg, device="cpu")
    try:
        for _ in range(3):
            server.advance()
        counts = server.report()["loudness_graphs"]
    finally:
        server.close()
    assert counts == {"replays": 0, "eager": 2 + 3, "captures": 0, "rebinds": 0}  # warm-up and served hops
