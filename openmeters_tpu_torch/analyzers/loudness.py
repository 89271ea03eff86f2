"""BS.1770-5 loudness suite, batched over streams (port of
``analyzers/loudness.py``).

K-weighted short-term (3 s) and momentary (0.4 s) LUFS with surround
channel weights, per-channel RMS fast (0.3 s) / slow (1 s), 4x/2x
oversampled true peak, and gated integrated loudness with LRA.  The
K-weighting runs as the lifted block state-space form with ``lift = B``:
one hop is four small matrix products (``ops/iir.py``).
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import NamedTuple

import torch

from openmeters_tpu_torch.ops.gating import GatedLoudness
from openmeters_tpu_torch.ops.iir import flush_denormal_state, lifted_iir_scan
from openmeters_tpu_torch.ops.truepeak import TruePeakKernel
from openmeters_tpu_torch.ops.windowed import BlockWindowedMeans
from openmeters_tpu_torch.tracing import span
from openmeters_tpu_torch.utils.channels import MAX_AUDIO_CHANNELS
from openmeters_tpu_torch.utils.level import power_to_db
from openmeters_tpu_torch.utils.migrate import carry_device
from openmeters_tpu_torch.utils.weighting import k_weighting_sos

LOUDNESS_OFFSET = -0.691
DEFAULT_FLOOR_DB = -99.9
# short-term, momentary, RMS-fast, RMS-slow
DEFAULT_WINDOWS_SECONDS = (3.0, 0.4, 0.3, 1.0)


def window_length(sample_rate: float, seconds: float) -> int:
    n = sample_rate * seconds
    return 1 if n < 1.0 else int(n)


class LoudnessSnapshot(NamedTuple):
    short_term_lufs: torch.Tensor  # [S]
    momentary_lufs: torch.Tensor  # [S]
    rms_fast_db: torch.Tensor  # [S, C]
    rms_slow_db: torch.Tensor  # [S, C]
    true_peak_db: torch.Tensor  # [S, C]
    integrated_lufs: torch.Tensor  # [S] gated (-70 abs, -10 rel)
    lra_lu: torch.Tensor  # [S] EBU Tech 3342 loudness range


@dataclasses.dataclass(frozen=True)
class LoudnessConfig:
    sample_rate: float = 48_000.0
    floor_db: float = DEFAULT_FLOOR_DB
    block_frames: int = 256
    channels: int = MAX_AUDIO_CHANNELS
    gating: bool = True  # integrated loudness + LRA state


@dataclasses.dataclass(frozen=True)
class LoudnessAnalyzer:
    config: LoudnessConfig = LoudnessConfig()

    @property
    def _windows(self) -> BlockWindowedMeans:
        cfg = self.config
        lengths = tuple(window_length(cfg.sample_rate, s) for s in DEFAULT_WINDOWS_SECONDS)
        return BlockWindowedMeans(cfg.block_frames, lengths)

    @property
    def _kw_coeffs(self):
        sos = k_weighting_sos(self.config.sample_rate)
        return tuple(
            (float(s[0]), float(s[1]), float(s[2]), float(s[4]), float(s[5])) for s in sos
        )

    @property
    def _truepeak(self) -> TruePeakKernel:
        return TruePeakKernel(self.config.sample_rate)

    @property
    def _gate(self) -> GatedLoudness:
        cfg = self.config
        return GatedLoudness(
            sample_rate=cfg.sample_rate,
            block_frames=cfg.block_frames,
            floor_db=cfg.floor_db,
        )

    def init(self, n_streams: int, device=None) -> dict:
        c = self.config.channels
        out = {
            "kw": torch.zeros((4, n_streams, c), dtype=torch.float32, device=device),
            "wm": self._windows.init((n_streams, c), device=device),
            "tp": self._truepeak.init((n_streams, c), device=device),
        }
        if self.config.gating:
            out["gate"] = self._gate.init(n_streams, device=device)
        return out

    def migrate_from(self, old: "LoudnessAnalyzer", carry: dict, n_streams: int):
        """A floor change keeps the whole window state (the floor gates
        the dB conversion only); a gating toggle keeps the filter, window
        and true-peak state and starts the gate afresh.  Any other change
        starts over (``None``)."""
        a, b = old.config, self.config
        if a == b:
            return carry
        if dataclasses.replace(a, floor_db=b.floor_db, gating=b.gating) != b:
            return None
        out = {k: carry[k] for k in ("kw", "wm", "tp")}
        if b.gating:
            out["gate"] = (
                carry["gate"] if a.gating
                else self._gate.init(n_streams, device=carry_device(carry))
            )
        return out

    def cadence(self, carry: dict) -> tuple[tuple, list[int]]:
        """The hop's branch pattern and its ring indices, both from the
        carry's host ints: the pattern is whether the windows re-reduce and,
        with gating, whether a 100 ms chunk closes; the indices are the
        windows' (:meth:`BlockWindowedMeans.cadence`) then the gate's
        (:meth:`GatedLoudness.cadence`)."""
        refresh, ints = self._windows.cadence(carry["wm"]["head"])
        if not self.config.gating:
            return (refresh,), ints
        gate = carry["gate"]
        crossing, more = self._gate.cadence(gate["chunk_pos"], gate["ring_idx"])
        return (refresh, crossing), ints + more

    def advanced(self, carry: dict, after: dict) -> dict:
        """``after`` (a carry's tensors) with the host ints that follow a hop
        of ``carry``."""
        out = dict(after, wm=dict(after["wm"], head=carry["wm"]["head"] + 1))
        if self.config.gating:
            pos, ring_idx = self._gate.next_cadence(carry["gate"]["chunk_pos"], carry["gate"]["ring_idx"])
            out["gate"] = dict(after["gate"], chunk_pos=pos, ring_idx=ring_idx)
        return out

    def step(self, carry: dict, block, channel_weights, reset_mask=None, idx=None):
        """One hop of ``block [S, B, C]`` raw channel samples with
        ``channel_weights [S, C]``; ``reset_mask [S]`` restarts streams.
        ``idx``: :meth:`cadence`'s indices as an int64 tensor on the block's
        device, made here when not given.  The host ints of ``carry`` choose
        the branches; the ring rows come from ``idx`` alone, so a CUDA graph
        of one pattern replays at every hop of that pattern
        (:class:`LoudnessGraphs`).

        Returns ``(carry, LoudnessSnapshot)``."""
        cfg = self.config
        s, b, c = block.shape
        if (b, c) != (cfg.block_frames, cfg.channels):
            raise ValueError(f"block [S, {b}, {c}], want [S, {cfg.block_frames}, {cfg.channels}]")
        floor = cfg.floor_db
        if idx is None:
            idx = _to_device(self.cadence(carry)[1], block.device)
        wm = self._windows
        n_wm = wm.n_indices

        lane_reset = None
        if reset_mask is not None:
            lane_reset = reset_mask[:, None].expand(s, c)

        x = block.permute(1, 0, 2).to(torch.float32)  # [B, S, C]
        kw_state = carry["kw"]
        if lane_reset is not None:
            kw_state = torch.where(lane_reset, 0.0, kw_state)
        filtered, kw_state = lifted_iir_scan(x, kw_state, self._kw_coeffs, lift=b)
        kw_state = flush_denormal_state(kw_state)

        k2 = filtered * filtered
        wm_carry = wm.push_block(carry["wm"], k2, lane_reset, idx[:n_wm])
        means = wm.means(wm_carry, idx[1 + wm.n_leaves : n_wm])  # [4, S, C] mean squares

        tp_carry, peak = self._truepeak.process_block(carry["tp"], x, lane_reset)

        lufs_in = torch.sum(means[:2] * channel_weights[None], dim=-1)  # [2, S]
        lufs = torch.where(
            lufs_in > 0.0,
            torch.clamp_min(
                LOUDNESS_OFFSET
                + 10.0 * torch.log(torch.clamp_min(lufs_in, 1e-45)) / math.log(10.0),
                floor,
            ),
            floor,
        )

        new_carry = {"kw": kw_state, "wm": wm_carry, "tp": tp_carry}
        if cfg.gating:
            wk2 = torch.einsum("bsc,sc->sb", k2, channel_weights.to(torch.float32))
            gate_carry = self._gate.push_block(carry["gate"], wk2, reset_mask, idx[n_wm:])
            new_carry["gate"] = gate_carry
            integrated = gate_carry["integrated"]
            lra = gate_carry["lra"]
        else:
            integrated = torch.full((s,), floor, dtype=torch.float32, device=block.device)
            lra = torch.zeros((s,), dtype=torch.float32, device=block.device)

        snapshot = LoudnessSnapshot(
            short_term_lufs=lufs[0],
            momentary_lufs=lufs[1],
            rms_fast_db=power_to_db(means[2], floor),
            rms_slow_db=power_to_db(means[3], floor),
            true_peak_db=power_to_db(peak * peak, floor),
            integrated_lufs=integrated,
            lra_lu=lra,
        )
        return new_carry, snapshot


def _to_device(ints: list[int], device: torch.device) -> torch.Tensor:
    """``ints`` as an int64 tensor on ``device``; to a card from pinned
    memory, without waiting for it (the caching host allocator keeps the
    buffer until the copy has run)."""
    host = torch.tensor(ints, dtype=torch.int64)
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def _pairs(static: dict, carry: dict):
    """``(static leaf, carry leaf)`` for each tensor leaf of two carries of
    one structure."""
    for key, leaf in static.items():
        if isinstance(leaf, dict):
            yield from _pairs(leaf, carry[key])
        elif isinstance(leaf, torch.Tensor):
            yield leaf, carry[key]


class LoudnessGraphs:
    """The loudness step of one engine, replayed from CUDA graphs on a card.

    A graph set (:class:`_GraphSet`) holds one device's static carry, block,
    weights, reset mask and index tensor at one stream count, and a graph
    for each branch pattern the config reaches (:meth:`LoudnessAnalyzer.cadence`,
    and a reset mask given or not: at most 8), recorded when the set is made.
    A carry that is no set's last output (the first hop, a restore, a
    migration) is copied into the static carry of a set whose last output
    nobody holds any more (a rebind); where every set of its device and
    stream count is held, a new set is made.  Off a card the step runs
    eagerly: the same function, its indices made from the host ints.

    ``counts``: graph replays, eager steps, graphs recorded, rebinds."""

    def __init__(self):
        self.counts = dict.fromkeys(("replays", "eager", "captures", "rebinds"), 0)
        self._sets: dict = {}  # (device, n_streams) -> [_GraphSet]

    def step(self, analyzer: LoudnessAnalyzer, carry: dict, block, channel_weights, reset_mask=None):
        """:meth:`LoudnessAnalyzer.step`, by a graph on a card."""
        if block.device.type != "cuda":
            self.counts["eager"] += 1
            with span("analyzers.loudness.eager"):
                return analyzer.step(carry, block, channel_weights, reset_mask)
        sets = self._sets.setdefault((block.device, block.shape[0]), [])
        graphs = next((g for g in sets if g.holds(carry)), None)
        if graphs is None:
            graphs = next((g for g in sets if g.free), None)
            if graphs is None:
                graphs = _GraphSet(analyzer, block, channel_weights, self.counts)
                sets.append(graphs)
            graphs.rebind(carry)
            self.counts["rebinds"] += 1
        with span("analyzers.loudness.replay"):
            self.counts["replays"] += 1
            return graphs.replay(carry, block, channel_weights, reset_mask)


class _GraphSet:
    """The static tensors of one device and stream count, and a graph of
    :meth:`LoudnessAnalyzer.step` for each branch pattern.  A graph reads
    the static inputs, updates the static carry and packs the snapshot into
    one vector; a replay returns the static carry with the host ints
    advanced, and a copy of the packed vector, so a held snapshot outlives
    later hops."""

    def __init__(self, analyzer: LoudnessAnalyzer, block, channel_weights, counts: dict):
        self._analyzer = analyzer
        device = block.device
        self._carry = analyzer.init(block.shape[0], device=device)
        self._block = torch.zeros_like(block)
        self._weights = torch.zeros_like(channel_weights)
        self._reset = torch.zeros(block.shape[:1], dtype=torch.bool, device=device)
        self._idx = torch.zeros((len(analyzer.cadence(self._carry)[1]),), dtype=torch.int64, device=device)
        self._token = None  # a weak reference to the "kw" leaf of the carry last returned
        self._stream = torch.cuda.current_stream(device)
        self._graphs: dict = {}  # pattern -> (graph, packed snapshot, the graph's outputs)
        pool = torch.cuda.graph_pool_handle()
        side = torch.cuda.Stream(device)
        side.wait_stream(self._stream)
        with torch.cuda.device(device), torch.cuda.stream(side):
            probes = self._probes()
            for probe, reset in probes.values():  # warm-up: the host-built tables, cuBLAS
                self._record(probe, reset)
            for pattern, (probe, reset) in probes.items():
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    outputs = self._record(probe, reset)
                finally:
                    graph.capture_end()
                self._graphs[pattern] = (graph, *outputs)
                counts["captures"] += 1
        self._stream.wait_stream(side)

    def _probes(self) -> dict:
        """``{pattern: (carry, reset)}``: the static carry with host ints
        that take each branch pattern the config reaches."""
        a = self._analyzer
        heads = range(a._windows.refresh_steps)  # noqa: SLF001
        positions = [None]
        if a.config.gating:
            gate = a._gate  # noqa: SLF001
            positions = range(0, gate.chunk_len, math.gcd(gate.block_frames, gate.chunk_len))
        out = {}
        for head in heads:
            for pos in positions:
                probe = dict(self._carry, wm=dict(self._carry["wm"], head=head))
                if pos is not None:
                    probe["gate"] = dict(self._carry["gate"], chunk_pos=pos)
                pattern = a.cadence(probe)[0]
                for reset in (False, True):
                    out.setdefault((*pattern, reset), (probe, reset))
        return out

    def _record(self, probe: dict, reset: bool):
        """The step on the static tensors, its snapshot packed and the new
        carry copied into the static carry: what a graph records."""
        new, snap = self._analyzer.step(
            probe, self._block, self._weights, self._reset if reset else None, self._idx
        )
        packed = torch.cat([leaf.reshape(-1) for leaf in snap])
        for static, leaf in _pairs(self._carry, new):
            if leaf is not static:
                static.copy_(leaf)
        self._shapes = [leaf.shape for leaf in snap]
        return packed, (new, snap)

    def holds(self, carry: dict) -> bool:
        return self._token is not None and carry.get("kw") is self._token()

    @property
    def free(self) -> bool:
        """No carry this set returned is held any more."""
        return self._token is None or self._token() is None

    def rebind(self, carry: dict) -> None:
        for static, leaf in _pairs(self._carry, carry):
            static.copy_(leaf)

    def replay(self, carry: dict, block, channel_weights, reset_mask):
        stream = torch.cuda.current_stream(block.device)
        if stream != self._stream:
            # the static tensors are used on this stream too: freed, they
            # wait for its work
            for t in (self._block, self._weights, self._reset, self._idx):
                t.record_stream(stream)
            for t, _ in _pairs(self._carry, self._carry):
                t.record_stream(stream)
            self._stream = stream
        pattern, ints = self._analyzer.cadence(carry)
        graph, packed, _ = self._graphs[(*pattern, reset_mask is not None)]
        self._block.copy_(block)
        self._weights.copy_(channel_weights)
        if reset_mask is not None:
            self._reset.copy_(reset_mask)
        self._idx.copy_(torch.tensor(ints, dtype=torch.int64).pin_memory(), non_blocking=True)
        graph.replay()
        leaves = torch.split(packed.clone(), [math.prod(shape) for shape in self._shapes])
        out = self._analyzer.advanced(carry, self._carry)
        out["kw"] = out["kw"].view_as(out["kw"])  # this hop's token
        self._token = weakref.ref(out["kw"])
        return out, LoudnessSnapshot(*(leaf.view(shape) for leaf, shape in zip(leaves, self._shapes)))
