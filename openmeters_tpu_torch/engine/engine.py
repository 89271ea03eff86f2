"""The batched meter engine: one step over all streams and analyzers (port
of ``engine/engine.py``).

A step takes a ``[S, B, C]`` block plus per-stream fold/weight matrices
(:class:`StreamMeta`) and a per-stream reset mask, folds it to stereo and
its mid projection, and fans out to the enabled analyzers: loudness, the
spectrogram, the spectrum, the oscilloscope, the stereometer and the
waveform, all six by default.

A spectrum whose hop is a whole multiple R > 1 of the engine block runs at
its own cadence: :meth:`MeterEngine.step` passes its carry through, and
:meth:`MeterEngine.spectrum_step` takes the R blocks of one spectrum hop at
once (the analyzer built with ``block_frames = hop``), so every call
slides exactly once.  :meth:`MeterEngine.super_step` is R engine hops then
the spectrum hop.

The oscilloscope runs in external-capture mode (``snapshot_every`` forced
to 0): the step keeps capture metadata only, and
:meth:`MeterEngine.extract_oscilloscope` reads the trace windows.

State updates in place where an analyzer says so (the framing ring, the
loudness rings and histograms, the oscilloscope's history rings): a carry
must not be reused after it has been stepped.  On a card the loudness step
replays CUDA graphs (:class:`~openmeters_tpu_torch.analyzers.loudness.LoudnessGraphs`):
the loudness part of the returned carry is the graphs' static state, which
the next step updates in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from openmeters_tpu_torch.analyzers.loudness import LoudnessAnalyzer, LoudnessConfig, LoudnessGraphs
from openmeters_tpu_torch.analyzers.oscilloscope import (
    OscilloscopeAnalyzer,
    OscilloscopeConfig,
)
from openmeters_tpu_torch.analyzers.spectrogram import (
    SpectrogramAnalyzer,
    SpectrogramConfig,
)
from openmeters_tpu_torch.analyzers.spectrum import SpectrumAnalyzer, SpectrumConfig
from openmeters_tpu_torch.analyzers.stereometer import (
    StereometerAnalyzer,
    StereometerConfig,
)
from openmeters_tpu_torch.analyzers.waveform import WaveformAnalyzer, WaveformConfig
from openmeters_tpu_torch.tracing import span
from openmeters_tpu_torch.utils.channels import (
    MAX_AUDIO_CHANNELS,
    channel_fallback,
    channel_weights,
    stereo_matrix,
)
from openmeters_tpu_torch.utils.migrate import carry_device

DSP_BATCH_FRAMES_AT_48K = 256
# the analyzers that step on the stereo fold alone, with their spans' names
_STEREO_ANALYZERS = tuple((name, f"analyzers.{name}") for name in ("oscilloscope", "stereometer", "waveform"))


def scaled_block_frames(sample_rate: float) -> int:
    """The engine block at ``sample_rate``: 256 frames at 48 kHz, scaled
    by rate."""
    return max(int(round(DSP_BATCH_FRAMES_AT_48K * sample_rate / 48_000.0)), 1)


class StreamMeta(NamedTuple):
    fold: torch.Tensor  # [S, C, 2] stereo fold matrices
    weights: torch.Tensor  # [S, C] BS.1770 channel weights

    @staticmethod
    def default(
        n_streams: int, channels: int = 2, pad_channels: int = MAX_AUDIO_CHANNELS
    ) -> "StreamMeta":
        positions = channel_fallback(channels)
        fold = torch.from_numpy(stereo_matrix(channels, positions)[:pad_channels])
        weights = torch.from_numpy(channel_weights(positions)[:pad_channels])
        return StreamMeta(
            fold=fold[None].repeat(n_streams, 1, 1),
            weights=weights[None].repeat(n_streams, 1),
        )


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    sample_rate: float = 48_000.0
    block_frames: int = DSP_BATCH_FRAMES_AT_48K
    channels: int = MAX_AUDIO_CHANNELS
    loudness: LoudnessConfig | None = LoudnessConfig()
    spectrogram: SpectrogramConfig | None = SpectrogramConfig()
    spectrum: SpectrumConfig | None = SpectrumConfig()
    oscilloscope: Any = dataclasses.field(default_factory=OscilloscopeConfig)
    stereometer: Any = dataclasses.field(default_factory=StereometerConfig)
    waveform: Any = dataclasses.field(default_factory=WaveformConfig)

    @staticmethod
    def at_rate(sample_rate: float, **kw) -> "EngineConfig":
        """A config for one sample rate, its block scaled by rate
        (:func:`scaled_block_frames`).  Streams of different rates run in
        engines of their own."""
        return EngineConfig(sample_rate=sample_rate, block_frames=scaled_block_frames(sample_rate), **kw)

    def resolve(self) -> "EngineConfig":
        """Propagate engine-level rate/block into analyzer configs."""
        kw = dict(sample_rate=self.sample_rate, block_frames=self.block_frames)

        def fix(cfg):
            return dataclasses.replace(cfg, **kw) if cfg is not None else None

        return dataclasses.replace(
            self,
            loudness=(
                dataclasses.replace(self.loudness, channels=self.channels, **kw)
                if self.loudness
                else None
            ),
            spectrogram=fix(self.spectrogram),
            spectrum=fix(self.spectrum),
            oscilloscope=fix(self.oscilloscope),
            stereometer=fix(self.stereometer),
            waveform=fix(self.waveform),
        )


@dataclasses.dataclass(frozen=True)
class MeterEngine:
    config: EngineConfig = EngineConfig()

    def __post_init__(self):
        object.__setattr__(self, "config", self.config.resolve())
        self.analyzers  # builds each analyzer, which validates its config
        # the loudness step's CUDA graphs, made on the first step of each
        # device and stream count (a server's warm-up)
        object.__setattr__(self, "loudness_graphs", LoudnessGraphs())

    @property
    def spectrum_cadence(self) -> int:
        """Engine hops per spectrum hop (R): the spectrum hop over the
        engine block where it is a whole multiple of it, else 1."""
        sp = self.config.spectrum
        if not sp:
            return 1
        b = self.config.block_frames
        if sp.hop_size > b and sp.hop_size % b == 0:
            return sp.hop_size // b
        return 1

    @property
    def analyzers(self) -> dict:
        cfg = self.config
        out = {}
        if cfg.loudness:
            out["loudness"] = LoudnessAnalyzer(cfg.loudness)
        if cfg.spectrogram:
            out["spectrogram"] = SpectrogramAnalyzer(cfg.spectrogram)
        if cfg.spectrum:
            sp = cfg.spectrum
            if self.spectrum_cadence > 1:
                # one full spectrum hop a call: every call slides once
                sp = dataclasses.replace(sp, block_frames=sp.hop_size)
            out["spectrum"] = SpectrumAnalyzer(sp)
        if cfg.oscilloscope:
            # external capture: the step keeps capture metadata only
            oc = dataclasses.replace(cfg.oscilloscope, snapshot_every=0)
            out["oscilloscope"] = OscilloscopeAnalyzer(oc)
        if cfg.stereometer:
            out["stereometer"] = StereometerAnalyzer(cfg.stereometer)
        if cfg.waveform:
            out["waveform"] = WaveformAnalyzer(cfg.waveform)
        return out

    def init(self, n_streams: int, device="cuda") -> dict:
        return {
            name: a.init(n_streams, device=device) for name, a in self.analyzers.items()
        }

    def step(self, carry: dict, block: torch.Tensor, meta: StreamMeta, reset_mask=None, any_reset=None):
        """One engine hop over ``block [S, B, C]``; ``reset_mask [S]`` bool
        restarts streams.  ``any_reset`` (a host bool, default
        ``reset_mask.any()``) says whether any stream of the whole batch
        restarts: a shard of a mesh passes the batch's, so a decision that
        advances a host scalar is taken alike on every shard.  Returns
        ``(carry, {name: snapshot})``."""
        with span("engine.step"):
            block = block.to(torch.float32)
            stereo = torch.einsum("sbc,sct->sbt", block, meta.fold)  # [S, B, 2]
            mid = 0.5 * (stereo[..., 0] + stereo[..., 1])  # [S, B]

            new_carry, snaps = {}, {}
            analyzers = self.analyzers
            if "loudness" in analyzers:
                with span("analyzers.loudness"):
                    new_carry["loudness"], snaps["loudness"] = self.loudness_graphs.step(
                        analyzers["loudness"], carry["loudness"], block, meta.weights, reset_mask
                    )
            if "spectrogram" in analyzers:
                with span("analyzers.spectrogram"):
                    new_carry["spectrogram"], snaps["spectrogram"] = analyzers[
                        "spectrogram"
                    ].step(carry["spectrogram"], mid, reset_mask)
            if "spectrum" in analyzers:
                if self.spectrum_cadence > 1:
                    # stepped by spectrum_step every R hops
                    new_carry["spectrum"] = carry["spectrum"]
                else:
                    with span("analyzers.spectrum"):
                        new_carry["spectrum"], snaps["spectrum"] = analyzers["spectrum"].step(
                            carry["spectrum"], stereo, reset_mask=reset_mask, any_reset=any_reset
                        )
            for name, span_name in _STEREO_ANALYZERS:
                if name in analyzers:
                    with span(span_name):
                        new_carry[name], snaps[name] = analyzers[name].step(
                            carry[name], stereo, reset_mask=reset_mask
                        )
            return new_carry, snaps

    def spectrum_step(self, spectrum_carry, blocks: torch.Tensor, meta: StreamMeta, reset_mask=None):
        """One spectrum hop: the ``R = spectrum_cadence`` engine blocks
        ``[R, S, B, C]`` of it, oldest first.

        ``reset_mask`` is ``[R, S]`` per engine hop or ``[S]`` (their OR).
        With per-hop masks the blocks before a stream's last reset are
        zeroed, so no audio from before the reset enters the spectrum; with
        the OR alone they are admitted as they are.

        Returns ``(spectrum_carry, SpectrumSnapshot)``.
        """
        r, s, b, _ = blocks.shape
        if r != self.spectrum_cadence:
            raise ValueError(f"{r} blocks, want the spectrum cadence {self.spectrum_cadence}")
        blocks = blocks.to(torch.float32)
        if reset_mask is not None and reset_mask.dim() == 2:
            hop_i = torch.arange(r, dtype=torch.int32, device=blocks.device)[:, None]  # [R, 1]
            last = torch.where(reset_mask, hop_i, -1).amax(dim=0)  # [S]: last reset hop, or -1
            keep = hop_i >= last[None, :]  # the reset hop carries new audio
            blocks = torch.where(keep[..., None, None], blocks, 0.0)
            reset_mask = reset_mask.any(dim=0)
        stereo = torch.einsum("rsbc,sct->srbt", blocks, meta.fold).reshape(s, r * b, 2)
        with span("analyzers.spectrum"):
            return self.analyzers["spectrum"].step(spectrum_carry, stereo, reset_mask=reset_mask)

    def super_step(self, carry: dict, blocks: torch.Tensor, meta: StreamMeta, resets=None,
                   fold_snaps=None):
        """R engine hops of ``blocks [R, S, B, C]`` (``resets [R, S]`` or
        None), then, for a cadenced spectrum, its hop.

        ``fold_snaps``, if given, reduces each engine hop's snapshots as
        they come.  Returns ``(carry, snaps)``: without ``fold_snaps`` the
        fast analyzers' snapshots stacked ``[R, ...]`` per leaf and
        ``snaps["spectrum"]`` the spectrum hop's; with it ``(the folded
        list, the spectrum snapshot or None)``.
        """
        r = blocks.shape[0]
        per_hop = []
        for i in range(r):
            carry, snaps = self.step(carry, blocks[i], meta, None if resets is None else resets[i])
            per_hop.append(fold_snaps(snaps) if fold_snaps is not None else snaps)
        sp_snap = None
        if self.spectrum_cadence > 1:
            carry["spectrum"], sp_snap = self.spectrum_step(carry["spectrum"], blocks, meta, resets)
        if fold_snaps is not None:
            return carry, (per_hop, sp_snap)
        stacked = {
            name: _stack_snaps([snaps[name] for snaps in per_hop]) for name in per_hop[0]
        }
        if sp_snap is not None:
            stacked["spectrum"] = sp_snap
        return carry, stacked

    def extract_oscilloscope(self, carry: dict):
        """The oscilloscope's capture windows from the live carry."""
        return self.analyzers["oscilloscope"].extract(carry["oscilloscope"])

    def migrate_carry(self, old_engine: "MeterEngine", carry: dict, n_streams: int) -> dict:
        """The carry to go on with after a config change, analyzer by
        analyzer: an unchanged analyzer keeps its carry; a changed one with
        a ``migrate_from`` keeps what that method keeps (the spectrum its
        framing and sliding state across an averaging or floor change, the
        oscilloscope its trigger lock across a cadence change); the rest,
        and a ``migrate_from`` that returns ``None``, start afresh.  The
        carry stays on its device, and fresh parts are made there."""
        old = old_engine.analyzers
        device = carry_device(carry)
        out = {}
        for name, analyzer in self.analyzers.items():
            migrated = None
            if name in old and name in carry:
                if old[name].config == analyzer.config:
                    migrated = carry[name]
                elif hasattr(analyzer, "migrate_from"):
                    migrated = analyzer.migrate_from(old[name], carry[name], n_streams)
            out[name] = migrated if migrated is not None else analyzer.init(n_streams, device=device)
        return out

    def carry_stream_dims(self) -> dict:
        """The tree of :meth:`init` with each leaf's stream dim, ``None``
        for a host scalar every shard of a mesh holds alike (ring origins
        and heads, hop counters, ``anchored`` flags); the counterpart of
        the JAX package's ``carry_pspecs``, read by
        :mod:`~openmeters_tpu_torch.engine.sharding`."""
        analyzers = self.analyzers

        def frames():
            return {"buf": 0, "origin": None, "avail": None, "fresh": 0}

        def sliding():
            return {"re": 0, "im": 0, "count": None, "anchored": None}

        out = {}
        if "loudness" in analyzers:
            out["loudness"] = {
                "kw": 1,  # [slot, S, C]
                "wm": {"totals": 1, "suffix": 2, "sums": 1, "comp": 1, "head": None, "blocks": 0},
                "tp": 1,
            }
            if analyzers["loudness"].config.gating:
                out["loudness"]["gate"] = analyzers["loudness"]._gate.stream_dims()  # noqa: SLF001
        if "spectrogram" in analyzers:
            sg = analyzers["spectrogram"]
            out["spectrogram"] = {"fb": frames()}
            if sg.use_sliding_reassigned:
                out["spectrogram"]["srs"] = sg._sliding_reassigned.stream_dims()  # noqa: SLF001
        if "spectrum" in analyzers:
            sa = analyzers["spectrum"]
            out["spectrum"] = {"fb": frames(), "smoothed": 0}  # lanes s * trace_count + t
            if sa.use_sliding:
                out["spectrum"]["sdft"] = sliding()
            if sa._held:  # noqa: SLF001
                out["spectrum"].update(raw_db=0, weighted_db=0)
        for name in ("oscilloscope", "stereometer", "waveform"):
            if name in analyzers:
                out[name] = analyzers[name].stream_dims()
        return out


def _stack_snaps(snaps: list):
    """Stack a list of like snapshots (tuples of tensors) leaf by leaf."""
    first = snaps[0]
    return type(first)(*(torch.stack(leaves) for leaves in zip(*snaps)))
