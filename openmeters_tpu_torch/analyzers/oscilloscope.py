"""Oscilloscope: NSDF pitch detection and the waveform-stable trigger (port
of ``analyzers/oscilloscope.py``).

Per hop each stream's traces are projected from the stereo block and
appended to mirrored history rings (``[S, 2 * ring_cap]``, written twice so
that every window of up to ``ring_cap`` samples is contiguous).  Then:

- **Period** (``_estimate_period``): McLeod NSDF over the newest
  ``probe_frames`` samples from an FFT autocorrelation with prefix-energy
  normalisation; the earliest peak within 0.93 of the best, parabolic
  refinement.  With a trigger every hop the probe spectrum slides (a
  ``[S, 2B] x [2B, 2 * bins]`` product and a phasor rotation) and is
  re-anchored exactly every ``PROBE_REFRESH`` hops and on any reset.
- **Stable trigger** (``_stable_capture``): a centre-aligned reference
  template (reset below match 0.3, dropped on a jump of a semitone or
  more) plus a Gaussian-edged slope template, searched over ~1.5 periods by
  one dense FFT correlation with exact sliding sums
  (:func:`~openmeters_tpu_torch.ops.corr.corr_dots_sums_ring`, reading the
  work window straight from the ring), argmax and parabolic refinement;
  candidate segments come off the ring with
  :func:`~openmeters_tpu_torch.ops.rows.window_rows`.
- **Zero-crossing** mode: rising edges at both ends of the history window.
- **Capture**: per-trace windows of ``window_cap`` raw samples from the
  rings, either in the step (``snapshot_every > 0``, at that cadence) or
  by :meth:`OscilloscopeAnalyzer.extract` (``snapshot_every == 0``, the
  engine's mode).

Every decision the JAX package masks per stream is masked here too, on the
device.  The scalars shared by all streams (``origin``, ``tick``,
``panchored``) are host values, so the cadence branches (trigger every N
hops, snapshot every N hops, the probe's exact re-anchor) are host
branches.  A reset forces the re-anchor when any stream resets: the step
reads ``reset_mask.any()`` back to the host, one sync on the hops that
carry a mask and none on the others.

The carry tree, dtypes included, is the JAX package's.  The history rings
are written IN PLACE: ``step`` mutates ``carry["hist"]``, so a carry must
not be reused after it has been stepped.

``migrate_from`` keeps the rings, the trigger lock and the template across
a change of cadence alone.  Not ported yet: ``pspecs`` (sharding, A12).
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from openmeters_tpu_torch.ops import corr
from openmeters_tpu_torch.ops.rows import window_rows
from openmeters_tpu_torch.utils.channels import Channel, projection_vector
from openmeters_tpu_torch.utils.migrate import carry_device, merge_carry

TRACE_COUNT = 2

# period estimator
MIN_HZ = 20.0
MAX_HZ = 8000.0
PROBE_SECONDS = 0.1
MIN_SIGNAL_PEAK = 0.001
MIN_PERIODICITY = 0.5
PEAK_CUTOFF = 0.93

# sliding probe spectrum: exact re-anchor cadence (hops)
PROBE_REFRESH = 32

# stable trigger
WINDOW_SECONDS = 0.04
MIN_CYCLES = 2.0
SEARCH_PERIODS = 1.5
NORMALIZE_FLOOR = 0.01
MEAN_RESPONSIVENESS = 0.25
EDGE_STRENGTH = 1.0
BUFFER_RESPONSIVENESS = 0.5
BUFFER_FALLOFF_PERIODS = 0.5
BUFFER_RETUNE_SEMITONES = 1.0
SLOPE_WIDTH_PERIODS = 0.25
RESET_BELOW_MATCH = 0.3
MAX_MISSED_PERIODS = 4

STATE_KEYS = ("period", "has_period", "missed", "mean", "reference", "ref_period")


class TriggerMode(enum.Enum):
    ZERO_CROSSING = "zero_crossing"
    STABLE = "stable"


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length()


@dataclasses.dataclass(frozen=True)
class OscilloscopeConfig:
    sample_rate: float = 48_000.0
    segment_duration: float = 0.02
    trigger_mode: TriggerMode = TriggerMode.STABLE
    num_cycles: int = 2
    trigger_source: Channel = Channel.MID
    channel_1: Channel = Channel.MID
    channel_2: Channel = Channel.NONE
    block_frames: int = 256
    # trigger cadence in hops (1 = every hop)
    trigger_every: int = 1
    # capture-window extraction cadence in hops; 0 = extract() on demand
    snapshot_every: int = 3


class OscilloscopeSnapshot(NamedTuple):
    samples: torch.Tensor  # [S, 2, window_cap] raw capture windows
    trace_valid: torch.Tensor  # [S, 2] bool
    span: torch.Tensor  # [S, 2] capture span in samples
    start: torch.Tensor  # [S, 2] int32 capture start within the history window
    frac: torch.Tensor  # [S, 2] fractional start offset
    period: torch.Tensor  # [S, 2] locked period (samples), 0 when unlocked
    locked: torch.Tensor  # [S, 2] bool


@dataclasses.dataclass(frozen=True)
class OscilloscopeAnalyzer:
    config: OscilloscopeConfig = OscilloscopeConfig()

    # -- static sizing ------------------------------------------------------

    @property
    def base_frames(self) -> int:
        cfg = self.config
        return max(int(round(cfg.sample_rate * cfg.segment_duration)), 1)

    @property
    def max_period(self) -> int:
        return int(math.ceil(self.config.sample_rate / MIN_HZ))

    @property
    def min_period(self) -> int:
        return max(int(round(self.config.sample_rate / MAX_HZ)), 2)

    @property
    def probe_frames(self) -> int:
        return max(int(round(self.config.sample_rate * PROBE_SECONDS)), self.max_period * 2)

    @property
    def kernel_cap(self) -> int:
        """Trigger template length at the longest period."""
        return max(
            int(round(max(self.config.sample_rate * WINDOW_SECONDS, self.max_period * MIN_CYCLES))),
            2,
        )

    @property
    def search_cap(self) -> int:
        # the search is clipped to half the template at run time
        return max(min(int(math.ceil(self.max_period * SEARCH_PERIODS)), self.kernel_cap // 2), 1)

    @property
    def work_cap(self) -> int:
        return self.search_cap + self.kernel_cap

    @property
    def _kernel_min(self) -> int:
        """Shortest run-time template (``klen >= rate * WINDOW_SECONDS``)."""
        return min(self.kernel_cap, max(int(round(self.config.sample_rate * WINDOW_SECONDS)), 2))

    @property
    def history_frames(self) -> int:
        cfg = self.config
        if cfg.trigger_mode is TriggerMode.ZERO_CROSSING:
            trigger = self.base_frames + self.max_period
        else:
            max_tail = max(
                self.max_period * max(cfg.num_cycles, 1) + 1, -(-self.kernel_cap // 2)
            )
            trigger = self.kernel_cap // 2 + max_tail + self.search_cap + 2
        return max(self.probe_frames, self.base_frames, trigger)

    @property
    def window_cap(self) -> int:
        """Capture-window capacity: the longest span of the trigger mode."""
        if self.config.trigger_mode is TriggerMode.ZERO_CROSSING:
            cap = self.base_frames + 2
        else:
            cap = max(
                int(math.ceil(self.max_period * max(self.config.num_cycles, 1))) + 2,
                self.base_frames + 2,
            )
        return min(cap, self.history_frames)

    @property
    def nsdf_fft(self) -> int:
        return _next_pow2(self.probe_frames + self.max_period)

    @property
    def slides_probe(self) -> bool:
        """The probe spectrum is sliding carry state when the trigger runs
        every hop (see the module docstring)."""
        cfg = self.config
        return (
            max(int(cfg.trigger_every), 1) == 1
            and cfg.trigger_mode is TriggerMode.STABLE
            and self.history_frames >= self.probe_frames + cfg.block_frames
        )

    @property
    def snap_cadence(self) -> int:
        return max(int(self.config.snapshot_every), 1)

    @property
    def external_capture(self) -> bool:
        """``snapshot_every == 0``: the step keeps capture metadata only and
        :meth:`extract` reads the windows."""
        return int(self.config.snapshot_every) == 0

    @property
    def holds_snap(self) -> bool:
        """Whether the carry holds the last extracted snapshot."""
        return not self.external_capture and (
            max(int(self.config.trigger_every), 1) > 1 or self.snap_cadence > 1
        )

    @property
    def corr_fft(self) -> int:
        # circular correlation is exact for the valid offsets when
        # nfft >= work_cap; covering the masked lags up to
        # work_cap - 1 - klen_min + search_cap keeps every read unwrapped
        max_read = self.work_cap - self._kernel_min + self.search_cap
        return _next_pow2(max(self.work_cap, max_read))

    # -- trace wiring -------------------------------------------------------

    @property
    def trace_channels(self):
        return (self.config.channel_1, self.config.channel_2)

    @property
    def active_traces(self):
        return tuple(ch is not Channel.NONE for ch in self.trace_channels)

    @property
    def trigger_slot(self) -> int:
        """History ring driving the trigger: a matching trace, or slot 2
        (a separate source projection)."""
        src = self.config.trigger_source
        for i, ch in enumerate(self.trace_channels):
            if ch is src and self.active_traces[i]:
                return i
        return 2

    @property
    def independent_triggers(self) -> bool:
        """No trigger source: each active trace runs its own trigger state;
        otherwise one linked capture is shared by all traces."""
        return self.config.trigger_source is Channel.NONE and any(self.active_traces)

    @property
    def trigger_lane_slots(self) -> tuple[int, ...]:
        if self.independent_triggers:
            return tuple(t for t in range(TRACE_COUNT) if self.active_traces[t])
        return (self.trigger_slot,)

    @property
    def n_trig(self) -> int:
        return len(self.trigger_lane_slots)

    @property
    def ring_cap(self) -> int:
        """Ring capacity: the history rounded up to whole blocks, so a
        block never wraps; stored mirrored (2x)."""
        b = max(int(self.config.block_frames), 1)
        return -(-self.history_frames // b) * b

    # -- state ----------------------------------------------------------------

    def init(self, n_streams: int, device=None) -> dict:
        s, lanes = n_streams, n_streams * self.n_trig  # lane = s * n_trig + i

        def zeros(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        carry = {
            # one ring per projection (ch1, ch2, trigger source)
            "hist": tuple(zeros((s, 2 * self.ring_cap)) for _ in range(3)),
            "origin": 0,
            "fresh": zeros((s,), torch.int32),
            "tick": 0,
            "period": zeros((lanes,)),
            "has_period": zeros((lanes,), torch.bool),
            "missed": zeros((lanes,), torch.int32),
            "mean": zeros((lanes,)),
            "reference": zeros((lanes, self.kernel_cap)),
            "ref_period": zeros((lanes,)),
        }
        if self.slides_probe:
            bins = self.nsdf_fft // 2 + 1
            carry["pspec_re"] = zeros((lanes, bins))
            carry["pspec_im"] = zeros((lanes, bins))
            carry["panchored"] = False
        n = self.n_trig
        if self.external_capture:
            carry["cap"] = {
                "valid": zeros((s, n), torch.bool),
                "span": zeros((s, n)),
                "start": zeros((s, n), torch.int32),
                "frac": zeros((s, n)),
            }
        if self.holds_snap:
            carry["snap"] = {
                "samples": zeros((s, TRACE_COUNT, self.window_cap)),
                "trace_valid": zeros((s, TRACE_COUNT), torch.bool),
                "span": zeros((s, TRACE_COUNT)),
                "start": zeros((s, TRACE_COUNT), torch.int32),
                "frac": zeros((s, TRACE_COUNT)),
            }
        return carry

    def stream_dims(self) -> dict:
        """Each carry leaf's stream dim, ``None`` for the host scalars (the
        JAX package's ``pspecs``).  Trigger lanes are stream-major
        (``s * n_trig + i``), so a shard's lanes are one contiguous run."""
        dims = {
            "hist": (0, 0, 0), "origin": None, "fresh": 0, "tick": None, "period": 0,
            "has_period": 0, "missed": 0, "mean": 0, "reference": 0, "ref_period": 0,
        }
        if self.slides_probe:
            dims.update(pspec_re=0, pspec_im=0, panchored=None)
        if self.external_capture:
            dims["cap"] = dict.fromkeys(("valid", "span", "start", "frac"), 0)
        if self.holds_snap:
            dims["snap"] = dict.fromkeys(("samples", "trace_valid", "span", "start", "frac"), 0)
        return dims

    def migrate_from(self, old: "OscilloscopeAnalyzer", carry: dict, n_streams: int):
        """Keep the state across a change of ``trigger_every`` or
        ``snapshot_every`` alone: the rings, the trigger lock and the
        template mean the same under either cadence, so a display-rate
        change does not drop a locked trigger.  State the new cadence adds
        (the sliding probe, the held snapshot) starts afresh; the probe then
        re-anchors exactly.  Any other change starts over (``None``)."""
        a, b = old.config, self.config
        if a == b:
            return carry
        if dataclasses.replace(a, trigger_every=b.trigger_every, snapshot_every=b.snapshot_every) != b:
            return None
        return merge_carry(self.init(n_streams, device=carry_device(carry)), carry)

    # -- capture metadata per trace ---------------------------------------------

    def _trace_cap(self, cap2: dict, key: str, t: int):
        """Trace ``t``'s field of the per-lane capture ``[S, n_trig]``: its own
        lane when the triggers are independent, else the linked lane."""
        if self.independent_triggers:
            return cap2[key][:, self.trigger_lane_slots.index(t)]
        return cap2[key][:, 0]

    def _per_trace_meta(self, cap2: dict, s: int) -> dict:
        """Per-lane capture metadata ``[S, n_trig]`` as per-trace snapshot
        fields ``[S, 2]``."""
        out = {}
        for field, key in (
            ("trace_valid", "valid"), ("span", "span"), ("start", "start"), ("frac", "frac"),
        ):
            like = cap2[key][:, 0]
            out[field] = torch.stack(
                [
                    self._trace_cap(cap2, key, t) if self.active_traces[t] else torch.zeros_like(like)
                    for t in range(TRACE_COUNT)
                ],
                dim=1,
            )
        return out

    def _lock_fields(self, state: dict, s: int):
        """Per-trace ``(locked, period)`` from the trigger lane state."""
        dev = state["period"].device
        if self.config.trigger_mode is not TriggerMode.STABLE:
            return (
                torch.zeros((s, TRACE_COUNT), dtype=torch.bool, device=dev),
                torch.zeros((s, TRACE_COUNT), dtype=torch.float32, device=dev),
            )
        lock2 = state["has_period"].reshape(s, self.n_trig)
        per2 = state["period"].reshape(s, self.n_trig)
        locked_t, period_t = [], []
        for t in range(TRACE_COUNT):
            if not self.active_traces[t]:
                locked_t.append(torch.zeros_like(lock2[:, 0]))
                period_t.append(torch.zeros_like(per2[:, 0]))
            else:
                i = self.trigger_lane_slots.index(t) if self.independent_triggers else 0
                locked_t.append(lock2[:, i])
                period_t.append(per2[:, i])
        return torch.stack(locked_t, dim=1), torch.stack(period_t, dim=1)

    def _windows(self, hist, cap2: dict, shift: int, s: int) -> torch.Tensor:
        """``[S, 2, window_cap]`` capture windows off the rings: one
        ``window_rows`` per active trace."""
        samples = []
        for t in range(TRACE_COUNT):
            if not self.active_traces[t]:
                samples.append(hist[t].new_zeros((s, self.window_cap)))
            else:
                samples.append(
                    window_rows(hist[t], self._trace_cap(cap2, "start", t) + shift, self.window_cap)
                )
        return torch.stack(samples, dim=1)

    def extract(self, carry: dict) -> OscilloscopeSnapshot:
        """Capture extraction in external-capture mode: the ``[S, 2,
        window_cap]`` trace windows anchored by the carry's capture
        metadata."""
        assert self.external_capture
        cap2 = carry["cap"]
        s = carry["fresh"].shape[0]
        # logical index 0 of the right-aligned history window; ``origin`` is
        # the next write slot
        shift = (carry["origin"] - self.history_frames) % self.ring_cap
        meta = self._per_trace_meta(cap2, s)
        locked, period = self._lock_fields(carry, s)
        return OscilloscopeSnapshot(
            samples=self._windows(carry["hist"], cap2, shift, s),
            trace_valid=meta["trace_valid"],
            span=meta["span"],
            start=meta["start"],
            frac=meta["frac"],
            period=torch.where(locked, period, 0.0),
            locked=locked,
        )

    # -- NSDF period estimation ---------------------------------------------

    def _estimate_period(self, probe, pspec=None) -> dict:
        """``probe``: ``[S, P]`` newest samples.  Returns ``[S]`` tensors
        ``period``, ``confidence``, ``detected``, ``last_peak``.  ``pspec``:
        the sliding spectrum of the raw probe window, ``(re, im)``; the mean
        is then removed in the frequency domain (``C = X - mean * D``, exact
        for the zero-padded window)."""
        dev = probe.device
        p = probe.shape[-1]
        mean = probe.mean(dim=-1, keepdim=True)
        c = probe - mean
        max_lag = min(self.max_period, p // 2)
        nfft = self.nsdf_fft

        e = torch.cumsum(c * c, dim=-1)
        e = torch.cat([torch.zeros_like(e[..., :1]), e], dim=-1)  # [S, P + 1]
        total = e[..., -1]
        left = torch.flip(e[..., p - max_lag : p + 1], dims=(-1,))  # e[p - tau]
        right = total[..., None] - e[..., : max_lag + 1]
        last_peak = c.abs().amax(dim=-1)

        if pspec is not None:
            *_, d_re, d_im = _slide_tensors(p, self.config.block_frames, nfft, dev)
            c_re = pspec[0] - mean * d_re
            c_im = pspec[1] - mean * d_im
        else:
            spec = torch.fft.rfft(c, n=nfft)
            c_re, c_im = spec.real, spec.imag
        power = c_re * c_re + c_im * c_im
        ac = torch.fft.irfft(torch.complex(power, torch.zeros_like(power)), n=nfft)[
            ..., : max_lag + 1
        ]

        taus = torch.arange(max_lag + 1, device=dev)
        denom = left + right
        nsdf = torch.where(denom > 1e-7, 2.0 * ac / torch.clamp_min(denom, 1e-30), 0.0)

        # first zero crossing at tau >= 1
        nonpos = nsdf[:, 1:] <= 0.0
        has_zc = nonpos.any(dim=-1)
        zc = nonpos.to(torch.int32).argmax(dim=-1) + 1
        first_tau = torch.clamp_min(zc, self.min_period)

        prev = torch.cat([nsdf[:, :1], nsdf[:, :-1]], dim=-1)
        nxt = torch.cat([nsdf[:, 1:], nsdf[:, -1:]], dim=-1)
        in_range = (taus[None, :] >= first_tau[:, None]) & (taus[None, :] < max_lag)
        cand = in_range & (nsdf >= MIN_PERIODICITY) & (nsdf >= prev) & (nsdf >= nxt)
        any_cand = cand.any(dim=-1)
        scored = torch.where(cand, nsdf, -math.inf)
        best_val = scored.amax(dim=-1)
        best_idx = scored.argmax(dim=-1)
        cutoff = best_val * PEAK_CUTOFF
        early = cand & (nsdf >= cutoff[:, None]) & (taus[None, :] <= best_idx[:, None])
        peak = torch.where(early.any(dim=-1), early.to(torch.int32).argmax(dim=-1), best_idx)

        y0, y1, y2 = _onehot_neighbors(nsdf, peak)
        period = _parabolic_refine(y0, y1, y2, peak)
        confidence = torch.clamp(y1, 0.0, 1.0)

        detected = (
            (last_peak >= MIN_SIGNAL_PEAK)
            & has_zc
            & (first_tau < max_lag)
            & any_cand
            & (total > 1e-7)
        )
        if not max_lag > self.min_period + 1:
            detected = torch.zeros_like(detected)
        return {
            "period": period,
            "confidence": confidence,
            "detected": detected,
            "last_peak": last_peak,
        }

    # -- stable trigger -------------------------------------------------------

    def _stable_capture(self, state: dict, trace, fresh_ok, shift: int, pspec=None):
        """Batched stable trigger.  ``trace``: ``[S, 2 * ring_cap]`` mirrored
        ring whose logical index 0 sits at physical ``shift`` (a host int).
        Returns ``(new_state, capture)`` with logical ``span``/``start``/
        ``frac`` and ``valid``, each ``[S]``."""
        cfg = self.config
        dev = trace.device
        hist = self.history_frames
        cycles = max(cfg.num_cycles, 1)
        kcap, scap, wcap = self.kernel_cap, self.search_cap, self.work_cap
        assert trace.shape[1] == 2 * self.ring_cap, "needs the mirrored ring"

        a0 = shift + hist - self.probe_frames
        est = self._estimate_period(trace[:, a0 : a0 + self.probe_frames], pspec=pspec)

        # silence unlocks
        silent = est["last_peak"] < MIN_SIGNAL_PEAK
        has_period = state["has_period"] & ~silent
        missed = torch.where(silent, 0, state["missed"])
        mean_state = torch.where(silent, 0.0, state["mean"])
        reference = torch.where(silent[:, None], 0.0, state["reference"])
        ref_period = torch.where(silent, 0.0, state["ref_period"])
        prev_period = torch.where(silent, 0.0, state["period"])

        # stabilise the period
        detected = est["detected"] & fresh_ok
        est_p = est["period"]
        ratio = est_p / torch.clamp_min(prev_period, 1e-6)
        ratio_ok = has_period & (ratio >= 0.9) & (ratio <= 1.1)
        smoothed = torch.where(ratio_ok, prev_period + 0.35 * (est_p - prev_period), est_p)
        missed_next = torch.where(detected, 0, missed + 1)
        hold = ~detected & has_period & (missed_next <= MAX_MISSED_PERIODS)
        unlock = ~detected & (~has_period | (missed_next > MAX_MISSED_PERIODS))
        period = torch.where(detected, smoothed, torch.where(hold, prev_period, 0.0))
        confidence = torch.where(detected, est["confidence"], 0.0)
        has_period = detected | hold
        missed = torch.where(detected, 0, torch.where(hold, missed_next, 0))
        # a full unlock clears the template too
        reference = torch.where(unlock[:, None], 0.0, reference)
        ref_period = torch.where(unlock, 0.0, ref_period)
        mean_state = torch.where(unlock, 0.0, mean_state)

        # locate: every run-time length is a mask
        p = torch.clamp_min(period, 1.0)
        span = p * cycles
        frames = torch.ceil(span).to(torch.int32) + 1
        klen = torch.clamp(
            torch.round(torch.clamp_min(p * MIN_CYCLES, cfg.sample_rate * WINDOW_SECONDS)), 2, kcap
        ).to(torch.int32)
        before = klen // 2
        after = klen - before
        right = hist - torch.maximum(frames, after)
        can_locate = has_period & (right >= before)
        search = torch.minimum(
            torch.clamp_min(torch.round(p * SEARCH_PERIODS).to(torch.int32), 1), klen // 2
        )
        search = torch.minimum(search, torch.clamp_min(right - before, 1))
        left = right - search

        # the work window starts at the searched region (start-aligned);
        # the mirror makes any start in [0, ring_cap) contiguous
        ring_cap = trace.shape[1] // 2
        w_start = torch.remainder(shift + torch.clamp_min(left - before, 0), ring_cap)

        # centre-aligned template store: a klen change is a mask change, a
        # jump of a semitone or more drops the template
        ref_empty = ~(reference.abs() > 1.0e-3).any(dim=-1)
        semis = torch.abs(
            torch.log2(torch.clamp_min(p, 1e-6) / torch.clamp_min(ref_period, 1e-6))
        ) * 12.0
        jump = can_locate & ~ref_empty & (semis >= BUFFER_RETUNE_SEMITONES)
        reference = torch.where(jump[:, None], 0.0, reference)
        ref_period = torch.where(can_locate & (ref_empty | jump), p, ref_period)
        use_reference = ~ref_empty & ~jump

        kidx = torch.arange(kcap, device=dev, dtype=torch.int32)
        off = (kcap - klen) // 2  # centred-store offset
        kmask = (kidx[None, :] >= off[:, None]) & (kidx[None, :] < (off + klen)[:, None])

        edges = torch.where(kmask, _edge_template(klen, p, kcap, off), 0.0)
        template = torch.where(use_reference[:, None] & kmask, edges + reference, edges)
        wlen = search + klen
        # the dots anchor on the template grid: start-aligned work puts the
        # first searched offset at index 0, so the anchor is -off
        dots_m, sx, sxx, wmean = corr.corr_dots_sums_ring(
            trace, w_start, template, klen, wlen, -off, self.corr_fft, scap + 1, wcap
        )

        mean_state = torch.where(
            can_locate, mean_state + MEAN_RESPONSIVENESS * (wmean - mean_state), mean_state
        )

        n1 = torch.clamp_min(klen.to(torch.float32), 1.0)[:, None]
        ex = torch.clamp_min(sxx - sx * sx / n1, 0.0)
        st = template.sum(dim=-1, keepdim=True)
        stt = (template * template).sum(dim=-1, keepdim=True)
        dot = dots_m - sx * st / n1
        ey = torch.clamp_min(stt - st * st / n1, 0.0)
        denom = torch.sqrt(ex * ey)
        scores = torch.where(
            denom > 1e-7, torch.clamp(dot / torch.clamp_min(denom, 1e-30), -1.0, 1.0), 0.0
        )

        # pick the best offset and refine it
        oidx = torch.arange(scap + 1, device=dev)
        ovalid = oidx[None, :] <= search[:, None]
        best = torch.where(ovalid, scores, -math.inf).argmax(dim=-1)
        b0, b1, b2 = _onehot_neighbors(scores, best)
        interior = (best > 0) & (best < search)
        frac = torch.where(
            interior, torch.clamp(_parabolic_refine(b0, b1, b2, best) - best, -0.5, 0.5), 0.0
        )
        best = best.to(torch.int32)
        cmean = sx.gather(1, best.long()[:, None])[:, 0] / torch.clamp_min(
            klen.to(torch.float32), 1.0
        )

        # candidate: the klen samples at the best offset, centred in the
        # store (store index off + u holds work[best + u]), read off the ring
        seg = window_rows(trace, torch.remainder(w_start + best - off, ring_cap), kcap)
        cand = torch.where(kmask, seg - cmean[:, None], 0.0)
        peakv = cand.abs().amax(dim=-1)
        cand = cand / torch.clamp_min(peakv, NORMALIZE_FLOOR)[:, None]
        std = torch.clamp_min(p * BUFFER_FALLOFF_PERIODS, 1.0)
        cand = cand * _gaussian_sym(klen, std, kcap, off)

        # reset (deferred one hop: clear now, rebuild from the next
        # candidate) or update the reference
        confident = confidence >= MIN_PERIODICITY
        match = _norm_corr_single(reference, cand, kmask)
        do_reset = can_locate & confident & use_reference & (match < RESET_BELOW_MATCH)
        reference = torch.where(do_reset[:, None], 0.0, reference)
        upd = can_locate & confident & ~do_reset
        refpeak = reference.abs().amax(dim=-1)
        ref_norm = reference / torch.clamp_min(refpeak, NORMALIZE_FLOOR)[:, None]
        new_ref = ref_norm + BUFFER_RESPONSIVENESS * (cand - ref_norm)
        reference = torch.where(upd[:, None], torch.where(kmask, new_ref, 0.0), reference)
        ref_period = torch.where(
            upd, ref_period + BUFFER_RESPONSIVENESS * (p - ref_period), ref_period
        )

        # capture
        start = left + best
        borrow = (frac < 0.0) & (start > 0)
        start = torch.where(borrow, start - 1, start)
        frac = torch.where(borrow, frac + 1.0, frac)
        fb_span = float(max(self.base_frames - 1, 1))
        fb_start = hist - self.base_frames
        capture = {
            "span": torch.where(can_locate, span, fb_span),
            "start": torch.where(can_locate, start, fb_start).to(torch.int32),
            "frac": torch.where(can_locate, frac, 0.0),
            "valid": fresh_ok,
        }
        new_state = {
            "period": torch.where(has_period, period, 0.0),
            "has_period": has_period,
            "missed": missed,
            "mean": mean_state,
            "reference": reference,
            "ref_period": ref_period,
        }
        return new_state, capture

    # -- zero-crossing capture ----------------------------------------------------

    def _zero_crossing_capture(self, trace, fresh_ok) -> dict:
        s, hist = trace.shape
        frames = min(self.base_frames, hist)
        rng = self.max_period
        prev = torch.cat([trace[:, :1], trace[:, :-1]], dim=-1)
        rising = (trace > 0.0) & (prev <= 0.0)
        idx = torch.arange(hist, device=trace.device)

        end = hist - 1
        in_right = idx >= max(end - rng, 0)
        rr = rising & in_right[None, :]
        right = torch.where(
            rr.any(dim=-1), torch.where(rr, idx, -1).amax(dim=-1), end
        ).to(torch.int32)

        left_lo = torch.clamp_min(right - frames, 0)
        left_hi = torch.minimum(left_lo + rng, torch.clamp_min(right - 2, 0))
        lmask = rising & (idx[None, :] >= left_lo[:, None]) & (idx[None, :] <= left_hi[:, None])
        left = torch.where(
            lmask.any(dim=-1), lmask.to(torch.int32).argmax(dim=-1), left_lo  # first rising edge
        ).to(torch.int32)
        return {
            "span": torch.clamp_min(right - left, 1).to(torch.float32),
            "start": left,
            "frac": torch.zeros((s,), dtype=torch.float32, device=trace.device),
            "valid": fresh_ok if frames > 0 else torch.zeros_like(fresh_ok),
        }

    # -- step -------------------------------------------------------------------

    def step(self, carry: dict, block: torch.Tensor, reset_mask=None):
        """One hop of ``[S, B, 2]`` stereo.  Returns ``(carry, snapshot)``."""
        cfg = self.config
        s, b, _ = block.shape
        if b != cfg.block_frames:
            raise ValueError(f"block of {b} frames, config says {cfg.block_frames}")
        dev = block.device
        hist_len = self.history_frames
        n_trig = self.n_trig
        cap = self.ring_cap

        fresh = carry["fresh"]
        state = {k: carry[k] for k in STATE_KEYS}
        hist = carry["hist"]
        cap_in, snap_in = carry.get("cap"), carry.get("snap")
        if reset_mask is not None:
            rm = reset_mask
            fresh = torch.where(rm, 0, fresh)
            for h in hist:
                h.masked_fill_(rm[:, None], 0.0)
            rml = rm.repeat_interleave(n_trig)  # stream-major trigger lanes
            for k, v in state.items():
                state[k] = torch.where(rml[:, None] if v.dim() == 2 else rml, torch.zeros_like(v), v)
            # a capture anchored before the reset must not survive it
            if cap_in is not None:
                cap_in = {k: torch.where(rm[:, None], torch.zeros_like(v), v) for k, v in cap_in.items()}
            if snap_in is not None:
                snap_in = {
                    k: torch.where(rm.reshape((-1,) + (1,) * (v.dim() - 1)), torch.zeros_like(v), v)
                    for k, v in snap_in.items()
                }
        fresh = torch.clamp_max(fresh + b, 2**30)

        # project and append to the mirrored rings, in place
        proj = _projections(cfg.channel_1, cfg.channel_2, cfg.trigger_source, dev)
        newest = torch.einsum("sbc,ch->shb", block.to(torch.float32), proj)  # [S, 3, B]
        origin = carry["origin"]
        for t, h in enumerate(hist):
            h[:, origin : origin + b] = newest[:, t]
            h[:, origin + cap : origin + cap + b] = newest[:, t]
        origin_next = (origin + b) % cap
        # logical index L of the right-aligned window lives at shift + L
        shift = (origin + b - hist_len) % cap

        fresh_ok = fresh >= min(self.base_frames, hist_len)
        if n_trig == 1:
            trig_flat = hist[self.trigger_lane_slots[0]]
        else:
            trig_flat = torch.stack(
                [hist[slot] for slot in self.trigger_lane_slots], dim=1
            ).reshape(s * n_trig, 2 * cap)
        fresh_lane = fresh_ok.repeat_interleave(n_trig)

        pspec, new_pspec = None, {}
        if self.slides_probe:
            nfft, p = self.nsdf_fft, self.probe_frames
            mat, rot_r, rot_i, _, _ = _slide_tensors(p, b, nfft, dev)
            refresh = carry["tick"] % PROBE_REFRESH == 0 or not carry["panchored"]
            if reset_mask is not None and not refresh:
                refresh = bool(reset_mask.any())  # the one host sync, on hops with a mask
            end = shift + hist_len
            if refresh:
                spec = torch.fft.rfft(trig_flat[:, end - p : end], n=nfft)
                pre, pim = spec.real.contiguous(), spec.imag.contiguous()
            else:
                delta = torch.cat(
                    [trig_flat[:, end - p - b : end - p], trig_flat[:, end - b : end]], dim=-1
                )
                packed = delta @ mat  # [lanes, 2 * bins]: [re | im]
                bins = nfft // 2 + 1
                dr, di = packed[:, :bins], packed[:, bins:]
                xr, xi = carry["pspec_re"], carry["pspec_im"]
                pre = xr * rot_r - xi * rot_i + dr
                pim = xr * rot_i + xi * rot_r + di
            pspec = (pre, pim)
            new_pspec = {"pspec_re": pre, "pspec_im": pim, "panchored": True}

        def run_trigger(st):
            if cfg.trigger_mode is TriggerMode.ZERO_CROSSING:
                capture = self._zero_crossing_capture(trig_flat[:, shift : shift + hist_len], fresh_lane)
                new_st = st
            else:
                new_st, capture = self._stable_capture(st, trig_flat, fresh_lane, shift, pspec=pspec)
            return new_st, {k: v.reshape(s, n_trig) for k, v in capture.items()}

        def extract_snap(cap2):
            snap = self._per_trace_meta(cap2, s)
            snap["samples"] = self._windows(hist, cap2, shift, s)
            return snap

        def hold_snap():
            # the window slid one block since the extraction: age the start
            return {**snap_in, "start": snap_in["start"] - b}

        tick = carry["tick"]
        every = max(int(cfg.trigger_every), 1)
        due = tick % every == 0
        if self.external_capture:
            # metadata only; extract() reads the windows
            if due:
                new_state, cap2 = run_trigger(state)
            else:
                new_state, cap2 = state, {**cap_in, "start": cap_in["start"] - b}
            snap = self._per_trace_meta(cap2, s)
            snap["samples"] = torch.zeros((s, TRACE_COUNT, 0), dtype=torch.float32, device=dev)
        elif every == 1:
            new_state, cap2 = run_trigger(state)
            snap = extract_snap(cap2) if tick % self.snap_cadence == 0 else hold_snap()
        elif due:
            new_state, cap2 = run_trigger(state)
            snap = extract_snap(cap2)
        else:
            new_state, snap = state, hold_snap()

        locked, period = self._lock_fields(new_state, s)
        new_carry = {
            "hist": hist,
            "origin": origin_next,
            "fresh": fresh,
            "tick": tick + 1,
            **new_pspec,
            **new_state,
        }
        if self.external_capture:
            new_carry["cap"] = cap2
        if self.holds_snap:
            new_carry["snap"] = snap
        return new_carry, OscilloscopeSnapshot(
            samples=snap["samples"],
            trace_valid=snap["trace_valid"],
            span=snap["span"],
            start=snap["start"],
            frac=snap["frac"],
            period=torch.where(locked, period, 0.0),
            locked=locked,
        )


# -- helpers -------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _probe_slide_consts(p: int, b: int, nfft: int):
    """Constants for the sliding probe spectrum.

    ``X' = rot * X + delta @ M`` advances the transform of a ``p``-sample
    window zero-padded to ``nfft`` by ``b`` samples: ``delta = [leaving
    block, entering block]``, ``M``'s rows ``-e^{-2 pi i k (m - b) / nfft}``
    and ``e^{-2 pi i k (p - b + j) / nfft}``.  ``D`` is the window support's
    Dirichlet vector (the DFT of 1 over ``[0, p)``), so the mean-removed
    spectrum is exactly ``C = X - mean * D``."""
    bins = nfft // 2 + 1
    k = np.arange(bins, dtype=np.float64)
    rot = np.exp(2j * np.pi * k * b / nfft)
    m = np.arange(b, dtype=np.float64)
    leave = -np.exp(-2j * np.pi * np.outer(m - b, k) / nfft)
    enter = np.exp(-2j * np.pi * np.outer(p - b + m, k) / nfft)
    mat = np.concatenate([leave, enter], axis=0)
    theta = 2.0 * np.pi * k / nfft
    num = 1.0 - np.exp(-1j * theta * p)
    den = 1.0 - np.exp(-1j * theta)
    dirich = np.where(np.abs(den) > 1e-12, num / np.where(den == 0, 1, den), p)
    return (
        mat.real.astype(np.float32), mat.imag.astype(np.float32),
        rot.real.astype(np.float32), rot.imag.astype(np.float32),
        dirich.real.astype(np.float32), dirich.imag.astype(np.float32),
    )


@functools.lru_cache(maxsize=8)
def _slide_tensors(p: int, b: int, nfft: int, device: torch.device):
    """:func:`_probe_slide_consts` on ``device``: the packed ``[2b, 2 *
    bins]`` matrix ``[M_re | M_im]``, the rotation and the Dirichlet
    vector."""
    mat_re, mat_im, rot_r, rot_i, d_re, d_im = _probe_slide_consts(p, b, nfft)
    mat = np.concatenate([mat_re, mat_im], axis=1)
    return tuple(torch.from_numpy(a).to(device) for a in (mat, rot_r, rot_i, d_re, d_im))


@functools.lru_cache(maxsize=8)
def _projections(ch1: Channel, ch2: Channel, src: Channel, device: torch.device):
    """``[2, 3]`` stereo projections of trace 1, trace 2 and the trigger
    source."""
    proj = np.stack([projection_vector(ch1), projection_vector(ch2), projection_vector(src)], axis=1)
    return torch.from_numpy(proj).to(device)


def _parabolic_refine(y0, y1, y2, tau):
    denom = y0 - 2.0 * y1 + y2
    flat = denom.abs() < 1e-7
    delta = torch.where(flat, 0.0, 0.5 * (y0 - y2) / torch.where(flat, 1.0, denom))
    return torch.clamp_min(tau.to(torch.float32) + torch.clamp(delta, -1.0, 1.0), 1.0)


def _gaussian_sym(length, std, cap: int, off):
    """Gaussian window of ``length`` samples placed at capacity index
    ``off`` of a ``cap`` buffer, zero outside."""
    i = torch.arange(cap, dtype=torch.float32, device=length.device)
    rel = i[None, :] - off.to(torch.float32)[:, None]
    center = (length.to(torch.float32) - 1.0) * 0.5
    x = (rel - center[:, None]) / torch.clamp_min(std, 1e-6)[:, None]
    g = torch.exp(-0.5 * x * x)
    ok = (length > 1)[:, None] & (rel >= 0.0) & (rel < length[:, None])
    return torch.where(ok, g, 0.0)


def _edge_template(length, period, cap: int, off):
    """Gaussian-edged slope template: negative on the left half, positive
    on the right, placed like :func:`_gaussian_sym`."""
    max_width = torch.clamp_min(torch.clamp_min(length // 2, 1).to(torch.float32) / 3.0, 1.0)
    width = torch.minimum(torch.clamp_min(period * SLOPE_WIDTH_PERIODS, 1.0), max_width)
    g = _gaussian_sym(length, width, cap, off)
    rel = torch.arange(cap, dtype=torch.int32, device=length.device)[None, :] - off[:, None]
    sign = torch.where(2 * rel >= (length - 1)[:, None], 1.0, -1.0)
    return EDGE_STRENGTH * g * sign


def _norm_corr_single(x, y, mask):
    """Normalised correlation of two masked buffers."""
    n = torch.clamp_min(mask.sum(dim=-1).to(torch.float32), 1.0)
    xm = torch.where(mask, x, 0.0)
    ym = torch.where(mask, y, 0.0)
    sx, sy = xm.sum(dim=-1), ym.sum(dim=-1)
    sxx, syy, sxy = (xm * xm).sum(dim=-1), (ym * ym).sum(dim=-1), (xm * ym).sum(dim=-1)
    dot = sxy - sx * sy / n
    ex = torch.clamp_min(sxx - sx * sx / n, 0.0)
    ey = torch.clamp_min(syy - sy * sy / n, 0.0)
    denom = torch.sqrt(ex * ey)
    return torch.where(denom > 1e-7, torch.clamp(dot / torch.clamp_min(denom, 1e-30), -1.0, 1.0), 0.0)


def _onehot_neighbors(values, idx):
    """``(values[idx - 1], values[idx], values[idx + 1])`` per row, with
    neighbours outside the row read as 0."""
    n = values.shape[-1]
    i = idx.long()[:, None]

    def at(j):
        got = values.gather(1, j.clamp(0, n - 1))
        return torch.where((j >= 0) & (j < n), got, torch.zeros_like(got))[:, 0]

    return at(i - 1), at(i), at(i + 1)
