"""Scripted pushes for the transport tests: each scenario is a list of
producer calls a hop, applied alike to every transport under test, and two
runners that assemble them, hop by hop, through the JAX package's copying
assembler (``Transport.assemble``) and through the port's descriptor pass
plus the plain gather (``assemble_desc``, ``ops/ring_gather.py``), as
``MeterServer`` runs it: two buffer sets of ``scan_hops`` descriptor sets
each, a set's rows gathered only just before the first pass into it
again, which gives their ring space back, so a gather reads rings the
producers could have refilled had the space gone back early."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from openmeters_tpu_torch.ops.ring_gather import ring_gather_reference

B, RATE = 64, 48_000.0


def ts(frame: int) -> int:
    return int(round(frame * 1e9 / RATE))


def seconds(frames: int) -> float:
    """A transport duration of exactly ``frames`` frames."""
    return (frames + 0.5) / RATE


class Script:
    """Producer calls a hop for ``n_streams`` streams of one transport."""

    def __init__(self, n_streams: int, hops: int, seed: int, scan_hops: int = 1, shards: int = 1, **transport):
        self.n_streams, self.hops, self.scan_hops, self.shards = n_streams, hops, scan_hops, shards
        self.transport = dict(n_streams=n_streams, channels=2, block_frames=B, sample_rate=RATE, **transport)
        self.ops = [[] for _ in range(hops)]
        self.pos = [0] * n_streams  # each stream's next frame on its timeline
        self.rng = np.random.default_rng(seed)

    def pcm(self, hop: int, st: int, frames: int, ch: int = 2, gap: int = 0) -> None:
        """``frames`` frames of noise, ``gap`` frames after the last push."""
        self.pos[st] += gap
        x = (self.rng.standard_normal((frames, ch)) * 0.3).astype(np.float32)
        self.ops[hop].append(("pcm", st, x, ts(self.pos[st])))
        self.pos[st] += frames

    def silence(self, hop: int, st: int, frames: int) -> None:
        self.ops[hop].append(("silence", st, frames, ts(self.pos[st])))
        self.pos[st] += frames

    def call(self, hop: int, *op) -> None:
        self.ops[hop].append(op)


def apply(tp, op) -> int | None:
    kind, st, *args = op
    if kind == "pcm":
        return tp.push_pcm(st, args[0], args[1])
    if kind == "silence":
        return tp.push_silence(st, args[0], args[1])
    if kind == "fault":
        return tp.push_fault(st)
    if kind == "active":
        return tp.set_active(st, args[0])
    if kind == "generation":
        return tp.set_generation(st, args[0])
    if kind == "channels":
        return tp.set_channels(st, args[0])
    raise ValueError(kind)


def _steady(seed=1):
    s = Script(5, 40, seed)
    for st in range(5):
        s.pcm(0, st, 3 * B + 17 * st)
    for h in range(1, 40):
        for st in range(5):
            # a clip's odd last push and the one after it
            s.pcm(h, st, {10: B - 3, 11: B + 3}.get(h, B) if st == 2 else B)
    s.ops[4][0][2][5, 1] = np.nan  # sanitized to 0 on the push
    return s


def _ring_wrap(seed=2):
    s = Script(3, 60, seed, ring_seconds=seconds(900))
    for h in range(60):
        for st in range(3):
            for n in (21, 22, 21):  # 64 frames a hop in three pushes
                s.pcm(h, st, n)
    return s


def _partial_spans(seed=3, scan_hops=1, shards=1, n_streams=4, hops=50):
    s = Script(n_streams, hops, seed, scan_hops=scan_hops, shards=shards)
    for h in range(hops):
        for st in range(n_streams):
            if s.rng.random() < 0.5:
                s.pcm(h, st, int(s.rng.integers(1, 2 * B)))
    return s


def _silence_gap(seed=4):
    s = Script(4, 12, seed)
    for st in range(4):
        s.pcm(0, st, B)
    s.pcm(1, 0, 20)
    s.pcm(1, 0, 30, gap=10)  # PCM, silence, PCM in one row: staged
    s.pcm(1, 1, 20)
    s.silence(1, 1, 12)
    s.pcm(1, 1, 40)  # an explicit silence span between PCM: staged
    s.pcm(1, 2, 30, gap=20)  # silence then PCM: staged
    s.pcm(1, 3, 30)
    s.silence(1, 3, 34)  # PCM then silence to the row's end: one segment
    for h in range(2, 12):
        for st in range(4):
            s.pcm(h, st, B, gap=5 if h % 3 == 0 else 0)
    return s


def _generation_change(seed=5):
    s = Script(3, 12, seed)
    for h in range(12):
        for st in range(3):
            if h == 4 and st == 1:
                s.pcm(h, st, 100)
                s.call(h, "generation", st, 2)
                s.pcm(h, st, 100)  # the hop holding both stops at the boundary
            else:
                s.pcm(h, st, B)
    return s


def _mono_stream(seed=6):
    s = Script(4, 16, seed)
    s.call(0, "channels", 1, 1)
    s.call(0, "generation", 1, 2)
    for h in range(16):
        for st in range(4):
            if h == 6 and st == 2:
                s.call(h, "channels", 2, 1)
                s.call(h, "generation", 2, 2)
            if h == 9 and st == 3:
                s.call(h, "channels", 3, 3)  # wider than the batch: the third channel is dropped
                s.call(h, "generation", 3, 2)
            ch = 1 if st == 1 or (st == 2 and h >= 6) else 3 if (st == 3 and h >= 9) else 2
            s.pcm(h, st, B + (7 if h % 2 else -7), ch=ch)
    return s


def _fault(seed=7):
    s = Script(3, 14, seed)
    for h in range(14):
        for st in range(3):
            s.pcm(h, st, B + 10)  # a backlog grows
        if h == 5:
            s.call(h, "fault", 0)
        if h == 8:
            s.pos[1] -= 200  # time runs backwards: a discontinuity
            s.pcm(h, 1, B)
    return s


def _pause_resume(seed=8):
    s = Script(3, 20, seed)
    for h in range(20):
        if h == 5:
            s.call(h, "active", 1, False)
        if h == 10:
            s.call(h, "active", 1, True)
        for st in range(3):
            s.pcm(h, st, B + 30 if h < 5 else B)
    return s


def _long_silence(seed=9):
    s = Script(2, 16, seed, max_silence_seconds=seconds(960))
    for h in range(16):
        for st in range(2):
            s.pcm(h, st, B, gap=2000 if (h, st) == (6, 0) else 0)
    return s


def _idle_watchdog(seed=10):
    s = Script(2, 40, seed, max_silence_seconds=seconds(960))
    for h in range(40):
        for st in range(2):
            if st == 0 and 5 <= h < 30:
                continue  # stalled past max_silence: one reset
            s.pcm(h, st, B)
    return s


def _backlog_cap(seed=11):
    s = Script(2, 10, seed, max_backlog_seconds=seconds(960))
    for h in range(10):
        s.pcm(h, 0, 1200 if h == 3 else B)
        s.pcm(h, 1, B)
    return s


SCENARIOS = {
    "steady": _steady,
    "ring_wrap": _ring_wrap,
    "partial_spans": _partial_spans,
    "silence_gap": _silence_gap,
    "generation_change": _generation_change,
    "mono_stream": _mono_stream,
    "fault": _fault,
    "pause_resume": _pause_resume,
    "long_silence": _long_silence,
    "idle_watchdog": _idle_watchdog,
    "backlog_cap": _backlog_cap,
    "scan_hops_2": lambda: _partial_spans(12, scan_hops=2),
    "two_shards": lambda: _partial_spans(13, shards=2, n_streams=6),
}


def run_copying(tp, script: Script) -> list:
    """``[(batch, reset, underrun, n_live, push results)]`` a hop through
    the JAX package's ``tp.assemble`` into two buffer sets (a set's buffer
    id where ``scan_hops`` is 1, as its serving loop does)."""
    k = script.scan_hops
    bufs = [[tp.make_buffers() for _ in range(k)] for _ in range(2)]
    pool = ThreadPoolExecutor(script.shards) if script.shards > 1 else None
    out = []
    try:
        for h in range(script.hops):
            slot, j = (h // k) % 2, h % k
            rcs = [apply(tp, op) for op in script.ops[h]]
            batch, rst, und, live = tp.assemble(pool=pool, shards=script.shards, out=bufs[slot][j],
                                                buf_id=slot if k == 1 else None)
            out.append((np.array(batch), rst, und, live, rcs))
    finally:
        if pool is not None:
            pool.shutdown()
    return out


def run_descriptors(tp, script: Script) -> list:
    """The same through ``tp.assemble_desc``; each hop's rows gathered
    (one gather a shard of ``script.shards``) only when its buffer set is
    about to be written and released again, and the last sets' at the end."""
    k, n = script.scan_hops, script.n_streams
    bufs = [[tp.make_desc_buffers() for _ in range(k)] for _ in range(2)]
    arena = tp.arena_tensor()
    pool = ThreadPoolExecutor(script.shards) if script.shards > 1 else None
    per = n // script.shards
    pending = [[], []]  # per set: (hop, staging, desc) not gathered yet
    got = {}

    def gather(slot):
        for h, staging, desc in pending[slot]:
            batch = torch.full((n, B, 2), float("nan"))
            for g in range(script.shards):
                ring_gather_reference(arena, staging, desc, batch[g * per : (g + 1) * per], row0=g * per)
            got[h] = (*got[h], batch.numpy())
        pending[slot] = []

    try:
        for h in range(script.hops):
            slot, j = (h // k) % 2, h % k
            if j == 0:
                gather(slot)
            rcs = [apply(tp, op) for op in script.ops[h]]
            staging, rst, und, desc = bufs[slot][j]
            rst, und, live = tp.assemble_desc(bufs[slot][j], slot, pool=pool, shards=script.shards,
                                              release=j == 0)
            got[h] = (rst, und, live, rcs)
            pending[slot].append((h, torch.from_numpy(staging), torch.from_numpy(desc)))
        gather(0)
        gather(1)
    finally:
        if pool is not None:
            pool.shutdown()
    return [(batch, rst, und, live, rcs) for h, (rst, und, live, rcs, batch) in sorted(got.items())]


def assert_same_hops(ours: list, ref: list, what: str) -> None:
    assert len(ours) == len(ref)
    for h, (a, b) in enumerate(zip(ours, ref)):
        assert a[4] == b[4], f"{what}, hop {h}: push results {a[4]} != {b[4]}"
        np.testing.assert_array_equal(a[1], b[1], err_msg=f"{what}, hop {h}: reset mask")
        np.testing.assert_array_equal(a[2], b[2], err_msg=f"{what}, hop {h}: underrun mask")
        assert a[3] == b[3], f"{what}, hop {h}: live streams"
        assert a[0].dtype == b[0].dtype == np.float32
        np.testing.assert_array_equal(a[0].view(np.uint32), b[0].view(np.uint32), err_msg=f"{what}, hop {h}: batch")
