"""Stream-parallel scale-out over a mesh of devices (port of
``engine/sharding.py``).

Streams are independent, so the engine step scales out by cutting the
stream axis into equal runs, one a shard: each shard holds an engine carry
of its own streams on its own device and runs the whole step on them.  No
tensor moves between devices inside a step; the only copies are the
inputs from the host and the meters back to it.

A :class:`StreamMesh` is a grid of ``torch.device``s with named axes.
:func:`make_mesh` lists every card of this process (or the first N), and
raises rather than give fewer; a mesh built directly may list one device
more than once (``StreamMesh([cuda:0, cuda:0])``, ``StreamMesh([cpu] *
8)``), and each such shard still owns its tensors, which rehearses a mesh
on one card or on the CPU.

A sharded carry is a :class:`ShardedCarry`: one engine carry a shard, in
shard order, shard ``i`` holding streams ``[i S/N, (i+1) S/N)``.  Which dim
of each leaf is the stream dim comes from
:meth:`MeterEngine.carry_stream_dims`; a leaf without one is a host scalar
(ring origins and heads, hop counters, ``anchored`` flags) that every shard
advances alike.  :func:`gather_carry` joins the shards again and checks
those scalars are equal on every shard (naming the leaf where they are
not), which is what ``check_vma`` proves for the JAX package at trace
time.  A shard without a reset steps with no mask, and decisions taken on
``any(reset)`` are shard-local (the oscilloscope's probe refresh), but for
the one that advances a host scalar: the held spectrum's slide (its
``count``), taken on the whole batch's reset (``any_reset``).

The snapshot's stream dims are derived as the JAX package derives its
specs: the snapshot shapes at 8, 16 and 24 streams, and a dim that scales
must scale exactly in proportion (this covers lane-flattened layouts like
the oscilloscope's ``[S * n_trig]``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from openmeters_tpu_torch.engine.engine import StreamMeta

STREAM_AXIS = "streams"


class StreamMesh:
    """A grid of devices with named axes: ``devices`` is an object array of
    ``torch.device``s, one dim an axis of ``axis_names``."""

    def __init__(self, devices, axis_names=(STREAM_AXIS,)):
        grid = np.asarray(devices, dtype=object)
        self.devices = np.empty(grid.shape, dtype=object)
        for idx, dev in np.ndenumerate(grid):
            self.devices[idx] = torch.device(dev)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-D grid of devices with axes {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def shard_devices(self, axis=STREAM_AXIS) -> tuple:
        """The device of each shard, in shard order, when streams are cut
        over ``axis`` (an axis name, or a tuple of them, outer first).  The
        axes must cover the mesh: a stream is computed once."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        if sorted(axes) != sorted(self.axis_names):
            raise ValueError(f"streams cut over {axes}: name every axis of the mesh {self.axis_names}")
        order = [self.axis_names.index(a) for a in axes]
        return tuple(np.transpose(self.devices, order).reshape(-1))


class ShardedCarry(list):
    """One engine carry a shard, in shard order."""


def _cards(need: int, what: str) -> list:
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0 or count < need:
        raise ValueError(
            f"requested {what} but only {count} CUDA device(s) are available; to rehearse a mesh on "
            "one card or the CPU, build a StreamMesh of that device listed once a shard"
        )
    return [torch.device("cuda", i) for i in range(need)]


def make_mesh(n_devices: int | None = None) -> StreamMesh:
    """1-D stream mesh over the first ``n_devices`` cards (default: every
    card).  Raises when fewer exist, or none: a run asked for N ways never
    silently runs on fewer, or on the CPU."""
    if n_devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return StreamMesh(_cards(max(count, 1), "a mesh over every card"))
    return StreamMesh(_cards(n_devices, f"a {n_devices}-device mesh"))


def make_multihost_mesh(n_hosts: int, per_host: int) -> StreamMesh:
    """2-D ``("dcn", "ici")`` mesh of this process's cards, ``n_hosts`` rows
    of ``per_host``: streams cut over both axes
    (``sharded_step(..., axis=("dcn", "ici"))``), with no traffic between
    shards on either."""
    cards = _cards(n_hosts * per_host, f"a {n_hosts}x{per_host} mesh")
    grid = np.empty((n_hosts, per_host), dtype=object)
    for i, dev in enumerate(cards):
        grid[i // per_host, i % per_host] = dev
    return StreamMesh(grid, ("dcn", "ici"))


# -- trees of leaves and their stream dims --------------------------------------


def _map(fn, tree, *rest, path=""):
    """``fn(path, leaf, *others)`` over the leaves of nested dicts, tuples
    and named tuples (the carry and snapshot trees), keeping the structure
    of ``tree``."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest), path=f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [_map(fn, v, *(r[i] for r in rest), path=f"{path}/{i}") for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(path, tree, *rest)


def derive_stream_dims(shapes_fn) -> dict:
    """Each leaf's stream dim, from ``shapes_fn(s)`` (a tree of tensors at
    ``s`` streams) at 8, 16 and 24 streams: the dim that scales, in exact
    proportion to ``s`` (integer cross-multiplication); ``None`` where no
    dim scales or the leaf is not a tensor.  Raises where a dim scales but
    not in proportion (``k S + c``), which would reassemble to the wrong
    shape, or where more than one dim scales."""
    s1, s2, s3 = 8, 16, 24

    def derive(path, l1, l2, l3):
        if not isinstance(l1, torch.Tensor):
            return None
        dims = []
        for i, (d1, d2, d3) in enumerate(zip(l1.shape, l2.shape, l3.shape)):
            if d1 == d2 == d3:
                continue
            if not (d1 * s2 == d2 * s1 and d1 * s3 == d3 * s1):
                raise ValueError(
                    f"{path}: dim {i} scales with the stream count but not in proportion ({d1}@S={s1}, "
                    f"{d2}@S={s2}, {d3}@S={s3}): give this leaf an explicit stream dim"
                )
            dims.append(i)
        if len(dims) > 1:
            raise ValueError(f"{path}: {tuple(l1.shape)} scales with the stream count in dims {dims}")
        return dims[0] if dims else None

    return _map(derive, shapes_fn(s1), shapes_fn(s2), shapes_fn(s3))


def _trace(engine, s: int, fn):
    """``fn(carry, meta, device)`` at ``s`` streams, on the meta device
    where the path runs there, else on the CPU (the kernel wrappers take
    only CPU and CUDA tensors)."""
    c = engine.config.channels

    def on(device):
        meta = StreamMeta(*(t.to(device) for t in StreamMeta.default(s, channels=c, pad_channels=c)))
        return fn(engine.init(s, device=device), meta, device)

    try:
        return on("meta")
    except (ValueError, RuntimeError, NotImplementedError):
        return on("cpu")


def snapshot_stream_dims(engine, kind: str = "step", scan_hops: int = 1):
    """The stream dim of each leaf of the snapshots of ``engine.step``
    (``kind="step"``), ``engine.spectrum_step`` (``"spectrum"``) or
    :func:`scan_last_snapshot_fn` over ``scan_hops`` hops (``"scan"``), by
    :func:`derive_stream_dims`."""
    b, c, r = engine.config.block_frames, engine.config.channels, engine.spectrum_cadence

    def shapes(s):
        def run(carry, meta, device):
            if kind == "step":
                return engine.step(carry, torch.zeros((s, b, c), device=device), meta)[1]
            if kind == "spectrum":
                blocks = torch.zeros((r, s, b, c), device=device)
                return engine.spectrum_step(carry["spectrum"], blocks, meta)[1]
            blocks = torch.zeros((scan_hops, s, b, c), device=device)
            return scan_last_snapshot_fn(engine)(carry, blocks, meta)[1]

        return _trace(engine, s, run)

    return derive_stream_dims(shapes)


# -- placing and gathering -------------------------------------------------------


def _stream_count(tree, dims) -> int:
    counts = set()
    _map(lambda _, leaf, d: counts.add(leaf.shape[d]) if d is not None else None, tree, dims)
    if len(counts) != 1:
        raise ValueError(f"the stream dims of the tree hold {sorted(counts)} streams")
    return counts.pop()


def _split(tree, dims, devices) -> list:
    """``tree`` cut along each leaf's stream dim into ``len(devices)``
    runs, each copied whole to its device (a shard owns its tensors, also
    where two shards share a device)."""
    n = len(devices)
    s = _stream_count(tree, dims)
    if s % n:
        raise ValueError(f"{s} streams do not divide over {n} shards")
    per = s // n

    def part(i, dev):
        def leaf_part(_, leaf, d):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            piece = leaf if d is None else leaf.narrow(d, i * per, per)
            return piece.to(dev, memory_format=torch.contiguous_format, copy=True)

        return _map(leaf_part, tree, dims)

    return [part(i, dev) for i, dev in enumerate(devices)]


def place_carry(engine, mesh: StreamMesh, carry: dict, axis=STREAM_AXIS) -> ShardedCarry:
    """An engine carry (on any device, or from
    :func:`~openmeters_tpu_torch.convert.carry_from_jax`) cut into the
    shards of ``mesh``, each on its device."""
    return ShardedCarry(_split(carry, engine.carry_stream_dims(), mesh.shard_devices(axis)))


def _join(shards: list, dims, device, what: str):
    def leaf_join(path, d, *leaves):
        first = leaves[0]
        if d is not None:
            return torch.cat([leaf.to(device) for leaf in leaves], dim=d)
        if isinstance(first, torch.Tensor):
            same = all(torch.equal(first.cpu(), leaf.cpu()) for leaf in leaves[1:])
        else:
            same = all(type(leaf) is type(first) and leaf == first for leaf in leaves[1:])
        if not same:
            shown = [leaf if not isinstance(leaf, torch.Tensor) else tuple(leaf.shape) for leaf in leaves]
            raise ValueError(f"{what} leaf {path} is replicated but differs across shards: {shown}")
        return first.to(device, copy=True) if isinstance(first, torch.Tensor) else first

    return _map(leaf_join, dims, *shards)


def gather_carry(engine, carry, device=None) -> dict:
    """The inverse of :func:`place_carry`: one engine carry of every
    stream on ``device`` (default: shard 0's).  Raises ``ValueError``
    naming the leaf when a host scalar differs across shards."""
    from openmeters_tpu_torch.utils.migrate import carry_device

    shards = list(carry)
    device = carry_device(shards[0]) if device is None else torch.device(device)
    return _join(shards, engine.carry_stream_dims(), device, "carry")


def gather_snapshots(snaps: list, dims, device="cpu"):
    """Per-shard snapshots (a step function's second output) joined along
    each leaf's stream dim (``dims``: the step's ``snapshot_dims``) on
    ``device``."""
    return _join(list(snaps), dims, torch.device(device), "snapshot")


# -- the sharded steps ----------------------------------------------------------


def on_device(device: torch.device):
    """``device`` made current (a no-op on the CPU), so each launch goes to
    that device's current stream."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _local(x, i: int, dim: int, per: int, device: torch.device, host_reset: bool = False):
    """Shard ``i``'s run of streams of an input along ``dim``: copied from
    the host, or a view where it lies on the shard's device already.  With
    ``host_reset``, a host mask without a reset in the shard gives ``None``
    (the shard steps with no mask)."""
    if x is None:
        return None
    part = x.narrow(dim, i * per, per)
    if host_reset and part.device.type == "cpu" and not bool(part.any()):
        return None
    if part.device == device:
        return part
    if part.device.type != "cpu":
        raise ValueError(f"input on {part.device} for a shard on {device}: a step moves no tensor between devices")
    return part.to(device, non_blocking=True)


def _local_meta(meta, i: int, per: int, device):
    return StreamMeta(*(_local(t, i, 0, per, device) for t in meta))


def _per_shard(carry, devices, streams: int) -> int:
    """Streams a shard, checking the carry has one part a shard."""
    n = len(devices)
    if len(carry) != n:
        raise ValueError(f"a carry of {len(carry)} shards for a mesh of {n}")
    if streams % n:
        raise ValueError(f"{streams} streams do not divide over {n} shards")
    return streams // n


def _shard_loop(devices, carry, fn, streams):
    per = _per_shard(carry, devices, streams)
    out_c, out_s = [], []
    for i, dev in enumerate(devices):
        with on_device(dev):
            c, snap = fn(i, dev, per, carry[i])
        out_c.append(c)
        out_s.append(snap)
    return out_c, out_s


def sharded_step(engine, mesh: StreamMesh, axis=STREAM_AXIS):
    """The engine step over ``mesh``: each shard's ``engine.step`` on its
    own streams, issued under its device.

    Returns ``(step_fn, place_carry)``.  ``step_fn(carry, block, meta,
    reset=None)`` takes a :class:`ShardedCarry` and ``block [S, B, C]``,
    ``meta`` and ``reset [S]`` of every stream, on the host or on the
    shards' one device; it returns the new sharded carry and
    the per-shard snapshots (``step_fn.snapshot_dims`` joins them with
    :func:`gather_snapshots`).  ``place_carry(carry)`` cuts an engine carry
    onto the mesh.  The stream count must divide by the mesh size.
    """
    devices = mesh.shard_devices(axis)

    def step_fn(carry, block, meta, reset=None):
        any_reset = None if reset is None else bool(reset.any())  # the batch's (see the module docstring)

        def one(i, dev, per, c):
            return engine.step(
                c, _local(block, i, 0, per, dev), _local_meta(meta, i, per, dev),
                _local(reset, i, 0, per, dev, host_reset=True), any_reset,
            )

        out_c, out_s = _shard_loop(devices, carry, one, block.shape[0])
        return ShardedCarry(out_c), out_s

    step_fn.snapshot_dims = snapshot_stream_dims(engine)
    return step_fn, lambda carry: place_carry(engine, mesh, carry, axis)


def sharded_spectrum_step(engine, mesh: StreamMesh, axis=STREAM_AXIS):
    """The cadenced spectrum hop (``engine.spectrum_step``) over ``mesh``:
    ``fn(spectrum_carries, blocks [R, S, B, C], meta, reset)`` with one
    spectrum carry a shard (``[c["spectrum"] for c in carry]``) and
    ``reset`` ``[R, S]``, ``[S]`` or ``None``; returns the new spectrum
    carries and the per-shard snapshots (``fn.snapshot_dims``)."""
    devices = mesh.shard_devices(axis)

    def fn(spectrum_carries, blocks, meta, reset=None):
        rdim = 1 if reset is not None and reset.dim() == 2 else 0

        def one(i, dev, per, c):
            return engine.spectrum_step(
                c, _local(blocks, i, 1, per, dev), _local_meta(meta, i, per, dev),
                _local(reset, i, rdim, per, dev, host_reset=True),
            )

        return _shard_loop(devices, spectrum_carries, one, blocks.shape[1])

    fn.snapshot_dims = snapshot_stream_dims(engine, "spectrum")
    return fn


def scan_last_snapshot_fn(engine):
    """``fn(carry, blocks [K, S, B, C], meta, resets [K, S] or None,
    any_resets=None)``: K engine hops, the last hop's snapshot kept
    (``any_resets``: each hop's ``any_reset`` for ``engine.step``); with a
    cadenced spectrum, K must be a multiple of the cadence, and the
    snapshot gains the last spectrum hop's (each hop's blocks before a
    stream's reset zeroed)."""
    r = engine.spectrum_cadence

    def scan_fn(carry, blocks, meta, resets=None, any_resets=None):
        k = blocks.shape[0]
        if r > 1 and k % r:
            raise ValueError(f"scan_hops ({k}) must be a multiple of the spectrum cadence ({r})")
        for j in range(k):
            carry, snaps = engine.step(carry, blocks[j], meta, None if resets is None else resets[j],
                                       None if any_resets is None else any_resets[j])
        if r > 1:
            sp = carry["spectrum"]
            for g in range(0, k, r):
                sp, sp_snap = engine.spectrum_step(
                    sp, blocks[g : g + r], meta, None if resets is None else resets[g : g + r]
                )
            carry = dict(carry, spectrum=sp)
            snaps = dict(snaps, spectrum=sp_snap)
        return carry, snaps

    return scan_fn


def sharded_scan_step(engine, mesh: StreamMesh, scan_hops: int, axis=STREAM_AXIS):
    """:func:`scan_last_snapshot_fn` over ``mesh`` (the server's
    ``scan_hops`` mode): ``step_fn(carry, blocks [K, S, B, C], meta,
    resets [K, S] or None)``; returns ``(step_fn, place_carry)`` as
    :func:`sharded_step` does."""
    devices = mesh.shard_devices(axis)
    inner = scan_last_snapshot_fn(engine)

    def step_fn(carry, blocks, meta, resets=None):
        if blocks.shape[0] != scan_hops:
            raise ValueError(f"{blocks.shape[0]} blocks, want scan_hops {scan_hops}")
        any_resets = None if resets is None else [bool(r) for r in resets.any(dim=1).cpu()]

        def one(i, dev, per, c):
            return inner(
                c, _local(blocks, i, 1, per, dev), _local_meta(meta, i, per, dev),
                _local(resets, i, 1, per, dev, host_reset=True), any_resets,
            )

        out_c, out_s = _shard_loop(devices, carry, one, blocks.shape[1])
        return ShardedCarry(out_c), out_s

    step_fn.snapshot_dims = snapshot_stream_dims(engine, "scan", scan_hops)
    return step_fn, lambda carry: place_carry(engine, mesh, carry, axis)
