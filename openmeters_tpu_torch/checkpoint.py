"""Checkpoint and restore of the streaming carry (port of ``checkpoint.py``).

A serving deployment can move streams across processes or cards without
losing the 3 s loudness window, the rings or the trigger locks: the whole
engine carry goes to one ``.npz``, each leaf under its path, with a
fingerprint of the config.  Restore checks the fingerprint, so a
checkpoint never loads into an engine of another config.

The format is the JAX package's: the same ``CARRY_FORMAT_VERSION``, the
same leaf paths (``"oscilloscope/hist/0"``) in its order (dict keys
sorted), the same fingerprint (each config prints as the reference's).
Host scalars are saved as 0-d arrays and come back as host ints and bools.
Leaves are matched by path, never by position: ``torch.utils._pytree``
flattens a dict in insertion order.  A checkpoint that the JAX package
wrote loads here; its sliding-DFT states, padded to the JAX kernel's
tiles, are cut as :func:`~openmeters_tpu_torch.convert.carry_from_jax`
cuts them.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np
import torch
import torch.utils._pytree as pytree

from openmeters_tpu_torch.convert import carry_from_jax

# raised whenever a relayout of the carry changes leaf structure or shapes
# without a visible config change; the resolved configs catch the rest
CARRY_FORMAT_VERSION = 2


def _config_fingerprint(engine) -> str:
    resolved = sorted((name, repr(a.config)) for name, a in engine.analyzers.items())
    payload = f"carry-v{CARRY_FORMAT_VERSION}:{repr(engine.config)}:{resolved!r}"
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _parts(path) -> tuple:
    return tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path)


def _flatten(carry) -> list[tuple[str, object]]:
    """``[(path, leaf)]`` in the JAX package's order: depth first, dict keys
    sorted, sequences by index."""
    items = sorted(
        ((_parts(path), leaf) for path, leaf in pytree.tree_flatten_with_path(carry)[0]),
        key=lambda it: it[0],
    )
    return [("/".join(map(str, parts)), leaf) for parts, leaf in items]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, bool):
        return np.asarray(leaf, bool)
    return np.asarray(leaf, np.int32)


def save_state(path: str, engine, carry) -> None:
    items = _flatten(carry)
    arrays = {f"leaf_{i}": _to_numpy(v) for i, (_, v) in enumerate(items)}
    meta = {
        "fingerprint": _config_fingerprint(engine),
        "paths": [p for p, _ in items],
        "n_streams": _infer_streams(engine, dict(items)),
    }
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(path, **arrays)


def load_state(path: str, engine, device="cuda") -> dict:
    """The carry in ``path`` for ``engine``, on ``device``."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        if meta["fingerprint"] != _config_fingerprint(engine):
            raise ValueError(
                "checkpoint was written by a different engine config "
                f"({meta['fingerprint']} != {_config_fingerprint(engine)})"
            )
        saved = {p: z[f"leaf_{i}"] for i, p in enumerate(meta["paths"])}
    n_streams = meta.get("n_streams")
    if n_streams is None:  # written before the count was stored
        n_streams = _infer_streams(engine, saved)
    template = engine.init(n_streams, device="meta")
    want = dict(_flatten(template))
    if set(saved) != set(want):
        raise ValueError("checkpoint structure mismatch")
    paths, spec = pytree.tree_flatten_with_path(template)
    names = ["/".join(map(str, _parts(path))) for path, _ in paths]
    tree = pytree.tree_unflatten([saved[name] for name in names], spec)
    carry = carry_from_jax(tree, engine, device=device)
    for name, got in _flatten(carry):
        if isinstance(got, torch.Tensor) and got.shape != want[name].shape:
            raise ValueError(f"leaf shape mismatch at {name}: {tuple(got.shape)} vs {tuple(want[name].shape)}")
    return carry


def _infer_streams(engine, leaves: dict) -> int:
    """The stream count of ``leaves`` (``{path: array or tensor}``): the
    first axis that grows by exactly one from ``engine.init(1)`` to
    ``engine.init(2)`` is the stream axis."""
    one = _flatten(engine.init(1, device="meta"))
    two = dict(_flatten(engine.init(2, device="meta")))
    for name, a in one:
        for ax, (d1, d2) in enumerate(zip(np.shape(a), np.shape(two[name]))):
            if d2 - d1 == 1 and name in leaves:
                return int(np.shape(leaves[name])[ax])
    raise ValueError("cannot infer stream count from checkpoint")
