"""Carry state across packages.

The meters hold no weights: what crosses between the JAX package and this
one is the engine carry.  The JAX carry comes in as numpy arrays, with the
shared scalars as 0-d arrays; here those scalars are host ints (or bools):
ring origins and hop counters, the sliding states' ``count`` and
``anchored``, the waveform's ``ring_head``.  Everything else is a tensor.
Both trees nest dicts and tuples.  A sliding-DFT state that the JAX
package stores padded to its kernel's 512-bin tiles is cut to ``bins``.
The classic spectrogram's sliding state (``spectrogram/sdft``), which the
JAX package and earlier versions of this one carry, is dropped: this
package computes each classic column from its own frame and holds none.
"""

from __future__ import annotations

import numpy as np
import torch


# subtrees that a carry from the JAX package or an earlier version of this
# one may hold and this package no longer does
RETIRED = ("/spectrogram/sdft",)


def _template(engine) -> dict:
    return engine.init(1, device="meta")


def carry_from_jax(carry_np: dict, engine, device="cuda") -> dict:
    """The port's carry for ``engine`` from the JAX package's carry given
    as numpy arrays (``jax.device_get`` of it), on ``device`` (the card
    unless given ``"cpu"``).  Arrays are copied."""

    def convert(node, tmpl, path):
        if isinstance(tmpl, dict):
            node = {k: v for k, v in node.items() if k in tmpl or f"{path}/{k}" not in RETIRED}
            if set(node) != set(tmpl):
                raise KeyError(f"{path}: keys {sorted(node)} != {sorted(tmpl)}")
            return {k: convert(node[k], tmpl[k], f"{path}/{k}") for k in tmpl}
        if isinstance(tmpl, tuple):
            if not isinstance(node, (tuple, list)) or len(node) != len(tmpl):
                raise ValueError(f"{path}: want a sequence of {len(tmpl)}")
            return tuple(convert(n, t, f"{path}/{i}") for i, (n, t) in enumerate(zip(node, tmpl)))
        arr = np.asarray(node)
        if isinstance(tmpl, bool):
            return bool(arr)
        if isinstance(tmpl, int):
            return int(arr)
        if arr.ndim != tmpl.ndim:
            raise ValueError(f"{path}: rank {arr.ndim} != {tmpl.ndim}")
        bins = tmpl.shape[-1]
        if path.rsplit("/", 2)[-2:] in (["sdft", "re"], ["sdft", "im"]) and arr.shape[-1] > bins:
            arr = arr[..., :bins]  # the JAX kernel's tile padding
        return torch.tensor(arr, dtype=tmpl.dtype, device=device)

    return convert(carry_np, _template(engine), "")


def carry_to_numpy(carry: dict) -> dict:
    """Inverse of :func:`carry_from_jax`: host scalars become 0-d numpy
    arrays (int32 or bool), tensors become numpy arrays."""

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(convert(v) for v in node)
        if isinstance(node, bool):
            return np.asarray(node, bool)
        if isinstance(node, int):
            return np.asarray(node, np.int32)
        return node.detach().cpu().numpy()

    return convert(carry)
