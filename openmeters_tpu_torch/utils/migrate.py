"""Carry migration shared by the analyzers' ``migrate_from`` methods (port
of ``utils/migrate.py``).

A settings change keeps what it can of a live carry, field by field, as
the reference's ``update_config`` does for each processor.  Each analyzer
has ``migrate_from(old_analyzer, carry, n_streams)``, which returns the
carry to go on with (``None``: start afresh).  This module holds the
"keep what still fits" merge they share.

Trees are compared key by key: ``torch.utils._pytree`` flattens a dict in
its insertion order, where the JAX package sorts keys, so two equal carries
built in different orders must still match.  A tensor leaf fits a tensor
of the same shape and dtype; a host scalar (ring origins, hop counters,
``anchored`` flags) fits one of the same Python type.
"""

from __future__ import annotations

import torch
import torch.utils._pytree as pytree


def _by_path(tree) -> dict:
    return {pytree.keystr(path): leaf for path, leaf in pytree.tree_flatten_with_path(tree)[0]}


def _leaf_fits(a, b) -> bool:
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (
            isinstance(a, torch.Tensor)
            and isinstance(b, torch.Tensor)
            and a.shape == b.shape
            and a.dtype == b.dtype
        )
    return type(a) is type(b)


def _compatible(a, b) -> bool:
    la, lb = _by_path(a), _by_path(b)
    return la.keys() == lb.keys() and all(_leaf_fits(la[k], lb[k]) for k in la)


def merge_carry(fresh: dict, carry: dict) -> dict:
    """Per key: the carried subtree where its structure, shapes and dtypes
    match the fresh template's, else the fresh subtree (state the old
    config did not have, or state of another size)."""
    return {
        k: carry[k] if k in carry and _compatible(carry[k], v) else v
        for k, v in fresh.items()
    }


def carry_device(carry) -> torch.device:
    """The device of a carry's tensors: where fresh parts of a migrated
    carry are made."""
    for leaf in pytree.tree_leaves(carry):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")
