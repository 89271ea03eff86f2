"""Deciding ``correct``: every analyzer a configuration enables is checked
by the reference module ``reference/<analyzer>.py`` or
``reference/<analyzer>_<variant>.py`` whose ``supported`` takes its
settings, on the sampled streams, over each fetched
hop of the window and the capture hop after it, and each compared number
is held to the configuration's ``limits``.

The control (``precision="tf32"``) puts the reference computed at TF32 in
the program's place, over the same streams, hops and leaves."""

from __future__ import annotations

import numpy as np

from meterbench import manifest


def reference(analyzer: str, cfg: dict):
    """The reference module that takes ``analyzer`` at settings ``cfg``."""
    import importlib

    root = manifest.HERE / "reference"
    paths = [root / f"{analyzer}.py", *sorted(root.glob(f"{analyzer}_*.py"))]
    for path in paths:
        if path.exists():
            mod = importlib.import_module(f"meterbench.reference.{path.stem}")
            if mod.supported(cfg):
                return mod
    raise NotImplementedError(f"no reference takes the {analyzer} analyzer at {cfg}")


def _section(engine: dict, analyzer: str) -> dict:
    value = engine.get(analyzer, {})
    return dict(value) if value else {}


def numbers(cell: manifest.Cell, run_, samples, precision: str | None = None) -> dict:
    """The compared numbers of one run.  ``samples(k, frames)`` gives what
    the ``k``-th sampled stream received.  ``precision=None`` judges the
    program's outputs; ``"tf32"`` the control's."""
    engine = cell.config["engine"]
    hops = list(run_.drained_hops) + [run_.final_hop]
    frames = (max(hops) + 1) * 256
    out: dict[str, float] = {}
    for analyzer in manifest.enabled_analyzers(engine):
        cfg = _section(engine, analyzer)
        mod = reference(analyzer, cfg)
        for k in range(len(run_.sampled)):
            x = samples(k, frames)
            want = mod.expected(x, hops, cfg, "f64")
            got = mod.expected(x, hops, cfg, precision) if precision else None
            g, w = {}, {}
            for field, leaf in mod.LEAVES.items():
                rows, idx = [], []
                if leaf in run_.drained:
                    rows += [run_.drained[leaf][i, k] for i in range(len(run_.drained_hops))]
                    idx += list(range(len(run_.drained_hops)))
                if leaf in run_.final:
                    rows.append(run_.final[leaf][k])
                    idx.append(len(hops) - 1)
                if not idx:
                    continue
                w[field] = want[field][idx]
                if f"{field}_ties" in want:
                    w[f"{field}_ties"] = want[f"{field}_ties"][idx]
                g[field] = np.stack(rows) if got is None else got[field][idx]
            for name, v in mod.gaps(g, w).items():
                out[name] = max(out.get(name, 0.0), v)
    return out


def verdict(found: dict, limits: dict) -> bool:
    missing = set(found) ^ set(limits)
    if missing:
        raise KeyError(f"compared numbers and limits differ: {sorted(missing)}")
    return all(found[k] <= limits[k] for k in found)
