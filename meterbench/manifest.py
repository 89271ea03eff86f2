"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``configs/<name>.json``, via the manifest's
``file``) and a traffic mix (``traffic/<name>.json``); each per-layer
metric is a reader ``metrics/<name>.py``; each analyzer a configuration
enables is checked by ``reference/<analyzer>.py``.  Adding a cell, a
configuration, a mix or a metric adds files and manifest entries and edits
none.
"""

from __future__ import annotations

import dataclasses
import enum
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"
ANALYZERS = {
    # EngineConfig field -> (module of the port, config class)
    "loudness": ("openmeters_tpu_torch.analyzers.loudness", "LoudnessConfig"),
    "spectrogram": ("openmeters_tpu_torch.analyzers.spectrogram", "SpectrogramConfig"),
    "spectrum": ("openmeters_tpu_torch.analyzers.spectrum", "SpectrumConfig"),
    "oscilloscope": ("openmeters_tpu_torch.analyzers.oscilloscope", "OscilloscopeConfig"),
    "stereometer": ("openmeters_tpu_torch.analyzers.stereometer", "StereometerConfig"),
    "waveform": ("openmeters_tpu_torch.analyzers.waveform", "WaveformConfig"),
}


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's object
    traffic: dict  # the traffic file's object
    end_to_end: list  # manifest entries of the metrics this cell reports with --trace 0
    per_layer: list  # ... with --trace 1


def load_manifest(path: pathlib.Path = MANIFEST) -> dict:
    return json.loads(path.read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, manifest: dict | None = None) -> Cell:
    m = manifest if manifest is not None else load_manifest()
    w = next((w for w in m["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {[x['name'] for x in m['workloads']]}")
    cfg_entry = next(c for c in m["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[e for e in m["end_to_end"] if _applies(e, name)],
        per_layer=[p for p in m["per_layer"] if _applies(p, name)],
    )


def load_module(path: pathlib.Path, name: str):
    """Import a reader or a reference from its file (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py", f"meterbench_metric_{name.replace('.', '_')}")


def engine_config(engine: dict):
    """The port's ``EngineConfig`` from a configuration's ``engine`` object:
    each analyzer key a mapping of its config's fields (an enum by its
    value), ``null`` for off, absent for the default."""
    import importlib

    from openmeters_tpu_torch.engine import EngineConfig

    kw = {}
    for key, value in engine.items():
        if key not in ANALYZERS:
            kw[key] = value
        elif value is None:
            kw[key] = None
        else:
            module, cls_name = ANALYZERS[key]
            cls = getattr(importlib.import_module(module), cls_name)
            defaults = cls()
            fields = {}
            for f, v in value.items():
                d = getattr(defaults, f)
                fields[f] = type(d)(v) if isinstance(d, enum.Enum) else v
            kw[key] = cls(**fields)
    return EngineConfig(**kw)


def enabled_analyzers(engine: dict) -> list[str]:
    """The analyzers a configuration runs: every one of the engine's six
    unless set to ``null``."""
    return [a for a in ANALYZERS if engine.get(a, {}) is not None]
