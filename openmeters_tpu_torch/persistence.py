"""Settings persistence: lossy JSON schema + debounced atomic writer (port
of ``persistence.py``, on the port's configs and enums: one settings file
means the same configuration in both packages, and each writes it byte for
byte alike).

Reference parity: ``src/persistence/`` — settings are JSON with a *lossy*
schema: unknown keys are warned about and ignored, invalid values fall back
to defaults at the narrowest scope (``lossy.rs:8-60``, fixture test
``schema.rs:198-273``); every ``update()`` clones settings to a debounced
(500 ms) saver thread writing atomic tmp+rename JSON (``store.rs:88-181``,
``persistence.rs:13-20``); a final ``flush()`` runs on shutdown.

The persisted surface here is the engine/analyzer config tree (the headless
equivalent of the reference's per-visual settings structs, cf. the
``visual_settings!`` pairing macro, ``persistence/visuals.rs:151-243``).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import logging
import os
import tempfile
import threading
from typing import Any

from openmeters_tpu_torch.analyzers.loudness import LoudnessConfig
from openmeters_tpu_torch.analyzers.oscilloscope import OscilloscopeConfig, TriggerMode
from openmeters_tpu_torch.analyzers.spectrogram import SpectrogramConfig
from openmeters_tpu_torch.analyzers.spectrum import AveragingMode, SpectrumConfig
from openmeters_tpu_torch.analyzers.stereometer import StereometerConfig
from openmeters_tpu_torch.analyzers.waveform import WaveformConfig
from openmeters_tpu_torch.engine import EngineConfig
from openmeters_tpu_torch.utils.channels import Channel
from openmeters_tpu_torch.utils.windows import WindowKind

log = logging.getLogger("openmeters_tpu_torch.settings")

DEBOUNCE_SECONDS = 0.5  # reference store.rs:88-140

_ENUMS = (WindowKind, Channel, AveragingMode, TriggerMode)


def _encode(value: Any) -> Any:
    if isinstance(value, enum.Enum):
        return value.value
    if dataclasses.is_dataclass(value):
        return {
            f.name: _encode(getattr(value, f.name))
            for f in dataclasses.fields(value)
        }
    return value


def _decode_field(name: str, raw: Any, default: Any, scope: str) -> Any:
    """Lossy single-field decode: wrong type/invalid -> default + warning."""
    try:
        if isinstance(default, enum.Enum):
            return type(default)(raw)
        if dataclasses.is_dataclass(default):
            return _decode_struct(raw, default, f"{scope}.{name}")
        if isinstance(default, bool):
            if isinstance(raw, bool):
                return raw
            raise ValueError(raw)
        if isinstance(default, int) and not isinstance(default, bool):
            if isinstance(raw, bool) or not isinstance(raw, (int, float)):
                raise ValueError(raw)
            return int(raw)
        if isinstance(default, float):
            if isinstance(raw, bool) or not isinstance(raw, (int, float)):
                raise ValueError(raw)
            return float(raw)
        if default is None or isinstance(default, str):
            return raw
        raise ValueError(f"unsupported field type {type(default)}")
    except (ValueError, KeyError, TypeError):
        log.warning("[settings] invalid value for %s.%s: %r (using default)",
                    scope, name, raw)
        return default


def _decode_struct(raw: Any, default: Any, scope: str) -> Any:
    """Lossy dataclass decode (reference lossy.rs semantics)."""
    if not isinstance(raw, dict):
        if raw is not None:
            log.warning("[settings] invalid section %s: %r (using defaults)", scope, raw)
        return default
    fields = {f.name: f for f in dataclasses.fields(default)}
    out = {}
    for key, value in raw.items():
        if key not in fields:
            log.warning("[settings] unknown key %s.%s ignored", scope, key)
            continue
        out[key] = _decode_field(key, value, getattr(default, key), scope)
    return dataclasses.replace(default, **out)


_SECTION_DEFAULTS = {
    "loudness": LoudnessConfig(),
    "spectrogram": SpectrogramConfig(),
    "spectrum": SpectrumConfig(),
    "oscilloscope": OscilloscopeConfig(),
    "stereometer": StereometerConfig(),
    "waveform": WaveformConfig(),
}

_PANE_NAMES = tuple(_SECTION_DEFAULTS)


@dataclasses.dataclass(frozen=True)
class UiSettings:
    """Presentation settings persisted alongside the engine config: the
    selected theme and the pane-grid layout (reference ``UiSettings``
    carries the theme + ``pane_grid`` state, persistence/visuals.rs;
    layout rows map to the reference's drag-reorderable pane grid,
    ``ui/pane_grid.rs``)."""

    theme: str = "default"
    # rows of pane names; panes whose analyzer is disabled are skipped at
    # render time.  Kept so a settings file round-trips with the JAX
    # package; the port reads it once its render layer lands (ROADMAP A11e)
    pane_layout: tuple = (
        ("loudness", "spectrum", "stereometer"),
        ("spectrogram", "oscilloscope", "waveform"),
    )


def encode_ui(ui: UiSettings) -> dict:
    return {
        "theme": ui.theme,
        "pane_layout": [list(row) for row in ui.pane_layout],
    }


def decode_ui(raw: Any, default: UiSettings | None = None) -> UiSettings:
    """Lossy ui-section decode: bad rows/names are dropped with a warning,
    a fully invalid section falls back to the default layout."""
    default = default or UiSettings()
    if raw is None:
        return default
    if not isinstance(raw, dict):
        log.warning("[settings] invalid section ui: %r (using defaults)", raw)
        return default
    theme = raw.get("theme", default.theme)
    if not isinstance(theme, str):
        log.warning("[settings] invalid value for ui.theme: %r (using default)", theme)
        theme = default.theme
    layout = default.pane_layout
    if "pane_layout" in raw:
        rows = []
        ok = isinstance(raw["pane_layout"], list)
        for row in raw["pane_layout"] if ok else ():
            if not isinstance(row, list):
                ok = False
                continue
            keep = [p for p in row if p in _PANE_NAMES]
            for p in row:
                if p not in _PANE_NAMES:
                    log.warning("[settings] unknown pane ui.pane_layout: %r ignored", p)
            if keep:
                rows.append(tuple(keep))
        if not ok:
            log.warning("[settings] invalid ui.pane_layout (using default)")
        elif rows:
            layout = tuple(rows)
    for key in raw:
        if key not in ("theme", "pane_layout"):
            log.warning("[settings] unknown key ui.%s ignored", key)
    return UiSettings(theme=theme, pane_layout=layout)


def encode_settings(config: EngineConfig) -> dict:
    doc: dict = {
        "sample_rate": config.sample_rate,
        "block_frames": config.block_frames,
        "channels": config.channels,
        "enabled": {},
    }
    for name in _SECTION_DEFAULTS:
        section = getattr(config, name)
        doc["enabled"][name] = section is not None
        if section is not None:
            doc[name] = _encode(section)
    return doc


def decode_settings(doc: Any, default: EngineConfig | None = None) -> EngineConfig:
    default = default or EngineConfig()
    if not isinstance(doc, dict):
        log.warning("[settings] root is not an object; using defaults")
        return default
    updates: dict = {}
    for key in ("sample_rate", "block_frames", "channels"):
        if key in doc:
            updates[key] = _decode_field(
                key, doc[key], getattr(default, key), "engine"
            )
    enabled = doc.get("enabled", {})
    if not isinstance(enabled, dict):
        enabled = {}
    for name, section_default in _SECTION_DEFAULTS.items():
        on = enabled.get(name)
        if on is False:
            updates[name] = None
            continue
        current = getattr(default, name) or section_default
        updates[name] = _decode_struct(doc.get(name), current, name)
    for key in doc:
        if key not in ("sample_rate", "block_frames", "channels", "enabled",
                       "ui", *_SECTION_DEFAULTS):
            log.warning("[settings] unknown key %s ignored", key)
    return dataclasses.replace(default, **updates)


def write_json_atomic(path: str, doc: Any) -> None:
    """tmp + rename (reference persistence.rs:13-20)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=2)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class SettingsHandle:
    """Debounced settings store (reference store.rs:88-181).

    ``update()`` schedules a save 500 ms out (collapsing bursts);
    ``flush()`` writes immediately (call on shutdown, main.rs:59).
    """

    def __init__(self, path: str, default: EngineConfig | None = None):
        self.path = path
        self._lock = threading.Lock()
        self._timer: threading.Timer | None = None
        self.config = self.load_or_default(path, default)
        self.ui = self.load_ui_or_default(path)

    @staticmethod
    def _read_doc(path: str) -> Any:
        try:
            with open(path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, json.JSONDecodeError) as e:
            log.warning("[settings] unreadable %s: %s (using defaults)", path, e)
            return None

    @staticmethod
    def load_or_default(path: str, default: EngineConfig | None = None) -> EngineConfig:
        doc = SettingsHandle._read_doc(path)
        if doc is None:
            return default or EngineConfig()
        return decode_settings(doc, default)

    @staticmethod
    def load_ui_or_default(path: str, default: UiSettings | None = None) -> UiSettings:
        doc = SettingsHandle._read_doc(path)
        if not isinstance(doc, dict):
            return default or UiSettings()
        return decode_ui(doc.get("ui"), default)

    def update(self, config: EngineConfig) -> None:
        with self._lock:
            self.config = config
            self._schedule_save_locked()

    def update_ui(self, ui: UiSettings) -> None:
        with self._lock:
            self.ui = ui
            self._schedule_save_locked()

    def _schedule_save_locked(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
        self._timer = threading.Timer(DEBOUNCE_SECONDS, self._save)
        self._timer.daemon = True
        self._timer.start()

    def _encode_doc(self, cfg: EngineConfig, ui: UiSettings) -> dict:
        doc = encode_settings(cfg)
        doc["ui"] = encode_ui(ui)
        return doc

    def _save(self) -> None:
        with self._lock:
            cfg, ui = self.config, self.ui
            self._timer = None
        write_json_atomic(self.path, self._encode_doc(cfg, ui))

    def flush(self) -> None:
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
        write_json_atomic(self.path, self._encode_doc(self.config, self.ui))
