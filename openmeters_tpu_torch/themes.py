"""Theme store: named palette sets persisted as diffs from defaults (port
of ``themes.py``, host code on numpy as there: a theme file written by
either package loads in the other with the same palettes).

Reference parity: ``src/persistence/theme.rs`` and ``palette.rs`` — themes
are separate JSON files in a ``themes/`` directory; built-in themes are
read-only; saving a new theme auto-names it ``default-custom-N``; palettes
persist only what differs from the per-visual defaults (colors when changed,
interior stop positions when moved, spreads when != 1)
(theme.rs:14-140, palette.rs:37-84).

Headless themes carry the per-visual :class:`~openmeters_tpu_torch.views.
GradientPalette` parameters consumed by downstream renderers.  Image panes
(spectrogram) shade through the whole gradient; line/bar panes read their
colors off the gradient's endpoints — ``evaluate(1.0)`` is the primary
stroke and ``evaluate(0.0)`` the secondary accent (second oscilloscope
channel, integrated-loudness bar) — so the builtin ``default`` theme
reproduces the renderer's stock colors exactly and a custom theme recolors
every pane through the same stop-editing surface the reference's
palette_editor widget drives (``ui/palette_editor.rs``).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from openmeters_tpu_torch.persistence import write_json_atomic
from openmeters_tpu_torch.views import HEAT_RAMP, GradientPalette, sanitize_stop_spreads

EPSILON = 1e-6
VISUALS = ("loudness", "spectrogram", "spectrum", "oscilloscope", "stereometer", "waveform")


# stock renderer colors as 2-stop [secondary, primary] gradients (render.py
# frame-function defaults); spectrogram keeps the full heat ramp
_DEFAULT_PALETTES = {
    "spectrogram": HEAT_RAMP,
    "spectrum": GradientPalette.make([[0.3, 0.9, 1.0, 0.0], [0.3, 0.9, 1.0, 1.0]]),
    "oscilloscope": GradientPalette.make([[1.0, 0.6, 0.2, 1.0], [0.3, 0.9, 1.0, 1.0]]),
    "stereometer": GradientPalette.make([[0.3, 0.9, 1.0, 0.0], [0.3, 0.9, 1.0, 0.35]]),
    "waveform": GradientPalette.make([[0.3, 0.9, 1.0, 1.0], [0.3, 0.9, 1.0, 1.0]]),
    "loudness": GradientPalette.make([[0.2, 0.55, 0.9, 1.0], [0.3, 0.9, 1.0, 1.0]]),
}


def _default_palette(visual: str) -> GradientPalette:
    return _DEFAULT_PALETTES.get(
        visual, GradientPalette.make([[0, 0, 0, 1], [1, 1, 1, 1]])
    )


@dataclasses.dataclass(frozen=True)
class Theme:
    name: str
    builtin: bool = False
    palettes: dict = dataclasses.field(default_factory=dict)  # visual -> GradientPalette

    def palette(self, visual: str) -> GradientPalette:
        return self.palettes.get(visual, _default_palette(visual))

    def stroke(self, visual: str, t: float = 1.0) -> tuple:
        """Line/bar color for a pane: the gradient endpoint at ``t``
        (1.0 = primary stroke, 0.0 = secondary accent)."""
        return tuple(float(c) for c in self.palette(visual).evaluate(t))


def palette_diff(palette: GradientPalette, default: GradientPalette) -> dict | None:
    """Persist only what differs from the default (palette.rs:37-84)."""
    out = {}
    if palette.colors.shape != default.colors.shape or not np.allclose(
        palette.colors, default.colors, atol=EPSILON
    ):
        out["stops"] = palette.colors.tolist()
    n = len(default.colors)
    if n > 2 and not np.allclose(palette.positions, default.positions, atol=EPSILON):
        out["stop_positions"] = palette.positions[1 : n - 1].tolist()
    spreads = sanitize_stop_spreads(palette.spreads, n)
    if np.any(np.abs(spreads - 1.0) > EPSILON):
        out["stop_spreads"] = spreads.tolist()
    return out or None


def palette_from_diff(diff: dict | None, default: GradientPalette) -> GradientPalette:
    if not diff:
        return default
    colors = np.asarray(diff.get("stops", default.colors), np.float32)
    n = len(colors)
    positions = default.positions
    if "stop_positions" in diff and n > 2:
        interior = np.asarray(diff["stop_positions"], np.float32)[: n - 2]
        positions = np.concatenate([[0.0], interior, [1.0]]).astype(np.float32)
    spreads = diff.get("stop_spreads")
    return GradientPalette.make(colors, positions, spreads)


BUILTIN_THEMES = {
    "default": Theme("default", builtin=True),
    "heat": Theme("heat", builtin=True, palettes={"spectrogram": HEAT_RAMP}),
}


class ThemeStore:
    """themes/ directory of JSON theme files (theme.rs:14-140)."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def list_themes(self) -> list[str]:
        names = list(BUILTIN_THEMES)
        for fn in sorted(os.listdir(self.directory)):
            if fn.endswith(".json"):
                names.append(fn[:-5])
        return names

    def load(self, name: str) -> Theme:
        if name in BUILTIN_THEMES:
            return BUILTIN_THEMES[name]
        path = os.path.join(self.directory, f"{name}.json")
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            return BUILTIN_THEMES["default"]
        palettes = {}
        for visual in VISUALS:
            diff = doc.get("palettes", {}).get(visual)
            if diff:
                palettes[visual] = palette_from_diff(diff, _default_palette(visual))
        return Theme(name=name, palettes=palettes)

    def save(self, theme: Theme, name: str | None = None) -> str:
        """Save; builtin names are read-only -> auto-name default-custom-N
        (theme.rs auto-naming)."""
        name = name or theme.name
        if name in BUILTIN_THEMES:
            name = self._next_custom_name()
        doc = {"palettes": {}}
        for visual, palette in theme.palettes.items():
            diff = palette_diff(palette, _default_palette(visual))
            if diff:
                doc["palettes"][visual] = diff
        write_json_atomic(os.path.join(self.directory, f"{name}.json"), doc)
        return name

    def delete(self, name: str) -> bool:
        if name in BUILTIN_THEMES:
            return False  # builtin themes are read-only
        try:
            os.unlink(os.path.join(self.directory, f"{name}.json"))
            return True
        except OSError:
            return False

    def _next_custom_name(self) -> str:
        taken = set(self.list_themes())
        n = 1
        while f"default-custom-{n}" in taken:
            n += 1
        return f"default-custom-{n}"
