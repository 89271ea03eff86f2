"""The port's theme store (``themes.py``), its CLI (``themes``) and the
persisted ``ui`` section against the JAX package's: tests/test_themes_backoff.py's
theme and UI cases as pairs, and theme files crossing both ways."""

import contextlib
import io
import json
import logging

import numpy as np
import pytest

pytest.importorskip("torch")

import openmeters_tpu.persistence as jpersist  # noqa: E402
import openmeters_tpu.themes as jthemes  # noqa: E402
import openmeters_tpu.views as jviews  # noqa: E402
import openmeters_tpu_torch.persistence as tpersist  # noqa: E402
import openmeters_tpu_torch.themes as tthemes  # noqa: E402
import openmeters_tpu_torch.views as tviews  # noqa: E402

PACKAGES = {"jax": (jthemes, jviews), "torch": (tthemes, tviews)}


def palette_arrays(p) -> list:
    return [np.asarray(p.colors), np.asarray(p.positions), np.asarray(p.spreads)]


def assert_same_palette(a, b) -> None:
    for x, y in zip(palette_arrays(a), palette_arrays(b)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_defaults_and_builtins_identical():
    """Every visual's default palette, the builtin themes and their stroke
    colours are the JAX package's."""
    assert tthemes.VISUALS == jthemes.VISUALS and tthemes.EPSILON == jthemes.EPSILON
    assert set(tthemes.BUILTIN_THEMES) == set(jthemes.BUILTIN_THEMES)
    for visual in (*jthemes.VISUALS, "nosuch"):
        assert_same_palette(tthemes._default_palette(visual), jthemes._default_palette(visual))
        for name in jthemes.BUILTIN_THEMES:
            t, j = tthemes.BUILTIN_THEMES[name], jthemes.BUILTIN_THEMES[name]
            assert_same_palette(t.palette(visual), j.palette(visual))
            for pos in (0.0, 0.3, 1.0):
                assert t.stroke(visual, pos) == j.stroke(visual, pos)


def test_stroke_endpoints_match_stock_colors():
    """tests/test_themes_backoff.py's stroke case: the builtin default
    reproduces the renderer's stock colours in the port too."""
    default = tthemes.BUILTIN_THEMES["default"]
    approx = pytest.approx
    assert default.stroke("spectrum") == approx((0.3, 0.9, 1.0, 1.0))
    assert default.stroke("oscilloscope", 1.0) == approx((0.3, 0.9, 1.0, 1.0))
    assert default.stroke("oscilloscope", 0.0) == approx((1.0, 0.6, 0.2, 1.0))
    assert default.stroke("stereometer") == approx((0.3, 0.9, 1.0, 0.35))
    assert default.stroke("loudness", 0.0) == approx((0.2, 0.55, 0.9, 1.0))


@pytest.mark.parametrize("edit", ["positions_spreads", "colors", "two_stop", "none"])
def test_palette_diff_roundtrip_identical(edit):
    """``palette_diff`` and ``palette_from_diff`` give the JAX package's
    dicts and palettes (tests/test_themes_backoff.py's diff case, and more
    edits)."""
    out = {}
    for name, (themes, views) in PACKAGES.items():
        visual = "spectrum" if edit == "two_stop" else "spectrogram"
        default = themes._default_palette(visual)
        colors = np.array(default.colors)
        kw = {}
        if edit == "positions_spreads":
            kw = dict(positions=[0.0, 0.2, 0.5, 0.8, 1.0], spreads=[1, 2, 1, 1, 1])
        elif edit == "colors":
            colors[2] = [0.25, 0.5, 0.75, 1.0]
        elif edit == "two_stop":
            colors[0] = [1.0, 0.0, 0.0, 0.5]
            kw = dict(spreads=[1.0, 3.0])
        custom = views.GradientPalette.make(colors, **kw)
        diff = themes.palette_diff(custom, default)
        out[name] = (diff, themes.palette_from_diff(diff, default))
    assert out["torch"][0] == out["jax"][0]
    assert_same_palette(out["torch"][1], out["jax"][1])
    if edit == "none":
        assert out["torch"][0] is None


def test_theme_store_roundtrip_and_builtin_protection(tmp_path):
    """tests/test_themes_backoff.py's store case in the port: save, load,
    defaults for untouched visuals, builtin names read-only and
    auto-named, delete."""
    store = tthemes.ThemeStore(str(tmp_path / "themes"))
    assert set(tthemes.BUILTIN_THEMES) <= set(store.list_themes())
    custom = tthemes.Theme("mine", palettes={
        "spectrum": tviews.GradientPalette.make([[0, 0, 0, 1], [1, 0, 0, 1]], spreads=[2.0, 1.0])})
    assert store.save(custom) == "mine"
    loaded = store.load("mine")
    np.testing.assert_allclose(loaded.palette("spectrum").spreads, [2.0, 1.0])
    assert loaded.palette("spectrogram") is tthemes._default_palette("spectrogram")
    assert store.save(tthemes.Theme("default")) == "default-custom-1"
    assert store.save(tthemes.Theme("default")) == "default-custom-2"
    assert not store.delete("default")
    assert store.delete("default-custom-1")
    assert store.load("nosuch") is tthemes.BUILTIN_THEMES["default"]


def _theme(pkg: str, name: str):
    themes, views = PACKAGES[pkg]
    heat = np.array(views.HEAT_RAMP.colors)
    heat[1] = [0.5, 0.1, 0.9, 1.0]
    return themes.Theme(name, palettes={
        "spectrogram": views.GradientPalette.make(heat, [0.0, 0.3, 0.5, 0.7, 1.0], [1, 2, 1, 0.5, 1]),
        "oscilloscope": views.GradientPalette.make([[1, 0, 0, 1], [0, 1, 0, 1]]),
        "loudness": themes._default_palette("loudness"),
    })


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_theme_files_cross_both_ways(tmp_path, writer):
    """A theme saved by one package's store is the same file the other's
    writes, and loads in the other with the same palettes."""
    reader = "torch" if writer == "jax" else "jax"
    d = {k: tmp_path / k for k in PACKAGES}
    for pkg in PACKAGES:
        assert PACKAGES[pkg][0].ThemeStore(str(d[pkg])).save(_theme(pkg, "crossed")) == "crossed"
    assert (d["jax"] / "crossed.json").read_bytes() == (d["torch"] / "crossed.json").read_bytes()
    loaded = PACKAGES[reader][0].ThemeStore(str(d[writer])).load("crossed")
    own = PACKAGES[reader][0].ThemeStore(str(d[reader])).load("crossed")
    assert set(loaded.palettes) == set(own.palettes) == {"spectrogram", "oscilloscope"}
    for visual in PACKAGES[reader][0].VISUALS:
        assert_same_palette(loaded.palette(visual), own.palette(visual))


def _cli(main, argv) -> tuple[int, str]:
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rc = main(argv)
    return rc, buf.getvalue()


def test_themes_cli_editor_flow_identical(tmp_path):
    """tests/test_themes_backoff.py's editor flow through both CLIs: the
    same exit codes, output and theme files at every step."""
    from openmeters_tpu.__main__ import main as jmain
    from openmeters_tpu_torch.__main__ import main as tmain

    steps = [
        ["create", "mytheme", "--base", "heat"],
        ["set-stop", "mytheme", "spectrogram", "--stop", "1", "--color", "0.5,0.1,0.9", "--spread", "2.0"],
        ["set-stop", "mytheme", "spectrogram", "--stop", "2", "--position", "0.45", "--color", "0.2,0.3,0.4,0.5"],
        ["set-stop", "mytheme", "oscilloscope", "--stop", "5"],
        ["show", "mytheme"],
        ["list"],
        ["create", "--base", "default"],
        ["delete", "default"],
        ["show"],
        ["set-stop", "mytheme", "nosuch"],
        ["delete", "mytheme"],
        ["list"],
    ]
    for step in steps:
        outs = {}
        for name, main in (("jax", jmain), ("torch", tmain)):
            d = tmp_path / name
            outs[name] = _cli(main, ["themes", *step, "--dir", str(d)])
            outs[name] += (sorted((p.name, p.read_bytes()) for p in d.glob("*.json")),)
        assert outs["torch"] == outs["jax"], step
    doc = json.loads(_cli(tmain, ["themes", "show", "default-custom-1", "--dir", str(tmp_path / "torch")])[1])
    assert doc["name"] == "default-custom-1"


def test_ui_settings_lossy_decode_and_persist(tmp_path, caplog):
    """tests/test_themes_backoff.py's ui case on both packages: the same
    lossy decode and warnings, and a settings file with a ``ui`` section
    written by either reads back the same in the other."""
    raw = {"theme": "heat", "pane_layout": [["spectrum", "nosuchpane"], ["waveform"], []], "mystery": 1}
    for pkg, logger in ((jpersist, "openmeters_tpu.settings"), (tpersist, "openmeters_tpu_torch.settings")):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=logger):
            ui = pkg.decode_ui(raw)
        assert ui.theme == "heat" and ui.pane_layout == (("spectrum",), ("waveform",))
        assert "nosuchpane" in caplog.text and "mystery" in caplog.text
        assert pkg.decode_ui(42).pane_layout == pkg.UiSettings().pane_layout
        assert pkg.decode_ui({"theme": 3}).theme == "default"
    paths = {}
    for name, pkg in (("jax", jpersist), ("torch", tpersist)):
        paths[name] = str(tmp_path / f"{name}.json")
        h = pkg.SettingsHandle(paths[name])
        h.update_ui(pkg.UiSettings(theme="heat", pane_layout=(("loudness",),)))
        h.flush()
    assert open(paths["jax"], "rb").read() == open(paths["torch"], "rb").read()
    for pkg, path in ((tpersist, paths["jax"]), (jpersist, paths["torch"])):
        ui = pkg.SettingsHandle.load_ui_or_default(path)
        assert ui.theme == "heat" and ui.pane_layout == (("loudness",),)


def test_resolve_theme_from_flag_settings_and_store(tmp_path):
    """The served theme: ``--theme`` over the settings file's ``ui.theme``
    over the builtin default; a stored theme loads from ``--themes-dir``."""
    from openmeters_tpu_torch.__main__ import _resolve_theme

    store = tthemes.ThemeStore(str(tmp_path / "themes"))
    store.save(_theme("torch", "stored"))
    settings = str(tmp_path / "s.json")
    h = tpersist.SettingsHandle(settings)
    h.update_ui(tpersist.UiSettings(theme="stored"))
    h.flush()
    d = str(tmp_path / "themes")
    assert _resolve_theme(None, d, None) is tthemes.BUILTIN_THEMES["default"]
    assert _resolve_theme("heat", d, settings) is tthemes.BUILTIN_THEMES["heat"]
    from_settings = _resolve_theme(None, d, settings)
    assert from_settings.name == "stored"
    assert_same_palette(from_settings.palette("oscilloscope"), _theme("torch", "x").palette("oscilloscope"))
