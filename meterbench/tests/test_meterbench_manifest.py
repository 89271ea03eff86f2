"""BENCHMARK.json against the benchmark's contract, and the files it names."""

from __future__ import annotations

import json
import re

import pytest

from meterbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def m():
    return manifest.load_manifest()


def test_top_level_keys(m):
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/") for p in m["paths"])
    assert len(m["command"]) <= 32 and m["command"][1].startswith("meterbench/")
    assert len(manifest.MANIFEST.read_bytes()) <= 64 * 1024


def test_names_and_units_use_allowed_characters(m):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in m[k]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for w in m["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in m["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for e in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(e["unit"]), e["unit"]
        assert e["better"] in ("lower", "higher") and e["source"] in SOURCES
    for e in m["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace") and 0 < e["bound"] <= 0.25


def test_every_cell_reports_what_the_contract_asks(m):
    e2e = {e["name"] for e in m["end_to_end"]}
    assert "setup_s" in e2e
    for w in m["workloads"]:
        cell = manifest.cell(w["name"], m)
        reported = {e["name"] for e in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for p in cell.per_layer:
            assert p["moves"] in reported, (p["name"], w["name"])


def test_each_named_file_is_there(m):
    used = {w["config"] for w in m["workloads"]}
    assert used == {c["name"] for c in m["configs"]}
    for c in m["configs"]:
        config = json.loads((manifest.ROOT / c["file"]).read_text())
        assert c["file"].startswith("meterbench/configs/")
        assert config["name"] == c["name"] and config["reduced"] == c["reduced"]
        for analyzer in manifest.enabled_analyzers(config["engine"]):
            assert (manifest.HERE / "reference" / f"{analyzer}.py").exists(), analyzer
        assert config["limits"]
    for w in m["workloads"]:
        assert (manifest.HERE / "traffic" / f"{w['traffic']}.json").exists()


def test_each_metric_has_a_reader(m):
    for p in m["per_layer"]:
        assert callable(manifest.metric_reader(p["name"]).read)


def test_engine_config_builds_from_the_file(m):
    from openmeters_tpu_torch.engine import EngineConfig

    for c in m["configs"]:
        config = json.loads((manifest.ROOT / c["file"]).read_text())
        ecfg = manifest.engine_config(config["engine"])
        assert isinstance(ecfg, EngineConfig)
        for analyzer in manifest.ANALYZERS:
            assert (getattr(ecfg, analyzer) is None) == (analyzer not in manifest.enabled_analyzers(config["engine"]))
