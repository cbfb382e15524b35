"""BENCHMARK.json against the benchmark's contract, and the files it
names found by name."""

import json
import os
import re

import pytest

from portbench import spec

BENCH = spec.load_benchmark()
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == TOP
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16
    assert len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p)
        assert not p.startswith("/") and ".." not in p.split("/")
    for word in BENCH["command"]:
        assert _line_ok(word) and not word.startswith("/")


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
    for group in ("configs", "workloads"):
        got = [e["name"] for e in BENCH[group]]
        assert len(got) == len(set(got))
    metrics = [e["name"] for g in ("end_to_end", "per_layer")
               for e in BENCH[g]]
    assert len(metrics) == len(set(metrics))
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(e["unit"]), e["unit"]
        assert e["better"] in ("lower", "higher")
        assert e["source"] in SOURCES
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line_ok(c["source"]) and _line_ok(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line_ok(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metric_keys_and_bounds():
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                         "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                         "source", "layer", "moves"}
        assert _line_ok(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_found_by_name(c):
    assert c["file"] == f"portbench/configs/{c['name']}.json"
    assert spec.config(c["name"])["name"] == c["name"]
    assert spec.config(c["name"])["reduced"] == c["reduced"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert c["name"] in used


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    cfg = spec.config(w["config"])
    mix = spec.traffic(w["traffic"])
    assert mix["direction"] == "decode"
    assert int(mix.get("mesh", 0)) <= w["chips"]
    assert cfg["geometry"]["components"] >= 1
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric
    e2e = [m["name"] for m in spec.metrics_for(BENCH, w["name"], False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_for(BENCH, w["name"], True)


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_found_by_name(m):
    assert callable(spec.reader(m["name"]))
    for wl in m.get("workloads", []):
        spec.cell(BENCH, wl)


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_in_each_cell(m):
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    target = e2e[m["moves"]]
    cells = m.get("workloads") or [w["name"] for w in BENCH["workloads"]]
    for wl in cells:
        assert "workloads" not in target or wl in target["workloads"], \
            (m["name"], wl)


def test_layers_named_alike():
    by_layer: dict = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_missing_names_are_refused():
    for fn in (spec.config, spec.traffic):
        with pytest.raises(spec.SpecError):
            fn("no-such-name")
    with pytest.raises(spec.SpecError):
        spec.reader("no_such_metric")
    with pytest.raises(spec.SpecError):
        spec.config("../BENCHMARK")
    with pytest.raises(spec.SpecError):
        spec.cell(BENCH, "no-such-cell")


def test_benchmark_json_is_plain_json():
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        assert json.load(f) == BENCH
