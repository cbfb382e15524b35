"""BENCHMARK.json and the files it names.

A cell names a configuration and a traffic mix; each is a JSON file
found by that name (`configs/<config>.json`, `traffic/<traffic>.json`),
and each metric is read by `metrics/<metric>.py`, a module with a
`read(readings)` function that returns a number, or None where it finds
nothing to read.  Adding any of them is adding a file.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME_RX = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


class SpecError(ValueError):
    """A cell, configuration, mix or metric that is missing or
    malformed."""


def load_benchmark(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise SpecError(f"no BENCHMARK.json at {root}")
    with open(path) as f:
        return json.load(f)


def _json(kind: str, name: str) -> dict:
    if not NAME_RX.match(name):
        raise SpecError(f"{kind} name {name!r} is not a valid name")
    path = os.path.join(HERE, kind, f"{name}.json")
    if not os.path.exists(path):
        raise SpecError(f"no {kind} file for {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SpecError(f"no workload {workload!r} in BENCHMARK.json")


def metrics_for(bench: dict, workload: str, traced: bool) -> list:
    """The metric entries a run of `workload` reports: the end-to-end
    ones untraced, the per-layer ones traced, each where its
    `workloads` key (if any) lists the cell."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def reader(name: str):
    """The `read` function of metrics/<name>.py."""
    if not NAME_RX.match(name):
        raise SpecError(f"metric name {name!r} is not a valid name")
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.exists(path):
        raise SpecError(f"no reader for metric {name!r} ({path})")
    mod_name = "portbench_metric_" + re.sub(r"[^A-Za-z0-9_]", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "read", None)):
        raise SpecError(f"metrics/{name}.py has no read(readings)")
    return mod.read
