"""What the benchmark imports, and how it refuses to run."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

from portbench import spec

BANNED = {"jax", "jaxlib", "flax", "grok_tpu"}


def _modules():
    for dirpath, _, files in os.walk(spec.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, spec.ROOT))
def test_no_module_imports_jax_or_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            # whole top-level names: grok_tpu_torch is not grok_tpu
            assert n.split(".")[0] not in BANNED, (path, n)


def _run(args, cwd):
    return subprocess.run([sys.executable, "portbench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env={**os.environ,
                                            "CUDA_VISIBLE_DEVICES": ""})


def test_run_exits_nonzero_without_a_card():
    got = _run(["--workload", "ht1080-decode-b8", "--seed", "2147483649",
                "--seconds", "1", "--trace", "0"], spec.ROOT)
    assert got.returncode != 0
    assert '"correct"' not in got.stdout
    assert "card" in got.stderr


def test_run_refuses_an_unknown_cell():
    got = _run(["--workload", "no-such-cell", "--seed", "1", "--seconds",
                "1"], spec.ROOT)
    assert got.returncode != 0 and '"correct"' not in got.stdout


def test_run_exits_nonzero_beside_nothing_but_the_benchmark(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = _run(["--workload", "ht1080-decode-b8", "--seed", "1",
                "--seconds", "1"], str(tmp_path))
    assert got.returncode != 0 and '"correct"' not in got.stdout
