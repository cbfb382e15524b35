"""A configuration, a traffic mix and a per-layer metric are added by
adding files, and the harness finds them by their names alone."""

import json
import shutil

from portbench import spec
from portbench.run import result_line
from portbench.tests.tinycells import tiny


def test_new_files_make_a_new_cell(tmp_path, monkeypatch):
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(f"{spec.HERE}/{d}", tmp_path / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    cfg, mix = tiny("ht1080-decode-b8")
    cfg["name"] = "htj2k-tiny-gray"
    cfg["geometry"]["components"] = 1
    mix["frames_per_call"], mix["pool_frames"] = 1, 2
    (tmp_path / "configs" / "htj2k-tiny-gray.json").write_text(
        json.dumps(cfg))
    (tmp_path / "traffic" / "decode-one.json").write_text(json.dumps(mix))
    (tmp_path / "metrics" / "decode_calls.py").write_text(
        "def read(r):\n    return float(r.window.calls)\n")
    monkeypatch.setattr(spec, "HERE", str(tmp_path))
    bench = spec.load_benchmark()
    bench["configs"].append({"name": "htj2k-tiny-gray", "source": "x",
                             "file": "portbench/configs/htj2k-tiny-gray.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "tiny-gray", "chips": 1,
                               "config": "htj2k-tiny-gray",
                               "traffic": "decode-one", "why": "x"})
    bench["per_layer"].append({"name": "decode_calls", "unit": "calls",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "device", "moves": "decode_mps",
                               "workloads": ["tiny-gray"]})
    for e in bench["end_to_end"]:
        if "workloads" in e and e["name"] == "decode_mps":
            e["workloads"].append("tiny-gray")
    cell = spec.cell(bench, "tiny-gray")
    from portbench.harness import run_cell
    res = run_cell("tiny-gray", spec.config(cell["config"]),
                   spec.traffic(cell["traffic"]), seed=3, seconds=0.05,
                   traced=True, device="cpu")
    traced = result_line(bench, "tiny-gray", True, res, "cpu")
    assert traced["metrics"]["decode_calls"]["value"] >= 1
    assert traced["correct"]
    plain = result_line(bench, "tiny-gray", False, res, "cpu")
    assert set(plain["metrics"]) == {"setup_s", "decode_mps"}
    assert list(plain)[-1] == "checks"
