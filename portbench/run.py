"""Run one cell of the port's benchmark once, on the card(s) of this
machine:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the port's libraries, the pool made from the seed and
encoded, and the warm-up) is timed from the start of this file to the
first timed call.  The window then runs for --seconds,
and the sampled outputs are checked.  Earlier lines of standard output
carry the run's context (the cards' names, power limits and clocks, the
pool's bytes and SHA-256, the calls and routes, in a traced run each
card's idle share); the last line is one JSON object with `correct`,
`attempted`, `failed`, `metrics`, `device`, with --trace 1 `breakdown`,
and last `checks`: each number compared beside its limit, also the last
lines of standard error.  With --trace 0 the metrics are the cell's
end-to-end metrics, with --trace 1 its per-layer metrics.

Exits non-zero, printing no result, without a CUDA card or with fewer
cards than the cell asks for, where the port cannot be imported, and
where JAX or the JAX package was loaded in this process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import spec  # noqa: E402


def _fail(msg: str, code: int) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return code


def result_line(bench: dict, workload: str, traced: bool, res: dict,
                platform: str) -> dict:
    """The last line: the cell's metrics read by their readers, the
    device, the breakdown of a traced run, and the checks."""
    r = res["readings"]
    metrics = {}
    for m in spec.metrics_for(bench, workload, traced):
        v = spec.reader(m["name"])(r)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": platform, "kind": r.kind, "count": res["devices"],
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": bool(res["check"]["correct"]
                            and res["failed"] == 0),
            "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device}
    if traced and r.trace is not None:
        device["busy_s"] = r.trace.mean_busy_s()
        device["window_s"] = r.trace.window_s
        line["breakdown"] = {"device_ops": r.trace.device_ops(10),
                             "idle_gaps": r.trace.idle_gaps(10)}
    v = res["check"]
    line["checks"] = {k: {"value": v["numbers"][k], "limit": v["limits"][k]}
                      for k in v["numbers"]}
    line["checks"]["frames_checked"] = {"value": v["frames_checked"],
                                        "limit": ">= 1"}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    try:
        bench = spec.load_benchmark()
        cell = spec.cell(bench, a.workload)
        cfg = spec.config(cell["config"])
        mix = spec.traffic(cell["traffic"])
    except (spec.SpecError, OSError, ValueError, KeyError) as e:
        return _fail(f"cell {a.workload!r}: {e}", 2)
    import torch
    chips = int(cell["chips"])
    if not torch.cuda.is_available():
        return _fail("no CUDA card: the benchmark runs on the card only", 3)
    if torch.cuda.device_count() < chips:
        return _fail(f"{a.workload} asks for {chips} cards, "
                     f"{torch.cuda.device_count()} visible", 3)
    try:
        from portbench.harness import loaded_jax_modules, run_cell
        import grok_tpu_torch  # noqa: F401
    except ImportError as e:
        return _fail(f"the port cannot be imported: {e}", 4)
    res = run_cell(a.workload, cfg, mix, seed=a.seed, seconds=a.seconds,
                   traced=bool(a.trace), device="cuda", t_start=T_START)
    jax = loaded_jax_modules()
    if jax:
        return _fail(f"the process holds {', '.join(jax)} after the "
                     f"window: the port must not load JAX", 5)
    line = result_line(bench, a.workload, bool(a.trace), res, "gpu")
    print(json.dumps({"context": res["context"]}), flush=True)
    for k, v in line["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
