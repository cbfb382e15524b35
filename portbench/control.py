"""The readings that the check's limits are set from, on the card:

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--controls program,lsb,irreversible] [--control-seeds 3] \
        [--seconds 3]

For each control and seed, one run of the cell (a short window at the
cell's own load, in this one process) prints its numbers compared:
  - program: the port as the configuration states it (sound runs: the
    lower reading, the largest number over the seeds);
  - lsb: the reference put in the program's place at the precision
    below the configuration's, one bit less (the source with its
    lowest bit cleared in place of the decode);
  - irreversible: the port's own lossy path, the 9/7 in float32 in
    place of the reversible 5/3.
The upper reading is the smallest number a control gives.  The last
line sums the readings up.  The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="program,lsb,irreversible")
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="how many of the seeds the controls other than "
                         "program run")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    bench = spec.load_benchmark()
    cell = spec.cell(bench, a.workload)
    cfg, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    from portbench.harness import run_cell
    summary: dict = {}
    seeds = [int(s) for s in a.seeds.split(",")]
    for control in a.controls.split(","):
        for seed in seeds if control == "program" \
                else seeds[:a.control_seeds]:
            res = run_cell(a.workload, cfg, mix, seed=seed,
                           seconds=a.seconds, traced=False, device=a.device,
                           control=None if control == "program" else control)
            v = res["check"]
            correct = bool(v["correct"] and res["failed"] == 0)
            print(json.dumps({"control": control, "seed": seed,
                              "correct": correct, "numbers": v["numbers"],
                              "frames_checked": v["frames_checked"],
                              "attempted": res["attempted"],
                              "failed": res["failed"],
                              "calls": res["readings"].window.calls}),
                  flush=True)
            s = summary.setdefault(control, {"seeds": 0, "correct": 0,
                                             "min": {}, "max": {}})
            s["seeds"] += 1
            s["correct"] += correct
            for k, x in v["numbers"].items():
                s["min"][k] = min(s["min"].get(k, x), x)
                s["max"][k] = max(s["max"].get(k, x), x)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
