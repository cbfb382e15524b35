"""Cells of the benchmark cut to sizes that a CPU test run holds: the
same configurations and mixes, on frames of a few dozen pixels a side,
with fewer resolutions and 16x16 code-blocks, run by the harness on the
CPU (the port's plain versions)."""

from __future__ import annotations

import copy

from portbench import spec
from portbench.harness import run_cell

CELLS = {
    "ht1080-decode-b8": dict(h=40, w=56, fpc=2, pool=4),
    "p1-8k-decode": dict(h=40, w=48, fpc=1, pool=2),
}
# A cell kept for later (the mesh's mix, its configuration, the size):
# the harness's mesh path at a CPU test's size, over CPU shards.
LATER = {
    "p1-8k-decode-mesh4": ("part1-12bit-pan-lossless", "decode-b1-mesh4",
                           dict(h=80, w=48, fpc=1, pool=2)),
}


def tiny(workload: str) -> tuple:
    """(config, mix) of a benchmark cell at a CPU test's size."""
    if workload in LATER:
        cfg_name, mix_name, s = LATER[workload]
    else:
        cell = spec.cell(spec.load_benchmark(), workload)
        cfg_name, mix_name = cell["config"], cell["traffic"]
        s = CELLS[workload]
    cfg = copy.deepcopy(spec.config(cfg_name))
    mix = copy.deepcopy(spec.traffic(mix_name))
    cfg["geometry"].update(width=s["w"], height=s["h"])
    cfg["compress"].update(num_resolutions=3, cblk_w_exp=4, cblk_h_exp=4)
    mix.update(frames_per_call=s["fpc"], pool_frames=s["pool"],
               warmup_calls=1, check_calls=2)
    return cfg, mix


def run_tiny(workload: str, seed: int = 2**31 + 5, seconds: float = 0.05,
             control: str | None = None) -> dict:
    """One run of the cut cell on the CPU; a window of `seconds` holds
    at least one call."""
    cfg, mix = tiny(workload)
    return run_cell(workload, cfg, mix, seed=seed, seconds=seconds,
                    traced=False, device="cpu", control=control)


def correct(res: dict) -> bool:
    return bool(res["check"]["correct"] and res["failed"] == 0)
