"""The comparison that decides `correct`.

The configurations are lossless, so the reference of a decoded frame is
its source, made by the benchmark from the seed (synth.py), and the
comparison is exact: every sample of every plane of every frame of the
sampled calls of the window, limit 0.

The number compared, beside its limit: mismatched_samples, the samples
of the checked frames that differ from their source (a frame of the
wrong shape counts all of its samples).  A run with no frame checked is
not correct.  An encode mix has no check here: its streams need a
reference decoder that shares no table with the port.
"""

from __future__ import annotations

import torch

LIMITS = {"mismatched_samples": 0}


def _frame_mismatch(planes: list, src: torch.Tensor) -> int:
    """Samples of one decoded frame (a list of component planes) that
    differ from its source (C, H, W)."""
    if len(planes) != src.shape[0]:
        return int(src.numel())
    bad = 0
    for p, s in zip(planes, src):
        if tuple(p.shape) != tuple(s.shape):
            bad += int(s.numel())
        else:
            bad += int((p.to(s.device).to(torch.int32)
                        != s.to(torch.int32)).sum())
    return bad


def judge_decode(cell, items: list, slots: list) -> dict:
    mism = frames = wrong = 0
    for (i, b), slot in zip(items, slots):
        for k, f in enumerate(cell.batches[b]):
            planes = slot[k] if k < len(slot) else []
            bad = _frame_mismatch(planes, cell.src[f])
            frames += 1
            mism += bad
            wrong += bad > 0
    return {"numbers": {"mismatched_samples": mism},
            "frames_checked": frames, "frames_wrong": wrong}


def judge(cell, items: list, slots: list) -> dict:
    """The verdict on the window's sampled outputs: the numbers compared,
    their limits, the frames checked and found wrong, and `correct`."""
    v = judge_decode(cell, items, slots)
    v["limits"] = {k: LIMITS[k] for k in v["numbers"]}
    v["correct"] = v["frames_checked"] > 0 and all(
        v["numbers"][k] <= LIMITS[k] for k in v["numbers"])
    return v
