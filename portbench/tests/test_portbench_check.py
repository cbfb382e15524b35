"""The comparison that decides `correct`, at CPU sizes: sound runs of
every cell pass, the controls fail, and so does a run of a cell with its
timed path broken underneath (the harness's look for a card skipped)."""

import contextlib

import pytest
import torch

from portbench.tests.tinycells import CELLS, correct, run_tiny, tiny


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_run_is_correct(workload):
    res = run_tiny(workload)
    assert correct(res), res["check"]
    assert res["check"]["frames_checked"] >= 1
    assert res["attempted"] >= res["readings"].window.calls >= 1


@pytest.mark.parametrize("workload,control", [
    ("ht1080-decode-b8", "lsb"), ("ht1080-decode-b8", "irreversible"),
    ("p1-8k-decode", "lsb"), ("p1-8k-decode", "irreversible")])
def test_control_is_not_correct(workload, control):
    res = run_tiny(workload, control=control)
    assert not correct(res)
    assert res["check"]["numbers"]["mismatched_samples"] > 0


@contextlib.contextmanager
def patched(mod, name, make):
    real = getattr(mod, name)
    setattr(mod, name, make(real))
    try:
        yield
    finally:
        setattr(mod, name, real)


def _stale(real):
    """A step that returns its state unchanged: each call answers with
    what the call before it produced (the calls alternate between the
    pool's batches)."""
    last = []

    def run(*a, **k):
        out = real(*a, **k)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    return run


def _half(real):
    """Half of the batch left out: the first half's answers stand in for
    the rest."""
    def run(items, *a, **k):
        half = items[:max(1, len(items) // 2)]
        out = real(half, *a, **k)
        return (list(out) * len(items))[:len(items)]
    return run


def _flip_plane(real):
    """An answer altered where it is produced: one decoded sample."""
    def run(self):
        out = real(self)
        out[0][0][0, 0] += 1
        return out
    return run


def _no_exchange(real):
    """The exchange between cards left out: each shard mirrors its own
    rows where its neighbours' halo belongs."""
    def run(parts, halo):
        out = []
        for p in parts:
            top = p[..., 1:halo + 1, :].flip(-2)
            bot = p[..., -halo - 1:-1, :].flip(-2)
            out.append(torch.cat([top, p, bot], -2))
        return out
    return run


def _decode_faults():
    from grok_tpu_torch import api
    from grok_tpu_torch.pipeline import serve
    return {"stale": (api, "decompress_device_batch", _stale),
            "half": (api, "decompress_device_batch", _half),
            "altered": (serve.StagedBatch, "run", _flip_plane)}


@pytest.mark.parametrize("workload,fault", [
    ("ht1080-decode-b8", "stale"), ("ht1080-decode-b8", "half"),
    ("ht1080-decode-b8", "altered"), ("p1-8k-decode", "stale"),
    ("p1-8k-decode", "altered")])
def test_decode_fault_is_not_correct(workload, fault):
    """(A one-scene call has no half of its batch to leave out.)"""
    mod, name, make = _decode_faults()[fault]
    with patched(mod, name, make):
        res = run_tiny(workload)
    assert not correct(res), (fault, res["check"])


def test_mesh_without_exchange_is_not_correct():
    from grok_tpu_torch.parallel import sharding
    with patched(sharding, "_exchange", _no_exchange):
        res = run_tiny("p1-8k-decode-mesh4")
    assert not correct(res), res["check"]


def test_a_mix_with_no_check_is_refused():
    """An encode mix has no reference here: the harness will not run it."""
    from portbench.harness import run_cell
    cfg, mix = tiny("ht1080-decode-b8")
    mix["direction"] = "encode"
    with pytest.raises(ValueError, match="no mix for direction"):
        run_cell("x", cfg, mix, seed=1, seconds=0.01, traced=False,
                 device="cpu")
