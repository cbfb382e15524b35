"""The port's tracer (grok_tpu_torch/util/trace.py) and its spans and
counters in the serving decode: nesting, parents, call ids and self
times; the off path; the profiler's `grok:` annotations; the span tree
and counters of an HT batch, a Part-1 batch, a batch the serving
decode declines and a 12-bit Part-1 scene decoded over four CPU shards
(the per-shard K3 spans, the gather, the halos and the mesh counters,
against their values reckoned from the staged shapes), with planes
equal to an untraced decode's."""

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from grok_tpu_torch import api, native  # noqa: E402
from grok_tpu_torch.core.params import CompressParams  # noqa: E402
from grok_tpu_torch.core.params import DecompressParams  # noqa: E402
from grok_tpu_torch.parallel.sharding import HALO, Mesh  # noqa: E402
from grok_tpu_torch.pipeline import plan as plan_mod  # noqa: E402
from grok_tpu_torch.util import trace  # noqa: E402


@pytest.fixture
def tracing(monkeypatch):
    """The tracer on, empty, for one test; off and empty after it."""
    monkeypatch.setattr(trace, "_enabled", True)
    trace.collect()
    yield
    trace.enable(False)
    trace.collect()


def _spans():
    """name -> [(id, parent, call, attrs)] of the recorded spans."""
    out = {}
    for name, _t0, _t1, _s, sid, parent, call, _tid, attrs in trace._spans:
        out.setdefault(name, []).append((sid, parent, call, attrs))
    return out


def test_spans_nest_with_parents_calls_and_self_time(tracing, monkeypatch):
    clock = iter(float(t) for t in range(100))
    monkeypatch.setattr(trace.time, "perf_counter", lambda: next(clock))
    with trace.trace("a", x=1):                 # t 0 .. 7
        with trace.trace("b"):                  # 1 .. 4
            with trace.trace("c"):              # 2 .. 3
                pass
        with trace.trace("b"):                  # 5 .. 6
            pass
    with trace.trace("b"):                      # 8 .. 9: a new call
        trace.count("n", 2)
        trace.count("n", 3)
    got = _spans()
    (a_id, a_par, a_call, a_attrs), = got["a"]
    assert a_par is None and a_call == a_id and a_attrs == {"x": 1}
    (c_id, c_par, c_call, _), = got["c"]
    b_ids = [s[0] for s in got["b"]]
    assert c_par == b_ids[0] and c_call == a_id
    assert [s[1] for s in got["b"]] == [a_id, a_id, None]
    assert [s[2] for s in got["b"]] == [a_id, a_id, b_ids[2]]
    blob = trace.collect()
    assert blob["counters"] == {"n": 5.0}
    assert blob["stages"]["a"] == {"calls": 1, "total_s": 7.0,
                                   "self_s": 3.0}
    assert blob["stages"]["b"] == {"calls": 3, "total_s": 5.0,
                                   "self_s": 4.0}
    assert blob["stages"]["c"] == {"calls": 1, "total_s": 1.0,
                                   "self_s": 1.0}
    assert trace.collect() == {"stages": {}, "counters": {}}


def test_each_thread_keeps_its_own_stack(tracing):
    seen = []

    def work():
        with trace.trace("t"):
            seen.append(trace._local.stack[-1].parent)

    with trace.trace("main"):
        th = threading.Thread(target=work)
        th.start()
        th.join(timeout=30)
    assert not th.is_alive()
    got = _spans()
    assert seen == [None]
    assert got["t"][0][2] == got["t"][0][0] != got["main"][0][2]


def test_the_off_path_records_nothing_and_enters_no_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(trace, "_enabled", False)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    trace.collect()
    assert trace.trace("a") is trace.trace("b", x=1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.trace("a") as sp:
            trace.count("n")
    assert sp is None
    assert trace.collect() == {"stages": {}, "counters": {}}


def test_spans_enter_the_profiler_only_while_it_records(tracing, tmp_path,
                                                         monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def spy(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    with trace.trace("before"):
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.trace("outer"):
            with trace.trace("inner"):
                torch.ones(8).add_(1)
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    assert entered == ["grok:outer", "grok:inner"]
    ev = json.loads(path.read_text())
    ev = ev["traceEvents"] if isinstance(ev, dict) else ev
    ann = {e["name"]: e for e in ev if e.get("cat") == "user_annotation"}
    assert {"grok:outer", "grok:inner"} <= set(ann)
    o, i = ann["grok:outer"], ann["grok:inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]


def _frames(rng, n, c, h, w, bits):
    return [[torch.from_numpy(rng.integers(0, 1 << bits, (h, w))
                              .astype(np.int32)) for _ in range(c)]
            for _ in range(n)]


MESH4 = Mesh(("cpu",) * 4)
SCENE = (40, 32)       # rows and columns of every synthesis level a
#                        multiple of 4: the row shards need no mirror pad


@pytest.fixture(scope="module")
def batches():
    """(name, streams, frames) of an HT RGB batch of 2, a Part-1 batch of
    1, a batch of two HT streams of different sizes (declined by the
    serving decode: different main headers) and a 12-bit Part-1 scene
    (a gradient under noise of sigma 193: 10 or more magnitude planes),
    decoded over MESH4."""
    rng = np.random.default_rng(21)
    small = dict(num_resolutions=3, cblk_w_exp=4, cblk_h_exp=4)
    out = []
    fr = _frames(rng, 2, 3, 36, 52, 8)
    out.append(("ht", api.compress_device_batch(
        fr, CompressParams(ht=True, mct=1, **small), prec=8, sgnd=False,
        device="cpu"), fr))
    fr = _frames(rng, 1, 1, 32, 36, 8)
    out.append(("mq", api.compress_device_batch(
        fr, CompressParams(**small), prec=8, sgnd=False, device="cpu"), fr))
    fr = _frames(rng, 1, 1, 20, 28, 8) + _frames(rng, 1, 1, 24, 20, 8)
    out.append(("general", [api.compress_device_batch(
        [f], CompressParams(ht=True, **small), prec=8, sgnd=False,
        device="cpu")[0] for f in fr], fr))
    h, w = SCENE
    y, x = np.mgrid[0:h, 0:w]
    img = 2048 + 24 * x - 16 * y + rng.normal(0, 193, (h, w))
    fr = [[torch.from_numpy(np.clip(np.rint(img), 0, 4095).astype(np.int32))]]
    out.append(("mesh", api.compress_device_batch(
        fr, CompressParams(**small), prec=12, sgnd=False, device="cpu"), fr))
    return out


def _tree(names: dict) -> dict:
    """name -> sorted names of the parents of its spans."""
    by_id = {s[0]: n for n, ss in names.items() for s in ss}
    return {n: sorted({by_id.get(s[1]) or "-" for s in ss})
            for n, ss in names.items()}


def _mesh_expected(staged) -> dict:
    """The mesh counters of one meshed call, reckoned from the staged
    batch's shapes: K3's lanes in 4 contiguous shares (one group), each
    share's body, lane arguments (7 int32 and a 1x3 int32 segment row)
    and (H, W) int32 outputs moved between the first shard and the
    others; each synthesis level's rows (int32) split and gathered, and
    a HALO-row strip each way across each of the 3 boundaries."""
    (W, H, _),  = staged.program.mq_groups
    nl = staged.meta.shape[0]
    share = [nl // 4 + (i < nl % 4) for i in range(4)]
    peer = sum(staged.body.numel() + n * (7 * 4 + 3 * 4 + H * W * 4)
               for n in share[1:])
    for rows, cols in (SCENE, (SCENE[0] // 2, SCENE[1] // 2)):
        peer += 2 * 3 * (rows // 4 + HALO) * cols * 4
    dlen = staged.meta[:, 7].numpy()
    bounds = np.cumsum([0] + share)
    return {"share": share, "decode.mesh.cards": 4,
            "decode.mesh.lanes_max": max(share),
            "decode.mesh.lanes_min": min(share),
            "decode.mesh.peer_bytes": peer,
            "decode.mesh.k3_bytes_max": max(
                int(dlen[a:b].sum()) for a, b in zip(bounds, bounds[1:]))}


@pytest.mark.parametrize("case", [0, 1, 2, 3],
                         ids=["ht", "mq", "general", "mesh"])
def test_decode_spans_and_counters(batches, case, tracing, monkeypatch):
    name, streams, frames = batches[case]
    monkeypatch.setattr(plan_mod, "_PLANS", {})
    trace.enable(False)
    want = api.decompress_device_batch(streams, device="cpu")
    dp = DecompressParams(mesh=MESH4) if name == "mesh" else None
    if dp is not None:
        # off, a meshed decode records nothing either
        api.decompress_device_batch(streams, dp, device="cpu")
    assert trace.collect() == {"stages": {}, "counters": {}}
    staged = []
    stage = api.stage_serving_batch

    def stage_spy(*a, **k):
        staged.append(stage(*a, **k))
        return staged[-1]

    monkeypatch.setattr(api, "stage_serving_batch", stage_spy)
    trace.enable(True)
    monkeypatch.setattr(plan_mod, "_PLANS", {})
    got = api.decompress_device_batch(streams, dp, device="cpu")
    for fw, fg, src in zip(want, got, frames):
        for w, g, s in zip(fw, fg, src):
            assert torch.equal(w, g) and torch.equal(g, s)
    names = _spans()
    calls = {n: len(v) for n, v in names.items()}
    tree = _tree(names)
    blob = trace.collect()
    ctr = blob["counters"]
    n = len(streams)
    if name == "general":
        assert calls["decode.general"] == n
        assert ctr["decode.general_streams"] == n
        assert tree["decode.stage.t2"] == ["decode.general"]
        assert tree["decode.program"] == ["decode.general"]
        assert ctr["decode.plan_builds"] == n
        return
    assert "decode.general" not in calls
    assert ctr["decode.plan_builds"] == 1
    assert ctr["decode.program_builds"] == 1
    assert ctr["decode.upload_bytes"] > 0
    assert calls["decode.stage"] == calls["decode.stage.headers"] == 1
    assert calls["decode.stage.t2"] == n
    assert calls["decode.stage.pack"] == calls["decode.stage.upload"] == 1
    assert calls["decode.program"] == calls["decode.program.synth"] == 1
    # 3 resolutions: 2 synthesis levels a component
    assert calls["decode.program.dwt.r1"] == calls[
        "decode.program.dwt.r2"] == len(frames[0])
    assert tree["decode.stage"] == tree["decode.program"] == ["-"]
    for child in ("headers", "t2", "pack"):
        assert tree[f"decode.stage.{child}"] == ["decode.stage"]
    assert tree["decode.stage.upload"] == ["decode.stage.pack"]
    assert tree["decode.program.synth"] == ["decode.program"]
    assert tree["decode.program.dwt.r2"] == ["decode.program.synth"]
    if name == "mesh":
        exp = _mesh_expected(staged[0])
        assert int(staged[0].meta[:, 9].max()) >= 10
        cards = [f"decode.program.k3.card{i}" for i in range(4)]
        for card, lanes in zip(cards, exp.pop("share")):
            assert [s[3] for s in names[card]] == [{"lanes": lanes}]
            assert tree[card] == ["decode.program.k3"]
        assert calls["decode.program.k3.scatter"] == 1
        assert tree["decode.program.k3.scatter"] == ["decode.program.k3"]
        assert calls["decode.program.k3.gather"] == 1
        assert tree["decode.program.k3.gather"] == ["decode.program.k3"]
        # 3 resolutions, one component: two row-sharded levels
        for span in ("mesh.shard_rows", "mesh.halo", "mesh.gather_rows"):
            assert calls[span] == 2
            assert tree[span] == ["decode.program.dwt.r1",
                                  "decode.program.dwt.r2"]
        assert {k: ctr[k] for k in exp} == exp
    else:
        assert not any(k.startswith(("decode.program.k3.", "mesh."))
                       for k in calls)
        assert not any(k.startswith("decode.mesh.") for k in ctr)
    if name == "ht":
        assert calls["decode.stage.ht_scan"] == n
        assert tree["decode.stage.ht_scan"] == ["decode.stage"]
        nb = calls["decode.program.k1"]
        assert nb >= 2 and calls["decode.program.k1_stage"] == nb
        assert all(set(s[3]) == {"W", "H"}
                   for s in names["decode.program.k1"])
        assert calls["decode.program.readback"] == 1
        assert "decode.program.k3" not in calls
        assert not any(k.startswith("decode.k3.") for k in ctr)
    else:
        assert calls["decode.program.k3"] == 1
        assert "decode.stage.ht_scan" not in calls
        assert not any(k.startswith("decode.ht_scan.") for k in ctr)
        for k in ("k1", "k1_stage", "readback"):
            assert f"decode.program.{k}" not in calls
        assert 1 <= ctr["decode.k3.lanes"]
        assert ctr["decode.k3.lane_bytes_max"] <= ctr["decode.k3.bytes"] \
            <= min(ctr["decode.upload_bytes"], sum(map(len, streams)))
    for st in blob["stages"].values():
        assert 0 <= st["self_s"] <= st["total_s"] + 1e-9
    # a second call: the plan and the program are cached
    api.decompress_device_batch(streams, device="cpu")
    ctr2 = trace.collect()["counters"]
    assert "decode.plan_builds" not in ctr2
    assert "decode.program_builds" not in ctr2


def test_ht_scan_counters(batches, tracing, monkeypatch):
    """decode.ht_scan.ms_bytes: the MagSgn wire bytes of the scanned
    segments, reckoned here from each segment's length and its Scup
    bytes; word_bytes: the part of them the C scan took 8 at a time."""
    _name, streams, frames = batches[0]
    scanned = []
    scan2 = native.ht_scan2

    def spy(body, offs, lens, *into):
        scanned.append((body, np.array(offs), np.array(lens)))
        return scan2(body, offs, lens, *into)

    monkeypatch.setattr(native, "ht_scan2", spy)
    monkeypatch.setattr(plan_mod, "_PLANS", {})
    trace.enable(False)
    want = api.decompress_device_batch(streams, device="cpu")
    assert len(scanned) == len(streams)
    trace.collect()
    scanned.clear()
    trace.enable(True)
    got = api.decompress_device_batch(streams, device="cpu")
    ctr = trace.collect()["counters"]
    for fw, fg, src in zip(want, got, frames):
        for w, g, s in zip(fw, fg, src):
            assert torch.equal(w, g) and torch.equal(g, s)
    ms_bytes = 0
    for body, offs, lens in scanned:
        for o, n in zip(offs.tolist(), lens.tolist()):
            seg = body[o:o + n]
            scup = (seg[-1] << 4) | (seg[-2] & 0xF)
            assert 2 <= scup <= n
            ms_bytes += n - scup
    assert len(scanned) == len(streams) and ms_bytes > 0
    assert ctr["decode.ht_scan.ms_bytes"] == ms_bytes
    assert 0 < ctr["decode.ht_scan.word_bytes"] <= ms_bytes
    assert ctr["decode.ht_scan.word_bytes"] % 8 == 0


@pytest.mark.parametrize("case", ["ht", "mq", "tile_parts"])
def test_staging_arena_counters(batches, case, tracing, monkeypatch):
    """decode.stage.arena_bytes equals decode.upload_bytes (one host
    write a byte uploaded); decode.stage.arena_grows is absent (0) on a
    second identical call; body_views counts the streams staged from a
    view of their buffer, body_joins those of several tile-parts a
    tile."""
    if case == "tile_parts":
        _name, _s, frames = batches[0]
        streams = api.compress_device_batch(
            frames, CompressParams(ht=True, mct=1, max_tile_parts=2,
                                   num_resolutions=3, cblk_w_exp=4,
                                   cblk_h_exp=4),
            prec=8, sgnd=False, device="cpu")
    else:
        _name, streams, frames = batches[["ht", "mq"].index(case)]
    n = len(streams)
    monkeypatch.setattr(plan_mod, "_PLANS", {})
    for call in range(2):
        got = api.decompress_device_batch(streams, device="cpu")
        for fg, src in zip(got, frames):
            for g, s in zip(fg, src):
                assert torch.equal(g, s)
        ctr = trace.collect()["counters"]
        assert ctr["decode.stage.arena_bytes"] == ctr["decode.upload_bytes"]
        assert "decode.stage.arena_grows" not in ctr
        views = ctr.get("decode.stage.body_views", 0)
        joins = ctr.get("decode.stage.body_joins", 0)
        assert (views, joins) == ((0, n) if case == "tile_parts"
                                  else (n, 0))
