"""The four-card cell's per-layer readers on hand-built device traces:
k3_card_skew_pct (each card's K3 time against the mean of the cards)
and mesh_peer_ms (the copies between cards, a traced call), and the cut
cell run on CPU shards with the port's tracer on."""

import copy
from types import SimpleNamespace

import pytest

from portbench import spec
from portbench.devtrace import DeviceTrace
from portbench.harness import run_cell
from portbench.tests.tinycells import correct, tiny

CELL = "p1-8k-decode-mesh4"
K3 = "t1_decode_kernel(unsigned char const*, int, int const*)"
PEER = "Memcpy PtoP (Device -> Device)"


def _ev(name, ts, dur, dev, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": dev, "tid": 7, "args": {"device": dev}}


def _calls(n, length=1000):
    """n benchmark call spans of `length` us, back to back from 0."""
    return [{"ph": "X", "cat": "user_annotation", "name": "pb:call",
             "ts": i * length, "dur": length, "pid": 9, "tid": 1}
            for i in range(n)]


def _readings(events, devices):
    return SimpleNamespace(trace=DeviceTrace(events, devices),
                           direction="decode")


def _k3(us_by_card: list, calls: int = 2):
    """Each card's K3 time split over the calls, plus work that the
    reader must leave out: another kernel, a K3 launch before the
    window, and the first design's kernel."""
    ev = _calls(calls)
    for dev, us in enumerate(us_by_card):
        for i in range(calls):
            ev.append(_ev(K3, i * 1000 + 10, us / calls, dev))
        ev.append(_ev("void at::native::elementwise_kernel<128, 2>(int)",
                      20, 50 * (dev + 1), dev))
        ev.append(_ev(K3, -500, 400, dev))
        ev.append(_ev("t1_decode_kernel_v1(int*)", 30, 90, dev))
    return _readings(ev, list(range(len(us_by_card))))


@pytest.fixture(scope="module")
def readers():
    return {n: spec.reader(n) for n in ("k3_card_skew_pct", "mesh_peer_ms")}


def test_even_cards_read_zero(readers):
    assert readers["k3_card_skew_pct"](_k3([400, 400, 400, 400])) == \
        pytest.approx(0.0)


def test_a_card_a_quarter_above_the_mean_reads_25(readers):
    got = readers["k3_card_skew_pct"]
    assert got(_k3([300, 400, 400, 500])) == pytest.approx(25.0)
    # one card 25% slower than three even ones: its lead over the mean
    assert got(_k3([400, 400, 400, 500])) == pytest.approx(
        100.0 * (500 / 425 - 1))


def test_one_card_or_no_trace_reads_none(readers):
    assert readers["k3_card_skew_pct"](_k3([400])) is None
    # four cards in the trace, K3 on one of them
    r = _k3([400, 0, 0, 0])
    assert readers["k3_card_skew_pct"](r) is None
    none = SimpleNamespace(trace=None, direction="decode")
    assert all(f(none) is None for f in readers.values())
    assert readers["mesh_peer_ms"](_readings(
        _calls(2) + [_ev(PEER, 10, 80, 0, "gpu_memcpy")], [0])) is None


def test_only_copies_between_cards_count(readers):
    """Two calls: peer copies of 300 + 100 + 200 us on three cards, and
    copies on one card, from and to the host, a fill, a kernel and a
    peer copy before the window, all left out."""
    ev = _calls(2) + [
        _ev(PEER, 10, 300, 1, "gpu_memcpy"),
        _ev(PEER, 1200, 100, 2, "gpu_memcpy"),
        _ev(PEER, 1500, 200, 0, "gpu_memcpy"),
        _ev("Memcpy DtoD (Device -> Device)", 40, 900, 0, "gpu_memcpy"),
        _ev("Memcpy HtoD (Pinned -> Device)", 50, 700, 0, "gpu_memcpy"),
        _ev("Memcpy DtoH (Device -> Pageable)", 60, 500, 3, "gpu_memcpy"),
        _ev("Memset (Device)", 70, 400, 1, "gpu_memset"),
        _ev(K3, 80, 600, 2),
        _ev(PEER, -300, 200, 1, "gpu_memcpy"),
    ]
    got = readers["mesh_peer_ms"](_readings(ev, [0, 1, 2, 3]))
    assert got == pytest.approx((300 + 100 + 200) * 1e-3 / 2)
    # four cards and no copy between them: 0
    assert readers["mesh_peer_ms"](_readings(
        _calls(1) + [_ev(K3, 10, 50, d) for d in range(4)],
        [0, 1, 2, 3])) == 0.0


def _cut_cell():
    """tiny()'s cut of the cell, applied to the configuration that
    BENCHMARK.json gives the cell."""
    cut, mix = tiny(CELL)
    cfg = copy.deepcopy(spec.config(
        spec.cell(spec.load_benchmark(), CELL)["config"]))
    g, c = cut["geometry"], cut["compress"]
    cfg["geometry"].update(width=g["width"], height=g["height"])
    cfg["compress"].update(num_resolutions=c["num_resolutions"],
                           cblk_w_exp=c["cblk_w_exp"],
                           cblk_h_exp=c["cblk_h_exp"])
    return cfg, mix


def test_the_mesh_configuration_decodes_the_one_card_scene():
    """The four-card deployment's own configuration holds the scene of
    the one-card cell, so the two cells measure one scene on both
    layouts; its mix asks for the four cards."""
    bench = spec.load_benchmark()
    mesh = spec.config(spec.cell(bench, CELL)["config"])
    one = spec.config(spec.cell(bench, "p1-8k-decode")["config"])
    assert mesh["name"] != one["name"]
    for k in ("geometry", "precision", "compress", "reduced"):
        assert mesh[k] == one[k], k
    assert mesh["mesh"]["cards"] == spec.cell(bench, CELL)["chips"] \
        == spec.traffic(spec.cell(bench, CELL)["traffic"])["mesh"] == 4


def test_the_cut_mesh_cell_with_the_port_tracer_on():
    """The cell at a CPU test's size over four CPU shards, traced, with
    the port's tracer on: correct, every shard's K3 span recorded, and
    the new readers None (a CPU run has no device trace)."""
    from grok_tpu_torch.util import trace as ptrace
    cfg, mix = _cut_cell()
    assert cfg["name"] == "part1-12bit-pan-lossless-mesh4"
    ptrace.collect()
    ptrace.enable()
    try:
        res = run_cell(CELL, cfg, mix, seed=2**31 + 9,
                       seconds=0.05, traced=True, device="cpu")
        blob = ptrace.collect()
    finally:
        ptrace.enable(False)
        ptrace.collect()
    assert correct(res), res["check"]
    assert res["context"]["routes"]["general_route_streams"] == 0
    st = blob["stages"]
    calls = st["decode.program"]["calls"]       # warm-up and window
    assert calls >= res["context"]["routes"]["served_calls"] >= 1
    for i in range(4):
        assert st[f"decode.program.k3.card{i}"]["calls"] == calls
    assert st["decode.program.k3.gather"]["calls"] == calls
    assert st["mesh.halo"]["calls"] == 2 * calls
    assert blob["counters"]["decode.mesh.cards"] == 4 * calls
    r = res["readings"]
    assert r.trace is None
    bench = spec.load_benchmark()
    for m in ("k3_card_skew_pct", "mesh_peer_ms"):
        assert CELL in next(
            e for e in bench["per_layer"] if e["name"] == m)["workloads"]
        assert spec.reader(m)(r) is None
