"""The reading of the port's own spans (progtrace.py): device operations
attributed by correlation id to the innermost program span on the
launching thread, idle gaps named by program spans, nothing changed on a
trace without them, and the tracer on in a traced run's window only."""

import json

import pytest

from portbench import progtrace
from portbench.devtrace import DeviceTrace
from portbench.tests.test_portbench_arith import _timeline
from portbench.tests.tinycells import run_tiny, tiny


def _launch(corr, ts, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1, "pid": 9, "tid": tid,
            "args": {"correlation": corr}}


def _op(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7, "args": {"device": 0, "correlation": corr}}


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 9, "tid": tid}


def _program_timeline():
    """One call (0-100 us): the program 10-90 with its synthesis 50-80
    on thread 1; a span of thread 2 over 55-60.  Kernels: launched at 20
    in the program (runs 30-40), at 60 in the synthesis (65-75), at 5
    outside any program span (95-98), at 58 on thread 2 (a copy 41-44),
    and one whose launch is not in the trace (45-47)."""
    return [
        _span("pb:call", 0, 100),
        _span("grok:decode.program", 10, 80),
        _span("grok:decode.program.synth", 50, 30),
        _span("grok:decode.other", 55, 5, tid=2),
        _launch(1, 20), _op("void k1(int*)", 30, 10, 1),
        _launch(2, 60), _op("void synth(int*)", 65, 10, 2),
        _launch(3, 5), _op("void late(int*)", 95, 3, 3),
        _launch(4, 58, tid=2),
        _op("Memcpy DtoD", 41, 3, 4, cat="gpu_memcpy"),
        _op("void lost(int*)", 45, 2, 99),
        _op("void before(int*)", -10, 5, 1),     # outside the window
    ]


def test_operations_go_to_the_innermost_span_of_their_launch():
    ev = _program_timeline()
    t = DeviceTrace(ev, [0])
    p = progtrace.ProgramTrace(ev, t.t0, t.t1)
    got = p.device_s_by_span()
    assert got["decode.program"] == pytest.approx(10e-6)
    assert got["decode.program.synth"] == pytest.approx(10e-6)
    assert got["decode.other"] == pytest.approx(3e-6)
    assert got[progtrace.NO_SPAN] == pytest.approx(5e-6)   # late, lost
    assert sum(got.values()) == pytest.approx(28e-6)
    by = p.by_span()
    assert by[progtrace.NO_SPAN][0] == 2
    assert by["decode.program"][2] == [["k1", pytest.approx(10e-6)]]
    assert by["decode.other"][2] == [["Memcpy DtoD", pytest.approx(3e-6)]]
    assert p.inside("decode.program") == (2, pytest.approx(20e-6))
    assert p.inside("decode.program.synth") == (1, pytest.approx(10e-6))
    assert p.inside("decode.stage") == (0, 0)
    assert p.attributed_share() == pytest.approx(23 / 28)


def test_a_gap_inside_a_program_span_is_named_by_it():
    ev = _program_timeline()
    t = DeviceTrace(ev, [0])
    p = progtrace.ProgramTrace(ev, t.t0, t.t1)
    gaps = dict(progtrace.idle_gaps(t, p))
    # idle 0-30, 40-41, 44-45, 47-65, 75-95, 98-100; thread 2's span
    # 55-60 is the innermost there
    assert gaps["call"] == pytest.approx(17e-6)      # 0-10, 90-95, 98-100
    assert gaps["decode.program"] == pytest.approx(35e-6)   # 10-30, 40-41,
    #                                                 44-45, 47-50, 80-90
    assert gaps["decode.program.synth"] == pytest.approx(15e-6)
    assert gaps["decode.other"] == pytest.approx(5e-6)
    assert sum(gaps.values()) == pytest.approx(72e-6)
    # without the program spans, the benchmark's own naming
    assert dict(t.idle_gaps()) == {"call": pytest.approx(72e-6)}


def test_a_trace_without_program_spans_reads_as_before(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _timeline()}))
    plain = DeviceTrace.from_file(str(path), [0, 1])
    both = progtrace._WithProgram.from_file(str(path), [0, 1])
    assert both.program.intervals == []
    assert progtrace.idle_gaps(both, both.program) == plain.idle_gaps()
    for d in (0, 1):
        assert both.idle_pct(d) == plain.idle_pct(d)
        assert both.busy_s(d) == plain.busy_s(d)
    assert both.kernel_s("t1_decode_kernel") == \
        plain.kernel_s("t1_decode_kernel")
    assert both.device_ops() == plain.device_ops()
    assert both.calls == plain.calls and both.window_s == plain.window_s
    # operations without correlation ids go to no span
    assert both.program.attributed_share() == 0.0


def test_an_untraced_run_leaves_the_port_tracer_off_and_empty():
    from grok_tpu_torch.util import trace
    trace.collect()
    res = run_tiny("ht1080-decode-b8")
    assert res["check"]["correct"]
    assert not trace._enabled
    assert trace.collect() == {"stages": {}, "counters": {}}


@pytest.mark.parametrize("workload", ["ht1080-decode-b8", "p1-8k-decode"])
def test_a_traced_run_reads_every_program_span_metric(workload):
    from grok_tpu_torch.util import trace
    cfg, mix = tiny(workload)
    res = progtrace.run_traced(workload, cfg, mix, seed=2**31 + 9,
                               seconds=0.05, device="cpu")
    assert res["check"]["correct"] and res["failed"] == 0
    assert not trace._enabled
    assert trace.collect() == {"stages": {}, "counters": {}}
    got = progtrace.readings(res)
    m, ctx = got["metrics"], got["context"]
    spans = ["stage_parse_ms", "stage_pack_ms", "stage_self_ms",
             "program_host_ms"]
    if workload == "ht1080-decode-b8":
        spans.append("stage_ht_scan_ms")
    else:
        assert m["stage_ht_scan_ms"] is None
    for k in spans:
        assert m[k] is not None and m[k] > 0, k
    # the device readings come from a card's trace only
    for k in ("program_launches", "k1_stage_dev_ms", "synth_dev_ms"):
        assert m[k] is None
    staged = sum(m[k] or 0.0 for k in ("stage_parse_ms", "stage_ht_scan_ms",
                                       "stage_pack_ms", "stage_self_ms"))
    assert staged <= ctx["decode_stage_ms"]
    assert ctx["spans_a_call"]["decode.stage"] == 1.0
    assert ctx["spans_a_call"]["decode.program"] == 1.0
    # the window alone: warm-up's plan and program builds are not in it
    assert "decode.plan_builds" not in ctx["program_counters"]
    assert ctx["program_counters"]["decode.upload_bytes"] > 0


def test_on_off_cost_times_calls_in_turns_and_leaves_the_tracer_off():
    from grok_tpu_torch.util import trace
    cfg, mix = tiny("ht1080-decode-b8")
    got = progtrace.on_off_cost("ht1080-decode-b8", cfg, mix,
                                seed=2**31 + 3, pairs=3, device="cpu")
    assert got["on"]["calls"] == got["off"]["calls"] == 3
    assert set(got["paired_pct"]) == {"q1", "median", "q3"}
    assert got["off"]["q1_ms"] <= got["off"]["median_ms"] \
        <= got["off"]["q3_ms"]
    assert not trace._enabled
    assert trace.collect() == {"stages": {}, "counters": {}}
