"""The port's own spans and counters in a traced run of a cell.

The port records spans and counters inside its decode
(grok_tpu_torch/util/trace.py: `decode.stage.*`, `decode.program.*`,
PERF.md section 3) when its tracer is on, and while a torch.profiler
session records, each span also opens a `grok:<name>` annotation in the
profiler's trace.  This module reads both:

- `ProgramTrace` reads the `grok:` annotations of a chrome trace and
  attributes each device operation (kernel, copy, fill) to the innermost
  program span that enclosed its launch, on the launching thread: the
  launch is the runtime or driver call with the operation's
  `correlation` id.
- `idle_gaps` names the device's idle time by the innermost span of
  either kind, the benchmark's `pb:` wrappers or the port's `grok:`
  spans; on a trace without program spans it gives what
  `DeviceTrace.idle_gaps` gives.
- `run_traced` runs a cell traced (harness.run_cell) with the port's
  tracer on for the window alone, and `readings` turns the result into
  the per-layer numbers of PERF.md section 3 (stage_parse_ms,
  stage_ht_scan_ms, stage_pack_ms, stage_self_ms, program_host_ms,
  program_launches, k1_stage_dev_ms, synth_dev_ms), the counters a call
  and the device ms a traced call of each program span.
- `on_off_cost` times calls of a cell with the tracer on and off, in
  turns, in one process.

run.py does not read these yet (PERF.md section 7 names the edits);
until then they are read by running this file on the card:

    python3 portbench/progtrace.py --workload <cell> --seed <n> --seconds <s> [--pairs <k>]
"""

from __future__ import annotations

import bisect
import copy
import json
import os
import statistics
import sys
import time
import timeit
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench.devtrace import (DEVICE_CATS, DeviceTrace,  # noqa: E402
                                short_name)

PROGRAM_PREFIX = "grok:"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NO_SPAN = "(no program span)"


class ProgramTrace:
    """The `grok:` spans of a chrome trace and the device operations
    that start in [t0, t1) (microseconds on the trace's clock), each
    with the program spans that enclosed its launch, innermost first."""

    def __init__(self, events: list, t0: float, t1: float):
        spans = defaultdict(list)          # (pid, tid) -> [(ts, te, name)]
        launches = {}                      # correlation -> (pid, tid, ts)
        ops = []                           # (dur, correlation, name)
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            cat, name = ev.get("cat", ""), str(ev.get("name", ""))
            ts, dur = float(ev["ts"]), float(ev["dur"])
            corr = (ev.get("args") or {}).get("correlation")
            if cat == "user_annotation" and name.startswith(PROGRAM_PREFIX):
                spans[(ev.get("pid"), ev.get("tid"))].append(
                    (ts, ts + dur, name[len(PROGRAM_PREFIX):]))
            elif cat in LAUNCH_CATS and corr is not None:
                launches[corr] = (ev.get("pid"), ev.get("tid"), ts)
            elif cat in DEVICE_CATS and t0 <= ts < t1:
                ops.append((dur, corr, name))
        for v in spans.values():
            v.sort()
        self.intervals = [s for v in spans.values() for s in v]
        starts = {k: [s[0] for s in v] for k, v in spans.items()}
        self.ops = []                      # (seconds, (innermost, ...),
        #                                    short name)
        self.unlaunched = 0                # operations without a launch
        for dur, corr, name in ops:
            chain = ()
            at = launches.get(corr)
            self.unlaunched += at is None
            if at is not None and (at[0], at[1]) in spans:
                key = (at[0], at[1])
                i = bisect.bisect_right(starts[key], at[2])
                chain = tuple(n for s, e, n in reversed(spans[key][:i])
                              if e > at[2])
            self.ops.append((dur * 1e-6, chain, short_name(name)))

    def device_s_by_span(self) -> dict:
        """{span: seconds} of the operations whose innermost enclosing
        program span has that name (NO_SPAN: none encloses the
        launch)."""
        return {k: v[1] for k, v in self.by_span().items()}

    def by_span(self, top: int = 3) -> dict:
        """{span: [operations, seconds, [[name, seconds], ...]]} by the
        innermost enclosing program span, with each span's `top`
        operations by time."""
        ops = defaultdict(lambda: defaultdict(lambda: [0, 0.0]))
        for s, chain, name in self.ops:
            got = ops[chain[0] if chain else NO_SPAN][name]
            got[0] += 1
            got[1] += s
        out = {}
        for span, names in ops.items():
            ranked = sorted(names.items(), key=lambda kv: -kv[1][1])
            out[span] = [sum(v[0] for v in names.values()),
                         sum(v[1] for v in names.values()),
                         [[k, v[1]] for k, v in ranked[:top]]]
        return out

    def inside(self, name: str) -> tuple[int, float]:
        """(operations, seconds) launched inside a span `name`, at any
        depth."""
        got = [s for s, chain, _ in self.ops if name in chain]
        return len(got), sum(got)

    def attributed_share(self) -> float | None:
        """The share of the operations' seconds launched inside some
        program span."""
        tot = sum(s for s, _, _ in self.ops)
        return None if tot <= 0 else \
            sum(s for s, chain, _ in self.ops if chain) / tot


def idle_gaps(trace: DeviceTrace, prog: ProgramTrace | None,
              top: int = 10) -> list:
    """DeviceTrace.idle_gaps with the program spans beside the
    benchmark's: each gap named by the innermost span of either kind."""
    if prog is None or not prog.intervals:
        return trace.idle_gaps(top)
    both = copy.copy(trace)
    both.spans = trace.spans + prog.intervals
    return both.idle_gaps(top)


class _WithProgram(DeviceTrace):
    """A DeviceTrace that also keeps the program spans of its file."""

    @classmethod
    def from_file(cls, path: str, devices: list | None = None):
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        t = cls(events, devices)
        t.program = ProgramTrace(events, t.t0, t.t1)
        return t


def run_traced(workload: str, cfg: dict, mix: dict, *, seed: int,
               seconds: float, device="cuda",
               t_start: float | None = None) -> dict:
    """harness.run_cell traced, with the port's tracer on from the
    window's first call to its last; the result's "program" holds the
    tracer's blob (collect()), and its readings' trace (on a card) a
    `program` ProgramTrace."""
    from grok_tpu_torch.util import trace as ptrace
    from portbench import harness

    def cleared(real):
        # applied as the window opens (harness.run_cell applies its
        # patches then): drops what the profiler's start-up call recorded
        ptrace.collect()
        return real

    class Mix(harness.MIXES["decode"]):
        window_opens = None

        def layer_spans(self, spans):
            ptrace.enable()
            return super().layer_spans(spans) + [(self, "window_opens",
                                                  cleared)]

    mixes = {**harness.MIXES, "decode": Mix}
    try:
        with harness._patched(harness, "MIXES", lambda _r: mixes), \
                harness._patched(harness, "DeviceTrace",
                                 lambda _r: _WithProgram):
            res = harness.run_cell(workload, cfg, mix, seed=seed,
                                   seconds=seconds, traced=True,
                                   device=device, t_start=t_start)
    finally:
        blob = ptrace.collect()
        ptrace.enable(False)
    res["program"] = blob
    return res


def _ms(total_s: float, calls: int) -> float | None:
    return 1e3 * total_s / calls if calls else None


def readings(res: dict) -> dict:
    """The per-layer numbers of a run_traced result: host ms a call of
    the window from the port's spans, device numbers a traced call from
    the profiler (None without a device trace), the counters a call, and
    the checks of PERF.md section 3."""
    r = res["readings"]
    st, calls = res["program"]["stages"], r.window.calls

    def total(name):
        return st.get(name, {}).get("total_s", 0.0)

    def spans_ms(*names):
        if not any(n in st for n in names):
            return None
        return _ms(sum(total(n) for n in names), calls)

    out = {
        "stage_parse_ms": spans_ms("decode.stage.headers",
                                   "decode.stage.t2"),
        "stage_ht_scan_ms": spans_ms("decode.stage.ht_scan"),
        "stage_pack_ms": spans_ms("decode.stage.pack"),
        "stage_self_ms": _ms(st["decode.stage"]["self_s"], calls)
        if "decode.stage" in st else None,
        "program_host_ms": _ms(total("decode.program")
                               - total("decode.program.readback"), calls)
        if "decode.program" in st else None,
        "program_launches": None, "k1_stage_dev_ms": None,
        "synth_dev_ms": None,
    }
    prog = getattr(r.trace, "program", None)
    ctx = {"window_calls": calls,
           "decode_stage_ms": r.span_ms_per_call("decode_stage"),
           "decode_program_ms": r.span_ms_per_call("decode_program"),
           "program_counters": {k: v / calls for k, v in
                                res["program"]["counters"].items()}
           if calls else {},
           "spans_a_call": {k: v["calls"] / calls for k, v in st.items()}
           if calls else {},
           "self_ms_a_call": {k: _ms(v["self_s"], calls)
                              for k, v in st.items()}}
    staged = [out[k] for k in ("stage_parse_ms", "stage_ht_scan_ms",
                               "stage_pack_ms", "stage_self_ms")]
    if ctx["decode_stage_ms"] and out["stage_self_ms"] is not None:
        ctx["staging_sum_over_decode_stage_ms"] = \
            sum(v for v in staged if v is not None) / ctx["decode_stage_ms"]
    if prog is not None and r.trace.calls:
        n = r.trace.calls
        launches, _ = prog.inside("decode.program")
        out["program_launches"] = launches / n
        for key, span in (("k1_stage_dev_ms", "decode.program.k1_stage"),
                          ("synth_dev_ms", "decode.program.synth")):
            k, s = prog.inside(span)
            out[key] = _ms(s, n) if k else None
        ctx["device_ms_by_span"] = {k: _ms(v, n) for k, v in sorted(
            prog.device_s_by_span().items(), key=lambda kv: -kv[1])}
        ctx["by_span"] = {
            k: [v[0] / n, _ms(v[1], n), [[a, _ms(b, n)] for a, b in v[2]]]
            for k, v in sorted(prog.by_span().items(),
                               key=lambda kv: -kv[1][1])}
        ctx["attributed_share"] = prog.attributed_share()
        ctx["ops_without_launch"] = [prog.unlaunched, len(prog.ops)]
        ctx["busy_s"] = r.trace.mean_busy_s()
        ctx["window_s"] = r.trace.window_s
        ctx["idle_gaps"] = idle_gaps(r.trace, prog, 16)
        ctx["idle_gaps_wrappers"] = r.trace.idle_gaps(16)
        ctx["device_ops"] = r.trace.device_ops(12)
        ctx["traced_calls"] = n
    return {"metrics": out, "context": ctx}


def span_cost_us(n: int = 100000) -> dict:
    """The host cost of one span and one counter, off and on (the
    profiler not recording), in microseconds: the best of 5 timings of
    n."""
    from grok_tpu_torch.util import trace as ptrace

    def span():
        with ptrace.trace("decode.program.k1", W=64, H=64):
            pass

    def counter():
        ptrace.count("decode.upload_bytes", 1)

    out = {}
    was = ptrace._enabled
    try:
        for on in (False, True):
            ptrace.enable(on)
            for name, f in (("span", span), ("count", counter)):
                k = n if not on else n // 10
                best = min(timeit.repeat(f, number=k, repeat=5))
                out[f"{name}_{'on' if on else 'off'}"] = 1e6 * best / k
                ptrace.collect()
    finally:
        ptrace.enable(was)
    return out


def on_off_cost(workload: str, cfg: dict, mix: dict, *, seed: int,
                pairs: int, device="cuda") -> dict:
    """Calls of the cell timed (each ended by a synchronize) with the
    port's tracer on and off in turns (off, on, on, off, ...), in one
    process after warm-up: each side's median and quartiles in ms, the
    median of on less off over the median off call, and over the pairs
    (each on call against the off call beside it) the quartiles of on
    less off over off, in %."""
    from grok_tpu_torch.util import trace as ptrace
    from portbench import harness
    cell = harness.Cell(workload, cfg, mix, seed, device)
    m = harness.MIXES[mix["direction"]](cell)
    nb = len(cell.batches)
    for i in range(max(int(mix.get("warmup_calls", 2)), nb)):
        m.call(i % nb)
    harness._sync(cell.devs)
    times = {False: [], True: []}
    i = 0
    try:
        for p in range(pairs):
            for on in ((False, True) if p % 2 == 0 else (True, False)):
                ptrace.enable(on)
                t = time.perf_counter()
                m.call(i % nb)
                harness._sync(cell.devs)
                times[on].append(time.perf_counter() - t)
                i += 1
                ptrace.collect()
    finally:
        ptrace.enable(False)
    out = {}
    for on, v in times.items():
        q = statistics.quantiles(v, n=4) if len(v) > 1 else [v[0]] * 3
        out["on" if on else "off"] = {"median_ms": 1e3 * q[1],
                                      "q1_ms": 1e3 * q[0],
                                      "q3_ms": 1e3 * q[2], "calls": len(v)}
    off = out["off"]["median_ms"]
    out["on_less_off_pct"] = 100.0 * (out["on"]["median_ms"] - off) / off
    out["off_iqr_pct"] = 100.0 * (out["off"]["q3_ms"]
                                  - out["off"]["q1_ms"]) / off
    d = [100.0 * (a - b) / b for a, b in zip(times[True], times[False])]
    if len(d) > 1:
        out["paired_pct"] = dict(zip(("q1", "median", "q3"),
                                     statistics.quantiles(d, n=4)))
    return out


def main(argv=None) -> int:
    import argparse
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--pairs", type=int, default=0,
                    help="on/off pairs of calls timed after the run")
    a = ap.parse_args(argv)
    from portbench import spec
    bench = spec.load_benchmark()
    cell = spec.cell(bench, a.workload)
    cfg, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    res = run_traced(a.workload, cfg, mix, seed=a.seed, seconds=a.seconds,
                     t_start=t_start)
    line = readings(res)
    line["workload"], line["seed"] = a.workload, a.seed
    line["correct"] = bool(res["check"]["correct"] and res["failed"] == 0)
    line["checks"] = res["check"]["numbers"]
    line["context"]["cards"] = res["context"].get("cards")
    line["span_cost_us"] = span_cost_us()
    if a.pairs:
        line["on_off"] = on_off_cost(a.workload, cfg, mix, seed=a.seed,
                                     pairs=a.pairs)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
