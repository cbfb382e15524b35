"""Stage tracing + run metrics (SURVEY.md §5 observability).

Host-side tracer: `with trace("decode.stage.t2"):` around a stage of the
port records a span (its name, start and end on time.perf_counter, its
parent span and a call id), and `count(name, value)` adds to a counter;
`collect()` returns (and clears) a metrics blob of per-stage calls, total
and self seconds and the counters; `write_perfetto(path)` emits a
chrome://tracing-compatible JSON trace with each span's parent and call.

Spans nest per thread: a span opened with no open span on its thread
starts a new call, and the spans opened inside it share its call id.  A
span around device work ends when the host returns, not when the card
finishes; while a torch.profiler session records, each span also enters
`torch.profiler.record_function("grok:" + name)`, so the profiler's
trace holds the device operations each span launched, on the
profiler's clock.

Off unless GROK_TRACE=1 is set or enable() is called.  Off, trace()
returns one shared no-op context object and count() returns at once:
a span then costs one function call and an empty `with`, under a
microsecond on an H100 host's CPU; on, a few microseconds (PERF.md §3).

The reference exposes wall-clock timing + verbose logging only
[grok: CLI repeat-decode flag, spdlog]; this adds structured spans.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time

import torch

PROFILER_PREFIX = "grok:"

_enabled = os.environ.get("GROK_TRACE", "") not in ("", "0")
_spans: list[tuple] = []     # (name, t0, t1, self_s, id, parent, call,
#                              thread, attrs)
_counters: dict[str, float] = {}
_lock = threading.Lock()
_local = threading.local()   # .stack: the thread's open spans
_ids = itertools.count(1)


def enable(on: bool = True):
    global _enabled
    _enabled = on


def enabled() -> bool:
    """Whether spans and counters are recorded (for a counter whose
    value costs more to reckon than a call of count())."""
    return _enabled


class _Off:
    """The context trace() returns while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "t0", "id", "parent", "call", "child_s",
                 "stack", "rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.parent, self.call = None, self.id
        self.child_s = 0.0
        self.stack = stack
        stack.append(self)
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(PROFILER_PREFIX
                                                     + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.stack.pop()
        dur = t1 - self.t0
        if self.stack:
            self.stack[-1].child_s += dur
        with _lock:
            _spans.append((self.name, self.t0, t1, dur - self.child_s,
                           self.id, self.parent, self.call,
                           threading.get_ident(), self.attrs))
        return False


def trace(name: str, **attrs):
    """A span named `name` (attrs: values written with it) while tracing
    is on; the shared no-op context otherwise."""
    if not _enabled:
        return _OFF
    return _Span(name, attrs)


def count(name: str, value: float = 1.0):
    if not _enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0.0) + value


def collect(clear: bool = True) -> dict:
    """Metrics blob: per-stage calls, total and self seconds (a span's
    duration less its child spans'), and the counters."""
    with _lock:
        stages: dict[str, dict] = {}
        for name, t0, t1, self_s, *_ in _spans:
            st = stages.setdefault(name, {"calls": 0, "total_s": 0.0,
                                          "self_s": 0.0})
            st["calls"] += 1
            st["total_s"] += t1 - t0
            st["self_s"] += self_s
        blob = {"stages": stages, "counters": dict(_counters)}
        if clear:
            _spans.clear()
            _counters.clear()
        return blob


def write_perfetto(path: str, clear: bool = True):
    """chrome://tracing / Perfetto JSON event dump: one complete event a
    span, with its id, parent (None for a call's first span), call id
    and attributes as args."""
    with _lock:
        events = [{"name": name, "ph": "X", "pid": 1, "tid": tid,
                   "ts": t0 * 1e6, "dur": (t1 - t0) * 1e6,
                   "args": {"id": sid, "parent": parent, "call": call,
                            **attrs}}
                  for name, t0, t1, _s, sid, parent, call, tid, attrs
                  in _spans]
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)
        if clear:
            _spans.clear()
