"""Stage tracing + run metrics (SURVEY.md §5 observability).

Lightweight host-side tracer: `trace("t2_parse")` context managers around
pipeline stages record wall-clock spans; `collect()` returns (and clears)
a metrics blob; `write_perfetto(path)` emits a chrome://tracing-compatible
JSON trace.  Enabled by GROK_TRACE=1 (or programmatically via enable());
zero overhead when disabled.

The reference exposes wall-clock timing + verbose logging only
[grok: CLI repeat-decode flag, spdlog]; this adds structured spans.  The
port's copy of grok_tpu/util/trace.py: host spans only (a span around
device work ends when the host returns, not when the card finishes).
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager

_enabled = os.environ.get("GROK_TRACE", "") not in ("", "0")
_spans: list[dict] = []
_counters: dict[str, float] = {}
_lock = threading.Lock()


def enable(on: bool = True):
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


@contextmanager
def trace(name: str, **attrs):
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t1 = time.perf_counter()
        with _lock:
            _spans.append({"name": name, "ts": t0, "dur": t1 - t0,
                           **attrs})


def count(name: str, value: float = 1.0):
    if not _enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0.0) + value


def collect(clear: bool = True) -> dict:
    """Metrics blob: per-stage totals + counters."""
    with _lock:
        stages: dict[str, dict] = {}
        for s in _spans:
            st = stages.setdefault(s["name"], {"calls": 0, "total_s": 0.0})
            st["calls"] += 1
            st["total_s"] += s["dur"]
        blob = {"stages": stages, "counters": dict(_counters)}
        if clear:
            _spans.clear()
            _counters.clear()
        return blob


def write_perfetto(path: str, clear: bool = True):
    """chrome://tracing / Perfetto JSON event dump."""
    with _lock:
        events = [{"name": s["name"], "ph": "X", "pid": 1, "tid": 1,
                   "ts": s["ts"] * 1e6, "dur": s["dur"] * 1e6}
                  for s in _spans]
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)
        if clear:
            _spans.clear()
