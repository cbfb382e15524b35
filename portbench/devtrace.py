"""Reading the device trace of a traced run.

`torch.profiler` (CUPTI) records every operation on the card, the
port's own kernels included, however they were launched, and the
benchmark's host spans (`record_function("pb:<name>")`) on the same
clock.  The chrome trace it exports is read here: the device operations
(kernels, copies, fills) of each card, merged into busy intervals over
the traced window (the first traced call's start to the last one's
end), the idle gaps between them, named by the innermost benchmark span the
host was in, and each kernel's time.
"""

from __future__ import annotations

import json
import re
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "pb:"
CALL_SPAN = SPAN_PREFIX + "call"


def short_name(name: str, limit: int = 64) -> str:
    """A device operation's name without its return type and
    parameters: "void k<false>(int*, ...)" -> "k<false>"."""
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:limit]


def _merge(intervals: list) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class DeviceTrace:
    """The traced window's device operations and host spans (times in
    microseconds on the trace's clock)."""

    def __init__(self, events: list, devices: list | None = None):
        self.ops = defaultdict(list)          # device -> [(ts, dur, name)]
        spans = []
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            cat = ev.get("cat", "")
            ts, dur = float(ev["ts"]), float(ev["dur"])
            if cat in DEVICE_CATS:
                dev = (ev.get("args") or {}).get("device", ev.get("pid"))
                self.ops[int(dev)].append((ts, dur, ev.get("name", "")))
            elif cat == "user_annotation" and \
                    str(ev.get("name", "")).startswith(SPAN_PREFIX):
                spans.append((ts, ts + dur, ev["name"][len(SPAN_PREFIX):]))
        self.spans = spans
        calls = [s for s in spans if s[2] == "call"]
        self.calls = len(calls)
        if calls:
            self.t0 = min(s[0] for s in calls)
            self.t1 = max(s[1] for s in calls)
        else:
            self.t0 = self.t1 = 0.0
        self.devices = sorted(set(devices or []) | set(self.ops))

    @classmethod
    def from_file(cls, path: str, devices: list | None = None):
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return cls(events, devices)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _busy(self, dev: int) -> list:
        clipped = [(max(ts, self.t0), min(ts + dur, self.t1))
                   for ts, dur, _ in self.ops.get(dev, [])]
        return _merge([iv for iv in clipped if iv[1] > iv[0]])

    def busy_s(self, dev: int) -> float:
        """Seconds of the window in which an operation ran on `dev`."""
        return sum(e - s for s, e in self._busy(dev)) * 1e-6

    def mean_busy_s(self) -> float:
        if not self.devices:
            return 0.0
        return sum(self.busy_s(d) for d in self.devices) / len(self.devices)

    def idle_pct(self, dev: int) -> float | None:
        if self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s(dev) / self.window_s)

    def kernel_s(self, pattern: str) -> float:
        """Seconds of every kernel whose name holds `pattern` as a whole
        word, summed over the devices (kernels that start in the
        window)."""
        rx = re.compile(r"(?<![A-Za-z0-9_])" + re.escape(pattern)
                        + r"(?![A-Za-z0-9_])")
        return sum(dur for ops in self.ops.values() for ts, dur, name in ops
                   if self.t0 <= ts < self.t1 and rx.search(name)) * 1e-6

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds]] of the device operations that took the most
        time in the window, summed over the devices."""
        tot = defaultdict(float)
        for ops in self.ops.values():
            for ts, dur, name in ops:
                if self.t0 <= ts < self.t1:
                    tot[short_name(name)] += dur * 1e-6
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def _span_at(self, t: float) -> str:
        best = None
        for s, e, name in self.spans:
            if s <= t < e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        return best[2] if best else "between_calls"

    def idle_gaps(self, top: int = 10) -> list:
        """[[span, seconds]]: the idle time of the window summed by the
        innermost benchmark span the host was in, over the devices,
        largest first.  A gap that outlasts a span is split at the
        spans' edges."""
        edges = sorted({t for s, e, _ in self.spans for t in (s, e)})
        tot = defaultdict(float)
        for dev in self.devices:
            edge = self.t0
            for s, e in self._busy(dev) + [[self.t1, self.t1]]:
                if s > edge:
                    cuts = [edge] + [t for t in edges if edge < t < s] + [s]
                    for a, b in zip(cuts, cuts[1:]):
                        tot[self._span_at((a + b) / 2)] += (b - a) * 1e-6
                edge = max(edge, e)
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:top]]
