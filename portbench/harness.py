"""One run of one cell: set-up, the measured window, the check.

`run_cell` drives the port's public entry point, as a user does:
`api.decompress_device_batch` on host streams, in a closed loop (each
call starts when the last one has returned and the device has
finished).  It takes from the port only the system under
test and, through wrappers around public module attributes, the time
spent in its layers and the route each call took.

Set-up makes the pool of frames on the device from the seed, encodes it,
and warms up every batch of the pool.  The window then
runs for `seconds`.  A sample of the window's outputs, drawn from the
seed, is copied aside as it is produced and compared with the reference
once the window has closed (check.py).
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench import check, synth
from portbench.devtrace import CALL_SPAN, SPAN_PREFIX, DeviceTrace
from portbench.window import Window

JAX_MODULES = ("jax", "jaxlib", "flax", "grok_tpu")


@dataclass
class Readings:
    """What the metric readers read (metrics/<name>.py `read`)."""
    workload: str
    config: dict
    traffic: dict
    kind: str                        # the device's name
    setup_s: float
    window: Window
    spans: dict = field(default_factory=dict)    # name -> [seconds]
    trace: DeviceTrace | None = None
    traced: dict = field(default_factory=dict)   # work of the traced calls

    @property
    def direction(self) -> str:
        return self.traffic["direction"]

    def span_ms_per_call(self, name: str) -> float | None:
        """A layer's host milliseconds a call of the window."""
        got = self.spans.get(name)
        if not got or not self.window.calls:
            return None
        return 1e3 * sum(got) / self.window.calls


def loaded_jax_modules() -> list:
    """Top-level names of JAX, its libraries or the JAX package that
    the process holds, compared whole (the port's name begins with the
    JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(JAX_MODULES))


def compress_params(cfg: dict, **over):
    """The port's CompressParams from a configuration's `compress`
    fields (the progression order by its name), with `over` on top."""
    from grok_tpu_torch.core.params import CompressParams, ProgOrder
    kw = dict(cfg["compress"])
    if "prog_order" in kw:
        kw["prog_order"] = ProgOrder[kw["prog_order"]]
    kw.update(over)
    return CompressParams(**kw)


def make_mesh(n: int, dev: torch.device):
    """A mesh of n devices: the first n cards, or n CPU shards."""
    if not n:
        return None
    from grok_tpu_torch.parallel import Mesh, tile_mesh
    if dev.type == "cuda":
        return tile_mesh(n)
    return Mesh((dev,) * n)


def _sync(devs: list) -> None:
    for d in devs:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


@contextlib.contextmanager
def _patched(mod, name: str, make):
    """mod.name replaced by make(original) for the block."""
    real = getattr(mod, name)
    setattr(mod, name, make(real))
    try:
        yield
    finally:
        setattr(mod, name, real)


class _Spans:
    """Host spans around layer functions (traced runs): each wrapped
    call records its seconds under a name and a `pb:<name>` annotation
    in the profiler's timeline; `sync_devs` ends a span with a
    synchronize, where the layer's work is on the device."""

    def __init__(self):
        self.spans: dict = {}

    def wrap(self, name: str, sync_devs: list | None = None):
        def make(real):
            def run(*a, **k):
                with torch.profiler.record_function(SPAN_PREFIX + name):
                    t = time.perf_counter()
                    try:
                        out = real(*a, **k)
                        if sync_devs:
                            _sync(sync_devs)
                        return out
                    finally:
                        self.spans.setdefault(name, []).append(
                            time.perf_counter() - t)
            return run
        return make


def _counter(counts: dict, name: str):
    """A wrapper maker that counts the calls under `name`."""
    counts.setdefault(name, 0)

    def make(real):
        def run(*a, **k):
            counts[name] += 1
            return real(*a, **k)
        return run
    return make


class _Reservoir:
    """A uniform sample of the window's calls, drawn from the seed
    (reservoir sampling) into slots made before the window, so that
    keeping a call allocates nothing: `items[j]` is (call index, batch)
    of the call whose output `slots[j]` holds."""

    def __init__(self, slots: list, seed: int):
        self.slots = slots
        self.rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF,
                                          0x5EED])
        self.items: list = []

    def offer(self, i: int, b: int, out, keep) -> None:
        k = len(self.slots)
        if len(self.items) < k:
            j = len(self.items)
            self.items.append(None)
        else:
            j = int(self.rng.integers(0, i + 1))
            if j >= k:
                return
        self.slots[j] = keep(out, self.slots[j])
        self.items[j] = (i, b)


def _stream_digest(streams: list) -> tuple[int, str]:
    h = hashlib.sha256()
    for s in streams:
        h.update(s)
    return sum(len(s) for s in streams), h.hexdigest()


class Cell:
    """A cell's set-up state: the device(s), the pool and the batches."""

    def __init__(self, workload: str, cfg: dict, mix: dict, seed: int,
                 device, control: str | None = None):
        self.workload, self.cfg, self.mix = workload, cfg, mix
        self.seed, self.control = seed, control
        self.dev = torch.device(device)
        if self.dev.type == "cuda" and self.dev.index is None:
            self.dev = torch.device("cuda", 0)
        self.mesh = make_mesh(int(mix.get("mesh", 0)), self.dev)
        self.devs = list(dict.fromkeys(self.mesh.devices)) if self.mesh \
            else [self.dev]
        g = cfg["geometry"]
        self.h, self.w, self.nc = g["height"], g["width"], g["components"]
        self.prec = cfg["precision"]["bits"]
        if cfg["precision"]["signed"]:
            raise ValueError("synth.py makes unsigned frames only")
        self.fpc = int(mix["frames_per_call"])
        n = int(mix["pool_frames"])
        if n % self.fpc:
            raise ValueError("pool_frames must be a multiple of "
                             "frames_per_call")
        self.src = synth.pool(n, self.h, self.w, self.nc, seed, self.dev,
                              self.prec)
        self.batches = [list(range(i, i + self.fpc))
                        for i in range(0, n, self.fpc)]
        self.context: dict = {}

    def frames(self, idx: list) -> list:
        """Frames idx as the encode takes them: lists of int32 component
        tensors on the device."""
        return [[self.src[f, c].to(torch.int32) for c in range(self.nc)]
                for f in idx]

    def params(self, **over):
        return compress_params(self.cfg, **over)


class DecodeMix:
    """Host streams of the pool decoded a batch a call."""

    def __init__(self, cell: Cell):
        from grok_tpu_torch import api
        from grok_tpu_torch.core.params import DecompressParams
        self.api, self.cell = api, cell
        over = {"irreversible": True} if cell.control == "irreversible" \
            else {}
        p = cell.params(**over)
        self.streams: list = []
        for b in cell.batches:
            self.streams += api.compress_device_batch(
                cell.frames(b), p, prec=cell.prec, sgnd=False,
                device=cell.dev)
        nbytes, sha = _stream_digest(self.streams)
        cell.context["pool"] = {"frames": len(self.streams),
                                "stream_bytes": nbytes, "sha256": sha}
        self.dparams = DecompressParams(mesh=cell.mesh)
        self.batch_streams = [[self.streams[f] for f in b]
                              for b in cell.batches]

    def call(self, b: int):
        c = self.cell
        if c.control == "lsb":           # the reference in the program's
            return [[(c.src[f, k].to(torch.int32) >> 1) << 1   # place, a
                     for k in range(c.nc)]                     # bit less
                    for f in c.batches[b]]
        return self.api.decompress_device_batch(
            self.batch_streams[b], self.dparams, device=c.dev)

    def work_bytes(self, b: int) -> int:
        return sum(len(s) for s in self.batch_streams[b])

    @staticmethod
    def slot(out):
        """An empty slot shaped like a call's output."""
        return [[torch.empty_like(p) for p in fr] for fr in out]

    @staticmethod
    def keep(out, slot):
        """A copy of a call's planes, into the slot's own tensors."""
        for fr_s, fr in zip(slot, out):
            for p_s, p in zip(fr_s, fr):
                p_s.copy_(p)
        return slot

    def layer_spans(self, spans: _Spans):
        from grok_tpu_torch.pipeline import serve
        return [(self.api, "stage_device_batch",
                 spans.wrap("decode_stage")),
                (serve.StagedBatch, "run",
                 spans.wrap("decode_program", self.cell.devs))]

    def route_counters(self, counts: dict):
        from grok_tpu_torch.pipeline import serve
        return [(serve.StagedBatch, "run", _counter(counts, "served_calls")),
                (self.api, "decompress_device",
                 _counter(counts, "general_route_streams"))]


MIXES = {"decode": DecodeMix}


def _card_context() -> list:
    """nvidia-smi's reading of each card: name, power limit and draw,
    SM clock and its maximum, temperature."""
    import subprocess
    q = ("index,name,power.limit,power.draw,clocks.sm,clocks.max.sm,"
         "temperature.gpu")
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"nvidia-smi unavailable: {e}"]
    return out.stdout.strip().splitlines() or [out.stderr.strip()]


def run_cell(workload: str, cfg: dict, mix: dict, *, seed: int,
             seconds: float, traced: bool, device="cuda",
             control: str | None = None,
             t_start: float | None = None) -> dict:
    """One run of a cell on `device` ("cuda": the first card, and the
    next ones for a mesh).  control: "lsb" or "irreversible", a control
    of the check in the program's place (control.py).  t_start: the
    process's start on perf_counter's clock, where set-up begins.
    Returns {"readings", "check", "attempted", "failed",
    "memory_peak_bytes", "context", "devices"}."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(workload, cfg, mix, seed, device, control)
    if mix["direction"] not in MIXES:
        raise ValueError(f"no mix for direction {mix['direction']!r}")
    mix_obj = MIXES[mix["direction"]](cell)
    nb = len(cell.batches)
    out = None
    for i in range(max(int(mix.get("warmup_calls", 2)), nb)):
        out = mix_obj.call(i % nb)
    _sync(cell.devs)
    res = _Reservoir([mix_obj.slot(out)
                      for _ in range(int(mix.get("check_calls", 4)))], seed)
    del out

    counts: dict = {}
    spans = _Spans()
    patches = list(mix_obj.route_counters(counts))
    if traced:
        patches += mix_obj.layer_spans(spans)
    prof = None
    trace_calls = int(mix.get("trace_calls", 4))
    if traced and cell.dev.type == "cuda":
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        mix_obj.call(0)               # the profiler's own start-up
        _sync(cell.devs)
    for d in cell.devs:
        if d.type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)
    setup_s = time.perf_counter() - t_start

    win = Window()
    failed_calls: list = []
    first_error = None
    px = cell.h * cell.w * cell.fpc
    traced_work = {"calls": 0, "stream_bytes": 0, "samples": 0}
    with contextlib.ExitStack() as stack:
        for mod, name, make in patches:
            stack.enter_context(_patched(mod, name, make))
        i = 0
        while not win.calls or time.perf_counter() - win.starts[0] < seconds:
            b = i % nb
            t = time.perf_counter()
            out = None
            with torch.profiler.record_function(CALL_SPAN):
                try:
                    out = mix_obj.call(b)
                    _sync(cell.devs)
                except Exception:        # a failed call fails its frames
                    failed_calls.append(i)
                    if first_error is None:
                        first_error = traceback.format_exc()
            win.add(t, time.perf_counter(), px if out is not None else 0)
            if prof is not None and i < trace_calls:
                traced_work["calls"] += 1
                traced_work["stream_bytes"] += mix_obj.work_bytes(b)
                traced_work["samples"] += cell.nc * px
                if traced_work["calls"] == trace_calls:
                    prof.stop()
            if out is not None:
                res.offer(i, b, out, mix_obj.keep)
            out = None
            i += 1
        if prof is not None and traced_work["calls"] < trace_calls:
            prof.stop()
    _sync(cell.devs)
    peak = max((torch.cuda.max_memory_allocated(d) for d in cell.devs
                if d.type == "cuda"), default=0)
    if first_error:
        print(first_error, file=sys.stderr)

    trace = None
    if prof is not None:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            trace = DeviceTrace.from_file(
                path, [d.index for d in cell.devs])
        del prof
    verdict = check.judge(cell, res.items, res.slots)
    del res
    attempted = win.calls * cell.fpc
    failed = len(failed_calls) * cell.fpc + verdict["frames_wrong"]

    ctx = cell.context
    ctx["call_samples"] = win.calls
    ctx["window_s"] = win.seconds
    ctx["routes"] = counts
    if cell.dev.type == "cuda":
        ctx["cards"] = _card_context()
    if trace is not None:
        ctx["idle_pct_by_card"] = {d: trace.idle_pct(d)
                                   for d in trace.devices}
        ctx["traced_calls"] = trace.calls
    kind = torch.cuda.get_device_name(cell.dev) \
        if cell.dev.type == "cuda" else "cpu"
    readings = Readings(workload, cfg, mix, kind, setup_s, win,
                        spans.spans, trace, traced_work)
    return {"readings": readings, "check": verdict, "attempted": attempted,
            "failed": failed, "memory_peak_bytes": peak, "context": ctx,
            "devices": len(cell.devs)}
