#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main paths on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

  1. device  — print the card's name and power limit; require CUDA.
  2. build   — build the CUDA kernels (one nvcc per csrc/*.cu, started
               together) and the host C runtime from the checkout.
  3. encode  — the main encode path, grok_tpu_torch.api.
               compress_device_batch on the card, with the launch counts
               set to 0 before it and read after it:
               (A) 8 frames of 512x512 8-bit gray, HT, 5 resolutions,
               32x32 code-blocks (the bench headline's shape);
               (B) one 1920x1080 8-bit RGB frame, HT lossless RCT + 5/3,
               6 resolutions, 64x64 code-blocks.
               The inputs are made by the port's synthetic_image and
               uploaded first (set-up).  Every rep must give the same
               bytes, and a small encode on the card must equal the same
               encode through the plain versions on the CPU.
  4. decode  — the main decode path, decompress_device_batch on the card
               over the streams of phase 3, counts reset and read the
               same way; every output must equal its source bit for bit.
  5. K4      — the HT cleanup encoder on every lane of the encode path
               against its plain version: byte-identical used stream
               bytes and bit counts; both timed on the same lanes.
  6. K4->K1  — 64 synthetic lanes of 1x1 to 64x64 encoded by K4,
               assembled and scanned by the port's C runtime, staged and
               un-stuffed as the decode does, decoded by K1: the source
               magnitudes and signs must come back.
  7. K1      — the HT cleanup decoder on the decode path's staged lanes
               against its plain version: bit-exact; both timed.

The last three lines of stdout are the card's name and power limit, a
JSON line of per-kernel results, and the JSON result line.  No JAX and
nothing of the JAX package is imported: a finder installed first refuses
jax, jaxlib and grok_tpu.
"""

from __future__ import annotations

import importlib.abc
import json
import os
import subprocess
import sys
import time

import numpy as np

REPS = 5                 # end-to-end reps after a warm-up; best reported
KERNEL_REPS = 20         # kernel launches per timing window
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 peak bandwidth
_BLOCKED = ("jax", "jaxlib", "grok_tpu")


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if any(name == b or name.startswith(b + ".") for b in _BLOCKED):
            raise ImportError(f"chip_smoke: import of {name} refused")
        return None


def _fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _k4_bytes(lanes, bits, lut) -> int:
    """Bytes the HT cleanup encode must move: each valid lane's w*h int32
    samples and every lane's four int32 parameters read, the LUT read
    once, the used 32-bit words of the three streams and the three bit
    counts per lane written.  Block padding is not counted."""
    mneg, _p, w, h, valid = lanes
    v = (valid == 1).long()
    samples = 4 * int((w.long() * h.long() * v).sum())
    words = 4 * int(((bits.long().clamp(min=0) + 31) >> 5).sum())
    return samples + 16 * mneg.shape[0] + _nbytes(lut) + words \
        + 12 * mneg.shape[0]


def _k1_bytes(meta, lanes, lut) -> int:
    """Bytes the HT cleanup decode must move: each valid lane's used
    stream bytes (the MagSgn stream and the MEL + VLC suffix, as the C
    scan measured them, before staging pads them) and every lane's four
    int32 parameters read, the LUT read once, and each valid lane's w*h
    int32 samples written."""
    _ms, _mel, _vlc, _p, w, h, valid = lanes
    v = (valid == 1).long()
    used = int(((meta[:, 1].long() + meta[:, 3].long()) * v).sum())
    out = 4 * int((w.long() * h.long() * v).sum())
    return used + 16 * w.shape[0] + _nbytes(lut) + out


def _kernel_ms(torch, fn) -> float:
    """Mean device time of fn() over KERNEL_REPS launches (CUDA events)."""
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    fn()
    ev0.record()
    for _ in range(KERNEL_REPS):
        fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / KERNEL_REPS


def _plain_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _host_split(serve_enc, call) -> dict:
    """Host seconds of the C wire assembly and the Tier-2 finish inside
    one encode call (wrapped for this call only), and the call's own."""
    spent = {"assemble": 0.0, "finish": 0.0}
    orig = (serve_enc.native.ht_assemble_batch, serve_enc.finish_tile_encode)

    def timed_as(key, fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[key] += time.perf_counter() - t
        return run

    serve_enc.native.ht_assemble_batch = timed_as("assemble", orig[0])
    serve_enc.finish_tile_encode = timed_as("finish", orig[1])
    try:
        spent["call"] = call()
    finally:
        serve_enc.native.ht_assemble_batch, serve_enc.finish_tile_encode = \
            orig
    return spent


def _synthetic_roundtrip(torch, dev, K):
    """Phase 6: K4 -> C assembly -> C scan -> device un-stuff -> K1."""
    ht_encode, ht_decode, native, stage_bytes, unstuff_suffix, stage_dims = K
    rng = np.random.default_rng(7)
    n, side = 64, 64
    mneg = np.zeros((n, side, side), np.int32)
    mags, negs, dims = [], [], []
    for i in range(n):
        w = 1 + (i * 37) % side if i else 1
        h = 1 + (i * 23) % side if i else 1
        sigma = float(10 ** rng.uniform(0, 3.5))
        mag = np.abs(rng.normal(0, sigma, (h, w))).astype(np.int64)
        mag[rng.random((h, w)) < 0.4] = 0
        mag[0, 0] = max(int(mag[0, 0]), 1)
        neg = rng.random((h, w)) < 0.5
        mneg[i, :h, :w] = (mag << 1) | neg
        mags.append(mag)
        negs.append(neg & (mag > 0))
        dims.append((w, h))

    def col(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    caps = (side * side * 28 // 8 + 64, 1024, 2048)
    streams, bits = ht_encode.ht_encode_lanes(
        torch.from_numpy(mneg).to(dev), col([0] * n),
        col([d[0] for d in dims]), col([d[1] for d in dims]), col([1] * n),
        *caps)
    buf = streams.cpu().numpy().reshape(-1)
    bits = bits.cpu().numpy().astype(np.int64)
    if (bits < 0).any():
        _fail("K4 round trip: a stream exceeded its capacity")
    row = sum(caps)
    base = np.arange(n, dtype=np.int64) * row
    res = native.ht_assemble_batch(buf, base, bits[0], base + caps[0],
                                   bits[1], base + caps[0] + caps[1],
                                   bits[2], np.zeros(n, np.int32))
    if res is None:
        _fail("K4 round trip: the C assembler refused the streams")
    wire, wlens = res
    offs = np.cumsum(wlens) - wlens
    scan = native.ht_scan2(wire[:int(wlens.sum())].tobytes(), offs, wlens)
    if scan is None or (scan[0][:, 0] < 0).any():
        _fail("K4 round trip: the C scan refused the assembled segments")
    sc, digest = scan
    body = torch.from_numpy(digest.copy()).to(dev)
    m = torch.from_numpy(sc.astype(np.int64)).to(dev)
    lms, lsuf, dm = stage_dims(sc)
    ms = stage_bytes(body, m[:, 1], m[:, 2], lms, False)
    suf_f = stage_bytes(body, m[:, 3], m[:, 4], lsuf, False)
    suf_r = stage_bytes(body, m[:, 3], m[:, 4] - 1, lsuf, True)
    mel, vlc = unstuff_suffix(suf_f, suf_r, dm)
    u8 = torch.uint8
    got = ht_decode.ht_decode_lanes(
        ms.to(u8), mel.to(u8), vlc.to(u8), col([0] * n),
        col([d[0] for d in dims]), col([d[1] for d in dims]), col([1] * n),
        side, side).cpu().numpy()
    for j, ((w, h), mag, neg) in enumerate(zip(dims, mags, negs)):
        v = got[j, :h, :w]
        if not (np.array_equal(np.abs(v), 2 * mag)
                and np.array_equal(v < 0, neg)):
            _fail(f"K4 -> K1 round trip differs on synthetic lane {j} "
                  f"({w}x{h})")
    print(f"K4 -> K1 round trip: {n} synthetic lanes of 1x1 to "
          f"{side}x{side} give back their magnitudes and signs", flush=True)


def main() -> int:
    sys.meta_path.insert(0, _Refuse())
    # ---- 1. device -------------------------------------------------------
    card = _card()
    print(f"card: {card}", flush=True)
    import torch
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke needs a "
              "CUDA card")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from grok_tpu_torch import _build, api, native
    from grok_tpu_torch.core.params import CompressParams
    from grok_tpu_torch.ops import ht_decode, ht_encode
    from grok_tpu_torch.pipeline import serve_enc
    from grok_tpu_torch.pipeline.device import stage_bytes, unstuff_suffix
    from grok_tpu_torch.pipeline.serve import stage_dims
    from grok_tpu_torch.util.synth import synthetic_image

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    t1 = time.perf_counter()
    _build.load_host_library()
    print(f"build: CUDA kernels {t1 - t0:.3f} s, host C runtime "
          f"{time.perf_counter() - t1:.3f} s", flush=True)
    for ln in _build.build_log.splitlines():
        if ln.startswith("[") or "registers" in ln or "spill" in ln \
                or "error" in ln:
            print(f"build: {ln.strip()}", flush=True)

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    work = {
        "A": ([synthetic_image(512, 512, 1, seed=100 + i) for i in range(8)],
              CompressParams(ht=True, num_resolutions=5, cblk_w_exp=5,
                             cblk_h_exp=5)),
        "B": ([synthetic_image(1080, 1920, 3, seed=7)],
              CompressParams(ht=True, num_resolutions=6)),
    }
    frames = {name: [[torch.from_numpy(im[..., c] if im.ndim == 3 else im)
                      .to(dev).to(torch.int32)
                      for c in range(im.shape[2] if im.ndim == 3 else 1)]
                     for im in imgs] for name, (imgs, _p) in work.items()}
    torch.cuda.synchronize()
    print(f"setup: synthetic sources made and uploaded in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    def counts_zero():
        ht_encode.ht_encode_lanes.launches = 0
        ht_decode.ht_decode_lanes.launches = 0

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def report(what, name, times, nframes, npx):
        best, med = min(times[1:]), float(np.median(times[1:]))
        print(f"{what} {name}: best of {REPS}: {best * 1e3:.3f} ms/call, "
              f"{best * 1e3 / nframes:.3f} ms/frame, {npx / 1e6 / best:.2f}"
              f" MP/s (median {med * 1e3:.3f} ms/call) [{card}]",
              flush=True)

    # ---- 3. encode main path --------------------------------------------
    streams = {}
    counts_zero()
    for name, (imgs, params) in work.items():
        times = []
        for _ in range(REPS + 1):          # the first call is a warm-up
            out, dt = timed(lambda: api.compress_device_batch(
                frames[name], params, device=dev))
            times.append(dt)
            if name in streams and out != streams[name]:
                _fail(f"encode {name}: reps gave different bytes")
            streams[name] = out
        npx = sum(im.shape[0] * im.shape[1] for im in imgs)
        report("encode", name, times, len(imgs), npx)
        print(f"encode {name}: {sum(len(s) for s in streams[name])} bytes "
              f"for {len(imgs)} frame(s)", flush=True)
    k4_launches = ht_encode.ht_encode_lanes.launches
    if k4_launches == 0:
        _fail("the encode path never launched the HT cleanup encoder")
    small = [synthetic_image(80, 96, 1, seed=20 + i) for i in range(3)]
    small_rgb = synthetic_image(64, 96, 3, seed=5)
    sp = CompressParams(ht=True, num_resolutions=3, cblk_w_exp=5,
                        cblk_h_exp=5)
    if (api.compress_device_batch(small, sp, device=dev)
            != api.compress_device_batch(small, sp, device="cpu")
            or api.compress_device(small_rgb, sp, device=dev)
            != api.compress_device(small_rgb, sp, device="cpu")):
        _fail("encode on the card differs from the plain versions on the "
              "CPU")
    print("encode reference: 3 x 80x96 gray and 64x96 RGB byte-identical "
          "to the CPU encode through the plain versions", flush=True)

    # ---- 4. decode main path --------------------------------------------
    counts_zero()
    for name, (imgs, _params) in work.items():
        times = []
        for _ in range(REPS + 1):
            out, dt = timed(lambda: api.decompress_device_batch(
                streams[name], device=dev))
            times.append(dt)
            for img, comps in zip(imgs, out):
                if any(c.device.type != "cuda" for c in comps):
                    _fail(f"decode {name}: output left the card")
                arr = torch.stack(comps, -1).cpu().numpy() \
                    if img.ndim == 3 else comps[0].cpu().numpy()
                if arr.shape != img.shape or not np.array_equal(arr, img):
                    _fail(f"decode {name}: pixels differ from the source")
        npx = sum(im.shape[0] * im.shape[1] for im in imgs)
        report("decode", name, times, len(imgs), npx)
        print(f"decode {name}: {len(imgs)} frame(s) bit-exact to the "
              f"source", flush=True)
    k1_launches = ht_decode.ht_decode_lanes.launches
    if k1_launches == 0:
        _fail("the decode path never launched the HT cleanup decoder")

    for name in work:
        host, dev_t = [], []
        for _ in range(REPS):
            staged, dt0 = timed(lambda: api.stage_device_batch(
                streams[name], device=dev))
            _, dt1 = timed(staged.run)
            host.append(dt0)
            dev_t.append(dt1)
        print(f"split decode {name}: host parse+stage+upload "
              f"{min(host) * 1e3:.3f} ms, device program "
              f"{min(dev_t) * 1e3:.3f} ms (best of {REPS}) [{card}]",
              flush=True)

    # ---- 5. K4 vs its plain version ---------------------------------------
    k4 = {"ms": 0.0, "plain_ms": 0.0, "err": 0, "bytes": 0}
    for name, (imgs, params) in work.items():
        comps = [torch.stack([f[ci] for f in frames[name]])
                 for ci in range(len(frames[name][0]))]
        h, w = comps[0].shape[1:]
        hdr = api._build_main_header(h, w, len(comps), 8, False, params)
        plan, lanes = serve_enc.stage_encode_lanes(comps, hdr, params)
        caps = plan.caps
        nl = lanes[0].shape[0]
        got = ht_encode.ht_encode_lanes(*lanes, *caps)
        ref, p_ms = _plain_ms(torch, lambda: ht_encode.ht_encode_lanes_ref(
            *lanes, *caps))
        # only each stream's first ceil(bits / 8) bytes are defined
        used = ht_encode.clear_unused(*got, *caps[:2])
        err = max(int((used.int() - ref[0].int()).abs().max()),
                  int((got[1] - ref[1]).abs().max()))
        k4["err"] = max(k4["err"], err)
        print(f"K4 {name}: {nl} lanes ({plan.W}x{plan.H}) vs the plain "
              f"version: max_abs_err {err}", flush=True)
        if err:
            _fail(f"K4 disagrees with its plain version on {name}")
        k_ms = _kernel_ms(torch, lambda: ht_encode.ht_encode_lanes(
            *lanes, *caps))
        nbytes = _k4_bytes(lanes, got[1], ht_encode._lut_on(dev))
        k4["ms"] += k_ms
        k4["plain_ms"] += p_ms
        k4["bytes"] += nbytes
        print(f"K4 {name}: 1 launch per encode, {nl} lanes, kernel "
              f"{k_ms:.4f} ms, bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} "
              f"ms ({nbytes} bytes), plain version {p_ms:.1f} ms on the "
              f"same lanes [{card}]", flush=True)
        _, dev_s = timed(lambda: ht_encode.ht_encode_lanes(
            *serve_enc.stage_encode_lanes(comps, hdr, params)[1], *caps))
        host = _host_split(serve_enc, lambda: timed(
            lambda: api.compress_device_batch(frames[name], params,
                                              device=dev))[1])
        print(f"split encode {name}: device staging + K4 {dev_s * 1e3:.3f}"
              f" ms, C wire assembly {host['assemble'] * 1e3:.3f} ms, "
              f"Tier-2 finish {host['finish'] * 1e3:.3f} ms, whole call "
              f"{host['call'] * 1e3:.3f} ms [{card}]", flush=True)

    # ---- 6. K4 -> K1 round trip -------------------------------------------
    _synthetic_roundtrip(torch, dev, (ht_encode, ht_decode, native,
                                      stage_bytes, unstuff_suffix,
                                      stage_dims))

    # ---- 7. K1 vs its plain version ---------------------------------------
    k1 = {"ms": 0.0, "plain_ms": 0.0, "err": 0, "bytes": 0}
    for name in work:
        staged = api.stage_device_batch(streams[name], device=dev)
        prog = staged.program
        k_ms = p_ms = 0.0
        nb0 = k1["bytes"]
        for bi, b in enumerate(prog.buckets):
            lanes = prog.stage(staged.body, staged.meta, bi,
                               *staged.dims[bi])
            got = ht_decode.ht_decode_lanes(*lanes, b.W, b.H)
            ref, dt = _plain_ms(torch, lambda: ht_decode.ht_decode_lanes_ref(
                *lanes, b.W, b.H))
            p_ms += dt
            err = int((got.long() - ref.long()).abs().max())
            k1["err"] = max(k1["err"], err)
            print(f"K1 {name} bucket {b.W}x{b.H} lanes {lanes[0].shape[0]}:"
                  f" max_abs_err {err}", flush=True)
            if err:
                _fail(f"K1 disagrees with its plain version ({name} "
                      f"{b.W}x{b.H}: max abs err {err})")
            k_ms += _kernel_ms(torch, lambda: ht_decode.ht_decode_lanes(
                *lanes, b.W, b.H))
            lo = prog.lane_base[bi]
            k1["bytes"] += _k1_bytes(
                staged.meta[lo:lo + lanes[0].shape[0]], lanes,
                ht_decode._lut_on(dev))
        k1["ms"] += k_ms
        k1["plain_ms"] += p_ms
        nb = k1["bytes"] - nb0
        print(f"K1 {name}: {len(prog.buckets)} launches per decode, kernel "
              f"{k_ms:.4f} ms, bound {nb / HBM_BYTES_PER_S * 1e3:.4f} ms "
              f"({nb} bytes), plain version {p_ms:.1f} ms [{card}]",
              flush=True)

    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": "ht_cleanup_decode", "route": "cuda",
         "source": "grok_tpu_torch/csrc/ht_decode.cu",
         "replaces": "grok_tpu/ops/pallas_ht.py:310",
         "launches": k1_launches, "max_abs_err": k1["err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bytes"] / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes", "library_ms": None},
        {"name": "ht_cleanup_encode", "route": "cuda",
         "source": "grok_tpu_torch/csrc/ht_encode.cu",
         "replaces": "grok_tpu/ops/pallas_ht_enc.py:125",
         "launches": k4_launches, "max_abs_err": k4["err"],
         "ms": k4["ms"], "plain_ms": k4["plain_ms"],
         "bound_ms": k4["bytes"] / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes", "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
