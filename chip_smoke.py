#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

  1. device  — print the card's name and power limit; require CUDA.
  2. build   — build the CUDA kernels from csrc/ and time the build.
  3. kernel  — stage the HT lanes of both workloads as the serving path
               does, run the HT cleanup kernel and its plain PyTorch
               version on the same card tensors: bit-exact, both timed.
               64 synthetic lanes are also held against the scalar HT
               decoder (grok_tpu.t1ht.scalar.ht_decode_block).
  4. e2e     — grok_tpu_torch.api.decompress_device_batch on the card:
               (A) 8 streams of 512x512 8-bit gray, HT, 5 resolutions,
               32x32 code-blocks (the bench headline's shape);
               (B) one 1920x1080 8-bit RGB frame, HT lossless RCT + 5/3,
               6 resolutions, 64x64 code-blocks.
               Every output must equal its source bit for bit, and the
               kernel launch counter must have moved.

The inputs are encoded on the host (set-up, timed apart).  The last
three lines of stdout are the card's name and power limit, a JSON line
of per-kernel results, and the JSON result line.  No JAX is imported:
a finder installed first refuses jax and the JAX package's device
modules.
"""

from __future__ import annotations

import importlib.abc
import json
import os
import subprocess
import sys
import time

import numpy as np

REPS = 5                 # end-to-end reps; the best is reported
KERNEL_REPS = 20         # kernel launches per timing window
_BLOCKED = ("jax", "jaxlib", "grok_tpu.ops", "grok_tpu.parallel",
            "grok_tpu.pipeline.device")


class _NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if any(name == b or name.startswith(b + ".") for b in _BLOCKED):
            raise ImportError(f"chip_smoke: import of {name} refused")
        return None


def _block_jax():
    sys.meta_path.insert(0, _NoJax())


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


def _encode(job):
    """Host encode of one workload image (runs in a worker process)."""
    from grok_tpu import CompressParams, compress
    from grok_tpu.util.oracle import synthetic_image
    h, w, c, seed, kw = job
    img = synthetic_image(h, w, c, seed=seed)
    return img, compress(img, CompressParams(ht=True, **kw))


def _synthetic_lanes(torch):
    """64 HT blocks of odd and even sizes up to 64x64, their clean
    sub-streams packed as the kernel takes them, and the scalar
    decoder's output for each."""
    from grok_tpu.t1ht.scalar import ht_decode_block, ht_encode_block
    from grok_tpu.t1ht.wire import split_cleanup
    from grok_tpu_torch.ops.ht_decode import _quant_len
    rng = np.random.default_rng(7)
    blocks, refs = [], []
    for i in range(64):
        w, h = int(rng.integers(1, 65)), int(rng.integers(1, 65))
        sigma = float(10 ** rng.uniform(0, 4))
        mag = np.abs(rng.normal(0, sigma, (h, w))).astype(np.int64)
        mag[rng.random((h, w)) < 0.4] = 0
        mag[0, 0] = max(int(mag[0, 0]), 3)
        neg = rng.random((h, w)) < 0.5
        enc = ht_encode_block(mag, neg, i % 4)
        blocks.append((split_cleanup(enc.data, enc.seg_lens[0]), w, h))
        refs.append(ht_decode_block(enc.data, enc.seg_lens, 1, enc.numbps,
                                    i % 4, w, h))

    def pack(k):
        L = _quant_len(max(len(b[0][k]) for b in blocks))
        a = np.zeros((len(blocks), L + 1), np.uint8)
        for j, b in enumerate(blocks):
            a[j, :len(b[0][k])] = np.frombuffer(b[0][k], np.uint8)
        return torch.from_numpy(a).cuda()

    def col(v):
        return torch.tensor(v, dtype=torch.int32).cuda()

    lanes = (pack(0), pack(1), pack(2), col([0] * 64),
             col([b[1] for b in blocks]), col([b[2] for b in blocks]),
             col([1] * 64))
    return lanes, blocks, refs


def main() -> int:
    _block_jax()
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
    from grok_tpu_torch import _build
    from grok_tpu_torch import api
    from grok_tpu_torch.ops import ht_decode

    # ---- set-up: host encodes, in worker processes ------------------------
    import concurrent.futures as cf
    import multiprocessing as mp

    from grok_tpu import native
    # build the C runtime once, here: the encode workers would otherwise
    # all build it into the same file at the same time
    if not native.available():
        _fail("the C host runtime (grok_tpu/native) did not build")
    a_kw = dict(num_resolutions=5, cblk_w_exp=5, cblk_h_exp=5)
    jobs = [(512, 512, 1, 100 + i, a_kw) for i in range(8)]
    jobs.append((1080, 1920, 3, 7, dict(num_resolutions=6)))
    t0 = time.perf_counter()
    with cf.ProcessPoolExecutor(max_workers=min(9, os.cpu_count() or 1),
                                mp_context=mp.get_context("spawn"),
                                initializer=_block_jax) as pool:
        done = list(pool.map(_encode, jobs))
    print(f"setup: host encode {time.perf_counter() - t0:.3f} s "
          f"(A 8x512x512 gray, B 1920x1080 RGB; "
          f"{sum(len(s) for _, s in done)} bytes)", flush=True)
    work = {"A": ([d[0] for d in done[:8]], [d[1] for d in done[:8]]),
            "B": ([done[8][0]], [done[8][1]])}

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.3f} s", flush=True)
    for ln in _build.build_log.splitlines():
        if "registers" in ln or "spill" in ln or "error" in ln:
            print(f"build: {ln.strip()}", flush=True)

    # ---- 3. kernel vs plain version ---------------------------------------
    dev = torch.device("cuda", 0)
    kern = {"ms": 0.0, "plain_ms": 0.0, "err": 0}
    ev0, ev1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    for name, (_imgs, streams) in work.items():
        staged = api.stage_device_batch(streams, device=dev)
        prog = staged.program
        k_ms = p_ms = 0.0
        for bi, b in enumerate(prog.buckets):
            lanes = prog.stage(staged.body, staged.meta, bi,
                               *staged.dims[bi])
            got = ht_decode.ht_decode_lanes(*lanes, b.W, b.H)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = ht_decode.ht_decode_lanes_ref(*lanes, b.W, b.H)
            torch.cuda.synchronize()
            p_ms += (time.perf_counter() - t0) * 1e3
            err = int((got.long() - ref.long()).abs().max())
            ev0.record()
            for _ in range(KERNEL_REPS):
                ht_decode.ht_decode_lanes(*lanes, b.W, b.H)
            ev1.record()
            torch.cuda.synchronize()
            k_ms += ev0.elapsed_time(ev1) / KERNEL_REPS
            kern["err"] = max(kern["err"], err)
            print(f"kernel {name} bucket {b.W}x{b.H} lanes "
                  f"{lanes[0].shape[0]}: max_abs_err {err}", flush=True)
            if err:
                _fail(f"kernel disagrees with its plain version "
                      f"({name} {b.W}x{b.H}: max abs err {err})")
        kern["ms"] += k_ms
        kern["plain_ms"] += p_ms
        print(f"kernel {name}: {len(prog.buckets)} launches per decode, "
              f"kernel {k_ms:.4f} ms, plain version {p_ms:.1f} ms "
              f"[{card}]", flush=True)
    lanes, blocks, refs = _synthetic_lanes(torch)
    got = ht_decode.ht_decode_lanes(*lanes, 64, 64).cpu().numpy()
    for j, ((_s, w, h), (m2, ng)) in enumerate(zip(blocks, refs)):
        v = got[j, :h, :w]
        if not (np.array_equal(np.abs(v), m2)
                and np.array_equal(v < 0, ng)):
            _fail(f"kernel disagrees with the scalar HT decoder on "
                  f"synthetic lane {j} ({w}x{h})")
    print("kernel vs scalar ht_decode_block: 64 lanes bit-exact",
          flush=True)

    # ---- 4. end to end ---------------------------------------------------
    ht_decode.ht_decode_lanes.launches = 0
    for name, (imgs, streams) in work.items():
        times = []
        for _ in range(REPS + 1):          # the first call is a warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = api.decompress_device_batch(streams, device=dev)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            for img, comps in zip(imgs, out):
                if any(c.device.type != "cuda" for c in comps):
                    _fail(f"{name}: output left the card")
                arr = torch.stack(comps, -1).cpu().numpy() \
                    if img.ndim == 3 else comps[0].cpu().numpy()
                if arr.shape != img.shape or not np.array_equal(arr, img):
                    _fail(f"{name}: decoded pixels differ from the source")
        best, med = min(times[1:]), float(np.median(times[1:]))
        npx = sum(im.shape[0] * im.shape[1] for im in imgs)
        print(f"e2e {name}: {len(streams)} stream(s) bit-exact; best of "
              f"{REPS}: {best * 1e3:.3f} ms/call, "
              f"{best * 1e3 / len(streams):.3f} ms/frame, "
              f"{npx / 1e6 / best:.2f} MP/s (median {med * 1e3:.3f} "
              f"ms/call) [{card}]", flush=True)
    launches = ht_decode.ht_decode_lanes.launches
    if launches == 0:
        _fail("the main path never launched the HT cleanup kernel")

    for name, (_imgs, streams) in work.items():
        host, dev_t = [], []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            staged = api.stage_device_batch(streams, device=dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            staged.run()
            torch.cuda.synchronize()
            host.append(t1 - t0)
            dev_t.append(time.perf_counter() - t1)
        print(f"split {name}: host parse+stage+upload {min(host) * 1e3:.3f}"
              f" ms, device program {min(dev_t) * 1e3:.3f} ms (best of "
              f"{REPS}) [{card}]", flush=True)

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "ht_cleanup_decode", "route": "cuda",
        "source": "grok_tpu_torch/csrc/ht_decode.cu",
        "replaces": "grok_tpu/ops/pallas_ht.py:310",
        "launches": launches, "max_abs_err": kern["err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
