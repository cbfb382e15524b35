"""On-card validation and timing of the port's kernels and serving paths.

    python -m grok_tpu_torch.tools.hw_validate [--device cuda|cpu] [check ...]

The counterpart of tools/hw_validate.py, with its check names, default
shapes and synthetic content (the same default_rng seeds and draws; the
blocks are coded by the port's own encoders).  With no check named, all
nine run:

  gather_probe     P1, the per-lane gather (ops/lane_gather.py), at 64 and
                   65536 rows of 128 lanes, against its plain version,
                   torch.take_along_dim and numpy's take_along_axis;
  ht_dec, ht_enc   K1 and K4 on 1024 blocks of 32x32: K4 -> C assembly ->
                   C scan -> K1 gives back the source; both kernels
                   against their plain versions and their first designs
                   (ht_decode_lanes_v1, ht_encode_lanes_v1, one thread per
                   lane) on every lane, the two designs timed in turns;
  mq_dec, mq_enc   K3 and K5 on 128 blocks of 64x64: K5 -> K3 gives back
                   the source; both kernels against their first designs
                   (t1_*_lanes_v1, one thread per lane) on every lane, bit
                   for bit, and both designs timed in turns; against their
                   plain versions on a subset of the lanes cut to EDGE_H
                   rows (the plain versions step every lane in lockstep: a
                   full 64x64 lane costs tens of seconds);
  serve_mq_enc, serve_mq_enc_rt, serve_mixed_enc
                   the Part-1, the rate-targeted and 3-layer Part-1 and
                   the HT-mixed serving encodes (api.compress_device) of a
                   512x512 gray frame with 32x32 code-blocks: every rep
                   gives the same bytes, and a 128x96 encode on the card
                   equals the CPU encode through the plain versions;
  serve_mixed_dec  the HT-mixed serving decode of that frame's natural
                   stream and of a forced one (every other Part-1 codeword
                   padded so that HT wins the block): lossless, every rep
                   the same, and a 128x96 forced stream decoded on the card
                   equal to its CPU decode.

Each `run_<check>(device, ...)` prints one line and returns a dict with
"ok" and its numbers.  Kernel times are CUDA events over back-to-back
launches on a card; on the CPU (--device cpu, small sizes) they are host
times of the plain versions.  The serving checks report the kernels'
launch counts: the port has no host fallback to detect, it raises.
main() prints the card's name and power limit first and exits 1 if a
check fails.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
import time

import numpy as np
import torch

from grok_tpu_torch import api, native
from grok_tpu_torch.codestream import j2k
from grok_tpu_torch.core.params import CompressParams
from grok_tpu_torch.ops import ht_decode, ht_encode, lane_gather, t1_decode, \
    t1_encode
from grok_tpu_torch.pipeline import serve_enc
from grok_tpu_torch.pipeline.device import stage_bytes, unstuff_suffix
from grok_tpu_torch.pipeline.serve import stage_dims
from grok_tpu_torch.util.synth import synthetic_image

CHECKS = ("gather_probe", "ht_dec", "ht_enc", "mq_dec", "mq_enc",
          "serve_mq_enc", "serve_mq_enc_rt", "serve_mixed_enc",
          "serve_mixed_dec")
GATHER_ROWS = (64, 65536)
EDGE_H = 8               # rows of the lanes held against the Part-1 plain
KERNEL_REPS = 20         # launches per kernel timing window
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 peak bandwidth
# --device cpu: the plain versions at sizes a CPU run finishes in seconds
SMALL = {"gather_probe": dict(rows=(64, 512)),
         "ht_dec": dict(w=16, h=16, nblocks=16),
         "ht_enc": dict(w=16, h=16, nblocks=16),
         "mq_dec": dict(w=16, h=16, nblocks=4),
         "mq_enc": dict(w=16, h=16, nblocks=4),
         "serve_mq_enc": dict(side=64, cblk_exp=4, n=1),
         "serve_mq_enc_rt": dict(side=64, cblk_exp=4, n=1),
         "serve_mixed_enc": dict(side=64, cblk_exp=4, n=1),
         "serve_mixed_dec": dict(side=64, cblk_exp=4, n=1)}
# each kernel's launch count: (wrapper, attribute)
COUNTERS = {"K1": (ht_decode.ht_decode_lanes, "launches"),
            "K2": (ht_decode.ht_decode_lanes, "refine_launches"),
            "K3": (t1_decode.t1_decode_lanes, "launches"),
            "K4": (ht_encode.ht_encode_lanes, "launches"),
            "K4r": (ht_encode.ht_encode_lanes, "refine_launches"),
            "K5": (t1_encode.t1_encode_lanes, "launches"),
            "P1": (lane_gather.lane_gather, "launches"),
            # K1/K2's int64 re-decode of lanes marked MARK_I64 (a corrupt
            # block's magnitudes past int32)
            "K12i64": (ht_decode.ht_decode_lanes, "i64_launches"),
            # the first designs of K1, K2, K3, K4, K4r and K5: the oracle,
            # on no serving path
            "K1v1": (ht_decode.ht_decode_lanes_v1, "launches"),
            "K2v1": (ht_decode.ht_decode_lanes_v1, "refine_launches"),
            "K3v1": (t1_decode.t1_decode_lanes_v1, "launches"),
            "K4v1": (ht_encode.ht_encode_lanes_v1, "launches"),
            "K4rv1": (ht_encode.ht_encode_lanes_v1, "refine_launches"),
            "K5v1": (t1_encode.t1_encode_lanes_v1, "launches")}


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def zero_counts() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


def launch_counts() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in COUNTERS.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def kernel_ms(device: torch.device, fn, reps: int = KERNEL_REPS) -> float:
    """Mean time of fn() over reps back-to-back calls after a warm-up,
    by CUDA events, on a card; elsewhere the host time of one call (the
    plain versions)."""
    if device.type != "cuda":
        return _call_ms(device, fn)[1]
    fn()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(reps):
        fn()
    ev1.record()
    torch.cuda.synchronize(device)
    return ev0.elapsed_time(ev1) / reps


def turns_ms(device: torch.device, old, new) -> tuple:
    """(old's, new's) kernel_ms, each the mean of two windows taken in
    turns: old, new, new, old (elsewhere than on a card, one call each)."""
    if device.type != "cuda":
        return kernel_ms(device, old), kernel_ms(device, new)
    a, b = kernel_ms(device, old), kernel_ms(device, new)
    b, a = (b + kernel_ms(device, new)) / 2, (a + kernel_ms(device, old)) / 2
    return a, b


def encodes_equal(got, ref) -> bool:
    """Two t1_encode_lanes results agree: lengths, the used bytes (the
    sentinel and the codeword), the watermark rows and the sigtype map."""
    out, lens = got[0], got[1]
    used = torch.arange(out.shape[1], device=out.device)[None] \
        <= lens.long()[:, None]
    return (torch.equal(lens, ref[1])
            and torch.equal(torch.where(used, out, 0),
                            torch.where(used, ref[0], 0))
            and torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3]))


def plain_encode_ms(*args) -> tuple:
    """(t1_encode_lanes_ref(*args), its wall ms) for CPU tensors, on one
    thread: the plain version of a K5 launch's held lanes, run in a
    worker process beside the card's work (chip_smoke.py phases 8, 25
    and 32)."""
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = t1_encode.t1_encode_lanes_ref(*args)
    return out, (time.perf_counter() - t0) * 1e3


def plain_decode_ms(*args) -> tuple:
    """(t1_decode_lanes_ref(*args), its wall ms) for CPU tensors, on one
    thread: the plain version of a K3 launch's held lanes, run in a
    worker process beside the card's work (chip_smoke.py phases 9, 16
    and 32)."""
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = t1_decode.t1_decode_lanes_ref(*args)
    return out, (time.perf_counter() - t0) * 1e3


def _call_ms(device: torch.device, fn):
    """(fn(), wall ms of the call, ended by a synchronize)."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, (time.perf_counter() - t0) * 1e3


def _col(v, device) -> torch.Tensor:
    return torch.tensor(list(v), dtype=torch.int32, device=device)


def _report(res: dict, text: str) -> dict:
    print(f"{res['check']} {text}: ok={res['ok']} [{res['device']}]",
          flush=True)
    return res


# ---------------------------------------------------------------------------
# P1
# ---------------------------------------------------------------------------

def run_gather_probe(device, rows: int = 64, L: int = 128) -> dict:
    """P1 on the JAX probe's own inputs (x = arange, idx drawn by
    default_rng(0)): the kernel against its plain version, the library
    call torch.take_along_dim and numpy's take_along_axis; the plain
    version's time, and the kernel's and the library call's timed in
    turns (P1, library, library, P1: `ms`, `library_ms` the mean of each
    one's two windows, `spread_ms` the larger gap between a call's two
    windows); on a card the bytes bound (x and idx read once, out written
    once: 12 bytes an element)."""
    device = torch.device(device)
    x = np.arange(rows * L, dtype=np.int32).reshape(rows, L)
    idx = np.random.default_rng(0).integers(0, rows, (rows, L),
                                            dtype=np.int32)
    xd, ixd = torch.from_numpy(x).to(device), torch.from_numpy(idx).to(device)
    ix64 = ixd.to(torch.int64)         # the library call's index type
    before = lane_gather.lane_gather.launches
    got = lane_gather.lane_gather(xd, ixd)
    launches = lane_gather.lane_gather.launches - before
    want = np.take_along_axis(x, idx, axis=0)
    err = max(int((got.long() - other.long()).abs().max())
              for other in (lane_gather.lane_gather_ref(xd, ixd),
                            torch.take_along_dim(xd, ix64, dim=0),
                            torch.from_numpy(want).to(device)))
    nbytes = 3 * rows * L * 4

    def p1():
        return lane_gather.lane_gather(xd, ixd)

    def lib():
        return torch.take_along_dim(xd, ix64, dim=0)
    w = [kernel_ms(device, f) for f in (p1, lib, lib, p1)]
    res = dict(check="gather_probe", device=str(device), rows=rows, L=L,
               ok=err == 0, max_abs_err=err, launches=launches,
               ms=(w[0] + w[3]) / 2, library_ms=(w[1] + w[2]) / 2,
               spread_ms=max(abs(w[0] - w[3]), abs(w[1] - w[2])),
               plain_ms=kernel_ms(device, lambda: lane_gather
                                  .lane_gather_ref(xd, ixd)),
               bytes=nbytes,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3
               if device.type == "cuda" else None)
    bound = f", bound {res['bound_ms']:.4f} ms ({nbytes} bytes)" \
        if res["bound_ms"] is not None else ""
    return _report(res, f"rows={rows} L={L}: max_abs_err {err} against the "
                   f"plain version, take_along_dim and numpy; in turns "
                   f"(P1, library, library, P1) "
                   f"{', '.join(f'{v:.4f}' for v in w)} ms: kernel "
                   f"{res['ms']:.4f} ms, take_along_dim "
                   f"{res['library_ms']:.4f} ms, spread "
                   f"{res['spread_ms']:.4f} ms; plain "
                   f"{res['plain_ms']:.4f} ms{bound}")


# ---------------------------------------------------------------------------
# HT: K1 and K4
# ---------------------------------------------------------------------------

def _ht_source(seed: int, w: int, h: int, nblocks: int):
    """The JAX tool's HT blocks (`_ht_jobs`, run_ht_enc): half the samples
    zero, magnitudes |N(0, 300)|, the first sample at least 3.  Returns
    mneg (nblocks, h, w) int32, magnitudes and negative masks."""
    rng = np.random.default_rng(seed)
    mags, negs = [], []
    for _ in range(nblocks):
        mag = np.abs(rng.normal(0, 300.0, (h, w))).astype(np.int64)
        mag[rng.random((h, w)) >= 0.5] = 0
        mag = np.minimum(mag, (1 << 24) - 1)
        neg = (rng.random((h, w)) < 0.5) & (mag > 0)
        mag[0, 0] = max(int(mag[0, 0]), 3)
        mags.append(mag)
        negs.append(neg)
    mag, neg = np.stack(mags), np.stack(negs)
    return ((mag << 1) | neg).astype(np.int32), mag, neg


def ht_caps(W: int, H: int, nbmax: int) -> tuple:
    """K4's stream capacities for W x H lanes of up to nbmax planes (the
    serving encode's rule, pipeline/serve_enc.py)."""
    nq = ((W + 1) // 2) * ((H + 1) // 2)
    return (ht_encode._cap_bytes(W * H * (nbmax + 2) // 8 + 16),
            ht_encode._cap_bytes(nq * 9 // 8 + 16),
            ht_encode._cap_bytes(nq * 15 // 8 + 16))


def ht_decode_inputs(mneg: torch.Tensor, wv: torch.Tensor, hv: torch.Tensor,
                     caps: tuple) -> tuple:
    """K4 -> the C wire assembly -> the C scan -> the decode's staging and
    un-stuffing: K1's lanes (ms, mel, vlc, p, w, h, valid) for the
    cleanup encodes of mneg's lanes, on mneg's device."""
    dev = mneg.device
    n = mneg.shape[0]
    zero = torch.zeros(n, dtype=torch.int32, device=dev)
    streams, bits = ht_encode.ht_encode_lanes(mneg, zero, wv, hv, zero + 1,
                                              *caps)
    buf = streams.cpu().numpy().reshape(-1)
    bits = bits.cpu().numpy().astype(np.int64)
    if (bits < 0).any():
        raise RuntimeError("K4: a stream exceeded its capacity")
    base = np.arange(n, dtype=np.int64) * sum(caps)
    res = native.ht_assemble_batch(buf, base, bits[0], base + caps[0],
                                   bits[1], base + caps[0] + caps[1],
                                   bits[2], np.where(bits[0] > 0, 0, -1))
    if res is None:
        raise RuntimeError("the C assembler refused K4's streams")
    wire, wlens = res
    coded = wlens > 0
    offs = np.cumsum(wlens) - wlens
    scan = native.ht_scan2(wire[:int(wlens.sum())].tobytes(), offs[coded],
                           wlens[coded])
    if scan is None or (scan[0][:, 0] < 0).any():
        raise RuntimeError("the C scan refused the assembled segments")
    sc = np.zeros((n, 7), np.int64)
    sc[coded], digest, _bits = scan
    body = torch.from_numpy(np.concatenate([digest, np.zeros(16, np.uint8)])
                            ).to(dev)
    m = torch.from_numpy(sc).to(dev)
    lms, lsuf, dm = stage_dims(sc)
    ms = stage_bytes(body, m[:, 1], m[:, 2], lms, False)
    suf_f = stage_bytes(body, m[:, 3], m[:, 4], lsuf, False)
    suf_r = stage_bytes(body, m[:, 3], m[:, 4] - 1, lsuf, True)
    mel, vlc = unstuff_suffix(suf_f, suf_r, dm)
    u8 = torch.uint8
    return (ms.to(u8), mel.to(u8), vlc.to(u8), zero, wv, hv,
            torch.from_numpy(coded.astype(np.int32)).to(dev))


def run_ht_dec(device, w: int = 32, h: int = 32, nblocks: int = 1024) -> dict:
    """K1 on blocks coded by the port's HT encoder: bit-exact to the
    source, to its plain version and to its first design on every lane;
    the two designs timed in turns."""
    device = torch.device(device)
    mneg, mag, neg = _ht_source(0, w, h, nblocks)
    wv, hv = _col([w] * nblocks, device), _col([h] * nblocks, device)
    nbmax = int(mag.max()).bit_length()
    lanes = ht_decode_inputs(torch.from_numpy(mneg).to(device), wv, hv,
                             ht_caps(w, h, nbmax))
    got, codes = ht_decode.ht_decode_lanes(*lanes, w, h)
    ref, rcodes = ht_decode.ht_decode_lanes_ref(*lanes, w, h)
    err = int((got.long() - ref.long()).abs().max())
    # intact lanes: no error code, as the plain version says
    codes_ok = torch.equal(codes, rcodes) and not bool(codes.any())
    v1 = torch.equal(got, ht_decode.ht_decode_lanes_v1(*lanes, w, h))
    g = got.cpu().numpy()
    exact = int(((np.abs(g) == 2 * mag) & ((g < 0) == neg)).all((1, 2))
                .sum())
    prev_ms, ms = turns_ms(
        device, lambda: ht_decode.ht_decode_lanes_v1(*lanes, w, h),
        lambda: ht_decode.ht_decode_lanes(*lanes, w, h))
    res = dict(check="ht_dec", device=str(device), blocks=nblocks,
               ok=err == 0 and exact == nblocks and v1 and codes_ok,
               max_abs_err=err,
               equal_to_v1=v1, ms=ms, prev_ms=prev_ms)
    res["mp_s"] = nblocks * w * h / 1e3 / res["ms"]
    return _report(res, f"{w}x{h}x{nblocks}: {exact}/{nblocks} bit-exact "
                   f"to the source, max_abs_err {err} against the plain "
                   f"version, every lane equal to v1={v1}, no lane "
                   f"flagged={codes_ok}; kernel "
                   f"{ms:.4f} ms/launch ({res['mp_s']:.1f} MP/s), v1 "
                   f"{prev_ms:.4f} ms/launch, in turns")


def ht_encodes_equal(got, ref, caps) -> bool:
    """Two ht_encode_lanes results agree: bit counts, the used bytes of
    every stream (caps: the capacities of all streams but the last) and,
    for K4r, ns."""
    return (torch.equal(got[1], ref[1])
            and torch.equal(ht_encode.clear_unused(got[0], got[1], *caps),
                            ht_encode.clear_unused(ref[0], ref[1], *caps))
            and all(torch.equal(a, b) for a, b in zip(got[2:], ref[2:])))


def run_ht_enc(device, w: int = 32, h: int = 32, nblocks: int = 1024) -> dict:
    """K4 against its plain version and its first design on every lane
    (used stream bytes and bit counts); the two designs timed in
    turns."""
    device = torch.device(device)
    mneg, mag, _neg = _ht_source(1, w, h, nblocks)
    caps = ht_caps(w, h, int(mag.max()).bit_length())
    n = nblocks
    lanes = (torch.from_numpy(mneg).to(device), _col([0] * n, device),
             _col([w] * n, device), _col([h] * n, device),
             _col([1] * n, device))
    got = ht_encode.ht_encode_lanes(*lanes, *caps)
    ref = ht_encode.ht_encode_lanes_ref(*lanes, *caps)
    used = ht_encode.clear_unused(*got, *caps[:2])
    err = max(int((used.int() - ref[0].int()).abs().max()),
              int((got[1] - ref[1]).abs().max()))
    v1 = ht_encodes_equal(got, ht_encode.ht_encode_lanes_v1(*lanes, *caps),
                          caps[:2])
    prev_ms, ms = turns_ms(
        device, lambda: ht_encode.ht_encode_lanes_v1(*lanes, *caps),
        lambda: ht_encode.ht_encode_lanes(*lanes, *caps))
    res = dict(check="ht_enc", device=str(device), blocks=n,
               ok=err == 0 and v1 and bool((got[1] >= 0).all()),
               max_abs_err=err, equal_to_v1=v1, ms=ms, prev_ms=prev_ms)
    res["mp_s"] = n * w * h / 1e3 / res["ms"]
    return _report(res, f"{w}x{h}x{n}: max_abs_err {err} against the plain "
                   f"version (used bytes, bit counts), every lane equal to "
                   f"v1={v1}; kernel {ms:.4f} ms/launch ({res['mp_s']:.1f} "
                   f"MP/s), v1 {prev_ms:.4f} ms/launch, in turns")


# ---------------------------------------------------------------------------
# Part-1: K3 and K5
# ---------------------------------------------------------------------------

def _mq_source(seed: int, w: int, h: int, nblocks: int):
    """The JAX tool's Part-1 blocks (run_mq_dec, run_mq_enc): 60% of the
    samples |N(0, 30)|, signs drawn everywhere.  Returns mneg (nblocks, h,
    w) int32 and the orientations."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(nblocks):
        mag = np.abs((rng.normal(0, 30, (h, w))
                      * (rng.random((h, w)) < 0.6))).astype(np.int64)
        neg = rng.random((h, w)) < 0.5
        out.append((mag << 1) | neg)
    return np.stack(out).astype(np.int32), [i % 4 for i in range(nblocks)]


def mq_encode_inputs(mneg: np.ndarray, orient: list, device) -> tuple:
    """K5's inputs (mneg, orient, numbps, w, h) and its capacities (L, R)
    for whole-lane blocks, on `device`."""
    n, h, w = mneg.shape
    nb = [int(m.max() >> 1).bit_length() for m in mneg]
    nbmax = max(nb + [1])
    L = ht_encode._cap_bytes(w * h * (nbmax + 1) // 2 + 64)
    return ((torch.from_numpy(np.ascontiguousarray(mneg)).to(device),
             _col(orient, device), _col(nb, device), _col([w] * n, device),
             _col([h] * n, device)), (L, max(3 * nbmax - 2, 1)))


def mq_decode_inputs(ins: tuple, out: torch.Tensor,
                     lens: torch.Tensor) -> tuple:
    """K3's lanes for K5's codewords (out, lens) of the lanes ins: one
    segment each, every pass."""
    _mneg, ori, nb, wv, hv = ins
    if (lens < 0).any():
        raise RuntimeError("K5: a codeword exceeded its capacity")
    n = lens.shape[0]
    body = torch.cat([out[j, 1:1 + int(lens[j])] for j in range(n)]
                     + [out.new_zeros(1)])
    start = (torch.cumsum(lens, 0) - lens).to(torch.int32)
    zero = torch.zeros_like(lens)
    ptbl = torch.stack([zero, lens, zero], 1)[:, None].contiguous()
    npass = (3 * nb - 2).clamp(min=0).to(torch.int32)
    return body, start, npass, nb, ori, wv, hv, zero, ptbl


def _edge(mneg: np.ndarray, orient: list, device, count: int = 16):
    """The first `count` lanes cut to EDGE_H rows: where the plain
    versions are held against the kernels."""
    return mq_encode_inputs(mneg[:count, :EDGE_H], orient[:count], device)


def run_mq_dec(device, w: int = 64, h: int = 64, nblocks: int = 128) -> dict:
    """K3 on blocks coded by the port's Part-1 encoder: the source comes
    back on every lane; against its plain version on the edge lanes;
    timed."""
    device = torch.device(device)
    mneg, orient = _mq_source(2, w, h, nblocks)
    ins, (L, R) = mq_encode_inputs(mneg, orient, device)
    out, lens, _rates, _st = t1_encode.t1_encode_lanes(*ins, L, R)
    lanes = mq_decode_inputs(ins, out, lens)
    dec = t1_decode.t1_decode_lanes(*lanes, w, h)
    got = dec.cpu().numpy()
    mag, neg = mneg >> 1, (mneg & 1).astype(bool)
    exact = int(((np.abs(got) >> 1 == mag) & ((got < 0) == (neg & (mag > 0))))
                .all((1, 2)).sum())
    e_ins, (eL, eR) = _edge(mneg, orient, device)
    e_out, e_lens, _r, _s = t1_encode.t1_encode_lanes(*e_ins, eL, eR)
    e_lanes = mq_decode_inputs(e_ins, e_out, e_lens)
    eh = e_ins[0].shape[1]
    err = int((t1_decode.t1_decode_lanes(*e_lanes, w, eh).long()
               - t1_decode.t1_decode_lanes_ref(*e_lanes, w, eh).long())
              .abs().max())
    v1 = torch.equal(t1_decode.t1_decode_lanes_v1(*lanes, w, h), dec)
    prev_ms, ms = turns_ms(
        device, lambda: t1_decode.t1_decode_lanes_v1(*lanes, w, h),
        lambda: t1_decode.t1_decode_lanes(*lanes, w, h))
    res = dict(check="mq_dec", device=str(device), blocks=nblocks,
               ok=err == 0 and exact == nblocks and v1, max_abs_err=err,
               equal_to_v1=v1, edge_lanes=e_lanes[1].shape[0], ms=ms,
               prev_ms=prev_ms)
    res["mp_s"] = nblocks * w * h / 1e3 / res["ms"]
    return _report(res, f"{w}x{h}x{nblocks}: {exact}/{nblocks} lanes give "
                   f"back the source, every lane equal to v1={v1}, "
                   f"max_abs_err {err} against the plain version on "
                   f"{res['edge_lanes']} lanes of {w}x{eh}; kernel "
                   f"{ms:.4f} ms/launch ({res['mp_s']:.1f} MP/s), v1 "
                   f"{prev_ms:.4f} ms/launch, in turns")


def run_mq_enc(device, w: int = 64, h: int = 64, nblocks: int = 128) -> dict:
    """K5: its codewords decode back to the source (K3) on every lane;
    against its plain version (lengths, used bytes, watermark rows,
    sigtype) on the edge lanes; timed."""
    device = torch.device(device)
    mneg, orient = _mq_source(3, w, h, nblocks)
    ins, (L, R) = mq_encode_inputs(mneg, orient, device)
    out, lens, _rates, _st = t1_encode.t1_encode_lanes(*ins, L, R)
    dec = t1_decode.t1_decode_lanes(*mq_decode_inputs(ins, out, lens), w,
                                    h).cpu().numpy()
    mag, neg = mneg >> 1, (mneg & 1).astype(bool)
    exact = int(((np.abs(dec) >> 1 == mag) & ((dec < 0) == (neg & (mag > 0))))
                .all((1, 2)).sum())
    e_ins, (eL, eR) = _edge(mneg, orient, device)
    got = t1_encode.t1_encode_lanes(*e_ins, eL, eR)
    ref = t1_encode.t1_encode_lanes_ref(*e_ins, eL, eR)
    used = torch.arange(eL, device=device)[None] <= got[1].long()[:, None]
    err = max(int((got[1] - ref[1]).abs().max()),
              int((torch.where(used, got[0].int(), 0)
                   - torch.where(used, ref[0].int(), 0)).abs().max()),
              int((got[2] - ref[2]).abs().max()),
              int((got[3].int() - ref[3].int()).abs().max()))
    v1 = encodes_equal((out, lens, _rates, _st),
                       t1_encode.t1_encode_lanes_v1(*ins, L, R))
    prev_ms, ms = turns_ms(
        device, lambda: t1_encode.t1_encode_lanes_v1(*ins, L, R),
        lambda: t1_encode.t1_encode_lanes(*ins, L, R))
    res = dict(check="mq_enc", device=str(device), blocks=nblocks,
               ok=err == 0 and exact == nblocks and v1, max_abs_err=err,
               equal_to_v1=v1, edge_lanes=e_ins[0].shape[0], ms=ms,
               prev_ms=prev_ms)
    res["mp_s"] = nblocks * w * h / 1e3 / res["ms"]
    return _report(res, f"{w}x{h}x{nblocks}: {exact}/{nblocks} codewords "
                   f"decode back to the source, every lane equal to "
                   f"v1={v1}, max_abs_err {err} against the plain version "
                   f"on {res['edge_lanes']} lanes of {w}x{e_ins[0].shape[1]}"
                   f"; kernel {ms:.4f} ms/launch ({res['mp_s']:.1f} MP/s), "
                   f"v1 {prev_ms:.4f} ms/launch, in turns")


# ---------------------------------------------------------------------------
# Serving paths
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def forced_ht_blocks():
    """Pad every other Part-1 codeword of the serving encode by 4096 bytes,
    so that HT wins those blocks of an HT-mixed encode (natural content
    picks Part-1 everywhere): the device of the JAX package's mixed
    tests.  The padded codewords lose, so no padding is emitted."""
    encode = serve_enc._encode_mq

    def fat_every_other(*args, **kw):
        encs = encode(*args, **kw)
        for e in encs[1::2]:
            if e.data:
                e.data = e.data + bytes(4096)
        return encs
    serve_enc._encode_mq = fat_every_other
    try:
        yield
    finally:
        serve_enc._encode_mq = encode


def _frame(img: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(img.astype(np.int32)).to(device)


def _small() -> np.ndarray:
    """The 128x96 frame of the card-against-CPU comparisons."""
    return synthetic_image(128, 96, 1, seed=60)


def ht_blocks(stream: bytes) -> int:
    """How many blocks an HT-mixed stream's COM bitmap names as HT."""
    hdr = j2k.read_main_header(stream)
    th = j2k.TileHeader()
    for p in j2k.read_tile_parts(stream, hdr):
        j2k.read_tile_part_header(stream, p, hdr, th)
    bm = th.ht_mixed_bitmap()
    return -1 if bm is None else sum(bin(b).count("1") for b in bm)


def _serve_encode(device, check: str, label: str, params, side: int,
                  n: int) -> dict:
    """One serving encode check: n + 1 calls (the first a warm-up) of
    api.compress_device on a side x side gray frame, every one the same
    bytes; the launch counts of those calls; on a card, a 128x96 encode
    equal to the CPU encode through the plain versions."""
    img = _frame(synthetic_image(side, side, 1, seed=7), device)
    zero_counts()
    outs, times = [], []
    for _ in range(n + 1):
        out, ms = _call_ms(device, lambda: api.compress_device(
            img, params, device=device))
        outs.append(out)
        times.append(ms)
    counts = launch_counts()
    same = all(o == outs[0] for o in outs)
    ref = None
    if device.type != "cpu":
        small = _small()
        ref = api.compress_device(small, params, device=device) == \
            api.compress_device(small, params, device="cpu")
    best = min(times[1:])
    res = dict(check=check, device=str(device), case=label,
               ok=same and ref is not False, reps_identical=same,
               cpu_reference=ref, bytes=len(outs[0]), ms=best,
               median_ms=float(np.median(times[1:])),
               mp_s=side * side / 1e3 / best, launches=counts)
    used = {k: v for k, v in counts.items() if v}
    return _report(res, f"{side}^2 {label}: {len(outs[0])} B, reps "
                   f"identical={same}, 128x96 equal to the CPU encode="
                   f"{ref}, best {best:.3f} ms/call ({res['mp_s']:.2f} "
                   f"MP/s), launches {used}")


def _serve_kw(cblk_exp: int) -> dict:
    return dict(num_resolutions=5, cblk_w_exp=cblk_exp, cblk_h_exp=cblk_exp)


def run_serve_mq_enc(device, side: int = 512, cblk_exp: int = 5,
                     n: int = 10) -> dict:
    """The Part-1 default-style serving encode (K5)."""
    return _serve_encode(torch.device(device), "serve_mq_enc", "Part-1",
                         CompressParams(**_serve_kw(cblk_exp)), side, n)


def run_serve_mq_enc_rt(device, side: int = 512, cblk_exp: int = 5,
                        n: int = 5) -> dict:
    """The rate-targeted (4:1) and 3-layer (16:1, 4:1, 1:1) Part-1
    serving encodes: K5, the per-pass distortions, the PCRD finish and its
    minimal-flush refinement (trial decodes with K3)."""
    device = torch.device(device)
    cases = []
    for extra in (dict(rates=[4.0]),
                  dict(num_layers=3, rates=[16.0, 4.0, 1.0])):
        cases.append(_serve_encode(
            device, "serve_mq_enc_rt", str(extra),
            CompressParams(**_serve_kw(cblk_exp), **extra), side, n))
    return dict(check="serve_mq_enc_rt", device=str(device),
                ok=all(c["ok"] for c in cases), cases=cases)


def run_serve_mixed_enc(device, side: int = 512, cblk_exp: int = 5,
                        n: int = 5) -> dict:
    """The HT-mixed serving encode (K4 and K5, the smaller codeword per
    block)."""
    return _serve_encode(torch.device(device), "serve_mixed_enc", "HT-mixed",
                         CompressParams(ht_mixed=True,
                                        **_serve_kw(cblk_exp)),
                         side, n)


def run_serve_mixed_dec(device, side: int = 512, cblk_exp: int = 5,
                        n: int = 10) -> dict:
    """The HT-mixed serving decode (api.decompress_device) of a natural
    stream and of a forced one whose bitmap names both HT and Part-1
    blocks: lossless, every rep the same; on a card, a 128x96 forced
    stream decoded equal to its CPU decode."""
    device = torch.device(device)
    params = CompressParams(ht_mixed=True, **_serve_kw(cblk_exp))
    src = synthetic_image(side, side, 1, seed=7)
    img = _frame(src, device)
    streams = {"natural": api.compress_device(img, params, device=device)}
    with forced_ht_blocks():
        streams["forced"] = api.compress_device(img, params, device=device)
    cases = []
    for label, s in streams.items():
        zero_counts()
        outs, times = [], []
        for _ in range(n + 1):
            out, ms = _call_ms(device, lambda: api.decompress_device(
                s, device=device))
            outs.append(out[0].cpu().numpy())
            times.append(ms)
        counts = launch_counts()
        lossless = all(np.array_equal(o, src) for o in outs)
        best = min(times[1:])
        cases.append(dict(case=label, ok=lossless, bytes=len(s), ms=best,
                          median_ms=float(np.median(times[1:])),
                          mp_s=side * side / 1e3 / best, launches=counts))
        used = {k: v for k, v in counts.items() if v}
        print(f"serve_mixed_dec {label} {side}^2 ({len(s)} B): every rep "
              f"lossless={lossless}, best {best:.3f} ms/call "
              f"({cases[-1]['mp_s']:.2f} MP/s), launches {used} "
              f"[{device}]", flush=True)
    ref = None
    if device.type != "cpu":
        small = _small()
        with forced_ht_blocks():
            s = api.compress_device(small, params, device=device)
        ref = all(np.array_equal(a.cpu().numpy(), b.numpy()) for a, b in zip(
            api.decompress_device(s, device=device),
            api.decompress_device(s, device="cpu")))
    nht = {label: ht_blocks(s) for label, s in streams.items()}
    # the forced stream's blocks go through both decoders (only kernels
    # count their launches: none on the CPU)
    both = nht["forced"] > 0 and (device.type != "cuda" or (
        cases[1]["launches"]["K1"] > 0 and cases[1]["launches"]["K3"] > 0))
    res = dict(check="serve_mixed_dec", device=str(device),
               ok=all(c["ok"] for c in cases) and ref is not False and both,
               cpu_reference=ref, ht_blocks=nht, cases=cases)
    return _report(res, f"{side}^2: HT blocks in the bitmaps {nht}, forced "
                   f"stream through both decoders={both}, 128x96 equal to "
                   f"the CPU decode={ref}")


def run(check: str, device, **kw) -> list:
    """Run one check at the given (or, on the CPU, the small) sizes;
    returns its result dicts (gather_probe: one per row count)."""
    device = torch.device(device)
    args = dict(SMALL[check]) if device.type == "cpu" else {}
    args.update(kw)
    if check == "gather_probe":
        rows = args.pop("rows", GATHER_ROWS)
        return [run_gather_probe(device, rows=r, **args) for r in rows]
    return [globals()[f"run_{check}"](device, **args)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m grok_tpu_torch.tools.hw_validate",
        description="Validate and time the port's kernels and serving "
                    "paths on a card (or, at small sizes, on the CPU).")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("checks", nargs="*", metavar="check",
                    help=f"any of {', '.join(CHECKS)} (default: all)")
    args = ap.parse_args(argv)
    bad = [c for c in args.checks if c not in CHECKS]
    if bad:
        ap.error(f"unknown checks {bad}; choose from {list(CHECKS)}")
    print(f"card: {card()}", flush=True)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("hw_validate: CUDA is not available; --device cpu runs the "
              "plain versions", file=sys.stderr)
        return 2
    failed = []
    for check in args.checks or CHECKS:
        t0 = time.perf_counter()
        if not all(r["ok"] for r in run(check, device)):
            failed.append(check)
        print(f"  [{check} total {time.perf_counter() - t0:.1f} s]",
              flush=True)
    if failed:
        print(f"hw_validate: FAILED {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
