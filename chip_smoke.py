#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main paths on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

  1. device  — print the card's name and power limit; require CUDA.
  2. build   — build the CUDA kernels (one nvcc per csrc/*.cu, started
               together) and the host C runtime from the checkout.
  3. encode  — the main encode paths, grok_tpu_torch.api.
               compress_device_batch on the card, each path with the
               launch counts set to 0 before it and read after it:
               HT (K4): (A) 8 frames of 512x512 8-bit gray, 5
               resolutions, 32x32 code-blocks; (B) one 1920x1080 8-bit
               RGB frame, lossless RCT + 5/3, 6 resolutions, 64x64
               code-blocks;
               Part-1 (K5): (A1) and (B1), the same frames and settings
               with Part-1 default-style code-blocks;
               HT-mixed (K4 + K5): (A-mix), the (A) frames with
               ht_mixed (on this content the Part-1 codeword is the
               smaller for every block, so the bitmap names no HT block),
               and (A-mix forced), the same encode with every other
               block's Part-1 codeword padded so that HT wins it (the
               device of grok_tpu's tests/test_ht_mixed.py), whose bitmap
               must mark both HT and Part-1 blocks;
               refined HT (K4r): (A-r), the (A) frames with ht_planes=1;
               (B-r), the (B) frame with ht_planes=2 in 3 layers at
               byte-rate targets 40:1, 10:1 and 4:1 (the PCRD finish);
               Part-1 targeted (K5, and K3 for the trial decodes of the
               minimal-flush truncation refinement): (A1-t), the (A1)
               frames in one layer at 4:1; (B1-t), the (B1) frame in 3
               layers at 40:1, 10:1 and 4:1.
               The inputs are made by the port's synthetic_image and
               uploaded first (set-up).  Every rep must give the same
               bytes, and small HT, Part-1, refined, layered and targeted
               Part-1 encodes on the card must equal the same encodes
               through the plain versions on the CPU.  Each (B-r) and
               (B1-t) layer prefix must keep to its byte budget, and the
               refinement must shrink at least one (A1-t) block.  The
               served paths must launch neither K4r nor K2, the refined
               one neither K4 nor K5, the targeted Part-1 one none of K1,
               K2, K4 and K4r.
  4. decode  — the main decode paths, decompress_device_batch on the card
               over the streams of phase 3, counts reset and read the
               same way per path (HT: K1, Part-1 and Part-1 targeted: K3,
               HT-mixed: K1 + K3, refined HT: K2 and K1 through the
               general route, stream by stream); every lossless output
               must equal its source bit for bit; (A-r) and (A1-t) must
               equal their decodes through the plain versions on the CPU
               (ht_planes=1 drops plane-0 samples that have no
               significant neighbour, so (A-r) is within 1 of the source,
               not lossless); (B-r) and (B1-t) decoded at 1, 2 and 3
               layers must rise in PSNR with every layer, 3 layers equal
               to the full decode.  Then each cell's host staging and its
               synced device part (the served device program, or the
               general route's block decodes and synthesis), on the HT
               cells with the HT decoders' first designs in turns (v1,
               v2, v2, v1; best and median of 5).
  5. K4      — the HT cleanup encoder (one warp per code-block) against
               its first design (ht_encode_lanes_v1, one thread per
               code-block, the full-lane oracle) and against its plain
               version on every lane of (A) and (B): byte-identical used
               stream bytes and bit counts; the two designs timed in
               turns (v1, v2, v2, v1), the plain version once; for (B),
               the launch of the slowest lane alone (largest w * h, then
               most stream bits) against all lanes.
  6. K4->K1  — 64 synthetic lanes of 1x1 to 64x64 encoded by K4,
               assembled and scanned by the port's C runtime, staged and
               un-stuffed as the decode does, decoded by K1: the source
               magnitudes and signs must come back.
  7. K1      — the HT cleanup decoder (one warp per code-block) on every
               staged lane of the decode path's (A) and (B) buckets
               against its first design (ht_decode_lanes_v1, one thread
               per code-block, the full-lane oracle) and its plain
               version: bit-exact; the two designs timed in turns per
               bucket (its lane count printed), the plain version once;
               for (B), the slowest lane alone (largest w * h, then most
               MagSgn bytes) against its bucket's launch.
  8. K5      — the Part-1 encoder (one warp per code-block) against its
               first design (t1_encode_lanes_v1, one thread per
               code-block, the full-lane oracle) on every lane of (A1)
               and (B1), and against its plain version on every lane of
               (A1) and on the bottom-edge lanes of (B1) (h <= 8: the
               plain version steps all lanes in lockstep, so its time
               follows the lanes' size, not their count): identical
               lengths, used bytes, watermark rows and sigtype; the two
               designs timed in turns (v1, v2, v2, v1) on all lanes and on
               the compared lanes, the plain version on the compared
               lanes (on the host's CPU, in a worker process beside the
               card's work, checked before the kernels line); for (B1),
               the launch of the slowest lane alone (largest nbps * w * h)
               against all lanes, and the bound of all lanes.
  9. K3      — the Part-1 decoder against its first design on every staged
               lane of the decode path's (A1) and (B1) blocks and against
               its plain version on the same lanes as phase 8 (on the
               host's CPU, as there): bit-exact; timed as phase 8 (the
               slowest lane by npass * w * h),
               with the bound of all (B1) lanes.
 10. K5->K3  — 64 synthetic lanes of 1x1 to 64x64 (h not a multiple of
               4, w = 1, all-zero lanes, up to 16 planes) encoded by K5
               and decoded by K3: the source must come back.
 11. vectors — K3 on the committed Part-1 mode-switch vectors
               (grok_tpu_torch/t1/mq_vectors.npz: BYPASS, RESET,
               TERMALL, VSC, PTERM, SEGSYM) against the scalar decodes
               stored with them and against its plain version.
 12. K4r     — the refined HT encoder against its first design on every
               lane of (A-r) and (B-r), timed in turns, with the all-lane
               bound, and against its plain version on every lane of
               (A-r) and on the bottom-edge lanes of (B-r) (cut to EDGE_H
               rows as in phase 8): byte-identical used bytes of all five
               streams, bit counts and SigProp significance maps; the two
               designs timed in turns on the compared lanes, the plain
               version once.
 13. K2      — the refined HT decoder against its first design and its
               plain version on the general route's staged lanes: every
               refined lane of (A-r)'s first frame and of the full-layer
               (B-r) decode, and every lane (K1 and K2) of (B-r)'s
               bottom-edge buckets (H <= EDGE_H); bit-exact; the two
               designs timed in turns on each refined launch (its lane
               count printed), the plain version once.
 14. K4r->K2 — 64 synthetic lanes of 1x1 to 64x64 (w = 1, h not a
               multiple of 4, all-zero lanes) at cleanup planes 1..3
               encoded by K4r, wire-assembled, raw-stuffed, scanned and
               un-stuffed by the port's C runtime, staged as the general
               route does and decoded by K2: equal to the plain version,
               every cleanup-significant sample exact to plane p - 1 and
               every SigProp sample at its plane-(p - 1) value.
 15. P1      — the per-lane gather through the hardware-validation tool
               (grok_tpu_torch/tools/hw_validate.py run_gather_probe) at
               64 and 65536 rows of 128 lanes: equal to its plain version
               and to torch.take_along_dim; P1 and take_along_dim timed
               in turns (P1, library, library, P1) with their spread, the
               plain version once; the bound counts x and idx read once
               and out written once, 12 bytes an element.
 16. K3 trial — K3 on the refinement's trial-decode lanes of (A1-t)'s
               first frame (32x32 blocks, so every lane whole) against its
               first design and its plain version (on the host's CPU, as
               phase 8): bit-exact; the two designs timed in turns on all
               lanes and on the slowest lane alone, the plain version
               once.
 17. tool    — the tool's serve_mq_enc_rt: the 512x512 Part-1 encode at
               4:1 and in 3 layers at 16:1, 4:1 and 1:1, every rep the
               same bytes, a 128x96 encode equal to the CPU encode.
 18. mq_dec, mq_enc — the tool's K3 and K5 checks on 128 dense 64x64
               blocks: the source comes back, every lane equal to the
               first design, the plain versions on edge lanes, the two
               designs timed in turns.

 19. tiled   — (C) one 3840x2160 8-bit RGB frame, HT lossless RCT + 5/3,
               6 resolutions, 64x64 code-blocks, in 1024x1024 tiles (12
               tiles, the edge tiles 768 wide and 112 tall), and (C1) the
               same in Part-1 default style: encoded on the card (one K4
               or K5 launch per tile, counted per tile) and decoded back
               bit-exact to the source (K1 per tile and bucket, or one
               K3 launch per tile); every rep the same bytes; a 200x136
               RGB encode in 64-px tiles equal to the CPU encode; best and
               median of 5 calls, the host and synced-device split.
 20. windows — (C-win) a 1024x1024 window at (1000, 700) on (C), which
               meets tiles 0, 1, 4 and 5 only (the others launch
               nothing); (B-win) and (B-r-win) a 512x512 window at (333,
               211) on (B) (served) and (B-r) (general route): equal to
               the source, or to (B-r)'s full decode, inside the window;
               the live lane count beside the whole decode's.
 21. M       — the committed general-route codestreams (grok_tpu_torch/
               util/stream_vectors.npz: 1080p Part-1 0x3F and BYPASS in 2
               layers, a 512x512 layered HT-mixed set) decoded on the card
               at each layer cap to their committed plane hashes, with
               their K3 (and K1) launches; K3 on every general-route lane
               against its first design, timed in turns, and on the
               bottom-edge lanes against its plain version.
 22. T, P, R — the committed damaged, packed-header and ROI streams
               (grok_tpu_torch/util/damaged_vectors.npz and the (M)
               streams, edited by util/stream_edit.py) decoded through
               decompress_device on the card to their committed plane
               hashes: (T-m1) m1 cut at 50% and 80%, whole and at
               max_layers=1, (T-m2) m2 cut at 50%, (T-mix) mmix cut at
               80%, (T-h) a 1080p HT frame cut at 50% and 80%, (P) a
               1080p Part-1 frame with PPM, its PPT twin, and an SOP + EPH
               twin with a mid-stream SOP marker inverted, (R) a 1080p HT
               frame in 1024x1024 tiles with a Maxshift ROI and tile
               COC/QCC/POC, whole and in the ROI's 512x512 window; each
               with its K3/K1 launches per decode, the call time and the
               host split with the Python Tier-2 parse apart; K3 on each
               stream's bottom-edge lanes and K1 on its flattest bucket
               against their plain versions, and every HT lane zeroed for
               a cut cleanup segment all zero from K1.
 23. W, S    — code-blocks over 64 on a side and strict decodes: the
               committed 1080p streams of grok_tpu_torch/util/
               wide_vectors.npz decoded through decompress_device to their
               committed plane hashes, 3 calls after a warm-up: (W-h) HT
               in 1024x4 blocks at 24:1 and the lossless 32-line slice in
               the same blocks (served, K1; every 1024x4 block coded),
               (W-r) HT ht_planes=2 in 256x16 blocks, 2 layers, at
               max_layers 1 and 2 (the general route, K2), (W-1) Part-1
               in 128x32 blocks (served, K3), (W-1s) Part-1 style 0x3F in
               16x256 blocks, 2 layers, at max_layers 1 and 2 (general,
               K3), (W-win) a 512x512 window at (333, 211) on (W-h) and
               (W-1), and (S) the (T-h) HT frame with a byte of 24 blocks'
               codewords zeroed (hbad; with random bytes, hbad_rand, whose
               lanes of magnitudes of 2^31 or more are marked and
               re-decoded in int64, held to the JAX package's hash as
               well).  The warm-up decode's own
               K1, K2 and K3 launches are recorded: their error codes zero
               on every lane of an intact stream, flagged lanes all zero
               and held against the plain version, and on each wide shape
               the largest lane and up to 15 of the smallest held against
               the plain version in the bucket's dims, padding and error
               codes included; the wide launches are then timed over the
               bucket.  Then (S) the strict decodes: m1 and (W-h) give
               their committed planes, hbad and each damaged (T) and (P)
               stream raise the exception the JAX package's strict device
               decode raised (type and message, committed with the
               hashes).
  24. E       — the general encode on the card through compress_device,
               a warm-up and 3 calls each (every rep the same bytes), with
               the host split of one more: (E-dci) a digital-cinema 2K
               frame (2048x1080, 12-bit, 9/7 + ICT, 6 resolutions, 32x32
               Part-1 blocks, precincts 2^7 at r = 0 and 2^8 above, CPRL,
               three tile-parts with TLM, one layer at 8:1, CINEMA_2K; K5,
               the PCRD finish and the refinement's K3 trial decodes),
               under the 1,302,083-byte ceiling, its layout read back,
               decoded on the card against the source (PSNR) and, at
               reduce 5, against the plain versions' CPU decode (within
               1); (E-lay) the (B) frame in the committed layouts
               of grok_tpu_torch/util/enc_vectors.npz (HT with precincts,
               POC, 3 tile-parts, TLM and PLM; Part-1 with precincts and
               PPM; Part-1 in 3 quality layers), equal to the committed
               bytes; (E-w) the sources of wide_vectors.npz's whl, wh, wr
               and w1 in code-blocks over 64 on a side, equal to the
               committed bytes, the warm-up encode's own K4, K4r and K5
               launches recorded and on each wide shape the largest lane
               and up to 15 of the smallest held against the plain
               version in the bucket's dims, then each wide launch timed.
  25. E-ms    — mode switches, layered HT-mixed, ROI and a custom MCT on
               the card through compress_device, a warm-up and 3 calls
               each (every rep the same bytes), on the (B) frame: (ms_3f)
               Part-1 lossless with all six mode switches, (ms_byp)
               BYPASS in 3 layers at 24:1, (mix_lay) HT-mixed in 3
               layers at 24:1, (roi) Part-1 lossless with a centred 640 x
               360 Maxshift ROI, each equal to its committed stream of
               grok_tpu_torch/util/enc_vectors.npz (the lossless ones to
               their SHA-256), every styled K5 launch of the warm-ups
               timed in turns with the same lanes in the default style
               and held, on its largest lane and up to 15 of its
               smallest, against the plain version (run on the host's
               CPU in worker processes beside the card's work); then a
               custom-MCT HT encode of the frame (the same bytes every
               rep) and of a 64x96 RGB input, equal to the plain
               versions' encode on the CPU.
  26. HT-sw   — HT code-blocks with Part-1 mode switches: the (B) and
               (B-r) streams with their COD style OR'd with 0x3F and with
               each single switch (grok_tpu_torch/util/stream_edit.py
               or_cod_style), each decoded on the card equal to the
               unedited stream's decode, through K1 (served) and K2 (the
               general route).
  27. G       — the mesh (grok_tpu_torch/parallel): (G) one 8192x8192
               8-bit gray frame in one tile, Part-1 lossless 5/3, 6
               resolutions, 64x64 blocks (16,384 lanes), and (G-97) its
               4096x4096 crop in 9/7 at 20:1 and 8:1 in 2 layers (the
               PCRD bisection), each encoded and decoded through
               compress_device / decompress_device without a mesh and
               over Mesh(("cuda:0",) * 4) (and every visible card where
               there are several; on one card, printed as not run): the
               same bytes and planes meshed and unmeshed, (G) the source
               bit for bit, K5 and K3 launched once a shard (once a call
               unmeshed), a warm-up and 3 calls each, best and median;
               each shard's K5 and K3 launch of (G) timed with its bound;
               the finest 8192x8192 synthesis level sharded and
               unsharded, timed and equal (grok_tpu_torch/tools/
               mesh_probe.py giant_tile and finest_level); the PCRD slope
               collective over the 4 shards equal to the host's bracket;
               then dryrun_multichip(4) on virtual shards.
  28. C-dist  — two worker processes on cuda:0 over Gloo (an ephemeral
               127.0.0.1 port, a timeout on every wait):
               compress_distributed and decompress_distributed of (C)
               and (C1) with TLM; process 0's bytes equal to
               compress_device's, its canvases to decompress_device's
               and the source; best of 3 calls after a warm-up against
               the single process's.

  29. X, D24  — mixed filters and encodes past 24 planes: (X) the
               committed 1080p RGB streams of grok_tpu_torch/util/
               mixed_vectors.npz (component 1 on the 9/7, 0 and 2 on the
               5/3, Part-1 and HT at 24:1) decoded served and on the
               general route, whole and in a 512x512 window, the 5/3
               planes to their committed hashes, the 9/7 plane within 1
               of the JAX package's decode, a warm-up and 2 calls each;
               (D24) a 1920x1080 24-bit gray frame (the seed's frame
               spread to 24 bits, with a 256x512 region of full-range
               noise) encoded on the card lossless in HT and Part-1
               (decoded back bit for bit) and in HT, Part-1 and refined HT
               in 3 layers at 40:1, 10:1, 4:1 (every layer prefix within
               its budget, PSNR rising), a warm-up and 2 calls each; the
               warm-up's own K4 and K4r launches held, on their largest
               lane past 24 planes and the 15 smallest, against the plain
               versions, and every launch timed with its bound; 64x64
               crops of the noise (16x16 blocks; HT on the 5/3 and on
               the 9/7, whose transforms run in float64 past 24 planes)
               equal to the plain versions' CPU encode, the crop's K5
               launch held on its largest lane past 24 planes and the 15
               smallest (the plain K5 takes minutes on a 64x64 lane of 27
               planes).
  30. C-stream — (C) written tile by tile by codec.py Compressor to a
               temporary file: equal to compress_device_batch, and again
               after a stop at 4 tiles and a resume; Decompressor's tiles
               equal to the decompress_device canvas, whole and in a
               1024x1024 window, decompress() the source.
  31. CLI     — grok_tpu_torch.cli compress -> dump -> decompress through
               main(argv) on a 1920x1080 PPM (HT) and a 1920x1080 24-bit
               PGX (Part-1, JP2) in a temporary folder: the decoded file
               equal to the source.
  32. subsampled — grok_tpu_torch.compress of the frames of
               grok_tpu_torch/util/sub_vectors.py on the card: (Y422) the
               (B) frame in BT.709 10-bit Y'CbCr 4:2:2, HT lossless and
               Part-1 9/7 at 8:1; (Y420) 8-bit 4:2:0, Part-1 lossless and
               HT in 3 layers at 40:1, 10:1, 4:1; (RGBD) (B)'s RGB beside
               a 16-bit signed plane, HT and Part-1 lossless; (C420) the
               (C) frame in 4:2:0 at (1, 1) on the canvas, HT lossless in
               1024x1024 tiles.  Each a warm-up and 3 timed calls (the
               host split of the last), every call the same bytes, the
               launches per encode; lossless ones decoded back to the
               source and, where untargeted, equal to the committed
               SHA-256 of grok_tpu.compress's bytes; lossy ones with the
               warm-up's K4, K5 and K3 trial-decode launches held on their
               largest lane and the 15 smallest against the plain
               versions (K5's and K3's on the host's CPU, in phase 8's
               worker processes beside the card's work), every layer prefix
               within its budget and a 32x32 crop encoded
               and decoded on the card equal to the plain versions' on
               the CPU (the decode within 1); (C420) decoded in a
               1024x1024 window, and written by Compressor tile by tile
               to compress's bytes.

The last three lines of stdout are the card's name and power limit, a
JSON line of per-kernel results, and the JSON result line.  No JAX and
nothing of the JAX package is imported: a finder installed first refuses
jax, jaxlib and grok_tpu.
"""

from __future__ import annotations

import contextlib
import importlib.abc
import json
import os
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np

REPS = 5                 # end-to-end reps after a warm-up; best reported
REPS_DMG = 3             # the same for phase 22's 13 decodes
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 peak bandwidth
EDGE_H = 8               # (B1), (B-r) lanes held against the plain versions
G_SIDE = 8192            # phase 27's giant tile (G)
G_REPS = 3               # timed calls after a warm-up in phases 27, 28
DIST_TIMEOUT_S = 600     # phase 28's wait on each worker process
# phase 28's worker: process `rank` of 2 on cuda:0, over Gloo on `port`;
# (C-dist) and (C1-dist) encoded and decoded reps + 1 times, process 0
# writing its bytes and canvases under `out`; prints its best times
_DIST_WORKER = r"""
import json, sys, time
rank, port, out, reps = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                         int(sys.argv[4]))
import numpy as np
import torch
from grok_tpu_torch.core.params import CompressParams
from grok_tpu_torch.parallel.distributed import (
    compress_distributed, decompress_distributed, gather_bytes_to_host0,
    init_distributed, shutdown_distributed)
from grok_tpu_torch.util.synth import synthetic_image
try:
    got = init_distributed(f"127.0.0.1:{port}", 2, rank, timeout=300)
    assert got == (rank, 2), got
    dev = torch.device("cuda", 0)
    uhd = synthetic_image(2160, 3840, 3, seed=9)
    pt = dict(num_resolutions=6, tile_w=1024, tile_h=1024, write_tlm=True)
    best = {}
    for name, p in (("C", CompressParams(ht=True, **pt)),
                    ("C1", CompressParams(**pt))):
        enc_t, dec_t = [], []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            data = compress_distributed(uhd, p, device=dev)
            torch.cuda.synchronize()
            enc_t.append(time.perf_counter() - t0)
            data = gather_bytes_to_host0(data if rank == 0 else b"")[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            planes = decompress_distributed(data, device=dev)
            torch.cuda.synchronize()
            dec_t.append(time.perf_counter() - t0)
        best[name] = (min(enc_t[1:]), min(dec_t[1:]))
        if rank == 0:
            with open(f"{out}/{name}.j2k", "wb") as f:
                f.write(data)
            np.save(f"{out}/{name}.npy",
                    torch.stack(planes, -1).cpu().numpy())
        else:
            assert planes is None
    assert not [m for m in sys.modules if m in ("jax", "grok_tpu")
                or m.startswith(("jax.", "grok_tpu."))]
    print(json.dumps(best), flush=True)
finally:
    shutdown_distributed()
"""
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


def _k5_bytes(ins, lens, tables) -> int:
    """Bytes the Part-1 encode must move: each lane's w*h int32 samples
    and four int32 parameters read, the tables read once; the sentinel
    and the used codeword bytes, the length, the watermark rows the lane
    reaches and its w*h int8 sigtype written.  Padding and unused
    capacity are not counted."""
    _mneg, _ori, nb, w, h = ins
    area = int((w.long() * h.long()).sum())
    rows = int((3 * nb.long() - 2).clamp(min=0).sum())
    nl = nb.shape[0]
    return 4 * area + 16 * nl + _nbytes(*tables) \
        + int(lens.long().sum()) + nl + 4 * nl + 4 * rows + area


def _k3_bytes(lanes, tables) -> int:
    """Bytes the Part-1 decode must move: each lane's used codeword bytes
    (up to the end of its last segment), its seven int32 parameters and
    its segment table read, the tables read once, and each lane's w*h
    int32 samples written."""
    _body, _start, npass, _nb, _o, w, h, _st, ptbl = lanes
    live = (npass > 0).long()
    used = int((ptbl[:, :, 1].amax(1).long() * live).sum())
    nl = w.shape[0]
    return used + 28 * nl + _nbytes(ptbl) + _nbytes(*tables) \
        + 4 * int((w.long() * h.long()).sum())


def _plain_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _host_split(serve_enc, tile, call) -> dict:
    """Seconds of the C wire assembly, the Tier-2 finish and, inside the
    finish, the Part-1 truncation refinement (its trial decodes run on the
    card and are waited for) in one encode call (wrapped for this call
    only), and the call's own."""
    spent = {"assemble": 0.0, "finish": 0.0, "refine": 0.0}
    orig = (serve_enc.native.ht_assemble_batch, serve_enc.finish_tile_encode,
            tile._refine_truncations)

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
    tile._refine_truncations = timed_as("refine", orig[2])
    try:
        spent["call"] = call()
    finally:
        (serve_enc.native.ht_assemble_batch, serve_enc.finish_tile_encode,
         tile._refine_truncations) = orig
    return spent


def _synthetic_lanes(rng, n: int, side: int, sigma_exp: float):
    """n lanes of 1x1 to side x side (lane 0 1x1, lane 1 w = 1, lane 2
    all zero, heights not a multiple of 4 among the rest) as mneg
    (n, side, side) int32, with their sizes and source planes."""
    mneg = np.zeros((n, side, side), np.int32)
    mags, negs, dims = [], [], []
    for i in range(n):
        w = 1 + (i * 37) % side if i else 1
        h = 1 + (i * 23) % side if i else 1
        if i == 1:
            w = 1
        sigma = float(10 ** rng.uniform(0, sigma_exp))
        mag = np.abs(rng.normal(0, sigma, (h, w))).astype(np.int64)
        mag[rng.random((h, w)) < 0.4] = 0
        if i == 2:
            mag[:] = 0
        else:
            mag[0, 0] = max(int(mag[0, 0]), 1)
        neg = rng.random((h, w)) < 0.5
        mneg[i, :h, :w] = (mag << 1) | neg
        mags.append(mag)
        negs.append(neg & (mag > 0))
        dims.append((w, h))
    return mneg, mags, negs, dims


def _synthetic_roundtrip(torch, dev, ht_decode, hw_validate):
    """Phase 6: K4 -> C assembly -> C scan -> device un-stuff -> K1
    (hw_validate.ht_decode_inputs, the path of the tool's ht_dec)."""
    n, side = 64, 64
    mneg, mags, negs, dims = _synthetic_lanes(np.random.default_rng(7), n,
                                              side, 3.5)

    def col(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    lanes = hw_validate.ht_decode_inputs(
        torch.from_numpy(mneg).to(dev), col([d[0] for d in dims]),
        col([d[1] for d in dims]), (side * side * 28 // 8 + 64, 1024, 2048))
    got = ht_decode.ht_decode_lanes(*lanes, side, side)[0].cpu().numpy()
    for j, ((w, h), mag, neg) in enumerate(zip(dims, mags, negs)):
        v = got[j, :h, :w]
        if not (np.array_equal(np.abs(v), 2 * mag)
                and np.array_equal(v < 0, neg)):
            _fail(f"K4 -> K1 round trip differs on synthetic lane {j} "
                  f"({w}x{h})")
    print(f"K4 -> K1 round trip: {n} synthetic lanes of 1x1 to "
          f"{side}x{side} give back their magnitudes and signs", flush=True)


def _mq_roundtrip(torch, dev, t1_encode, t1_decode, hw_validate):
    """Phase 10: K5 -> K3 on synthetic lanes, up to 16 planes (the K3
    lanes staged by hw_validate.mq_decode_inputs)."""
    n, side = 64, 64
    mneg, mags, negs, dims = _synthetic_lanes(np.random.default_rng(9), n,
                                              side, 4.0)
    nb = [int(m.max()).bit_length() if m.size else 0 for m in mags]
    if max(nb) > 16:
        _fail("K5 -> K3 round trip: synthetic lanes over 16 planes")

    def col(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    ins = (torch.from_numpy(mneg).to(dev), col([i % 4 for i in range(n)]),
           col(nb), col([d[0] for d in dims]), col([d[1] for d in dims]))
    out, lens, _rates, _st = t1_encode.t1_encode_lanes(
        *ins, side * side * 8 + 64, 3 * 16 - 2)
    got = t1_decode.t1_decode_lanes(
        *hw_validate.mq_decode_inputs(ins, out, lens), side,
        side).cpu().numpy()
    for j, ((wj, hj), mag, neg) in enumerate(zip(dims, mags, negs)):
        v = got[j, :hj, :wj]
        if not (np.array_equal(np.abs(v) >> 1, mag)
                and np.array_equal(v < 0, neg)):
            _fail(f"K5 -> K3 round trip differs on synthetic lane {j} "
                  f"({wj}x{hj})")
    print(f"K5 -> K3 round trip: {n} synthetic lanes of 1x1 to "
          f"{side}x{side}, up to {max(nb)} planes, give back their "
          f"magnitudes and signs", flush=True)


def _k4r_bytes(lanes, bits, lut) -> int:
    """Bytes the refined HT encode must move: as the cleanup's
    (_k4_bytes) for the five streams and their five bit counts, plus
    each valid lane's w*h uint8 SigProp significance map written."""
    mneg, _p, w, h, valid = lanes
    v = (valid == 1).long()
    area = int((w.long() * h.long() * v).sum())
    words = 4 * int(((bits.long().clamp(min=0) + 31) >> 5).sum())
    nl = mneg.shape[0]
    return 5 * area + 16 * nl + _nbytes(lut) + words + 20 * nl


def _k2_bytes(meta, lanes, lut) -> int:
    """Bytes the refined HT decode must move on its lanes: each lane's
    used MagSgn, cleanup suffix, SigProp and MagRef bytes (as the host
    staging measured them) and its five int32 parameters read, the LUT
    read once, and each lane's w*h int32 samples written."""
    w, h = lanes[6], lanes[7]
    used = int(meta[:, [1, 3, 5, 7]].sum())
    return used + 20 * w.shape[0] + _nbytes(lut) \
        + 4 * int((w.long() * h.long()).sum())


def _refine_roundtrip(torch, dev, K):
    """Phase 14: K4r -> C assembly and raw stuffing -> C scan and
    un-stuffing -> device staging -> K2."""
    ht_encode, ht_decode, native, stage_bytes, unstuff_suffix, stage_dims = K
    n, side = 64, 64
    mneg, mags, negs, dims = _synthetic_lanes(np.random.default_rng(11), n,
                                              side, 3.5)
    nb = [int(m.max()).bit_length() if m.size else 0 for m in mags]
    pv = [min(1 + i % 3, max(b - 1, 0)) for i, b in enumerate(nb)]

    def col(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    caps = (side * side * 28 // 8 + 64, 1024, 2048)
    lsp, lmr = ht_encode.refine_caps(side, side)
    w, h = col([d[0] for d in dims]), col([d[1] for d in dims])
    streams, bits, _ns = ht_encode.ht_encode_lanes(
        torch.from_numpy(mneg).to(dev), col(pv), w, h, col([1] * n), *caps,
        refine=True)
    buf = streams.cpu().numpy().reshape(-1)
    bits = bits.cpu().numpy().astype(np.int64)
    if (bits < 0).any():
        _fail("K4r round trip: a stream exceeded its capacity")
    row = sum(caps) + lsp + lmr
    base = np.arange(n, dtype=np.int64) * row
    res = native.ht_assemble_batch(buf, base, bits[0], base + caps[0],
                                   bits[1], base + caps[0] + caps[1],
                                   bits[2], np.where(bits[0] > 0, 0, -1))
    if res is None:
        _fail("K4r round trip: the C assembler refused the streams")
    wire, wlens = res
    coded = wlens > 0
    offs = np.cumsum(wlens) - wlens
    scan = native.ht_scan2(wire[:int(wlens.sum())].tobytes(), offs[coded],
                           wlens[coded])
    if scan is None or (scan[0][:, 0] < 0).any():
        _fail("K4r round trip: the C scan refused the assembled segments")
    sc = np.zeros((n, 7), np.int64)
    sc[coded], digest, _bits = scan
    parts, starts, lens = [digest], [], []
    top = len(digest)
    for s, cap_off in ((3, sum(caps)), (4, sum(caps) + lsp)):
        rw, rl = native.ht_raw_batch(buf, base + cap_off, bits[s])
        cl, cll, _nb = native.ht_unstuff_batch(
            rw[:int(rl.sum())].tobytes(), np.cumsum(rl) - rl, rl)
        parts.append(cl[:int(cll.sum())])
        starts.append(top + np.cumsum(cll) - cll)
        lens.append(cll)
        top += int(cll.sum())
    body = torch.from_numpy(np.concatenate(parts + [np.zeros(16, np.uint8)])
                            ).to(dev)
    m = torch.from_numpy(sc).to(dev)
    lms, lsuf, dm = stage_dims(sc)
    lrf = ht_decode._quant_len(int(max(lens[0].max(), lens[1].max())))
    ms = stage_bytes(body, m[:, 1], m[:, 2], lms, False)
    suf_f = stage_bytes(body, m[:, 3], m[:, 4], lsuf, False)
    suf_r = stage_bytes(body, m[:, 3], m[:, 4] - 1, lsuf, True)
    mel, vlc = unstuff_suffix(suf_f, suf_r, dm)
    sp, mr = (stage_bytes(body, torch.from_numpy(a).to(dev),
                          torch.from_numpy(b).to(dev), lrf, False)
              for a, b in zip(starts, lens))
    u8 = torch.uint8
    args = (ms.to(u8), mel.to(u8), vlc.to(u8), col(pv), w, h,
            col(coded.astype(np.int32).tolist()), side, side, sp.to(u8),
            mr.to(u8), col([3] * n))
    got, codes = ht_decode.ht_decode_lanes(*args)
    ref, rcodes = ht_decode.ht_decode_lanes_ref(*args)
    if not (torch.equal(got, ref) and torch.equal(codes, rcodes)):
        _fail("K4r -> K2 round trip: K2 differs from its plain version")
    got = got.cpu().numpy()
    for j, ((wj, hj), mag, neg) in enumerate(zip(dims, mags, negs)):
        v = got[j, :hj, :wj]
        p = pv[j]
        if p == 0:
            ok = np.array_equal(np.abs(v), 2 * mag)
        else:
            bp = p - 1
            half_bp = 1 << bp if bp else 0
            csig = (mag >> p) > 0
            new = (v != 0) & ~csig
            ok = (np.array_equal(np.abs(v)[csig],
                                 ((mag >> bp) << p)[csig] + half_bp)
                  and (mag[new] >> bp == 1).all()
                  and (np.abs(v)[new] == (1 << p) + half_bp).all())
        if not (ok and np.array_equal(v < 0, neg & (v != 0))):
            _fail(f"K4r -> K2 round trip differs on synthetic lane {j} "
                  f"({wj}x{hj}, p = {p})")
    print(f"K4r -> K2 round trip: {n} synthetic lanes of 1x1 to "
          f"{side}x{side} at cleanup planes 1..3 give back every sample to "
          f"plane p - 1 ({int(sum(len(x) for x in parts[1:]))} clean "
          f"refinement bytes)", flush=True)


def _select(lanes, sel) -> tuple:
    """The lanes where sel holds."""
    return tuple(t[sel].contiguous() for t in lanes)


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
    from grok_tpu_torch.codestream import j2k
    from grok_tpu_torch.core.geometry import Rect
    from grok_tpu_torch.core.params import CompressParams
    from grok_tpu_torch.ops import ht_decode, ht_encode, t1_decode, t1_encode
    from grok_tpu_torch.pipeline import device as pdevice
    from grok_tpu_torch.pipeline import serve_enc, tile
    from grok_tpu_torch.pipeline.device import stage_bytes, unstuff_suffix
    from grok_tpu_torch.pipeline.serve import stage_dims
    from grok_tpu_torch.t2.rate import (layer_budget_consts,
                                        layer_targets_for_tile)
    from grok_tpu_torch.t1 import vectors
    from grok_tpu_torch.tools import hw_validate
    from grok_tpu_torch.util.synth import synthetic_image
    t_start = time.perf_counter()

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
    gray = [synthetic_image(512, 512, 1, seed=100 + i) for i in range(8)]
    rgb = [synthetic_image(1080, 1920, 3, seed=7)]
    pa = dict(num_resolutions=5, cblk_w_exp=5, cblk_h_exp=5)
    work = {
        "A": (gray, CompressParams(ht=True, **pa)),
        "B": (rgb, CompressParams(ht=True, num_resolutions=6)),
        "A1": (gray, CompressParams(**pa)),
        "B1": (rgb, CompressParams(num_resolutions=6)),
        "A-mix": (gray, CompressParams(ht_mixed=True, **pa)),
        "A-mix forced": (gray, CompressParams(ht_mixed=True, **pa)),
        "A-r": (gray, CompressParams(ht=True, ht_planes=1, **pa)),
        "B-r": (rgb, CompressParams(ht=True, num_resolutions=6, ht_planes=2,
                                    num_layers=3, rates=[40.0, 10.0, 4.0])),
        "A1-t": (gray, CompressParams(rates=[4.0], **pa)),
        "B1-t": (rgb, CompressParams(num_resolutions=6, num_layers=3,
                                     rates=[40.0, 10.0, 4.0])),
    }
    up = {id(imgs): [[torch.from_numpy(im[..., c] if im.ndim == 3 else im)
                      .to(dev).to(torch.int32)
                      for c in range(im.shape[2] if im.ndim == 3 else 1)]
                     for im in imgs] for imgs in (gray, rgb)}
    frames = {name: up[id(imgs)] for name, (imgs, _p) in work.items()}
    torch.cuda.synchronize()
    print(f"setup: synthetic sources made and uploaded in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    # each kernel's launch count: hw_validate.COUNTERS
    counts_zero, counts = hw_validate.zero_counts, hw_validate.launch_counts
    kernel_ms = hw_validate.kernel_ms    # CUDA events, KERNEL_REPS launches
    turns_ms = hw_validate.turns_ms      # (v1, v2) in turns: v1 v2 v2 v1
    paths = {"HT": ("A", "B"), "Part-1": ("A1", "B1"),
             "HT-mixed": ("A-mix", "A-mix forced"),
             "HT-refined": ("A-r", "B-r"),
             "Part-1 targeted": ("A1-t", "B1-t")}
    refined = paths["HT-refined"]
    layered = ("B-r", "B1-t")          # lossy: held by layer below
    # the kernels each path must launch, and those it must not
    enc_need = {"HT": ["K4"], "Part-1": ["K5"], "HT-mixed": ["K4", "K5"],
                "HT-refined": ["K4r"], "Part-1 targeted": ["K5", "K3"]}
    dec_need = {"HT": ["K1"], "Part-1": ["K3"], "HT-mixed": ["K1", "K3"],
                "HT-refined": ["K2"], "Part-1 targeted": ["K3"]}
    # the first designs (K1v1, K2v1, K3v1, K4v1, K4rv1, K5v1) are the
    # oracle only
    v1s = ["K1v1", "K2v1", "K3v1", "K4v1", "K4rv1", "K5v1"]
    absent = {p: ["K4r", "K2"] + v1s for p in paths}
    absent["HT-refined"] = ["K4", "K5"] + v1s
    absent["Part-1 targeted"] = ["K1", "K2", "K4", "K4r"] + v1s

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

    def need(path, got, kernels, absent):
        print(f"{path} launches: {got}", flush=True)
        for k in kernels:
            if got[k] == 0:
                _fail(f"the {path} path never launched {k}")
        for k in absent:
            if got[k]:
                _fail(f"the {path} path launched {k}")

    # ---- 3. encode main paths -------------------------------------------
    streams = {}
    enc_counts = {}
    for path, names in paths.items():
        counts_zero()
        for name in names:
            imgs, params = work[name]
            times = []
            with (hw_validate.forced_ht_blocks() if name == "A-mix forced"
                  else contextlib.nullcontext()):
                for _ in range(REPS + 1):  # the first call is a warm-up
                    out, dt = timed(lambda: api.compress_device_batch(
                        frames[name], params, device=dev))
                    times.append(dt)
                    if name in streams and out != streams[name]:
                        _fail(f"encode {name}: reps gave different bytes")
                    streams[name] = out
            npx = sum(im.shape[0] * im.shape[1] for im in imgs)
            report("encode", name, times, len(imgs), npx)
            print(f"encode {name}: {sum(len(s) for s in streams[name])} "
                  f"bytes for {len(imgs)} frame(s)", flush=True)
        enc_counts[path] = counts()
        need(f"{path} encode", enc_counts[path], enc_need[path],
             absent[path])
    n_k3 = enc_counts["Part-1 targeted"]["K3"]
    print(f"Part-1 targeted encode: K3 launched {n_k3} times for the trial "
          f"decodes over {REPS + 1} calls of (A1-t) and of (B1-t) (one "
          f"launch per frame with candidates)", flush=True)
    # the forced mixed stream's bitmaps must name both HT and Part-1
    # blocks
    nblk = len(serve_enc._plan_for(api._build_main_header(
        512, 512, 1, 8, False, work["A-mix"][1]), 0).blocks)
    for name in paths["HT-mixed"]:
        nht = []
        for s in streams[name]:
            hdr = j2k.read_main_header(s)
            th = j2k.TileHeader()
            for p in j2k.read_tile_parts(s, hdr):
                j2k.read_tile_part_header(s, p, hdr, th)
            bm = th.ht_mixed_bitmap()
            if bm is None:
                _fail(f"encode {name}: no HT-mixed bitmap")
            nht.append(sum(bin(b).count("1") for b in bm))
        print(f"encode {name}: the bitmaps mark {nht} HT blocks of {nblk} "
              f"per frame", flush=True)
        if name == "A-mix forced" and not all(0 < n < nblk for n in nht):
            _fail(f"encode {name}: a bitmap without both HT and Part-1 "
                  f"blocks")

    small = [synthetic_image(80, 96, 1, seed=20 + i) for i in range(3)]
    small_rgb = synthetic_image(64, 96, 3, seed=5)
    sp3 = dict(num_resolutions=3, cblk_w_exp=5, cblk_h_exp=5)
    for what, sp in (("HT", CompressParams(ht=True, **sp3)),
                     ("Part-1", CompressParams(num_resolutions=3,
                                               cblk_w_exp=4,
                                               cblk_h_exp=4))):
        if (api.compress_device_batch(small, sp, device=dev)
                != api.compress_device_batch(small, sp, device="cpu")
                or api.compress_device(small_rgb, sp, device=dev)
                != api.compress_device(small_rgb, sp, device="cpu")):
            _fail(f"{what} encode on the card differs from the plain "
                  f"versions on the CPU")
        print(f"encode reference {what}: 3 x 80x96 gray and 64x96 RGB "
              f"byte-identical to the CPU encode through the plain "
              f"versions", flush=True)
    small_r = [synthetic_image(128, 96, 1, seed=60 + i) for i in range(2)]
    for what, sp in (("A-r", CompressParams(ht=True, ht_planes=1, **sp3)),
                     ("B-r", CompressParams(ht=True, ht_planes=2,
                                            num_layers=3,
                                            rates=[40.0, 10.0, 4.0],
                                            **sp3))):
        if (api.compress_device_batch(small_r, sp, device=dev)
                != api.compress_device_batch(small_r, sp, device="cpu")
                or api.compress_device(small_rgb, sp, device=dev)
                != api.compress_device(small_rgb, sp, device="cpu")):
            _fail(f"{what} encode on the card differs from the plain "
                  f"versions on the CPU")
        print(f"encode reference {what}: 2 x 128x96 gray and 64x96 RGB "
              f"byte-identical to the CPU encode through the plain "
              f"versions", flush=True)
    sp3p1 = dict(sp3, cblk_w_exp=4, cblk_h_exp=4)
    for what, sp in (("A1-t", CompressParams(rates=[4.0], **sp3p1)),
                     ("B1-t", CompressParams(num_layers=3,
                                             rates=[40.0, 10.0, 4.0],
                                             **sp3p1))):
        if (api.compress_device_batch(small_r[:1], sp, device=dev)
                != api.compress_device_batch(small_r[:1], sp, device="cpu")
                or api.compress_device(small_rgb, sp, device=dev)
                != api.compress_device(small_rgb, sp, device="cpu")):
            _fail(f"{what} encode on the card differs from the plain "
                  f"versions on the CPU")
        print(f"encode reference {what}: 128x96 gray and 64x96 RGB "
              f"byte-identical to the CPU encode through the plain "
              f"versions", flush=True)

    def tile_results(name):
        """The serving encode's per-frame tile results, and the check that
        the API's stream carries the same tile body."""
        comps = [torch.stack([f[ci] for f in frames[name]])
                 for ci in range(len(frames[name][0]))]
        params = work[name][1]
        h, w = comps[0].shape[1:]
        hdr = api._build_main_header(h, w, len(comps), 8, False, params)
        res = serve_enc.try_encode_serving_batch(comps, hdr, params)
        if not all(s.endswith(r.body + b"\xff\xd9")
                   for s, r in zip(streams[name], res)):
            _fail(f"encode {name}: the tile body differs from the API "
                  f"stream's")
        return hdr, params, res

    # (B-r), (B1-t): every layer prefix within its byte budget (the PCRD
    # targets of t2/rate.py, on the tile's packet bytes)
    for name in layered:
        b_hdr, b_params, b_res = tile_results(name)
        targets = layer_targets_for_tile(layer_budget_consts(b_hdr,
                                                             b_params),
                                         b_hdr.siz.tile_rect(0), b_params)
        per_layer = len(b_res[0].packet_lens) // b_params.num_layers
        prefix = [int(sum(b_res[0].packet_lens[:per_layer * (k + 1)]))
                  for k in range(b_params.num_layers)]
        print(f"encode {name}: layer prefixes {prefix} bytes, budgets "
              f"{[round(t, 1) for t in targets]}", flush=True)
        if any(p > t for p, t in zip(prefix, targets)):
            _fail(f"encode {name}: a layer prefix exceeds its byte budget")
    # the minimal-flush refinement of the targeted Part-1 encodes
    for name in paths["Part-1 targeted"]:
        res = tile_results(name)[2]
        print(f"encode {name}: the refinement shrank "
              f"{sum(r.refined for r in res)} blocks by "
              f"{sum(r.reclaimed for r in res)} bytes in all "
              f"({sum(r.trial_lanes for r in res)} trial-decode lanes, "
              f"{len(res)} frame(s))", flush=True)
        if name == "A1-t" and not sum(r.refined for r in res):
            _fail("encode A1-t: the refinement shrank no block")

    # ---- 4. decode main paths --------------------------------------------
    def pixels(comps):
        return torch.stack(comps, -1).cpu().numpy() if len(comps) > 1 \
            else comps[0].cpu().numpy()

    def psnr(a, img):
        mse = np.mean((a.astype(np.float64) - img) ** 2)
        return float("inf") if mse == 0 else 10 * np.log10(255 ** 2 / mse)

    # the refined and targeted streams' reference decodes: the plain
    # versions on the CPU
    want = {}
    for name in ("A-r", "A1-t"):
        t0 = time.perf_counter()
        want[name] = [pixels(c) for c in api.decompress_device_batch(
            streams[name], device="cpu")]
        print(f"decode {name} on the CPU through the plain versions: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    dec_counts = {}
    for path, names in paths.items():
        counts_zero()
        for name in names:
            imgs = work[name][0]
            times = []
            for _ in range(REPS + 1):
                out, dt = timed(lambda: api.decompress_device_batch(
                    streams[name], device=dev))
                times.append(dt)
                for fi, (img, comps) in enumerate(zip(imgs, out)):
                    if any(c.device.type != "cuda" for c in comps):
                        _fail(f"decode {name}: output left the card")
                    arr = pixels(comps)
                    ref = want[name][fi] if name in want else img
                    if name in layered:
                        continue                 # lossy: layers below
                    if arr.shape != ref.shape or not np.array_equal(arr,
                                                                    ref):
                        _fail(f"decode {name}: pixels differ from the "
                              f"{'CPU decode' if name in want else 'source'}")
            npx = sum(im.shape[0] * im.shape[1] for im in imgs)
            report("decode", name, times, len(imgs), npx)
            if name == "A-r":
                err = [int(np.abs(a.astype(np.int64) - im).max())
                       for a, im in zip(want[name], imgs)]
                ndiff = [int((a != im).sum()) for a, im in zip(want[name],
                                                               imgs)]
                print(f"decode {name}: {len(imgs)} frames bit-exact to the "
                      f"plain versions' decode on the CPU; against the "
                      f"source max abs err {err}, pixels differing "
                      f"{ndiff}", flush=True)
                if max(err) > 1:
                    _fail(f"decode {name}: more than 1 from the source")
            elif name == "A1-t":
                db = [psnr(a, im) for a, im in zip(want[name], imgs)]
                print(f"decode {name}: {len(imgs)} frames bit-exact to the "
                      f"plain versions' decode on the CPU; PSNR against the "
                      f"source {db} dB", flush=True)
            elif name in layered:
                img = imgs[0]
                by_layer = []
                for k in (1, 2, 3):
                    o = api.decompress_device(
                        streams[name][0], api.DecompressParams(max_layers=k),
                        device=dev)
                    by_layer.append(psnr(pixels(o), img))
                full = psnr(pixels(out[0]), img)
                print(f"decode {name}: PSNR at 1, 2, 3 layers {by_layer} dB "
                      f"(full decode {full} dB) [{card}]", flush=True)
                if not (by_layer[0] < by_layer[1] < by_layer[2]) or \
                        by_layer[2] != full:
                    _fail(f"decode {name}: PSNR does not rise with every "
                          f"layer")
            else:
                print(f"decode {name}: {len(imgs)} frame(s) bit-exact to "
                      f"the source", flush=True)
        dec_counts[path] = counts()
        need(f"{path} decode", dec_counts[path], dec_need[path],
             absent[path] + (["K5"] if path == "Part-1 targeted" else []))

    @contextlib.contextmanager
    def ht_decoder(fn):
        """The decode paths' HT decode kernels swapped for fn's design (the
        first design, for a timing in turns)."""
        saved = ht_decode.ht_decode_lanes, pdevice.ht_decode_lanes
        ht_decode.ht_decode_lanes = pdevice.ht_decode_lanes = fn
        try:
            yield
        finally:
            ht_decode.ht_decode_lanes, pdevice.ht_decode_lanes = saved

    def v1_lanes(*a, i64=False):
        """The first design behind ht_decode_lanes' contract: its planes
        and zero error codes (it flags nothing; the lanes it is given here
        are intact, so no int64 re-decode is asked of it)."""
        if i64:
            _fail("an int64 re-decode of an intact stream's lanes")
        out = ht_decode.ht_decode_lanes_v1(*a)
        return out, out.new_zeros(out.shape[0])

    ht_designs = {"v2": ht_decode.ht_decode_lanes, "v1": v1_lanes}
    ht_cells = paths["HT"] + paths["HT-mixed"] + refined
    for name in work:
        stage = (lambda: api.stage_general_device(streams[name][0],
                                                  device=dev)) \
            if name in refined else (lambda: api.stage_device_batch(
                streams[name], device=dev))
        order = ("v1", "v2", "v2", "v1") if name in ht_cells else ("v2",)
        host, dev_t = [], {k: [] for k in order}
        for k in order[:2]:                            # warm-up
            with ht_decoder(ht_designs[k]):
                stage().run()
        for _ in range(REPS):
            staged, dt0 = timed(stage)
            host.append(dt0)
            for k in order:
                with ht_decoder(ht_designs[k]):
                    dev_t[k].append(timed(staged.run)[1])
        part = ", ".join(
            f"{k} best {min(t) * 1e3:.3f} ms (median "
            f"{float(np.median(t)) * 1e3:.3f})" for k, t in dev_t.items())
        what = "general route, first frame: host parse+stage+upload" \
            if name in refined else "host parse+stage+upload"
        dpart = "device blocks+synthesis" if name in refined \
            else "device program"
        print(f"split decode {name} ({what} {min(host) * 1e3:.3f} ms, best "
              f"of {REPS}): {dpart} {part} [{card}]", flush=True)

    def enc_lanes(name):
        imgs, params = work[name]
        comps = [torch.stack([f[ci] for f in frames[name]])
                 for ci in range(len(frames[name][0]))]
        h, w = comps[0].shape[1:]
        hdr = api._build_main_header(h, w, len(comps), 8, False, params)
        plan, lanes = serve_enc.stage_encode_lanes(comps, hdr, params)
        return comps, hdr, params, plan, lanes

    for name in (n for n in work if n != "A-mix forced"):
        comps, hdr, params, plan, _lanes = enc_lanes(name)

        def device_part(ht_enc):
            lanes = serve_enc.stage_encode_lanes(comps, hdr, params)[1]
            if plan.coder == "ht":
                ht_enc(*lanes, *plan.caps, refine=bool(params.ht_planes))
            if plan.coder == "mq" or params.ht_mixed:
                t1_encode.t1_encode_lanes(
                    *serve_enc.mq_lane_inputs(plan, lanes), *plan.mq_caps)
        # best and median of REPS synced calls after a warm-up; on HT
        # cells also with the first HT encoder design, in turns
        designs = {"v2": ht_encode.ht_encode_lanes}
        if plan.coder == "ht":
            designs["v1"] = ht_encode.ht_encode_lanes_v1
        dev_s = {k: [] for k in designs}
        for k in designs:
            device_part(designs[k])
        for _ in range(REPS):
            for k in ("v1", "v2", "v2", "v1") if len(designs) == 2 \
                    else ("v2",):
                dev_s[k].append(timed(lambda: device_part(designs[k]))[1])
        part = ", ".join(
            f"{k} best {min(t) * 1e3:.3f} ms (median "
            f"{float(np.median(t)) * 1e3:.3f})" for k, t in dev_s.items())
        print(f"split encode {name}: device staging + block coders: {part} "
              f"[{card}]", flush=True)
        host = _host_split(serve_enc, tile, lambda: timed(
            lambda: api.compress_device_batch(frames[name], params,
                                              device=dev))[1])
        print(f"split encode {name}: C wire assembly "
              f"{host['assemble'] * 1e3:.3f} ms, Tier-2 finish "
              f"{host['finish'] * 1e3:.3f} ms (of which the truncation "
              f"refinement and its trial decodes "
              f"{host['refine'] * 1e3:.3f} ms), whole call "
              f"{host['call'] * 1e3:.3f} ms [{card}]", flush=True)

    # ---- 5. K4 vs its first design and its plain version -----------------
    k4 = {"ms": 0.0, "prev_ms": 0.0, "plain_ms": 0.0, "err": 0, "bytes": 0}
    for name in paths["HT"]:
        _comps, _hdr, _params, plan, lanes = enc_lanes(name)
        caps = plan.caps
        nl = lanes[0].shape[0]
        got = ht_encode.ht_encode_lanes(*lanes, *caps)
        if not hw_validate.ht_encodes_equal(
                got, ht_encode.ht_encode_lanes_v1(*lanes, *caps), caps[:2]):
            _fail(f"K4 differs from its first design on {name}")
        ref, p_ms = _plain_ms(torch, lambda: ht_encode.ht_encode_lanes_ref(
            *lanes, *caps))
        # only each stream's first ceil(bits / 8) bytes are defined
        used = ht_encode.clear_unused(*got, *caps[:2])
        err = max(int((used.int() - ref[0].int()).abs().max()),
                  int((got[1] - ref[1]).abs().max()))
        k4["err"] = max(k4["err"], err)
        print(f"K4 {name}: {nl} lanes ({plan.W}x{plan.H}) equal to v1 bit for "
              f"bit; vs the plain version: max_abs_err {err}", flush=True)
        if err:
            _fail(f"K4 disagrees with its plain version on {name}")
        v1_ms, k_ms = turns_ms(
            dev, lambda: ht_encode.ht_encode_lanes_v1(*lanes, *caps),
            lambda: ht_encode.ht_encode_lanes(*lanes, *caps))
        nbytes = _k4_bytes(lanes, got[1], ht_encode._lut_on(dev))
        k4["ms"] += k_ms
        k4["prev_ms"] += v1_ms
        k4["plain_ms"] += p_ms
        k4["bytes"] += nbytes
        print(f"K4 {name}: 1 launch per encode, {nl} lanes, kernel "
              f"{k_ms:.4f} ms, v1 {v1_ms:.4f} ms, in turns "
              f"({v1_ms / k_ms:.2f}x), bound "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes} bytes), "
              f"plain version {p_ms:.1f} ms on the same lanes [{card}]",
              flush=True)
        if name == "B":
            nbits = got[1].long().clamp(min=0).sum(0)
            est = lanes[2].long() * lanes[3] * (1 << 24) + nbits
            j = int(torch.argmax(est))
            one = _select(lanes, torch.arange(nl, device=dev) == j)
            one_v1, one_ms = turns_ms(
                dev, lambda: ht_encode.ht_encode_lanes_v1(*one, *caps),
                lambda: ht_encode.ht_encode_lanes(*one, *caps))
            print(f"K4 {name} diagnostic: the slowest lane alone "
                  f"({int(lanes[2][j])}x{int(lanes[3][j])}, "
                  f"{int(nbits[j])} stream bits) v2 {one_ms:.4f} ms, v1 "
                  f"{one_v1:.4f} ms; all {nl} lanes v2 {k_ms:.4f} ms "
                  f"[{card}]", flush=True)

    # ---- 6. K4 -> K1 round trip -------------------------------------------
    _synthetic_roundtrip(torch, dev, ht_decode, hw_validate)

    # ---- 7. K1 vs its first design and its plain version -----------------
    k1 = {"ms": 0.0, "prev_ms": 0.0, "plain_ms": 0.0, "err": 0, "bytes": 0}
    for name in paths["HT"]:
        staged = api.stage_device_batch(streams[name], device=dev)
        prog = staged.program
        k_ms = v1_ms = p_ms = 0.0
        nb0 = k1["bytes"]
        slow = None              # (w * h << 24 | MagSgn bytes, lanes, ...)
        for bi, b in enumerate(prog.buckets):
            lanes = prog.stage(staged.body, staged.meta, bi,
                               *staged.dims[bi][:3])
            nl = lanes[0].shape[0]
            got, codes = ht_decode.ht_decode_lanes(*lanes, b.W, b.H)
            if not torch.equal(got, ht_decode.ht_decode_lanes_v1(
                    *lanes, b.W, b.H)):
                _fail(f"K1 differs from its first design ({name} "
                      f"{b.W}x{b.H})")
            if bool(codes.any()):
                _fail(f"K1 flagged a lane of the intact {name}")
            (ref, _c), dt = _plain_ms(
                torch, lambda: ht_decode.ht_decode_lanes_ref(*lanes, b.W,
                                                             b.H))
            p_ms += dt
            err = int((got.long() - ref.long()).abs().max())
            k1["err"] = max(k1["err"], err)
            if err:
                _fail(f"K1 disagrees with its plain version ({name} "
                      f"{b.W}x{b.H}: max abs err {err})")
            a_ms, b_ms = turns_ms(
                dev, lambda: ht_decode.ht_decode_lanes_v1(*lanes, b.W, b.H),
                lambda: ht_decode.ht_decode_lanes(*lanes, b.W, b.H))
            k_ms += b_ms
            v1_ms += a_ms
            meta = prog.lane_meta(staged.meta, bi)
            nb = _k1_bytes(meta, lanes, ht_decode._lut_on(dev))
            k1["bytes"] += nb
            print(f"K1 {name} bucket {b.W}x{b.H}: {nl} lanes equal to v1 bit "
                  f"for bit, max_abs_err {err} against the plain version; v2 "
                  f"{b_ms:.4f} ms, v1 {a_ms:.4f} ms, in turns "
                  f"({a_ms / b_ms:.2f}x), bound "
                  f"{nb / HBM_BYTES_PER_S * 1e3:.4f} ms ({nb} bytes), plain "
                  f"version {dt:.1f} ms [{card}]", flush=True)
            if name == "B":
                est = torch.where(lanes[6] == 1, lanes[4].long() * lanes[5]
                                  * (1 << 24) + meta[:, 1].long(), -1)
                j = int(torch.argmax(est))
                if slow is None or int(est[j]) > slow[0]:
                    slow = (int(est[j]), lanes, j, b, b_ms)
        k1["ms"] += k_ms
        k1["prev_ms"] += v1_ms
        k1["plain_ms"] += p_ms
        nb = k1["bytes"] - nb0
        print(f"K1 {name}: {len(prog.buckets)} launches per decode, v2 "
              f"{k_ms:.4f} ms, v1 {v1_ms:.4f} ms, in turns "
              f"({v1_ms / k_ms:.2f}x), bound "
              f"{nb / HBM_BYTES_PER_S * 1e3:.4f} ms ({nb} bytes), plain "
              f"version {p_ms:.1f} ms [{card}]", flush=True)
        if slow is not None:
            est, lanes, j, b, b_ms = slow
            nl = lanes[0].shape[0]
            one = _select(lanes, torch.arange(nl, device=dev) == j)
            one_v1, one_ms = turns_ms(
                dev, lambda: ht_decode.ht_decode_lanes_v1(*one, b.W, b.H),
                lambda: ht_decode.ht_decode_lanes(*one, b.W, b.H))
            print(f"K1 {name} diagnostic: the slowest lane alone "
                  f"({int(one[4][0])}x{int(one[5][0])}, {est & 0xFFFFFF} "
                  f"MagSgn bytes) v2 {one_ms:.4f} ms, v1 {one_v1:.4f} ms; "
                  f"its bucket's {nl} lanes ({b.W}x{b.H}) v2 {b_ms:.4f} ms "
                  f"[{card}]", flush=True)

    tables = t1_decode.lut_on(dev)

    # the plain K5 and K3 on (A1), (B1) and the trial-decode lanes run on
    # the host's CPU, in worker processes beside the card's work; each is
    # checked (its err and plain_ms taken) before the kernels line
    import concurrent.futures
    import multiprocessing
    host_pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=3, mp_context=multiprocessing.get_context("spawn"))
    host_checks = []

    def on_host(fn, args, check):
        """fn(*args) (hw_validate.plain_encode_ms or plain_decode_ms) on
        CPU copies of the tensors, in a host worker; check(ref, p_ms)
        when the checks are collected."""
        host_checks.append((host_pool.submit(fn, *(
            a.cpu() if isinstance(a, torch.Tensor) else a for a in args)),
            check))

    # ---- 8. K5 vs its plain version ---------------------------------------
    k5 = {"ms": 0.0, "plain_ms": 0.0, "prev_ms": 0.0, "err": 0, "bytes": 0}
    for name in paths["Part-1"]:
        _comps, _hdr, _params, plan, lanes = enc_lanes(name)
        ins = serve_enc.mq_lane_inputs(plan, lanes)
        L, R = plan.mq_caps
        nl_all = ins[0].shape[0]
        full = t1_encode.t1_encode_lanes(*ins, L, R)
        if not hw_validate.encodes_equal(
                full, t1_encode.t1_encode_lanes_v1(*ins, L, R)):
            _fail(f"K5 differs from its first design on {name}")
        v1_ms, full_ms = turns_ms(
            dev, lambda: t1_encode.t1_encode_lanes_v1(*ins, L, R),
            lambda: t1_encode.t1_encode_lanes(*ins, L, R))
        print(f"K5 {name}: all {nl_all} lanes equal to v1 bit for bit; "
              f"v2 {full_ms:.4f} ms, v1 {v1_ms:.4f} ms, in turns "
              f"({v1_ms / full_ms:.2f}x) [{card}]", flush=True)
        if name == "B1":
            est = ins[2].long() * ins[3] * ins[4]
            one = _select(ins, torch.arange(nl_all, device=dev)
                          == int(torch.argmax(est)))
            one_ms = kernel_ms(dev, lambda: t1_encode.t1_encode_lanes(
                *one, L, R))
            nb_all = _k5_bytes(ins, full[1], tables)
            print(f"K5 {name} diagnostic: the slowest lane alone (nbps*w*h "
                  f"{int(est.max())}) {one_ms:.4f} ms, all {nl_all} lanes "
                  f"{full_ms:.4f} ms, all-lane bound "
                  f"{nb_all / HBM_BYTES_PER_S * 1e3:.4f} ms ({nb_all} bytes) "
                  f"[{card}]", flush=True)
        if name == "B1":
            # the bottom-edge blocks: h <= EDGE_H, w and h not multiples
            # of the block size, cut to EDGE_H rows
            ins = _select(ins, ins[4] <= EDGE_H)
            ins = (ins[0][:, :EDGE_H].contiguous(),) + ins[1:]
        nl = ins[0].shape[0]
        Hs, Ws = ins[0].shape[1:]
        got = t1_encode.t1_encode_lanes(*ins, L, R)
        lens = got[1]
        if (lens < 0).any():
            _fail(f"K5 gave a negative length on {name}")
        sizes = sorted({(int(a), int(b)) for a, b in zip(ins[3], ins[4])})

        def check_k5(ref, p_ms, name=name, got=tuple(t.cpu() for t in got),
                     L=L, what=f"{nl} of {nl_all} lanes ({Ws}x{Hs}; w x h "
                     f"{sizes[:6]}{' ...' if len(sizes) > 6 else ''})"):
            used = torch.arange(L)[None] <= got[1].long()[:, None]
            err = max(int((got[1] - ref[1]).abs().max()),
                      int((torch.where(used, got[0].int(), 0)
                           - torch.where(used, ref[0].int(), 0))
                          .abs().max()),
                      int((got[2] - ref[2]).abs().max()),
                      int((got[3].int() - ref[3].int()).abs().max()))
            k5["err"] = max(k5["err"], err)
            k5["plain_ms"] += p_ms
            print(f"K5 {name}: {what} vs the plain version (on the host "
                  f"CPU, {p_ms:.1f} ms): max_abs_err {err} [{card}]",
                  flush=True)
            if err:
                _fail(f"K5 disagrees with its plain version on {name}")
        on_host(hw_validate.plain_encode_ms, tuple(ins) + (L, R), check_k5)
        prev_ms, k_ms = turns_ms(
            dev, lambda: t1_encode.t1_encode_lanes_v1(*ins, L, R),
            lambda: t1_encode.t1_encode_lanes(*ins, L, R))
        nbytes = _k5_bytes(ins, lens, tables)
        k5["ms"] += k_ms
        k5["prev_ms"] += prev_ms
        k5["bytes"] += nbytes
        print(f"K5 {name}: 1 launch per encode, kernel {full_ms:.4f} ms on "
              f"all {nl_all} lanes; on the {nl} compared lanes kernel "
              f"{k_ms:.4f} ms (v1 {prev_ms:.4f} ms), bound "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes} bytes) "
              f"[{card}]", flush=True)

    # ---- 9. K3 vs its plain version ---------------------------------------
    k3 = {"ms": 0.0, "plain_ms": 0.0, "prev_ms": 0.0, "err": 0, "bytes": 0}
    for name in paths["Part-1"]:
        staged = api.stage_device_batch(streams[name], device=dev)
        lanes = staged.program.stage_mq(staged.body, staged.meta)
        (W, H, _b), = staged.program.mq_groups
        nl_all = lanes[1].shape[0]
        if not torch.equal(t1_decode.t1_decode_lanes(*lanes, W, H),
                           t1_decode.t1_decode_lanes_v1(*lanes, W, H)):
            _fail(f"K3 differs from its first design on {name}")
        v1_ms, full_ms = turns_ms(
            dev, lambda: t1_decode.t1_decode_lanes_v1(*lanes, W, H),
            lambda: t1_decode.t1_decode_lanes(*lanes, W, H))
        print(f"K3 {name}: all {nl_all} lanes equal to v1 bit for bit; "
              f"v2 {full_ms:.4f} ms, v1 {v1_ms:.4f} ms, in turns "
              f"({v1_ms / full_ms:.2f}x) [{card}]", flush=True)
        if name == "B1":
            est = lanes[2].long() * lanes[5] * lanes[6]
            one = (lanes[0],) + _select(
                lanes[1:], torch.arange(nl_all, device=dev)
                == int(torch.argmax(est)))
            one_ms = kernel_ms(dev, lambda: t1_decode.t1_decode_lanes(
                *one, W, H))
            nb_all = _k3_bytes(lanes, tables)
            print(f"K3 {name} diagnostic: the slowest lane alone (npass*w*h "
                  f"{int(est.max())}) {one_ms:.4f} ms, all {nl_all} lanes "
                  f"{full_ms:.4f} ms, all-lane bound "
                  f"{nb_all / HBM_BYTES_PER_S * 1e3:.4f} ms ({nb_all} bytes) "
                  f"[{card}]", flush=True)
        if name == "B1":
            # the same bottom-edge blocks as phase 8
            lanes = (lanes[0],) + _select(lanes[1:], lanes[6] <= EDGE_H)
            W, H = int(lanes[5].max()), EDGE_H
        nl = lanes[1].shape[0]
        got = t1_decode.t1_decode_lanes(*lanes, W, H)

        def check_k3(ref, p_ms, name=name, got=got.cpu(),
                     what=f"{nl} of {nl_all} lanes ({W}x{H})"):
            err = int((got.long() - ref.long()).abs().max())
            k3["err"] = max(k3["err"], err)
            k3["plain_ms"] += p_ms
            print(f"K3 {name}: {what} vs the plain version (on the host "
                  f"CPU, {p_ms:.1f} ms): max_abs_err {err} [{card}]",
                  flush=True)
            if err:
                _fail(f"K3 disagrees with its plain version on {name}")
        on_host(hw_validate.plain_decode_ms, tuple(lanes) + (W, H),
                check_k3)
        prev_ms, k_ms = turns_ms(
            dev, lambda: t1_decode.t1_decode_lanes_v1(*lanes, W, H),
            lambda: t1_decode.t1_decode_lanes(*lanes, W, H))
        nb = _k3_bytes(lanes, tables)
        k3["ms"] += k_ms
        k3["prev_ms"] += prev_ms
        k3["bytes"] += nb
        print(f"K3 {name}: 1 launch per decode, kernel {full_ms:.4f} ms on "
              f"all {nl_all} lanes; on the {nl} compared lanes kernel "
              f"{k_ms:.4f} ms (v1 {prev_ms:.4f} ms), bound "
              f"{nb / HBM_BYTES_PER_S * 1e3:.4f} ms ({nb} bytes) [{card}]",
              flush=True)

    # ---- 10. K5 -> K3 round trip ------------------------------------------
    _mq_roundtrip(torch, dev, t1_encode, t1_decode, hw_validate)

    # ---- 11. mode-switch vectors ------------------------------------------
    v = vectors.load()
    la = vectors.k3_lanes(v, dev)
    got = t1_decode.t1_decode_lanes(*la, vectors.SIDE, vectors.SIDE)
    ref = t1_decode.t1_decode_lanes_ref(*la, vectors.SIDE, vectors.SIDE)
    err = max(int(np.abs(got.cpu().numpy().astype(np.int64)
                         - v["mag2"]).max()),
              int((got.long() - ref.long()).abs().max()))
    k3["err"] = max(k3["err"], err)
    if err:
        _fail(f"K3 on the mode-switch vectors: max abs err {err}")
    print(f"K3 mode-switch vectors: {len(v['npass'])} lanes, styles "
          f"{sorted({hex(s) for s in v['style'].tolist()})}, equal to the "
          f"scalar decodes and the plain version", flush=True)

    # ---- 12. K4r vs its first design and its plain version ---------------
    k4r = {"ms": 0.0, "prev_ms": 0.0, "plain_ms": 0.0, "err": 0, "bytes": 0}
    for name in refined:
        _comps, _hdr, _params, plan, lanes = enc_lanes(name)
        caps = plan.caps
        nl_all = lanes[0].shape[0]
        allcaps = caps + ht_encode.refine_caps(plan.W, plan.H)
        got = ht_encode.ht_encode_lanes(*lanes, *caps, refine=True)
        if not hw_validate.ht_encodes_equal(
                got, ht_encode.ht_encode_lanes_v1(*lanes, *caps, refine=True),
                allcaps[:-1]):
            _fail(f"K4r differs from its first design on {name}")
        if (got[1] < 0).any():
            _fail(f"K4r: a stream of {name} exceeded its capacity")
        v1_all, full_ms = turns_ms(
            dev, lambda: ht_encode.ht_encode_lanes_v1(*lanes, *caps,
                                                      refine=True),
            lambda: ht_encode.ht_encode_lanes(*lanes, *caps, refine=True))
        nb_all = _k4r_bytes(lanes, got[1], ht_encode._lut_on(dev))
        print(f"K4r {name}: all {nl_all} lanes ({plan.W}x{plan.H}) equal to "
              f"v1 bit for bit; v2 {full_ms:.4f} ms, v1 {v1_all:.4f} ms, in "
              f"turns ({v1_all / full_ms:.2f}x), all-lane bound "
              f"{nb_all / HBM_BYTES_PER_S * 1e3:.4f} ms ({nb_all} bytes) "
              f"[{card}]", flush=True)
        if name == "B-r":
            # the bottom-edge blocks, cut to EDGE_H rows (phase 8)
            lanes = _select(lanes, lanes[3] <= EDGE_H)
            lanes = (lanes[0][:, :EDGE_H].contiguous(),) + lanes[1:]
        nl = lanes[0].shape[0]
        Hs, Ws = lanes[0].shape[1:]
        allcaps = caps + ht_encode.refine_caps(Ws, Hs)
        got = ht_encode.ht_encode_lanes(*lanes, *caps, refine=True)

        def plain():
            st, bt = ht_encode.ht_encode_lanes_ref(*lanes, *caps)
            sp, mr, rb, ns = ht_encode.ht_refine_lanes_ref(*lanes,
                                                           *allcaps[3:])
            return torch.cat([st, sp, mr], 1), torch.cat([bt, rb]), ns
        ref, p_ms = _plain_ms(torch, plain)
        used = ht_encode.clear_unused(got[0], got[1], *allcaps[:-1])
        err = max(int((used.int() - ref[0].int()).abs().max()),
                  int((got[1] - ref[1]).abs().max()),
                  int((got[2].int() - ref[2].int()).abs().max()))
        k4r["err"] = max(k4r["err"], err)
        nref = int((lanes[1] > 0).sum())
        print(f"K4r {name}: {nl} of {nl_all} lanes ({Ws}x{Hs}, {nref} with "
              f"a cleanup plane above 0) vs the plain version: max_abs_err "
              f"{err}", flush=True)
        if err or (got[1] < 0).any():
            _fail(f"K4r disagrees with its plain version on {name}")
        v1_ms, k_ms = turns_ms(
            dev, lambda: ht_encode.ht_encode_lanes_v1(*lanes, *caps,
                                                      refine=True),
            lambda: ht_encode.ht_encode_lanes(*lanes, *caps, refine=True))
        nbytes = _k4r_bytes(lanes, got[1], ht_encode._lut_on(dev))
        k4r["ms"] += k_ms
        k4r["prev_ms"] += v1_ms
        k4r["plain_ms"] += p_ms
        k4r["bytes"] += nbytes
        print(f"K4r {name}: 1 launch per encode, kernel {full_ms:.4f} ms on "
              f"all {nl_all} lanes; on the {nl} compared lanes kernel "
              f"{k_ms:.4f} ms (v1 {v1_ms:.4f} ms), bound "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes} bytes), "
              f"plain version {p_ms:.1f} ms [{card}]", flush=True)

    # ---- 13. K2 vs its first design and its plain version ----------------
    k2 = {"ms": 0.0, "prev_ms": 0.0, "plain_ms": 0.0, "err": 0, "bytes": 0}
    for name in refined:
        staged = api.stage_general_device(streams[name][0], device=dev)
        k_ms = v1_ms = p_ms = 0.0
        nb0, nk2 = k2["bytes"], 0
        for bi, b in enumerate(staged.program.buckets):
            la = staged.lanes[bi]
            meta = staged.meta[bi]
            sel = [("refined", la[10])]
            if name == "B-r" and b.H <= EDGE_H:
                sel.append(("edge (K1 + K2)", np.ones_like(la[10])))
            for what, mask in sel:
                if not mask.any():
                    continue
                idx = torch.from_numpy(np.nonzero(mask)[0]).to(dev)
                t = [x.index_select(0, idx) for x in la[:10]]
                args = (*t[:3], *t[5:9], b.W, b.H, t[3], t[4], t[9])
                if what == "refined":
                    got, codes = ht_decode.ht_decode_lanes(*args)
                    old = ht_decode.ht_decode_lanes_v1(*args)
                else:
                    got, codes = ht_decode.decode_ht_blocks(
                        *t, la[10][mask], b.W, b.H)
                    with ht_decoder(v1_lanes):
                        old, _c = ht_decode.decode_ht_blocks(
                            *t, la[10][mask], b.W, b.H)
                if not torch.equal(got, old):
                    _fail(f"K2 differs from its first design ({name} "
                          f"{b.W}x{b.H} {what})")
                if bool(codes.any()):
                    _fail(f"K2 flagged a lane of the intact {name}")
                (ref, _c), dt = _plain_ms(torch, lambda: ht_decode
                                          .ht_decode_lanes_ref(*args))
                err = int((got.long() - ref.long()).abs().max())
                k2["err"] = max(k2["err"], err)
                print(f"K2 {name} bucket {b.W}x{b.H} {what} lanes "
                      f"{idx.numel()}: equal to v1 bit for bit, max_abs_err "
                      f"{err} against the plain version", flush=True)
                if err:
                    _fail(f"K2 disagrees with its plain version ({name} "
                          f"{b.W}x{b.H} {what})")
                if what == "refined":
                    p_ms += dt
                    nk2 += 1
                    a_ms, b_ms = turns_ms(
                        dev, lambda: ht_decode.ht_decode_lanes_v1(*args),
                        lambda: ht_decode.ht_decode_lanes(*args))
                    k_ms += b_ms
                    v1_ms += a_ms
                    nb = _k2_bytes(meta[mask], t, ht_decode._lut_on(dev))
                    k2["bytes"] += nb
                    print(f"K2 {name} bucket {b.W}x{b.H}: {idx.numel()} "
                          f"refined lanes, v2 {b_ms:.4f} ms, v1 {a_ms:.4f} "
                          f"ms, in turns ({a_ms / b_ms:.2f}x), bound "
                          f"{nb / HBM_BYTES_PER_S * 1e3:.4f} ms ({nb} bytes), "
                          f"plain version {dt:.1f} ms [{card}]", flush=True)
        k2["ms"] += k_ms
        k2["prev_ms"] += v1_ms
        k2["plain_ms"] += p_ms
        nb = k2["bytes"] - nb0
        print(f"K2 {name}: {nk2} launches per decode (first frame), v2 "
              f"{k_ms:.4f} ms, v1 {v1_ms:.4f} ms, in turns "
              f"({v1_ms / k_ms:.2f}x), bound "
              f"{nb / HBM_BYTES_PER_S * 1e3:.4f} ms ({nb} bytes), plain "
              f"version {p_ms:.1f} ms [{card}]", flush=True)

    # ---- 14. K4r -> K2 round trip ------------------------------------------
    _refine_roundtrip(torch, dev, (ht_encode, ht_decode, native,
                                   stage_bytes, unstuff_suffix, stage_dims))

    # ---- 15. P1 through the hardware-validation tool -----------------------
    # the probe's own launches count (run_gather_probe reads the counter
    # around its checked call), not the timing windows'
    p1 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "err": 0,
          "bytes": 0, "spread_ms": 0.0}
    p1_launches = 0
    for rows in hw_validate.GATHER_ROWS:
        r = hw_validate.run_gather_probe(dev, rows=rows)
        if not r["ok"]:
            _fail(f"P1 disagrees with its plain version or take_along_dim "
                  f"at {rows} rows")
        for key in ("ms", "plain_ms", "library_ms", "spread_ms"):
            p1[key] += r[key]
        # P1 and take_along_dim in turns (P1, library, library, P1)
        verdict = ("P1 loses beyond the spread"
                   if r["ms"] - r["library_ms"] > r["spread_ms"] else
                   "P1 within the spread or ahead")
        print(f"P1 {rows} rows: P1 {r['ms']:.4f} ms, take_along_dim "
              f"{r['library_ms']:.4f} ms, spread {r['spread_ms']:.4f} ms "
              f"({verdict}); bound {r['bytes'] / HBM_BYTES_PER_S * 1e3:.4f}"
              f" ms ({r['bytes']} bytes: x, idx and out once each) "
              f"[{card}]", flush=True)
        p1["bytes"] += r["bytes"]
        p1_launches += r["launches"]
    print(f"P1 launches: {p1_launches}", flush=True)
    if not p1_launches:
        _fail("the gather probe never launched P1")

    # ---- 16. K3 on the refinement's trial-decode lanes ----------------------
    grabbed = []
    refine = tile._refine_truncations

    def grab(ejobs, encs, layer_cum, device):
        if not grabbed:
            grabbed.append(tile.trial_decode_lanes(ejobs, encs, layer_cum,
                                                   device))
        return refine(ejobs, encs, layer_cum, device)
    tile._refine_truncations = grab
    try:
        api.compress_device_batch(frames["A1-t"][:1], work["A1-t"][1],
                                  device=dev)
    finally:
        tile._refine_truncations = refine
    cands, lanes, W, H = grabbed[0]
    got = t1_decode.t1_decode_lanes(*lanes, W, H)
    if not torch.equal(got, t1_decode.t1_decode_lanes_v1(*lanes, W, H)):
        _fail("K3 differs from its first design on the trial-decode lanes")
    nl = lanes[1].shape[0]

    def check_trial(ref, p_ms, got=got.cpu(),
                    what=f"{nl} lanes of {len(cands)} candidate blocks "
                    f"({W}x{H})"):
        err = int((got.long() - ref.long()).abs().max())
        k3["err"] = max(k3["err"], err)
        print(f"K3 trial decodes A1-t frame 0: {what} vs the plain version "
              f"(on the host CPU, {p_ms:.1f} ms): max_abs_err {err} "
              f"[{card}]", flush=True)
        if err:
            _fail("K3 disagrees with its plain version on the trial-decode "
                  "lanes")
    on_host(hw_validate.plain_decode_ms, tuple(lanes) + (W, H),
            check_trial)
    v1_ms, k_ms = turns_ms(
        dev, lambda: t1_decode.t1_decode_lanes_v1(*lanes, W, H),
        lambda: t1_decode.t1_decode_lanes(*lanes, W, H))
    # the slowest lane alone, in both designs: v1 runs 32 lanes in one
    # instruction stream, v2 one lane per warp
    est = lanes[2].long() * lanes[5] * lanes[6]
    one = (lanes[0],) + _select(lanes[1:], torch.arange(nl, device=dev)
                                == int(torch.argmax(est)))
    one_v1, one_v2 = turns_ms(
        dev, lambda: t1_decode.t1_decode_lanes_v1(*one, W, H),
        lambda: t1_decode.t1_decode_lanes(*one, W, H))
    print(f"K3 trial decodes A1-t frame 0 diagnostic: the slowest lane alone "
          f"(npass*w*h {int(est.max())}) v2 {one_v2:.4f} ms, v1 "
          f"{one_v1:.4f} ms [{card}]", flush=True)
    nb = _k3_bytes(lanes, tables)
    print(f"K3 trial decodes A1-t frame 0: every lane equal to v1 bit for "
          f"bit; 1 launch per frame, kernel {k_ms:.4f} ms, v1 {v1_ms:.4f} "
          f"ms, in turns ({v1_ms / k_ms:.2f}x), bound "
          f"{nb / HBM_BYTES_PER_S * 1e3:.4f} ms ({nb} bytes) [{card}]",
          flush=True)

    # ---- 17. the tool's rate-targeted Part-1 serving check ----------------
    r = hw_validate.run_serve_mq_enc_rt(dev)
    if not r["ok"]:
        _fail("hw_validate serve_mq_enc_rt failed")

    # ---- 18. the tool's K3 and K5 checks on 128 dense 64x64 blocks ---------
    for check in ("mq_dec", "mq_enc"):
        r = getattr(hw_validate, f"run_{check}")(dev)
        if not r["ok"]:
            _fail(f"hw_validate {check} failed")
        print(f"{check}: v2 {r['ms']:.4f} ms, v1 {r['prev_ms']:.4f} ms "
              f"({r['prev_ms'] / r['ms']:.2f}x) on the tool's "
              f"{r['blocks']} blocks [{card}]", flush=True)

    # ---- 19. tiled HT (C) and tiled Part-1 (C1) --------------------------
    from grok_tpu_torch.pipeline import serve
    from grok_tpu_torch.util import stream_vectors
    DP = api.DecompressParams
    t0 = time.perf_counter()
    uhd = synthetic_image(2160, 3840, 3, seed=9)
    frames_c = [[torch.from_numpy(np.ascontiguousarray(uhd[..., c])).to(dev)
                 .to(torch.int32) for c in range(3)]]
    torch.cuda.synchronize()
    print(f"setup: the 3840x2160 source made and uploaded in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    pt = dict(num_resolutions=6, tile_w=1024, tile_h=1024)
    tiled = {"C": (CompressParams(ht=True, **pt), "K4", "K1"),
             "C1": (CompressParams(**pt), "K5", "K3")}
    c_hdr = api._build_main_header(2160, 3840, 3, 8, False, tiled["C"][0])
    ntiles = c_hdr.siz.num_tiles
    edge = c_hdr.siz.tile_rect(ntiles - 1)
    print(f"tiled cells: {ntiles} tiles of 1024x1024, the last "
          f"{edge.w}x{edge.h}", flush=True)

    @contextlib.contextmanager
    def per_tile(fn_name, owner, kernel):
        """owner.fn_name wrapped to record `kernel`'s launches per tile
        (the tile index is its third argument or keyword t)."""
        got = {}
        real = getattr(owner, fn_name)

        def spy(*a, **k):
            t = k.get("t", a[3] if len(a) > 3 else 0) \
                if fn_name == "try_encode_serving_batch" else a[2]
            n0 = counts()[kernel]
            try:
                return real(*a, **k)
            finally:
                got[t] = counts()[kernel] - n0
        setattr(owner, fn_name, spy)
        try:
            yield got
        finally:
            setattr(owner, fn_name, real)

    def stage_tiles(stream, dp):
        """Each decoded tile's staged work (served, or on the general
        route), as decompress_device stages it."""
        dp = api._params(dp)
        cs, hdr, by_tile, tile_body = api._tiles(stream, dp)
        out = []
        for t in sorted(by_tile):
            rect = hdr.siz.tile_rect(t)
            if dp.window is not None and \
                    rect.intersect(Rect(*dp.window)).empty:
                continue
            th, body = tile_body(t)
            try:
                out.append(serve.stage_serving_batch(cs, hdr, t, th, [body],
                                                     dp, device=dev))
            except serve.GeneralRoute:
                out.append(tile.stage_general(cs, hdr, t, th, body, dp,
                                              device=dev))
        return out

    def live_lanes(staged) -> int:
        n = 0
        for s in staged:
            if isinstance(s, serve.StagedBatch):
                m = s.meta.cpu().numpy()
                n += int(((m[:, 5] != 0) | (m[:, 8] > 0)).sum())
            else:
                n += sum(int((m[:, 9] > 0).sum()) for m in s.meta)
                n += 0 if s.mq is None else s.mq[1].shape[0]
        return n

    def split_decode(name, stream, dp):
        """Best and median of REPS host stagings and synced device runs
        of every tile after a warm-up."""
        [s.run() for s in stage_tiles(stream, dp)]
        host, devt = [], []
        for _ in range(REPS):
            staged, dt = timed(lambda: stage_tiles(stream, dp))
            host.append(dt)
            devt.append(timed(lambda: [s.run() for s in staged])[1])
        print(f"split decode {name}: host parse+stage+upload best "
              f"{min(host) * 1e3:.3f} ms (median "
              f"{float(np.median(host)) * 1e3:.3f}), device blocks+"
              f"synthesis best {min(devt) * 1e3:.3f} ms (median "
              f"{float(np.median(devt)) * 1e3:.3f}), {len(staged)} tiles "
              f"[{card}]", flush=True)
        return staged

    t_new = time.perf_counter()
    tiled_streams = {}
    for name, (params, kenc, kdec) in tiled.items():
        counts_zero()
        times = []
        with per_tile("try_encode_serving_batch", api, kenc) as enc_tile:
            for _ in range(REPS + 1):
                out, dt = timed(lambda: api.compress_device_batch(
                    frames_c, params, device=dev))
                times.append(dt)
                if name in tiled_streams and out != tiled_streams[name]:
                    _fail(f"encode {name}: reps gave different bytes")
                tiled_streams[name] = out
        got = counts()
        report("encode", name, times, 1, 3840 * 2160)
        need(f"{name} encode", got, [kenc],
             ["K2", "K4r"] + v1s + (["K5"] if kenc == "K4" else ["K4"]))
        print(f"encode {name}: {len(tiled_streams[name][0])} bytes; {kenc} "
              f"launches per tile {[enc_tile[t] for t in range(ntiles)]}",
              flush=True)
        if got[kenc] != ntiles * (REPS + 1) or set(enc_tile.values()) \
                != {1}:
            _fail(f"encode {name}: not one {kenc} launch per tile")
        comps = [torch.stack([f[ci] for f in frames_c]) for ci in range(3)]
        host = _host_split(serve_enc, tile, lambda: timed(
            lambda: api.compress_device_batch(frames_c, params,
                                              device=dev))[1])

        def device_part():
            for t in range(ntiles):
                r = c_hdr.siz.tile_rect(t)
                tc = [c[:, r.y0:r.y1, r.x0:r.x1].contiguous() for c in comps]
                plan, lanes = serve_enc.stage_encode_lanes(tc, c_hdr, params,
                                                           t)
                if plan.coder == "ht":
                    ht_encode.ht_encode_lanes(*lanes, *plan.caps)
                else:
                    t1_encode.t1_encode_lanes(
                        *serve_enc.mq_lane_inputs(plan, lanes),
                        *plan.mq_caps)
        device_part()
        dev_s = [timed(device_part)[1] for _ in range(REPS)]
        print(f"split encode {name}: device staging + block coders of all "
              f"tiles best {min(dev_s) * 1e3:.3f} ms (median "
              f"{float(np.median(dev_s)) * 1e3:.3f}); C wire assembly "
              f"{host['assemble'] * 1e3:.3f} ms, Tier-2 finish "
              f"{host['finish'] * 1e3:.3f} ms, whole call "
              f"{host['call'] * 1e3:.3f} ms [{card}]", flush=True)

        counts_zero()
        times = []
        with per_tile("_decode_tile_on", api, kdec) as dec_tile:
            for _ in range(REPS + 1):
                out, dt = timed(lambda: api.decompress_device_batch(
                    tiled_streams[name], device=dev))
                times.append(dt)
                if not np.array_equal(pixels(out[0]), uhd):
                    _fail(f"decode {name}: pixels differ from the source")
        got = counts()
        report("decode", name, times, 1, 3840 * 2160)
        need(f"{name} decode", got, [kdec], ["K2"] + v1s)
        print(f"decode {name}: bit-exact to the source; {kdec} launches per "
              f"tile {[dec_tile[t] for t in range(ntiles)]}", flush=True)
        if kdec == "K3" and set(dec_tile.values()) != {1}:
            _fail(f"decode {name}: not one K3 launch per tile")
        split_decode(name, tiled_streams[name][0], DP())
    small_t = synthetic_image(136, 200, 3, seed=21)
    for name, (params, _ke, _kd) in tiled.items():
        sp = replace(params, tile_w=64, tile_h=64)
        if api.compress_device(small_t, sp, device=dev) != \
                api.compress_device(small_t, sp, device="cpu"):
            _fail(f"tiled {name} encode on the card differs from the plain "
                  f"versions on the CPU")
        print(f"encode reference {name}: 200x136 RGB in 64-px tiles "
              f"byte-identical to the CPU encode through the plain "
              f"versions", flush=True)

    # ---- 20. windows: (C-win) on (C), (B-win) on (B) and (B-r) -----------
    wins = {"C-win": ("C", tiled_streams["C"][0], (1000, 700, 2024, 1724),
                      uhd),
            "B-win": ("B", streams["B"][0], (333, 211, 845, 723), rgb[0]),
            "B-r-win": ("B-r", streams["B-r"][0], (333, 211, 845, 723),
                        None)}
    for name, (base, stream, window, src) in wins.items():
        dp = DP(window=window)
        x0, y0, x1, y1 = window
        counts_zero()
        times = []
        with per_tile("_decode_tile_on", api, "K1") as dec_tile:
            for _ in range(REPS + 1):
                out, dt = timed(lambda: api.decompress_device(stream, dp,
                                                              device=dev))
                times.append(dt)
        got = counts()
        report("decode", name, times, 1, (x1 - x0) * (y1 - y0))
        inside = pixels(out)[y0:y1, x0:x1]
        if src is None:      # (B-r): its full decode inside the window
            src = pixels(api.decompress_device(stream, device=dev))
        if not np.array_equal(inside, src[y0:y1, x0:x1]):
            _fail(f"decode {name}: pixels inside the window differ")
        need(f"{name} decode", got, ["K2"] if base == "B-r" else ["K1"],
             v1s)
        n_win = live_lanes(stage_tiles(stream, dp))
        n_full = live_lanes(stage_tiles(stream, DP()))
        tiles_hit = sorted(dec_tile) if dec_tile else [0]
        print(f"decode {name}: {x1 - x0}x{y1 - y0} window at ({x0}, {y0}) "
              f"equal to the {'full decode' if base == 'B-r' else 'source'} "
              f"inside; {n_win} live lanes against {n_full} for the whole "
              f"{base}; tiles decoded {tiles_hit}", flush=True)
        if not 0 < n_win < n_full:
            _fail(f"decode {name}: the window did not cut the lanes")
        if base == "C" and tiles_hit != [0, 1, 4, 5]:
            _fail(f"decode {name}: decoded tiles {tiles_hit}, not the "
                  f"four the window meets")
        split_decode(name, stream, dp)

    # ---- 21. the general route on the committed streams (M) --------------
    gen_k3 = {}
    for name, (data, hashes) in stream_vectors.load().items():
        for k in stream_vectors.LAYER_CAPS:
            counts_zero()
            times = []
            for _ in range(REPS + 1):
                out, dt = timed(lambda: api.decompress_device(
                    data, DP(max_layers=k), device=dev))
                times.append(dt)
                if stream_vectors.plane_hash(out) != hashes[k]:
                    _fail(f"decode M {name} at max_layers={k}: planes "
                          f"differ from the committed hash")
            got = counts()
            gen_k3[(name, k)] = got["K3"] // (REPS + 1)
            npx = out[0].shape[0] * out[0].shape[1]
            report("decode", f"M {name} max_layers={k}", times, 1, npx)
            need(f"M {name} decode", got, ["K3"], ["K2"] + v1s)
            print(f"decode M {name} max_layers={k}: equal to the committed "
                  f"hash; launches per decode K3 {gen_k3[(name, k)]}, K1 "
                  f"{got['K1'] // (REPS + 1)}", flush=True)
        staged = split_decode(f"M {name}", data, DP())[0]
        lanes = staged.mq
        (W, H, _b), = staged.program.mq_groups
        nl_all = lanes[1].shape[0]
        if not torch.equal(t1_decode.t1_decode_lanes(*lanes, W, H),
                           t1_decode.t1_decode_lanes_v1(*lanes, W, H)):
            _fail(f"K3 differs from its first design on M {name}")
        v1_ms, k_ms = turns_ms(
            dev, lambda: t1_decode.t1_decode_lanes_v1(*lanes, W, H),
            lambda: t1_decode.t1_decode_lanes(*lanes, W, H))
        nb = _k3_bytes(lanes, tables)
        styles = sorted({hex(s) for s in lanes[7].tolist()})
        print(f"K3 M {name} (general route, styles {styles}): all {nl_all} "
              f"lanes equal to v1 bit for bit; v2 {k_ms:.4f} ms, v1 "
              f"{v1_ms:.4f} ms, in turns ({v1_ms / k_ms:.2f}x), bound "
              f"{nb / HBM_BYTES_PER_S * 1e3:.4f} ms ({nb} bytes) [{card}]",
              flush=True)
        # the bottom-edge lanes (h <= EDGE_H, or the flattest lanes where
        # no block is that flat), as phase 9 takes them
        He = max(EDGE_H, int(lanes[6].min()))
        edge = (lanes[0],) + _select(lanes[1:], lanes[6] <= He)
        We, nle = int(edge[5].max()), edge[1].shape[0]
        got = t1_decode.t1_decode_lanes(*edge, We, He)
        ref, p_ms = _plain_ms(torch, lambda: t1_decode.t1_decode_lanes_ref(
            *edge, We, He))
        err = int((got.long() - ref.long()).abs().max())
        k3["err"] = max(k3["err"], err)
        e_v1, e_ms = turns_ms(
            dev, lambda: t1_decode.t1_decode_lanes_v1(*edge, We, He),
            lambda: t1_decode.t1_decode_lanes(*edge, We, He))
        print(f"K3 M {name}: {nle} bottom-edge lanes ({We}x{He}) vs the "
              f"plain version: max_abs_err {err}; v2 {e_ms:.4f} ms, v1 "
              f"{e_v1:.4f} ms in turns, plain version {p_ms:.1f} ms "
              f"[{card}]", flush=True)
        if err:
            _fail(f"K3 disagrees with its plain version on M {name}")
    print(f"tiled, window and general-route phases: "
          f"{time.perf_counter() - t_new:.1f} s", flush=True)

    # ---- 22. damaged, packed-header and ROI streams (T, P, R) ------------
    from grok_tpu_torch.t2 import parse as t2parse
    from grok_tpu_torch.util import damaged_vectors
    t_dmg = time.perf_counter()
    dstreams, dhashes = damaged_vectors.all_streams()
    # row: (cases, kernels per decode: {kernel: launches, or None for at
    # least one})
    drows = {
        "T-m1": (["m1_cut50", "m1_cut50_L1", "m1_cut80", "m1_cut80_L1"],
                 {"K3": 1}),
        "T-m2": (["m2_cut50"], {"K3": 1}),
        "T-mix": (["mmix_cut80"], {"K1": None, "K3": 1}),
        "T-h": (["h_cut50", "h_cut80"], {"K1": None}),
        "P": (["ppm", "ppt", "sop_flip"], {"K3": 1}),
        "R": (["roi", "roi_win"], {"K1": None}),
    }
    parse_s = [0.0]
    parse_real = t2parse.parse_packets

    def parse_timed(*a, **k):
        t = time.perf_counter()
        try:
            return parse_real(*a, **k)
        finally:
            parse_s[0] += time.perf_counter() - t

    def dmg_planes(case, out):
        win = damaged_vectors.CASES[case][2].get("window")
        return damaged_vectors.window_planes(out, win) if win else out

    zero_seen = 0
    for row_name, (cases, kneed) in drows.items():
        staged_row = []
        for case in cases:
            data = damaged_vectors.stream(case, dstreams)
            dp = DP(**damaged_vectors.CASES[case][2])
            counts_zero()
            times = []
            for _ in range(REPS_DMG + 1):
                out, dt = timed(lambda: api.decompress_device(data, dp,
                                                              device=dev))
                times.append(dt)
                if stream_vectors.plane_hash(dmg_planes(case, out)) != \
                        dhashes[case]:
                    _fail(f"decode {row_name} {case}: planes differ from "
                          f"the committed hash")
            got = counts()
            per = {k: got[k] / (REPS_DMG + 1) for k in ("K1", "K2", "K3")}
            need(f"{row_name} {case} decode", got, list(kneed),
                 ["K2", "K4", "K4r", "K5"] + v1s
                 + [k for k in ("K1", "K3") if k not in kneed])
            for k, n in kneed.items():
                if n is not None and per[k] != n:
                    _fail(f"decode {row_name} {case}: {per[k]} {k} "
                          f"launches per decode, not {n}")
            best, med = min(times[1:]), float(np.median(times[1:]))
            print(f"decode {row_name} {case}: equal to the committed hash; "
                  f"best of {REPS_DMG}: {best * 1e3:.3f} ms/call (median "
                  f"{med * 1e3:.3f}); launches per decode K1 {per['K1']:g}, "
                  f"K3 {per['K3']:g} [{card}]", flush=True)
            # the host split, with the Python Tier-2 parse apart
            [s.run() for s in stage_tiles(data, dp)]
            host, devt, pms = [], [], []
            t2parse.parse_packets = parse_timed
            try:
                for _ in range(REPS_DMG):
                    parse_s[0] = 0.0
                    staged, dt = timed(lambda: stage_tiles(data, dp))
                    host.append(dt)
                    pms.append(parse_s[0])
                    devt.append(timed(lambda: [s.run() for s in staged])[1])
            finally:
                t2parse.parse_packets = parse_real
            print(f"split decode {row_name} {case}: host parse+stage+upload "
                  f"best {min(host) * 1e3:.3f} ms (median "
                  f"{float(np.median(host)) * 1e3:.3f}), of which the Python "
                  f"Tier-2 parse {min(pms) * 1e3:.3f} ms (median "
                  f"{float(np.median(pms)) * 1e3:.3f}); device blocks+"
                  f"synthesis best {min(devt) * 1e3:.3f} ms (median "
                  f"{float(np.median(devt)) * 1e3:.3f}), {len(staged)} "
                  f"tiles [{card}]", flush=True)
            staged_row += staged
        # K3 and K1 against their plain versions on the row's lanes
        for s in staged_row:
            prog = s.program
            # (bucket index, K1's arguments) of the buckets with HT lanes
            if isinstance(s, serve.StagedBatch):
                ht_lanes = [(bi, prog.stage(s.body, s.meta, bi,
                                            *s.dims[bi][:3]))
                            for bi in range(len(prog.buckets))
                            if s.dims[bi][3]]
                mq_lanes, zero = None, None
            else:
                ht_lanes = [(bi, la[:3] + la[5:9])
                            for bi, la in enumerate(s.lanes)
                            if la is not None]
                mq_lanes, zero = s.mq, s.zero_lanes
            if mq_lanes is not None:
                He = max(EDGE_H, int(mq_lanes[6].min()))
                edge = (mq_lanes[0],) + _select(mq_lanes[1:],
                                                mq_lanes[6] <= He)
                We = int(edge[5].max())
                got = t1_decode.t1_decode_lanes(*edge, We, He)
                ref, p_ms = _plain_ms(torch, lambda: t1_decode
                                      .t1_decode_lanes_ref(*edge, We, He))
                err = int((got.long() - ref.long()).abs().max())
                k3["err"] = max(k3["err"], err)
                print(f"K3 {row_name}: {edge[1].shape[0]} of "
                      f"{mq_lanes[1].shape[0]} lanes ({We}x{He}) vs the "
                      f"plain version: max_abs_err {err}, plain version "
                      f"{p_ms:.1f} ms [{card}]", flush=True)
                if err:
                    _fail(f"K3 disagrees with its plain version on "
                          f"{row_name}")
            # K1: the flattest bucket in full (every lane of it), and the
            # zero lanes' buckets
            zero_b = set()
            if zero is not None and zero.size:
                zero_b = {bi for bi, lo in enumerate(prog.lane_base)
                          for z in zero.tolist()
                          if lo <= z < lo + s.meta[bi].shape[0]}
            flat = min((bi for bi, _la in ht_lanes), default=None,
                       key=lambda bi: (prog.buckets[bi].H,
                                       prog.buckets[bi].W))
            for bi, la in ht_lanes:
                b = prog.buckets[bi]
                if bi != flat and bi not in zero_b:
                    continue
                got, _codes = ht_decode.ht_decode_lanes(*la, b.W, b.H)
                (ref, _c), p_ms = _plain_ms(
                    torch, lambda: ht_decode.ht_decode_lanes_ref(*la, b.W,
                                                                 b.H))
                err = int((got.long() - ref.long()).abs().max())
                k1["err"] = max(k1["err"], err)
                msg = ""
                if bi in zero_b:
                    lo = prog.lane_base[bi]
                    zs = [z - lo for z in zero.tolist()
                          if lo <= z < lo + got.shape[0]]
                    if bool((got[zs] != 0).any()) or \
                            bool((la[6][zs] != 0).any()):
                        _fail(f"K1 gave a zeroed lane of {row_name} a "
                              f"non-zero sample")
                    zero_seen += len(zs)
                    msg = f"; {len(zs)} zeroed lanes (valid 0) all zero"
                print(f"K1 {row_name} bucket {b.W}x{b.H}: {got.shape[0]} "
                      f"lanes vs the plain version: max_abs_err {err}, "
                      f"plain version {p_ms:.1f} ms{msg} [{card}]",
                      flush=True)
                if err:
                    _fail(f"K1 disagrees with its plain version on "
                          f"{row_name}")
    if not zero_seen:
        _fail("no cut HT block reached K1 as a zeroed lane (T-h)")
    print(f"damaged, packed-header and ROI phase: "
          f"{time.perf_counter() - t_dmg:.1f} s", flush=True)

    # ---- 23. wide code-blocks (W) and strict decodes (S) ------------------
    from grok_tpu_torch.util import wide_vectors
    t_wide = time.perf_counter()
    wstreams, whashes, wedits, wstrict = wide_vectors.load()
    for n in wide_vectors.EDITED:
        wstreams[n] = wide_vectors.apply_edits(dstreams["h"], wedits[n])
    # case: (row, the kernels each decode launches: {kernel: launches per
    # decode, or None for at least one})
    wcases = {"wh": ("W-h", {"K1": None}), "whl": ("W-h", {"K1": None}),
              "wr_L1": ("W-r", {}), "wr_L2": ("W-r", {"K2": None}),
              "w1": ("W-1", {"K3": 1}), "w1s_L1": ("W-1s", {"K3": 1}),
              "w1s_L2": ("W-1s", {"K3": 1}),
              "wh_win": ("W-win", {"K1": None}),
              "w1_win": ("W-win", {"K3": 1}), "hbad": ("S", {"K1": None}),
              "hbad_rand": ("S", {"K1": None, "K12i64": None})}
    wide = {}            # (kernel, shape): ms, plain_ms, bytes, launches
    plain_done = set()   # (kernel, W, H) held against the plain version
    flagged = 0
    i64_lanes = [0]      # lanes re-decoded in int64 (recorded launches)

    def wide_rec(kernel, W, H):
        return wide.setdefault((kernel, f"{W}x{H}"), {
            "ms": 0.0, "plain_ms": 0.0, "bytes": 0, "launches": 0,
            "lanes": 0, "plain_lanes": 0})

    @contextlib.contextmanager
    def recorded():
        """Every K1/K2 and K3 launch of the decode paths recorded, with
        its arguments and result, as (kernel, arguments, result); the
        launch counts stay on the wrappers."""
        calls = []
        spots = ((ht_decode, pdevice, "ht_decode_lanes"),
                 (t1_decode, pdevice, "t1_decode_lanes"))
        saved = []
        for mod, alias, name in spots:
            real = getattr(mod, name)

            def spy(*a, _real=real, _name=name, **kw):
                out = _real(*a, **kw)
                kern = "K3" if _name == "t1_decode_lanes" else (
                    "K12i64" if kw.get("i64") else
                    "K2" if len(a) > 9 else "K1")
                calls.append((kern, a, out))
                return out
            # the wrappers count their launches on the name they are
            # called by: the spy's counts go back to them below
            spy.launches = spy.refine_launches = spy.i64_launches = 0
            saved.append((mod, alias, name, real, spy))
            setattr(mod, name, spy)
            setattr(alias, name, spy)
        try:
            yield calls
        finally:
            for mod, alias, name, real, spy in saved:
                setattr(mod, name, real)
                setattr(alias, name, real)
                real.launches += spy.launches
                if hasattr(real, "refine_launches"):
                    real.refine_launches += spy.refine_launches
                    real.i64_launches += spy.i64_launches

    def held_lanes(keep, w, h, more_key):
        """The lanes of a main-path launch held against the plain
        version: the largest of `keep` (its block's full size, the most
        `more_key` among those) and up to 15 of the smallest."""
        area = w.long() * h.long()
        big = torch.where(keep, area * (1 << 20) + more_key.long(), -1)
        j = int(torch.argmax(big))
        small = torch.nonzero(keep)[:, 0]
        small = small[torch.argsort(area[small], stable=True)]
        small = small[small != j][:15]
        return torch.cat([small, torch.tensor([j], device=dev)])

    for case, (row_name, kneed) in wcases.items():
        name, kw = wide_vectors.CASES[case]
        data = wstreams[name]
        dp = DP(**kw)
        win = kw.get("window")
        counts_zero()
        times = []
        for rep in range(REPS_DMG + 1):
            # the warm-up decode's launches are recorded and held below
            with (recorded() if rep == 0 else
                  contextlib.nullcontext()) as rec:
                out, dt = timed(lambda: api.decompress_device(data, dp,
                                                              device=dev))
            if rep == 0:
                calls = rec
            times.append(dt)
            planes = damaged_vectors.window_planes(out, win) if win else out
            if stream_vectors.plane_hash(planes) != whashes[case]:
                _fail(f"decode {row_name} {case}: planes differ from the "
                      f"committed hash")
        got = counts()
        per = {k: got[k] / (REPS_DMG + 1)
               for k in ("K1", "K2", "K3", "K12i64")}
        # the int64 re-decode runs only where a corrupt block is marked
        need(f"{row_name} {case} decode", got, list(kneed),
             ["K4", "K4r", "K5"] + v1s
             + ([] if name in wide_vectors.EDITED else ["K12i64"]))
        for k, n in kneed.items():
            if n is not None and per[k] != n:
                _fail(f"decode {row_name} {case}: {per[k]} {k} launches per "
                      f"decode, not {n}")
        rec_n = {k: sum(c[0] == k for c in calls)
                 for k in ("K1", "K2", "K3", "K12i64")}
        if any(rec_n[k] != per[k] for k in rec_n):
            _fail(f"decode {row_name} {case}: {rec_n} launches recorded, "
                  f"{per} counted per decode")
        best, med = min(times[1:]), float(np.median(times[1:]))
        print(f"decode {row_name} {case}: equal to the committed hash"
              f"; best of {REPS_DMG}: {best * 1e3:.3f} ms/call (median "
              f"{med * 1e3:.3f}); launches per decode K1 {per['K1']:g}, K2 "
              f"{per['K2']:g}, K3 {per['K3']:g}, int64 re-decodes "
              f"{per['K12i64']:g} [{card}]", flush=True)
        # the main path's own launches against the plain versions
        for kern, a, res in calls:
            if kern == "K3":
                W, H = a[9], a[10]
                if max(W, H) <= 64 or ("K3", W, H) in plain_done:
                    continue
                plain_done.add(("K3", W, H))
                lanes = a[:9]
                sel = held_lanes(lanes[2] > 0, lanes[5], lanes[6], lanes[2])
                sub = (lanes[0],) + tuple(t.index_select(0, sel)
                                          for t in lanes[1:])
                ref, p_ms = _plain_ms(torch, lambda: t1_decode
                                      .t1_decode_lanes_ref(*sub, W, H))
                e = int((res[sel].long() - ref.long()).abs().max())
                k3["err"] = max(k3["err"], e)
                if e:
                    _fail(f"K3 disagrees with its plain version on the "
                          f"wide lanes of {case} ({W}x{H})")
                r = wide_rec("K3", W, H)
                r["plain_ms"] += p_ms
                r["plain_lanes"] += int(sel.numel())
                print(f"K3 {case} ({W}x{H} lanes): {sel.numel()} of the "
                      f"main path's {lanes[1].shape[0]} lanes (the largest "
                      f"{int(sub[5][-1])}x{int(sub[6][-1])}, "
                      f"{int(sub[2][-1])} passes) equal to the plain "
                      f"version, plain version {p_ms:.1f} ms [{card}]",
                      flush=True)
                continue
            W, H = a[7], a[8]
            lanes, more = a[:7], a[9:]
            got_k, err = res
            if kern == "K12i64":
                # the marked lanes' int64 re-decode, whole, against the
                # plain version's int64 mode
                ref, rerr = ht_decode.ht_decode_lanes_ref(
                    *lanes, W, H, *more, i64=True)
                if not (torch.equal(got_k, ref) and torch.equal(err, rerr)):
                    _fail(f"the int64 re-decode of {case}'s marked lanes "
                          f"({W}x{H}) disagrees with its plain version")
                i64_lanes[0] += int(err.numel())
                print(f"K1/K2 int64 re-decode {case} {W}x{H}: "
                      f"{err.numel()} marked lanes equal to the plain "
                      f"version's int64 mode (largest |sample| "
                      f"{int(got_k.abs().max())}) [{card}]", flush=True)
                continue
            kd = k1 if kern == "K1" else k2
            bad = (err != 0) & (err != ht_decode.MARK_I64)
            nerr = int(bad.sum())
            if case not in wide_vectors.EDITED and nerr:
                _fail(f"{kern} flagged {nerr} lanes of the intact {case}")
            if nerr and bool(got_k[bad].any()):
                _fail(f"{kern} gave a flagged lane a non-zero sample")
            flagged += nerr
            checks = []
            if nerr:
                checks.append(("flagged", torch.nonzero(bad)[:16, 0]))
            if max(W, H) > 64 and (kern, W, H) not in plain_done:
                plain_done.add((kern, W, H))
                checks.append(("wide", held_lanes(lanes[6] == 1, lanes[4],
                                                  lanes[5], -lanes[3])))
            for what, sel in checks:
                sub = tuple(t.index_select(0, sel) for t in lanes + more)
                (ref, rerr), p_ms = _plain_ms(torch, lambda: ht_decode
                                              .ht_decode_lanes_ref(
                                                  *sub[:7], W, H, *sub[7:]))
                e = int((got_k[sel].long() - ref.long()).abs().max())
                kd["err"] = max(kd["err"], e)
                if e or not torch.equal(err[sel], rerr):
                    _fail(f"{kern} disagrees with its plain version on the "
                          f"{what} lanes of {case} ({W}x{H})")
                if what == "wide":
                    r = wide_rec(kern, W, H)
                    r["plain_ms"] += p_ms
                    r["plain_lanes"] += int(sel.numel())
                    print(f"{kern} {case} wide bucket {W}x{H}: {sel.numel()}"
                          f" of the main path's {lanes[0].shape[0]} lanes "
                          f"(the largest {int(sub[4][-1])}x{int(sub[5][-1])}"
                          f") equal to the plain version, error codes "
                          f"included, plain version {p_ms:.1f} ms [{card}]",
                          flush=True)
                else:
                    print(f"{kern} {case} bucket {W}x{H}: {nerr} lanes "
                          f"flagged (codes {sorted(set(err[bad].tolist()))})"
                          f", all zero; {sel.numel()} equal to the plain "
                          f"version, error codes included [{card}]",
                          flush=True)
        # the wide launches timed (after the counted run; each bound from
        # the staged meta of its bucket)
        for s in stage_tiles(data, dp):
            prog = s.program
            # (bucket, kernel, its lanes' K1 arguments, K2's three more,
            # their meta rows), the lanes each launch of the path takes
            if isinstance(s, serve.StagedBatch):
                hts = [(bi, "K1", prog.stage(s.body, s.meta, bi,
                                             *s.dims[bi][:3]), (),
                        prog.lane_meta(s.meta, bi))
                       for bi in range(len(prog.buckets)) if s.dims[bi][3]]
                mq = prog.stage_mq(s.body, s.meta) \
                    if any(d[4] for d in s.dims) else None
            else:
                hts = []
                for bi, la in enumerate(s.lanes):
                    if la is None:
                        continue
                    # decode_ht_blocks: K1 on the cleanup-only lanes, K2
                    # on the refined ones
                    for kern, mask in (("K1", ~la[10]), ("K2", la[10])):
                        if not mask.any():
                            continue
                        idx = torch.from_numpy(np.nonzero(mask)[0]).to(dev)
                        hts.append((bi, kern, tuple(
                            t.index_select(0, idx) for t in la[:3] + la[5:9]),
                            tuple(t.index_select(0, idx) for t in
                                  la[3:5] + la[9:10]) if kern == "K2"
                            else (), torch.from_numpy(s.meta[bi]).to(dev)
                            .index_select(0, idx)))
                mq = s.mq
            lut = ht_decode._lut_on(dev)
            for bi, kern, base, more, meta in hts:
                b = prog.buckets[bi]
                if max(b.W, b.H) <= 64:
                    continue
                k_ms = kernel_ms(dev, lambda: ht_decode.ht_decode_lanes(
                    *base, b.W, b.H, *more))
                nb = _k1_bytes(meta, base, lut) if kern == "K1" else \
                    _k2_bytes(meta, base[:3] + more[:2] + base[3:]
                              + more[2:], lut)
                r = wide_rec(kern, b.W, b.H)
                r["ms"] += k_ms
                r["bytes"] += nb
                r["launches"] += 1
                r["lanes"] += int(base[0].shape[0])
                print(f"{kern} {case} wide bucket {b.W}x{b.H}: "
                      f"{base[0].shape[0]} lanes v2 {k_ms:.4f} ms, bound "
                      f"{nb / HBM_BYTES_PER_S * 1e3:.4f} ms ({nb} bytes) "
                      f"[{card}]", flush=True)
            if mq is not None:
                for W, H, bis in prog.mq_groups:
                    if max(W, H) <= 64:
                        continue
                    if len(prog.mq_groups) > 1:
                        _fail(f"K3 {case}: a tile of several K3 groups")
                    k_ms = kernel_ms(dev, lambda: t1_decode.t1_decode_lanes(
                        *mq, W, H))
                    nb = _k3_bytes(mq, tables)
                    r = wide_rec("K3", W, H)
                    r["ms"] += k_ms
                    r["bytes"] += nb
                    r["launches"] += 1
                    r["lanes"] += int(mq[1].shape[0])
                    print(f"K3 {case} ({W}x{H} lanes): {mq[1].shape[0]} "
                          f"lanes v2 {k_ms:.4f} ms, bound "
                          f"{nb / HBM_BYTES_PER_S * 1e3:.4f} ms ({nb} bytes)"
                          f" [{card}]", flush=True)
    if not flagged:
        _fail("no lane of the broken HT stream was flagged")
    if not i64_lanes[0]:
        _fail("no lane of hbad_rand was re-decoded in int64")
    for kern, W, H in (("K1", 1024, 4), ("K2", 0, 0), ("K3", 0, 0)):
        if not any(k == kern and (W == 0 or (w, h) == (W, H))
                   for k, w, h in plain_done):
            _fail(f"no wide {kern} launch {'' if not W else f'at {W}x{H} '}"
                  f"of the main path was held against its plain version")

    # strict decodes: the committed outcomes of the JAX package's
    def strict_outcome(data):
        try:
            out = api.decompress_device(data, DP(strict=True), device=dev)
        except Exception as e:            # noqa: BLE001: compared below
            return (type(e).__name__, str(e))
        return ("planes", stream_vectors.plane_hash(out))
    sstreams = dict(wstreams)
    sstreams["m1"] = dstreams["m1"]
    for key, want in wstrict.items():
        data = sstreams[key] if key in sstreams else \
            damaged_vectors.stream(key, dstreams)
        t0 = time.perf_counter()
        got = strict_outcome(data)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if got != want:
            _fail(f"strict decode of {key}: {got}, not {want}")
        print(f"strict decode S {key}: {got[0]}"
              f"{'' if got[0] == 'planes' else ': ' + got[1]} as committed "
              f"({dt * 1e3:.1f} ms) [{card}]", flush=True)
    print(f"wide code-block and strict phase: "
          f"{time.perf_counter() - t_wide:.1f} s", flush=True)

    # ---- 24. the general encode (E-dci, E-lay, E-w) ------------------------
    from grok_tpu_torch.core.params import Poc, ProgOrder, RsizProfile
    from grok_tpu_torch.util import enc_vectors
    t_gen = time.perf_counter()
    REPS_GEN = 3

    @contextlib.contextmanager
    def enc_recorded():
        """Every K4/K4r and K5 launch of the serving encode recorded, with
        its arguments and result (the counts stay on the wrappers)."""
        calls, saved = [], []
        for name in ("ht_encode_lanes", "t1_encode_lanes"):
            real = getattr(serve_enc, name)

            def spy(*a, _real=real, _name=name, **kw):
                out = _real(*a, **kw)
                kern = "K5" if _name == "t1_encode_lanes" else (
                    "K4r" if kw.get("refine") else "K4")
                calls.append((kern, a, out))
                return out
            saved.append((name, real))
            setattr(serve_enc, name, spy)
        try:
            yield calls
        finally:
            for name, real in saved:
                setattr(serve_enc, name, real)

    def encode_cell(row_name, frame, params, prec=8, record=False):
        """A warm-up and REPS_GEN encodes of one frame on the card, every
        rep the same bytes; the host split of one more call.  Returns
        (stream, the warm-up's recorded launches, launch counts)."""
        counts_zero()
        times, out, calls = [], None, []
        for rep in range(REPS_GEN + 1):
            with (enc_recorded() if record and rep == 0 else
                  contextlib.nullcontext()) as rec:
                s, dt = timed(lambda: api.compress_device(
                    frame, params, prec=prec, device=dev))
            if rep == 0 and record:
                calls = rec
            times.append(dt)
            if out is not None and s != out:
                _fail(f"encode {row_name}: reps gave different bytes")
            out = s
        got = counts()
        best, med = min(times[1:]), float(np.median(times[1:]))
        host = _host_split(serve_enc, tile, lambda: timed(
            lambda: api.compress_device(frame, params, prec=prec,
                                        device=dev))[1])
        print(f"encode {row_name}: {len(out)} bytes; best of {REPS_GEN}: "
              f"{best * 1e3:.3f} ms/call (median {med * 1e3:.3f}); one more "
              f"call {host['call'] * 1e3:.3f} ms: C wire assembly "
              f"{host['assemble'] * 1e3:.3f} ms, Tier-2 finish "
              f"{host['finish'] * 1e3:.3f} ms (truncation refinement "
              f"{host['refine'] * 1e3:.3f} ms); launches per encode K4 "
              f"{got['K4'] / (REPS_GEN + 1):g}, K4r "
              f"{got['K4r'] / (REPS_GEN + 1):g}, K5 "
              f"{got['K5'] / (REPS_GEN + 1):g}, K3 "
              f"{got['K3'] / (REPS_GEN + 1):g} [{card}]", flush=True)
        return out, calls, got

    def upload(img):
        return [torch.from_numpy(np.ascontiguousarray(img[..., c])).to(dev)
                .to(torch.int32) for c in range(img.shape[2])]

    # E-dci: a digital-cinema 2K frame, 12-bit, CINEMA_2K
    dci_img = synthetic_image(1080, 2048, 3, seed=11).astype(np.int32) << 4
    dci_p = CompressParams(
        irreversible=True, num_resolutions=6, cblk_w_exp=5, cblk_h_exp=5,
        prec_w_exps=[7] + [8] * 5, prec_h_exps=[7] + [8] * 5,
        prog_order=ProgOrder.CPRL, max_tile_parts=3, write_tlm=True,
        rates=[8.0], rsiz=RsizProfile.CINEMA_2K)
    dci, _c, got = encode_cell("E-dci", upload(dci_img), dci_p, prec=12)
    need("E-dci encode", got, ["K5", "K3"], ["K4", "K4r", "K1", "K2"] + v1s)
    ceiling = 1_302_083                    # DCI 2K at 24 fps
    if len(dci) > ceiling:
        _fail(f"E-dci: {len(dci)} bytes over the {ceiling}-byte ceiling")
    hdr = j2k.read_main_header(dci)
    parts = j2k.read_tile_parts(dci, hdr)
    if (len(parts) != 3 or len(hdr.tlm) != 3 or hdr.rsiz & 0xFFF != 3
            or hdr.cod.comp.prec_exps != [(7, 7)] + [(8, 8)] * 5
            or hdr.cod.prog_order != ProgOrder.CPRL):
        _fail(f"E-dci: {len(parts)} tile-parts, {len(hdr.tlm)} TLM "
              f"entries, Rsiz {hdr.rsiz:#x}, precincts "
              f"{hdr.cod.comp.prec_exps}, not the CINEMA_2K layout")
    out, dt = timed(lambda: api.decompress_device(dci, device=dev))
    mse = sum(float(((o.double() - torch.from_numpy(dci_img[..., c]).to(dev)
                      .double()) ** 2).mean()) for c, o in enumerate(out)) / 3
    psnr = 10 * np.log10(4095.0 ** 2 / mse)
    # the plain versions' CPU decode of the lowest resolution (reduce 5,
    # 12 Part-1 lanes: a whole-frame plain decode takes many minutes)
    low = api.decompress_device(dci, DP(reduce=5), device=dev)
    cpu, cpu_s = timed(lambda: api.decompress_device(dci, DP(reduce=5),
                                                     device="cpu"))
    e = max(int((o.cpu().long() - c_.long()).abs().max())
            for o, c_ in zip(low, cpu))
    if e > 1:
        _fail(f"E-dci: the card's decode at reduce 5 differs by {e} from "
              f"the plain versions'")
    print(f"E-dci: {len(dci)} bytes (ceiling {ceiling}), 3 tile-parts with "
          f"TLM, precincts 2^7 at r = 0 and 2^8 above, CPRL; decoded on the "
          f"card in {dt * 1e3:.1f} ms, PSNR {psnr:.2f} dB against the "
          f"source; at reduce 5 ({tuple(low[0].shape)}) within {e} of the "
          f"plain versions' CPU decode ({cpu_s:.1f} s) [{card}]",
          flush=True)

    # E-lay: reversible layouts of the (B) frame, the committed bytes
    lay = enc_vectors.load()
    for name in enc_vectors.NAMES:
        params = CompressParams(**enc_vectors.params(name, Poc, ProgOrder))
        s, _c, got = encode_cell(f"E-lay {name}", frames["B"][0], params)
        need(f"E-lay {name} encode", got,
             ["K4"] if params.ht else ["K5"], ["K4r", "K1", "K2"] + v1s)
        if s != lay[name]:
            _fail(f"E-lay {name}: the card's stream differs from the "
                  f"committed one")
        print(f"E-lay {name}: equal to the committed stream [{card}]",
              flush=True)

    # E-w: the wide code-block streams, encoded on the card
    lut_e = ht_encode._lut_on(dev)
    for name in ("whl", "wh", "wr", "w1"):
        spec, kw = wide_vectors.SPECS[name]
        h, w, ch, seed = spec[:4]
        img = synthetic_image(h, w, ch, seed=seed)[:spec[4] if len(spec) > 4
                                                  else None]
        s, calls, got = encode_cell(f"E-w {name}", upload(img),
                                    CompressParams(**kw), record=True)
        if s != wstreams[name]:
            _fail(f"E-w {name}: the card's stream differs from the "
                  f"committed one")
        rec_n = {k: sum(c[0] == k for c in calls) for k in ("K4", "K4r",
                                                              "K5")}
        if any(rec_n[k] * (REPS_GEN + 1) != got[k] for k in rec_n):
            _fail(f"E-w {name}: {rec_n} launches recorded, {got} counted")
        for kern, a, res in calls:
            H, W = a[0].shape[1:]
            if max(W, H) <= 64:
                continue
            if kern == "K5":
                ins, (L, R) = a[:5], a[5:7]
                sel = held_lanes(ins[2] > 0, ins[3], ins[4], ins[2])
                sub = tuple(t.index_select(0, sel) for t in ins)
                ref, p_ms = _plain_ms(torch, lambda: t1_encode
                                      .t1_encode_lanes_ref(*sub, L, R))
                ok = hw_validate.encodes_equal(
                    tuple(t.index_select(0, sel) for t in res), ref)
                kd, nb = k5, _k5_bytes(ins, res[1], tables)

                def launch(ins=ins, L=L, R=R):
                    return t1_encode.t1_encode_lanes(*ins, L, R)
            else:
                lanes, caps = a[:5], tuple(a[5:8])
                sel = held_lanes(lanes[4] == 1, lanes[2], lanes[3],
                                 (lanes[0] >> 1).amax((1, 2)))
                sub = tuple(t.index_select(0, sel) for t in lanes)
                refine = kern == "K4r"

                def plain():
                    st, bt = ht_encode.ht_encode_lanes_ref(*sub, *caps)
                    if not refine:
                        return st, bt
                    sp, mr, rb, ns = ht_encode.ht_refine_lanes_ref(
                        *sub, *ht_encode.refine_caps(W, H))
                    return torch.cat([st, sp, mr], 1), torch.cat([bt, rb]), ns
                ref, p_ms = _plain_ms(torch, plain)
                allc = caps + (ht_encode.refine_caps(W, H) if refine else ())
                ok = hw_validate.ht_encodes_equal(
                    (res[0].index_select(0, sel), res[1][:, sel])
                    + tuple(t.index_select(0, sel) for t in res[2:]), ref,
                    allc[:-1])
                kd = k4r if refine else k4
                nb = (_k4r_bytes if refine else _k4_bytes)(lanes, res[1],
                                                           lut_e)

                def launch(lanes=lanes, caps=caps, refine=refine):
                    return ht_encode.ht_encode_lanes(*lanes, *caps,
                                                     refine=refine)
            if not ok:
                kd["err"] = max(kd["err"], 1)
                _fail(f"{kern} disagrees with its plain version on the wide "
                      f"lanes of E-w {name} ({W}x{H})")
            k_ms = kernel_ms(dev, launch)
            r = wide_rec(kern, W, H)
            r["ms"] += k_ms
            r["plain_ms"] += p_ms
            r["bytes"] += nb
            r["launches"] += 1
            r["lanes"] += int(a[0].shape[0])
            r["plain_lanes"] += int(sel.numel())
            print(f"{kern} E-w {name} wide bucket {W}x{H}: {sel.numel()} of "
                  f"the main path's {a[0].shape[0]} lanes (the largest "
                  f"first of the held) equal to the plain version, plain "
                  f"version {p_ms:.1f} ms; the launch {k_ms:.4f} ms, bound "
                  f"{nb / HBM_BYTES_PER_S * 1e3:.4f} ms ({nb} bytes) "
                  f"[{card}]", flush=True)
    for kern in ("K4", "K4r", "K5"):
        if not any(k == kern for k, _sh in wide):
            _fail(f"no wide {kern} launch of the general encode was held "
                  f"against its plain version")
    print(f"general encode phase: {time.perf_counter() - t_gen:.1f} s",
          flush=True)

    # ---- 25. mode switches, layered HT-mixed, ROI, custom MCT (E-ms) ------
    from grok_tpu_torch.core.params import MCTMode
    t_ms = time.perf_counter()
    modes = enc_vectors.load_modes()
    # the styled K5 launches: timed, and in turns with the same lanes in
    # the default style
    k5s = {"ms": 0.0, "default_ms": 0.0, "plain_ms": 0.0, "bytes": 0,
           "launches": 0, "lanes": 0, "plain_lanes": 0}
    ms_need = {"ms_3f": ["K5"], "ms_byp": ["K5", "K3"],
               "mix_lay": ["K4", "K5", "K3"], "roi": ["K5"]}
    held = []
    # the held lanes' plain versions run in the host pool (phase 8)
    for name in enc_vectors.MODE_NAMES:
        params = CompressParams(**enc_vectors.params(name, Poc,
                                                     ProgOrder))
        s, calls, got = encode_cell(f"E-ms {name}", frames["B"][0],
                                    params, record=True)
        need(f"E-ms {name} encode", got, ms_need[name],
             ["K4r", "K1", "K2"] + v1s)
        if not enc_vectors.matches(name, s, modes):
            _fail(f"E-ms {name}: the card's stream differs from the "
                  f"committed one")
        print(f"E-ms {name}: equal to the committed stream"
              f"{' (its SHA-256)' if name in enc_vectors.HASHED else ''}"
              f" [{card}]", flush=True)
        for kern, a, res in calls:
            if kern != "K5" or len(a) < 8 or a[7] is None:
                continue
            ins, (L, R), sty = a[:5], a[5:7], a[7]
            sel = held_lanes(ins[2] > 0, ins[3], ins[4], ins[2])
            sub = tuple(t.index_select(0, sel).cpu()
                        for t in ins + (sty,))
            held.append((name, host_pool.submit(
                hw_validate.plain_encode_ms, *sub[:5], L, R, sub[5]),
                tuple(t.index_select(0, sel).cpu() for t in res)))
            d_ms, s_ms = turns_ms(
                dev, lambda: t1_encode.t1_encode_lanes(*ins, L, R),
                lambda: t1_encode.t1_encode_lanes(*ins, L, R, sty))
            nb = _k5_bytes(ins, res[1], tables) + _nbytes(sty)
            nl = int(ins[0].shape[0])
            k5s["ms"] += s_ms
            k5s["default_ms"] += d_ms
            k5s["bytes"] += nb
            k5s["launches"] += 1
            k5s["lanes"] += nl
            k5s["plain_lanes"] += int(sel.numel())
            print(f"K5 E-ms {name} styled launch (style "
                  f"{sorted(set(sty.tolist()))}): {nl} lanes "
                  f"{s_ms:.4f} ms; the same lanes in the default style "
                  f"{d_ms:.4f} ms, in turns; bound "
                  f"{nb / HBM_BYTES_PER_S * 1e3:.4f} ms ({nb} bytes) "
                  f"[{card}]", flush=True)
    # a custom MCT: the same bytes every rep, and the card's encode of
    # a small input equal to the plain versions' on the CPU
    cm_p = CompressParams(ht=True, irreversible=True, num_resolutions=6,
                          mct=MCTMode.CUSTOM,
                          custom_mct=[[0.5, 0.3, 0.2],
                                      [-0.2, 0.5, -0.3],
                                      [0.1, -0.4, 0.3]])
    s, _c, got = encode_cell("E-ms custom", frames["B"][0], cm_p)
    need("E-ms custom encode", got, ["K4"], ["K4r", "K5"] + v1s)
    cm_small = replace(cm_p, num_resolutions=3, cblk_w_exp=5,
                       cblk_h_exp=5)
    if api.compress_device(small_rgb, cm_small, device=dev) != \
            api.compress_device(small_rgb, cm_small, device="cpu"):
        _fail("E-ms custom: the card's encode of 64x96 RGB differs from "
              "the plain versions' on the CPU")
    print(f"E-ms custom: {len(s)} bytes, the same every rep; 64x96 RGB "
          f"byte-identical to the CPU encode through the plain versions "
          f"[{card}]", flush=True)
    for name, fut, got_sub in held:
        ref, p_ms = fut.result()
        if not hw_validate.encodes_equal(got_sub, ref):
            _fail(f"K5 disagrees with its plain version on the styled "
                  f"lanes of E-ms {name}")
        k5s["plain_ms"] += p_ms
        print(f"K5 E-ms {name}: the main path's largest styled lane and "
              f"{got_sub[1].numel() - 1} smallest equal to the plain "
              f"version (on the host CPU, {p_ms:.1f} ms)", flush=True)
    if not k5s["launches"]:
        _fail("no styled K5 launch was held against its plain version")
    print(f"mode-switch phase: {time.perf_counter() - t_ms:.1f} s",
          flush=True)

    # ---- 26. HT code-blocks with Part-1 mode switches (B-sw, B-r-sw) -----
    from grok_tpu_torch.util import stream_edit
    t_sw = time.perf_counter()
    for name, kern in (("B", "K1"), ("B-r", "K2")):
        base = streams[name][0]
        want = api.decompress_device(base, device=dev)
        for bits in (0x3F, 0x01, 0x02, 0x04, 0x08, 0x10, 0x20):
            edited = stream_edit.or_cod_style(base, bits)
            counts_zero()
            got = api.decompress_device(edited, device=dev)
            torch.cuda.synchronize()
            n = counts()
            if n[kern] == 0:
                _fail(f"the {name} stream with style bits {bits:#04x} "
                      f"never launched {kern}")
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                _fail(f"the {name} stream with style bits {bits:#04x} "
                      f"decodes differently from the unedited stream")
        print(f"HT mode switches {name}-sw: the COD style OR'd with 0x3F "
              f"and each of 0x01..0x20 decodes equal to the unedited "
              f"stream, through {kern}", flush=True)
    print(f"HT mode-switch phase: {time.perf_counter() - t_sw:.1f} s",
          flush=True)

    # ---- 27. the mesh: the giant tile (G) and its 9/7 crop (G-97) --------
    from grok_tpu_torch.parallel import Mesh, sharding
    from grok_tpu_torch.parallel.entry import dryrun_multichip
    from grok_tpu_torch.tools import mesh_probe
    t_g = time.perf_counter()
    t0 = time.perf_counter()
    g_img = synthetic_image(G_SIDE, G_SIDE, 1, seed=27)
    g_src = torch.from_numpy(g_img).to(dev)
    torch.cuda.synchronize()
    print(f"setup: the {G_SIDE}x{G_SIDE} source made and uploaded in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    meshes = {"unmeshed": None, "4 virtual shards": Mesh((dev,) * 4)}
    if torch.cuda.device_count() > 1:
        meshes["every card"] = sharding.tile_mesh()
    else:
        print("mesh of every visible card: not run (one card visible)",
              flush=True)
    g_cases = {
        "G": (g_src, CompressParams(num_resolutions=6)),
        "G-97": (g_src[:G_SIDE // 2, :G_SIDE // 2].contiguous(),
                 CompressParams(irreversible=True, num_resolutions=6,
                                num_layers=2, rates=[20.0, 8.0]))}
    sharded = {}
    for name, (src, params) in g_cases.items():
        try:
            got = mesh_probe.giant_tile(
                name, src, params, meshes, dev, G_REPS, f"[{card}]",
                record="4 virtual shards" if name == "G" else None)
        except RuntimeError as e:
            _fail(str(e))
        if name == "G":
            # each shard's launch of the first (warm-up) call, timed
            nsh = meshes["4 virtual shards"].size
            rec = got["4 virtual shards"]
            for kern in ("K5", "K3"):
                row_ = {"cell": "G", "shards": nsh, "lanes": [], "ms": [],
                        "bound_ms": [], "launches": nsh * (G_REPS + 1)}
                for a in rec["k5_calls" if kern == "K5" else "k3_calls"]:
                    if kern == "K5":
                        fn = (lambda a=a: t1_encode.t1_encode_lanes(*a))
                        nb = _k5_bytes(a[:5], fn()[1], tables)
                    else:
                        fn = (lambda a=a: t1_decode.t1_decode_lanes(*a))
                        nb = _k3_bytes(a[:9], tables)
                    row_["lanes"].append(int(a[1].shape[0]))
                    row_["ms"].append(kernel_ms(dev, fn, reps=3))
                    row_["bound_ms"].append(nb / HBM_BYTES_PER_S * 1e3)
                sharded[kern] = row_
                print(f"{kern} {name} per shard: lanes {row_['lanes']}, "
                      f"{[round(x, 4) for x in row_['ms']]} ms, bound "
                      f"{[round(x, 4) for x in row_['bound_ms']]} ms "
                      f"[{card}]", flush=True)
            if not np.array_equal(got["unmeshed"]["planes"].cpu().numpy(),
                                  g_img):
                _fail("decode G: the planes differ from the source")
            print("decode G: meshed and unmeshed bit-exact to the source",
                  flush=True)
        else:
            ref = src.cpu().numpy().astype(np.float64)
            mse = np.mean((got["unmeshed"]["planes"].cpu().numpy() - ref)
                          ** 2)
            print(f"decode G-97: meshed equal to unmeshed, PSNR "
                  f"{10 * np.log10(255 ** 2 / mse):.2f} dB", flush=True)
        del got
    # the finest synthesis level of (G), unsharded and over the meshes
    try:
        mesh_probe.finest_level(g_src, meshes, G_REPS, f"[{card}]")
    except RuntimeError as e:
        _fail(str(e))
    del g_src
    torch.cuda.empty_cache()
    from grok_tpu_torch.t2.rate import Hull
    rng = np.random.default_rng(27)
    slopes = [np.sort(rng.uniform(0.1, 900, int(rng.integers(1, 6))))[::-1]
              for _ in range(4099)]
    got = sharding.pcrd_slope_bounds_sharded(
        [Hull(pass_idx=np.arange(len(x)), slopes=x) for x in slopes],
        meshes["4 virtual shards"])
    flat = np.concatenate(slopes)
    if got != (flat.min() * 0.5, flat.max() * 2.0 + 1.0):
        _fail(f"the PCRD slope collective gave {got}")
    print(f"PCRD slope collective over 4 shards of {len(flat)} slopes: "
          f"{got}, the host's bracket", flush=True)
    dry = dryrun_multichip(4)
    print(f"dryrun_multichip(4): every mesh path on {dry['mesh']}, the "
          f"global statistic {dry['dist']}", flush=True)
    print(f"mesh phase: {time.perf_counter() - t_g:.1f} s", flush=True)

    # ---- 28. two processes over Gloo: (C-dist) and (C1-dist) -------------
    import socket
    import tempfile
    t_mp = time.perf_counter()
    pt_d = dict(num_resolutions=6, tile_w=1024, tile_h=1024, write_tlm=True)
    dist_params = {"C": CompressParams(ht=True, **pt_d),
                   "C1": CompressParams(**pt_d)}
    single = {}
    for name, p in dist_params.items():
        enc_t, dec_t = [], []
        for _ in range(G_REPS + 1):
            data, dt = timed(lambda: api.compress_device(uhd, p, device=dev))
            enc_t.append(dt)
            planes, dt = timed(lambda: api.decompress_device(data,
                                                             device=dev))
            dec_t.append(dt)
        single[name] = (data, planes, min(enc_t[1:]), min(dec_t[1:]))
    with tempfile.TemporaryDirectory() as tmp:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(__file__)))
        env.pop("GROK_COORDINATOR", None)
        procs = [subprocess.Popen(
            [sys.executable, "-c", _DIST_WORKER, str(r), str(port), tmp,
             str(G_REPS)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        outs = []
        try:
            for p_ in procs:
                outs.append(p_.communicate(timeout=DIST_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for p_ in procs:
                p_.kill()
            _fail(f"a distributed worker passed {DIST_TIMEOUT_S} s")
        finally:
            for p_ in procs:
                if p_.poll() is None:
                    p_.kill()
                    p_.wait()
        for r, (p_, o) in enumerate(zip(procs, outs)):
            if p_.returncode != 0:
                _fail(f"distributed worker {r} exited {p_.returncode}:\n"
                      f"{o[-4000:]}")
        w_times = json.loads(outs[0].strip().splitlines()[-1])
        for name in dist_params:
            data, planes, enc_1, dec_1 = single[name]
            with open(os.path.join(tmp, f"{name}.j2k"), "rb") as f:
                if f.read() != data:
                    _fail(f"{name}-dist: process 0's bytes differ from "
                          f"compress_device's")
            got = np.load(os.path.join(tmp, f"{name}.npy"))
            if not np.array_equal(got, pixels(planes)) or \
                    not np.array_equal(got, uhd):
                _fail(f"{name}-dist: process 0's canvases differ from "
                      f"decompress_device's or the source")
            enc_2, dec_2 = w_times[name]
            print(f"{name}-dist: 2 processes on one card over Gloo, "
                  f"process 0's bytes and canvases equal to the single "
                  f"process's; encode best {enc_2 * 1e3:.3f} ms (single "
                  f"process {enc_1 * 1e3:.3f} ms), decode best "
                  f"{dec_2 * 1e3:.3f} ms (single process {dec_1 * 1e3:.3f}"
                  f" ms) of {G_REPS} [{card}]", flush=True)
    print(f"multi-process phase: {time.perf_counter() - t_mp:.1f} s",
          flush=True)

    # ---- 29. mixed filters and encodes past 24 planes ---------------------
    from grok_tpu_torch.util import mixed_vectors
    t_hp = time.perf_counter()
    # (X) the committed mixed-filter streams: component 1 on the 9/7,
    # components 0 and 2 on the 5/3, decoded served and on the general
    # route, whole and in a 512x512 window
    wx0, wy0, wx1, wy1 = mixed_vectors.WINDOW
    REPS_HP = 2
    for name, (data, sha, sha_win, irrev) in mixed_vectors.load().items():
        kern = "K1" if name == "ht" else "K3"
        want97 = torch.from_numpy(irrev.astype(np.int64)).to(dev)
        for route in ("served", "general"):
            for win in (None, mixed_vectors.WINDOW):
                dp = DP(window=win)

                def decode(dp=dp, route=route):
                    if route == "served":
                        return api.decompress_device(data, dp, device=dev)
                    return api.stage_general_device(data, dp,
                                                    device=dev).run()
                counts_zero()
                times = []
                for _rep in range(REPS_HP + 1):     # a warm-up first
                    out, dt = timed(decode)
                    times.append(dt)
                dt = min(times[1:])
                got = counts()
                need(f"X-{name} {route} decode", got, [kern],
                     ["K4", "K4r", "K5"] + v1s)
                planes = [p.cpu().numpy() for p in out]
                p97 = out[mixed_vectors.IRREV_COMP].long()
                if win is None:
                    ok = mixed_vectors.exact_hashes(planes)[0] == sha
                    e97 = int((p97 - want97).abs().max())
                else:
                    ok = mixed_vectors.exact_hashes(planes)[1] == sha_win
                    e97 = int((p97[wy0:wy1, wx0:wx1]
                               - want97[wy0:wy1, wx0:wx1]).abs().max())
                if not ok or e97 > 1:
                    _fail(f"X-{name} {route} {'window' if win else 'whole'}"
                          f": 5/3 planes equal {ok}, 9/7 plane within "
                          f"{e97}")
                print(f"decode X-{name} {route} "
                      f"{'512x512 window' if win else 'whole'}: the 5/3 "
                      f"planes equal the committed hash, the 9/7 plane "
                      f"within {e97}; best of {REPS_HP} {dt * 1e3:.3f} ms, "
                      f"{kern} {got[kern] / (REPS_HP + 1):g} a decode "
                      f"[{card}]", flush=True)

    # (D24) a 1920x1080 24-bit gray frame: lossless HT and Part-1, and HT,
    # Part-1 and refined HT in 3 layers at 40:1, 10:1, 4:1
    # the seed's 8-bit frame spread to 24 bits, its low byte noise, and a
    # 256x512 region of full-range noise whose high-pass magnitudes pass
    # 2^24 (lanes of 25 and more planes)
    rng24 = np.random.default_rng(24)
    deep_img = (synthetic_image(1080, 1920, 1, seed=24).astype(np.int64)
                * 65793).astype(np.int32)
    deep_img ^= rng24.integers(0, 256, deep_img.shape, dtype=np.int32)
    deep_img[:256, :512] = rng24.integers(0, 1 << 24, (256, 512),
                                          dtype=np.int32)
    deep = upload(deep_img[..., None])
    deep_rec = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "launches": 0,
                    "lanes": 0, "plain_lanes": 0} for k in ("K4", "K4r",
                                                            "K5")}
    lay3 = dict(num_layers=3, rates=[40.0, 10.0, 4.0])
    d24 = {"ht": CompressParams(ht=True, num_resolutions=6),
           "p1": CompressParams(num_resolutions=6),
           "ht_lay": CompressParams(ht=True, num_resolutions=6, **lay3),
           "p1_lay": CompressParams(num_resolutions=6, **lay3),
           "ref_lay": CompressParams(ht=True, ht_planes=2,
                                     num_resolutions=6, **lay3)}
    for name, params in d24.items():
        counts_zero()
        times, out, calls = [], None, []
        for rep in range(REPS_HP + 1):
            with (enc_recorded() if rep == 0 else
                  contextlib.nullcontext()) as rec:
                s, dt = timed(lambda: api.compress_device(
                    deep, params, prec=24, device=dev))
            if rep == 0:
                calls = rec
            times.append(dt)
            if out is not None and s != out:
                _fail(f"encode D24 {name}: reps gave different bytes")
            out = s
        got = counts()
        kern = "K4r" if params.ht_planes else "K4" if params.ht else "K5"
        need(f"D24 {name} encode", got, [kern], ["K1", "K2"] + v1s)
        mb = max(serve_enc._plan_for(api._build_main_header(
            1080, 1920, 1, 24, False, params), 0).lane_mb)
        if params.rates:
            hdr24 = api._build_main_header(1080, 1920, 1, 24, False, params)
            res, = serve_enc.try_encode_serving_batch(
                [deep[0][None]], hdr24, params)
            if not out.endswith(res.body + b"\xff\xd9"):
                _fail(f"encode D24 {name}: the tile body differs from the "
                      f"API stream's")
            targets = layer_targets_for_tile(
                layer_budget_consts(hdr24, params), hdr24.siz.tile_rect(0),
                params)
            per = len(res.packet_lens) // 3
            prefix = [int(sum(res.packet_lens[:per * (k + 1)]))
                      for k in range(3)]
            if any(p > t for p, t in zip(prefix, targets)):
                _fail(f"encode D24 {name}: layer prefixes {prefix} over "
                      f"the budgets {targets}")
            dec = [api.decompress_device(out, DP(max_layers=k), device=dev)
                   [0].double() for k in (1, 3)]
            ref = deep[0].double()
            snr = [10 * np.log10(float(((1 << 24) - 1) ** 2
                                       / ((d - ref) ** 2).mean()))
                   for d in dec]
            if not snr[0] < snr[1]:
                _fail(f"decode D24 {name}: PSNR {snr} does not rise")
            budgets = [round(t, 1) for t in targets]
            what = (f"layer prefixes {prefix} within {budgets}; PSNR at 1 "
                    f"and 3 layers {snr[0]:.2f}, {snr[1]:.2f} dB")
        else:
            back = api.decompress_device(out, device=dev)[0]
            if not torch.equal(back, deep[0]):
                _fail(f"decode D24 {name}: not the source")
            what = "decoded back to the source bit for bit"
        print(f"encode D24 {name}: {len(out)} bytes, Mb up to {mb}; "
              f"{what}; best of {REPS_HP}: {min(times[1:]) * 1e3:.3f} "
              f"ms/call; {kern} {got[kern] / (REPS_HP + 1):g} a call "
              f"[{card}]", flush=True)
        # the warm-up's own launches, on their lanes past 24 planes (K5's
        # are held below, on the 64x64 crop: its plain version takes
        # minutes on a 64x64 lane of 27 planes)
        for kn, a, res_ in calls:
            if kn == "K5":
                ins, (L, R) = a[:5], a[5:7]
                keep = ins[2] > 24
                sel, ok, p_ms = torch.zeros(0), True, 0.0
                nb = _k5_bytes(ins, res_[1], tables)

                def launch(ins=ins, L=L, R=R):
                    return t1_encode.t1_encode_lanes(*ins, L, R)
            else:
                lanes, caps = a[:5], tuple(a[5:8])
                H, W = lanes[0].shape[1:]
                mag = (lanes[0] >> 1).amax((1, 2)).long()
                keep = (lanes[4] == 1) & (mag >= (1 << 24))
                sel = held_lanes(keep, lanes[2], lanes[3], mag)
                sub = tuple(t.index_select(0, sel) for t in lanes)
                refine = kn == "K4r"

                def plain(sub=sub, caps=caps, refine=refine, W=W, H=H):
                    st, bt = ht_encode.ht_encode_lanes_ref(*sub, *caps)
                    if not refine:
                        return st, bt
                    sp, mr, rb, ns = ht_encode.ht_refine_lanes_ref(
                        *sub, *ht_encode.refine_caps(W, H))
                    return torch.cat([st, sp, mr], 1), torch.cat([bt, rb]), ns
                ref, p_ms = _plain_ms(torch, plain)
                allc = caps + (ht_encode.refine_caps(W, H) if refine else ())
                ok = hw_validate.ht_encodes_equal(
                    (res_[0].index_select(0, sel), res_[1][:, sel])
                    + tuple(t.index_select(0, sel) for t in res_[2:]), ref,
                    allc[:-1])
                nb = (_k4r_bytes if refine else _k4_bytes)(lanes, res_[1],
                                                           lut_e)

                def launch(lanes=lanes, caps=caps, refine=refine):
                    return ht_encode.ht_encode_lanes(*lanes, *caps,
                                                     refine=refine)
            if not bool(keep.any()):
                _fail(f"D24 {name}: no {kn} lane past 24 planes")
            if not ok:
                {"K4": k4, "K4r": k4r, "K5": k5}[kn]["err"] = 1
                _fail(f"{kn} disagrees with its plain version on the lanes "
                      f"past 24 planes of D24 {name}")
            k_ms = kernel_ms(dev, launch)
            r = deep_rec[kn]
            r["ms"] += k_ms
            r["plain_ms"] += p_ms
            r["bytes"] += nb
            r["launches"] += 1
            r["lanes"] += int(a[0].shape[0])
            r["plain_lanes"] += int(sel.numel())
            held = (f"{sel.numel()} of them (the largest and the 15 "
                    f"smallest) equal to the plain version, plain "
                    f"{p_ms:.1f} ms" if sel.numel() else
                    "held on the 64x64 crop below")
            print(f"{kn} D24 {name}: the main path's {a[0].shape[0]} lanes, "
                  f"{int(keep.sum())} past 24 planes, {held}; the launch "
                  f"{k_ms:.4f} ms, bound {nb / HBM_BYTES_PER_S * 1e3:.4f} ms "
                  f"({nb} bytes) [{card}]", flush=True)
    # a 64x64 crop of the noise (16x16 blocks): the card's encodes equal
    # the plain versions' on the CPU, and its K5 launch's largest lane past
    # 24 planes and 15 smallest equal to the plain version
    crop = np.ascontiguousarray(deep_img[:64, :64])
    d24["ht97"] = CompressParams(ht=True, irreversible=True)   # in float64
    for name in ("ht", "ht97", "p1_lay", "ref_lay"):
        p = replace(d24[name], num_resolutions=3, cblk_w_exp=4, cblk_h_exp=4)
        with enc_recorded() as calls:
            on_card = api.compress_device(crop, p, prec=24, device=dev)
        if on_card != api.compress_device(crop, p, prec=24, device="cpu"):
            _fail(f"D24 {name}: the card's 64x64 encode differs from the "
                  f"plain versions' on the CPU")
        for kn, a, res_ in calls:
            if kn != "K5":
                continue
            ins, (L, R) = a[:5], a[5:7]
            keep = ins[2] > 24
            sel = held_lanes(keep, ins[3], ins[4], ins[2])
            sub = tuple(t.index_select(0, sel) for t in ins)
            ref, p_ms = _plain_ms(torch, lambda: t1_encode
                                  .t1_encode_lanes_ref(*sub, L, R))
            if not bool(keep.any()) or not hw_validate.encodes_equal(
                    tuple(t.index_select(0, sel) for t in res_), ref):
                k5["err"] = 1
                _fail("K5 disagrees with its plain version on the crop's "
                      "lanes past 24 planes (or it has none)")
            deep_rec["K5"]["plain_ms"] += p_ms
            deep_rec["K5"]["plain_lanes"] += int(sel.numel())
            print(f"K5 D24 crop {name}: {sel.numel()} of the launch's "
                  f"{a[0].shape[0]} lanes ({int(keep.sum())} past 24 planes;"
                  f" the largest of those and the 15 smallest) equal to the "
                  f"plain version, plain {p_ms:.1f} ms [{card}]", flush=True)
    for kn, r in deep_rec.items():
        if not r["launches"] or not r["plain_lanes"]:
            _fail(f"no {kn} launch past 24 planes was held against its "
                  f"plain version")
    print(f"D24: 64x64 crops in HT (5/3 and 9/7), layered Part-1 and "
          f"layered refined HT equal to the CPU encode byte for byte",
          flush=True)
    print(f"mixed-filter and high-precision phase: "
          f"{time.perf_counter() - t_hp:.1f} s", flush=True)

    # ---- 30. streaming: Compressor and Decompressor on (C) ----------------
    import tempfile
    from grok_tpu_torch.codec import Compressor, Decompressor
    t_st = time.perf_counter()
    pc = CompressParams(ht=True, num_resolutions=6, tile_w=1024,
                        tile_h=1024, write_tlm=True)
    uhd_dev = upload(uhd)
    want_c = api.compress_device_batch([uhd_dev], pc, device=dev)[0]
    with tempfile.TemporaryDirectory() as tmp:
        def stream_to(path, tiles, resume=False):
            enc = Compressor(path, width=3840, height=2160, numcomps=3,
                             params=pc, resume=resume, device=dev)
            for t in tiles:
                r = enc._hdr.siz.tile_rect(t)
                enc.write_tile(t, [c[r.y0:r.y1, r.x0:r.x1] for c in uhd_dev])
            return enc
        counts_zero()
        (enc, dt) = timed(lambda: stream_to(os.path.join(tmp, "c.j2k"),
                                            range(12)))
        enc.finish()
        got = counts()
        with open(os.path.join(tmp, "c.j2k"), "rb") as f:
            if f.read() != want_c:
                _fail("C-stream: Compressor's bytes differ from "
                      "compress_device_batch's")
        if got["K4"] != 12:
            _fail(f"C-stream: {got['K4']} K4 launches for 12 tiles")
        part = stream_to(os.path.join(tmp, "r.j2k"), range(4))
        part._fh.close()
        enc2 = stream_to(os.path.join(tmp, "r.j2k"), range(12), resume=True)
        enc2.finish()
        with open(os.path.join(tmp, "r.j2k"), "rb") as f:
            if f.read() != want_c:
                _fail("C-stream: the resumed stream differs")
        print(f"C-stream: Compressor wrote (C) tile by tile in "
              f"{dt * 1e3:.3f} ms (12 K4 launches), equal to "
              f"compress_device_batch, and equal again after a stop at 4 "
              f"tiles and a resume [{card}]", flush=True)
        path = os.path.join(tmp, "c.j2k")
        canvas = api.decompress_device(want_c, device=dev)
        with Decompressor(path, device=dev) as dec:
            counts_zero()
            for t in range(dec.num_tiles):
                r = dec._hdr.siz.tile_rect(t)
                tl = dec.decompress_tile(t)
                if not all(torch.equal(a[:r.h, :r.w],
                                       c[r.y0:r.y1, r.x0:r.x1])
                           for a, c in zip(tl, canvas)):
                    _fail(f"C-stream: Decompressor's tile {t} differs from "
                          f"the decompress_device canvas")
            n_tiles = counts()["K1"]
            img, dt = timed(dec.decompress)
            if not np.array_equal(img.to_array(), uhd):
                _fail("C-stream: Decompressor.decompress is not the source")
        win = (1000, 700, 2024, 1724)
        wcanvas = api.decompress_device(want_c, DP(window=win), device=dev)
        with Decompressor(path, DP(window=win), device=dev) as dec:
            for t in (0, 1, 4, 5):
                r = dec._hdr.siz.tile_rect(t)
                tl = dec.decompress_tile(t)
                x0, y0 = max(r.x0, win[0]), max(r.y0, win[1])
                x1, y1 = min(r.x1, win[2]), min(r.y1, win[3])
                if not all(torch.equal(
                        a[y0 - r.y0:y1 - r.y0, x0 - r.x0:x1 - r.x0],
                        c[y0:y1, x0:x1]) for a, c in zip(tl, wcanvas)):
                    _fail(f"C-stream: windowed tile {t} differs")
            wimg = dec.decompress()
            if not np.array_equal(wimg.to_array(),
                                  uhd[win[1]:win[3], win[0]:win[2]]):
                _fail("C-stream: the windowed Image is not the source's "
                      "region")
        print(f"C-stream: Decompressor's 12 tiles ({n_tiles} K1 launches) "
              f"equal the decompress_device canvas, tiles 0, 1, 4, 5 inside "
              f"the {win} window too; decompress() the source in "
              f"{dt * 1e3:.3f} ms, the window's region [{card}]",
              flush=True)
    print(f"streaming phase: {time.perf_counter() - t_st:.1f} s", flush=True)

    # ---- 31. the CLI tools: compress -> dump -> decompress -----------------
    import io
    from grok_tpu_torch.cli import compress as cli_c
    from grok_tpu_torch.cli import decompress as cli_d
    from grok_tpu_torch.cli import dump as cli_dump
    from grok_tpu_torch.util import imageio
    t_cli = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ppm, pgx = os.path.join(tmp, "b.ppm"), os.path.join(tmp, "d.pgx")
        with open(ppm, "wb") as f:
            f.write(b"P6\n1920 1080\n255\n"
                    + rgb[0].astype(np.uint8).tobytes())
        with open(pgx, "wb") as f:
            f.write(b"PG ML +24 1920 1080\n" + deep_img.astype(">u4")
                    .tobytes())
        for src, enc_name, flags, out_name in (
                (ppm, "b.j2k", ["-HT"], "b_out.ppm"),
                (pgx, "d.jp2", [], "d_out.pgx")):
            j = os.path.join(tmp, enc_name)
            o = os.path.join(tmp, out_name)
            counts_zero()
            t0 = time.perf_counter()
            if cli_c.main(["-i", src, "-o", j] + flags) != 0:
                _fail(f"CLI compress {src} failed")
            t1 = time.perf_counter()
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                rc = cli_dump.main(["-i", j])
            if rc != 0 or "Main header:" not in text.getvalue():
                _fail(f"CLI dump {enc_name} failed")
            t2 = time.perf_counter()
            if cli_d.main(["-i", j, "-o", o]) != 0:
                _fail(f"CLI decompress {enc_name} failed")
            t3 = time.perf_counter()
            got = counts()
            if not any(got[k] for k in ("K4", "K5")) or \
                    not any(got[k] for k in ("K1", "K3")):
                _fail(f"CLI {enc_name}: the tools launched no kernel: {got}")
            back = imageio.read_image(o).to_array()
            want_a = imageio.read_image(src).to_array()
            if not np.array_equal(back, want_a):
                _fail(f"CLI {enc_name}: the decoded file is not the source")
            print(f"CLI {os.path.basename(src)}: compress -> {enc_name} "
                  f"({os.path.getsize(j)} bytes) {(t1 - t0) * 1e3:.1f} ms, "
                  f"dump {(t2 - t1) * 1e3:.1f} ms, decompress -> {out_name} "
                  f"{(t3 - t2) * 1e3:.1f} ms, equal to the source; "
                  f"launches {got} [{card}]", flush=True)
    print(f"CLI phase: {time.perf_counter() - t_cli:.1f} s", flush=True)

    # ---- 32. subsampled and mixed-precision encodes (Y422, Y420, RGBD,
    # C420) --------------------------------------------------------------
    from grok_tpu_torch.core.image import Component, Image
    from grok_tpu_torch.util import sub_vectors
    t_sub = time.perf_counter()
    REPS_SUB = 3

    def on_card(img):
        """The Image with its samples uploaded (the encode keeps them on
        the card)."""
        return Image(components=[Component(
            data=torch.from_numpy(np.ascontiguousarray(c.data)).to(dev),
            dx=c.dx, dy=c.dy, prec=c.prec, sgnd=c.sgnd)
            for c in img.components], x0=img.x0, y0=img.y0, x1=img.x1,
            y1=img.y1, color_space=img.color_space)

    def comp_region(img, c, x0, y0, x1, y1):
        """(rows, cols) slices of component c's plane for the canvas
        region [x0, x1) x [y0, y1)."""
        ci = img.components[c]
        ox, oy = -(-img.x0 // ci.dx), -(-img.y0 // ci.dy)
        return (slice(-(-y0 // ci.dy) - oy, -(-y1 // ci.dy) - oy),
                slice(-(-x0 // ci.dx) - ox, -(-x1 // ci.dx) - ox))

    def crop(img, side):
        """The image's side x side region at its canvas origin."""
        x1, y1 = img.x0 + side, img.y0 + side
        return Image(components=[Component(
            data=np.ascontiguousarray(c.data[comp_region(
                img, i, img.x0, img.y0, x1, y1)]),
            dx=c.dx, dy=c.dy, prec=c.prec, sgnd=c.sgnd)
            for i, c in enumerate(img.components)],
            x0=img.x0, y0=img.y0, x1=x1, y1=y1)

    sub_held = []
    sub_imgs = {}
    for name, (kind, kw) in sub_vectors.WORKLOADS.items():
        if kind not in sub_imgs:
            host_img = sub_vectors.image(kind)
            sub_imgs[kind] = (host_img, on_card(host_img))
        host_img, img = sub_imgs[kind]
        params = CompressParams(**kw)
        lossless = not params.irreversible and not params.rates
        counts_zero()
        times, out, split, calls = [], None, None, []
        for rep in range(REPS_SUB + 1):       # a warm-up first
            # a lossy warm-up's block coder and trial-decode launches are
            # recorded and held below
            with (enc_recorded() if rep == 0 and not lossless else
                  contextlib.nullcontext()) as rec_e, \
                    (recorded() if rep == 0 and not lossless else
                     contextlib.nullcontext()) as rec_d:
                split = _host_split(serve_enc, tile, lambda: timed(
                    lambda: api.compress(img, params, device=dev)))
            if rep == 0 and not lossless:
                calls = rec_e + [c for c in rec_d if c[0] == "K3"]
            s, dt = split["call"]
            times.append(dt)
            if out is not None and s != out:
                _fail(f"encode {name}: reps gave different bytes")
            out = s
        got = counts()
        kern = "K4" if params.ht else "K5"
        need(f"{name} encode", got, [kern], ["K4r", "K1", "K2"] + v1s)
        held = []
        for kn, a, res_ in calls:
            # the main path's launches at 1080p: the largest lane and the
            # 15 smallest against the plain version
            # (K5's and K3's plain versions on the host's CPU, one process
            # each, beside the card's work: checked after the last frame)
            if kn == "K5":
                ins, (L, R) = a[:5], a[5:7]
                sel = held_lanes(ins[2] > 0, ins[3], ins[4], ins[2])
                sub_held.append((name, kn, sel.numel(), ins[0].shape[0],
                                host_pool.submit(hw_validate.plain_encode_ms,
                                            *(t.index_select(0, sel).cpu()
                                              for t in ins), L, R),
                                tuple(t.index_select(0, sel).cpu()
                                      for t in res_)))
                continue
            if kn == "K3":
                W, H = a[9], a[10]
                lanes = a[:9]
                sel = held_lanes(lanes[2] > 0, lanes[5], lanes[6],
                                 lanes[2])
                sub_held.append((name, kn, sel.numel(), lanes[1].shape[0],
                                host_pool.submit(hw_validate.plain_decode_ms,
                                            lanes[0].cpu(),
                                            *(t.index_select(0, sel).cpu()
                                              for t in lanes[1:]), W, H),
                                res_[sel].cpu()))
                continue
            lanes, caps = a[:5], tuple(a[5:8])
            sel = held_lanes(lanes[4] == 1, lanes[2], lanes[3],
                             (lanes[0] >> 1).amax((1, 2)))
            sub = tuple(t.index_select(0, sel) for t in lanes)
            ref, p_ms = _plain_ms(torch, lambda: ht_encode
                                  .ht_encode_lanes_ref(*sub, *caps))
            if not hw_validate.ht_encodes_equal(
                    (res_[0].index_select(0, sel), res_[1][:, sel]), ref,
                    caps[:-1]):
                k4["err"] = 1
                _fail(f"K4 disagrees with its plain version on the lanes "
                      f"of {name}")
            held.append(f"K4 {sel.numel()} of {lanes[0].shape[0]} "
                        f"lanes equal to the plain version (plain "
                        f"{p_ms:.1f} ms)")
        if not lossless and not any(c[0] == kern for c in calls):
            _fail(f"encode {name}: no {kern} launch was held against its "
                  f"plain version")
        if lossless:
            back, dec_s = timed(lambda: api.decompress_device(out,
                                                              device=dev))
            if not all(torch.equal(b, c.data) for b, c in
                       zip(back, img.components)):
                _fail(f"decode {name}: not the source")
            what = "decoded back to the source bit for bit"
        else:
            # each layer prefix within its budget (the tile's own encode
            # gives the packet lengths), and a 32x32 crop encoded and
            # decoded on the card equal to the plain versions' on the CPU
            hdr = api._image_header(img, params)
            res, = serve_enc.try_encode_serving_batch(
                [c.data[None] for c in img.components], hdr, params)
            if not out.endswith(res.body + b"\xff\xd9"):
                _fail(f"encode {name}: the tile body differs from the "
                      f"API stream's")
            targets = layer_targets_for_tile(
                layer_budget_consts(hdr, params), hdr.siz.tile_rect(0),
                params)
            nl = params.num_layers
            per = len(res.packet_lens) // nl
            prefix = [int(sum(res.packet_lens[:per * (k + 1)]))
                      for k in range(nl)]
            if any(p > t for p, t in zip(prefix, targets)):
                _fail(f"encode {name}: layer prefixes {prefix} over the "
                      f"budgets {targets}")
            back, dec_s = timed(lambda: api.decompress_device(out,
                                                              device=dev))
            peak = [(1 << c.prec) - 1 for c in img.components]
            psnr = [10 * np.log10(pk ** 2 / max(float(
                ((b.double() - c.data.double()) ** 2).mean()), 1e-12))
                for pk, b, c in zip(peak, back, img.components)]
            small = crop(host_img, 32)
            cp = replace(params, num_resolutions=3, cblk_w_exp=4,
                         cblk_h_exp=4)
            on_c = api.compress(on_card(small), cp, device=dev)
            if on_c != api.compress(small, cp, device="cpu"):
                _fail(f"{name}: the card's 32x32 crop encode differs from "
                      f"the plain versions' on the CPU")
            e = max(int((a.cpu().long() - b.long()).abs().max())
                    for a, b in zip(api.decompress_device(on_c,
                                                          device=dev),
                                    api.decompress_device(on_c,
                                                          device="cpu")))
            if e > 1:
                _fail(f"{name}: the card's decode of the crop differs by "
                      f"{e} from the plain versions'")
            what = (f"the main path's launches held on the largest lane "
                    f"and the 15 smallest: {'; '.join(held)}; layer "
                    f"prefixes {prefix} within "
                    f"{[round(t, 1) for t in targets]}; PSNR by component "
                    f"{', '.join(f'{v:.2f}' for v in psnr)} dB; the 32x32 "
                    f"crop's stream equal to the CPU encode, its decode "
                    f"within {e}")
        if name in sub_vectors.HASHES:
            if sub_vectors.sha256(out) != sub_vectors.HASHES[name]:
                _fail(f"encode {name}: not grok_tpu.compress's bytes (the "
                      f"committed hash)")
            what += "; grok_tpu.compress's bytes (the committed hash)"
        best, med = min(times[1:]), float(np.median(times[1:]))
        print(f"encode {name}: {len(out)} bytes; best of {REPS_SUB} "
              f"{best * 1e3:.3f} ms/call (median {med * 1e3:.3f}); the "
              f"last "
              f"call's C wire assembly {split['assemble'] * 1e3:.3f} ms, "
              f"Tier-2 finish {split['finish'] * 1e3:.3f} ms (truncation "
              f"refinement {split['refine'] * 1e3:.3f} ms); launches per "
              f"encode K4 {got['K4'] / (REPS_SUB + 1):g}, K5 "
              f"{got['K5'] / (REPS_SUB + 1):g}, K3 "
              f"{got['K3'] / (REPS_SUB + 1):g}; the first decode (its "
              f"plan "
              f"built) {dec_s * 1e3:.3f} ms; {what} [{card}]", flush=True)
        if kind != "c420":
            continue
        # C420: a 1024x1024 window of the decode, and Compressor tile by
        # tile
        win = (1000, 700, 2024, 1724)
        wplanes, wdt = timed(lambda: api.decompress_device(
            out, DP(window=win), device=dev))
        for c, (wp, comp) in enumerate(zip(wplanes, img.components)):
            rs = comp_region(img, c, *win)
            if not torch.equal(wp[rs], comp.data[rs]):
                _fail(f"C420: component {c} differs inside the window")
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "c420.j2k")

            def stream():
                enc = Compressor(path, width=img.w, height=img.h,
                                 numcomps=3, x0=img.x0, y0=img.y0,
                                 subsampling=[(c.dx, c.dy) for c in
                                              img.components],
                                 params=params, device=dev)
                for t in range(enc.num_tiles):
                    r = enc._hdr.siz.tile_rect(t)
                    enc.write_tile(t, [comp.data[comp_region(
                        img, c, r.x0, r.y0, r.x1, r.y1)]
                        for c, comp in enumerate(img.components)])
                enc.finish()
            counts_zero()
            _none, sdt = timed(stream)
            n_k4 = counts()["K4"]
            with open(path, "rb") as f:
                if f.read() != out:
                    _fail("C420: Compressor's bytes differ from "
                          "compress's")
        print(f"C420: a {win} window decoded in {wdt * 1e3:.3f} ms, equal "
              f"to the source inside it; Compressor wrote the tiles in "
              f"{sdt * 1e3:.3f} ms ({n_k4} K4 launches), compress's bytes "
              f"[{card}]", flush=True)
    for name, kn, n_sel, nl, fut, got_sub in sub_held:
        ref, p_ms = fut.result()
        if not (hw_validate.encodes_equal(got_sub, ref) if kn == "K5"
                else torch.equal(got_sub, ref)):
            (k5 if kn == "K5" else k3)["err"] = 1
            _fail(f"{kn} disagrees with its plain version on the lanes "
                  f"of {name}")
        print(f"{kn} {name}: {n_sel} of the main path's {nl} lanes (the "
              f"largest and the 15 smallest) equal to the plain version "
              f"(on the host CPU, {p_ms:.1f} ms) [{card}]", flush=True)
    print(f"subsampled phase: {time.perf_counter() - t_sub:.1f} s",
          flush=True)

    t_hc = time.perf_counter()
    for fut, check in host_checks:
        check(*fut.result())
    host_pool.shutdown()
    print(f"host-CPU plain checks of phases 8, 9 and 16: waited "
          f"{time.perf_counter() - t_hc:.1f} s for them", flush=True)
    print(f"smoke: {time.perf_counter() - t_start:.1f} s after the imports",
          flush=True)
    print(card, flush=True)

    def row(name, src, replaces, launches, k, library_ms=None):
        r = {"name": name, "route": "cuda",
             "source": f"grok_tpu_torch/csrc/{src}", "replaces": replaces,
             "launches": launches, "max_abs_err": k["err"],
             "ms": k["ms"], "plain_ms": k["plain_ms"],
             "bound_ms": k["bytes"] / HBM_BYTES_PER_S * 1e3,
             "bound_by": "bytes", "library_ms": library_ms}
        if "prev_ms" in k:          # the first design's time, same lanes
            r["prev_ms"] = k["prev_ms"]
        kern = {"ht_cleanup_decode": "K1", "ht_refine_decode": "K2",
                "mq_decode": "K3", "ht_cleanup_encode": "K4",
                "ht_refine_encode": "K4r", "mq_encode": "K5"}.get(name)
        shapes = {sh: {"ms": v["ms"], "plain_ms": v["plain_ms"],
                       "bound_ms": v["bytes"] / HBM_BYTES_PER_S * 1e3,
                       "launches": v["launches"], "lanes": v["lanes"]}
                  for (k2_, sh), v in wide.items() if k2_ == kern}
        if shapes:                  # phases 23, 24: lanes over 64 on a side
            r["wide"] = shapes
        if kern in sharded:         # phase 27: (G)'s launches per shard
            r["sharded"] = sharded[kern]
        if kern in deep_rec:        # phase 29: lanes past 24 planes
            d = deep_rec[kern]
            r["deep"] = {"ms": d["ms"], "plain_ms": d["plain_ms"],
                         "bound_ms": d["bytes"] / HBM_BYTES_PER_S * 1e3,
                         "launches": d["launches"], "lanes": d["lanes"],
                         "plain_lanes": d["plain_lanes"]}
        if kern == "K5":            # phase 25: the styled launches
            r["styled"] = {
                "ms": k5s["ms"], "default_ms": k5s["default_ms"],
                "plain_ms": k5s["plain_ms"],
                "bound_ms": k5s["bytes"] / HBM_BYTES_PER_S * 1e3,
                "launches": k5s["launches"], "lanes": k5s["lanes"],
                "plain_lanes": k5s["plain_lanes"]}
        return r
    print(json.dumps({"kernels": [
        row("ht_cleanup_decode", "ht_decode.cu",
            "grok_tpu/ops/pallas_ht.py:310", dec_counts["HT"]["K1"], k1),
        row("ht_cleanup_encode", "ht_encode.cu",
            "grok_tpu/ops/pallas_ht_enc.py:125", enc_counts["HT"]["K4"], k4),
        row("mq_decode", "t1_decode.cu", "grok_tpu/ops/pallas_t1.py:150",
            dec_counts["Part-1"]["K3"], k3),
        row("mq_encode", "t1_encode.cu", "grok_tpu/ops/pallas_t1_enc.py:46",
            enc_counts["Part-1"]["K5"], k5),
        row("ht_refine_decode", "ht_decode.cu",
            "grok_tpu/ops/pallas_ht.py:293", dec_counts["HT-refined"]["K2"],
            k2),
        row("ht_refine_encode", "ht_encode.cu",
            "grok_tpu/ops/pallas_ht_enc.py:722",
            enc_counts["HT-refined"]["K4r"], k4r),
        dict(row("lane_gather", "lane_gather.cu", "tools/hw_validate.py:383",
                 p1_launches, p1, p1["library_ms"]),
             bound_note="x and idx read once, out written once: 12 bytes "
             "an element", spread_ms=p1["spread_ms"],
             rows=hw_validate.GATHER_ROWS)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
