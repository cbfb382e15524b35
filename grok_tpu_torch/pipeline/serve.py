"""Cached serving decode of HT, Part-1 and HT-mixed streams on a
PyTorch device.

The `ht`, `mq` and `mixed` branches of grok_tpu/pipeline/serve.py
`try_decode_serving_batch`, over the port's own host layers: the cached
ServePlan (pipeline/plan.py), the C Tier-2 parser and the C HT wire scan
(native/), which un-stuffs each HT block's MagSgn stream into one
digest.  Part-1 blocks keep their raw codewords: a block's per-layer
chunks of a multi-layer stream are concatenated into one compact body.
HT-mixed streams route each block by the tile-part COM bitmap, and
upload both the raw body and the digest.  Each stream's coded bytes are
written once on the host, into a staging arena kept on the plan (pinned
memory for a CUDA device) and reused across calls: a raw body copied
from the caller's buffer, a digest written there by the C scan; the
per-lane meta array follows, and one host-to-device copy takes it all.
A DecodeProgram (pipeline/device.py), cached on the plan per table
version, does the rest on the device.

Scope: one tile of HT cleanup-only (whatever Part-1 mode-switch bits
the style carries beside the HT bit: the HT decoder reads none of them),
Part-1 default-style (one codeword
segment per block, any number of layers) or single-layer HT-mixed
code-blocks of any legal size (sides up to 1024, at most 4096 samples),
all streams of a batch under one main header and the same tile overrides
(COC, QCC, RGN, POC), decoded whole or under a layer cap (dp.max_layers:
each stream's chunks of later layers dropped), whole or in a window
(dp.window: the blocks that miss the synthesis-dilated window decode as
zeros, plan.py window_mask), with the ROI Maxshift undone on the device.
A strict decode (dp.strict) of Part-1 blocks is served as a permissive
one, as the JAX package serves it (its strict Tier-2 parse raises where
the C parse declines, on the general route).  Over a device mesh
(dp.mesh, a parallel/sharding.py Mesh whose first device is `device`)
the batch is served too: K3's lanes are split into one launch per shard
and every synthesis level is row-sharded with halo exchange, while the
HT lanes stay on the first device (one K1 launch per bucket); the planes
equal the unmeshed decode's.  Refined HT blocks, Part-1 mode switches
and multi-segment blocks, layered HT-mixed streams or HT-mixed sets with
mode switches, components mixing HT and Part-1 code-blocks, packed
packet headers (PPM/PPT), a custom MCT, streams the C Tier-2 parse
declines (cut short, or corrupt) and strict decodes of HT or HT-mixed
blocks raise GeneralRoute, which the entry points answer with the
general device route (pipeline/tile.py decode_tile, kernels K1, K2 and
K3, with the Python Tier-2 parse where the C one declines, the scalar
decoder's exceptions on a strict decode, and with a mesh its sharded K3
launches and synthesis levels), as the JAX package's serving decode
declines them to its decode_tile.  (The JAX package's serving decode
also declines a mesh; the port serves it, with the same planes.)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from grok_tpu_torch import native
from grok_tpu_torch.core.params import CBLK_HT
from grok_tpu_torch.ops.ht_decode import MAX_STREAM, _quant_len
from grok_tpu_torch.parallel.sharding import check_mesh
from grok_tpu_torch.pipeline.plan import (_plan_for, _th_ovr_key,
                                          window_mask)
from grok_tpu_torch.t1ht import tables
from grok_tpu_torch.pipeline.device import META_COLS, Bucket, DecodeProgram
from grok_tpu_torch.util.trace import count, enabled as tracing_on, trace


def _unsupported(route: str, why: str) -> NotImplementedError:
    return NotImplementedError(
        f"{route} is not ported ({why}); the PyTorch port's serving "
        f"decode takes HT cleanup, Part-1 default-style and HT-mixed "
        f"tiles, its general route refined HT and Part-1 mode switches")


class GeneralRoute(NotImplementedError):
    """The serving decode declines a stream that the general device route
    (pipeline/tile.py decode_tile) decodes: HT refinement passes, Part-1
    mode switches, several codeword segments per block, layered HT-mixed
    streams, components mixing HT and Part-1 blocks, packed packet
    headers, a custom MCT, packets the C Tier-2 parse declines; or a
    batch that the batch entry takes stream by stream (several tiles,
    different main headers, tile-part overrides).  The entry points catch this class only; every other
    decline stays a NotImplementedError."""

    def __init__(self, why: str):
        super().__init__(f"the serving decode declines {why}: the entry "
                         f"points decode such streams one by one, on the "
                         f"general device route where needed")


@dataclass
class StagedBatch:
    """A batch ready on the device: run() decodes it."""
    program: DecodeProgram
    body: torch.Tensor        # uint8 digest and/or raw codewords
    meta: torch.Tensor        # (lanes, META_COLS) int32
    dims: list                # per bucket (Lms, Lsuf, Dm, any HT lane,
    #                           any Part-1 lane)
    mesh: object = None       # dp.mesh: K3 and the synthesis sharded

    def run(self) -> list:
        return self.program.run(self.body, self.meta, self.dims, self.mesh)


def _program(plan, N: int, device: torch.device) -> DecodeProgram:
    """DecodeProgram for (plan, N, device, table version), cached on the
    plan: under full staging every stream contributes every block the
    plan keeps, so the bucket layout depends on nothing else.  Programs
    of older table versions are dropped when a new one is built."""
    key = ("torch_prog", N, str(device), tables.VERSION)
    prog = plan.fast.get(key)
    if prog is None:
        for k in [k for k in plan.fast if isinstance(k, tuple)
                  and k[0] == "torch_prog" and k[3] != tables.VERSION]:
            del plan.fast[k]
        fidx, bsel = _full_index(plan)
        buckets = tuple(
            Bucket(W, H, tuple(plan.sig_tail[gi] for gi in fidx[sel]))
            for (W, H), sel in zip(plan.bucket_dims, bsel) if sel.size)
        prog = DecodeProgram(plan.comps_sig, plan.mct_mode, N, buckets,
                             device, plan.roi, plan.custom_inv)
        plan.fast[key] = prog
        count("decode.program_builds")
    return prog


def _full_index(plan):
    """(kept block indices, per-bucket positions into them)."""
    got = plan.fast.get("torch_full")
    if got is None:
        fidx = np.nonzero(plan.rok)[0]
        bsel = [np.nonzero(plan.bucket[fidx] == bid)[0]
                for bid in range(len(plan.bucket_dims))]
        got = (fidx, bsel)
        plan.fast["torch_full"] = got
    return got


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def _stream_bound(coder: str, n: int, n_blks: int) -> int:
    """Arena bytes a stream of n coded bytes may take: its raw body
    (Part-1, mixed) and the C scan's digest bound (HT, mixed), each
    16-byte aligned."""
    b = _up16(n) if coder != "ht" else 0
    if coder != "mq":
        b += _up16(3 * n + 24 * n_blks + 64)
    return b


def _arena_need(plan, bodies: list, meta_bytes: int) -> int:
    """The arena's size up front for a batch: every stream's bound and
    the lane meta."""
    return sum(_stream_bound(plan.coder, len(b), plan.n_blks)
               for b in bodies) + _up16(meta_bytes) + 16


class _Arena:
    """A batch's staging buffer, kept on the plan per device and reused
    across calls: host memory (pinned for a CUDA device) that every
    stream's coded bytes, digests and lane meta are written into once,
    each piece at a 16-byte-aligned base with its padding zeroed, and
    that one host-to-device copy uploads.  Its size is a multiple of
    ROUND.  `written` counts the bytes written in the current call."""

    ROUND = 1 << 20

    def __init__(self, device: torch.device, cap: int):
        self.device = device
        self.buf, self.host = self._alloc(cap)
        self.done = None        # the event of its last copy to the device
        self.written = 0

    def _alloc(self, need: int) -> tuple:
        cap = -(-max(need, 1) // self.ROUND) * self.ROUND
        buf = torch.empty(cap, dtype=torch.uint8,
                          pin_memory=self.device.type == "cuda")
        return buf, buf.numpy()

    @classmethod
    def of(cls, plan, device: torch.device, need: int) -> "_Arena":
        """The plan's arena on `device`, of at least `need` bytes, once
        its previous copy to the device is done."""
        key = ("torch_arena", str(device))
        arena = plan.fast.get(key)
        if arena is None:
            arena = plan.fast[key] = cls(device, need)
        else:
            if arena.done is not None:
                arena.done.synchronize()
                arena.done = None
            if arena.host.size < need:
                arena.grow(need, 0)
        arena.written = 0
        return arena

    def grow(self, need: int, top: int) -> None:
        """A larger buffer of at least `need` bytes, holding the first
        `top` bytes written so far."""
        count("decode.stage.arena_grows")
        old = self.host
        self.buf, self.host = self._alloc(need)
        self.host[:top] = old[:top]
        self.written += top

    def put(self, at: int, data) -> None:
        """`data` (any contiguous buffer) at `at`, its padding zeroed."""
        v = np.frombuffer(data, np.uint8)
        self.host[at:at + v.size] = v
        self.written += v.size
        self.pad(at + v.size)

    def pad(self, end: int) -> None:
        """Zero from `end` to the next 16-byte boundary."""
        self.host[end:_up16(end)] = 0
        self.written += _up16(end) - end

    def upload(self, views: list) -> list:
        """Device tensors of arrays written in the arena, given as
        (offset, the numpy view of the arena there): one host-to-device
        copy of the arena up to the last one's end."""
        count("decode.upload_bytes", sum(v.nbytes for _o, v in views))
        o, v = views[-1]
        src = self.buf[:max(16, o + _up16(v.nbytes))]
        if self.device.type == "cuda":
            dev = src.to(self.device, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record(torch.cuda.current_stream(self.device))
        else:
            # a copy: a staged batch never shares the arena's bytes
            dev = src.to(self.device, copy=True)
        return [dev[o:o + v.nbytes].view(torch.from_numpy(v[:0]).dtype)
                .reshape(v.shape) for o, v in views]


def _upload(plan, arrays: list, device: torch.device) -> list:
    """Host numpy arrays -> device tensors through the plan's staging
    arena: each array copied there at a 16-byte-aligned offset, then one
    host-to-device copy."""
    offs, total = [], 0
    for a in arrays:
        offs.append(total)
        total += _up16(a.nbytes)
    arena = _Arena.of(plan, device, total)
    for a, o in zip(arrays, offs):
        arena.put(o, a.reshape(-1).view(np.uint8))
    return arena.upload([(o, arena.host[o:o + a.nbytes].view(a.dtype)
                          .reshape(a.shape)) for a, o in zip(arrays, offs)])


def stage_dims(sc: np.ndarray) -> tuple:
    """(Lms, Lsuf, Dm) staging dims of one bucket's lanes from their
    C-scan rows (native.ht_scan2 columns)."""
    # shift-candidate bound for the un-stuff: the bit deficit is <= 4
    # (VLC nibble) + stuffing deletions (the C scan's FF/0x7F counts)
    dmax = int(np.maximum(sc[:, 5], 4 + sc[:, 6]).max())
    need_d = -(-dmax // 8) + 1
    if need_d > 64:
        raise _unsupported("general path", "pathological stuffing density")
    Dm = 1
    while Dm < need_d:
        Dm *= 2
    return (_quant_len(int(sc[:, 2].max())), _quant_len(int(sc[:, 4].max())),
            Dm)


def _scan_ht(plan, arena: _Arena, at: int, rest: int, body, offs, lens,
             numbps, si: int):
    """C wire scan of a stream's HT blocks, its digest written into the
    arena at `at` (where it does not fit, the arena grows to hold `rest`
    more bytes and the stream is scanned again) -> (scan rows with the
    cleanup plane in column 0 and the clean MagSgn, MEL and VLC bits in
    columns 7 to 9, the digest's length); raises outside the K1 route's
    scope."""
    res = native.ht_scan2(body, offs, lens, arena.host, at)
    if res is None:
        arena.grow(at + rest, at)
        res = native.ht_scan2(body, offs, lens, arena.host, at)
    if res is None:
        raise _unsupported("general path", "HT wire scan overflow")
    scan, dig, bits = res
    arena.written += dig.size
    arena.pad(at + dig.size)
    if (scan[:, 0] < 0).any():
        # the general route decodes such a block as zeros, or raises the
        # scalar decoder's "bad framing" on a strict decode
        raise GeneralRoute(f"stream {si}, whose HT framing is invalid")
    # per-block cleanup plane (t1ht.scalar.derive_p: cleanup-only, so
    # p = 0 unless the ht_planes COM extension is present), kept in scan
    # column 0 (the validity flag)
    scan[:, 0] = np.minimum(plan.ht_p_ext, np.maximum(numbps - 1, 0))
    if scan.size and int(scan[:, 2:5:2].max()) > MAX_STREAM:
        raise _unsupported("general path", "a sub-stream longer than "
                           f"{MAX_STREAM} bytes")
    return np.concatenate([scan, bits], 1), dig.size


def _concat_layers(body, chunks: np.ndarray, n_blks: int):
    """Multi-layer Part-1: a default-style block's per-layer chunks are
    contributions to one codeword segment, concatenated per block (in
    layer order) into a compact body.  Returns (body as a uint8 array,
    offs, lens)."""
    ch = chunks[np.lexsort((chunks[:, 1], chunks[:, 0]))]
    bview = np.frombuffer(body, np.uint8)
    buf = np.empty(int(ch[:, 5].sum()), np.uint8)
    offs = np.zeros(n_blks, np.int64)
    lens = np.zeros(n_blks, np.int32)
    first = np.ones(n_blks, bool)
    pos = 0
    for b, _l, _s, _p, off, ln in ch.tolist():
        if first[b]:
            offs[b] = pos
            first[b] = False
        buf[pos:pos + ln] = bview[off:off + ln]
        lens[b] += ln
        pos += ln
    return buf, offs, lens


def stage_serving_batch(cs: bytes, hdr, t: int, th, bodies: list, dp, *,
                        device, ths=None) -> StagedBatch:
    """Host staging of N same-geometry tile bodies (any contiguous
    buffers, read in place) and their upload."""
    device = torch.device(device)
    check_mesh(dp.mesh, device)
    if hdr.ppm is not None or any(
            q is not None and q.ppt is not None for q in (ths or [th])):
        raise GeneralRoute("PPM/PPT packed packet headers")
    if ths is not None and any(_th_ovr_key(q) != _th_ovr_key(th)
                               for q in ths):
        raise _unsupported("general path",
                           "batch streams with different tile overrides")
    plan = _plan_for(cs, hdr, t, th, int(dp.reduce or 0))
    if plan.coder == "split":
        raise GeneralRoute("components mixing HT and Part-1 code-blocks")
    if plan.coder == "mixed" and (plan.style != CBLK_HT).any():
        raise GeneralRoute("an HT-mixed set with Part-1 mode switches")
    if dp.strict and plan.coder != "mq":
        # the scalar decoder's checks: on the general route, which reads
        # each HT lane's error code back
        raise GeneralRoute("a strict decode of HT code-blocks")
    if plan.coder == "mq" and plan.style.any():
        raise GeneralRoute("Part-1 mode switches")
    if plan.custom_inv is not None:
        raise GeneralRoute("a custom MCT")
    wmask = window_mask(plan, dp.window) if dp.window is not None \
        else None
    ths_l = list(ths) if ths is not None else [th] * len(bodies)
    if plan.coder != "mixed" and any(
            q is not None and q.ht_mixed_bitmap() is not None
            for q in ths_l):
        raise _unsupported("general path", "a batch mixing HT-mixed and "
                           "other streams")

    N = len(bodies)
    fidx, bsel = _full_index(plan)
    nf = fidx.size
    scans = np.zeros((N, nf, 10), np.int64)
    valid = np.zeros((N, nf), bool)           # HT lanes (K1)
    mqrows = np.zeros((N, nf, 4), np.int64)   # Part-1 lanes (K3): offset
    #                                           in the stream's raw body,
    #                                           length, npass, numbps
    # the arena: per stream its raw body (mq, mixed), copied in the pack
    # step, then its digest (ht, mixed), written by the scan, each at a
    # 16-byte-aligned base; then the lane meta (full staging: a lane for
    # every kept block of every stream)
    meta_bytes = N * nf * META_COLS * 4
    arena = _Arena.of(plan, device, _arena_need(plan, bodies, meta_bytes))
    # rest[si]: the most the batch may still write from stream si on
    rest = np.cumsum([_stream_bound(plan.coder, len(b), plan.n_blks)
                      for b in bodies][::-1])[::-1] + meta_bytes + 32
    raws = []                                 # (base, raw body)
    raw_base = np.zeros(N, np.int64)
    dig_base = np.zeros(N, np.int64)
    top = 0
    for si, body in enumerate(bodies):
        with trace("decode.stage.t2"):
            parsed = native.t2_parse_prepared(body, plan.prep, plan.sop,
                                              plan.eph)
            if parsed is None:
                raise GeneralRoute(f"stream {si}, whose packets the C "
                                   f"Tier-2 parse declines (cut short or "
                                   f"corrupt)")
            incl, zb, npass, chunks, _end = parsed
            incl = np.asarray(incl, bool)
            if dp.max_layers:
                # a layer cap: drop the chunks of layers at or past it
                # and rebuild inclusion and pass counts from the rest (zb
                # stays valid: it was signalled at first inclusion), as
                # grok_tpu/pipeline/serve.py does
                chunks = chunks[chunks[:, 1] < dp.max_layers]
                npass = np.zeros_like(npass)
                np.add.at(npass, chunks[:, 0], chunks[:, 3])
                incl = np.zeros_like(incl)
                incl[chunks[:, 0]] = True
            if (chunks[:, 2] != 0).any():
                raise GeneralRoute("multi-segment code-blocks")
            if len(chunks) != int(np.count_nonzero(incl)):
                if plan.coder != "mq":
                    raise GeneralRoute("blocks spread over several layers "
                                       "(a layered HT-mixed stream)")
                body, offs, lens = _concat_layers(body, chunks,
                                                  plan.n_blks)
            else:
                offs = np.zeros(plan.n_blks, np.int64)
                lens = np.zeros(plan.n_blks, np.int32)
                offs[chunks[:, 0]] = chunks[:, 4]
                lens[chunks[:, 0]] = chunks[:, 5]
        keep = incl & plan.rok
        if wmask is not None:
            keep &= wmask
        idx = np.nonzero(keep)[0]
        if idx.size == 0:
            # nothing to decode in this stream (a tile that got no bytes,
            # a window on none of its blocks): the general route gives
            # the tile of zero coefficients, as the JAX package does
            raise GeneralRoute(f"stream {si} without coded code-blocks")
        numbps = plan.mb[idx] - zb[idx]
        npz = npass[idx]
        pos = np.searchsorted(fidx, idx)
        if plan.coder == "ht":
            hsel = np.ones(idx.size, bool)
        elif plan.coder == "mq":
            hsel = np.zeros(idx.size, bool)
        else:
            # the stream's bitmap routes each block to its coder
            bm = ths_l[si].ht_mixed_bitmap() \
                if ths_l[si] is not None else None
            if bm is None:
                raise _unsupported("general path", f"stream {si}: no "
                                   f"HT-mixed bitmap")
            bma = np.frombuffer(bm, np.uint8)
            cidx = plan.canon_idx[idx]
            if int(cidx.max()) >= bma.size * 8:
                raise _unsupported("general path", f"stream {si}: a short "
                                   f"HT-mixed bitmap")
            hsel = ((bma[cidx >> 3] >> (cidx & 7)) & 1).astype(bool)
        if not (npz[hsel] == 1).all():
            if plan.coder == "ht":
                raise GeneralRoute("HT SigProp/MagRef refinement passes")
            raise _unsupported("HT refinement in HT-mixed sets",
                               "SigProp/MagRef passes")
        if not ((npz[~hsel] >= 1) & (npz[~hsel] <= 109)).all() or (
                (~hsel).any() and not ((numbps[~hsel] >= 0)
                                       & (numbps[~hsel] <= 30)).all()):
            raise _unsupported("general path", "a Part-1 block outside "
                               "1..109 passes or 0..30 magnitude planes")
        if plan.coder != "ht":
            raw_base[si] = top
            raws.append((top, body))
            top += _up16(len(body))
            m = ~hsel
            mqrows[si, pos[m]] = np.stack(
                [offs[idx][m], lens[idx][m], npz[m], numbps[m]], 1)
        if plan.coder != "mq":
            dig_base[si] = top
            if hsel.any():
                with trace("decode.stage.ht_scan"):
                    scan, used = _scan_ht(
                        plan, arena, top, int(rest[si]), body,
                        offs[idx][hsel], lens[idx][hsel], numbps[hsel], si)
                top += _up16(used)
                scans[si, pos[hsel]] = scan
                valid[si, pos[hsel]] = True

    if plan.coder != "ht":
        # K3's lanes: their count, their coded bytes, the longest chain
        mq_len = mqrows[:, :, 1][mqrows[:, :, 2] > 0]
        count("decode.k3.lanes", mq_len.size)
        count("decode.k3.bytes", int(mq_len.sum()))
        count("decode.k3.lane_bytes_max", int(mq_len.max(initial=0)))

    with trace("decode.stage.pack"):
        body_n = max(16, top)
        need = body_n + _up16(meta_bytes)
        if arena.host.size < need:
            arena.grow(need, top)
        for base, raw in raws:
            arena.put(base, raw)
        arena.host[top:body_n] = 0
        arena.written += body_n - top

        prog = _program(plan, N, device)
        metas, dims = [], []
        for sel in bsel:
            if sel.size == 0:
                continue
            sc = scans[:, sel].reshape(-1, 10)
            v = valid[:, sel].reshape(-1)
            mqr = mqrows[:, sel].reshape(-1, 4)
            dbase = np.repeat(dig_base, sel.size)
            meta = np.zeros((sc.shape[0], META_COLS), np.int32)
            meta[:, 0] = np.where(v, sc[:, 1] + dbase, 0)
            meta[:, 1] = sc[:, 2]
            meta[:, 2] = np.where(v, sc[:, 3] + dbase, 0)
            meta[:, 3] = sc[:, 4]
            meta[:, 4] = sc[:, 0]
            meta[:, 5] = v
            mq_on = mqr[:, 2] > 0
            meta[:, 6] = np.where(mq_on, mqr[:, 0] + np.repeat(raw_base,
                                                               sel.size), 0)
            meta[:, 7:10] = mqr[:, 1:4]
            meta[:, 10:13] = sc[:, 7:10]
            metas.append(meta)
            dims.append(stage_dims(sc) + (bool(v.any()), bool(mq_on.any())))
        meta_all = arena.host[body_n:body_n + meta_bytes].view(
            np.int32).reshape(N * nf, META_COLS)
        np.concatenate(metas, out=meta_all)
        arena.written += meta_bytes
        count("decode.stage.arena_bytes", arena.written)
        if dp.mesh is not None and plan.coder != "ht" and tracing_on():
            count("decode.mesh.k3_bytes_max",
                  _k3_bytes_max(prog, meta_all[:, 7], dp.mesh.size))
        with trace("decode.stage.upload"):
            body_d, meta_d = arena.upload([(0, arena.host[:body_n]),
                                           (body_n, meta_all)])
    return StagedBatch(prog, body_d, meta_d, dims, dp.mesh)


def _k3_bytes_max(prog: DecodeProgram, dlen: np.ndarray, n: int) -> int:
    """The coded bytes of K3's fullest shard over a mesh of n shards:
    each group of prog.mq_groups has its lanes (in meta order) split in n
    contiguous shares, as ops/t1_decode.py t1_decode_lanes_sharded
    splits them, and each shard's bytes are summed over the groups."""
    per = np.zeros(n, np.int64)
    for _W, _H, bis in prog.mq_groups:
        lens = np.concatenate([prog.lane_meta(dlen, bi) for bi in bis])
        per += [int(s.sum(dtype=np.int64)) for s in np.array_split(lens, n)]
    return int(per.max())


def try_decode_serving_batch(cs: bytes, hdr, t: int, th, bodies: list, dp,
                             *, device, ths=None) -> list:
    """Decode N same-geometry tile bodies on `device` -> N lists of
    per-component int32 tensors.  Raises GeneralRoute where the general
    device route takes the stream, NotImplementedError outside both
    routes' scope (the JAX counterpart returns None there and the caller
    falls back to its general path)."""
    return stage_serving_batch(cs, hdr, t, th, bodies, dp, device=device,
                               ths=ths).run()
