"""Fused serving decode on the device: the `ht3` and `mq3` routes of
grok_tpu/pipeline/device.py `_build_decode_fn`, in PyTorch.

One uploaded body and one per-lane meta array go in; per component int32
pixel planes of all N streams come out, resident on the device.  The body
holds, per stream, the HT digest (per HT block: the clean MagSgn stream
and the raw cleanup suffix, from the host C scan) and/or the raw Part-1
codewords.  In between, per bucket of same-sized code-blocks:

  1. HT lanes: stage each lane's sub-streams from the digest (masked byte
     gathers), un-stuff MEL and VLC from the raw suffix, and decode the
     HT cleanup pass (ops/ht_decode.py, kernel K1);
  2. Part-1 lanes: decode each codeword straight from the body with one
     default-style segment [0, dlen) per block (ops/t1_decode.py, kernel
     K3), the lanes of all buckets in one launch (each lane carries its
     own size).  An HT-mixed plan runs both over the same lanes: the
     coder a block does not use sees valid = 0 (K1) or numpasses = 0
     (K3) and gives zeros, so the two outputs add;

then for the whole batch:

  3. undo the ROI Maxshift of the components that carry one (RGN:
     magnitudes at or above 2^s are shifted down by s), dequantize and
     place every block into its band (one gather and one scatter over
     index tensors built once per program);
  4. inverse DWT per component, on (N, H, W) stacks of all N streams;
  5. inverse RCT/ICT, or a custom MCT's inverse in float64, and the DC
     shift with clipping.

A DecodeProgram is built once per signature (plan geometry, batch size,
bucket layout, table version) and cached by the caller.  The general
decode route (pipeline/tile.py decode_tile) runs its own block decodes
(K1/K2 per bucket from its own staging, K3 from `stage_mq_lanes`: its
Part-1 lanes with their own segment tables) and hands their outputs to
steps 3-5 (`synthesize`).  With a device mesh, on either route, the
default-style single-segment Part-1 lanes (every Part-1 lane the serving
decode takes) are decoded by one K3 launch per shard and every synthesis
level is row-sharded (parallel/sharding.py); the HT lanes stay on the
first device.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from grok_tpu_torch.core.geometry import BAND_LL, Rect
from grok_tpu_torch.ops import dwt, mct
from grok_tpu_torch.ops.ht_decode import MARK_I64, ht_decode_lanes
from grok_tpu_torch.ops.t1_decode import (t1_decode_lanes,
                                          t1_decode_lanes_sharded)
from grok_tpu_torch.parallel.sharding import inv_2d_level_sharded
from grok_tpu_torch.util.trace import count, trace

# per-lane meta columns of the uploaded meta array: the HT lane (K1) and
# the Part-1 lane (K3) of the same block
META_COLS = 13    # ms_start, ms_len, suf_start, suf_len, p, valid,
#                   mq_start, mq_len, npass, nbps, and the HT lane's clean
#                   MagSgn, MEL and VLC bits (native.ht_scan2)


def stage_bytes(body: torch.Tensor, start: torch.Tensor, ln: torch.Tensor,
                L: int, rev: bool) -> torch.Tensor:
    """Per-lane byte windows of the uploaded digest -> (NL, L+1) int32,
    zero at and beyond each lane's length ln:
      forward: body[start + k]
      rev:     body[start + ln - 1 - k]   (VLC segments read backwards)
    """
    k = torch.arange(L + 1, device=body.device)
    if rev:
        idx = (start + ln - 1)[:, None] - k
    else:
        idx = start[:, None] + k
    idx = idx.clamp(0, body.numel() - 1)
    return torch.where(k < ln[:, None], body[idx].to(torch.int32), 0)


def fill_ones(rows: torch.Tensor, nbits: torch.Tensor) -> torch.Tensor:
    """Per-lane clean byte rows (NL, L+1) with every bit from nbits (NL,)
    on set: the 1-bits the scalar HT decoder reads past a sub-stream's
    end (its readers take 0xFF bytes there)."""
    k8 = 8 * torch.arange(rows.shape[1], device=rows.device)
    keep = (nbits.to(torch.int64)[:, None] - k8).clamp(0, 8)
    return rows | ((0xFF << keep) & 0xFF).to(rows.dtype)


def unstuff_suffix(suf_f: torch.Tensor, suf_r: torch.Tensor,
                   Dm: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Un-stuff the raw HT cleanup suffix: (mel_clean, vlc_clean) as
    (NL, L+1) int32 byte arrays.

    MEL reads suf_f forward MSB-first with 7 payload bits after 0xFF;
    VLC reads suf_r (the reversed view, starting at the nibble byte
    ln-2) with the 0x7F-after->0x8F rule.  Un-stuffing only deletes
    bits, so clean byte j comes from source bytes j+d, j+d+1 for some
    d in [0, Dm]; Dm bounds d from the C scan's stuffing-event counts."""
    NL, L1 = suf_f.shape
    L = L1 - 1
    i32 = torch.int32
    dev = suf_f.device

    def rev8(x):
        x = ((x & 0x55) << 1) | ((x >> 1) & 0x55)
        x = ((x & 0x33) << 2) | ((x >> 2) & 0x33)
        return ((x & 0x0F) << 4) | ((x >> 4) & 0x0F)

    def repack(pv, nb):
        # clean byte j draws bits [8j, 8j+8) from source bytes k, k+1
        # where P[k] <= 8j < P[k+1], P = exclusive prefix sum of nb
        pad = Dm + 2
        pvp = torch.nn.functional.pad(pv, (0, pad))
        nbp = torch.nn.functional.pad(nb, (0, pad), value=8)
        P = (torch.cumsum(nbp, dim=1) - nbp).to(i32)
        j8 = 8 * torch.arange(L, device=dev, dtype=i32)[None]
        out = torch.zeros((NL, L), dtype=i32, device=dev)
        for d in range(Dm + 1):
            off = j8 - P[:, d:d + L]
            nbd = nbp[:, d:d + L]
            cond = (off >= 0) & (off < nbd)
            offc = off.clamp(0, 7)
            # the shift is >= 1 wherever cond holds; clamp elsewhere
            lsh = (nbd - offc).clamp(0, 31)
            val = ((pvp[:, d:d + L] >> offc)
                   | (pvp[:, d + 1:d + 1 + L] << lsh)) & 0xFF
            out = torch.where(cond, val, out)
        return out

    # --- MEL: forward MSB-first ------------------------------------------
    prevff = torch.cat([torch.zeros((NL, 1), dtype=i32, device=dev),
                        (suf_f[:, :-1] == 0xFF).to(i32)], dim=1)
    pv_mel = torch.where(prevff == 1, rev8(suf_f & 0x7F) >> 1, rev8(suf_f))
    mel = repack(pv_mel, 8 - prevff)

    # --- VLC: backward; suf_r[0] is the nibble byte ln-2 ------------------
    first = torch.zeros((1, L1), dtype=torch.bool, device=dev)
    first[0, 0] = True
    prev = torch.cat([torch.zeros((NL, 1), dtype=i32, device=dev),
                      suf_r[:, :-1]], dim=1)
    is7 = ~first & (prev > 0x8F) & (suf_r == 0x7F)
    pv_vlc = torch.where(first, suf_r >> 4,
                         torch.where(is7, suf_r & 0x7F, suf_r))
    nb_vlc = torch.where(first, 4, torch.where(is7, 7, 8)).to(i32)
    vlc = repack(pv_vlc, nb_vlc)

    pad1 = torch.zeros((NL, 1), dtype=i32, device=dev)
    return torch.cat([mel, pad1], dim=1), torch.cat([vlc, pad1], dim=1)


def mq_groups(buckets) -> list:
    """K3's launches over a program's Part-1 lanes: [(W, H, bucket
    indices)], one launch in W x H lanes each.  One group where the
    largest bucket dims hold at most 4096 samples (the components code
    blocks of one shape, and no bucket is larger than its nominal block);
    else each bucket, largest first, joins the first group whose dims
    still fit (components coding blocks of different shapes, such as
    128x32 and 32x128)."""
    groups = []
    for bi in sorted(range(len(buckets)),
                     key=lambda i: -buckets[i].W * buckets[i].H):
        b = buckets[bi]
        for g in groups:
            W, H = max(g[0], b.W), max(g[1], b.H)
            if W * H <= 4096:
                g[0], g[1] = W, H
                g[2].append(bi)
                break
        else:
            groups.append([b.W, b.H, [bi]])
    return [(W, H, sorted(bis)) for W, H, bis in groups]


@dataclass(frozen=True)
class Bucket:
    """Every stream's code-blocks of one padded size, stream-major (lane =
    stream * len(blocks) + block): one K1 launch; K3 takes the lanes of
    all buckets in one launch."""
    W: int
    H: int
    blocks: tuple     # per block: (ci, r, orient, yoff, xoff, bh, bw,
    #                                delta, irrev), one stream's worth


class DecodeProgram:
    """The static half of the serving decode for one signature: lane
    sizes per bucket and the band placement index tensors, on device."""

    def __init__(self, comps_sig: tuple, mct_mode: int, N: int,
                 buckets: tuple, device: torch.device, roi: tuple = (),
                 custom_inv: np.ndarray | None = None):
        """roi: per component, its ROI Maxshift (0 for none);
        custom_inv: the (C, C) float64 inverse of a custom MCT's matrix
        (mct_mode 3), else None."""
        self.comps_sig = comps_sig
        self.mct_mode = mct_mode
        self.N = N
        self.buckets = buckets
        self.device = device
        # the filter of each component (5/3 or 9/7): a 9/7 component's
        # bands dequantize to float32, a 5/3 component's to int32
        self.irrevs = tuple(bool(cs[5]) for cs in comps_sig)
        if mct_mode == 1 and any(self.irrevs[:3]):
            # the JAX package's inverse RCT shifts its three planes, which
            # numpy refuses on a 9/7 plane
            raise TypeError("inverse RCT over a 9/7 component")

        # band layout in one flat buffer: component by component, band
        # by band, each band an (N, bh, bw) block of all N streams
        self.band_at: dict = {}
        pos = 0
        for ci, cs in enumerate(comps_sig):
            for (r, orient, brect, _d) in cs[6]:
                bh, bw = brect[3] - brect[1], brect[2] - brect[0]
                self.band_at[(ci, r, orient)] = (pos, bh, bw)
                pos += N * bh * bw
        self.total = pos

        srcs, tgts, scales, irrs, whs, oris, shifts = ([], [], [], [], [],
                                                       [], [])
        self.lane_base = []       # first lane of each bucket in the meta
        lanes = 0
        src_base = 0              # offset of the bucket in the cat output
        for b in buckets:
            nb = len(b.blocks)
            self.lane_base.append(lanes)
            blk = np.array([t[3:7] for t in b.blocks], np.int64)
            yoff, xoff, bh, bw = blk.T
            band = np.array([self.band_at[t[:3]] for t in b.blocks],
                            np.int64)
            start, BH, BW = band.T
            si = np.arange(N)[:, None, None, None]
            j = np.arange(nb)[None, :, None, None]
            y = np.arange(b.H)[None, None, :, None]
            x = np.arange(b.W)[None, None, None, :]
            inside = np.broadcast_to((y < bh[j]) & (x < bw[j]),
                                     (N, nb, b.H, b.W))
            lane = si * nb + j
            src = src_base + (lane * b.H + y) * b.W + x
            tgt = (start[j] + si * BH[j] * BW[j]
                   + (yoff[j] + y) * BW[j] + xoff[j] + x)
            srcs.append(np.broadcast_to(src, inside.shape)[inside])
            tgts.append(np.broadcast_to(tgt, inside.shape)[inside])
            half_delta = np.array([t[7] * 0.5 if t[8] else 0.0
                                   for t in b.blocks], np.float32)
            scales.append(np.broadcast_to(half_delta[j],
                                          inside.shape)[inside])
            irr = np.array([bool(t[8]) for t in b.blocks])
            irrs.append(np.broadcast_to(irr[j], inside.shape)[inside])
            if any(roi):
                sh = np.array([roi[t[0]] for t in b.blocks], np.int64)
                shifts.append(np.broadcast_to(sh[j], inside.shape)[inside])
            whs.append(np.tile(np.stack([bw, bh], 1), (N, 1)))
            oris.append(np.tile([t[2] for t in b.blocks], N))
            lanes += N * nb
            src_base += N * nb * b.H * b.W

        def dev_t(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   dtype=dtype).to(device)

        src, tgt = np.concatenate(srcs), np.concatenate(tgts)
        scale, irr = np.concatenate(scales), np.concatenate(irrs)
        # the placement per filter: (9/7, the placed samples' positions
        # in src order or None for all, their targets, the 9/7 half
        # steps or None)
        self.src = dev_t(src, torch.int64)
        self.place = []
        for irrev in (False, True):
            sel = np.nonzero(irr == irrev)[0]
            if not len(sel):
                continue
            whole = len(sel) == len(irr)
            self.place.append((
                irrev, None if whole else dev_t(sel, torch.int64),
                dev_t(tgt if whole else tgt[sel], torch.int64),
                dev_t(scale if whole else scale[sel], torch.float32)
                if irrev else None))
        # per placed sample, its component's ROI shift (None: no ROI);
        # shifts past 62 leave every int32 magnitude as it is
        self.roi = (dev_t(np.minimum(np.concatenate(shifts), 62),
                          torch.int64) if shifts else None)
        self.custom_inv = (dev_t(custom_inv, torch.float64)
                           if custom_inv is not None else None)
        self.wh = [(dev_t(a[:, 0], torch.int32), dev_t(a[:, 1], torch.int32))
                   for a in whs]
        self.mq_groups = mq_groups(buckets)
        # each lane's bucket, in meta order (K3's groups select by it)
        self.lane_bucket = dev_t(np.repeat(
            np.arange(len(buckets)), [N * len(b.blocks) for b in buckets]),
            torch.int64)
        self.mq_lanes = (dev_t(np.concatenate(oris), torch.int32),
                         torch.cat([w for w, _h in self.wh]),
                         torch.cat([h for _w, h in self.wh]))

    def lane_meta(self, meta: torch.Tensor, bi: int) -> torch.Tensor:
        lo = self.lane_base[bi]
        return meta[lo:lo + self.N * len(self.buckets[bi].blocks)]

    def stage(self, body: torch.Tensor, meta: torch.Tensor, bi: int,
              Lms: int, Lsuf: int, Dm: int) -> tuple:
        """K1's inputs of bucket bi: (ms, mel, vlc, p, w, h, valid), each
        stream filled with 1-bits past its clean bits."""
        mt = self.lane_meta(meta, bi).to(torch.int64)
        u8 = torch.uint8
        ms = fill_ones(stage_bytes(body, mt[:, 0], mt[:, 1], Lms, False),
                       mt[:, 10])
        suf_f = stage_bytes(body, mt[:, 2], mt[:, 3], Lsuf, False)
        suf_r = stage_bytes(body, mt[:, 2], mt[:, 3] - 1, Lsuf, True)
        mel, vlc = unstuff_suffix(suf_f, suf_r, Dm)
        mel, vlc = fill_ones(mel, mt[:, 11]), fill_ones(vlc, mt[:, 12])
        w, h = self.wh[bi]
        return (ms.to(u8), mel.to(u8), vlc.to(u8),
                mt[:, 4].to(torch.int32), w, h, mt[:, 5].to(torch.int32))

    def stage_mq(self, body: torch.Tensor, meta: torch.Tensor) -> tuple:
        """K3's inputs for the lanes of every bucket, in meta order:
        (body, start, npass, nbps, orient, w, h, style, ptbl), one
        default-style codeword segment [0, dlen) per lane that opens at
        pass 0 and is never raw.  decode_mq decodes them."""
        start, dlen, npass, nbps = (meta[:, k].contiguous()
                                    for k in (6, 7, 8, 9))
        zero = torch.zeros_like(dlen)
        ptbl = torch.stack([zero, dlen, zero], 1)[:, None].contiguous()
        ori, w, h = self.mq_lanes
        return (body, start, npass, nbps, ori, w, h, zero, ptbl)

    def stage_mq_lanes(self, body: torch.Tensor, rows: torch.Tensor,
                       ptbl: torch.Tensor, pos: torch.Tensor) -> tuple:
        """K3's inputs for the general route's Part-1 lanes, in any mode
        switches: (body, start, npass, nbps, orient, w, h, style, ptbl).
        rows: (n, 4) int32 on the device, each lane's (start in body,
        npass, nbps, style); ptbl: (n, P, 3) int32, the lanes' segment
        tables (ops/t1_decode.py segment_table), uploaded with the body;
        pos: (n,) int64, each lane's index in meta order, which selects
        its orient and size."""
        ori, w, h = self.mq_lanes
        start, npass, nbps, style = (rows[:, k].contiguous()
                                     for k in range(4))
        return (body, start, npass, nbps, ori[pos], w[pos], h[pos], style,
                ptbl)

    def decode_mq(self, args: tuple, pos: torch.Tensor | None = None,
                  mesh=None, shard: torch.Tensor | None = None) -> list:
        """K3 over Part-1 lanes, one launch per group of mq_groups: args
        are stage_mq's (every lane, in meta order; pos None) or
        stage_mq_lanes' (pos: (n,) int64 on the device, each lane's index
        in meta order).  With a device mesh (parallel/sharding.py Mesh),
        the lanes that shard (True in shard, (n,) bool on the device: the
        default-style single-segment ones; shard None: every lane, as
        the serving decode stages them) are decoded with their K3
        launches split over the mesh, one per shard, and the others on
        the first device, as the JAX package's mesh decode shards them.
        Returns per bucket its lanes' (n, H, W) int32 samples, zeros on
        the lanes not given; None for a bucket none of whose group's lanes
        was given."""
        total = self.lane_bucket.shape[0]
        outs = [None] * len(self.buckets)
        for W, H, bis in self.mq_groups:
            sub, at, sh = args, pos, shard
            if len(self.mq_groups) > 1:
                owner = self.lane_bucket if pos is None \
                    else self.lane_bucket[pos]
                k = torch.nonzero(torch.isin(owner, torch.tensor(
                    bis, device=owner.device)))[:, 0]
                if not k.numel():
                    continue
                sub = _lanes(args, k)
                at = k if pos is None else pos[k]
                sh = None if shard is None else shard[k]
            got = t1_decode_lanes(*sub, W, H) if mesh is None \
                else _decode_mq_meshed(sub, W, H, mesh, sh)
            if at is None:
                full = got
            else:
                full = got.new_zeros((total, H, W))
                full[at] = got
            for bi in bis:
                b, lo = self.buckets[bi], self.lane_base[bi]
                outs[bi] = full[lo:lo + self.N * len(b.blocks), :b.H, :b.W]
        return outs

    def run(self, body: torch.Tensor, meta: torch.Tensor,
            dims: list, mesh=None) -> list:
        """body: uint8 digest and/or raw codewords; meta: (lanes,
        META_COLS) int32; dims: per bucket (Lms, Lsuf, Dm, any HT lane,
        any Part-1 lane); mesh: a parallel/sharding.py Mesh whose first
        device is the program's, over which K3's lanes (all default
        style, one segment) and the synthesis levels are sharded, or
        None.  Returns N lists of per-component int32 planes."""
        with trace("decode.program"):
            if mesh is not None:
                count("decode.mesh.cards", mesh.size)
            # 1-2. the block decodes: K3 over every Part-1 lane (once, or
            # once per group of bucket shapes; with a mesh once per shard
            # of each), K1 per bucket on the first device
            if any(d[4] for d in dims):
                with trace("decode.program.k3"):
                    mq = self.decode_mq(self.stage_mq(body, meta),
                                        mesh=mesh)
            ms2, ht = [], []
            for bi, b in enumerate(self.buckets):
                Lms, Lsuf, Dm, any_ht, any_mq = dims[bi]
                n = self.N * len(b.blocks)
                if any_ht:
                    with trace("decode.program.k1_stage", W=b.W, H=b.H):
                        args = self.stage(body, meta, bi, Lms, Lsuf, Dm)
                    with trace("decode.program.k1", W=b.W, H=b.H):
                        out, err = ht_decode_lanes(*args, b.W, b.H)
                    ht.append((bi, args, err))
                else:
                    out = torch.zeros((n, b.H, b.W), dtype=torch.int32,
                                      device=self.device)
                if any_mq:
                    out = out + mq[bi]
                ms2.append(out)
            planes = self.synthesize(ms2, mesh=mesh)
            wide = redecode_marked(
                ms2, [(bi, args, None, err) for bi, args, err in ht],
                lambda bi, a, _rf: ht_decode_lanes(
                    *a, self.buckets[bi].W, self.buckets[bi].H,
                    i64=True)[0])
            return planes if wide is None \
                else self.synthesize(wide, mesh=mesh)

    def synthesize(self, outs: list, mct_round: bool = False,
                   mesh=None) -> list:
        """Steps 3-5 from the block decodes: outs[bi] is bucket bi's
        (N * blocks, H, W) int32 signed mag2 with the half-bit, in lane
        order (int64 after redecode_marked: only the dequantization then
        runs in int64).  mct_round: under a custom MCT, round the reversible
        components to the nearest integer instead of truncating them
        toward zero (the JAX package rounds them where its C block
        decoder takes the tile, a tile without HT blocks).  mesh: a
        parallel/sharding.py Mesh whose first device is the program's:
        every synthesis level row-sharded over it (inv_2d_level_sharded,
        equal to the unsharded level).  Returns N lists of per-component
        int32 planes."""
        with trace("decode.program.synth"):
            m = torch.cat([o.reshape(-1) for o in outs])[self.src]

            # 3. ROI Maxshift, dequantize + place (signed mag2 carries the
            # half-bit, as the threshold of the Maxshift expects), each
            # filter's samples into a flat buffer of its own dtype
            m2 = m.abs()
            if self.roi is not None:
                big = m2.to(torch.int64) >= (1 << self.roi)
                m2 = torch.where(big, m2 >> self.roi.to(torch.int32), m2)
            flats = {}
            for irrev, sel, tgt, scale in self.place:
                ms, m2s = (m, m2) if sel is None else (m[sel], m2[sel])
                if irrev:
                    sign = torch.where(ms < 0, -1.0, 1.0)
                    vals = sign * m2s.to(torch.float32) * scale
                    flat = torch.zeros(self.total, dtype=torch.float32,
                                       device=self.device)
                else:
                    vals = torch.where(ms < 0, -(m2s >> 1), m2s >> 1)
                    flat = torch.zeros(self.total, dtype=torch.int32,
                                       device=self.device)
                # int64 planes (redecode_marked): each coefficient sign *
                # (mag2 >> 1) in int64, then wrapped to int32, as the JAX
                # package's host decode places its int64 band arrays in int32
                # synthesis buffers
                flat[tgt] = vals.to(flat.dtype)
                flats[irrev] = flat

            N = self.N

            def band(ci, r, orient):
                pos, bh, bw = self.band_at[(ci, r, orient)]
                flat = flats.get(self.irrevs[ci])
                if flat is None:    # a component without code-blocks
                    flat = flats[not self.irrevs[ci]].new_zeros(
                        self.total, dtype=torch.float32 if self.irrevs[ci]
                        else torch.int32)
                    flats[self.irrevs[ci]] = flat
                return flat[pos:pos + N * bh * bw].view(N, bh, bw)

            # 4. inverse DWT per component, all N streams at once
            level = dwt.inv_2d_level if mesh is None else partial(
                inv_2d_level_sharded, mesh=mesh)
            outs = []
            for ci, cs in enumerate(self.comps_sig):
                (rect_t, numres, r_lim, _prec, _sgnd, irrev, _bands) = cs
                rect = Rect(*rect_t)
                cur = band(ci, 0, BAND_LL)
                nl = numres - 1
                for r in range(1, r_lim):
                    s = 1 << (nl - r)
                    with trace(f"decode.program.dwt.r{r}"):
                        cur = level(cur, band(ci, r, 1), band(ci, r, 2),
                                    band(ci, r, 3), rect.ceil_scale(s, s),
                                    irrev)
                outs.append(cur)

            # 5. inverse MCT + DC unshift/clip
            if self.custom_inv is not None:
                outs = mct.custom_mct(outs, self.custom_inv)
            elif self.mct_mode == 2 and len(outs) >= 3:
                # ICT (component 0 on 9/7): a 5/3 plane among the three goes
                # in as float32
                outs[0], outs[1], outs[2] = mct.ict_inv(
                    *(o.to(torch.float32) for o in outs[:3]))
            elif self.mct_mode and len(outs) >= 3:
                outs[0], outs[1], outs[2] = mct.rct_inv(outs[0], outs[1],
                                                        outs[2])
            final = []
            for ci, cs in enumerate(self.comps_sig):
                (_rect, _numres, _r_lim, prec, sgnd, irrev, _bands) = cs
                arr = outs[ci]
                if irrev or (self.custom_inv is not None and mct_round):
                    arr = torch.round(arr)
                elif arr.is_floating_point():
                    # a 5/3 plane through the ICT or a custom MCT: truncated
                    # toward zero, as the JAX package casts it
                    arr = torch.trunc(arr)
                final.append(mct.dc_shift_inv(arr.to(torch.int32), prec, sgnd))
            return [[final[ci][si] for ci in range(len(final))]
                    for si in range(N)]


def _lanes(args: tuple, k: torch.Tensor) -> tuple:
    """K3's arguments of the lanes k (the body stays whole)."""
    return (args[0],) + tuple(t.index_select(0, k) for t in args[1:])


def _decode_mq_meshed(args: tuple, W: int, H: int, mesh,
                      shard: torch.Tensor) -> torch.Tensor:
    """K3 over one group's lanes with a mesh: the sharded lanes (shard
    None: all) through t1_decode_lanes_sharded (one launch per shard),
    the rest (styled or several segments) through one launch on the
    first device."""
    if shard is None:
        return t1_decode_lanes_sharded(*args, W, H, mesh=mesh)
    k = torch.nonzero(shard)[:, 0]
    if k.numel() == shard.numel():
        return t1_decode_lanes_sharded(*args, W, H, mesh=mesh)
    out = torch.zeros((shard.numel(), H, W), dtype=torch.int32,
                      device=shard.device)
    if k.numel():
        out[k] = t1_decode_lanes_sharded(*_lanes(args, k), W, H, mesh=mesh)
    rest = torch.nonzero(~shard)[:, 0]
    out[rest] = t1_decode_lanes(*_lanes(args, rest), W, H)
    return out


def redecode_marked(outs: list, ht: list, decode_i64) -> list | None:
    """The repair of magnitudes of 2^31 or more, after a decode's block
    coders ran: outs[bi] is bucket bi's int32 output; ht holds (bi, K1/K2
    arguments, refine mask or None, error codes) for each bucket the HT
    coders decoded.  One read-back says whether any lane is marked
    (ops/ht_decode.py MARK_I64, only a corrupt block's): if none, None,
    and the int32 synthesis stands.  Otherwise every bucket as int64, the
    marked lanes re-decoded by decode_i64(bi, their arguments, their
    refine mask) (int64 planes, the scalar decoder's), added to the
    bucket's Part-1 output on those lanes (zero on an HT lane), for a
    synthesis whose dequantization runs in int64, as the JAX package's
    host decode does (sign * (mag2 >> 1), then int32 on)."""
    if not ht:
        return None
    flags = [(err == MARK_I64) for _bi, _a, _rf, err in ht]
    with trace("decode.program.readback"):
        marked = bool(torch.stack([f.any() for f in flags]).any())
    if not marked:
        return None
    wide = [o.to(torch.int64) for o in outs]
    for (bi, args, rf, err), f in zip(ht, flags):
        sel = torch.nonzero(f)[:, 0]
        if not sel.numel():
            continue
        sub = tuple(t.index_select(0, sel) for t in args)
        got = decode_i64(bi, sub, None if rf is None
                         else rf[sel.cpu().numpy()])
        # the int32 output of those lanes is theirs alone modulo 2^32;
        # the difference is the int64 decode's
        wide[bi][sel] += got - got.to(torch.int32).to(torch.int64)
    return wide
