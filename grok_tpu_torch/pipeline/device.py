"""Fused serving decode on the device: the `ht3` route of
grok_tpu/pipeline/device.py `_build_decode_fn`, in PyTorch.

One uploaded digest (per block: the clean MagSgn stream and the raw
cleanup suffix, from the host C scan) and one per-lane meta array go in;
per component int32 pixel planes of all N streams come out, resident on
the device.  In between, per bucket of same-sized code-blocks:

  1. stage each lane's sub-streams from the digest (masked byte gathers)
     and un-stuff MEL and VLC from the raw suffix;
  2. decode the HT cleanup pass (ops/ht_decode.py, kernel K1);

then for the whole batch:

  3. dequantize and place every block into its band (one gather and one
     scatter over index tensors built once per program);
  4. inverse DWT per component, on (N, H, W) stacks of all N streams;
  5. inverse RCT/ICT and the DC shift with clipping.

A DecodeProgram is built once per signature (plan geometry, batch size,
bucket layout, table version) and cached by the caller.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from grok_tpu.core.geometry import BAND_LL, Rect
from grok_tpu_torch.ops import dwt, mct
from grok_tpu_torch.ops.ht_decode import ht_decode_lanes

# per-lane meta columns of the uploaded meta array
META_COLS = 6     # ms_start, ms_len, suf_start, suf_len, p, valid


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


@dataclass(frozen=True)
class Bucket:
    """One kernel launch: every stream's code-blocks of one padded size,
    stream-major (lane = stream * len(blocks) + block)."""
    W: int
    H: int
    blocks: tuple     # per block: (ci, r, orient, yoff, xoff, bh, bw,
    #                                delta, irrev), one stream's worth


class DecodeProgram:
    """The static half of the serving decode for one signature: lane
    sizes per bucket and the band placement index tensors, on device."""

    def __init__(self, comps_sig: tuple, mct_mode: int, N: int,
                 buckets: tuple, device: torch.device):
        self.comps_sig = comps_sig
        self.mct_mode = mct_mode
        self.N = N
        self.buckets = buckets
        self.device = device
        irrevs = {bool(cs[5]) for cs in comps_sig}
        if len(irrevs) != 1:
            raise NotImplementedError(
                "serving decode: components mixing 5/3 and 9/7")
        self.irrev = irrevs.pop()

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

        srcs, tgts, scales, whs = [], [], [], []
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
            if self.irrev:
                half_delta = np.array([t[7] * 0.5 for t in b.blocks],
                                      np.float32)
                scales.append(np.broadcast_to(half_delta[j],
                                              inside.shape)[inside])
            whs.append(np.tile(np.stack([bw, bh], 1), (N, 1)))
            lanes += N * nb
            src_base += N * nb * b.H * b.W

        def dev_t(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   dtype=dtype).to(device)

        self.src = dev_t(np.concatenate(srcs), torch.int64)
        self.tgt = dev_t(np.concatenate(tgts), torch.int64)
        self.scale = (dev_t(np.concatenate(scales), torch.float32)
                      if self.irrev else None)
        self.wh = [(dev_t(a[:, 0], torch.int32), dev_t(a[:, 1], torch.int32))
                   for a in whs]

    def stage(self, body: torch.Tensor, meta: torch.Tensor, bi: int,
              Lms: int, Lsuf: int, Dm: int) -> tuple:
        """Kernel inputs of bucket bi: (ms, mel, vlc, p, w, h, valid)."""
        b = self.buckets[bi]
        lo = self.lane_base[bi]
        mt = meta[lo:lo + self.N * len(b.blocks)].to(torch.int64)
        u8 = torch.uint8
        ms = stage_bytes(body, mt[:, 0], mt[:, 1], Lms, False)
        suf_f = stage_bytes(body, mt[:, 2], mt[:, 3], Lsuf, False)
        suf_r = stage_bytes(body, mt[:, 2], mt[:, 3] - 1, Lsuf, True)
        mel, vlc = unstuff_suffix(suf_f, suf_r, Dm)
        w, h = self.wh[bi]
        return (ms.to(u8), mel.to(u8), vlc.to(u8),
                mt[:, 4].to(torch.int32), w, h, mt[:, 5].to(torch.int32))

    def run(self, body: torch.Tensor, meta: torch.Tensor,
            dims: list) -> list:
        """body: uint8 digest; meta: (lanes, META_COLS) int32; dims: per
        bucket (Lms, Lsuf, Dm).  Returns N lists of per-component int32
        planes."""
        # 1-2. stage + HT cleanup decode per bucket
        ms2 = []
        for bi, b in enumerate(self.buckets):
            lanes = self.stage(body, meta, bi, *dims[bi])
            ms2.append(ht_decode_lanes(*lanes, b.W, b.H).reshape(-1))
        m = torch.cat(ms2)[self.src]

        # 3. dequantize + place (signed mag2 carries the half-bit)
        m2 = m.abs()
        if self.irrev:
            sign = torch.where(m < 0, -1.0, 1.0)
            vals = sign * m2.to(torch.float32) * self.scale
            flat = torch.zeros(self.total, dtype=torch.float32,
                               device=self.device)
        else:
            vals = torch.where(m < 0, -(m2 >> 1), m2 >> 1)
            flat = torch.zeros(self.total, dtype=torch.int32,
                               device=self.device)
        flat[self.tgt] = vals

        N = self.N

        def band(ci, r, orient):
            pos, bh, bw = self.band_at[(ci, r, orient)]
            return flat[pos:pos + N * bh * bw].view(N, bh, bw)

        # 4. inverse DWT per component, all N streams at once
        outs = []
        for ci, cs in enumerate(self.comps_sig):
            (rect_t, numres, r_lim, _prec, _sgnd, irrev, _bands) = cs
            rect = Rect(*rect_t)
            cur = band(ci, 0, BAND_LL)
            nl = numres - 1
            for r in range(1, r_lim):
                s = 1 << (nl - r)
                cur = dwt.inv_2d_level(cur, band(ci, r, 1), band(ci, r, 2),
                                       band(ci, r, 3),
                                       rect.ceil_scale(s, s), irrev)
            outs.append(cur)

        # 5. inverse MCT + DC unshift/clip
        if self.mct_mode and len(outs) >= 3:
            inv = mct.ict_inv if self.mct_mode == 2 else mct.rct_inv
            outs[0], outs[1], outs[2] = inv(outs[0], outs[1], outs[2])
        final = []
        for ci, cs in enumerate(self.comps_sig):
            (_rect, _numres, _r_lim, prec, sgnd, irrev, _bands) = cs
            arr = outs[ci]
            if irrev or (self.mct_mode == 2 and ci < 3):
                arr = torch.round(arr)
            final.append(mct.dc_shift_inv(arr.to(torch.int32), prec, sgnd))
        return [[final[ci][si] for ci in range(len(final))]
                for si in range(N)]
