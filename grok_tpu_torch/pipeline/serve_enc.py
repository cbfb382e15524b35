"""Batched serving encode on a PyTorch device: HTJ2K, Part-1 and
HT-mixed.

The branches of grok_tpu/pipeline/serve_enc.py `try_encode_serving_
batch`, and what grok_tpu.compress_device codes on the host through
grok_tpu/pipeline/tile.py `encode_tile`: N same-geometry frames of one
tile go through one device pass —

  1. DC shift, RCT/ICT or a custom MCT, forward DWT and quantization to
     mneg = (magnitude << 1) | sign, on (N, h, w) stacks of all frames
     (ops/mct.py, ops/dwt.py; 9/7 quantizes in f32 as the JAX device
     path does, in float64 after a custom MCT or past 24 magnitude
     planes as its host path does),
     and the ROI's Maxshift upshift inside each band's window;
  2. every code-block of every frame gathered into one lane of an
     (NL, H, W) tensor, frame-major (one gather over index tensors built
     once per plan), each lane with its own (w, h);
  3. one launch of the block coder: the HT cleanup encode, kernel K4
     (ops/ht_encode.py), for HT code-blocks, or with ht_planes = P > 0
     kernel K4r, which codes each lane's cleanup at plane min(P,
     numbps - 1) and, where that plane is above 0, HT SigProp and HT
     MagRef at the plane below; the EBCOT/MQ encode, kernel K5
     (ops/t1_encode.py), for Part-1 code-blocks in their code-block
     style (any of the six mode switches); both for HT-mixed sets (the
     Part-1 coding in the default style), which keep the smaller
     codeword per block (HT on ties) and name the HT blocks in a COM
     bitmap, as the JAX package's mixed encoder does;
  4. for a multi-layer or byte-rate-targeted encode, each lane's exact
     distortion after each of its passes, summed in int64 on the device
     (one pass over the staged lanes for HT, one pass row at a time for
     Part-1);
  5. one download of the per-lane stats (bit counts or lengths and
     watermarks, magnitude, the distortion sums), then the used bytes
     compacted on the device by a prefix sum over the per-lane byte
     counts and downloaded once;

— and the host finishes: for HT the C wire assembly (native.ht_assemble_
batch) stuffs and interleaves each block's three cleanup streams and
native.ht_raw_batch stuffs the refinement streams; the Tier-2 finish
(pipeline/tile.py) runs the PCRD allocation for several layers or byte
targets, shrinks each targeted Part-1 block's final truncation by trial
decodes on the device (K3), and emits the packets.

Scope: HT code-blocks (cleanup-only or refined), Part-1 code-blocks in
any style of the six mode switches, or HT-mixed sets of HT and
default-style Part-1 blocks, at any number of layers, byte-rate or
quality targets; one tile per call (the entry point loops over a
stream's tiles and splits them into tile-parts, api.py
compress_device_batch); any precincts, progression-order changes and
PPM's split packet headers (the Tier-2 finish, pipeline/tile.py); ROI
and a custom MCT (AUTO_RD is the entry point's choice between two
encodes); every precision the reference encodes (up to 27 bits: block
magnitudes below 2^30, the distortion sums split into exact int64
halves).  Anything else (HT code-blocks with Part-1 mode switches,
components mixing 5/3 and 9/7) raises NotImplementedError naming the
route: the port has no host encoder to fall back to.  Reversible streams are
byte-identical to the JAX package's encoders.

With params.mesh (a parallel/sharding.py Mesh whose first device is the
frames' device), every forward DWT level is split by rows across the
mesh with halo exchange and the default-style Part-1 lanes are coded
by one K5 launch per shard, as the JAX package's mesh encode shards
them (the PCRD slope bracket, which the JAX package reduces over the
mesh, comes from the hulls on the host here: the port's hulls live
there); HT lanes (K4, K4r), styled Part-1 lanes and the refinement's
trial decodes run on the first device.  The bytes equal the unsharded
encode's.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np
import torch

from grok_tpu_torch import native
from grok_tpu_torch.codestream import j2k
from grok_tpu_torch.core.geometry import Rect
from grok_tpu_torch.core.params import CBLK_HT, MCTMode
from grok_tpu_torch.core.quant import band_level, band_norm
from grok_tpu_torch.ops import dwt, mct
from grok_tpu_torch.ops.ht_encode import (_bitlen, _cap_bytes,
                                          ht_encode_lanes, refine_caps)
from grok_tpu_torch.ops.t1_encode import (pass_records, t1_encode_lanes,
                                          t1_encode_lanes_sharded)
from grok_tpu_torch.parallel.sharding import fwd_multilevel_sharded
from grok_tpu_torch.pipeline.plan import _pow2_at_least
from grok_tpu_torch.pipeline.tile import (TileGeometry, band_window,
                                          canon_block_indices,
                                          finish_tile_encode)
from grok_tpu_torch.t1.records import SIG_SPP, EncodedBlock, PassInfo
from grok_tpu_torch.t2.rate import (layer_budget_consts,
                                    layer_targets_for_tile,
                                    quality_targets_for_tile)
from grok_tpu_torch.transform.mct_np import (custom_mct_inverse,
                                             mct_component_norms)

_log = logging.getLogger("grok_tpu_torch")

_EPLANS: dict = {}
_EPLANS_MAX = 16


def _unsupported(route: str, why: str) -> NotImplementedError:
    return NotImplementedError(
        f"{route} is not ported ({why}); the PyTorch port encodes "
        f"HT, Part-1 (any mode switches) and HT-mixed streams (tiled, "
        f"layered and rate-targeted too, HT refined too, with ROI and "
        f"any MCT) of components of any subsampling, precision (up to "
        f"27 bits) and signedness")


@dataclass
class EncPlan:
    geo: TileGeometry
    blocks: list              # per block: (ci, r, orient, yoff, xoff, bh, bw)
    lane_block: list          # per block: T2 key (c, r, p, band_i, cblk_i)
    lane_mb: np.ndarray       # Mb per block
    lane_w: np.ndarray        # PCRD distortion weight per block
    comps_sig: tuple          # per comp: (rect, numres, prec, sgnd, irrev,
    #                           ((r, orient, delta), ...))
    mct_mode: int             # 0 none, 1 RCT, 2 ICT, 3 custom (Part 2)
    W: int                    # lane block dims: the largest block
    H: int
    coder: str                # "ht" (K4, or K4 + K5 when mixed) or "mq"
    caps: tuple               # per-lane (LMS, LMEL, LVLC) bytes (K4)
    mq_caps: tuple            # per-lane byte capacity and watermark rows
    #                           (L, R) (K5)
    lane_style: np.ndarray    # code-block style per block
    band_rects: dict          # (ci, r, orient) -> the band's Rect
    fast: dict = field(default_factory=dict)   # device index tensors


def _build_plan(hdr, t: int) -> EncPlan:
    geo = TileGeometry.build(hdr, t)
    styles = {cs.cblk_style for cs in geo.styles}
    if styles == {CBLK_HT}:
        coder = "ht"
    elif not any(st & CBLK_HT for st in styles):
        coder = "mq"
    else:
        raise _unsupported("HT code-blocks with mode switches encode",
                           "a code-block style of HT with Part-1 mode "
                           "switches")
    irrevs = {bool(cs.irreversible) for cs in geo.styles}
    if len(irrevs) != 1:
        raise _unsupported("general encode", "components mixing 5/3 and "
                           "9/7")
    mct_norms = None
    if geo.cod.mct:
        mct_norms = mct_component_norms(bool(geo.styles[0].irreversible))
    elif geo.custom_mct is not None:
        mct_norms = mct_component_norms(
            True, custom_inv=custom_mct_inverse(geo.custom_mct))
    mbmax = 0
    W = H = 1
    blocks, lane_block, lane_mb, lane_w, comps_sig = [], [], [], [], []
    lane_style, band_rects = [], {}
    for c, tcg in enumerate(geo.tcgs):
        quant = geo.quants[c]
        cs = geo.styles[c]
        wc = float(mct_norms[c]) if mct_norms is not None and \
            c < len(mct_norms) else 1.0
        bands_sig = []
        for rg in tcg.resolutions:
            for band_i, bg in enumerate(rg.bands):
                bands_sig.append((rg.r, bg.orient,
                                  float(quant.delta(rg.r, bg.orient))))
                band_rects[(c, rg.r, bg.orient)] = bg.rect
                mb = quant.mb(rg.r, bg.orient)
                mbmax = max(mbmax, mb)
                # PCRD weight, op for op as the JAX package's encoders
                delta = quant.delta(rg.r, bg.orient)
                lvl = band_level(cs.num_resolutions, rg.r) \
                    if rg.r > 0 else cs.num_resolutions - 1
                bnorm = band_norm(bool(cs.irreversible), max(lvl, 0),
                                  bg.orient) if lvl > 0 else 1.0
                wgt = (delta * bnorm * wc) ** 2
                for p in range(rg.num_precincts):
                    for cblk_i, cb in enumerate(bg.precincts[p].cblks):
                        blocks.append((c, rg.r, bg.orient,
                                       cb.rect.y0 - bg.rect.y0,
                                       cb.rect.x0 - bg.rect.x0,
                                       cb.rect.h, cb.rect.w))
                        lane_block.append((c, rg.r, p, band_i, cblk_i))
                        lane_mb.append(mb)
                        lane_w.append(wgt)
                        lane_style.append(cs.cblk_style)
                        W = max(W, cb.rect.w)
                        H = max(H, cb.rect.h)
        rect = geo.comp_rects[c]
        comps_sig.append(((rect.x0, rect.y0, rect.x1, rect.y1),
                          cs.num_resolutions, hdr.comps[c].prec,
                          hdr.comps[c].sgnd, bool(cs.irreversible),
                          tuple(bands_sig)))
    if not blocks:
        raise _unsupported("general encode", "the tile has no code-blocks")
    # the lanes' bucket: the blocks' nominal power-of-two size (code-blocks
    # of any legal shape, sides up to 1024, at most 4096 samples)
    W, H = _pow2_at_least(W, lo=1), _pow2_at_least(H, lo=1)
    mct_mode = 0
    if geo.cod.mct and len(comps_sig) >= 3:
        mct_mode = 2 if geo.styles[0].irreversible else 1
    elif geo.custom_mct is not None:
        mct_mode = 3
    # per-lane stream capacities: MagSgn <= Mb + 1 bits per sample; MEL
    # <= 2 significance events + 1 initial-pair event of <= 6 bits per
    # quad pair (9 bits/quad); VLC <= 7-bit codeword + 8-bit UVLC per
    # quad (magnitudes below 2^30 keep U <= 31, so u stays below the
    # UVLC escape at 36)
    nq = ((W + 1) // 2) * ((H + 1) // 2)
    caps = (_cap_bytes(W * H * (mbmax + 2) // 8 + 16),
            _cap_bytes(nq * 9 // 8 + 16), _cap_bytes(nq * 15 // 8 + 16))
    # Part-1 codeword capacity: 4 bits per sample and magnitude plane
    # (the MQ coder spends about one bit per decision on noise-like data,
    # a decision per sample and plane plus a sign; a raw pass spends at
    # most two bits per sample), 8 bytes more per pass where a mode switch
    # may terminate segments (a flush and a stuffing byte), and one rate
    # row per pass of the deepest block
    R = max(3 * mbmax - 2, 1)
    mq_caps = (_cap_bytes(W * H * (mbmax + 1) // 2 + 64
                          + (8 * R if any(lane_style) else 0)), R)
    return EncPlan(geo=geo, blocks=blocks, lane_block=lane_block,
                   lane_mb=np.asarray(lane_mb, np.int32),
                   lane_w=np.asarray(lane_w, np.float64),
                   comps_sig=tuple(comps_sig), mct_mode=mct_mode, W=W, H=H,
                   coder=coder, caps=caps, mq_caps=mq_caps,
                   lane_style=np.asarray(lane_style, np.int32),
                   band_rects=band_rects)


def _hdr_key(hdr):
    """Geometry identity for the plan cache: the SIZ/COD/QCD content."""
    g = hdr.siz
    return (g.xsiz, g.ysiz, g.xosiz, g.yosiz, g.xtsiz, g.ytsiz,
            g.xtosiz, g.ytosiz,
            tuple((c.prec, c.sgnd, c.dx, c.dy) for c in hdr.comps),
            repr(hdr.cod), repr(hdr.qcd),
            tuple(sorted((k, repr(v)) for k, v in hdr.coc.items())),
            tuple(sorted((k, repr(v)) for k, v in hdr.qcc.items())),
            tuple(sorted(hdr.rgn.items())),
            None if hdr.custom_mct is None
            else np.asarray(hdr.custom_mct, np.float64).tobytes())


def _plan_for(hdr, t: int) -> EncPlan:
    key = (_hdr_key(hdr), t)
    plan = _EPLANS.get(key)
    if plan is None:
        plan = _build_plan(hdr, t)
        if len(_EPLANS) >= _EPLANS_MAX:
            _EPLANS.pop(next(iter(_EPLANS)))   # evict the oldest entry
        _EPLANS[key] = plan
    return plan


def _stage_bands(comps: list, plan: EncPlan, roi_rect=None,
                 mesh=None) -> dict:
    """DC shift + MCT + forward DWT + quantization of (N, h, w) component
    stacks, then the ROI's Maxshift upshift -> {(ci, r, orient): (N, bh,
    bw) int32 (mag << 1) | neg}.  mesh: every forward DWT level split by
    rows across the mesh's devices (parallel/sharding.py
    fwd_multilevel_sharded, equal to the unsharded levels), the bands
    back on the first device."""
    outs = []
    for ci, csig in enumerate(plan.comps_sig):
        (_rect, _numres, prec, sgnd, _irrev, _bands) = csig
        outs.append(mct.dc_shift_fwd(comps[ci].to(torch.int32), prec, sgnd))
    # past 24 magnitude planes the JAX package encodes on the host, in
    # float64; float32 holds only 24-bit integers, so the irreversible
    # transforms and quantization run in float64 there as well
    f64 = plan.mct_mode == 3 or int(plan.lane_mb.max()) > 24
    if plan.mct_mode == 3:
        # a custom MCT, in float64 (and so the 9/7 lifting and the
        # quantization after it), as the JAX package's host encode
        outs = mct.custom_mct(outs, torch.tensor(
            np.asarray(plan.geo.custom_mct, np.float64),
            device=outs[0].device))
    elif plan.mct_mode and len(outs) >= 3:
        if plan.mct_mode == 2:
            ft = torch.float64 if f64 else torch.float32
            outs[:3] = mct.ict_fwd(*(o.to(ft) for o in outs[:3]))
        else:
            outs[:3] = mct.rct_fwd(*outs[:3])
    band_mag, band_neg = {}, {}
    for ci, csig in enumerate(plan.comps_sig):
        (rect_t, numres, _prec, _sgnd, irrev, bands) = csig
        dtype = torch.float64 if f64 and irrev else None
        blist = dwt.fwd_multilevel(outs[ci], Rect(*rect_t), numres, irrev,
                                   dtype) if mesh is None else \
            fwd_multilevel_sharded(outs[ci], Rect(*rect_t), numres, irrev,
                                   mesh, dtype)
        for (r, orient, delta) in bands:
            arr = blist[0] if r == 0 else blist[r][orient - 1]
            if irrev and f64:
                mag = torch.floor(arr.abs() / delta).to(torch.int32)
            elif irrev:
                inv = torch.tensor(1.0 / delta, dtype=torch.float32,
                                   device=arr.device)
                mag = torch.floor(arr.abs() * inv).to(torch.int32)
            else:
                mag = arr.abs().to(torch.int32)
            band_mag[(ci, r, orient)] = mag
            band_neg[(ci, r, orient)] = (arr < 0).to(torch.int32)
    if plan.geo.rgn:
        _roi_upshift(plan, band_mag, roi_rect)
    return {k: (m << 1) | band_neg[k] for k, m in band_mag.items()}


def _roi_upshift(plan: EncPlan, band_mag: dict, roi_rect) -> None:
    """Maxshift ROI (ISO 15444-1 Annex H): the magnitudes of each ROI
    component's bands shifted up by its RGN shift inside the band's ROI
    window, the whole band or roi_rect (canvas coordinates) mapped into
    it by band_window, as grok_tpu/pipeline/tile.py `encode_tile` does;
    with its warning, once per frame and component, where a band's
    background magnitude reaches the shift."""
    geo = plan.geo
    wins = []
    for ci, csig in enumerate(plan.comps_sig):
        shift = geo.rgn.get(ci, 0)
        if shift <= 0:
            continue
        nl = csig[1] - 1
        for (r, orient, _delta) in csig[5]:
            key = (ci, r, orient)
            brect = plan.band_rects[key]
            if roi_rect is not None:
                dx, dy = geo.subsampling[ci]
                sub = Rect(*roi_rect).intersect(geo.rect).ceil_scale(dx, dy)
                bw = band_window(sub, nl, r, orient).intersect(brect)
            else:
                bw = brect
            if not bw.empty:
                wins.append((key, shift, bw, brect))
    if not wins:
        return
    bgmax = torch.stack([band_mag[key].reshape(
        band_mag[key].shape[0], -1).amax(1)
        for key, _s, _bw, _br in wins], 1).cpu().numpy()   # (N, bands)
    for fi in range(bgmax.shape[0]):
        warned = set()
        for i, (key, shift, _bw, _br) in enumerate(wins):
            m = int(bgmax[fi, i])
            if m >> shift and key[0] not in warned:
                warned.add(key[0])
                _log.warning(f"RGN shift {shift} < background magnitude "
                             f"bits ({m.bit_length()}); decode will be "
                             f"ambiguous (raise -R shift)")
    for key, shift, bw, br in wins:
        sl = band_mag[key][:, bw.y0 - br.y0:bw.y1 - br.y0,
                           bw.x0 - br.x0:bw.x1 - br.x0]
        sl <<= shift


def _lane_index(plan: EncPlan, N: int, device: torch.device):
    """(band order, flat source index of every lane sample, per-lane w,
    h): the gather that batches all N frames' code-blocks into lanes
    (lane = frame * blocks + block), built once per (N, device).  Padded
    samples index the zero appended after the last band."""
    key = ("lanes", N, str(device))
    got = plan.fast.get(key)
    if got is not None:
        return got
    order, start = [], {}
    pos = 0
    for ci, tcg in enumerate(plan.geo.tcgs):
        for rg in tcg.resolutions:
            for bg in rg.bands:
                key_b = (ci, rg.r, bg.orient)
                start[key_b] = (pos, bg.rect.h, bg.rect.w)
                order.append(key_b)
                pos += N * bg.rect.h * bg.rect.w
    W, H = plan.W, plan.H
    blk = np.array([b[3:7] for b in plan.blocks], np.int64)
    yoff, xoff, bh, bw = blk.T
    band = np.array([start[b[:3]] for b in plan.blocks], np.int64)
    s0, BH, BW = band.T
    f = np.arange(N)[:, None, None, None]
    j = np.arange(len(plan.blocks))[None, :, None, None]
    y = np.arange(H)[None, None, :, None]
    x = np.arange(W)[None, None, None, :]
    inside = (y < bh[j]) & (x < bw[j])
    src = s0[j] + f * BH[j] * BW[j] + (yoff[j] + y) * BW[j] + xoff[j] + x
    src = np.where(inside, src, pos).reshape(-1)
    wv = np.tile(bw, N).astype(np.int32)
    hv = np.tile(bh, N).astype(np.int32)
    got = (order, torch.from_numpy(src).to(device),
           torch.from_numpy(wv).to(device), torch.from_numpy(hv).to(device))
    plan.fast[key] = got
    return got


def targeted(params) -> bool:
    """Whether the encode needs the PCRD allocation: several layers, a
    byte-rate target (a ratio above 1) or quality targets."""
    return params.num_layers != 1 or bool(
        params.rates and any(r > 1 for r in params.rates)) or bool(
        params.fixed_quality and params.quality)


def stage_encode_lanes(comps: list, hdr, params, t: int = 0):
    """Steps 1-2 for N frames of tile t (comps[ci]: (N, h, w) integer
    tensors on the device, the tile's samples): the cached plan and K4's
    (or K4r's) inputs
    (mneg, p, w, h, valid), one lane per code-block of every frame; p is
    each lane's cleanup plane, min(ht_planes, numbps - 1), computed on
    the device (P = 0 for Part-1 code-blocks, which the JAX package
    codes without it too).  Raises NotImplementedError outside the
    served scope."""
    if params.mct == MCTMode.AUTO_RD and len(comps) >= 3:
        raise _unsupported("AUTO_RD MCT encode of one tile", "mct=AUTO_RD: "
                           "api.compress_device_batch encodes with and "
                           "without the colour transform")
    plan = _plan_for(hdr, t)
    N = int(comps[0].shape[0])
    device = comps[0].device
    order, src, wv, hv = _lane_index(plan, N, device)
    band_mneg = _stage_bands(comps, plan, params.roi_rect, params.mesh)
    flat = torch.cat([band_mneg[k].reshape(-1) for k in order]
                     + [band_mneg[order[0]].new_zeros(1)])
    NL = N * len(plan.blocks)
    mneg = flat[src].reshape(NL, plan.H, plan.W)
    P = int(params.ht_planes or 0) if plan.coder == "ht" else 0
    if P:
        # the encoder clamp: each lane's cleanup plane min(P, numbps - 1)
        mx = (mneg >> 1).reshape(NL, -1).amax(1).to(torch.int64)
        pv = (_bitlen(mx) - 1).clamp(min=0, max=P).to(torch.int32)
    else:
        pv = torch.zeros(NL, dtype=torch.int32, device=device)
    return plan, (mneg, pv, wv, hv, torch.ones_like(pv))


def _per_lane(plan: EncPlan, name: str, vals, NL: int, device):
    """A per-block int32 column tiled over the NL lanes of the frames,
    on `device`, built once per (NL, device)."""
    key = (name, NL, str(device))
    got = plan.fast.get(key)
    if got is None:
        got = plan.fast[key] = torch.from_numpy(np.tile(
            np.asarray(vals, np.int32), NL // len(plan.blocks))).to(device)
    return got


def mq_lane_inputs(plan: EncPlan, lanes: tuple) -> tuple:
    """K5's inputs (mneg, orient, numbps, w, h) from the staged lanes:
    numbps is each lane's magnitude bit length, computed on the
    device."""
    mneg, _p, wv, hv, _valid = lanes
    NL = mneg.shape[0]
    ori = _per_lane(plan, "orient", [b[2] for b in plan.blocks], NL,
                    mneg.device)
    mx = (mneg >> 1).reshape(NL, -1).amax(1).to(torch.int64)
    return mneg, ori, _bitlen(mx).to(torch.int32), wv, hv


def mq_lane_styles(plan: EncPlan, lanes: tuple):
    """K5's style column: each block's code-block style, or None where
    every block is in the default style."""
    mneg = lanes[0]
    if not plan.lane_style.any():
        return None
    return _per_lane(plan, "style", plan.lane_style, mneg.shape[0],
                     mneg.device)


def _compact(buf: torch.Tensor, first: torch.Tensor, cnt: torch.Tensor,
             total: int) -> np.ndarray:
    """Download the used bytes of every segment at once: segment i is
    cnt[i] bytes from buf.reshape(-1)[first[i]:], gathered back to back
    on the device by a prefix sum over cnt."""
    if not total:
        return np.zeros(1, np.uint8)
    end = torch.cumsum(cnt, 0)
    jj = torch.arange(total, device=buf.device)
    seg = torch.searchsorted(end, jj, right=True)
    return buf.reshape(-1)[first[seg] + jj - (end - cnt)[seg]].cpu().numpy()


def _sq_sums(x: torch.Tensor) -> torch.Tensor:
    """Exact sums of squares along dim 1 of (NL, n) non-negative int64
    values below 2^32, n <= 4096, as three int64 rows (hh, hl, ll) with
    sum x^2 = hh * 2^32 + hl * 2^17 + ll: x split into 16-bit halves,
    every product below 2^32 and every row's sum below 2^44 (the JAX
    package's encode splits its magnitudes into 12- and 13-bit halves
    likewise, grok_tpu/pipeline/serve_enc.py `_build_encode_fn`)."""
    hi, lo = x >> 16, x & 0xFFFF
    return torch.stack([(hi * hi).sum(1), (hi * lo).sum(1),
                        (lo * lo).sum(1)])


def _exact_sums(rows: np.ndarray) -> np.ndarray:
    """(3k, NL) int64 rows of _sq_sums triples -> the k sums per lane,
    exact: int64 where each fits below 2^62, else Python ints (an object
    array)."""
    hh, hl, ll = rows[0::3], rows[1::3], rows[2::3]
    if not hh.size or hh.max() < (1 << 29):
        return (hh << 32) + (hl << 17) + ll
    hh, hl, ll = (a.astype(object) for a in (hh, hl, ll))
    return (hh << 32) + (hl << 17) + ll


def _distortions(s: np.ndarray) -> np.ndarray:
    """Per-pass distortions sum m^2 - 0.25 E_t (float64, (k - 1, NL))
    from _exact_sums' (k, NL) sums [sum m^2, E_1, ...]: in float64 as the
    JAX package rebuilds them where the sums are int64 (exact while
    they stay below 2^53, the reference's own scope), else the correctly
    rounded value of the exact rational (4 sum m^2 - E_t) / 4, so that
    the PCRD finish (t2/rate.py) never sees a wrapped or twice-rounded
    sum."""
    if s.dtype != object:
        d = s.astype(np.float64)
        return d[0][None] - 0.25 * d[1:]
    return ((4 * s[0][None] - s[1:]) / 4).astype(np.float64)


def _dist_stats(mneg, p, ns) -> torch.Tensor:
    """Exact per-lane distortion sums for the PCRD finish
    (grok_tpu/pipeline/serve_enc.py `_build_encode_fn`'s model), each as
    a _sq_sums triple of int64 rows: sum m^2; then without ns the count
    of significant samples (as (0, 0, count)), with ns the residuals E_x
    = sum (2m - 2 rec_x)^2 in half-sample units after the cleanup,
    SigProp and MagRef passes (rec of t1ht/scalar.py ht_encode_block,
    the SigProp reconstruction from the kernel's ns).  Exact at every
    precision the encode takes (magnitudes below 2^31, blocks of at most
    4096 samples); _exact_sums recombines them on the host."""
    NL = mneg.shape[0]
    mag = (mneg >> 1).reshape(NL, -1).to(torch.int64)
    rows = [_sq_sums(mag)]
    if ns is None:
        cnt = (mag > 0).sum(1)
        rows.append(torch.stack([torch.zeros_like(cnt),
                                 torch.zeros_like(cnt), cnt]))
        return torch.cat(rows)
    pl = p.to(torch.int64)[:, None]
    M = mag << 1
    vq = mag >> pl
    sig = vq > 0
    rec_p = torch.where(sig, (vq << (pl + 1)) + (1 << pl), 0)
    bp = (pl - 1).clamp(min=0)
    rec_sp = torch.where(ns.reshape(NL, -1) > 0, 3 << bp, rec_p)
    rec_mr = torch.where(sig, ((mag >> bp) << (bp + 1)) + (1 << bp),
                         rec_sp)
    for rec in (rec_p, rec_sp, rec_mr):
        rows.append(_sq_sums((M - rec).abs()))
    return torch.cat(rows)


def _encode_ht(plan: EncPlan, lanes: tuple, P: int, want_dist: bool) -> list:
    """K4 (P = 0) or K4r (P > 0) over the staged lanes, then the C wire
    assembly: one EncodedBlock per lane (frame-major), with three passes
    (cleanup, SigProp, MagRef) where the lane's cleanup plane is above 0.
    want_dist: compute each pass's exact distortion (the PCRD finish)."""
    mneg, pv = lanes[0], lanes[1]
    NL = mneg.shape[0]
    device = mneg.device
    mx = (mneg >> 1).reshape(NL, -1).amax(1)
    LMS, LMEL, LVLC = plan.caps
    refine = P > 0
    if refine:
        streams, bits, ns = ht_encode_lanes(*lanes, LMS, LMEL, LVLC,
                                            refine=True)
        caps = (LMS, LMEL, LVLC) + refine_caps(plan.W, plan.H)
    else:
        streams, bits = ht_encode_lanes(*lanes, LMS, LMEL, LVLC)
        ns, caps = None, (LMS, LMEL, LVLC)
    nst = len(caps)

    # one download of the stats: bit counts, magnitude, distortion sums
    rows = [bits.to(torch.int64), mx[None].to(torch.int64)]
    if want_dist:
        rows.append(_dist_stats(mneg, pv, ns))
    stats = torch.cat(rows).cpu().numpy()
    bits_h, mx_h = stats[:nst], stats[nst]
    if (bits_h < 0).any():
        raise RuntimeError("HT encode: a stream exceeded its capacity "
                           "(samples beyond the signalled precision?)")
    numbps = np.frexp(mx_h.astype(np.float64))[1]      # bit length
    coded = numbps > 0
    if want_dist:
        dist = _distortions(_exact_sums(stats[nst + 1:]))  # (1 or 3, NL)
    cnt = ((bits_h + 7) >> 3) * coded                  # (nst, NL) bytes
    cnt_l = cnt.T.reshape(-1)                          # lane-major
    offs = (np.cumsum(cnt_l) - cnt_l).reshape(NL, nst).T

    # stream segment s of lane l starts at its region of the lane's row
    seg = torch.arange(nst * NL, device=device)
    region = torch.tensor(np.cumsum((0,) + caps[:-1]), device=device)
    first = (seg // nst) * sum(caps) + region[seg % nst]
    cnt_d = (((bits.to(torch.int64) + 7) >> 3) * (mx > 0)).t().reshape(-1)
    body = _compact(streams, first, cnt_d, int(cnt_l.sum()))
    res = native.ht_assemble_batch(
        body, offs[0], bits_h[0], offs[1], bits_h[1], offs[2], bits_h[2],
        np.where(coded, 0, -1))
    if res is None:
        raise RuntimeError("HT wire assembly overflowed (cleanup suffix "
                           "over 4079 bytes)")
    wire, wlens = res
    wpos = np.cumsum(wlens) - wlens
    if refine:
        # raw stuffing of the SigProp and MagRef streams (empty where the
        # lane codes the cleanup only)
        rw = [native.ht_raw_batch(body, offs[s], bits_h[s] * coded)
              for s in (3, 4)]
        rpos = [np.cumsum(ln) - ln for _w, ln in rw]
    encs = []
    for lane in range(NL):
        if not coded[lane]:
            encs.append(EncodedBlock())
            continue
        seg_b = wire[wpos[lane]:wpos[lane] + wlens[lane]].tobytes()
        sl = len(seg_b)
        nb = int(numbps[lane])
        p_eff = min(P, nb - 1) if refine else 0
        # dist is read only by rate allocation, which the one-layer
        # untargeted finish does not run
        dl = dist[:, lane] if want_dist else np.zeros(3)
        if p_eff > 0:
            sp_b, mr_b = (w[pos[lane]:pos[lane] + ln[lane]].tobytes()
                          for (w, ln), pos in zip(rw, rpos))
            encs.append(EncodedBlock(
                data=seg_b + sp_b + mr_b, numbps=nb,
                passes=[PassInfo(rate=sl, dist=float(dl[0]), term=True),
                        PassInfo(rate=sl + len(sp_b), dist=float(dl[1]),
                                 term=True),
                        PassInfo(rate=sl + len(sp_b) + len(mr_b),
                                 dist=float(dl[2]), term=True)],
                seg_lens=[sl, len(sp_b), len(mr_b)], seg_passes=[1, 1, 1]))
            continue
        encs.append(EncodedBlock(
            data=seg_b, numbps=nb,
            passes=[PassInfo(rate=sl, dist=float(dl[0]), term=True)],
            seg_lens=[sl], seg_passes=[1]))
    return encs


def _mq_dist_stats(mneg, sigtype, numbps, R: int) -> torch.Tensor:
    """Exact per-pass distortion sums of Part-1 lanes for the PCRD finish
    (grok_tpu/pipeline/serve_enc.py `_mq_dstat`'s model): row 0 = sum m^2,
    then row 1 + r = E_r = sum (2m - 2 rec_r)^2 in half-sample units
    after pass row r of the watermark layout (row 0 the cleanup at the MSB
    plane; rows 3j-2, 3j-1, 3j SPP, MRP and CLN at plane index j), with
    rec the scalar coder's reconstruction: 0 until the sample's
    significance pass, then (m >> g << g) + 2^g / 2 at the plane g last
    coded (g = bp + 1 at the SPP of plane bp for samples not significant
    there yet).  K5's sigtype says whether a sample that becomes
    significant at its MSB plane does so in the SPP or the cleanup.  Rows
    past a lane's 3 numbps - 2 passes are not meaningful; the host reads
    only the lane's own.  Each row is a _sq_sums triple (exact at every
    precision the encode takes), one pass row summed at a time (no (R,
    NL, H*W) temporary)."""
    NL = mneg.shape[0]
    mg = (mneg >> 1).reshape(NL, -1).to(torch.int64)
    M = mg << 1
    msb = _bitlen(mg) - 1                            # -1 where m = 0
    st_spp = sigtype.reshape(NL, -1) == SIG_SPP
    nb = numbps.to(torch.int64)[:, None]
    rows = [_sq_sums(mg)]
    for r in range(R):
        j = 0 if r == 0 else (r + 2) // 3
        pt = 2 if r == 0 else r - (3 * j - 2)        # 0 SPP, 1 MRP, 2 CLN
        bp = (nb - 1 - j).clamp(min=0)
        g = bp
        if pt == 2:
            signow = (mg > 0) & (msb >= bp)
        else:
            signow = (msb > bp) | ((msb == bp) & st_spp)
            if pt == 0:
                g = torch.where(msb == bp, bp, bp + 1)
        rec2 = torch.where(signow, ((mg >> g) << (g + 1)) + (1 << g), 0)
        rows.append(_sq_sums((M - rec2).abs()))
    return torch.cat(rows)


def _k5(plan: EncPlan, ins: tuple, L: int, R: int, sty, mesh) -> tuple:
    """K5 over the lanes ins (mneg, orient, numbps, w, h) in the styles
    sty (None: the default style).  With a mesh, the default-style lanes
    are coded by one launch per shard (ops/t1_encode.py
    t1_encode_lanes_sharded) and the styled lanes by one launch on the
    first device, as the JAX package's mesh encode shards only the
    default-style blocks; the outputs in lane order."""
    if mesh is None:
        return t1_encode_lanes(*ins, L, R, sty)
    if sty is None:
        return t1_encode_lanes_sharded(*ins, L, R, mesh=mesh)
    default = np.tile(plan.lane_style == 0, ins[0].shape[0]
                      // len(plan.blocks))
    if not default.any():
        return t1_encode_lanes(*ins, L, R, sty)
    dev = ins[0].device
    dk = torch.from_numpy(np.nonzero(default)[0]).to(dev)
    sk = torch.from_numpy(np.nonzero(~default)[0]).to(dev)
    got = t1_encode_lanes_sharded(*(t.index_select(0, dk) for t in ins), L,
                                  R, mesh=mesh)
    res = tuple(t.new_zeros((default.size,) + t.shape[1:]) for t in got)
    for r, g in zip(res, got):
        r[dk] = g
    if sk.numel():
        for r, g in zip(res, t1_encode_lanes(
                *(t.index_select(0, sk) for t in ins), L, R,
                sty.index_select(0, sk))):
            r[sk] = g
    return res


def _encode_mq(plan: EncPlan, lanes: tuple, want_dist: bool = False,
               styled: bool = True, mesh=None) -> list:
    """K5 over the staged lanes: one EncodedBlock per lane (frame-major),
    its segments, rates and termination flags as the JAX package's C
    coder logs them (ops/t1_encode.py pass_records), in the blocks'
    code-block styles (styled False: the default style, an HT-mixed
    set's Part-1 coding).  want_dist: each pass's exact distortion too
    (the PCRD finish), downloaded with the stats.  mesh: K5 sharded over
    it for the default-style lanes (_k5)."""
    mneg, ori, nb, wv, hv = mq_lane_inputs(plan, lanes)
    sty = mq_lane_styles(plan, lanes) if styled else None
    NL = mneg.shape[0]
    L, R = plan.mq_caps
    out, lens, rates, sigtype = _k5(plan, (mneg, ori, nb, wv, hv), L, R,
                                    sty, mesh)

    # one download of the stats: length, numbps, rate rows and the
    # distortion sums
    cols = [lens[:, None], nb[:, None], rates]
    if want_dist:
        cols.append(_mq_dist_stats(mneg, sigtype, nb, R).t())
    stats = torch.cat([c.to(torch.int64) for c in cols], 1).cpu().numpy()
    lens_h = stats[:, 0]
    nb_h = stats[:, 1]
    if want_dist:
        dist = _distortions(_exact_sums(stats[:, 2 + R:].T)).T  # (NL, R)
    if (lens_h < 0).any():
        raise RuntimeError("Part-1 encode: a codeword exceeded its "
                           "capacity (samples beyond the signalled "
                           "precision?)")
    over = nb_h > np.tile(plan.lane_mb, NL // len(plan.blocks))
    if over.any():
        raise ValueError(f"block overflows Mb: {int(nb_h[over].max())} "
                         f"magnitude planes; raise guard bits")
    offs = np.cumsum(lens_h) - lens_h
    # a lane's codeword follows the carry sentinel at byte 0 of its row
    first = torch.arange(NL, device=out.device) * L + 1
    body = _compact(out, first, lens.to(torch.int64), int(lens_h.sum()))
    styles = np.tile(plan.lane_style, NL // len(plan.blocks)) if styled \
        else np.zeros(NL, np.int32)
    encs = []
    for lane in range(NL):
        n = int(nb_h[lane])
        if n == 0:
            encs.append(EncodedBlock())
            continue
        ln = int(lens_h[lane])
        rr, terms, seg_lens, seg_passes = pass_records(
            stats[lane, 2:2 + R], n, ln, int(styles[lane]))
        # dist is read only by rate allocation, which the one-layer
        # untargeted finish does not run
        encs.append(EncodedBlock(
            data=body[offs[lane]:offs[lane] + ln].tobytes(), numbps=n,
            passes=[PassInfo(rate=v, dist=float(dist[lane, t])
                             if want_dist else 0.0, term=terms[t])
                    for t, v in enumerate(rr)],
            seg_lens=seg_lens, seg_passes=seg_passes))
    return encs


def _canon(plan: EncPlan) -> list:
    """Each block's canonical index (pipeline/tile.py canon_block_
    indices), in plan block order."""
    got = plan.fast.get("canon")
    if got is None:
        canon = canon_block_indices(plan.geo)
        got = plan.fast["canon"] = [canon[(c, r, band_i, p, cblk_i)]
                                    for (c, r, p, band_i, cblk_i)
                                    in plan.lane_block]
    return got


def _layer_targets(hdr, geo, params) -> list:
    """Per-tile cumulative layer byte budgets (None = every remaining
    pass) by the same helpers as the JAX package's encoders (t2/rate.py),
    so the PCRD targets, and the streams, agree."""
    if not (params.rates and any(r > 1 for r in params.rates)):
        return [None] * params.num_layers
    return layer_targets_for_tile(layer_budget_consts(hdr, params),
                                  geo.rect, params)


def try_encode_serving_batch(comps: list, hdr, params, t: int = 0,
                             targets: list | None = None) -> list:
    """Encode N frames of tile t: comps[ci] is an (N, h, w) integer
    tensor on the device, the tile's samples.  targets: the tile's
    cumulative layer byte budgets (None: the whole-stream rule of the
    JAX package's encoders; codec.py Compressor passes its own).
    Returns N TileEncodeResults; raises NotImplementedError outside the
    served scope."""
    plan, lanes = stage_encode_lanes(comps, hdr, params, t)
    B = len(plan.blocks)
    N = lanes[0].shape[0] // B
    mixed = bool(params.ht_mixed) and plan.coder == "ht"
    want_dist = targeted(params)
    if targets is None:
        targets = _layer_targets(hdr, plan.geo, params)
    mesh = params.mesh
    finish = dict(quality_targets=quality_targets_for_tile(hdr, plan.geo,
                                                           params),
                  pocs=hdr.pocs, split_headers=bool(params.write_ppm),
                  device=lanes[0].device)
    if plan.coder == "mq":
        encs = _encode_mq(plan, lanes, want_dist, mesh=mesh)
    else:
        encs = _encode_ht(plan, lanes, int(params.ht_planes or 0),
                          want_dist)
    # each job carries its block's style, orient and size, which turn on
    # the finish's minimal-flush truncation refinement of targeted
    # single-segment Part-1 blocks (as grok_tpu/pipeline/tile.py
    # encode_tile's jobs do)
    jobs = [dict(key=kb, mb=int(mb), weight=float(w), style=int(st),
                 orient=int(b[2]), w=int(b[6]), h=int(b[5]))
            for kb, mb, w, st, b in zip(plan.lane_block, plan.lane_mb,
                                        plan.lane_w, plan.lane_style,
                                        plan.blocks)]
    if not mixed:
        return [finish_tile_encode(plan.geo, jobs, encs[fi * B:(fi + 1) * B],
                                   targets, **finish) for fi in range(N)]
    # HT-mixed: both coders on the same lanes, the Part-1 coding in the
    # default style; the smaller codeword wins per block, HT on ties, and
    # a Part-1 winner's job gets style 0 (grok_tpu/pipeline/tile.py
    # encode_tile), so the refinement touches exactly those blocks
    encs_mq = _encode_mq(plan, lanes, want_dist, styled=False, mesh=mesh)
    canon = _canon(plan)
    nbytes = (len(canon) + 7) // 8
    results = []
    for fi in range(N):
        frame = encs[fi * B:(fi + 1) * B]
        fjobs = []
        bitmap = bytearray(nbytes)
        for bi, ci in enumerate(canon):
            mq_e = encs_mq[fi * B + bi]
            if len(frame[bi].data) <= len(mq_e.data):
                bitmap[ci >> 3] |= 1 << (ci & 7)          # an HT block
                fjobs.append(jobs[bi])
            else:
                frame[bi] = mq_e
                fjobs.append(dict(jobs[bi], style=0))
        res = finish_tile_encode(plan.geo, fjobs, frame, targets,
                                 seg_style_mask=~CBLK_HT, **finish)
        res.com = j2k.write_com(b"GRKTPU_HTMIX=" + bytes(bitmap),
                                binary=True)
        results.append(res)
    return results
