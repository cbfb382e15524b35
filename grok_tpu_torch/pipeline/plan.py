"""Cached serving-decode plans: everything derivable from a main header.

The port's copy of the plan half of grok_tpu/pipeline/serve.py
(`ServePlan`, `_build_plan`, `_plan_for`, `_th_ovr_key`), with the fields
the port's device decodes read: the geometry, the C Tier-2 parser's
descriptor arrays (and the contexts and packet order the Python parse,
t2/parse.py, walks: the tile's POC, else the main header's), per-block
metadata in the parser's global block order, with each block's
code-block style, its rect in band coordinates for the window mask
(`window_mask`) and its place in the JAX package's decode order (the
order a strict decode's exception follows), and per component the ROI
Maxshift (RGN, main and tile) and a custom MCT's inverse.  Plans are
cached per (main header, tile, reduce, mixed, tile overrides: COD, COC,
QCD, QCC, RGN, POC).  A plan
holds no table state; the decode programs kept on it
(pipeline/serve.py) are keyed on t1ht.tables.VERSION.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from grok_tpu_torch import native
from grok_tpu_torch.core.geometry import BAND_LL, Rect
from grok_tpu_torch.core.params import CBLK_HT
from grok_tpu_torch.pipeline.tile import (TileGeometry, band_window,
                                          canon_block_indices)
from grok_tpu_torch.t2.progression import iter_packets
from grok_tpu_torch.transform.mct_np import custom_mct_inverse
from grok_tpu_torch.util.trace import count

_PLANS: dict = {}
_PLANS_MAX = 16


@dataclass
class ServePlan:
    geo: object
    prep: tuple                       # C t2_parse descriptor arrays
    sop: bool
    eph: bool
    n_blks: int
    # per-global-block-index metadata (aligned with the C parser)
    mb: np.ndarray                    # Mb (numbps = mb - zb)
    bucket: np.ndarray                # bucket id per block
    bucket_dims: list                 # bucket id -> (Wpad, Hpad)
    sig_tail: list                    # per block: (ci, r, orient, yoff,
    #                                   xoff, bh, bw, delta, irrev)
    coder: str                        # "ht", "mq", "mixed" or "split"
    #                                   (components mixing HT and Part-1)
    rok: np.ndarray                   # block contributes at this reduce
    comps_sig: tuple
    mct_mode: int
    style: np.ndarray                 # code-block style per block (COD)
    blk_rect: np.ndarray              # (n, 4) absolute band-coord rects
    blk_band: np.ndarray              # (n,) index into band_info
    band_info: list                   # (c, r, orient, nl) per band
    ht_p_ext: int = 0                 # ht_planes COM extension (derive_p)
    canon_idx: np.ndarray | None = None   # mixed: each block's index in
    #                                       the HT-mixed bitmap
    job_idx: np.ndarray | None = None   # each block's index in the
    #                                     component, resolution, band,
    #                                     precinct, code-block order in
    #                                     which the JAX package's
    #                                     decode_tile decodes blocks
    ctx_keys: list = field(default_factory=list)   # (c, r, p) per context,
    #                                       in the parser's order
    seg_mask: int = -1                # T2 segmentation style mask
    roi: tuple = ()                   # per component: the ROI Maxshift
    custom_inv: np.ndarray | None = None   # inverse of a custom MCT
    fast: dict = field(default_factory=dict)   # device programs, staging


def _pow2_at_least(v: int, lo: int = 4, hi: int = 1024) -> int:
    p = lo
    while p < v and p < hi:
        p *= 2
    return p


def _build_plan(hdr, t: int, th, reduce: int) -> ServePlan:
    geo = TileGeometry.build(hdr, t, th)
    if th is not None and th.ht_mixed_bitmap() is not None:
        # HT MIXED sets: per-block HT/MQ routing by the per-stream COM
        # bitmap; T2 parses with the Part-1 segmentation rule of the
        # style without its HT bit
        coder = "mixed"
    elif all(cs.cblk_style & CBLK_HT for cs in geo.styles):
        # HT code-blocks, with or without Part-1 mode-switch bits beside
        # the HT bit: an HT pass ends its segment whatever the other bits
        # say (t2/packet.py max_seg_passes), and the HT block decoder
        # reads none of them, as the JAX package's decoders do not
        coder = "ht"
    elif not any(cs.cblk_style & CBLK_HT for cs in geo.styles):
        # Part-1 blocks of any mode switches: the T2 contexts segment
        # each block by its style; the serving decode takes style 0
        # only, the general route every style (K3's segment table)
        coder = "mq"
    else:
        # components mixing HT and Part-1 code-blocks (a COC): each block
        # by its component's style, on the general route
        coder = "split"

    seg_mask = ~CBLK_HT if coder == "mixed" else -1
    ctxs = geo.make_contexts(seg_mask)
    ctx_keys = list(ctxs.keys())
    ctx_idx = {k: i for i, k in enumerate(ctx_keys)}
    ctxs_flat = []
    for k in ctx_keys:
        ctx = ctxs[k]
        bands = []
        for (_o, bp) in ctx.bands:
            bands.append((bp.cblk_grid_w, bp.cblk_grid_h,
                          [g.idx_in_prec for g in bp.cblks]))
        ctxs_flat.append((ctx.style, bands))
    packet_list = list(iter_packets(geo.tcgs, geo.subsampling,
                                    geo.cod.num_layers, geo.cod.prog_order,
                                    geo.rect.x0, geo.rect.y0,
                                    (th.pocs if th is not None else None)
                                    or hdr.pocs or None))
    packets = [(ctx_idx[(pc.comp, pc.res, pc.prec)], pc.layer)
               for pc in packet_list]
    prep = native.t2_prepare(ctxs_flat, packets)

    # per-block metadata in the C parser's global block order:
    # ctx (c, r, p) -> band -> cblk
    mb_l, bucket_l, tails, rok_l, canon_l = [], [], [], [], []
    style_l, blk_rect_l, blk_band_l = [], [], []
    band_info: list = []
    band_ids: dict = {}
    bucket_ids: dict = {}
    bucket_dims: list = []
    # the canonical order is the JAX package's decode order too
    canon = canon_block_indices(geo)
    for (c, r, p) in ctx_keys:
        quant = geo.quants[c]
        irrev = bool(geo.styles[c].irreversible)
        rg = geo.tcgs[c].resolutions[r]
        numres_c = geo.styles[c].num_resolutions
        r_lim_c = max(numres_c - reduce, 1) if reduce else numres_c
        for band_i, bg in enumerate(rg.bands):
            bkey = (c, r, bg.orient, numres_c - 1)
            bid_w = band_ids.setdefault(bkey, len(band_ids))
            if bid_w == len(band_info):
                band_info.append(bkey)
            mb = quant.mb(r, bg.orient)
            delta = float(quant.delta(r, bg.orient))
            for cblk_i, cb in enumerate(bg.precincts[p].cblks):
                canon_l.append(canon[(c, r, band_i, p, cblk_i)])
                mb_l.append(mb)
                rok_l.append(r < r_lim_c)
                style_l.append(geo.styles[c].cblk_style)
                blk_rect_l.append((cb.rect.x0, cb.rect.y0, cb.rect.x1,
                                   cb.rect.y1))
                blk_band_l.append(bid_w)
                # a bucket no larger than the nominal power-of-two block
                # (an edge block is smaller): at most 4096 samples
                key = (_pow2_at_least(cb.rect.w), _pow2_at_least(cb.rect.h))
                bid = bucket_ids.setdefault(key, len(bucket_ids))
                if bid == len(bucket_dims):
                    bucket_dims.append(key)
                bucket_l.append(bid)
                tails.append((c, r, bg.orient if r > 0 else BAND_LL,
                              cb.rect.y0 - bg.rect.y0,
                              cb.rect.x0 - bg.rect.x0,
                              cb.rect.h, cb.rect.w, delta, irrev))

    comps_sig = []
    for c, tcg in enumerate(geo.tcgs):
        cs = geo.styles[c]
        numres = cs.num_resolutions
        r_lim = max(numres - reduce, 1) if reduce else numres
        bands = []
        for rg in tcg.resolutions:
            if rg.r >= r_lim:
                continue
            for bg in rg.bands:
                bands.append((rg.r, bg.orient,
                              (bg.rect.x0, bg.rect.y0, bg.rect.x1,
                               bg.rect.y1),
                              float(geo.quants[c].delta(rg.r, bg.orient))))
        rect = geo.comp_rects[c]
        # translation-normalized signature: shift the component rect by
        # a multiple of 2^levels (every DWT parity preserved) and keep
        # only band SIZES (positions never enter the program), so
        # same-shaped tiles of a grid share one program
        nl = numres - 1
        txc = (rect.x0 >> nl) << nl
        tyc = (rect.y0 >> nl) << nl
        bands = [(r, o, (0, 0, bx1 - bx0, by1 - by0), d)
                 for (r, o, (bx0, by0, bx1, by1), d) in bands]
        comps_sig.append((
            (rect.x0 - txc, rect.y0 - tyc,
             rect.x1 - txc, rect.y1 - tyc), numres, r_lim,
            hdr.comps[c].prec, hdr.comps[c].sgnd,
            bool(cs.irreversible), tuple(bands)))
    # 1 RCT, 2 ICT, 3 a custom matrix (which takes precedence, as in
    # the JAX package's decode)
    mct_mode, custom_inv = 0, None
    if geo.custom_mct is not None:
        mct_mode = 3
        custom_inv = custom_mct_inverse(geo.custom_mct)
    elif geo.cod.mct and len(comps_sig) >= 3:
        mct_mode = 2 if geo.styles[0].irreversible else 1

    return ServePlan(
        geo=geo, prep=prep, sop=geo.cod.sop, eph=geo.cod.eph,
        n_blks=len(mb_l), mb=np.asarray(mb_l, np.int32),
        bucket=np.asarray(bucket_l, np.int32), bucket_dims=bucket_dims,
        sig_tail=tails, coder=coder, rok=np.asarray(rok_l, bool),
        comps_sig=tuple(comps_sig), mct_mode=mct_mode,
        style=np.asarray(style_l, np.int32),
        blk_rect=np.asarray(blk_rect_l, np.int64).reshape(-1, 4),
        blk_band=np.asarray(blk_band_l, np.int64), band_info=band_info,
        ht_p_ext=hdr.ht_planes_ext(),
        canon_idx=np.asarray(canon_l, np.int64) if coder == "mixed"
        else None, job_idx=np.asarray(canon_l, np.int64),
        ctx_keys=ctx_keys, seg_mask=seg_mask,
        roi=tuple(int(geo.rgn.get(c, 0)) for c in range(len(geo.tcgs))),
        custom_inv=custom_inv)


def _th_ovr_key(th) -> tuple:
    """Canonical key for the tile-part overrides a plan was built from
    (COD, COC, QCD, QCC, RGN, POC; dataclass reprs are deterministic):
    the overrides change geometry, quantization, the ROI shifts or the
    packet order, so they join the plan cache key and must match across
    a batch."""
    if th is None:
        return (None,) * 6
    return tuple(repr(v) if v else None
                 for v in (th.cod, th.coc, th.qcd, th.qcc, th.rgn, th.pocs))


def _plan_for(cs: bytes, hdr, t: int, th, reduce: int = 0) -> ServePlan:
    # the coder choice depends on the TILE-PART COM bitmap (mixed vs
    # ht), which varies per stream under one main header — fold its
    # presence into the key; per-tile COD/QCD overrides key the same way
    mixed = th is not None and th.ht_mixed_bitmap() is not None
    key = (bytes(cs[:hdr.main_header_end]), t, reduce, mixed,
           _th_ovr_key(th))
    plan = _PLANS.get(key)
    if plan is None:
        count("decode.plan_builds")
        plan = _build_plan(hdr, t, th, reduce)
        if len(_PLANS) >= _PLANS_MAX:
            _PLANS.pop(next(iter(_PLANS)))   # evict the oldest entry
        _PLANS[key] = plan
    return plan


def window_mask(plan: ServePlan, window) -> np.ndarray:
    """Per block: whether its rect meets the synthesis-dilated decode
    window in its band (pipeline/tile.py band_window), as
    grok_tpu/pipeline/serve.py masks a served window and
    grok_tpu/pipeline/tile.py selects the general route's blocks (the
    same blocks: a block's rect lies inside its band).  Blocks outside
    decode as zeros, which leaves every pixel inside the window
    exact."""
    geo = plan.geo
    wins = np.empty((len(plan.band_info), 4), np.int64)
    subs = {}
    for bi, (c, r, orient, nl) in enumerate(plan.band_info):
        if c not in subs:
            dx, dy = geo.subsampling[c]
            subs[c] = Rect(*window).intersect(geo.rect).ceil_scale(dx, dy)
        w = band_window(subs[c], nl, r, orient)
        wins[bi] = (w.x0, w.y0, w.x1, w.y1)
    wb = wins[plan.blk_band]
    br = plan.blk_rect
    return ((np.maximum(br[:, 0], wb[:, 0]) < np.minimum(br[:, 2], wb[:, 2]))
            & (np.maximum(br[:, 1], wb[:, 1])
               < np.minimum(br[:, 3], wb[:, 3])))
