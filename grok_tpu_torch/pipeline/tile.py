"""Tile geometry, the Tier-2 finish of an encode, and the general decode.

The port's copy of grok_tpu/pipeline/tile.py, for what the port serves:
`TileGeometry` (geometry + coding state shared by the decode and encode
plans), `canon_block_indices` (the HT-mixed bitmap's block order),
`band_window` (a decode window in band coordinates),
`TileEncodeResult`, `finish_tile_encode` (the PCRD rate allocation over
several layers, byte or quality targets, t2/rate.py, the Part-1
minimal-flush truncation refinement by trial decodes with kernel K3, and
the packet emission by the C Tier-2 coder, native.t2_emit, or for
POC-ordered packets and PPM's split headers by the Python packet
encoder, t2/packet.py), and `decode_tile`, the
general device decode route for the streams the serving decode declines
(refined HT blocks, Part-1 mode switches, layered HT-mixed streams,
components mixing HT and Part-1 blocks, packed packet headers, a custom
MCT, packets cut short or corrupt, strict decodes of HT blocks), with or
without a device mesh, with kernels K1, K2 and K3, whole or in a window,
for code-blocks of any legal size.

Reference parity: [grok: src/lib/core/tile/TileProcessor.cpp ::
compressTile] — behavior normative per ISO 15444-1.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from grok_tpu_torch import native
from grok_tpu_torch.codestream.j2k import (CodingStyle, CodingStyleComp,
                                           MainHeader, QuantStyle, TileHeader)
from grok_tpu_torch.core.geometry import (BAND_LL, Rect, TileCompGeom,
                                          build_tilecomp_geometry,
                                          map_interval_to_band)
from grok_tpu_torch.core.quant import Quantizer
from grok_tpu_torch.ops.ht_decode import _quant_len
from grok_tpu_torch.t2.packet import PrecinctCtx
from grok_tpu_torch.t2.progression import iter_packets
from grok_tpu_torch.t2.rate import (allocate_layers,
                                    allocate_layers_quality, convex_hull)

SOP_MARKER = b"\xff\x91"
EPH_MARKER = b"\xff\x92"


def quantizer_from_style(q: QuantStyle, cs: CodingStyleComp,
                         prec: int) -> Quantizer:
    return Quantizer(style=q.style, guard_bits=q.guard_bits, steps=q.steps,
                     num_resolutions=cs.num_resolutions, prec=prec)


@dataclass
class TileGeometry:
    """Geometry + coding state shared by encode and decode for one tile."""

    t: int
    rect: Rect
    comp_rects: list[Rect]
    tcgs: list[TileCompGeom]
    styles: list[CodingStyleComp]
    quants: list[Quantizer]
    cod: CodingStyle
    subsampling: list[tuple[int, int]]
    rgn: dict = field(default_factory=dict)      # comp -> ROI Maxshift
    custom_mct: object = None                    # Part-2 matrix or None

    @staticmethod
    def build(hdr: MainHeader, t: int,
              tile_hdr: TileHeader | None = None) -> "TileGeometry":
        th = tile_hdr or TileHeader()
        rect = hdr.siz.tile_rect(t)
        cod = th.cod or hdr.cod
        rgn = dict(hdr.rgn)
        rgn.update(th.rgn)
        comp_rects, tcgs, styles, quants, subs = [], [], [], [], []
        for c, ci in enumerate(hdr.comps):
            cs = hdr.style_for(c, th.coc, th.cod)
            q = hdr.quant_for(c, th.qcc, th.qcd)
            cr = rect.ceil_scale(ci.dx, ci.dy)
            tcg = build_tilecomp_geometry(
                cr, cs.num_resolutions, cs.cblk_w_exp, cs.cblk_h_exp,
                cs.prec_exps)
            tcg.comp = c
            comp_rects.append(cr)
            tcgs.append(tcg)
            styles.append(cs)
            # RCT chroma expansion is absorbed by the guard bits (upstream
            # convention): Rb stays prec + gain.
            quants.append(quantizer_from_style(q, cs, ci.prec))
            subs.append((ci.dx, ci.dy))
        return TileGeometry(t=t, rect=rect, comp_rects=comp_rects, tcgs=tcgs,
                            styles=styles, quants=quants, cod=cod,
                            subsampling=subs, rgn=rgn,
                            custom_mct=hdr.custom_mct)

    def make_contexts(self, seg_style_mask: int = -1) \
            -> dict[tuple[int, int, int], PrecinctCtx]:
        """seg_style_mask: AND-mask on the T2 segmentation style (HT
        MIXED streams parse with ~CBLK_HT)."""
        ctxs: dict[tuple[int, int, int], PrecinctCtx] = {}
        for c, tcg in enumerate(self.tcgs):
            style = self.styles[c].cblk_style & seg_style_mask
            for rg in tcg.resolutions:
                for p in range(rg.num_precincts):
                    bands = [(bg.orient, bg.precincts[p]) for bg in rg.bands]
                    ctxs[(c, rg.r, p)] = PrecinctCtx(bands, style)
        return ctxs


def canon_block_indices(geo: TileGeometry) -> dict[tuple, int]:
    """Canonical flat index of every code-block in the tile: nested
    (component, resolution, band, precinct, cblk) enumeration over the
    full geometry, shared by the HT-mixed bitmap writer and reader.
    Key: (c, r, band_i, p, cblk_i)."""
    idx: dict[tuple, int] = {}
    n = 0
    for c, tcg in enumerate(geo.tcgs):
        for rg in tcg.resolutions:
            for band_i, bg in enumerate(rg.bands):
                for p in range(rg.num_precincts):
                    for cblk_i in range(len(bg.precincts[p].cblks)):
                        idx[(c, rg.r, band_i, p, cblk_i)] = n
                        n += 1
    return idx


def band_window(sub: Rect, nl: int, r: int, orient: int,
                dilate: int = 4) -> Rect:
    """Map a tile-component-coordinate rect into band coordinates, dilated
    by the synthesis filter support (region-decode block selection; a
    conservative (larger) window is always safe)."""
    s = 1 << (nl - r)
    rr = Rect(sub.x0 // s - dilate, sub.y0 // s - dilate,
              -(-sub.x1 // s) + dilate, -(-sub.y1 // s) + dilate)
    if r == 0 or orient == BAND_LL:
        return rr
    xob = 1 if orient in (1, 3) else 0
    yob = 1 if orient in (2, 3) else 0
    x0, x1 = map_interval_to_band(rr.x0, rr.x1, xob)
    y0, y1 = map_interval_to_band(rr.y0, rr.y1, yob)
    return Rect(x0, y0, x1, y1)


@dataclass
class TileEncodeResult:
    packets: list[bytes]             # in progression order
    packet_lens: list[int]
    body: bytes                      # concatenated packets
    com: bytes = b""                 # tile-part COM (the HT-mixed bitmap)
    headers: bytes = b""             # packed packet headers (PPM only)
    refined: int = 0                 # blocks the minimal-flush refinement
    #                                  shrank
    reclaimed: int = 0               # bytes it took off their truncations
    trial_lanes: int = 0             # its trial decodes


def trial_decode_lanes(ejobs: list[dict], encs: list, layer_cum: list,
                       device) -> tuple:
    """The minimal-flush refinement's candidates and their K3 lanes.

    A candidate is a single-segment, non-HT block (its job carries style,
    orient, w and h) whose final truncation p ends on a pass that is not
    terminated.  Its prefix lengths hi = min(rate_p, len(data)) and then
    hi - 1 down to lo = max(rate_(p-1) or 2, hi - 8) each become a lane
    that decodes p passes of one segment of that length, every lane of a
    block reading the block's bytes at the same start of one body.
    Returns (cands: (entry index, p, [lengths]) per block, the
    t1_decode_lanes arguments on `device` (None without candidates), W,
    H)."""
    import torch

    from grok_tpu_torch.core.params import CBLK_HT

    cands, datas, rows = [], [], []
    pos = 0
    for i, (j, enc) in enumerate(zip(ejobs, encs)):
        p = layer_cum[i][-1] if layer_cum[i] else 0
        if (p <= 0 or p >= len(enc.passes) or len(enc.seg_lens) != 1
                or enc.passes[p - 1].term
                or "style" not in j or "orient" not in j
                or j["style"] & CBLK_HT):
            continue
        hi = min(enc.passes[p - 1].rate, len(enc.data))
        lo = max(enc.passes[p - 2].rate if p >= 2 else 2, hi - 8)
        lens = [hi] + list(range(hi - 1, lo - 1, -1))
        cands.append((i, p, lens))
        for r in lens:
            rows.append((pos, r, p, enc.numbps, j["orient"], j["w"], j["h"],
                         j["style"]))
        datas.append(enc.data)
        pos += len(enc.data)
    if not cands:
        return cands, None, 0, 0
    a = np.asarray(rows, np.int32)
    NL = a.shape[0]
    ptbl = np.zeros((NL, 1, 3), np.int32)
    ptbl[:, 0, 1] = a[:, 1]                      # one segment of length r
    body = np.frombuffer(b"".join(datas) + b"\0", np.uint8).copy()

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    args = (dev(body), dev(a[:, 0]), dev(a[:, 2]), dev(a[:, 3]),
            dev(a[:, 4]), dev(a[:, 5]), dev(a[:, 6]), dev(a[:, 7]),
            dev(ptbl))
    return cands, args, int(a[:, 5].max()), int(a[:, 6].max())


def _refine_truncations(ejobs: list[dict], encs: list, layer_cum: list,
                        device) -> tuple:
    """The Part-1 minimal-flush refinement of grok_tpu/pipeline/tile.py
    `finish_tile_encode`: a non-terminated pass's rate carries the MQ
    flush's pessimism (+5 bytes), so each candidate block's final
    truncation shrinks to the smallest prefix r such that every length
    from r to hi - 1 decodes the same signed samples as hi (the JAX
    package's downward scan with its early break).  Every candidate
    prefix of the tile is decoded in one t1_decode_lanes call on `device`
    (K3 on a CUDA device, the plain version on the CPU).  The shrunk
    rates are written into the blocks' PassInfo.  Returns ([(entry index,
    pass index, new rate)], lanes decoded)."""
    import torch

    from grok_tpu_torch.ops import t1_decode

    cands, args, W, H = trial_decode_lanes(ejobs, encs, layer_cum, device)
    if not cands:
        return [], 0
    out = t1_decode.t1_decode_lanes(*args, W, H)
    first = np.cumsum([0] + [len(c[2]) for c in cands])
    ref = torch.from_numpy(np.repeat(first[:-1], [len(c[2]) for c in cands])
                           ).to(out.device)
    same = (out == out[ref]).reshape(out.shape[0], -1).all(1).cpu().numpy()
    changes = []
    for (i, p, lens), f in zip(cands, first):
        best = lens[0]
        for k in range(1, len(lens)):      # the tail is contiguous
            if not same[f + k]:
                break
            best = lens[k]
        pi = encs[i].passes[p - 1]
        if best < pi.rate:
            changes.append((i, p - 1, best))
            pi.rate = best
    return changes, int(first[-1])


def finish_tile_encode(geo: TileGeometry, ejobs: list[dict], encs: list,
                       layer_targets: list | None = None,
                       seg_style_mask: int = -1, *, device,
                       quality_targets: list | None = None,
                       pocs: list | None = None,
                       split_headers: bool = False) -> TileEncodeResult:
    """Rate allocation + Tier-2 emission over already-coded blocks.

    ejobs need key (c, r, p, band_i, cblk_i), mb and, for the PCRD
    allocation, weight (the band's distortion weight) per block; encs
    are the EncodedBlocks.  layer_targets: cumulative byte budget per
    layer, None for "every remaining pass"; quality_targets: each
    layer's allowed total squared error (t2/rate.py
    quality_targets_for_tile), which takes the place of the byte targets.
    One layer with no target ships every pass of every block and runs no
    allocation; otherwise the convex hulls and the layer allocation
    (t2/rate.py: by byte targets, every candidate allocation sized by the
    emitter, or by quality targets) pick each block's passes per layer,
    and the Part-1 minimal-flush refinement shrinks the final truncation
    of blocks whose jobs carry style, orient, w and h
    (_refine_truncations: trial decodes on `device`, the serving
    encode's; a required keyword, so that no caller's refinement runs on
    another device than its encode), as grok_tpu/pipeline/tile.py
    `finish_tile_encode` does.
    pocs: the progression-order changes the packets follow; such packets
    are emitted by the Python packet encoder (t2/packet.py
    encode_packet), as the JAX package emits them, the others by the C
    Tier-2 coder.  split_headers (PPM): the packet headers are returned
    apart (TileEncodeResult.headers, in packet order) and the packets
    are their bodies alone.
    seg_style_mask: AND-mask on the Tier-2 segmentation style (HT-mixed
    sets emit with ~CBLK_HT); the emitter chunks each block's codeword by
    its passes' termination flags."""
    num_layers = geo.cod.num_layers
    trivial = quality_targets is None and num_layers == 1 and (
        not layer_targets or all(t is None for t in layer_targets))
    ctxs = geo.make_contexts(seg_style_mask)
    hulls, rate_tables, entry_keys = [], [], []
    for j, enc in zip(ejobs, encs):
        c, r, p, band_i, cblk_i = j["key"]
        mb = j["mb"]
        if enc.numbps > mb:
            raise ValueError(
                f"block overflows Mb: {enc.numbps} > {mb} "
                f"(band r={r}); raise guard bits")
        ctxs[(c, r, p)].set_block(band_i, cblk_i, enc, mb)
        if not trivial:
            rates = np.array([pi.rate for pi in enc.passes],
                             dtype=np.float64)
            dists = np.array([pi.dist * j["weight"] for pi in enc.passes],
                             dtype=np.float64)
            hulls.append(convex_hull(rates, dists))
            rate_tables.append(rates)
        entry_keys.append(j["key"])
    if not entry_keys:
        return TileEncodeResult(packets=[], packet_lens=[], body=b"")
    keys = list(ctxs.keys())
    kidx = {k: i for i, k in enumerate(keys)}
    pkt_cache: dict = {}

    def order(nl: int) -> list:
        return list(iter_packets(geo.tcgs, geo.subsampling, nl,
                                 geo.cod.prog_order, geo.rect.x0,
                                 geo.rect.y0, pocs or None))

    def pkts_for(nl: int):
        if nl not in pkt_cache:
            pl = order(nl)
            pkt_cache[nl] = (
                np.asarray([kidx[(pc.comp, pc.res, pc.prec)] for pc in pl],
                           np.int32),
                np.asarray([pc.layer for pc in pl], np.int32))
        return pkt_cache[nl]

    def contexts(layer_cum) -> dict:
        """Fresh precinct contexts holding the blocks with their passes
        per layer, for the Python packet encoder."""
        cs = geo.make_contexts(seg_style_mask)
        for key, cums in zip(entry_keys, layer_cum):
            c, r, p, band_i, cblk_i = key
            src = ctxs[(c, r, p)].eblocks[band_i][cblk_i]
            cs[(c, r, p)].set_block(band_i, cblk_i, src.enc,
                                    src.enc.numbps + src.zb)
            cs[(c, r, p)].eblocks[band_i][cblk_i].layer_cum = cums
        return cs

    def python_emit(cs: dict, nl: int) -> TileEncodeResult:
        """grok_tpu/pipeline/tile.py's Python emission: whole packets
        (SOP, header, EPH, body), or with split_headers the bodies and
        the headers apart."""
        pkts, headers = [], bytearray()
        for pc in order(nl):
            hd, bd = cs[(pc.comp, pc.res, pc.prec)].encode_packet(pc.layer)
            if split_headers:
                headers += hd
                pkts.append(bd)
                continue
            pkt = bytearray()
            if geo.cod.sop:
                idx = len(pkts) & 0xFFFF
                pkt += SOP_MARKER + bytes([0, 4, idx >> 8, idx & 0xFF])
            pkt += hd
            if geo.cod.eph:
                pkt += EPH_MARKER
            pkts.append(bytes(pkt + bd))
        return TileEncodeResult(packets=pkts,
                                packet_lens=[len(p) for p in pkts],
                                body=b"".join(pkts), headers=bytes(headers))

    c_emit = not pocs and not split_headers
    if trivial:
        for key in entry_keys:
            c, r, p, band_i, cblk_i = key
            st = ctxs[(c, r, p)].eblocks[band_i][cblk_i]
            st.layer_cum = [st.enc.numpasses]
        if not c_emit:
            return python_emit(ctxs, 1)
        pc_a, pl_a = pkts_for(1)
        packets = native.t2_emit(ctxs, keys, list(zip(pc_a, pl_a)), 1,
                                 geo.cod.sop, geo.cod.eph)
        if packets is None:
            raise RuntimeError("the C Tier-2 emitter declined the tile")
        return TileEncodeResult(packets=packets,
                                packet_lens=[len(p) for p in packets],
                                body=b"".join(packets))

    prep = None
    if not pocs:
        # prepared emitter: the static arrays are flattened once; every
        # PCRD bisection step and the final emission are one C call
        prep = native.t2_emit_prepare(ctxs, keys)
        if prep is None:
            raise RuntimeError("a code-block of the tile has no coded state")
        gidx = {(k, b, cb): i for i, (k, b, cb) in enumerate(prep["order"])}
        e2g = np.asarray([gidx[((c, r, p), band_i, cblk_i)]
                          for (c, r, p, band_i, cblk_i) in entry_keys],
                         np.int64)

    def emit(layer_cum, nlayers: int):
        if prep is None:
            return python_emit(contexts(layer_cum), nlayers).packets
        lc = np.zeros((prep["n_blks"], nlayers), np.int32)
        lc[e2g] = np.asarray(layer_cum, np.int32)
        pc_a, pl_a = pkts_for(nlayers)
        pk = native.t2_emit_prepared(prep, pc_a, pl_a, lc, nlayers,
                                     geo.cod.sop, geo.cod.eph)
        if pk is None:
            raise RuntimeError("the C Tier-2 emitter declined the tile")
        return pk

    def simulate(layer_cum) -> int:
        nl = len(layer_cum[0]) if layer_cum else num_layers
        return sum(len(p) for p in emit(layer_cum, nl))

    totals = []
    for (c, r, p, band_i, cblk_i) in entry_keys:
        totals.append(ctxs[(c, r, p)].eblocks[band_i][cblk_i]
                      .enc.numpasses)
    if quality_targets is not None:
        dists_list = [np.array([pi.dist * j["weight"] for pi in enc.passes])
                      for j, enc in zip(ejobs, encs)]
        # targets arrive as the allowed total squared error: the required
        # reduction against the largest one achievable
        e0 = sum(float(d[-1]) for d in dists_list if len(d))
        conv = [None if q is None else max(e0 - float(q), 0.0)
                for q in quality_targets]
        layer_cum = allocate_layers_quality(hulls, num_layers, conv,
                                            totals, dists_list)
    else:
        layer_cum = allocate_layers(hulls, num_layers, layer_targets or [],
                                    simulate, totals,
                                    pass_rates=rate_tables)
    changes, trials = _refine_truncations(ejobs, encs, layer_cum, device)
    if prep is not None:
        for i, pno, rate in changes:
            # the prepared arrays hold the rates as they were allocated
            prep["pass_rates"][prep["pass_off"][e2g[i]] + pno] = rate
    if c_emit:
        packets = emit(layer_cum, num_layers)
        res = TileEncodeResult(packets=packets,
                               packet_lens=[len(p) for p in packets],
                               body=b"".join(packets))
    else:
        res = python_emit(contexts(layer_cum), num_layers)
    res.refined = len(changes)
    res.reclaimed = sum(int(rate_tables[i][pno]) - rate
                        for i, pno, rate in changes)
    res.trial_lanes = trials
    return res


# ---------------------------------------------------------------------------
# Decode: the general device route
# ---------------------------------------------------------------------------

def _general_unsupported(what: str, why: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported ({why}); the PyTorch port's general decode "
        f"route decodes HT (cleanup and refinement passes), Part-1 (every "
        f"mode switch) and HT-mixed code-blocks")


# A strict decode's HT block errors, the exceptions of grok_tpu/t1ht/
# scalar.py ht_decode_block(strict=True): the kernels' lane error codes
# (ops/ht_decode.py ERR_VLC, ERR_EXP), and the host's for a cleanup
# segment cut short or badly framed
_HT_ERR_TRUNC, _HT_ERR_FRAMING = 3, 4
_HT_ERRORS = {1: "HT cleanup: bad VLC code",
              2: "HT cleanup: bad exponent bound",
              _HT_ERR_TRUNC: "HT cleanup segment truncated",
              _HT_ERR_FRAMING: "HT cleanup: bad framing"}


def raise_first_ht_error(job_idx: np.ndarray, blocks: np.ndarray,
                         codes: np.ndarray) -> None:
    """Raise the ValueError of the failing HT block (codes != 0) that the
    JAX package's decode_tile meets first: it decodes a tile's blocks in
    component, resolution, band, precinct and code-block order (job_idx:
    each plan block's place in it; blocks: the plan blocks the codes
    belong to), and its scalar decoder raises at the first failing
    one."""
    bad = np.nonzero(np.asarray(codes) != 0)[0]
    if bad.size:
        first = bad[np.argmin(job_idx[np.asarray(blocks)[bad]])]
        raise ValueError(_HT_ERRORS[int(codes[first])])


@dataclass
class GeneralStaged:
    """A tile staged for the general decode route: run() decodes it."""
    program: object           # pipeline/device.py DecodeProgram (N = 1)
    lanes: list               # per bucket: decode_ht_blocks' arguments
    #                           (ms, mel, vlc, sp, mr, p, w, h, valid, npass,
    #                           refine host mask), None without HT blocks
    meta: list                # per bucket: (lanes, 10) int64 host rows: ms,
    #                           suffix, SigProp, MagRef (start, length) in
    #                           the digest, p, npass
    mq: tuple | None = None   # K3's arguments (the program's decode_mq)
    #                           over the tile's Part-1 lanes
    mq_pos: object = None     # (n,) int64: each Part-1 lane's index in
    #                           meta order
    mct_round: bool = False   # synthesize's rounding under a custom MCT
    zero_lanes: object = None  # (z,) int64 host: the HT lanes (meta
    #                           order) decoded as zeros (valid = 0): a
    #                           cleanup segment cut short or badly framed
    strict: tuple | None = None   # a strict decode: (the plan's job_idx,
    #                           each lane's block (meta order), each
    #                           lane's host error code), the device's
    #                           codes read back after the block decodes
    mesh: object = None       # dp.mesh: K3 sharded over it for the lanes
    #                           of mq_shard, and the synthesis levels
    mq_shard: object = None   # (n,) bool on the device: the Part-1 lanes
    #                           (mq's order) that shard (default style,
    #                           one segment)

    def run(self) -> list:
        import torch

        from grok_tpu_torch.ops.ht_decode import MARK_I64, decode_ht_blocks
        from grok_tpu_torch.pipeline.device import redecode_marked
        prog = self.program
        mq = prog.decode_mq(self.mq, self.mq_pos, self.mesh, self.mq_shard) \
            if self.mq is not None else [None] * len(prog.buckets)
        outs, errs, ht = [], [], []
        for bi, b in enumerate(prog.buckets):
            n = self.meta[bi].shape[0]
            la = self.lanes[bi]
            if la is None:
                out = torch.zeros((n, b.H, b.W), dtype=torch.int32,
                                  device=prog.device)
                errs.append(torch.zeros(n, dtype=torch.int32,
                                        device=prog.device))
            else:
                out, err = decode_ht_blocks(*la, b.W, b.H)
                errs.append(err)
                ht.append((bi, la[:10], la[10], err))
            if mq[bi] is not None:
                out = out + mq[bi]
            outs.append(out)
        if self.strict is not None:
            # the one read-back a strict decode adds
            job_idx, blocks, codes = self.strict
            dev = torch.cat(errs).cpu().numpy()
            dev[dev == MARK_I64] = 0             # decoded, not an error
            raise_first_ht_error(job_idx, blocks,
                                 np.where(codes != 0, codes, dev))
        planes = prog.synthesize(outs, self.mct_round, self.mesh)
        wide = redecode_marked(
            outs, ht, lambda bi, a, rf: decode_ht_blocks(
                *a, rf, prog.buckets[bi].W, prog.buckets[bi].H,
                i64=True)[0])
        if wide is not None:
            planes = prog.synthesize(wide, self.mct_round, self.mesh)
        return planes[0]


def decode_tile(cs: bytes, hdr: MainHeader, t: int, th: TileHeader | None,
                body: bytes, dp, *, device) -> list:
    """Decode one tile's packet body on `device` by the general route ->
    per-component int32 tensors, resident there (stage_general, then
    GeneralStaged.run).

    The device branch of grok_tpu/pipeline/tile.py `decode_tile`, the
    route by which the JAX package decodes what its serving decode
    declines: the C Tier-2 parse of the whole packet sequence, or where
    it declines (packed headers, packets cut short or corrupt) the Python
    one (t2/parse.py: SOP resync, a permissive stop with a warning); each
    kept block's codeword segments assembled up to dp.max_layers
    (t2/packet.py BlockDecState) and routed by its code-block style, or
    for HT-mixed streams by the tile-part bitmap; HT blocks with their
    cleanup plane (t1ht/scalar.py derive_p), the cleanup segments split
    by the C scan and the refinement segments un-stuffed by C on the
    host, uploaded as one digest, then per bucket of same-sized blocks the
    sub-streams staged and the blocks decoded by ops/ht_decode.py
    `decode_ht_blocks` (K1 on cleanup-only blocks, K2 on refined ones; a
    block whose cleanup segment was cut short or is badly framed is a
    zero lane, valid = 0, as the JAX package decodes it as zeros); Part-1
    blocks with their segment tables (ops/t1_decode.py segment_table:
    BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM; a block cut short reads
    past its bytes as past a segment's end), their raw codewords in the
    same upload, decoded by one K3 launch over the Part-1 lanes of every
    bucket (one per group of bucket shapes where no one lane of 4096
    samples covers them); a block sees zeros from the coder it does not
    use.  Then the serving decode's ROI shift, dequantization, placement, inverse DWT and MCT
    (a custom one rounded as the JAX package rounds it), DC shift and
    clip (pipeline/device.py DecodeProgram.synthesize), at dp.reduce.
    With dp.window, only the blocks that meet the synthesis-dilated
    window (band_window) are decoded: every pixel inside the window is
    exact, the rest is not meaningful.  Code-blocks of any legal size
    (sides up to 1024, at most 4096 samples) decode in buckets of their
    power-of-two sizes.

    A strict decode (dp.strict) raises what the JAX package's strict
    decode_tile raises: the Python Tier-2 parse's exception where the C
    parse declines (a missing EPH, an SOP sequence mismatch, a packet body
    past the tile data), then, for the HT block it decodes first
    (raise_first_ht_error), the scalar decoder's ValueError: a cleanup
    segment cut short or badly framed (found on the host), an invalid
    CxtVLC codeword or an exponent bound over 40 (the kernels' lane error
    codes, read back once).  Part-1 blocks decode unchecked, as the JAX
    package's do.

    HT code-blocks whose style carries Part-1 mode-switch bits beside the
    HT bit decode as HT blocks (one pass a segment; the HT decoder reads
    none of the other bits), as the JAX package decodes them; components
    mixing HT and Part-1 blocks decode each block by its component's
    style.

    With dp.mesh (a parallel/sharding.py Mesh whose first device is
    `device`; the meshed tiles the serving decode declines come here),
    the default-style single-segment Part-1 lanes are decoded by one K3
    launch per shard of the mesh, the other lanes (HT, styled Part-1) on
    `device`, and every synthesis level is split by rows across the mesh
    with halo exchange (the JAX package's mesh branch of decode_tile);
    the planes equal the unsharded decode's and end on `device`.

    Raises NotImplementedError naming the route for Part-1 blocks
    outside 1..109 passes or 0..30 magnitude planes."""
    return stage_general(cs, hdr, t, th, body, dp, device=device).run()


def stage_general(cs: bytes, hdr: MainHeader, t: int, th: TileHeader | None,
                  body: bytes, dp, *, device) -> GeneralStaged:
    """The host half of decode_tile and the upload: every bucket's lanes
    staged on `device`, ready for the block decodes."""
    import torch

    from grok_tpu_torch.core.params import CBLK_HT
    from grok_tpu_torch.ops.ht_decode import MAX_STREAM
    from grok_tpu_torch.ops.t1_decode import MAX_NUMBPS, segment_table
    from grok_tpu_torch.pipeline.device import (fill_ones, stage_bytes,
                                                unstuff_suffix)
    from grok_tpu_torch.pipeline.plan import _plan_for, window_mask
    from grok_tpu_torch.pipeline.serve import (_full_index, _program,
                                               _upload, stage_dims)
    from grok_tpu_torch.t1ht.scalar import derive_p
    from grok_tpu_torch.t2.packet import BlockDecState, Chunk
    from grok_tpu_torch.t2.parse import parse_packets

    device = torch.device(device)
    th = th or TileHeader()
    route = "general decode route"
    plan = _plan_for(cs, hdr, t, th, int(dp.reduce or 0))
    bitmap = None
    if plan.coder == "mixed":
        # the stream's bitmap routes each block (a block past its end is
        # a Part-1 block, as in the JAX package)
        bitmap = np.frombuffer(th.ht_mixed_bitmap(), np.uint8)

    # -- T2: the C parse, or the Python one where it declines (packed
    # headers, packets cut short or corrupt), then each kept block's
    # segments up to the cap --------------------------------------------
    parsed = None
    if th.ppt is None:
        parsed = native.t2_parse_prepared(body, plan.prep, plan.sop,
                                          plan.eph)
    if parsed is None:
        parsed = parse_packets(body, plan, hdr_buf=th.ppt,
                               strict=bool(dp.strict))
    incl, zb, _npass, chunks, _end = parsed
    keep = np.asarray(incl, bool) & plan.rok
    if dp.window is not None:
        keep &= window_mask(plan, dp.window)
    states = {}
    for b, lay, segno, npk, off, ln in chunks.tolist():
        if keep[b]:
            st = states.setdefault(b, BlockDecState(included=True,
                                                    zb=int(zb[b])))
            st.chunks.append(Chunk(layer=lay, segno=segno, numpasses=npk,
                                   offset=off, length=ln))
    ht, mq = [], []          # per block: (b, data, seg_lens, n, numbps, x)
    n_ht = 0                 # HT blocks, their lanes zeroed included
    zero = []                # blocks whose cleanup segment was cut short
    #                          or badly framed: zero lanes (valid = 0)
    host_err = {}            # a strict decode's: block -> error code
    for b in sorted(states):
        data, seg_lens, n = states[b].assemble(body, dp.max_layers)
        if n <= 0:
            continue
        numbps = int(plan.mb[b]) - states[b].zb
        if bitmap is not None:
            ci = int(plan.canon_idx[b])
            is_ht = ci >> 3 < bitmap.size and bool(
                (bitmap[ci >> 3] >> (ci & 7)) & 1)
        else:
            # by the block's style: its component's COD or COC
            is_ht = bool(plan.style[b] & CBLK_HT)
        if is_ht:
            n_ht += 1
            if numbps <= 0 or seg_lens[0] > len(data):
                # nothing to decode, or the cleanup segment's suffix (at
                # its end) is gone: the JAX package decodes such a block
                # as zeros, or raises on a strict decode
                zero.append(b)
                if numbps > 0 and data:
                    host_err[b] = _HT_ERR_TRUNC
                continue
            p = derive_p(n, numbps, plan.ht_p_ext)
            # the passes decoded, as the JAX package's scalar decoder
            # takes them: SigProp, then MagRef, each where its segment
            # was signalled, none below a cleanup plane of 0
            n = min(n, len(seg_lens), 3) if p > 0 else 1
            # a refinement segment cut short reads 0xFF past its data,
            # as the scalar decoder reads it
            data += b"\xff" * (sum(seg_lens[:n]) - len(data))
            ht.append((b, data, seg_lens[:n], n, numbps, p))
        else:
            if n > 109 or not 0 <= numbps <= MAX_NUMBPS:
                raise _general_unsupported(
                    route, f"a Part-1 block of {n} passes and {numbps} "
                    f"magnitude planes (outside 1..109 and 0..30)")
            # the Part-1 style: the block's COD style, or 0 for the
            # Part-1 blocks of an HT-mixed set
            style = int(plan.style[b]) & ~CBLK_HT
            mq.append((b, data, seg_lens, n, numbps, style))
    # a custom MCT rounds reversible components where the JAX package's
    # C block decoder takes the tile: some block to decode, none of them
    # HT
    mct_round = bool(mq) and not n_ht

    prog = _program(plan, 1, device)
    fidx, bsel = _full_index(plan)
    lane_of = np.full(plan.n_blks, -1, np.int64)   # block -> meta order
    lane_of[fidx[np.concatenate(bsel)]] = np.arange(fidx.size)
    pieces = []                                    # uploaded byte areas

    def area(buf) -> int:
        base = sum(-(-len(x) // 16) * 16 for x in pieces)
        pieces.append(np.frombuffer(buf, np.uint8)
                      if not isinstance(buf, np.ndarray) else buf)
        return base

    # -- HT: C split of the cleanup segments, C un-stuffing of the
    # refinement segments, one digest; per lane in meta order: ms,
    # suffix, SigProp, MagRef (start, length), p, npass, the clean bits
    # of the MagSgn, MEL, VLC, SigProp and MagRef streams (past which the
    # scalar decoder reads 1-bits), and the C scan's stuffing counts ------
    meta = np.zeros((fidx.size, 15), np.int64)
    sc = np.zeros((fidx.size, 7), np.int64)
    if ht:
        seg = np.asarray([s + [0] * (3 - n) for _b, _d, s, n, _nb, _p in ht],
                         np.int64)
        datas = [d for _b, d, *_ in ht]
        doff = np.cumsum([0] + [len(d) for d in datas])[:-1]
        cat = b"".join(datas)
        res = native.ht_scan2(cat, doff, seg[:, 0])
        if res is None:
            raise _general_unsupported(route, "HT wire scan overflow")
        scan, dig, bits = res
        # a badly framed cleanup segment: a zero lane, as the JAX
        # package decodes it, or a strict decode's error
        ok = scan[:, 0] >= 0
        for x, good in zip(ht, ok):
            if not good:
                zero.append(x[0])
                host_err[x[0]] = _HT_ERR_FRAMING
        sp_c, sp_len, sp_bits = native.ht_unstuff_batch(
            cat, doff + seg[:, 0], seg[:, 1])
        mr_c, mr_len, mr_bits = native.ht_unstuff_batch(
            cat, doff + seg[:, 0] + seg[:, 1], seg[:, 2])
        longest = max(int(scan[:, 2].max()), int(scan[:, 4].max()),
                      int(sp_len.max()), int(mr_len.max()))
        if longest > MAX_STREAM:
            raise _general_unsupported(route, f"a sub-stream longer than "
                                       f"{MAX_STREAM} bytes")
        dig_base = area(dig)
        sp_base = area(sp_c)
        mr_base = area(mr_c)
        rows = lane_of[[x[0] for x in ht]]
        vals = np.stack([dig_base + scan[:, 1], scan[:, 2],
                         dig_base + scan[:, 3], scan[:, 4],
                         sp_base + np.cumsum(sp_len) - sp_len, sp_len,
                         mr_base + np.cumsum(mr_len) - mr_len, mr_len,
                         [x[5] for x in ht], [x[3] for x in ht],
                         bits[:, 0], bits[:, 1], bits[:, 2], sp_bits,
                         mr_bits], 1)
        meta[rows[ok]] = vals[ok]
        sc[rows[ok], 5:7] = scan[ok, 5:7]
    sc[:, 2], sc[:, 4] = meta[:, 1], meta[:, 3]
    ends = prog.lane_base[1:] + [fidx.size]
    metas = [meta[lo:hi] for lo, hi in zip(prog.lane_base, ends)]
    dims = [stage_dims(sc[lo:hi]) for lo, hi in zip(prog.lane_base, ends)]

    # -- Part-1: the raw codewords and their segment tables ----------------
    if mq:
        # segments clamped to each block's data: a block cut short reads
        # past its data as past a segment's end (0xFF, or 0 raw bits), as
        # the JAX package's C block decoder does
        npass_e, ptbl = segment_table([x[3] for x in mq], [x[4] for x in mq],
                                      [x[5] for x in mq],
                                      [x[2] for x in mq],
                                      [len(x[1]) for x in mq])
        datas = [x[1] for x in mq]
        raw_base = area(b"".join(datas) + b"\0")
        mq_rows = np.stack([raw_base + np.cumsum([0] + [len(d) for d in
                                                        datas])[:-1],
                            npass_e, [x[4] for x in mq], [x[5] for x in mq]],
                           1).astype(np.int32)
        mq_pos = lane_of[[x[0] for x in mq]]

    top = sum(-(-len(x) // 16) * 16 for x in pieces)
    flat = np.zeros(max(16, top), np.uint8)
    pos = 0
    for x in pieces:
        flat[pos:pos + len(x)] = x
        pos += -(-len(x) // 16) * 16
    arrays = [flat, meta.astype(np.int32)]
    if mq:
        arrays += [mq_rows, ptbl]
    up = _upload(plan, arrays, device)
    body_d, meta_d = up[0], up[1]
    lanes, lo = [], 0
    for (Lms, Lsuf, Dm), m in zip(dims, metas):
        n = m.shape[0]
        if not ht:
            lanes.append(None)
            continue
        mt = meta_d[lo:lo + n].to(torch.int64)
        lo += n
        u8 = torch.uint8
        suf_f = stage_bytes(body_d, mt[:, 2], mt[:, 3], Lsuf, False)
        suf_r = stage_bytes(body_d, mt[:, 2], mt[:, 3] - 1, Lsuf, True)
        mel, vlc = unstuff_suffix(suf_f, suf_r, Dm)
        mel, vlc = fill_ones(mel, mt[:, 11]), fill_ones(vlc, mt[:, 12])
        Lrf = _quant_len(int(max(m[:, 5].max(), m[:, 7].max())))
        ms = fill_ones(stage_bytes(body_d, mt[:, 0], mt[:, 1], Lms, False),
                       mt[:, 10])
        sp = fill_ones(stage_bytes(body_d, mt[:, 4], mt[:, 5], Lrf, False),
                       mt[:, 13])
        mr = fill_ones(stage_bytes(body_d, mt[:, 6], mt[:, 7], Lrf, False),
                       mt[:, 14])
        w, h = prog.wh[len(lanes)]
        i32 = torch.int32
        lanes.append((ms.to(u8), mel.to(u8), vlc.to(u8), sp.to(u8),
                      mr.to(u8), mt[:, 8].to(i32), w, h,
                      (mt[:, 9] > 0).to(i32), mt[:, 9].to(i32),
                      m[:, 9] >= 2))
    staged = GeneralStaged(prog, lanes, metas, mct_round=mct_round,
                           zero_lanes=lane_of[zero] if zero else
                           np.zeros(0, np.int64))
    if dp.strict:
        blocks = fidx[np.concatenate(bsel)]        # meta order
        codes = np.zeros(fidx.size, np.int64)
        for b, c in host_err.items():
            codes[lane_of[b]] = c
        staged.strict = (plan.job_idx, blocks, codes)
    if mq:
        staged.mq_pos = torch.from_numpy(mq_pos).to(device)
        staged.mq = prog.stage_mq_lanes(body_d, up[2], up[3],
                                        staged.mq_pos)
    if dp.mesh is not None:
        staged.mesh = dp.mesh
        if mq:
            staged.mq_shard = torch.from_numpy(np.asarray(
                [x[5] == 0 and len(x[2]) <= 1 for x in mq])).to(device)
    return staged
