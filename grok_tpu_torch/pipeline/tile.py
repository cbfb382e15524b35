"""Tile geometry, the Tier-2 finish of an encode, and the general decode.

The port's copy of grok_tpu/pipeline/tile.py, for what the port serves:
`TileGeometry` (geometry + coding state shared by the decode and encode
plans), `canon_block_indices` (the HT-mixed bitmap's block order),
`TileEncodeResult`, `finish_tile_encode` (the PCRD rate allocation over
several layers or byte targets, t2/rate.py, the Part-1 minimal-flush
truncation refinement by trial decodes with kernel K3, and the packet
emission by the C Tier-2 coder, native.t2_emit), and `decode_tile`, the
general device decode route for HT streams the serving decode declines
(refined blocks), with kernels K1 and K2.

Reference parity: [grok: src/lib/core/tile/TileProcessor.cpp ::
compressTile] — behavior normative per ISO 15444-1.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from grok_tpu_torch import native
from grok_tpu_torch.codestream.j2k import (CodingStyle, CodingStyleComp,
                                           MainHeader, QuantStyle, TileHeader)
from grok_tpu_torch.core.geometry import (Rect, TileCompGeom,
                                          build_tilecomp_geometry)
from grok_tpu_torch.core.quant import Quantizer
from grok_tpu_torch.ops.ht_decode import _quant_len
from grok_tpu_torch.t2.packet import PrecinctCtx
from grok_tpu_torch.t2.progression import iter_packets
from grok_tpu_torch.t2.rate import allocate_layers, convex_hull


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


@dataclass
class TileEncodeResult:
    packets: list[bytes]             # in progression order
    packet_lens: list[int]
    body: bytes                      # concatenated packets
    com: bytes = b""                 # tile-part COM (the HT-mixed bitmap)
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
                       seg_style_mask: int = -1,
                       device="cpu") -> TileEncodeResult:
    """Rate allocation + Tier-2 emission over already-coded blocks.

    ejobs need key (c, r, p, band_i, cblk_i), mb and, for the PCRD
    allocation, weight (the band's distortion weight) per block; encs
    are the EncodedBlocks.  layer_targets: cumulative byte budget per
    layer, None for "every remaining pass".  One layer with no target
    ships every pass of every block and runs no allocation; otherwise
    the convex hulls and the layer allocation (t2/rate.py) pick each
    block's passes per layer, with every candidate allocation sized by
    the C emitter, and the Part-1 minimal-flush refinement shrinks the
    final truncation of blocks whose jobs carry style, orient, w and h
    (_refine_truncations: trial decodes on `device`, the serving
    encode's), as grok_tpu/pipeline/tile.py `finish_tile_encode` does
    for byte targets (its quality targets are not ported).
    seg_style_mask: AND-mask on the Tier-2 segmentation style (HT-mixed
    sets emit with ~CBLK_HT); the emitter chunks each block's codeword by
    its passes' termination flags."""
    num_layers = geo.cod.num_layers
    trivial = num_layers == 1 and (
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

    def pkts_for(nl: int):
        if nl not in pkt_cache:
            pl = list(iter_packets(geo.tcgs, geo.subsampling, nl,
                                   geo.cod.prog_order, geo.rect.x0,
                                   geo.rect.y0))
            pkt_cache[nl] = (
                np.asarray([kidx[(pc.comp, pc.res, pc.prec)] for pc in pl],
                           np.int32),
                np.asarray([pc.layer for pc in pl], np.int32))
        return pkt_cache[nl]

    if trivial:
        for key in entry_keys:
            c, r, p, band_i, cblk_i = key
            st = ctxs[(c, r, p)].eblocks[band_i][cblk_i]
            st.layer_cum = [st.enc.numpasses]
        pc_a, pl_a = pkts_for(1)
        packets = native.t2_emit(ctxs, keys, list(zip(pc_a, pl_a)), 1,
                                 geo.cod.sop, geo.cod.eph)
    else:
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
        layer_cum = allocate_layers(hulls, num_layers, layer_targets or [],
                                    simulate, totals,
                                    pass_rates=rate_tables)
        changes, trials = _refine_truncations(ejobs, encs, layer_cum, device)
        for i, pno, rate in changes:
            # the prepared arrays hold the rates as they were allocated
            prep["pass_rates"][prep["pass_off"][e2g[i]] + pno] = rate
        packets = emit(layer_cum, num_layers)
        return TileEncodeResult(
            packets=packets, packet_lens=[len(p) for p in packets],
            body=b"".join(packets), refined=len(changes),
            reclaimed=sum(int(rate_tables[i][pno]) - rate
                          for i, pno, rate in changes),
            trial_lanes=trials)
    if packets is None:
        raise RuntimeError("the C Tier-2 emitter declined the tile")
    return TileEncodeResult(packets=packets,
                            packet_lens=[len(p) for p in packets],
                            body=b"".join(packets))


# ---------------------------------------------------------------------------
# Decode: the general device route
# ---------------------------------------------------------------------------

def _general_unsupported(what: str, why: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported ({why}); the PyTorch port's general decode "
        f"route decodes single-tile HT streams (cleanup and refinement "
        f"passes) only")


@dataclass
class GeneralStaged:
    """A tile staged for the general decode route: run() decodes it."""
    program: object           # pipeline/device.py DecodeProgram (N = 1)
    lanes: list               # per bucket: decode_ht_blocks' arguments
    #                           (ms, mel, vlc, sp, mr, p, w, h, valid, npass,
    #                           refine host mask)
    meta: list                # per bucket: (lanes, 10) int64 host rows: ms,
    #                           suffix, SigProp, MagRef (start, length) in
    #                           the digest, p, npass

    def run(self) -> list:
        from grok_tpu_torch.ops.ht_decode import decode_ht_blocks
        outs = [decode_ht_blocks(*la, b.W, b.H)
                for la, b in zip(self.lanes, self.program.buckets)]
        return self.program.synthesize(outs)[0]


def decode_tile(cs: bytes, hdr: MainHeader, t: int, th: TileHeader | None,
                body: bytes, dp, *, device) -> list:
    """Decode one tile's packet body on `device` by the general route ->
    per-component int32 tensors, resident there (stage_general, then
    GeneralStaged.run).

    The HT device branch of grok_tpu/pipeline/tile.py `decode_tile`, the
    route by which the JAX package decodes what its serving decode
    declines (refined streams): the C Tier-2 parse of the whole packet
    sequence; each block's codeword segments assembled up to
    dp.max_layers (t2/packet.py BlockDecState) and its cleanup plane
    (t1ht/scalar.py derive_p); the cleanup segments split by the C scan
    and the refinement segments un-stuffed by C on the host, uploaded as
    one digest; then on the device, per bucket of same-sized blocks, the
    sub-streams staged and the blocks decoded by ops/ht_decode.py
    `decode_ht_blocks` (K1 on cleanup-only blocks, K2 on refined ones),
    and the serving decode's dequantization, placement, inverse DWT and
    MCT, DC shift and clip (pipeline/device.py DecodeProgram.synthesize),
    at dp.reduce.

    Raises NotImplementedError naming the route for Part-1 or HT-mixed
    blocks (the general route's K3 is not ported), windows, ROI, PPM/PPT,
    strict decodes, code-blocks over 64 x 64 and blocks the device
    kernels do not take (grok_tpu/ops/pallas_ht.py ht_block_eligible)."""
    return stage_general(cs, hdr, t, th, body, dp, device=device).run()


def stage_general(cs: bytes, hdr: MainHeader, t: int, th: TileHeader | None,
                  body: bytes, dp, *, device) -> GeneralStaged:
    """The host half of decode_tile and the upload: every bucket's lanes
    staged on `device`, ready for the block decodes."""
    import torch

    from grok_tpu_torch.ops.ht_decode import MAX_STREAM
    from grok_tpu_torch.pipeline.device import stage_bytes, unstuff_suffix
    from grok_tpu_torch.pipeline.plan import _plan_for
    from grok_tpu_torch.pipeline.serve import (_full_index, _program,
                                               _upload, stage_dims)
    from grok_tpu_torch.t1ht.scalar import derive_p
    from grok_tpu_torch.t2.packet import BlockDecState, Chunk

    device = torch.device(device)
    th = th or TileHeader()
    route = "general decode route"
    if dp.strict:
        raise _general_unsupported("strict decode", "strict=True")
    if dp.window is not None:
        raise _general_unsupported("windowed decode", "a window was given")
    if hdr.ppm is not None or th.ppt is not None:
        raise _general_unsupported(route, "PPM/PPT packed packet headers")
    if th.coc or th.qcc or th.rgn or th.pocs:
        raise _general_unsupported(route, "per-component overrides, ROI or "
                                   "a tile POC")
    if th.ht_mixed_bitmap() is not None:
        raise _general_unsupported("HT-mixed blocks on the " + route,
                                   "their Part-1 blocks need K3 there")
    plan = _plan_for(cs, hdr, t, th, int(dp.reduce or 0))
    if plan is None:
        raise _general_unsupported(route, "ROI, a custom MCT, Part-1 mode "
                                   "switches or code-blocks over 64x64")
    if plan.coder != "ht":
        raise _general_unsupported("Part-1 blocks on the " + route,
                                   "the general route's K3 is not ported")

    # -- T2: the C parse, then each kept block's segments up to the cap ----
    parsed = native.t2_parse_prepared(body, plan.prep, plan.sop, plan.eph)
    if parsed is None:
        raise _general_unsupported(route, "the C Tier-2 parse failed "
                                   "(truncated or corrupt packets)")
    incl, zb, _npass, chunks, _end = parsed
    states = {}
    for b, lay, segno, npk, off, ln in chunks.tolist():
        if incl[b] and plan.rok[b]:
            st = states.setdefault(b, BlockDecState(included=True,
                                                    zb=int(zb[b])))
            st.chunks.append(Chunk(layer=lay, segno=segno, numpasses=npk,
                                   offset=off, length=ln))
    blks, datas, segs, npass, nbps, pv = [], [], [], [], [], []
    for b in sorted(states):
        data, seg_lens, n = states[b].assemble(body, dp.max_layers)
        if n <= 0:
            continue
        numbps = int(plan.mb[b]) - states[b].zb
        p = derive_p(n, numbps, plan.ht_p_ext)
        # the device kernels' scope (ht_block_eligible)
        if n > 3 or len(seg_lens) != n or (n > 1 and p == 0) \
                or numbps - p > 24:
            raise _general_unsupported(
                route, f"a block of {n} passes in {len(seg_lens)} segments "
                f"with {numbps} planes and cleanup plane {p}")
        blks.append(b)
        datas.append(data)
        segs.append(seg_lens + [0] * (3 - n))
        npass.append(n)
        nbps.append(numbps)
        pv.append(p)
    if not blks:
        raise _general_unsupported(route, "no coded code-blocks")
    nb = len(blks)
    seg = np.asarray(segs, np.int64)                   # (nb, 3) lengths
    doff = np.cumsum([0] + [len(d) for d in datas])[:-1]
    cat = b"".join(datas)

    # -- host staging: C split of the cleanup segments, C un-stuffing of
    # the refinement segments, one digest ---------------------------------
    res = native.ht_scan2(cat, doff, seg[:, 0])
    if res is None:
        raise _general_unsupported(route, "HT wire scan overflow")
    scan, dig = res
    if (scan[:, 0] < 0).any():
        raise _general_unsupported(route, "invalid HT cleanup framing")
    sp_c, sp_len = native.ht_unstuff_batch(cat, doff + seg[:, 0], seg[:, 1])
    mr_c, mr_len = native.ht_unstuff_batch(cat, doff + seg[:, 0] + seg[:, 1],
                                           seg[:, 2])
    longest = max(int(scan[:, 2].max()), int(scan[:, 4].max()),
                  int(sp_len.max()), int(mr_len.max()))
    if longest > MAX_STREAM:
        raise _general_unsupported(route, f"a sub-stream longer than "
                                   f"{MAX_STREAM} bytes")
    sp_base = -(-len(dig) // 16) * 16
    mr_base = sp_base + -(-len(sp_c) // 16) * 16
    flat = np.zeros(max(16, mr_base + len(mr_c)), np.uint8)
    flat[:len(dig)] = dig
    flat[sp_base:sp_base + len(sp_c)] = sp_c
    flat[mr_base:mr_base + len(mr_c)] = mr_c
    # per-block meta: ms, suffix, SigProp, MagRef (start, length), p, npass
    meta_b = np.stack([scan[:, 1], scan[:, 2], scan[:, 3], scan[:, 4],
                       sp_base + np.cumsum(sp_len) - sp_len, sp_len,
                       mr_base + np.cumsum(mr_len) - mr_len, mr_len,
                       pv, npass], 1).astype(np.int64)

    # -- full staging over the plan's kept blocks, bucket by bucket --------
    prog = _program(plan, 1, device)
    fidx, bsel = _full_index(plan)
    row_of = np.full(plan.n_blks, -1, np.int64)
    row_of[blks] = np.arange(nb)
    metas, dims = [], []
    for sel in bsel:
        if sel.size == 0:
            continue
        r = row_of[fidx[sel]]
        m = np.where((r >= 0)[:, None], meta_b[np.maximum(r, 0)], 0)
        metas.append(m)
        live = m[:, 9] > 0
        sc = np.zeros((m.shape[0], 7), np.int64)
        sc[:, 2], sc[:, 4] = m[:, 1], m[:, 3]
        sc[live, 5:7] = scan[r[live], 5:7]
        dims.append(stage_dims(sc))
    body_d, meta_d = _upload(plan, [flat, np.concatenate(metas)
                                    .astype(np.int32)], device)
    lanes, lo = [], 0
    for (Lms, Lsuf, Dm), m in zip(dims, metas):
        n = m.shape[0]
        mt = meta_d[lo:lo + n].to(torch.int64)
        lo += n
        u8 = torch.uint8
        suf_f = stage_bytes(body_d, mt[:, 2], mt[:, 3], Lsuf, False)
        suf_r = stage_bytes(body_d, mt[:, 2], mt[:, 3] - 1, Lsuf, True)
        mel, vlc = unstuff_suffix(suf_f, suf_r, Dm)
        Lrf = _quant_len(int(max(m[:, 5].max(), m[:, 7].max())))
        ms = stage_bytes(body_d, mt[:, 0], mt[:, 1], Lms, False)
        sp = stage_bytes(body_d, mt[:, 4], mt[:, 5], Lrf, False)
        mr = stage_bytes(body_d, mt[:, 6], mt[:, 7], Lrf, False)
        w, h = prog.wh[len(lanes)]
        i32 = torch.int32
        lanes.append((ms.to(u8), mel.to(u8), vlc.to(u8), sp.to(u8),
                      mr.to(u8), mt[:, 8].to(i32), w, h,
                      (mt[:, 9] > 0).to(i32), mt[:, 9].to(i32),
                      m[:, 9] >= 2))
    return GeneralStaged(prog, lanes, metas)
