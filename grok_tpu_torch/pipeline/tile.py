"""Tile geometry and the Tier-2 finish of an encode (host side).

The port's copy of the host half of grok_tpu/pipeline/tile.py:
`TileGeometry` (geometry + coding state shared by the serving decode and
encode plans), `canon_block_indices` (the HT-mixed bitmap's block
order), `TileEncodeResult`, and `finish_tile_encode` for the serving
shape the port encodes — one quality layer with no byte or
quality target, where every pass ships and no rate allocation runs.
Packets are emitted by the C Tier-2 coder (native.t2_emit).

Reference parity: [grok: src/lib/core/tile/TileProcessor.cpp ::
compressTile] — behavior normative per ISO 15444-1.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from grok_tpu_torch import native
from grok_tpu_torch.codestream.j2k import (CodingStyle, CodingStyleComp,
                                           MainHeader, QuantStyle, TileHeader)
from grok_tpu_torch.core.geometry import (Rect, TileCompGeom,
                                          build_tilecomp_geometry)
from grok_tpu_torch.core.quant import Quantizer
from grok_tpu_torch.t2.packet import PrecinctCtx
from grok_tpu_torch.t2.progression import iter_packets


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


def finish_tile_encode(geo: TileGeometry, ejobs: list[dict], encs: list,
                       seg_style_mask: int = -1) -> TileEncodeResult:
    """Tier-2 emission over already-coded blocks for one quality layer
    with no byte or quality target: every pass of every block ships, so
    no rate allocation runs.  ejobs need only key (c, r, p, band_i,
    cblk_i) and mb per block; encs are the EncodedBlocks.
    seg_style_mask: AND-mask on the Tier-2 segmentation style (HT-mixed
    sets emit with ~CBLK_HT); the emitter chunks each block's codeword
    by its passes' termination flags."""
    if geo.cod.num_layers != 1:
        raise NotImplementedError(
            "multi-layer Tier-2 finish (PCRD) is not ported")
    ctxs = geo.make_contexts(seg_style_mask)
    for j, enc in zip(ejobs, encs):
        c, r, p, band_i, cblk_i = j["key"]
        mb = j["mb"]
        if enc.numbps > mb:
            raise ValueError(
                f"block overflows Mb: {enc.numbps} > {mb} "
                f"(band r={r}); raise guard bits")
        ctx = ctxs[(c, r, p)]
        ctx.set_block(band_i, cblk_i, enc, mb)
        ctx.eblocks[band_i][cblk_i].layer_cum = [enc.numpasses]
    if not ejobs:
        return TileEncodeResult(packets=[], packet_lens=[], body=b"")
    keys = list(ctxs.keys())
    kidx = {k: i for i, k in enumerate(keys)}
    pkts = [(kidx[(pc.comp, pc.res, pc.prec)], pc.layer)
            for pc in iter_packets(geo.tcgs, geo.subsampling, 1,
                                   geo.cod.prog_order, geo.rect.x0,
                                   geo.rect.y0)]
    packets = native.t2_emit(ctxs, keys, pkts, 1, geo.cod.sop, geo.cod.eph)
    if packets is None:
        raise RuntimeError("the C Tier-2 emitter declined the tile")
    return TileEncodeResult(packets=packets,
                            packet_lens=[len(p) for p in packets],
                            body=b"".join(packets))
