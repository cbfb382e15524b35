"""Tier-2 precinct state (ISO/IEC 15444-1 B.10) for the C packet coder.

The port's copy of the state half of grok_tpu/t2/packet.py: the encoder's
block state, and the decoder's (`Chunk`, `BlockDecState` with its
`assemble` of a block's codeword segments up to a layer cap).  Packets
are parsed (native.t2_parse_prepared) and emitted (native.t2_emit) by the
C Tier-2 code, which builds its own tag trees from this state, so the
Python packet coder, tag trees and bit IO of the JAX package are not
carried over.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from grok_tpu_torch.core.geometry import BandPrecinctGeom
from grok_tpu_torch.t1.records import EncodedBlock


@dataclass
class BlockEncState:
    """Per-code-block encoder-side T2 state."""

    enc: EncodedBlock
    zb: int                                 # zero bitplanes = Mb - numbps
    layer_cum: list[int] = field(default_factory=list)   # passes per layer


@dataclass
class Chunk:
    """One codeword-segment contribution from one packet."""

    layer: int
    segno: int
    numpasses: int
    offset: int      # into the tile body buffer
    length: int


@dataclass
class BlockDecState:
    """Per-code-block decoder-side T2 accumulation (the C parser's rows
    for one block, native.t2_parse_prepared)."""

    included: bool = False
    numpasses: int = 0
    zb: int = 0              # zero bitplanes, known at first inclusion
    chunks: list[Chunk] = field(default_factory=list)

    def assemble(self, body: bytes, max_layers: int = 0
                 ) -> tuple[bytes, list[int], int]:
        """Concatenate codeword bytes up to max_layers (0 = all).

        Returns (data, seg_lens, numpasses).
        """
        seg_lens: dict[int, int] = {}
        data = bytearray()
        numpasses = 0
        for ch in self.chunks:
            if max_layers and ch.layer >= max_layers:
                continue
            seg_lens[ch.segno] = seg_lens.get(ch.segno, 0) + ch.length
            data.extend(body[ch.offset:ch.offset + ch.length])
            numpasses += ch.numpasses
        lens = [seg_lens[k] for k in sorted(seg_lens)]
        return bytes(data), lens, numpasses


class PrecinctCtx:
    """Bands + per-block encoder state for one (comp, res, precinct)."""

    def __init__(self, band_precincts: list[tuple[int, BandPrecinctGeom]],
                 style: int):
        self.style = style
        self.bands: list[tuple[int, BandPrecinctGeom]] = band_precincts
        self.eblocks: list[list[BlockEncState | None]] = [
            [None] * len(bp.cblks) for _orient, bp in band_precincts]

    def set_block(self, band_i: int, cblk_i: int, enc: EncodedBlock,
                  mb: int):
        self.eblocks[band_i][cblk_i] = BlockEncState(
            enc=enc, zb=max(mb - enc.numbps, 0))
