"""Tier-2 precinct state (ISO/IEC 15444-1 B.10) for the C packet coder.

The port's copy of the state half of grok_tpu/t2/packet.py.  Packets are
parsed (native.t2_parse_prepared) and emitted (native.t2_emit) by the C
Tier-2 code, which builds its own tag trees from this state, so the
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
