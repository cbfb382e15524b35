"""Tier-2 precinct state, the packet encoder and the packet header
decode (ISO/IEC 15444-1 B.10).

The port's copy of grok_tpu/t2/packet.py: the encoder's block state
(packets in the default progressions are emitted by the C Tier-2 coder,
native.t2_emit, which builds its own tag trees from it) and
`PrecinctCtx.encode_packet`, the Python packet encoder that emits
POC-ordered packets and PPM's split headers, as the JAX package's finish
does; and the decoder: `Chunk`, `BlockDecState` with its `assemble` of a
block's codeword segments up to a layer cap, and
`PrecinctCtx.decode_packet`, one packet header into chunks on each
block, with its tag trees (t2/tagtree.py) and bit reader
(codestream/bitio.py).  Intact streams are parsed by the C Tier-2
parser (native.t2_parse_prepared); the Python parse (t2/parse.py) takes
packed headers, cut streams and SOP resync.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

from grok_tpu_torch.codestream.bitio import BitReader, BitWriter
from grok_tpu_torch.core.geometry import BandPrecinctGeom
from grok_tpu_torch.core.params import CBLK_BYPASS, CBLK_HT, CBLK_TERMALL
from grok_tpu_torch.t1.records import EncodedBlock
from grok_tpu_torch.t2.tagtree import TagTree


def floorlog2(x: int) -> int:
    return x.bit_length() - 1


def max_seg_passes(style: int, segno: int) -> int:
    """Pass capacity of codeword segment `segno` (the segmentation
    schedule of the block coders)."""
    if style & CBLK_HT:
        return 1            # every HT pass terminates its own segment
    if style & CBLK_TERMALL:
        return 1
    if style & CBLK_BYPASS:
        if segno == 0:
            return 10
        return 2 if (segno % 2) == 1 else 1
    return 109


def write_numpasses(bw: BitWriter, n: int):
    """B.10.6 coding of the number of new passes."""
    if n == 1:
        bw.write_bit(0)
    elif n == 2:
        bw.write_bits(0b10, 2)
    elif 3 <= n <= 5:
        bw.write_bits(0b11, 2)
        bw.write_bits(n - 3, 2)
    elif 6 <= n <= 36:
        bw.write_bits(0b1111, 4)
        bw.write_bits(n - 6, 5)
    elif 37 <= n <= 164:
        bw.write_bits(0b111111111, 9)
        bw.write_bits(n - 37, 7)
    else:
        raise ValueError(f"cannot code {n} new passes")


def read_numpasses(br: BitReader) -> int:
    """B.10.6: the number of new coding passes."""
    if not br.read_bit():
        return 1
    if not br.read_bit():
        return 2
    v = br.read_bits(2)
    if v < 3:
        return 3 + v
    v = br.read_bits(5)
    if v < 31:
        return 6 + v
    return 37 + br.read_bits(7)


@dataclass
class BlockEncState:
    """Per-code-block encoder-side T2 state."""

    enc: EncodedBlock
    zb: int                                 # zero bitplanes = Mb - numbps
    passes_written: int = 0                 # cumulative passes in prior layers
    rate_written: int = 0                   # cumulative bytes in prior layers
    lblock: int = 3
    layer_cum: list[int] = field(default_factory=list)   # passes per layer


@dataclass
class SegState:
    length: int = 0
    numpasses: int = 0


@dataclass
class Chunk:
    """One codeword-segment contribution from one packet."""

    layer: int
    segno: int
    numpasses: int
    offset: int      # into the tile body buffer
    length: int
    seq: int = 0     # parse order within the tile (the Python parse)


@dataclass
class BlockDecState:
    """Per-code-block decoder-side T2 accumulation (the C parser's rows
    for one block, native.t2_parse_prepared, or the Python parse's)."""

    included: bool = False
    numpasses: int = 0
    lblock: int = 3
    zb: int = 0              # zero bitplanes, known at first inclusion
    segs: list[SegState] = field(default_factory=list)
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
    """Bands + per-block state for one (comp, res, precinct): the
    encoder's block states and tag trees (built at the first packet
    encoded), and the decoder's tag trees and block states, built at the
    first packet decoded."""

    def __init__(self, band_precincts: list[tuple[int, BandPrecinctGeom]],
                 style: int):
        self.style = style
        self.bands: list[tuple[int, BandPrecinctGeom]] = band_precincts
        self.eblocks: list[list[BlockEncState | None]] = [
            [None] * len(bp.cblks) for _orient, bp in band_precincts]
        self.dec: tuple | None = None   # (incl, imsb, dblocks)
        self.enc: tuple | None = None   # (incl, imsb)

    def set_block(self, band_i: int, cblk_i: int, enc: EncodedBlock,
                  mb: int):
        self.eblocks[band_i][cblk_i] = BlockEncState(
            enc=enc, zb=max(mb - enc.numbps, 0))

    # -- encoder -----------------------------------------------------------
    def _enc(self) -> tuple:
        """The encoder's tag trees, the zero-bitplane tree's leaves set
        from the block states (grok_tpu/t2/packet.py sets them block by
        block in set_block: the minima do not depend on the order)."""
        if self.enc is None:
            incl, imsb = [], []
            for band_i, (_orient, bp) in enumerate(self.bands):
                has = bp.cblk_grid_w and bp.cblk_grid_h
                incl.append(TagTree(bp.cblk_grid_w, bp.cblk_grid_h)
                            if has else None)
                tree = TagTree(bp.cblk_grid_w, bp.cblk_grid_h) \
                    if has else None
                for cblk_i, geo in enumerate(bp.cblks):
                    tree.set_value(*geo.idx_in_prec,
                                   self.eblocks[band_i][cblk_i].zb)
                imsb.append(tree)
            self.enc = (incl, imsb)
        return self.enc

    def encode_packet(self, layer: int) -> tuple[bytes, bytes]:
        """Emit (header_bits_flushed, body) for one layer."""
        incls, imsbs = self._enc()
        if layer == 0:
            # The inclusion tag tree must know EVERY block's
            # first-inclusion layer before any bit is emitted: interior
            # nodes are shared, so encoding an early not-yet-included
            # block against a min() that later siblings would lower
            # desynchronizes the emitted prefix from the decoder's view.
            for band_i, (_orient, bp) in enumerate(self.bands):
                tree = incls[band_i]
                for cblk_i, geo in enumerate(bp.cblks):
                    st = self.eblocks[band_i][cblk_i]
                    x, y = geo.idx_in_prec
                    lc = st.layer_cum
                    first = next((l for l, v in enumerate(lc) if v > 0),
                                 1 << 20)
                    tree.set_value(x, y, first)
        bw = BitWriter()
        bw.write_bit(1)  # packet non-empty (zero-inclusion handled per block)
        body = bytearray()
        for band_i, (_orient, bp) in enumerate(self.bands):
            incl, imsb = incls[band_i], imsbs[band_i]
            for cblk_i, geo in enumerate(bp.cblks):
                st = self.eblocks[band_i][cblk_i]
                assert st is not None, "encoder block state missing"
                total = st.layer_cum[layer] if layer < len(st.layer_cum) \
                    else st.passes_written
                newpasses = total - st.passes_written
                x, y = geo.idx_in_prec
                # inclusion (tree values pre-set at layer 0)
                if st.passes_written == 0:
                    incl.encode(bw, x, y, layer + 1)
                else:
                    bw.write_bit(1 if newpasses > 0 else 0)
                if newpasses <= 0:
                    continue
                if st.passes_written == 0:
                    imsb.encode(bw, x, y, 0x7FFFFFFF)   # resolve fully
                write_numpasses(bw, newpasses)
                # chunk new passes by codeword-segment termination
                passes = st.enc.passes
                chunks: list[tuple[int, int]] = []   # (numpasses, bytes)
                nump, prev_rate = 0, st.rate_written
                for pi in range(st.passes_written, total):
                    nump += 1
                    if passes[pi].term or pi == total - 1:
                        chunks.append((nump, passes[pi].rate - prev_rate))
                        prev_rate = passes[pi].rate
                        nump = 0
                # Lblock update (comma code) then lengths
                increment = 0
                for cn, clen in chunks:
                    bits_needed = max(clen.bit_length(), 1)
                    increment = max(increment,
                                    bits_needed - (st.lblock + floorlog2(cn)))
                for _ in range(increment):
                    bw.write_bit(1)
                bw.write_bit(0)
                st.lblock += increment
                for cn, clen in chunks:
                    bw.write_bits(clen, st.lblock + floorlog2(cn))
                # body bytes
                start = st.rate_written
                end = passes[total - 1].rate
                body.extend(st.enc.data[start:end])
                st.passes_written = total
                st.rate_written = end
        return bw.flush(), bytes(body)

    # -- decoder -----------------------------------------------------------
    @property
    def dblocks(self) -> list[list[BlockDecState]]:
        return self._dec()[2]

    def _dec(self) -> tuple:
        if self.dec is None:
            incl, imsb, dblocks = [], [], []
            for _orient, bp in self.bands:
                has = bp.cblk_grid_w and bp.cblk_grid_h
                incl.append(TagTree(bp.cblk_grid_w, bp.cblk_grid_h)
                            if has else None)
                imsb.append(TagTree(bp.cblk_grid_w, bp.cblk_grid_h)
                            if has else None)
                dblocks.append([BlockDecState() for _ in bp.cblks])
            self.dec = (incl, imsb, dblocks)
        return self.dec

    def snapshot(self) -> tuple:
        """A deep copy of the decoder state, for restore() when a packet
        turns out corrupt (the SOP resync)."""
        return copy.deepcopy(self._dec())

    def restore(self, snap: tuple):
        self.dec = snap

    def decode_packet(self, br: BitReader, layer: int, body_base: int,
                      seq: list | None = None) -> int:
        """Parse one packet header; record body spans on each block.

        br is positioned at the packet header.  body_base is the offset
        of this packet's body within the enclosing buffer; seq, a
        one-element list, numbers the chunks in parse order.  Returns
        the body length; br is aligned past the header."""
        if not br.read_bit():           # empty packet
            br.align()
            return 0
        incls, imsbs, dblocks = self._dec()
        body_len = 0
        for band_i, (_orient, bp) in enumerate(self.bands):
            incl, imsb = incls[band_i], imsbs[band_i]
            for cblk_i, geo in enumerate(bp.cblks):
                st = dblocks[band_i][cblk_i]
                x, y = geo.idx_in_prec
                if not st.included:
                    included_now = incl.decode(br, x, y, layer + 1)
                else:
                    included_now = bool(br.read_bit())
                if not included_now:
                    continue
                if not st.included:
                    # zero-bitplane count: probe with rising thresholds
                    k = 1
                    while not imsb.decode(br, x, y, k):
                        k += 1
                    st.zb = imsb.leaf_value(x, y)
                    st.included = True
                newpasses = read_numpasses(br)
                # comma code -> lblock increase
                while br.read_bit():
                    st.lblock += 1
                # distribute the new passes over codeword segments
                remaining = newpasses
                while remaining > 0:
                    if not st.segs:
                        st.segs.append(SegState())
                    segno = len(st.segs) - 1
                    cap = max_seg_passes(self.style, segno) - \
                        st.segs[-1].numpasses
                    if cap <= 0:
                        st.segs.append(SegState())
                        continue
                    k = min(cap, remaining)
                    seg_len = br.read_bits(st.lblock + floorlog2(k))
                    st.segs[-1].length += seg_len
                    st.segs[-1].numpasses += k
                    n = 0
                    if seq is not None:
                        n = seq[0]
                        seq[0] += 1
                    st.chunks.append(Chunk(layer=layer, segno=segno,
                                           numpasses=k,
                                           offset=body_base + body_len,
                                           length=seg_len, seq=n))
                    body_len += seg_len
                    remaining -= k
                st.numpasses += newpasses
        br.align()
        return body_len
