"""The Python Tier-2 packet parse of a tile (ISO/IEC 15444-1 B.10).

The port's copy of the packet loop of grok_tpu/pipeline/tile.py
`decode_tile`, the route the JAX package takes where its C parse
declines: packed packet headers (PPM merged per tile, or PPT), streams
cut short, and corrupt packets with SOP markers.  Packet by packet in
the plan's progression (the tile's POC, else the main header's):

  - with SOP, each in-body packet must open with its marker and the
    packet index mod 65536 (packed headers may carry SOP in the header
    buffer, skipped there);
  - the precinct's decoder state is snapshotted before a packet (with
    SOP in a permissive decode) and restored if the packet proves
    corrupt; the parse then resyncs on the next SOP marker (B.10.5), at
    the packet its Nsop names;
  - EPH after a header is consumed (a missing one raises only when
    strict);
  - a packet header, or a body, that runs past the data stops the parse
    in a permissive decode with the JAX package's warning, through
    `logging` (logger "grok_tpu_torch"): the blocks keep what was read,
    the last packet's chunks included unless a snapshot restored its
    precinct.  A strict decode raises instead.

`parse_packets` returns what native.t2_parse_prepared returns, in the
plan's global block order (context -> band -> code-block), so that the
staging downstream of the parse does not know which parse ran.
"""

from __future__ import annotations

import logging

import numpy as np

from grok_tpu_torch.codestream.bitio import BitReader

SOP_MARKER = b"\xff\x91"
EPH_MARKER = b"\xff\x92"

_log = logging.getLogger("grok_tpu_torch")


def parse_packets(body: bytes, plan, *, hdr_buf: bytes | None = None,
                  strict: bool = False) -> tuple:
    """Parse one tile's packet sequence.

    body: the tile's concatenated tile-part data (past SOD); plan: the
    tile's pipeline/plan.py ServePlan (its contexts and packet order);
    hdr_buf: the tile's packed packet headers (PPT, or the PPM blobs of
    its tile-parts), None when the headers are in the body.  Returns
    (incl int32 (n,), zb int32 (n,), npass int32 (n,), chunks int32
    (m, 6) [block, layer, segno, numpasses, offset in body, length] in
    parse order, end: the body offset after the last packet parsed)."""
    geo = plan.geo
    ctxs = geo.make_contexts(plan.seg_mask)
    keys = plan.ctx_keys
    pkt_ctx, pkt_layer = plan.prep[8], plan.prep[9]
    sop, eph = plan.sop, plan.eph
    use_ppt = hdr_buf is not None
    if not use_ppt:
        hdr_buf = body
    hdr_pos = 0
    body_pos = 0
    seq = [0]
    n_pk = len(pkt_ctx)
    pk_i = 0
    while pk_i < n_pk:
        key = keys[pkt_ctx[pk_i]]
        layer = int(pkt_layer[pk_i])
        pk_i += 1
        pkt_start = body_pos
        ctx = ctxs[key]
        snap = ctx.snapshot() if sop and not strict else None
        try:
            if not use_ppt:
                hdr_pos = body_pos
            if sop and not use_ppt:
                # SOP is per packet when signalled: a missing marker or a
                # sequence-number mismatch means sync was lost
                if hdr_buf[hdr_pos:hdr_pos + 2] != SOP_MARKER:
                    raise ValueError("expected SOP marker")
                nsop = (hdr_buf[hdr_pos + 4] << 8) | hdr_buf[hdr_pos + 5]
                if nsop != (pk_i - 1) % 65536:
                    raise ValueError("SOP sequence mismatch")
                hdr_pos += 6
                body_pos += 6
            elif sop and hdr_buf[hdr_pos:hdr_pos + 2] == SOP_MARKER:
                hdr_pos += 6
            br = BitReader(hdr_buf, hdr_pos)
            seq0 = seq[0]
            blen = ctx.decode_packet(br, layer, 0, seq)
            hdr_end = br.pos
            if eph:
                if hdr_buf[hdr_end:hdr_end + 2] != EPH_MARKER:
                    if strict:
                        raise ValueError("missing EPH marker")
                else:
                    hdr_end += 2
            if use_ppt:
                hdr_pos = hdr_end
                base = body_pos
            else:
                base = hdr_end
            # this packet's chunks were recorded relative to its body
            for bl in ctx.dblocks:
                for st in bl:
                    for chk in reversed(st.chunks):
                        if chk.seq < seq0:
                            break
                        chk.offset += base
            body_pos = base + blen
            if body_pos > len(body):
                raise EOFError("packet body past end of tile data")
        except (EOFError, IndexError, ValueError) as e:
            if strict:
                raise
            if snap is not None:
                ctx.restore(snap)
            if sop:
                # resync on the next SOP marker (B.10.5 error resilience):
                # its Nsop field tells which packet the stream resumes at
                nxt = body.find(SOP_MARKER, pkt_start + 2)
                if nxt >= 0 and nxt + 6 <= len(body):
                    nsop = (body[nxt + 4] << 8) | body[nxt + 5]
                    target = next((c for c in range(pk_i, n_pk)
                                   if c % 65536 == nsop), None)
                    if target is not None:
                        _log.warning(f"tile {geo.t}: corrupt packet "
                                     f"({type(e).__name__}); resync at SOP "
                                     f"#{nsop} (offset {nxt})")
                        body_pos = nxt
                        pk_i = target
                        continue
            _log.warning(f"tile {geo.t}: truncated/corrupt packet stream "
                         f"({type(e).__name__}); decoding what is present")
            break
    return _flatten(ctxs, keys, plan.n_blks) + (body_pos,)


def _flatten(ctxs: dict, keys: list, n_blks: int) -> tuple:
    """(incl, zb, npass, chunks) in the global block order."""
    incl = np.zeros(n_blks, np.int32)
    zb = np.zeros(n_blks, np.int32)
    npass = np.zeros(n_blks, np.int32)
    rows = []
    gi = 0
    for k in keys:
        ctx = ctxs[k]
        if ctx.dec is None:        # no packet of it was parsed
            gi += sum(len(bp.cblks) for _o, bp in ctx.bands)
            continue
        for bl in ctx.dblocks:
            for st in bl:
                incl[gi] = st.included
                zb[gi] = st.zb
                npass[gi] = st.numpasses
                rows += [(c.seq, gi, c.layer, c.segno, c.numpasses,
                          c.offset, c.length) for c in st.chunks]
                gi += 1
    rows.sort()
    chunks = np.asarray([r[1:] for r in rows], np.int32).reshape(-1, 6)
    return incl, zb, npass, chunks
