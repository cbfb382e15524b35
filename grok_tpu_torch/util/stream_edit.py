"""Codestream edits that make legal variants of a stream.

Used to build the streams that the JAX package's encoder does not write,
from ones it does, on the CPU and on the card alike:

  - `ppm_to_ppt`: the main header's PPM packed packet headers moved into
    PPT markers, one run per tile-part (A.7.4, A.7.5);
  - `move_to_tile_parts`: main-header COC, QCC, RGN and POC segments
    moved into the first tile-part header of every tile, where they mean
    what they meant in the main header;
  - `cut`, `flip`: a stream cut to a share of its bytes, and a stream
    with bytes inverted at an offset;
  - `or_cod_style`, `with_coc`: the COD's code-block style OR'd with
    mode-switch bits (HT code-blocks with Part-1 switches beside the HT
    bit), and a main-header COC giving one component its own style.

Each edit rewrites Psot of the tile-parts it grows and the main header's
TLM, so the result parses as a whole stream.
"""

from __future__ import annotations

import struct

from grok_tpu_torch.codestream import j2k

_TILE_MARKERS = (j2k.COC, j2k.QCC, j2k.RGN, j2k.POC)


def _segments(cs: bytes, pos: int, stop: int) -> tuple:
    """([(marker, whole segment bytes)], position of `stop`) from pos up
    to the first `stop` marker."""
    segs = []
    while True:
        m = struct.unpack_from(">H", cs, pos)[0]
        if m == stop:
            return segs, pos
        ln = struct.unpack_from(">H", cs, pos + 2)[0]
        segs.append((m, cs[pos:pos + 2 + ln]))
        pos += 2 + ln


def _split(cs: bytes) -> tuple:
    """(main header segments after SOC, [(SOT segment, tile-part header
    segments, data)], tail after the last tile-part)."""
    main, pos = _segments(cs, 2, j2k.SOT)
    parts = []
    while pos + 12 <= len(cs) and \
            struct.unpack_from(">H", cs, pos)[0] == j2k.SOT:
        psot = struct.unpack_from(">I", cs, pos + 6)[0]
        end = pos + psot if psot else len(cs) - 2
        segs, sod = _segments(cs, pos + 12, j2k.SOD)
        parts.append((cs[pos:pos + 12], segs, cs[sod + 2:end]))
        pos = end
    return main, parts, cs[pos:]


def _join(main: list, parts: list, tail: bytes) -> bytes:
    """Reassemble a stream from _split's pieces, with each tile-part's
    Psot and the TLM entries rewritten to the new tile-part sizes."""
    tps = []
    for sot, segs, data in parts:
        hdr = b"".join(s for _m, s in segs)
        psot = 12 + len(hdr) + 2 + len(data)
        old = struct.unpack_from(">I", sot, 6)[0]
        sot = sot[:6] + struct.pack(">I", psot if old else 0) + sot[10:]
        tps.append(sot + hdr + struct.pack(">H", j2k.SOD) + data)
    out = bytearray(struct.pack(">H", j2k.SOC))
    tlm_done = False
    for m, s in main:
        if m == j2k.TLM:
            if not tlm_done:
                out += j2k.write_tlm(
                    [(struct.unpack_from(">H", tp, 4)[0], len(tp))
                     for tp in tps])
                tlm_done = True
            continue
        out += s
    return bytes(out) + b"".join(tps) + tail


def ppm_to_ppt(data: bytes) -> bytes:
    """The same stream with its PPM packed headers in PPT markers: each
    tile-part's Nppm blob (stream order) becomes the PPT run of that
    tile-part's header, split into segments of at most 65,535 bytes."""
    main, parts, tail = _split(data)
    ppm = b"".join(s[5:] for m, s in main if m == j2k.PPM)
    if not ppm:
        raise ValueError("the stream has no PPM marker")
    r = j2k.Reader(ppm)
    out_parts = []
    for sot, segs, body in parts:
        blob = r.take(r.u32())
        ppts = []
        for z, k in enumerate(range(0, len(blob), 65532)):
            chunk = blob[k:k + 65532]
            ppts.append((j2k.PPT, struct.pack(">HHB", j2k.PPT,
                                              len(chunk) + 3, z) + chunk))
        out_parts.append((sot, segs + ppts, body))
    return _join([(m, s) for m, s in main if m != j2k.PPM], out_parts, tail)


def move_to_tile_parts(data: bytes,
                       markers: tuple = _TILE_MARKERS) -> bytes:
    """The same stream with the main header's segments of `markers`
    (COC, QCC, RGN, POC by default) moved into the first tile-part
    header of every tile."""
    main, parts, tail = _split(data)
    moved = [s for m, s in main if m in markers]
    if not moved:
        raise ValueError("the main header has none of those markers")
    kept = [(m, s) for m, s in main if m not in markers]
    out_parts = []
    for sot, segs, body in parts:
        if sot[10] == 0:                  # TPsot: the tile's first part
            segs = [(0, s) for s in moved] + segs
        out_parts.append((sot, segs, body))
    return _join(kept, out_parts, tail)


def cut(data: bytes, share: float) -> bytes:
    """The first int(share * len) bytes of a stream."""
    return data[:int(len(data) * share)]


def flip(data: bytes, offset: int, n: int = 4) -> bytes:
    """The stream with n bytes inverted from `offset` on."""
    mid = bytes(b ^ 0xFF for b in data[offset:offset + n])
    return data[:offset] + mid + data[offset + n:]


def or_cod_style(data: bytes, bits: int) -> bytes:
    """The stream with its main-header COD code-block style OR'd with
    `bits` (SPcod byte 4: the segment's 13th byte)."""
    main, parts, tail = _split(data)
    out = []
    for m, seg in main:
        if m == j2k.COD:
            seg = bytearray(seg)
            seg[12] |= bits
            seg = bytes(seg)
        out.append((m, seg))
    return _join(out, parts, tail)


def with_coc(data: bytes, comp: int, style: int) -> bytes:
    """The stream with a main-header COC after its COD for component
    `comp` (fewer than 257 components): the COD's decomposition levels,
    code-block size and filter, code-block style `style`, default
    precincts."""
    main, parts, tail = _split(data)
    out = []
    for m, seg in main:
        out.append((m, seg))
        if m == j2k.COD:
            sp = bytearray(seg[9:14])   # levels, xcb, ycb, style, filter
            sp[3] = style
            out.append((j2k.COC, struct.pack(">HHBB", j2k.COC, 4 + len(sp),
                                             comp, 0) + bytes(sp)))
    return _join(out, parts, tail)
