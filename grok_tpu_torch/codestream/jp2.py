"""JP2 container box parse/emit (ISO/IEC 15444-1 Annex I): the port's
copy of grok_tpu/codestream/jp2.py.

Boxes: jP (signature), ftyp, jp2h (ihdr, bpcc, colr, pclr, cmap, cdef, res),
jp2c (codestream), uuid, xml.  The device entry points only locate the
codestream (`locate_codestream`); palette, channel definitions and the
ICC profile apply to the host Image that codec.py Decompressor.decompress
and the CLI tools return (pipeline/postproc.py).

Reference parity: [grok: src/lib/core/codestream/FileFormat*.cpp] — behavior
normative per Annex I.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from grok_tpu_torch.codestream.j2k import CodestreamError
from grok_tpu_torch.core.image import ColorSpace

JP2_SIGNATURE = bytes.fromhex("0000000C6A5020200D0A870A")

# enumerated color spaces (I.5.3.3)
ENUM_SRGB = 16
ENUM_GRAY = 17
ENUM_SYCC = 18
ENUM_EYCC = 24
ENUM_CMYK = 12

_ENUM_TO_CS = {ENUM_SRGB: ColorSpace.SRGB, ENUM_GRAY: ColorSpace.GRAY,
               ENUM_SYCC: ColorSpace.SYCC, ENUM_EYCC: ColorSpace.EYCC,
               ENUM_CMYK: ColorSpace.CMYK}
_CS_TO_ENUM = {v: k for k, v in _ENUM_TO_CS.items()}


class JP2Error(ValueError):
    pass


@dataclass
class PaletteBox:
    entries: list[list[int]]          # NE rows x NPC columns
    bit_depths: list[int]             # per generated channel
    sgnd: list[bool]


@dataclass
class ComponentMapping:
    comp: int
    typ: int        # 0 = direct, 1 = palette
    pcol: int


@dataclass
class ChannelDef:
    channel: int
    typ: int        # 0 = color, 1 = opacity, 2 = premul opacity
    assoc: int


@dataclass
class JP2Meta:
    color_space: ColorSpace = ColorSpace.UNSPECIFIED
    icc_profile: bytes | None = None
    palette: PaletteBox | None = None
    cmap: list[ComponentMapping] = field(default_factory=list)
    cdef: list[ChannelDef] = field(default_factory=list)
    capture_resolution: tuple[float, float] | None = None
    display_resolution: tuple[float, float] | None = None
    xml: list[bytes] = field(default_factory=list)
    uuids: list[tuple[bytes, bytes]] = field(default_factory=list)
    width: int = 0
    height: int = 0
    numcomps: int = 0
    bpc: int = 0          # ihdr BPC field (0xFF = varies -> bpcc)
    bpcc: list[int] = field(default_factory=list)


def _box(tag: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload) + 8) + tag + payload


def _res_payload(res: tuple[float, float]) -> bytes:
    """(vertical, horizontal) px/meter as rational * 10^exp."""
    out = b""
    for v in res:
        num, den, ex = int(round(v * 100)), 100, 0
        while num and num % 10 == 0 and den % 10 == 0:
            num //= 10
            den //= 10
        out += struct.pack(">HH", num & 0xFFFF, den)
    out += struct.pack(">bb", 0, 0)
    return out


def wrap_jp2(codestream: bytes, *, width: int, height: int, numcomps: int,
             prec: int, sgnd: bool = False,
             color_space: ColorSpace = ColorSpace.UNSPECIFIED,
             icc_profile: bytes | None = None,
             capture_resolution: tuple[float, float] | None = None,
             per_comp_prec: list[tuple[int, bool]] | None = None) -> bytes:
    """Wrap a raw J2K codestream in a minimal JP2 file."""
    ftyp = _box(b"ftyp", b"jp2 " + struct.pack(">I", 0) + b"jp2 ")
    mixed = per_comp_prec is not None and len(set(per_comp_prec)) > 1
    bpc = 0xFF if mixed else ((prec - 1) | (0x80 if sgnd else 0))
    ihdr = _box(b"ihdr", struct.pack(">IIHBBBB", height, width, numcomps,
                                     bpc, 7, 0, 0))
    boxes = ihdr
    if mixed:
        bpcc = bytes(((p - 1) | (0x80 if s else 0)) for (p, s) in per_comp_prec)
        boxes += _box(b"bpcc", bpcc)
    if icc_profile is not None:
        boxes += _box(b"colr", struct.pack(">BBB", 2, 0, 0) + icc_profile)
    else:
        enum = _CS_TO_ENUM.get(
            color_space,
            ENUM_GRAY if numcomps <= 2 else ENUM_SRGB)
        boxes += _box(b"colr", struct.pack(">BBBI", 1, 0, 0, enum))
    if numcomps in (2, 4):
        # trailing component is alpha: signal colour channels + opacity
        ncol = numcomps - 1
        payload = struct.pack(">H", numcomps)
        for ch in range(ncol):
            payload += struct.pack(">HHH", ch, 0, ch + 1)
        payload += struct.pack(">HHH", ncol, 1, 0)
        boxes += _box(b"cdef", payload)
    if capture_resolution is not None:
        boxes += _box(b"res ", _box(b"resc", _res_payload(capture_resolution)))
    jp2h = _box(b"jp2h", boxes)
    return JP2_SIGNATURE + ftyp + jp2h + _box(b"jp2c", codestream)


def is_jp2(data: bytes) -> bool:
    return data[:12] == JP2_SIGNATURE


def is_j2k(data: bytes) -> bool:
    return data[:2] == b"\xff\x4f"


def _iter_boxes(data: bytes, pos: int, end: int, permissive: bool = False):
    while pos + 8 <= end:
        ln = struct.unpack(">I", data[pos:pos + 4])[0]
        tag = data[pos + 4:pos + 8]
        body_start = pos + 8
        if ln == 1:
            ln = struct.unpack(">Q", data[pos + 8:pos + 16])[0]
            body_start = pos + 16
        elif ln == 0:
            ln = end - pos
        if ln < 8 or pos + ln > end:
            if permissive and ln >= 8:
                # truncated file: yield what is present and stop
                yield tag, body_start, end
                return
            raise JP2Error(f"bad box length {ln} for {tag!r}")
        yield tag, body_start, pos + ln
        pos += ln


def _parse_jp2h(data: bytes, start: int, end: int, meta: JP2Meta):
    for tag, s, e in _iter_boxes(data, start, end):
        body = data[s:e]
        if tag == b"ihdr":
            h, w, nc, bpc, _c, _unkc, _ipr = struct.unpack(">IIHBBBB", body[:14])
            meta.height, meta.width, meta.numcomps, meta.bpc = h, w, nc, bpc
        elif tag == b"bpcc":
            meta.bpcc = list(body)
        elif tag == b"colr":
            meth, _prec, _approx = body[0], body[1], body[2]
            if meth == 1:
                enum = struct.unpack(">I", body[3:7])[0]
                meta.color_space = _ENUM_TO_CS.get(enum,
                                                   ColorSpace.UNSPECIFIED)
            elif meth == 2 and meta.icc_profile is None:
                meta.icc_profile = body[3:]
        elif tag == b"pclr":
            ne, npc = struct.unpack(">HB", body[:3])
            depths = list(body[3:3 + npc])
            bit_depths = [(d & 0x7F) + 1 for d in depths]
            sgnd = [bool(d & 0x80) for d in depths]
            pos = 3 + npc
            entries = []
            for _ in range(ne):
                row = []
                for c in range(npc):
                    nb = (bit_depths[c] + 7) // 8
                    v = int.from_bytes(body[pos:pos + nb], "big")
                    pos += nb
                    row.append(v)
                entries.append(row)
            meta.palette = PaletteBox(entries=entries, bit_depths=bit_depths,
                                      sgnd=sgnd)
        elif tag == b"cmap":
            for i in range(0, len(body), 4):
                cmp_, typ, pcol = struct.unpack(">HBB", body[i:i + 4])
                meta.cmap.append(ComponentMapping(comp=cmp_, typ=typ,
                                                  pcol=pcol))
        elif tag == b"cdef":
            n = struct.unpack(">H", body[:2])[0]
            for i in range(n):
                ch, typ, assoc = struct.unpack(
                    ">HHH", body[2 + 6 * i:8 + 6 * i])
                meta.cdef.append(ChannelDef(channel=ch, typ=typ, assoc=assoc))
        elif tag == b"res ":
            for rtag, rs, re_ in _iter_boxes(data, s, e):
                vals = struct.unpack(">HHHHbb", data[rs:rs + 10])
                vr = vals[0] / max(vals[1], 1) * 10.0 ** vals[4]
                hr = vals[2] / max(vals[3], 1) * 10.0 ** vals[5]
                if rtag == b"resc":
                    meta.capture_resolution = (vr, hr)
                elif rtag == b"resd":
                    meta.display_resolution = (vr, hr)


def parse_jp2(data: bytes,
              permissive: bool = False) -> tuple[int, int, JP2Meta]:
    """Locate the codestream inside a JP2 file.

    Returns (codestream_start, codestream_end, meta).  With permissive,
    a truncated final box (usually jp2c) is clamped to the file end so
    partial files still decode what is present.
    """
    if not is_jp2(data):
        raise JP2Error("not a JP2 file (bad signature box)")
    meta = JP2Meta()
    cs_span = None
    for tag, s, e in _iter_boxes(data, 12, len(data), permissive):
        if tag == b"ftyp":
            if data[s:s + 4] not in (b"jp2 ", b"jpx ", b"jph "):
                raise JP2Error(f"unsupported brand {data[s:s+4]!r}")
        elif tag == b"jp2h":
            _parse_jp2h(data, s, e, meta)
        elif tag == b"jp2c":
            cs_span = (s, e)
            break   # first codestream wins
        elif tag == b"xml ":
            meta.xml.append(data[s:e])
        elif tag == b"uuid":
            meta.uuids.append((data[s:s + 16], data[s + 16:e]))
    if cs_span is None:
        raise JP2Error("no jp2c codestream box found")
    return cs_span[0], cs_span[1], meta


def locate_codestream(data, permissive: bool = False):
    """The J2K codestream of `data`, a raw codestream or a JP2 file
    (grok_tpu/api.py `_locate_codestream`): a slice for JP2, a
    memoryview slice for buffer sources."""
    if is_jp2(data):
        s, e, _meta = parse_jp2(data, permissive)
        if isinstance(data, (bytes, bytearray)):
            return data[s:e]
        return memoryview(data)[s:e]
    if is_j2k(data):
        return data
    raise CodestreamError("not a JPEG 2000 codestream or JP2 file")
