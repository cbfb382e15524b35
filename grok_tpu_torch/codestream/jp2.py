"""JP2 container boxes (ISO/IEC 15444-1 Annex I): what the port needs.

The port's copy of grok_tpu/codestream/jp2.py, trimmed to the encoder's
minimal wrapper (`wrap_jp2`) and to locating the codestream box of a JP2
file for the decoder (`locate_codestream`, `parse_jp2`).  The port
returns device-resident samples and applies no palette, channel
definition or colour metadata, so those boxes are skipped, not parsed.

Reference parity: [grok: src/lib/core/codestream/FileFormat*.cpp] — behavior
normative per Annex I.
"""

from __future__ import annotations

import struct

from grok_tpu_torch.codestream.j2k import CodestreamError
from grok_tpu_torch.core.image import ColorSpace

JP2_SIGNATURE = bytes.fromhex("0000000C6A5020200D0A870A")

# enumerated color spaces (I.5.3.3)
ENUM_SRGB = 16
ENUM_GRAY = 17
ENUM_SYCC = 18
ENUM_EYCC = 24
ENUM_CMYK = 12

_CS_TO_ENUM = {ColorSpace.SRGB: ENUM_SRGB, ColorSpace.GRAY: ENUM_GRAY,
               ColorSpace.SYCC: ENUM_SYCC, ColorSpace.EYCC: ENUM_EYCC,
               ColorSpace.CMYK: ENUM_CMYK}


class JP2Error(ValueError):
    pass


def _box(tag: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload) + 8) + tag + payload


def wrap_jp2(codestream: bytes, *, width: int, height: int, numcomps: int,
             prec: int, sgnd: bool = False,
             color_space: ColorSpace = ColorSpace.UNSPECIFIED) -> bytes:
    """Wrap a raw J2K codestream in a minimal JP2 file (all components
    share one precision and signedness)."""
    ftyp = _box(b"ftyp", b"jp2 " + struct.pack(">I", 0) + b"jp2 ")
    bpc = (prec - 1) | (0x80 if sgnd else 0)
    boxes = _box(b"ihdr", struct.pack(">IIHBBBB", height, width, numcomps,
                                      bpc, 7, 0, 0))
    enum = _CS_TO_ENUM.get(color_space,
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


def locate_codestream(data, permissive: bool = False):
    """The J2K codestream of `data`, a raw codestream or a JP2 file
    (grok_tpu/api.py `_locate_codestream`): a slice for JP2, a
    memoryview slice for buffer sources."""
    if is_jp2(data):
        s, e = parse_jp2(data, permissive)
        if isinstance(data, (bytes, bytearray)):
            return data[s:e]
        return memoryview(data)[s:e]
    if is_j2k(data):
        return data
    raise CodestreamError("not a JPEG 2000 codestream or JP2 file")


def parse_jp2(data: bytes, permissive: bool = False) -> tuple[int, int]:
    """Locate the codestream inside a JP2 file: (start, end).  With
    permissive, a truncated final box (usually jp2c) is clamped to the
    file end so partial files still decode what is present."""
    if not is_jp2(data):
        raise JP2Error("not a JP2 file (bad signature box)")
    for tag, s, e in _iter_boxes(data, 12, len(data), permissive):
        if tag == b"ftyp":
            if data[s:s + 4] not in (b"jp2 ", b"jpx ", b"jph "):
                raise JP2Error(f"unsupported brand {data[s:s+4]!r}")
        elif tag == b"jp2c":
            return s, e            # first codestream wins
    raise JP2Error("no jp2c codestream box found")
