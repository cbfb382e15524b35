"""J2K codestream marker parse/emit (ISO/IEC 15444-1 Annex A).

The port's copy of grok_tpu/codestream/j2k.py.  The readers are whole:
main-header and tile-part-header state machines for SOC SIZ COD COC QCD
QCC RGN POC COM CAP TLM PLM PLT PPM PPT SOT SOD EOC, with error recovery
on truncated streams (strict=False), so that the serving decode sees
every marker it must refuse.  The writers are those the encode emits:
SIZ CAP COD QCD QCC RGN POC COM TLM PLM PPM SOT PLT and the custom MCT's
MCT MCC MCO.

Reference parity: [grok: src/lib/core/codestream/CodeStreamCompress.cpp,
CodeStreamDecompress.cpp, codestream/markers/*] — behavior normative per
Annex A; structure is our own.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from grok_tpu_torch.core.geometry import SizGrid
from grok_tpu_torch.core.params import Poc, ProgOrder
from grok_tpu_torch.core.quant import (QSTYLE_DERIVED, QSTYLE_EXPOUNDED,
                                       QSTYLE_NONE, StepSize)

# -- marker codes ------------------------------------------------------------
SOC = 0xFF4F
SIZ = 0xFF51
COD = 0xFF52
COC = 0xFF53
TLM = 0xFF55
PLM = 0xFF57
PLT = 0xFF58
CPF = 0xFF59
QCD = 0xFF5C
QCC = 0xFF5D
RGN = 0xFF5E
POC = 0xFF5F
PPM = 0xFF60
PPT = 0xFF61
CRG = 0xFF63
COM = 0xFF64
MCT = 0xFF74
MCC = 0xFF75
MCO = 0xFF77
CAP = 0xFF50
SOT = 0xFF90
SOP = 0xFF91
EPH = 0xFF92
SOD = 0xFF93
EOC = 0xFFD9

_MARKER_NAMES = {
    SOC: "SOC", SIZ: "SIZ", COD: "COD", COC: "COC", TLM: "TLM", PLM: "PLM",
    PLT: "PLT", CPF: "CPF", QCD: "QCD", QCC: "QCC", RGN: "RGN", POC: "POC",
    PPM: "PPM", PPT: "PPT", CRG: "CRG", COM: "COM", CAP: "CAP", SOT: "SOT",
    MCT: "MCT", MCC: "MCC", MCO: "MCO",
    SOP: "SOP", EPH: "EPH", SOD: "SOD", EOC: "EOC",
}


def marker_name(code: int) -> str:
    return _MARKER_NAMES.get(code, f"0x{code:04X}")


class CodestreamError(ValueError):
    pass


# -- header state ------------------------------------------------------------

@dataclass
class CompInfo:
    prec: int
    sgnd: bool
    dx: int
    dy: int


@dataclass
class CodingStyleComp:
    """SPcod/SPcoc contents for one component."""

    num_resolutions: int = 6
    cblk_w_exp: int = 6
    cblk_h_exp: int = 6
    cblk_style: int = 0
    irreversible: bool = False
    prec_exps: list[tuple[int, int]] | None = None    # per-res (PPx, PPy)


@dataclass
class CodingStyle:
    """COD contents."""

    prog_order: ProgOrder = ProgOrder.LRCP
    num_layers: int = 1
    mct: int = 0
    sop: bool = False
    eph: bool = False
    comp: CodingStyleComp = field(default_factory=CodingStyleComp)


@dataclass
class QuantStyle:
    style: int = QSTYLE_NONE
    guard_bits: int = 2
    steps: list[StepSize] = field(default_factory=list)


@dataclass
class TilePartInfo:
    tile_index: int
    part_index: int
    num_parts: int          # 0 = unknown
    header_start: int       # offset of the SOT marker
    data_start: int         # offset just past SOD
    data_end: int           # header_start + Psot (or stream end)


@dataclass
class MainHeader:
    siz: SizGrid = None
    rsiz: int = 0
    comps: list[CompInfo] = field(default_factory=list)
    cod: CodingStyle = field(default_factory=CodingStyle)
    coc: dict[int, CodingStyleComp] = field(default_factory=dict)
    qcd: QuantStyle = field(default_factory=QuantStyle)
    qcc: dict[int, QuantStyle] = field(default_factory=dict)
    rgn: dict[int, int] = field(default_factory=dict)     # comp -> ROI shift
    pocs: list[Poc] = field(default_factory=list)
    comments: list[tuple[int, bytes]] = field(default_factory=list)
    cap: tuple[int, list[int]] | None = None              # (Pcap, Scap list)
    custom_mct: object = None        # (N, N) float64 forward decorrelation
    tlm: list[tuple[int, int]] = field(default_factory=list)  # (tile, length)
    plm: list[list[int]] = field(default_factory=list)  # per-part pkt lens
    crg: list[tuple[int, int]] = field(default_factory=list)  # (Xcrg, Ycrg)
    ppm: bytes | None = None
    main_header_end: int = 0

    def ht_planes_ext(self) -> int:
        """Global HT cleanup-plane extension P (0 = standard framing):
        ht_planes >= 1 encodes signal P once as a COM marker
        'GRKTPU_HTP=<P>'; the per-block plane is then min(P, numbps-1)
        (t1ht/scalar.py derive_p).  Standard readers skip the COM."""
        for _reg, data in self.comments:
            if data.startswith(b"GRKTPU_HTP="):
                try:
                    return max(0, int(data[11:]))
                except ValueError:
                    return 0
        return 0

    @property
    def numcomps(self) -> int:
        return len(self.comps)

    def style_for(self, comp: int, tile_coc: dict | None = None,
                  tile_cod: CodingStyle | None = None) -> CodingStyleComp:
        cod = tile_cod or self.cod
        coc = dict(self.coc)
        if tile_coc:
            coc.update(tile_coc)
        return coc.get(comp, cod.comp)

    def quant_for(self, comp: int, tile_qcc: dict | None = None,
                  tile_qcd: QuantStyle | None = None) -> QuantStyle:
        qcd = tile_qcd or self.qcd
        qcc = dict(self.qcc)
        if tile_qcc:
            qcc.update(tile_qcc)
        return qcc.get(comp, qcd)


@dataclass
class TileHeader:
    """Per-tile overrides accumulated from tile-part headers."""

    cod: CodingStyle | None = None
    coc: dict[int, CodingStyleComp] = field(default_factory=dict)
    qcd: QuantStyle | None = None
    qcc: dict[int, QuantStyle] = field(default_factory=dict)
    rgn: dict[int, int] = field(default_factory=dict)
    pocs: list[Poc] = field(default_factory=list)
    ppt: bytes | None = None
    plt: list[int] = field(default_factory=list)
    comments: list[tuple[int, bytes]] = field(default_factory=list)

    def ht_mixed_bitmap(self) -> bytes | None:
        """Per-block coder bitmap of the HT MIXED extension (round 4):
        a binary COM 'GRKTPU_HTMIX=<bitmap>' in the tile-part header;
        bit i (LSB-first within bytes) of the canonical block
        enumeration (comp, res, band, precinct, cblk — tile.py
        canon_block_indices) selects the HT coder for that block, else
        Part-1 MQ.  Standard readers skip the COM.  Mirrors the
        reference's mixed HT set support [grok: HTJ2K mixed code-block
        styles] with our extension signaling (CAP Ccap15 bit 5 is also
        set; see docs/WIRE_AUDIT.md)."""
        for _reg, data in self.comments:
            if data.startswith(b"GRKTPU_HTMIX="):
                return data[13:]
        return None


# -- segment writers ----------------------------------------------------------

def _seg(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def write_siz(siz: SizGrid, rsiz: int, comps: list[CompInfo]) -> bytes:
    g = siz.normalized()
    payload = struct.pack(">HIIIIIIII H", rsiz, g.xsiz, g.ysiz, g.xosiz,
                          g.yosiz, g.xtsiz, g.ytsiz, g.xtosiz, g.ytosiz,
                          len(comps))
    for c in comps:
        ssiz = (c.prec - 1) | (0x80 if c.sgnd else 0)
        payload += struct.pack(">BBB", ssiz, c.dx, c.dy)
    return _seg(SIZ, payload)


def _spcod(cs: CodingStyleComp) -> bytes:
    b = struct.pack(">BBBBB", cs.num_resolutions - 1, cs.cblk_w_exp - 2,
                    cs.cblk_h_exp - 2, cs.cblk_style,
                    0 if cs.irreversible else 1)
    if cs.prec_exps is not None:
        for (px, py) in cs.prec_exps[:cs.num_resolutions]:
            b += struct.pack(">B", (px & 0xF) | ((py & 0xF) << 4))
    return b


def write_cod(cod: CodingStyle) -> bytes:
    scod = ((1 if cod.comp.prec_exps is not None else 0)
            | (2 if cod.sop else 0) | (4 if cod.eph else 0))
    payload = struct.pack(">BBHB", scod, int(cod.prog_order), cod.num_layers,
                          cod.mct)
    payload += _spcod(cod.comp)
    return _seg(COD, payload)


def _sqcd_payload(q: QuantStyle) -> bytes:
    sqcd = (q.style & 0x1F) | (q.guard_bits << 5)
    b = struct.pack(">B", sqcd)
    if q.style == QSTYLE_NONE:
        for s in q.steps:
            b += struct.pack(">B", (s.expn & 0x1F) << 3)
    elif q.style == QSTYLE_DERIVED:
        s = q.steps[0]
        b += struct.pack(">H", ((s.expn & 0x1F) << 11) | (s.mant & 0x7FF))
    else:
        for s in q.steps:
            b += struct.pack(">H", ((s.expn & 0x1F) << 11) | (s.mant & 0x7FF))
    return b


def write_qcd(q: QuantStyle) -> bytes:
    return _seg(QCD, _sqcd_payload(q))


def write_qcc(comp: int, numcomps: int, q: QuantStyle) -> bytes:
    head = (struct.pack(">B", comp) if numcomps < 257
            else struct.pack(">H", comp))
    return _seg(QCC, head + _sqcd_payload(q))


def write_rgn(comp: int, numcomps: int, shift: int) -> bytes:
    head = (struct.pack(">B", comp) if numcomps < 257
            else struct.pack(">H", comp))
    return _seg(RGN, head + struct.pack(">BB", 0, shift))


def write_poc(pocs: list[Poc], numcomps: int) -> bytes:
    payload = b""
    for p in pocs:
        payload += struct.pack(">B", p.rs)
        payload += (struct.pack(">B", p.cs) if numcomps < 257
                    else struct.pack(">H", p.cs))
        payload += struct.pack(">HB", p.layer_end, p.re)
        payload += (struct.pack(">B", p.ce) if numcomps < 257
                    else struct.pack(">H", p.ce))
        payload += struct.pack(">B", int(p.order))
    return _seg(POC, payload)


def write_com(text: str | bytes, binary: bool = False) -> bytes:
    data = text.encode("latin-1") if isinstance(text, str) else bytes(text)
    return _seg(COM, struct.pack(">H", 0 if binary else 1) + data)


def write_mct_set(matrix) -> bytes:
    """Part-2 custom MCT: one f64 decorrelation array (MCT), one component
    collection binding all components (MCC), one ordering (MCO), as
    read_main_header reads them back.  Array index 1, collection index
    0."""
    import numpy as np
    m = np.asarray(matrix, dtype=">f8")
    n = m.shape[0]
    # MCT: Zmct=0, Imct = index 1 | type DECORRELATION(1)<<8 | f64(3)<<10,
    # Ymct=0, data
    imct = 1 | (1 << 8) | (3 << 10)
    out = _seg(MCT, struct.pack(">HHH", 0, imct, 0) + m.tobytes())
    # MCC: Zmcc=0, Imcc=0, Ymcc=0, Qmcc=1; collection: type 1 (matrix
    # decorrelation), Nmccin comps in, the comp indices, Nmccout + indices,
    # Tmcc = decorrelation array index (1) | offset array (0)
    pl = struct.pack(">HBHH", 0, 0, 0, 1)
    pl += struct.pack(">B", 1)
    pl += struct.pack(">H", n) + b"".join(struct.pack(">B", c)
                                          for c in range(n))
    pl += struct.pack(">H", n) + b"".join(struct.pack(">B", c)
                                          for c in range(n))
    pl += struct.pack(">BBB", 1, 0, 0)
    out += _seg(MCC, pl)
    # MCO: one stage, collection 0
    out += _seg(MCO, struct.pack(">BB", 1, 0))
    return out


def write_cap(pcap: int, scaps: list[int]) -> bytes:
    payload = struct.pack(">I", pcap)
    for s in scaps:
        payload += struct.pack(">H", s)
    return _seg(CAP, payload)


def write_sot(tile_index: int, psot: int, part_index: int,
              num_parts: int) -> bytes:
    return struct.pack(">HHHIBB", SOT, 10, tile_index, psot, part_index,
                       num_parts)


def write_tlm(entries: list[tuple[int, int]], ztlm: int = 0) -> bytes:
    """entries: (tile_index, tile_part_length). ST=2, SP=1 (4-byte lengths)."""
    stlm = (2 << 4) | (1 << 6)
    payload = struct.pack(">BB", ztlm, stlm)
    for (t, ln) in entries:
        payload += struct.pack(">HI", t, ln)
    return _seg(TLM, payload)


def write_plt(lengths: list[int], zplt: int = 0) -> bytes:
    payload = struct.pack(">B", zplt)
    for ln in lengths:
        chunks = []
        v = ln
        chunks.append(v & 0x7F)
        v >>= 7
        while v:
            chunks.append((v & 0x7F) | 0x80)
            v >>= 7
        payload += bytes(reversed(chunks))
    return _seg(PLT, payload)


def write_plm(per_part_lengths: list[list[int]], zplm: int = 0) -> bytes:
    """PLM (A.4.6): packet lengths in the MAIN header, one Nplm-prefixed
    varint list per tile-part in stream order.  Returns b"" when any
    tile-part's list exceeds the 255-byte Nplm field (caller falls back
    to PLT / no index)."""
    payload = struct.pack(">B", zplm)
    for lens in per_part_lengths:
        blob = b""
        for ln in lens:
            chunks = [ln & 0x7F]
            v = ln >> 7
            while v:
                chunks.append((v & 0x7F) | 0x80)
                v >>= 7
            blob += bytes(reversed(chunks))
        if len(blob) > 255:
            return b""
        payload += struct.pack(">B", len(blob)) + blob
    if len(payload) + 4 > 65535:
        return b""
    return _seg(PLM, payload)


def write_ppm(chunks: list[bytes]) -> bytes:
    """PPM (A.7.4): the packed packet headers in the main header, one
    Nppm-prefixed blob per tile in stream order, in one segment (Zppm 0),
    as grok_tpu/api.py `_main_header_bytes` writes it."""
    payload = bytearray(struct.pack(">B", 0))
    for chunk in chunks:
        payload += struct.pack(">I", len(chunk)) + chunk
    return struct.pack(">HH", PPM, len(payload) + 2) + payload


# -- segment readers ----------------------------------------------------------

class Reader:
    """Byte cursor with big-endian helpers."""

    __slots__ = ("data", "pos", "end")

    def __init__(self, data: bytes, pos: int = 0, end: int | None = None):
        self.data = data
        self.pos = pos
        self.end = len(data) if end is None else end

    def u8(self) -> int:
        if self.pos >= self.end:
            raise CodestreamError("unexpected end of codestream")
        v = self.data[self.pos]
        self.pos += 1
        return v

    def u16(self) -> int:
        return (self.u8() << 8) | self.u8()

    def u32(self) -> int:
        return (self.u16() << 16) | self.u16()

    def take(self, n: int) -> bytes:
        if self.pos + n > self.end:
            raise CodestreamError("unexpected end of codestream")
        v = self.data[self.pos:self.pos + n]
        self.pos += n
        # zero-copy sources (memoryview over a mapped JP2) slice to
        # memoryview; segment consumers expect real bytes (startswith,
        # concatenation) and segments are small — copy here only
        return v if isinstance(v, bytes) else bytes(v)

    @property
    def remaining(self) -> int:
        return self.end - self.pos


def _read_spcod(r: Reader, scod_has_prec: bool) -> CodingStyleComp:
    numres = r.u8() + 1
    cw = r.u8() + 2
    ch = r.u8() + 2
    style = r.u8()
    transform = r.u8()
    cs = CodingStyleComp(num_resolutions=numres, cblk_w_exp=cw, cblk_h_exp=ch,
                         cblk_style=style, irreversible=(transform == 0))
    if scod_has_prec:
        exps = []
        for _ in range(numres):
            b = r.u8()
            exps.append((b & 0xF, (b >> 4) & 0xF))
        cs.prec_exps = exps
    return cs


def _read_cod(r: Reader) -> CodingStyle:
    scod = r.u8()
    prog = ProgOrder(r.u8())
    layers = r.u16()
    mct = r.u8()
    comp = _read_spcod(r, bool(scod & 1))
    return CodingStyle(prog_order=prog, num_layers=layers, mct=mct,
                       sop=bool(scod & 2), eph=bool(scod & 4), comp=comp)


def _read_coc(r: Reader, numcomps: int) -> tuple[int, CodingStyleComp]:
    comp = r.u8() if numcomps < 257 else r.u16()
    scoc = r.u8()
    return comp, _read_spcod(r, bool(scoc & 1))


def _read_sqcd(r: Reader, nbytes: int) -> QuantStyle:
    sqcd = r.u8()
    style = sqcd & 0x1F
    guard = sqcd >> 5
    steps: list[StepSize] = []
    body = nbytes - 1
    if style == QSTYLE_NONE:
        for _ in range(body):
            steps.append(StepSize(expn=r.u8() >> 3, mant=0))
    elif style == QSTYLE_DERIVED:
        v = r.u16()
        steps.append(StepSize(expn=v >> 11, mant=v & 0x7FF))
    elif style == QSTYLE_EXPOUNDED:
        for _ in range(body // 2):
            v = r.u16()
            steps.append(StepSize(expn=v >> 11, mant=v & 0x7FF))
    else:
        raise CodestreamError(f"unknown quantization style {style}")
    return QuantStyle(style=style, guard_bits=guard, steps=steps)


def _read_poc(r: Reader, numcomps: int, nbytes: int) -> list[Poc]:
    entry = 5 + (2 if numcomps >= 257 else 1) * 2
    out = []
    for _ in range(nbytes // entry):
        rs = r.u8()
        cs = r.u8() if numcomps < 257 else r.u16()
        ly = r.u16()
        re = r.u8()
        ce = r.u8() if numcomps < 257 else r.u16()
        out.append(Poc(rs=rs, cs=cs, layer_end=ly, re=re, ce=ce,
                       order=ProgOrder(r.u8())))
    return out


def _read_plm(r: Reader, nbytes: int) -> list[list[int]]:
    """Parse one PLM segment -> per-tile-part packet-length lists."""
    r.u8()  # Zplm
    consumed = 1
    out: list[list[int]] = []
    while consumed < nbytes:
        n = r.u8()
        consumed += 1 + n
        lens: list[int] = []
        v = 0
        for _ in range(n):
            byte = r.u8()
            v = (v << 7) | (byte & 0x7F)
            if not (byte & 0x80):
                lens.append(v)
                v = 0
        out.append(lens)
    return out


def _read_plt(r: Reader, nbytes: int) -> list[int]:
    r.u8()  # Zplt
    out = []
    v = 0
    for _ in range(nbytes - 1):
        b = r.u8()
        v = (v << 7) | (b & 0x7F)
        if not (b & 0x80):
            out.append(v)
            v = 0
    return out


def _read_tlm(r: Reader, nbytes: int) -> list[tuple[int, int]]:
    r.u8()  # Ztlm
    stlm = r.u8()
    st = (stlm >> 4) & 3
    sp = (stlm >> 6) & 1
    entry = st + (4 if sp else 2)
    out = []
    consumed = 2
    idx = 0
    while consumed + entry <= nbytes:
        if st == 0:
            t = idx
        elif st == 1:
            t = r.u8()
        else:
            t = r.u16()
        ln = r.u32() if sp else r.u16()
        out.append((t, ln))
        consumed += entry
        idx += 1
    return out


def read_main_header(data: bytes, start: int = 0) -> MainHeader:
    """Parse SOC..(first SOT) into a MainHeader."""
    r = Reader(data, start)
    if r.u16() != SOC:
        raise CodestreamError("missing SOC marker")
    hdr = MainHeader()
    while True:
        marker = r.u16()
        if marker == SOT:
            if hdr.siz is None:
                # found by the fuzz loop: a scrambled SIZ marker skips as
                # an unknown segment and decode later dereferences None
                raise CodestreamError("missing SIZ marker before SOT")
            hdr.main_header_end = r.pos - 2
            break
        if marker == EOC:
            raise CodestreamError("EOC before any tile data")
        if not (0xFF00 <= marker <= 0xFFFF):
            raise CodestreamError(f"bad marker 0x{marker:04X}")
        ln = r.u16()
        if r.pos + ln - 2 > len(r.data):
            raise CodestreamError(
                f"marker {marker_name(marker)} length {ln} exceeds "
                "available data (truncated codestream)")
        seg = Reader(r.data, r.pos, r.pos + ln - 2)
        r.pos += ln - 2
        if marker == SIZ:
            rsiz = seg.u16()
            xs, ys, xo, yo, xt, yt, xto, yto = (seg.u32() for _ in range(8))
            ncomp = seg.u16()
            comps = []
            for _ in range(ncomp):
                ssiz = seg.u8()
                prec = (ssiz & 0x7F) + 1
                if prec > 31:
                    # int32 coefficient pipeline bound (encode side caps
                    # at 27); found by the fuzz loop as an int64 overflow
                    raise CodestreamError(
                        f"unsupported component precision {prec}")
                dx, dy = seg.u8(), seg.u8()
                if dx < 1 or dy < 1:
                    # A.5.1: XRsiz/YRsiz in [1, 255] — a zero reaches
                    # the canvas division (fuzz: ZeroDivisionError)
                    raise CodestreamError(
                        f"invalid component subsampling {dx}x{dy}")
                comps.append(CompInfo(prec=prec,
                                      sgnd=bool(ssiz & 0x80),
                                      dx=dx, dy=dy))
            # A.5.1 geometry requirements + a decode-size guard (fuzz
            # finding: scrambled Xsiz/Ysiz provoked multi-GiB allocs)
            if not (xo < xs and yo < ys and xt > 0 and yt > 0
                    and xto <= xo and yto <= yo and ncomp > 0):
                raise CodestreamError("invalid SIZ geometry")
            import os as _os
            max_px = int(_os.environ.get("GROK_MAX_DECODE_PIXELS",
                                         1 << 31))
            if (xs - xo) * (ys - yo) * ncomp > max_px:
                raise CodestreamError(
                    f"image exceeds decode limit ({max_px} samples; "
                    "raise GROK_MAX_DECODE_PIXELS)")
            hdr.rsiz = rsiz
            hdr.siz = SizGrid(xs, ys, xo, yo, xt, yt, xto, yto)
            hdr.comps = comps
        elif marker == COD:
            hdr.cod = _read_cod(seg)
        elif marker == COC:
            c, cs = _read_coc(seg, hdr.numcomps)
            hdr.coc[c] = cs
        elif marker == QCD:
            hdr.qcd = _read_sqcd(seg, ln - 2)
        elif marker == QCC:
            c = seg.u8() if hdr.numcomps < 257 else seg.u16()
            used = 1 if hdr.numcomps < 257 else 2
            hdr.qcc[c] = _read_sqcd(seg, ln - 2 - used)
        elif marker == RGN:
            c = seg.u8() if hdr.numcomps < 257 else seg.u16()
            seg.u8()  # Srgn == 0 (implicit)
            hdr.rgn[c] = seg.u8()
        elif marker == POC:
            used = 0
            hdr.pocs += _read_poc(seg, hdr.numcomps, ln - 2)
        elif marker == COM:
            reg = seg.u16()
            hdr.comments.append((reg, seg.take(seg.remaining)))
        elif marker == CAP:
            pcap = seg.u32()
            scaps = [seg.u16() for _ in range(seg.remaining // 2)]
            hdr.cap = (pcap, scaps)
        elif marker == TLM:
            hdr.tlm += _read_tlm(seg, ln - 2)
        elif marker == PLM:
            hdr.plm += _read_plm(seg, ln - 2)
        elif marker == CRG:
            for _ in range((ln - 2) // 4):
                hdr.crg.append((seg.u16(), seg.u16()))
        elif marker == PPM:
            seg.u8()  # Zppm
            body = seg.take(seg.remaining)
            hdr.ppm = (hdr.ppm or b"") + body
        elif marker == MCT:
            import numpy as np
            seg.u16()            # Zmct (0: unsplit)
            imct = seg.u16()
            seg.u16()            # Ymct
            if (imct >> 8) & 3 == 1 and (imct >> 10) & 3 == 3:
                data = seg.take(seg.remaining)
                k = len(data) // 8
                n = int(round(k ** 0.5))
                if n * n == k:
                    hdr.custom_mct = np.frombuffer(
                        data, dtype=">f8").reshape(n, n).astype(float)
        # MCC/MCO: the single-collection layout written by write_mct_set
        # is implied by the MCT record; PLM, CRG, CPF, unknown: skipped
    return hdr


def tile_parts_from_tlm(data: bytes, hdr: MainHeader) \
        -> list[TilePartInfo] | None:
    """Tile-part framing seeded from the TLM marker (A.4.6): jump from
    part to part by signalled length instead of scanning, validating each
    landing point's SOT against the TLM entry.  Returns None (caller
    falls back to the scan) when TLM is absent or inconsistent — a TLM
    written by a buggy encoder must never poison the decode."""
    if not hdr.tlm:
        return None
    parts: list[TilePartInfo] = []
    pos = hdr.main_header_end
    n = len(data)
    for (t, ln) in hdr.tlm:
        if ln < 14 or pos + 12 > n:
            return None
        if struct.unpack(">H", data[pos:pos + 2])[0] != SOT:
            return None
        r = Reader(data, pos + 2)
        lsot = r.u16()
        isot = r.u16()
        psot = r.u32()
        tpsot = r.u8()
        tnsot = r.u8()
        if isot != t or (psot and psot != ln):
            return None
        hp = pos + 2 + lsot
        data_start = None
        while hp + 4 <= n:
            m = struct.unpack(">H", data[hp:hp + 2])[0]
            if m == SOD:
                data_start = hp + 2
                break
            hp += 2 + struct.unpack(">H", data[hp + 2:hp + 4])[0]
        if data_start is None:
            return None
        parts.append(TilePartInfo(tile_index=isot, part_index=tpsot,
                                  num_parts=tnsot, header_start=pos,
                                  data_start=data_start,
                                  data_end=min(pos + ln, n)))
        pos += ln
    # the signalled parts must tile the stream up to EOC
    if pos + 2 <= n and struct.unpack(">H", data[pos:pos + 2])[0] \
            not in (EOC, SOT):
        return None
    return parts


def read_tile_parts(data: bytes, hdr: MainHeader,
                    strict: bool = True) -> list[TilePartInfo]:
    """Tile-part framing: TLM-seeded jumps when the marker is present and
    consistent, else scan SOT..EOC without parsing bodies."""
    parts = tile_parts_from_tlm(data, hdr)
    if parts is not None:
        return parts
    parts: list[TilePartInfo] = []
    pos = hdr.main_header_end
    n = len(data)
    while pos + 2 <= n:
        marker = struct.unpack(">H", data[pos:pos + 2])[0]
        if marker == EOC:
            break
        if marker != SOT:
            if strict:
                raise CodestreamError(
                    f"expected SOT at {pos}, found {marker_name(marker)}")
            break
        r = Reader(data, pos + 2)
        lsot = r.u16()
        isot = r.u16()
        psot = r.u32()
        tpsot = r.u8()
        tnsot = r.u8()
        # find SOD by walking tile-part header markers
        hp = pos + 2 + lsot
        data_start = None
        while hp + 2 <= n:
            m = struct.unpack(">H", data[hp:hp + 2])[0]
            if m == SOD:
                data_start = hp + 2
                break
            ln = struct.unpack(">H", data[hp + 2:hp + 4])[0]
            hp += 2 + ln
        if data_start is None:
            if strict:
                raise CodestreamError("tile-part header without SOD")
            break
        data_end = pos + psot if psot else n
        data_end = min(data_end, n)
        parts.append(TilePartInfo(tile_index=isot, part_index=tpsot,
                                  num_parts=tnsot, header_start=pos,
                                  data_start=data_start, data_end=data_end))
        if psot == 0:
            break
        pos += psot
    return parts


def read_tile_part_header(data: bytes, part: TilePartInfo, hdr: MainHeader,
                          th: TileHeader) -> TileHeader:
    """Parse the marker segments between SOT and SOD into tile overrides."""
    r = Reader(data, part.header_start + 2)
    lsot = r.u16()
    r.pos = part.header_start + 2 + lsot
    while r.pos < part.data_start - 2:
        marker = r.u16()
        ln = r.u16()
        if r.pos + ln - 2 > len(r.data):
            raise CodestreamError(
                f"marker {marker_name(marker)} length {ln} exceeds "
                "available data (truncated tile-part header)")
        seg = Reader(r.data, r.pos, r.pos + ln - 2)
        r.pos += ln - 2
        if marker == COD:
            th.cod = _read_cod(seg)
        elif marker == COC:
            c, cs = _read_coc(seg, hdr.numcomps)
            th.coc[c] = cs
        elif marker == QCD:
            th.qcd = _read_sqcd(seg, ln - 2)
        elif marker == QCC:
            c = seg.u8() if hdr.numcomps < 257 else seg.u16()
            used = 1 if hdr.numcomps < 257 else 2
            th.qcc[c] = _read_sqcd(seg, ln - 2 - used)
        elif marker == RGN:
            c = seg.u8() if hdr.numcomps < 257 else seg.u16()
            seg.u8()
            th.rgn[c] = seg.u8()
        elif marker == POC:
            th.pocs += _read_poc(seg, hdr.numcomps, ln - 2)
        elif marker == PPT:
            seg.u8()  # Zppt
            th.ppt = (th.ppt or b"") + seg.take(seg.remaining)
        elif marker == PLT:
            th.plt += _read_plt(seg, ln - 2)
        elif marker == COM:
            reg = seg.u16()
            th.comments.append((reg, seg.take(seg.remaining)))
        # unknown: skip
    return th
