"""Public surface of the PyTorch port: the device decode and encode, and
the top-level compress / decompress.

Mirrors grok_tpu/api.py `decompress_device[_batch]`,
`compress_device[_batch]`, `compress` (an Image whose components have
their own precision, signedness and subsampling) and `decompress` (to a
host Image, through codec.py Decompressor), single-tile and tiled
(encodes in one or more tile-parts per tile, with precincts, POC, PLT,
TLM, PLM, PPM and quality layers), decodes whole or in a window, of intact, cut
or corrupt streams, with packed headers, ROI, tile overrides or a
custom MCT.  The entry
points run on the CUDA card unless the caller asks for another device
(`device=`, "cuda" by default; a missing card raises, there is no CPU
fallback).
Decoded int32 component planes stay resident on the device; encodes take
device tensors (kept where they are) or numpy arrays (uploaded) and
return codestream bytes.  Streams or parameters outside the served scope
raise NotImplementedError instead of falling back to a host codec.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from grok_tpu_torch.codestream import j2k, jp2
from grok_tpu_torch.codestream.j2k import (CodingStyle, CodingStyleComp,
                                           CompInfo, MainHeader, QuantStyle,
                                           TileHeader)
from grok_tpu_torch.codestream.profiles import validate_profile
from grok_tpu_torch.core.geometry import Rect, SizGrid
from grok_tpu_torch.core.image import ColorSpace, Component, Image
from grok_tpu_torch.core.params import (CBLK_HT, CompressParams,
                                        DecompressParams, MCTMode)
from grok_tpu_torch.core.quant import StepSize, make_quantizer
from grok_tpu_torch.parallel.sharding import check_mesh
from grok_tpu_torch.pipeline.plan import _th_ovr_key
from grok_tpu_torch.pipeline.serve import (GeneralRoute, StagedBatch,
                                           stage_serving_batch,
                                           try_decode_serving_batch)
from grok_tpu_torch.pipeline.serve_enc import try_encode_serving_batch
from grok_tpu_torch.pipeline.tile import decode_tile, stage_general
from grok_tpu_torch.util.trace import count, trace


def _params(dparams: DecompressParams | None,
            dev: torch.device | None = None) -> DecompressParams:
    """The decode's parameters: permissive by default, like the JAX
    serving surfaces (the C scan validates framing, the kernel decodes
    payloads without validation), and the mesh held to the entry's
    device `dev`."""
    dp = dparams or DecompressParams()
    if dev is not None:
        check_mesh(dp.mesh, dev)
    return replace(dp, strict=False) if dp.strict is None else dp


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           f"available")
    return dev


def _main_header_packets(hdr, parts: list) -> tuple:
    """The main header's per-tile-part packet data, keyed on each
    tile-part's header offset, as grok_tpu/api.py `decompress` reads
    them: PPM (A.7.4), one Nppm-prefixed blob of packed packet headers
    per tile-part in stream order; PLM (A.4.6), one list of packet
    lengths per tile-part in stream order (kept where the counts
    agree)."""
    order = sorted(parts, key=lambda p: p.header_start)
    ppm: dict = {}
    if hdr.ppm is not None:
        r = j2k.Reader(hdr.ppm)
        for p in order:
            if r.remaining < 4:
                break
            n = r.u32()
            ppm[p.header_start] = r.take(min(n, r.remaining))
    plm: dict = {}
    if hdr.plm and len(hdr.plm) == len(order):
        plm = {p.header_start: lens for p, lens in zip(order, hdr.plm)}
    return ppm, plm


def _tile_body(cs, hdr, parts, ppm: dict | None = None,
               plm: dict | None = None, view: bool = False):
    """(tile header, body) of one tile from its tile-parts: the PPM blobs
    of its tile-parts become its packed headers (th.ppt) and their PLM
    lists its packet lengths (th.plt, where no PLT was given).  The body
    is the tile-parts' bodies joined into bytes; with `view`, a tile of
    one tile-part keeps its body as a memoryview of `cs`, with no
    copy."""
    th = TileHeader()
    chunks, packed, lens = [], [], []
    for p in sorted(parts, key=lambda p: p.part_index):
        j2k.read_tile_part_header(cs, p, hdr, th)
        chunks.append(memoryview(cs)[p.data_start:p.data_end])
        lens += (plm or {}).get(p.header_start, [])
        if ppm and p.header_start in ppm:
            packed.append(ppm[p.header_start])
    if not th.plt and lens:
        th.plt = lens
    if packed:
        th.ppt = b"".join(packed)
    if view and len(chunks) == 1:
        return th, chunks[0]
    return th, b"".join(chunks)


def _codestream(data, dp: DecompressParams):
    """The J2K codestream of `data`, a raw codestream or a JP2 file: the
    caller's object itself, or a memoryview of the JP2 file's
    codestream box (no copy)."""
    s, e, _meta = _locate_codestream_span(data, permissive=not dp.strict)
    return data if (s, e) == (0, len(data)) else memoryview(data)[s:e]


def stage_device_batch(streams: list[bytes],
                       dparams: DecompressParams | None = None, *,
                       device="cuda") -> StagedBatch:
    """Parse N same-geometry single-tile codestreams on the host and
    upload their staged batch to `device`; .run() on the result decodes
    it.  Raises GeneralRoute for what the batch entry takes stream by
    stream: several tiles, different main headers, tile-part COD/QCD,
    tile-part overrides and packed headers, and every stream the
    serving decode declines to the general route."""
    with trace("decode.stage"):
        dev = _device(device)
        dp = _params(dparams, dev)
        if not streams:
            raise ValueError("no streams to stage")
        with trace("decode.stage.headers"):
            first_cs = _codestream(streams[0], dp)
            hdr = j2k.read_main_header(first_cs)
            mh = bytes(first_cs[:hdr.main_header_end])
            bodies, ths = [], []
            for s in streams:
                cs = _codestream(s, dp)
                if bytes(cs[:hdr.main_header_end]) != mh:
                    raise GeneralRoute("a batch of streams with different "
                                       "main headers")
                parts = j2k.read_tile_parts(cs, hdr, strict=dp.strict)
                if hdr.siz.num_tiles != 1 or \
                        {p.tile_index for p in parts} != {0}:
                    raise GeneralRoute("a batch of multi-tile streams")
                # one tile-part: its body read in place, as a view of
                # the caller's stream; several are joined
                th, body = _tile_body(cs, hdr, parts, view=True)
                if any(_th_ovr_key(th)):
                    raise GeneralRoute("a batch of streams with tile-part "
                                       "overrides")
                count("decode.stage.body_views"
                      if isinstance(body, memoryview)
                      else "decode.stage.body_joins")
                bodies.append(body)
                ths.append(th)
        return stage_serving_batch(mh, hdr, 0, ths[0], bodies, dp,
                                   device=dev, ths=ths)


def decompress_device_batch(streams: list[bytes],
                            dparams: DecompressParams | None = None, *,
                            device="cuda") -> list:
    """Decode N same-geometry codestreams in one batched device decode.

    All N streams' code-blocks share kernel launches, the N bodies go up
    as one digest, and every stream's inverse DWT/MCT runs on stacked
    tensors.  Returns N lists of per-component int32 tensors on
    `device`.  With dp.mesh the batch is served over the mesh (K3's
    lanes one launch per shard, the synthesis levels row-sharded).  What
    the served batch declines (GeneralRoute: multi-tile streams,
    different main headers, tile-part COD/QCD, refined HT blocks, Part-1
    mode switches, layered HT-mixed streams) decodes stream by stream
    through decompress_device, as the JAX package's batch decode does."""
    if not streams:
        return []
    try:
        staged = stage_device_batch(streams, dparams, device=device)
    except GeneralRoute:
        count("decode.general_streams", len(streams))
        out = []
        for s in streams:
            with trace("decode.general"):
                out.append(decompress_device(s, dparams, device=device))
        return out
    return staged.run()


def _decode_tile_on(cs, hdr, t: int, th, body: bytes, dp,
                    dev: torch.device) -> list:
    """Per-component tensors of one tile: served, or on GeneralRoute
    decoded by the general device route."""
    try:
        return try_decode_serving_batch(cs, hdr, t, th, [body], dp,
                                        device=dev)[0]
    except GeneralRoute:
        return decode_tile(cs, hdr, t, th, body, dp, device=dev)


def decompress_device(data: bytes, dparams: DecompressParams | None = None,
                      *, device="cuda") -> list:
    """Decode one codestream to per-component int32 tensors resident on
    `device`, as grok_tpu/api.py `decompress_device` does.

    Each tile is served (tile-part COD, COC, QCD, QCC, RGN and POC
    overrides through the plan key; ROI undone on the device), or where
    the serving decode declines it (GeneralRoute: refined HT blocks,
    Part-1 mode switches, layered HT-mixed streams, PPM/PPT packed
    headers, a custom MCT, packets cut short or corrupt) decoded by the
    general device route, pipeline/tile.py decode_tile, on the same
    device: a cut or corrupt stream decodes what is present, with a
    warning, as grok_tpu.decompress(strict=False) does.  A stream with one tile returns that tile's planes; with
    several, full-image canvases at dp.reduce, each tile pasted at its
    place.  With dp.window, a tile that misses the window is not decoded
    (its region stays 0), and every sample inside the window equals the
    whole decode's.  With dp.mesh (a parallel/sharding.py Mesh whose
    first device is `device`, else ValueError), each tile is decoded with
    its default-style Part-1 lanes (one K3 launch per shard) and its
    synthesis levels sharded over the mesh, on the serving route or,
    where that declines the tile, on the general route, as
    grok_tpu.decompress with a mesh decodes it; the planes are the
    unsharded decode's."""
    dev = _device(device)
    dp = _params(dparams, dev)
    cs, hdr, by_tile, tile_body = _tiles(data, dp)
    tiles = sorted(by_tile)
    if len(tiles) == 1:
        return _decode_tile_on(cs, hdr, tiles[0], *tile_body(tiles[0]), dp,
                               dev)
    canvas = _Canvas(hdr, dp, dev)
    for t in _window_tiles(hdr, tiles, dp):
        th, body = tile_body(t)
        canvas.paste(t, th, _decode_tile_on(cs, hdr, t, th, body, dp, dev))
    return canvas.planes


def _window_tiles(hdr, tiles: list, dp: DecompressParams) -> list:
    """The tiles a decode decodes: all, or those that meet dp.window."""
    if dp.window is None:
        return list(tiles)
    win = Rect(*dp.window)
    return [t for t in tiles if not hdr.siz.tile_rect(t).intersect(win).empty]


class _Canvas:
    """Full-image component planes at dp.reduce on `dev`, zero where no
    tile was pasted."""

    def __init__(self, hdr, dp: DecompressParams, dev: torch.device):
        self.hdr, self.reduce = hdr, dp.reduce
        g = hdr.siz.normalized()
        scale = 1 << dp.reduce if dp.reduce else 1
        self.origins, self.planes = [], []
        for ci in hdr.comps:
            x0, y0 = -(-g.xosiz // ci.dx), -(-g.yosiz // ci.dy)
            x1, y1 = -(-g.xsiz // ci.dx), -(-g.ysiz // ci.dy)
            rx0, ry0 = -(-x0 // scale), -(-y0 // scale)
            rx1, ry1 = -(-x1 // scale), -(-y1 // scale)
            self.origins.append((rx0, ry0))
            self.planes.append(torch.zeros((ry1 - ry0, rx1 - rx0),
                                           dtype=torch.int32, device=dev))

    def paste(self, t: int, th, comps: list) -> None:
        """Tile t's component planes (its tile header th) at their
        place."""
        hdr = self.hdr
        rect = hdr.siz.tile_rect(t)
        for c, ci in enumerate(hdr.comps):
            nl = hdr.style_for(c, th.coc, th.cod).num_resolutions - 1
            s = 1 << (min(self.reduce, nl) if self.reduce else 0)
            r = rect.ceil_scale(ci.dx, ci.dy).ceil_scale(s, s)
            ox, oy = self.origins[c]
            self.planes[c][r.y0 - oy:r.y1 - oy, r.x0 - ox:r.x1 - ox] = \
                comps[c][:r.h, :r.w].to(self.planes[c].device)


def _tiles(data: bytes, dp: DecompressParams) -> tuple:
    """(codestream, main header, {tile index: its tile-parts}, body): the
    tile's (tile header, body) by body(t), with the main header's PPM and
    PLM merged into the tile header."""
    cs = jp2.locate_codestream(data, permissive=not dp.strict)
    hdr = j2k.read_main_header(cs)
    parts = j2k.read_tile_parts(cs, hdr, strict=dp.strict)
    by_tile: dict = {}
    for p in parts:
        by_tile.setdefault(p.tile_index, []).append(p)
    if not by_tile:
        raise ValueError("the codestream has no tile-parts")
    ppm, plm = _main_header_packets(hdr, parts)
    return cs, hdr, by_tile, \
        lambda t: _tile_body(cs, hdr, by_tile[t], ppm, plm)


@dataclass
class HeaderInfo:
    """grk_header_info analog (grok_tpu/api.py `HeaderInfo`)."""

    width: int
    height: int
    x0: int
    y0: int
    numcomps: int
    prec: list[int]
    sgnd: list[bool]
    subsampling: list[tuple[int, int]]
    num_tiles: int
    tile_size: tuple[int, int]
    num_resolutions: int
    num_layers: int
    prog_order: int
    irreversible: bool
    mct: int
    cblk_size: tuple[int, int]
    color_space: ColorSpace = ColorSpace.UNSPECIFIED
    comments: list[bytes] = field(default_factory=list)
    is_jp2: bool = False
    rsiz: int = 0


def _locate_codestream_span(data, permissive: bool = False) -> tuple:
    """(codestream start, end, JP2 meta or None) without copying, as
    grok_tpu/api.py `_locate_codestream_span`: a mapped source keeps its
    codestream as a view."""
    if jp2.is_jp2(data):
        return jp2.parse_jp2(data, permissive)
    if jp2.is_j2k(data):
        return 0, len(data), None
    raise j2k.CodestreamError("not a JPEG 2000 codestream or JP2 file")


def read_header(data) -> HeaderInfo:
    """The stream's HeaderInfo: main header and JP2 boxes only, no pixel
    work."""
    s, e, meta = _locate_codestream_span(data)
    cs = data if (s, e) == (0, len(data)) else memoryview(data)[s:e]
    return _header_info_from(j2k.read_main_header(cs), meta)


def _header_info_from(hdr, meta) -> HeaderInfo:
    """HeaderInfo from a parsed MainHeader and JP2 meta (or None), as
    grok_tpu/api.py `_header_info_from` builds it."""
    g = hdr.siz.normalized()
    color = ColorSpace.UNSPECIFIED
    if meta is not None:
        color = meta.color_space
    elif hdr.numcomps == 1:
        color = ColorSpace.GRAY
    elif hdr.numcomps == 3 and hdr.cod.mct:
        color = ColorSpace.SRGB
    return HeaderInfo(
        width=g.xsiz - g.xosiz, height=g.ysiz - g.yosiz,
        x0=g.xosiz, y0=g.yosiz,
        numcomps=hdr.numcomps,
        prec=[c.prec for c in hdr.comps],
        sgnd=[c.sgnd for c in hdr.comps],
        subsampling=[(c.dx, c.dy) for c in hdr.comps],
        num_tiles=hdr.siz.num_tiles,
        tile_size=(g.xtsiz, g.ytsiz),
        num_resolutions=hdr.cod.comp.num_resolutions,
        num_layers=hdr.cod.num_layers,
        prog_order=int(hdr.cod.prog_order),
        irreversible=hdr.cod.comp.irreversible,
        mct=hdr.cod.mct,
        cblk_size=(1 << hdr.cod.comp.cblk_w_exp,
                   1 << hdr.cod.comp.cblk_h_exp),
        color_space=color,
        comments=[c for (_r, c) in hdr.comments],
        is_jp2=meta is not None,
        rsiz=hdr.rsiz,
    )


def stage_general_device(data: bytes,
                         dparams: DecompressParams | None = None, *,
                         device="cuda"):
    """Stage one single-tile stream for the general decode route on
    `device` (pipeline/tile.py stage_general); .run() on the result
    decodes it, as decompress_device does for a stream the serving
    decode declines."""
    dev = _device(device)
    dp = _params(dparams, dev)
    cs, hdr, by_tile, tile_body = _tiles(data, dp)
    if len(by_tile) != 1:
        raise NotImplementedError("stage_general_device stages single-tile "
                                  "streams; decompress_device decodes "
                                  "tiled ones")
    t, = by_tile
    return stage_general(cs, hdr, t, *tile_body(t), dp, device=dev)


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def _build_main_header(h: int, w: int, ncomps: int, prec: int, sgnd: bool,
                       params: CompressParams,
                       origin: tuple[int, int] = (0, 0)) -> MainHeader:
    """The main header of an h x w image at `origin` (x0, y0) on the
    canvas whose components share one precision, without subsampling
    (compress_device's frames)."""
    x0, y0 = origin
    return _main_header((x0, y0, x0 + w, y0 + h),
                        [CompInfo(prec=prec, sgnd=bool(sgnd), dx=1, dy=1)
                         for _ in range(ncomps)], params)


def _image_header(image: Image, params: CompressParams) -> MainHeader:
    """The main header of an Image: its canvas and each component's
    precision, signedness and subsampling (its samples unused)."""
    return _main_header((image.x0, image.y0, image.x1, image.y1),
                        [CompInfo(prec=c.prec, sgnd=bool(c.sgnd), dx=c.dx,
                                  dy=c.dy) for c in image.components],
                        params)


def _main_header(canvas: tuple[int, int, int, int], comps: list,
                 params: CompressParams) -> MainHeader:
    """grok_tpu/api.py `_build_main_header`: the canvas (x0, y0, x1, y1),
    each component's CompInfo (precision, signedness and subsampling),
    the MCT where the first three components share their subsampling,
    one quantizer per component (a QCC where it differs from the QCD) and
    the ROI's raised exponents on its component."""
    params.validate()
    x0, y0, x1, y1 = canvas
    for c in comps:
        if c.prec > 27:
            # int32 coefficient pipeline: RCT (+1 bit), DWT band gain (+2
            # bits) and the sign-magnitude shift must fit 31 bits
            raise ValueError(
                f"component precision {c.prec} exceeds the supported "
                "27-bit bound for the int32 coefficient pipeline")
        if not (1 <= c.prec and 1 <= c.dx <= 255 and 1 <= c.dy <= 255):
            raise ValueError(f"component precision {c.prec} or subsampling "
                             f"({c.dx}, {c.dy}) outside SIZ's range")
    # the Rsiz profile's constraints, checked where grok_tpu.compress
    # checks them: before any route of the encode is chosen
    errs = validate_profile(params, x1 - x0, y1 - y0, len(comps),
                            frame_rate=params.frame_rate,
                            mainlevel=params.mainlevel,
                            sublevel=params.sublevel)
    if errs:
        raise ValueError("profile violations: " + "; ".join(errs))
    mct_mode = params.mct
    if mct_mode is None:
        mct_mode = MCTMode.RCT_OR_ICT if len(comps) >= 3 else MCTMode.NONE
    if mct_mode == MCTMode.CUSTOM:
        if params.custom_mct is None:
            raise ValueError("MCTMode.CUSTOM requires custom_mct matrix")
        if not params.irreversible:
            raise ValueError("custom MCT requires the irreversible path")
        if len({(c.dx, c.dy) for c in comps}) != 1:
            raise ValueError("a custom MCT needs components of one "
                             "subsampling")
    siz = SizGrid(xsiz=x1, ysiz=y1, xosiz=x0, yosiz=y0,
                  xtsiz=params.tile_w, ytsiz=params.tile_h,
                  xtosiz=params.tile_off_x, ytosiz=params.tile_off_y)
    use_mct = 1 if (mct_mode == MCTMode.RCT_OR_ICT and len(comps) >= 3
                    and len({(c.dx, c.dy) for c in comps[:3]}) == 1) else 0
    prec_exps = None
    if params.prec_w_exps:
        prec_exps = list(zip(params.prec_w_exps, params.prec_h_exps))
    cblk_style = params.cblk_style
    if params.ht or params.ht_mixed:
        cblk_style |= CBLK_HT
    cs = CodingStyleComp(num_resolutions=params.num_resolutions,
                         cblk_w_exp=params.cblk_w_exp,
                         cblk_h_exp=params.cblk_h_exp,
                         cblk_style=cblk_style,
                         irreversible=params.irreversible,
                         prec_exps=prec_exps)
    cod = CodingStyle(prog_order=params.prog_order,
                      num_layers=params.num_layers, mct=use_mct,
                      sop=params.sop, eph=params.eph, comp=cs)
    hdr = MainHeader(siz=siz, rsiz=int(params.rsiz), comps=comps, cod=cod)
    if params.ht or params.ht_mixed:
        # CAP (A.5.2 / ISO 15444-15): Pcap bit for Part 15 + one Ccap15
        # entry (0 = HT-only code-blocks; bit 5 = mixed); Rsiz bit 14
        hdr.cap = (1 << (32 - 15), [0x20 if params.ht_mixed else 0])
        hdr.rsiz |= 0x4000
    if mct_mode == MCTMode.CUSTOM:
        hdr.custom_mct = np.asarray(params.custom_mct, dtype=float)
        hdr.rsiz |= 0x8000 | 0x0100      # Part-2 extended + MCT extension
    for c, ci in enumerate(comps):
        q = make_quantizer(params.num_resolutions, ci.prec,
                           params.irreversible, params.num_guard_bits,
                           params.quant_step,
                           derived=not params.quant_style_expounded
                           and params.irreversible)
        steps = q.steps if q.style != 1 else q.steps[:1]
        if (c == params.roi_comp and params.roi_shift > 0
                and not params.irreversible):
            # Maxshift headroom: the signalled exponents raised so that
            # Mb = guard + eps - 1 covers the upshifted ROI planes
            steps = [StepSize(expn=st.expn + params.roi_shift,
                              mant=st.mant) for st in steps]
        qs = QuantStyle(style=q.style, guard_bits=q.guard_bits, steps=steps)
        if c == 0:
            hdr.qcd = qs
        elif qs != hdr.qcd:
            hdr.qcc[c] = qs
    if params.roi_shift > 0 and params.roi_comp >= 0:
        hdr.rgn[params.roi_comp] = params.roi_shift
    hdr.pocs = list(params.pocs)
    return hdr


def _main_header_bytes(hdr: MainHeader, params: CompressParams,
                       tlm_entries: list[tuple[int, int]] | None,
                       ppm_chunks: list[bytes] | None = None,
                       plm_lists: list[list[int]] | None = None) -> bytes:
    """grok_tpu/api.py `_main_header_bytes` for the headers the port
    encodes: SIZ, CAP, COD, QCD, QCC, RGN, POC, the custom MCT's
    MCT/MCC/MCO, TLM, PLM (one list of packet lengths per tile-part), PPM
    (one blob of packed headers per tile) and the comments, in the
    reference's order."""
    out = bytearray(struct.pack(">H", j2k.SOC))
    out += j2k.write_siz(hdr.siz, hdr.rsiz, hdr.comps)
    if hdr.cap is not None:
        out += j2k.write_cap(*hdr.cap)
    out += j2k.write_cod(hdr.cod)
    out += j2k.write_qcd(hdr.qcd)
    for c, q in hdr.qcc.items():
        out += j2k.write_qcc(c, len(hdr.comps), q)
    for c, sh in hdr.rgn.items():
        out += j2k.write_rgn(c, len(hdr.comps), sh)
    if hdr.pocs:
        out += j2k.write_poc(hdr.pocs, len(hdr.comps))
    if hdr.custom_mct is not None:
        out += j2k.write_mct_set(hdr.custom_mct)
    if tlm_entries is not None:
        out += j2k.write_tlm(tlm_entries)
    if plm_lists is not None:
        out += j2k.write_plm(plm_lists)
    if ppm_chunks is not None:
        out += j2k.write_ppm(ppm_chunks)
    if params.comment:
        out += j2k.write_com(params.comment)
    if params.ht_planes:
        # ht_planes >= 1 extension: the global HT cleanup plane P is
        # signalled once here (the segments stay standard-framed);
        # decoders compute the per-block plane min(P, numbps-1)
        # (t1ht/scalar.py derive_p).  Standard readers skip the COM.
        out += j2k.write_com("GRKTPU_HTP=%d" % params.ht_planes)
    return bytes(out)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _frame_components(arrays) -> list:
    """One frame as a list of component arrays or tensors: a list as it
    is, an (h, w, c) array split along its last axis, an (h, w) array as
    one component."""
    if isinstance(arrays, (list, tuple)):
        return list(arrays)
    if arrays.ndim == 3:
        return [arrays[:, :, c] for c in range(arrays.shape[2])]
    return [arrays]


def _frames_on(arrays_list, params: CompressParams,
               device) -> tuple[list, torch.device]:
    """An encode's frames as lists of int32 component tensors on its
    device, and that device: tensors must already lie on `device` (an
    index left out is the current card), numpy arrays are uploaded; the
    mesh is held to the device, and the frames must share their
    component shapes.  ValueError otherwise."""
    frames = [_frame_components(f) for f in arrays_list]
    tensors = [a for f in frames for a in f if isinstance(a, torch.Tensor)]

    def refuse(a, want):
        raise ValueError(f"a component tensor is on {a.device}, but the "
                         f"encode was asked to run on {want}")
    want = torch.device(device)
    for a in tensors:
        # the type is checked before the card is, so a mismatch raises
        # with or without a card
        if a.device.type != want.type:
            refuse(a, want)
    dev = _device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    for a in tensors:
        if a.device != dev:
            refuse(a, dev)
    check_mesh(params.mesh, dev)
    frames = [[a.to(torch.int32) if isinstance(a, torch.Tensor) else
               torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
               for a in f] for f in frames]
    if len({tuple(tuple(c.shape) for c in f) for f in frames}) != 1:
        raise ValueError("an encode's frames must share their component "
                         "shapes")
    return frames, dev


def _uniform_image(frame: list, prec: int, sgnd: bool,
                   origin: tuple[int, int]) -> Image:
    """The Image grok_tpu.compress_device builds around one frame of
    unsubsampled components of one precision (GRAY or SRGB), at
    `origin` on the canvas; components of differing shapes raise
    ValueError (compress takes subsampled ones as an Image)."""
    shapes = {tuple(c.shape) for c in frame}
    if len(shapes) != 1 or len(next(iter(shapes))) != 2:
        raise ValueError(
            f"compress_device takes (h, w) components of one shape, got "
            f"{sorted(shapes)}: encode subsampled components with "
            f"compress(Image) and each component's dx, dy")
    h, w = frame[0].shape
    x0, y0 = origin
    return Image(components=[Component(data=c, prec=prec, sgnd=sgnd)
                             for c in frame],
                 x0=x0, y0=y0, x1=x0 + w, y1=y0 + h,
                 color_space=ColorSpace.GRAY if len(frame) == 1
                 else ColorSpace.SRGB)


def _check_components(image: Image, frame: list) -> None:
    """Each component's samples must cover its grid on the image's canvas
    exactly: ceil(x1 / dx) - ceil(x0 / dx) columns and likewise rows
    (ValueError otherwise; grok_tpu.compress writes such a component
    into a stream its own decode refuses)."""
    if len(frame) != len(image.components):
        raise ValueError(f"{len(frame)} component arrays for an image of "
                         f"{len(image.components)} components")
    for c, (ci, a) in enumerate(zip(image.components, frame)):
        want = (_cdiv(image.y1, ci.dy) - _cdiv(image.y0, ci.dy),
                _cdiv(image.x1, ci.dx) - _cdiv(image.x0, ci.dx))
        if tuple(a.shape) != want:
            raise ValueError(
                f"component {c} holds {tuple(a.shape)} samples; with "
                f"subsampling ({ci.dx}, {ci.dy}) on the canvas "
                f"[{image.x0}, {image.x1}) x [{image.y0}, {image.y1}) it "
                f"needs {want}")


def compress_device_batch(arrays_list, params: CompressParams | None = None,
                          prec: int = 8, sgnd: bool = False, *,
                          device="cuda",
                          origin: tuple[int, int] = (0, 0)) -> list[bytes]:
    """Encode N same-geometry frames to N codestreams in one batched
    device encode — the encode mirror of decompress_device_batch.

    arrays_list: one entry per frame, each a list of (h, w) component
    arrays of one shape, or a single (h, w) / (h, w, c) array (as the
    JAX package's signature takes them: one precision, no subsampling;
    components of differing shapes raise ValueError, compress takes
    them as an Image).  Torch tensors stay on
    their device, which must be `device` (else ValueError); numpy arrays
    are uploaded to `device`.  origin: the image's (x0, y0) on the
    canvas, as grok_tpu's Image x0 and y0.  Tile by tile
    (params.tile_w/tile_h and the tile offsets), every frame's tile is
    sliced on the device and all frames' code-blocks of the tile share
    one launch of each block coder the stream uses (K4 for HT, K4r for
    refined HT, K5 for Part-1, both for HT-mixed), with the tile's own
    layer budgets.  Each stream carries its tiles in tile order, each in
    up to params.max_tile_parts tile-parts (split at packet boundaries),
    with non-default precincts, progression-order changes (POC), PLT,
    TLM, PLM, PPM and quality targets where params ask for them, any
    Part-1 mode switches, ROI (params.roi_comp, roi_shift and roi_rect)
    and a custom or AUTO_RD MCT, as grok_tpu.compress writes it.  With
    params.mesh (a parallel/sharding.py Mesh whose first device is
    `device`, else ValueError) the forward DWT levels and the
    default-style Part-1 lanes are sharded over the mesh, as
    grok_tpu.compress_device shards them; the bytes are the unsharded
    encode's."""
    params = params or CompressParams(ht=True)
    if not arrays_list:
        return []
    frames, dev = _frames_on(arrays_list, params, device)
    image = _uniform_image(frames[0], prec, sgnd, origin)
    return _encode_image_frames(frames, image, params, dev)


def _encode_image_frames(frames: list, image: Image,
                         params: CompressParams,
                         dev: torch.device) -> list[bytes]:
    """N frames of device tensors laid out as `image` (its canvas, each
    component's precision, signedness and subsampling, its colour space
    and JP2 metadata; its samples unused) to N codestreams: the R-D
    choice of the colour transform for MCTMode.AUTO_RD, else one
    encode."""
    if params.mct == MCTMode.AUTO_RD and len(frames[0]) >= 3:
        return _auto_rd(frames, image, params, dev)
    return _encode_frames(frames, image, params)


def _auto_rd(frames: list, image: Image, params: CompressParams,
             dev: torch.device) -> list[bytes]:
    """The R-D choice of the colour transform, as grok_tpu/api.py
    `compress` makes it for MCTMode.AUTO_RD: every frame encoded with
    and without it; a lossless encode keeps the shorter stream, a lossy
    one the stream whose decode (decompress_device, on the same device)
    has the lower squared error against the frame (the first on a
    tie)."""
    lossless = not params.irreversible and not params.rates \
        and not params.quality
    cands = [_encode_frames(frames, image, replace(params, mct=m))
             for m in (MCTMode.RCT_OR_ICT, MCTMode.NONE)]
    out = []
    for fi, f in enumerate(frames):
        best = None
        for streams in cands:
            data = streams[fi]
            if lossless:
                key = float(len(data))
            else:
                dec = decompress_device(data, device=dev)
                key = float(sum(((d.to(torch.int64) - c.to(torch.int64))
                                 ** 2).sum() for d, c in zip(dec, f)))
            if best is None or key < best[0]:
                best = (key, data)
        out.append(best[1])
    return out


def _encode_frames(frames: list, image: Image,
                   params: CompressParams) -> list[bytes]:
    """One encode of N frames laid out as `image` (_encode_image_frames)."""
    hdr = _image_header(image, params)
    _check_components(image, frames[0])
    comps = [torch.stack([f[ci] for f in frames])
             for ci in range(len(frames[0]))]
    per_tile = [try_encode_serving_batch(_tile_samples(comps, hdr, t),
                                         hdr, params, t)
                for t in range(hdr.siz.num_tiles)]
    out = []
    for fi in range(len(frames)):
        tps, tlm, plm, ppm = [], [], [], []
        for t, results in enumerate(per_tile):
            res = results[fi]
            ppm.append(res.headers)
            for tp, lens in _tile_parts(t, res, params):
                tps.append(tp)
                tlm.append((t, len(tp)))
                plm.append(list(lens))
        mh = _main_header_bytes(hdr, params,
                                tlm if params.write_tlm else None,
                                ppm if params.write_ppm else None,
                                plm if params.write_plm else None)
        stream = mh + b"".join(tps) + struct.pack(">H", j2k.EOC)
        if params.jp2:
            c0 = image.components[0]
            stream = jp2.wrap_jp2(
                stream, width=image.w, height=image.h,
                numcomps=len(image.components), prec=c0.prec, sgnd=c0.sgnd,
                color_space=image.color_space,
                icc_profile=image.icc_profile,
                capture_resolution=image.capture_resolution,
                per_comp_prec=[(c.prec, c.sgnd) for c in image.components])
        out.append(stream)
    return out


def _tile_samples(comps: list, hdr: MainHeader, t: int) -> list:
    """Tile t's samples of (N, h, w) component stacks: each component
    sliced by its own tile-component rect (the tile rect ceil-divided by
    its dx, dy), relative to its grid's origin on the canvas."""
    g = hdr.siz
    if g.num_tiles == 1:
        return comps
    r = g.tile_rect(t)
    out = []
    for c, ci in zip(comps, hdr.comps):
        cr = r.ceil_scale(ci.dx, ci.dy)
        gx0, gy0 = -(-g.xosiz // ci.dx), -(-g.yosiz // ci.dy)
        out.append(c[:, cr.y0 - gy0:cr.y1 - gy0,
                     cr.x0 - gx0:cr.x1 - gx0].contiguous())
    return out


def _tile_parts(t: int, res, params: CompressParams) -> list:
    """Tile t's tile-parts as (bytes, their packet lengths): the packet
    sequence split across up to params.max_tile_parts parts at packet
    boundaries, as grok_tpu.compress splits it, the tile-header markers
    (the HT-mixed bitmap COM, then the PLT) in part 0."""
    nparts = max(1, min(params.max_tile_parts, len(res.packets) or 1))
    per = -(-len(res.packets) // nparts) if nparts > 1 else None
    out = []
    for pi in range(nparts):
        if per is None:
            lens, body = res.packet_lens, res.body
        else:
            lens = res.packet_lens[pi * per:(pi + 1) * per]
            body = b"".join(res.packets[pi * per:(pi + 1) * per])
        seg = j2k.write_plt(lens, zplt=pi) if params.write_plt else b""
        if pi == 0:
            seg = res.com + seg
        psot = 12 + len(seg) + 2 + len(body)
        out.append((j2k.write_sot(t, psot, pi, nparts) + seg
                    + struct.pack(">H", j2k.SOD) + body, lens))
    return out


def compress_device(arrays, params: CompressParams | None = None,
                    prec: int = 8, sgnd: bool = False, *,
                    device="cuda", origin: tuple[int, int] = (0, 0)) -> bytes:
    """Encode one frame (a list of (h, w) component arrays of one shape,
    or one (h, w) / (h, w, c) array) to a codestream on the device."""
    return compress_device_batch([arrays], params, prec, sgnd,
                                 device=device, origin=origin)[0]


def _as_image(image_or_array) -> Image:
    """An Image as it is; an (h, w) or (h, w, c) numpy array or tensor as
    grok_tpu's Image.from_array builds it (8-bit unsigned, GRAY or SRGB),
    a tensor's samples left on its device."""
    if isinstance(image_or_array, Image):
        return image_or_array
    if not isinstance(image_or_array, torch.Tensor):
        return Image.from_array(np.asarray(image_or_array))
    return _uniform_image(_frame_components(image_or_array), 8, False,
                          (0, 0))


def compress(image_or_array, params: CompressParams | None = None, *,
             device="cuda") -> bytes:
    """Encode an Image (or an (h, w) / (h, w, c) array) to a J2K
    codestream or a JP2 file on `device`, as grok_tpu.compress writes it
    (grok_tpu/api.py `compress`): each component with its own precision,
    signedness and subsampling (dx, dy), the colour transform where the
    first three components share their subsampling, a QCC where a
    component's quantization differs; AUTO_RD's R-D choice (the lossy
    candidates decoded by decompress_device on the same device); with
    params.jp2 the image's colour space, ICC profile, capture resolution
    and, where the precisions differ, the BPCC box.  The components'
    samples are numpy arrays (uploaded) or tensors, which must lie on
    `device` (else ValueError), each covering its grid on the image's
    canvas exactly: ceil(x1 / dx) - ceil(x0 / dx) columns and likewise
    rows (else ValueError).  Everything else as compress_device_batch:
    tiles, layers and rate targets, precincts, POC, the markers, mode
    switches, HT-mixed and refined HT, ROI and params.mesh."""
    params = params or CompressParams()
    image = _as_image(image_or_array)
    (frame,), dev = _frames_on([[c.data for c in image.components]],
                               params, device)
    return _encode_image_frames([frame], image, params, dev)[0]


def decompress(data, dparams: DecompressParams | None = None, *,
               device="cuda", tile_index: int | None = None,
               components: list | None = None) -> Image:
    """Decode a J2K codestream or JP2 file to a host Image, as
    grok_tpu.decompress does (strict unless dparams.strict is False):
    codec.py Decompressor(...).decompress() on `device`.  tile_index:
    only that tile (the rest of the image zero) and components: only
    those, as grok_tpu's DecompressParams tile_index and components give
    them (the port's DecompressParams has no such fields)."""
    from grok_tpu_torch.codec import Decompressor
    with Decompressor(data, dparams, cache_tiles=0, device=device) as dec:
        return dec.decompress(tile=tile_index, components=components)
