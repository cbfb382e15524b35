"""Object-lifecycle codec API on the port's device entries: the port's
copy of grok_tpu/codec.py.

`Decompressor` is the grk_decompress_init / read_header / set_window /
decompress / decompress_tile flow over one codestream, with a
decoded-tile LRU cache and memory-mapped file sources: opening by path
maps the file instead of reading it, and a JP2's codestream box stays a
zero-copy view, so tile access touches only the pages of the requested
tile-parts (released again after each tile's decode).  A tile decodes on
`device` (the card unless the caller asks for the CPU) as
api.decompress_device decodes it, served or on the general route.

`Compressor` is the streaming tile-incremental encode (opj_write_tile /
opj_end_compress): the main header goes out first, each write_tile
encodes one tile on `device` through the serving encode
(pipeline/serve_enc.py, the per-tile call of api.compress_device_batch)
and appends its tile-part, a sidecar manifest makes a stopped encode
resumable, and finish() patches the TLM.

Reference parity: [grok: src/lib/core/cache/TileCache, util MemStream /
mapped-file helpers, opj_write_tile / grk_compress streaming surface].
"""

from __future__ import annotations

import hashlib
import json
import mmap
import os
import struct
from dataclasses import replace

import numpy as np

from grok_tpu_torch import api
from grok_tpu_torch.codestream import j2k
from grok_tpu_torch.core.image import ColorSpace, Component, Image
from grok_tpu_torch.core.params import (CompressParams, DecompressParams,
                                        MCTMode)
from grok_tpu_torch.pipeline.postproc import postprocess
from grok_tpu_torch.pipeline.serve_enc import try_encode_serving_batch


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class Decompressor:
    """Incremental decoder over one codestream.

    Usage:
        dec = Decompressor(path_or_bytes)    # device="cuda" by default
        info = dec.header                    # cheap: no pixel work
        planes = dec.decompress_tile(3)      # one tile, cached, on device
        img = dec.decompress()               # a host Image
    """

    def __init__(self, data, params: DecompressParams | None = None,
                 cache_tiles: int | None = 16, *, device="cuda"):
        """data: a bytes-like codestream or JP2 file, or a filesystem path
        (the file is memory-mapped, not read).  cache_tiles: the decoded
        tiles' LRU capacity (0 disables the cache, None is unbounded)."""
        self.cache_tiles = cache_tiles
        self.params = params or DecompressParams()
        if self.params.strict is None:
            self.params = replace(self.params, strict=True)
        self.device = api._device(device)
        self._mm = self._fh = None
        if isinstance(data, (str, os.PathLike)):
            self._fh = open(data, "rb")
            self._mm = mmap.mmap(self._fh.fileno(), 0,
                                 access=mmap.ACCESS_READ)
            data = self._mm
        s, e, self._meta = api._locate_codestream_span(
            data, permissive=not self.params.strict)
        self._cs_off = s               # codestream offset in the mapping
        if s == 0 and e == len(data):
            self._cs = data
        elif isinstance(data, (bytes, bytearray)):
            self._cs = data[s:e]
        else:
            # a mapped JP2: the jp2c box stays a view of the mapping
            self._cs = memoryview(data)[s:e]
        self._hdr = j2k.read_main_header(self._cs)
        self._parts = j2k.read_tile_parts(self._cs, self._hdr,
                                          strict=self.params.strict)
        self._by_tile: dict[int, list] = {}
        for p in self._parts:
            self._by_tile.setdefault(p.tile_index, []).append(p)
        self._packets = api._main_header_packets(self._hdr, self._parts)
        self._cache: dict[tuple, list] = {}
        self.header = api._header_info_from(self._hdr, self._meta)

    @property
    def num_tiles(self) -> int:
        return self._hdr.siz.num_tiles

    def set_window(self, x0: int, y0: int, x1: int, y1: int):
        """Region-of-interest decode window (canvas coordinates)."""
        self.params.window = (x0, y0, x1, y1)
        return self

    def _dp(self) -> DecompressParams:
        return api._params(self.params, self.device)

    def _cache_key(self, t: int) -> tuple:
        return (t, self.params.reduce, self.params.max_layers,
                self.params.window)

    def decompress_tile(self, t: int) -> list:
        """Decode one tile (LRU-cached): per-component int32 tensors on
        the device, the tile at the decode's reduce (exact inside the
        window where one is set)."""
        key = self._cache_key(t)
        if key in self._cache:
            self._cache[key] = self._cache.pop(key)    # refresh recency
            return self._cache[key]
        if t not in self._by_tile:
            raise j2k.CodestreamError(f"tile {t} not present")
        th, body = api._tile_body(self._cs, self._hdr, self._by_tile[t],
                                  *self._packets)
        out = api._decode_tile_on(self._cs, self._hdr, t, th, body,
                                  self._dp(), self.device)
        if self._mm is not None and hasattr(self._mm, "madvise"):
            # drop the tile's consumed pages so that the resident set stays
            # bounded by the cache, not the stream (the pages are clean and
            # fault back in on a later access)
            pg = mmap.PAGESIZE
            for p in self._by_tile[t]:
                lo = (self._cs_off + p.data_start) // pg * pg
                hi = self._cs_off + p.data_end
                ln = min((hi - lo + pg - 1) // pg * pg, len(self._mm) - lo)
                self._mm.madvise(mmap.MADV_DONTNEED, lo, ln)
        if self.cache_tiles is None or self.cache_tiles > 0:
            while self.cache_tiles is not None \
                    and len(self._cache) >= self.cache_tiles:
                self._cache.pop(next(iter(self._cache)))
            self._cache[key] = out
        return out

    def decompress(self, *, tile: int | None = None,
                   components: list | None = None) -> Image:
        """Decode every (window-meeting) tile on the device with
        api.decompress_device, download the planes and return the host
        Image grok_tpu.codec.Decompressor.decompress returns: the window's
        region at the decode's reduce, JP2 colour space, ICC profile and
        capture resolution carried, palette and channel definitions (and
        the parameters' upsample, force-RGB and ICC) applied.  tile: only
        that tile (decompress_tile, the rest of the image zero) and
        components: only those, as grok_tpu.decompress's tile_index and
        components give them (the CLI's -T and -c)."""
        dp = self._dp()
        hdr, meta = self._hdr, self._meta
        if tile is None:
            planes = api.decompress_device(self._cs, dp, device=self.device)
        else:
            if tile not in self._by_tile:
                raise j2k.CodestreamError(f"tile {tile} not in codestream")
            canvas = api._Canvas(hdr, dp, self.device)
            if api._window_tiles(hdr, [tile], dp):
                th, _body = api._tile_body(self._cs, hdr,
                                           self._by_tile[tile],
                                           *self._packets)
                canvas.paste(tile, th, self.decompress_tile(tile))
            planes = canvas.planes
        g = hdr.siz.normalized()
        scale = 1 << dp.reduce if dp.reduce else 1
        img_x0, img_y0 = _cdiv(g.xosiz, scale), _cdiv(g.yosiz, scale)
        img_x1, img_y1 = _cdiv(g.xsiz, scale), _cdiv(g.ysiz, scale)
        if dp.window is not None:
            wx0, wy0, wx1, wy1 = dp.window
            img_x0 = max(img_x0, wx0 // scale)
            img_y0 = max(img_y0, wy0 // scale)
            img_x1 = min(img_x1, _cdiv(wx1, scale))
            img_y1 = min(img_y1, _cdiv(wy1, scale))
        comps = []
        for c in (range(hdr.numcomps) if components is None
                  else components):
            ci, arr = hdr.comps[c], planes[c]
            if dp.window is not None:
                # the plane's origin, then the window's region in it
                ox = _cdiv(_cdiv(g.xosiz, ci.dx), scale)
                oy = _cdiv(_cdiv(g.yosiz, ci.dy), scale)
                arr = arr[_cdiv(img_y0, ci.dy) - oy:_cdiv(img_y1, ci.dy) - oy,
                          _cdiv(img_x0, ci.dx) - ox:_cdiv(img_x1, ci.dx) - ox]
            comps.append(Component(
                data=arr.cpu().numpy().astype(np.int32, copy=False),
                dx=ci.dx * scale, dy=ci.dy * scale, prec=ci.prec,
                sgnd=ci.sgnd))
        color = meta.color_space if meta is not None else (
            ColorSpace.GRAY if len(comps) == 1 else ColorSpace.SRGB)
        img = Image(components=comps, x0=img_x0, y0=img_y0, x1=img_x1,
                    y1=img_y1, color_space=color)
        if meta is not None:
            img.icc_profile = meta.icc_profile
            img.capture_resolution = meta.capture_resolution
        return postprocess(img, meta, dp)

    def cache_info(self) -> dict:
        return {"tiles_cached": len(self._cache)}

    def close(self):
        """Release the mapped file (no-op for bytes sources)."""
        if isinstance(getattr(self, "_cs", None), memoryview):
            self._cs.release()     # else mmap.close() raises BufferError
            self._cs = b""
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Compressor:
    """Streaming tile-incremental encoder on the device.

    Usage:
        enc = Compressor("out.j2k", width=W, height=H, numcomps=1,
                         params=CompressParams(...))   # device="cuda"
        for t in range(enc.num_tiles):
            enc.write_tile(t, tile)     # a tensor on the device, or numpy
        enc.finish()

    The main header goes out at once (with a zeroed TLM slot when
    params.write_tlm, patched by finish()); each write_tile appends one
    tile-part and updates a sidecar manifest (<path>.manifest.json), so
    that a stopped encode restarts where it stopped (resume=True).  The
    streams are api.compress_device_batch's, tile for tile; a
    rate-targeted tile's budget is the JAX object's (the whole-image
    budget less the written main header, shared by tile area).  Refused
    as the JAX object refuses them: PPM, PLM, AUTO_RD, several
    tile-parts a tile, an ROI rectangle, fixed-quality targets and JP2
    (ValueError).  subsampling: each component's (dx, dy), one precision
    and signedness for all, as the JAX object takes them; write_tile then
    takes each component's (comp_h, comp_w) samples of the tile.
    """

    def __init__(self, path, *, width: int, height: int, numcomps: int = 1,
                 prec: int = 8, sgnd: bool = False, x0: int = 0, y0: int = 0,
                 subsampling=None, params: CompressParams | None = None,
                 resume: bool = False, device="cuda"):
        self.params = params or CompressParams()
        if self.params.write_ppm or self.params.write_plm:
            raise ValueError("PPM/PLM need the whole stream: use "
                             "compress_device()")
        if self.params.mct == MCTMode.AUTO_RD:
            raise ValueError(
                "MCTMode.AUTO_RD compares whole encodes; the streaming "
                "Compressor writes its main header before the first "
                "tile — pick RCT_OR_ICT or NONE explicitly (or use "
                "compress_device())")
        if self.params.max_tile_parts != 1:
            raise ValueError("streaming encode emits one tile-part per tile")
        if self.params.roi_rect is not None or self.params.fixed_quality:
            raise ValueError("ROI rect / fixed-quality targets are "
                             "whole-stream features: use compress_device()")
        if self.params.jp2:
            raise ValueError("JP2 boxes need the stream length: wrap the "
                             "finished file with jp2.wrap_jp2")
        self.device = device
        sub = subsampling or [(1, 1)] * numcomps
        if len(sub) != numcomps:
            raise ValueError(f"{len(sub)} subsampling factors for "
                             f"{numcomps} components")
        self._hdr = api._main_header(
            (x0, y0, x0 + width, y0 + height),
            [j2k.CompInfo(prec=prec, sgnd=bool(sgnd), dx=dx, dy=dy)
             for dx, dy in sub],
            self.params)
        siz = self._hdr.siz
        self.num_tiles = siz.num_tiles
        self._raw_bytes = sum((siz.xsiz - siz.xosiz) * (siz.ysiz - siz.yosiz)
                              * c.prec / 8.0 / (c.dx * c.dy)
                              for c in self._hdr.comps)
        self._total_pixels = (siz.xsiz - siz.xosiz) * (siz.ysiz - siz.yosiz)
        tlm = [(t, 0) for t in range(self.num_tiles)] \
            if self.params.write_tlm else None
        mh = api._main_header_bytes(self._hdr, self.params, tlm)
        self._header_overhead = len(mh) + self.num_tiles * 14 + 2
        # the zeroed TLM slot, found by its whole segment's bytes
        self._tlm_off = mh.find(j2k.write_tlm(tlm)) if tlm is not None \
            else -1
        self._path = os.fspath(path)
        self._manifest_path = self._path + ".manifest.json"
        self._hdr_hash = hashlib.sha256(mh).hexdigest()
        self._done: dict[int, int] = {}
        self._pos = len(mh)
        self._finished = False
        if resume and os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                m = json.load(f)
            if m.get("hdr") != self._hdr_hash:
                raise ValueError("resume manifest does not match header")
            self._done = {int(k): v for k, v in m["tiles"].items()}
            self._pos = m["pos"]
            self._fh = open(self._path, "r+b")
            self._fh.truncate(self._pos)     # drop any torn tail
            self._fh.seek(self._pos)
        else:
            self._fh = open(self._path, "w+b")
            self._fh.write(mh)
            self._save_manifest()

    def _save_manifest(self):
        tmp = self._manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"hdr": self._hdr_hash, "pos": self._pos,
                       "tiles": self._done}, f)
        os.replace(tmp, self._manifest_path)

    def tile_written(self, t: int) -> bool:
        return t in self._done

    def _targets(self, rect) -> list:
        """The tile's cumulative layer budgets by the JAX object's rule
        (None: every remaining pass)."""
        frac = (rect.w * rect.h) / max(self._total_pixels, 1)
        out: list = []
        for lay in range(self.params.num_layers):
            if self.params.rates and self.params.rates[lay] > 1:
                budget = self._raw_bytes / self.params.rates[lay] - \
                    self._header_overhead
                out.append(max(budget, 100.0) * frac)
            else:
                out.append(None)
        return out

    def write_tile(self, t: int, data) -> None:
        """Encode and append tile t.  data: the tile's samples, one (h, w)
        or (h, w, numcomps) array, or a per-component list of (comp_h,
        comp_w) arrays (subsampled layouts: the tile's rect ceil-divided
        by each component's dx, dy), covering the tile's region of the
        image (larger arrays are cropped); torch tensors must lie on the
        Compressor's device, numpy arrays are uploaded to it."""
        if self._finished:
            raise ValueError("finish() already called")
        if not (0 <= t < self.num_tiles):
            raise ValueError(f"tile {t} out of range")
        if t in self._done:
            return                           # resumed: already on disk
        (comps,), _dev = api._frames_on([data], self.params, self.device)
        if len(comps) != len(self._hdr.comps):
            raise ValueError(f"expected {len(self._hdr.comps)} components")
        rect = self._hdr.siz.tile_rect(t)
        for c, (arr, ci) in enumerate(zip(comps, self._hdr.comps)):
            cr = rect.ceil_scale(ci.dx, ci.dy)
            if arr.dim() != 2 or arr.shape[0] < cr.h or arr.shape[1] < cr.w:
                raise ValueError(
                    f"tile {t} comp {c}: need {cr.h}x{cr.w} samples, "
                    f"got {'x'.join(map(str, arr.shape))}")
            comps[c] = arr[None, :cr.h, :cr.w].contiguous()
        res, = try_encode_serving_batch(comps, self._hdr, self.params, t,
                                        targets=self._targets(rect))
        (tp, _lens), = api._tile_parts(t, res, self.params)
        self._fh.seek(self._pos)
        self._fh.write(tp)
        self._fh.flush()
        self._pos += len(tp)
        self._done[t] = len(tp)
        self._save_manifest()

    def finish(self) -> None:
        """Append EOC, patch the TLM slot, drop the resume manifest."""
        missing = [t for t in range(self.num_tiles) if t not in self._done]
        if missing:
            raise ValueError(f"tiles not written: {missing[:8]}"
                             f"{'...' if len(missing) > 8 else ''}")
        self._fh.seek(self._pos)
        self._fh.write(struct.pack(">H", j2k.EOC))
        if self._tlm_off >= 0:
            entries = [(t, self._done[t]) for t in range(self.num_tiles)]
            self._fh.seek(self._tlm_off)
            self._fh.write(j2k.write_tlm(entries))
        self._fh.flush()
        self._fh.close()
        if os.path.exists(self._manifest_path):
            os.remove(self._manifest_path)
        self._finished = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if not self._finished and not self._fh.closed:
            # keep the manifest: the encode is resumable
            self._fh.close()

