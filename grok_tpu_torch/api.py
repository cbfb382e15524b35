"""Public device-decode surface of the PyTorch port.

Mirrors grok_tpu/api.py `decompress_device_batch` and
`decompress_device` for served streams: the device is always explicit
(`device=`), the decoded int32 component planes stay resident on it, and
streams outside the served scope raise NotImplementedError instead of
falling back to a host decode.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from grok_tpu.api import _locate_codestream
from grok_tpu.codestream import j2k
from grok_tpu.codestream.j2k import TileHeader
from grok_tpu.core.params import DecompressParams
from grok_tpu_torch.pipeline.serve import (StagedBatch, stage_serving_batch,
                                           try_decode_serving_batch)


def _params(dparams: DecompressParams | None) -> DecompressParams:
    # permissive by default, like the JAX serving surfaces: the C scan
    # validates framing, the kernel decodes payloads without validation
    dp = dparams or DecompressParams()
    return replace(dp, strict=False) if dp.strict is None else dp


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           f"available")
    return dev


def _tile_body(cs, hdr, parts):
    th = TileHeader()
    chunks = []
    for p in sorted(parts, key=lambda p: p.part_index):
        j2k.read_tile_part_header(cs, p, hdr, th)
        chunks.append(cs[p.data_start:p.data_end])
    return th, b"".join(chunks)


def stage_device_batch(streams: list[bytes],
                       dparams: DecompressParams | None = None, *,
                       device) -> StagedBatch:
    """Parse N same-geometry codestreams on the host and upload their
    staged batch to `device`; .run() on the result decodes it."""
    dev = _device(device)
    dp = _params(dparams)
    if not streams:
        raise ValueError("no streams to stage")
    first_cs, _ = _locate_codestream(streams[0], permissive=not dp.strict)
    hdr = j2k.read_main_header(first_cs)
    mh = bytes(first_cs[:hdr.main_header_end])
    bodies, ths = [], []
    for s in streams:
        cs, _ = _locate_codestream(s, permissive=not dp.strict)
        if bytes(cs[:hdr.main_header_end]) != mh:
            raise NotImplementedError("batch decode of streams with "
                                      "different main headers is not "
                                      "ported")
        parts = j2k.read_tile_parts(cs, hdr, strict=dp.strict)
        if hdr.siz.num_tiles != 1 or {p.tile_index for p in parts} != {0}:
            raise NotImplementedError("multi-tile decode is not ported")
        th, body = _tile_body(cs, hdr, parts)
        if th.cod is not None or th.qcd is not None:
            raise NotImplementedError("batch decode of streams with "
                                      "tile-part COD/QCD is not ported")
        bodies.append(body)
        ths.append(th)
    return stage_serving_batch(mh, hdr, 0, ths[0], bodies, dp, device=dev,
                               ths=ths)


def decompress_device_batch(streams: list[bytes],
                            dparams: DecompressParams | None = None, *,
                            device) -> list:
    """Decode N same-geometry codestreams in one batched device decode.

    All N streams' code-blocks share kernel launches, the N bodies go up
    as one digest, and every stream's inverse DWT/MCT runs on stacked
    tensors.  Returns N lists of per-component int32 tensors on
    `device`."""
    if not streams:
        return []
    return stage_device_batch(streams, dparams, device=device).run()


def decompress_device(data: bytes, dparams: DecompressParams | None = None,
                      *, device) -> list:
    """Decode one codestream to per-component int32 tensors resident on
    `device` (single-tile served streams; tile-part COD/QCD overrides
    are served through the plan key, as in the JAX package)."""
    dev = _device(device)
    dp = _params(dparams)
    cs, _ = _locate_codestream(data, permissive=not dp.strict)
    hdr = j2k.read_main_header(cs)
    parts = j2k.read_tile_parts(cs, hdr, strict=dp.strict)
    tiles = {p.tile_index for p in parts}
    if len(tiles) != 1:
        raise NotImplementedError("multi-tile decode is not ported")
    t = tiles.pop()
    th, body = _tile_body(cs, hdr, parts)
    return try_decode_serving_batch(cs, hdr, t, th, [body], dp,
                                    device=dev)[0]
