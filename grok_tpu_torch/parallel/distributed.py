"""Tile-sharded encode and decode over processes: the counterpart of
grok_tpu/parallel/distributed.py.

Each process drives its own device; `torch.distributed` over Gloo
carries the bytes (Gloo serves two processes sharing one card, where
NCCL refuses a card shared by two ranks).  Every entry point degenerates
to one process when no process group is set up, so the whole surface runs
in a single process too.

  - `init_distributed` joins the process group from its arguments or the
    JAX package's environment names (GROK_COORDINATOR = host:port,
    GROK_NUM_PROCESSES, GROK_PROCESS_ID), with a finite timeout on every
    collective;
  - `gather_bytes_to_host0` gathers one byte blob per process: two
    all-gathers of CPU tensors, the lengths first;
  - `compress_distributed`: process p encodes the tiles t with t % n == p
    with the port's tile encode on its device; process 0 assembles the
    main header, TLM and EOC, byte-identical to api.compress_device at
    every parameter it accepts;
  - `decompress_distributed`: process p decodes its tiles through the
    port's tile decode on its device; the int32 planes gather to process
    0 as bytes, which returns what api.decompress_device returns.
"""

from __future__ import annotations

import os
import struct
from datetime import timedelta

import numpy as np
import torch

TIMEOUT_S = 300.0        # every process-group wait


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def rank_and_size() -> tuple[int, int]:
    """(this process's rank, the number of processes); (0, 1) without a
    process group."""
    dist = _dist()
    return (0, 1) if dist is None else (dist.get_rank(),
                                        dist.get_world_size())


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     timeout: float = TIMEOUT_S) -> tuple[int, int]:
    """Join the process group (Gloo, `tcp://coordinator`); returns
    (rank, number of processes).  Arguments left out are read from
    GROK_COORDINATOR ("host:port"), GROK_NUM_PROCESSES and
    GROK_PROCESS_ID; with no coordinator at all this is the one-process
    setup, (0, 1).  timeout (seconds) bounds the rendezvous and every
    collective after it."""
    import torch.distributed as dist

    coordinator = coordinator or os.environ.get("GROK_COORDINATOR")
    if coordinator is None:
        return rank_and_size()
    if num_processes is None:
        num_processes = int(os.environ["GROK_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["GROK_PROCESS_ID"])
    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                timeout=timedelta(seconds=timeout))
    return rank_and_size()


def shutdown_distributed() -> None:
    """Leave the process group, where one was joined."""
    dist = _dist()
    if dist is not None:
        dist.destroy_process_group()


def gather_bytes_to_host0(blob: bytes) -> list[bytes]:
    """One variable-length byte blob per process, gathered onto every
    process in rank order (callers read it on process 0); [blob] in one
    process.  Two all-gathers of CPU tensors: the lengths, then the
    zero-padded uint8 payloads."""
    dist = _dist()
    if dist is None or dist.get_world_size() == 1:
        return [bytes(blob)]
    n = dist.get_world_size()
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(lens, torch.tensor([len(blob)], dtype=torch.int64))
    top = max(1, max(int(x) for x in lens))
    pad = torch.zeros(top, dtype=torch.uint8)
    if blob:
        pad[:len(blob)] = torch.from_numpy(np.frombuffer(bytes(blob),
                                                         np.uint8).copy())
    outs = [torch.empty_like(pad) for _ in range(n)]
    dist.all_gather(outs, pad)
    return [o[:int(ln)].numpy().tobytes() for o, ln in zip(outs, lens)]


def _records(blobs: list[bytes]):
    """(key, payload) records of ">II"-framed blobs."""
    for blob in blobs:
        pos = 0
        while pos < len(blob):
            key, ln = struct.unpack_from(">II", blob, pos)
            pos += 8
            yield key, blob[pos:pos + ln]
            pos += ln


def compress_distributed(arrays, params=None, prec: int = 8,
                         sgnd: bool = False, *, device="cuda",
                         origin: tuple[int, int] = (0, 0)) -> bytes | None:
    """Process-sharded encode of one frame (every process passes the whole
    frame, as api.compress_device takes it: tensors on `device`, else
    ValueError, numpy arrays uploaded): process p encodes the tiles t
    with t % n == p on `device`; the tile-parts gather to process 0,
    which returns the codestream, byte-identical to api.compress_device;
    the others return None.

    Refused (ValueError), as grok_tpu/parallel/distributed.py refuses
    them: a JP2 wrapper, PPM, PLM, an ROI rectangle, fixed-quality
    targets and several tile-parts a tile.  Refused besides: ht_mixed and
    ht_planes (the JAX function passes neither to its tile encode, so its
    streams differ from grok_tpu.compress there, and with ht_planes
    decode to other pixels), and MCTMode.AUTO_RD (a whole-frame choice
    between two encodes)."""
    from grok_tpu_torch import api
    from grok_tpu_torch.codestream import j2k
    from grok_tpu_torch.core.params import CompressParams, MCTMode
    from grok_tpu_torch.pipeline.serve_enc import try_encode_serving_batch

    params = params or CompressParams(ht=True)
    if params.jp2 or params.write_ppm or params.write_plm:
        raise ValueError("distributed encode: raw J2K with inline headers "
                         "only")
    if (params.roi_rect is not None or params.fixed_quality
            or params.max_tile_parts != 1):
        raise ValueError("distributed encode: ROI rect, fixed-quality "
                         "targets and tile-part splitting are whole-stream "
                         "features: use compress_device")
    if params.ht_mixed or params.ht_planes:
        raise ValueError("distributed encode: ht_mixed and ht_planes are "
                         "refused (grok_tpu.parallel.distributed."
                         "compress_distributed ignores both and writes "
                         "another stream than grok_tpu.compress): use "
                         "compress_device")
    if params.mct == MCTMode.AUTO_RD and \
            len(api._frame_components(arrays)) >= 3:
        raise ValueError("distributed encode: MCTMode.AUTO_RD chooses "
                         "between two whole-frame encodes: use "
                         "compress_device")
    (comps,), _dev = api._frames_on([arrays], params, device)
    comps = [c[None] for c in comps]
    if len({tuple(c.shape) for c in comps}) != 1:
        raise NotImplementedError("encode of subsampled components is not "
                                  "ported")
    h, w = comps[0].shape[1:]
    hdr = api._build_main_header(h, w, len(comps), prec, sgnd, params,
                                 origin)
    rank, n = rank_and_size()
    local = bytearray()
    for t in range(rank, hdr.siz.num_tiles, n):
        res = try_encode_serving_batch(
            api._tile_samples(comps, hdr, t, origin), hdr, params, t)[0]
        (tp, _lens), = api._tile_parts(t, res, params)
        local += struct.pack(">II", t, len(tp)) + tp
    gathered = gather_bytes_to_host0(bytes(local))
    if rank != 0:
        return None
    parts = dict(_records(gathered))
    missing = [t for t in range(hdr.siz.num_tiles) if t not in parts]
    if missing:
        raise RuntimeError(f"distributed encode lost tiles {missing[:8]}")
    tiles = [parts[t] for t in range(hdr.siz.num_tiles)]
    tlm = [(t, len(p)) for t, p in enumerate(tiles)] \
        if params.write_tlm else None
    return (api._main_header_bytes(hdr, params, tlm) + b"".join(tiles)
            + struct.pack(">H", j2k.EOC))


def decompress_distributed(data: bytes, dparams=None, *,
                           device="cuda") -> list | None:
    """Process-sharded decode: process p decodes the tiles t with
    t % n == p (those that meet dparams.window, where one is given)
    through the port's tile decode on `device`; their int32 planes
    gather to process 0 as bytes.  Process 0 returns what
    api.decompress_device returns (a one-tile stream's planes, or
    full-image canvases on `device` with the tiles outside a window left
    at 0); the others return None.  The JAX function's refused
    single-tile and component-subset decodes have no field in the port's
    DecompressParams."""
    from grok_tpu_torch import api

    dev = api._device(device)
    dp = api._params(dparams, dev)
    cs, hdr, by_tile, tile_body = api._tiles(data, dp)
    tiles = sorted(by_tile)
    if len(tiles) > 1:
        tiles = api._window_tiles(hdr, tiles, dp)
    rank, n = rank_and_size()
    local = bytearray()
    for t in tiles:
        if t % n != rank:
            continue
        comps = api._decode_tile_on(cs, hdr, t, *tile_body(t), dp, dev)
        rec = bytearray()
        for c in comps:
            a = c.to(torch.int32).cpu().numpy()
            rec += struct.pack(">II", *a.shape) + a.tobytes()
        local += struct.pack(">II", t, len(rec)) + rec
    gathered = gather_bytes_to_host0(bytes(local))
    if rank != 0:
        return None
    decoded = {}
    for t, rec in _records(gathered):
        planes, pos = [], 0
        for _c in hdr.comps:
            ph, pw = struct.unpack_from(">II", rec, pos)
            pos += 8
            a = np.frombuffer(rec, np.int32, ph * pw, pos).reshape(ph, pw)
            pos += 4 * ph * pw
            planes.append(torch.from_numpy(a.copy()).to(dev))
        decoded[t] = planes
    missing = [t for t in tiles if t not in decoded]
    if missing:
        raise RuntimeError(f"distributed decode lost tiles {missing[:8]}")
    if len(by_tile) == 1:
        return decoded[tiles[0]]
    canvas = api._Canvas(hdr, dp, dev)
    for t in tiles:
        canvas.paste(t, tile_body(t)[0], decoded[t])
    return canvas.planes
