"""Entry points of the port's device step and of its mesh: the
counterparts of __graft_entry__.py `entry` and `dryrun_multichip`.

entry(): the hot pair of the decode path on one device, the Part-1 block
decode (kernel K3) and the DWT round trip, over 4 blocks coded by K5.

dryrun_multichip(n): the sharded codec step over an n-shard mesh (the
tiles axis; virtual shards where fewer devices are visible), with the
global distortion statistic; a row-sharded inverse 5/3 level against the
unsharded one; and a codestream through the public entry points with
the mesh: the meshed decode equal to the source (5/3) and to the
unmeshed decode (9/7), the meshed encode byte-identical to the unmeshed.
"""

from __future__ import annotations

import numpy as np
import torch

from grok_tpu_torch.core.geometry import Rect
from grok_tpu_torch.ops import dwt


def entry(device="cuda"):
    """(step, args): step(*args) decodes 4 16x16 Part-1 blocks with
    t1_decode_lanes (K3 on a card, the plain version on the CPU), takes
    their coefficients sign * (|mag2| >> 1) through a 2-resolution
    forward and inverse 5/3 DWT, and returns (coefficients, round trip),
    which are equal."""
    from grok_tpu_torch.ops.t1_decode import t1_decode_lanes
    from grok_tpu_torch.ops.t1_encode import t1_encode_lanes
    from grok_tpu_torch.tools.hw_validate import (mq_decode_inputs,
                                                  mq_encode_inputs)

    dev = torch.device(device)
    W = H = 16
    B = 4
    rng = np.random.default_rng(0)
    mag = np.abs(rng.normal(0, 20, (B, H, W))).astype(np.int64)
    neg = rng.random((B, H, W)) < 0.5
    ins, (L, R) = mq_encode_inputs(((mag << 1) | neg).astype(np.int32),
                                   [b % 4 for b in range(B)], dev)
    out, lens, _rates, _sig = t1_encode_lanes(*ins, L, R)
    args = mq_decode_inputs(ins, out, lens)
    rect = Rect(0, 0, W, H)

    def step(*lanes):
        m2 = t1_decode_lanes(*lanes, W, H)
        coefs = torch.sign(m2) * (m2.abs() >> 1)
        bands = dwt.fwd_multilevel(coefs, rect, 2, False)
        return coefs, dwt.inv_multilevel(bands, rect, 2, False)

    return step, args


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One step of every mesh path over an n_devices-shard mesh of
    `device`'s type: the visible devices in turn, repeated where fewer
    are visible (virtual shards).  Raises AssertionError where a result
    differs; returns {"mesh": device names, "dist": the global
    statistic}."""
    from grok_tpu_torch import api
    from grok_tpu_torch.core.params import CompressParams, DecompressParams
    from grok_tpu_torch.parallel.sharding import (
        Mesh, make_codec_roundtrip_step, make_inv53_2d_sharded,
        shard_tile_batch, tile_mesh, unshard)
    from grok_tpu_torch.util.synth import synthetic_image

    visible = tile_mesh(device=device).devices
    mesh = Mesh(tuple(visible[i % len(visible)] for i in range(n_devices)))
    dev = mesh.first
    rng = np.random.default_rng(0)

    # the tile-batch codec step, 2 tiles a shard, and its statistic
    H = W = 16
    tiles = rng.integers(0, 256, (2 * n_devices, 3, H, W)).astype(np.int32)
    out, dist = make_codec_roundtrip_step(Rect(0, 0, W, H), 3)(
        shard_tile_batch(tiles, mesh))
    assert np.array_equal(unshard(out, mesh).cpu().numpy(), tiles), \
        "sharded codec step not lossless"
    assert bool(torch.isfinite(dist)), "distortion statistic not finite"

    # a row-sharded inverse 5/3 level with halo exchange
    R, Wd = 8 * n_devices, 16
    bands = [torch.from_numpy(rng.integers(-200, 200, (R // 2, Wd // 2))
                              .astype(np.int32)).to(dev) for _ in range(4)]
    inter = torch.empty((R, Wd), dtype=torch.int32, device=dev)
    for (a, b), band in zip(((0, 0), (0, 1), (1, 0), (1, 1)), bands):
        inter[a::2, b::2] = band
    got = unshard(make_inv53_2d_sharded(mesh, R // n_devices, Wd)(
        shard_tile_batch(inter, mesh)), mesh)
    ref = dwt.inv_2d_level(*bands, Rect(0, 0, Wd, R), False)
    assert torch.equal(got, ref), "sharded DWT level mismatch"

    # codestreams through the entry points with the mesh
    blk = dict(cblk_w_exp=3, cblk_h_exp=3)
    img = synthetic_image(96, 88, 1, seed=3)
    cs = api.compress_device(img, CompressParams(num_resolutions=3, **blk),
                             device=dev)
    got = api.decompress_device(cs, DecompressParams(mesh=mesh),
                                device=dev)[0]
    assert np.array_equal(got.cpu().numpy(), img), \
        "mesh-sharded decode not lossless"
    img2 = synthetic_image(64, 64, 1, seed=4)
    cs2 = api.compress_device(img2, CompressParams(
        irreversible=True, quant_step=0.002, **blk), device=dev)
    got2 = api.decompress_device(cs2, DecompressParams(mesh=mesh),
                                 device=dev)[0]
    ref2 = api.decompress_device(cs2, device=dev)[0]
    assert torch.equal(got2, ref2), "mesh-sharded 9/7 decode differs"
    p2 = dict(num_resolutions=2, **blk)
    assert api.compress_device(img2, CompressParams(mesh=mesh, **p2),
                               device=dev) == \
        api.compress_device(img2, CompressParams(**p2), device=dev), \
        "mesh-sharded encode differs"
    return {"mesh": [str(d) for d in mesh.devices], "dist": float(dist)}
