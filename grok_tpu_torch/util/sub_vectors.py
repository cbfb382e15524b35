"""The subsampled and mixed-precision 1080p and UHD frames of
chip_smoke.py phase 32, and the SHA-256 of grok_tpu.compress's bytes for
their reversible, untargeted encodes.

The frames are made in numpy from the smoke's seeded frames
(synthetic_image): the (B) frame, 1920x1080 RGB of seed 7, and the (C)
frame, 3840x2160 RGB of seed 9.

  - y422: (B) in BT.709 Y'CbCr, 10 bits, video range, chroma 4:2:2 (the
    mean of each horizontal pair): a broadcast or IMF master;
  - y420: (B) likewise in 8 bits, chroma 4:2:0 (the mean of each 2x2
    square): a video frame;
  - rgbd: (B)'s RGB and a 16-bit signed plane, a smooth field with
    noise: an RGB image beside an elevation or depth plane;
  - c420: (C) as y420, placed at (1, 1) on the canvas.

WORKLOADS names each encode's frame and its parameters (CompressParams
keywords of both packages).  HASHES holds the SHA-256 of grok_tpu.
compress's bytes for the reversible, untargeted ones, written by
tests/test_torch_subsampled.py make_sub_hashes and recomputed there; the
port's encodes on the card must give the same bytes.
"""

from __future__ import annotations

import hashlib

import numpy as np

from grok_tpu_torch.core.image import ColorSpace, Component, Image
from grok_tpu_torch.util.synth import synthetic_image

B_SOURCE = (1080, 1920, 7)        # height, width, seed
C_SOURCE = (2160, 3840, 9)
C_ORIGIN = (1, 1)

WORKLOADS = {
    "y422_ht": ("y422", dict(ht=True, num_resolutions=6)),
    "y422_97": ("y422", dict(num_resolutions=6, irreversible=True,
                             rates=[8.0])),
    "y420_p1": ("y420", dict(num_resolutions=6)),
    "y420_lay": ("y420", dict(ht=True, num_resolutions=6, num_layers=3,
                              rates=[40.0, 10.0, 4.0])),
    "rgbd_ht": ("rgbd", dict(ht=True, num_resolutions=6)),
    "rgbd_p1": ("rgbd", dict(num_resolutions=6)),
    "c420": ("c420", dict(ht=True, num_resolutions=6, tile_w=1024,
                          tile_h=1024, write_tlm=True)),
}

HASHES = {
    "y422_ht":
        "af1a101b0ee5540da2588f4e4e6e8ea6fadfeb470878e79ca1ac0e9270de2a61",
    "y420_p1":
        "7c84c35e890453c6b0d3a1a078a006e3533a40f266c9412e116facdae4d289c2",
    "rgbd_ht":
        "cd43968aae4034dd09efda2bb552d58e011501b37f5d3e6eaa74d3853b0d05e5",
    "rgbd_p1":
        "4c6fb59d0a9b31afc720c60c022bf9364f0c00ff68c21f975f5c5e2acec49442",
    "c420":
        "78b4abe1b6d5e831e279584fea96272ec2f7569936b64af3ace89e47df461d02",
}


def _mean_pool(x: np.ndarray, dx: int, dy: int) -> np.ndarray:
    """The mean of each dy x dx block (the edge repeated where the plane
    is not a multiple)."""
    h, w = x.shape
    H, W = -(-h // dy) * dy, -(-w // dx) * dx
    x = np.pad(x, ((0, H - h), (0, W - w)), mode="edge")
    return x.reshape(H // dy, dy, W // dx, dx).mean(axis=(1, 3))


def ycbcr709(rgb: np.ndarray, bits: int, dx: int, dy: int) -> list:
    """BT.709 Y'CbCr in video range at `bits` bits (Y' 16-235, Cb and Cr
    16-240 at 8 bits, scaled by 2^(bits - 8)), the chroma planes
    subsampled by (dx, dy) as the mean of each block."""
    r, g, b = (rgb[..., i].astype(np.float64) / 255.0 for i in range(3))
    y = 0.2126 * r + 0.7152 * g + 0.0722 * b
    cb, cr = (b - y) / 1.8556, (r - y) / 1.5748
    s = 1 << (bits - 8)
    return [np.rint((16 + 219 * y) * s).astype(np.int32)] + [
        np.rint((128 + 224 * _mean_pool(c, dx, dy)) * s).astype(np.int32)
        for c in (cb, cr)]


def depth_plane(h: int, w: int, seed: int) -> np.ndarray:
    """A 16-bit signed plane: a smooth field with noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    d = (12000 * np.sin(xx / 157.0) * np.cos(yy / 91.0)
         + 8000 * np.sin((xx + yy) / 413.0) + rng.normal(0, 60, (h, w)))
    return np.clip(np.rint(d), -32768, 32767).astype(np.int32)


def image(kind: str) -> Image:
    """The port's Image of frame `kind` (y422, y420, rgbd, c420)."""
    if kind == "c420":
        h, w, seed = C_SOURCE
        x0, y0 = C_ORIGIN
    else:
        h, w, seed = B_SOURCE
        x0 = y0 = 0
    rgb = synthetic_image(h, w, 3, seed=seed)
    if kind == "rgbd":
        comps = [Component(data=rgb[..., c].astype(np.int32))
                 for c in range(3)]
        comps.append(Component(data=depth_plane(h, w, seed), prec=16,
                               sgnd=True))
        return Image(components=comps, color_space=ColorSpace.SRGB)
    bits, (dx, dy) = {"y422": (10, (2, 1)), "y420": (8, (2, 2)),
                      "c420": (8, (2, 2))}[kind]
    planes = ycbcr709(rgb, bits, dx, dy)
    subs = [(1, 1), (dx, dy), (dx, dy)]
    return Image(components=[Component(data=p, dx=sx, dy=sy, prec=bits)
                             for p, (sx, sy) in zip(planes, subs)],
                 x0=x0, y0=y0, x1=x0 + w, y1=y0 + h,
                 color_space=ColorSpace.SYCC)


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()
