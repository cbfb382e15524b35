"""Frames made from the seed, on the device that runs the cell.

The content is that of the port's `util/synth.py` `synthetic_image`
(gradients, a sinusoid texture and Gaussian noise of sigma 12, each
component offset by 20), frozen here so that a change to the port does
not change the benchmark's input.  The noise comes from one
`torch.Generator` on the device, drawn in one call for the whole pool,
so the same seed gives the same frames on the same kind of device.
Frame k of a pool is panned by 8 k columns, so that no two frames share
their texture; every seed gives frames of the same sizes and the same
structure, and only the noise differs.
"""

from __future__ import annotations

import torch


def pool(n: int, h: int, w: int, channels: int, seed: int, device,
         precision: int = 8) -> torch.Tensor:
    """(n, channels, h, w) uint8 (precision 8) or int32 frames on
    `device`, clipped to [0, 2**precision - 1]."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    noise = torch.randn((n, channels, h, w), generator=gen, device=dev,
                        dtype=torch.float32)
    yy = torch.arange(h, device=dev, dtype=torch.float64)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float64)[None, :]
    shift = 8.0 * torch.arange(n, device=dev, dtype=torch.float64)
    xs = xx[None] + shift[:, None, None]
    base = (96 + 80 * torch.sin(xs / 23.0) * torch.cos(yy[None] / 17.0)
            + 40 * (xx[None] / max(w - 1, 1))
            + 24 * (yy[None] / max(h - 1, 1)))
    scale = float((1 << precision) - 1) / 255.0
    top = float((1 << precision) - 1)
    comp = 20.0 * torch.arange(channels, device=dev, dtype=torch.float64)
    out = torch.empty((n, channels, h, w), device=dev,
                      dtype=torch.uint8 if precision <= 8 else torch.int32)
    for c in range(channels):                # one component at a time
        chan = (base + 12 * noise[:, c].double() + comp[c]) * scale
        out[:, c] = chan.clamp_(0, top).to(out.dtype)
    return out
