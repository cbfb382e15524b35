"""Synthetic test content (grok_tpu/util/oracle.py `synthetic_image`)."""

from __future__ import annotations

import numpy as np


def synthetic_image(h: int, w: int, channels: int = 1,
                    seed: int = 0) -> np.ndarray:
    """Natural-ish test content: gradients + sinusoid texture + noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = (
        96 + 80 * np.sin(xx / 23.0) * np.cos(yy / 17.0)
        + 40 * (xx / max(w - 1, 1))
        + 24 * (yy / max(h - 1, 1))
    )
    out = np.empty((h, w, channels), dtype=np.uint8)
    for c in range(channels):
        chan = base + 12 * rng.standard_normal((h, w)) + 20 * c
        out[:, :, c] = np.clip(chan, 0, 255).astype(np.uint8)
    return out[:, :, 0] if channels == 1 else out
