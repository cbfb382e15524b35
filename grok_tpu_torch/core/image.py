"""Colour-space codes of the image model (grok_tpu/core/image.py).

The port takes and returns per-component tensors rather than an Image
object; it needs only the colour-space codes, which the JP2 wrapper
writes into the colr box.
"""

from __future__ import annotations

from enum import IntEnum


class ColorSpace(IntEnum):
    UNSPECIFIED = 0
    SRGB = 1
    GRAY = 2
    SYCC = 3
    EYCC = 4
    CMYK = 5
