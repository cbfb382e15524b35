"""Image model (grk_image equivalent): the port's copy of
grok_tpu/core/image.py.

Planar, per-component integer samples on the JPEG 2000 reference canvas,
with per-component subsampling, precision and signedness.  The port's
entry points take and return per-component tensors; the object API
(codec.py Decompressor.decompress) and the CLI tools return and read
this host Image, as the JAX package's do.

Reference parity: [grok: src/lib/core/util/GrkImage.* ; upstream
opj_image_create/opj_image_destroy verified in SURVEY.md §1.1].
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

import numpy as np


class ColorSpace(IntEnum):
    UNSPECIFIED = 0
    SRGB = 1
    GRAY = 2
    SYCC = 3
    EYCC = 4
    CMYK = 5


@dataclass
class Component:
    data: np.ndarray          # int32, shape (h, w) — component grid samples
    dx: int = 1               # subsampling (XRsiz)
    dy: int = 1
    prec: int = 8             # bit depth
    sgnd: bool = False

    @property
    def w(self) -> int:
        return self.data.shape[1]

    @property
    def h(self) -> int:
        return self.data.shape[0]

    def clip_range(self) -> tuple[int, int]:
        if self.sgnd:
            return -(1 << (self.prec - 1)), (1 << (self.prec - 1)) - 1
        return 0, (1 << self.prec) - 1


@dataclass
class Image:
    components: list[Component]
    x0: int = 0               # XOsiz
    y0: int = 0               # YOsiz
    x1: int = 0               # Xsiz (0 -> derive from component 0)
    y1: int = 0
    color_space: ColorSpace = ColorSpace.UNSPECIFIED
    icc_profile: bytes | None = None
    capture_resolution: tuple[float, float] | None = None
    comment: str | None = None
    meta: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.x1 == 0 and self.components:
            c = self.components[0]
            self.x1 = self.x0 + c.w * c.dx
            self.y1 = self.y0 + c.h * c.dy

    @property
    def numcomps(self) -> int:
        return len(self.components)

    @property
    def w(self) -> int:
        return self.x1 - self.x0

    @property
    def h(self) -> int:
        return self.y1 - self.y0

    @staticmethod
    def from_array(arr: np.ndarray, prec: int = 8, sgnd: bool = False,
                   color_space: ColorSpace | None = None) -> "Image":
        """Build from (h, w) gray or (h, w, c) interleaved array."""
        arr = np.asarray(arr)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        comps = [Component(data=arr[:, :, i].astype(np.int32), prec=prec,
                           sgnd=sgnd)
                 for i in range(arr.shape[2])]
        if color_space is None:
            color_space = ColorSpace.GRAY if len(comps) == 1 else ColorSpace.SRGB
        return Image(components=comps, color_space=color_space)

    def to_array(self) -> np.ndarray:
        """Interleave components (requires uniform size); squeeze gray."""
        datas = [c.data for c in self.components]
        if len({d.shape for d in datas}) != 1:
            raise ValueError("components differ in size; cannot interleave")
        out = np.stack(datas, axis=-1)
        return out[:, :, 0] if out.shape[-1] == 1 else out
