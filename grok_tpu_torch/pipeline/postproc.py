"""Post-decode image operations driven by JP2 metadata and decode params.

The container-level transforms the reference applies after tile decode
[grok: src/lib/core/codestream/FileFormatDecompress.cpp color handling,
src/bin/image_format post-ops]: palette (pclr/cmap) expansion, channel
reordering per cdef, grayscale->RGB promotion, component upsampling to
the finest grid, and ICC profile application (through Pillow's
littlecms binding, where Pillow is installed).  The port's copy of
grok_tpu/pipeline/postproc.py: host numpy on the downloaded planes of
codec.py Decompressor.decompress and the CLI tools.
"""

from __future__ import annotations

import numpy as np

from grok_tpu_torch.core.image import ColorSpace, Component, Image
from grok_tpu_torch.util.msg import warn


def apply_palette(img: Image, meta) -> Image:
    """Expand indexed components through pclr via the cmap box (I.5.3.5)."""
    if meta is None or meta.palette is None or not meta.cmap:
        return img
    pal = meta.palette
    entries = np.asarray(pal.entries, dtype=np.int64)      # (NE, NPC)
    if entries.ndim != 2 or not len(entries):
        return img
    new_comps = []
    for m in meta.cmap:
        if m.comp >= len(img.components):
            warn(f"cmap references missing component {m.comp}; skipped")
            return img
        src = img.components[m.comp]
        if m.typ == 1:                                     # palette lookup
            if m.pcol >= entries.shape[1]:
                warn(f"cmap references missing palette column {m.pcol}")
                return img
            idx = np.clip(src.data, 0, len(entries) - 1)
            data = entries[idx, m.pcol].astype(np.int32)
            prec = pal.bit_depths[m.pcol]
            sgnd = pal.sgnd[m.pcol]
        else:                                              # direct use
            data, prec, sgnd = src.data, src.prec, src.sgnd
        new_comps.append(Component(data=data, dx=src.dx, dy=src.dy,
                                   prec=prec, sgnd=sgnd))
    img.components = new_comps
    return img


def apply_cdef(img: Image, meta) -> Image:
    """Reorder channels so colour channels come first in assoc order,
    opacity channels after (I.5.3.6)."""
    if meta is None or not meta.cdef:
        return img
    n = len(img.components)
    if len(meta.cdef) != n or any(c.channel >= n for c in meta.cdef):
        return img
    colours = sorted((c for c in meta.cdef if c.typ == 0 and c.assoc > 0),
                     key=lambda c: c.assoc)
    alphas = [c for c in meta.cdef if c.typ in (1, 2)]
    rest = [c for c in meta.cdef
            if c not in colours and c not in alphas]
    order = [c.channel for c in colours + rest + alphas]
    if sorted(order) != list(range(n)) or order == list(range(n)):
        return img
    img.components = [img.components[i] for i in order]
    return img


def force_rgb(img: Image) -> Image:
    """Promote a grayscale image to RGB by replicating luma (the
    grk_decompress --force-rgb semantics for GRAY; sYCC/eYCC handling
    happens through the codestream MCT)."""
    if img.color_space not in (ColorSpace.GRAY, ColorSpace.UNSPECIFIED):
        return img
    if not img.components or len(img.components) > 2:
        return img
    luma = img.components[0]
    reps = [Component(data=luma.data.copy(), dx=luma.dx, dy=luma.dy,
                      prec=luma.prec, sgnd=luma.sgnd) for _ in range(3)]
    img.components = reps + list(img.components[1:])      # keep alpha last
    img.color_space = ColorSpace.SRGB
    return img


def upsample(img: Image) -> Image:
    """Replicate subsampled components up to the finest component grid."""
    if not img.components:
        return img
    min_dx = min(c.dx for c in img.components)
    min_dy = min(c.dy for c in img.components)
    ref_shape = None
    for c in img.components:
        if c.dx == min_dx and c.dy == min_dy:
            ref_shape = c.data.shape
            break
    out = []
    for c in img.components:
        fx, fy = c.dx // min_dx, c.dy // min_dy
        data = c.data
        if fx > 1 or fy > 1:
            data = np.repeat(np.repeat(data, fy, axis=0), fx, axis=1)
            if ref_shape is not None:
                data = data[:ref_shape[0], :ref_shape[1]]
                if data.shape != ref_shape:     # pad edge replication
                    py = ref_shape[0] - data.shape[0]
                    px = ref_shape[1] - data.shape[1]
                    data = np.pad(data, ((0, py), (0, px)), mode="edge")
        out.append(Component(data=data, dx=min_dx, dy=min_dy,
                             prec=c.prec, sgnd=c.sgnd))
    img.components = out
    return img


def apply_icc(img: Image) -> Image:
    """Transform pixel values through the embedded ICC profile to sRGB
    (8-bit 1/3-component images; requires Pillow's littlecms binding)."""
    if img.icc_profile is None:
        return img
    comps = img.components
    if len(comps) not in (1, 3) or any(c.prec != 8 or c.sgnd
                                       for c in comps):
        warn("ICC profile present but not applicable "
             "(need unsigned 8-bit, 1 or 3 components); skipped")
        return img
    if len({c.data.shape for c in comps}) != 1:
        warn("ICC apply skipped: subsampled components (upsample first)")
        return img
    try:
        import io

        from PIL import Image as PILImage, ImageCms
        src_prof = ImageCms.ImageCmsProfile(io.BytesIO(img.icc_profile))
        dst_prof = ImageCms.createProfile("sRGB")
        mode = "L" if len(comps) == 1 else "RGB"
        arr = comps[0].data.astype(np.uint8) if mode == "L" else \
            np.stack([c.data for c in comps], axis=-1).astype(np.uint8)
        pim = PILImage.fromarray(arr, mode=mode)
        out = ImageCms.profileToProfile(pim, src_prof, dst_prof,
                                        outputMode="RGB")
        res = np.asarray(out).astype(np.int32)
        c0 = comps[0]
        img.components = [Component(data=res[..., i], dx=c0.dx, dy=c0.dy,
                                    prec=8, sgnd=False) for i in range(3)]
        img.color_space = ColorSpace.SRGB
        img.icc_profile = None
    except Exception as e:                    # corrupt profile: keep pixels
        warn(f"ICC profile application failed ({e}); returning raw pixels")
    return img


def postprocess(img: Image, meta, dp) -> Image:
    """Apply the standard post-decode chain in the reference's order:
    palette -> cdef -> (optional) upsample, force-rgb, ICC."""
    img = apply_palette(img, meta)
    img = apply_cdef(img, meta)
    if getattr(dp, "upsample", False):
        img = upsample(img)
    if getattr(dp, "force_rgb", False):
        img = force_rgb(img)
    if getattr(dp, "apply_icc", False):
        img = apply_icc(img)
    return img
