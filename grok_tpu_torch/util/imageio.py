"""Image-format readers/writers for the CLI tools.

Native implementations of the conformance-critical simple formats (PGX,
PNM/PGM/PPM, PAM, RAW/RAWL); PNG/TIFF/JPEG/BMP via Pillow when present.

Reference parity: [grok: src/bin/image_format/*.cpp — PGXFormat, PNMFormat,
RAWFormat, TIFFFormat, PNGFormat...].  The port's copy of
grok_tpu/util/imageio.py.
"""

from __future__ import annotations

import os
import re

import numpy as np

from grok_tpu_torch.core.image import ColorSpace, Component, Image

try:
    from PIL import Image as PILImage

    HAVE_PIL = True
except Exception:  # pragma: no cover
    HAVE_PIL = False


# -- PGX (ISO 15444-4 conformance raster) ------------------------------------

def read_pgx(path: str) -> Image:
    with open(path, "rb") as f:
        data = f.read()
    m = re.match(rb"PG[ \t]+(ML|LM)[ \t]*([+-])?\s*(\d+)[ \t]+(\d+)[ \t]+"
                 rb"(\d+)\s", data)
    if not m:
        raise ValueError(f"{path}: not a PGX file")
    endian = ">" if m.group(1) == b"ML" else "<"
    sgnd = m.group(2) == b"-"
    prec = int(m.group(3))
    w = int(m.group(4))
    h = int(m.group(5))
    off = m.end()
    nbytes = 1 if prec <= 8 else (2 if prec <= 16 else 4)
    base = {1: "i1" if sgnd else "u1", 2: "i2" if sgnd else "u2",
            4: "i4" if sgnd else "u4"}[nbytes]
    arr = np.frombuffer(data, dtype=endian + base, count=w * h,
                        offset=off).reshape(h, w).astype(np.int32)
    return Image(components=[Component(data=arr, prec=prec, sgnd=sgnd)],
                 color_space=ColorSpace.GRAY)


def write_pgx(path: str, img: Image, comp: int = 0):
    c = img.components[comp]
    nbytes = 1 if c.prec <= 8 else (2 if c.prec <= 16 else 4)
    base = {1: "i1" if c.sgnd else "u1", 2: "i2" if c.sgnd else "u2",
            4: "i4" if c.sgnd else "u4"}[nbytes]
    hdr = f"PG ML {'-' if c.sgnd else '+'}{c.prec} {c.w} {c.h}\n"
    with open(path, "wb") as f:
        f.write(hdr.encode())
        f.write(np.asarray(c.data, dtype=">" + base).tobytes())


# -- PNM / PGM / PPM ----------------------------------------------------------

def read_pnm(path: str) -> Image:
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] not in (b"P5", b"P6"):
        raise ValueError(f"{path}: only binary PGM (P5) / PPM (P6) supported")
    ncomp = 3 if data[:2] == b"P6" else 1
    # header tokens with comment support
    toks, pos = [], 2
    while len(toks) < 3:
        m = re.match(rb"\s*(#[^\n]*\n|\S+)", data[pos:])
        if not m:
            raise ValueError(f"{path}: bad PNM header")
        t = m.group(1)
        pos += m.end()
        if not t.startswith(b"#"):
            toks.append(int(t))
    w, h, maxval = toks
    pos += 1  # single whitespace after maxval
    prec = maxval.bit_length()
    dt = ">u2" if maxval > 255 else "u1"
    arr = np.frombuffer(data, dtype=dt, count=w * h * ncomp,
                        offset=pos - 1 if data[pos - 1:pos].isspace() is False
                        else pos)
    arr = arr.reshape(h, w, ncomp).astype(np.int32)
    comps = [Component(data=arr[:, :, i].copy(), prec=prec)
             for i in range(ncomp)]
    return Image(components=comps, color_space=ColorSpace.SRGB if ncomp == 3
                 else ColorSpace.GRAY)


def write_pnm(path: str, img: Image):
    comps = img.components
    ncomp = len(comps)
    if ncomp not in (1, 3):
        raise ValueError("PNM supports 1 or 3 components")
    prec = comps[0].prec
    maxval = (1 << prec) - 1
    magic = b"P6" if ncomp == 3 else b"P5"
    arr = np.stack([c.data for c in comps], axis=-1)
    dt = ">u2" if maxval > 255 else "u1"
    with open(path, "wb") as f:
        f.write(magic + b"\n%d %d\n%d\n" % (comps[0].w, comps[0].h, maxval))
        f.write(np.clip(arr, 0, maxval).astype(dt).tobytes())


# -- PAM (P7) -----------------------------------------------------------------

def read_pam(path: str) -> Image:
    """Netpbm PAM (P7): arbitrary depth incl. GRAYSCALE_ALPHA/RGB_ALPHA."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"P7":
        raise ValueError(f"{path}: not a PAM (P7) file")
    fields = {}
    pos = data.index(b"\n") + 1
    while True:
        end = data.index(b"\n", pos)
        line = data[pos:end].strip()
        pos = end + 1
        if not line or line.startswith(b"#"):
            continue
        if line == b"ENDHDR":
            break
        k, _, v = line.partition(b" ")
        fields[k.decode()] = v.decode().strip()
    w = int(fields["WIDTH"])
    h = int(fields["HEIGHT"])
    depth = int(fields["DEPTH"])
    maxval = int(fields["MAXVAL"])
    prec = maxval.bit_length()
    dt = ">u2" if maxval > 255 else "u1"
    arr = np.frombuffer(data, dtype=dt, count=w * h * depth, offset=pos)
    arr = arr.reshape(h, w, depth).astype(np.int32)
    comps = [Component(data=arr[:, :, i].copy(), prec=prec)
             for i in range(depth)]
    cs = ColorSpace.SRGB if depth >= 3 else ColorSpace.GRAY
    return Image(components=comps, color_space=cs)


def write_pam(path: str, img: Image):
    comps = img.components
    depth = len(comps)
    prec = comps[0].prec
    maxval = (1 << prec) - 1
    tupltype = {1: "GRAYSCALE", 2: "GRAYSCALE_ALPHA", 3: "RGB",
                4: "RGB_ALPHA"}.get(depth, "RGB")
    arr = np.stack([c.data for c in comps], axis=-1)
    dt = ">u2" if maxval > 255 else "u1"
    hdr = (f"P7\nWIDTH {comps[0].w}\nHEIGHT {comps[0].h}\n"
           f"DEPTH {depth}\nMAXVAL {maxval}\nTUPLTYPE {tupltype}\n"
           f"ENDHDR\n")
    with open(path, "wb") as f:
        f.write(hdr.encode())
        f.write(np.clip(arr, 0, maxval).astype(dt).tobytes())


# -- RAW ----------------------------------------------------------------------

def read_raw(path: str, w: int, h: int, ncomp: int, prec: int,
             sgnd: bool = False, little_endian: bool = False) -> Image:
    nbytes = 1 if prec <= 8 else (2 if prec <= 16 else 4)
    e = "<" if little_endian else ">"
    base = {1: "i1" if sgnd else "u1", 2: "i2" if sgnd else "u2",
            4: "i4" if sgnd else "u4"}[nbytes]
    arr = np.fromfile(path, dtype=e + base, count=w * h * ncomp)
    arr = arr.reshape(ncomp, h, w).astype(np.int32)
    return Image(components=[Component(data=arr[i], prec=prec, sgnd=sgnd)
                             for i in range(ncomp)])


def write_raw(path: str, img: Image, little_endian: bool = False):
    e = "<" if little_endian else ">"
    with open(path, "wb") as f:
        for c in img.components:
            nbytes = 1 if c.prec <= 8 else (2 if c.prec <= 16 else 4)
            base = {1: "i1" if c.sgnd else "u1", 2: "i2" if c.sgnd else "u2",
                    4: "i4" if c.sgnd else "u4"}[nbytes]
            f.write(np.asarray(c.data, dtype=e + base).tobytes())


# -- dispatch -----------------------------------------------------------------

_PIL_EXTS = {".png", ".tif", ".tiff", ".jpg", ".jpeg", ".bmp"}


def read_image(path: str) -> Image:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pgx":
        return read_pgx(path)
    if ext in (".pgm", ".ppm", ".pnm"):
        return read_pnm(path)
    if ext == ".pam":
        return read_pam(path)
    if ext in _PIL_EXTS:
        if not HAVE_PIL:
            raise RuntimeError("Pillow not available for " + ext)
        arr = np.array(PILImage.open(path))
        prec = 16 if arr.dtype == np.uint16 else 8
        return Image.from_array(arr.astype(np.int32), prec=prec)
    raise ValueError(f"unsupported input format {ext}")


def write_image(path: str, img: Image):
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pgx":
        return write_pgx(path, img)
    if ext in (".pgm", ".ppm", ".pnm"):
        return write_pnm(path, img)
    if ext == ".pam":
        return write_pam(path, img)
    if ext in _PIL_EXTS:
        if not HAVE_PIL:
            raise RuntimeError("Pillow not available for " + ext)
        arr = img.to_array()
        if img.components[0].prec <= 8:
            out = arr.astype(np.uint8)
        else:
            out = arr.astype(np.uint16)
        PILImage.fromarray(out).save(path)
        return
    raise ValueError(f"unsupported output format {ext}")
