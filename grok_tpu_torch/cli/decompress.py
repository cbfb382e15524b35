"""grk_decompress-parity CLI on the card: decode J2K/JP2 to raster images.

The port's copy of grok_tpu/cli/decompress.py, with its flags and output
files, except that `--device` (cuda by default; cpu runs the kernels'
plain versions) takes the place of `-B/--backend`.  Each file is decoded
on the device through codec.py Decompressor (api.decompress_device; -T
through Decompressor.decompress_tile, -c selecting the components after
the decode) and written from the downloaded planes:

    python -m grok_tpu_torch.cli.decompress -i in.j2k -o out.ppm

[grok: src/bin/jp2/GrkDecompress.cpp]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from grok_tpu_torch.codec import Decompressor
from grok_tpu_torch.core.params import DecompressParams
from grok_tpu_torch.util import trace as _trace


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="grk_decompress",
        description="JPEG 2000 decoder on the GPU (grok_tpu_torch)")
    p.add_argument("-i", "--in-file")
    p.add_argument("-o", "--out-file", required=True)
    p.add_argument("-batch", "--in-dir")
    p.add_argument("-out_dir")
    p.add_argument("-r", "--reduce", type=int, default=0,
                   help="discard this many resolution levels")
    p.add_argument("-l", "--layers", type=int, default=0,
                   help="decode only the first N layers")
    p.add_argument("-T", "--tile", type=int, default=None,
                   help="decode a single tile")
    p.add_argument("-d", "--region", help="decode region x0,y0,x1,y1")
    p.add_argument("-c", "--components", help="component subset, e.g. 0,1")
    p.add_argument("-f", "--force", dest="permissive", action="store_true",
                   help="permissive mode: decode truncated/corrupt streams")
    p.add_argument("--device", default="cuda",
                   help="torch device the decode runs on (cuda, cpu)")
    p.add_argument("-e", "--repetitions", type=int, default=1,
                   help="repeat decode (performance measurement)")
    p.add_argument("-u", "--upsample", action="store_true",
                   help="upsample subsampled components to the full grid")
    p.add_argument("--force-rgb", action="store_true",
                   help="promote grayscale output to RGB")
    p.add_argument("--icc", dest="apply_icc", action="store_true",
                   help="apply an embedded ICC profile (to sRGB)")
    p.add_argument("-p", "--precision", type=int, default=None,
                   help="force output precision (bits); values are "
                        "shifted/clipped")
    p.add_argument("--trace", metavar="FILE",
                   help="write a perfetto-compatible trace of the "
                        "decode's spans (util/trace.py), each with its "
                        "parent and call id")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def force_precision(img, prec: int):
    """Shift every component to `prec` bits (grk_decompress -p)."""
    import numpy as np
    for c in img.components:
        if c.prec == prec:
            continue
        if c.prec < prec:
            c.data = np.asarray(c.data, np.int64) << (prec - c.prec)
        else:
            c.data = np.asarray(c.data, np.int64) >> (c.prec - prec)
        c.data = c.data.astype(np.int32)
        c.prec = prec
    return img


def decode_one(in_path: str, out_path: str, dp: DecompressParams,
               reps: int, verbose: bool, precision: int | None = None, *,
               device: str = "cuda", tile: int | None = None,
               components: list | None = None) -> int:
    from grok_tpu_torch.util.imageio import write_image
    with open(in_path, "rb") as f:
        data = f.read()
    t_best = float("inf")
    img = None
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        with _trace.trace("decompress"):
            dec = Decompressor(data, dp, cache_tiles=0, device=device)
            img = dec.decompress(tile=tile, components=components)
        t_best = min(t_best, time.perf_counter() - t0)
    if precision is not None:
        img = force_precision(img, precision)
    with _trace.trace("write_image"):
        write_image(out_path, img)
    if verbose:
        mp = img.w * img.h / 1e6
        print(f"[grk_decompress] {in_path} -> {out_path}: "
              f"{mp / t_best:.2f} MP/s", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    if a.trace:
        _trace.enable()
    dp = DecompressParams(reduce=a.reduce, max_layers=a.layers,
                          strict=not a.permissive, upsample=a.upsample,
                          force_rgb=a.force_rgb, apply_icc=a.apply_icc)
    if a.region:
        dp.window = tuple(int(v) for v in a.region.split(","))
    comps = [int(v) for v in a.components.split(",")] \
        if a.components else None
    sel = dict(device=a.device, tile=a.tile, components=comps)
    if a.in_dir:
        out_dir = a.out_dir or a.in_dir
        os.makedirs(out_dir, exist_ok=True)
        rc = 0
        for name in sorted(os.listdir(a.in_dir)):
            base, ext = os.path.splitext(name)
            if ext.lower() not in (".j2k", ".jp2", ".j2c", ".jpc", ".jph"):
                continue
            rc |= decode_one(os.path.join(a.in_dir, name),
                             os.path.join(out_dir, base + ".png"),
                             dp, a.repetitions, a.verbose, **sel)
        return rc
    if not a.in_file:
        print("error: -i or -batch required", file=sys.stderr)
        return 2
    rc = decode_one(a.in_file, a.out_file, dp, a.repetitions, a.verbose,
                    a.precision, **sel)
    if a.trace:
        import json as _json
        print(_json.dumps(_trace.collect(clear=False)), file=sys.stderr)
        _trace.write_perfetto(a.trace)
    return rc


if __name__ == "__main__":
    sys.exit(main())
