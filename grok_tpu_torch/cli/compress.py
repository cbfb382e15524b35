"""grk_compress-parity CLI on the card: encode raster images to J2K/JP2.

The port's copy of grok_tpu/cli/compress.py, with its flags and output
files, except that `--device` (cuda by default; cpu runs the kernels'
plain versions) takes the place of `-B/--backend`.  Each image is read on
the host, uploaded and encoded on the device by api.compress_device; a
.jp2/.jph output is wrapped as grok_tpu.compress wraps it (the image's
colour space, ICC profile and capture resolution):

    python -m grok_tpu_torch.cli.compress -i in.ppm -o out.j2k

Flag spelling follows the reference tool where sensible
[grok: src/bin/jp2/GrkCompress.cpp].
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from dataclasses import replace

from grok_tpu_torch.api import compress_device
from grok_tpu_torch.codestream import jp2
from grok_tpu_torch.core.params import CompressParams, MCTMode, ProgOrder
from grok_tpu_torch.util.imageio import read_image


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="grk_compress",
        description="JPEG 2000 encoder on the GPU (grok_tpu_torch)")
    p.add_argument("-i", "--in-file", help="input image "
                   "(png/tif/jpg/bmp/pgm/ppm/pgx/raw)")
    p.add_argument("-o", "--out-file", required=True,
                   help="output .j2k/.jp2")
    p.add_argument("-batch", "--in-dir", help="encode every image in a folder")
    p.add_argument("-out_dir", help="output folder for batch mode")
    p.add_argument("-r", "--compression-ratios",
                   help="layer rates, e.g. 40,10,1 (1 or 0 = lossless last)")
    p.add_argument("-q", "--quality", help="layer PSNR targets, e.g. 30,40")
    p.add_argument("-n", "--resolutions", type=int, default=6)
    p.add_argument("-b", "--code-block-dims", default="64,64",
                   help="code-block WxH, e.g. 64,64")
    p.add_argument("-c", "--precinct-dims",
                   help="precinct dims per resolution, e.g. {128,128},{256,256}")
    p.add_argument("-t", "--tile-dims", help="tile WxH, e.g. 512,512")
    p.add_argument("-p", "--progression-order", default="LRCP",
                   choices=[o.name for o in ProgOrder])
    p.add_argument("-I", "--irreversible", action="store_true",
                   help="9/7 + ICT (lossy)")
    p.add_argument("-M", "--mode", type=int, default=0,
                   help="code-block style mode switches (bitmask)")
    p.add_argument("-HT", "--htj2k", action="store_true",
                   help="HTJ2K (Part 15) block coder — experimental "
                        "self-consistent tables, see t1ht docs")
    p.add_argument("--ht-mixed", action="store_true",
                   help="HT MIXED sets: per code-block the smaller of "
                        "the HT and Part-1 MQ streams (density <= pure "
                        "MQ; per-block choice in a COM bitmap)")
    p.add_argument("-S", "--sop", action="store_true", help="SOP markers")
    p.add_argument("-E", "--eph", action="store_true", help="EPH markers")
    p.add_argument("-R", "--roi", help="ROI: comp,shift (Maxshift)")
    p.add_argument("-G", "--guard-bits", type=int, default=2)
    p.add_argument("-C", "--comment", help="COM marker text")
    p.add_argument("-y", "--mct", type=int, choices=[0, 1, 2], default=None,
                   help="0=off, 1=RCT/ICT, 2=custom")
    p.add_argument("-PLT", action="store_true", help="write PLT markers")
    p.add_argument("-TLM", action="store_true", help="write TLM markers")
    p.add_argument("-PLM", action="store_true",
                   help="write PLM (main-header packet lengths)")
    p.add_argument("--device", default="cuda",
                   help="torch device the encode runs on (cuda, cpu)")
    p.add_argument("-F", "--raw-format",
                   help="raw input descriptor w,h,ncomp,prec[,s|u] "
                        "(for .raw big-endian / .rawl little-endian)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def params_from_args(a) -> CompressParams:
    params = CompressParams()
    params.num_resolutions = a.resolutions
    cw, ch = (int(v) for v in a.code_block_dims.split(","))
    params.cblk_w_exp = cw.bit_length() - 1
    params.cblk_h_exp = ch.bit_length() - 1
    if a.tile_dims:
        params.tile_w, params.tile_h = (int(v) for v in a.tile_dims.split(","))
    if a.precinct_dims:
        import re
        pairs = re.findall(r"\{(\d+),(\d+)\}", a.precinct_dims)
        if not pairs:
            raise SystemExit(
                f"grk_compress: bad precinct spec {a.precinct_dims!r} "
                "(expected {w,h}[,{w,h}...])")
        exps = [(int(w).bit_length() - 1, int(h).bit_length() - 1)
                for (w, h) in pairs]
        while len(exps) < params.num_resolutions:
            exps.append(exps[-1])
        params.prec_w_exps = [e[0] for e in exps]
        params.prec_h_exps = [e[1] for e in exps]
    params.prog_order = ProgOrder[a.progression_order]
    params.irreversible = a.irreversible
    params.cblk_style = a.mode
    params.ht = a.htj2k
    params.ht_mixed = a.ht_mixed
    params.sop = a.sop
    params.eph = a.eph
    params.num_guard_bits = a.guard_bits
    params.comment = a.comment
    params.write_plt = a.PLT
    params.write_tlm = a.TLM
    params.write_plm = a.PLM
    if a.mct is not None:
        params.mct = MCTMode(a.mct)
    if a.roi:
        comp, shift = (int(v) for v in a.roi.split(","))
        params.roi_comp, params.roi_shift = comp, shift
    if a.compression_ratios:
        params.rates = [float(v) for v in a.compression_ratios.split(",")]
        params.num_layers = len(params.rates)
    elif a.quality:
        params.quality = [float(v) for v in a.quality.split(",")]
        params.num_layers = len(params.quality)
        params.fixed_quality = True
    return params


def compress(img, params: CompressParams, device: str = "cuda") -> bytes:
    """grok_tpu.compress of a host Image, on `device`: the components'
    samples encoded by api.compress_device (one precision and
    signedness for all, as the port's encode takes them), the JP2 boxes
    as grok_tpu.compress writes them."""
    comps = img.components
    if len({(c.prec, c.sgnd) for c in comps}) != 1:
        raise NotImplementedError("encode of components of different "
                                  "precisions is not ported")
    if any((c.dx, c.dy) != (1, 1) for c in comps):
        raise NotImplementedError("encode of subsampled components is not "
                                  "ported")
    c0 = comps[0]
    stream = compress_device([c.data for c in comps],
                             replace(params, jp2=False), c0.prec, c0.sgnd,
                             device=device, origin=(img.x0, img.y0))
    if not params.jp2:
        return stream
    return jp2.wrap_jp2(
        stream, width=img.w, height=img.h, numcomps=len(comps),
        prec=c0.prec, sgnd=c0.sgnd, color_space=img.color_space,
        icc_profile=img.icc_profile,
        capture_resolution=img.capture_resolution,
        per_comp_prec=[(c.prec, c.sgnd) for c in comps])


def encode_one(in_path: str, out_path: str, params: CompressParams,
               verbose: bool, raw_format: str | None = None,
               device: str = "cuda") -> int:
    ext = os.path.splitext(in_path)[1].lower()
    if ext in (".raw", ".rawl"):
        if not raw_format:
            print("error: raw input needs -F w,h,ncomp,prec[,s|u]",
                  file=sys.stderr)
            return 2
        from grok_tpu_torch.util.imageio import read_raw
        parts = raw_format.split(",")
        w, h, nc, prec = (int(v) for v in parts[:4])
        sgnd = len(parts) > 4 and parts[4].strip().lower() == "s"
        img = read_raw(in_path, w, h, nc, prec, sgnd,
                       little_endian=ext == ".rawl")
    else:
        img = read_image(in_path)
    params.jp2 = out_path.lower().endswith((".jp2", ".jph"))
    t0 = time.perf_counter()
    data = compress(img, params, device)
    dt = time.perf_counter() - t0
    with open(out_path, "wb") as f:
        f.write(data)
    if verbose:
        mp = img.w * img.h / 1e6
        print(f"[grk_compress] {in_path} -> {out_path}: {len(data)} bytes, "
              f"{mp / dt:.2f} MP/s", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    params = params_from_args(a)
    if a.in_dir:
        # resumable batch encode: a manifest records finished outputs so a
        # killed job restarts at the first unwritten image (SURVEY.md §5
        # checkpoint/resume)
        import json
        out_dir = a.out_dir or a.in_dir
        os.makedirs(out_dir, exist_ok=True)
        manifest_path = os.path.join(out_dir, ".grk_manifest.json")
        done: dict = {}
        if os.path.exists(manifest_path):
            try:
                done = json.load(open(manifest_path))
            except Exception:
                done = {}
        rc = 0
        for name in sorted(os.listdir(a.in_dir)):
            base, ext = os.path.splitext(name)
            if ext.lower() not in (".png", ".tif", ".tiff", ".jpg", ".jpeg",
                                   ".bmp", ".pgm", ".ppm", ".pgx"):
                continue
            out_path = os.path.join(out_dir, base + ".jp2")
            if done.get(name) and os.path.exists(out_path):
                continue
            rc |= encode_one(os.path.join(a.in_dir, name), out_path,
                             params, a.verbose, device=a.device)
            done[name] = True
            with open(manifest_path, "w") as f:
                json.dump(done, f)
        return rc
    if not a.in_file:
        print("error: -i or -batch required", file=sys.stderr)
        return 2
    return encode_one(a.in_file, a.out_file, params, a.verbose,
                      a.raw_format, a.device)


if __name__ == "__main__":
    sys.exit(main())
