"""The committed damaged, packed-header and ROI codestreams
(util/damaged_vectors.npz) and the plane hashes of their decodes.

Four codestreams coded by the JAX package's grok_tpu.compress from the
1920x1080 RGB frame of util/stream_vectors.py's m1 (synthetic_image seed
1), each 5/3, 6 resolutions, 64x64 code-blocks:

  - h: HT, 2 layers at 48:1 and 24:1;
  - ppm: Part-1, 2 layers at 48:1 and 24:1, with the packet headers
    packed in the main header (PPM);
  - sop: Part-1, 2 layers at 48:1 and 24:1, with SOP and EPH markers;
  - roi: HT at 24:1 in 1024x1024 tiles, a Maxshift ROI on component 0
    over a 512x512 rect (main-header RGN), component 2 coded with 5
    resolutions (COC, QCC) and a progression change (POC), the COC, QCC
    and POC moved into every tile's header (util/stream_edit.py
    move_to_tile_parts).

`CASES` names each decode that util/stream_edit.py derives from them and
from the committed m1, m2 and mmix (cut at a share of their bytes, the
PPM stream turned to PPT, the first 4 bytes of a mid-stream packet of
the SOP stream, its SOP marker, inverted), with its decode parameters.  `hashes` holds the
sha256 (util/stream_vectors.py plane_hash) of the JAX package's decode
of each: grok_tpu.decompress(strict=False), with each Part-1 code-block
decoded by the JAX package's C block decoder within its own bytes
(tests/test_torch_t2_parse.py: where a cut leaves a block short, its
tile decoder reads past them).  A window case hashes the window's
samples.  tests/test_torch_t2_parse.py rebuilds the Part-1 streams byte
for byte and every hash (its make_damaged_streams rebuilds all four
streams, the HT ones in minutes; save() writes the file).
"""

from __future__ import annotations

import os

import numpy as np

from grok_tpu_torch.util import stream_edit, stream_vectors

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "damaged_vectors.npz")
NAMES = ("h", "ppm", "sop", "roi")

ROI_RECT = (704, 284, 1216, 796)
# grok_tpu.CompressParams keywords of each stream (the POC as
# (rs, cs, layer_end, re, ce, order) rows), with (component, resolutions)
# for a COC
_M1 = (1080, 1920, 3, 1)
SPECS = {
    "h": (_M1, dict(ht=True, num_resolutions=6, num_layers=2,
                    rates=[48.0, 24.0]), None),
    "ppm": (_M1, dict(num_resolutions=6, num_layers=2, rates=[48.0, 24.0],
                      write_ppm=True), None),
    "sop": (_M1, dict(num_resolutions=6, num_layers=2, rates=[48.0, 24.0],
                      sop=True, eph=True), None),
    "roi": (_M1, dict(ht=True, num_resolutions=6, rates=[24.0],
                      tile_w=1024, tile_h=1024, roi_comp=0, roi_shift=4,
                      roi_rect=ROI_RECT,
                      pocs=[(0, 0, 1, 3, 3, 4), (3, 0, 1, 6, 3, 2)]),
            (2, 5)),
}

# name: (stream, edit, decode parameters)
CASES = {
    "m1_cut50": ("m1", ("cut", 0.5), {}),
    "m1_cut50_L1": ("m1", ("cut", 0.5), {"max_layers": 1}),
    "m1_cut80": ("m1", ("cut", 0.8), {}),
    "m1_cut80_L1": ("m1", ("cut", 0.8), {"max_layers": 1}),
    "m2_cut50": ("m2", ("cut", 0.5), {}),
    "mmix_cut80": ("mmix", ("cut", 0.8), {}),
    "h_cut50": ("h", ("cut", 0.5), {}),
    "h_cut80": ("h", ("cut", 0.8), {}),
    "ppm": ("ppm", None, {}),
    "ppt": ("ppm", ("ppt",), {}),
    "sop_flip": ("sop", ("flip",), {}),
    "roi": ("roi", None, {}),
    "roi_win": ("roi", None, {"window": ROI_RECT}),
}


def flip_mid_packet(data: bytes) -> bytes:
    """The 4 first bytes of the middle packet (by SOP markers) of a
    stream with SOP inverted, its SOP marker among them: the parse loses
    sync there and resyncs on the next packet's SOP."""
    sops = []
    at = data.find(b"\xff\x91\x00\x04")
    while at >= 0:
        sops.append(at)
        at = data.find(b"\xff\x91\x00\x04", at + 6)
    if not sops:
        raise ValueError("the stream has no SOP marker")
    return stream_edit.flip(data, sops[len(sops) // 2], 4)


def stream(case: str, streams: dict) -> bytes:
    """The codestream of a case, from {name: bytes} of the committed
    streams (stream_vectors' and these)."""
    name, edit, _dp = CASES[case]
    data = streams[name]
    if edit is None:
        return data
    if edit[0] == "cut":
        return stream_edit.cut(data, edit[1])
    if edit[0] == "ppt":
        return stream_edit.ppm_to_ppt(data)
    return flip_mid_packet(data)


def window_planes(planes, window) -> list:
    """The window's samples of full-canvas planes (no subsampling)."""
    x0, y0, x1, y1 = window
    return [p[y0:y1, x0:x1] for p in planes]


def load() -> tuple:
    """({name: codestream bytes}, {case: plane hash})."""
    with np.load(PATH) as z:
        streams = {n: z[n].tobytes() for n in NAMES}
        hashes = {c: str(z[f"sha_{c}"]) for c in CASES}
    return streams, hashes


def all_streams() -> tuple:
    """({name: bytes} of the committed streams here and in
    stream_vectors.npz, {case: plane hash})."""
    streams, hashes = load()
    streams.update({n: d for n, (d, _h) in stream_vectors.load().items()})
    return streams, hashes


def save(streams: dict, hashes: dict, path: str = PATH) -> None:
    arrays = {n: np.frombuffer(streams[n], np.uint8) for n in NAMES}
    for c, v in hashes.items():
        arrays[f"sha_{c}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)
