"""The committed wide-code-block codestreams (util/wide_vectors.npz), the
plane hashes of their decodes, and the strict decodes' outcomes.

Five codestreams coded by the JAX package's grok_tpu.compress from the
1920x1080 RGB frame of util/stream_vectors.py's m1 (synthetic_image seed
1), each 5/3, 6 resolutions, with code-blocks over 64 on a side:

  - wh: HT, 1024x4 code-blocks, one layer at 24:1 (a line-based,
    low-latency video stream: a row of blocks completes after 4 lines).
    Cleanup-only HT codes a block whole or drops it, and at 24:1 every
    block of the first decomposition level (the 1024x4 buckets) is
    dropped;
  - whl: HT, 1024x4 code-blocks, lossless, the frame's top 32 lines (a
    slice of the same low-latency stream at the rate of a contribution
    link): every block coded, 36 lanes of 960x4 in the 1024x4 bucket;
  - wr: HT with ht_planes=2 (SigProp and MagRef passes), 256x16
    code-blocks, 2 layers at 48:1 and 24:1;
  - w1: Part-1 default style, 128x32 code-blocks, one layer at 24:1 (an
    archive's blocks);
  - w1s: Part-1 style 0x3F (every mode switch), 16x256 code-blocks, 2
    layers at 48:1 and 24:1.

`CASES` names each decode with its parameters (layer caps, a 512x512
window at (333, 211)); `hashes` holds the sha256 (util/stream_vectors.py
plane_hash) of grok_tpu.decompress(strict=False) of each (a window case
hashes the window's samples).

The committed edits break the codewords of 24 code-blocks of
damaged_vectors.py's h (HT, 64x64 blocks, 2 layers), a byte of each
block's cleanup suffix overwritten (seed BAD_SEED), so that the packets
parse and the blocks meet invalid CxtVLC codewords: hbad with zero bytes,
hbad_rand with random ones.  `hashes["hbad"]` is hbad's permissive decode
(the JAX package's scalar decoder zeroes such blocks; so does K1).
hbad_rand also leaves blocks that decode to magnitudes of 2^31 or more,
which the port re-decodes in int64 (ops/ht_decode.py MARK_I64), so that
its decode of both gives `hashes` (the plain versions on the CPU and the
kernels on the card).  `strict` holds what
grok_tpu.decompress_device(strict=True) gives for both, for m1 and wh,
and for every stream of damaged_vectors.py's CASES: the exception's type
name and message, or "planes" and the plane hash (for the PPM stream
grok_tpu.decompress(strict=True)'s: the JAX package's decompress_device
does not merge a main-header PPM and decodes it wrong, ROADMAP §3).
tests/test_torch_wide_blocks.py rebuilds the streams (make_wide_streams,
a few minutes on the CPU), the hashes and outcomes (make_wide_hashes,
make_strict_outcomes); save() writes the file.
"""

from __future__ import annotations

import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "wide_vectors.npz")
NAMES = ("wh", "whl", "wr", "w1", "w1s")

# synthetic_image's (h, w, channels, seed), and the rows kept
_M1 = (1080, 1920, 3, 1)
_M1_TOP32 = _M1 + (32,)
# grok_tpu.CompressParams keywords of each stream
SPECS = {
    "wh": (_M1, dict(ht=True, num_resolutions=6, cblk_w_exp=10,
                     cblk_h_exp=2, rates=[24.0])),
    "whl": (_M1_TOP32, dict(ht=True, num_resolutions=6, cblk_w_exp=10,
                            cblk_h_exp=2)),
    "wr": (_M1, dict(ht=True, ht_planes=2, num_resolutions=6, cblk_w_exp=8,
                     cblk_h_exp=4, num_layers=2, rates=[48.0, 24.0])),
    "w1": (_M1, dict(num_resolutions=6, cblk_w_exp=7, cblk_h_exp=5,
                     rates=[24.0])),
    "w1s": (_M1, dict(num_resolutions=6, cblk_w_exp=4, cblk_h_exp=8,
                      cblk_style=0x3F, num_layers=2, rates=[48.0, 24.0])),
}

WINDOW = (333, 211, 845, 723)

# name: (stream, decode parameters)
CASES = {
    "wh": ("wh", {}),
    "wh_win": ("wh", {"window": WINDOW}),
    "whl": ("whl", {}),
    "wr_L1": ("wr", {"max_layers": 1}),
    "wr_L2": ("wr", {"max_layers": 2}),
    "w1": ("w1", {}),
    "w1_win": ("w1", {"window": WINDOW}),
    "w1s_L1": ("w1s", {"max_layers": 1}),
    "w1s_L2": ("w1s", {"max_layers": 2}),
    "hbad": ("hbad", {}),
    "hbad_rand": ("hbad_rand", {}),
}

# the seed and block count of the codeword edits on damaged_vectors' h,
# and the byte of hbad's (hbad_rand's are random)
BAD_SEED, BAD_BLOCKS, BAD_BYTE = 3, 24, 0x00
EDITED = ("hbad", "hbad_rand")
def load() -> tuple:
    """({name: codestream bytes}, {case: plane hash}, {name: edits (k,
    2) int64 [offset, byte]} of hbad and hbad_rand, {stream: (outcome,
    detail)} of the strict decodes)."""
    with np.load(PATH) as z:
        streams = {n: z[n].tobytes() for n in NAMES}
        hashes = {c: str(z[f"sha_{c}"]) for c in CASES}
        edits = {n: z[f"edits_{n}"] for n in EDITED}
        strict = {str(k): (str(a), str(b)) for k, a, b in z["strict"]}
    return streams, hashes, edits, strict


def apply_edits(data: bytes, edits) -> bytes:
    """data with edits[i] = (offset, byte) written over it."""
    out = bytearray(data)
    for off, b in np.asarray(edits).tolist():
        out[off] = b
    return bytes(out)


def save(streams: dict, hashes: dict, edits, strict: dict,
         path: str = PATH) -> None:
    arrays = {n: np.frombuffer(streams[n], np.uint8) for n in NAMES}
    for c, v in hashes.items():
        arrays[f"sha_{c}"] = np.asarray(v)
    for n in EDITED:
        arrays[f"edits_{n}"] = np.asarray(edits[n], np.int64).reshape(-1, 2)
    arrays["strict"] = np.asarray([(k, a, b) for k, (a, b) in
                                   strict.items()])
    np.savez_compressed(path, **arrays)
