"""The committed mixed-filter codestreams (util/mixed_vectors.npz).

Two codestreams coded by the JAX package's grok_tpu.compress with
component 1 on the 9/7 filter and components 0 and 2 on the 5/3 (a
main-header COC selecting the 9/7 and a QCC with its derived step sizes;
tests/test_torch_mixed_filter.py make_mixed_vectors writes them), from a
1920x1080 RGB frame (synthetic_image seed 1) without a multiple
component transform, 6 resolutions, 64x64 code-blocks, at 24:1:

  - p1: Part-1 code-blocks;
  - ht: HT code-blocks.

Beside each stream, what grok_tpu.decompress decodes from it: the
sha256 of its 5/3 planes (components 0 and 2, `plane_hash`), whole and
cropped to WINDOW, and its 9/7 plane (component 1) as uint8, against
which a decode is held within +-1 (the f32 9/7 synthesis).  The port
decodes both streams served and on its general route (the card checks
them in chip_smoke.py without the JAX package).
"""

from __future__ import annotations

import os

import numpy as np

from grok_tpu_torch.util.stream_vectors import plane_hash

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "mixed_vectors.npz")
NAMES = ("p1", "ht")
SOURCE = (1080, 1920, 3, 1)      # height, width, channels, seed
IRREV_COMP = 1
WINDOW = (333, 211, 845, 723)    # x0, y0, x1, y1: a 512x512 region

# the encodes, as grok_tpu.CompressParams keywords
SPECS = {
    "p1": dict(num_resolutions=6, mct=0, rates=[24.0]),
    "ht": dict(num_resolutions=6, mct=0, rates=[24.0], ht=True),
}


def crop(plane, window=WINDOW):
    """The window's region of a whole-image plane."""
    x0, y0, x1, y1 = window
    return plane[y0:y1, x0:x1]


def exact_hashes(planes) -> tuple:
    """(whole, window) hashes of the 5/3 planes of a whole decode."""
    rev = [p for c, p in enumerate(planes) if c != IRREV_COMP]
    return plane_hash(rev), plane_hash([crop(p) for p in rev])


def load() -> dict:
    """{name: (codestream bytes, whole hash, window hash, the 9/7 plane
    as (H, W) uint8)}."""
    out = {}
    with np.load(PATH) as z:
        for n in NAMES:
            out[n] = (z[n].tobytes(), str(z[f"{n}_sha"]),
                      str(z[f"{n}_sha_win"]), z[f"{n}_irrev"])
    return out


def save(vectors: dict, path: str = PATH) -> None:
    """Write {name: (codestream bytes, whole hash, window hash, 9/7
    plane)}."""
    arrays = {}
    for n, (data, sha, sha_win, irrev) in vectors.items():
        arrays[n] = np.frombuffer(data, np.uint8)
        arrays[f"{n}_sha"] = np.asarray(sha)
        arrays[f"{n}_sha_win"] = np.asarray(sha_win)
        arrays[f"{n}_irrev"] = np.asarray(irrev, np.uint8)
    np.savez_compressed(path, **arrays)
