"""The committed general-route codestreams (util/stream_vectors.npz).

Three codestreams coded by the JAX package's grok_tpu.compress, each with
the sha256 of grok_tpu.decompress(strict=False)'s int32 planes at every
layer cap (`plane_hash`):

  - m1: a 1920x1080 RGB frame (synthetic_image seed 1), RCT + 5/3, 6
    resolutions, 64x64 code-blocks, Part-1 code-block style 0x3F
    (BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM) in 2 layers at 48:1 and
    24:1;
  - m2: the same frame with BYPASS alone, 2 layers at 40:1 and 20:1;
  - mmix: a 512x512 gray frame (seed 3) as an HT-mixed set in 2 layers
    at 16:1 and 8:1, with every other Part-1 codeword padded at encode
    time so that HT wins those blocks (the padding never reaches the
    stream: the HT codeword replaces it).

None of them is served: the port decodes them on its general device
route (pipeline/tile.py decode_tile, K3 and K1), which lets the card
check that route on real streams without the JAX package.
tests/test_torch_general.py rebuilds them with the JAX package and
requires them equal, byte for byte and hash for hash.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "stream_vectors.npz")
NAMES = ("m1", "m2", "mmix")
LAYER_CAPS = (1, 2)

# the encodes, as grok_tpu.CompressParams keywords, with their sources:
# (height, width, channels, synthetic_image seed, precision)
SPECS = {
    "m1": ((1080, 1920, 3, 1), dict(num_resolutions=6, cblk_style=0x3F,
                                    num_layers=2, rates=[48.0, 24.0])),
    "m2": ((1080, 1920, 3, 1), dict(num_resolutions=6, cblk_style=0x01,
                                    num_layers=2, rates=[40.0, 20.0])),
    "mmix": ((512, 512, 1, 3), dict(num_resolutions=6, ht_mixed=True,
                                    num_layers=2, rates=[16.0, 8.0])),
}


def plane_hash(planes) -> str:
    """sha256 of int32 component planes (numpy arrays or tensors), each
    in row-major order as little-endian int32, in component order."""
    h = hashlib.sha256()
    for p in planes:
        if hasattr(p, "detach"):
            p = p.detach().cpu().numpy()
        h.update(np.ascontiguousarray(p, "<i4").tobytes())
    return h.hexdigest()


def load() -> dict:
    """{name: (codestream bytes, {layer cap: plane hash})}."""
    out = {}
    with np.load(PATH) as z:
        for n in NAMES:
            out[n] = (z[n].tobytes(),
                      {k: str(z[f"{n}_sha{k}"]) for k in LAYER_CAPS})
    return out


def save(vectors: dict, path: str = PATH) -> None:
    """Write {name: (codestream bytes, {layer cap: plane hash})}."""
    arrays = {}
    for n, (data, hashes) in vectors.items():
        arrays[n] = np.frombuffer(data, np.uint8)
        for k, v in hashes.items():
            arrays[f"{n}_sha{k}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)
