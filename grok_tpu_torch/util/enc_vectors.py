"""The committed codestreams of the general encode (util/enc_vectors.npz):
reversible stream layouts of the (B) frame of chip_smoke.py (1920x1080
RGB, synthetic_image seed 7, 5/3 + RCT, 6 resolutions), coded by the JAX
package's grok_tpu.compress, which the card's encode of the same frame
must equal byte for byte:

  - lay_ht: HT at 24:1, precincts of 128 (256 at the three finest
    resolutions), a POC (resolutions 0-2 in RLCP, then 3-5 in CPRL),
    three tile-parts with TLM and PLM;
  - lay_ppm: Part-1 at 24:1, the same precincts, the packet headers in
    the main header (PPM);
  - lay_q: Part-1 in three quality layers (fixed_quality, PSNR targets
    of 20, 23 and 26 dB), PLT.

tests/test_torch_general_enc.py rebuilds them (make_enc_streams, a few
minutes on the CPU: the JAX package's HT coder is Python); save() writes
the file.
"""

from __future__ import annotations

import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "enc_vectors.npz")
NAMES = ("lay_ht", "lay_ppm", "lay_q")

# synthetic_image's (h, w, channels, seed): chip_smoke.py's (B) frame
FRAME = (1080, 1920, 3, 7)
_PREC = dict(prec_w_exps=[7, 7, 7, 8, 8, 8], prec_h_exps=[7, 7, 7, 8, 8, 8])
# the progression-order changes of lay_ht, as (rs, cs, layer_end, re, ce,
# ProgOrder value): RLCP, then CPRL
POCS = ((0, 0, 1, 3, 3, 1), (3, 0, 1, 6, 3, 4))
# CompressParams keywords of each stream ("pocs": POCS)
SPECS = {
    "lay_ht": dict(ht=True, num_resolutions=6, rates=[24.0], pocs=POCS,
                   max_tile_parts=3, write_tlm=True, write_plm=True,
                   **_PREC),
    "lay_ppm": dict(num_resolutions=6, rates=[24.0], write_ppm=True,
                    **_PREC),
    "lay_q": dict(num_resolutions=6, num_layers=3, fixed_quality=True,
                  quality=[20.0, 23.0, 26.0], write_plt=True),
}


def params(name: str, poc_cls, order_cls) -> dict:
    """SPECS[name] as CompressParams keywords, its POCs built with
    poc_cls and order_cls (the JAX package's or the port's Poc and
    ProgOrder)."""
    kw = dict(SPECS[name])
    if "pocs" in kw:
        kw["pocs"] = [poc_cls(rs=a, cs=b, layer_end=c, re=d, ce=e,
                              order=order_cls(o))
                      for a, b, c, d, e, o in kw["pocs"]]
    return kw


def load() -> dict:
    """{name: codestream bytes}."""
    with np.load(PATH) as z:
        return {n: z[n].tobytes() for n in NAMES}


def save(streams: dict, path: str = PATH) -> None:
    np.savez_compressed(path, **{n: np.frombuffer(streams[n], np.uint8)
                                 for n in NAMES})
