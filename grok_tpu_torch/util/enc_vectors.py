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
    of 20, 23 and 26 dB), PLT;

and the mode-switch, HT-mixed and ROI encodes of the same frame
(MODE_NAMES, chip_smoke.py phase 25), coded by grok_tpu.compress_device
(DEVICE_MADE) or, for roi, by grok_tpu.compress (the same bytes on the
reversible path; on the CPU the JAX package's default-style device
coder fails on the frame's bottom-edge blocks of fewer than 6 rows):

  - ms_3f: Part-1, lossless, all six mode switches (style 0x3F);
  - ms_byp: Part-1 with BYPASS in three layers at 96:1, 48:1 and 24:1;
  - mix_lay: HT-mixed in three layers at 96:1, 48:1 and 24:1;
  - roi: Part-1, lossless, Maxshift ROI on component 0 in a centred 640 x
    360 roi_rect, at ROI_SHIFT, the smallest shift the JAX package does
    not warn about (the background's magnitude bits in the ROI's band
    windows).

The two lossless streams (about 4.7 MB each) are kept as their SHA-256
digests (HASHED), the others whole.  tests/test_torch_general_enc.py
rebuilds them (make_enc_streams, a few minutes on the CPU: the JAX
package's HT coder is Python); save() writes the file.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "enc_vectors.npz")
NAMES = ("lay_ht", "lay_ppm", "lay_q")
MODE_NAMES = ("ms_3f", "ms_byp", "mix_lay", "roi")
HASHED = ("ms_3f", "roi")
DEVICE_MADE = ("ms_3f", "ms_byp", "mix_lay")
ROI_SHIFT = 8

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
    "ms_3f": dict(num_resolutions=6, cblk_style=0x3F),
    "ms_byp": dict(num_resolutions=6, cblk_style=0x01, num_layers=3,
                   rates=[96.0, 48.0, 24.0]),
    "mix_lay": dict(num_resolutions=6, ht_mixed=True, num_layers=3,
                    rates=[96.0, 48.0, 24.0]),
    "roi": dict(num_resolutions=6, roi_comp=0, roi_shift=ROI_SHIFT,
                roi_rect=(640, 360, 1280, 720)),
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
    """{name: codestream bytes} of NAMES."""
    with np.load(PATH) as z:
        return {n: z[n].tobytes() for n in NAMES}


def load_modes() -> dict:
    """{name: (codestream bytes, or None for HASHED, SHA-256 hex digest)}
    of MODE_NAMES."""
    out = {}
    with np.load(PATH) as z:
        for n in MODE_NAMES:
            if n in HASHED:
                out[n] = (None, z[n + "_sha256"].tobytes().hex())
            else:
                data = z[n].tobytes()
                out[n] = (data, hashlib.sha256(data).hexdigest())
    return out


def matches(name: str, data: bytes, modes: dict) -> bool:
    """Whether `data` is the committed stream `name` of load_modes()."""
    whole, digest = modes[name]
    return hashlib.sha256(data).hexdigest() == digest and (
        whole is None or data == whole)


def save(streams: dict, path: str = PATH) -> None:
    """Write every stream of NAMES and MODE_NAMES (HASHED ones as their
    digests)."""
    arrays = {n: np.frombuffer(streams[n], np.uint8)
              for n in NAMES + MODE_NAMES if n not in HASHED}
    for n in HASHED:
        arrays[n + "_sha256"] = np.frombuffer(
            hashlib.sha256(streams[n]).digest(), np.uint8)
    np.savez_compressed(path, **arrays)
