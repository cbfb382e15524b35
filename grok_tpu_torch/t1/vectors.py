"""The committed Part-1 mode-switch test vectors (t1/mq_vectors.npz).

About 32 code-blocks of 4x4 to 16x16, coded by the JAX package's scalar
coder (grok_tpu/t1/t1_scalar.py) in code-block styles 0x00-0x3F (BYPASS,
RESET, TERMALL, VSC, PTERM, SEGSYM and their mixes), some with truncated
pass counts, with the scalar decoder's signed reconstruction of each.
They let the card check the Part-1 decode kernel (K3) on every mode
switch without the JAX package; tests/test_torch_mq.py regenerates them
from the scalar coder and requires them equal.
"""

from __future__ import annotations

import os

import numpy as np
import torch

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "mq_vectors.npz")
SIDE = 16          # the lanes' block dims (W = H)


def load() -> dict:
    """The vectors as numpy arrays: body (uint8), start, npass, nbps,
    orient, w, h, style (n,) int32; seg_lens (n, S) int32 padded with -1;
    mag2 (n, SIDE, SIDE) int32, the scalar decode, negative = sign."""
    with np.load(PATH) as z:
        return {k: z[k] for k in z.files}


def k3_lanes(v: dict, device) -> tuple:
    """t1_decode_lanes' arguments (before W, H) for the vectors on
    `device`."""
    from grok_tpu_torch.ops.t1_decode import segment_table
    segs = [[int(x) for x in row if x >= 0] for row in v["seg_lens"]]
    npass, ptbl = segment_table(v["npass"], v["nbps"], v["style"], segs)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
    return (torch.from_numpy(v["body"]).to(device), t(v["start"]), t(npass),
            t(v["nbps"]), t(v["orient"]), t(v["w"]), t(v["h"]),
            t(v["style"]), torch.from_numpy(ptbl).to(device))
