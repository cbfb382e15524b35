"""Un-stuffing of the raw HT refinement segments (HT SigProp, HT MagRef).

The port's copy of `_unstuff_lsb` from grok_tpu/t1ht/wire.py: the numpy
statement of the rule.  The general decode route un-stuffs every
refinement segment of a tile with its C mirror, native.ht_unstuff_batch,
which tests/test_torch_host.py holds byte-identical to this function.
"""

from __future__ import annotations

import numpy as np


def _unstuff_lsb(wire: np.ndarray) -> bytes:
    """Forward LSB-first wire bytes -> clean LSB-first bytes (MagSgn,
    SigProp, MagRef).  A byte following 0xFF carries 7 payload bits
    (bits 0..6)."""
    if wire.size == 0:
        return b""
    bits = np.unpackbits(wire, bitorder="little").reshape(-1, 8)
    keep = np.ones_like(bits, dtype=bool)
    keep[1:, 7] = wire[:-1] != 0xFF
    return np.packbits(bits[keep], bitorder="little").tobytes()
