"""EBCOT Tier-1 context formation (ISO/IEC 15444-1 D.3).

The port's copy of grok_tpu/t1/luts.py: zero-coding, sign-coding and
magnitude-refinement context rules (Tables D.1-D.3) and the LUT builders.
The port's coders index LUTs built from these rules over the packed
neighbour-flag word (ops/t1_decode.py `flag_luts`).
"""

from __future__ import annotations

import numpy as np

from grok_tpu_torch.core.geometry import BAND_HH, BAND_HL, BAND_LH, BAND_LL


def zc_context(orient: int, h: int, v: int, d: int) -> int:
    """Zero-coding context 0..8 from significant-neighbor counts.

    h, v in [0,2]; d in [0,4].  LL and LH use the H-dominant column of
    Table D.1, HL swaps h/v, HH is diagonal-dominant.
    """
    if orient == BAND_HL:
        h, v = v, h
    if orient in (BAND_LL, BAND_LH, BAND_HL):
        if h == 2:
            return 8
        if h == 1:
            if v >= 1:
                return 7
            return 6 if d >= 1 else 5
        if v == 2:
            return 4
        if v == 1:
            return 3
        return 2 if d >= 2 else (1 if d == 1 else 0)
    # HH
    if d >= 3:
        return 8
    if d == 2:
        return 7 if h + v >= 1 else 6
    if d == 1:
        hv = h + v
        return 5 if hv >= 2 else (4 if hv == 1 else 3)
    hv = h + v
    return 2 if hv >= 2 else (1 if hv == 1 else 0)


def sc_context(hsum: int, vsum: int) -> tuple[int, int]:
    """Sign-coding (context, xor-bit) from clamped neighbor sign sums
    (Table D.2).  hsum/vsum in {-1, 0, 1}."""
    if hsum == 1:
        return (13, 0) if vsum == 1 else ((12, 0) if vsum == 0 else (11, 0))
    if hsum == 0:
        return (10, 0) if vsum == 1 else ((9, 0) if vsum == 0 else (10, 1))
    return (11, 1) if vsum == 1 else ((12, 1) if vsum == 0 else (13, 1))


def mr_context(any_sig_neighbor: bool, refined_before: bool) -> int:
    """Magnitude-refinement context (Table D.3)."""
    if refined_before:
        return 16
    return 15 if any_sig_neighbor else 14


def build_zc_lut() -> np.ndarray:
    """LUT [orient, h, v, d] -> context."""
    lut = np.zeros((4, 3, 3, 5), dtype=np.int8)
    for orient in range(4):
        for h in range(3):
            for v in range(3):
                for d in range(5):
                    lut[orient, h, v, d] = zc_context(orient, h, v, d)
    return lut


def build_sc_lut() -> tuple[np.ndarray, np.ndarray]:
    """LUTs [hsum+1, vsum+1] -> (context, xorbit)."""
    ctx = np.zeros((3, 3), dtype=np.int8)
    xor = np.zeros((3, 3), dtype=np.int8)
    for hs in (-1, 0, 1):
        for vs in (-1, 0, 1):
            c, x = sc_context(hs, vs)
            ctx[hs + 1, vs + 1] = c
            xor[hs + 1, vs + 1] = x
    return ctx, xor
