"""Inverse 5/3 and 9/7 lifting in NumPy (ISO/IEC 15444-1 Annex F).

The port's copy of the part of grok_tpu/transform/dwt_np.py it calls:
the 1D inverses that core/quant.py pushes impulses through to get the
band synthesis norms behind the irreversible step sizes and the PCRD
distortion weights.  The transforms of the pixels themselves run on the
device (ops/dwt.py).

9/7 scaling: the decoder's low *= K, high *= 2/K, then inverse lifting.
"""

from __future__ import annotations

import numpy as np

ALPHA = -1.586134342059924
BETA = -0.052980118572961
GAMMA = 0.882911075530934
DELTA = 0.443506852043971
K = 1.230174104914001


def _extend2(x: np.ndarray, pad: int) -> np.ndarray:
    """Whole-sample symmetric extension along the last axis (period 2(N-1))."""
    n = x.shape[-1]
    if n == 1:
        reps = [1] * (x.ndim - 1) + [2 * pad + 1]
        return np.tile(x, reps)
    idx = np.arange(-pad, n + pad)
    m = np.mod(idx, 2 * n - 2)
    m = np.where(m >= n, 2 * n - 2 - m, m)
    return x[..., m]


def _c_div2(v: np.ndarray) -> np.ndarray:
    """C-style truncating division by 2 (matches the reference's lone-sample
    path; only reachable on truncated lossy 5/3 streams)."""
    return np.sign(v) * (np.abs(v) >> 1)


def inv53_1d(low: np.ndarray, high: np.ndarray, off: int, n: int) -> np.ndarray:
    """Inverse 5/3: interleave (low, high) back to n samples at offset off."""
    if n == 0:
        return low[..., :0]
    if n == 1:
        if off % 2 == 0:
            return low.copy()
        return _c_div2(high)
    # int32 is ample for any Part-1 coefficient range and halves bandwidth
    y = np.empty(low.shape[:-1] + (n,), dtype=np.int32)
    if off % 2 == 0:
        y[..., 0::2] = low
        y[..., 1::2] = high
    else:
        y[..., 0::2] = high
        y[..., 1::2] = low
    ye = _extend2(y, 2)
    e = np.empty_like(ye)
    e[..., 1:-1] = ye[..., 1:-1] - ((ye[..., :-2] + ye[..., 2:] + 2) >> 2)
    o = ye[..., 2:-2] + ((e[..., 1:-3] + e[..., 3:-1]) >> 1)
    x = np.empty_like(y)
    if off % 2 == 0:
        x[..., 0::2] = e[..., 2:-2][..., 0::2]
        x[..., 1::2] = o[..., 1::2]
    else:
        x[..., 0::2] = o[..., 0::2]
        x[..., 1::2] = e[..., 2:-2][..., 1::2]
    return x


def inv97_1d(low: np.ndarray, high: np.ndarray, off: int, n: int) -> np.ndarray:
    if n == 0:
        return low[..., :0]
    if n == 1:
        if off % 2 == 0:
            return low.copy()
        return high / 2.0
    y = np.empty(low.shape[:-1] + (n,), dtype=np.float64)
    if off % 2 == 0:
        y[..., 0::2] = low * K
        y[..., 1::2] = high * (2.0 / K)
    else:
        y[..., 0::2] = high * (2.0 / K)
        y[..., 1::2] = low * K
    a = _extend2(y, 4)
    parity = off % 2

    def lift(arr, coef, target_parity):
        upd = arr[..., 1:-1] + coef * (arr[..., :-2] + arr[..., 2:])
        jpar = (np.arange(1, arr.shape[-1] - 1) + parity) % 2
        mask = jpar == target_parity
        out = arr.copy()
        out[..., 1:-1] = np.where(mask, upd, arr[..., 1:-1])
        return out

    a = lift(a, -DELTA, 0)
    a = lift(a, -GAMMA, 1)
    a = lift(a, -BETA, 0)
    a = lift(a, -ALPHA, 1)
    return a[..., 4:-4]
