"""Device DWT in PyTorch: 5/3 reversible (int32) and 9/7 irreversible
(float32) lifting, vectorized over leading batch axes.

Port of grok_tpu/ops/dwt.py, operation for operation: 5/3 is bit-exact
against it and against the NumPy oracle grok_tpu/transform/dwt_np.py;
9/7 matches to f32 rounding.  Every lifting pass is a whole-array shifted
add; the serving decode runs each level once on a stacked (N, H, W)
tensor for all N streams of a batch.

Reference parity: [grok: src/lib/core/transform/WaveletFwd,
WaveletReverse] — behavior normative per ISO 15444-1 Annex F.
"""

from __future__ import annotations

import torch

from grok_tpu_torch.core.geometry import Rect

ALPHA = -1.586134342059924
BETA = -0.052980118572961
GAMMA = 0.882911075530934
DELTA = 0.443506852043971
K = 1.230174104914001


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Whole-sample symmetric extension as an index map of period
    2(n-1): matches numpy's (and jnp's) pad mode="reflect" at every
    n >= 2, including pad >= n, where it reflects again."""
    period = 2 * (n - 1)
    i = torch.arange(-pad, n + pad, device=device) % period
    return torch.where(i < n, i, period - i)


def _extend2(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Whole-sample symmetric extension along the last axis."""
    n = x.shape[-1]
    if n == 1:
        return x.expand(*x.shape[:-1], 2 * pad + 1)
    return x.index_select(-1, _reflect_index(n, pad, x.device))


def _interleave(low: torch.Tensor, high: torch.Tensor, off: int,
                n: int) -> torch.Tensor:
    y = low.new_zeros(low.shape[:-1] + (n,))
    if off % 2 == 0:
        y[..., 0::2] = low
        y[..., 1::2] = high
    else:
        y[..., 0::2] = high
        y[..., 1::2] = low
    return y


def fwd53_1d(x: torch.Tensor, off: int):
    """Forward 5/3 along the last axis; x int32, interval starts at `off`."""
    n = x.shape[-1]
    if n == 0:
        return x[..., :0], x[..., :0]
    if n == 1:
        if off % 2 == 0:
            return x, x[..., :0]
        return x[..., :0], x * 2
    xe = _extend2(x, 2)
    h = xe[..., 1:-1] - ((xe[..., :-2] + xe[..., 2:]) >> 1)      # odd abs pos
    l = xe[..., 2:-2] + ((h[..., :-2] + h[..., 2:] + 2) >> 2)     # even abs
    hmid = h[..., 1:-1]
    if off % 2 == 0:
        return l[..., 0::2], hmid[..., 1::2]
    return l[..., 1::2], hmid[..., 0::2]


def inv53_1d(low: torch.Tensor, high: torch.Tensor, off: int,
             n: int) -> torch.Tensor:
    if n == 0:
        return low[..., :0]
    if n == 1:
        if off % 2 == 0:
            return low
        return torch.sign(high) * (torch.abs(high) >> 1)
    y = _interleave(low, high, off, n)
    ye = _extend2(y, 2)
    e = ye[..., 1:-1] - ((ye[..., :-2] + ye[..., 2:] + 2) >> 2)
    o = ye[..., 2:-2] + ((e[..., :-2] + e[..., 2:]) >> 1)
    emid = e[..., 1:-1]
    x = torch.zeros_like(y)
    if off % 2 == 0:
        x[..., 0::2] = emid[..., 0::2]
        x[..., 1::2] = o[..., 1::2]
    else:
        x[..., 0::2] = o[..., 0::2]
        x[..., 1::2] = emid[..., 1::2]
    return x


def _lift97(a: torch.Tensor, coef: float, target_parity: int,
            parity: int) -> torch.Tensor:
    c = torch.tensor(coef, dtype=a.dtype, device=a.device)
    upd = a[..., 1:-1] + c * (a[..., :-2] + a[..., 2:])
    jpar = (torch.arange(1, a.shape[-1] - 1, device=a.device) + parity) % 2
    mid = torch.where(jpar == target_parity, upd, a[..., 1:-1])
    return torch.cat([a[..., :1], mid, a[..., -1:]], dim=-1)


def fwd97_1d(x: torch.Tensor, off: int):
    n = x.shape[-1]
    if n == 0:
        return x[..., :0], x[..., :0]
    if n == 1:
        if off % 2 == 0:
            return x, x[..., :0]
        return x[..., :0], x * 2.0
    a = _extend2(x, 4)
    parity = off % 2
    a = _lift97(a, ALPHA, 1, parity)
    a = _lift97(a, BETA, 0, parity)
    a = _lift97(a, GAMMA, 1, parity)
    a = _lift97(a, DELTA, 0, parity)
    core = a[..., 4:-4]
    lo_k = torch.tensor(1.0 / K, dtype=x.dtype, device=x.device)
    hi_k = torch.tensor(K / 2.0, dtype=x.dtype, device=x.device)
    if off % 2 == 0:
        return core[..., 0::2] * lo_k, core[..., 1::2] * hi_k
    return core[..., 1::2] * lo_k, core[..., 0::2] * hi_k


def inv97_1d(low: torch.Tensor, high: torch.Tensor, off: int,
             n: int) -> torch.Tensor:
    if n == 0:
        return low[..., :0]
    if n == 1:
        if off % 2 == 0:
            return low
        return high * 0.5
    lo_k = torch.tensor(K, dtype=low.dtype, device=low.device)
    hi_k = torch.tensor(2.0 / K, dtype=high.dtype, device=high.device)
    y = _interleave(low * lo_k, high * hi_k, off, n)
    a = _extend2(y, 4)
    parity = off % 2
    a = _lift97(a, -DELTA, 0, parity)
    a = _lift97(a, -GAMMA, 1, parity)
    a = _lift97(a, -BETA, 0, parity)
    a = _lift97(a, -ALPHA, 1, parity)
    return a[..., 4:-4]


# ---------------------------------------------------------------------------
# 2D multilevel (static geometry; batched over leading axes)
# ---------------------------------------------------------------------------

def _res_rect(tc_rect: Rect, nl: int, r: int) -> Rect:
    s = 1 << (nl - r)
    return tc_rect.ceil_scale(s, s)


def _swap(x):
    return x.transpose(-1, -2)


def fwd_2d_level(cur, rect: Rect, irreversible: bool):
    f1 = fwd97_1d if irreversible else fwd53_1d
    lo_v, hi_v = f1(_swap(cur), rect.y0)
    ll, hl = f1(_swap(lo_v), rect.x0)
    lh, hh = f1(_swap(hi_v), rect.x0)
    return ll, hl, lh, hh


def inv_2d_level(ll, hl, lh, hh, rect: Rect, irreversible: bool):
    i1 = inv97_1d if irreversible else inv53_1d
    lo_v = i1(ll, hl, rect.x0, rect.w)
    hi_v = i1(lh, hh, rect.x0, rect.w)
    return _swap(i1(_swap(lo_v), _swap(hi_v), rect.y0, rect.h))


def fwd_multilevel(samples: torch.Tensor, tc_rect: Rect,
                   num_resolutions: int, irreversible: bool,
                   dtype: torch.dtype | None = None) -> list:
    """bands[0] = LL array; bands[r] = (HL, LH, HH) for r >= 1.  9/7
    lifts in float32 unless dtype says otherwise (float64 after a custom
    MCT, as the JAX package's host encode lifts it)."""
    nl = num_resolutions - 1
    if dtype is None:
        dtype = torch.float32 if irreversible else torch.int32
    cur = samples.to(dtype)
    out: list = [None] * num_resolutions
    for r in range(nl, 0, -1):
        rect = _res_rect(tc_rect, nl, r)
        ll, hl, lh, hh = fwd_2d_level(cur, rect, irreversible)
        out[r] = (hl, lh, hh)
        cur = ll
    out[0] = cur
    return out


def inv_multilevel(bands: list, tc_rect: Rect, num_resolutions: int,
                   irreversible: bool, max_res: int | None = None):
    nl = num_resolutions - 1
    cur = bands[0]
    stop = num_resolutions if max_res is None else max_res
    for r in range(1, stop):
        rect = _res_rect(tc_rect, nl, r)
        hl, lh, hh = bands[r]
        cur = inv_2d_level(cur, hl, lh, hh, rect, irreversible)
    return cur


def inv_multilevel_flat(flat_bands: tuple, tc_rect_tuple: tuple,
                        num_resolutions: int, irreversible: bool,
                        max_res: int | None = None):
    """Flat (LL, HL1, LH1, HH1, HL2, ...) band tuple form.

    max_res < num_resolutions performs reduced-resolution synthesis (the
    per-level rects still scale by the full decomposition count).
    """
    stop = num_resolutions if max_res is None else max_res
    bands: list = [flat_bands[0]]
    for r in range(1, stop):
        i = 1 + 3 * (r - 1)
        bands.append((flat_bands[i], flat_bands[i + 1], flat_bands[i + 2]))
    return inv_multilevel(bands, Rect(*tc_rect_tuple), num_resolutions,
                          irreversible, max_res=stop)
