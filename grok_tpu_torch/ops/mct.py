"""Device MCT + DC level shift in PyTorch, batched over leading axes.

Port of grok_tpu/ops/mct.py: RCT and the DC shift are exact int32
arithmetic; ICT is f32; a custom (Part-2) MCT and its inverse are
float64, as the JAX package's host encode and decode compute them
(transform/mct_np.py custom_mct_fwd and custom_mct_inv).

Reference parity: [grok: src/lib/core/transform/mct.cpp] — ISO 15444-1
G.2/G.3.
"""

from __future__ import annotations

import torch

ICT_FWD = ((0.299, 0.587, 0.114),
           (-0.168736, -0.331264, 0.5),
           (0.5, -0.418688, -0.081312))
ICT_INV = ((1.0, 0.0, 1.402),
           (1.0, -0.344136, -0.714136),
           (1.0, 1.772, 0.0))


def rct_fwd(r, g, b):
    y = (r + 2 * g + b) >> 2
    return y, b - g, r - g


def rct_inv(y, cb, cr):
    g = y - ((cb + cr) >> 2)
    return cr + g, g, cb + g


def _mat3(m, a, b, c):
    # coefficients rounded to the operand dtype first, as the JAX module
    # does with jnp.asarray(coef, a.dtype)
    def k(v):
        return torch.tensor(v, dtype=a.dtype, device=a.device)
    return tuple(k(m[i][0]) * a + k(m[i][1]) * b + k(m[i][2]) * c
                 for i in range(3))


def ict_fwd(r, g, b):
    return _mat3(ICT_FWD, r, g, b)


def ict_inv(y, cb, cr):
    return _mat3(ICT_INV, y, cb, cr)


def custom_mct(comps: list, matrix: torch.Tensor) -> list:
    """A custom MCT (the encode's forward matrix) or its inverse (the
    decode's): component i becomes sum_k matrix[i, k] * comps[k], in
    float64 (matrix: (C, C) float64, on the components' device; comps: C
    same-shaped tensors).  A matrix product over the component axis, as
    the JAX package's np.tensordot: on the CPU the same BLAS order, so
    that a sum on an exact .5 rounds alike."""
    x = torch.stack([c.to(torch.float64) for c in comps])
    out = torch.tensordot(matrix, x, dims=([1], [0]))
    return list(out.unbind(0))


def dc_shift_fwd(x, prec: int, sgnd: bool):
    return x if sgnd else x - (1 << (prec - 1))


def dc_shift_inv(x, prec: int, sgnd: bool):
    if not sgnd:
        x = x + (1 << (prec - 1))
        return torch.clamp(x, 0, (1 << prec) - 1)
    return torch.clamp(x, -(1 << (prec - 1)), (1 << (prec - 1)) - 1)
