"""The per-component PCRD distortion weights of the colour transforms,
and the custom MCT's inverse.

The port's copy of `mct_component_norms` from grok_tpu/transform/
mct_np.py, for the RCT, the ICT and a custom MCT, and of
`custom_mct_inv`, the NumPy model of the custom MCT's inverse that
the device decode computes (ops/mct.py custom_mct: the same float64
inverse matrix and products); the transforms themselves run on the
device (ops/mct.py).
"""

from __future__ import annotations

import numpy as np

# ICT inverse coefficient matrix (ISO/IEC 15444-1 G-4)
ICT_INV = np.array([
    [1.0, 0.0, 1.402],
    [1.0, -0.344136, -0.714136],
    [1.0, 1.772, 0.0],
])


def mct_component_norms(irreversible: bool,
                        custom_inv: np.ndarray | None = None) -> np.ndarray:
    """L2 norm of each inverse-transform column: the per-component distortion
    weight used by PCRD (error in transformed comp c scales pixel MSE by
    norm[c]^2); custom_inv: a custom MCT's inverse matrix."""
    if custom_inv is not None:
        inv = np.asarray(custom_inv, dtype=np.float64)
    elif irreversible:
        inv = ICT_INV
    else:
        # RCT inverse linearized: G = Y - (Cb+Cr)/4; R = Cr + G; B = Cb + G
        inv = np.array([
            [1.0, -0.25, 0.75],
            [1.0, -0.25, -0.25],
            [1.0, 0.75, -0.25],
        ])
    return np.sqrt((inv ** 2).sum(axis=0))


def custom_mct_inverse(matrix) -> np.ndarray:
    """The float64 inverse of a custom MCT's forward matrix."""
    return np.linalg.inv(np.asarray(matrix, dtype=np.float64))


def custom_mct_inv(comps: list[np.ndarray], matrix) -> list[np.ndarray]:
    """Undo a custom MCT: the inverse matrix applied across components,
    in float64."""
    stacked = np.stack(comps, axis=0).astype(np.float64)
    out = np.tensordot(custom_mct_inverse(matrix), stacked, axes=(1, 0))
    return [out[i] for i in range(out.shape[0])]
