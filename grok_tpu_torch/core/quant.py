"""Quantization (ISO/IEC 15444-1 Annex E) + band synthesis norms.

The port's copy of grok_tpu/core/quant.py, trimmed to what the port
calls: the step sizes the encoder signals in QCD (reversible:
exponent-only; irreversible: Delta_b = 2^(Rb - eps_b) * (1 + mu_b / 2^11)
from the 9/7 band synthesis norms), the 5/3 and 9/7 band norms and band
levels behind the PCRD distortion weights, and the Quantizer the tile
geometry resolves from QCD/QCC.  Quantizing and dequantizing run on the device
(pipeline/serve_enc.py, pipeline/device.py).

Reference parity: [grok: src/lib/core/ quantizer setup in CodingParams;
upstream opj_dwt_calc_explicit_stepsizes] — behavior normative per Annex E.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from grok_tpu_torch.core.geometry import (BAND_GAIN, BAND_HH, BAND_HL,
                                          BAND_LH, BAND_LL)
from grok_tpu_torch.transform import dwt_np

# Quantization styles (Sqcd low 5 bits; Table A.28)
QSTYLE_NONE = 0       # reversible: exponent-only
QSTYLE_DERIVED = 1    # one (eps, mu) for all bands, scaled per level
QSTYLE_EXPOUNDED = 2  # (eps, mu) per band


@lru_cache(maxsize=None)
def _norms_1d(irreversible: bool, max_level: int = 10) -> tuple:
    """L2 norms of the 1D synthesis basis: (low[levels+1], high[levels+1]).

    low[l] = norm of the level-l lowpass synthesis function; high[l] for
    highpass.  Computed by pushing a centered unit impulse through the
    inverse lifting `l` times; the start length (32) dwarfs the filter
    support so boundary extension never touches the response.  Beyond
    max_level the norms scale by sqrt(2) per level (asymptotic regime) —
    callers extrapolate.  low[0] = high[0] = 1.
    """
    lows = [1.0]
    highs = [1.0]
    inv = dwt_np.inv97_1d if irreversible else dwt_np.inv53_1d
    amp = 1.0 if irreversible else float(1 << 24)   # defeat integer rounding
    for lvl in range(1, max_level + 1):
        half = 32
        imp = np.zeros(half, dtype=np.float64)
        imp[half // 2] = amp
        zero = np.zeros(half, dtype=np.float64)
        for which, acc in ((0, lows), (1, highs)):
            cur = inv(zero if which else imp, imp if which else zero,
                      0, 2 * half)
            for _ in range(lvl - 1):
                cur = inv(cur, np.zeros_like(cur), 0, 2 * cur.shape[-1])
            acc.append(float(np.sqrt(np.sum(
                np.asarray(cur, dtype=np.float64) ** 2))) / amp)
    return tuple(lows), tuple(highs)


def band_norm(irreversible: bool, level: int, orient: int) -> float:
    """L2 norm of the 2D synthesis basis for a band.

    level: decomposition level of the band (1 = finest); for LL it is the
    remaining level count.  Separable: 2D norm = product of 1D norms.
    """
    lows, highs = _norms_1d(irreversible)
    lvl = min(level, len(lows) - 1)
    extra = level - lvl    # beyond the table: norms scale geometrically
    lo = lows[lvl] * (lows[-1] / lows[-2]) ** extra
    hi = highs[lvl] * (highs[-1] / highs[-2]) ** extra
    if orient == BAND_LL:
        return lo * lo
    if orient == BAND_HL:   # highpass horizontal, lowpass vertical
        return hi * lo
    if orient == BAND_LH:
        return lo * hi
    return hi * hi


@dataclass(frozen=True)
class StepSize:
    expn: int   # eps_b, 5 bits
    mant: int   # mu_b, 11 bits (0 for reversible)

    def delta(self, rb: int) -> float:
        """Actual step Delta_b = 2^(Rb - eps) * (1 + mu/2^11)  [eq. E-3]."""
        return float(2.0 ** (rb - self.expn) * (1.0 + self.mant / 2048.0))


def encode_stepsize(step: float, numbps: int) -> StepSize:
    """Quantize a float step into (expn, mant) such that
    2^(numbps - expn) * (1 + mant/2048) ~= step  (floor on the mantissa)."""
    if step <= 0:
        raise ValueError("step must be positive")
    p = math.floor(math.log2(step))
    mant = int(math.floor((step / 2.0 ** p - 1.0) * 2048.0 + 0.5))
    if mant >= 2048:
        mant = 0
        p += 1
    return StepSize(expn=numbps - p, mant=mant)


def band_level(num_resolutions: int, r: int) -> int:
    """Decomposition level of the bands at resolution r (LL at r=0 has the
    deepest level)."""
    nl = num_resolutions - 1
    return nl - r + 1 if r > 0 else nl


def default_stepsizes(num_resolutions: int, prec: int, irreversible: bool,
                      base_step: float = 0.0) -> list[tuple[int, StepSize]]:
    """Per-band (orient, StepSize) in codestream band order:
    LL, then per resolution 1..nl: HL, LH, HH.

    Reversible: exponent-only, eps = prec + gain.
    Irreversible: step = base/norm_b, making quantization MSE uniform across
    bands (base_step = 0 -> base 1.0, near-lossless before PCRD truncation).
    """
    out: list[tuple[int, StepSize]] = []
    nl = num_resolutions - 1
    base = base_step if base_step > 0 else 1.0

    def one(r: int, orient: int):
        if not irreversible:
            gain = BAND_GAIN[orient]
            return StepSize(expn=prec + gain, mant=0)
        lvl = band_level(num_resolutions, r) if r > 0 else max(nl, 1)
        if r == 0 and nl == 0:
            lvl = 0
        norm = band_norm(True, lvl, orient) if lvl > 0 else 1.0
        return encode_stepsize(base / norm, prec)

    out.append((BAND_LL, one(0, BAND_LL)))
    for r in range(1, num_resolutions):
        for orient in (BAND_HL, BAND_LH, BAND_HH):
            out.append((orient, one(r, orient)))
    return out


def band_index(r: int, orient: int) -> int:
    """Index into the codestream band-order list for (resolution, orient)."""
    if r == 0:
        return 0
    off = {BAND_HL: 0, BAND_LH: 1, BAND_HH: 2}[orient]
    return 1 + 3 * (r - 1) + off


@dataclass
class Quantizer:
    """Per-tile-component quantization state resolved from QCD/QCC."""

    style: int                      # QSTYLE_*
    guard_bits: int
    steps: list[StepSize]           # per band (codestream order); for DERIVED
                                    # only steps[0] is signalled
    num_resolutions: int
    prec: int                       # component precision incl. MCT expansion

    def step_for(self, r: int, orient: int) -> StepSize:
        if self.style == QSTYLE_DERIVED:
            # eq. E-5 (eps_b = eps_0 - NL + n_b) reduces, in codestream band
            # order, to eps_b = eps_0 - (r - 1) for bands at resolution r >= 1
            # and eps_0 for the LL band.
            s0 = self.steps[0]
            return StepSize(expn=s0.expn - max(r - 1, 0), mant=s0.mant)
        return self.steps[band_index(r, orient)]

    def rb(self, r: int, orient: int) -> int:
        """Dynamic range Rb = prec + gain(band)  [eq. E-4 context].

        The log2 gain is the 5/3 reversible subband gain (0/1/1/2); the 9/7
        path is already normalized by its K scaling, so gain = 0 there.
        """
        gain = BAND_GAIN[orient] if self.style == QSTYLE_NONE else 0
        return self.prec + gain

    def mb(self, r: int, orient: int) -> int:
        """Max magnitude bitplanes Mb = guard + eps_b - 1  [eq. B-16 / E-2]."""
        return self.guard_bits + self.step_for(r, orient).expn - 1

    def delta(self, r: int, orient: int) -> float:
        if self.style == QSTYLE_NONE:
            return 1.0
        return self.step_for(r, orient).delta(self.rb(r, orient))


def make_quantizer(num_resolutions: int, prec: int, irreversible: bool,
                   guard_bits: int = 2, base_step: float = 0.0,
                   derived: bool = False) -> Quantizer:
    steps = [s for (_o, s) in default_stepsizes(num_resolutions, prec,
                                                irreversible, base_step)]
    if not irreversible:
        style = QSTYLE_NONE
    else:
        style = QSTYLE_DERIVED if derived else QSTYLE_EXPOUNDED
    return Quantizer(style=style, guard_bits=guard_bits, steps=steps,
                     num_resolutions=num_resolutions, prec=prec)
