"""PCRD rate allocation (post-compression rate-distortion optimization).

The port's copy of grok_tpu/t2/rate.py without the sharded encode's
slope bounds (the port has no sharded encode).

Per code-block: convex-hull filtering of the (rate, weighted distortion)
pass envelope.  Per layer: global lambda bisection over the hull slopes,
with exact Tier-2 simulation of the packet bytes, to hit cumulative byte
targets.  Distortion weights (band synthesis norm x quantizer step x MCT
column norm, squared) are applied by the tile encoder before allocation.

Reference parity: [grok: src/lib/core/tile/ rate allocation feeding
T2Compress] — standard PCRD-opt per Taubman's EBCOT formulation (the
algorithm ISO 15444-1 Annex J.10 describes informatively).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Hull:
    """Convex-hull truncation points for one code-block."""

    pass_idx: np.ndarray     # (k,) pass indices (0-based, inclusive ends)
    slopes: np.ndarray       # (k,) strictly decreasing R-D slopes


def convex_hull(rates: np.ndarray, dists: np.ndarray) -> Hull:
    """Feasible truncation points on the convex hull of the R-D envelope.

    rates: cumulative bytes per pass; dists: cumulative weighted distortion
    reduction per pass (both monotone nondecreasing).
    """
    idx: list[int] = []
    slope: list[float] = []
    r_prev, d_prev = 0.0, 0.0
    for i in range(len(rates)):
        dr = float(rates[i]) - r_prev
        dd = float(dists[i]) - d_prev
        if dr <= 0:
            if dd > 0 and idx:
                # free distortion: extend the previous hull point to include
                # this zero-rate pass and recompute its slope to absorb the
                # added distortion reduction.
                d_prev = float(dists[i])
                idx[-1] = i
                if len(idx) >= 2:
                    r0, d0 = float(rates[idx[-2]]), float(dists[idx[-2]])
                else:
                    r0, d0 = 0.0, 0.0
                dr_prev = float(rates[i]) - r0
                slope[-1] = (d_prev - d0) / dr_prev if dr_prev > 0 else np.inf
            continue
        s = dd / dr
        while idx and s >= slope[-1]:
            # previous point is not on the hull: merge
            idx.pop()
            slope.pop()
            if idx:
                r0 = float(rates[idx[-1]])
                d0 = float(dists[idx[-1]])
            else:
                r0, d0 = 0.0, 0.0
            s = (float(dists[i]) - d0) / (float(rates[i]) - r0)
        idx.append(i)
        slope.append(s)
        r_prev, d_prev = float(rates[i]), float(dists[i])
    return Hull(pass_idx=np.array(idx, dtype=np.int64),
                slopes=np.array(slope, dtype=np.float64))


def passes_for_lambda(hull: Hull, lam: float, min_passes: int = 0) -> int:
    """Number of passes (exclusive end) to include at slope threshold lam."""
    n = 0
    for i in range(len(hull.pass_idx)):
        if hull.slopes[i] >= lam:
            n = int(hull.pass_idx[i]) + 1
    return max(n, min_passes)


class _HullBank:
    """All hulls as padded matrices: one vectorized threshold query per
    lambda instead of a Python loop over every block (the bisection's
    inner op — dominant at multi-tile/gigapixel block counts)."""

    def __init__(self, hulls: list[Hull]):
        nb = len(hulls)
        kmax = max((len(h.slopes) for h in hulls), default=0)
        self.slopes = np.full((nb, max(kmax, 1)), -np.inf)
        self.ends = np.zeros((nb, max(kmax, 1)), np.int64)
        for b, h in enumerate(hulls):
            k = len(h.slopes)
            if k:
                self.slopes[b, :k] = h.slopes
                self.ends[b, :k] = h.pass_idx + 1

    def passes(self, lam: float, prev: np.ndarray) -> np.ndarray:
        counts = (self.slopes >= lam).sum(axis=1)
        idx = np.maximum(counts - 1, 0)
        n = np.take_along_axis(self.ends, idx[:, None], axis=1)[:, 0]
        return np.maximum(np.where(counts > 0, n, 0), prev)


def _cum_table(per_block: list) -> np.ndarray:
    """(nb, pmax) cumulative-value matrix, zero padded."""
    nb = len(per_block)
    pmax = max((len(v) for v in per_block), default=0)
    mat = np.zeros((nb, max(pmax, 1)), np.float64)
    for b, v in enumerate(per_block):
        if len(v):
            mat[b, :len(v)] = v
    return mat


def _cum_lookup(mat: np.ndarray, cum: np.ndarray) -> float:
    """sum over blocks of mat[b, cum[b]-1] for cum[b] > 0."""
    idx = np.maximum(cum - 1, 0)
    vals = np.take_along_axis(mat, idx[:, None], axis=1)[:, 0]
    return float(np.where(cum > 0, vals, 0.0).sum())


def allocate_layers(hulls: list[Hull], num_layers: int,
                    targets: list[float | None], simulate,
                    total_passes: list[int] | None = None,
                    pass_rates: list | None = None) -> list[list[int]]:
    """Assign cumulative pass counts per layer for every block.

    targets: cumulative byte budget per layer (None = include everything
    remaining — lossless final layer, which must carry ALL passes, not just
    the hull vertices).
    simulate(layer_cums: list[per-block cumulative passes per layer so far])
      -> total bytes through the last simulated layer (headers included).

    pass_rates[b]: cumulative codeword bytes per pass of block b.  When
    given, the bisection runs against an incremental cost model — exact
    body bytes from the rate table plus a header estimate calibrated by
    the most recent exact Tier-2 simulation — and only candidates the
    model accepts are exact-simulated (every CHOSEN allocation is still
    exact-verified <= target).  This drops the O(40 x full-T2) cost per
    layer to a handful of emissions — the scaling fix for multi-tile /
    gigapixel allocation (SURVEY §2 row 13).

    Returns layer_cum[block][layer].
    """
    nb = len(hulls)
    if total_passes is None:
        total_passes = [int(h.pass_idx[-1]) + 1 if len(h.pass_idx) else 0
                        for h in hulls]
    layer_cum: list[list[int]] = [[] for _ in range(nb)]
    prev = [0] * nb
    bank = _HullBank(hulls)
    rates_mat = _cum_table(pass_rates) if pass_rates is not None else None

    def body_bytes(cum) -> float:
        return _cum_lookup(rates_mat, np.asarray(cum, np.int64))

    all_slopes = np.concatenate(
        [h.slopes for h in hulls if len(h.slopes)]) \
        if any(len(h.slopes) for h in hulls) else np.array([1.0])
    smin = float(all_slopes.min()) * 0.5
    smax = float(all_slopes.max()) * 2.0 + 1.0

    for l in range(num_layers):
        tgt = targets[l] if l < len(targets) else None
        if tgt is None:
            chosen = [max(total_passes[b], prev[b]) for b in range(nb)]
        else:
            def exact_size(trial: list[int]) -> float:
                for b in range(nb):
                    layer_cum[b].append(trial[b])
                size = simulate(layer_cum)
                for b in range(nb):
                    layer_cum[b].pop()
                return size

            # bisect toward the smallest lambda whose size fits the target
            lo, hi = smin, smax      # lo: too much data, hi: fits
            chosen = prev[:]         # fallback: nothing new this layer
            header_est = None        # calibrated by exact simulations
            prev_a = np.asarray(prev, np.int64)
            for _ in range(40):
                mid = 0.5 * (lo + hi)
                trial = bank.passes(mid, prev_a).tolist()
                if pass_rates is not None and header_est is not None:
                    est = body_bytes(trial) + header_est
                    if est > tgt:
                        # model rejects: no Tier-2 emission.  Header
                        # over-estimates only make the split conservative
                        # (the chosen lambda stays exact-verified below).
                        lo = mid
                        if (hi - lo) <= 1e-9 * max(hi, 1.0):
                            break
                        continue
                size = exact_size(trial)
                if pass_rates is not None:
                    header_est = max(size - body_bytes(trial), 0.0)
                if size <= tgt:
                    chosen = trial
                    hi = mid
                    if size >= 0.98 * tgt:
                        break        # close enough: stop simulating
                else:
                    lo = mid
                if (hi - lo) <= 1e-9 * max(hi, 1.0):
                    break
        for b in range(nb):
            layer_cum[b].append(chosen[b])
        prev = chosen
    return layer_cum


def allocate_layers_quality(hulls: list[Hull], num_layers: int,
                            dist_targets: list[float | None],
                            total_passes: list[int],
                            dists: list[np.ndarray]) -> list[list[int]]:
    """Fixed-quality allocation: per layer, the cheapest (highest-slope)
    pass set whose cumulative distortion reduction meets the target.

    dist_targets: cumulative weighted-squared-error reduction per layer
    (None = everything).  dists[b][p]: cumulative reduction per pass.
    """
    nb = len(hulls)
    layer_cum: list[list[int]] = [[] for _ in range(nb)]
    prev = [0] * nb
    bank = _HullBank(hulls)
    dists_mat = _cum_table(dists)
    all_slopes = np.concatenate([h.slopes for h in hulls if len(h.slopes)]) \
        if any(len(h.slopes) for h in hulls) else np.array([1.0])
    smin = float(all_slopes.min()) * 0.5
    smax = float(all_slopes.max()) * 2.0 + 1.0

    def reduction(chosen):
        return _cum_lookup(dists_mat, np.asarray(chosen, np.int64))

    for l in range(num_layers):
        tgt = dist_targets[l] if l < len(dist_targets) else None
        if tgt is None:
            chosen = [max(total_passes[b], prev[b]) for b in range(nb)]
        else:
            lo, hi = smin, smax
            chosen = [max(total_passes[b], prev[b]) for b in range(nb)]
            prev_a = np.asarray(prev, np.int64)
            for _ in range(40):
                mid = 0.5 * (lo + hi)
                trial = bank.passes(mid, prev_a).tolist()
                if reduction(trial) >= tgt:
                    chosen = trial
                    lo = mid        # try fewer bytes (higher threshold)
                else:
                    hi = mid
        for b in range(nb):
            layer_cum[b].append(chosen[b])
        prev = chosen
    return layer_cum


def quality_targets_for_tile(hdr, geo, params) -> list | None:
    """Each layer's allowed total squared error for a fixed-quality
    encode (params.fixed_quality with PSNR targets params.quality; None
    for a layer whose target is not above 0), over the tile's samples,
    as grok_tpu.compress computes them; None without quality targets."""
    if not (params.fixed_quality and params.quality):
        return None
    npix = sum(geo.comp_rects[c].w * geo.comp_rects[c].h
               for c in range(len(hdr.comps)))
    peak = (1 << hdr.comps[0].prec) - 1
    return [None if q <= 0 else peak * peak / (10.0 ** (q / 10.0)) * npix
            for q in params.quality]


def layer_budget_consts(hdr, params) -> tuple:
    """Whole-image constants for per-tile layer byte budgets, from the
    main header the encode writes (stream byte-identity with the JAX
    package's encoders depends on identical PCRD targets)."""
    from grok_tpu_torch.api import _main_header_bytes
    siz = hdr.siz
    raw_bytes = sum((siz.xsiz - siz.xosiz) * (siz.ysiz - siz.yosiz)
                    * c.prec / 8.0 / (c.dx * c.dy) for c in hdr.comps)
    total_pixels = (siz.xsiz - siz.xosiz) * (siz.ysiz - siz.yosiz)
    mh_probe = _main_header_bytes(hdr, params, None)
    header_overhead = len(mh_probe) + siz.num_tiles * 14 + 2
    return raw_bytes, total_pixels, header_overhead


def layer_targets_for_tile(consts: tuple, tile_rect, params) -> list:
    """Cumulative per-layer byte budgets for one tile (None = all
    remaining passes; ratio <= 1 means lossless intent, matching the
    reference tools' -r 1 convention)."""
    raw_bytes, total_pixels, header_overhead = consts
    frac = (tile_rect.w * tile_rect.h) / max(total_pixels, 1)
    targets: list = []
    for l in range(params.num_layers):
        if params.rates and params.rates[l] > 1:
            budget = raw_bytes / params.rates[l] - header_overhead
            targets.append(max(budget, 100.0) * frac)
        else:
            targets.append(None)
    return targets
