"""Packet progression iteration (ISO/IEC 15444-1 B.12) + POC changes.

The port's copy of grok_tpu/t2/progression.py.

Yields (layer, resolution, component, precinct) in codestream order for the
five progressions.  Positional orders (RPCL/PCRL/CPRL) are realized by
sorting precincts on their canvas-coordinate anchor — equivalent to the
standard's position-scanning loops because distinct precincts of one
(component, resolution) never share an anchor.

Reference parity: [grok: src/lib/core/t2/PacketIter, PacketManager] —
behavior normative per B.12.
"""

from __future__ import annotations

from dataclasses import dataclass

from grok_tpu_torch.core.geometry import TileCompGeom
from grok_tpu_torch.core.params import Poc, ProgOrder


@dataclass(frozen=True)
class PacketCoord:
    layer: int
    res: int
    comp: int
    prec: int


def precinct_anchor(tcg: TileCompGeom, r: int, p: int, dx: int, dy: int,
                    tile_x0: int, tile_y0: int) -> tuple[int, int]:
    """Canvas-coordinate anchor (y, x) of precinct p at resolution r.

    The anchor is the precinct's upper-left corner mapped through the
    resolution scaling (<< (nl - r)) and component subsampling (* dx),
    clamped to the tile origin for edge precincts.
    """
    rg = tcg.resolutions[r]
    nl = len(tcg.resolutions) - 1
    px = p % rg.num_prec_x
    py = p // rg.num_prec_x
    gx = ((rg.rect.x0 >> rg.ppx) + px) << rg.ppx
    gy = ((rg.rect.y0 >> rg.ppy) + py) << rg.ppy
    cx = max((gx << (nl - r)) * dx, tile_x0)
    cy = max((gy << (nl - r)) * dy, tile_y0)
    return cy, cx


def iter_packets(tcgs: list[TileCompGeom], subsampling: list[tuple[int, int]],
                 num_layers: int, order: ProgOrder,
                 tile_x0: int = 0, tile_y0: int = 0,
                 pocs: list[Poc] | None = None):
    """Yield PacketCoord for every packet of one tile, in progression order.

    tcgs: per-component geometry trees; subsampling: per-component (dx, dy).
    """
    if pocs:
        seen: set[tuple[int, int, int, int]] = set()
        for poc in pocs:
            for pc in _iter_one(tcgs, subsampling, order=poc.order,
                                layers=range(0, min(poc.layer_end, num_layers)),
                                res_range=range(poc.rs, poc.re),
                                comp_range=range(poc.cs, poc.ce),
                                tile_x0=tile_x0, tile_y0=tile_y0):
                key = (pc.layer, pc.res, pc.comp, pc.prec)
                if key not in seen:
                    seen.add(key)
                    yield pc
        # remaining packets in the tile's base order
        for pc in _iter_one(tcgs, subsampling, order=order,
                            layers=range(num_layers),
                            res_range=None, comp_range=None,
                            tile_x0=tile_x0, tile_y0=tile_y0):
            key = (pc.layer, pc.res, pc.comp, pc.prec)
            if key not in seen:
                seen.add(key)
                yield pc
        return
    yield from _iter_one(tcgs, subsampling, order=order,
                         layers=range(num_layers), res_range=None,
                         comp_range=None, tile_x0=tile_x0, tile_y0=tile_y0)


def _iter_one(tcgs, subsampling, order: ProgOrder, layers,
              res_range, comp_range, tile_x0: int, tile_y0: int):
    ncomps = len(tcgs)
    comps = [c for c in (comp_range if comp_range is not None
                         else range(ncomps)) if c < ncomps]
    max_res = max(len(t.resolutions) for t in tcgs)

    def res_of(c):
        rr = res_range if res_range is not None else range(max_res)
        return [r for r in rr if r < len(tcgs[c].resolutions)]

    def nprec(c, r):
        return tcgs[c].resolutions[r].num_precincts

    if order == ProgOrder.LRCP:
        for l in layers:
            for r in range(max_res):
                for c in comps:
                    if r not in res_of(c):
                        continue
                    for p in range(nprec(c, r)):
                        yield PacketCoord(l, r, c, p)
        return

    if order == ProgOrder.RLCP:
        for r in range(max_res):
            for l in layers:
                for c in comps:
                    if r not in res_of(c):
                        continue
                    for p in range(nprec(c, r)):
                        yield PacketCoord(l, r, c, p)
        return

    # positional orders: build (anchor, c, r, p) tuples and sort
    entries = []
    for c in comps:
        dx, dy = subsampling[c]
        for r in res_of(c):
            for p in range(nprec(c, r)):
                ay, ax = precinct_anchor(tcgs[c], r, p, dx, dy,
                                         tile_x0, tile_y0)
                entries.append((ay, ax, c, r, p))

    if order == ProgOrder.RPCL:
        entries.sort(key=lambda e: (e[3], e[0], e[1], e[2]))
        for (_ay, _ax, c, r, p) in entries:
            for l in layers:
                yield PacketCoord(l, r, c, p)
    elif order == ProgOrder.PCRL:
        entries.sort(key=lambda e: (e[0], e[1], e[2], e[3]))
        for (_ay, _ax, c, r, p) in entries:
            for l in layers:
                yield PacketCoord(l, r, c, p)
    elif order == ProgOrder.CPRL:
        entries.sort(key=lambda e: (e[2], e[0], e[1], e[3]))
        for (_ay, _ax, c, r, p) in entries:
            for l in layers:
                yield PacketCoord(l, r, c, p)
    else:
        raise ValueError(f"unknown progression order {order}")
