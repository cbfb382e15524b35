"""Canvas-coordinate geometry (ISO/IEC 15444-1 Annex B).

The port's copy of grok_tpu/core/geometry.py: image/tile grids on the
reference canvas, per-component tile rectangles, resolution levels,
sub-bands, precincts and code-blocks, computed on the host into the
static tables the serving plans and the device programs are built from.

Reference parity: [grok: src/lib/core/tile/TileComponent, util/Rect] —
behavior normative per ISO 15444-1 B.3-B.7.
"""

from __future__ import annotations

from dataclasses import dataclass, field


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class Rect:
    """Half-open rectangle [x0, x1) x [y0, y1) in canvas coordinates."""

    x0: int
    y0: int
    x1: int
    y1: int

    @property
    def w(self) -> int:
        return max(0, self.x1 - self.x0)

    @property
    def h(self) -> int:
        return max(0, self.y1 - self.y0)

    @property
    def empty(self) -> bool:
        return self.x1 <= self.x0 or self.y1 <= self.y0

    def intersect(self, o: "Rect") -> "Rect":
        return Rect(max(self.x0, o.x0), max(self.y0, o.y0),
                    min(self.x1, o.x1), min(self.y1, o.y1))

    def ceil_scale(self, sx: int, sy: int) -> "Rect":
        """Map to a coarser grid: ceil(x/s) on every edge (B-5 style)."""
        return Rect(ceil_div(self.x0, sx), ceil_div(self.y0, sy),
                    ceil_div(self.x1, sx), ceil_div(self.y1, sy))


# Band orientation codes (ISO 15444-1 Table B.1 ordering within a packet).
BAND_LL, BAND_HL, BAND_LH, BAND_HH = 0, 1, 2, 3
# (xob, yob) offsets per orientation.
_BAND_OFFS = {BAND_LL: (0, 0), BAND_HL: (1, 0), BAND_LH: (0, 1), BAND_HH: (1, 1)}
# Log2 DWT gain per orientation (reversible path).
BAND_GAIN = {BAND_LL: 0, BAND_HL: 1, BAND_LH: 1, BAND_HH: 2}


@dataclass
class CodeBlockGeom:
    rect: Rect            # in band coordinates
    idx_in_prec: tuple[int, int]   # (cx, cy) position in precinct's cblk grid


@dataclass
class BandPrecinctGeom:
    """The part of one precinct that lies in one band."""

    rect: Rect                      # band coordinates
    cblk_grid_w: int
    cblk_grid_h: int
    cblks: list[CodeBlockGeom] = field(default_factory=list)


@dataclass
class BandGeom:
    orient: int                     # BAND_LL/HL/LH/HH
    rect: Rect                      # band coordinates
    precincts: list[BandPrecinctGeom] = field(default_factory=list)


@dataclass
class ResolutionGeom:
    r: int                          # resolution level, 0..numresolutions-1
    rect: Rect                      # resolution coordinates (trx0..)
    ppx: int                        # precinct exponent at this resolution
    ppy: int
    num_prec_x: int
    num_prec_y: int
    cblk_w_exp: int                 # effective code-block exponent in band coords
    cblk_h_exp: int
    bands: list[BandGeom] = field(default_factory=list)

    @property
    def num_precincts(self) -> int:
        return self.num_prec_x * self.num_prec_y


@dataclass
class TileCompGeom:
    comp: int
    rect: Rect                      # tile-component rect (tcx0..)
    resolutions: list[ResolutionGeom] = field(default_factory=list)


def map_interval_to_band(a: int, b: int, ob: int) -> tuple[int, int]:
    """Map a resolution-coordinate interval [a,b) to band coords for offset ob.

    Band sample i sits at resolution coordinate 2*i + ob (for r > 0).
    """
    return ceil_div(a - ob, 2), ceil_div(b - ob, 2)


def band_rect(tc_rect: Rect, nl: int, r: int, orient: int) -> Rect:
    """Sub-band rectangle (ISO 15444-1 eq. B-15)."""
    if orient == BAND_LL:
        s = 1 << (nl - r)
        return tc_rect.ceil_scale(s, s)
    xob, yob = _BAND_OFFS[orient]
    s = 1 << (nl - r)
    d = 1 << (nl - r + 1)
    return Rect(
        ceil_div(tc_rect.x0 - s * xob, d), ceil_div(tc_rect.y0 - s * yob, d),
        ceil_div(tc_rect.x1 - s * xob, d), ceil_div(tc_rect.y1 - s * yob, d),
    )


def build_tilecomp_geometry(
    tc_rect: Rect,
    num_resolutions: int,
    cblk_w_exp: int,
    cblk_h_exp: int,
    prec_exps: list[tuple[int, int]] | None = None,
) -> TileCompGeom:
    """Build the full resolution/band/precinct/code-block tree for one
    tile-component.

    prec_exps: per-resolution (PPx, PPy); None means maximal (15,15).
    """
    nl = num_resolutions - 1
    tcg = TileCompGeom(comp=-1, rect=tc_rect)
    for r in range(num_resolutions):
        s = 1 << (nl - r)
        res_rect = tc_rect.ceil_scale(s, s)
        ppx, ppy = (15, 15) if prec_exps is None else prec_exps[r]
        # Effective code-block size: bounded by the precinct size in band
        # coordinates (B.7: min(xcb, PPx-1) for r>0, min(xcb, PPx) for r=0).
        if r == 0:
            cwe = min(cblk_w_exp, ppx)
            che = min(cblk_h_exp, ppy)
        else:
            cwe = min(cblk_w_exp, ppx - 1)
            che = min(cblk_h_exp, ppy - 1)
        if res_rect.empty:
            npx = npy = 0
        else:
            npx = ceil_div(res_rect.x1, 1 << ppx) - (res_rect.x0 >> ppx)
            npy = ceil_div(res_rect.y1, 1 << ppy) - (res_rect.y0 >> ppy)
        rg = ResolutionGeom(r=r, rect=res_rect, ppx=ppx, ppy=ppy,
                            num_prec_x=npx, num_prec_y=npy,
                            cblk_w_exp=cwe, cblk_h_exp=che)
        orients = [BAND_LL] if r == 0 else [BAND_HL, BAND_LH, BAND_HH]
        for orient in orients:
            brect = band_rect(tc_rect, nl, r, orient)
            bg = BandGeom(orient=orient, rect=brect)
            xob, yob = _BAND_OFFS[orient]
            for py in range(npy):
                for px in range(npx):
                    # precinct rect in resolution coordinates
                    p_x0 = max(((res_rect.x0 >> ppx) + px) << ppx, res_rect.x0)
                    p_y0 = max(((res_rect.y0 >> ppy) + py) << ppy, res_rect.y0)
                    p_x1 = min((((res_rect.x0 >> ppx) + px + 1) << ppx), res_rect.x1)
                    p_y1 = min((((res_rect.y0 >> ppy) + py + 1) << ppy), res_rect.y1)
                    if r == 0:
                        bp = Rect(p_x0, p_y0, p_x1, p_y1)
                    else:
                        bx0, bx1 = map_interval_to_band(p_x0, p_x1, xob)
                        by0, by1 = map_interval_to_band(p_y0, p_y1, yob)
                        bp = Rect(bx0, by0, bx1, by1)
                    bp = bp.intersect(brect)
                    bpg = BandPrecinctGeom(rect=bp, cblk_grid_w=0, cblk_grid_h=0)
                    if not bp.empty:
                        cw, ch = 1 << cwe, 1 << che
                        cx0, cx1 = bp.x0 >> cwe, ceil_div(bp.x1, cw)
                        cy0, cy1 = bp.y0 >> che, ceil_div(bp.y1, ch)
                        bpg.cblk_grid_w = cx1 - cx0
                        bpg.cblk_grid_h = cy1 - cy0
                        for cy in range(cy0, cy1):
                            for cx in range(cx0, cx1):
                                cr = Rect(cx << cwe, cy << che,
                                          (cx + 1) << cwe, (cy + 1) << che)
                                cr = cr.intersect(bp)
                                bpg.cblks.append(
                                    CodeBlockGeom(rect=cr,
                                                  idx_in_prec=(cx - cx0, cy - cy0)))
                    bg.precincts.append(bpg)
            rg.bands.append(bg)
        tcg.resolutions.append(rg)
    return tcg


@dataclass(frozen=True)
class SizGrid:
    """Image + tile grid on the reference canvas (SIZ marker content)."""

    xsiz: int
    ysiz: int
    xosiz: int = 0
    yosiz: int = 0
    xtsiz: int = 0   # 0 -> single tile covering the image
    ytsiz: int = 0
    xtosiz: int = 0
    ytosiz: int = 0

    def normalized(self) -> "SizGrid":
        xt = self.xtsiz or (self.xsiz - self.xosiz)
        yt = self.ytsiz or (self.ysiz - self.yosiz)
        return SizGrid(self.xsiz, self.ysiz, self.xosiz, self.yosiz,
                       xt, yt, self.xtosiz, self.ytosiz)

    @property
    def num_tiles_x(self) -> int:
        g = self.normalized()
        return ceil_div(g.xsiz - g.xtosiz, g.xtsiz)

    @property
    def num_tiles_y(self) -> int:
        g = self.normalized()
        return ceil_div(g.ysiz - g.ytosiz, g.ytsiz)

    @property
    def num_tiles(self) -> int:
        return self.num_tiles_x * self.num_tiles_y

    def tile_rect(self, t: int) -> Rect:
        g = self.normalized()
        p = t % self.num_tiles_x
        q = t // self.num_tiles_x
        return Rect(
            max(g.xtosiz + p * g.xtsiz, g.xosiz),
            max(g.ytosiz + q * g.ytsiz, g.yosiz),
            min(g.xtosiz + (p + 1) * g.xtsiz, g.xsiz),
            min(g.ytosiz + (q + 1) * g.ytsiz, g.ysiz),
        )
