"""Multi-device parallelism of the port: the counterpart of
grok_tpu/parallel/sharding.py.

A JAX `Mesh` is single-controller: one call drives all of its devices.
Its counterpart here is `Mesh`, a tuple of PyTorch devices on the one
axis "tiles" that one process drives; a sharded array is a list of
per-shard tensors, shard i on mesh.devices[i] (`shard_tile_batch`,
`unshard`).  The devices may repeat: `Mesh(("cuda:0",) * 4)` is four
virtual shards on one card, run one after another, as the JAX package's
tests run an 8-device virtual CPU mesh.  (torch.distributed is the
counterpart of the multi-process half, parallel/distributed.py.)

Two strategies, as in the JAX package:

1. Tile-batch data parallelism (`make_codec_roundtrip_step`) and lane
   parallelism of the block coders (`decode_blocks_sharded`, and
   ops/t1_decode.py t1_decode_lanes_sharded / ops/t1_encode.py
   t1_encode_lanes_sharded: kernel K3 or K5 launched once per shard, on
   the shard's device, over its share of the lanes).  The global PCRD
   statistic reduces on the first device (`pcrd_slope_bounds_sharded`;
   the encode does not call it, since its hulls are on the host, where
   t2/rate.py allocate_layers computes the same bracket).

2. Giant-tile spatial sharding (`make_inv_2d_level_sharded`,
   `make_fwd_2d_level_sharded` and their wrappers): one DWT level's rows
   split across the mesh.  The horizontal lifting is local to a shard;
   the vertical lifting needs the neighbours' edge rows (the halo, 4 rows
   for both filters), copied with `.to(neighbour, non_blocking=True)`,
   the ppermute of the JAX package: between cards a peer-to-peer copy,
   between shards on one card a copy on the card.  A shard runs
   ops/dwt.py's own steps (the 9/7 in float32 in the same order, its
   gains applied where ops/dwt.py applies them), with the halo in place
   of the symmetric extension, so that a sharded level equals the
   unsharded one bit for bit, 9/7 included.

A level too small to shard (R < 5 n rows or W < 8 columns, the JAX
package's rule) runs ops/dwt.py on the mesh's first device.

Traced (util/trace.py), a sharded level's copies between shards are
spanned: `mesh.shard_rows` (the rows split onto the shards),
`mesh.halo` (the exchange) and `mesh.gather_rows` (the rows back on the
first device); an inverse level also counts them in
`decode.mesh.peer_bytes`.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from grok_tpu_torch.core.geometry import Rect
from grok_tpu_torch.ops import dwt, mct
from grok_tpu_torch.ops.dwt import ALPHA, BETA, DELTA, GAMMA, K
from grok_tpu_torch.util.trace import count, trace

HALO = 4           # rows of each neighbour a shard reads (both filters)


@dataclass(frozen=True)
class Mesh:
    """Devices on the one mesh axis "tiles", driven by one process.
    Entries may be torch.device or strings ("cuda:0", "cpu") and may
    repeat; all must have one device type."""

    devices: tuple

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh's devices must share one device "
                             f"type, got {[str(d) for d in devs]}")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        return self.devices[0]


def _same_device(a, b) -> bool:
    """Whether two devices are one (an index left out is index 0)."""
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def check_mesh(mesh, device) -> None:
    """The entry points' rule: every device of the mesh has `device`'s
    type and the first one is `device`; else ValueError."""
    if mesh is None:
        return
    if not isinstance(mesh, Mesh):
        raise ValueError(f"mesh must be a grok_tpu_torch.parallel Mesh, "
                         f"got {type(mesh).__name__}")
    dev = torch.device(device)
    if any(d.type != dev.type for d in mesh.devices):
        names = [str(d) for d in mesh.devices]
        raise ValueError(f"the mesh's devices {names} are not all of the "
                         f"entry's device type {dev.type}")
    if not _same_device(mesh.first, dev):
        raise ValueError(f"the mesh's first device {mesh.first} is not the "
                         f"entry's device {dev}")


def tile_mesh(n_devices: int | None = None, *, device="cuda") -> Mesh:
    """A mesh of every visible device of `device`'s type (the CUDA cards,
    or the one CPU), or of the first n_devices of them.  Asking for more
    than are visible raises ValueError; virtual shards are built
    explicitly, as Mesh(("cuda:0",) * 4)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [dev]
    n = len(devs) if n_devices is None else int(n_devices)
    if not 1 <= n <= len(devs):
        raise ValueError(f"a mesh of {n} {dev.type} device(s) asked for; "
                         f"{len(devs)} visible")
    return Mesh(tuple(devs[:n]))


def shard_tile_batch(arr, mesh: Mesh, dim: int = 0) -> list:
    """A (T, ...) batch (numpy array or tensor) split along `dim` into
    mesh.size contiguous shards, shard i on mesh.devices[i] (uneven
    shards where T is not a multiple)."""
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(arr))
    return [p.to(d).contiguous()
            for p, d in zip(torch.tensor_split(t, mesh.size, dim=dim),
                            mesh.devices)]


def unshard(parts: list, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """The shards concatenated along `dim` on the mesh's first device."""
    return torch.cat([p.to(mesh.first, non_blocking=True) for p in parts],
                     dim)


def on_device(dev: torch.device):
    """The CUDA device guard of a launch on `dev` (a kernel launches on
    the current device's context), a no-op elsewhere."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def make_codec_roundtrip_step(rect: Rect, num_resolutions: int,
                              prec: int = 8):
    """The sharded codec step over a (T, 3, H, W) tile batch: DC shift ->
    RCT -> forward DWT -> (the distortion statistic) -> inverse DWT ->
    inverse RCT -> unshift, each shard on its own device.  step(shards)
    -> (output shards, the statistic): sum |LL| over every tile, each
    shard's partial sum reduced on the first shard's device in float64
    (exact), the PCRD exchange."""

    def step(tiles: list) -> tuple:
        outs, parts = [], []
        for x in tiles:
            x = x.to(torch.int32)
            y, cb, cr = mct.rct_fwd(*(mct.dc_shift_fwd(x[:, c], prec, False)
                                      for c in range(3)))
            back = []
            part = torch.zeros((), dtype=torch.float64, device=x.device)
            for comp in (y, cb, cr):
                bands = dwt.fwd_multilevel(comp, rect, num_resolutions,
                                           False)
                part = part + bands[0].abs().to(torch.float64).sum()
                back.append(dwt.inv_multilevel(bands, rect, num_resolutions,
                                               False))
            rgb = mct.rct_inv(*back)
            outs.append(torch.stack([mct.dc_shift_inv(c, prec, False)
                                     for c in rgb], 1))
            parts.append(part)
        first = tiles[0].device
        dist = torch.stack([p.to(first) for p in parts]).sum()
        return outs, dist

    return step


# ---------------------------------------------------------------------------
# Row-sharded DWT levels: the halo exchange and ops/dwt.py's steps
# ---------------------------------------------------------------------------

def _exchange(parts: list, halo: int) -> list:
    """Each shard (..., rows, W) with `halo` rows of its neighbours above
    and below: the neighbour's edge rows copied to this shard's device
    (sharding.py:350-360's ppermute), the global edges extended by
    whole-sample symmetric mirror rows (rows 1..halo reflected), as
    ops/dwt.py's extension does."""
    n = len(parts)
    out = []
    with trace("mesh.halo"):
        for i, p in enumerate(parts):
            top = p[..., 1:halo + 1, :].flip(-2) if i == 0 else \
                parts[i - 1][..., -halo:, :].to(p.device, non_blocking=True)
            bot = p[..., -halo - 1:-1, :].flip(-2) if i == n - 1 else \
                parts[i + 1][..., :halo, :].to(p.device, non_blocking=True)
            out.append(torch.cat([top, p, bot], -2))
    return out


def _by_row_parity(x: torch.Tensor, y_first: int, even, odd):
    """even where the canvas row is even, odd elsewhere; x's row j is
    canvas row y_first + j."""
    par = (torch.arange(x.shape[-2], device=x.device) + y_first) % 2
    return torch.where((par == 0)[:, None], even, odd)


def _scale_rows(x: torch.Tensor, y_first: int, lo: float, hi: float):
    """ops/dwt.py's 9/7 gains on the rows: even canvas rows (low-pass)
    times lo, odd times hi, each a scalar of x's dtype."""
    lo_k = torch.tensor(lo, dtype=x.dtype, device=x.device)
    hi_k = torch.tensor(hi, dtype=x.dtype, device=x.device)
    return _by_row_parity(x, y_first, x * lo_k, x * hi_k)


def _v_inverse(ext: torch.Tensor, base: int, irrev: bool, halo: int):
    """Inverse vertical lifting of an extended strip (..., n + 2 halo, W)
    whose row 0 is canvas row `base` -> its n own rows: ops/dwt.py
    inv97_1d's lifting steps (after its gains) or inv53_1d's, on the
    rows."""
    a = ext.transpose(-1, -2)
    n = a.shape[-1] - 2 * halo
    if irrev:
        for coef, tp in ((-DELTA, 0), (-GAMMA, 1), (-BETA, 0), (-ALPHA, 1)):
            a = dwt._lift97(a, coef, tp, base % 2)
        return a[..., halo:halo + n].transpose(-1, -2)
    e = a[..., 1:-1] - ((a[..., :-2] + a[..., 2:] + 2) >> 2)
    o = a[..., 2:-2] + ((e[..., :-2] + e[..., 2:]) >> 1)
    even = e[..., halo - 1:halo - 1 + n].transpose(-1, -2)
    odd = o[..., halo - 2:halo - 2 + n].transpose(-1, -2)
    return _by_row_parity(even, base + halo, even, odd)


def _v_forward(ext: torch.Tensor, base: int, irrev: bool, halo: int):
    """Forward vertical lifting of an extended strip whose row 0 is canvas
    row `base` -> its own rows, interleaved (low-pass on even canvas
    rows): ops/dwt.py fwd97_1d's steps and gains, or fwd53_1d's."""
    a = ext.transpose(-1, -2)
    n = a.shape[-1] - 2 * halo
    if irrev:
        for coef, tp in ((ALPHA, 1), (BETA, 0), (GAMMA, 1), (DELTA, 0)):
            a = dwt._lift97(a, coef, tp, base % 2)
        core = a[..., halo:halo + n].transpose(-1, -2)
        return _scale_rows(core, base + halo, 1.0 / K, K / 2.0)
    h = a[..., 1:-1] - ((a[..., :-2] + a[..., 2:]) >> 1)
    lo = a[..., 2:-2] + ((h[..., :-2] + h[..., 2:] + 2) >> 2)
    even = lo[..., halo - 2:halo - 2 + n].transpose(-1, -2)
    odd = h[..., halo - 1:halo - 1 + n].transpose(-1, -2)
    return _by_row_parity(even, base + halo, even, odd)


def _h_inverse(rows: torch.Tensor, x0: int, width: int, irrev: bool):
    """ops/dwt.py's horizontal inverse on interleaved rows (low-pass on
    even canvas columns)."""
    xe = x0 % 2
    i1 = dwt.inv97_1d if irrev else dwt.inv53_1d
    return i1(rows[..., xe::2], rows[..., 1 - xe::2], x0, width)


def _h_forward(rows: torch.Tensor, x0: int, irrev: bool):
    """ops/dwt.py's horizontal forward on rows -> interleaved rows."""
    xe = x0 % 2
    lo, hi = (dwt.fwd97_1d if irrev else dwt.fwd53_1d)(rows, x0)
    out = rows.new_empty(rows.shape)
    out[..., xe::2] = lo
    out[..., 1 - xe::2] = hi
    return out


def _check_parts(parts: list, mesh: Mesh, rows: int, width: int) -> None:
    if len(parts) != mesh.size:
        raise ValueError(f"{len(parts)} shards for a mesh of {mesh.size}")
    for p in parts:
        if p.shape[-2] != rows or p.shape[-1] != width:
            raise ValueError(f"a shard of {tuple(p.shape[-2:])}, expected "
                             f"({rows}, {width})")


def _inv_level_fn(mesh: Mesh, rows_per_shard: int, width: int, x0: int,
                  y0: int, irrev: bool, halo: int, horizontal: bool = True):
    def fn(parts: list) -> list:
        _check_parts(parts, mesh, rows_per_shard, width)
        hrows = []
        for i, (p, d) in enumerate(zip(parts, mesh.devices)):
            h = p.to(d)
            if horizontal:
                h = _h_inverse(h, x0, width, irrev)
            if irrev:
                h = _scale_rows(h, y0 + i * rows_per_shard, K, 2.0 / K)
            hrows.append(h)
        return [_v_inverse(e, y0 + i * rows_per_shard - halo, irrev, halo)
                for i, e in enumerate(_exchange(hrows, halo))]
    return fn


def make_inv53_vertical_sharded(mesh: Mesh, rows_per_shard: int):
    """Inverse vertical 5/3 lifting over a row-sharded (R, W) array of
    interleaved rows (even row = low-pass), each shard exchanging 2 edge
    rows with each neighbour.  fn(shards) -> shards, bit-exact against
    reference_inv53_vertical."""
    def fn(parts: list) -> list:
        return _inv_level_fn(mesh, rows_per_shard, parts[0].shape[-1], 0, 0,
                             False, 2, horizontal=False)(parts)
    return fn


def reference_inv53_vertical(y: np.ndarray) -> np.ndarray:
    """Single-device oracle for the sharded vertical inverse lifting (the
    JAX package's, in NumPy)."""
    from grok_tpu_torch.transform.dwt_np import _extend2

    ye = _extend2(np.swapaxes(y.astype(np.int64), -1, -2), 2)
    e = np.empty_like(ye)
    e[..., 1:-1] = ye[..., 1:-1] - ((ye[..., :-2] + ye[..., 2:] + 2) >> 2)
    o = ye[..., 2:-2] + ((e[..., 1:-3] + e[..., 3:-1]) >> 1)
    out = np.empty_like(np.swapaxes(y, -1, -2))
    out[..., 0::2] = e[..., 2:-2][..., 0::2]
    out[..., 1::2] = o[..., 1::2]
    return np.swapaxes(out, -1, -2)


def make_inv53_2d_sharded(mesh: Mesh, rows_per_shard: int, width: int):
    """One full inverse 5/3 level over a row-sharded (R, width)
    interleaved array (even row and column = low-pass): horizontal
    lifting local to each shard, then vertical lifting with a 2-row halo
    from each neighbour; bit-exact against ops/dwt.py."""
    return _inv_level_fn(mesh, rows_per_shard, width, 0, 0, False, 2)


def make_inv_2d_level_sharded(mesh: Mesh, rows_per_shard: int, width: int,
                              x0: int, y0: int, irrev: bool):
    """One full inverse DWT level over a row-sharded (..., R, width)
    interleaved array of a level at canvas origin (x0, y0), any
    parities, 5/3 (int32) or 9/7 (float32): fn(shards) -> shards of the
    synthesized rows.  The shards take the raw coefficients (low-pass at
    even canvas rows and columns); the 9/7 gains are applied in float32
    where ops/dwt.py applies them (the JAX function takes them pre-scaled
    in float64), so that the level equals ops/dwt.py inv_2d_level bit for
    bit.  The global edges use whole-sample symmetric extension; callers
    pad ragged row counts with mirror rows (inv_2d_level_sharded)."""
    return _inv_level_fn(mesh, rows_per_shard, width, x0, y0, irrev, HALO)


def make_fwd_2d_level_sharded(mesh: Mesh, rows_per_shard: int, width: int,
                              x0: int, y0: int, irrev: bool):
    """One full forward DWT level over a row-sharded (..., R, width)
    sample array at canvas origin (x0, y0): vertical lifting first (a
    4-row halo from each neighbour), then horizontal lifting local to
    each shard, as ops/dwt.py fwd_2d_level orders them.  fn(shards) ->
    shards of the interleaved transform (low-pass at even canvas rows and
    columns), the 9/7 gains applied where ops/dwt.py applies them (the
    JAX function leaves them to its wrapper)."""

    def fn(parts: list) -> list:
        _check_parts(parts, mesh, rows_per_shard, width)
        parts = [p.to(d) for p, d in zip(parts, mesh.devices)]
        return [_h_forward(_v_forward(e, y0 + i * rows_per_shard - HALO,
                                      irrev, HALO), x0, irrev)
                for i, e in enumerate(_exchange(parts, HALO))]
    return fn


def _mirror_pad(R: int, n: int) -> int | None:
    """Mirror rows to append so that R rows split into n equal shards;
    deepened by whole shards to at least the lifting cone (a shallower
    mirror makes the last shard's edge extension reflect about the padded
    end instead of the last real row).  None where the level is too
    small to shard (sharding.py:470-484)."""
    if R < 5 * n:
        return None
    pad = (-R) % n
    if 0 < pad < HALO:
        pad += n * (-(-(HALO - pad) // n))
    if pad and pad + HALO > R - 1:
        return None
    return pad


def _shard_rows(x: torch.Tensor, mesh: Mesh, pad: int) -> list:
    """(..., R, W) -> mesh.size equal row shards after `pad` mirror rows
    (rows R-2, R-3, ...: whole-sample symmetric about the last row)."""
    R = x.shape[-2]
    with trace("mesh.shard_rows"):
        if pad:
            x = torch.cat([x, x[..., R - 1 - pad:R - 1, :].flip(-2)], -2)
        return shard_tile_batch(x, mesh, dim=-2)


def _gather_rows(parts: list, mesh: Mesh) -> torch.Tensor:
    """The row shards of a level back on the first device, in order."""
    with trace("mesh.gather_rows"):
        return unshard(parts, mesh, -2)


def _row_peer_bytes(parts: list) -> int:
    """The bytes a sharded level moves between its first shard and the
    others, or between neighbours, from its row shards (all of one shape
    and dtype): the rows split and gathered back, and a HALO-row strip
    each way across each of the n - 1 boundaries."""
    p = parts[0]
    row = p.nbytes // p.shape[-2]
    return 2 * (len(parts) - 1) * (p.nbytes + HALO * row)


def fwd_2d_level_sharded(cur, rect: Rect, irrev: bool, mesh: Mesh) -> tuple:
    """The sharded forward level of a (..., R, W) tensor at rect: mirror-
    pad ragged rows, run, trim, split into (ll, hl, lh, hh) on the mesh's
    first device, equal to ops/dwt.py fwd_2d_level.  A level too small
    to shard runs ops/dwt.py on the first device."""
    cur = cur.to(mesh.first)
    R, W = rect.h, rect.w
    pad = _mirror_pad(R, mesh.size)
    if pad is None or W < 8:
        return dwt.fwd_2d_level(cur, rect, irrev)
    fn = make_fwd_2d_level_sharded(mesh, (R + pad) // mesh.size, W, rect.x0,
                                   rect.y0, irrev)
    inter = _gather_rows(fn(_shard_rows(cur, mesh, pad)), mesh)[..., :R, :]
    ye, xe = rect.y0 % 2, rect.x0 % 2
    return tuple(inter[..., a::2, b::2].contiguous()
                 for a, b in ((ye, xe), (ye, 1 - xe), (1 - ye, xe),
                              (1 - ye, 1 - xe)))


def inv_2d_level_sharded(ll, hl, lh, hh, rect: Rect, irrev: bool,
                         mesh: Mesh) -> torch.Tensor:
    """The sharded inverse level: interleave the subbands (parity-aware)
    on the first device, mirror-pad the rows to a mesh multiple, run,
    trim.  Equal to ops/dwt.py inv_2d_level (int32 for 5/3, float32 for
    9/7); a level too small to shard runs ops/dwt.py on the first
    device."""
    first = mesh.first
    ll, hl, lh, hh = (b.to(first) for b in (ll, hl, lh, hh))
    R, W = rect.h, rect.w
    pad = _mirror_pad(R, mesh.size)
    if pad is None or W < 8:
        return dwt.inv_2d_level(ll, hl, lh, hh, rect, irrev)
    ye, xe = rect.y0 % 2, rect.x0 % 2
    inter = ll.new_empty(ll.shape[:-2] + (R, W))
    inter[..., ye::2, xe::2] = ll
    inter[..., ye::2, 1 - xe::2] = hl
    inter[..., 1 - ye::2, xe::2] = lh
    inter[..., 1 - ye::2, 1 - xe::2] = hh
    fn = make_inv_2d_level_sharded(mesh, (R + pad) // mesh.size, W, rect.x0,
                                   rect.y0, irrev)
    parts = _shard_rows(inter, mesh, pad)
    count("decode.mesh.peer_bytes", _row_peer_bytes(parts))
    return _gather_rows(fn(parts), mesh)[..., :R, :]


def fwd_multilevel_sharded(samples, tc_rect: Rect, num_resolutions: int,
                           irrev: bool, mesh: Mesh,
                           dtype: torch.dtype | None = None) -> list:
    """ops/dwt.py fwd_multilevel with every level through
    fwd_2d_level_sharded: bands[0] = LL, bands[r] = (HL, LH, HH), on the
    mesh's first device."""
    nl = num_resolutions - 1
    if dtype is None:
        dtype = torch.float32 if irrev else torch.int32
    cur = samples.to(mesh.first).to(dtype)
    out: list = [None] * num_resolutions
    for r in range(nl, 0, -1):
        s = 1 << (nl - r)
        ll, hl, lh, hh = fwd_2d_level_sharded(cur, tc_rect.ceil_scale(s, s),
                                              irrev, mesh)
        out[r] = (hl, lh, hh)
        cur = ll
    out[0] = cur
    return out


def inv_multilevel_sharded(bands: list, tc_rect: Rect, num_resolutions: int,
                           irrev: bool, mesh: Mesh,
                           max_res: int | None = None) -> torch.Tensor:
    """ops/dwt.py inv_multilevel with every level through
    inv_2d_level_sharded."""
    nl = num_resolutions - 1
    cur = bands[0]
    for r in range(1, num_resolutions if max_res is None else max_res):
        s = 1 << (nl - r)
        cur = inv_2d_level_sharded(cur, *bands[r], tc_rect.ceil_scale(s, s),
                                   irrev, mesh)
    return cur.to(mesh.first)


# ---------------------------------------------------------------------------
# The PCRD collective and the lane-sharded block decode
# ---------------------------------------------------------------------------

def pcrd_slope_bounds_sharded(hulls: list, mesh: Mesh) -> tuple:
    """The PCRD rate-allocation collective: the blocks' convex-hull R-D
    slopes split over the mesh (padded with the first slope to a mesh
    multiple, as sharding.py:519-522 pads them), each shard's min and max
    on its device, reduced on the first device in float64 (exact).
    Returns (smin, smax), equal to t2/rate.py allocate_layers' own
    bracket."""
    all_slopes = np.concatenate([h.slopes for h in hulls if len(h.slopes)]) \
        if any(len(h.slopes) for h in hulls) else np.array([1.0])
    all_slopes = np.asarray(all_slopes, np.float64)
    pad = (-len(all_slopes)) % mesh.size
    if pad:
        all_slopes = np.concatenate([all_slopes,
                                     np.full(pad, all_slopes[0])])
    parts = shard_tile_batch(all_slopes, mesh)
    mins = torch.stack([p.min().to(mesh.first) for p in parts])
    maxs = torch.stack([p.max().to(mesh.first) for p in parts])
    mn, mx = float(mins.min()), float(maxs.max())
    return mn * 0.5, mx * 2.0 + 1.0


def _block_lanes(blocks: list, device) -> tuple:
    """K3's arguments for default-style single-segment blocks (dicts of
    data, numpasses, numbps, orient, w, h): one segment [0, len) each."""
    datas = [bytes(b["data"]) for b in blocks]
    start = np.cumsum([0] + [len(d) for d in datas])[:-1]
    body = np.frombuffer(b"".join(datas) + b"\0", np.uint8).copy()
    cols = np.asarray([(b["numpasses"], b["numbps"], b["orient"], b["w"],
                        b["h"]) for b in blocks], np.int32).reshape(-1, 5)
    ptbl = np.zeros((len(blocks), 1, 3), np.int32)
    ptbl[:, 0, 1] = [len(d) for d in datas]

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)
                                if x.dtype != np.uint8 else x).to(device)
    zero = np.zeros(len(blocks), np.int32)
    return (t(body), t(start), t(cols[:, 0]), t(cols[:, 1]), t(cols[:, 2]),
            t(cols[:, 3]), t(cols[:, 4]), t(zero), t(ptbl))


def decode_blocks_sharded(blocks: list, mesh: Mesh, W: int, H: int) -> list:
    """Decode default-style code-blocks (dicts of data, numpasses, numbps,
    orient, w, h) with the lanes split over the mesh: kernel K3 launched
    once per shard (ops/t1_decode.py t1_decode_lanes_sharded; the plain
    version on CPU shards), in W x H lanes.  Returns per block (mag2
    int64, neg bool) numpy arrays, as the JAX function does."""
    from grok_tpu_torch.ops.t1_decode import t1_decode_lanes_sharded
    if not blocks:
        return []
    out = t1_decode_lanes_sharded(*_block_lanes(blocks, mesh.first), W, H,
                                  mesh=mesh).cpu().numpy()
    return [(np.abs(out[i, :b["h"], :b["w"]]).astype(np.int64),
             out[i, :b["h"], :b["w"]] < 0) for i, b in enumerate(blocks)]


def decode_blocks_sharded_auto(blocks: list, mesh: Mesh) -> list:
    """decode_blocks_sharded over mixed shapes: blocks bucketed by their
    padded power-of-two dims (at least 4), one sharded decode per bucket;
    a block without passes or planes decodes to zeros."""
    results: list = [None] * len(blocks)
    buckets: dict = {}
    for i, b in enumerate(blocks):
        if b["numpasses"] <= 0 or b["numbps"] <= 0:
            results[i] = (np.zeros((b["h"], b["w"]), np.int64),
                          np.zeros((b["h"], b["w"]), bool))
            continue
        W = H = 4
        while W < b["w"]:
            W <<= 1
        while H < b["h"]:
            H <<= 1
        buckets.setdefault((W, H), []).append(i)
    for (W, H), idxs in buckets.items():
        for i, res in zip(idxs, decode_blocks_sharded(
                [blocks[i] for i in idxs], mesh, W, H)):
            results[i] = res
    return results


def decode_tile_sharded(blocks: list, band_meta: dict, mesh: Mesh,
                        tc_rect: Rect, num_resolutions: int) -> torch.Tensor:
    """Giant-tile decode across the mesh: the blocks (as
    decode_blocks_sharded takes them, with res, bx, by: their band and
    place in it) decoded with K3 sharded over the mesh, dequantized
    (reversible: sign * (mag2 >> 1)) into their bands, then every
    synthesis level row-sharded.  band_meta: {(res, orient): band rect}.
    Returns the (h, w) int32 tensor on the mesh's first device, equal to
    the unsharded synthesis."""
    res = decode_blocks_sharded_auto(blocks, mesh)
    bands = {k: np.zeros((r.h, r.w), np.int32) for k, r in band_meta.items()}
    for b, (mag2, neg) in zip(blocks, res):
        v = np.where(neg, -(mag2 >> 1), mag2 >> 1)
        bands[(b["res"], b["orient"])][b["by"]:b["by"] + b["h"],
                                       b["bx"]:b["bx"] + b["w"]] = v
    tb = {k: torch.from_numpy(v).to(mesh.first) for k, v in bands.items()}
    levels = [tb[(0, 0)]] + [tuple(tb[(r, o)] for o in (1, 2, 3))
                             for r in range(1, num_resolutions)]
    return inv_multilevel_sharded(levels, tc_rect, num_resolutions, False,
                                  mesh)
