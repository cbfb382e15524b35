"""The port's mesh (grok_tpu_torch/parallel/sharding.py) on a mesh of 8
CPU shards against the JAX package's grok_tpu.parallel.sharding on the
8-device virtual CPU mesh (tests/conftest.py), on the shapes and seeds of
tests/test_parallel.py: the sharded codec step, the row-sharded DWT
levels (5/3 exact, 9/7 within that file's tolerance of the JAX function
and bit-identical to the port's unsharded ops/dwt.py), the ragged mirror
pads, the PCRD bracket (exactly), the lane-sharded block decode, and the
entry points with a mesh: meshed decodes equal to the unmeshed port and
to grok_tpu.decompress(backend="jax", mesh=...), meshed encodes
byte-identical to the unmeshed port and to grok_tpu.compress, one block
coder call per shard counted, and the mesh refusals.  The entry-point
streams code 8x8 blocks: the plain versions' cost on the CPU grows with
the block area, once per shard."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from grok_tpu import CompressParams as JCP  # noqa: E402
from grok_tpu import DecompressParams as JDP  # noqa: E402
from grok_tpu import compress, decompress, native  # noqa: E402
from grok_tpu.core.geometry import Rect as JRect  # noqa: E402
from grok_tpu.parallel import sharding as js  # noqa: E402
from grok_tpu.t2.rate import Hull as JHull  # noqa: E402
from grok_tpu.transform import dwt_np as jdwt_np  # noqa: E402
from grok_tpu.util.oracle import synthetic_image  # noqa: E402
from grok_tpu_torch import api  # noqa: E402
from grok_tpu_torch.core.geometry import Rect  # noqa: E402
from grok_tpu_torch.core.params import CompressParams as PCP  # noqa: E402
from grok_tpu_torch.core.params import DecompressParams as PDP  # noqa: E402
from grok_tpu_torch.ops import dwt, t1_decode, t1_encode  # noqa: E402
from grok_tpu_torch.parallel import sharding as ps  # noqa: E402
from grok_tpu_torch.parallel.sharding import Mesh  # noqa: E402
from grok_tpu_torch.pipeline import serve_enc  # noqa: E402
from grok_tpu_torch.t2.rate import Hull  # noqa: E402

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C toolchain")

MESH = Mesh(("cpu",) * 8)


@pytest.fixture(scope="module")
def jmesh():
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return js.tile_mesh(8)


def _t(a, dtype=torch.int32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def test_tile_batch_codec_step_lossless(jmesh):
    rng = np.random.default_rng(0)
    tiles = rng.integers(0, 256, (16, 3, 16, 16)).astype(np.int32)
    out, dist = ps.make_codec_roundtrip_step(Rect(0, 0, 16, 16), 3)(
        ps.shard_tile_batch(tiles, MESH))
    assert len(out) == 8 and all(o.shape[0] == 2 for o in out)
    assert np.array_equal(ps.unshard(out, MESH).numpy(), tiles)
    jout, jdist = js.make_codec_roundtrip_step(JRect(0, 0, 16, 16), 3)(
        js.shard_tile_batch(tiles, jmesh))
    assert np.array_equal(np.asarray(jout), tiles)
    # the JAX statistic sums in float32, the port's exactly in float64
    assert float(dist) == pytest.approx(float(jdist), rel=1e-6)


def test_huge_tile_halo_exchange_bit_exact(jmesh):
    rng = np.random.default_rng(1)
    y = rng.integers(-500, 500, (64, 32)).astype(np.int32)
    got = ps.unshard(ps.make_inv53_vertical_sharded(MESH, 8)(
        ps.shard_tile_batch(y, MESH)), MESH).numpy()
    assert np.array_equal(got, ps.reference_inv53_vertical(y))
    jgot = np.asarray(js.make_inv53_vertical_sharded(jmesh, 8)(
        js.shard_tile_batch(y, jmesh)))
    assert np.array_equal(got, jgot)


def test_full_2d_level_sharded_bit_exact(jmesh):
    rng = np.random.default_rng(5)
    R, W = 64, 48
    bands = [rng.integers(-500, 500, (R // 2, W // 2)) for _ in range(4)]
    inter = np.empty((R, W), np.int32)
    for (a, b), band in zip(((0, 0), (0, 1), (1, 0), (1, 1)), bands):
        inter[a::2, b::2] = band
    got = ps.unshard(ps.make_inv53_2d_sharded(MESH, R // 8, W)(
        ps.shard_tile_batch(inter, MESH)), MESH)
    assert torch.equal(got, dwt.inv_2d_level(*(_t(b) for b in bands),
                                             Rect(0, 0, W, R), False))
    assert np.array_equal(got.numpy(), jdwt_np.inv_2d_level(
        *bands, JRect(0, 0, W, R), False))
    jgot = np.asarray(js.make_inv53_2d_sharded(jmesh, R // 8, W)(
        js.shard_tile_batch(inter, jmesh)))
    assert np.array_equal(got.numpy(), jgot)


@pytest.mark.parametrize("R,W,x0,y0,irrev", [
    (80, 33, 1, 1, False), (100, 37, 1, 0, False), (64, 48, 0, 0, True),
    (88, 41, 1, 1, True)])
def test_inv_2d_level_sharded_generalized(jmesh, R, W, x0, y0, irrev):
    """Odd parities, ragged rows, 9/7 (4-row halos), both directions."""
    rng = np.random.default_rng(11)
    rect = Rect(x0, y0, x0 + W, y0 + R)
    img = rng.integers(-300, 300, (R, W)).astype(np.int64)
    src = _t(img, torch.float32 if irrev else torch.int32)
    fwd = dwt.fwd_2d_level(src, rect, irrev)
    got_f = ps.fwd_2d_level_sharded(src, rect, irrev, MESH)
    assert all(torch.equal(a, b) for a, b in zip(fwd, got_f))
    ref = dwt.inv_2d_level(*fwd, rect, irrev)
    got = ps.inv_2d_level_sharded(*fwd, rect, irrev, MESH)
    assert torch.equal(got, ref)
    jrect = JRect(x0, y0, x0 + W, y0 + R)
    jbands = jdwt_np.fwd_2d_level(img.astype(np.float64) if irrev else img,
                                  jrect, irrev)
    jgot = js.inv_2d_level_sharded(*jbands, jrect, irrev, jmesh)
    jgot_f = js.fwd_2d_level_sharded(img.astype(np.float64) if irrev
                                     else img, jrect, irrev, jmesh)
    if irrev:
        assert np.allclose(got.numpy(), jgot, atol=2e-2, rtol=1e-4)
        for a, b in zip(got_f, jgot_f):
            assert np.allclose(a.numpy(), b, atol=2e-2, rtol=1e-4)
    else:
        assert np.array_equal(got.numpy(), jgot)
        assert np.array_equal(got.numpy(), img)
        for a, b in zip(got_f, jgot_f):
            assert np.array_equal(a.numpy(), b)


@pytest.mark.parametrize("irrev", [False, True])
def test_sharded_dwt_ragged_pads_all_depths(jmesh, irrev):
    """Mirror pads 1..7 over 8 shards (the deepening rule), against the
    port's unsharded levels and, for 5/3, the JAX package's."""
    rng = np.random.default_rng(3)
    for R in (71, 70, 69, 68, 66, 65):
        rect = Rect(0, 0, 16, R)
        x = rng.integers(-500, 500, (R, 16)).astype(np.int64)
        src = _t(x, torch.float32 if irrev else torch.int32)
        ref = dwt.fwd_2d_level(src, rect, irrev)
        got = ps.fwd_2d_level_sharded(src, rect, irrev, MESH)
        for a, b in zip(ref, got):
            assert torch.equal(a, b), R
        igot = ps.inv_2d_level_sharded(*ref, rect, irrev, MESH)
        assert torch.equal(dwt.inv_2d_level(*ref, rect, irrev), igot), R
        if irrev:
            continue
        jrect = JRect(0, 0, 16, R)
        jref = js.fwd_2d_level_sharded(x, jrect, False, jmesh)
        for a, b in zip(got, jref):
            assert np.array_equal(a.numpy(), b), R
        assert np.array_equal(igot.numpy(), js.inv_2d_level_sharded(
            *jref, jrect, False, jmesh)), R


def test_level_too_small_runs_unsharded_on_first_device():
    """R < 5 n rows: ops/dwt.py on the mesh's first device."""
    rect = Rect(0, 0, 16, 39)
    x = _t(np.arange(39 * 16).reshape(39, 16) % 97)
    got = ps.fwd_2d_level_sharded(x, rect, False, MESH)
    assert all(torch.equal(a, b) for a, b in
               zip(got, dwt.fwd_2d_level(x, rect, False)))
    assert ps._mirror_pad(39, 8) is None and ps._mirror_pad(40, 8) == 0
    assert ps._mirror_pad(71, 8) == 9 and ps._mirror_pad(68, 8) == 4


def test_pcrd_slope_bounds_collective(jmesh):
    rng = np.random.default_rng(3)
    slopes = [np.sort(rng.uniform(0.1, 900, rng.integers(1, 6)))[::-1]
              for _ in range(23)]
    got = ps.pcrd_slope_bounds_sharded(
        [Hull(pass_idx=np.arange(len(s)), slopes=s) for s in slopes], MESH)
    want = js.pcrd_slope_bounds_sharded(
        [JHull(pass_idx=np.arange(len(s)), slopes=s) for s in slopes],
        jmesh)
    all_s = np.concatenate(slopes)
    assert got == want == (float(all_s.min()) * 0.5,
                           float(all_s.max()) * 2.0 + 1.0)
    assert ps.pcrd_slope_bounds_sharded([], MESH) == (0.5, 3.0)


def _scalar_blocks(seed, n, side, **extra):
    from grok_tpu.t1.t1_scalar import encode_block
    rng = np.random.default_rng(seed)
    blocks, refs = [], []
    for i in range(n):
        mag = np.abs(rng.normal(0, 40, (side, side))).astype(np.int64)
        mag[rng.random((side, side)) < 0.4] = 0
        neg = rng.random((side, side)) < 0.5
        enc = encode_block(mag, neg, i % 4, 0)
        blocks.append(dict(data=enc.data, numpasses=enc.numpasses,
                           numbps=enc.numbps, orient=i % 4, w=side, h=side))
        refs.append((mag, neg))
    return blocks, refs


def test_sharded_t1_block_decode_bit_exact(monkeypatch):
    """12 lanes over 8 shards (uneven), one decode call a shard."""
    calls = _count(monkeypatch, t1_decode, "t1_decode_lanes")
    blocks, refs = _scalar_blocks(3, 12, 8)
    res = ps.decode_blocks_sharded(blocks, MESH, 8, 8)
    assert calls == [2, 2, 2, 2, 1, 1, 1, 1]
    for (mag, neg), (m2, dn) in zip(refs, res):
        assert np.array_equal(m2 >> 1, mag)
        assert np.array_equal(dn[mag > 0], neg[mag > 0])
    # mixed shapes and an empty block, bucketed
    blocks[3] = dict(blocks[3], numpasses=0)
    auto = ps.decode_blocks_sharded_auto(blocks, MESH)
    assert not auto[3][0].any()
    assert all(np.array_equal(a[0], b[0]) for k, (a, b) in
               enumerate(zip(auto, res)) if k != 3)


def test_sharded_k3_copies_every_input_before_any_launch(monkeypatch):
    """A copy between cards runs on the source card's stream, behind what
    is issued there, so every shard's inputs go out before the first
    launch, and the outputs come back after the last: the order of the
    copies and the launches of one sharded K3 call over 4 shards."""
    events, inside = [], []
    to, launch = torch.Tensor.to, t1_decode.t1_decode_lanes

    def to_spy(self, *a, **k):
        if not inside:              # the plain K3's own conversions aside
            events.append("copy")
        return to(self, *a, **k)

    def launch_spy(*a, **k):
        events.append("launch")
        inside.append(1)
        try:
            return launch(*a, **k)
        finally:
            inside.pop()

    blocks, refs = _scalar_blocks(5, 6, 8)
    args = ps._block_lanes(blocks, "cpu")
    monkeypatch.setattr(torch.Tensor, "to", to_spy)
    monkeypatch.setattr(t1_decode, "t1_decode_lanes", launch_spy)
    out = t1_decode.t1_decode_lanes_sharded(*args, 8, 8,
                                            mesh=Mesh(("cpu",) * 4))
    monkeypatch.undo()
    # 4 shards of 2, 2, 1, 1 lanes: the body and 8 lane arrays each, the
    # 4 launches, then the 4 outputs back
    assert events == ["copy"] * 36 + ["launch"] * 4 + ["copy"] * 4
    for (mag, neg), got in zip(refs, out.numpy()):
        assert np.array_equal(np.abs(got[:8, :8]) >> 1, mag)


def test_decode_tile_sharded_end_to_end():
    """Sharded K3 + sharded synthesis levels equal the host multilevel
    synthesis (the JAX package's test, in 8x8 blocks)."""
    from grok_tpu.t1.t1_scalar import encode_block
    rng = np.random.default_rng(9)
    N, numres = 64, 3
    nl = numres - 1
    band_meta, bands_ref, blocks = {}, {}, []
    for r in range(numres):
        size = N >> (nl if r == 0 else nl - r + 1)
        for o in ((0,) if r == 0 else (1, 2, 3)):
            band_meta[(r, o)] = Rect(0, 0, size, size)
            vals = rng.integers(-400, 400, (size, size)).astype(np.int64)
            bands_ref[(r, o)] = vals
            for by in range(0, size, 8):
                for bx in range(0, size, 8):
                    sub = vals[by:by + 8, bx:bx + 8]
                    enc = encode_block(np.abs(sub), sub < 0, o, 0)
                    blocks.append(dict(
                        data=enc.data, numpasses=len(enc.passes),
                        numbps=enc.numbps, orient=o, w=8, h=8, res=r,
                        bx=bx, by=by))
    out = ps.decode_tile_sharded(blocks, band_meta, MESH, Rect(0, 0, N, N),
                                 numres)
    ref = jdwt_np.inv_multilevel(
        [bands_ref[(0, 0)]] + [tuple(bands_ref[(r, o)] for o in (1, 2, 3))
                               for r in range(1, numres)],
        JRect(0, 0, N, N), numres, False)
    assert np.array_equal(out.numpy(), ref)


def _count(monkeypatch, mod, name):
    """Count the calls of a block-coder wrapper (on the CPU the wrappers
    run their plain versions, which move no launch counter), by the
    shard's call order: one entry a call, its lane count."""
    calls = []
    orig = getattr(mod, name)

    def counted(*a, **kw):
        calls.append(int(a[1].shape[0]) if name == "t1_decode_lanes"
                     else int(a[0].shape[0]))
        return orig(*a, **kw)
    monkeypatch.setattr(mod, name, counted)
    return calls


BLK = dict(cblk_w_exp=3, cblk_h_exp=3)
# the served streams: Part-1 in 1 layer (gray, RGB) and in 3, 9/7, HT,
# HT-mixed, and a window (its "window" key is the decode's, not the
# encode's)
DECODE_CASES = [
    ((160, 140, 1, 1), dict(num_resolutions=3)),
    ((126, 155, 3, 2), dict(num_resolutions=3)),
    ((128, 128, 1, 3), dict(irreversible=True, quant_step=0.002)),
    ((96, 80, 1, 4), dict(num_resolutions=3, ht=True)),
    ((80, 64, 1, 6), dict(num_resolutions=3, num_layers=3,
                          rates=[24, 8, 0])),
    ((64, 56, 1, 7), dict(num_resolutions=3, ht_mixed=True)),
    ((80, 64, 1, 8), dict(num_resolutions=3, window=(13, 9, 51, 47))),
]


def _general_calls(monkeypatch):
    """The tiles handed to the general route (pipeline/tile.py
    decode_tile, as api.py calls it), by tile index."""
    calls = []
    orig = api.decode_tile

    def counted(*a, **k):
        calls.append(a[2])
        return orig(*a, **k)
    monkeypatch.setattr(api, "decode_tile", counted)
    return calls


@pytest.mark.parametrize("shape,kw", DECODE_CASES)
def test_public_api_mesh_decode(jmesh, monkeypatch, shape, kw):
    """decompress_device(mesh=...) on the streams of test_parallel.py's
    test_public_api_mesh_decode, a 3-layer Part-1 stream, an HT stream
    (whose lanes stay on the first device), an HT-mixed stream and a
    window: served (the general route is never entered), equal to the
    unmeshed port and to the JAX package's mesh decode; K3 called once
    per shard."""
    h, w, c, seed = shape
    kw = dict(kw)
    window = kw.pop("window", None)
    img = synthetic_image(h, w, c, seed=seed)
    cs = compress(img, JCP(**kw, **BLK))
    ref = api.decompress_device(cs, PDP(window=window), device="cpu")
    general = _general_calls(monkeypatch)
    calls = _count(monkeypatch, t1_decode, "t1_decode_lanes")
    got = api.decompress_device(cs, PDP(mesh=MESH, window=window),
                                device="cpu")
    assert not general
    assert all(torch.equal(a, b) for a, b in zip(ref, got))
    assert len(calls) == (0 if kw.get("ht") else 8)
    want = decompress(cs, JDP(backend="jax", mesh=jmesh, window=window,
                              strict=False)).to_array()
    arr = np.stack([g.numpy() for g in got], -1) if c > 1 else got[0].numpy()
    if window is not None:
        x0, y0, x1, y1 = window
        arr = arr[y0:y1, x0:x1]
    assert np.array_equal(arr, want)


def test_meshed_batch_decode_is_one_staged_batch(monkeypatch):
    """decompress_device_batch(mesh=...) of 3 same-geometry Part-1
    streams: one staged batch (nothing stream by stream), K3 once per
    shard, planes equal to the unmeshed batch's."""
    cp = JCP(num_resolutions=3, **BLK)
    streams = [compress(synthetic_image(64, 56, 1, seed=40 + i), cp)
               for i in range(3)]
    ref = api.decompress_device_batch(streams, device="cpu")
    staged = []
    orig = api.stage_serving_batch

    def spy(*a, **k):
        staged.append(len(a[4]))
        return orig(*a, **k)
    monkeypatch.setattr(api, "stage_serving_batch", spy)
    monkeypatch.setattr(api, "decompress_device", None)
    general = _general_calls(monkeypatch)
    calls = _count(monkeypatch, t1_decode, "t1_decode_lanes")
    got = api.decompress_device_batch(streams, PDP(mesh=MESH), device="cpu")
    assert staged == [3] and len(calls) == 8 and not general
    assert len(got) == 3
    assert all(torch.equal(a, b) for r, g in zip(ref, got)
               for a, b in zip(r, g))


def _scene12(h: int, w: int, seed: int) -> np.ndarray:
    """A 12-bit panchromatic-like scene: a gradient under Gaussian noise
    of sigma 193 (the benchmark's 12-bit content), so that the low bands
    code 10 or more magnitude planes."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = 2048 + 24 * x - 16 * y + rng.normal(0, 193, (h, w))
    return np.clip(np.rint(img), 0, 4095).astype(np.int32)


@pytest.mark.parametrize("shards", [4])
def test_meshed_12bit_scene_is_one_exact_staged_batch(monkeypatch, shards):
    """A 12-bit Part-1 scene (16x16 blocks, 3 resolutions) decoded over
    CPU shards as the four-card benchmark cell decodes it: one staged
    batch, K3 once a shard, every synthesis level row-sharded, the
    general route never entered; the planes equal the source and the
    unmeshed decode's."""
    img = _scene12(40, 32, 23)
    cs, = api.compress_device_batch(
        [[torch.from_numpy(img)]], PCP(num_resolutions=3, cblk_w_exp=4,
                                       cblk_h_exp=4),
        prec=12, sgnd=False, device="cpu")
    ref = api.decompress_device_batch([cs], device="cpu")
    staged, levels = [], []
    stage, exchange = api.stage_serving_batch, ps._exchange

    def stage_spy(*a, **k):
        staged.append(stage(*a, **k))
        return staged[-1]

    def exchange_spy(parts, halo):
        levels.append(len(parts))
        return exchange(parts, halo)

    monkeypatch.setattr(api, "stage_serving_batch", stage_spy)
    monkeypatch.setattr(ps, "_exchange", exchange_spy)
    monkeypatch.setattr(api, "decompress_device", None)
    general = _general_calls(monkeypatch)
    calls = _count(monkeypatch, t1_decode, "t1_decode_lanes")
    mesh = Mesh(("cpu",) * shards)
    got = api.decompress_device_batch([cs], PDP(mesh=mesh), device="cpu")
    assert len(staged) == 1 and staged[0].mesh is mesh and not general
    assert int(staged[0].meta[:, 9].max()) >= 10     # magnitude planes
    nl = staged[0].meta.shape[0]
    assert calls == [nl // shards + (i < nl % shards) for i in range(shards)]
    assert levels == [shards] * 2
    assert len(got) == 1 and len(got[0]) == 1
    assert torch.equal(got[0][0], ref[0][0])
    assert np.array_equal(got[0][0].numpy(), img)


def test_meshed_mode_switches_take_the_general_route(monkeypatch):
    """A meshed Part-1 stream with mode switches (0x3F) is declined by the
    serving decode and decoded by the general route, over the mesh (its
    styled lanes on the first device), with the unmeshed planes."""
    img = synthetic_image(48, 40, 1, seed=9)
    cs = compress(img, JCP(num_resolutions=2, cblk_style=0x3F, **BLK))
    ref = api.decompress_device(cs, device="cpu")
    general = _general_calls(monkeypatch)
    got = api.decompress_device(cs, PDP(mesh=MESH), device="cpu")
    assert general == [0]
    assert all(torch.equal(a, b) for a, b in zip(ref, got))
    assert np.array_equal(got[0].numpy(), img)


@pytest.mark.parametrize("kw", [
    dict(num_resolutions=3),
    dict(num_resolutions=3, num_layers=2, rates=[8, 0]),
    dict(num_resolutions=3, ht=True)])
def test_sharded_encode_byte_identical(monkeypatch, kw):
    """compress_device(mesh=...) at test_parallel.py's parameters (and in
    HT, whose lanes stay on the first device): forward DWT rows and K5
    lanes (one call a shard) sharded; bytes equal to the unmeshed port
    and to grok_tpu.compress."""
    img = synthetic_image(160, 140, 1, seed=21)
    host = api.compress_device(img, PCP(**kw, **BLK), device="cpu")
    calls = _count(monkeypatch, t1_encode, "t1_encode_lanes")
    got = api.compress_device(img, PCP(mesh=MESH, **kw, **BLK),
                              device="cpu")
    assert len(calls) == (0 if kw.get("ht") else 8)
    assert got == host == compress(img, JCP(**kw, **BLK))


def test_sharded_encode_styled_lanes_stay_on_first_device(monkeypatch):
    """Part-1 mode switches: the lanes run unsharded (one call), the DWT
    levels sharded; the bytes are the unmeshed encode's."""
    img = synthetic_image(48, 40, 1, seed=5)
    kw = dict(num_resolutions=2, cblk_style=0x3F, **BLK)
    shard_calls = _count(monkeypatch, t1_encode, "t1_encode_lanes")
    first_calls = _count(monkeypatch, serve_enc, "t1_encode_lanes")
    got = api.compress_device(img, PCP(mesh=Mesh(("cpu",) * 2), **kw),
                              device="cpu")
    assert not shard_calls and len(first_calls) == 1
    assert got == api.compress_device(img, PCP(**kw), device="cpu") == \
        compress(img, JCP(**kw))


def test_mesh_refusals():
    with pytest.raises(ValueError, match="one device type"):
        Mesh(("cpu", "meta"))
    with pytest.raises(ValueError):
        Mesh(())
    img = np.zeros((16, 16), np.uint8)
    with pytest.raises(ValueError, match="device type"):
        api.compress_device(img, PCP(mesh=Mesh(("meta",) * 2)), device="cpu")
    with pytest.raises(ValueError, match="first device"):
        api.compress_device(img, PCP(mesh=Mesh(("cpu:1", "cpu"))),
                            device="cpu")
    cs = compress(img, JCP(num_resolutions=2))
    with pytest.raises(ValueError, match="first device"):
        api.decompress_device(cs, PDP(mesh=Mesh(("cpu:1",))), device="cpu")
    with pytest.raises(ValueError, match="parallel Mesh"):
        api.decompress_device(cs, PDP(mesh=("cpu",)), device="cpu")
    with pytest.raises(ValueError, match="visible"):
        ps.tile_mesh(2, device="cpu")
    assert ps.tile_mesh(device="cpu") == Mesh(("cpu",))
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="visible"):
            ps.tile_mesh(device="cuda")
    with pytest.raises(TypeError):
        PDP(tile_index=0)


def test_entry_and_dryrun_multichip():
    from grok_tpu_torch.parallel.entry import dryrun_multichip, entry
    step, args = entry("cpu")
    coefs, back = step(*args)
    assert coefs.abs().max() > 0 and torch.equal(coefs, back)
    got = dryrun_multichip(2, device="cpu")
    assert got["mesh"] == ["cpu", "cpu"] and np.isfinite(got["dist"])


def test_mesh_probe_measurement_on_cpu():
    """tools/mesh_probe.py's giant_tile and finest_level (the measurement
    chip_smoke.py's phase 27 runs) at a small size on CPU shards: the
    meshed bytes and planes equal the unmeshed ones, one K5 and one K3
    call a shard is kept for the recorded mesh, and both decodes were
    served."""
    from grok_tpu_torch.tools import mesh_probe
    img = synthetic_image(48, 40, 1, seed=27)
    src = torch.from_numpy(img)
    meshes = {"unmeshed": None, "2 shards": Mesh(("cpu",) * 2)}
    got = mesh_probe.giant_tile("G", src, PCP(num_resolutions=2, **BLK),
                                meshes, "cpu", reps=1, record="2 shards")
    assert got["2 shards"]["bytes"] == got["unmeshed"]["bytes"] == \
        compress(img, JCP(num_resolutions=2, **BLK))
    assert np.array_equal(got["2 shards"]["planes"].numpy(), img)
    assert len(got["2 shards"]["k5_calls"]) == 2
    assert len(got["2 shards"]["k3_calls"]) == 2
    assert not got["unmeshed"]["k5_calls"]
    assert got["2 shards"]["route"] == got["unmeshed"]["route"] == "served"
    times = mesh_probe.finest_level(src, meshes, reps=1)
    assert set(times) == set(meshes)
