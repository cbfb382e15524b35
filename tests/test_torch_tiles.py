"""Tiled streams in the port (grok_tpu_torch.api compress_device[_batch]
tile by tile through pipeline/serve_enc.py, decompress_device[_batch] tile
by tile through the serving decode or the general route, each tile pasted
into a full-image canvas), through the plain versions on the CPU, vs the
JAX package: reversible encodes byte-identical to grok_tpu.compress (HT,
Part-1, HT-mixed, refined and 2-layer rate-targeted, with TLM and PLT,
edge tiles whose size is not a multiple of 2^levels, and a tile offset on
an image off the canvas origin); decodes bit-exact to grok_tpu.decompress
at reduce and max_layers and in a window across tiles; a batch of tiled
streams equal to their single decodes.  Also the Tier-2 finish's device,
which every caller must name."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from grok_tpu import CompressParams as JCP  # noqa: E402
from grok_tpu import DecompressParams as JDP  # noqa: E402
from grok_tpu import compress, decompress, native  # noqa: E402
from grok_tpu.core.image import Component, Image  # noqa: E402
from grok_tpu.util.oracle import synthetic_image  # noqa: E402
from grok_tpu_torch import api  # noqa: E402
from grok_tpu_torch.core.params import CompressParams as PCP  # noqa: E402
from grok_tpu_torch.core.params import DecompressParams as PDP  # noqa: E402
from grok_tpu_torch.pipeline import serve_enc, tile  # noqa: E402

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C toolchain")

# 60 x 50 in 32 x 24 tiles: a 2 x 3 grid whose edge tiles are 28 wide and
# 2 tall (not a multiple of 2^2)
CP = dict(num_resolutions=3, cblk_w_exp=3, cblk_h_exp=3, tile_w=32,
          tile_h=24, write_tlm=True, write_plt=True)
KINDS = {
    "ht": dict(ht=True),
    "part1": dict(),
    "mixed": dict(ht_mixed=True),
    "refined": dict(ht=True, ht_planes=1),
    "ht-2-layers": dict(ht=True, num_layers=2, rates=[8.0, 2.0]),
    "part1-2-layers": dict(num_layers=2, rates=[8.0, 2.0]),
}


def _np(comps):
    a = [c.numpy() for c in comps]
    return a[0] if len(a) == 1 else np.stack(a, -1)


@pytest.fixture(scope="module")
def rgb():
    return synthetic_image(50, 60, 3, seed=8)


@pytest.fixture(scope="module")
def streams(rgb):
    return {k: api.compress_device(rgb, PCP(**CP, **kw), device="cpu")
            for k, kw in KINDS.items()}


@pytest.mark.parametrize("kind", list(KINDS))
def test_tiled_encode_is_the_jax_packages(rgb, streams, kind):
    assert streams[kind] == compress(rgb, JCP(**CP, **KINDS[kind]))


def test_tiled_encode_with_a_tile_offset():
    """An image at (5, 3) on the canvas, tiles anchored at (2, 1): the
    first row and column of tiles are 29 and 22 samples."""
    gray = synthetic_image(40, 52, 1, seed=3)
    kw = dict(CP, tile_off_x=2, tile_off_y=1)
    for extra in (dict(ht=True), dict()):
        got = api.compress_device(gray, PCP(**kw, **extra), device="cpu",
                                  origin=(5, 3))
        img = Image(components=[Component(data=gray, prec=8)], x0=5, y0=3)
        assert got == compress(img, JCP(**kw, **extra))
        assert np.array_equal(_np(api.decompress_device(got, device="cpu")),
                              gray)


@pytest.mark.parametrize("kind", list(KINDS))
def test_tiled_decode_is_the_jax_packages(rgb, streams, kind):
    data = streams[kind]
    got = _np(api.decompress_device(data, device="cpu"))
    want = decompress(data, JDP(strict=False)).to_array()
    assert np.array_equal(got, want)
    if kind in ("ht", "part1", "mixed"):     # the lossless encodes
        assert np.array_equal(got, rgb)


@pytest.mark.parametrize("dp", [dict(reduce=1), dict(max_layers=1),
                                dict(reduce=1, max_layers=1)],
                         ids=["reduce1", "layers1", "reduce1-layers1"])
@pytest.mark.parametrize("kind", ["ht-2-layers", "part1-2-layers"])
def test_tiled_decode_at_reduce_and_layer_caps(streams, kind, dp):
    data = streams[kind]
    got = _np(api.decompress_device(data, PDP(**dp), device="cpu"))
    want = decompress(data, JDP(strict=False, **dp)).to_array()
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def test_tiled_part1_mode_switches_take_the_general_route(rgb):
    """Every tile of a 0x3F stream is declined by the serving decode and
    decoded on the general route."""
    data = compress(rgb, JCP(cblk_style=0x3F, **CP))
    got = _np(api.decompress_device(data, device="cpu"))
    assert np.array_equal(got, rgb)
    window = (20, 10, 45, 30)
    got = _np(api.decompress_device(data, PDP(window=window), device="cpu"))
    want = decompress(data, JDP(strict=False, window=window)).to_array()
    assert np.array_equal(got[10:30, 20:45], want)


def test_window_across_tiles(streams):
    window = (21, 13, 47, 39)          # meets 4 of the 6 tiles
    got = _np(api.decompress_device(streams["ht"], PDP(window=window),
                                    device="cpu"))
    want = decompress(streams["ht"], JDP(strict=False,
                                         window=window)).to_array()
    assert np.array_equal(got[13:39, 21:47], want)
    assert not got[48:].any()          # the bottom tiles are not decoded


def test_batch_of_tiled_streams(rgb, streams):
    frames = [rgb, synthetic_image(50, 60, 3, seed=9)]
    data = api.compress_device_batch(frames, PCP(**CP, ht=True),
                                     device="cpu")
    assert data[0] == streams["ht"]
    assert data[1] == api.compress_device(frames[1], PCP(**CP, ht=True),
                                          device="cpu")
    got = api.decompress_device_batch(data + [streams["part1"]],
                                      device="cpu")
    for d, g in zip(data + [streams["part1"]], got):
        assert np.array_equal(_np(g), _np(api.decompress_device(
            d, device="cpu")))
    assert np.array_equal(_np(got[1]), frames[1])


def test_finish_tile_encode_needs_its_device(monkeypatch):
    """The Tier-2 finish has no default device (its trial decodes run
    where the caller's encode runs), and every encode route, the HT-mixed
    one included, names its own."""
    geo = serve_enc._plan_for(api._build_main_header(
        16, 16, 1, 8, False, PCP(ht=True, num_resolutions=2)), 0).geo
    with pytest.raises(TypeError, match="device"):
        tile.finish_tile_encode(geo, [], [])
    seen = []
    real = serve_enc.finish_tile_encode

    def spy(*a, **k):
        seen.append(k["device"])
        return real(*a, **k)
    monkeypatch.setattr(serve_enc, "finish_tile_encode", spy)
    gray = synthetic_image(40, 48, 1, seed=2)
    for kw in (dict(ht_mixed=True), dict(ht=True), dict()):
        api.compress_device(gray, PCP(**CP, **kw), device="cpu")
    assert seen and all(d == torch.device("cpu") for d in seen)
    assert len(seen) == 3 * 4           # 2 x 2 tiles per encode
