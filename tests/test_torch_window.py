"""Windowed decodes of the port (grok_tpu_torch.api decompress_device with
DecompressParams.window) on both device routes, through the plain
versions on the CPU, vs grok_tpu.decompress(window=...): the served HT,
Part-1 (mq3) and HT-mixed streams (the window as a per-call block mask,
plan.py window_mask) and the general route's refined HT and Part-1 0x3F
streams (the same blocks selected), each equal to the JAX package inside
the window, at an odd offset, at the image or a tile edge, and at
reduce = 1; and fewer lanes decoded than for the whole image."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from grok_tpu import CompressParams as JCP  # noqa: E402
from grok_tpu import DecompressParams as JDP  # noqa: E402
from grok_tpu import compress, decompress, native  # noqa: E402
from grok_tpu.util.oracle import synthetic_image  # noqa: E402
from grok_tpu_torch import api  # noqa: E402
from grok_tpu_torch.core.params import DecompressParams as PDP  # noqa: E402
from grok_tpu_torch.pipeline.serve import GeneralRoute  # noqa: E402

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C toolchain")

CP = dict(num_resolutions=3, cblk_w_exp=3, cblk_h_exp=3)
KINDS = {
    "ht": dict(ht=True),
    "mq3": dict(),
    "mixed": dict(ht_mixed=True),
    "refined": dict(ht=True, ht_planes=2),
    "part1-0x3f": dict(cblk_style=0x3F),
    "ht-tiled": dict(ht=True, tile_w=32, tile_h=24),
}
GENERAL = ("refined", "part1-0x3f")
# (window, reduce): an odd interior offset, the image's top-left corner,
# a window across the tile edges at x = 32 and y = 24, and reduce = 1
WINDOWS = [((5, 7, 29, 31), 0), ((0, 0, 17, 13), 0),
           ((31, 23, 35, 27), 0), ((5, 7, 29, 31), 1),
           ((27, 19, 45, 37), 1)]


@pytest.fixture(scope="module")
def streams():
    img = synthetic_image(56, 64, 3, seed=2)
    return {k: compress(img, JCP(**CP, **kw)) for k, kw in KINDS.items()}


def _inside(arr, window, reduce):
    """The window's samples of a decode whose planes start at the image
    origin (0, 0), at `reduce`."""
    s = 1 << reduce
    x0, y0, x1, y1 = window
    return arr[y0 // s:-(-y1 // s), x0 // s:-(-x1 // s)]


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("window, reduce", WINDOWS,
                         ids=[f"{w}-r{r}" for w, r in WINDOWS])
def test_window_equals_the_jax_package_inside(streams, kind, window,
                                              reduce):
    data = streams[kind]
    got = api.decompress_device(data, PDP(window=window, reduce=reduce),
                                device="cpu")
    got = np.stack([c.numpy() for c in got], -1)
    want = decompress(data, JDP(strict=False, window=window,
                                reduce=reduce)).to_array()
    inside = _inside(got, window, reduce)
    assert inside.shape == want.shape
    assert np.array_equal(inside, want)


def _live_lanes(data, dp) -> int:
    """Lanes with a block to decode: served (HT valid or Part-1 npass)
    or on the general route (its staged rows)."""
    try:
        staged = api.stage_device_batch([data], dp, device="cpu")
        meta = staged.meta.numpy()
        return int(((meta[:, 5] != 0) | (meta[:, 8] > 0)).sum())
    except GeneralRoute:
        staged = api.stage_general_device(data, dp, device="cpu")
        ht = sum(int((m[:, 9] > 0).sum()) for m in staged.meta)
        return ht + (0 if staged.mq is None else staged.mq[1].shape[0])


@pytest.mark.parametrize("kind", ["ht", "mq3", "mixed", *GENERAL])
def test_window_decodes_fewer_lanes(streams, kind):
    data = streams[kind]
    full = _live_lanes(data, PDP())
    part = _live_lanes(data, PDP(window=(5, 7, 21, 19)))
    assert 0 < part < full


def test_tiled_window_skips_the_tiles_it_misses(streams, monkeypatch):
    """A window inside one tile of the 2 x 3 grid (tile 3) decodes that
    tile only; the other tiles' regions stay 0."""
    from grok_tpu_torch.pipeline import serve
    seen = []
    real = serve.stage_serving_batch

    def spy(cs, hdr, t, *a, **k):
        seen.append(t)
        return real(cs, hdr, t, *a, **k)
    monkeypatch.setattr(serve, "stage_serving_batch", spy)
    monkeypatch.setattr(api, "try_decode_serving_batch",
                        lambda *a, **k: spy(*a, **k).run())
    window = (36, 26, 50, 40)
    got = api.decompress_device(streams["ht-tiled"], PDP(window=window),
                                device="cpu")
    assert seen == [3]
    got = np.stack([c.numpy() for c in got], -1)
    want = decompress(streams["ht-tiled"], JDP(strict=False,
                                               window=window)).to_array()
    assert np.array_equal(_inside(got, window, 0), want)
    assert not got[:24].any() and not got[:, :32].any()
