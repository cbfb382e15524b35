"""The port's general device decode route (grok_tpu_torch.api decompress_
device[_batch] -> pipeline/tile.py decode_tile: Part-1 blocks in every
mode switch through K3's segment tables, layered HT-mixed streams through
K1 and K3) on the JAX package's streams, through the plain versions on
the CPU, vs grok_tpu.decompress(strict=False): bit-exact on the
reversible path at every tested layer cap and reduce, within +-1 on 9/7.
Also the committed general-route codestreams (grok_tpu_torch/util/
stream_vectors.npz), rebuilt here with the JAX package."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from grok_tpu import CompressParams as JCP  # noqa: E402
from grok_tpu import DecompressParams as JDP  # noqa: E402
from grok_tpu import compress, decompress, native  # noqa: E402
from grok_tpu.codestream import j2k  # noqa: E402
from grok_tpu.core.image import Component, Image  # noqa: E402
from grok_tpu.util.oracle import synthetic_image  # noqa: E402
from grok_tpu_torch import api  # noqa: E402
from grok_tpu_torch.core.params import DecompressParams as PDP  # noqa: E402
from grok_tpu_torch.ops import ht_decode, t1_decode  # noqa: E402
from grok_tpu_torch.pipeline.serve import GeneralRoute  # noqa: E402
from grok_tpu_torch.util import stream_vectors  # noqa: E402

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C toolchain")

CP = dict(num_resolutions=3, cblk_w_exp=4, cblk_h_exp=4)
STYLES = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x3F)


def _np(comps):
    a = [c.numpy() for c in comps]
    return a[0] if len(a) == 1 else np.stack(a, -1)


def _want(data, **kw):
    return decompress(data, JDP(strict=False, **kw)).to_array()


@pytest.fixture
def launches(monkeypatch):
    """The plain versions' calls, by kernel: the block decodes the route
    made (one call per launch on the card)."""
    seen = []
    k1, k3 = ht_decode.ht_decode_lanes_ref, t1_decode.t1_decode_lanes_ref
    monkeypatch.setattr(ht_decode, "ht_decode_lanes_ref",
                        lambda *x: seen.append("K1") or k1(*x))
    monkeypatch.setattr(t1_decode, "t1_decode_lanes_ref",
                        lambda *x: seen.append("K3") or k3(*x))
    return seen


@pytest.fixture(scope="module")
def gray():
    return synthetic_image(40, 48, 1, seed=1)


@pytest.mark.parametrize("style", STYLES, ids=hex)
def test_part1_mode_switch_streams(gray, style, launches):
    """Every single mode switch and all six at once: the serving decode
    declines them (GeneralRoute), the general route decodes each with one
    K3 launch over the tile's Part-1 lanes."""
    data = compress(gray, JCP(cblk_style=style, **CP))
    with pytest.raises(GeneralRoute, match="mode switches"):
        api.stage_device_batch([data], device="cpu")
    got = _np(api.decompress_device(data, device="cpu"))
    assert launches == ["K3"]
    assert np.array_equal(got, _want(data))
    assert np.array_equal(got, gray)


@pytest.mark.parametrize("style", (0x01, 0x04, 0x3F), ids=hex)
def test_part1_mode_switches_at_reduce_1(style):
    img = synthetic_image(48, 40, 3, seed=4)
    data = compress(img, JCP(cblk_style=style, **CP))
    got = _np(api.decompress_device(data, PDP(reduce=1), device="cpu"))
    assert np.array_equal(got, _want(data, reduce=1))


@pytest.mark.parametrize("style", (0x04, 0x01), ids=("TERMALL", "BYPASS"))
@pytest.mark.parametrize("max_layers", (1, 2))
def test_two_layer_streams_at_each_cap(gray, style, max_layers):
    """Segments spread across layers: a cap that ends mid-segment decodes
    the passes the kept bytes cover, as the JAX package does."""
    data = compress(gray, JCP(cblk_style=style, num_layers=2,
                              rates=[8.0, 2.0], **CP))
    got = _np(api.decompress_device(data, PDP(max_layers=max_layers),
                                    device="cpu"))
    assert np.array_equal(got, _want(data, max_layers=max_layers))


def test_irreversible_97_bypass_within_one():
    img = synthetic_image(40, 48, 3, seed=6)
    data = compress(img, JCP(cblk_style=0x01, irreversible=True,
                             num_layers=2, rates=[8.0, 2.0], **CP))
    for max_layers in (1, 2):
        got = _np(api.decompress_device(data, PDP(max_layers=max_layers),
                                        device="cpu")).astype(np.int64)
        want = _want(data, max_layers=max_layers).astype(np.int64)
        assert got.shape == want.shape
        assert int(np.abs(got - want).max()) <= 1


def _bitmap(data):
    hdr = j2k.read_main_header(data)
    th = j2k.TileHeader()
    for p in j2k.read_tile_parts(data, hdr):
        j2k.read_tile_part_header(data, p, hdr, th)
    return th.ht_mixed_bitmap()


def _forced_mixed(img, prec, kw) -> bytes:
    """An HT-mixed encode by grok_tpu.compress in which every other
    Part-1 codeword is padded, so that HT wins those blocks (the JAX
    package's device of tests/test_ht_mixed.py, on its native coder)."""
    real = native.encode_tile_blocks
    calls = [0]

    def fat_every_other(jobs):
        out = real(jobs)
        for e in out:
            calls[0] += 1
            if calls[0] % 2 and e.data:
                e.data = e.data + b"\x00" * 4096
                e.seg_lens = [len(e.data)]
        return out

    native.encode_tile_blocks = fat_every_other
    try:
        return compress(Image(components=[Component(data=img, prec=prec)]),
                        JCP(ht_mixed=True, **kw))
    finally:
        native.encode_tile_blocks = real


@pytest.fixture(scope="module")
def layered_mixed():
    a = synthetic_image(48, 40, 1, seed=9).astype(np.int32) >> 3
    forced = _forced_mixed(a, 5, dict(CP, num_layers=2, rates=[6.0, 2.0]))
    assert 0 < sum(_bitmap(forced))
    return forced


@pytest.mark.parametrize("max_layers", (1, 2))
def test_layered_ht_mixed_with_ht_blocks(layered_mixed, max_layers,
                                         launches):
    """A layered HT-mixed stream: the serving decode declines it, the
    general route decodes its HT blocks by K1 and its Part-1 blocks,
    spread over both layers, by K3."""
    with pytest.raises(GeneralRoute, match="layered HT-mixed"):
        api.stage_device_batch([layered_mixed], device="cpu")
    launches.clear()
    got = _np(api.decompress_device(layered_mixed,
                                    PDP(max_layers=max_layers),
                                    device="cpu"))
    assert {"K1", "K3"} <= set(launches)
    assert launches.count("K3") == 1
    assert np.array_equal(got, _want(layered_mixed, max_layers=max_layers))


def test_batch_takes_general_route_streams_one_by_one(gray, layered_mixed):
    """decompress_device_batch meets GeneralRoute and decodes each stream
    through decompress_device: Part-1 mode switches, a layered HT-mixed
    stream, and a default-style stream under another main header."""
    streams = [compress(gray, JCP(cblk_style=0x3F, **CP)),
               compress(gray, JCP(cblk_style=0x01, num_layers=2,
                                  rates=[8.0, 2.0], **CP)),
               layered_mixed,
               compress(gray, JCP(**CP))]
    out = api.decompress_device_batch(streams, device="cpu")
    for s, comps in zip(streams, out):
        assert np.array_equal(_np(comps), _want(s))
    # the same-header mode-switch streams alone: still stream by stream
    same = [streams[0], compress(synthetic_image(40, 48, 1, seed=2),
                                 JCP(cblk_style=0x3F, **CP))]
    for s, comps in zip(same, api.decompress_device_batch(same,
                                                          device="cpu")):
        assert np.array_equal(_np(comps), _want(s))


def make_stream_vectors() -> dict:
    """The committed general-route codestreams of grok_tpu_torch/util/
    stream_vectors.py, from the JAX package: {name: (bytes, {layer cap:
    plane hash})}."""
    out = {}
    for name, ((h, w, ch, seed), kw) in stream_vectors.SPECS.items():
        img = synthetic_image(h, w, ch, seed=seed)
        if kw.get("ht_mixed"):
            kw = {k: v for k, v in kw.items() if k != "ht_mixed"}
            data = _forced_mixed(img, 8, kw)
        else:
            data = compress(img, JCP(**kw))
        hashes = {}
        for k in stream_vectors.LAYER_CAPS:
            im = decompress(data, JDP(strict=False, max_layers=k))
            hashes[k] = stream_vectors.plane_hash(
                c.data.astype(np.int32) for c in im.components)
        out[name] = (data, hashes)
    return out


def test_stream_vectors_are_the_jax_packages():
    """The committed codestreams and their plane hashes, rebuilt."""
    got = stream_vectors.load()
    want = make_stream_vectors()
    assert set(got) == set(want) == set(stream_vectors.NAMES)
    for name in stream_vectors.NAMES:
        assert got[name][0] == want[name][0], name
        assert got[name][1] == want[name][1], name
    assert sum(len(d) for d, _h in got.values()) < 700_000
    assert sum(_bitmap(got["mmix"][0])) > 0      # HT-won blocks
    hdr = j2k.read_main_header(got["m1"][0])
    assert hdr.cod.comp.cblk_style == 0x3F and hdr.cod.num_layers == 2


def test_stream_vectors_are_declined_by_the_serving_decode():
    """Each committed stream goes to the general route."""
    for name, (data, _h) in stream_vectors.load().items():
        with pytest.raises(GeneralRoute):
            api.stage_device_batch([data], device="cpu")
