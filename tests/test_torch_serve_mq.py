"""The port's Part-1 and HT-mixed serving paths (grok_tpu_torch.api ->
pipeline/serve_enc.py and pipeline/serve.py, kernels K5 and K3 through
their plain versions on the CPU) vs the JAX package: the encodes
byte-identical to grok_tpu.compress, the decodes bit-exact to the source
pixels for the port's own streams and the JAX package's (2-layer Part-1
and HT-mixed with HT-won blocks among them), and every route outside the
slice raising NotImplementedError."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from grok_tpu import CompressParams as JCP  # noqa: E402
from grok_tpu import compress, native  # noqa: E402
from grok_tpu.codestream import j2k  # noqa: E402
from grok_tpu.core.image import Component, Image  # noqa: E402
from grok_tpu.util.oracle import synthetic_image  # noqa: E402
from grok_tpu_torch import api  # noqa: E402
from grok_tpu_torch.core.params import CBLK_BYPASS, CBLK_VSC  # noqa: E402
from grok_tpu_torch.core.params import CompressParams as PCP  # noqa: E402
from grok_tpu_torch.ops import ht_decode, t1_decode, t1_encode  # noqa: E402
from grok_tpu_torch.pipeline.serve import GeneralRoute  # noqa: E402

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C toolchain")

CP = dict(num_resolutions=3, cblk_w_exp=4, cblk_h_exp=4)


def _img(a, prec):
    return Image(components=[Component(data=a, prec=prec)])


def _np(comps):
    a = [c.numpy() for c in comps]
    return a[0] if len(a) == 1 else np.stack(a, -1)


@pytest.fixture(scope="module")
def gray():
    """2-3-bit gray frames, 40x56 (not a power of two)."""
    return [synthetic_image(40, 56, 1, seed=20 + i).astype(np.int32) >> 5
            for i in range(2)]


@pytest.fixture(scope="module")
def rgb():
    return synthetic_image(24, 40, 3, seed=5)


@pytest.fixture(scope="module")
def own(gray, rgb):
    before = t1_encode.t1_encode_lanes.launches
    g = api.compress_device_batch(gray, PCP(**CP), prec=3, device="cpu")
    c = api.compress_device(rgb, PCP(**CP), device="cpu")
    assert t1_encode.t1_encode_lanes.launches == before   # plain version
    return g, c


def test_part1_encode_byte_identical_to_host_encoder(gray, rgb, own):
    g, c = own
    assert g == [compress(_img(a, 3), JCP(backend="scalar", **CP))
                 for a in gray]
    assert c == compress(rgb, JCP(backend="scalar", **CP))


def test_mixed_encode_byte_identical_to_host_encoder():
    a = synthetic_image(40, 56, 1, seed=3).astype(np.int32) >> 4
    kw = dict(CP, cblk_w_exp=5, cblk_h_exp=5)
    got = api.compress_device(a, PCP(ht_mixed=True, **kw), prec=4,
                              device="cpu")
    assert got == compress(_img(a, 4), JCP(ht_mixed=True, **kw))
    assert np.array_equal(_np(api.decompress_device(got, device="cpu")), a)


def test_decode_own_part1_streams(gray, rgb, own):
    g, c = own
    before = t1_decode.t1_decode_lanes.launches
    out = api.decompress_device_batch(g, device="cpu")
    assert t1_decode.t1_decode_lanes.launches == before
    for a, comps in zip(gray, out):
        assert comps[0].dtype == torch.int32
        assert np.array_equal(_np(comps), a)
    assert np.array_equal(_np(api.decompress_device(c, device="cpu")), rgb)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(num_layers=2, rates=[6.0, 1.0]),
    dict(irreversible=True, num_layers=2, rates=[8.0, 2.0]),
    dict(sop=True, eph=True, prog_order=2, write_plt=True),
])
def test_decode_jax_part1_streams(kw):
    a = synthetic_image(40, 48, 1, seed=7).astype(np.int32) >> 4
    data = compress(_img(a, 4), JCP(**CP, **kw))
    got = _np(api.decompress_device(data, device="cpu"))
    from grok_tpu import decompress
    assert np.array_equal(got, decompress(data).to_array())
    if not kw.get("irreversible"):
        assert np.array_equal(got, a)


def _bitmap(data):
    hdr = j2k.read_main_header(data)
    th = j2k.TileHeader()
    for p in j2k.read_tile_parts(data, hdr):
        j2k.read_tile_part_header(data, p, hdr, th)
    return th.ht_mixed_bitmap()


def test_decode_mixed_streams_with_ht_blocks(monkeypatch):
    """HT wins few blocks of natural content, so the JAX package's tests
    pad every other Part-1 codeword to force HT blocks; a batch of the
    forced stream and a natural one (different bitmaps) decodes through
    both K1 and K3."""
    import grok_tpu.pipeline.tile as tile_pipe
    a = synthetic_image(48, 40, 1, seed=9).astype(np.int32) >> 3
    kw = dict(CP, cblk_w_exp=3, cblk_h_exp=3)
    natural = compress(_img(a, 5), JCP(ht_mixed=True, **kw))
    real = tile_pipe.encode_block
    calls = {"n": 0}

    def fat_every_other(mag, neg, orient, style):
        e = real(mag, neg, orient, style)
        calls["n"] += 1
        if calls["n"] % 2 and e.data:
            e.data = e.data + b"\x00" * 4096
            e.seg_lens = [len(e.data)]
        return e

    monkeypatch.setattr(tile_pipe, "encode_block", fat_every_other)
    forced = compress(_img(a, 5), JCP(ht_mixed=True, backend="scalar",
                                      **kw))
    monkeypatch.undo()
    assert sum(_bitmap(forced)) > sum(_bitmap(natural))
    k1, k3 = (ht_decode.ht_decode_lanes_ref, t1_decode.t1_decode_lanes_ref)
    seen = []
    monkeypatch.setattr(ht_decode, "ht_decode_lanes_ref",
                        lambda *x: seen.append("K1") or k1(*x))
    monkeypatch.setattr(t1_decode, "t1_decode_lanes_ref",
                        lambda *x: seen.append("K3") or k3(*x))
    out = api.decompress_device_batch([forced, natural], device="cpu")
    assert {"K1", "K3"} <= set(seen)
    for comps in out:
        assert np.array_equal(_np(comps), a)


@pytest.mark.parametrize("kw", [
    dict(cblk_style=CBLK_BYPASS),
    dict(cblk_style=CBLK_VSC),
    dict(num_layers=2),
    dict(rates=[8.0]),
    dict(ht_mixed=True, num_layers=2),
])
def test_out_of_scope_encodes_raise(gray, kw):
    """Encodes once out of the port's scope, now served: mode switches
    (kernel K5 takes them), multi-layer and rate-targeted Part-1 and
    layered HT-mixed encodes, byte-identical to the host encoder
    (tests/test_torch_serve_mq_rt.py and tests/test_torch_enc_modes.py
    cover them in full)."""
    params = dict(CP, **kw)
    got = api.compress_device(gray[0], PCP(**params), prec=3, device="cpu")
    assert got == compress(_img(gray[0], 3), JCP(**params))


@pytest.mark.parametrize("kw, what", [
    (dict(cblk_style=CBLK_BYPASS), None),
    (dict(cblk_style=0x3F), None),
    (dict(write_ppm=True), "PPM"),
])
def test_out_of_scope_streams_raise(gray, kw, what):
    """Mode-switch streams and packed packet headers (PPM) decode on the
    general route, bit-exact to the JAX package's decode
    (grok_tpu.decompress: its device decode is wrong on PPM)."""
    data = compress(_img(gray[0], 3), JCP(**CP, **kw))
    from grok_tpu import DecompressParams, decompress
    got = _np(api.decompress_device(data, device="cpu"))
    assert np.array_equal(got, decompress(
        data, DecompressParams(strict=False)).to_array())
    assert np.array_equal(got, gray[0])
    if what == "PPM":
        assert j2k.read_main_header(data).ppm is not None
        with pytest.raises(GeneralRoute, match="PPM"):
            api.stage_device_batch([data], device="cpu")


@pytest.fixture(scope="module")
def mixed_pair():
    """(planes, [forced, natural]): an HT-mixed stream with HT blocks
    forced as in test_decode_mixed_streams_with_ht_blocks, and a natural
    one, of one frame."""
    import grok_tpu.pipeline.tile as tile_pipe
    a = synthetic_image(48, 40, 1, seed=9).astype(np.int32) >> 3
    kw = dict(CP, cblk_w_exp=3, cblk_h_exp=3)
    natural = compress(_img(a, 5), JCP(ht_mixed=True, **kw))
    real = tile_pipe.encode_block
    calls = {"n": 0}

    def fat_every_other(mag, neg, orient, style):
        e = real(mag, neg, orient, style)
        calls["n"] += 1
        if calls["n"] % 2 and e.data:
            e.data = e.data + b"\x00" * 4096
            e.seg_lens = [len(e.data)]
        return e

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tile_pipe, "encode_block", fat_every_other)
        forced = compress(_img(a, 5), JCP(ht_mixed=True, backend="scalar",
                                          **kw))
    return a, [forced, natural]


@pytest.mark.parametrize("case", ["part1", "part1_layers", "mixed"])
def test_arena_upload_equals_the_joined_layout(gray, own, mixed_pair, case,
                                               monkeypatch):
    """Part-1 batches (one layer: each raw body copied from a view of
    its stream; two layers: the compact body of each block's chunks) and
    an HT-mixed batch (raw body, then digest, a stream): the staged body
    and meta equal the plain layout byte for byte, and the planes equal
    the source (the stream-by-stream decode of the lossy layers)."""
    from grok_tpu_torch.pipeline import plan as pplan
    from grok_tpu_torch.pipeline import serve
    from staging_ref import joined_layout
    monkeypatch.setattr(pplan, "_PLANS", {})
    joins = []
    if case == "part1":
        planes, streams = gray, own[0]
    elif case == "part1_layers":
        # lossy layers at 8 bits: every stream's blocks spread over both
        streams = [compress(_img(synthetic_image(40, 56, 1, seed=20 + i)
                                 .astype(np.int32), 8),
                            JCP(num_layers=2, rates=[8.0, 2.0], **CP))
                   for i in range(2)]
        planes = [_np(api.decompress_device(s, device="cpu"))
                  for s in streams]
        concat = serve._concat_layers
        monkeypatch.setattr(serve, "_concat_layers", lambda *a: (
            joins.append(1), concat(*a))[1])
    else:
        a, streams = mixed_pair
        planes = [a, a]
    staged = api.stage_device_batch(streams, device="cpu")
    assert len(joins) == (2 if case == "part1_layers" else 0)
    body_cat, meta = joined_layout(streams)
    assert np.array_equal(staged.body.numpy(), body_cat)
    assert np.array_equal(staged.meta.numpy(), meta)
    if case == "mixed":
        # both coders' lanes: raw Part-1 bytes and HT digests
        assert staged.meta[:, 5].any() and (staged.meta[:, 8] > 0).any()
    for want, got in zip(planes, staged.run()):
        assert np.array_equal(_np(got), want)
