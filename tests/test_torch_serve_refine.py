"""The port's refined, layered and rate-targeted HT encode (grok_tpu_torch.
api compress_device[_batch] -> pipeline/serve_enc.py with K4r and the
PCRD finish) and the general device decode route of the streams it makes
(api decompress_device[_batch] -> pipeline/tile.py decode_tile with K1
and K2), through the plain versions on the CPU, vs the JAX package:
byte-identical to grok_tpu.compress and bit-identical to
grok_tpu.decompress on the reversible path at every layer cap and at
reduce = 1; the 9/7 case within +-1 of the JAX package's decode of the
same stream (f32 against f64 synthesis)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from grok_tpu import CompressParams as JCP  # noqa: E402
from grok_tpu import DecompressParams as JDP  # noqa: E402
from grok_tpu import api as japi  # noqa: E402
from grok_tpu import compress, decompress, native  # noqa: E402
from grok_tpu.util.oracle import synthetic_image  # noqa: E402
from grok_tpu_torch import api  # noqa: E402
from grok_tpu_torch.core.params import CompressParams as PCP  # noqa: E402
from grok_tpu_torch.core.params import DecompressParams as PDP  # noqa: E402
from grok_tpu_torch.ops import ht_decode, ht_encode  # noqa: E402

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C toolchain")

CP = dict(ht=True, num_resolutions=3, cblk_w_exp=5, cblk_h_exp=5)
CASES = {
    "p1": dict(ht_planes=1),
    "p2": dict(ht_planes=2),
    "p2-layers": dict(ht_planes=2, rates=[8.0, 2.0], num_layers=2),
    # a second layer deep enough that PCRD ships SigProp and MagRef
    # segments in it
    "p2-layers-deep": dict(ht_planes=2, rates=[4.0, 1.5], num_layers=2),
    "p0-rate": dict(rates=[8.0]),
}


@pytest.fixture(scope="module")
def images():
    return {"gray": synthetic_image(128, 96, 1, seed=3),
            "rgb": synthetic_image(64, 96, 3, seed=5)}


@pytest.fixture(scope="module")
def streams(images):
    """Each case's port encode (device = CPU) and JAX package encode."""
    out = {}
    for name, kw in CASES.items():
        for im_name, img in images.items():
            got = api.compress_device(img, PCP(**CP, **kw), device="cpu")
            want = compress(img, JCP(backend="jax", **CP, **kw))
            out[(name, im_name)] = (got, want)
    return out


def _np(comps):
    a = [c.numpy() for c in comps]
    return a[0] if len(a) == 1 else np.stack(a, -1)


@pytest.mark.parametrize("im_name", ["gray", "rgb"])
@pytest.mark.parametrize("case", list(CASES))
def test_encode_byte_identical_to_jax_package(streams, case, im_name):
    got, want = streams[(case, im_name)]
    assert got == want


@pytest.mark.parametrize("im_name", ["gray", "rgb"])
@pytest.mark.parametrize("case", list(CASES))
def test_decode_bit_identical_at_every_layer_cap_and_reduce(
        streams, images, case, im_name):
    data = streams[(case, im_name)][0]
    nl = CASES[case].get("num_layers", 1)
    for max_layers in range(nl + 1 if nl > 1 else 1):
        for reduce in (0, 1):
            got = _np(api.decompress_device(
                data, PDP(max_layers=max_layers, reduce=reduce),
                device="cpu"))
            want = decompress(data, JDP(strict=False, max_layers=max_layers,
                                        reduce=reduce)).to_array()
            assert got.shape == want.shape
            assert np.array_equal(got, want), (max_layers, reduce)


def test_refined_encode_and_decode_run_the_refine_coders(images):
    """The refined streams go through K4r and K2's plain versions (no
    launch is counted on the CPU), and each layer of the layered stream
    raises the quality of its decode."""
    img = images["rgb"]
    seen = {}
    orig_enc = ht_encode.ht_encode_lanes_ref
    orig_ref = ht_encode.ht_refine_lanes_ref
    orig_dec = ht_decode._refine_ref

    def spy(name, fn):
        def run(*a, **k):
            seen[name] = seen.get(name, 0) + 1
            return fn(*a, **k)
        return run
    ht_encode.ht_refine_lanes_ref = spy("K4r", orig_ref)
    ht_decode._refine_ref = spy("K2", orig_dec)
    before = (ht_encode.ht_encode_lanes.refine_launches,
              ht_decode.ht_decode_lanes.refine_launches)
    try:
        kw = dict(CP, ht_planes=2, num_layers=3, rates=[12.0, 4.0, 1.5])
        data = api.compress_device(img, PCP(**kw), device="cpu")
        outs = [_np(api.decompress_device(data, PDP(max_layers=k),
                                          device="cpu"))
                for k in (1, 2, 3)]
    finally:
        ht_encode.ht_refine_lanes_ref = orig_ref
        ht_decode._refine_ref = orig_dec
    assert ht_encode.ht_encode_lanes_ref is orig_enc
    assert seen.get("K4r") == 1 and seen.get("K2", 0) >= 1
    assert (ht_encode.ht_encode_lanes.refine_launches,
            ht_decode.ht_decode_lanes.refine_launches) == before
    assert data == compress(img, JCP(backend="jax", **kw))
    psnr = [10 * np.log10(255 ** 2 / np.mean(
        (o.astype(np.float64) - img) ** 2)) for o in outs]
    assert psnr[0] < psnr[1] < psnr[2], psnr


def test_batch_encode_and_decode_of_refined_frames(images):
    frames = [images["gray"], synthetic_image(128, 96, 1, seed=4)]
    kw = dict(CP, ht_planes=1)
    data = api.compress_device_batch(frames, PCP(**kw), device="cpu")
    assert data == [compress(f, JCP(backend="jax", **kw)) for f in frames]
    # the serving decode declines the refined streams: stream by stream
    got = api.decompress_device_batch(data, device="cpu")
    for d, f, g in zip(data, frames, got):
        want = decompress(d, JDP(strict=False)).to_array()
        assert np.array_equal(_np(g), want)
        # ht_planes = 1 on the 5/3 path refines plane 0, but SigProp skips
        # a sample with no significant neighbour: near-lossless
        assert int(np.abs(_np(g).astype(np.int64) - f).max()) <= 1
    staged = api.stage_general_device(data[0], device="cpu")
    assert np.array_equal(_np(staged.run()), _np(got[0]))
    assert any(la[10].any() for la in staged.lanes)


def test_lossy_97_refined_within_one_of_the_jax_decode(images):
    img = images["rgb"]
    kw = dict(CP, irreversible=True, ht_planes=2, num_layers=2,
              rates=[12.0, 3.0])
    data = api.compress_device(img, PCP(**kw), device="cpu")
    for max_layers in (1, 2):
        got = _np(api.decompress_device(data, PDP(max_layers=max_layers),
                                        device="cpu")).astype(np.int64)
        want = decompress(data, JDP(strict=False, max_layers=max_layers)) \
            .to_array().astype(np.int64)
        assert got.shape == want.shape
        assert int(np.abs(got - want).max()) <= 1


def test_out_of_scope_on_refined_streams_still_raises(streams):
    data = streams[("p2", "rgb")][0]
    # a window decodes on the general route, equal inside the window
    got = _np(api.decompress_device(data, PDP(window=(0, 0, 32, 32)),
                                    device="cpu"))
    want = decompress(data, JDP(strict=False,
                                window=(0, 0, 32, 32))).to_array()
    assert np.array_equal(got[:32, :32], want)
    # a strict decode: the JAX package's strict device decode
    strict = _np(api.decompress_device(data, PDP(strict=True), device="cpu"))
    want = japi.decompress_device(data, JDP(strict=True))
    want = [np.asarray(a) for a in want]
    assert np.array_equal(strict, want[0] if len(want) == 1
                          else np.stack(want, -1))
    # packed packet headers (PPM) on a refined stream: the general route
    # with the Python Tier-2 parse, bit-exact to grok_tpu.decompress
    img = synthetic_image(64, 64, 1, seed=6)
    ppm = compress(img, JCP(write_ppm=True, ht_planes=2, **CP))
    assert np.array_equal(_np(api.decompress_device(ppm, device="cpu")),
                          decompress(ppm, JDP(strict=False)).to_array())


def test_targeted_encode_scope(images):
    img = images["rgb"]
    # Part-1 targeted and layered encodes are served (byte-identity:
    # tests/test_torch_serve_mq_rt.py), and quality targets, rate-targeted
    # and layered HT-mixed encodes and Part-1 encodes with ht_planes set
    # (which, as in the JAX package, leaves Part-1 blocks as they are and
    # signals its COM) (byte-identity here, on a corner of the frame: the
    # Part-1 coder's plain version is slow on the CPU)
    part = np.ascontiguousarray(img[:32, :48])
    for kw in (dict(ht=False, ht_mixed=True, rates=[8.0]),
               dict(ht=False, ht_mixed=True, num_layers=2),
               dict(ht=False, ht_planes=2)):
        assert api.compress_device(part, PCP(**dict(CP, **kw)),
                                   device="cpu") == \
            compress(part, JCP(**dict(CP, **kw)))
    kw = dict(CP, fixed_quality=True, quality=[30.0])
    assert api.compress_device(img, PCP(**kw), device="cpu") == \
        compress(img, JCP(**kw))
