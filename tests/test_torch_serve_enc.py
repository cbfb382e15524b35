"""The port's batched serving encode (grok_tpu_torch.api
compress_device[_batch] -> pipeline/serve_enc.py, kernel K4 through its
plain version on the CPU) vs the JAX package: byte-identical to the host
encoder grok_tpu.compress on the reversible path; on the 9/7 + ICT path,
decoded by grok_tpu.decompress within +-1 of the JAX device encode (f32
quantization on both devices, the scoped latitude of the repository's
"Invariants" notes); and round trips through the port's decode."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from grok_tpu import CompressParams as JCP  # noqa: E402
from grok_tpu import Image  # noqa: E402
from grok_tpu import compress, decompress, native  # noqa: E402
from grok_tpu import api as japi  # noqa: E402
from grok_tpu.core.params import MCTMode as JMCT  # noqa: E402
from grok_tpu.util.oracle import synthetic_image  # noqa: E402
from grok_tpu_torch import api  # noqa: E402
from grok_tpu_torch.core.params import CompressParams as PCP  # noqa: E402
from grok_tpu_torch.core.params import MCTMode, Poc, ProgOrder  # noqa: E402
from grok_tpu_torch.ops import ht_encode  # noqa: E402

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C toolchain")

CP = dict(ht=True, num_resolutions=3, cblk_w_exp=5, cblk_h_exp=5)


@pytest.fixture(scope="module")
def gray():
    return [synthetic_image(80, 96, 1, seed=20 + i) for i in range(3)]


@pytest.fixture(scope="module")
def rgb():
    return synthetic_image(64, 96, 3, seed=5)


def test_batch_lossless_byte_identical_to_host_encoder(gray):
    before = ht_encode.ht_encode_lanes.launches
    got = api.compress_device_batch(gray, PCP(**CP), device="cpu")
    assert ht_encode.ht_encode_lanes.launches == before   # plain version
    assert got == [compress(im, JCP(**CP)) for im in gray]
    out = api.decompress_device_batch(got, device="cpu")
    for im, comps in zip(gray, out):
        assert np.array_equal(comps[0].numpy(), im)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(write_plt=True, write_tlm=True, comment="grok", jp2=True),
    dict(sop=True, eph=True, prog_order=ProgOrder.RPCL, mct=MCTMode.NONE),
])
def test_rgb_lossless_byte_identical_and_round_trips(rgb, kw):
    got = api.compress_device(rgb, PCP(**CP, **kw), device="cpu")
    assert got == compress(rgb, JCP(**CP, **kw))
    back = api.decompress_device(got, device="cpu")
    assert np.array_equal(torch.stack(back, -1).numpy(), rgb)


def test_tensor_inputs_stay_where_they_are(gray):
    frames = [[torch.from_numpy(im.astype(np.int32))] for im in gray[:2]]
    got = api.compress_device_batch(frames, PCP(**CP), device="cpu")
    assert got == [compress(im, JCP(**CP)) for im in gray[:2]]


@pytest.mark.parametrize("device", ["cuda", "cuda:0", "meta"])
def test_tensor_on_another_device_than_asked_raises(gray, device):
    # no silent encode where the tensor lies: with or without a card
    frames = [[torch.from_numpy(gray[0].astype(np.int32))]]
    with pytest.raises(ValueError, match="asked to run on"):
        api.compress_device_batch(frames, PCP(**CP), device=device)


def test_lossy_ict_97_decodes_within_one_of_jax_device_encode(
        rgb, monkeypatch):
    monkeypatch.setenv("GROK_HT_PALLAS", "1")
    monkeypatch.setenv("GROK_PALLAS_INTERPRET", "1")
    kw = dict(CP, irreversible=True)
    got = api.compress_device(rgb, PCP(**kw), device="cpu")
    want = japi.compress_device_batch([rgb], JCP(**kw))[0]
    a = decompress(got).to_array().astype(np.int64)
    b = decompress(want).to_array().astype(np.int64)
    assert a.shape == b.shape == rgb.shape
    assert int(np.abs(a - b).max()) <= 1
    # and the port decodes its own 9/7 stream as the host decoder does
    port = torch.stack(api.decompress_device(got, device="cpu"), -1)
    assert int(np.abs(port.numpy().astype(np.int64) - a).max()) <= 1


def test_out_of_scope_parameters_raise(rgb):
    poc = Poc(rs=0, cs=0, layer_end=1, re=3, ce=3, order=ProgOrder.LRCP)
    # Part-1 targeted and layered encodes are served, as the host
    # encoder codes them, and tiled encodes too; so are POC, PPM, PLM,
    # several tile-parts and non-default precincts (the general encode's
    # stream layouts)
    for kw in (dict(ht=False, rates=[8.0]), dict(ht=False, num_layers=2),
               dict(tile_w=32, tile_h=32), dict(pocs=[poc]),
               dict(write_ppm=True), dict(write_plm=True),
               dict(max_tile_parts=2),
               dict(prec_w_exps=[4, 5, 5], prec_h_exps=[4, 5, 5])):
        assert api.compress_device(rgb, PCP(**dict(CP, **kw)),
                                   device="cpu") == \
            compress(rgb, JCP(**dict(CP, **kw)))
    # and so are layered and rate-targeted HT-mixed encodes, Part-1 mode
    # switches, AUTO_RD and ROI (on a corner of the frame: the Part-1
    # coder's plain version is slow on the CPU)
    part = np.ascontiguousarray(rgb[:32, :48])
    for kw in (dict(ht_mixed=True, ht=False, num_layers=2),
               dict(ht_mixed=True, ht=False, rates=[8.0]),
               dict(ht=False, cblk_style=0x01),
               dict(mct=MCTMode.AUTO_RD),
               dict(roi_comp=0, roi_shift=12)):
        jkw = dict(kw, mct=JMCT(kw["mct"])) if "mct" in kw else kw
        assert api.compress_device(part, PCP(**dict(CP, **kw)),
                                   device="cpu") == \
            compress(part, JCP(**dict(CP, **jkw)))
    # what stays out: subsampled components
    with pytest.raises(NotImplementedError, match="subsampled"):
        api.compress_device([rgb[:, :, 0], rgb[::2, ::2, 1],
                             rgb[::2, ::2, 2]], PCP(**CP), device="cpu")
    # Mb over 24 encodes as the reference does
    deep = rgb.astype(np.int32) << 15
    assert api.compress_device(deep, PCP(**CP, num_guard_bits=3), prec=23,
                               device="cpu") == \
        compress(Image.from_array(deep, prec=23),
                 JCP(**CP, num_guard_bits=3))


def test_no_cpu_fallback_for_a_cuda_device(gray):
    """Without a card a cuda encode raises; with one, it encodes there."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            api.compress_device_batch(gray, PCP(**CP))
        return
    assert api.compress_device_batch(gray, PCP(**CP)) == \
        [compress(im, JCP(**CP)) for im in gray]
