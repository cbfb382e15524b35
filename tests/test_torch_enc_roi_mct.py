"""ROI (Maxshift) encodes and custom and AUTO_RD MCT encodes in the
PyTorch port (grok_tpu_torch.api.compress_device[_batch] on the CPU),
held against the JAX package's grok_tpu.compress_device:

  - ROI on Part-1 and HT streams, the whole component and a roi_rect:
    byte-identical (the RGN marker, the QCC of the reversible ROI
    component's raised exponents, the upshift inside each band's window)
    and decoded by the port equal to grok_tpu.decompress; the warning
    for a shift below the background's magnitude bits, in the same words;
  - AUTO_RD, lossless: the shorter of the streams with and without the
    colour transform, byte-identical (frames where either one wins);
  - a custom MCT and AUTO_RD, lossy: the port's decode of its stream and
    the JAX package's decode of its own agree within +-1 and in PSNR
    against the source within 0.1 dB; the custom MCT's parameter errors
    are the reference's.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_enc_roi_mct.py -q
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import grok_tpu  # noqa: E402
from grok_tpu import CompressParams as JCP  # noqa: E402
from grok_tpu import native  # noqa: E402
from grok_tpu.core.params import MCTMode as JMCT  # noqa: E402
from grok_tpu.util.oracle import synthetic_image  # noqa: E402
from grok_tpu_torch import api  # noqa: E402
from grok_tpu_torch.core.params import CompressParams as PCP  # noqa: E402
from grok_tpu_torch.core.params import MCTMode  # noqa: E402

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C toolchain")

CP = dict(num_resolutions=3, cblk_w_exp=4, cblk_h_exp=4)
# a matrix that mixes every component into every other
MATRIX = [[0.5, 0.3, 0.2], [-0.2, 0.5, -0.3], [0.1, -0.4, 0.3]]


@pytest.fixture(scope="module")
def rgb():
    return synthetic_image(32, 40, 3, seed=15)


def _decoded(stream) -> np.ndarray:
    comps = [c.numpy() for c in api.decompress_device(stream, device="cpu")]
    return comps[0] if len(comps) == 1 else np.stack(comps, -1)


def _jax_kw(kw: dict) -> dict:
    return dict(kw, mct=JMCT(kw["mct"])) if "mct" in kw else kw


# Part-1 cases on a 4-bit corner of the frame: the Part-1 coder's plain
# version pays for each of the shifted planes
ROI = {
    "part1_whole": dict(roi_comp=0, roi_shift=6),
    "part1_rect": dict(roi_comp=1, roi_shift=6, roi_rect=(8, 4, 20, 12),
                       cblk_style=0x01),
    "ht_whole": dict(ht=True, roi_comp=2, roi_shift=11),
    "ht_rect": dict(ht=True, roi_comp=0, roi_shift=10,
                    roi_rect=(20, 12, 40, 32), num_layers=2,
                    rates=[10.0, 3.0]),
}


@pytest.mark.parametrize("name", sorted(ROI))
def test_roi_encode_byte_identical_and_decodes(rgb, name, caplog):
    kw = dict(CP, **ROI[name])
    prec = 8
    if not kw.get("ht"):
        rgb, prec = np.ascontiguousarray(rgb[:16, :24] >> 4), 4
    with caplog.at_level(logging.WARNING):
        got = api.compress_device(rgb, PCP(**kw), prec=prec, device="cpu")
    assert not [r for r in caplog.records if "RGN shift" in r.message]
    want = grok_tpu.compress_device(rgb, JCP(**kw), prec=prec)
    assert got == want
    assert np.array_equal(_decoded(got), grok_tpu.decompress(want).to_array())


def test_roi_shift_below_background_warns_as_the_reference(rgb, caplog):
    kw = dict(CP, ht=True, roi_comp=0, roi_shift=3)
    with caplog.at_level(logging.WARNING):
        want = grok_tpu.compress_device(rgb, JCP(**kw))
    jax_msgs = [r.message for r in caplog.records if "RGN shift" in r.message]
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="grok_tpu_torch"):
        got = api.compress_device(rgb, PCP(**kw), device="cpu")
    port_msgs = [r.message for r in caplog.records
                 if "RGN shift" in r.message]
    assert jax_msgs and port_msgs == jax_msgs
    assert got == want


def test_auto_rd_lossless_keeps_the_shorter_stream(rgb):
    # a frame of like channels (the colour transform wins) and one of
    # independent noise (the transform loses)
    rng = np.random.default_rng(3)
    like = np.repeat(rgb[:, :, :1], 3, -1) // 2 + rng.integers(
        0, 4, rgb.shape, dtype=np.uint8)
    noise = rng.integers(0, 256, rgb.shape, dtype=np.uint8)
    frames = [like, noise]
    kw = dict(CP, ht=True, mct=MCTMode.AUTO_RD)
    got = api.compress_device_batch(frames, PCP(**kw), device="cpu")
    want = [grok_tpu.compress_device(f, JCP(**_jax_kw(kw))) for f in frames]
    assert got == want
    with_mct = [grok_tpu.compress_device(f, JCP(**dict(CP, ht=True)))
                for f in frames]
    assert [g == w for g, w in zip(got, with_mct)] == [True, False]
    for g, f in zip(got, frames):
        assert np.array_equal(_decoded(g), f)


def _psnr(a, ref) -> float:
    mse = ((a.astype(np.float64) - ref.astype(np.float64)) ** 2).mean()
    return 10 * np.log10(255.0 ** 2 / mse)


LOSSY = {
    "custom": dict(ht=True, mct=MCTMode.CUSTOM, custom_mct=MATRIX),
    "custom_targeted": dict(ht=True, mct=MCTMode.CUSTOM, custom_mct=MATRIX,
                            num_layers=2, rates=[16.0, 6.0]),
    "auto_rd": dict(ht=True, mct=MCTMode.AUTO_RD),
    "auto_rd_targeted": dict(ht=True, mct=MCTMode.AUTO_RD, rates=[8.0]),
}


@pytest.mark.parametrize("name", sorted(LOSSY))
def test_lossy_mct_encode_within_latitude(rgb, name):
    kw = dict(CP, irreversible=True, **LOSSY[name])
    got = api.compress_device(rgb, PCP(**kw), device="cpu")
    want = grok_tpu.compress_device(rgb, JCP(**_jax_kw(kw)))
    port = _decoded(got).astype(np.int64)
    ref = grok_tpu.decompress(want).to_array().astype(np.int64)
    assert int(np.abs(port - ref).max()) <= 1
    assert abs(_psnr(port, rgb) - _psnr(ref, rgb)) <= 0.1


def test_custom_mct_parameter_errors_are_the_reference(rgb):
    for kw in (dict(mct=MCTMode.CUSTOM),
               dict(mct=MCTMode.CUSTOM, custom_mct=MATRIX)):
        with pytest.raises(ValueError) as jax_err:
            grok_tpu.compress_device(rgb, JCP(**_jax_kw(dict(CP, **kw))))
        with pytest.raises(ValueError) as port_err:
            api.compress_device(rgb, PCP(**CP, **kw), device="cpu")
        assert str(port_err.value) == str(jax_err.value)
