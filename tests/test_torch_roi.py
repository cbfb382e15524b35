"""ROI (Maxshift), tile-part COC/QCC/RGN/POC overrides and custom-MCT
streams on the port's device decode (api.decompress_device[_batch] on
the CPU, the plain versions), held bit-exact to the JAX package's
decode, grok_tpu.decompress(strict=False) (its Part-1 blocks decoded
within their own bytes: test_torch_t2_parse.py ref_decode), within +-1
on the 9/7 path.

The JAX package's encoder writes COC, QCC and POC only in the main
header (and COC never): `_coc_compress` codes a component with fewer
resolutions under a main-header COC and QCC, and
grok_tpu_torch/util/stream_edit.py move_to_tile_parts moves the segments
into every tile's header, where they mean what they meant in the main
header."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from grok_tpu import CompressParams as JCP  # noqa: E402
from grok_tpu import compress, native  # noqa: E402
from grok_tpu.codestream import j2k as jj2k  # noqa: E402
from grok_tpu.core.params import MCTMode, Poc, ProgOrder  # noqa: E402
from grok_tpu.util.oracle import synthetic_image  # noqa: E402
from grok_tpu_torch import api  # noqa: E402
from grok_tpu_torch.codestream import j2k as pj2k  # noqa: E402
from grok_tpu_torch.core.params import DecompressParams as PDP  # noqa: E402
from grok_tpu_torch.ops import mct as pmct  # noqa: E402
from grok_tpu_torch.pipeline.serve import GeneralRoute  # noqa: E402
from grok_tpu_torch.transform import mct_np as pmct_np  # noqa: E402
from grok_tpu_torch.util import stream_edit  # noqa: E402
from test_torch_t2_parse import (_coc_compress, _img, _np,  # noqa: E402
                                 port_decode, ref_decode)

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C toolchain")

CP = dict(num_resolutions=3, cblk_w_exp=4, cblk_h_exp=4)
CP1 = dict(CP, cblk_w_exp=3, cblk_h_exp=3)     # Part-1: quick plain K3
WIN = (9, 17, 41, 50)
POCS = [Poc(rs=0, cs=0, layer_end=2, re=2, ce=3, order=ProgOrder.RLCP),
        Poc(rs=2, cs=0, layer_end=2, re=3, ce=3, order=ProgOrder.CPRL)]


@pytest.fixture(scope="module")
def rgb():
    return synthetic_image(64, 72, 3, seed=21)


@pytest.fixture(scope="module")
def rgb3():
    """3-bit RGB samples: quick plain Part-1 decodes."""
    return _img(synthetic_image(64, 72, 3, seed=21).astype(np.int32) >> 5,
                3)


@pytest.fixture(scope="module")
def gray():
    return _img(synthetic_image(64, 64, 1, seed=22).astype(np.int32) >> 5,
                3)


@pytest.mark.parametrize("coder", ["part1", "ht"])
@pytest.mark.parametrize("where", ["main", "tile"])
def test_roi_maxshift_decodes(rgb, gray, coder, where):
    """RGN in the main header or in the tile header, a Maxshift ROI over
    a rect: Part-1 on one tile (the served decode), HT on 2x2 tiles;
    whole, and with the RGN in the main header at reduce=1 and in a
    window."""
    img, kw = (rgb, dict(CP, ht=True, tile_w=32, tile_h=32)) \
        if coder == "ht" else (gray, CP1)
    data = compress(img, JCP(roi_comp=0, roi_shift=5,
                             roi_rect=(20, 12, 52, 44), **kw))
    decodes = (dict(), dict(reduce=1), dict(window=WIN))
    if where == "tile":
        data = stream_edit.move_to_tile_parts(data, (pj2k.RGN,))
        assert not pj2k.read_main_header(data).rgn
        decodes = decodes[:1]
    for dk in decodes:
        assert np.array_equal(port_decode(data, **dk),
                              ref_decode(data, **dk)), dk


def test_roi_single_tile_is_served(rgb):
    """A main-header ROI needs no general route: the served batch undoes
    the Maxshift on the device."""
    data = compress(rgb, JCP(roi_comp=1, roi_shift=4, ht=True, **CP))
    staged = api.stage_device_batch([data, data], device="cpu")
    for comps in staged.run():
        assert np.array_equal(_np(comps), ref_decode(data))


@pytest.mark.parametrize("coder", ["part1", "ht"])
def test_tile_coc_qcc_poc_decode(rgb, rgb3, coder):
    """COC/QCC (component 1 in 2 resolutions) and a POC moved into the
    tile headers of 2x2 tiles, and two streams whose main headers are
    equal and whose moved COC differs, decoded one after the other (a
    plan cached on the main header alone would decode the second with
    the first's geometry)."""
    img, kw = (rgb, dict(CP, ht=True)) if coder == "ht" else \
        (rgb3, dict(CP1, cblk_style=0x3F))
    params = JCP(pocs=POCS, num_layers=2, rates=[10.0, 4.0], tile_w=32,
                 tile_h=32, **kw)
    a = stream_edit.move_to_tile_parts(_coc_compress(img, params, 1, 2))
    b = stream_edit.move_to_tile_parts(_coc_compress(img, params, 2, 2))
    ha, hb = (pj2k.read_main_header(x) for x in (a, b))
    assert a[:ha.main_header_end] == b[:hb.main_header_end]
    assert not ha.coc and not ha.qcc and not ha.pocs
    for dk in (dict(), dict(max_layers=1) if coder == "ht"
               else dict(reduce=1)):
        assert np.array_equal(port_decode(a, **dk), ref_decode(a, **dk)), dk
    assert np.array_equal(port_decode(b), ref_decode(b))


def test_single_tile_overrides_in_a_batch(rgb):
    """One-tile streams with tile COC/QCC/POC: each decoded by its own
    plan, also in a batch with an unedited stream."""
    params = JCP(pocs=POCS, num_layers=2, rates=[10.0, 4.0], ht=True, **CP)
    plain = _coc_compress(rgb, params, 2, 2)
    moved = stream_edit.move_to_tile_parts(plain)
    with pytest.raises(GeneralRoute):
        api.stage_device_batch([moved, moved], device="cpu")
    got = api.decompress_device_batch([plain, moved], device="cpu")
    want = ref_decode(plain)
    assert np.array_equal(want, ref_decode(moved))
    assert all(np.array_equal(_np(g), want) for g in got)


MATRIX = np.array([[0.5, 0.3, 0.2], [-0.2, 0.6, -0.4], [0.1, -0.5, 0.4]])


@pytest.mark.parametrize("coder", ["part1", "ht"])
def test_custom_mct_irreversible(rgb, rgb3, coder):
    """grok_tpu.compress's custom MCT (9/7 only): within +-1."""
    img, kw = (rgb, dict(CP, ht=True)) if coder == "ht" else (rgb3, CP1)
    data = compress(img, JCP(irreversible=True, mct=MCTMode.CUSTOM,
                             custom_mct=MATRIX, **kw))
    got = port_decode(data).astype(np.int64)
    assert int(np.abs(got - ref_decode(data)).max()) <= 1


@pytest.mark.parametrize("coder", ["part1", "ht", "mixed"])
def test_custom_mct_reversible_components(rgb, rgb3, coder):
    """A 5/3 stream under a custom MCT (its MCT, MCC and MCO segments
    added to the main header of a stream coded without a colour
    transform): bit-exact, rounded as the JAX package rounds it, to the
    nearest integer where its C block decoder takes the tile (Part-1
    blocks only), toward zero on its host route (HT blocks)."""
    img, kw = {"part1": (rgb3, CP1), "ht": (rgb, dict(CP, ht=True)),
               "mixed": (rgb3, dict(CP, ht_mixed=True))}[coder]
    data = compress(img, JCP(mct=MCTMode.NONE, **kw))
    at = data.index(b"\xff\x90")
    data = data[:at] + jj2k.write_mct_set(MATRIX) + data[at:]
    assert np.array_equal(port_decode(data), ref_decode(data))
    with pytest.raises(GeneralRoute, match="custom MCT"):
        api.stage_device_batch([data], device="cpu")


def test_custom_mct_inverse_copies():
    """The port's NumPy copy and device inverse against the JAX
    package's custom_mct_inv."""
    from grok_tpu.transform.mct_np import custom_mct_inv as jinv
    rng = np.random.default_rng(5)
    comps = [rng.integers(-300, 300, (7, 9)) for _ in range(3)]
    want = jinv(comps, MATRIX)
    for a, b in zip(pmct_np.custom_mct_inv(comps, MATRIX), want):
        assert np.array_equal(a, b)
    inv = torch.from_numpy(pmct_np.custom_mct_inverse(MATRIX))
    got = pmct.custom_mct([torch.from_numpy(c).to(torch.int32)
                           for c in comps], inv)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), b)


def test_blocks_over_64_still_raise():
    """Code-blocks over 64 on a side (128 x 32 here) no longer raise: the
    decode equals grok_tpu.decompress."""
    img = _img(synthetic_image(40, 140, 1, seed=23).astype(np.int32) >> 5,
               3)
    data = compress(img, JCP(num_resolutions=1, cblk_w_exp=7, cblk_h_exp=5))
    assert np.array_equal(port_decode(data), ref_decode(data))
