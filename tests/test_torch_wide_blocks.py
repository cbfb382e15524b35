"""Code-blocks over 64 on a side (sides up to 1024, at most 4096 samples:
128 x 32, 16 x 256, 1024 x 4, 256 x 16) through the port's device decode
on the CPU (the plain versions of K1, K2 and K3), held bit-exact to
grok_tpu.decompress: HT, refined HT (ht_planes=2, 2 layers, the general
route with K2), Part-1 default style (served) and every mode switch
(0x3F, the general route), HT-mixed; whole, in a window, at reduce=1,
under a layer cap, and as a batch of two.  A 160 x 136 frame gives
blocks up to 80 wide and 68 tall (buckets up to 128 on a side); the
Part-1 frames have 3-bit samples, whose few passes keep the plain K3
quick.

    python -m pytest tests/test_torch_wide_blocks.py -q
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from grok_tpu import CompressParams as JCP  # noqa: E402
from grok_tpu import DecompressParams as JDP  # noqa: E402
from grok_tpu import compress, decompress, native  # noqa: E402
from grok_tpu.core.image import ColorSpace, Component, Image  # noqa: E402
from grok_tpu.util.oracle import synthetic_image  # noqa: E402
from grok_tpu_torch import api  # noqa: E402
from grok_tpu_torch.core.params import DecompressParams as PDP  # noqa: E402
from grok_tpu_torch.ops import ht_decode, t1_decode  # noqa: E402
from grok_tpu_torch.pipeline import plan as pplan  # noqa: E402
from grok_tpu_torch.pipeline.serve import GeneralRoute  # noqa: E402
from grok_tpu_torch.util import damaged_vectors as dv  # noqa: E402
from grok_tpu_torch.util import stream_vectors  # noqa: E402
from grok_tpu_torch.util import wide_vectors as wv  # noqa: E402

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C toolchain")

W0, H0 = 160, 136
# (cblk_w_exp, cblk_h_exp) per nominal block shape
SHAPES = {"128x32": (7, 5), "16x256": (4, 8), "1024x4": (10, 2),
          "256x16": (8, 4)}


@pytest.fixture(scope="module")
def rgb():
    return synthetic_image(H0, W0, 3, seed=41)


@pytest.fixture(scope="module")
def gray3():
    a = synthetic_image(H0, W0, 1, seed=42).astype(np.int32) >> 5
    return Image(components=[Component(a, prec=3, sgnd=False)],
                 color_space=ColorSpace.GRAY)


def _ref(data: bytes, **kw) -> np.ndarray:
    im = decompress(data, JDP(strict=False, **kw))
    return np.stack([c.data for c in im.components])


def _port(data: bytes, **kw) -> np.ndarray:
    return np.stack([g.numpy() for g in
                     api.decompress_device(data, PDP(**kw), device="cpu")])


def _cp(shape: str, **kw) -> JCP:
    xw, yh = SHAPES[shape]
    return JCP(num_resolutions=3, cblk_w_exp=xw, cblk_h_exp=yh, **kw)


def _wide_buckets(data: bytes) -> list:
    """The plan's bucket dims over 64 on a side."""
    from grok_tpu_torch.codestream import j2k as pj2k
    hdr = pj2k.read_main_header(data)
    part, = pj2k.read_tile_parts(data, hdr)
    th = pj2k.TileHeader()
    pj2k.read_tile_part_header(data, part, hdr, th)
    plan = pplan._plan_for(data, hdr, 0, th, 0)
    return [d for d in plan.bucket_dims if max(d) > 64]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_ht_wide_blocks_served_equal_the_jax_package(rgb, shape):
    data = compress(rgb, _cp(shape, ht=True))
    assert _wide_buckets(data)
    api.stage_device_batch([data], device="cpu")       # served, not general
    assert np.array_equal(_port(data), _ref(data))


def test_ht_wide_blocks_window_reduce_and_batch(rgb):
    data = compress(rgb, _cp("128x32", ht=True))
    win = (37, 21, 131, 101)
    got = _port(data, window=win)[:, win[1]:win[3], win[0]:win[2]]
    assert np.array_equal(got, _ref(data, window=win))
    assert np.array_equal(_port(data, reduce=1), _ref(data, reduce=1))
    other = compress(synthetic_image(H0, W0, 3, seed=43),
                     _cp("128x32", ht=True))
    got = api.decompress_device_batch([data, other], device="cpu")
    for g, d in zip(got, (data, other)):
        assert np.array_equal(np.stack([c.numpy() for c in g]), _ref(d))


def test_refined_ht_wide_blocks_on_the_general_route(rgb):
    """ht_planes=2 in 2 layers with 256 x 16 blocks: K2 on wide lanes,
    whole, at a layer cap of 1 and in a window."""
    data = compress(rgb, _cp("256x16", ht=True, ht_planes=2, num_layers=2,
                             rates=[8.0, 2.0]))
    with pytest.raises(GeneralRoute):
        api.stage_device_batch([data], device="cpu")
    before = ht_decode.ht_decode_lanes.refine_launches
    assert np.array_equal(_port(data), _ref(data))
    assert np.array_equal(_port(data, max_layers=1), _ref(data,
                                                          max_layers=1))
    win = (10, 60, 150, 90)
    got = _port(data, window=win)[:, win[1]:win[3], win[0]:win[2]]
    assert np.array_equal(got, _ref(data, window=win))
    # the CPU runs the plain version, which counts no launch
    assert ht_decode.ht_decode_lanes.refine_launches == before


@pytest.mark.parametrize("shape, style", [("128x32", 0), ("16x256", 0x3F),
                                          ("1024x4", 0)])
def test_part1_wide_blocks_equal_the_jax_package(gray3, shape, style):
    data = compress(gray3, _cp(shape, cblk_style=style))
    assert _wide_buckets(data)
    if style:
        with pytest.raises(GeneralRoute):
            api.stage_device_batch([data], device="cpu")
    assert np.array_equal(_port(data), _ref(data))
    if not style:
        assert np.array_equal(_port(data, reduce=1), _ref(data, reduce=1))


def test_ht_mixed_wide_blocks(gray3):
    """HT-mixed with 128 x 32 blocks in 2 layers: the general route (K3
    over the Part-1 blocks, K1 over the HT ones)."""
    data = compress(gray3, _cp("128x32", ht_mixed=True, num_layers=2,
                               rates=[6.0, 2.0]))
    with pytest.raises(GeneralRoute):
        api.stage_device_batch([data], device="cpu")
    assert np.array_equal(_port(data), _ref(data))


def _coc_blocks(img, params, comp: int, xw: int, yh: int) -> bytes:
    """grok_tpu.compress with component `comp` coded in 2^xw x 2^yh
    code-blocks by a main-header COC (the JAX package's encoder writes
    none by itself; its tile coder follows the header)."""
    import grok_tpu.api as japi
    from grok_tpu.codestream.j2k import CodingStyleComp
    build = japi._build_main_header

    def with_coc(image, p):
        hdr = build(image, p)
        cs = hdr.cod.comp
        hdr.coc[comp] = CodingStyleComp(
            num_resolutions=cs.num_resolutions, cblk_w_exp=xw,
            cblk_h_exp=yh, cblk_style=cs.cblk_style,
            irreversible=cs.irreversible, prec_exps=cs.prec_exps)
        return hdr
    japi._build_main_header = with_coc
    try:
        return compress(img, params)
    finally:
        japi._build_main_header = build


@pytest.mark.parametrize("style", [0, 0x3F])
def test_part1_components_of_transposed_block_shapes(style):
    """128 x 32 blocks in one component, 32 x 128 (a COC) in the other:
    no one lane of 4096 samples covers both, so K3 runs once per group of
    bucket shapes, on the served route (style 0) and the general one."""
    a = synthetic_image(H0, W0, 2, seed=44).astype(np.int32) >> 5
    img = Image(components=[Component(a[..., c], prec=3, sgnd=False)
                            for c in range(2)],
                color_space=ColorSpace.UNSPECIFIED)
    data = _coc_blocks(img, _cp("128x32", cblk_style=style), 1, 5, 7)
    assert {(128, 32), (32, 128)} <= set(_wide_buckets(data))
    if style:
        with pytest.raises(GeneralRoute):
            api.stage_device_batch([data], device="cpu")
    else:
        prog = api.stage_device_batch([data], device="cpu").program
        assert len(prog.mq_groups) == 2
    assert np.array_equal(_port(data), _ref(data))


def test_wrappers_take_any_legal_block_shape():
    assert ht_decode.lane_dims_ok(1024, 4) and ht_decode.lane_dims_ok(4, 1024)
    assert not ht_decode.lane_dims_ok(1024, 8)
    assert not ht_decode.lane_dims_ok(2048, 2)
    lanes = t1_decode.segment_table([1], [1], [0], [[2]])
    assert lanes[1].shape[0] == 1


# ---------------------------------------------------------------------------
# The committed wide-code-block vectors
# ---------------------------------------------------------------------------

def make_wide_streams(names=wv.NAMES) -> dict:
    """The committed streams of grok_tpu_torch/util/wide_vectors.py, from
    the JAX package: {name: bytes}."""
    out = {}
    for name in names:
        spec, kw = wv.SPECS[name]
        h, w, ch, seed = spec[:4]
        top = spec[4] if len(spec) > 4 else None     # the rows kept
        img = synthetic_image(h, w, ch, seed=seed)[:top]
        out[name] = compress(np.ascontiguousarray(img), JCP(**kw))
    return out


def make_bad_edits(h: bytes) -> dict:
    """{hbad: zero bytes, hbad_rand: random bytes} written over a byte of
    the cleanup suffixes of BAD_BLOCKS code-blocks of h."""
    from test_torch_strict import corrupt_edits
    return {"hbad": corrupt_edits(h, wv.BAD_SEED, wv.BAD_BLOCKS,
                                  wv.BAD_BYTE),
            "hbad_rand": corrupt_edits(h, wv.BAD_SEED, wv.BAD_BLOCKS)}


def _hash(planes) -> str:
    """The plane hash of a decode (the JAX package's decode of a window
    gives the window's samples)."""
    return stream_vectors.plane_hash(np.asarray(p).astype(np.int32)
                                     for p in planes)


def case_stream(case: str, streams: dict, h: bytes, edits) -> bytes:
    name = wv.CASES[case][0]
    return wv.apply_edits(h, edits[name]) if name in wv.EDITED \
        else streams[name]


def make_wide_hashes(streams: dict, h: bytes, edits) -> dict:
    """{case: plane hash} of grok_tpu.decompress(strict=False) of every
    case (a window case: of the window's samples)."""
    out = {}
    for case, (_name, kw) in wv.CASES.items():
        im = decompress(case_stream(case, streams, h, edits),
                        JDP(strict=False, **kw))
        out[case] = _hash([c.data for c in im.components])
    return out


def strict_outcome(data: bytes, device: bool = True) -> tuple:
    """What grok_tpu.decompress_device(strict=True) gives (with device
    False, grok_tpu.decompress(strict=True)): (exception type name,
    message) or ("planes", plane hash)."""
    import grok_tpu
    try:
        if device:
            return ("planes", _hash(grok_tpu.decompress_device(
                data, JDP(strict=True))))
        return ("planes", _hash([c.data for c in grok_tpu.decompress(
            data, JDP(strict=True)).components]))
    except Exception as e:              # noqa: BLE001: recorded as it is
        return (type(e).__name__, str(e))


def make_strict_outcomes(streams: dict, h: bytes, edits) -> dict:
    """{stream: outcome} of the strict decodes the card repeats: m1, wh,
    hbad and every stream of damaged_vectors.py's CASES."""
    dstreams, _h = dv.all_streams()
    out = {"m1": strict_outcome(dstreams["m1"]),
           "wh": strict_outcome(streams["wh"])}
    for name in wv.EDITED:
        out[name] = strict_outcome(wv.apply_edits(h, edits[name]))
    for case in dv.CASES:
        # one outcome a stream: a layer cap or a window on it is another
        # case of the same stream.  The JAX package's decompress_device
        # does not merge a main-header PPM (ROADMAP §3) and decodes the
        # PPM stream wrong: its decompress is the reference there, as
        # for the permissive hash
        if not (case.endswith("_L1") or case == "roi_win"):
            out[case] = strict_outcome(dv.stream(case, dstreams),
                                       device=case != "ppm")
    return out


def test_wide_vectors_headers():
    """What each committed stream carries, as its spec says, and the
    file's size."""
    from grok_tpu_torch.codestream import j2k as pj2k
    streams, hashes, edits, strict = wv.load()
    for name, (_img, kw) in wv.SPECS.items():
        hdr = pj2k.read_main_header(streams[name])
        cs = hdr.cod.comp
        assert (cs.cblk_w_exp, cs.cblk_h_exp) == (kw["cblk_w_exp"],
                                                  kw["cblk_h_exp"])
        assert hdr.cod.num_layers == kw.get("num_layers", 1)
        assert (cs.cblk_style & 0x3F) == kw.get("cblk_style", 0)
    assert set(hashes) == set(wv.CASES)
    assert all(len(edits[n]) == wv.BAD_BLOCKS for n in wv.EDITED)
    assert (edits["hbad"][:, 1] == wv.BAD_BYTE).all()
    for n in wv.EDITED:
        assert strict[n] == ("ValueError", "HT cleanup: bad VLC code")
    assert strict["m1"][0] == strict["wh"][0] == "planes"
    assert os.path.getsize(wv.PATH) < 1_200_000


def test_wide_vectors_part1_hashes_are_the_jax_packages():
    """The Part-1 cases' hashes rebuilt from the committed streams (the
    JAX package's C tile decoder; its HT decodes of the frame take
    minutes on the CPU: the card holds those against the hashes)."""
    streams, hashes, edits, _s = wv.load()
    for case, (name, kw) in wv.CASES.items():
        if name in ("w1", "w1s"):
            im = decompress(streams[name], JDP(strict=False, **kw))
            assert _hash([c.data for c in im.components]) == hashes[case], \
                case


def test_lossless_slice_codes_every_1024x4_block():
    """whl, the lossless 32-line slice: every lane of its 1024 x 4 bucket
    is coded, and the port's served decode (the plain K1 here) gives the
    committed hash, the JAX package's planes (rebuilt here: the source's
    lossless slice)."""
    streams, hashes, _e, _s = wv.load()
    data = streams["whl"]
    staged = api.stage_device_batch([data], device="cpu")
    prog = staged.program
    bi = next(i for i, b in enumerate(prog.buckets) if (b.W, b.H) == (1024,
                                                                    4))
    assert bool((prog.lane_meta(staged.meta, bi)[:, 5] == 1).all())
    top = synthetic_image(*wv.SPECS["whl"][0][:3],
                          seed=wv.SPECS["whl"][0][3])[:32]
    assert _hash(top.transpose(2, 0, 1)) == hashes["whl"]
    assert _hash(_port(data)) == hashes["whl"]


def test_port_decodes_of_the_broken_ht_streams():
    """hbad (zero bytes over 24 blocks' codewords) and hbad_rand (random
    bytes; some of its blocks decode to magnitudes of 2^31 or more, which
    the port re-decodes in int64) decode to the JAX package's hashes."""
    _s, hashes, edits, _st = wv.load()
    h = dv.all_streams()[0]["h"]
    for name in ("hbad", "hbad_rand"):
        got = _hash(_port(wv.apply_edits(h, edits[name])))
        assert got == hashes[name], name
