"""The general encode of the PyTorch port (grok_tpu_torch.api
compress_device[_batch] on the CPU, the plain versions of K4, K4r and K5)
held byte for byte against the JAX package's host encoder
grok_tpu.compress, and decoded back by the port:

  - the stream layouts: non-default precincts (code-blocks the precincts
    clip), progression-order changes (POC), two and three tile-parts a
    tile with TLM and PLT, PLM, PPM (packed headers in the main header),
    quality targets (fixed_quality), on HT, refined HT and Part-1
    streams, single-tile, tiled and batched;
  - code-blocks over 64 on a side (128 x 4, 16 x 256, 256 x 16) through
    the encode's lanes of any legal shape, HT, refined HT and Part-1.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_general_enc.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from grok_tpu import CompressParams as JCP  # noqa: E402
from grok_tpu import compress, native  # noqa: E402
from grok_tpu.core.params import Poc as JPoc  # noqa: E402
from grok_tpu.core.params import ProgOrder as JPO  # noqa: E402
from grok_tpu.util.oracle import synthetic_image  # noqa: E402
from grok_tpu_torch import api  # noqa: E402
from grok_tpu_torch.codestream import j2k as pj2k  # noqa: E402
from grok_tpu_torch.core.params import CompressParams as PCP  # noqa: E402
from grok_tpu_torch.core.params import Poc, ProgOrder  # noqa: E402

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C toolchain")


def _pocs(P, O, layers: int = 1):
    """Two progression-order changes: resolutions 0-1 in RLCP, then the
    rest in CPRL."""
    return [P(rs=0, cs=0, layer_end=layers, re=2, ce=3, order=O.RLCP),
            P(rs=0, cs=0, layer_end=layers, re=3, ce=3, order=O.CPRL)]


HT = dict(ht=True, num_resolutions=3)
# Part-1 cases on 16 x 16 code-blocks of a small gray frame: the plain
# K5 and K3 (its trial decodes) step every pass of every lane in turn
P1 = dict(num_resolutions=3, cblk_w_exp=4, cblk_h_exp=4)
PREC = dict(prec_w_exps=[4, 4, 5], prec_h_exps=[4, 4, 5])

# name: (frame, CompressParams keywords; "poc": the number of layers of
# _pocs' POC)
CASES = {
    "precincts_ht": ("rgb", dict(HT, **PREC)),
    "precincts_part1": ("gray", dict(P1, prec_w_exps=[3, 3, 4],
                                     prec_h_exps=[3, 3, 4])),
    "poc_ht": ("rgb", dict(HT, poc=1)),
    "poc_part1_layers": ("gray", dict(P1, num_layers=2, rates=[12.0, 1.0],
                                      poc=2)),
    "tile_parts_2_ht": ("rgb", dict(HT, max_tile_parts=2, write_tlm=True,
                                    write_plt=True, prog_order=4)),
    "tile_parts_3_plm_part1": ("gray", dict(P1, max_tile_parts=3,
                                            write_plm=True, write_tlm=True,
                                            prog_order=2)),
    "ppm_part1": ("gray", dict(P1, write_ppm=True, **PREC)),
    "ppm_refined_ht_layers": ("rgb", dict(HT, ht_planes=1, num_layers=2,
                                          rates=[10.0, 1.0],
                                          write_ppm=True)),
    "quality_part1": ("gray", dict(P1, num_layers=3, fixed_quality=True,
                                   quality=[30.0, 40.0, 0.0])),
    "quality_refined_ht": ("rgb", dict(HT, ht_planes=2, num_layers=2,
                                       fixed_quality=True,
                                       quality=[35.0, 0.0])),
    "tiled_precincts_poc_tile_parts_plm": ("rgb", dict(
        ht=True, num_resolutions=2, tile_w=32, tile_h=32, max_tile_parts=2,
        write_plm=True, write_tlm=True, prec_w_exps=[4, 4],
        prec_h_exps=[4, 4], poc=1)),
}


@pytest.fixture(scope="module")
def frames():
    # the gray frame's samples below 16 (8-bit, 4 magnitude planes at
    # most): the Part-1 cases' plain K5 and K3 step every pass in turn
    return {"rgb": synthetic_image(48, 64, 3, seed=5),
            "gray": synthetic_image(32, 48, 1, seed=6) >> 4}


def params(kw: dict) -> tuple:
    """(the JAX package's CompressParams, the port's) for kw."""
    kw = dict(kw)
    layers = kw.pop("poc", 0)
    jkw, pkw = dict(kw), dict(kw)
    if layers:
        jkw["pocs"] = _pocs(JPoc, JPO, layers)
        pkw["pocs"] = _pocs(Poc, ProgOrder, layers)
    return JCP(**jkw), PCP(**pkw)


def _planes(img) -> list:
    return [img[..., c] for c in range(img.shape[2])] if img.ndim == 3 \
        else [img]


@pytest.mark.parametrize("case", list(CASES))
def test_layouts_byte_identical_and_decode_back(frames, case):
    which, kw = CASES[case]
    img = frames[which]
    jp, pp = params(kw)
    got = api.compress_device(img, pp, device="cpu")
    assert got == compress(img, jp)
    dec = api.decompress_device(got, device="cpu")
    lossless = not kw.get("ht_planes")      # ht_planes is not lossless
    for a, b in zip(dec, _planes(img)):
        a = np.asarray(a)
        assert a.shape == b.shape
        if lossless:
            assert np.array_equal(a, b)


def test_layout_markers_as_asked(frames):
    """What the streams carry: the precinct sizes, the POC, the tile-parts
    with their TLM entries, PLM lists that match the PLTs' and the PPM
    blobs, read back by the port's own parse."""
    img = frames["rgb"]
    got = api.compress_device(img, params(CASES[
        "tiled_precincts_poc_tile_parts_plm"][1])[1], device="cpu")
    hdr = pj2k.read_main_header(got)
    parts = pj2k.read_tile_parts(got, hdr)
    assert hdr.cod.comp.prec_exps == [(4, 4), (4, 4)]
    assert len(hdr.pocs) == 2
    assert len(parts) == 2 * hdr.siz.num_tiles
    assert {p.part_index for p in parts} == {0, 1}
    assert len(hdr.tlm) == len(parts) and len(hdr.plm) == len(parts)
    ppm = api.compress_device(img, params(CASES["ppm_refined_ht_layers"][1])
                              [1], device="cpu")
    assert pj2k.read_main_header(ppm).ppm is not None


def test_batch_and_tiles_byte_identical(frames):
    """Two frames in one batch, tiled, with every layout option at once:
    each stream equal to grok_tpu.compress of its frame."""
    imgs = [frames["rgb"], synthetic_image(48, 64, 3, seed=9)]
    kw = dict(ht=True, num_resolutions=2, tile_w=32, tile_h=24,
              max_tile_parts=3, write_plm=True, write_tlm=True,
              write_ppm=True, prec_w_exps=[3, 4], prec_h_exps=[3, 4], poc=1)
    jp, pp = params(kw)
    assert api.compress_device_batch(imgs, pp, device="cpu") == \
        [compress(im, jp) for im in imgs]


def test_general_encode_without_a_card_raises(frames):
    """No fallback: a general encode asked of the card raises without one
    (and encodes there with one)."""
    jp, pp = params(CASES["poc_ht"][1])
    if torch.cuda.is_available():
        assert api.compress_device(frames["rgb"], pp) == \
            compress(frames["rgb"], jp)
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        api.compress_device(frames["rgb"], pp)


# ---------------------------------------------------------------------------
# Code-blocks over 64 on a side
# ---------------------------------------------------------------------------

def _gray(h: int, w: int, bits: int):
    """A synthetic gray frame of `bits` bits (few planes: the plain K5
    and K3 step every pass of a lane in turn), as the JAX package's
    Image and as the array."""
    from grok_tpu.core.image import ColorSpace, Component, Image
    g = synthetic_image(h, w, 1, seed=3).astype(np.int32) >> (8 - bits)
    return Image(components=[Component(g, prec=bits, sgnd=False)],
                 color_space=ColorSpace.GRAY), g


# (frame h, w, bits, CompressParams keywords): 128 x 4 blocks over two
# resolutions; 16 x 256 and 256 x 16 blocks in one resolution (the frame
# one block); HT, refined HT in two layers, Part-1
WIDE = {
    "128x4_ht": (40, 256, 4, dict(ht=True, num_resolutions=2, cblk_w_exp=7,
                                  cblk_h_exp=2)),
    "128x4_refined_ht": (40, 256, 4, dict(ht=True, ht_planes=1,
                                          num_layers=2, rates=[6.0, 1.0],
                                          num_resolutions=2, cblk_w_exp=7,
                                          cblk_h_exp=2)),
    "128x4_part1": (40, 256, 2, dict(num_resolutions=2, cblk_w_exp=7,
                                     cblk_h_exp=2)),
    "16x256_ht": (256, 48, 4, dict(ht=True, num_resolutions=1, cblk_w_exp=4,
                                   cblk_h_exp=8)),
    "16x256_part1": (256, 16, 2, dict(num_resolutions=1, cblk_w_exp=4,
                                      cblk_h_exp=8)),
    "256x16_refined_ht": (16, 256, 4, dict(ht=True, ht_planes=1,
                                           num_layers=2, rates=[6.0, 1.0],
                                           num_resolutions=1, cblk_w_exp=8,
                                           cblk_h_exp=4)),
    "256x16_part1": (16, 256, 2, dict(num_resolutions=1, cblk_w_exp=8,
                                      cblk_h_exp=4)),
}


@pytest.mark.parametrize("case", list(WIDE))
def test_wide_code_blocks_byte_identical_and_decode_back(case):
    h, w, bits, kw = WIDE[case]
    jimg, g = _gray(h, w, bits)
    got = api.compress_device(g, PCP(**kw), prec=bits, device="cpu")
    assert got == compress(jimg, JCP(**kw))
    if not kw.get("ht_planes") and (kw.get("ht") or h * w < 4096):
        # (a Part-1 frame of one 4096-sample block: the plain K3 steps
        # every pass of it; the encode is the point here)
        assert np.array_equal(np.asarray(api.decompress_device(
            got, device="cpu")[0]), g)


def test_wide_lanes_bucket_to_their_nominal_size_with_capacities_no_larger():
    """The encode plan buckets wide lanes to the blocks' nominal
    power-of-two size, and a wide lane's stream capacities are those of a
    64 x 64 lane (it holds no more samples)."""
    from grok_tpu_torch.pipeline import serve_enc

    def plan(h, w, cw, ch):
        hdr = api._build_main_header(h, w, 1, 8, False, PCP(
            ht=True, num_resolutions=2, cblk_w_exp=cw, cblk_h_exp=ch))
        return serve_enc._build_plan(hdr, 0)
    wide, square = plan(40, 240, 10, 2), plan(128, 128, 6, 6)
    assert (wide.W, wide.H) == (128, 4)        # 120 x 4 blocks: 128 x 4
    assert max(bw for *_b, _bh, bw in wide.blocks) == 120
    assert (square.W, square.H) == (64, 64)
    assert all(a <= b for a, b in zip(wide.caps, square.caps))
    assert wide.mq_caps[0] <= square.mq_caps[0]


@pytest.mark.parametrize("W, H", [(128, 4), (16, 256), (256, 16)])
def test_wide_plain_encoders_equal_the_scalar_coders(W, H):
    """The plain K4 on wide lanes (one full, one clipped) against
    grok_tpu.t1ht.ht_encode_block at cleanup planes 0 and 1, and on 128 x
    4 lanes the plain K5 against the Part-1 grok_tpu.t1.t1_scalar
    encode_block (two planes)."""
    from grok_tpu.t1.t1_scalar import encode_block
    from grok_tpu_torch.ops import ht_encode as E
    from grok_tpu_torch.ops import t1_encode as T
    from test_torch_ht_encode import _scalar_clean
    rng = np.random.default_rng(W * H + W)
    blocks = []
    for w, h in ((W, H), (W - 5, max(H - 3, 1))):
        mag = rng.integers(0, 4, (h, w)).astype(np.int64)
        mag[rng.random((h, w)) < 0.3] = 0
        blocks.append((mag, rng.random((h, w)) < 0.5))
    mneg = np.zeros((2, H, W), np.int32)
    for j, (m, n) in enumerate(blocks):
        mneg[j, :m.shape[0], :m.shape[1]] = (m << 1) | (n & (m > 0))

    def col(v):
        return torch.tensor(list(v), dtype=torch.int32)
    ws, hs = col(m.shape[1] for m, _ in blocks), col(m.shape[0]
                                                      for m, _ in blocks)
    nq = ((W + 1) // 2) * ((H + 1) // 2)
    caps = (E._cap_bytes(W * H * 4), E._cap_bytes(nq * 9 // 8 + 16),
            E._cap_bytes(nq * 15 // 8 + 16))
    for p in (0, 1):
        streams, bits = E.ht_encode_lanes_ref(
            torch.from_numpy(mneg), col([p, p]), ws, hs, col([1, 1]), *caps)
        starts = np.cumsum((0,) + caps)
        for j, (m, n) in enumerate(blocks):
            for k, (b, nbits) in enumerate(_scalar_clean(m, n, 1, p)):
                assert int(bits[k, j]) == nbits, (p, j, k)
                nbytes = (nbits + 7) // 8
                assert streams[j, starts[k]:starts[k] + nbytes].numpy() \
                    .tobytes() == bytes(b[:nbytes]), (p, j, k)
    if W * H == 4096:
        # the whole-frame cases above hold the plain K5 at these shapes
        return
    nb = col(int(m.max()).bit_length() for m, _ in blocks)
    out, lens, _rates, _st = T.t1_encode_lanes_ref(
        torch.from_numpy(mneg), col([1, 1]), nb, ws, hs, W * H + 64, 4)
    for j, (m, n) in enumerate(blocks):
        assert out[j, 1:1 + int(lens[j])].numpy().tobytes() == \
            encode_block(m, n & (m > 0), 1, 0).data


# ---------------------------------------------------------------------------
# The committed general-encode streams
# ---------------------------------------------------------------------------

def make_enc_streams(names=None) -> dict:
    """The committed streams of grok_tpu_torch/util/enc_vectors.py, from
    the JAX package (the mode-switch and HT-mixed encodes by
    grok_tpu.compress_device, the layouts and roi by grok_tpu.compress,
    which writes the same bytes on the reversible path: on the CPU the
    JAX package's default-style device coder, which compress_device
    takes for roi's blocks, fails on the frame's bottom-edge blocks of
    fewer than 6 rows): {name: bytes}."""
    import grok_tpu

    from grok_tpu_torch.util import enc_vectors as ev
    h, w, ch, seed = ev.FRAME
    img = synthetic_image(h, w, ch, seed=seed)
    return {n: (grok_tpu.compress_device if n in ev.DEVICE_MADE
                else compress)(img, JCP(**ev.params(n, JPoc, JPO)))
            for n in (names or ev.NAMES + ev.MODE_NAMES)}


def test_enc_vectors_carry_their_specs():
    """What each committed stream carries, as its spec says, and the
    file's size."""
    import os

    from grok_tpu_torch.util import enc_vectors as ev
    streams = ev.load()
    assert set(streams) == set(ev.NAMES)
    for name, s in streams.items():
        kw = ev.SPECS[name]
        hdr = pj2k.read_main_header(s)
        parts = pj2k.read_tile_parts(s, hdr)
        assert (hdr.siz.xsiz, hdr.siz.ysiz) == ev.FRAME[1::-1]
        assert hdr.cod.num_layers == kw.get("num_layers", 1)
        assert bool(hdr.cod.comp.cblk_style & 0x40) == bool(kw.get("ht"))
        assert hdr.cod.comp.prec_exps == (
            list(zip(kw["prec_w_exps"], kw["prec_h_exps"]))
            if "prec_w_exps" in kw else None)
        assert len(hdr.pocs) == len(kw.get("pocs", ()))
        assert len(parts) == kw.get("max_tile_parts", 1)
        assert bool(hdr.tlm) == kw.get("write_tlm", False)
        assert bool(hdr.plm) == kw.get("write_plm", False)
        assert (hdr.ppm is not None) == kw.get("write_ppm", False)
    assert os.path.getsize(ev.PATH) < 1_500_000


def test_mode_vectors_carry_their_specs():
    """The committed mode-switch, HT-mixed and ROI streams of the (B)
    frame: the whole ones carry their specs, the hashed ones a 32-byte
    digest; and the ROI's shift is the smallest the JAX package does not
    warn about on this frame (the background's magnitude bits in the
    ROI's band windows, computed by the port's staging)."""
    from grok_tpu_torch.core.geometry import Rect
    from grok_tpu_torch.pipeline import serve_enc
    from grok_tpu_torch.pipeline.tile import band_window
    from grok_tpu_torch.util import enc_vectors as ev
    modes = ev.load_modes()
    assert set(modes) == set(ev.MODE_NAMES)
    for name, (data, digest) in modes.items():
        kw = ev.SPECS[name]
        assert len(bytes.fromhex(digest)) == 32
        assert (data is None) == (name in ev.HASHED)
        if data is None:
            continue
        hdr = pj2k.read_main_header(data)
        assert (hdr.siz.xsiz, hdr.siz.ysiz) == ev.FRAME[1::-1]
        assert hdr.cod.num_layers == kw.get("num_layers", 1)
        assert hdr.cod.comp.cblk_style == kw.get("cblk_style", 0) | (
            0x40 if kw.get("ht_mixed") else 0)
        assert ev.matches(name, data, modes)
        assert not ev.matches(name, data[:-1], modes)
    h, w, ch, seed = ev.FRAME
    img = synthetic_image(h, w, ch, seed=seed)
    kw = dict(ev.SPECS["roi"], roi_shift=1)
    hdr = api._build_main_header(h, w, ch, 8, False, PCP(**kw))
    plan = serve_enc._build_plan(hdr, 0)
    plan.geo.rgn = {}                       # the bands before the shift
    bands = serve_enc._stage_bands(
        [torch.from_numpy(np.ascontiguousarray(img[..., c]))[None]
         for c in range(ch)], plan)
    sub = Rect(*kw["roi_rect"]).intersect(plan.geo.rect)
    top = 0
    for r, orient, _d in plan.comps_sig[0][5]:
        brect = plan.band_rects[(0, r, orient)]
        bw = band_window(sub, plan.comps_sig[0][1] - 1, r, orient) \
            .intersect(brect)
        if not bw.empty:
            top = max(top, int((bands[(0, r, orient)] >> 1).max()))
    assert top.bit_length() == ev.ROI_SHIFT
