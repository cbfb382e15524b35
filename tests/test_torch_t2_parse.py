"""The port's Python Tier-2 packet parse (grok_tpu_torch/t2/parse.py) and
the streams it opens to the device decode: streams cut short, SOP resync
after corrupt packets, PPM and PPT packed headers, through
api.decompress_device[_batch] on the CPU (the plain versions), held
bit-exact to the JAX package's decode, grok_tpu.decompress(strict=False).
Also the Rsiz profile check of the port's encode, and the committed
damaged-stream vectors (grok_tpu_torch/util/damaged_vectors.npz),
rebuilt here with the JAX package.

The reference decode (`ref_decode`) decodes each Part-1 code-block with
the JAX package's own C block decoder, grok_tpu.native.decode_block,
which bounds a block's codeword segments by the block's bytes.  The JAX
package's C tile decoder (native.decode_tile_blocks, the route
grok_tpu.decompress takes for tiles without HT blocks) passes no such
bound: a block that a cut leaves short reads on into the next block's
bytes, and past the end of its buffer for the last one.  On intact
streams the two agree (test_reference_decode_is_the_jax_packages), and
on cut streams the per-block decode equals the JAX package's normative
scalar decoder, backend="scalar"."""

import logging
from contextlib import contextmanager

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from grok_tpu import CompressParams as JCP  # noqa: E402
from grok_tpu import DecompressParams as JDP  # noqa: E402
from grok_tpu import compress, decompress, native  # noqa: E402
from grok_tpu.core.image import Component, Image  # noqa: E402
from grok_tpu.core.params import RsizProfile as JRsiz  # noqa: E402
from grok_tpu.util.oracle import synthetic_image  # noqa: E402
from grok_tpu_torch import api  # noqa: E402
from grok_tpu_torch import native as pnative  # noqa: E402
from grok_tpu_torch.codestream import j2k as pj2k  # noqa: E402
from grok_tpu_torch.core.params import CompressParams as PCP  # noqa: E402
from grok_tpu_torch.core.params import DecompressParams as PDP  # noqa: E402
from grok_tpu_torch.core.params import RsizProfile  # noqa: E402
from grok_tpu_torch.pipeline import plan as pplan  # noqa: E402
from grok_tpu_torch.t2.parse import parse_packets  # noqa: E402
from grok_tpu_torch.util import damaged_vectors as dv  # noqa: E402
from grok_tpu_torch.util import stream_edit, stream_vectors  # noqa: E402

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C toolchain")

CP = dict(num_resolutions=3, cblk_w_exp=4, cblk_h_exp=4)
LAYERED = dict(CP, num_layers=3, rates=[24.0, 8.0, 3.0])
# Part-1: 8x8 blocks of 3-bit samples, whose plain K3 decodes are quick
CP1 = dict(CP, cblk_w_exp=3, cblk_h_exp=3)
LAYERED1 = dict(LAYERED, cblk_w_exp=3, cblk_h_exp=3)


def _per_block_tile_decode(jobs, band_arrays, band_meta):
    """grok_tpu.native.decode_tile_blocks with each block decoded by
    grok_tpu.native.decode_block within its own bytes, then the same
    ROI shift, dequantization and placement as the C tile decoder."""
    for j in jobs:
        mag2, neg = native.decode_block(
            j["data"], j["seg_lens"], j["numpasses"], j["numbps"],
            j["orient"], j["w"], j["h"], j["style"])
        key = (j["comp"], j["res"], j["orient"] if j["res"] > 0 else 0)
        delta, irrev, roi = band_meta[key]
        m = mag2.astype(np.int32)
        if roi > 0:
            m = np.where(m >= (1 << roi), m >> roi, m)
        if irrev:
            v = m.astype(np.float32) * (np.float32(delta) * np.float32(0.5))
        else:
            v = m >> 1
        band_arrays[key][j["by"]:j["by"] + j["h"],
                         j["bx"]:j["bx"] + j["w"]] = np.where(neg, -v, v)


@contextmanager
def _per_block():
    orig = native.decode_tile_blocks
    native.decode_tile_blocks = _per_block_tile_decode
    try:
        yield
    finally:
        native.decode_tile_blocks = orig


def ref_decode(data: bytes, **kw) -> np.ndarray:
    """grok_tpu.decompress(strict=False), each Part-1 block decoded within
    its own bytes (see the module docstring)."""
    with _per_block():
        return decompress(data, JDP(strict=False, **kw)).to_array()


def _np(comps):
    a = [c.numpy() for c in comps]
    return a[0] if len(a) == 1 else np.stack(a, -1)


def port_decode(data: bytes, **kw) -> np.ndarray:
    """api.decompress_device on the CPU; a window's samples only."""
    got = _np(api.decompress_device(data, PDP(**kw), device="cpu"))
    if kw.get("window") is not None:
        x0, y0, x1, y1 = kw["window"]
        got = got[y0:y1, x0:x1]
    return got


def _img(a, prec):
    """An Image of a (h, w) or (h, w, c) array of `prec`-bit samples."""
    a = np.asarray(a, np.int32)
    planes = [a] if a.ndim == 2 else [a[..., c] for c in range(a.shape[2])]
    return Image(components=[Component(data=p, prec=prec) for p in planes])


@pytest.fixture(scope="module")
def gray():
    """A 64x64 3-bit gray frame (few bitplanes: quick plain versions)."""
    return _img(synthetic_image(64, 64, 1, seed=11).astype(np.int32) >> 5,
                3)


@pytest.fixture(scope="module")
def rgb():
    return synthetic_image(64, 72, 3, seed=12)


def _tile_part(data: bytes) -> tuple:
    """(tile-part, its tile header) of a single-tile stream."""
    hdr = pj2k.read_main_header(data)
    part, = pj2k.read_tile_parts(data, hdr)
    th = pj2k.TileHeader()
    pj2k.read_tile_part_header(data, part, hdr, th)
    return part, th


CODERS = {
    "part1": dict(LAYERED1),
    "part1_3f": dict(LAYERED1, cblk_style=0x3F),
    "ht": dict(LAYERED, ht=True),
    "ht_refined": dict(LAYERED, ht=True, ht_planes=2),
}


@pytest.fixture(scope="module")
def layered(gray, rgb):
    """{coder: (stream, body start, packet ends)}: 3 layers, LRCP, the
    Part-1 ones on the gray frame, the HT ones on the RGB frame."""
    out = {}
    for name, kw in CODERS.items():
        img = gray if name.startswith("part1") else rgb
        # the packet lengths from a twin with PLT (the same packets)
        _p, th = _tile_part(compress(img, JCP(write_plt=True, **kw)))
        plain = compress(img, JCP(**kw))
        part, _th = _tile_part(plain)
        assert sum(th.plt) == part.data_end - part.data_start
        out[name] = (plain, part.data_start, np.cumsum(th.plt))
    return out


def _cut_at(stream, start, ends, where: str) -> bytes:
    n = len(ends)
    if where == "inside_a_block":
        # into the codewords of the middle packet of the second layer
        k = n // 3 + n // 6
        lo = ends[k - 1]
        return stream[:start + lo + (ends[k] - lo) * 2 // 3]
    if where == "packet_boundary":
        return stream[:start + ends[n // 2]]
    # the end of the first layer (LRCP: a third of the packets)
    return stream[:start + ends[n // 3 - 1]]


@pytest.mark.parametrize("coder", list(CODERS))
@pytest.mark.parametrize("where", ["inside_a_block", "packet_boundary",
                                   "layer_boundary"])
def test_cut_streams_decode_what_is_present(layered, coder, where, caplog):
    stream, start, ends = layered[coder]
    data = _cut_at(stream, start, ends, where)
    decodes = ((dict(), dict(max_layers=1), dict(reduce=1),
                dict(window=(9, 17, 41, 50)))
               if coder in ("part1", "ht") else (dict(), dict(reduce=1)))
    with caplog.at_level(logging.WARNING, logger="grok_tpu_torch"):
        for kw in decodes:
            assert np.array_equal(port_decode(data, **kw),
                                  ref_decode(data, **kw)), kw
    if where == "inside_a_block":
        assert "truncated/corrupt packet stream" in caplog.text


def test_reference_decode_is_the_jax_packages(layered):
    """The per-block reference equals grok_tpu.decompress on intact
    streams, and the JAX package's scalar decoder on a cut one."""
    stream, start, ends = layered["part1_3f"]
    assert np.array_equal(ref_decode(stream), decompress(
        stream, JDP(strict=False)).to_array())
    cut = _cut_at(stream, start, ends, "inside_a_block")
    assert np.array_equal(ref_decode(cut), decompress(
        cut, JDP(strict=False, backend="scalar")).to_array())


def test_cut_ht_blocks_decode_as_zero_lanes(layered):
    """An HT block whose cleanup segment was cut is a zero lane (valid =
    0) of the device decode, as the JAX package decodes it."""
    from grok_tpu_torch.pipeline.tile import stage_general
    stream, start, ends = layered["ht"]
    data = _cut_at(stream, start, ends, "inside_a_block")
    cs, hdr, by_tile, tile_body = api._tiles(data, api._params(None))
    staged = stage_general(cs, hdr, 0, *tile_body(0), api._params(None),
                           device="cpu")
    assert staged.zero_lanes.size
    assert np.array_equal(_np(staged.run()), ref_decode(data))


def _ref_blocks(data: bytes) -> list:
    """The JAX package's HT blocks after its Tier-2 parse, as its decode
    hands them to its scalar HT decoder: (data, seg_lens, numpasses,
    numbps) each, in its block order."""
    import grok_tpu.t1ht as jt1ht
    seen, orig = [], jt1ht.ht_decode_block

    def spy(d, seg_lens, numpasses, numbps, *a, **k):
        seen.append((bytes(d), list(seg_lens), numpasses, numbps))
        return orig(d, seg_lens, numpasses, numbps, *a, **k)
    jt1ht.ht_decode_block = spy
    try:
        ref_decode(data)
    finally:
        jt1ht.ht_decode_block = orig
    return seen


def _port_blocks(data: bytes) -> list:
    """The same from the port's Python parse of a single-tile stream."""
    from grok_tpu_torch.t2.packet import BlockDecState, Chunk
    part, th = _tile_part(data)
    hdr = pj2k.read_main_header(data)
    body = data[part.data_start:part.data_end]
    plan = pplan._plan_for(data, hdr, 0, th, 0)
    incl, zb, _np_, chunks, _end = parse_packets(body, plan)
    states = {}
    for b, lay, segno, npk, off, ln in chunks.tolist():
        states.setdefault(b, BlockDecState(zb=int(zb[b]))).chunks.append(
            Chunk(layer=lay, segno=segno, numpasses=npk, offset=off,
                  length=ln))
    out = []
    for b in sorted(states):
        d, seg_lens, n = states[b].assemble(body)
        if incl[b] and n > 0:
            out.append((d, seg_lens, n, int(plan.mb[b]) - states[b].zb))
    return out


def test_sop_resync_after_corrupt_packets(gray, rgb, caplog):
    """The first 4 bytes of a mid-stream packet inverted (its SOP
    marker): the parse resyncs on the next SOP marker where the JAX
    package does, and the decode gives its planes.  For the HT stream
    the packets parsed after the corrupt one hand a block an invalid VLC
    codeword, which the JAX package's scalar decoder answers with a zero
    block: K1 flags the lane and zeroes it (ERR_VLC), and the parse is
    held block by block too."""
    part1 = dv.flip_mid_packet(compress(gray, JCP(sop=True, eph=True,
                                                 **LAYERED1)))
    ht = dv.flip_mid_packet(compress(rgb, JCP(sop=True, eph=True,
                                              **dict(LAYERED, ht=True))))
    for data in (part1, ht):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="grok_tpu_torch"):
            got = port_decode(data)
        assert "resync at SOP" in caplog.text
    assert np.array_equal(got.shape, ref_decode(ht).shape)
    assert np.array_equal(port_decode(part1), ref_decode(part1))
    assert _port_blocks(ht) == _ref_blocks(ht)
    assert np.array_equal(port_decode(ht), ref_decode(ht))


@pytest.mark.parametrize("tiles", [False, True])
def test_ppm_and_ppt_decode(gray, rgb, tiles):
    """Packed packet headers in the main header (PPM) and, moved, in the
    tile-part headers (PPT), held against grok_tpu.decompress (the JAX
    package's device decode is wrong on PPM streams)."""
    tw = dict(tile_w=32, tile_h=32) if tiles else {}
    cases = ((gray, LAYERED1), (rgb, dict(LAYERED, ht=True)))
    for img, kw in cases[:1] if tiles else cases:
        ppm = compress(img, JCP(write_ppm=True, **kw, **tw))
        ppt = stream_edit.ppm_to_ppt(ppm)
        assert pj2k.read_main_header(ppt).ppm is None
        want = ref_decode(ppm)
        assert np.array_equal(port_decode(ppm), want)
        assert np.array_equal(port_decode(ppt), want)
        if not tiles:
            assert np.array_equal(port_decode(ppm, max_layers=2),
                                  ref_decode(ppm, max_layers=2))


def test_parse_packets_equals_the_c_parse(gray, rgb, layered):
    """On intact streams (these and every intact stream of the cut
    cases) the Python parse returns what the C parse returns, array for
    array."""
    from grok_tpu.core.params import Poc, ProgOrder
    pocs = [Poc(rs=0, cs=0, layer_end=2, re=2, ce=3,
                order=ProgOrder.RLCP),
            Poc(rs=2, cs=0, layer_end=2, re=3, ce=3, order=ProgOrder.CPRL)]
    streams = [
        compress(gray, JCP(**LAYERED1)),
        compress(gray, JCP(sop=True, eph=True, cblk_style=0x3F,
                           prog_order=2, **LAYERED1)),
        compress(rgb, JCP(ht=True, ht_planes=2, prec_w_exps=[4, 4, 5],
                          prec_h_exps=[4, 4, 5], **LAYERED)),
        compress(rgb, JCP(num_layers=2, rates=[8.0, 3.0], pocs=pocs,
                          **CP)),
        compress(rgb, JCP(ht_mixed=True, **CP)),
    ] + [stream for stream, _start, _ends in layered.values()]
    for data in streams:
        hdr = pj2k.read_main_header(data)
        part, th = _tile_part(data)
        body = data[part.data_start:part.data_end]
        plan = pplan._plan_for(data, hdr, 0, th, 0)
        want = pnative.t2_parse_prepared(body, plan.prep, plan.sop, plan.eph)
        got = parse_packets(body, plan, strict=True)
        assert len(got) == len(want) == 5
        for a, b in zip(got[:4], want[:4]):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        assert got[4] == want[4] == len(body)


def test_batches_mix_intact_cut_and_packed_streams(gray):
    intact = compress(gray, JCP(**LAYERED1))
    cut = stream_edit.cut(intact, 0.6)
    ppm = compress(gray, JCP(write_ppm=True, **LAYERED1))
    batch = [intact, cut, ppm, intact]
    got = api.decompress_device_batch(batch, device="cpu")
    for data, comps in zip(batch, got):
        assert np.array_equal(_np(comps), ref_decode(data))
    # every stream of a batch intact: the served batch, one call
    same = api.decompress_device_batch([intact, intact], device="cpu")
    assert all(np.array_equal(_np(c), ref_decode(intact)) for c in same)


@pytest.mark.parametrize("rsiz", ["CINEMA_2K", "CINEMA_4K", "BROADCAST",
                                  "IMF"])
def test_rsiz_profile_violations_raise_the_jax_packages_error(rsiz):
    """A 64x48 gray 5/3 frame under a profile it breaks: the reference's
    ValueError text, before any route of the encode."""
    img = synthetic_image(48, 64, 1, seed=3)
    with pytest.raises(ValueError) as want:
        compress(img, JCP(rsiz=getattr(JRsiz, rsiz)))
    assert str(want.value).startswith("profile violations: ")
    for batch in (False, True):
        with pytest.raises(ValueError) as got:
            p = PCP(rsiz=getattr(RsizProfile, rsiz))
            if batch:
                api.compress_device_batch([img, img], p, device="cpu")
            else:
                api.compress_device(img, p, device="cpu")
        assert str(got.value) == str(want.value)
    # without a profile, the reference's bytes as before
    assert api.compress_device(img, PCP(ht=True), device="cpu") == \
        compress(img, JCP(ht=True))


def test_strict_decodes_still_raise(layered):
    """A strict decode of a cut stream raises what the JAX package's
    strict device decode raises, its type and message."""
    import grok_tpu
    stream, start, ends = layered["part1"]
    data = _cut_at(stream, start, ends, "inside_a_block")
    with pytest.raises(Exception) as want:
        grok_tpu.decompress_device(data, JDP(strict=True))
    with pytest.raises(type(want.value)) as got:
        api.decompress_device(data, PDP(strict=True), device="cpu")
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# The committed damaged-stream vectors
# ---------------------------------------------------------------------------

def _coc_compress(img, params, comp: int, numres: int) -> bytes:
    """grok_tpu.compress with component `comp` coded in `numres`
    resolutions: a main-header COC and its QCC (the JAX package's
    encoder writes none by itself; its tile coder follows the header)."""
    import grok_tpu.api as japi
    from grok_tpu.codestream.j2k import CodingStyleComp, QuantStyle
    from grok_tpu.core.quant import make_quantizer
    build = japi._build_main_header

    def with_coc(image, p):
        hdr = build(image, p)
        cs = hdr.cod.comp
        hdr.coc[comp] = CodingStyleComp(
            num_resolutions=numres, cblk_w_exp=cs.cblk_w_exp,
            cblk_h_exp=cs.cblk_h_exp, cblk_style=cs.cblk_style,
            irreversible=cs.irreversible, prec_exps=cs.prec_exps)
        q = make_quantizer(numres, image.components[comp].prec,
                           p.irreversible, p.num_guard_bits, p.quant_step,
                           derived=not p.quant_style_expounded
                           and p.irreversible)
        hdr.qcc[comp] = QuantStyle(style=q.style, guard_bits=q.guard_bits,
                                   steps=q.steps if q.style != 1
                                   else q.steps[:1])
        return hdr
    japi._build_main_header = with_coc
    try:
        return compress(img, params)
    finally:
        japi._build_main_header = build


def make_damaged_streams(names=dv.NAMES) -> dict:
    """The committed streams of grok_tpu_torch/util/damaged_vectors.py,
    from the JAX package: {name: bytes}."""
    from grok_tpu.core.params import Poc, ProgOrder
    out = {}
    for name in names:
        (h, w, ch, seed), kw, coc = dv.SPECS[name]
        img = synthetic_image(h, w, ch, seed=seed)
        kw = dict(kw)
        if "pocs" in kw:
            kw["pocs"] = [Poc(*r[:5], order=ProgOrder(r[5]))
                          for r in kw["pocs"]]
        if coc is None:
            out[name] = compress(img, JCP(**kw))
        else:
            out[name] = stream_edit.move_to_tile_parts(
                _coc_compress(img, JCP(**kw), *coc),
                (pj2k.COC, pj2k.QCC, pj2k.POC))
    return out


def make_damaged_hashes(streams: dict) -> dict:
    """{case: plane hash} of the reference decode of every case, from
    {name: bytes} of all committed streams."""
    out = {}
    for case, (_name, _edit, kw) in dv.CASES.items():
        a = ref_decode(dv.stream(case, streams), **kw)
        planes = [a] if a.ndim == 2 else [a[..., c]
                                          for c in range(a.shape[-1])]
        out[case] = stream_vectors.plane_hash(p.astype(np.int32)
                                              for p in planes)
    return out


def test_damaged_vectors_are_the_jax_packages():
    """The committed Part-1 streams rebuilt byte for byte, and every
    case's plane hash rebuilt from the committed streams (the HT streams'
    JAX encodes take minutes on the CPU: their decodes are held here, and
    their headers below)."""
    streams, hashes = dv.all_streams()
    rebuilt = make_damaged_streams(("ppm", "sop"))
    for name, data in rebuilt.items():
        assert streams[name] == data, name
    assert make_damaged_hashes(streams) == hashes
    assert sum(len(streams[n]) for n in dv.NAMES) < 1_200_000


def test_damaged_vectors_headers():
    """What each committed stream carries, as its spec says."""
    streams, _h = dv.load()
    h = pj2k.read_main_header(streams["h"])
    assert h.cod.comp.cblk_style == 0x40 and h.cod.num_layers == 2
    assert pj2k.read_main_header(streams["ppm"]).ppm is not None
    sop = pj2k.read_main_header(streams["sop"])
    assert sop.cod.sop and sop.cod.eph
    roi = streams["roi"]
    hdr = pj2k.read_main_header(roi)
    assert hdr.rgn == {0: 4} and not hdr.coc and not hdr.qcc \
        and not hdr.pocs and hdr.siz.num_tiles == 2 * 2
    for p in pj2k.read_tile_parts(roi, hdr):
        th = pj2k.TileHeader()
        pj2k.read_tile_part_header(roi, p, hdr, th)
        # component 0's steps (the ROI's) are the QCD's
        assert th.coc[2].num_resolutions == 5 and set(th.qcc) == {1, 2}
        assert len(th.pocs) == 2
