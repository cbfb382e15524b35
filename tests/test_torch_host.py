"""The port's own host layers (grok_tpu_torch/codestream, core, t1, t2,
t1ht, pipeline/plan.py, pipeline/tile.py, native/) held against the JAX
package's originals on the same inputs, and the port's independence of
the JAX package, checked on its sources."""

import ast
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grok_tpu import CompressParams, compress, native  # noqa: E402
from grok_tpu.codestream import j2k as jj2k  # noqa: E402
from grok_tpu.codestream import jp2 as jjp2  # noqa: E402
from grok_tpu.core.quant import make_quantizer as jmake_quantizer  # noqa: E402
from grok_tpu.pipeline import serve as jserve  # noqa: E402
from grok_tpu.pipeline import tile as jtile  # noqa: E402
from grok_tpu.ops import pallas_t1 as jpt1  # noqa: E402
from grok_tpu.t1 import luts as jluts  # noqa: E402
from grok_tpu.t1 import mq as jmq  # noqa: E402
from grok_tpu.t1 import t1_scalar as jscalar  # noqa: E402
from grok_tpu.t1ht import tables as T  # noqa: E402
from grok_tpu.t1ht.mel import MELDecoder  # noqa: E402
from grok_tpu.t1ht.scalar import (_FwdReader, _VLCReader,  # noqa: E402
                                  ht_encode_block)
from grok_tpu.util.oracle import synthetic_image as jsynth  # noqa: E402
from grok_tpu_torch import native as pnative  # noqa: E402
from grok_tpu_torch.codestream import j2k as pj2k  # noqa: E402
from grok_tpu_torch.codestream import jp2 as pjp2  # noqa: E402
from grok_tpu_torch.core.quant import make_quantizer as pmake_quantizer  # noqa: E402,E501
from grok_tpu_torch.core.params import CBLK_HT  # noqa: E402
from grok_tpu_torch.ops import t1_decode as pt1d  # noqa: E402
from grok_tpu_torch.pipeline import plan as pplan  # noqa: E402
from grok_tpu_torch.pipeline import tile as ptile  # noqa: E402
from grok_tpu_torch.t1 import luts as pluts  # noqa: E402
from grok_tpu_torch.t1 import mq as pmq  # noqa: E402
from grok_tpu_torch.t1 import records as precords  # noqa: E402
from grok_tpu_torch.t1.records import EncodedBlock, PassInfo  # noqa: E402
from grok_tpu_torch.t1ht import tables as PT  # noqa: E402
from grok_tpu_torch.util.synth import synthetic_image as psynth  # noqa: E402
from test_ht_tables_dropin import _synthetic_normative_tables  # noqa: E402

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C toolchain")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (image shape, compress parameters): HT and Part-1, framing markers,
# precincts, POC, several layers, tiles and tile-parts, JP2
CONFIGS = [
    ((48, 40, 1), dict(ht=True, num_resolutions=3, cblk_w_exp=4,
                       cblk_h_exp=4)),
    ((40, 56, 3), dict(ht=True, num_resolutions=2, write_plt=True,
                       write_tlm=True, sop=True, eph=True, comment="c",
                       prog_order=2)),
    ((40, 40, 3), dict(irreversible=True, num_resolutions=3, num_layers=2,
                       rates=[8.0, 2.0], prec_w_exps=[4, 5, 5],
                       prec_h_exps=[4, 5, 5], jp2=True)),
    ((64, 48, 1), dict(tile_w=32, tile_h=32, max_tile_parts=2,
                       write_plm=True, num_resolutions=2)),
]


@pytest.fixture(scope="module")
def streams():
    out = []
    for i, ((h, w, c), kw) in enumerate(CONFIGS):
        img = jsynth(h, w, c, seed=40 + i)
        out.append(compress(img, CompressParams(**kw)))
    return out


def _fields(obj):
    return dataclasses.astuple(obj)


def _parse(j2k, cs):
    hdr = j2k.read_main_header(cs)
    parts = j2k.read_tile_parts(cs, hdr, strict=True)
    ths = {}
    for p in parts:
        ths.setdefault(p.tile_index, j2k.TileHeader())
        j2k.read_tile_part_header(cs, p, hdr, ths[p.tile_index])
    return hdr, parts, ths


def test_headers_parse_to_equal_fields(streams):
    for data in streams:
        jcs = data
        if jjp2.is_jp2(data):
            s, e, _meta = jjp2.parse_jp2(data)
            jcs = data[s:e]
        pcs = pjp2.locate_codestream(data)
        assert bytes(pcs) == bytes(jcs)
        jh, jparts, jths = _parse(jj2k, jcs)
        ph, pparts, pths = _parse(pj2k, pcs)
        assert _fields(ph) == _fields(jh)
        assert [_fields(p) for p in pparts] == [_fields(p) for p in jparts]
        assert {t: _fields(th) for t, th in pths.items()} == \
            {t: _fields(th) for t, th in jths.items()}


def test_header_writers_and_jp2_wrap_emit_equal_bytes(streams):
    jh = jj2k.read_main_header(streams[1])
    ph = pj2k.read_main_header(streams[1])
    for name, args in (("write_siz", lambda h: (h.siz, h.rsiz, h.comps)),
                       ("write_cod", lambda h: (h.cod,)),
                       ("write_qcd", lambda h: (h.qcd,)),
                       ("write_cap", lambda h: h.cap)):
        assert getattr(pj2k, name)(*args(ph)) == \
            getattr(jj2k, name)(*args(jh)), name
    for name, args in (("write_sot", (0, 1234, 0, 1)),
                       ("write_tlm", ([(0, 99), (1, 70000)],)),
                       ("write_plt", ([1, 127, 128, 70000],)),
                       ("write_com", ("grok",))):
        assert getattr(pj2k, name)(*args) == getattr(jj2k, name)(*args)
    for nc in (1, 3, 4):
        kw = dict(width=33, height=17, numcomps=nc, prec=8)
        assert pjp2.wrap_jp2(b"cs", **kw) == jjp2.wrap_jp2(b"cs", **kw)


@pytest.mark.parametrize("irrev", [False, True])
def test_quantizer_steps_equal(irrev):
    for numres, prec, base in ((6, 8, 0.0), (3, 12, 0.25), (1, 8, 0.0)):
        jq = jmake_quantizer(numres, prec, irrev, 2, base)
        pq = pmake_quantizer(numres, prec, irrev, 2, base)
        assert _fields(pq) == _fields(jq)


def test_synthetic_image_equal():
    for shape in ((17, 23, 1), (8, 9, 3)):
        assert np.array_equal(psynth(*shape, seed=3), jsynth(*shape, seed=3))


def test_plan_for_gives_the_same_arrays(streams):
    for data in streams[:3]:
        cs = data if not jjp2.is_jp2(data) else \
            pjp2.locate_codestream(data)
        jh, jparts, jths = _parse(jj2k, cs)
        ph, _pparts, pths = _parse(pj2k, cs)
        for reduce in (0, 1):
            jp = jserve._plan_for(cs, jh, 0, jths[0], reduce)
            pp = pplan._plan_for(cs, ph, 0, pths[0], reduce)
            assert (jp is None) == (pp is None)
            if jp is None:
                continue
            for a, b in zip(pp.prep, jp.prep):
                assert np.array_equal(np.asarray(a), np.asarray(b))
            for f in ("sop", "eph", "n_blks", "bucket_dims", "sig_tail",
                      "coder", "comps_sig", "mct_mode", "ht_p_ext"):
                assert getattr(pp, f) == getattr(jp, f), f
            for f in ("mb", "bucket", "rok"):
                assert np.array_equal(getattr(pp, f), getattr(jp, f)), f


def _body(data):
    hdr, parts, ths = _parse(jj2k, data)
    th = ths[0]
    body = b"".join(data[p.data_start:p.data_end] for p in parts)
    return hdr, th, body


def test_c_t2_parse_and_ht_scan_give_the_same_outputs(streams):
    for data in streams[:2]:
        hdr, th, body = _body(data)
        plan = jserve._plan_for(data, hdr, 0, th, 0)
        jres = native.t2_parse_prepared(body, plan.prep, plan.sop, plan.eph)
        pres = pnative.t2_parse_prepared(body, plan.prep, plan.sop, plan.eph)
        for a, b in zip(pres, jres):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        chunks = jres[3]
        offs, lens = chunks[:, 4].astype(np.int64), chunks[:, 5]
        jscan, jdig = native.ht_scan2(body, offs, lens)
        pscan, pdig, _bits = pnative.ht_scan2(body, offs, lens)
        assert np.array_equal(pscan, jscan) and np.array_equal(pdig, jdig)
    # garbage framing: both refuse the same segments
    rng = np.random.default_rng(0)
    junk = rng.integers(0, 256, 4000, dtype=np.uint8).tobytes()
    offs = rng.integers(0, 3000, 50).astype(np.int64)
    lens = rng.integers(0, 900, 50).astype(np.int32)
    assert all(np.array_equal(a, b) for a, b in zip(
        pnative.ht_scan2(junk, offs, lens)[:2], native.ht_scan2(junk, offs,
                                                                lens)))


def test_c_parse_and_scan_read_any_buffer_in_place(streams):
    """The C Tier-2 parse and the HT scan on a memoryview at an offset
    into a larger buffer, a bytearray and a uint8 array equal the same
    calls on bytes; the scan into a caller's array at an offset writes
    the same digest there, and declines an array too small."""
    for data in streams[:2]:
        hdr, th, body = _body(data)
        plan = jserve._plan_for(data, hdr, 0, th, 0)
        want = pnative.t2_parse_prepared(body, plan.prep, plan.sop, plan.eph)
        chunks = want[3]
        offs, lens = chunks[:, 4].astype(np.int64), chunks[:, 5]
        wscan, wdig, wbits = pnative.ht_scan2(body, offs, lens)
        for buf in (memoryview(b"\xff" * 13 + body + b"\xff" * 5)[13:-5],
                    bytearray(body), np.frombuffer(body, np.uint8).copy()):
            got = pnative.t2_parse_prepared(buf, plan.prep, plan.sop,
                                            plan.eph)
            assert all(np.array_equal(np.asarray(a), np.asarray(b))
                       for a, b in zip(got, want))
            scan, dig, bits = pnative.ht_scan2(buf, offs, lens)
            assert np.array_equal(scan, wscan) and np.array_equal(bits, wbits)
            assert np.array_equal(dig, wdig)
        out = np.full(37 + 3 * len(body) + 24 * len(offs) + 64, 7, np.uint8)
        scan, dig, bits = pnative.ht_scan2(memoryview(body), offs, lens,
                                           out, 37)
        assert np.array_equal(scan, wscan) and np.array_equal(bits, wbits)
        assert np.array_equal(dig, wdig) and np.shares_memory(dig, out)
        assert np.array_equal(out[37:37 + dig.size], wdig)
        assert (out[:37] == 7).all()
        assert pnative.ht_scan2(body, offs, lens, out[:37 + wdig.size // 2],
                                37) is None


def _cleanup(ms, suffix, nib=0x5):
    """A wire cleanup segment: MagSgn bytes, then the suffix bytes and the
    two Scup bytes (the suffix's length in 12 bits under nibble nib)."""
    scup = len(suffix) + 2
    return bytes(ms) + bytes(suffix) + bytes(
        [(nib << 4) | (scup & 0xF), scup >> 4])


def _coded(rng, n):
    """n bytes of coded data: no 0xFF, as most words of a MagSgn stream."""
    return rng.integers(0, 0xFF, n).astype(np.uint8)


def _scan_segments(case):
    """(body, offs, lens) of HT cleanup segments at the edges of the C
    scan's word path (8 MagSgn bytes a step, none 0xFF) and its suffix
    counts (8 bytes a step, lanes summed every 255 steps)."""
    rng = np.random.default_rng(22)
    segs, extra = [], []
    if case == "ff_at_each_offset":
        for k in range(8):
            for base in (0, 8, 24):
                ms = _coded(rng, 40)
                ms[base + k] = 0xFF
                ms[base + k + 1] &= 0x7F
                segs.append(_cleanup(ms, _coded(rng, 9)))
    elif case == "ff_last_magsgn":
        for n in (1, 7, 8, 9, 15, 16, 17, 64):
            ms = _coded(rng, n)
            ms[-1] = 0xFF
            segs.append(_cleanup(ms, [0x10, 0x90]))
            segs.append(_cleanup(ms, [0xFF, 0x7F, 0x80]))
    elif case == "ff_runs":
        for start, run in ((0, 8), (3, 2), (5, 11), (8, 16), (13, 30)):
            ms = _coded(rng, 64)
            ms[start:start + run] = 0xFF
            segs.append(_cleanup(ms, _coded(rng, 12)))
        segs.append(_cleanup([0xFF] * 33, [0xFF] * 21))
    elif case == "short_and_whole_words":
        for n in list(range(8)) + [8, 16, 24, 64, 1000]:
            segs.append(_cleanup(_coded(rng, n), _coded(rng, 5)))
    elif case == "suffix_7f":
        pairs = [0x7F, 0x90, 0x7F, 0x8F, 0x7F, 0xFF, 0x7F, 0x7F, 0x91,
                 0xFF, 0x7F, 0x00, 0x7F, 0x80]
        for lead in range(9):
            suf = list(_coded(rng, lead)) + pairs
            segs.append(_cleanup(_coded(rng, 20), suf, nib=0x9))
            segs.append(_cleanup(_coded(rng, 3), suf + [0xFF], nib=0xF))
            segs.append(_cleanup(_coded(rng, 3), suf + [0x7F], nib=0xF))
            segs.append(_cleanup(_coded(rng, 5), list(_coded(rng, lead))
                                 + [0x7F, 0x8F, 0x7F, 0x90]))
        segs.append(_cleanup(_coded(rng, 8), [], nib=0xF))
        segs.append(_cleanup(_coded(rng, 8), [0x7F], nib=0xF))
        # a suffix of 2,400 bytes: the lanes are summed past 255 steps
        long = rng.choice(np.array([0xFF, 0x7F, 0x90, 0x8F], np.uint8), 2400)
        segs.append(_cleanup(_coded(rng, 100), long))
        segs.append(_cleanup(_coded(rng, 16), [0xFF] * 2100 + [0x7F] * 1900))
    elif case == "invalid_framing":
        segs.append(bytes([0x12, 0x01, 0x00]))              # scup 1
        segs.append(bytes([0x34, 0x20, 0x01]))              # scup 16 > L
        segs.append(bytes([0xAB, 0xF5]))                    # L 2, scup large
        segs.append(_cleanup(_coded(rng, 30), _coded(rng, 4)))
        segs.append(b"\xff")                                # L 1
        segs.append(b"")                                    # L 0
        # segments outside the body: a negative offset, one past its end
        extra = [(-4, 20), (10, 10 ** 6)]
    else:                                                   # mixed
        alph = np.array([0xFF, 0x7F, 0x8F, 0x90, 0x00, 0x12], np.uint8)
        for n in (0, 5, 8, 31, 64, 200):
            for m in (0, 1, 9, 40):
                segs.append(_cleanup(rng.choice(alph, n), rng.choice(alph, m),
                                     nib=int(rng.integers(0, 16))))
    body = b"".join(segs)
    lens = [len(x) for x in segs] + [ln for _, ln in extra]
    offs = list(np.cumsum([0] + lens[:len(segs) - 1])) + [o for o, _ in extra]
    return (body, np.asarray(offs, np.int64)[:len(lens)],
            np.asarray(lens, np.int32))


def _reader_bits(seg: bytes, suf: int):
    """(MagSgn, MEL, VLC) clean bits as the scalar decoder's readers take
    them, each read until its next bit would be padding."""
    L = len(seg)
    ms, n_ms = _FwdReader(seg, 0, suf), 0
    while ms.pos < suf or ms._n:
        ms.bit()
        n_ms += 1
    mel, n_mel = MELDecoder(seg, suf, L - 2), 0
    while mel.pos < mel.end or mel._nbits:
        mel._read_bit()
        n_mel += 1
    vlc, n_vlc = _VLCReader(seg, suf, L), 0
    while vlc.pos >= suf or vlc._n:
        vlc.bit()
        n_vlc += 1
    return n_ms, n_mel, n_vlc


@pytest.mark.parametrize("case", [
    "ff_at_each_offset", "ff_last_magsgn", "ff_runs", "short_and_whole_words",
    "suffix_7f", "invalid_framing", "mixed"])
def test_c_ht_scan_word_path_edges(case):
    body, offs, lens = _scan_segments(case)
    jscan, jdig = native.ht_scan2(body, offs, lens)
    pscan, pdig, bits = pnative.ht_scan2(body, offs, lens)
    assert np.array_equal(pscan, jscan) and np.array_equal(pdig, jdig)
    valid = pscan[:, 0] == 0
    assert valid.sum() >= 1
    if case == "invalid_framing":
        assert valid.tolist() == [False, False, False, True, False, False,
                                  False, False]
    assert not bits[~valid].any()
    for i in np.flatnonzero(valid):
        seg = body[offs[i]:offs[i] + lens[i]]
        suf = int(lens[i]) - int(pscan[i, 4])
        assert tuple(bits[i]) == _reader_bits(seg, suf), i


def test_c_ht_assemble_batch_gives_the_same_segments():
    rng = np.random.default_rng(1)
    buf = rng.choice(np.array([0xFF, 0x7F, 0x8F, 0x90, 0, 0x12], np.uint8),
                     3000)
    n = 40
    args = [rng.integers(0, 2000, n), rng.integers(0, 3000, n),
            rng.integers(0, 2000, n), rng.integers(0, 2000, n),
            rng.integers(0, 2000, n), rng.integers(0, 2000, n),
            np.where(rng.random(n) < 0.2, -1, 0)]
    j_out, j_lens = native.ht_assemble_batch(buf, *args)
    p_out, p_lens = pnative.ht_assemble_batch(buf, *args)
    assert np.array_equal(p_lens, j_lens)
    assert np.array_equal(p_out[:p_lens.sum()], j_out[:j_lens.sum()])


def _tables_state(t):
    return (t.VLC_ENC, t.VLC_DEC, t.VLC_ENC_INIT, t.VLC_DEC_INIT,
            t.UVLC_PXOR, t.two_families(), t.tables_have_ek())


def test_tables_equal_default_and_after_dropin_install():
    assert _tables_state(PT) == _tables_state(T)
    lens_ek, lens_init = _synthetic_normative_tables()
    v0 = T.VERSION
    PT.install_tables(lens=lens_ek, lens_init=lens_init,
                      uvlc_prefix_xor=0b101)
    try:
        # the port's tables are its own: the JAX package's stay default
        assert T.VERSION == v0 and not T.two_families()
        T.install_tables(lens=lens_ek, lens_init=lens_init,
                         uvlc_prefix_xor=0b101)
        assert _tables_state(PT) == _tables_state(T)
    finally:
        T.reset_tables()
        PT.reset_tables()
    assert _tables_state(PT) == _tables_state(T)


def test_install_tables_clears_the_ports_caches(streams):
    # every cache that bakes table state is keyed on the port's VERSION:
    # after an install its next use rebuilds it and drops the older one
    from grok_tpu_torch.api import stage_device_batch
    from grok_tpu_torch.ops import ht_decode, ht_encode
    cpu = torch.device("cpu")

    def use():
        for mod in (ht_decode, ht_encode):
            mod._lut_on(cpu)
        return stage_device_batch(streams[:1], device="cpu")

    pplan._PLANS.clear()      # plans of earlier tests in this process
    use()
    v0 = PT.VERSION
    PT.reset_tables()
    assert PT.VERSION == v0 + 1
    staged = use()
    for mod in (ht_decode, ht_encode):
        assert list(mod._LUT_CACHE) == [PT.VERSION]
        assert [k[0] for k in mod._DEV_LUT] == [PT.VERSION]
    progs = [k for p in pplan._PLANS.values() if p is not None
             for k in p.fast if isinstance(k, tuple) and k[0] == "torch_prog"]
    assert progs and all(k[3] == PT.VERSION for k in progs)
    img = jsynth(48, 40, 1, seed=40)
    assert np.array_equal(staged.run()[0][0].numpy(), img)


def test_finish_tile_encode_emits_the_same_bytes():
    img = jsynth(72, 56, 3, seed=9)
    for kw in (dict(), dict(sop=True, eph=True, prog_order=3)):
        params = CompressParams(ht=True, num_resolutions=3, cblk_w_exp=4,
                                cblk_h_exp=4, **kw)
        data = compress(img, params)
        jh = jj2k.read_main_header(data)
        ph = pj2k.read_main_header(data)
        jgeo = jtile.TileGeometry.build(jh, 0)
        pgeo = ptile.TileGeometry.build(ph, 0)
        rng = np.random.default_rng(2)
        jobs, jencs, pencs = [], [], []
        for c, tcg in enumerate(jgeo.tcgs):
            for rg in tcg.resolutions:
                for band_i, bg in enumerate(rg.bands):
                    mb = jgeo.quants[c].mb(rg.r, bg.orient)
                    for p in range(rg.num_precincts):
                        for cblk_i, cb in enumerate(bg.precincts[p].cblks):
                            mag = (np.abs(rng.normal(0, 20, (cb.rect.h,
                                                             cb.rect.w)))
                                   .astype(np.int64)) * (rng.random() < 0.8)
                            enc = ht_encode_block(mag, rng.random(mag.shape)
                                                  < 0.5, bg.orient)
                            jobs.append(dict(key=(c, rg.r, p, band_i,
                                                  cblk_i), mb=mb, weight=1.0))
                            jencs.append(enc)
                            pencs.append(EncodedBlock(
                                data=enc.data, numbps=enc.numbps,
                                passes=[PassInfo(q.rate, q.dist, q.term)
                                        for q in enc.passes],
                                seg_lens=list(enc.seg_lens),
                                seg_passes=list(enc.seg_passes)))
        want = jtile.finish_tile_encode(jgeo, jobs, jencs, [None])
        got = ptile.finish_tile_encode(pgeo, jobs, pencs, device="cpu")
        assert got.packets == want.packets and got.body == want.body
        assert got.packet_lens == want.packet_lens


def test_mq_tables_and_initial_states_equal():
    assert pmq.MQ_TABLE == jmq.MQ_TABLE
    for name in ("MQ_QE", "MQ_NMPS", "MQ_NLPS", "MQ_SWITCH"):
        a, b = getattr(pmq, name), getattr(jmq, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in ("N_CTX", "CTX_ZC", "CTX_SC", "CTX_MAG", "CTX_RL",
                 "CTX_UNI"):
        assert getattr(pmq, name) == getattr(jmq, name), name
    assert pmq.initial_ctx_states() == jmq.initial_ctx_states()
    packed = pt1d.mq_table().astype(np.int64)
    assert np.array_equal(packed & 0xFFFF, jmq.MQ_QE)
    assert np.array_equal((packed >> 16) & 0x3F, jmq.MQ_NMPS)
    assert np.array_equal((packed >> 22) & 0x3F, jmq.MQ_NLPS)
    assert np.array_equal(packed >> 28, jmq.MQ_SWITCH)


def test_context_luts_equal():
    assert np.array_equal(pluts.build_zc_lut(), jluts.build_zc_lut())
    for a, b in zip(pluts.build_sc_lut(), jluts.build_sc_lut()):
        assert np.array_equal(a, b)
    for nb in (False, True):
        for ref in (False, True):
            assert pluts.mr_context(nb, ref) == jluts.mr_context(nb, ref)
    # the kernels' flag-word LUT against the Pallas kernel's arithmetic
    lut = pt1d.flag_luts().astype(np.int64)
    f = np.arange(4096)
    ctx, xr = (np.asarray(a) for a in jpt1._sc_from_flags(f))
    assert np.array_equal(lut[1024 + f] & 15, ctx + 9)
    assert np.array_equal(lut[1024 + f] >> 4, xr)
    f = np.arange(256)
    h = ((f >> 3) & 1) + ((f >> 4) & 1)
    v = ((f >> 1) & 1) + ((f >> 6) & 1)
    d = (f & 1) + ((f >> 2) & 1) + ((f >> 5) & 1) + ((f >> 7) & 1)
    for orient in range(4):
        want = np.asarray(jpt1._zc_ctx_arith(np.full(256, orient), h, v, d))
        assert np.array_equal(lut[(orient << 8) | f], want), orient


def test_pass_structure_equal():
    for nb in range(31):
        sched = precords.pass_schedule(nb)
        assert sched == jscalar.pass_schedule(nb)
        for style in range(0x80):
            assert precords.segment_pass_counts(len(sched), style) == \
                jscalar.segment_pass_counts(len(sched), style)
            assert [precords.is_raw_pass(p, t, style)
                    for p, (t, _bp) in enumerate(sched)] == \
                [jscalar.is_raw_pass(p, t, style)
                 for p, (t, _bp) in enumerate(sched)]
    assert (precords.PASS_SIG, precords.PASS_REF, precords.PASS_CLN) == \
        (jscalar.PASS_SIG, jscalar.PASS_REF, jscalar.PASS_CLN)


@pytest.mark.parametrize("shape, kw", [
    ((48, 40, 1), dict(num_resolutions=3, cblk_w_exp=4, cblk_h_exp=4)),
    ((37, 61, 3), dict(num_resolutions=4, cblk_w_exp=3, cblk_h_exp=5)),
    ((64, 64, 1), dict(num_resolutions=2, prec_w_exps=[4, 5],
                       prec_h_exps=[4, 5])),
])
def test_canon_block_indices_equal(shape, kw):
    img = jsynth(*shape, seed=3)
    data = compress(img, CompressParams(ht_mixed=True, **kw))
    jh, _jparts, jths = _parse(jj2k, data)
    ph, _pparts, pths = _parse(pj2k, data)
    jgeo = jtile.TileGeometry.build(jh, 0)
    pgeo = ptile.TileGeometry.build(ph, 0)
    assert ptile.canon_block_indices(pgeo) == jtile.canon_block_indices(jgeo)
    jp = jserve._plan_for(data, jh, 0, jths[0], 0)
    pp = pplan._plan_for(data, ph, 0, pths[0], 0)
    assert jp.coder == pp.coder == "mixed"
    assert np.array_equal(pp.canon_idx, jp.canon_idx)


def test_finish_tile_encode_mixed_blocks_emits_the_same_bytes():
    """HT and Part-1 blocks of one tile under the HT-mixed segmentation
    mask (~CBLK_HT), as the mixed encode finishes them."""
    img = jsynth(40, 56, 1, seed=4)
    params = CompressParams(ht_mixed=True, num_resolutions=3, cblk_w_exp=4,
                            cblk_h_exp=4)
    data = compress(img, params)
    jgeo = jtile.TileGeometry.build(jj2k.read_main_header(data), 0)
    pgeo = ptile.TileGeometry.build(pj2k.read_main_header(data), 0)
    rng = np.random.default_rng(5)
    jobs, jencs, pencs = [], [], []
    for c, tcg in enumerate(jgeo.tcgs):
        for rg in tcg.resolutions:
            for band_i, bg in enumerate(rg.bands):
                mb = jgeo.quants[c].mb(rg.r, bg.orient)
                for p in range(rg.num_precincts):
                    for cblk_i, cb in enumerate(bg.precincts[p].cblks):
                        mag = np.abs(rng.normal(0, 12, (cb.rect.h,
                                                        cb.rect.w)))
                        mag = mag.astype(np.int64)
                        neg = rng.random(mag.shape) < 0.5
                        enc = (ht_encode_block if len(jobs) % 2
                               else jscalar.encode_block)(mag, neg,
                                                          bg.orient)
                        jobs.append(dict(key=(c, rg.r, p, band_i, cblk_i),
                                         mb=mb, weight=1.0))
                        jencs.append(enc)
                        pencs.append(EncodedBlock(
                            data=enc.data, numbps=enc.numbps,
                            passes=[PassInfo(q.rate, q.dist, q.term)
                                    for q in enc.passes],
                            seg_lens=list(enc.seg_lens),
                            seg_passes=list(enc.seg_passes)))
    want = jtile.finish_tile_encode(jgeo, jobs, jencs, [None],
                                    seg_style_mask=~CBLK_HT)
    got = ptile.finish_tile_encode(pgeo, jobs, pencs,
                                   seg_style_mask=~CBLK_HT, device="cpu")
    assert got.packets == want.packets and got.body == want.body
    assert got.com == b""


@pytest.mark.parametrize("irrev", [False, True])
def test_band_norms_and_mct_norms_equal(irrev):
    from grok_tpu.core.quant import band_norm as jnorm
    from grok_tpu.transform.mct_np import mct_component_norms as jmct
    from grok_tpu_torch.core.quant import band_norm as pnorm
    from grok_tpu_torch.transform.mct_np import mct_component_norms as pmct
    for level in range(0, 14):
        for orient in range(4):
            assert pnorm(irrev, level, orient) == jnorm(irrev, level, orient)
    assert np.array_equal(pmct(irrev), jmct(irrev))


def test_derive_p_equal():
    from grok_tpu.t1ht.scalar import derive_p as jderive
    from grok_tpu_torch.t1ht.scalar import derive_p as pderive
    for npass in range(0, 4):
        for numbps in range(0, 30):
            for ext in (None, 0, 1, 2, 3, 7):
                assert pderive(npass, numbps, ext) == \
                    jderive(npass, numbps, ext)


def test_unstuff_copy_and_c_unstuff_batch_equal():
    from grok_tpu.t1ht.wire import _unstuff_lsb as junstuff
    from grok_tpu_torch.t1ht.wire import _unstuff_lsb as punstuff
    rng = np.random.default_rng(3)
    body = rng.choice(np.array([0xFF, 0x7F, 0x8F, 0x90, 0, 0x12], np.uint8),
                      4000)
    body[::5] = rng.integers(0, 256, body[::5].size)
    n = 60
    offs = rng.integers(0, 3000, n).astype(np.int64)
    lens = rng.integers(0, 900, n).astype(np.int32)
    lens[:3] = 0
    out, olens, _bits = pnative.ht_unstuff_batch(body.tobytes(), offs,
                                                 lens)
    pos = np.cumsum(olens) - olens
    for i in range(n):
        seg = body[offs[i]:offs[i] + lens[i]]
        want = junstuff(seg)
        assert punstuff(seg) == want
        assert out[pos[i]:pos[i] + olens[i]].tobytes() == want, i
    with pytest.raises(ValueError):
        pnative.ht_unstuff_batch(body.tobytes(), [3990], [20])


def test_c_ht_raw_batch_gives_the_same_segments():
    rng = np.random.default_rng(4)
    buf = rng.choice(np.array([0xFF, 0x7F, 0xFE, 0x90, 0, 0x12], np.uint8),
                     3000)
    n = 40
    offs = rng.integers(0, 2000, n)
    bits = rng.integers(0, 6000, n)
    bits[:2] = 0
    j_out, j_lens = native.ht_raw_batch(buf, offs, bits)
    p_out, p_lens = pnative.ht_raw_batch(buf, offs, bits)
    assert np.array_equal(p_lens, j_lens)
    assert np.array_equal(p_out[:p_lens.sum()], j_out[:j_lens.sum()])


def _hulls(seed, nb):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(nb):
        k = int(rng.integers(0, 6))
        rates = np.cumsum(rng.integers(0, 400, k)).astype(np.float64)
        dists = np.cumsum(rng.random(k) * rng.choice([0, 1, 1e3, 1e6],
                                                     k)).astype(np.float64)
        out.append((rates, dists))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rate_allocation_copy_equal(seed):
    from grok_tpu.t2 import rate as jrate
    from grok_tpu_torch.t2 import rate as prate
    rd = _hulls(seed, 40)
    jh = [jrate.convex_hull(r, d) for r, d in rd]
    ph = [prate.convex_hull(r, d) for r, d in rd]
    for a, b in zip(ph, jh):
        assert np.array_equal(a.pass_idx, b.pass_idx)
        assert np.array_equal(a.slopes, b.slopes)
        for lam in (0.0, 1.0, 50.0, 1e4):
            assert prate.passes_for_lambda(a, lam, 1) == \
                jrate.passes_for_lambda(b, lam, 1)
    prev = np.zeros(len(ph), np.int64)
    for lam in (0.0, 3.0, 1e3):
        assert np.array_equal(prate._HullBank(ph).passes(lam, prev),
                              jrate._HullBank(jh).passes(lam, prev))
    rates = [r for r, _d in rd]
    cum = np.asarray([len(r) for r in rates], np.int64)
    assert prate._cum_lookup(prate._cum_table(rates), cum) == \
        jrate._cum_lookup(jrate._cum_table(rates), cum)
    totals = [len(r) for r in rates]

    def simulate(layer_cum):
        # a deterministic stand-in for the Tier-2 size: bodies + headers
        last = [lc[-1] for lc in layer_cum]
        return int(sum(rates[b][n - 1] for b, n in enumerate(last) if n)
                   + 7 * sum(last) + 40)
    targets = [1500.0, 6000.0, None]
    assert prate.allocate_layers(ph, 3, targets, simulate, totals,
                                 pass_rates=rates) == \
        jrate.allocate_layers(jh, 3, targets, simulate, totals,
                              pass_rates=rates)


def test_layer_targets_equal():
    from grok_tpu.api import _build_main_header as jbuild
    from grok_tpu.core.image import Image
    from grok_tpu.t2 import rate as jrate
    from grok_tpu_torch.api import _build_main_header as pbuild
    from grok_tpu_torch.core.params import CompressParams as PCP
    from grok_tpu_torch.t2 import rate as prate
    kw = dict(ht=True, num_resolutions=3, ht_planes=2, num_layers=3,
              rates=[40.0, 10.0, 1.0], comment="x")
    img = jsynth(72, 56, 3, seed=9)
    jp, pp = CompressParams(**kw), PCP(**kw)
    jh = jbuild(Image.from_array(img), jp)
    ph = pbuild(72, 56, 3, 8, False, pp)
    jc, pc = jrate.layer_budget_consts(jh, jp), prate.layer_budget_consts(ph,
                                                                         pp)
    assert pc == jc
    rect = ph.siz.tile_rect(0)
    assert prate.layer_targets_for_tile(pc, rect, pp) == \
        jrate.layer_targets_for_tile(jc, jh.siz.tile_rect(0), jp)


def test_block_dec_state_assembles_the_same_segments():
    from grok_tpu.t2.packet import BlockDecState as JState
    from grok_tpu.t2.packet import Chunk as JChunk
    from grok_tpu_torch.t2.packet import BlockDecState as PState
    from grok_tpu_torch.t2.packet import Chunk as PChunk
    body = bytes(range(256)) * 4
    rows = [(0, 0, 1, 0, 10), (1, 1, 1, 10, 7), (1, 2, 1, 17, 3),
            (2, 0, 2, 30, 0), (3, 1, 1, 40, 5)]
    js, ps = JState(included=True), PState(included=True)
    for lay, segno, npk, off, ln in rows:
        js.chunks.append(JChunk(lay, segno, npk, off, ln))
        ps.chunks.append(PChunk(lay, segno, npk, off, ln))
    for cap in range(0, 5):
        assert ps.assemble(body, cap) == js.assemble(body, cap)


def test_bit_reader_and_tag_trees_decode_the_same_bits():
    """The packet-header bit reader (0xFF stuffing) and the tag trees of
    the port's Python Tier-2 parse against the JAX package's, on random
    bytes with runs of 0xFF."""
    from grok_tpu.codestream.bitio import BitReader as JReader
    from grok_tpu.t2.tagtree import TagTree as JTree
    from grok_tpu_torch.codestream.bitio import BitReader as PReader
    from grok_tpu_torch.t2.tagtree import TagTree as PTree
    rng = np.random.default_rng(9)
    for trial in range(20):
        data = rng.integers(0, 256, 64, dtype=np.uint8)
        data[rng.random(64) < 0.2] = 0xFF
        data = data.tobytes()
        jr, pr = JReader(data, 3), PReader(data, 3)
        w, h = 1 + trial % 5, 1 + trial % 3
        jt, pt = JTree(w, h), PTree(w, h)
        got, want = [], []
        for k in range(40):
            x, y = k % w, (k // w) % h
            n = 1 + k % 7
            for rd, tree, out in ((jr, jt, want), (pr, pt, got)):
                try:
                    out.append((tree.decode(rd, x, y, 1 + k % 4),
                                tree.leaf_value(x, y), rd.read_bits(n),
                                rd.pos))
                    if k % 9 == 8:
                        rd.align()
                except EOFError:
                    out.append("eof")
        assert got == want


def test_profile_checks_equal():
    """The port's Rsiz profile check against the JAX package's, over
    profiles, sizes, tiling, progressions and rates."""
    from grok_tpu.codestream.profiles import validate_profile as jcheck
    from grok_tpu.core.params import CompressParams as JCP
    from grok_tpu.core.params import ProgOrder as JOrder
    from grok_tpu.core.params import RsizProfile as JRsiz
    from grok_tpu_torch.codestream.profiles import validate_profile as pcheck
    from grok_tpu_torch.core.params import CompressParams as PCP
    from grok_tpu_torch.core.params import ProgOrder as POrder
    from grok_tpu_torch.core.params import RsizProfile as PRsiz
    for rsiz in ("NONE", "CINEMA_2K", "CINEMA_4K", "BROADCAST", "IMF"):
        for kw in (dict(), dict(irreversible=True, prog_order="CPRL",
                                cblk_w_exp=5, cblk_h_exp=5),
                   dict(tile_w=1024, tile_h=1024, num_layers=2,
                        rates=[40.0, 8.0]),
                   dict(num_resolutions=8, prec_w_exps=[9] * 8,
                        prec_h_exps=[9] * 8)):
            for (w, h, nc, fr, ml, sl) in ((64, 48, 1, None, 0, 0),
                                           (2048, 1080, 3, 48, 3, 1),
                                           (4096, 2160, 3, 24.0, 11, 0)):
                def args(cp, order, prof):
                    k = dict(kw, rsiz=getattr(prof, rsiz))
                    if "prog_order" in k:
                        k["prog_order"] = getattr(order, k["prog_order"])
                    return (cp(**k), w, h, nc)
                extra = dict(frame_rate=fr, mainlevel=ml, sublevel=sl)
                assert pcheck(*args(PCP, POrder, PRsiz), **extra) == \
                    jcheck(*args(JCP, JOrder, JRsiz), **extra)


def test_finish_tile_encode_layers_emits_the_same_bytes():
    """The PCRD branch: refined HT blocks (three terminated passes each)
    allocated into three layers, two of them byte-targeted."""
    img = jsynth(72, 56, 1, seed=11)
    params = CompressParams(ht=True, num_resolutions=3, cblk_w_exp=4,
                            cblk_h_exp=4, num_layers=3)
    data = compress(img, params)
    jgeo = jtile.TileGeometry.build(jj2k.read_main_header(data), 0)
    pgeo = ptile.TileGeometry.build(pj2k.read_main_header(data), 0)
    rng = np.random.default_rng(6)
    jobs, jencs, pencs = [], [], []
    for c, tcg in enumerate(jgeo.tcgs):
        for rg in tcg.resolutions:
            for band_i, bg in enumerate(rg.bands):
                mb = jgeo.quants[c].mb(rg.r, bg.orient)
                for p in range(rg.num_precincts):
                    for cblk_i, cb in enumerate(bg.precincts[p].cblks):
                        mag = (np.abs(rng.normal(0, 40, (cb.rect.h,
                                                         cb.rect.w)))
                               .astype(np.int64)) * (rng.random() < 0.9)
                        enc = ht_encode_block(mag, rng.random(mag.shape)
                                              < 0.5, bg.orient, p=2)
                        jobs.append(dict(key=(c, rg.r, p, band_i, cblk_i),
                                         mb=mb, weight=float(rng.random())))
                        jencs.append(enc)
                        pencs.append(EncodedBlock(
                            data=enc.data, numbps=enc.numbps,
                            passes=[PassInfo(q.rate, q.dist, q.term)
                                    for q in enc.passes],
                            seg_lens=list(enc.seg_lens),
                            seg_passes=list(enc.seg_passes)))
    targets = [600.0, 1800.0, None]
    want = jtile.finish_tile_encode(jgeo, jobs, jencs, targets)
    got = ptile.finish_tile_encode(pgeo, jobs, pencs, targets,
                                   device="cpu")
    assert got.packets == want.packets and got.body == want.body
    assert len(got.packets) > 3 and len(got.body) > 600


_BANNED = ("jax", "jaxlib", "grok_tpu")


def _sources():
    pkg = os.path.join(REPO, "grok_tpu_torch")
    for root, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_sources_import_no_jax_and_no_jax_package():
    """Every import in the port and in chip_smoke.py, at module level or
    inside a function, by its top-level name."""
    bad = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                if n.split(".")[0] in _BANNED:
                    bad.append(f"{os.path.relpath(path, REPO)}:"
                               f"{node.lineno} {n}")
    assert not bad, bad


def test_port_sources_scanned_include_the_mesh_modules():
    """The import scan above reads the scale-out modules too."""
    scanned = {os.path.relpath(p, REPO) for p in _sources()}
    assert {f"grok_tpu_torch/parallel/{m}.py" for m in
            ("__init__", "sharding", "distributed", "entry")} <= scanned


@pytest.mark.parametrize("shape", [(64, 32), (9, 5), (16, 1), (2, 3)])
def test_reference_inv53_vertical_equal(shape):
    """The port's copy of the sharded lifting's NumPy oracle against its
    original."""
    from grok_tpu.parallel.sharding import reference_inv53_vertical as jref
    from grok_tpu_torch.parallel.sharding import \
        reference_inv53_vertical as pref
    y = np.random.default_rng(7).integers(-500, 500, shape).astype(np.int32)
    assert np.array_equal(pref(y), jref(y))


def test_port_sources_scanned_include_the_object_api_and_the_tools():
    """The import scan reads the object API, the CLI tools and the host
    copies they bring."""
    scanned = {os.path.relpath(p, REPO) for p in _sources()}
    assert {"grok_tpu_torch/codec.py", "grok_tpu_torch/cli/compress.py",
            "grok_tpu_torch/cli/decompress.py", "grok_tpu_torch/cli/dump.py",
            "grok_tpu_torch/pipeline/postproc.py",
            "grok_tpu_torch/util/imageio.py", "grok_tpu_torch/util/msg.py",
            "grok_tpu_torch/util/trace.py"} <= scanned


def test_jp2_metadata_and_header_info_equal(streams):
    """The JP2 boxes' parse (JP2Meta, palette, cmap, cdef, colr/ICC,
    resolution) and read_header's HeaderInfo, against the originals."""
    import struct

    from grok_tpu.api import read_header as jread_header
    from grok_tpu_torch.api import read_header as pread_header
    ihdr = jjp2._box(b"ihdr", struct.pack(">IIHBBBB", 8, 8, 1, 7, 7, 0, 0))
    icc = jjp2._box(b"colr", struct.pack(">BBB", 2, 0, 0) + b"ICCDATA")
    pclr = jjp2._box(b"pclr", struct.pack(">HB", 2, 3) + bytes([7, 7, 7])
                     + bytes(range(6)))
    cmap = jjp2._box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, c)
                                       for c in range(3)))
    cdef = jjp2._box(b"cdef", struct.pack(">H", 1)
                     + struct.pack(">HHH", 0, 0, 1))
    res = jjp2._box(b"res ", jjp2._box(b"resc", jjp2._res_payload(
        (2834.0, 2835.0))))
    jp2h = jjp2._box(b"jp2h", ihdr + icc + pclr + cmap + cdef + res)
    ftyp = jjp2._box(b"ftyp", b"jp2 " + struct.pack(">I", 0) + b"jp2 ")
    wrapped = [jjp2.JP2_SIGNATURE + ftyp + jp2h
               + jjp2._box(b"jp2c", streams[0])]
    wrapped += [s for s in streams if jjp2.is_jp2(s)]
    for data in wrapped:
        js, je, jm = jjp2.parse_jp2(data)
        ps, pe, pm = pjp2.parse_jp2(data)
        assert (ps, pe) == (js, je)
        assert repr(pm) == repr(jm)
    for data in streams + wrapped:
        assert repr(pread_header(data)) == repr(jread_header(data))
    kw = dict(width=33, height=17, numcomps=3, prec=12, icc_profile=b"icc",
              capture_resolution=(2834.0, 2835.0),
              per_comp_prec=[(12, False), (8, False), (8, True)])
    assert pjp2.wrap_jp2(b"cs", **kw) == jjp2.wrap_jp2(b"cs", **kw)


def test_postprocess_and_image_model_equal():
    """palette, cdef, upsample, force-RGB over the copied Image model,
    against grok_tpu/pipeline/postproc.py on the same inputs."""
    from grok_tpu.core import image as jimage
    from grok_tpu.pipeline import postproc as jpost
    from grok_tpu_torch.core import image as pimage
    from grok_tpu_torch.pipeline import postproc as ppost
    rng = np.random.default_rng(5)
    y = rng.integers(0, 256, (12, 10)).astype(np.int32)
    c = rng.integers(0, 4, (6, 5)).astype(np.int32)

    def build(im):
        return im.Image(components=[
            im.Component(data=y.copy(), prec=8),
            im.Component(data=c.copy(), dx=2, dy=2, prec=8),
            im.Component(data=c.copy(), dx=2, dy=2, prec=8)],
            color_space=im.ColorSpace.UNSPECIFIED)

    def meta(jp):
        return jp.JP2Meta(
            palette=jp.PaletteBox(entries=[[9, 8], [7, 6], [5, 4], [3, 2]],
                                  bit_depths=[8, 8], sgnd=[False, False]),
            cmap=[jp.ComponentMapping(0, 0, 0), jp.ComponentMapping(1, 1, 0),
                  jp.ComponentMapping(2, 1, 1)],
            cdef=[jp.ChannelDef(0, 0, 3), jp.ChannelDef(1, 0, 2),
                  jp.ChannelDef(2, 0, 1)])

    class DP:
        upsample = force_rgb = True
        apply_icc = False
    got = ppost.postprocess(build(pimage), meta(pjp2), DP())
    want = jpost.postprocess(build(jimage), meta(jjp2), DP())
    assert repr(got) == repr(want)
    gray = [im.Image.from_array(y) for im in (pimage, jimage)]
    assert repr(ppost.force_rgb(gray[0])) == repr(jpost.force_rgb(gray[1]))


def test_imageio_msg_and_trace_copies_equal(tmp_path):
    """The format readers and writers (PGX, PNM, PAM, raw) on each
    other's files, the message handlers and the tracer's blob."""
    from grok_tpu.core.image import Image as JImage
    from grok_tpu.util import imageio as jio
    from grok_tpu.util import trace as jtrace
    from grok_tpu_torch.util import imageio as pio
    from grok_tpu_torch.util import msg as pmsg
    from grok_tpu_torch.util import trace as ptrace
    rng = np.random.default_rng(6)
    cases = {"a.pgx": JImage.from_array(rng.integers(0, 1 << 20, (5, 7)),
                                        prec=20),
             "a.ppm": JImage.from_array(rng.integers(0, 256, (5, 7, 3))),
             "a.pgm": JImage.from_array(rng.integers(0, 4096, (5, 7)),
                                        prec=12),
             "a.pam": JImage.from_array(rng.integers(0, 256, (4, 6, 4)))}
    for name, img in cases.items():
        jio.write_image(str(tmp_path / ("j" + name)), img)
        pimg = pio.read_image(str(tmp_path / ("j" + name)))
        assert repr(pimg) == repr(jio.read_image(str(tmp_path
                                                     / ("j" + name))))
        pio.write_image(str(tmp_path / ("p" + name)), pimg)
        assert (tmp_path / ("p" + name)).read_bytes() == \
            (tmp_path / ("j" + name)).read_bytes()
    img = cases["a.pgx"]
    jio.write_raw(str(tmp_path / "j.raw"), img)
    pio.write_raw(str(tmp_path / "p.raw"), pio.read_raw(
        str(tmp_path / "j.raw"), 7, 5, 1, 20))
    assert (tmp_path / "p.raw").read_bytes() == \
        (tmp_path / "j.raw").read_bytes()
    got = []
    pmsg.set_msg_handlers(warning=got.append)
    try:
        pmsg.warn("w")
    finally:
        pmsg.set_msg_handlers()
    assert got == ["w"]
    blobs = []
    for tr in (ptrace, jtrace):
        tr.enable()
        try:
            with tr.trace("a", x=1):
                pass
            tr.count("n", 2)
            blob = tr.collect()
        finally:
            tr.enable(False)
        blobs.append((sorted(blob["stages"]), blob["counters"],
                      blob["stages"]["a"]["calls"]))
    assert blobs[0] == blobs[1]
