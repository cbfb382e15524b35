"""Strict decodes and the HT lane error flag of the PyTorch port, held
against the JAX package on the CPU (the port's plain versions).

Lane level: HT code-blocks coded by grok_tpu.t1ht.scalar (cleanup only,
and with the ht_planes extension at 1 to 3 passes), bytes of their
segments flipped, each sorted by grok_tpu.t1ht.scalar.ht_decode_block
(strict=True) into one of four classes: it decodes; it raises "bad VLC
code" (ERR_VLC); it raises "bad exponent bound" (ERR_EXP); it decodes
but reads a MagSgn value of 25 bits or more (U over 25) or a UVLC escape
(u >= 36).  The lanes' clean streams are the bits the scalar readers
take, 1-bits past each segment's end included.  The port's plain K1/K2
(ht_decode_lanes_ref) must give the scalar's permissive (mag2, neg),
wrapped to int32, and the class as its error code.

Stream level: intact, cut, SOP-flipped and EPH-less Part-1 and HT
streams through api.decompress_device(strict=True, device="cpu") must
raise the exception grok_tpu.decompress_device(strict=True) raises, with
its type and message, or give its planes.

    python -m pytest tests/test_torch_strict.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import grok_tpu  # noqa: E402
import grok_tpu.t1ht.scalar as scalar  # noqa: E402
from grok_tpu import CompressParams as JCP  # noqa: E402
from grok_tpu import DecompressParams as JDP  # noqa: E402
from grok_tpu import native  # noqa: E402
from grok_tpu.t1ht.mel import MELDecoder  # noqa: E402
from grok_tpu.util.oracle import synthetic_image  # noqa: E402
from grok_tpu_torch import api  # noqa: E402
from grok_tpu_torch.core.params import DecompressParams as PDP  # noqa: E402
from grok_tpu_torch.ops import ht_decode as D  # noqa: E402
from grok_tpu_torch.util import damaged_vectors as dv  # noqa: E402

DECODES, BAD_VLC, BAD_EXP, WIDE_U = 0, 1, 2, 3
_MSG = {"HT cleanup: bad VLC code": BAD_VLC,
        "HT cleanup: bad exponent bound": BAD_EXP}


def _bits_to_row(bits: list, nbytes: int) -> np.ndarray:
    """A bit sequence packed LSB-first into nbytes clean bytes."""
    a = np.zeros(nbytes * 8, np.uint8)
    a[:len(bits)] = bits[:nbytes * 8]
    return np.packbits(a.reshape(-1, 8)[:, ::-1], axis=1).reshape(-1)


def _clean_rows(data: bytes, seg_lens: list, n: int, nbytes: int):
    """The clean MagSgn, MEL, VLC, SigProp and MagRef rows of one HT
    block: the bits the scalar decoder's readers take (1-bits past each
    segment's end), nbytes each."""
    L = seg_lens[0]
    ms_lo, ms_hi, suf_lo = scalar.parse_cleanup(data, L)
    nb = 8 * nbytes
    fwd = scalar._FwdReader(data, ms_lo, ms_hi)
    mel = MELDecoder(data, suf_lo, L - 2)
    vlc = scalar._VLCReader(data, suf_lo, L)
    rows = [[fwd.bit() for _ in range(nb)],
            [mel._read_bit() for _ in range(nb)],
            [vlc.bit() for _ in range(nb)]]
    s0 = L
    for k in (1, 2):
        if n > k and len(seg_lens) > k:
            s1 = s0 + seg_lens[k]
            rd = scalar._FwdReader(data, s0, min(s1, len(data)))
            rows.append([rd.bit() for _ in range(nb)])
            s0 = s1
        else:
            rows.append([1] * nb)
    return [_bits_to_row(r, nbytes) for r in rows]


def _classify(job, monkeypatch) -> int | None:
    """The lane's class by the scalar decoder's strict decode, None for
    the host-level failures (a cut or badly framed cleanup segment)."""
    seen = {"n": 0, "esc": False}
    fwd_bits, read_u = scalar._FwdReader.bits, scalar._read_u_pair

    def bits(self, n):
        seen["n"] = max(seen["n"], n)
        return fwd_bits(self, n)

    def u_pair(*a):
        got = read_u(*a)
        seen["esc"] |= max(got) >= 36
        return got

    with monkeypatch.context() as m:
        m.setattr(scalar._FwdReader, "bits", bits)
        m.setattr(scalar, "_read_u_pair", u_pair)
        try:
            scalar.ht_decode_block(*_args(job), strict=True,
                                   ht_planes=job["P"])
        except ValueError as e:
            return _MSG.get(str(e))
    return WIDE_U if seen["n"] >= 25 or seen["esc"] else DECODES


def _args(job):
    return (job["data"], job["seg_lens"], job["n"], job["numbps"],
            job["orient"], job["w"], job["h"])


def flipped_jobs(seed: int, count: int, W: int, H: int,
                 flips: bool = True):
    """count HT blocks of up to W x H coded by the scalar coder (cleanup
    plane 0 or the ht_planes extension P = 1, 2 at 1..3 passes), with 1
    to 3 bytes of their segments overwritten (random, 0xFF or 0x00;
    none without flips), seeded."""
    rng = np.random.default_rng(seed)
    jobs = []
    while len(jobs) < count:
        w = int(rng.integers(W // 2, W + 1))
        h = int(rng.integers(H // 2, H + 1))
        sigma = float(rng.choice([4, 30, 300, 3000]))
        mag = np.abs(rng.laplace(0, sigma, (h, w))).astype(np.int64)
        mag[rng.random((h, w)) < 0.3] = 0
        if not mag.any():
            continue
        neg = rng.random((h, w)) < 0.5
        P = int(rng.integers(0, 3))
        orient = int(rng.integers(0, 4))
        enc = scalar.ht_encode_block(mag, neg, orient, p=P)
        n = int(rng.integers(1, len(enc.seg_lens) + 1))
        seg = list(enc.seg_lens[:n])
        data = bytearray(enc.data[:sum(seg)])
        L = seg[0]
        for _ in range(int(rng.integers(1, 4)) if flips else 0):
            # the cleanup segment but its two Scup bytes, mostly; a
            # refinement byte now and then
            at = int(rng.integers(0, max(L - 2, 1))) if rng.random() < 0.85 \
                else int(rng.integers(0, len(data)))
            data[at] = int(rng.choice([int(rng.integers(0, 256)), 0xFF,
                                       0x00]))
        jobs.append(dict(data=bytes(data), seg_lens=seg, n=n,
                         numbps=enc.numbps, orient=orient, w=w, h=h, P=P))
    return jobs


def port_lanes(jobs, W: int, H: int):
    """ht_decode_lanes' K2 arguments for the jobs (every lane with its
    SigProp and MagRef rows and pass count)."""
    nbytes = max(len(j["data"]) for j in jobs) + 64
    rows = [_clean_rows(j["data"], j["seg_lens"], j["n"], nbytes)
            for j in jobs]

    def u8(k):
        return torch.from_numpy(np.stack([r[k] for r in rows]))

    def col(v):
        return torch.tensor(list(v), dtype=torch.int32)
    p = col(scalar.derive_p(j["n"], j["numbps"], j["P"]) for j in jobs)
    return (u8(0), u8(1), u8(2), p, col(j["w"] for j in jobs),
            col(j["h"] for j in jobs), col(1 for _ in jobs), u8(3), u8(4),
            col(j["n"] for j in jobs))


def scalar_planes(jobs, W: int, H: int, wrap: bool = True) -> np.ndarray:
    """The scalar decoder's permissive decodes as signed mag2 wrapped to
    int32, (NL, H, W) (int64, as they are, without wrap)."""
    out = np.zeros((len(jobs), H, W), np.int64)
    for i, j in enumerate(jobs):
        m2, ng = scalar.ht_decode_block(*_args(j), ht_planes=j["P"])
        out[i, :j["h"], :j["w"]] = np.where(ng, -m2, m2)
    if not wrap:
        return out
    out &= 0xFFFFFFFF
    return np.where(out >= 1 << 31, out - (1 << 32), out).astype(np.int32)


# (seed, lanes, lane side W x H): narrow and wide lanes; the first seed
# covers every class (two or more lanes of ERR_EXP and of U over 25 or
# an escape among 48)
LANES = [(17, 48, 16, 16), (12, 48, 16, 16), (6, 24, 32, 32),
         (7, 12, 128, 8)]


@pytest.mark.parametrize("seed, count, W, H", LANES)
def test_plain_k1_k2_equal_the_scalar_decoder_and_flag_its_class(
        monkeypatch, seed, count, W, H):
    jobs = flipped_jobs(seed, count, W, H)
    cls = [_classify(j, monkeypatch) for j in jobs]
    keep = [i for i, c in enumerate(cls) if c is not None]
    jobs, cls = [jobs[i] for i in keep], np.asarray([cls[i] for i in keep])
    lanes = port_lanes(jobs, W, H)
    want = scalar_planes(jobs, W, H)
    # K2 (every lane with its passes) and K1 (the cleanup-only lanes)
    got, err = D.ht_decode_lanes_ref(*lanes[:7], W, H, *lanes[7:])
    # a decoded lane may be marked for the int64 re-decode (MARK_I64):
    # every lane whose scalar magnitudes pass int32 is, and its int64
    # re-decode gives the scalar's int64 planes
    e = err.numpy()
    assert np.array_equal(np.where(e == D.MARK_I64, 0, e),
                          np.where(cls == WIDE_U, 0, cls))
    assert np.array_equal(got.numpy(), want)
    wide = scalar_planes(jobs, W, H, wrap=False)
    over = (np.abs(wide) >= 1 << 31).reshape(len(jobs), -1).any(1)
    assert (e[over] == D.MARK_I64).all()
    g64, e64 = D.ht_decode_lanes_ref(*lanes[:7], W, H, *lanes[7:], i64=True)
    assert torch.equal(e64, err)
    assert np.array_equal(g64.numpy(), wide)
    one = np.nonzero([j["n"] == 1 for j in jobs])[0]
    sel = torch.from_numpy(one)
    got1, err1 = D.ht_decode_lanes_ref(*(t[sel] for t in lanes[:7]), W, H)
    assert np.array_equal(err1.numpy(), err.numpy()[one])
    assert np.array_equal(got1.numpy(), want[one])
    if seed == LANES[0][0]:
        # the seeds cover every class
        assert set(cls.tolist()) == {DECODES, BAD_VLC, BAD_EXP, WIDE_U}


# ---------------------------------------------------------------------------
# Stream level
# ---------------------------------------------------------------------------

def _np(comps):
    return np.stack([np.asarray(c) for c in comps])


def _outcome(decode):
    """("planes", array) or ("raises", type, message)."""
    try:
        return ("planes", _np(decode()))
    except Exception as e:             # noqa: BLE001: held to the JAX one
        return ("raises", type(e), str(e))


def _assert_same_strict(data: bytes):
    """The port's strict decode gives what the JAX package's gives: its
    planes, or its exception's type and message."""
    want = _outcome(lambda: grok_tpu.decompress_device(data,
                                                       JDP(strict=True)))
    got = _outcome(lambda: api.decompress_device(data, PDP(strict=True),
                                                 device="cpu"))
    assert got[0] == want[0], (got, want)
    if want[0] == "planes":
        assert np.array_equal(got[1], want[1])
    else:
        assert got[1:] == want[1:]
    return want


def _body_range(data: bytes):
    from grok_tpu_torch.codestream import j2k as pj2k
    hdr = pj2k.read_main_header(data)
    part, = pj2k.read_tile_parts(data, hdr)
    return part.data_start, part.data_end


def _block_chunks(data: bytes):
    """(offset in the stream, length) of each code-block chunk of a
    single-tile stream, by the port's C Tier-2 parse."""
    from grok_tpu_torch import native as pnative
    from grok_tpu_torch.codestream import j2k as pj2k
    from grok_tpu_torch.pipeline import plan as pplan
    hdr = pj2k.read_main_header(data)
    part, = pj2k.read_tile_parts(data, hdr)
    th = pj2k.TileHeader()
    pj2k.read_tile_part_header(data, part, hdr, th)
    body = data[part.data_start:part.data_end]
    plan = pplan._plan_for(data, hdr, 0, th, 0)
    chunks = pnative.t2_parse_prepared(body, plan.prep, plan.sop,
                                       plan.eph)[3]
    return [(part.data_start + int(o), int(n)) for o, n in chunks[:, 4:6]]


def corrupt_edits(data: bytes, seed: int, k: int,
                  byte: int | None = None) -> np.ndarray:
    """(k, 2) [offset, byte]: a byte of the cleanup suffix region (the
    last third of the chunk, but its two Scup bytes) of k code-blocks'
    chunks overwritten (by `byte`, or random bytes), so that the packets
    parse and the blocks' codewords break."""
    rng = np.random.default_rng(seed)
    chunks = [c for c in _block_chunks(data) if c[1] >= 8]
    out = []
    for i in rng.choice(len(chunks), size=min(k, len(chunks)),
                        replace=False):
        off, n = chunks[int(i)]
        at = off + int(rng.integers(2 * n // 3, n - 2))
        out.append((at, int(rng.integers(0, 256)) if byte is None
                    else byte))
    return np.asarray(out, np.int64)


def corrupt_blocks(data: bytes, seed: int, k: int) -> bytes:
    """data with corrupt_edits applied."""
    out = bytearray(data)
    for off, b in corrupt_edits(data, seed, k).tolist():
        out[off] = b
    return bytes(out)


def _drop_eph(data: bytes) -> bytes:
    """The stream with its third EPH marker's second byte changed."""
    lo, hi = _body_range(data)
    at, seen = lo, 0
    while True:
        at = data.index(b"\xff\x92", at, hi)
        seen += 1
        if seen == 3:
            return data[:at + 1] + b"\x00" + data[at + 2:]
        at += 2


@pytest.fixture(scope="module")
def strict_streams():
    """Small Part-1 (8 x 8 blocks, 3-bit samples: quick plain K3) and HT
    streams, 2 layers, with SOP and EPH."""
    gray = synthetic_image(48, 40, 1, seed=31).astype(np.int32) >> 5
    from grok_tpu.core.image import Component, Image
    from grok_tpu.core.image import ColorSpace
    img1 = Image(components=[Component(gray, prec=3, sgnd=False)],
                 color_space=ColorSpace.GRAY)
    rgb = synthetic_image(48, 40, 3, seed=32)
    kw = dict(num_resolutions=3, num_layers=2, rates=[16.0, 4.0], sop=True,
              eph=True)
    return {"part1": grok_tpu.compress(img1, JCP(cblk_w_exp=3, cblk_h_exp=3,
                                                 **kw)),
            "ht": grok_tpu.compress(rgb, JCP(ht=True, cblk_w_exp=4,
                                             cblk_h_exp=4, **kw))}


@pytest.mark.skipif(not native.available(), reason="no C toolchain")
@pytest.mark.parametrize("coder", ["part1", "ht"])
@pytest.mark.parametrize("case", ["intact", "cut", "sop_flip", "no_eph"])
def test_strict_streams_raise_or_decode_as_the_jax_package(strict_streams,
                                                           coder, case):
    data = strict_streams[coder]
    if case == "cut":
        data = data[:len(data) * 3 // 4]
    elif case == "sop_flip":
        data = dv.flip_mid_packet(data)
    elif case == "no_eph":
        data = _drop_eph(data)
    want = _assert_same_strict(data)
    assert want[0] == ("planes" if case == "intact" else "raises")


@pytest.mark.skipif(not native.available(), reason="no C toolchain")
def test_strict_part1_mode_switches_decode_unchecked_as_the_jax_package():
    """A Part-1 stream of every mode switch (0x3F, as the committed m1)
    with a byte of every code-block's codewords replaced, its packets
    intact.  grok_tpu.decompress_device(strict=True) decodes such blocks
    unchecked, and the port's strict decode gives its planes (K3 takes no
    error flag); only the JAX package's host scalar decoder
    (grok_tpu.decompress(strict=True, backend="scalar")) checks the
    segmentation symbol and raises."""
    gray = synthetic_image(48, 40, 1, seed=31).astype(np.int32) >> 5
    from grok_tpu.core.image import ColorSpace, Component, Image
    img = Image(components=[Component(gray, prec=3, sgnd=False)],
                color_space=ColorSpace.GRAY)
    data = bytearray(grok_tpu.compress(img, JCP(
        cblk_w_exp=3, cblk_h_exp=3, cblk_style=0x3F, num_resolutions=3,
        num_layers=2, rates=[16.0, 4.0])))
    rng = np.random.default_rng(0)
    for off, n in _block_chunks(bytes(data)):
        if n >= 3:
            data[off + int(rng.integers(0, n))] = int(rng.integers(0, 256))
    data = bytes(data)
    assert _assert_same_strict(data)[0] == "planes"
    with pytest.raises(ValueError, match="segmentation symbol mismatch"):
        grok_tpu.decompress(data, JDP(strict=True, backend="scalar"))


@pytest.mark.skipif(not native.available(), reason="no C toolchain")
def test_strict_names_the_jax_packages_first_failing_block():
    """Several HT blocks with broken codewords, in a stream of 16 x 16
    precincts (the JAX package's decode order, component, resolution,
    band, precinct, code-block, is not the Tier-2 parse's): the strict
    decode raises the scalar decoder's error of the block the JAX package
    decodes first (the first failing block of seed 99 has an exponent
    bound over 40, of the others an invalid codeword)."""
    from grok_tpu_torch.codestream import j2k as pj2k
    from grok_tpu_torch.pipeline import plan as pplan
    from grok_tpu_torch.pipeline.tile import raise_first_ht_error
    rgb = synthetic_image(48, 40, 3, seed=32)
    ht = grok_tpu.compress(rgb, JCP(ht=True, cblk_w_exp=3, cblk_h_exp=3,
                                    prec_w_exps=[4, 4, 4],
                                    prec_h_exps=[4, 4, 4], num_resolutions=3,
                                    num_layers=2, rates=[16.0, 4.0]))
    msgs = set()
    for seed in (0, 2, 99):
        data = corrupt_blocks(ht, seed, 16)
        want = _assert_same_strict(data)
        if want[0] == "raises":
            msgs.add(want[2])
    assert msgs == {"HT cleanup: bad VLC code",
                    "HT cleanup: bad exponent bound"}
    # the order itself: two failing blocks the parse meets in one order
    # and the JAX package's decode in the other
    hdr = pj2k.read_main_header(ht)
    part, = pj2k.read_tile_parts(ht, hdr)
    th = pj2k.TileHeader()
    pj2k.read_tile_part_header(ht, part, hdr, th)
    job = pplan._plan_for(ht, hdr, 0, th, 0).job_idx
    a = next(b for b in range(job.size - 1) if job[b] > job[b + 1])
    with pytest.raises(ValueError, match="bad VLC code"):
        raise_first_ht_error(job, np.array([a, a + 1]), np.array([2, 1]))
    with pytest.raises(ValueError, match="bad exponent bound"):
        raise_first_ht_error(job, np.array([a, a + 1]), np.array([1, 2]))


@pytest.mark.skipif(not native.available(), reason="no C toolchain")
@pytest.mark.parametrize("route", ["served", "general"])
def test_permissive_decode_of_magnitudes_past_int32_equals_the_jax_package(
        monkeypatch, route):
    """The 48 x 40 HT stream of 16 x 16 precincts with 16 blocks'
    codewords broken (seed 0): the scalar decoder's magnitudes reach
    2^35 on blocks it decodes.  The port marks those lanes (MARK_I64),
    re-decodes them in int64 and dequantizes them in int64, so that its
    permissive decode equals grok_tpu.decompress on every sample, served
    and on the general route; without the re-decode it does not."""
    from grok_tpu_torch.pipeline import device as pdev
    rgb = synthetic_image(48, 40, 3, seed=32)
    ht = grok_tpu.compress(rgb, JCP(ht=True, cblk_w_exp=3, cblk_h_exp=3,
                                    prec_w_exps=[4, 4, 4],
                                    prec_h_exps=[4, 4, 4], num_resolutions=3,
                                    num_layers=2, rates=[16.0, 4.0]))
    data = corrupt_blocks(ht, 0, 16)
    want = np.stack([c.data for c in grok_tpu.decompress(
        data, JDP(strict=False)).components])
    seen = []
    real = pdev.redecode_marked

    def decode(repair: bool):
        def spy(outs, ht_, fn):
            got = real(outs, ht_, fn) if repair else None
            seen.append(got is not None)
            return got
        monkeypatch.setattr(pdev, "redecode_marked", spy)
        if route == "served":
            return _np(api.decompress_device(data, PDP(strict=False),
                                             device="cpu"))
        return _np(api.stage_general_device(data, PDP(strict=False),
                                            device="cpu").run())
    assert (decode(False) != want).sum() > 300
    assert np.array_equal(decode(True), want)
    assert seen == [False, True]
