"""The HT block decoders' lane bodies (grok_tpu_torch/csrc/ht_decode.cu, K1
and K2, one code-block per warp) built for the host with a C++ compiler
through the warp shim csrc/t1_warp.cuh (one thread plays the 32 lanes in
turn), and held lane by lane against the plain version,
`ht_decode_lanes_ref`:

  - seeded lanes of 1x1 to 64x64 (w = 1, h not a multiple of 4, all-zero
    and invalid lanes) coded by the plain encoders at cleanup planes
    0..3, decoded by K1 and by K2 at 1, 2 and 3 passes, under the default
    tables and under normative-shaped ones (two table families, EMB
    symbols, flipped UVLC prefix polarity), with stream rows at every
    byte alignment;
  - MEL chains (long full runs, partial runs that carry across quad
    rows) and the initial-row UVLC rules (the pair's MEL event, and the
    3-bit first prefix that implies u1 <= 2);
  - corrupt and truncated lanes: streams cut short (reads past the row
    give 1-bits) and random bytes that meet invalid codewords (flagged
    lanes, all zeros);
  - lanes built to chain SigProp significance along a stripe's row,
    across the boundary between two threads' columns and across column
    32, down a column, over stripe boundaries and back up a stripe;
  - a few lanes against grok_tpu.t1ht.scalar.ht_decode_block directly;
  - lanes whose bytes were flipped (tests/test_torch_strict.py): the
    error codes of invalid codewords and exponent bounds over 40, U up
    to 40 and UVLC escapes, reads past the segments' ends, on lanes up
    to 32 x 32 (the two-warp design) and on wide ones, 128 x 8,
    16 x 128 and 128 x 16 (the wide design), also intact.

Every comparison is exact over every output sample, the padding
included (the host output buffers start dirty).  The file skips, with its
reason, when no C++ compiler is found.

    python -m pytest tests/test_torch_ht_decode_lane_body.py -q
"""

import ctypes
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from grok_tpu_torch.ops import ht_decode as D  # noqa: E402
from grok_tpu_torch.ops import ht_encode as E  # noqa: E402
from test_torch_ht_encode import normative_shaped  # noqa: E402,F401
from test_torch_ht_lane_body import (CSRC, _caps, _chains,  # noqa: E402
                                     _cxx, _lanes, _seeded)

HARNESS = r"""
#include "ht_decode.cu"

#include <vector>

extern "C" int host_ht_decode(const uint8_t* ms, int lms, const uint8_t* mel,
                              int lmel, const uint8_t* vlc, int lvlc,
                              const int* p, const int* w, const int* h,
                              const int* valid, const int* lut, int lut_n,
                              int symb, int nfam, int pxor, int* out, int nl,
                              int W, int H, const uint8_t* sp, int lsp,
                              const uint8_t* mr, int lmr, const int* npass,
                              int* err)
{
    // the CTA's tables, and the lane's workspace, dirty as a CTA's shared
    // memory may be but for its first word (the kernel zeroes it)
    std::vector<int> tab(lut_n + 768, -1);
    build_tables(lut, lut_n, symb, pxor, tab.data());
    const bool wide = W > 64 || H > 64;
    std::vector<unsigned char> buf(
        (wide ? ht_wide_bytes(W, H) : HT_REF_BYTES) + 16, 0xA5);
    unsigned char* ws = (unsigned char*)(((uintptr_t)buf.data() + 15)
                                         & ~(uintptr_t)15);
    for (int lane = 0; lane < nl; lane++) {
        if (wide) {
            decode_wide_one(tab.data(), nfam, pxor, ws, lane, ms, lms, mel,
                            lmel, vlc, lvlc, p, w, h, valid, out, W, H, sp,
                            lsp, mr, lmr, npass, err);
            continue;
        }
        *(int*)ws = 0;
        for (int role = 0; role < 2; role++)
            decode_one(role, tab.data(), lut_n, nfam, ws, lane, ms, lms, mel,
                       lmel, vlc, lvlc, p, w, h, valid, out, W, H, sp, lsp,
                       mr, lmr, npass, err);
    }
    return 0;
}

// the int64 re-decode of marked lanes: every lane through the wide design
// with long long output
extern "C" int host_ht_decode_i64(const uint8_t* ms, int lms,
                                  const uint8_t* mel, int lmel,
                                  const uint8_t* vlc, int lvlc, const int* p,
                                  const int* w, const int* h,
                                  const int* valid, const int* lut,
                                  int lut_n, int symb, int nfam, int pxor,
                                  long long* out, int nl, int W, int H,
                                  const uint8_t* sp, int lsp,
                                  const uint8_t* mr, int lmr,
                                  const int* npass, int* err)
{
    std::vector<int> tab(lut_n + 768, -1);
    build_tables(lut, lut_n, symb, pxor, tab.data());
    std::vector<unsigned char> buf(ht_wide_bytes(W, H) + 16, 0xA5);
    unsigned char* ws = (unsigned char*)(((uintptr_t)buf.data() + 15)
                                         & ~(uintptr_t)15);
    for (int lane = 0; lane < nl; lane++)
        decode_wide_one(tab.data(), nfam, pxor, ws, lane, ms, lms, mel,
                        lmel, vlc, lvlc, p, w, h, valid, out, W, H, sp, lsp,
                        mr, lmr, npass, err);
    return 0;
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = _cxx()
    if cxx is None:
        pytest.skip("no C++ compiler: the lane bodies cannot be built for "
                    "the host")
    d = tmp_path_factory.mktemp("ht_decode_lane_body")
    src, so = d / "harness.cpp", d / "libht_decode_lane_body.so"
    src.write_text(HARNESS)
    run = subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                          "-I", CSRC, str(src), "-o", str(so)],
                         capture_output=True, text=True)
    assert run.returncode == 0, run.stderr
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.host_ht_decode.argtypes = [vp, ci, vp, ci, vp, ci, vp, vp, vp, vp,
                                   vp, ci, ci, ci, ci, vp, ci, ci, ci, vp,
                                   ci, vp, ci, vp, vp]
    lib.host_ht_decode_i64.argtypes = lib.host_ht_decode.argtypes
    return lib


def _rows(t, shift: int):
    """A (NL, L+1) uint8 tensor as a buffer whose row 0 starts `shift`
    bytes past a 16-byte boundary, with slack after the last row (the
    lane body loads the aligned words that cover a row)."""
    a = np.ascontiguousarray(t.numpy())
    buf = np.zeros(a.size + shift + 16, np.uint8)
    buf[shift:shift + a.size] = a.reshape(-1)
    return buf, buf.ctypes.data + shift


def host_decode(lib, lanes, W: int, H: int, shift: int = 0,
                i64: bool = False):
    """The K1 lane body (K2 with sp, mr, npass in lanes; the wide lane
    body for W or H over 64, and for every lane with i64, its int64
    output) on the host: ht_decode_lanes' output, the planes and the
    error codes."""
    ms, mel, vlc, p, w, h, valid = lanes[:7]
    refine = len(lanes) == 10
    keep, ptr = [], {}
    for name, t in (("ms", ms), ("mel", mel), ("vlc", vlc)) + (
            (("sp", lanes[7]), ("mr", lanes[8])) if refine else ()):
        buf, ptr[name] = _rows(t, shift)
        keep.append(buf)
    ints = [np.ascontiguousarray(t.numpy(), np.int32)
            for t in (p, w, h, valid) + ((lanes[9],) if refine else ())]
    NL = ms.shape[0]
    out = np.full((NL, H, W), -0x5A5A5A5A, np.int64 if i64 else np.int32)
    err = np.full(NL, -7, np.int32)
    _, symb, nfam, pxor = D.vlc_dec_lut()
    lut = np.ascontiguousarray(D.vlc_dec_lut_marked(), np.int32)
    (lib.host_ht_decode_i64 if i64 else lib.host_ht_decode)(
        ptr["ms"], ms.shape[1], ptr["mel"], mel.shape[1], ptr["vlc"],
        vlc.shape[1], *(a.ctypes.data for a in ints[:4]), lut.ctypes.data,
        lut.size, symb, nfam, pxor, out.ctypes.data, NL, W, H,
        ptr["sp"] if refine else None, lanes[7].shape[1] if refine else 0,
        ptr["mr"] if refine else None, lanes[8].shape[1] if refine else 0,
        ints[4].ctypes.data if refine else None, err.ctypes.data)
    return torch.from_numpy(out), torch.from_numpy(err)


def _check(lib, lanes, W: int, H: int, shift: int = 0):
    """The lane body equal to the plain version on every output sample and
    error code; returns the host body's output."""
    got, err = host_decode(lib, lanes, W, H, shift)
    want, werr = D.ht_decode_lanes_ref(*lanes[:7], W, H, *lanes[7:])
    assert torch.equal(err, werr)
    assert torch.equal(got, want)
    return got


def _col(v):
    return torch.tensor(list(v), dtype=torch.int32)


def _coded(enc, W: int, H: int, refine: bool):
    """Decode lanes of the plain encoders' clean streams for enc = (mneg,
    p, w, h, valid): (ms, mel, vlc, p, w, h, valid), and with refine the
    SigProp and MagRef streams (sp, mr) after them."""
    caps = _caps(W, H)
    streams, bits = E.ht_encode_lanes_ref(*enc, *caps[:3])
    if refine:
        sp, mr, rbits, _ns = E.ht_refine_lanes_ref(*enc, *caps[3:])
        streams, bits = torch.cat([streams, sp, mr], 1), torch.cat(
            [bits, rbits])
    else:
        caps = caps[:3]
    assert (bits >= 0).all()
    used = E.clear_unused(streams, bits, *caps[:-1])
    starts = np.cumsum((0,) + caps)
    cut = [torch.nn.functional.pad(used[:, a:b], (0, 1)).contiguous()
           for a, b in zip(starts[:-1], starts[1:])]
    return tuple(cut[:3]) + tuple(enc[1:]) + tuple(cut[3:])


def _k2(coded, npass):
    """K2's lanes: the coded lanes with their pass counts."""
    return coded[:7] + (coded[7], coded[8], _col(npass))


# (tables, seed, lanes, block side): like sizes together, the plain
# SigProp steps every position of the block in turn
SEEDED = [(t, *g) for t in ("default", "normative")
          for g in ((1, 24, 8), (2, 16, 24), (3, 8, 33))] \
    + [("default", 4, 5, 64)]


@pytest.mark.parametrize("tables, seed, n, side", SEEDED)
def test_lane_bodies_match_plain_version_on_seeded_lanes(lib, request,
                                                         tables, seed, n,
                                                         side):
    if tables == "normative":
        request.getfixturevalue("normative_shaped")
    blocks = _seeded(seed + 10 * (tables == "normative"), n, side,
                     tables == "normative")
    p = [i % 4 for i in range(n)]
    valid = [int(i != 5) for i in range(n)]
    enc = _lanes(blocks, side, side, p, valid)
    coded = _coded(enc, side, side, True)
    got = _check(lib, coded[:7], side, side, shift=seed % 4)
    assert got[[i for i in range(n) if i not in (2, 5)]].any()
    assert not got[2].any() and not got[5:6].any()
    # every pair of p and a pass count over the lanes
    got2 = _check(lib, _k2(coded, [3 - i % 3 for i in range(n)]), side,
                  side, shift=(seed + 1) % 4)
    # the refinement changed some lanes
    assert not torch.equal(got, got2)


def _mel_blocks(W: int, H: int):
    """Blocks whose MEL events run long: a few isolated significant
    samples in a sea of zeros (full runs up to the top MEL state, partial
    runs that carry across quad rows), a checkerboard of context-0 quads
    (events one and zero in turn), and initial quad rows whose pairs take
    the pair's MEL event with both u > 2, with u0 > 2 >= u1 (the 3-bit
    first prefix that implies u1 <= 2) and with both u <= 2."""
    rng = np.random.default_rng(21)
    out = []

    def block(mag):
        out.append((mag, rng.random(mag.shape) < 0.5))

    mag = np.zeros((H, W), np.int64)
    for y, x in ((0, 0), (H - 1, W - 1), (H // 2, 3), (5, W // 2 + 1)):
        mag[y, x] = 1 + int(rng.integers(0, 200))
    block(mag)
    mag = np.zeros((H, W), np.int64)
    mag[::2, ::2] = np.indices((H // 2, W // 2)).sum(0) % 2 * 7
    block(mag)
    mag = np.zeros((H, W), np.int64)
    mag[::4, ::6] = 9                   # runs broken every other quad row
    block(mag)
    for u0, u1 in ((40, 40), (100, 3), (2, 3), (3, 100), (1, 1)):
        mag = np.zeros((H, W), np.int64)
        mag[:2, 0:W:4] = u0             # quad 0 of each pair
        mag[:2, 2:W:4] = u1             # quad 1 of each pair
        mag[4:, :] = rng.integers(0, 4, (H - 4, W))
        block(mag)
    return out


@pytest.mark.parametrize("tables", ["default", "normative"])
def test_lane_bodies_follow_mel_chains_and_initial_row_rules(lib, request,
                                                             tables):
    if tables == "normative":
        request.getfixturevalue("normative_shaped")
    W, H = 64, 24
    blocks = _mel_blocks(W, H)
    n = len(blocks)
    enc = _lanes(blocks, W, H, [0] * n)
    coded = _coded(enc, W, H, False)
    got = _check(lib, coded, W, H, shift=3)
    for j, (mag, neg) in enumerate(blocks):        # lossless at p = 0
        assert np.array_equal(got[j].numpy(),
                              np.where(neg & (mag > 0), -2 * mag, 2 * mag))


def _corrupt(coded, rng):
    """The coded lanes with their streams cut short (every byte from a
    random point on zeroed) on even lanes and overwritten with random,
    0xFF and 0x55 bytes on odd ones, SigProp and MagRef included."""
    out = list(coded)
    idx = list(range(3)) + ([7, 8] if len(coded) == 9 else [])
    for s in idx:
        t = out[s].clone()
        n, L1 = t.shape
        for j in range(n):
            if j % 2 == 0:
                t[j, int(rng.integers(0, max(L1 // 4, 2))):] = 0
            else:
                fill = (j // 2) % 3
                t[j] = torch.from_numpy(
                    rng.integers(0, 256, L1, dtype=np.uint8) if fill == 0
                    else np.full(L1, (0xFF, 0x55)[fill - 1], np.uint8))
        out[s] = t
    return tuple(out)


def test_lane_bodies_on_corrupt_and_truncated_lanes(lib):
    side, n = 32, 12
    blocks = _seeded(8, n, side, False)
    enc = _lanes(blocks, side, side, [1 + i % 3 for i in range(n)])
    coded = _corrupt(_coded(enc, side, side, True), np.random.default_rng(9))
    got = _check(lib, coded[:7], side, side, shift=1)
    # random bytes meet an invalid CxtVLC codeword: those lanes are
    # flagged and all zeros, as the scalar decoder gives them; the others
    # decode
    _, err = D.ht_decode_lanes_ref(*coded[:7], side, side)
    assert (err == D.ERR_VLC).any() and not got[err != 0].any()
    assert got[err == 0].any()
    _check(lib, _k2(coded, [1 + i % 3 for i in range(n)]), side, side,
           shift=2)
    # rows of one byte: every read past the first byte gives 0
    short = tuple(t[:, :1].contiguous() for t in coded[:3]) + coded[3:7] \
        + tuple(t[:, :1].contiguous() for t in coded[7:9]) \
        + (_col([3] * n),)
    _check(lib, short, side, side)


@pytest.mark.parametrize("W, H, p", [(16, 11, 1), (64, 16, 2)])
def test_lane_bodies_follow_sigprop_chains(lib, W, H, p):
    blocks = _chains(W, H, p)
    n = len(blocks)
    enc = _lanes(blocks, W, H, [p] * n)
    coded = _coded(enc, W, H, True)
    for npass in (2, 3):
        got = _check(lib, _k2(coded, [npass] * n), W, H, shift=npass)
        # the chains that stay causal: every path sample significant
        for j in (0, 1, 2, 4, 8, 10):
            mag = blocks[j][0]
            assert np.array_equal(got[j, :mag.shape[0], :mag.shape[1]]
                                  .numpy() != 0, mag > 0), (npass, j)


def test_lane_bodies_match_scalar_decoder(lib):
    """A few lanes against grok_tpu.t1ht.scalar.ht_decode_block: blocks
    coded by the scalar coder with the ht_planes extension and truncated
    to 1, 2 and 3 passes, their clean streams split by the scalar wire
    reader."""
    from test_torch_ht_refine import _dec_lanes, _refined_jobs
    jobs, refs = _refined_jobs(60, 2)
    jobs, refs = jobs[:24], refs[:24]
    _, t = _dec_lanes(jobs)
    t = [x[:len(jobs)].contiguous() for x in t]
    got = host_decode(lib, t, 32, 32, shift=1)[0].numpy()
    assert any(j["numpasses"] == 3 for j in jobs)
    for i, (j, (m2, ng)) in enumerate(zip(jobs, refs)):
        v = got[i, :j["h"], :j["w"]]
        assert np.array_equal(np.abs(v), m2), i
        assert np.array_equal(v < 0, ng), i
        assert not got[i, j["h"]:].any() and not got[i, :, j["w"]:].any()
    # the cleanup-only route (K1) on the same lanes' first pass
    first = [i for i, j in enumerate(jobs) if j["numpasses"] == 1]
    k1 = host_decode(lib, [x[first] for x in t[:7]], 32, 32)[0].numpy()
    for r, i in enumerate(first):
        j, (m2, ng) = jobs[i], refs[i]
        assert np.array_equal(np.abs(k1[r, :j["h"], :j["w"]]), m2), i


@pytest.mark.parametrize("seed, count, W, H, flips", [
    (17, 48, 16, 16, True), (6, 24, 32, 32, True), (7, 12, 128, 8, True),
    (8, 8, 16, 128, True), (9, 8, 128, 16, False)])
def test_lane_bodies_on_flipped_and_wide_lanes(lib, seed, count, W, H,
                                               flips):
    import grok_tpu.t1ht.scalar as scalar
    from test_torch_strict import flipped_jobs, port_lanes
    jobs = [j for j in flipped_jobs(seed, count, W, H, flips)
            if scalar.parse_cleanup(j["data"], j["seg_lens"][0])]
    lanes = port_lanes(jobs, W, H)
    got = _check(lib, lanes[:7], W, H, shift=1)     # K1 on every cleanup
    _check(lib, lanes, W, H, shift=3)               # K2 with its passes
    _, err = D.ht_decode_lanes_ref(*lanes[:7], W, H)
    assert got[err == 0].any()
    assert (err != 0).any() == flips or W > 64


@pytest.mark.parametrize("seed, W, H", [(17, 16, 16), (12, 16, 16),
                                        (7, 128, 8)])
def test_int64_lane_body_on_marked_lanes(lib, seed, W, H):
    """The mark of lanes whose magnitudes may pass int32 (MARK_I64) and
    the int64 re-decode (the wide design with long long output, K1 and
    K2) equal the plain version's int64 mode on flipped lanes, whose
    scalar magnitudes reach 2^31 and more on some decoded lanes."""
    import grok_tpu.t1ht.scalar as scalar
    from test_torch_strict import flipped_jobs, port_lanes
    jobs = [j for j in flipped_jobs(seed, 48 if W <= 64 else 12, W, H)
            if scalar.parse_cleanup(j["data"], j["seg_lens"][0])]
    lanes = port_lanes(jobs, W, H)
    marked = 0
    for la in (lanes[:7], lanes):
        got, err = host_decode(lib, la, W, H, shift=2, i64=True)
        want, werr = D.ht_decode_lanes_ref(*la[:7], W, H, *la[7:], i64=True)
        assert torch.equal(err, werr)
        assert torch.equal(got, want)
        marked += int((err == D.MARK_I64).sum())
    if seed == 17:
        assert marked
