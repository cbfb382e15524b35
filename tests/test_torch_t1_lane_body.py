"""The Part-1 kernels' lane bodies (grok_tpu_torch/csrc/t1_decode.cu, K3,
and csrc/t1_encode.cu, K5, one code-block per warp) built for the host
with a C++ compiler through the warp shim csrc/t1_warp.cuh (one thread
plays the 32 lanes in turn), and held lane by lane against the plain
versions, `t1_decode_lanes_ref` and `t1_encode_lanes_ref`:

  - 64 seeded lanes of 1x1 to 64x64 (w = 1, h not a multiple of 4,
    all-zero lanes, up to 16 planes);
  - lanes built to chain significance through the significance
    propagation pass: along a stripe's row, across the 32-column ballot
    boundary, down diagonals and columns and over stripe boundaries, so
    that a column missing from a stripe's visit mask changes the codeword;
  - the committed mode-switch vectors (grok_tpu_torch/t1/mq_vectors.npz:
    BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM), also against the scalar
    decodes stored with them;
  - K3 on wide lanes (128 x 8, 16 x 256, 1024 x 4: a stripe walked in
    64-column chunks), coded by the plain K5 (the encode kernel takes
    lanes of up to 64 x 64), significance chains across the chunk edges
    included;
  - K5 on styled lanes (each of the six Part-1 mode switches alone, all
    six, BYPASS with PTERM) of 1x1 to 16x16 against the plain version,
    and of 64 x 64 against the JAX package's C block coder.

Every comparison is exact: codeword bytes, lengths, watermark rows and
the sigtype map for K5, the signed reconstruction for K3.  The plain
versions step every lane in lockstep, so their time follows the largest
lane and plane count of a call: the lanes go through them in groups of
like size.  The file skips, with its reason, when no C++ compiler is
found.

    python -m pytest tests/test_torch_t1_lane_body.py -q
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from grok_tpu_torch.ops import t1_decode as D  # noqa: E402
from grok_tpu_torch.ops import t1_encode as E  # noqa: E402
from grok_tpu_torch.t1 import vectors  # noqa: E402

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "grok_tpu_torch", "csrc")
PAD = 32           # bytes around the body: the window reads 16-byte chunks

HARNESS = r"""
#include "t1_decode.cu"
#include "t1_encode.cu"

#include <vector>

static unsigned char* aligned(std::vector<unsigned char>& v, int bytes)
{
    v.assign(bytes + 16, 0);
    return (unsigned char*)(((uintptr_t)v.data() + 15) & ~(uintptr_t)15);
}

extern "C" int host_t1_decode(const uint8_t* body, long long nb,
                              const int* start, const int* npass,
                              const int* nbps, const int* orient,
                              const int* w, const int* h, const int* style,
                              const int* ptbl, int P, const uint8_t* lut,
                              const uint32_t* mqt, int* out, int nl, int W,
                              int H)
{
    static T1Tables t;
    t1_load_tables(t, lut, mqt);
    std::vector<unsigned char> buf;
    unsigned char* ws = aligned(buf, t1_lane_bytes(W, H, false));
    for (int lane = 0; lane < nl; lane++)
        decode_one(t, ws, lane, body, nb, start, npass, nbps, orient, w, h,
                   style, ptbl, P, out, W, H);
    return 0;
}

extern "C" int host_t1_encode(const int* mneg, const int* orient,
                              const int* numbps, const int* w, const int* h,
                              const int* style, const uint8_t* lut,
                              const uint32_t* mqt,
                              uint8_t* out, int L, int* lengths, int* rates,
                              int R, int8_t* sigtype, int nl, int W, int H)
{
    static T1Tables t;
    t1_load_tables(t, lut, mqt);
    std::vector<unsigned char> buf;
    unsigned char* ws = aligned(buf, t1_lane_bytes(W, H, true));
    for (int lane = 0; lane < nl; lane++)
        encode_one(t, ws, lane, mneg, orient, numbps, w, h, style, out, L,
                   lengths, rates, R, sigtype, W, H);
    return 0;
}
"""


def _cxx():
    for c in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        if c and shutil.which(c):
            return shutil.which(c)
    return None


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = _cxx()
    if cxx is None:
        pytest.skip("no C++ compiler: the lane bodies cannot be built for "
                    "the host")
    d = tmp_path_factory.mktemp("t1_lane_body")
    src, so = d / "harness.cpp", d / "libt1_lane_body.so"
    src.write_text(HARNESS)
    run = subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                          "-I", CSRC, str(src), "-o", str(so)],
                         capture_output=True, text=True)
    assert run.returncode == 0, run.stderr
    lib = ctypes.CDLL(str(so))
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.host_t1_decode.argtypes = [vp, cl, vp, vp, vp, vp, vp, vp, vp, vp,
                                   ci, vp, vp, vp, ci, ci, ci]
    lib.host_t1_encode.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, ci,
                                   vp, vp, ci, vp, ci, ci, ci]
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _tables():
    return (np.ascontiguousarray(D.flag_luts()),
            np.ascontiguousarray(D.mq_table().view(np.uint32)))


def host_encode(lib, ins, L: int, R: int, style=None) -> tuple:
    """The K5 lane body on the host: t1_encode_lanes' outputs as numpy
    (style: None, every lane in the default style, or (NL,) int32)."""
    mneg, ori, nb, w, h = (np.ascontiguousarray(t.numpy()) for t in ins)
    sty = None if style is None else np.ascontiguousarray(style.numpy())
    NL, H, W = mneg.shape
    out = np.zeros((NL, L), np.uint8)
    lens = np.zeros(NL, np.int32)
    rates = np.full((NL, R), -7, np.int32)
    st = np.full((NL, H, W), -7, np.int8)
    lut, mqt = _tables()
    lib.host_t1_encode(_ptr(mneg), _ptr(ori), _ptr(nb), _ptr(w), _ptr(h),
                       None if sty is None else _ptr(sty), _ptr(lut),
                       _ptr(mqt), _ptr(out), L, _ptr(lens),
                       _ptr(rates), R, _ptr(st), NL, W, H)
    return out, lens, rates, st


def host_decode(lib, lanes, W: int, H: int) -> np.ndarray:
    """The K3 lane body on the host: t1_decode_lanes' output as numpy."""
    body, *cols, ptbl = (np.ascontiguousarray(t.numpy()) for t in lanes)
    padded = np.zeros(body.size + 2 * PAD, np.uint8)
    padded[PAD:PAD + body.size] = body
    cols = [np.ascontiguousarray(c, np.int32) for c in cols]
    out = np.full((cols[0].size, H, W), -7, np.int32)
    lut, mqt = _tables()
    lib.host_t1_decode(padded.ctypes.data + PAD, body.size,
                       *(_ptr(c) for c in cols), _ptr(ptbl), ptbl.shape[1],
                       _ptr(lut), _ptr(mqt), _ptr(out), cols[0].size, W, H)
    return out


def _col(v):
    return torch.tensor(list(v), dtype=torch.int32)


def _lanes(blocks, W: int, H: int) -> tuple:
    """K5's inputs for [(mag, neg)] blocks in W x H lanes."""
    mneg = np.zeros((len(blocks), H, W), np.int32)
    for j, (m, n) in enumerate(blocks):
        mneg[j, :m.shape[0], :m.shape[1]] = (m << 1) | (n & (m > 0))
    return (torch.from_numpy(mneg), _col(i % 4 for i in range(len(blocks))),
            _col(int(m.max()).bit_length() if m.size else 0
                 for m, _n in blocks),
            _col(m.shape[1] for m, _n in blocks),
            _col(m.shape[0] for m, _n in blocks))


def _decode_lanes(ins, out, lens) -> tuple:
    """K3's lanes for K5's codewords: one segment each, every pass."""
    _m, ori, nb, w, h = ins
    n = lens.shape[0]
    body = torch.cat([out[j, 1:1 + int(lens[j])] for j in range(n)]
                     + [torch.zeros(1, dtype=torch.uint8)])
    start = (torch.cumsum(lens, 0) - lens).to(torch.int32)
    zero = torch.zeros_like(lens)
    ptbl = torch.stack([zero, lens, zero], 1)[:, None].contiguous()
    return (body, start, (3 * nb - 2).clamp(min=0).to(torch.int32), nb, ori,
            w, h, zero, ptbl)


def _round_trip(lib, blocks, W: int, H: int):
    """K5 and K3 lane bodies against the plain versions on the blocks in
    W x H lanes; the decode must also give back the source."""
    ins = _lanes(blocks, W, H)
    nbmax = max(1, int(ins[2].max()))
    L, R = W * H * (nbmax + 2) // 2 + 64, 3 * nbmax - 2
    L += -L % 4
    got = host_encode(lib, ins, L, R)
    ref = E.t1_encode_lanes_ref(*ins, L, R)
    lens = ref[1]
    assert (lens >= 0).all()
    assert np.array_equal(got[1], lens.numpy())
    assert np.array_equal(got[2], ref[2].numpy())
    assert np.array_equal(got[3], ref[3].numpy())
    for j in range(len(blocks)):
        n = 1 + int(lens[j])
        assert np.array_equal(got[0][j, :n], ref[0][j, :n].numpy()), j
    lanes = _decode_lanes(ins, ref[0], lens)
    dec = host_decode(lib, lanes, W, H)
    assert np.array_equal(dec, D.t1_decode_lanes_ref(*lanes, W, H).numpy())
    assert np.array_equal(np.abs(dec) >> 1, ins[0].numpy() >> 1)
    assert np.array_equal(dec < 0, (ins[0].numpy() & 1) == 1)


def _seeded(seed: int, n: int, side: int, maxnb: int, first: int):
    """n blocks of 1x1 to side x side: lane `first` 1x1, the next w = 1,
    the next all zero, heights not a multiple of 4 among the rest; up to
    maxnb planes."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        w = 1 + int(rng.integers(0, side))
        h = 1 + int(rng.integers(0, side))
        if i == first:
            w = h = 1
        elif i == first + 1:
            w = 1
        elif i == first + 3:
            h = side - 1 if side > 4 else 3
        nb = 1 + (i * 5) % maxnb
        mag = rng.integers(0, 1 << nb, (h, w))
        mag[rng.random((h, w)) < rng.uniform(0.1, 0.9)] = 0
        if i == first + 2:
            mag[:] = 0
        out.append((mag, rng.random((h, w)) < 0.5))
    return out


# (seed, lanes, block side, planes): 64 lanes in all, the plain versions'
# lockstep cost kept small by grouping like sizes
SEEDED = [(1, 24, 16, 16), (2, 24, 32, 4), (3, 16, 64, 1)]


@pytest.mark.parametrize("seed, n, side, maxnb", SEEDED)
def test_lane_bodies_match_plain_versions_on_seeded_lanes(lib, seed, n, side,
                                                          maxnb):
    blocks = _seeded(seed, n, side, maxnb, 0)
    if maxnb > 15:
        # lanes past the 16-bit shared-memory words take the device-memory
        # path of both lane bodies
        assert max(int(m.max()).bit_length() for m, _n in blocks) > 15
    _round_trip(lib, blocks, side, side)


def _chains(W: int, H: int):
    """Blocks in W x H lanes whose second plane's samples become
    significant one after another in the SPP, each only through the one
    before it."""
    out = []

    def block(h, w, path, seed=(0, 0)):
        mag = np.zeros((h, w), np.int64)
        for y, x in path:
            mag[y, x] = 2                      # bit 1: the SPP of plane 1
        mag[seed] = 4                          # bit 2: the MSB cleanup
        out.append((mag, np.indices((h, w)).sum(0) % 3 == 1))

    def bounce(x, top):                        # 0, 1, .., top, top - 1, ..
        x %= 2 * top
        return x if x <= top else 2 * top - x

    block(4, W, [(0, x) for x in range(1, W)])                  # a row
    block(8, W, [(3, x) for x in range(1, W)], (3, 0))          # row 3
    block(1, W, [(0, x) for x in range(1, W)])                  # h = 1
    block(H, W, [(bounce(x, H - 1), x) for x in range(1, W)])   # diagonals
    block(H, W, [(y, 0) for y in range(1, H)])                  # a column
    block(H, 8, [(y, 1 + y % 7) for y in range(1, H)])          # zigzag
    block(H - 3, W, [(bounce(x // 2, H - 4), x)                 # a snake
                     for x in range(1, W)])
    block(H, W, [(y, x) for y in range(H) for x in range(W)     # a mesh
                 if (x + y) % 2])
    return out


@pytest.mark.parametrize("W, H", [(16, 16), (64, 16)])
def test_lane_bodies_follow_significance_chains(lib, W, H):
    _round_trip(lib, _chains(W, H), W, H)


def test_decode_lane_body_on_mode_switch_vectors(lib):
    v = vectors.load()
    lanes = vectors.k3_lanes(v, "cpu")
    got = host_decode(lib, lanes, vectors.SIDE, vectors.SIDE)
    assert np.array_equal(got, v["mag2"])
    assert np.array_equal(got, D.t1_decode_lanes_ref(
        *lanes, vectors.SIDE, vectors.SIDE).numpy())


def _wide_round_trip(lib, blocks, W: int, H: int):
    """K5's lane body on W x H lanes (W or H over 64: stripes walked in
    64-column chunks) against the plain version, codewords, lengths,
    watermarks and sigtype; then K3's lane body on the plain K5's
    codewords against the plain version and the source."""
    ins = _lanes(blocks, W, H)
    nbmax = max(1, int(ins[2].max()))
    L, R = W * H * (nbmax + 2) // 2 + 64, 3 * nbmax - 2
    L += -L % 4
    out, lens, rates, st = E.t1_encode_lanes_ref(*ins, L, R)
    got = host_encode(lib, ins, L, R)
    assert np.array_equal(got[1], lens.numpy())
    assert np.array_equal(got[2], rates.numpy())
    assert np.array_equal(got[3], st.numpy())
    for j in range(len(blocks)):
        n = 1 + int(lens[j])
        assert np.array_equal(got[0][j, :n], out[j, :n].numpy()), j
    lanes = _decode_lanes(ins, out, lens)
    dec = host_decode(lib, lanes, W, H)
    assert np.array_equal(dec, D.t1_decode_lanes_ref(*lanes, W, H).numpy())
    assert np.array_equal(np.abs(dec) >> 1, ins[0].numpy() >> 1)
    assert np.array_equal(dec < 0, (ins[0].numpy() & 1) == 1)


@pytest.mark.parametrize("W, H", [(128, 8), (16, 256), (1024, 4)])
def test_decode_lane_body_on_wide_lanes(lib, W, H):
    rng = np.random.default_rng(W + H)
    blocks = []
    for i in range(3):
        w = W if i == 0 else int(rng.integers(1, W + 1))
        h = H if i == 0 else int(rng.integers(1, H + 1))
        mag = rng.integers(0, 8, (h, w))
        mag[rng.random((h, w)) < 0.6] = 0
        blocks.append((mag, rng.random((h, w)) < 0.5))
    if W > 64:
        # significance chains along rows through the 64-column chunk
        # edges (a missed carry changes the codeword)
        blocks += [b for b in _chains(W, 8)[:3] if b[0].shape[0] <= H]
    _wide_round_trip(lib, blocks, W, H)


# the six Part-1 mode switches alone, all of them, and BYPASS with PTERM
STYLES = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x3F, 0x11]


def styled_blocks(seed: int, side: int, maxnb: int, per: int = 2):
    """per blocks of 1x1 to side x side for each style of STYLES (the
    first of each style with a full plane count, so BYPASS reaches its
    raw passes): [(mag, neg)] and the styles."""
    rng = np.random.default_rng(seed)
    blocks, styles = [], []
    for st in STYLES:
        for i in range(per):
            h = side if i == 0 else 1 + int(rng.integers(0, side))
            w = side if i == 0 else 1 + int(rng.integers(0, side))
            nb = maxnb if i == 0 else 1 + int(rng.integers(0, maxnb))
            mag = rng.integers(0, 1 << nb, (h, w))
            mag[rng.random((h, w)) < rng.uniform(0.4, 0.95)] = 0
            mag[h // 2, w // 2] = (1 << nb) - 1
            blocks.append((mag, rng.random((h, w)) < 0.5))
            styles.append(st)
    return blocks, styles


# (seed, block side, planes): lanes of 1x1 to 16x16
STYLED = [(11, 4, 8), (12, 16, 9)]


def _styled_ins(blocks, styles, side: int) -> tuple:
    ins = _lanes(blocks, side, side)
    nbmax = max(1, int(ins[2].max()))
    R = 3 * nbmax - 2
    L = side * side * (nbmax + 2) // 2 + 64 + 8 * R
    return ins, _col(styles), L + -L % 4, R


@pytest.mark.parametrize("seed, side, maxnb", STYLED)
def test_encode_lane_body_matches_plain_version_on_styled_lanes(
        lib, seed, side, maxnb):
    blocks, styles = styled_blocks(seed, side, maxnb)
    ins, sty, L, R = _styled_ins(blocks, styles, side)
    out, lens, rates, st = E.t1_encode_lanes_ref(*ins, L, R, sty)
    got = host_encode(lib, ins, L, R, sty)
    assert (lens >= 0).all()
    assert np.array_equal(got[1], lens.numpy())
    assert np.array_equal(got[2], rates.numpy())
    assert np.array_equal(got[3], st.numpy())
    for j in range(len(blocks)):
        n = 1 + int(lens[j])
        assert np.array_equal(got[0][j, :n], out[j, :n].numpy()), j


def test_encode_lane_body_matches_c_coder_on_styled_64x64_lanes(lib):
    """The lane body on 64 x 64 lanes of every style against the JAX
    package's C block coder, whose equality with the plain version on
    such lanes tests/test_torch_enc_modes.py holds (the plain version's
    lockstep cost at this size is paid once, there)."""
    native = pytest.importorskip("grok_tpu.native")
    if not native.available():
        pytest.skip("no C toolchain for the JAX package's block coder")
    blocks, styles = styled_blocks(13, 64, 6, 1)
    ins, sty, L, R = _styled_ins(blocks, styles, 64)
    out, lens, rates, _st = host_encode(lib, ins, L, R, sty)
    want = native.encode_tile_blocks(
        [dict(mag=m, neg=n, orient=j % 4, style=st)
         for j, ((m, n), st) in enumerate(zip(blocks, styles))])
    for j, (e, st) in enumerate(zip(want, styles)):
        total = int(lens[j])
        assert bytes(out[j, 1:1 + total]) == e.data, (j, st)
        rr, terms, _sl, _sp = E.pass_records(rates[j], int(ins[2][j]),
                                             total, st)
        assert rr == [p.rate for p in e.passes], (j, st)
        assert terms == [p.term for p in e.passes], (j, st)
