"""The HT block encoders' lane bodies (grok_tpu_torch/csrc/ht_encode.cu, K4
and K4r, one code-block per warp) built for the host with a C++ compiler
through the warp shim csrc/t1_warp.cuh (one thread plays the 32 lanes in
turn), and held lane by lane against the plain versions,
`ht_encode_lanes_ref` and `ht_refine_lanes_ref`:

  - seeded lanes of 1x1 to 64x64 (w = 1, h not a multiple of 4, all-zero
    and invalid lanes) at cleanup planes 0..3, under the default tables
    and under normative-shaped ones (two table families, EMB symbols,
    flipped UVLC prefix polarity);
  - lanes whose streams overflow their capacities (-1 bits);
  - lanes built to chain SigProp significance along a stripe's row,
    across the boundary between two threads' columns and across column
    32, down a column, over stripe boundaries and back up a stripe, so
    that a wrong composition of the columns' maps or a missing causal
    neighbour changes the stream;
  - a few lanes against grok_tpu.t1ht.scalar directly.

Every comparison is exact: the used bytes of every stream, the bit
counts and the ns map (written whole: the host buffers start dirty).
The file skips, with its reason, when no C++ compiler is found.

    python -m pytest tests/test_torch_ht_lane_body.py -q
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import grok_tpu.t1ht.scalar as scalar  # noqa: E402
from grok_tpu_torch.ops import ht_encode as E  # noqa: E402
from test_torch_ht_encode import (_scalar_clean,  # noqa: E402,F401
                                  normative_shaped)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "grok_tpu_torch", "csrc")

HARNESS = r"""
#include "ht_encode.cu"

#include <vector>

extern "C" int host_ht_encode(const int* mneg, const int* p, const int* w,
                              const int* h, const int* valid, const int* lut,
                              int symb, int nfam, int pxor, uint8_t* out,
                              int row, int lms, int lmel, int lvlc, int lsp,
                              int lmr, int* bits, uint8_t* ns, int nl, int W,
                              int H)
{
    // the warp's workspace, dirty as a CTA's shared memory may be
    const bool wide = W > 64 || H > 64;
    std::vector<unsigned char> buf(
        (wide ? ht_enc_wide_bytes(W, H) : HT_REF_BYTES) + 16, 0xA5);
    unsigned char* ws = (unsigned char*)(((uintptr_t)buf.data() + 15)
                                         & ~(uintptr_t)15);
    for (int lane = 0; lane < nl; lane++)
        if (wide)
            encode_wide_one(lut, symb, nfam, pxor, ws, lane, mneg, p, w, h,
                            valid, out, row, lms, lmel, lvlc, lsp, lmr, bits,
                            ns, nl, W, H);
        else
            encode_one(lut, symb, nfam, pxor, ws, lane, mneg, p, w, h, valid,
                       out, row, lms, lmel, lvlc, lsp, lmr, bits, ns, nl, W,
                       H);
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
    d = tmp_path_factory.mktemp("ht_lane_body")
    src, so = d / "harness.cpp", d / "libht_lane_body.so"
    src.write_text(HARNESS)
    run = subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                          "-I", CSRC, str(src), "-o", str(so)],
                         capture_output=True, text=True)
    assert run.returncode == 0, run.stderr
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.host_ht_encode.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, vp,
                                   ci, ci, ci, ci, ci, ci, vp, vp, ci, ci,
                                   ci]
    return lib


def host_encode(lib, lanes, caps, refine: bool):
    """The K4 (K4r) lane body on the host: ht_encode_lanes' outputs."""
    mneg, p, w, h, valid = (np.ascontiguousarray(t.numpy()) for t in lanes)
    NL, H, W = mneg.shape
    lms, lmel, lvlc, lsp, lmr = caps if refine else (*caps, 0, 0)
    row = lms + lmel + lvlc + lsp + lmr
    out = np.full((NL, row), 0xA5, np.uint8)
    bits = np.full((5 if refine else 3, NL), -7, np.int32)
    ns = np.full((NL, H, W), 7, np.uint8) if refine else None
    lut, symb, nfam, pxor = E.vlc_enc_lut()
    lut = np.ascontiguousarray(lut, np.int32)
    lib.host_ht_encode(*(a.ctypes.data for a in (mneg, p, w, h, valid, lut)),
                       symb, nfam, pxor, out.ctypes.data, row, lms, lmel,
                       lvlc, lsp, lmr, bits.ctypes.data,
                       None if ns is None else ns.ctypes.data, NL, W, H)
    got = (torch.from_numpy(out), torch.from_numpy(bits))
    return got + (torch.from_numpy(ns),) if refine else got


def plain(lanes, caps, refine: bool):
    streams, bits = E.ht_encode_lanes_ref(*lanes, *caps[:3])
    if not refine:
        return streams, bits
    sp, mr, rb, ns = E.ht_refine_lanes_ref(*lanes, *caps[3:])
    return torch.cat([streams, sp, mr], 1), torch.cat([bits, rb]), ns


def _check(lib, lanes, caps, refine: bool):
    """The lane body equal to the plain version on every lane: bit
    counts, used stream bytes, ns.  Returns the host body's outputs."""
    got = host_encode(lib, lanes, caps, refine)
    ref = plain(lanes, caps, refine)
    assert torch.equal(got[1], ref[1])
    cut = caps[:-1]
    assert torch.equal(E.clear_unused(got[0], got[1], *cut),
                       E.clear_unused(ref[0], ref[1], *cut))
    if refine:
        assert torch.equal(got[2], ref[2])
    return got


def _col(v):
    return torch.tensor(list(v), dtype=torch.int32)


def _lanes(blocks, W, H, p, valid=None):
    """(mneg, p, w, h, valid) for [(mag, neg)] blocks in W x H lanes."""
    mneg = np.zeros((len(blocks), H, W), np.int32)
    for j, (m, n) in enumerate(blocks):
        mneg[j, :m.shape[0], :m.shape[1]] = (m << 1) | (n & (m > 0))
    return (torch.from_numpy(mneg), _col(p), _col(m.shape[1] for m, _ in
                                                  blocks),
            _col(m.shape[0] for m, _ in blocks),
            _col(valid if valid is not None else [1] * len(blocks)))


def _caps(W: int, H: int, mb: int = 24) -> tuple:
    """Stream capacities no seeded lane overflows (the serving rule at mb
    planes), then the refinement streams'."""
    nq = ((W + 1) // 2) * ((H + 1) // 2)
    return (E._cap_bytes(W * H * (mb + 2) // 8 + 16),
            E._cap_bytes(nq * 9 // 8 + 16),
            E._cap_bytes(nq * 15 // 8 + 16)) + E.refine_caps(W, H)


def _seeded(seed: int, n: int, side: int, low: bool):
    """n blocks of 1x1 to side x side: lane 0 1x1, lane 1 w = 1, lane 2 all
    zero, lane 3 h not a multiple of 4; magnitudes from |N(0, sigma)|,
    sigma from 0.3 to 1e5 (low: up to 30, where EMB symbols and MEL runs
    are frequent)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        w = 1 + int(rng.integers(0, side))
        h = 1 + int(rng.integers(0, side))
        if i == 0:
            w = h = 1
        elif i == 1:
            w = 1
        elif i == 3:
            h = side - 1 if side > 4 else 3
        sigma = 10 ** rng.uniform(-0.5, 1.5 if low else 5)
        mag = np.abs(rng.normal(0, sigma, (h, w))).astype(np.int64)
        mag[rng.random((h, w)) < rng.uniform(0.1, 0.8)] = 0
        if i == 2:
            mag[:] = 0
        out.append((mag, rng.random((h, w)) < 0.5))
    return out


# (seed, lanes, block side): like sizes together, the plain SigProp steps
# every position of the block in turn
SEEDED = [(1, 24, 8), (2, 16, 24), (3, 8, 33), (4, 4, 64)]


@pytest.mark.parametrize("tables", ["default", "normative"])
@pytest.mark.parametrize("seed, n, side", SEEDED)
def test_lane_bodies_match_plain_versions_on_seeded_lanes(lib, request,
                                                          tables, seed, n,
                                                          side):
    if tables == "normative":
        request.getfixturevalue("normative_shaped")
    blocks = _seeded(seed + 10 * (tables == "normative"), n, side,
                     tables == "normative")
    p = [i % 4 for i in range(n)]
    valid = [int(i != 5) for i in range(n)]
    lanes = _lanes(blocks, side, side, p, valid)
    caps = _caps(side, side)
    got = _check(lib, lanes, caps[:3], False)
    assert (got[1] >= 0).all()
    got_r = _check(lib, lanes, caps, True)
    # the cleanup streams of K4r are K4's
    assert torch.equal(got_r[1][:3], got[1])
    assert (got_r[1][3:, [i for i in range(n) if i % 4 and i != 5]]
            > 0).any()


def test_lane_bodies_report_overflow(lib):
    """Every stream past its capacity on some lane: -1 bits, and no store
    past the capacity (the next stream's bytes stay as the plain version
    has them)."""
    blocks = _seeded(5, 11, 16, False)
    # a MEL event per quad, one and zero in turn: the top-left sample of
    # every other quad, which gives no quad a context
    mag = np.zeros((16, 16), np.int64)
    mag[::2, ::2] = np.indices((8, 8)).sum(0) % 2 * 5
    blocks.append((mag, mag > 2))
    p = [i % 2 for i in range(12)]
    lanes = _lanes(blocks, 16, 16, p)
    caps = (8, 4, 8, 4, 4)
    got = _check(lib, lanes, caps, True)
    for s in range(5):
        assert (got[1][s] == -1).any(), s
    assert (got[1] >= 0).any()
    _check(lib, lanes, caps[:3], False)


def _chains(W: int, H: int, p: int):
    """Blocks in W x H lanes at cleanup plane p whose plane-(p - 1)
    samples become significant in SigProp one after another, each only
    through the one before it: a cleanup-significant seed (magnitude
    2^p) and a path of magnitude 2^(p - 1) samples."""
    out = []

    def block(h, w, path, seeds=((0, 0),)):
        mag = np.zeros((h, w), np.int64)
        for y, x in path:
            mag[y, x] = 1 << (p - 1)
        for seed in seeds:
            mag[seed] = 1 << p
        out.append((mag, np.indices((h, w)).sum(0) % 3 == 1))

    def bounce(x, top):                        # 0, 1, .., top, top - 1, ..
        x %= 2 * top
        return x if x <= top else 2 * top - x

    block(4, W, [(0, x) for x in range(1, W)])                  # a row
    block(8, W, [(3, x) for x in range(1, W)], [(3, 0)])        # row 3
    block(1, W, [(0, x) for x in range(1, W)])                  # h = 1
    block(H, W, [(bounce(x, H - 1), x) for x in range(1, W)])   # diagonals
    block(H, W, [(y, 0) for y in range(1, H)])                  # a column
    block(H, 8, [(y, 1 + y % 7) for y in range(1, H)])          # zigzag
    block(H - 3, W, [(bounce(x // 2, H - 4), x)                 # a snake
                     for x in range(1, W)])
    block(H, W, [(y, x) for y in range(H) for x in range(W)     # a mesh
                 if (x + y) % 2])
    # up a stripe: each sample reached through the one below-left of it
    block(4, W, [(3 - bounce(x, 3), x) for x in range(1, W)], [(3, 0)])
    # the column to the right does not count: a path that would need it
    block(4, W, [(0, x) for x in range(W - 1, 0, -1)], [(0, W - 1)])
    # the row below a stripe, with its cleanup significance only
    block(8, W, [(3, x) for x in range(1, W, 3)],
          [(4, x) for x in range(1, W, 3)])
    return out


@pytest.mark.parametrize("W, H, p", [(16, 11, 1), (64, 16, 2)])
def test_lane_bodies_follow_sigprop_chains(lib, W, H, p):
    blocks = _chains(W, H, p)
    lanes = _lanes(blocks, W, H, [p] * len(blocks))
    got = _check(lib, lanes, _caps(W, H), True)
    # every path sample of the chains that stay causal became significant
    ns = got[2].numpy()
    for j in (0, 1, 2, 4, 8, 10):
        mag = lanes[0][j].numpy() >> 1
        assert np.array_equal(ns[j] == 1, mag == 1 << (p - 1)), j


def test_lane_bodies_match_scalar_coder(lib):
    """A few lanes against grok_tpu.t1ht.scalar directly: the clean
    cleanup streams of ht_encode_block, the clean SigProp and MagRef
    streams of _encode_sigprop and _encode_magref, and new_sig as ns."""
    blocks = _seeded(6, 6, 32, False)[3:] + _chains(32, 8, 1)[:3]
    _against_scalar(lib, blocks, [1, 2, 3, 1, 1, 1], 32, 32, _caps(32, 32))


def _deep(seed: int, n: int, W: int, H: int, mb: int) -> list:
    """n blocks of up to W x H (the first W x H) whose magnitudes reach
    mb bits: log-uniform exponents up to mb, a quarter of the samples
    zero, the top sample 2^mb - 1."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        w = W if i == 0 else int(rng.integers(1, W + 1))
        h = H if i == 0 else int(rng.integers(1, H + 1))
        mag = np.exp2(rng.uniform(0, mb, (h, w))).astype(np.int64)
        mag = np.minimum(mag, (1 << mb) - 1)
        mag[rng.random((h, w)) < 0.25] = 0
        mag[0, 0] = (1 << mb) - 1
        out.append((mag, rng.random((h, w)) < 0.5))
    return out


@pytest.mark.parametrize("mb", [25, 26, 27, 28, 29, 30])
def test_lane_bodies_match_scalar_coder_past_24_planes(lib, mb):
    """Lanes of 25 to 30 magnitude planes (the encodes of 25- to 27-bit
    samples with their guard bits and band gains), K4 and K4r, against
    the plain versions and grok_tpu.t1ht.scalar: MagSgn fields up to 31
    bits, exponent bounds up to 31."""
    blocks = _deep(mb, 4, 16, 16, mb)
    p = [0, 1, 3, mb - 2]
    lanes = _lanes(blocks, 16, 16, p)
    caps = _caps(16, 16, mb)
    _check(lib, lanes, caps[:3], False)
    _check(lib, lanes, caps, True)
    _against_scalar(lib, blocks, p, 16, 16, caps)


def test_wide_lane_bodies_past_24_planes(lib):
    """The wide design on 30-plane lanes, K4 and K4r, against the plain
    versions."""
    blocks = _deep(7, 3, 128, 8, 30)
    lanes = _lanes(blocks, 128, 8, [0, 2, 29])
    caps = _caps(128, 8, 30)
    _check(lib, lanes, caps[:3], False)
    _check(lib, lanes, caps, True)


def _against_scalar(lib, blocks: list, p: list, W: int, H: int,
                    caps: tuple) -> None:
    """The K4r lane body on blocks in W x H lanes at cleanup planes p
    equal to the scalar coder's clean streams and new significance."""
    lanes = _lanes(blocks, W, H, p)
    streams, bits, ns = host_encode(lib, lanes, caps, True)
    starts = np.cumsum((0,) + caps)
    clean = [_scalar_clean(m, n & (m > 0), j % 4, p[j])
             for j, (m, n) in enumerate(blocks)]
    raw = scalar._finish_raw
    scalar._finish_raw = lambda sink: (bytes(sink.finish()), sink.nbits)
    try:
        for j, (mag, neg) in enumerate(blocks):
            h, w = mag.shape
            neg = neg & (mag > 0)
            sig = (mag >> p[j]) > 0
            if p[j] > 0:
                sp, new_sig = scalar._encode_sigprop(mag, neg, sig, p[j] - 1,
                                                     w, h)
                mr = scalar._encode_magref(mag, sig, p[j] - 1, w, h)
            else:                    # a cleanup-only lane
                sp, mr, new_sig = (b"", 0), (b"", 0), np.zeros_like(sig)
            want = list(clean[j]) + [sp, mr]
            for s, (b, n) in enumerate(want):
                assert int(bits[s, j]) == n, (j, s)
                nb = (n + 7) // 8
                row = streams[j, starts[s]:starts[s] + nb].numpy()
                assert row.tobytes() == bytes(b[:nb]), (j, s)
            assert np.array_equal(ns[j, :h, :w].numpy() == 1, new_sig), j
            assert not ns[j, h:].any() and not ns[j, :, w:].any()
    finally:
        scalar._finish_raw = raw


@pytest.mark.parametrize("W, H", [(128, 4), (16, 256), (256, 16)])
def test_wide_lane_bodies_match_plain_versions(lib, W, H):
    """The wide design (W or H over 64: one warp per block, its first
    thread serial) on seeded lanes of up to W x H at cleanup planes 0..3,
    invalid and all-zero lanes included, K4 and K4r, against the plain
    versions."""
    rng = np.random.default_rng(W + H)
    blocks = []
    for i in range(6):
        w = W if i == 0 else int(rng.integers(1, W + 1))
        h = H if i == 0 else int(rng.integers(1, H + 1))
        mag = np.abs(rng.normal(0, 10 ** rng.uniform(0, 2.5),
                                (h, w))).astype(np.int64)
        mag[rng.random((h, w)) < 0.4] = 0
        if i == 2:
            mag[:] = 0
        blocks.append((mag, rng.random((h, w)) < 0.5))
    lanes = _lanes(blocks, W, H, [i % 4 for i in range(6)],
                   valid=[1, 1, 1, 1, 0, 1])
    caps = _caps(W, H)
    for refine in (False, True):
        _check(lib, lanes, caps if refine else caps[:3], refine)
