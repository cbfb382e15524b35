"""Encodes past 24 magnitude planes: 24- to 27-bit samples through the
port's encode on the CPU (the plain versions of K4, K4r and K5, and the
split distortion sums), held against the JAX package:

  - the plain K4/K4r (ht_encode_lanes_ref, ht_refine_lanes_ref) against
    grok_tpu.t1ht.scalar on lanes of 25 to 30 planes (the host-built
    lane bodies are held in tests/test_torch_ht_lane_body.py);
  - the split distortion sums (serve_enc._sq_sums, _exact_sums) against
    exact Python-int sums on lanes whose sums pass 2^63;
  - reversible encodes of 24- and 27-bit frames (HT, refined HT, Part-1,
    HT-mixed; every guard-bit count the reference takes) byte-identical
    to grok_tpu.compress and lossless; rate-targeted and layered ones
    within their byte budgets at every layer;
  - precision 28 raises the reference's ValueError.

The reference is grok_tpu.compress, not grok_tpu.compress_device: the
latter loses samples in Part-1 from 19-bit precision (a fault of the
reference that the port does not copy)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import grok_tpu  # noqa: E402
import grok_tpu.t1ht.scalar as scalar  # noqa: E402
from grok_tpu import CompressParams as JCP  # noqa: E402
from grok_tpu import native  # noqa: E402
from grok_tpu_torch import api  # noqa: E402
from grok_tpu_torch.core.params import CompressParams as PCP  # noqa: E402
from grok_tpu_torch.ops import ht_encode as E  # noqa: E402
from grok_tpu_torch.ops import t1_encode  # noqa: E402
from grok_tpu_torch.pipeline import serve_enc  # noqa: E402
from grok_tpu_torch.t2.rate import (layer_budget_consts,  # noqa: E402
                                    layer_targets_for_tile)
from test_torch_ht_encode import _scalar_clean  # noqa: E402

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C toolchain")

BLK = dict(num_resolutions=3, cblk_w_exp=4, cblk_h_exp=4)


def _deep(rng, h: int, w: int, mb: int):
    """(mag, neg) of h x w with log-uniform exponents up to mb planes,
    a quarter zero, the top sample 2^mb - 1."""
    mag = np.minimum(np.exp2(rng.uniform(0, mb, (h, w))).astype(np.int64),
                     (1 << mb) - 1)
    mag[rng.random((h, w)) < 0.25] = 0
    mag[0, 0] = (1 << mb) - 1
    return mag, (rng.random((h, w)) < 0.5) & (mag > 0)


def _mneg(blocks, W, H):
    out = np.zeros((len(blocks), H, W), np.int32)
    for j, (m, n) in enumerate(blocks):
        out[j, :m.shape[0], :m.shape[1]] = (m << 1) | n
    return torch.from_numpy(out)


def _col(v):
    return torch.tensor(list(v), dtype=torch.int32)


@pytest.mark.parametrize("mb", [25, 27, 30])
def test_plain_k4_k4r_equal_the_scalar_coder_past_24_planes(mb):
    rng = np.random.default_rng(mb)
    blocks = [_deep(rng, h, w, mb) for h, w in ((16, 16), (9, 13), (4, 1))]
    p = [0, 2, mb - 3]
    lanes = (_mneg(blocks, 16, 16), _col(p), _col(b[0].shape[1] for b in
                                                   blocks),
             _col(b[0].shape[0] for b in blocks), _col([1] * 3))
    nq = 64
    caps = (E._cap_bytes(256 * (mb + 2) // 8 + 16),
            E._cap_bytes(nq * 9 // 8 + 16), E._cap_bytes(nq * 15 // 8 + 16))
    streams, bits = E.ht_encode_lanes_ref(*lanes, *caps)
    sp, mr, rbits, ns = E.ht_refine_lanes_ref(*lanes, *E.refine_caps(16, 16))
    starts = np.cumsum((0,) + caps)
    clean = [_scalar_clean(m, n, j % 4, p[j])
             for j, (m, n) in enumerate(blocks)]
    raw = scalar._finish_raw
    scalar._finish_raw = lambda sink: (bytes(sink.finish()), sink.nbits)
    try:
        for j, (mag, neg) in enumerate(blocks):
            h, w = mag.shape
            want = list(clean[j])
            sig = (mag >> p[j]) > 0
            if p[j] > 0:
                want.append(scalar._encode_sigprop(mag, neg, sig, p[j] - 1,
                                                   w, h)[0])
                want.append(scalar._encode_magref(mag, sig, p[j] - 1, w, h))
            for s, (b, n) in enumerate(want):
                nb = (n + 7) // 8
                if s < 3:
                    got_b = streams[j, starts[s]:starts[s] + nb]
                    got_n = int(bits[s, j])
                else:
                    got_b = (sp, mr)[s - 3][j, :nb]
                    got_n = int(rbits[s - 3, j])
                assert got_n == n, (j, s)
                assert got_b.numpy().tobytes() == bytes(b[:nb]), (j, s)
    finally:
        scalar._finish_raw = raw


def _py_sq(x: np.ndarray) -> list:
    return [sum(int(v) * int(v) for v in row) for row in x]


def test_split_distortion_sums_are_exact():
    """Lanes of 64 x 64 magnitudes near 2^30 (sums near 2^72): the HT and
    Part-1 sums equal Python-int sums of the same model; a lane of small
    magnitudes keeps the int64 path."""
    rng = np.random.default_rng(3)
    mags = [np.full((64, 64), (1 << 30) - 1, np.int64),
            rng.integers(1 << 29, 1 << 30, (64, 64)),
            rng.integers(0, 1 << 12, (64, 64))]
    negs = [rng.random((64, 64)) < 0.5 for _ in mags]
    mneg = _mneg(list(zip(mags, negs)), 64, 64)
    mag = np.stack(mags).reshape(3, -1)
    s = serve_enc._exact_sums(serve_enc._dist_stats(
        mneg, None, None).numpy())
    assert s.dtype == object
    assert list(s[0]) == _py_sq(mag)
    assert list(s[1]) == [int((m > 0).sum()) for m in mag]
    p = _col([0, 5, 2])
    ns = torch.zeros((3, 64, 64), dtype=torch.uint8)
    s = serve_enc._exact_sums(serve_enc._dist_stats(mneg, p, ns).numpy())
    M = 2 * mag
    for j, pl in enumerate((0, 5, 2)):
        vq = mag[j] >> pl
        rec = np.where(vq > 0, (vq << (pl + 1)) + (1 << pl), 0)
        assert s[1][j] == _py_sq((M[j] - rec)[None])[0], j
    assert s[1][0] == int((mag[0] > 0).sum())
    small = serve_enc._exact_sums(serve_enc._dist_stats(
        mneg[2:], None, None).numpy())
    assert small.dtype == np.int64 and int(small[0][0]) == _py_sq(mag[2:])[0]
    # the distortions of the exact rationals, correctly rounded
    d = serve_enc._distortions(s)
    assert d[0][1] == (4 * s[0][1] - s[1][1]) / 4
    # Part-1: row 0 and the first cleanup row against Python ints
    nb = _col([30, 30, 12])
    R = 4
    sigtype = torch.zeros((3, 64, 64), dtype=torch.int8)
    s = serve_enc._exact_sums(serve_enc._mq_dist_stats(mneg, sigtype, nb,
                                                       R).numpy())
    assert list(s[0]) == _py_sq(mag)
    for j, n in enumerate((30, 30, 12)):
        bp = n - 1
        sig = (mag[j] >> bp) > 0
        rec = np.where(sig, ((mag[j] >> bp) << (bp + 1)) + (1 << bp), 0)
        assert s[1][j] == _py_sq((M[j] - rec)[None])[0], j


def _gray(prec: int, seed: int, h: int = 32, w: int = 40):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << prec, size=(h, w)).astype(np.int32)


def _ref(img, prec: int, kw: dict) -> bytes:
    return grok_tpu.compress(grok_tpu.Image.from_array(img, prec=prec),
                             JCP(**BLK, **kw))


LOSSLESS = {"ht": dict(ht=True), "p1": dict(), "mixed": dict(ht_mixed=True),
            "refined": dict(ht=True, ht_planes=2)}


@pytest.mark.parametrize("prec, kind", [(24, "ht"), (24, "p1")]
                         + [(27, k) for k in LOSSLESS])
def test_reversible_encodes_equal_grok_tpu_compress(prec, kind):
    img = _gray(prec, prec, 24, 32)
    kw = LOSSLESS[kind]
    got = api.compress_device(img, PCP(**BLK, **kw), prec=prec, device="cpu")
    assert got == _ref(img, prec, kw)
    if kind != "refined":       # one refined layer is not lossless
        out = api.decompress_device(got, device="cpu")[0].numpy()
        assert np.array_equal(out, img)


@pytest.mark.parametrize("guard", [1, 3, 5, 7])
def test_every_guard_bit_count_at_27_bits(guard):
    img = _gray(27, 40 + guard, 24, 24)
    kw = dict(ht=True, num_guard_bits=guard)
    got = api.compress_device(img, PCP(**BLK, **kw), prec=27, device="cpu")
    assert got == _ref(img, 27, kw)
    assert np.array_equal(api.decompress_device(got, device="cpu")[0]
                          .numpy(), img)


def test_too_few_guard_bits_raise_as_the_reference():
    # RGB: the RCT's chroma bit and the HH gain pass Mb
    img = np.random.default_rng(0).integers(0, 1 << 27, (16, 16, 3)) \
        .astype(np.int32)
    kw = dict(ht=True, num_guard_bits=0)
    with pytest.raises(ValueError, match="overflows Mb"):
        _ref(img, 27, kw)
    with pytest.raises(ValueError, match="overflows Mb"):
        api.compress_device(img, PCP(**BLK, **kw), prec=27, device="cpu")


LAYERED = {"ht": dict(ht=True), "p1": dict(), "mixed": dict(ht_mixed=True)}


@pytest.mark.parametrize("kind", list(LAYERED))
def test_layered_27_bit_encodes_keep_their_budgets(kind):
    """3 layers at 40:1, 10:1, 4:1: every layer prefix within its byte
    budget, and the stream the reference writes (whose distortions stay
    in its 53-bit scope on this frame)."""
    img = _gray(27, 5, 24, 32)
    kw = dict(LAYERED[kind], num_layers=3, rates=[40.0, 10.0, 4.0])
    params = PCP(**BLK, **kw)
    comps = [torch.from_numpy(img[None])]
    hdr = api._build_main_header(24, 32, 1, 27, False, params)
    res = serve_enc.try_encode_serving_batch(comps, hdr, params)
    targets = layer_targets_for_tile(layer_budget_consts(hdr, params),
                                     hdr.siz.tile_rect(0), params)
    per = len(res[0].packet_lens) // 3
    prefix = [sum(res[0].packet_lens[:per * (k + 1)]) for k in range(3)]
    assert all(p <= t for p, t in zip(prefix, targets)), (prefix, targets)
    got = api.compress_device(img, params, prec=27, device="cpu")
    assert got == _ref(img, 27, kw)


def test_k5_codes_thirty_planes():
    """The plain K5 on 30-plane lanes: 3 * 30 - 2 pass rows, the
    codeword within the serving capacity."""
    rng = np.random.default_rng(30)
    blocks = [_deep(rng, 16, 16, 30), _deep(rng, 7, 11, 30)]
    mneg = _mneg(blocks, 16, 16)
    R = 3 * 30 - 2
    L = E._cap_bytes(256 * 31 // 2 + 64)
    out, lens, rates, _st = t1_encode.t1_encode_lanes(
        mneg, _col([0, 1]), _col([30, 30]), _col([16, 11]), _col([16, 7]),
        L, R)
    assert (lens > 0).all() and (lens < L).all()
    for j in range(2):
        rr, terms, seg_lens, _sp = t1_encode.pass_records(
            rates[j].numpy(), 30, int(lens[j]))
        assert len(rr) == R and rr[-1] == int(lens[j]) == sum(seg_lens)
        assert all(b >= a for a, b in zip(rr, rr[1:])) and terms[-1]


def test_precision_28_raises_as_the_reference():
    img = _gray(27, 2, 8, 8)
    with pytest.raises(ValueError, match="27-bit"):
        grok_tpu.compress(grok_tpu.Image.from_array(img, prec=28), JCP())
    with pytest.raises(ValueError, match="27-bit"):
        api.compress_device(img, PCP(), prec=28, device="cpu")


def test_dense_64x64_blocks_of_27_bits_decode_on_both_routes():
    """A 64 x 64 code-block of 27-bit samples: its MagSgn sub-stream
    passes 8 KB (the JAX package's device kernel stops there and its
    serving decode hands such a block to the host); the port stages it
    on the serving decode and on the general route."""
    img = _gray(27, 64, 64, 64)
    kw = dict(ht=True, num_resolutions=2)
    data = grok_tpu.compress(grok_tpu.Image.from_array(img, prec=27),
                             JCP(**kw))
    assert api.compress_device(img, PCP(**kw), prec=27, device="cpu") == data
    for out in (api.decompress_device(data, device="cpu"),
                api.stage_general_device(data, device="cpu").run()):
        assert np.array_equal(out[0].numpy(), img)


@pytest.mark.parametrize("ch", [1, 3])
@pytest.mark.parametrize("kw", [dict(ht=True), dict(rates=[6.0])],
                         ids=["ht", "p1_6to1"])
def test_irreversible_27_bit_encodes_equal_grok_tpu_compress(kw, ch):
    """9/7 encodes past 24 planes (the ICT too): the reference encodes
    them on the host in float64, and so does the port's device encode
    (float32 holds only 24-bit integers), byte for byte."""
    img = np.random.default_rng(11).integers(0, 1 << 27, (24, 32, ch)) \
        .astype(np.int32)
    kw = dict(kw, irreversible=True)
    got = api.compress_device(img, PCP(**BLK, **kw), prec=27, device="cpu")
    assert got == _ref(img if ch > 1 else img[..., 0], 27, kw)
