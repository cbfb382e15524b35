"""The port's refined HT coders vs the references: K4r (grok_tpu_torch/
ops/ht_encode.py ht_encode_lanes(..., refine=True)) against the scalar HT
coder's SigProp and MagRef segments (t1ht.scalar.ht_encode_block with
p > 0) and against the JAX package's Pallas kernel in interpret mode;
K2 (ops/ht_decode.py ht_decode_lanes(..., sp, mr, npass)) against
t1ht.scalar.ht_decode_block at every pass count and against the Pallas
REFINE kernel in interpret mode; all exact.  On the CPU the wrappers run
the plain PyTorch versions; the CUDA kernels are held against them on the
card by tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import grok_tpu.t1ht.scalar as scalar  # noqa: E402
from grok_tpu import native  # noqa: E402
from grok_tpu.ops.pallas_ht import (_pack_raw, ht_block_eligible,  # noqa: E402
                                    pack_ht_for_pallas,
                                    pallas_ht_decode_refine)
from grok_tpu.ops.pallas_ht_enc import pallas_ht_encode  # noqa: E402
from grok_tpu_torch import native as pnative  # noqa: E402
from grok_tpu_torch.ops import ht_decode as D  # noqa: E402
from grok_tpu_torch.ops import ht_encode as E  # noqa: E402

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C toolchain")

# 1x1 to 32x32, every height 1..7 (stripe tails), w = 1 and h = 1
SHAPES = [(1, 1), (1, 7), (7, 1), (5, 2), (3, 3), (6, 4), (9, 5), (2, 6),
          (11, 7), (32, 32), (13, 6), (31, 29), (32, 17), (3, 32), (16, 16),
          (8, 8)]
SIGMAS = [5, 50, 500, 30, 8, 300, 70, 2000, 15, 40, 900, 6, 120, 60, 25, 3]
CAPS = (32 * 32 * 28 // 8 + 64, 1024, 1024)


def _blocks(seed, shapes, sigmas):
    rng = np.random.default_rng(seed)
    out = []
    for (w, h), s in zip(shapes, sigmas):
        mag = np.abs(rng.normal(0, s, (h, w))).astype(np.int64)
        mag[rng.random((h, w)) < 0.45] = 0
        mag[0, 0] = max(int(mag[0, 0]), 1)
        neg = (rng.random((h, w)) < 0.5) & (mag > 0)
        out.append((mag, neg))
    return out


def _col(v):
    return torch.tensor(v, dtype=torch.int32)


def _p_eff(mag, P):
    nb = int(mag.max()).bit_length()
    return min(P, nb - 1) if nb > 1 else 0


def _lanes(blocks, W, H, P):
    n = len(blocks)
    mneg = np.zeros((n, H, W), np.int32)
    for j, (mag, neg) in enumerate(blocks):
        h, w = mag.shape
        mneg[j, :h, :w] = (mag << 1) | neg
    return (torch.from_numpy(mneg), _col([_p_eff(m, P) for m, _ in blocks]),
            _col([m.shape[1] for m, _ in blocks]),
            _col([m.shape[0] for m, _ in blocks]), _col([1] * n))


def _raw_wire(streams, bits, lane, start, s):
    """A lane's stuffed SigProp (s = 3) or MagRef (s = 4) segment, by the
    port's C stuffing."""
    out, lens = pnative.ht_raw_batch(streams[lane].numpy(), [start],
                                     [int(bits[s, lane])])
    return out[:lens[0]].tobytes()


@pytest.mark.parametrize("P", [1, 2, 3])
def test_k4r_plain_matches_scalar_coder(P):
    blocks = _blocks(P, SHAPES, SIGMAS)
    lanes = _lanes(blocks, 32, 32, P)
    streams, bits, ns = E.ht_encode_lanes(*lanes, *CAPS, refine=True)
    LSP, LMR = E.refine_caps(32, 32)
    assert streams.shape == (16, sum(CAPS) + LSP + LMR)
    assert bits.shape == (5, 16) and ns.shape == (16, 32, 32)
    # the cleanup streams are K4's, unchanged
    c_streams, c_bits = E.ht_encode_lanes(*lanes, *CAPS)
    assert torch.equal(bits[:3], c_bits)
    assert torch.equal(E.clear_unused(streams[:, :sum(CAPS)], bits[:3],
                                      *CAPS[:2]),
                       E.clear_unused(c_streams, c_bits, *CAPS[:2]))
    for j, (mag, neg) in enumerate(blocks):
        h, w = mag.shape
        p = int(lanes[1][j])
        ref = scalar.ht_encode_block(mag, neg, j % 4, p=P)
        if p == 0:
            assert bits[3:, j].tolist() == [0, 0] and not ns[j].any()
            assert len(ref.seg_lens) == 1
            continue
        s0, s1 = ref.seg_lens[0], ref.seg_lens[0] + ref.seg_lens[1]
        assert _raw_wire(streams, bits, j, sum(CAPS), 3) == ref.data[s0:s1]
        assert _raw_wire(streams, bits, j, sum(CAPS) + LSP, 4) == \
            ref.data[s1:]
        _sp, new_sig = scalar._encode_sigprop(mag, neg, (mag >> p) > 0,
                                              p - 1, w, h)
        assert np.array_equal(ns[j, :h, :w].numpy() == 1, new_sig), j
        assert not ns[j, h:].any() and not ns[j, :, w:].any()


def test_k4r_plain_matches_pallas_interpret():
    blocks = _blocks(7, [(8, 8), (7, 5), (1, 1), (8, 3), (3, 8), (5, 1),
                         (8, 8), (2, 7)], [40, 300, 9, 80, 1000, 20, 3, 60])
    P = 2
    lanes = _lanes(blocks, 8, 8, P)
    LMS, LMEL, LVLC = 512, 256, 256
    n = len(blocks)
    mneg = np.zeros((8, 8, 128), np.int32)
    mneg[..., :n] = lanes[0].numpy().transpose(1, 2, 0)
    pv = np.zeros((1, 128), np.int32)
    pv[0, :n] = lanes[1].numpy()
    wh = np.ones((2, 128), np.int32)
    wh[0, :n], wh[1, :n] = lanes[2].numpy(), lanes[3].numpy()
    valid = np.zeros((1, 128), np.int32)
    valid[0, :n] = 1
    outs = [np.asarray(a) for a in pallas_ht_encode(
        jnp.asarray(mneg), jnp.asarray(pv), jnp.asarray(wh),
        jnp.asarray(valid), 8, 8, 1, LMS, LMEL, LVLC, True, True)]
    jbits, jns = outs[5], outs[6]
    streams, bits, ns = E.ht_encode_lanes(*lanes, LMS, LMEL, LVLC,
                                          refine=True)
    assert np.array_equal(bits.numpy(), jbits[:, :n])
    assert np.array_equal(ns.numpy(), jns[..., :n].transpose(2, 0, 1))
    LSP, LMR = E.refine_caps(8, 8)
    starts = np.cumsum([0, LMS, LMEL, LVLC, LSP])
    for k, wbuf in enumerate(outs[:5]):
        jb = np.ascontiguousarray(wbuf[:, :n].T).view("<u4").view(np.uint8)
        for j in range(n):
            nb = (int(bits[k, j]) + 7) // 8
            got = streams[j, starts[k]:starts[k] + nb].numpy().tobytes()
            assert got == jb[j, :nb].tobytes(), (k, j)


def _refined_jobs(seed, P):
    """Every truncation (1, 2 and 3 passes) of scalar-coded blocks with
    the ht_planes extension P, as decode jobs, and their scalar
    decodes."""
    jobs, refs = [], []
    for j, (mag, neg) in enumerate(_blocks(seed, SHAPES, SIGMAS)):
        h, w = mag.shape
        enc = scalar.ht_encode_block(mag, neg, j % 4, p=P)
        for n in range(1, len(enc.seg_lens) + 1):
            sl = enc.seg_lens[:n]
            job = dict(data=enc.data[:sum(sl)], seg_lens=sl, numpasses=n,
                       numbps=enc.numbps, w=w, h=h,
                       ht_p=scalar.derive_p(n, enc.numbps, P))
            assert ht_block_eligible(job)
            jobs.append(job)
            refs.append(scalar.ht_decode_block(job["data"], sl, n,
                                               enc.numbps, j % 4, w, h,
                                               ht_planes=P))
    return jobs, refs


def _dec_lanes(jobs):
    """The JAX packing (128 lanes, S = 1) and the same data as the port's
    lane tensors (ms, mel, vlc, p, w, h, valid, sp, mr, npass)."""
    ms, mel, vlc, pv, wh, valid = pack_ht_for_pallas(jobs, 1)
    sp = _pack_raw([j["_ht_hdr"][3] if j["numpasses"] > 1 else b""
                    for j in jobs], 1)
    mr = _pack_raw([j["_ht_hdr"][4] if j["numpasses"] > 1 else b""
                    for j in jobs], 1)
    npv = np.zeros((1, 128), np.int32)
    npv[0, :len(jobs)] = [j["numpasses"] for j in jobs]
    jx = (ms, mel, vlc, pv, wh, valid, sp, mr, npv)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in
         (ms, mel, vlc, pv.reshape(-1), wh[0], wh[1], valid.reshape(-1), sp,
          mr, npv.reshape(-1))]
    return jx, t


def _assert_scalar_exact(out, jobs, refs):
    out = out.numpy()
    for i, (j, (m2, ng)) in enumerate(zip(jobs, refs)):
        v = out[i, :j["h"], :j["w"]]
        assert np.array_equal(np.abs(v), m2), f"block {i} magnitude"
        assert np.array_equal(v < 0, ng), f"block {i} sign"


@pytest.mark.parametrize("P", [1, 2, 3])
def test_k2_plain_matches_scalar_decoder(P):
    jobs, refs = _refined_jobs(10 + P, P)
    _, t = _dec_lanes(jobs)
    out, err = D.ht_decode_lanes(*t[:7], 32, 32, *t[7:])
    assert out.shape == (128, 32, 32) and out.dtype == torch.int32
    assert not err.any()
    _assert_scalar_exact(out, jobs, refs)
    assert not out[len(jobs):].any()


def test_k2_plain_matches_pallas_refine_interpret():
    jobs, refs = _refined_jobs(20, 2)
    jobs = [j for j in jobs if j["w"] <= 8 and j["h"] <= 8]
    refs = [r for r in refs if r[0].shape[0] <= 8 and r[0].shape[1] <= 8]
    jx, t = _dec_lanes(jobs)
    want = np.asarray(pallas_ht_decode_refine(
        *(jnp.asarray(a) for a in jx), 8, 8, 1,
        interpret=True)).transpose(2, 0, 1)
    got, err = D.ht_decode_lanes(*t[:7], 8, 8, *t[7:])
    assert np.array_equal(got.numpy(), want) and not err.any()
    _assert_scalar_exact(got, jobs, refs)


def test_k4r_to_k2_round_trip_matches_the_scalar_decode():
    """K4r's clean streams, as they leave the encoder, decoded by K2 at
    every pass count: the scalar decode of the scalar-coded block."""
    P = 2
    blocks = _blocks(30, SHAPES, SIGMAS)
    lanes = _lanes(blocks, 32, 32, P)
    streams, bits, _ns = E.ht_encode_lanes(*lanes, *CAPS, refine=True)
    starts = np.cumsum((0,) + CAPS + E.refine_caps(32, 32))
    cut = [torch.nn.functional.pad(streams[:, a:b], (0, 1)).contiguous()
           for a, b in zip(starts[:-1], starts[1:])]
    for n in (1, 2, 3):
        out = D.ht_decode_lanes(cut[0], cut[1], cut[2], *lanes[1:], 32, 32,
                                cut[3], cut[4],
                                _col([n] * len(blocks)))[0].numpy()
        for j, (mag, neg) in enumerate(blocks):
            h, w = mag.shape
            enc = scalar.ht_encode_block(mag, neg, j % 4, p=P)
            k = min(n, len(enc.seg_lens))
            m2, ng = scalar.ht_decode_block(
                enc.data[:sum(enc.seg_lens[:k])], enc.seg_lens[:k], k,
                enc.numbps, j % 4, w, h, ht_planes=P)
            assert np.array_equal(np.abs(out[j, :h, :w]), m2), (n, j)
            assert np.array_equal(out[j, :h, :w] < 0, ng), (n, j)


def test_decode_ht_blocks_routes_cleanup_and_refined_lanes():
    jobs, refs = _refined_jobs(40, 1)
    _, t = _dec_lanes(jobs)
    refine = t[9].numpy() >= 2
    assert refine.any() and (~refine[:len(jobs)]).any()
    before = (D.ht_decode_lanes.launches, D.ht_decode_lanes.refine_launches)
    out, err = D.decode_ht_blocks(*t[:3], t[7], t[8], *t[3:7], t[9], refine,
                                  32, 32)
    # CPU tensors: the plain versions, no launch counted
    assert (D.ht_decode_lanes.launches,
            D.ht_decode_lanes.refine_launches) == before
    _assert_scalar_exact(out, jobs, refs)
    want, werr = D.ht_decode_lanes(*t[:7], 32, 32, *t[7:])
    assert torch.equal(out, want) and torch.equal(err, werr)


def test_refine_wrappers_reject_what_the_kernels_do_not_take():
    jobs, _ = _refined_jobs(50, 2)
    _, t = _dec_lanes(jobs)
    ms, mel, vlc, p, w, h, valid, sp, mr, npv = t
    with pytest.raises(ValueError):
        D.ht_decode_lanes(ms, mel, vlc, p, w, h, valid, 32, 32, sp, mr)
    with pytest.raises(ValueError):
        D.ht_decode_lanes(ms, mel, vlc, p, w, h, valid, 32, 32, sp[:3], mr,
                          npv)
    with pytest.raises(ValueError):
        D.ht_decode_lanes(ms, mel, vlc, p, w, h, valid, 32, 32,
                          sp.to(torch.int32), mr, npv)
    with pytest.raises(ValueError):
        D.ht_decode_lanes(ms, mel, vlc, p, w, h, valid, 32, 32, sp, mr,
                          npv.to(torch.int64))
    with pytest.raises(ValueError):
        D.decode_ht_blocks(ms, mel, vlc, sp, mr, p, w, h, valid, npv,
                           np.ones(3, bool), 32, 32)
    lanes = _lanes(_blocks(51, [(8, 8)], [40]), 8, 8, 2)
    with pytest.raises(ValueError):
        E.ht_encode_lanes(lanes[0], lanes[1].to(torch.int64), *lanes[2:],
                          256, 64, 64, refine=True)
    with pytest.raises(ValueError):
        E.ht_encode_lanes(lanes[0].to("meta"), *lanes[1:], 256, 64, 64,
                          refine=True)


def test_refine_caps_and_stripe_order():
    assert E.refine_caps(64, 64) == (1056, 544)
    assert E.refine_caps(1, 1) == (64, 64)
    order = E.stripe_order(3, 6)
    assert order.tolist() == [0, 3, 6, 9, 1, 4, 7, 10, 2, 5, 8, 11, 12, 15,
                              13, 16, 14, 17]
    assert sorted(order.tolist()) == list(range(18))
