"""The port's HT cleanup decoder (grok_tpu_torch/ops/ht_decode.py, kernel
K1) vs the references: the scalar HT coder (t1ht.scalar.ht_decode_block)
and the JAX package's Pallas kernel run in interpret mode
(grok_tpu/ops/pallas_ht.py pallas_ht_decode), all exact.  On the CPU the
wrapper runs the plain PyTorch version; the CUDA kernel itself is held
against it on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from grok_tpu.ops.pallas_ht import (_vlc_dec_planes, ht_block_eligible,  # noqa: E402,E501
                                    pack_ht_for_pallas, pallas_ht_decode)
from grok_tpu.t1ht import tables as T  # noqa: E402
from grok_tpu.t1ht.scalar import ht_decode_block, ht_encode_block  # noqa: E402,E501
from grok_tpu_torch.ops import ht_decode as H  # noqa: E402
from test_ht_tables_dropin import _synthetic_normative_tables  # noqa: E402


@pytest.fixture
def normative_shaped():
    """Two table families, EMB symbols and flipped UVLC prefix polarity
    (the drop-in shape of tests/test_ht_tables_dropin.py)."""
    lens_ek, lens_init = _synthetic_normative_tables()
    T.install_tables(lens=lens_ek, lens_init=lens_init,
                     uvlc_prefix_xor=0b101)
    assert T.two_families() and T.tables_have_ek()
    yield
    T.reset_tables()


def _make(rng, w, h, sigma, orient):
    mag = np.abs(rng.normal(0, sigma, (h, w))).astype(np.int64)
    mag[rng.random((h, w)) < 0.4] = 0
    neg = rng.random((h, w)) < 0.5
    mag[0, 0] = max(int(mag[0, 0]), 3)      # never an empty block
    enc = ht_encode_block(mag, neg, orient)
    job = dict(data=enc.data, seg_lens=enc.seg_lens, numpasses=1,
               numbps=enc.numbps, orient=orient, w=w, h=h)
    ref = ht_decode_block(enc.data, enc.seg_lens, 1, enc.numbps,
                          orient, w, h)
    return job, ref


def _jobs(seed, shapes, sigmas):
    rng = np.random.default_rng(seed)
    jobs, refs = [], []
    for i, ((w, h), s) in enumerate(zip(shapes, sigmas)):
        j, r = _make(rng, w, h, s, i % 4)
        assert ht_block_eligible(j)
        jobs.append(j)
        refs.append(r)
    return jobs, refs


def _lanes(jobs):
    """The JAX packing (128 lanes, S=1) and the same data as the port's
    lane-major tensors."""
    ms, mel, vlc, pv, wh, valid = pack_ht_for_pallas(jobs, 1)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in
         (ms, mel, vlc, pv.reshape(-1), wh[0], wh[1], valid.reshape(-1))]
    return (ms, mel, vlc, pv, wh, valid), t


def _assert_scalar_exact(out, jobs, refs):
    out = out.numpy()
    for i, (j, (m2, ng)) in enumerate(zip(jobs, refs)):
        v = out[i, :j["h"], :j["w"]]
        assert np.array_equal(np.abs(v), m2), f"block {i} magnitude"
        assert np.array_equal(v < 0, ng), f"block {i} sign"


SHAPES = [(8, 8), (7, 5), (8, 6), (3, 8), (4, 4), (1, 1), (2, 3), (16, 16),
          (13, 64), (64, 64), (61, 37), (32, 32)]
SIGMAS = [15, 300, 4, 80, 1000, 20, 9, 2, 50, 10000, 3, 150]


def test_ref_matches_scalar_coder():
    jobs, refs = _jobs(0, SHAPES, SIGMAS)
    _, lanes = _lanes(jobs)
    out = H.ht_decode_lanes_ref(*lanes, 64, 64)
    assert out.shape == (128, 64, 64) and out.dtype == torch.int32
    _assert_scalar_exact(out, jobs, refs)
    assert not out[len(jobs):].any()          # invalid lanes stay zero


def _vs_pallas_interpret(seed, sigmas):
    shapes = [(8, 8), (7, 5), (8, 6), (3, 8), (8, 8), (4, 4)]
    jobs, refs = _jobs(seed, shapes, sigmas)
    jx, lanes = _lanes(jobs)
    ms, mel, vlc, pv, wh, valid = jx
    want = np.asarray(pallas_ht_decode(
        jnp.asarray(ms), jnp.asarray(mel), jnp.asarray(vlc),
        jnp.asarray(pv), jnp.asarray(wh), jnp.asarray(valid), 8, 8, 1,
        interpret=True)).transpose(2, 0, 1)
    got = H.ht_decode_lanes(*lanes, 8, 8)
    assert np.array_equal(got.numpy(), want)
    _assert_scalar_exact(got, jobs, refs)


def test_matches_pallas_interpret():
    _vs_pallas_interpret(1, [15, 300, 4, 80, 1000, 20])


def test_matches_pallas_interpret_normative_tables(normative_shaped):
    # low sigmas: EMB (eps_k != 0) symbols are actually emitted
    _vs_pallas_interpret(2, [8, 8, 3, 20, 8, 5])
    jobs, refs = _jobs(3, SHAPES, [8] * len(SHAPES))
    _, lanes = _lanes(jobs)
    _assert_scalar_exact(H.ht_decode_lanes_ref(*lanes, 64, 64), jobs, refs)


def _jax_lut():
    planes, symb, _has_ek, nfam, pxor = _vlc_dec_planes()
    idx = np.arange(nfam * T.N_CTX * 128)
    ent = np.zeros(idx.size, np.int64)
    for j in range(planes.shape[0]):
        words = planes[j].astype(np.int64) & 0xFFFFFFFF
        ent |= ((words[idx >> 5] >> (idx & 31)) & 1) << j
    return ent, symb, nfam, pxor


def _assert_lut_matches():
    lut, symb, nfam, pxor = H.vlc_dec_lut()
    ent, jsymb, jnfam, jpxor = _jax_lut()
    assert lut.dtype == np.int32
    assert np.array_equal(lut.astype(np.int64), ent)
    assert (symb, nfam, pxor) == (jsymb, jnfam, jpxor)


def test_lut_matches_jax_planes_default():
    _assert_lut_matches()
    assert H.vlc_dec_lut()[2] == 1


def test_lut_follows_install_tables(normative_shaped):
    _assert_lut_matches()
    lut, symb, nfam, pxor = H.vlc_dec_lut()
    # EMB symbols (eps_k in bits 5..8) widen the symbol field
    assert nfam == 2 and pxor == 0b101 and symb > 5
    assert (lut & ((1 << symb) - 1)).max() >= 32


def test_wrapper_cpu_runs_plain_version_without_counting():
    jobs, _ = _jobs(4, [(8, 8), (5, 7)], [40, 400])
    _, lanes = _lanes(jobs)
    before = H.ht_decode_lanes.launches
    got = H.ht_decode_lanes(*lanes, 8, 8)
    assert H.ht_decode_lanes.launches == before
    assert torch.equal(got, H.ht_decode_lanes_ref(*lanes, 8, 8))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    jobs, _ = _jobs(5, [(8, 8)], [40])
    _, lanes = _lanes(jobs)
    ms, mel, vlc, p, w, h, valid = lanes
    bad = [
        (ms.to(torch.int32), mel, vlc, p, w, h, valid),      # dtype
        (ms, mel, vlc, p.to(torch.int64), w, h, valid),
        (ms, mel[:5], vlc, p, w, h, valid),                  # lane count
        (ms.t().contiguous().t(), mel, vlc, p, w, h, valid), # layout
        (ms, mel, vlc, p[:, None], w, h, valid),             # rank
    ]
    for args in bad:
        with pytest.raises(ValueError):
            H.ht_decode_lanes(*args, 8, 8)
    with pytest.raises(ValueError):
        H.ht_decode_lanes(*lanes, 128, 8)                   # > 64 wide
    with pytest.raises(ValueError):
        H.ht_decode_lanes(*lanes[:3], p.to("meta"), w, h, valid, 8, 8)


def test_stream_helpers():
    assert H._quant_len(1) == 256
    assert H._quant_len(248) == 256 and H._quant_len(249) == 512
    assert H.MAX_STREAM == 256 * 32 - 8

