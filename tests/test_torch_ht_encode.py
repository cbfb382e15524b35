"""The port's HT cleanup encoder (grok_tpu_torch/ops/ht_encode.py, kernel
K4) vs the references: the clean streams the scalar HT coder
(t1ht.scalar.ht_encode_block) hands to its wire assembler, and the JAX
package's Pallas kernel run in interpret mode (grok_tpu/ops/
pallas_ht_enc.py pallas_ht_encode), all byte-exact.  On the CPU the
wrapper runs the plain PyTorch version; the CUDA kernel itself is held
against it on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import grok_tpu.t1ht.scalar as scalar  # noqa: E402
from grok_tpu.ops.pallas_ht_enc import (_vlc_enc_planes,  # noqa: E402
                                        pallas_ht_encode)
from grok_tpu.t1ht import tables as T  # noqa: E402
from grok_tpu_torch.ops import ht_encode as E  # noqa: E402
from grok_tpu_torch.t1ht import tables as PT  # noqa: E402
from test_ht_tables_dropin import _synthetic_normative_tables  # noqa: E402


@pytest.fixture
def normative_shaped():
    """Two table families, EMB symbols and flipped UVLC prefix polarity,
    installed in both packages (the references read the JAX package's
    tables, the port reads its own)."""
    lens_ek, lens_init = _synthetic_normative_tables()
    for tables in (T, PT):
        tables.install_tables(lens=lens_ek, lens_init=lens_init,
                              uvlc_prefix_xor=0b101)
        assert tables.two_families() and tables.tables_have_ek()
    yield
    T.reset_tables()
    PT.reset_tables()


def _scalar_clean(mag, neg, orient, p=0):
    """The scalar coder's clean (ms, mel, vlc) (bytes, bits) streams, as
    passed to assemble_cleanup; None for an empty block."""
    got = []
    orig = scalar.assemble_cleanup

    def capture(ms, mel, vlc):
        got.append((ms, mel, vlc))
        return orig(ms, mel, vlc)

    scalar.assemble_cleanup = capture
    try:
        scalar.ht_encode_block(mag, neg, orient, p=p)
    finally:
        scalar.assemble_cleanup = orig
    return got[0] if got else None


def _blocks(seed, shapes, sigmas):
    rng = np.random.default_rng(seed)
    out = []
    for (w, h), s in zip(shapes, sigmas):
        mag = np.abs(rng.normal(0, s, (h, w))).astype(np.int64)
        mag[rng.random((h, w)) < 0.4] = 0
        neg = rng.random((h, w)) < 0.5
        out.append((mag, neg))
    return out


def _lanes(blocks, W, H, p=None):
    n = len(blocks)
    mneg = np.zeros((n, H, W), np.int32)
    for j, (mag, neg) in enumerate(blocks):
        h, w = mag.shape
        mneg[j, :h, :w] = (mag << 1) | neg

    def col(v):
        return torch.tensor(v, dtype=torch.int32)
    return (torch.from_numpy(mneg), col(p or [0] * n),
            col([b[0].shape[1] for b in blocks]),
            col([b[0].shape[0] for b in blocks]), col([1] * n))


SHAPES = [(8, 8), (7, 5), (1, 1), (32, 32), (3, 8), (16, 16), (13, 32),
          (2, 3), (32, 17), (4, 4), (31, 29), (1, 9), (9, 1), (6, 6),
          (32, 32), (5, 12)]
SIGMAS = [15, 300, 4, 80, 1000, 20, 9, 2, 50, 10000, 3, 150, 40, 0.3, 6,
          700]
CAPS = (32 * 32 * 28 // 8 + 64, 1024, 1024)


def _assert_scalar_exact(streams, bits, blocks, caps, p=None):
    regions = (0, caps[0], caps[0] + caps[1], sum(caps))
    for j, (mag, neg) in enumerate(blocks):
        ref = _scalar_clean(mag, neg, j % 4, (p or [0] * len(blocks))[j])
        if ref is None:                 # empty block: no segment
            assert not mag.any()
            continue
        for k, (b, n) in enumerate(ref):
            assert int(bits[k, j]) == n, (j, k)
            row = streams[j, regions[k]:regions[k + 1]].numpy()
            nb = (n + 7) // 8
            assert row[:nb].tobytes() == bytes(b[:nb]), (j, k)
            assert not row[nb:].any(), (j, k)


@pytest.mark.parametrize("tables", ["default", "dropin"])
def test_ref_matches_scalar_clean_streams(tables, request):
    if tables == "dropin":
        request.getfixturevalue("normative_shaped")
    # low sigmas make EMB (eps_k != 0) symbols and MEL runs frequent
    sig = SIGMAS if tables == "default" else [3, 8, 2, 20, 5, 8] * 3
    blocks = _blocks(0 if tables == "default" else 1, SHAPES, sig)
    streams, bits = E.ht_encode_lanes(*_lanes(blocks, 32, 32), *CAPS)
    assert streams.shape == (16, sum(CAPS)) and streams.dtype == torch.uint8
    assert bits.shape == (3, 16) and bits.dtype == torch.int32
    _assert_scalar_exact(streams, bits, blocks, CAPS)


def test_ref_cleanup_plane_above_zero():
    blocks = _blocks(2, SHAPES[:8], [900, 300, 40, 80, 1000, 200, 90, 60])
    p = [1, 2, 0, 3, 1, 2, 1, 1]
    streams, bits = E.ht_encode_lanes(*_lanes(blocks, 32, 32, p), *CAPS)
    _assert_scalar_exact(streams, bits, blocks, CAPS, p)


def _vs_pallas_interpret(seed, sigmas):
    shapes = [(32, 32), (7, 5), (1, 1), (32, 17), (3, 8), (16, 16),
              (13, 32), (2, 3)] * 2
    blocks = _blocks(seed, shapes, sigmas)
    lanes = _lanes(blocks, 32, 32)
    LMS, LMEL, LVLC = 4096, 512, 512
    mneg = np.zeros((32, 32, 128), np.int32)
    mneg[..., :16] = lanes[0].numpy().transpose(1, 2, 0)
    wh = np.ones((2, 128), np.int32)
    wh[0, :16], wh[1, :16] = lanes[2].numpy(), lanes[3].numpy()
    valid = np.zeros((1, 128), np.int32)
    valid[0, :16] = 1
    ms_w, mel_w, vlc_w, jbits = (np.asarray(a) for a in pallas_ht_encode(
        jnp.asarray(mneg), jnp.zeros((1, 128), jnp.int32), jnp.asarray(wh),
        jnp.asarray(valid), 32, 32, 1, LMS, LMEL, LVLC, True))
    streams, bits = E.ht_encode_lanes(*lanes, LMS, LMEL, LVLC)
    assert np.array_equal(bits.numpy(), jbits[:, :16])
    for k, (wbuf, lo, hi) in enumerate(((ms_w, 0, LMS),
                                        (mel_w, LMS, LMS + LMEL),
                                        (vlc_w, LMS + LMEL, None))):
        jb = np.ascontiguousarray(wbuf[:, :16].T).view("<u4").view(np.uint8)
        for j in range(16):
            nb = (int(bits[k, j]) + 7) // 8
            assert streams[j, lo:hi].numpy()[:nb].tobytes() == \
                jb[j, :nb].tobytes(), (j, k)


def test_matches_pallas_interpret():
    _vs_pallas_interpret(3, [15, 300, 4, 80, 1000, 20, 9, 2] * 2)


def test_matches_pallas_interpret_normative_tables(normative_shaped):
    _vs_pallas_interpret(4, [3, 8, 2, 20, 5, 8, 3, 6] * 2)


def _jax_enc_lut():
    planes, symb, _has_ek, nfam, pxor = _vlc_enc_planes()
    idx = np.arange(nfam * T.N_CTX << symb)
    ent = np.zeros(idx.size, np.int64)
    for j in range(planes.shape[0]):
        words = planes[j].astype(np.int64) & 0xFFFFFFFF
        ent |= ((words[idx >> 5] >> (idx & 31)) & 1) << j
    return ent, symb, nfam, pxor


def _assert_lut_matches():
    lut, symb, nfam, pxor = E.vlc_enc_lut()
    ent, jsymb, jnfam, jpxor = _jax_enc_lut()
    assert lut.dtype == np.int32
    assert np.array_equal(lut.astype(np.int64), ent)
    assert (symb, nfam, pxor) == (jsymb, jnfam, jpxor)


def test_lut_matches_jax_planes_default():
    _assert_lut_matches()
    assert E.vlc_enc_lut()[1:3] == (5, 1)


def test_lut_follows_install_tables(normative_shaped):
    _assert_lut_matches()
    assert E.vlc_enc_lut()[1:] == (9, 2, 0b101)


def test_empty_invalid_and_overflowing_lanes():
    blocks = _blocks(5, [(8, 8)] * 4, [0.1, 50, 50, 1e5])
    blocks[0][0][:] = 0                       # numbps == 0: MEL runs only
    mneg, p, w, h, valid = _lanes(blocks, 8, 8)
    valid[1] = 0
    streams, bits = E.ht_encode_lanes(mneg, p, w, h, valid, 64, 64, 64)
    assert bits[:, 1].tolist() == [0, 0, 0] and not streams[1].any()
    assert bits[0, 0] == 0 and bits[1, 0] > 0
    # ~38 significant samples of ~17 bits need more than 64 bytes
    assert bits[0, 3] == -1 and (bits[:, 2] >= 0).all()


def test_wrapper_cpu_runs_plain_version_without_counting():
    lanes = _lanes(_blocks(6, [(8, 8), (5, 7)], [40, 400]), 8, 8)
    before = E.ht_encode_lanes.launches
    got = E.ht_encode_lanes(*lanes, 256, 64, 64)
    assert E.ht_encode_lanes.launches == before
    ref = E.ht_encode_lanes_ref(*lanes, 256, 64, 64)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_clear_unused_keeps_exactly_the_used_bytes():
    blocks = _blocks(8, [(8, 8), (5, 7), (8, 8)], [40, 400, 1e5])
    lanes = _lanes(blocks, 8, 8)
    streams, bits = E.ht_encode_lanes_ref(*lanes, 64, 64, 64)
    assert bits[0, 2] == -1                  # an overflowing stream
    # what the kernel leaves unwritten is anything: 0xFF here
    dirty = streams.clone()
    col = torch.arange(streams.shape[1])[None]
    for s, lo in enumerate((0, 64, 128)):
        nb = ((bits[s].to(torch.int64) + 7) >> 3)[:, None]
        dirty[(col >= lo + nb) & (col < lo + 64)] = 0xFF
    got = E.clear_unused(dirty, bits, 64, 64)
    assert torch.equal(got[:2], streams[:2])
    assert not got[2, :64].any() and torch.equal(got[2, 64:], streams[2, 64:])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    lanes = _lanes(_blocks(7, [(8, 8)], [40]), 8, 8)
    mneg, p, w, h, valid = lanes
    bad = [
        (mneg.to(torch.int64), p, w, h, valid),            # dtype
        (mneg, p.to(torch.int64), w, h, valid),
        (mneg, p, w[:0], h, valid),                         # lane count
        (mneg.transpose(1, 2), p, w, h, valid),             # layout
        (mneg[0], p, w, h, valid),                          # rank
        (mneg, p[:, None], w, h, valid),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            E.ht_encode_lanes(*args, 256, 64, 64)
    with pytest.raises(ValueError):
        E.ht_encode_lanes(*lanes, 258, 64, 64)              # not 4-aligned
    with pytest.raises(ValueError):
        E.ht_encode_lanes(torch.zeros((1, 8, 1024), dtype=torch.int32),
                          p, w, h, valid, 256, 64, 64)       # > 4096 samples
    with pytest.raises(ValueError):
        E.ht_encode_lanes(mneg, p.to("meta"), w, h, valid, 256, 64, 64)
