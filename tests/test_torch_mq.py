"""The port's Part-1 block coders (grok_tpu_torch/ops/t1_encode.py, K5, and
ops/t1_decode.py, K3) through their plain versions on the CPU, held
against the JAX package: the scalar coder grok_tpu/t1/t1_scalar.py
(`encode_block`, `decode_block`) and the XLA twin of the encode kernel
(grok_tpu/ops/t1_enc.py `t1_encode_batch`).  Every comparison is exact.
Also the committed mode-switch vectors (grok_tpu_torch/t1/mq_vectors.npz),
regenerated here from the scalar coder."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from grok_tpu.ops import pallas_t1_enc as jpe  # noqa: E402
from grok_tpu.ops.pallas_t1 import pack_for_pallas  # noqa: E402
from grok_tpu.ops.t1_enc import t1_encode_batch  # noqa: E402
from grok_tpu.t1.t1_scalar import decode_block, encode_block  # noqa: E402
from grok_tpu_torch.ops import t1_decode as D  # noqa: E402
from grok_tpu_torch.ops import t1_encode as E  # noqa: E402
from grok_tpu_torch.t1 import vectors  # noqa: E402

STYLES = (0x00, 0x01, 0x02, 0x04, 0x08, 0x20, 0x3F)
VEC_STYLES = (0x00, 0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x3F, 0x05, 0x09,
              0x22, 0x31, 0x0C, 0x15, 0x2A, 0x3E)


def _col(v):
    return torch.tensor(np.asarray(v), dtype=torch.int32)


def _enc_lanes(blocks, W, H):
    """K5's inputs for [(mag, neg, orient)] blocks in (W, H) lanes."""
    mneg = np.zeros((len(blocks), H, W), np.int32)
    for j, (m, n, _o) in enumerate(blocks):
        mneg[j, :m.shape[0], :m.shape[1]] = (m << 1) | n
    return (torch.from_numpy(mneg), _col([o for *_, o in blocks]),
            _col([int(m.max()).bit_length() if m.size else 0
                  for m, *_ in blocks]),
            _col([m.shape[1] for m, *_ in blocks]),
            _col([m.shape[0] for m, *_ in blocks]))


@pytest.fixture(scope="module")
def mixed_blocks():
    """Lanes of mixed shapes in one batch, all four orients, 0-6 planes,
    some sparse."""
    rng = np.random.default_rng(0)
    shapes = [(1, 1), (4, 4), (7, 5), (3, 16), (16, 16), (16, 16)]
    out = []
    for i in range(28):
        h, w = shapes[i % len(shapes)]
        nb = i % 7
        mag = rng.integers(0, 1 << nb, (h, w)) if nb \
            else np.zeros((h, w), np.int64)
        if i % 6 == 5:
            mag[rng.random((h, w)) < 0.9] = 0              # sparse
        out.append((mag, rng.random((h, w)) < 0.5, i % 4))
    return out


def test_encode_plain_matches_scalar_coder(mixed_blocks):
    ins = _enc_lanes(mixed_blocks, 16, 16)
    out, lens, rates, _st = E.t1_encode_lanes(*ins, 2048, 3 * 6 - 2)
    assert E.t1_encode_lanes.launches == 0            # the plain version
    for j, (m, n, o) in enumerate(mixed_blocks):
        e = encode_block(m, n, o)
        assert int(out[j, 0]) == 0                    # carry sentinel
        assert bytes(out[j, 1:1 + int(lens[j])].numpy()) == e.data, j
        if e.passes:
            assert E.pass_records(rates[j].numpy(), e.numbps,
                                  len(e.data))[0] \
                == [p.rate for p in e.passes] \
                == jpe.rates_from_watermarks(rates[j].numpy(), e.numbps,
                                             len(e.data))


def test_encode_plain_matches_xla_twin():
    rng = np.random.default_rng(1)
    B, W, H = 12, 8, 8
    mag = rng.integers(0, 8, (B, H, W))
    mag[rng.random(mag.shape) < 0.4] = 0
    mag[3] = 0                                         # an empty lane
    neg = rng.random(mag.shape) < 0.5
    ori = np.arange(B) % 4
    nbps = np.array([int(m.max()).bit_length() for m in mag], np.int32)
    msb = np.where(mag > 0, np.floor(np.log2(np.maximum(mag, 1))), -1)
    L = 2 * W * H + 128
    j_out, j_len, j_rates, j_st = (np.asarray(a) for a in t1_encode_batch(
        mag.astype(np.int32), neg, ori.astype(np.int32), nbps,
        msb.astype(np.int32), W, H, 4, L))
    mneg = torch.from_numpy(((mag << 1) | neg).astype(np.int32))
    out, lens, rates, st = E.t1_encode_lanes(mneg, _col(ori), _col(nbps),
                                             _col([W] * B), _col([H] * B),
                                             L, 3 * 3 - 2)
    assert np.array_equal(lens.numpy(), j_len)
    assert np.array_equal(rates.numpy(), j_rates[:, :7])
    assert not j_rates[:, 7:].any()
    assert np.array_equal(st.numpy(), j_st)
    for j in range(B):
        n = int(lens[j])
        assert np.array_equal(out[j, :1 + n].numpy(), j_out[j, :1 + n])


def test_encode_reports_capacity_overflow(mixed_blocks):
    ins = _enc_lanes(mixed_blocks, 16, 16)
    _out, lens, _r, _s = E.t1_encode_lanes(*ins, 8, 16)
    full = E.t1_encode_lanes(*ins, 2048, 16)[1]
    assert ((lens == -1) == (full + 1 > 8)).all() and (lens == -1).any()


def _coded(seed, style, n=21, side=16, trunc=True):
    """n scalar-coded blocks of random sizes up to side x side in
    `style`, some with truncated pass counts."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        w, h = int(rng.integers(1, side + 1)), int(rng.integers(1, side + 1))
        nb = 1 + i % 6
        mag = rng.integers(0, 1 << nb, (h, w))
        mag[rng.random((h, w)) < 0.5] = 0
        mag[0, 0] = max(int(mag[0, 0]), 1)
        neg = rng.random((h, w)) < 0.5
        e = encode_block(mag, neg, i % 4, style)
        npass = e.numpasses - (i % 4 if trunc else 0)
        out.append((w, h, i % 4, e, max(npass, 0)))
    return out


def _k3_lanes(coded, style):
    body = b"".join(c[3].data for c in coded) + b"\0"
    starts = np.cumsum([0] + [len(c[3].data) for c in coded])[:-1]
    npass, ptbl = D.segment_table([c[4] for c in coded],
                                  [c[3].numbps for c in coded],
                                  [style] * len(coded),
                                  [c[3].seg_lens for c in coded])
    return (torch.frombuffer(bytearray(body), dtype=torch.uint8),
            _col(starts), _col(npass), _col([c[3].numbps for c in coded]),
            _col([c[2] for c in coded]), _col([c[0] for c in coded]),
            _col([c[1] for c in coded]), _col([style] * len(coded)),
            torch.from_numpy(ptbl))


@pytest.mark.parametrize("style", STYLES)
def test_decode_plain_matches_scalar_decoder(style):
    coded = _coded(10 + style, style)
    got = D.t1_decode_lanes(*_k3_lanes(coded, style), 16, 16).numpy()
    assert D.t1_decode_lanes.launches == 0
    for j, (w, h, o, e, npass) in enumerate(coded):
        m2, ng = decode_block(e.data, e.seg_lens, npass, e.numbps, o, w, h,
                              style)
        assert np.array_equal(got[j, :h, :w], np.where(ng, -m2, m2)), j
        assert not got[j, h:].any() and not got[j, :, w:].any()


def test_segment_table_matches_pallas_packing():
    for style in (0x00, 0x01, 0x04, 0x15):
        coded = _coded(30 + style, style, n=12)
        blocks = [dict(data=e.data, numpasses=npass, numbps=e.numbps,
                       orient=o, w=w, h=h, style=style,
                       seg_lens=e.seg_lens) for w, h, o, e, npass in coded]
        jptbl = pack_for_pallas(blocks, 1)[5]                # (3, P8, 128)
        _np, ptbl = D.segment_table([b["numpasses"] for b in blocks],
                                    [b["numbps"] for b in blocks],
                                    [style] * len(blocks),
                                    [b["seg_lens"] for b in blocks])
        P = ptbl.shape[1]
        want = jptbl[:, :, :len(blocks)].transpose(2, 1, 0)
        assert np.array_equal(ptbl, want[:, :P])
        assert (want[:, P:, 0] == -1).all() and not want[:, P:, 2].any()


def test_encode_decode_plain_round_trip():
    rng = np.random.default_rng(3)
    blocks = []
    for i, (h, w) in enumerate([(1, 1), (5, 1), (1, 9), (13, 7), (16, 16),
                                (16, 16), (6, 11), (3, 3)]):
        mag = np.abs(rng.normal(0, 10 ** (i % 4), (h, w))).astype(np.int64)
        mag[rng.random((h, w)) < 0.3] = 0
        if i == 5:
            mag[:] = 0                                        # all zero
        blocks.append((mag, (rng.random((h, w)) < 0.5) & (mag > 0), i % 4))
    ins = _enc_lanes(blocks, 16, 16)
    out, lens, _r, _s = E.t1_encode_lanes(*ins, 4096, 40)
    nb = ins[2]
    body = torch.cat([out[j, 1:1 + int(lens[j])] for j in range(len(blocks))]
                     + [torch.zeros(1, dtype=torch.uint8)])
    start = torch.cumsum(lens, 0) - lens
    zero = torch.zeros_like(lens)
    ptbl = torch.stack([zero, lens, zero], 1)[:, None].contiguous()
    got = D.t1_decode_lanes(body, start.int(), (3 * nb - 2).clamp(min=0).int(),
                            nb, ins[1], ins[3], ins[4], zero, ptbl, 16, 16)
    assert torch.equal(got.abs() >> 1, ins[0] >> 1)
    assert torch.equal(got < 0, (ins[0] & 1) == 1)


def test_wrappers_refuse_what_the_kernels_do_not_take(mixed_blocks):
    ins = _enc_lanes(mixed_blocks, 16, 16)
    with pytest.raises(ValueError, match="multiple of 4"):
        E.t1_encode_lanes(*ins, 30, 16)
    with pytest.raises(ValueError, match="dtype"):
        E.t1_encode_lanes(ins[0].long(), *ins[1:], 64, 16)
    with pytest.raises(ValueError, match="is on cpu, expected meta"):
        E.t1_encode_lanes(ins[0].to("meta"), *ins[1:], 64, 16)
    with pytest.raises(ValueError, match="no Part-1 encode kernel"):
        E.t1_encode_lanes(*(t.to("meta") for t in ins), 64, 16)
    la = _k3_lanes(_coded(5, 0, n=3), 0)
    # sides up to 1024 within 4096 samples (A.6.1); the first design up
    # to 64 x 64
    with pytest.raises(ValueError, match="outside"):
        D.t1_decode_lanes(*la, 65, 64)
    with pytest.raises(ValueError, match="outside"):
        D.t1_decode_lanes_v1(*la, 65, 16)
    with pytest.raises(ValueError, match="shape"):
        D.t1_decode_lanes(la[0], la[1][:2], *la[2:], 16, 16)


def make_mq_vectors(seed: int = 11, n: int = 32, side: int = 16) -> dict:
    """The mode-switch vectors of grok_tpu_torch/t1/vectors.py, from the
    JAX package's scalar coder."""
    rng = np.random.default_rng(seed)
    body, start, segs, rows = [], [], [], []
    mag2s = np.zeros((n, side, side), np.int32)
    pos = 0
    for i in range(n):
        style = VEC_STYLES[i % len(VEC_STYLES)]
        w, h = int(rng.integers(4, side + 1)), int(rng.integers(4, side + 1))
        nb = int(rng.integers(1, 9))
        mag = rng.integers(0, 1 << nb, (h, w))
        mag[rng.random((h, w)) < rng.uniform(0.2, 0.8)] = 0
        mag[0, 0] = max(int(mag[0, 0]), 1 << (nb - 1))
        neg = rng.random((h, w)) < 0.5
        orient = i % 4
        e = encode_block(mag, neg, orient, style)
        npass = e.numpasses - (i % 5 == 4) * int(
            rng.integers(1, e.numpasses + 1))
        m2, ng = decode_block(e.data, e.seg_lens, npass, e.numbps, orient,
                              w, h, style)
        mag2s[i, :h, :w] = np.where(ng, -m2, m2)
        body.append(e.data)
        start.append(pos)
        pos += len(e.data)
        segs.append(list(e.seg_lens))
        rows.append((npass, e.numbps, orient, w, h, style))
    S = max(len(s) for s in segs)
    seg_lens = np.full((n, S), -1, np.int32)
    for i, s in enumerate(segs):
        seg_lens[i, :len(s)] = s
    r = np.asarray(rows, np.int32).T
    return dict(body=np.frombuffer(b"".join(body), np.uint8).copy(),
                start=np.asarray(start, np.int32), seg_lens=seg_lens,
                npass=r[0], nbps=r[1], orient=r[2], w=r[3], h=r[4],
                style=r[5], mag2=mag2s)


def test_mode_switch_vectors_are_current():
    """The committed vectors equal a fresh run of the scalar coder (to
    rewrite them: np.savez_compressed(vectors.PATH, **make_mq_vectors()))
    and the plain decoder reproduces them."""
    want = make_mq_vectors()
    got = vectors.load()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k
    assert {s & 0x3F for s in got["style"]} >= set(STYLES) | {0x10}
    dec = D.t1_decode_lanes(*vectors.k3_lanes(got, "cpu"), vectors.SIDE,
                            vectors.SIDE)
    assert np.array_equal(dec.numpy(), got["mag2"])
