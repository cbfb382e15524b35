"""Card-only tests of the port: the HT, Part-1 and per-lane gather CUDA
kernels (a kernel has no CPU mode) against their plain PyTorch versions,
the redesigned kernels' first designs, the scalar HT coder, the committed
Part-1 mode-switch vectors and torch.take_along_dim, on seeded and (HT
decoders) corrupt lanes, and the serving decode and encode (targeted and
layered Part-1 too) on the card against the source pixels, the host
encoder and the port's CPU encode.

Every test skips without a CUDA card.  The file imports no JAX, so it
runs on a machine with PyTorch and a card but no JAX:

    python -m pytest --noconftest -o addopts= -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grok_tpu import CompressParams, compress  # noqa: E402
from grok_tpu.t1ht import tables as T  # noqa: E402
from grok_tpu.t1ht.scalar import ht_decode_block, ht_encode_block  # noqa: E402,E501
from grok_tpu.t1ht.wire import split_cleanup  # noqa: E402
from grok_tpu.util.oracle import synthetic_image  # noqa: E402
from grok_tpu_torch import api  # noqa: E402
from grok_tpu_torch.core.params import CompressParams as PCP  # noqa: E402
from grok_tpu_torch.ops import ht_decode as H  # noqa: E402
from grok_tpu_torch.ops import ht_encode as E  # noqa: E402
from grok_tpu_torch.ops import lane_gather as G  # noqa: E402
from grok_tpu_torch.ops import t1_decode as D3  # noqa: E402
from grok_tpu_torch.ops import t1_encode as E5  # noqa: E402
from grok_tpu_torch.t1 import vectors  # noqa: E402
from grok_tpu_torch.t1ht import tables as PT  # noqa: E402
from grok_tpu_torch.tools import hw_validate  # noqa: E402
from test_ht_tables_dropin import _synthetic_normative_tables  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _blocks(seed, n, side, sigmas):
    """n HT blocks of random sizes up to side x side, their clean
    sub-streams as the kernel's lanes, and the scalar decode of each."""
    rng = np.random.default_rng(seed)
    streams, dims, refs = [], [], []
    for i in range(n):
        w, h = int(rng.integers(1, side + 1)), int(rng.integers(1, side + 1))
        mag = np.abs(rng.normal(0, sigmas[i % len(sigmas)], (h, w)))
        mag = mag.astype(np.int64)
        mag[rng.random((h, w)) < 0.4] = 0
        mag[0, 0] = max(int(mag[0, 0]), 3)
        neg = rng.random((h, w)) < 0.5
        enc = ht_encode_block(mag, neg, i % 4)
        streams.append(split_cleanup(enc.data, enc.seg_lens[0]))
        dims.append((w, h))
        refs.append(ht_decode_block(enc.data, enc.seg_lens, 1, enc.numbps,
                                    i % 4, w, h))

    def pack(k):
        L = H._quant_len(max(len(s[k]) for s in streams))
        a = np.zeros((n, L + 1), np.uint8)
        for j, s in enumerate(streams):
            a[j, :len(s[k])] = np.frombuffer(s[k], np.uint8)
        return torch.from_numpy(a)

    def col(v):
        return torch.tensor(v, dtype=torch.int32)

    lanes = (pack(0), pack(1), pack(2), col([0] * n),
             col([d[0] for d in dims]), col([d[1] for d in dims]),
             col([1] * n))
    return lanes, dims, refs


def _check_kernel(card, seed, sigmas):
    lanes, dims, refs = _blocks(seed, 96, 64, sigmas)
    dev = [t.to(card) for t in lanes]
    before = H.ht_decode_lanes.launches
    got, err = H.ht_decode_lanes(*dev, 64, 64)
    torch.cuda.synchronize()
    assert H.ht_decode_lanes.launches == before + 1
    ref, rerr = H.ht_decode_lanes_ref(*dev, 64, 64)
    assert torch.equal(got, ref) and torch.equal(err, rerr)
    assert not err.any()
    out = got.cpu().numpy()
    for j, ((w, h), (m2, ng)) in enumerate(zip(dims, refs)):
        assert np.array_equal(np.abs(out[j, :h, :w]), m2), j
        assert np.array_equal(out[j, :h, :w] < 0, ng), j


def test_kernel_matches_plain_version_and_scalar(card):
    _check_kernel(card, 0, [2, 9, 40, 300, 5000])


def _install_dropin():
    """The drop-in table shape, in both packages: the scalar coder reads
    the JAX package's tables, the port's kernels read the port's."""
    lens_ek, lens_init = _synthetic_normative_tables()
    for tables in (T, PT):
        tables.install_tables(lens=lens_ek, lens_init=lens_init,
                              uvlc_prefix_xor=0b101)
        assert tables.two_families() and tables.tables_have_ek()


def _reset_tables():
    T.reset_tables()
    PT.reset_tables()


def test_kernel_follows_install_tables(card):
    _install_dropin()
    try:
        _check_kernel(card, 1, [3, 8, 20])
    finally:
        _reset_tables()


def test_kernel_rejects_mixed_devices(card):
    lanes, _dims, _refs = _blocks(2, 4, 8, [20])
    dev = [t.to(card) for t in lanes]
    with pytest.raises(ValueError):
        H.ht_decode_lanes(*dev[:3], lanes[3], *dev[4:], 8, 8)


def test_serving_decode_on_card(card):
    cp = CompressParams(ht=True, num_resolutions=3, cblk_w_exp=5,
                        cblk_h_exp=5)
    imgs = [synthetic_image(80, 96, 1, seed=20 + i) for i in range(3)]
    rgb = synthetic_image(64, 96, 3, seed=5)
    before = H.ht_decode_lanes.launches
    out = api.decompress_device_batch([compress(im, cp) for im in imgs],
                                      device=card)
    torch.cuda.synchronize()
    assert H.ht_decode_lanes.launches > before
    for img, comps in zip(imgs, out):
        assert comps[0].device.type == "cuda"
        assert np.array_equal(comps[0].cpu().numpy(), img)
    got = api.decompress_device(compress(rgb, cp), device=card)
    assert np.array_equal(torch.stack(got, -1).cpu().numpy(), rgb)


def _enc_lanes(seed, n, side):
    rng = np.random.default_rng(seed)
    mneg = np.zeros((n, side, side), np.int32)
    ws, hs = [], []
    for i in range(n):
        w, h = int(rng.integers(1, side + 1)), int(rng.integers(1, side + 1))
        mag = np.abs(rng.normal(0, float(10 ** rng.uniform(0, 4)),
                                (h, w))).astype(np.int64)
        mag[rng.random((h, w)) < rng.uniform(0, 0.9)] = 0
        neg = rng.random((h, w)) < 0.5
        mneg[i, :h, :w] = (mag << 1) | neg
        ws.append(w)
        hs.append(h)

    def col(v):
        return torch.tensor(v, dtype=torch.int32)
    return (torch.from_numpy(mneg), col([i % 3 == 1 for i in range(n)]),
            col(ws), col(hs), col([int(i != 5) for i in range(n)]))


def _check_encoder(card, seed):
    lanes = _enc_lanes(seed, 96, 64)
    caps = (64 * 64 * 28 // 8 + 64, 1024, 2048)
    dev = [t.to(card) for t in lanes]
    before = E.ht_encode_lanes.launches
    got = E.ht_encode_lanes(*dev, *caps)
    torch.cuda.synchronize()
    assert E.ht_encode_lanes.launches == before + 1
    ref = E.ht_encode_lanes_ref(*lanes, *caps)
    assert torch.equal(got[1].cpu(), ref[1])
    # the kernel leaves the bytes past each stream's bits unwritten
    assert torch.equal(E.clear_unused(*got, *caps[:2]).cpu(), ref[0])
    _assert_encodes_equal(got, E.ht_encode_lanes_v1(*dev, *caps), caps[:2])


def _assert_encodes_equal(got, ref, caps):
    """Two ht_encode_lanes results equal: bit counts, used bytes, ns."""
    assert torch.equal(got[1], ref[1])
    assert torch.equal(E.clear_unused(got[0], got[1], *caps),
                       E.clear_unused(ref[0], ref[1], *caps))
    for a, b in zip(got[2:], ref[2:]):
        assert torch.equal(a, b)


def test_encoder_matches_plain_version(card):
    _check_encoder(card, 3)


def test_encoder_follows_install_tables(card):
    _install_dropin()
    try:
        _check_encoder(card, 4)
    finally:
        _reset_tables()


def test_encoder_reports_overflow(card):
    lanes = _enc_lanes(6, 8, 32)
    dev = [t.to(card) for t in lanes]
    _streams, bits = E.ht_encode_lanes(*dev, 8, 8, 8)
    ref = E.ht_encode_lanes_ref(*lanes, 8, 8, 8)[1]
    assert torch.equal(bits.cpu(), ref) and (ref < 0).any()
    assert torch.equal(E.ht_encode_lanes_v1(*dev, 8, 8, 8)[1], bits)


def test_serving_encode_on_card(card):
    cp = dict(ht=True, num_resolutions=3, cblk_w_exp=5, cblk_h_exp=5)
    imgs = [synthetic_image(80, 96, 1, seed=20 + i) for i in range(3)]
    before = E.ht_encode_lanes.launches
    got = api.compress_device_batch(imgs, PCP(**cp), device=card)
    assert E.ht_encode_lanes.launches > before
    assert got == [compress(im, CompressParams(**cp)) for im in imgs]
    rgb = synthetic_image(64, 96, 3, seed=5)
    assert api.compress_device(rgb, PCP(**cp), device=card) == \
        compress(rgb, CompressParams(**cp))


def _mq_lanes(seed, n, side, maxnb):
    """K5's inputs: n lanes of random sizes up to side x side."""
    rng = np.random.default_rng(seed)
    mneg = np.zeros((n, side, side), np.int32)
    ws, hs, nbs = [], [], []
    for i in range(n):
        w, h = int(rng.integers(1, side + 1)), int(rng.integers(1, side + 1))
        nb = int(rng.integers(0, maxnb + 1))
        mag = rng.integers(0, 1 << nb, (h, w)) if nb \
            else np.zeros((h, w), np.int64)
        mag[rng.random((h, w)) < rng.uniform(0, 0.9)] = 0
        mneg[i, :h, :w] = (mag << 1) | (rng.random((h, w)) < 0.5)
        ws.append(w)
        hs.append(h)
        nbs.append(int(mag.max()).bit_length())

    def col(v):
        return torch.tensor(v, dtype=torch.int32)
    return (torch.from_numpy(mneg), col([i % 4 for i in range(n)]), col(nbs),
            col(ws), col(hs))


def test_part1_kernels_match_plain_versions(card):
    ins = _mq_lanes(7, 48, 64, 12)
    L, R = 64 * 64 * 4 + 64, 3 * 12 - 2
    before = E5.t1_encode_lanes.launches
    got = E5.t1_encode_lanes(*[t.to(card) for t in ins], L, R)
    torch.cuda.synchronize()
    assert E5.t1_encode_lanes.launches == before + 1
    ref = E5.t1_encode_lanes_ref(*ins, L, R)
    lens = got[1].cpu()
    assert torch.equal(lens, ref[1]) and (lens >= 0).all()
    assert torch.equal(got[2].cpu(), ref[2])
    assert torch.equal(got[3].cpu(), ref[3])
    for j in range(lens.shape[0]):
        n = int(lens[j])
        assert torch.equal(got[0][j, :1 + n].cpu(), ref[0][j, :1 + n]), j
    # K3 on the codewords: equal to its plain version and to the source
    body = torch.cat([ref[0][j, 1:1 + int(lens[j])]
                      for j in range(lens.shape[0])]
                     + [torch.zeros(1, dtype=torch.uint8)])
    start = (torch.cumsum(lens, 0) - lens).int()
    zero = torch.zeros_like(lens)
    ptbl = torch.stack([zero, lens, zero], 1)[:, None].contiguous()
    args = (body, start, (3 * ins[2] - 2).clamp(min=0).int(), ins[2],
            ins[1], ins[3], ins[4], zero, ptbl)
    before = D3.t1_decode_lanes.launches
    dec = D3.t1_decode_lanes(*[a.to(card) for a in args], 64, 64).cpu()
    assert D3.t1_decode_lanes.launches == before + 1
    assert torch.equal(dec, D3.t1_decode_lanes_ref(*args, 64, 64))
    assert torch.equal(dec.abs() >> 1, ins[0] >> 1)


def test_part1_encoder_reports_overflow(card):
    ins = _mq_lanes(8, 16, 32, 10)
    got = E5.t1_encode_lanes(*[t.to(card) for t in ins], 16, 28)[1].cpu()
    assert torch.equal(got, E5.t1_encode_lanes_ref(*ins, 16, 28)[1])
    assert (got == -1).any()


def test_part1_decoder_on_mode_switch_vectors(card):
    v = vectors.load()
    la = vectors.k3_lanes(v, card)
    got = D3.t1_decode_lanes(*la, vectors.SIDE, vectors.SIDE).cpu().numpy()
    assert np.array_equal(got, v["mag2"])


@pytest.mark.parametrize("kw", [dict(), dict(ht_mixed=True)])
def test_part1_and_mixed_serving_encode_on_card(card, kw):
    cp = PCP(num_resolutions=3, cblk_w_exp=4, cblk_h_exp=4, **kw)
    imgs = [synthetic_image(40, 56, 1, seed=30 + i) for i in range(2)]
    before = E5.t1_encode_lanes.launches
    got = api.compress_device_batch(imgs, cp, device=card)
    assert E5.t1_encode_lanes.launches > before
    assert got == api.compress_device_batch(imgs, cp, device="cpu")
    out = api.decompress_device_batch(got, device=card)
    for img, comps in zip(imgs, out):
        assert np.array_equal(comps[0].cpu().numpy(), img)


def test_refine_kernels_match_plain_versions(card):
    """K4r and K2 on 96 lanes of up to 64x64 (cleanup planes 0..3): the
    encode byte-identical to its plain version, the decode of its streams
    at every pass count bit-exact to its plain version."""
    lanes = _enc_lanes(9, 96, 64)
    lanes = (lanes[0], torch.tensor([i % 4 for i in range(96)],
                                    dtype=torch.int32)) + lanes[2:]
    caps = (64 * 64 * 28 // 8 + 64, 1024, 2048)
    dev = [t.to(card) for t in lanes]
    before = E.ht_encode_lanes.refine_launches
    got = E.ht_encode_lanes(*dev, *caps, refine=True)
    torch.cuda.synchronize()
    assert E.ht_encode_lanes.refine_launches == before + 1
    ref = E.ht_encode_lanes(*lanes, *caps, refine=True)
    assert torch.equal(got[1].cpu(), ref[1]) and (ref[1] >= 0).all()
    allcaps = caps + E.refine_caps(64, 64)
    used = E.clear_unused(got[0], got[1], *allcaps[:-1]).cpu()
    assert torch.equal(used, E.clear_unused(*ref[:2], *allcaps[:-1]))
    assert torch.equal(got[2].cpu(), ref[2])
    starts = np.cumsum((0,) + allcaps)
    cut = [torch.nn.functional.pad(used[:, a:b], (0, 1)).contiguous()
           for a, b in zip(starts[:-1], starts[1:])]
    for n in (1, 2, 3):
        npv = torch.full((96,), n, dtype=torch.int32)
        args = (*cut[:3], *lanes[1:], 64, 64, cut[3], cut[4], npv)
        before = H.ht_decode_lanes.refine_launches
        out, err = H.ht_decode_lanes(*[a.to(card) if torch.is_tensor(a)
                                       else a for a in args])
        torch.cuda.synchronize()
        assert H.ht_decode_lanes.refine_launches == before + 1
        ref, rerr = H.ht_decode_lanes_ref(*args)
        assert torch.equal(out.cpu(), ref) and torch.equal(err.cpu(), rerr)


@pytest.mark.parametrize("rows, L", [(64, 128), (1000, 7), (3, 1)])
def test_lane_gather_matches_plain_version_and_library(card, rows, L):
    rng = np.random.default_rng(rows)
    x = torch.from_numpy(rng.integers(-2**31, 2**31, (rows, L),
                                      dtype=np.int32)).to(card)
    idx = torch.from_numpy(rng.integers(0, rows, (rows, L),
                                        dtype=np.int32)).to(card)
    before = G.lane_gather.launches
    got = G.lane_gather(x, idx)
    torch.cuda.synchronize()
    assert G.lane_gather.launches == before + 1
    assert torch.equal(got, G.lane_gather_ref(x, idx))
    assert torch.equal(got, torch.take_along_dim(x, idx.long(), dim=0))


@pytest.mark.parametrize("rows, L", list(hw_validate.GATHER_SHAPES)
                         + [(65536, 128)])
def test_lane_gather_matches_first_design_on_awkward_shapes(card, rows, L):
    """P1 (lane groups of 4 where L % 4 == 0 and the pointers are 16-byte
    aligned, else its scalar form) against its plain version, its first
    design and numpy: indices in range, out of range (0 there), and
    unaligned views; one launch a call."""
    for what, x, idx in hw_validate.gather_cases(rows, L, rows + L, card):
        before = G.lane_gather.launches, G.lane_gather_v1.launches
        got = G.lane_gather(x, idx)
        old = G.lane_gather_v1(x, idx)
        torch.cuda.synchronize()
        assert (G.lane_gather.launches, G.lane_gather_v1.launches) == (
            before[0] + 1, before[1] + 1)
        assert torch.equal(got, G.lane_gather_ref(x, idx)), what
        assert torch.equal(got, old), what
        assert np.array_equal(got.cpu().numpy(),
                              hw_validate.gather_want(x, idx)), what


@pytest.mark.parametrize("kw", [dict(rates=[4.0]),
                                dict(num_layers=3, rates=[40.0, 10.0, 4.0])])
def test_targeted_part1_serving_encode_on_card(card, kw):
    """The rate-targeted and layered Part-1 encode on the card (K5, the
    distortion sums, the PCRD finish, trial decodes with K3) equals the
    CPU encode through the plain versions and the host encoder; its
    layer-capped decodes on the card equal the CPU decodes."""
    cp = dict(num_resolutions=3, cblk_w_exp=5, cblk_h_exp=5, **kw)
    img = synthetic_image(64, 96, 3, seed=5)
    before = D3.t1_decode_lanes.launches
    got = api.compress_device(img, PCP(**cp), device=card)
    assert D3.t1_decode_lanes.launches > before      # the trial decodes
    assert got == api.compress_device(img, PCP(**cp), device="cpu")
    assert got == compress(img, CompressParams(**cp))
    for k in range(1, cp.get("num_layers", 1) + 1):
        dp = api.DecompressParams(max_layers=k)
        out = api.decompress_device(got, dp, device=card)
        want = api.decompress_device(got, dp, device="cpu")
        assert all(torch.equal(a.cpu(), b) for a, b in zip(out, want))


def test_refined_serving_encode_and_general_decode_on_card(card):
    cp = dict(ht=True, num_resolutions=3, cblk_w_exp=5, cblk_h_exp=5,
              ht_planes=2, num_layers=2, rates=[4.0, 1.5])
    img = synthetic_image(64, 96, 3, seed=5)
    got = api.compress_device(img, PCP(**cp), device=card)
    assert got == api.compress_device(img, PCP(**cp), device="cpu")
    assert got == compress(img, CompressParams(**cp))
    for k in (1, 2):
        dp = api.DecompressParams(max_layers=k)
        out = api.decompress_device(got, dp, device=card)
        assert all(c.device.type == "cuda" for c in out)
        want = api.decompress_device(got, dp, device="cpu")
        assert all(torch.equal(a.cpu(), b) for a, b in zip(out, want))


def test_capped_layered_ht_batch_served_on_card(card):
    """A layer cap on a layered, cleanup-only HT batch stays on the
    serving decode: one K1 launch per bucket that holds an HT lane (one
    in all at max_layers=1), no K2."""
    cp = CompressParams(ht=True, num_resolutions=3, cblk_w_exp=5,
                        cblk_h_exp=5, ht_planes=0, num_layers=2,
                        rates=[8.0, 2.0])
    streams = [compress(synthetic_image(80, 96, 1, seed=40 + i), cp)
               for i in range(2)]
    for k in (1, 2):
        dp = api.DecompressParams(max_layers=k)
        staged = api.stage_device_batch(streams, dp, device="cpu")
        buckets = sum(bool(d[3]) for d in staged.dims)     # any HT lane
        assert k > 1 or buckets == 1
        k1, k2 = H.ht_decode_lanes.launches, H.ht_decode_lanes.refine_launches
        out = api.decompress_device_batch(streams, dp, device=card)
        torch.cuda.synchronize()
        assert H.ht_decode_lanes.launches == k1 + buckets
        assert H.ht_decode_lanes.refine_launches == k2
        want = api.decompress_device_batch(streams, dp, device="cpu")
        for a, b in zip(out, want):
            assert torch.equal(a[0].cpu(), b[0])


@pytest.mark.parametrize("tables", ["default", "dropin"])
@pytest.mark.parametrize("refine", [False, True])
def test_ht_encoders_match_first_design(card, tables, refine):
    """K4 and K4r (one warp per lane) against their first designs (one
    thread per lane, the full-lane oracle) and their plain versions on
    every lane, at cleanup planes 0..3, under both table families, with
    room and with capacities that some lanes overflow."""
    lanes = _enc_lanes(13, 96, 64)
    lanes = (lanes[0], torch.tensor([i % 4 for i in range(96)],
                                    dtype=torch.int32)) + lanes[2:]
    dev = [t.to(card) for t in lanes]
    if tables == "dropin":
        _install_dropin()
    try:
        for caps in ((64 * 64 * 28 // 8 + 64, 1024, 2048), (256, 8, 32)):
            allcaps = caps + E.refine_caps(64, 64) if refine else caps
            got = E.ht_encode_lanes(*dev, *caps, refine=refine)
            _assert_encodes_equal(
                got, E.ht_encode_lanes_v1(*dev, *caps, refine=refine),
                allcaps[:-1])
            _assert_encodes_equal(
                [t.cpu() for t in got],
                E.ht_encode_lanes(*lanes, *caps, refine=refine),
                allcaps[:-1])
        assert (got[1] < 0).any() and (got[1] >= 0).any()
    finally:
        if tables == "dropin":
            _reset_tables()


def test_part1_kernels_match_first_design(card):
    """K5 and K3 (one warp per lane) against their first designs (one
    thread per lane, the full-lane oracle) on every lane, bit for bit."""
    ins = [t.to(card) for t in _mq_lanes(12, 96, 64, 14)]
    L, R = 64 * 64 * 4 + 64, 3 * 14 - 2
    got = E5.t1_encode_lanes(*ins, L, R)
    ref = E5.t1_encode_lanes_v1(*ins, L, R)
    lens = got[1]
    assert torch.equal(lens, ref[1]) and (lens >= 0).all()
    assert torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])
    used = torch.arange(L, device=card)[None] <= lens.long()[:, None]
    assert torch.equal(torch.where(used, got[0], 0),
                       torch.where(used, ref[0], 0))
    lens = lens.cpu()
    body = torch.cat([got[0][j, 1:1 + int(lens[j])].cpu()
                      for j in range(lens.shape[0])]
                     + [torch.zeros(1, dtype=torch.uint8)])
    start = (torch.cumsum(lens, 0) - lens).int()
    zero = torch.zeros_like(lens)
    ptbl = torch.stack([zero, lens, zero], 1)[:, None].contiguous()
    nb = ins[2].cpu()
    args = [a.to(card) for a in (body, start, (3 * nb - 2).clamp(min=0).int(),
                                 nb, ins[1].cpu(), ins[3].cpu(), ins[4].cpu(),
                                 zero, ptbl)]
    assert torch.equal(D3.t1_decode_lanes(*args, 64, 64),
                       D3.t1_decode_lanes_v1(*args, 64, 64))


def _ht_dec_lanes(seed, n, side):
    """K2's lanes (on the CPU): n lanes of up to side x side at cleanup
    planes 0..3 (one invalid) coded by the plain K4r, their clean streams
    cut into rows, at 3, 2 and 1 passes in turn."""
    lanes = _enc_lanes(seed, n, side)
    lanes = (lanes[0], torch.tensor([i % 4 for i in range(n)],
                                    dtype=torch.int32)) + lanes[2:]
    caps = (side * side * 28 // 8 + 64, 1024, 2048)
    streams, bits, _ns = E.ht_encode_lanes(*lanes, *caps, refine=True)
    allcaps = caps + E.refine_caps(side, side)
    used = E.clear_unused(streams, bits, *allcaps[:-1])
    starts = np.cumsum((0,) + allcaps)
    cut = [torch.nn.functional.pad(used[:, a:b], (0, 1)).contiguous()
           for a, b in zip(starts[:-1], starts[1:])]
    npass = torch.tensor([3 - i % 3 for i in range(n)], dtype=torch.int32)
    return (*cut[:3], *lanes[1:], cut[3], cut[4], npass)


def _corrupted(lanes, seed):
    """The lanes with every stream cut short on even lanes (zero from a
    random byte on) and replaced by random bytes on odd ones."""
    rng = np.random.default_rng(seed)
    out = list(lanes)
    for s in (0, 1, 2, 7, 8):
        t = out[s].clone()
        for j in range(t.shape[0]):
            if j % 2 == 0:
                t[j, int(rng.integers(0, t.shape[1])):] = 0
            else:
                t[j] = torch.from_numpy(rng.integers(0, 256, t.shape[1],
                                                     dtype=np.uint8))
        out[s] = t
    return tuple(out)


@pytest.mark.parametrize("tables", ["default", "dropin"])
def test_ht_decoders_match_first_design(card, tables):
    """K1 and K2 (one warp per lane) against their first designs (one
    thread per lane, the full-lane oracle of valid lanes) and their plain
    versions on every lane of 96 seeded lanes of up to 64x64 (an invalid
    lane, cleanup planes 0..3, 1..3 passes), and against their plain
    versions, error codes included, on the same lanes corrupted (the
    first design reads 0-bits past a row, caps U at 25 and flags
    nothing), under both table families; one launch each."""
    if tables == "dropin":
        _install_dropin()
    try:
        clean = _ht_dec_lanes(14, 96, 64)
        for lanes in (clean, _corrupted(clean, 15)):
            dev = [t.to(card) for t in lanes]
            for k2 in (False, True):
                more = dev[7:] if k2 else []
                before = (H.ht_decode_lanes.launches,
                          H.ht_decode_lanes.refine_launches)
                got, err = H.ht_decode_lanes(*dev[:7], 64, 64, *more)
                torch.cuda.synchronize()
                assert (H.ht_decode_lanes.launches,
                        H.ht_decode_lanes.refine_launches) == (
                    before[0] + (not k2), before[1] + k2)
                if lanes is clean:
                    assert torch.equal(got, H.ht_decode_lanes_v1(
                        *dev[:7], 64, 64, *more))
                    assert not err.any()
                ref, rerr = H.ht_decode_lanes_ref(
                    *lanes[:7], 64, 64, *(lanes[7:] if k2 else []))
                assert torch.equal(got.cpu(), ref)
                assert torch.equal(err.cpu(), rerr)
        assert got.abs().max() > 0
    finally:
        if tables == "dropin":
            _reset_tables()


@pytest.mark.parametrize("seed, count, bw, bh", [
    (17, 48, 16, 16), (6, 24, 32, 32), (7, 12, 128, 8), (8, 8, 16, 128),
    (9, 8, 1024, 4)])
def test_ht_decoders_flag_lanes_and_take_wide_lanes(card, seed, count, bw,
                                                     bh):
    """K1 and K2 on lanes whose bytes were flipped (tests/
    test_torch_strict.py: invalid codewords, exponent bounds over 40, U
    up to 40 and UVLC escapes), narrow (the two-warp design) and wide
    (W or H over 64: the wide design): equal to the plain version,
    error codes included."""
    import grok_tpu.t1ht.scalar as scalar
    from test_torch_strict import flipped_jobs, port_lanes
    jobs = [j for j in flipped_jobs(seed, count, bw, bh)
            if scalar.parse_cleanup(j["data"], j["seg_lens"][0])]
    lanes = port_lanes(jobs, bw, bh)
    dev = [t.to(card) for t in lanes]
    for more, cpu_more in ((dev[7:], lanes[7:]), ([], [])):
        got, err = H.ht_decode_lanes(*dev[:7], bw, bh, *more)
        ref, rerr = H.ht_decode_lanes_ref(*lanes[:7], bw, bh, *cpu_more)
        assert torch.equal(err.cpu(), rerr)
        assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("W, H", [(128, 32), (16, 256), (1024, 4)])
def test_part1_decoder_on_wide_lanes(card, W, H):
    """K3 on lanes over 64 on a side (a stripe in chunks of 64 columns),
    coded by the plain K5: equal to its plain version and the source."""
    rng = np.random.default_rng(W * H + 3)
    mneg = np.zeros((6, H, W), np.int32)
    dims = []
    for j in range(6):
        w = W if j < 3 else int(rng.integers(1, W + 1))
        h = H if j < 3 else int(rng.integers(1, H + 1))
        mag = rng.integers(0, 1 << 3, (h, w)) * (rng.random((h, w)) < 0.5)
        neg = rng.random((h, w)) < 0.5
        mneg[j, :h, :w] = (mag << 1) | (neg & (mag > 0))
        dims.append((w, h))
    col = lambda v: torch.tensor(list(v), dtype=torch.int32)  # noqa: E731
    nb = col(int(np.abs(mneg[j] >> 1).max()).bit_length() for j in range(6))
    ins = (torch.from_numpy(mneg), col(j % 4 for j in range(6)), nb,
           col(d[0] for d in dims), col(d[1] for d in dims))
    L, R = W * H * 3 + 64, 3 * 3 - 2
    out, lens, _r, _s = E5.t1_encode_lanes_ref(*ins, L, R)
    body = torch.cat([out[j, 1:1 + int(lens[j])] for j in range(6)]
                     + [torch.zeros(1, dtype=torch.uint8)])
    start = (torch.cumsum(lens, 0) - lens).to(torch.int32)
    zero = torch.zeros_like(lens)
    ptbl = torch.stack([zero, lens, zero], 1)[:, None].contiguous()
    lanes = (body, start, (3 * nb - 2).clamp(min=0).to(torch.int32), nb,
             ins[1], ins[3], ins[4], zero, ptbl)
    got = D3.t1_decode_lanes(*(t.to(card) for t in lanes), W, H)
    want = D3.t1_decode_lanes_ref(*lanes, W, H)
    assert torch.equal(got.cpu(), want)
    assert np.array_equal(np.abs(want.numpy()) >> 1, mneg >> 1)


@pytest.mark.parametrize("kw", [dict(ht=True), dict(),
                                dict(ht=True, ht_planes=2, num_layers=2,
                                     rates=[8.0, 2.0])],
                         ids=["HT", "Part-1", "refined"])
def test_wide_block_decode_on_card(card, kw):
    """A 160x136 RGB stream in 128x32 code-blocks decoded on the card
    equal to the CPU decode (the plain versions), strict included."""
    img = synthetic_image(136, 160, 3, seed=44)
    if "ht" not in kw:
        img = img >> 5
    data = compress(img, CompressParams(num_resolutions=3, cblk_w_exp=7,
                                        cblk_h_exp=5, **kw))
    from grok_tpu_torch.core.params import DecompressParams as PDP
    for dp in (PDP(), PDP(strict=True)):
        got = api.decompress_device(data, dp, device=card)
        want = api.decompress_device(data, dp, device="cpu")
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("kw", [dict(ht=True), dict()], ids=["HT", "Part-1"])
def test_tiled_encode_and_decode_on_card(card, kw):
    """A 136 x 200 RGB frame in 64-px tiles (3 x 4 tiles, the edge tiles
    8 tall and 8 wide, not a multiple of 2^4): one block-coder launch (K4
    or K5) per tile for the encode, equal to the CPU encode; one K3 launch
    per tile, or K1 launches per tile and bucket, for the decode,
    bit-exact to the source; a window across four tiles launches for
    those tiles only."""
    cp = PCP(num_resolutions=5, cblk_w_exp=5, cblk_h_exp=5, tile_w=64,
             tile_h=64, write_tlm=True, **kw)
    img = synthetic_image(136, 200, 3, seed=12)
    ntiles = 3 * 4
    enc = E.ht_encode_lanes if kw else E5.t1_encode_lanes
    n0 = enc.launches
    got = api.compress_device(img, cp, device=card)
    assert enc.launches == n0 + ntiles
    assert got == api.compress_device(img, cp, device="cpu")
    dec = H.ht_decode_lanes if kw else D3.t1_decode_lanes
    n0 = dec.launches
    out = api.decompress_device(got, device=card)
    torch.cuda.synchronize()
    full = dec.launches - n0
    if kw:
        assert full >= ntiles                   # K1: per tile and bucket
    else:
        assert full == ntiles                   # K3: one per tile
    assert np.array_equal(torch.stack(out, -1).cpu().numpy(), img)
    n0 = dec.launches
    win = api.DecompressParams(window=(60, 60, 70, 70))    # 4 tiles
    out = api.decompress_device(got, win, device=card)
    torch.cuda.synchronize()
    if kw:
        assert 4 <= dec.launches - n0 < full
    else:
        assert dec.launches - n0 == 4
    assert np.array_equal(torch.stack(out, -1)[60:70, 60:70].cpu().numpy(),
                          img[60:70, 60:70])


def test_general_route_on_committed_streams_on_card(card):
    """The committed Part-1 0x3F, BYPASS and layered HT-mixed streams
    decode on the general route on the card to their committed plane
    hashes at every layer cap, with one K3 launch per decode."""
    from grok_tpu_torch.util import stream_vectors as SV
    for name, (data, hashes) in SV.load().items():
        for k in SV.LAYER_CAPS:
            n0 = D3.t1_decode_lanes.launches
            out = api.decompress_device(
                data, api.DecompressParams(max_layers=k), device=card)
            torch.cuda.synchronize()
            assert D3.t1_decode_lanes.launches == n0 + 1, name
            assert SV.plane_hash(out) == hashes[k], (name, k)


def test_sharded_part1_kernels_match_unsharded(card):
    """K5 and K3 with their lanes split over a mesh of four virtual
    shards of the card: one launch a shard, outputs in lane order equal
    to one unsharded launch's."""
    from grok_tpu_torch.parallel import Mesh
    mesh = Mesh((card,) * 4)
    ins = [t.to(card) for t in _mq_lanes(9, 50, 64, 12)]   # 50 = 13+13+12+12
    L, R = 64 * 64 * 4 + 64, 3 * 12 - 2
    before = E5.t1_encode_lanes.launches
    got = E5.t1_encode_lanes_sharded(*ins, L, R, mesh=mesh)
    torch.cuda.synchronize()
    assert E5.t1_encode_lanes.launches == before + 4
    ref = E5.t1_encode_lanes(*ins, L, R)
    assert all(torch.equal(a, b) for a, b in zip(got[1:], ref[1:]))
    lens = ref[1]
    for j in range(lens.shape[0]):
        assert torch.equal(got[0][j, :1 + int(lens[j])],
                           ref[0][j, :1 + int(lens[j])]), j
    body = torch.cat([ref[0][j, 1:1 + int(lens[j])]
                      for j in range(lens.shape[0])]
                     + [ref[0].new_zeros(1)])
    start = (torch.cumsum(lens, 0) - lens).int()
    zero = torch.zeros_like(lens)
    ptbl = torch.stack([zero, lens, zero], 1)[:, None].contiguous()
    args = (body, start, (3 * ins[2] - 2).clamp(min=0).int(), ins[2],
            ins[1], ins[3], ins[4], zero, ptbl)
    before = D3.t1_decode_lanes.launches
    dec = D3.t1_decode_lanes_sharded(*args, 64, 64, mesh=mesh)
    torch.cuda.synchronize()
    assert D3.t1_decode_lanes.launches == before + 4
    assert torch.equal(dec, D3.t1_decode_lanes(*args, 64, 64))


def test_meshed_giant_tile_round_trip_on_card(card):
    """A (G)-shaped frame cut to 1024 x 1024 in one tile (Part-1 lossless
    5/3, 6 resolutions, 64 x 64 blocks) encoded and decoded over a mesh of
    four virtual shards of the card: the bytes equal the unmeshed
    encode's, the decode is the frame, K5 and K3 launch once a shard."""
    from grok_tpu_torch.core.params import DecompressParams as PDP
    from grok_tpu_torch.parallel import Mesh
    mesh = Mesh((card,) * 4)
    img = synthetic_image(1024, 1024, 1, seed=77)
    src = torch.from_numpy(img).to(card)
    e0 = E5.t1_encode_lanes.launches
    meshed = api.compress_device(src, PCP(mesh=mesh), device=card)
    assert E5.t1_encode_lanes.launches == e0 + 4
    assert meshed == api.compress_device(src, PCP(), device=card)
    d0 = D3.t1_decode_lanes.launches
    out = api.decompress_device(meshed, PDP(mesh=mesh), device=card)[0]
    torch.cuda.synchronize()
    assert D3.t1_decode_lanes.launches == d0 + 4
    assert np.array_equal(out.cpu().numpy(), img)


def test_mixed_filter_vectors_on_card(card):
    """The committed 1080p streams with component 1 on the 9/7 decode on
    the card, served and on the general route: the 5/3 planes to their
    committed hashes, the 9/7 plane within 1 of the JAX package's."""
    from grok_tpu_torch.util import mixed_vectors as MV
    for name, (data, sha, _sha_win, irrev) in MV.load().items():
        for out in (api.decompress_device(data, device=card),
                    api.stage_general_device(data, device=card).run()):
            planes = [p.cpu().numpy() for p in out]
            assert MV.exact_hashes(planes)[0] == sha, name
            e = np.abs(planes[MV.IRREV_COMP].astype(np.int64)
                       - irrev.astype(np.int64)).max()
            assert e <= 1, (name, e)


@pytest.mark.parametrize("mb", [25, 30])
def test_encoders_past_24_planes_match_plain_versions(card, mb):
    """K4, K4r and K5 on lanes of mb magnitude planes (log-uniform
    exponents, the top sample 2^mb - 1) equal their plain versions."""
    rng = np.random.default_rng(mb)
    n, side = 12, 16        # the plain K5 steps every pass of every plane
    mneg = np.zeros((n, side, side), np.int32)
    dims = []
    for i in range(n):
        w, h = int(rng.integers(1, side + 1)), int(rng.integers(1, side + 1))
        mag = np.minimum(np.exp2(rng.uniform(0, mb, (h, w))).astype(np.int64),
                         (1 << mb) - 1)
        mag[rng.random((h, w)) < 0.25] = 0
        mag[0, 0] = (1 << mb) - 1
        mneg[i, :h, :w] = (mag << 1) | (rng.random((h, w)) < 0.5)
        dims.append((w, h))

    def col(v):
        return torch.tensor(list(v), dtype=torch.int32)
    lanes = (torch.from_numpy(mneg), col(i % 4 for i in range(n)),
             col(d[0] for d in dims), col(d[1] for d in dims), col([1] * n))
    nq = (side // 2) ** 2
    caps = (E._cap_bytes(side * side * (mb + 2) // 8 + 16),
            E._cap_bytes(nq * 9 // 8 + 16), E._cap_bytes(nq * 15 // 8 + 16))
    rcaps = E.refine_caps(side, side)
    on = tuple(t.to(card) for t in lanes)
    st, bt = E.ht_encode_lanes(*on, *caps)
    rs, rb = E.ht_encode_lanes_ref(*lanes, *caps)
    assert torch.equal(bt.cpu(), rb) and (rb >= 0).all()
    assert torch.equal(E.clear_unused(st.cpu(), bt.cpu(), *caps[:-1]),
                       E.clear_unused(rs, rb, *caps[:-1]))
    st, bt, ns = E.ht_encode_lanes(*on, *caps, refine=True)
    sp, mr, rrb, rns = E.ht_refine_lanes_ref(*lanes, *rcaps)
    assert torch.equal(bt.cpu()[3:], rrb) and torch.equal(ns.cpu(), rns)
    ins = (lanes[0], lanes[1], col([mb] * n), lanes[2], lanes[3])
    L, R = E._cap_bytes(side * side * (mb + 1) // 2 + 64), 3 * mb - 2
    got = E5.t1_encode_lanes(*(t.to(card) for t in ins), L, R)
    ref = E5.t1_encode_lanes_ref(*ins, L, R)
    from grok_tpu_torch.tools.hw_validate import encodes_equal
    assert encodes_equal(tuple(t.cpu() for t in got), ref)
