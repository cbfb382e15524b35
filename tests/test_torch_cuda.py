"""Card-only tests of the port: the HT cleanup CUDA kernel (a kernel has
no CPU mode) against its plain PyTorch version and the scalar HT coder,
and the serving decode on the card against the source pixels.

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
from grok_tpu_torch.ops import ht_decode as H  # noqa: E402
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
    got = H.ht_decode_lanes(*dev, 64, 64)
    torch.cuda.synchronize()
    assert H.ht_decode_lanes.launches == before + 1
    assert torch.equal(got, H.ht_decode_lanes_ref(*dev, 64, 64))
    out = got.cpu().numpy()
    for j, ((w, h), (m2, ng)) in enumerate(zip(dims, refs)):
        assert np.array_equal(np.abs(out[j, :h, :w]), m2), j
        assert np.array_equal(out[j, :h, :w] < 0, ng), j


def test_kernel_matches_plain_version_and_scalar(card):
    _check_kernel(card, 0, [2, 9, 40, 300, 5000])


def test_kernel_follows_install_tables(card):
    lens_ek, lens_init = _synthetic_normative_tables()
    T.install_tables(lens=lens_ek, lens_init=lens_init,
                     uvlc_prefix_xor=0b101)
    try:
        assert T.two_families() and T.tables_have_ek()
        _check_kernel(card, 1, [3, 8, 20])
    finally:
        T.reset_tables()


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
