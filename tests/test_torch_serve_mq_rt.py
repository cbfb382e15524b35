"""The port's rate-targeted and multi-layer Part-1 serving path
(grok_tpu_torch.api -> pipeline/serve_enc.py, the PCRD finish and its
minimal-flush truncation refinement in pipeline/tile.py, the layer-capped
serving decode in pipeline/serve.py; kernels K5 and K3 through their
plain versions on the CPU) vs the JAX package: the per-pass distortion
sums equal grok_tpu.ops.t1_enc._pass_distortions exactly, reversible
encodes are byte-identical to grok_tpu.compress, their layer-capped
decodes bit-identical to grok_tpu.decompress, and 9/7 encodes keep to
their byte budgets with PSNR rising layer by layer."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from grok_tpu import CompressParams as JCP  # noqa: E402
from grok_tpu import DecompressParams, compress, decompress, native  # noqa: E402,E501
from grok_tpu.ops.t1_enc import _pass_distortions  # noqa: E402
from grok_tpu.util.oracle import synthetic_image  # noqa: E402
from grok_tpu_torch import api  # noqa: E402
from grok_tpu_torch.core.params import CompressParams as PCP  # noqa: E402
from grok_tpu_torch.ops import t1_encode  # noqa: E402
from grok_tpu_torch.pipeline import serve_enc  # noqa: E402
from grok_tpu_torch.t2.rate import (layer_budget_consts,  # noqa: E402
                                    layer_targets_for_tile)

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C toolchain")

CP = dict(num_resolutions=3, cblk_w_exp=4, cblk_h_exp=4)
CASES = {
    "4:1": dict(rates=[4.0]),
    "3 layers 16:1 4:1 1:1": dict(num_layers=3, rates=[16.0, 4.0, 1.0]),
    "3 layers 40:1 10:1 4:1": dict(num_layers=3, rates=[40.0, 10.0, 4.0]),
}


def _lanes(seed, n, side, maxnb):
    """K5's inputs: n lanes of random sizes up to side x side, w = 1 and
    h not a multiple of 4 among them, all-zero lanes, up to maxnb
    planes."""
    rng = np.random.default_rng(seed)
    mneg = np.zeros((n, side, side), np.int32)
    dims, mags = [], []
    for i in range(n):
        w, h = int(rng.integers(1, side + 1)), int(rng.integers(1, side + 1))
        if i == 0:
            w = 1
        if i == 1:
            h = 7
        nb = 0 if i == 2 else int(rng.integers(1, maxnb + 1))
        mag = rng.integers(0, 1 << nb, (h, w)) if nb \
            else np.zeros((h, w), np.int64)
        mag[rng.random((h, w)) < rng.uniform(0, 0.9)] = 0
        if i == 3:
            mag[0, 0] = (1 << maxnb) - 1               # the deepest lane
        mneg[i, :h, :w] = (mag << 1) | (rng.random((h, w)) < 0.5)
        dims.append((w, h))
        mags.append(mag)
    return mneg, dims, mags


@pytest.mark.parametrize("seed, side, maxnb", [(1, 13, 16), (2, 20, 9)])
def test_pass_distortions_equal_the_jax_packages(seed, side, maxnb):
    """Sum 0 minus a quarter of sum 1 + t (the split rows recombined), in
    f64, equals _pass_distortions at every pass t of every lane,
    exactly."""
    n = 12
    mneg, dims, mags = _lanes(seed, n, side, maxnb)
    nb = [int(m.max()).bit_length() for m in mags]
    assert max(nb) == maxnb and 0 in nb

    def col(v):
        return torch.tensor(v, dtype=torch.int32)
    ins = (torch.from_numpy(mneg), col([i % 4 for i in range(n)]), col(nb),
           col([d[0] for d in dims]), col([d[1] for d in dims]))
    R = 3 * maxnb - 2
    _out, _lens, _rates, sigtype = t1_encode.t1_encode_lanes(
        *ins, side * side * 8 + 64, R)
    d = serve_enc._mq_dist_stats(ins[0], sigtype, ins[2], R).numpy()
    assert d.shape == (3 * (R + 1), n) and d.dtype == np.int64
    dist = serve_enc._distortions(serve_enc._exact_sums(d))
    for j, ((w, h), mag) in enumerate(zip(dims, mags)):
        want = _pass_distortions(mag, sigtype[j, :h, :w].numpy(), nb[j])
        got = dist[:len(want), j]
        assert np.array_equal(got, want), j


def _img(a):
    from grok_tpu.core.image import Component, Image
    return Image(components=[Component(data=a, prec=8)])


@pytest.fixture(scope="module")
def gray():
    return [synthetic_image(40, 56, 1, seed=40 + i) for i in range(3)]


@pytest.fixture(scope="module")
def rgb():
    return synthetic_image(32, 40, 3, seed=8)


def _capped_decodes_match(streams, layers):
    """Every layer cap of the streams: the port's batch decode on the CPU
    bit-identical to grok_tpu.decompress at that cap."""
    for k in range(1, layers + 1):
        dp = DecompressParams(max_layers=k)
        got = api.decompress_device_batch(streams, dp, device="cpu")
        for s, comps in zip(streams, got):
            a = [c.numpy() for c in comps]
            a = a[0] if len(a) == 1 else np.stack(a, -1)
            assert np.array_equal(a, decompress(s, dp).to_array()), k


@pytest.mark.parametrize("case", list(CASES))
def test_gray_batch_byte_identical_and_capped_decodes(gray, case):
    kw = dict(CP, **CASES[case])
    got = api.compress_device_batch(gray, PCP(**kw), device="cpu")
    assert got == [compress(im, JCP(**kw)) for im in gray]
    _capped_decodes_match(got, kw.get("num_layers", 1))


@pytest.mark.parametrize("case", list(CASES))
def test_rgb_byte_identical_and_capped_decodes(rgb, case):
    kw = dict(CP, **CASES[case])
    got = api.compress_device(rgb, PCP(**kw), device="cpu")
    assert got == compress(rgb, JCP(**kw))
    _capped_decodes_match([got], kw.get("num_layers", 1))


def test_batch_equals_single_encodes(gray):
    kw = dict(CP, **CASES["3 layers 40:1 10:1 4:1"])
    batch = api.compress_device_batch(gray, PCP(**kw), device="cpu")
    assert batch == [api.compress_device(im, PCP(**kw), device="cpu")
                     for im in gray]


def _tile_results(frames, params):
    comps = [torch.from_numpy(np.stack(frames).astype(np.int32))]
    h, w = frames[0].shape
    hdr = api._build_main_header(h, w, 1, 8, False, params)
    return hdr, serve_enc.try_encode_serving_batch(comps, hdr, params)


def test_refinement_shrinks_blocks(gray):
    """The minimal-flush refinement runs: at 4:1 it shrinks blocks'
    final truncations, and the stream still equals the host encoder's."""
    params = PCP(**CP, **CASES["4:1"])
    _hdr, res = _tile_results(gray[:1], params)
    assert res[0].refined >= 1 and res[0].reclaimed >= res[0].refined
    assert res[0].trial_lanes > res[0].refined


def test_irreversible_layers_keep_budgets_and_rise_in_psnr():
    """9/7 targeted streams are the device model's own (not byte-identical
    to the host encoder): each layer prefix keeps to its byte budget and
    PSNR rises with every layer."""
    img = synthetic_image(64, 64, 1, seed=12)
    params = PCP(irreversible=True, **CP, **CASES["3 layers 40:1 10:1 4:1"])
    hdr, res = _tile_results([img], params)
    targets = layer_targets_for_tile(layer_budget_consts(hdr, params),
                                     hdr.siz.tile_rect(0), params)
    per = len(res[0].packet_lens) // 3
    prefix = [sum(res[0].packet_lens[:per * (k + 1)]) for k in range(3)]
    assert all(p <= t for p, t in zip(prefix, targets)), (prefix, targets)
    stream = api.compress_device(img, params, device="cpu")
    psnr = []
    for k in (1, 2, 3):
        out = api.decompress_device(stream, api.DecompressParams(
            max_layers=k), device="cpu")[0].numpy().astype(np.float64)
        psnr.append(10 * np.log10(255 ** 2 / np.mean((out - img) ** 2)))
    assert psnr[0] < psnr[1] < psnr[2], psnr
