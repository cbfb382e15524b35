"""Part-1 mode-switch encodes and layered or rate-targeted HT-mixed
encodes in the PyTorch port, held against the JAX package:

  - the plain version of kernel K5 on styled lanes (each of the six
    Part-1 mode switches alone, all six, BYPASS with PTERM; lanes of 1x1
    to 64x64 and 128 x 32, several styles in one call) against the JAX
    package's C block coder grok_tpu.native.encode_tile_blocks: the
    codeword bytes, the total length, the per-pass rates and termination
    flags, the segment lengths and pass counts (ops/t1_encode.py
    pass_records) and the magnitude bitplane count;
  - grok_tpu_torch.api.compress_device(device="cpu") byte for byte
    against grok_tpu.compress_device, reversible: styled Part-1 encodes
    untargeted, layered and rate-targeted, tiled, batched and with
    code-blocks over 64 wide, and HT-mixed encodes in three layers and at
    a byte target; each stream decoded by the port equal to
    grok_tpu.decompress.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_enc_modes.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import grok_tpu  # noqa: E402
from grok_tpu import CompressParams as JCP  # noqa: E402
from grok_tpu import native  # noqa: E402
from grok_tpu.util.oracle import synthetic_image  # noqa: E402
from grok_tpu_torch import api  # noqa: E402
from grok_tpu_torch.core.params import CompressParams as PCP  # noqa: E402
from grok_tpu_torch.ops import t1_encode  # noqa: E402

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C toolchain")

# the six Part-1 mode switches alone, all of them, and BYPASS with PTERM
STYLES = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x3F, 0x11]

CP = dict(num_resolutions=3, cblk_w_exp=4, cblk_h_exp=4)


def _col(v):
    return torch.tensor(list(v), dtype=torch.int32)


def _styled_lanes(W: int, H: int, sizes, seed: int):
    """One block of each (w, h) of `sizes` for each style of STYLES, in W
    x H lanes: [(mag, neg)], the styles and K5's inputs.  Each block's
    top plane count is set by one sample, so that BYPASS reaches its raw
    passes (from pass 10, the fifth plane) on each of them; most samples
    are 0 (the plain version's lockstep cost follows the decisions)."""
    rng = np.random.default_rng(seed)
    blocks, styles = [], []
    for st in STYLES:
        for i, (w, h) in enumerate(sizes):
            nb = 5
            mag = rng.integers(0, 1 << nb, (h, w))
            mag[rng.random((h, w)) < rng.uniform(0.6, 0.95)] = 0
            mag[h // 2, w // 2] = (1 << nb) - 1
            blocks.append((mag, rng.random((h, w)) < 0.5))
            styles.append(st)
    mneg = np.zeros((len(blocks), H, W), np.int32)
    for j, (m, n) in enumerate(blocks):
        mneg[j, :m.shape[0], :m.shape[1]] = (m << 1) | (n & (m > 0))
    ins = (torch.from_numpy(mneg), _col(j % 4 for j in range(len(blocks))),
           _col(int(m.max()).bit_length() for m, _n in blocks),
           _col(m.shape[1] for m, _n in blocks),
           _col(m.shape[0] for m, _n in blocks))
    return blocks, styles, ins


@pytest.mark.parametrize("W, H, sizes", [
    (64, 64, [(1, 1), (1, 9), (7, 3), (16, 16), (33, 20), (64, 64)]),
    (128, 32, [(128, 32), (100, 5)]),
])
def test_plain_k5_equals_c_coder_on_styled_lanes(W, H, sizes):
    blocks, styles, ins = _styled_lanes(W, H, sizes, seed=W + H)
    nbmax = int(ins[2].max())
    R = 3 * nbmax - 2
    L = W * H * (nbmax + 1) // 2 + 64 + 8 * R
    L += -L % 4
    out, lens, rates, _st = t1_encode.t1_encode_lanes_ref(*ins, L, R,
                                                          _col(styles))
    want = native.encode_tile_blocks(
        [dict(mag=m, neg=n, orient=j % 4, style=st)
         for j, ((m, n), st) in enumerate(zip(blocks, styles))])
    raw_lanes = 0
    for j, (e, st) in enumerate(zip(want, styles)):
        n, total = int(ins[2][j]), int(lens[j])
        assert n == e.numbps
        assert total == len(e.data)
        assert bytes(out[j, 1:1 + total].numpy()) == e.data, (j, st)
        rr, terms, seg_lens, seg_passes = t1_encode.pass_records(
            rates[j].numpy(), n, total, st)
        assert rr == [p.rate for p in e.passes], (j, st)
        assert terms == [p.term for p in e.passes], (j, st)
        assert seg_lens == e.seg_lens and seg_passes == e.seg_passes
        raw_lanes += bool(st & 1) and n >= 5
    assert raw_lanes == 3 * len(sizes)    # BYPASS reached its raw passes


def test_pass_records_of_the_default_style_are_the_watermark_rule():
    """The default style's records: one segment, each rate the watermark
    clamped to the total and made monotonic, the last the total
    (grok_tpu/ops/pallas_t1_enc.py rates_from_watermarks)."""
    row = [9, 7, 12, 40, 40, 3, 0]
    rr, terms, seg_lens, seg_passes = t1_encode.pass_records(row, 3, 30)
    assert rr == [9, 9, 12, 30, 30, 30, 30]
    assert terms == [False] * 6 + [True]
    assert seg_lens == [30] and seg_passes == [7]


@pytest.fixture(scope="module")
def rgb():
    return synthetic_image(32, 40, 3, seed=14)


def _decoded(stream) -> np.ndarray:
    comps = [c.numpy() for c in api.decompress_device(stream, device="cpu")]
    return comps[0] if len(comps) == 1 else np.stack(comps, -1)


CASES = {
    "0x3F": dict(cblk_style=0x3F),
    "bypass_termall_pterm_3_layers_targeted": dict(
        cblk_style=0x15, num_layers=3, rates=[40.0, 16.0, 6.0]),
    "vsc_segsym_reset_3_layers": dict(cblk_style=0x2A, num_layers=3),
    # single-segment styled blocks: the truncation refinement's trial
    # decodes run in the blocks' style
    "vsc_segsym_reset_pterm_targeted": dict(cblk_style=0x3A, num_layers=2,
                                            rates=[20.0, 6.0]),
    "bypass_tiled": dict(cblk_style=0x01, tile_w=24, tile_h=24),
    "bypass_vsc_wide": dict(cblk_style=0x09, cblk_w_exp=7, cblk_h_exp=2),
    "mixed_3_layers": dict(ht_mixed=True, num_layers=3),
    "mixed_3_layers_targeted": dict(ht_mixed=True, num_layers=3,
                                    rates=[40.0, 16.0, 6.0]),
    "mixed_byte_target": dict(ht_mixed=True, rates=[6.0]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_encode_byte_identical_to_jax_package_and_decodes(rgb, name):
    kw = dict(CP, **CASES[name])
    got = api.compress_device(rgb, PCP(**kw), device="cpu")
    want = grok_tpu.compress_device(rgb, JCP(**kw))
    assert got == want
    ref = grok_tpu.decompress(want).to_array()
    assert np.array_equal(_decoded(got), ref)
    if "rates" not in kw:
        assert np.array_equal(ref, rgb)         # lossless at every layer


def test_styled_batch_byte_identical_frame_by_frame():
    frames = [synthetic_image(24, 32, 1, seed=30 + i) for i in range(2)]
    kw = dict(CP, cblk_style=0x3F, num_layers=2, rates=[12.0, 4.0])
    before = t1_encode.t1_encode_lanes.launches
    got = api.compress_device_batch(frames, PCP(**kw), device="cpu")
    assert t1_encode.t1_encode_lanes.launches == before   # plain version
    assert got == [grok_tpu.compress_device(f, JCP(**kw)) for f in frames]


def test_refined_ht_mixed_is_refused_as_by_the_reference(rgb):
    """ht_planes with ht_mixed: both packages' parameter checks refuse
    the combination with the same ValueError (the mixed coder compares
    single-segment codewords), so there is no refined HT-mixed stream to
    port."""
    kw = dict(CP, ht_mixed=True, ht_planes=1)
    with pytest.raises(ValueError) as jax_err:
        grok_tpu.compress_device(rgb, JCP(**kw))
    with pytest.raises(ValueError) as port_err:
        api.compress_device(rgb, PCP(**kw), device="cpu")
    assert str(port_err.value) == str(jax_err.value)
