"""A layer cap on a layered, cleanup-only HT batch: the port's serving
decode (grok_tpu_torch.api) takes it batched, as the JAX package's
serving decode does, and every capped decode is bit-identical to
grok_tpu.decompress(max_layers=k) on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from grok_tpu import CompressParams, DecompressParams, compress, decompress  # noqa: E402,E501
from grok_tpu import native  # noqa: E402
from grok_tpu.util.oracle import synthetic_image  # noqa: E402
from grok_tpu_torch import api  # noqa: E402
from grok_tpu_torch.pipeline.serve import StagedBatch  # noqa: E402

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C toolchain")

# the HT parameters of tests/test_torch_serve.py, cleanup only, 2 layers
CP = dict(ht=True, num_resolutions=3, cblk_w_exp=5, cblk_h_exp=5,
          ht_planes=0, num_layers=2, rates=[8.0, 2.0])


@pytest.fixture(autouse=True)
def _ht_interpret_env(monkeypatch):
    monkeypatch.setenv("GROK_HT_PALLAS", "1")
    monkeypatch.setenv("GROK_PALLAS_INTERPRET", "1")


@pytest.fixture(scope="module")
def layered():
    imgs = [synthetic_image(80, 96, 1, seed=40 + i) for i in range(2)]
    return [compress(im, CompressParams(**CP)) for im in imgs]


def test_capped_layered_ht_batch_is_staged(layered):
    staged = api.stage_device_batch(layered,
                                    api.DecompressParams(max_layers=1),
                                    device="cpu")
    assert isinstance(staged, StagedBatch)
    assert staged.program.N == len(layered)


@pytest.mark.parametrize("k", [1, 2])
def test_capped_layered_ht_batch_matches_jax_decode(layered, k):
    got = api.decompress_device_batch(
        layered, api.DecompressParams(max_layers=k), device="cpu")
    outs = []
    for stream, comps in zip(layered, got):
        want = decompress(stream, DecompressParams(max_layers=k)).to_array()
        assert len(comps) == 1 and comps[0].device.type == "cpu"
        assert np.array_equal(comps[0].numpy(), want)
        outs.append(comps[0].numpy())
    # the cap drops something: one layer differs from the whole stream
    full = api.decompress_device_batch(layered, device="cpu")
    assert (k == 2) == all(np.array_equal(o, f[0].numpy())
                           for o, f in zip(outs, full))
