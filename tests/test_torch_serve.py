"""The port's serving decode (grok_tpu_torch.api / pipeline) vs the JAX
package's serving decode run on the CPU with the Pallas HT kernel in
interpret mode (as tests/test_serve.py runs it), and vs the source
pixels.  Lossless is bit-exact; the 9/7 + ICT path is within +-1 on at
most 4 pixels (the scoped f32 latitude of the repository's
"Invariants" notes)."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grok_tpu import (CompressParams, DecompressParams, compress,  # noqa: E402
                      decompress, native)
from grok_tpu import api as japi  # noqa: E402
from grok_tpu.pipeline.device import (_make_word_stager,  # noqa: E402
                                      _unstuff_suffix)
from grok_tpu.util.oracle import synthetic_image  # noqa: E402
from grok_tpu_torch import api  # noqa: E402
from grok_tpu_torch.pipeline import device as tdev  # noqa: E402

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C toolchain")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CP = dict(ht=True, num_resolutions=3, cblk_w_exp=5, cblk_h_exp=5)


@pytest.fixture(autouse=True)
def _ht_interpret_env(monkeypatch):
    monkeypatch.setenv("GROK_HT_PALLAS", "1")
    monkeypatch.setenv("GROK_PALLAS_INTERPRET", "1")


@pytest.fixture(scope="module")
def gray():
    imgs = [synthetic_image(80, 96, 1, seed=20 + i) for i in range(3)]
    return imgs, [compress(im, CompressParams(**CP)) for im in imgs]


@pytest.fixture(scope="module")
def rgb():
    img = synthetic_image(64, 96, 3, seed=5)
    return img, compress(img, CompressParams(**CP))


def _np(comps):
    a = [np.asarray(c) for c in comps]
    return a[0] if len(a) == 1 else np.stack(a, -1)


def test_batch_lossless_matches_jax_and_source(gray):
    imgs, streams = gray
    got = api.decompress_device_batch(streams, device="cpu")
    want = japi.decompress_device_batch(streams)
    assert len(got) == len(imgs)
    for img, g, w in zip(imgs, got, want):
        assert all(c.dtype == torch.int32 and c.device.type == "cpu"
                   for c in g)
        assert np.array_equal(_np(g), _np(w))
        assert np.array_equal(_np(g), img)


def test_rgb_rct_lossless_matches_jax_and_reduce_matches_host(rgb):
    img, stream = rgb
    got = api.decompress_device(stream, device="cpu")
    assert np.array_equal(_np(got), _np(japi.decompress_device(stream)))
    assert np.array_equal(_np(got), img)
    # reduced resolution: the JAX package's host decode is bit-identical
    # on the reversible path
    dp = DecompressParams(reduce=1)
    half = api.decompress_device_batch([stream, stream], dp, device="cpu")
    want = decompress(stream, dp).to_array()
    assert want.shape == (32, 48, 3)
    for g in half:
        assert np.array_equal(_np(g), want)


def test_lossy_ict_97_within_one_of_jax():
    img = synthetic_image(64, 96, 3, seed=5)
    data = compress(img, CompressParams(irreversible=True, rates=[6.0],
                                        **CP))
    got = _np(api.decompress_device(data, device="cpu"))
    want = _np(japi.decompress_device(data))
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert int(diff.max()) <= 1 and int((diff > 0).sum()) <= 4


def _jax_stage(body, meta, Lms, Lsuf, Dm):
    stage = _make_word_stager(jnp, jax, jnp.asarray(body), meta.shape[0])
    m = jnp.asarray(meta)
    ms = stage(m[:, 0], m[:, 1], Lms, False)
    suf_f = stage(m[:, 2], m[:, 3], Lsuf, False)
    suf_r = stage(m[:, 2], m[:, 3] - 1, Lsuf, True)
    mel, vlc = _unstuff_suffix(jnp, jax, suf_f, suf_r, Dm)
    return [np.asarray(a) for a in (ms, suf_f, suf_r, mel, vlc)]


def _torch_stage(body, meta, Lms, Lsuf, Dm):
    b = torch.from_numpy(body)
    m = torch.from_numpy(meta).to(torch.int64)
    ms = tdev.stage_bytes(b, m[:, 0], m[:, 1], Lms, False)
    suf_f = tdev.stage_bytes(b, m[:, 2], m[:, 3], Lsuf, False)
    suf_r = tdev.stage_bytes(b, m[:, 2], m[:, 3] - 1, Lsuf, True)
    mel, vlc = tdev.unstuff_suffix(suf_f, suf_r, Dm)
    return [a.numpy() for a in (ms, suf_f, suf_r, mel, vlc)]


def test_stager_and_unstuff_match_jax_on_served_digest(gray):
    staged = api.stage_device_batch(gray[1], device="cpu")
    body = staged.body.numpy()
    lo = 0
    for b, dims in zip(staged.program.buckets, staged.dims):
        n = staged.program.N * len(b.blocks)
        meta = staged.meta.numpy()[lo:lo + n, :4]
        lo += n
        for x, y in zip(_torch_stage(body, meta, *dims),
                        _jax_stage(body, meta, *dims)):
            assert x.dtype == np.int32 and np.array_equal(x, y)


@pytest.mark.parametrize("Dm", [1, 2, 4])
def test_stager_and_unstuff_match_jax_random_bytes(Dm):
    rng = np.random.default_rng(Dm)
    # stuffing-heavy bytes: 0xFF, 0x7F and > 0x8F runs
    body = rng.choice(np.array([0xFF, 0x7F, 0x90, 0xF0, 0x00, 0x12],
                               np.uint8), 4096)
    body[::3] = rng.integers(0, 256, body[::3].size)
    NL, Lms, Lsuf = 40, 256, 256
    meta = np.zeros((NL, 4), np.int32)
    meta[:, 0] = rng.integers(0, 3000, NL)
    meta[:, 1] = rng.integers(0, 200, NL)
    meta[:, 2] = rng.integers(0, 3000, NL)
    meta[:, 3] = rng.integers(2, 200, NL)
    meta[-1] = 0                                  # an empty lane
    for x, y in zip(_torch_stage(body, meta, Lms, Lsuf, Dm),
                    _jax_stage(body, meta, Lms, Lsuf, Dm)):
        assert np.array_equal(x, y)


def test_out_of_scope_streams_raise(rgb):
    img = synthetic_image(64, 64, 1, seed=6)
    mq = compress(img, CompressParams(num_resolutions=3))
    with pytest.raises(NotImplementedError, match="MQ"):
        api.decompress_device_batch([mq], device="cpu")
    _img, ht = rgb
    for dp, what in ((DecompressParams(window=(0, 0, 32, 32)), "windowed"),
                     (DecompressParams(max_layers=1), "layer-capped"),
                     (DecompressParams(strict=True), "strict")):
        with pytest.raises(NotImplementedError, match=what):
            api.decompress_device(ht, dp, device="cpu")
    refined = compress(img, CompressParams(ht_planes=2, **CP))
    with pytest.raises(NotImplementedError, match="not ported"):
        api.decompress_device(refined, device="cpu")


def test_no_cpu_fallback_for_a_cuda_device(gray):
    """A cuda device never yields CPU tensors: without a card the call
    raises; with one, every plane is on the card."""
    _imgs, streams = gray
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            api.decompress_device_batch(streams, device="cuda")
        return
    out = api.decompress_device_batch(streams, device="cuda")
    assert all(c.device.type == "cuda" for comps in out for c in comps)


_GUARD = r"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np
import grok_tpu_torch
from grok_tpu import CompressParams, compress
from grok_tpu.util.oracle import synthetic_image
img = synthetic_image(40, 48, 1, seed=1)
data = compress(img, CompressParams(ht=True, num_resolutions=2))
out = grok_tpu_torch.decompress_device_batch([data], device="cpu")
assert np.array_equal(out[0][0].numpy(), img)
assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules)
print("GUARD-OK")
"""


def test_port_imports_and_decodes_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _GUARD], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "GUARD-OK" in r.stdout

