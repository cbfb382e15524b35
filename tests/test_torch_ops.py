"""PyTorch port's MCT and DWT (grok_tpu_torch/ops) vs the JAX modules
grok_tpu/ops/mct.py and grok_tpu/ops/dwt.py on the same arrays.

5/3, RCT and the DC shift are exact.  9/7 and ICT: the two frameworks
run the same f32 lifting steps in different fused orders, so they agree
to atol 1e-3 before rounding and within +-1 after it (the scoped f32
latitude of the repository's "Invariants" notes)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from grok_tpu.core.geometry import Rect  # noqa: E402
from grok_tpu.ops import dwt as jdwt  # noqa: E402
from grok_tpu.ops import mct as jmct  # noqa: E402
from grok_tpu_torch.ops import dwt as tdwt  # noqa: E402
from grok_tpu_torch.ops import mct as tmct  # noqa: E402

NS = [1, 2, 3, 5, 17]
F32_ATOL = 1e-3


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("n,pad", [(2, 2), (2, 4), (3, 2), (3, 4),
                                   (5, 4), (17, 2)])
def test_extend2_matches_numpy_and_jax_reflect(n, pad):
    x = np.random.default_rng(n * 10 + pad).integers(
        -99, 99, (2, n)).astype(np.int32)
    got = _np(tdwt._extend2(torch.from_numpy(x), pad))
    assert np.array_equal(got, np.pad(x, ((0, 0), (pad, pad)), "reflect"))
    assert np.array_equal(got, _np(jdwt._extend2(jnp.asarray(x), pad)))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("off", [0, 1, 2, 3])
def test_53_1d_exact(n, off):
    x = np.random.default_rng(n * 7 + off).integers(
        -2048, 2048, (3, n)).astype(np.int32)
    jl, jh = jdwt.fwd53_1d(jnp.asarray(x), off)
    tl, th = tdwt.fwd53_1d(torch.from_numpy(x), off)
    assert np.array_equal(_np(tl), _np(jl))
    assert np.array_equal(_np(th), _np(jh))
    back = tdwt.inv53_1d(tl, th, off, n)
    assert back.dtype == torch.int32
    assert np.array_equal(_np(back), _np(jdwt.inv53_1d(jl, jh, off, n)))
    assert np.array_equal(_np(back), x)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("off", [0, 1, 3])
def test_97_1d_close(n, off):
    x = np.random.default_rng(n * 5 + off).normal(
        0, 100, (3, n)).astype(np.float32)
    jl, jh = jdwt.fwd97_1d(jnp.asarray(x), off)
    tl, th = tdwt.fwd97_1d(torch.from_numpy(x), off)
    assert np.allclose(_np(tl), _np(jl), atol=F32_ATOL, rtol=0)
    assert np.allclose(_np(th), _np(jh), atol=F32_ATOL, rtol=0)
    back = _np(tdwt.inv97_1d(tl, th, off, n))
    assert np.allclose(back, _np(jdwt.inv97_1d(jl, jh, off, n)),
                       atol=F32_ATOL, rtol=0)
    assert np.abs(np.rint(back) - np.rint(x)).max(initial=0) <= 1


# (h, w), rect offset (odd ones too), resolutions (1 to 3 DWT levels)
CASES = [((17, 5), (0, 0), 2), ((37, 53), (3, 5), 3), ((33, 20), (7, 0), 4),
         ((2, 3), (1, 1), 2)]


@pytest.mark.parametrize("shape,off,nres", CASES)
def test_53_multilevel_exact(shape, off, nres):
    h, w = shape
    x = np.random.default_rng(h * 100 + w).integers(
        -2048, 2048, (2, h, w)).astype(np.int32)
    rect = Rect(off[0], off[1], off[0] + w, off[1] + h)
    jb = jdwt.fwd_multilevel(x, rect, nres, False)
    tb = tdwt.fwd_multilevel(torch.from_numpy(x), rect, nres, False)
    assert np.array_equal(_np(tb[0]), _np(jb[0]))
    for r in range(1, nres):
        for i in range(3):
            assert np.array_equal(_np(tb[r][i]), _np(jb[r][i])), (r, i)
    back = tdwt.inv_multilevel(tb, rect, nres, False)
    assert np.array_equal(_np(back), x)
    rt = (rect.x0, rect.y0, rect.x1, rect.y1)
    flat = [tb[0]] + [b for r in range(1, nres) for b in tb[r]]
    part = tdwt.inv_multilevel_flat(tuple(flat), rt, nres, False,
                                    max_res=nres - 1)
    jflat = [jb[0]] + [b for r in range(1, nres) for b in jb[r]]
    jpart = jdwt.inv_multilevel_flat(tuple(jflat), rt, nres, False,
                                     nres - 1)
    assert np.array_equal(_np(part), _np(jpart))


@pytest.mark.parametrize("shape,off,nres", CASES)
def test_97_multilevel_close(shape, off, nres):
    h, w = shape
    x = np.random.default_rng(h * 3 + w).normal(
        0, 100, (2, h, w)).astype(np.float32)
    rect = Rect(off[0], off[1], off[0] + w, off[1] + h)
    jb = jdwt.fwd_multilevel(x, rect, nres, True)
    tb = tdwt.fwd_multilevel(torch.from_numpy(x), rect, nres, True)
    assert np.allclose(_np(tb[0]), _np(jb[0]), atol=F32_ATOL, rtol=0)
    for r in range(1, nres):
        for i in range(3):
            assert np.allclose(_np(tb[r][i]), _np(jb[r][i]),
                               atol=F32_ATOL, rtol=0), (r, i)
    # synthesis of the JAX bands by both, as the decode runs it
    tjb = [torch.from_numpy(np.array(jb[0]))] + [
        tuple(torch.from_numpy(np.array(b)) for b in jb[r])
        for r in range(1, nres)]
    back = _np(tdwt.inv_multilevel(tjb, rect, nres, True))
    jback = _np(jdwt.inv_multilevel(jb, rect, nres, True))
    assert np.allclose(back, jback, atol=F32_ATOL, rtol=0)
    assert np.abs(np.rint(back) - np.rint(jback)).max() <= 1


def test_rct_and_dc_shift_exact():
    rng = np.random.default_rng(3)
    r, g, b = (rng.integers(-128, 128, (2, 9, 13)).astype(np.int32)
               for _ in range(3))
    tr = [torch.from_numpy(a) for a in (r, g, b)]
    jr = [jnp.asarray(a) for a in (r, g, b)]
    fwd = tmct.rct_fwd(*tr)
    for a, e in zip(fwd, jmct.rct_fwd(*jr)):
        assert np.array_equal(_np(a), _np(e))
    inv = tmct.rct_inv(*fwd)
    for a, e, src in zip(inv, jmct.rct_inv(*jmct.rct_fwd(*jr)), (r, g, b)):
        assert a.dtype == torch.int32
        assert np.array_equal(_np(a), _np(e))
        assert np.array_equal(_np(a), src)
    x = rng.integers(-5000, 5000, (4, 7)).astype(np.int32)
    for prec, sgnd in ((8, False), (12, False), (8, True), (16, True)):
        got = tmct.dc_shift_inv(torch.from_numpy(x), prec, sgnd)
        assert got.dtype == torch.int32
        assert np.array_equal(_np(got),
                              _np(jmct.dc_shift_inv(jnp.asarray(x), prec,
                                                    sgnd)))
        assert np.array_equal(
            _np(tmct.dc_shift_fwd(torch.from_numpy(x), prec, sgnd)),
            _np(jmct.dc_shift_fwd(jnp.asarray(x), prec, sgnd)))


def test_ict_close():
    rng = np.random.default_rng(4)
    chans = [rng.uniform(-128, 128, (6, 11)).astype(np.float32)
             for _ in range(3)]
    tf = tmct.ict_fwd(*(torch.from_numpy(a) for a in chans))
    jf = jmct.ict_fwd(*(jnp.asarray(a) for a in chans))
    for a, e in zip(tf, jf):
        assert np.allclose(_np(a), _np(e), atol=F32_ATOL, rtol=0)
    ti = tmct.ict_inv(*tf)
    ji = jmct.ict_inv(*jf)
    for a, e, src in zip(ti, ji, chans):
        assert a.dtype == torch.float32
        assert np.allclose(_np(a), _np(e), atol=F32_ATOL, rtol=0)
        assert np.abs(np.rint(_np(a)) - np.rint(src)).max() <= 1
