"""Components that mix the 5/3 and the 9/7 filter, decoded by the port
(grok_tpu_torch.api.decompress_device on the CPU: served, or on the
general route for refined HT and Part-1 mode switches; and
stage_general_device, the general route for every stream) against
grok_tpu.decompress on the same streams: the 5/3 planes bit-identical,
the 9/7 planes within +-1, at reduce 0 and 1 and in a window.

The streams are grok_tpu.compress's, with one component's coding style
and quantization overridden in the main header it writes (a COC with
the 9/7 filter and a QCC with its derived step sizes, `mixed` below, a
patch of grok_tpu.api._build_main_header inside the test only): the JAX
encoder codes each component by its own style, so the component is
coded on the 9/7.  make_mixed_vectors rebuilds the committed 1080p
streams of util/mixed_vectors.npz the same way."""

import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import grok_tpu.api as japi  # noqa: E402
from grok_tpu import CompressParams as JCP  # noqa: E402
from grok_tpu import DecompressParams as JDP  # noqa: E402
from grok_tpu import compress, decompress, native  # noqa: E402
from grok_tpu.codestream.j2k import QuantStyle  # noqa: E402
from grok_tpu.core.quant import make_quantizer  # noqa: E402
from grok_tpu.util.oracle import synthetic_image  # noqa: E402
from grok_tpu_torch import api  # noqa: E402
from grok_tpu_torch.codestream import j2k  # noqa: E402
from grok_tpu_torch.core.params import DecompressParams as PDP  # noqa: E402
from grok_tpu_torch.util import mixed_vectors  # noqa: E402

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C toolchain")

BLK = dict(num_resolutions=3, cblk_w_exp=4, cblk_h_exp=4)
KINDS = {"p1": dict(),
         "ht": dict(ht=True),
         "refined": dict(ht=True, ht_planes=2, num_layers=2,
                         rates=[3.0, 1.5]),
         "p1_0x3F": dict(cblk_style=0x3F)}
WIN = (10, 7, 50, 40)
DPS = {"whole": dict(), "reduce1": dict(reduce=1), "window": dict(window=WIN)}


@contextlib.contextmanager
def mixed(comp: int = 1):
    """grok_tpu.compress writing component `comp` on the 9/7 filter: a
    main-header COC (the COD's style with the 9/7) and a QCC with the
    derived 9/7 step sizes at the encode's quant_step and guard bits."""
    orig = japi._build_main_header

    def build(image, params):
        hdr = orig(image, params)
        hdr.coc[comp] = dataclasses.replace(hdr.cod.comp, irreversible=True)
        q = make_quantizer(params.num_resolutions, hdr.comps[comp].prec,
                           True, params.num_guard_bits, params.quant_step,
                           derived=True)
        hdr.qcc[comp] = QuantStyle(style=q.style, guard_bits=q.guard_bits,
                                   steps=q.steps[:1])
        return hdr

    japi._build_main_header = build
    try:
        yield
    finally:
        japi._build_main_header = orig


def _ref(cs: bytes, dp: dict) -> list:
    return [np.asarray(c.data).astype(np.int64)
            for c in decompress(cs, JDP(**dp)).components]


def _held(got: list, ref: list, dp: dict, irrev: set) -> None:
    """got (port tensors) equal to ref (JAX planes) on the 5/3
    components, within 1 on the 9/7 ones; inside the window only."""
    assert len(got) == len(ref)
    for c, (g, r) in enumerate(zip(got, ref)):
        g = g.numpy().astype(np.int64)
        if "window" in dp:
            x0, y0, x1, y1 = dp["window"]
            g = g[y0:y1, x0:x1]
            r = r[y0:y1, x0:x1] if r.shape != g.shape else r
        assert g.shape == r.shape, c
        tol = 1 if c in irrev else 0
        assert int(np.abs(g - r).max()) <= tol, (c, int(np.abs(g - r).max()))


@pytest.fixture(scope="module")
def rgb():
    return synthetic_image(40, 56, 3, seed=2)


@pytest.fixture(scope="module")
def streams(rgb):
    out = {}
    with mixed():
        for k, kw in KINDS.items():
            out[k] = compress(rgb, JCP(mct=0, **BLK, **kw))
    return out


@pytest.mark.parametrize("dpk", list(DPS))
@pytest.mark.parametrize("kind", list(KINDS))
def test_mixed_filters_decode_as_the_jax_package(streams, kind, dpk):
    cs, dp = streams[kind], DPS[dpk]
    hdr = j2k.read_main_header(cs)
    assert hdr.style_for(1).irreversible and not hdr.cod.comp.irreversible
    ref = _ref(cs, dp)
    _held(api.decompress_device(cs, PDP(**dp), device="cpu"), ref, dp, {1})
    if kind in ("p1", "ht"):    # served above; the general route too
        _held(api.stage_general_device(cs, PDP(**dp), device="cpu").run(),
              ref, dp, {1})


def test_mixed_lossless_component_is_the_source(streams, rgb):
    got = api.decompress_device(streams["ht"], device="cpu")
    for c in (0, 2):
        assert np.array_equal(got[c].numpy(), rgb[..., c])


def test_ict_over_mixed_filters(rgb):
    """Component 0 on the 9/7 under the MCT: the decode's ICT takes the
    5/3 planes as float and truncates them, as the JAX package does."""
    with mixed(comp=0):
        cs = compress(rgb, JCP(mct=1, ht=True, **BLK))
    for dp in (dict(), dict(reduce=1)):
        _held(api.decompress_device(cs, PDP(**dp), device="cpu"),
              _ref(cs, dp), dp, {0, 1, 2})


def test_rct_over_a_97_component_raises(streams, rgb):
    """The inverse RCT over a 9/7 plane raises the TypeError the JAX
    package's numpy shift raises."""
    with mixed():
        cs = compress(rgb, JCP(mct=1, ht=True, **BLK))
    with pytest.raises(TypeError):
        decompress(cs)
    with pytest.raises(TypeError):
        api.decompress_device(cs, device="cpu")


def make_mixed_vectors() -> dict:
    """The streams of util/mixed_vectors.npz and what grok_tpu.decompress
    decodes from them (minutes on the CPU: the JAX package's HT coder is
    Python); mixed_vectors.save writes them."""
    h, w, ch, seed = mixed_vectors.SOURCE
    img = synthetic_image(h, w, ch, seed=seed)
    out = {}
    with mixed(mixed_vectors.IRREV_COMP):
        for name, kw in mixed_vectors.SPECS.items():
            cs = compress(img, JCP(**kw))
            planes = [p.astype(np.int32) for p in _ref(cs, {})]
            out[name] = (cs, *mixed_vectors.exact_hashes(planes),
                         planes[mixed_vectors.IRREV_COMP].astype(np.uint8))
    return out


def test_committed_mixed_vectors_code_component_1_on_the_97():
    for name, (cs, sha, sha_win, irrev) in mixed_vectors.load().items():
        hdr = j2k.read_main_header(cs)
        assert [hdr.style_for(c).irreversible for c in range(3)] == \
            [False, True, False], name
        assert hdr.cod.mct == 0
        assert irrev.shape == (1080, 1920) and len(sha) == len(sha_win) == 64


def test_meshed_synthesis_takes_the_filter_per_component(streams):
    """Over a mesh of two CPU shards every synthesis level is row-sharded
    (parallel/sharding.py) with each component's own filter: the planes
    equal the unmeshed decode's."""
    from grok_tpu_torch.parallel import Mesh
    for kind in ("ht", "p1"):
        cs = streams[kind]
        want = api.decompress_device(cs, device="cpu")
        got = api.decompress_device(cs, PDP(mesh=Mesh(("cpu",) * 2)),
                                    device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(got, want)), kind
