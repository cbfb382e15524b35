"""Subsampled and mixed-precision encodes of the port against the JAX
package: grok_tpu_torch.compress of an Image whose components have their
own subsampling (4:2:0, 4:2:2, 4:1:1 Y'CbCr), precision and signedness
(RGB beside a 16-bit signed plane) writes grok_tpu.compress's bytes on
the reversible path (HT, refined HT, Part-1 and its BYPASS switch,
HT-mixed, layers and rate targets, tiles, odd sizes off the canvas
origin, ROI on a chroma plane, JP2 with a BPCC box, AUTO_RD); a 9/7
4:2:2 encode decodes within one of the reference encode's decode; the
streaming Compressor, the process-sharded and the meshed encodes write
the same bytes; a component whose shape disagrees with its subsampling
raises ValueError; grok_tpu_torch.decompress returns grok_tpu.decompress's
Image.  Everything runs on the CPU through the kernels' plain versions,
at 96x64 frames or smaller with 16x16 code-blocks and 3 resolutions."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import grok_tpu  # noqa: E402
from grok_tpu import CompressParams as JCP  # noqa: E402
from grok_tpu import DecompressParams as JDP  # noqa: E402
from grok_tpu import native  # noqa: E402
from grok_tpu.core.image import Component as JComp  # noqa: E402
from grok_tpu.core.image import Image as JImage  # noqa: E402
from grok_tpu.core.params import MCTMode as JMCT  # noqa: E402
from grok_tpu.util.oracle import synthetic_image  # noqa: E402

import grok_tpu_torch  # noqa: E402
from grok_tpu_torch import api  # noqa: E402
from grok_tpu_torch.codec import Compressor  # noqa: E402
from grok_tpu_torch.core.image import Component as PComp  # noqa: E402
from grok_tpu_torch.core.image import Image as PImage  # noqa: E402
from grok_tpu_torch.core.params import CompressParams as PCP  # noqa: E402
from grok_tpu_torch.core.params import DecompressParams as PDP  # noqa: E402
from grok_tpu_torch.core.params import MCTMode  # noqa: E402
from grok_tpu_torch.parallel.distributed import \
    compress_distributed  # noqa: E402
from grok_tpu_torch.parallel.sharding import Mesh  # noqa: E402
from grok_tpu_torch.util import sub_vectors  # noqa: E402

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C toolchain")

BASE = dict(num_resolutions=3, cblk_w_exp=4, cblk_h_exp=4)
# per component (dx, dy, prec, sgnd)
Y420 = [(1, 1, 8, False), (2, 2, 8, False), (2, 2, 8, False)]
Y422 = [(1, 1, 8, False), (2, 1, 8, False), (2, 1, 8, False)]
Y411 = [(1, 1, 8, False), (4, 1, 8, False), (4, 1, 8, False)]
RGBD = [(1, 1, 8, False)] * 3 + [(1, 1, 16, True)]


def _cdiv(a, b):
    return -(-a // b)


def _planes(layout, w, h, x0=0, y0=0, seed=3):
    """Each component's samples on its grid of the canvas [x0, x0 + w) x
    [y0, y0 + h): a smooth synthetic frame, spread to the component's
    precision with noise in the low bits; a 16-bit signed plane is a
    smooth field with noise (an elevation or depth plane)."""
    rng = np.random.default_rng(seed)
    out = []
    for c, (dx, dy, prec, sgnd) in enumerate(layout):
        ch = _cdiv(y0 + h, dy) - _cdiv(y0, dy)
        cw = _cdiv(x0 + w, dx) - _cdiv(x0, dx)
        if prec == 16 and sgnd:
            yy, xx = np.mgrid[:ch, :cw]
            g = (9000 * np.sin(xx / 9.0) + 7000 * np.cos(yy / 7.0)
                 + rng.integers(-400, 400, (ch, cw)))
        else:
            g = synthetic_image(ch, cw, 1, seed=seed + c).astype(np.int64)
            if prec > 8:
                g = (g << (prec - 8)) | rng.integers(0, 1 << (prec - 8),
                                                     g.shape)
            if sgnd:
                g -= 1 << (prec - 1)
        out.append(np.asarray(g, np.int32))
    return out


def _images(layout, w, h, x0=0, y0=0, seed=3):
    """(the JAX Image, the port's Image, the planes) of one frame."""
    planes = _planes(layout, w, h, x0, y0, seed)
    kw = dict(x0=x0, y0=y0, x1=x0 + w, y1=y0 + h)
    ji = JImage([JComp(data=p, dx=dx, dy=dy, prec=pr, sgnd=sg)
                 for p, (dx, dy, pr, sg) in zip(planes, layout)], **kw)
    pi = PImage([PComp(data=p, dx=dx, dy=dy, prec=pr, sgnd=sg)
                 for p, (dx, dy, pr, sg) in zip(planes, layout)], **kw)
    return ji, pi, planes


def _jkw(kw):
    return dict(kw, mct=JMCT(kw["mct"])) if "mct" in kw else kw


# (layout, (w, h), origin, parameters, lossless): Part-1 frames are
# smaller, their plain coder being the slow one on the CPU
CASES = {
    "420-ht": (Y420, (96, 64), (0, 0), dict(ht=True), True),
    "422-ht": (Y422, (96, 64), (0, 0), dict(ht=True), True),
    "411-ht": (Y411, (96, 64), (0, 0), dict(ht=True), True),
    "420-p1": (Y420, (48, 32), (0, 0), dict(), True),
    "422-bypass": (Y422, (48, 32), (0, 0), dict(cblk_style=0x01), True),
    "420-odd-origin": (Y420, (93, 61), (1, 1), dict(ht=True), True),
    "422-odd-tiles": (Y422, (95, 63), (1, 1),
                      dict(ht=True, tile_w=48, tile_h=32), True),
    "411-tiles-p1": (Y411, (48, 32), (0, 0),
                     dict(tile_w=24, tile_h=16), True),
    "420-refined": (Y420, (96, 64), (0, 0), dict(ht=True, ht_planes=2),
                    False),
    "422-mixed": (Y422, (48, 32), (0, 0), dict(ht_mixed=True), True),
    "420-layers": (Y420, (96, 64), (0, 0), dict(ht=True, num_layers=3),
                   True),
    "420-ht-rates": (Y420, (96, 64), (0, 0),
                     dict(ht=True, num_layers=2, rates=[20.0, 5.0]), False),
    "420-p1-rates": (Y420, (48, 32), (0, 0),
                     dict(num_layers=2, rates=[20.0, 5.0]), False),
    "420-roi-chroma": (Y420, (96, 64), (0, 0),
                       dict(ht=True, roi_comp=1, roi_shift=10,
                            roi_rect=(21, 9, 71, 47)), True),
    "rgbd-rct": (RGBD, (96, 64), (0, 0), dict(ht=True), True),
    "rgbd-none-p1": (RGBD, (48, 32), (0, 0), dict(mct=MCTMode.NONE), True),
    "rgbd-jp2": (RGBD, (96, 64), (0, 0), dict(ht=True, jp2=True), True),
    "rgbd-auto-rd": (RGBD, (96, 64), (0, 0),
                     dict(ht=True, mct=MCTMode.AUTO_RD), True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_reversible_encode_writes_the_reference_bytes(name):
    layout, (w, h), (x0, y0), kw, lossless = CASES[name]
    ji, pi, planes = _images(layout, w, h, x0, y0)
    got = grok_tpu_torch.compress(pi, PCP(**BASE, **kw), device="cpu")
    assert got == grok_tpu.compress(ji, JCP(**BASE, **_jkw(kw)))
    if kw.get("jp2"):
        # mixed precisions: IHDR's BPC is 0xFF and the BPCC box is there
        assert b"bpcc" in got[:200]
    if lossless:
        back = api.decompress_device(got, device="cpu")
        assert all(np.array_equal(b.numpy(), p) for b, p in zip(back,
                                                                planes))


def test_tensor_components_stay_on_their_device():
    _ji, pi, planes = _images(Y420, 96, 64)
    dev = PImage([PComp(data=torch.from_numpy(c.data), dx=c.dx, dy=c.dy,
                        prec=c.prec) for c in pi.components], x1=96, y1=64)
    kw = dict(ht=True, **BASE)
    assert grok_tpu_torch.compress(dev, PCP(**kw), device="cpu") == \
        grok_tpu_torch.compress(pi, PCP(**kw), device="cpu")
    with pytest.raises(ValueError, match="meta"):
        grok_tpu_torch.compress(
            PImage([PComp(data=torch.zeros((8, 8), dtype=torch.int32,
                                           device="meta"))]),
            PCP(**kw), device="cpu")


def test_irreversible_422_within_one_of_the_reference():
    """10-bit 4:2:2 on the 9/7: the port quantizes in float32 where the
    reference's host encode quantizes in float64; each stream decoded by
    grok_tpu.decompress, within 1 of the other."""
    layout = [(1, 1, 10, False), (2, 1, 10, False), (2, 1, 10, False)]
    ji, pi, _planes_ = _images(layout, 96, 64)
    kw = dict(BASE, ht=True, irreversible=True)
    mine = grok_tpu.decompress(grok_tpu_torch.compress(pi, PCP(**kw),
                                                       device="cpu"))
    ref = grok_tpu.decompress(grok_tpu.compress(ji, JCP(**kw)))
    for a, b in zip(mine.components, ref.components):
        assert a.data.shape == b.data.shape and (a.dx, a.dy) == (b.dx, b.dy)
        assert int(np.abs(a.data.astype(np.int64) - b.data).max()) <= 1


def test_compressor_writes_compress_tile_for_tile(tmp_path):
    """The streaming object with subsampling=: each tile's (comp_h,
    comp_w) samples, the bytes of compress."""
    ji, pi, planes = _images(Y420, 95, 63, 1, 1)
    kw = dict(BASE, ht=True, tile_w=48, tile_h=32, write_tlm=True)
    want = grok_tpu_torch.compress(pi, PCP(**kw), device="cpu")
    assert want == grok_tpu.compress(ji, JCP(**kw))
    path = str(tmp_path / "s.j2k")
    enc = Compressor(path, width=95, height=63, numcomps=3, x0=1, y0=1,
                     subsampling=[(1, 1), (2, 2), (2, 2)],
                     params=PCP(**kw), device="cpu")
    hdr = enc._hdr
    for t in range(enc.num_tiles):
        r = hdr.siz.tile_rect(t)
        tile = []
        for p, ci in zip(planes, hdr.comps):
            cr = r.ceil_scale(ci.dx, ci.dy)
            gx0, gy0 = _cdiv(1, ci.dx), _cdiv(1, ci.dy)
            tile.append(p[cr.y0 - gy0:cr.y1 - gy0, cr.x0 - gx0:cr.x1 - gx0])
        enc.write_tile(t, tile)
    enc.finish()
    assert open(path, "rb").read() == want


def test_compress_distributed_takes_an_image():
    ji, pi, _planes_ = _images(RGBD, 96, 64)
    kw = dict(BASE, ht=True, tile_w=48, tile_h=32, write_tlm=True)
    got = compress_distributed(pi, PCP(**kw), device="cpu")
    assert got == grok_tpu_torch.compress(pi, PCP(**kw), device="cpu") == \
        grok_tpu.compress(ji, JCP(**kw))


@pytest.mark.parametrize("kw", [dict(ht=True), dict()])
def test_meshed_encode_equals_the_unmeshed_one(kw):
    """The forward DWT levels of each plane split by rows over 8 CPU
    shards (a 4:2:0 chroma plane's coarse levels too short to split run
    on the first device) and, in Part-1, the lanes one call a shard."""
    h, w = (64, 96) if kw else (48, 40)
    _ji, pi, _planes_ = _images(Y420, w, h)
    want = grok_tpu_torch.compress(pi, PCP(**BASE, **kw), device="cpu")
    got = grok_tpu_torch.compress(pi, PCP(mesh=Mesh(("cpu",) * 8), **BASE,
                                          **kw), device="cpu")
    assert got == want


def test_misshaped_components_raise():
    """A component whose shape disagrees with its subsampling (the JAX
    package writes a stream its own decode refuses), and differing
    shapes given to compress_device, raise ValueError."""
    a = synthetic_image(64, 96, 1, seed=1)
    bad = PImage([PComp(data=a), PComp(data=a[:32, :48], dx=2, dy=1)],
                 x1=96, y1=64)
    with pytest.raises(ValueError, match="component 1"):
        grok_tpu_torch.compress(bad, PCP(ht=True, **BASE), device="cpu")
    with pytest.raises(ValueError, match="component 1"):
        compress_distributed(bad, PCP(ht=True, **BASE), device="cpu")
    with pytest.raises(ValueError, match="one shape"):
        api.compress_device([a, a[::2, ::2]], PCP(ht=True, **BASE),
                            device="cpu")


@pytest.fixture(scope="module")
def y420_stream():
    ji, _pi, _planes_ = _images(Y420, 93, 61, 1, 1)
    return grok_tpu.compress(ji, JCP(ht=True, tile_w=48, tile_h=32,
                                     **BASE))


def _same_image(a, b):
    assert (a.x0, a.y0, a.x1, a.y1) == (b.x0, b.y0, b.x1, b.y1)
    assert int(a.color_space) == int(b.color_space)
    assert len(a.components) == len(b.components)
    for p, j in zip(a.components, b.components):
        assert (p.dx, p.dy, p.prec, bool(p.sgnd)) == \
            (j.dx, j.dy, j.prec, bool(j.sgnd))
        assert np.array_equal(p.data, j.data)


@pytest.mark.parametrize("opts", [
    dict(), dict(reduce=1), dict(window=(10, 7, 70, 50)),
    dict(components=[1, 2]), dict(tile_index=3), dict(strict=False)])
def test_decompress_returns_the_reference_image(y420_stream, opts):
    extra = {k: opts.pop(k) for k in ("components", "tile_index")
             if k in opts}
    got = grok_tpu_torch.decompress(y420_stream, PDP(**opts), device="cpu",
                                    **extra)
    _same_image(got, grok_tpu.decompress(y420_stream, JDP(**opts, **extra)))


def test_decompress_is_strict_by_default(y420_stream):
    cut = y420_stream[:len(y420_stream) // 2]
    with pytest.raises(Exception) as ref:
        grok_tpu.decompress(cut)
    with pytest.raises(Exception) as mine:
        grok_tpu_torch.decompress(cut, device="cpu")
    assert type(mine.value).__name__ == type(ref.value).__name__


def test_top_level_surface():
    for name in ("compress", "decompress", "set_msg_handlers", "ColorSpace",
                 "MCTMode", "ProgOrder", "initialize", "deinitialize"):
        assert hasattr(grok_tpu_torch, name), name
    assert grok_tpu_torch.initialize() is True
    assert grok_tpu_torch.deinitialize() is None


def make_sub_hashes(names=None) -> dict:
    """grok_tpu.compress of util/sub_vectors.py's workloads: {name:
    SHA-256 of its bytes} for the reversible, untargeted ones (the HT
    frames take 30-80 s each on the CPU: the JAX package's HT coder is
    Python)."""
    out = {}
    for name in names or sub_vectors.HASHES:
        kind, kw = sub_vectors.WORKLOADS[name]
        img = sub_vectors.image(kind)
        jimg = JImage([JComp(data=c.data, dx=c.dx, dy=c.dy, prec=c.prec,
                             sgnd=c.sgnd) for c in img.components],
                      x0=img.x0, y0=img.y0, x1=img.x1, y1=img.y1)
        out[name] = sub_vectors.sha256(grok_tpu.compress(jimg, JCP(**kw)))
    return out


# the Part-1 frames recompute in about a second each (the JAX package's C
# coder); the HT ones are slow
@pytest.mark.parametrize("name", [
    "y420_p1", "rgbd_p1",
    pytest.param("y422_ht", marks=pytest.mark.slow),
    pytest.param("rgbd_ht", marks=pytest.mark.slow),
    pytest.param("c420", marks=pytest.mark.slow)])
def test_committed_hashes_are_the_reference_encodes(name):
    assert make_sub_hashes([name]) == {name: sub_vectors.HASHES[name]}


def test_sub_vector_frames():
    """The smoke's frames: component shapes on their canvases, ranges of
    their precisions."""
    for kind in ("y422", "y420", "rgbd", "c420"):
        img = sub_vectors.image(kind)
        frame = [c.data for c in img.components]
        api._check_components(img, frame)
        for c in img.components:
            lo, hi = c.clip_range()
            assert lo <= int(c.data.min()) and int(c.data.max()) <= hi
