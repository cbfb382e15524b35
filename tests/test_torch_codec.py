"""The port's object API (grok_tpu_torch/codec.py Decompressor and
Compressor, on the CPU) held against grok_tpu.codec's objects: the JAX
tests/test_codec_api.py cases (the tile cache, the mapped path source,
the streaming encode's bytes and its resume, the refused whole-stream
features, JP2 palette and channel definitions applied), and a window at
a reduce."""

import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from grok_tpu import CompressParams as JCP  # noqa: E402
from grok_tpu import Image as JImage  # noqa: E402
from grok_tpu import compress, native  # noqa: E402
from grok_tpu import codec as jcodec  # noqa: E402
from grok_tpu.codestream.jp2 import JP2_SIGNATURE, _box  # noqa: E402
from grok_tpu.core.params import DecompressParams as JDP  # noqa: E402
from grok_tpu.util.oracle import synthetic_image  # noqa: E402
import grok_tpu_torch  # noqa: E402
from grok_tpu_torch import api  # noqa: E402
from grok_tpu_torch.core.params import CompressParams as PCP  # noqa: E402
from grok_tpu_torch.core.params import DecompressParams as PDP  # noqa: E402

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C toolchain")

CP = dict(num_resolutions=3, ht=True, cblk_w_exp=4, cblk_h_exp=4)


def _same_image(got, want):
    assert (got.x0, got.y0, got.x1, got.y1) == (want.x0, want.y0, want.x1,
                                                 want.y1)
    assert got.color_space == want.color_space
    assert len(got.components) == len(want.components)
    for g, w in zip(got.components, want.components):
        assert (g.dx, g.dy, g.prec, g.sgnd) == (w.dx, w.dy, w.prec, w.sgnd)
        assert g.data.dtype == np.int32
        assert np.array_equal(g.data, w.data)


@pytest.fixture(scope="module")
def tiled():
    img = synthetic_image(96, 96, 1, seed=70)
    return img, compress(img, JCP(tile_w=32, tile_h=32, write_tlm=True,
                                  **CP))


def test_decompressor_lifecycle_and_tile_cache(tiled):
    img, data = tiled
    dec = grok_tpu_torch.Decompressor(data, device="cpu")
    ref = jcodec.Decompressor(data)
    assert dec.num_tiles == 9
    assert dec.header == grok_tpu_torch.read_header(data)
    assert (dec.header.width, dec.header.height) == (96, 96)
    t4 = dec.decompress_tile(4)
    assert t4[0].device.type == "cpu"
    assert np.array_equal(t4[0].numpy(), ref.decompress_tile(4)[0])
    assert np.array_equal(t4[0].numpy(), img[32:64, 32:64])
    assert dec.cache_info()["tiles_cached"] == 1
    assert dec.decompress_tile(4) is t4            # the cached tiles
    _same_image(dec.decompress(), ref.decompress())
    assert np.array_equal(dec.decompress().to_array(), img)


def test_decompressor_window_and_reduce(tiled):
    img, data = tiled
    for dp in (dict(reduce=1), dict()):
        dec = grok_tpu_torch.Decompressor(data, PDP(**dp), device="cpu")
        ref = jcodec.Decompressor(data, JDP(**dp))
        dec.set_window(20, 10, 70, 61)
        ref.set_window(20, 10, 70, 61)
        _same_image(dec.decompress(), ref.decompress())
        # a tile the window meets, equal inside the window
        got, want = dec.decompress_tile(4)[0].numpy(), \
            ref.decompress_tile(4)[0]
        s = 2 if dp else 1
        y0, x0 = 32 // s, 32 // s
        win = (slice(max(10 // s, y0) - y0, -(-61 // s) - y0),
               slice(max(20 // s, x0) - x0, -(-70 // s) - x0))
        assert np.array_equal(got[win], want[win])
        assert dec.cache_info()["tiles_cached"] == 1


def test_decompressor_mmap_path_source(tmp_path, tiled):
    img, data = tiled
    p = tmp_path / "t.j2k"
    p.write_bytes(data)
    with grok_tpu_torch.Decompressor(str(p), device="cpu") as dec:
        assert dec.num_tiles == 9
        assert np.array_equal(dec.decompress_tile(4)[0].numpy(),
                              img[32:64, 32:64])
        assert np.array_equal(dec.decompress().to_array(), img)
    assert dec._mm is None
    # a JP2 by path: the codestream box stays a view of the mapping
    p2 = tmp_path / "t.jp2"
    p2.write_bytes(compress(img, JCP(tile_w=32, tile_h=32, jp2=True, **CP)))
    with grok_tpu_torch.Decompressor(str(p2), device="cpu") as dec:
        assert isinstance(dec._cs, memoryview)
        assert np.array_equal(dec.decompress_tile(8)[0].numpy(),
                              img[64:, 64:])
        assert dec.header.is_jp2
    assert dec._cs == b""


def _tiles(img, tw):
    ntx = -(-img.shape[1] // tw)
    for t in range(-(-img.shape[0] // tw) * ntx):
        ty, tx = divmod(t, ntx)
        yield t, img[ty * tw:(ty + 1) * tw, tx * tw:(tx + 1) * tw]


@pytest.mark.parametrize("kw", [dict(write_tlm=True),
                                dict(num_layers=2, rates=[12.0, 4.0],
                                     write_tlm=True, write_plt=True)],
                         ids=["lossless", "layered"])
def test_compressor_writes_the_jax_objects_bytes_and_resumes(tmp_path, kw):
    img = synthetic_image(80, 72, 3, seed=9)
    cp = dict(CP, tile_w=32, tile_h=32, **kw)
    p = str(tmp_path / "ref.j2k")
    enc = jcodec.Compressor(p, width=72, height=80, numcomps=3,
                            params=JCP(**cp))
    for t, sub in _tiles(img, 32):
        enc.write_tile(t, sub)
    enc.finish()
    want = open(p, "rb").read()

    p = str(tmp_path / "s.j2k")
    enc = grok_tpu_torch.Compressor(p, width=72, height=80, numcomps=3,
                                    params=PCP(**cp), device="cpu")
    assert enc.num_tiles == 9
    for t, sub in _tiles(img, 32):
        enc.write_tile(t, torch.from_numpy(sub) if t % 2 else sub)
    enc.finish()
    assert open(p, "rb").read() == want
    if "rates" not in kw:
        assert want == api.compress_device(img, PCP(**cp), device="cpu")

    # stopped after 4 tiles, resumed: the same bytes
    p2 = str(tmp_path / "r.j2k")
    enc = grok_tpu_torch.Compressor(p2, width=72, height=80, numcomps=3,
                                    params=PCP(**cp), device="cpu")
    for t, sub in list(_tiles(img, 32))[:4]:
        enc.write_tile(t, sub)
    enc._fh.close()
    enc2 = grok_tpu_torch.Compressor(p2, width=72, height=80, numcomps=3,
                                     params=PCP(**cp), resume=True,
                                     device="cpu")
    assert sum(enc2.tile_written(t) for t in range(enc2.num_tiles)) == 4
    for t, sub in _tiles(img, 32):
        enc2.write_tile(t, sub)
    enc2.finish()
    assert open(p2, "rb").read() == want


def test_compressor_refuses_what_the_jax_object_refuses(tmp_path):
    x = str(tmp_path / "x.j2k")
    for kw in (dict(write_ppm=True), dict(write_plm=True),
               dict(max_tile_parts=2), dict(jp2=True),
               dict(fixed_quality=True, quality=[30.0])):
        with pytest.raises(ValueError):
            jcodec.Compressor(x, width=64, height=64, params=JCP(**kw))
        with pytest.raises(ValueError):
            grok_tpu_torch.Compressor(x, width=64, height=64,
                                      params=PCP(**kw), device="cpu")
    with pytest.raises(NotImplementedError, match="subsampled"):
        grok_tpu_torch.Compressor(x, width=64, height=64, numcomps=3,
                                  subsampling=[(1, 1), (2, 2), (2, 2)],
                                  device="cpu")
    enc = grok_tpu_torch.Compressor(x, width=64, height=64, device="cpu")
    with pytest.raises(ValueError, match="not written"):
        enc.finish()
    if not torch.cuda.is_available():      # the card by default
        with pytest.raises(RuntimeError, match="CUDA"):
            grok_tpu_torch.Decompressor(compress(np.zeros((8, 8),
                                                          np.int32)))


def _jp2(cs: bytes, jp2h_boxes: bytes) -> bytes:
    ftyp = _box(b"ftyp", b"jp2 " + struct.pack(">I", 0) + b"jp2 ")
    return JP2_SIGNATURE + ftyp + _box(b"jp2h", jp2h_boxes) + \
        _box(b"jp2c", cs)


def test_decompressor_applies_jp2_palette_and_cdef():
    rng = np.random.default_rng(3)
    # a palette: one index component through pclr/cmap to three
    idx = rng.integers(0, 7, (24, 24)).astype(np.int32)
    pal = rng.integers(0, 256, (7, 3)).astype(np.int64)
    cs = compress(JImage.from_array(idx, prec=8), JCP(**CP))
    ihdr = _box(b"ihdr", struct.pack(">IIHBBBB", 24, 24, 1, 7, 7, 0, 0))
    colr = _box(b"colr", struct.pack(">BBBI", 1, 0, 0, 16))
    pclr = struct.pack(">HB", 7, 3) + bytes([7, 7, 7])
    for row in pal:
        pclr += bytes(int(v) for v in row)
    cmap = _box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, c)
                                  for c in range(3)))
    data = _jp2(cs, ihdr + colr + _box(b"pclr", pclr) + cmap)
    got = grok_tpu_torch.Decompressor(data, device="cpu").decompress()
    _same_image(got, jcodec.Decompressor(data).decompress())
    assert np.array_equal(got.to_array(), pal[idx])
    # cdef: stored A, B, G, R back to R, G, B, A; and RGBA's own cdef box
    px = rng.integers(0, 256, (24, 24, 4)).astype(np.int32)
    stored = np.ascontiguousarray(px[..., ::-1])
    cs = compress(JImage.from_array(stored, prec=8), JCP(**CP))
    ihdr = _box(b"ihdr", struct.pack(">IIHBBBB", 24, 24, 4, 7, 7, 0, 0))
    cdef = _box(b"cdef", struct.pack(">H", 4) + struct.pack(">HHH", 0, 1, 0)
                + struct.pack(">HHH", 1, 0, 3) + struct.pack(">HHH", 2, 0, 2)
                + struct.pack(">HHH", 3, 0, 1))
    data = _jp2(cs, ihdr + colr + cdef)
    got = grok_tpu_torch.Decompressor(data, device="cpu").decompress()
    _same_image(got, jcodec.Decompressor(data).decompress())
    assert np.array_equal(got.to_array(), px)
    data = compress(synthetic_image(24, 24, 4, seed=8), JCP(jp2=True, **CP))
    _same_image(grok_tpu_torch.Decompressor(data, device="cpu").decompress(),
                jcodec.Decompressor(data).decompress())
