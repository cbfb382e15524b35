"""HT code-blocks whose style carries Part-1 mode-switch bits beside the
HT bit, and components mixing HT and Part-1 code-blocks, decoded by the
port (grok_tpu_torch.api.decompress_device on the CPU: the serving decode
for cleanup-only HT, the general route for refined HT and the mixed
components) against grok_tpu.decompress on the same edited streams.

The streams are the JAX package's encodes with their coding style
edited: the COD style byte OR'd with each of the six Part-1 switches
(0x01 BYPASS ... 0x20 SEGSYM) and with all of them, and a COC giving one
component of an RGB stream all six; an HT segment ends at every pass
whatever the other bits say, and the HT decoder reads none of them, so
each decodes to what the unedited stream does.  The mixed stream joins
the packets of an HT encode (component 0) and a Part-1 encode
(components 1 and 2) of the same frame under COCs, and decodes to the
frame."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from grok_tpu import CompressParams as JCP  # noqa: E402
from grok_tpu import DecompressParams as JDP  # noqa: E402
from grok_tpu import compress, decompress, native  # noqa: E402
from grok_tpu.util.oracle import synthetic_image  # noqa: E402
from grok_tpu_torch import api  # noqa: E402
from grok_tpu_torch.codestream import j2k  # noqa: E402
from grok_tpu_torch.core.params import CBLK_HT  # noqa: E402
from grok_tpu_torch.core.params import DecompressParams as PDP  # noqa: E402
from grok_tpu_torch.pipeline import plan as pplan  # noqa: E402
from grok_tpu_torch.pipeline.serve import GeneralRoute  # noqa: E402
from grok_tpu_torch.util import stream_edit  # noqa: E402

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C toolchain")

BLK = dict(num_resolutions=3, cblk_w_exp=4, cblk_h_exp=4)
KINDS = {"cleanup": dict(ht=True),
         "refined": dict(ht=True, ht_planes=2, num_layers=2,
                         rates=[3.0, 1.5])}
BITS = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x3F]
DPS = [dict(), dict(reduce=1), dict(max_layers=1)]


def _arr(comps):
    a = [c.numpy() for c in comps]
    return a[0] if len(a) == 1 else np.stack(a, -1)


def _edit(cs: bytes, cod_bits: int = 0, coc: dict | None = None) -> bytes:
    """cs with its COD style OR'd with cod_bits, and a COC per
    {component: style}."""
    if cod_bits:
        cs = stream_edit.or_cod_style(cs, cod_bits)
    for c, st in (coc or {}).items():
        cs = stream_edit.with_coc(cs, c, st)
    return cs


@pytest.fixture(scope="module")
def gray():
    return synthetic_image(48, 56, 1, seed=31)


@pytest.fixture(scope="module")
def streams(gray):
    return {k: compress(gray, JCP(**BLK, **kw)) for k, kw in KINDS.items()}


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("kind", list(KINDS))
def test_ht_with_mode_switch_bits_decodes(streams, kind, bits):
    data = streams[kind]
    edited = _edit(data, bits)
    assert edited != data
    hdr = j2k.read_main_header(edited)
    assert hdr.cod.comp.cblk_style == CBLK_HT | bits
    for kw in DPS:
        want = decompress(edited, JDP(**kw)).to_array()
        assert np.array_equal(want, decompress(data, JDP(**kw)).to_array())
        got = api.decompress_device(edited, PDP(**kw), device="cpu")
        assert np.array_equal(_arr(got), want), kw
    batch = api.decompress_device_batch([edited, data], device="cpu")
    want = decompress(data).to_array()
    assert all(np.array_equal(_arr(b), want) for b in batch)


def test_cleanup_ht_with_switches_is_served(streams):
    """A cleanup-only HT stream with switch bits takes the serving
    decode (its plan's coder is "ht"); a refined one the general
    route."""
    from grok_tpu_torch.pipeline.serve import stage_serving_batch
    for kind, served in (("cleanup", True), ("refined", False)):
        edited = _edit(streams[kind], 0x3F)
        hdr = j2k.read_main_header(edited)
        parts = j2k.read_tile_parts(edited, hdr)
        th, body = api._tile_body(edited, hdr, parts)
        assert pplan._plan_for(edited, hdr, 0, th).coder == "ht"
        try:
            stage_serving_batch(edited, hdr, 0, th, [body],
                                PDP(strict=False), device="cpu")
            took = True
        except GeneralRoute:
            took = False
        assert took == served, kind


@pytest.fixture(scope="module")
def rgb():
    return synthetic_image(40, 48, 3, seed=32)


@pytest.mark.parametrize("kind", list(KINDS))
def test_coc_mode_switch_bits_on_one_component(rgb, kind):
    data = compress(rgb, JCP(**BLK, **KINDS[kind]))
    edited = _edit(data, coc={1: CBLK_HT | 0x3F})
    hdr = j2k.read_main_header(edited)
    assert hdr.coc[1].cblk_style == CBLK_HT | 0x3F
    for kw in DPS:
        want = decompress(edited, JDP(**kw)).to_array()
        assert np.array_equal(want, decompress(data, JDP(**kw)).to_array())
        got = api.decompress_device(edited, PDP(**kw), device="cpu")
        assert np.array_equal(_arr(got), want), kw


def _packets(cs: bytes) -> list:
    """The one tile-part's packets, cut by its PLT."""
    hdr = j2k.read_main_header(cs)
    (part,) = j2k.read_tile_parts(cs, hdr)
    th = j2k.TileHeader()
    j2k.read_tile_part_header(cs, part, hdr, th)
    body = cs[part.data_start:part.data_end]
    ends = np.cumsum(th.plt)
    return [body[e - n:e] for e, n in zip(ends, th.plt)]


def test_components_mixing_ht_and_part1(rgb):
    """Component 0 in HT blocks, 1 and 2 in Part-1 blocks (COCs): the
    packets of two encodes of the frame joined (LRCP, one layer and one
    precinct: packet r * 3 + c); lossless, equal to grok_tpu.decompress,
    on the general route."""
    kw = dict(BLK, write_plt=True)
    ht = compress(rgb, JCP(ht=True, **kw))
    p1 = compress(rgb, JCP(**kw))
    pk_ht, pk_p1 = _packets(ht), _packets(p1)
    pk = [(pk_ht if k % 3 == 0 else pk_p1)[k] for k in range(len(pk_ht))]
    main, [(sot, segs, _data)], tail = stream_edit._split(
        _edit(ht, coc={1: 0, 2: 0}))
    segs = [(m, j2k.write_plt([len(p) for p in pk]) if m == j2k.PLT else s)
            for m, s in segs]
    mixed = stream_edit._join(main, [(sot, segs, b"".join(pk))], tail)
    hdr = j2k.read_main_header(mixed)
    assert pplan._plan_for(mixed, hdr, 0, j2k.TileHeader()).coder == "split"
    want = decompress(mixed).to_array()
    assert np.array_equal(want, rgb)
    for kw_d in DPS:
        got = api.decompress_device(mixed, PDP(**kw_d), device="cpu")
        assert np.array_equal(_arr(got),
                              decompress(mixed, JDP(**kw_d)).to_array())
