"""The serving decode's upload laid out the plain way, for the tests of
its staging arena (pipeline/serve.py `_Arena`): each stream's tile body
joined into bytes, parsed by the C Tier-2 parse, its HT blocks scanned
into a digest array of their own, and every piece (per stream its raw
body, then its digest) copied into a zeroed buffer at 16-byte-aligned
bases; beside it the lane meta, a lane for every kept block of every
stream, bucket by bucket, stream major.  A staged batch's body and meta
are held to these byte for byte."""

import numpy as np

from grok_tpu_torch import api, native
from grok_tpu_torch.codestream import j2k, jp2
from grok_tpu_torch.pipeline import serve
from grok_tpu_torch.pipeline.device import META_COLS
from grok_tpu_torch.pipeline.plan import _plan_for


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def joined_layout(streams) -> tuple:
    """(body_cat uint8, meta (lanes, META_COLS) int32) of a batch of
    single-tile streams under one main header, decoded whole."""
    css = [jp2.locate_codestream(bytes(s), permissive=True)
           for s in streams]
    hdr = j2k.read_main_header(css[0])
    tiles = [api._tile_body(cs, hdr, j2k.read_tile_parts(cs, hdr,
                                                          strict=False))
             for cs in css]
    plan = _plan_for(bytes(css[0][:hdr.main_header_end]), hdr, 0,
                     tiles[0][0], 0)
    fidx, bsel = serve._full_index(plan)
    rows = np.zeros((len(streams), fidx.size, META_COLS), np.int64)
    pieces, top = [], 0
    for si, (th, body) in enumerate(tiles):
        incl, zb, npass, chunks, _end = native.t2_parse_prepared(
            body, plan.prep, plan.sop, plan.eph)
        incl = incl.astype(bool)
        if len(chunks) != np.count_nonzero(incl):
            body, offs, lens = serve._concat_layers(body, chunks,
                                                    plan.n_blks)
            body = body.tobytes()
        else:
            offs = np.zeros(plan.n_blks, np.int64)
            lens = np.zeros(plan.n_blks, np.int64)
            offs[chunks[:, 0]] = chunks[:, 4]
            lens[chunks[:, 0]] = chunks[:, 5]
        idx = np.nonzero(incl & plan.rok)[0]
        pos = np.searchsorted(fidx, idx)
        numbps = plan.mb[idx] - zb[idx]
        if plan.coder == "mixed":
            bm = np.frombuffer(th.ht_mixed_bitmap(), np.uint8)
            c = plan.canon_idx[idx]
            hsel = ((bm[c >> 3] >> (c & 7)) & 1).astype(bool)
        else:
            hsel = np.full(idx.size, plan.coder == "ht")
        if plan.coder != "ht":
            m = ~hsel
            r = rows[si, pos[m]]
            r[:, 6] = offs[idx][m] + top
            r[:, 7] = lens[idx][m]
            r[:, 8] = npass[idx][m]
            r[:, 9] = numbps[m]
            rows[si, pos[m]] = r
            pieces.append((top, body))
            top += _up16(len(body))
        if plan.coder != "mq":
            dig = b""
            if hsel.any():
                scan, dig, bits = native.ht_scan2(body, offs[idx][hsel],
                                                  lens[idx][hsel])
                r = rows[si, pos[hsel]]
                r[:, 0] = scan[:, 1] + top
                r[:, 1] = scan[:, 2]
                r[:, 2] = scan[:, 3] + top
                r[:, 3] = scan[:, 4]
                r[:, 4] = np.minimum(plan.ht_p_ext,
                                     np.maximum(numbps[hsel] - 1, 0))
                r[:, 5] = 1
                r[:, 10:13] = bits
                rows[si, pos[hsel]] = r
            pieces.append((top, dig))
            top += _up16(len(dig))
    body_cat = np.zeros(max(16, top), np.uint8)
    for base, b in pieces:
        body_cat[base:base + len(b)] = np.frombuffer(b, np.uint8)
    meta = np.concatenate([rows[:, sel].reshape(-1, META_COLS)
                           for sel in bsel if sel.size])
    return body_cat, meta.astype(np.int32)
