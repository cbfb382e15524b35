"""Host runtime of the port: the C Tier-2 packet coder and the C HT wire
transforms (cleanup assembly and scan, refinement-segment stuffing and
un-stuffing), bound with ctypes.

The port's copy of the serving half of grok_tpu/native/__init__.py,
over its own copy of the C sources (csrc/host/t2.c, csrc/host/ht_wire.c),
which _build.load_host_library compiles with the host C compiler at the
first call.  There is no Python fallback: without a C compiler these
calls raise.
"""

from __future__ import annotations

import ctypes

import numpy as np

from grok_tpu_torch.util.trace import count

_bound = None


def _lib():
    global _bound
    if _bound is None:
        from grok_tpu_torch._build import load_host_library
        lib = load_host_library()
        ip = ctypes.POINTER(ctypes.c_int)
        llp = ctypes.POINTER(ctypes.c_longlong)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.grk_t2_parse.restype = ctypes.c_int
        lib.grk_t2_parse.argtypes = [
            u8p, ctypes.c_int,
            ctypes.c_int, ip, ip,             # n_ctx, style, band_start
            ip, ip, ip,                       # ttw, tth, blk_start
            ip, ip,                           # blk_x, blk_y
            ctypes.c_int, ip, ip,             # n_pkts, pkt_ctx, pkt_layer
            ctypes.c_int, ctypes.c_int,       # sop, eph
            ip, ip, ip,                       # blk out arrays
            ip, ctypes.c_int, ip,             # chunks, cap, counts
        ]
        lib.grk_ht_scan2_bits.restype = ctypes.c_int
        lib.grk_ht_scan2_bits.argtypes = [
            u8p, ctypes.c_longlong, llp, ip, ctypes.c_int, ip,
            u8p, ctypes.c_longlong, llp, ip, llp]
        lib.grk_ht_assemble_batch.restype = ctypes.c_int
        lib.grk_ht_assemble_batch.argtypes = [
            u8p, llp, llp, llp, llp, llp, llp, ip, ctypes.c_int, u8p,
            ctypes.c_longlong, llp]
        lib.grk_ht_raw_batch.restype = ctypes.c_int
        lib.grk_ht_raw_batch.argtypes = [
            u8p, llp, llp, ctypes.c_int, u8p, ctypes.c_longlong, llp]
        lib.grk_ht_unstuff_batch_bits.restype = ctypes.c_int
        lib.grk_ht_unstuff_batch_bits.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong, llp, ip, ctypes.c_int,
            u8p, ctypes.c_longlong, llp, llp]
        lib.grk_t2_emit.restype = ctypes.c_int
        lib.grk_t2_emit.argtypes = [
            ctypes.c_int, ip, ip, ip, ip, ip, ip,
            ctypes.c_int, ip, ip,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ip, ip, ip, ip, u8p,
            llp, ctypes.c_char_p,
            u8p, ctypes.c_longlong, ip]
        _bound = lib
    return _bound


def _ip(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def _llp(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))


def _u8p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u8(buf) -> np.ndarray:
    """A contiguous buffer (bytes, bytearray, memoryview, uint8 array) as
    a uint8 array over the same memory, with no copy."""
    return np.frombuffer(buf, np.uint8)


def t2_prepare(ctxs_flat: list, packets: list[tuple[int, int]]):
    """Build the flat descriptor arrays grk_t2_parse consumes.  The result
    is reusable across streams of the same geometry (the serving decode
    caches it in its per-geometry plan)."""
    n_ctx = len(ctxs_flat)
    ctx_style = np.zeros(n_ctx, np.int32)
    ctx_band_start = np.zeros(n_ctx + 1, np.int32)
    band_ttw, band_tth, band_blk_start = [], [], [0]
    blk_x, blk_y = [], []
    for ci, (style, bands) in enumerate(ctxs_flat):
        ctx_style[ci] = style
        ctx_band_start[ci + 1] = ctx_band_start[ci] + len(bands)
        for (tw, th_, xys) in bands:
            band_ttw.append(tw)
            band_tth.append(th_)
            band_blk_start.append(band_blk_start[-1] + len(xys))
            for (x, y) in xys:
                blk_x.append(x)
                blk_y.append(y)
    return (n_ctx, ctx_style, ctx_band_start,
            np.asarray(band_ttw, np.int32), np.asarray(band_tth, np.int32),
            np.asarray(band_blk_start, np.int32),
            np.asarray(blk_x, np.int32), np.asarray(blk_y, np.int32),
            np.asarray([p[0] for p in packets], np.int32),
            np.asarray([p[1] for p in packets], np.int32))


def t2_parse_prepared(body, prep, sop: bool, eph: bool):
    """Tier-2 parse of a tile's whole packet sequence over prebuilt
    descriptor arrays (see t2_prepare); `body` is any contiguous buffer,
    read in place.  Returns (blk_included, blk_zb,
    blk_numpasses, chunks ndarray (N, 6) [blk, layer, segno, numpasses,
    offset, length], body_pos), or None if the parser refused the
    body."""
    lib = _lib()
    b = _u8(body)
    (n_ctx, ctx_style, ctx_band_start, band_ttw, band_tth,
     band_blk_start, blk_x, blk_y, pkt_ctx, pkt_layer) = prep
    n_blks = len(blk_x)
    n_pkts = len(pkt_ctx)
    blk_included = np.zeros(n_blks, np.int32)
    blk_zb = np.zeros(n_blks, np.int32)
    blk_np = np.zeros(n_blks, np.int32)
    counts = np.zeros(2, np.int32)
    cap = max(256, n_blks * max(1, n_pkts // max(n_ctx, 1)) * 2 + 64)
    while True:
        chunks = np.zeros((cap, 6), np.int32)
        rc = lib.grk_t2_parse(
            _u8p(b), b.size, n_ctx, _ip(ctx_style), _ip(ctx_band_start),
            _ip(band_ttw), _ip(band_tth), _ip(band_blk_start),
            _ip(blk_x), _ip(blk_y),
            n_pkts, _ip(pkt_ctx), _ip(pkt_layer),
            int(sop), int(eph),
            _ip(blk_included), _ip(blk_zb), _ip(blk_np),
            _ip(chunks), cap, _ip(counts))
        if rc == 3:          # chunk table overflow: grow and retry
            cap *= 4
            continue
        if rc != 0:
            return None
        break
    return (blk_included, blk_zb, blk_np, chunks[:counts[0]],
            int(counts[1]))


def ht_scan2(body, off: np.ndarray, lens: np.ndarray, out=None,
             at: int = 0):
    """Scan + split HT cleanup segments of `body` (any contiguous buffer,
    read in place) into clean sub-streams.

    Returns (out7 (n, 7) int32 [ok, ms_off, ms_len, suf_off, suf_len,
    n_ff, n_7f], digest uint8 array, bits (n, 3) int32 [ms, mel, vlc]) —
    offsets index the digest; ok = 0 for a valid framing, -1 otherwise;
    bits: each clean sub-stream's bits as the scalar decoder reads them,
    past which it reads 1-bits.  The digest is a new array of capacity
    3*len + 24 per block + 64, or with `out` (a writable uint8 array) a
    view of out[at:], whose remaining bytes are the capacity.  None if
    the digest overflowed (never for well-formed input into a new
    array).

    Counts `decode.ht_scan.ms_bytes` (the valid rows' MagSgn wire bytes)
    and `decode.ht_scan.word_bytes` (those the C scan's word path took)."""
    lib = _lib()
    b = _u8(body)
    n = len(off)
    off = np.ascontiguousarray(off, np.int64)
    lens = np.ascontiguousarray(lens, np.int32)
    res = np.zeros((n, 7), np.int32)
    if out is None:
        # the scan writes digest[:used]
        out, at = np.empty(int(3 * int(lens.sum()) + 24 * n + 64),
                           np.uint8), 0
    digest = out[at:]
    used = ctypes.c_longlong(0)
    words = ctypes.c_longlong(0)
    bits = np.zeros((n, 3), np.int32)
    rc = lib.grk_ht_scan2_bits(_u8p(b), b.size, _llp(off), _ip(lens), n,
                               _ip(res), _u8p(digest), digest.size,
                               ctypes.byref(used), _ip(bits),
                               ctypes.byref(words))
    if rc:
        return None
    valid = res[:, 0] == 0
    count("decode.ht_scan.ms_bytes",
          int(lens[valid].sum()) - int(res[valid, 4].sum()))
    count("decode.ht_scan.word_bytes", words.value)
    return res, digest[:int(used.value)], bits


def ht_assemble_batch(buf: np.ndarray, ms_off, ms_bits, mel_off, mel_bits,
                      vlc_off, vlc_bits, pvals):
    """Assemble n wire cleanup segments from clean streams in `buf`
    (byte offsets / bit counts per stream; pvals[k] < 0 skips lane k).
    Returns (out bytes buffer uint8, lens (n,) int64) — segments are
    back-to-back; byte-identical to grok_tpu.t1ht.scalar.assemble_cleanup.
    None on a capacity or suffix-length overflow."""
    lib = _lib()
    n = len(pvals)
    a = [np.ascontiguousarray(x, np.int64) for x in
         (ms_off, ms_bits, mel_off, mel_bits, vlc_off, vlc_bits)]
    pvals = np.ascontiguousarray(pvals, np.int32)
    buf = np.ascontiguousarray(buf, np.uint8)
    ocap = int((a[1].sum() + a[3].sum() + a[5].sum()) // 7
               + (a[1].sum() + a[3].sum() + a[5].sum() + 7) // 8
               + 32 * n + 64)
    out = np.zeros(ocap, np.uint8)
    olens = np.zeros(n, np.int64)
    rc = lib.grk_ht_assemble_batch(
        _u8p(buf), _llp(a[0]), _llp(a[1]), _llp(a[2]), _llp(a[3]),
        _llp(a[4]), _llp(a[5]), _ip(pvals), n, _u8p(out), ocap,
        _llp(olens))
    if rc:
        return None
    return out, olens


def ht_raw_batch(buf: np.ndarray, offs, bits):
    """Stuff n raw (HT SigProp / HT MagRef) clean streams into wire
    segments (0xFF stuffing + non-0xFF terminator), back-to-back.
    Returns (out uint8 buffer, lens (n,) int64); byte-identical to
    grok_tpu.t1ht.scalar._finish_raw."""
    lib = _lib()
    n = len(offs)
    offs = np.ascontiguousarray(offs, np.int64)
    bits = np.ascontiguousarray(bits, np.int64)
    buf = np.ascontiguousarray(buf, np.uint8)
    ocap = int(bits.sum() // 7 + int(bits.sum() + 7) // 8 + 16 * n + 64)
    out = np.zeros(ocap, np.uint8)
    olens = np.zeros(n, np.int64)
    rc = lib.grk_ht_raw_batch(_u8p(buf), _llp(offs), _llp(bits), n,
                              _u8p(out), ocap, _llp(olens))
    if rc:
        raise ValueError("raw segment capacity overflow")
    return out, olens


def ht_unstuff_batch(body: bytes, offs, lens):
    """Un-stuff n raw HT SigProp / HT MagRef wire segments (body[offs[i]:
    offs[i] + lens[i]]) into clean LSB-first bytes, back-to-back.
    Returns (out uint8 buffer, clean lens (n,) int64, each segment's clean
    bits (n,) int64, past which the scalar decoder reads 1-bits); each
    segment is byte-identical to t1ht/wire.py _unstuff_lsb of its wire
    bytes."""
    lib = _lib()
    n = len(offs)
    offs = np.ascontiguousarray(offs, np.int64)
    lens = np.ascontiguousarray(lens, np.int32)
    ocap = int(lens.sum()) + 8
    out = np.zeros(ocap, np.uint8)
    olens = np.zeros(n, np.int64)
    bits = np.zeros(n, np.int64)
    rc = lib.grk_ht_unstuff_batch_bits(body, len(body), _llp(offs),
                                       _ip(lens), n, _u8p(out), ocap,
                                       _llp(olens), _llp(bits))
    if rc:
        raise ValueError("a refinement segment lies outside the tile body")
    return out, olens, bits


def t2_emit_prepare(ctxs: dict, ctx_keys: list):
    """Flatten the static emitter inputs (geometry, zero-bitplanes, pass
    rates/terms, codeword bytes) of a tile.  Returns a dict, or None if
    any block state is missing."""
    n_ctx = len(ctx_keys)
    ctx_band_start = np.zeros(n_ctx + 1, np.int32)
    band_ttw, band_tth, band_blk_start = [], [], [0]
    blk_x, blk_y, blk_zb = [], [], []
    pass_off, pass_rates, pass_terms = [], [], []
    data_off = []
    data = bytearray()
    order = []                 # global block index -> (ctx_key, band, cblk)
    for ci, k in enumerate(ctx_keys):
        ctx = ctxs[k]
        ctx_band_start[ci + 1] = ctx_band_start[ci] + len(ctx.bands)
        for band_i, (_o, bp) in enumerate(ctx.bands):
            band_ttw.append(bp.cblk_grid_w)
            band_tth.append(bp.cblk_grid_h)
            band_blk_start.append(band_blk_start[-1] + len(bp.cblks))
            for cblk_i, g in enumerate(bp.cblks):
                st = ctx.eblocks[band_i][cblk_i]
                if st is None:
                    return None
                x, y = g.idx_in_prec
                blk_x.append(x)
                blk_y.append(y)
                blk_zb.append(st.zb)
                pass_off.append(len(pass_rates))
                for p in st.enc.passes:
                    pass_rates.append(p.rate)
                    pass_terms.append(1 if p.term else 0)
                data_off.append(len(data))
                data.extend(st.enc.data)
                order.append((k, band_i, cblk_i))
    a = lambda v, dt=np.int32: np.asarray(v or [0], dt)  # noqa: E731
    return dict(
        n_ctx=n_ctx, n_blks=len(blk_x),
        ctx_band_start=ctx_band_start,
        band_ttw=a(band_ttw), band_tth=a(band_tth),
        band_blk_start=np.asarray(band_blk_start, np.int32),
        blk_x=a(blk_x), blk_y=a(blk_y), blk_zb=a(blk_zb),
        pass_off=a(pass_off), pass_rates=a(pass_rates),
        pass_terms=np.asarray(pass_terms or [0], np.uint8),
        data_off=np.asarray(data_off or [0], np.int64),
        enc_data=bytes(data), order=order)


def t2_emit_prepared(prep: dict, pkt_ctx: np.ndarray, pkt_layer: np.ndarray,
                     blk_lc: np.ndarray, n_layers: int,
                     sop: bool, eph: bool):
    """Run the C emitter over prepared arrays.  blk_lc: (n_blks, n_layers)
    int32 cumulative passes per layer in GLOBAL block order.  Returns the
    list of packet byte strings, or None if the emitter declined."""
    lib = _lib()
    n_pkts = len(pkt_ctx)
    blk_lc = np.ascontiguousarray(blk_lc, np.int32)
    pkt_lens = np.zeros(max(n_pkts, 1), np.int32)
    cap = (len(prep["enc_data"]) + n_pkts * 64
           + prep["n_blks"] * 24 + 65536)
    while True:
        out = np.zeros(cap, np.uint8)
        rc = lib.grk_t2_emit(
            prep["n_ctx"], _ip(prep["ctx_band_start"]),
            _ip(prep["band_ttw"]), _ip(prep["band_tth"]),
            _ip(prep["band_blk_start"]),
            _ip(prep["blk_x"]), _ip(prep["blk_y"]),
            n_pkts, _ip(pkt_ctx), _ip(pkt_layer),
            n_layers, int(sop), int(eph),
            _ip(prep["blk_zb"]), _ip(blk_lc),
            _ip(prep["pass_off"]), _ip(prep["pass_rates"]),
            _u8p(prep["pass_terms"]),
            _llp(prep["data_off"]), prep["enc_data"],
            _u8p(out), ctypes.c_longlong(cap), _ip(pkt_lens))
        if rc == 3:
            cap *= 4
            continue
        if rc != 0:
            return None
        break
    pkts = []
    pos = 0
    buf = out.tobytes()
    for i in range(n_pkts):
        ln = int(pkt_lens[i])
        pkts.append(buf[pos:pos + ln])
        pos += ln
    return pkts


def t2_emit(ctxs: dict, ctx_keys: list, packets: list[tuple[int, int]],
            n_layers: int, sop: bool, eph: bool):
    """Tier-2 packet emission for a whole tile (one-shot wrapper over
    t2_emit_prepare + t2_emit_prepared; layer_cum read from the block
    states)."""
    prep = t2_emit_prepare(ctxs, ctx_keys)
    if prep is None:
        return None
    blk_lc = np.zeros((prep["n_blks"], n_layers), np.int32)
    for gi, (k, band_i, cblk_i) in enumerate(prep["order"]):
        lc = list(ctxs[k].eblocks[band_i][cblk_i].layer_cum)
        if len(lc) < n_layers:
            lc = lc + [lc[-1] if lc else 0] * (n_layers - len(lc))
        blk_lc[gi] = lc[:n_layers]
    pkt_ctx = np.asarray([p[0] for p in packets] or [0], np.int32)
    pkt_layer = np.asarray([p[1] for p in packets] or [0], np.int32)
    return t2_emit_prepared(prep, pkt_ctx[:len(packets)],
                            pkt_layer[:len(packets)], blk_lc, n_layers,
                            sop, eph)
