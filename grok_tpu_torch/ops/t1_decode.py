"""Batched Part-1 (EBCOT/MQ) code-block decode: kernel K3 of the port.

One lane is one code-block.  Each lane's codeword bytes are read straight
from an uploaded byte body at its start offset; a per-lane, per-pass
segment table says where each codeword segment opens and ends and which
passes are raw (BYPASS).  The output is the signed reconstruction
mag2 = +-(known bits * 2 + half bit at the last decoded plane), an
(NL, H, W) int32 tensor: what grok_tpu/t1/t1_scalar.py `decode_block`
returns as (mag2, neg), and the contract of the TPU kernel
grok_tpu/ops/pallas_t1.py `pallas_t1_decode`, with all of its mode
switches: BYPASS raw segments, TERMALL and other multi-segment
codewords, RESET, VSC and SEGSYM.

  - `t1_decode_lanes` is the wrapper: a CUDA tensor launches the
    hand-written kernel in csrc/t1_decode.cu (one warp per lane, the
    lane's state in shared memory, a persistent grid that takes the
    lanes longest first), a CPU tensor runs `t1_decode_lanes_ref`.  There
    is no fallback from one to the other.
  - `t1_decode_lanes_sharded` splits the lanes over a device mesh: one
    t1_decode_lanes call per shard, on the shard's device.
  - `t1_decode_lanes_v1` launches the first design, csrc/t1_decode_v1.cu
    (one thread per lane), kept as the full-lane oracle and the speed
    yardstick of the kernel on the card (chip_smoke.py and the
    hardware-validation tool); no serving path reaches it.
  - `t1_decode_lanes_ref` is the plain PyTorch version: all lanes step in
    lockstep through the scan positions of every pass, each MQ decision
    a handful of tensor ops with masked lanes.
  - `segment_table` builds the segment table from each block's pass
    count, style and segment lengths (the B.10.7 termination pattern).

Segment table: ptbl (NL, P, 3) int32, row p = (start, end, raw) of the
lane's pass p: start >= 0 opens a new codeword segment at that byte
offset (relative to the lane's start) ending at `end`; start = -1
continues the current one; raw = 1 marks a raw pass.  Passes at p >= P
continue, not raw.  Reads past a segment's end see 0xFF (MQ, C.3.4) or
0 bits (raw).  style carries the code-block style bits; the decoder
reads VSC, RESET and SEGSYM from it.

Shared with the encoder (ops/t1_encode.py): the packed neighbour-flag
word per sample and the LUTs over it (`flag_luts`), and the MQ state
tables of the plain versions.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from grok_tpu_torch.core.params import CBLK_RESET, CBLK_SEGSYM, CBLK_VSC
from grok_tpu_torch.ops.ht_decode import lane_dims_ok
from grok_tpu_torch.t1 import luts, mq
from grok_tpu_torch.t1.records import (PASS_CLN, PASS_REF, PASS_SIG,
                                       is_raw_pass, pass_schedule,
                                       segment_pass_counts)
from grok_tpu_torch.util.trace import count, trace

MAX_NUMBPS = 30          # mag2 of 30 planes fills int32

# flag word bits: neighbour significance, the orthogonal neighbours'
# signs, and the sample's own state
F_NW, F_N, F_NE = 1 << 0, 1 << 1, 1 << 2
F_W, F_E = 1 << 3, 1 << 4
F_SW, F_S, F_SE = 1 << 5, 1 << 6, 1 << 7
F_SGN_N, F_SGN_E, F_SGN_S, F_SGN_W = 1 << 8, 1 << 9, 1 << 10, 1 << 11
F_SIG, F_VIS, F_MU, F_NEG = 1 << 12, 1 << 13, 1 << 14, 1 << 15
VSC_MASK = ~(F_SW | F_S | F_SE)   # stripe row 3 under VSC: no row below
_M32 = 0xFFFFFFFF


@lru_cache(maxsize=1)
def flag_luts() -> np.ndarray:
    """The context LUTs over the flag word, as one uint8 array:
    [0, 1024): zero-coding context at (orient << 8) | (f & 0xFF);
    [1024, 5120): sign coding at 1024 + (f & 0xFFF), context 9..13 in
    the low nibble and the XOR bit at bit 4.  Built from the Table D.1 /
    D.2 rules of t1/luts.py."""
    out = np.zeros(1024 + 4096, np.uint8)
    for f in range(256):
        h = ((f >> 3) & 1) + ((f >> 4) & 1)
        v = ((f >> 1) & 1) + ((f >> 6) & 1)
        d = (f & 1) + ((f >> 2) & 1) + ((f >> 5) & 1) + ((f >> 7) & 1)
        for orient in range(4):
            out[(orient << 8) | f] = luts.zc_context(orient, h, v, d)
    for f in range(4096):
        hc = ((f >> 4) & 1) * (1 - 2 * ((f >> 9) & 1)) \
            + ((f >> 3) & 1) * (1 - 2 * ((f >> 11) & 1))
        vc = ((f >> 1) & 1) * (1 - 2 * ((f >> 8) & 1)) \
            + ((f >> 6) & 1) * (1 - 2 * ((f >> 10) & 1))
        cx, xr = luts.sc_context(max(-1, min(1, hc)), max(-1, min(1, vc)))
        out[1024 + f] = cx | (xr << 4)
    return out


def mq_table() -> np.ndarray:
    """The MQ state table packed for the kernels, one int32 per state:
    qe | nmps << 16 | nlps << 22 | switch << 28."""
    return (mq.MQ_QE.astype(np.int64) | (mq.MQ_NMPS.astype(np.int64) << 16)
            | (mq.MQ_NLPS.astype(np.int64) << 22)
            | (mq.MQ_SWITCH.astype(np.int64) << 28)).astype(np.int32)


_DEV_LUT: dict = {}


def lut_on(device: torch.device) -> tuple:
    """(flag_luts() as uint8, mq_table() as int32) on `device`: the
    kernels' tables."""
    key = str(device)
    got = _DEV_LUT.get(key)
    if got is None:
        got = (torch.from_numpy(flag_luts()).to(device),
               torch.from_numpy(mq_table()).to(device))
        _DEV_LUT[key] = got
    return got


class _Tables:
    """Plain-version tables on one device.  A context's state is one
    "cell" = (state index << 1) | mps."""

    def __init__(self, device):
        i64 = torch.int64
        qe = mq.MQ_QE.astype(np.int64)
        nmps = mq.MQ_NMPS.astype(np.int64)
        nlps = mq.MQ_NLPS.astype(np.int64)
        sw = mq.MQ_SWITCH.astype(np.int64)
        s = np.arange(47)
        cell_qe, cell_nm, cell_nl = (np.zeros(94, np.int64) for _ in range(3))
        for m in (0, 1):
            cell_qe[2 * s + m] = qe
            cell_nm[2 * s + m] = (nmps << 1) | m
            cell_nl[2 * s + m] = (nlps << 1) | (m ^ sw)
        a = np.arange(1 << 16)
        nsh = np.where(a > 0, 15 - np.floor(np.log2(np.maximum(a, 1))), 0)
        ctx0 = np.array([st << 1 | m for st, m in mq.initial_ctx_states()])
        lut = flag_luts().astype(np.int64)

        def t(x):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=i64,
                                   device=device)
        self.qe, self.nm, self.nl = t(cell_qe), t(cell_nm), t(cell_nl)
        self.nsh = t(nsh.astype(np.int64))
        self.ctx0 = t(ctx0)
        self.zc = t(lut[:1024])
        self.sc = t(lut[1024:])
        pat = np.zeros((2, 3, 3), np.int64)   # mark_sig neighbourhood
        for neg in (0, 1):
            pat[neg] = [[F_SE, F_S | neg * F_SGN_S, F_SW],
                        [F_E | neg * F_SGN_E, F_SIG | neg * F_NEG,
                         F_W | neg * F_SGN_W],
                        [F_NE, F_N | neg * F_SGN_N, F_NW]]
        self.pat = t(pat)


_TABLES: dict = {}


def tables_on(device) -> _Tables:
    key = str(device)
    got = _TABLES.get(key)
    if got is None:
        got = _TABLES[key] = _Tables(device)
    return got


def mark_sig(F, T, y: int, x: int, negb, m, vis=None):
    """Set sample (y, x) significant with sign negb where m: its own
    SIG/NEG bits and its eight neighbours' flags (F has a 1-sample
    border).  vis: lanes whose sample also gets VIS."""
    upd = torch.where(m[:, None, None], T.pat[negb.to(torch.int64)], 0)
    if vis is not None:
        upd[:, 1, 1] |= torch.where(vis, F_VIS, 0)
    F[:, y:y + 3, x:x + 3] |= upd


def stripe_order(H: int, W: int) -> list:
    """(y, x) of an H x W block in stripe scan order: 4-row stripes,
    column by column, top to bottom within a column."""
    return [(y, x) for y0 in range(0, H, 4) for x in range(W)
            for y in range(y0, min(y0 + 4, H))]


class _MQDec:
    """Lockstep MQ decoders (C.3) and raw readers, one per lane."""

    def __init__(self, T, body, start, NL, dev):
        i64 = torch.int64
        self.T = T
        self.body = body.to(i64)
        self.start = start
        z = torch.zeros(NL, dtype=i64, device=dev)
        self.a, self.c, self.ct, self.bp, self.send = z + 0x8000, z, z, z, z
        self.rct, self.rbyte, self.rprev = z, z, z
        self.ctx = T.ctx0.repeat(NL, 1)

    def byte(self, i, past: int):
        v = self.body[(self.start + i).clamp(0, self.body.numel() - 1)]
        return torch.where(i < self.send, v, past)

    def bytein(self, m):
        cur, nxt = self.byte(self.bp, 0xFF), self.byte(self.bp + 1, 0xFF)
        is_ff = cur == 0xFF
        stop = is_ff & (nxt > 0x8F)
        add = torch.where(stop, 0xFF00, torch.where(is_ff, nxt << 9,
                                                    nxt << 8))
        self.c = torch.where(m, (self.c + add) & _M32, self.c)
        self.ct = torch.where(m, torch.where(is_ff & ~stop, 7, 8), self.ct)
        self.bp = self.bp + (m & ~stop)

    def initdec(self, m):
        """C.3.5 INITDEC at the current byte position, where m."""
        self.a = torch.where(m, 0x8000, self.a)
        self.c = torch.where(m, self.byte(self.bp, 0xFF) << 16, self.c)
        self.ct = torch.where(m, 0, self.ct)
        self.bytein(m)
        self.c = torch.where(m, (self.c << 7) & _M32, self.c)
        self.ct = torch.where(m, self.ct - 7, self.ct)

    def decode(self, cx, act):
        """One decision per lane in context cx where act; 0 elsewhere."""
        T = self.T
        cell = self.ctx.gather(1, cx[:, None])[:, 0]
        qe = T.qe[cell]
        a1 = self.a - qe
        xp = (self.c >> 16) < qe                  # LPS exchange path
        small = a1 < qe
        msb = a1 >= 0x8000
        is_mps = torch.where(xp, small, msb | ~small)
        bit = torch.where(is_mps, cell & 1, 1 - (cell & 1))
        rn = act & (xp | ~msb)
        new = torch.where(is_mps, T.nm[cell], T.nl[cell])
        self.ctx.scatter_(1, cx[:, None], torch.where(rn, new, cell)[:, None])
        self.a = torch.where(act, torch.where(xp, qe, a1), self.a)
        self.c = torch.where(act & ~xp, self.c - (qe << 16), self.c)
        # RENORMD: n shifts, a BYTEIN before each shift that finds CT = 0
        n = torch.where(rn, T.nsh[self.a], 0)
        for _ in range(3):
            m = n > 0
            if not bool(m.any()):
                break
            feed = m & (self.ct == 0)
            if bool(feed.any()):
                self.bytein(feed)
            s = torch.minimum(n, self.ct)
            self.a = (self.a << s) & 0xFFFF
            self.c = (self.c << s) & _M32
            self.ct = self.ct - s
            n = n - s
        return torch.where(act, bit, 0)

    def raw_bit(self, m):
        """One raw bit per lane where m (MSB first, 7 bits after 0xFF)."""
        need = m & (self.rct == 0)
        cur = self.byte(self.bp, 0)
        nb = torch.where(self.rprev == 0xFF, 7, 8)
        self.rbyte = torch.where(need, cur, self.rbyte)
        self.rct = torch.where(need, nb, self.rct)
        self.rprev = torch.where(need, cur, self.rprev)
        self.bp = self.bp + need
        self.rct = self.rct - m.to(torch.int64)
        return torch.where(m, (self.rbyte >> self.rct.clamp(min=0)) & 1, 0)


def t1_decode_lanes_ref(body, start, npass, nbps, orient, w, h, style, ptbl,
                        W: int, H: int):
    """Plain PyTorch decode of NL lanes -> signed mag2 (NL, H, W) int32;
    see t1_decode_lanes for the arguments."""
    dev = body.device
    i64 = torch.int64
    T = tables_on(dev)
    NL = start.shape[0]
    P = ptbl.shape[1]
    nbps = nbps.to(i64)
    live = (nbps >= 0) & (nbps <= MAX_NUMBPS)
    nbps = torch.where(live, nbps, 0)
    npass = npass.to(i64)
    ori = orient.to(i64) << 8
    sty = style.to(i64)
    vsc = (sty & CBLK_VSC) != 0
    reset = (sty & CBLK_RESET) != 0
    segsym = (sty & CBLK_SEGSYM) != 0
    any_vsc = bool(vsc.any())
    tbl = ptbl.to(i64)
    lane = torch.arange(NL, device=dev)
    xin = [w.to(i64) > x for x in range(W)]
    yin = [h.to(i64) > y for y in range(H)]
    F = torch.zeros((NL, H + 2, W + 2), dtype=i64, device=dev)
    out = torch.zeros((NL, H, W), dtype=i64, device=dev)
    st = _MQDec(T, body, start.to(i64), NL, dev)
    RL = torch.full((NL,), mq.CTX_RL, dtype=i64, device=dev)
    UNI = torch.full((NL,), mq.CTX_UNI, dtype=i64, device=dev)

    def flags(y, x):
        f = F[:, y + 1, x + 1]
        if y % 4 == 3 and any_vsc:
            f = torch.where(vsc, f & VSC_MASK, f)
        return f

    def pass_start(pno, act):
        """Open pass pno where act: the segment table's row, INITDEC or a
        fresh raw reader at a new segment, RESET.  Returns the raw lanes."""
        row = tbl[lane, pno.clamp(0, P - 1)]
        inr = pno < P
        ns = torch.where(inr, row[:, 0], -1)
        rawf = inr & (row[:, 2] != 0)
        m_new = act & (ns >= 0)
        st.send = torch.where(m_new, row[:, 1], st.send)
        st.bp = torch.where(m_new, ns, st.bp)
        m_raw = m_new & rawf
        st.rct = torch.where(m_raw, 0, st.rct)
        st.rprev = torch.where(m_raw, 0, st.rprev)
        st.initdec(m_new & ~rawf)
        rst = act & reset & ~rawf
        st.ctx = torch.where(rst[:, None], T.ctx0, st.ctx)
        return act & rawf

    def dec(cx, m, raw, any_raw):
        if not bool(m.any()):
            return torch.zeros_like(cx)
        if not any_raw:
            return st.decode(cx, m)
        return st.decode(cx, m & ~raw) | st.raw_bit(m & raw)

    maxbp = int(nbps.max()) if NL else 0
    for bpl in range(maxbp - 1, -1, -1):
        k = nbps - 1 - bpl
        half = 3 << bpl
        for ptype in (PASS_SIG, PASS_REF, PASS_CLN):
            if ptype == PASS_CLN:
                pno, act = 3 * k, (k >= 0) & live
            else:
                pno = 3 * k - (2 if ptype == PASS_SIG else 1)
                act = (k >= 1) & live
            act = act & (pno < npass)
            if not bool(act.any()):
                continue
            raw = pass_start(pno, act)
            any_raw = bool(raw.any())
            if ptype == PASS_SIG:
                for y, x in stripe_order(H, W):
                    f = flags(y, x)
                    coded = act & xin[x] & yin[y] \
                        & ((f & (F_SIG | F_VIS)) == 0) & ((f & 0xFF) != 0)
                    bit = dec(T.zc[ori + (f & 0xFF)], coded, raw, any_raw)
                    became = coded & (bit == 1)
                    if bool(became.any()):
                        sc = T.sc[f & 0xFFF]
                        sbit = dec(sc & 15, became & ~raw, raw, False) \
                            ^ (sc >> 4)
                        if any_raw:
                            sbit = torch.where(raw, st.raw_bit(became & raw),
                                               sbit)
                        mark_sig(F, T, y, x, sbit, became, vis=coded)
                        out[:, y, x] = torch.where(became, half, out[:, y, x])
                    else:
                        F[:, y + 1, x + 1] |= torch.where(coded, F_VIS, 0)
            elif ptype == PASS_REF:
                for y, x in stripe_order(H, W):
                    f = flags(y, x)
                    coded = act & xin[x] & yin[y] & ((f & F_SIG) != 0) \
                        & ((f & F_VIS) == 0)
                    if not bool(coded.any()):
                        continue
                    mr = torch.where((f & F_MU) != 0, 16,
                                     torch.where((f & 0xFF) != 0, 15, 14))
                    bit = dec(mr, coded, raw, any_raw)
                    out[:, y, x] += torch.where(
                        coded, (bit << (bpl + 1)) - (1 << (bpl + 1))
                        + (1 << bpl), 0)
                    F[:, y + 1, x + 1] |= torch.where(coded, F_MU, 0)
            else:
                _cleanup(F, T, st, out, act, ori, xin, yin, h.to(i64), H, W,
                         half, flags, RL, UNI)
                if bool((act & segsym).any()):
                    for _ in range(4):
                        st.decode(UNI, act & segsym)
                F &= ~F_VIS
    core = F[:, 1:H + 1, 1:W + 1]
    return torch.where((core & F_NEG) != 0, -out, out).to(torch.int32)


def _cleanup(F, T, st, out, act, ori, xin, yin, hl, H, W, half, flags, RL,
             UNI):
    """One cleanup pass of the plain decoder (run-length mode included)."""
    zero = torch.zeros_like(act)
    zi = torch.zeros_like(hl)
    for y0 in range(0, H, 4):
        for x in range(W):
            rl, has, r = zero, zero, zi
            if y0 + 4 <= H:
                f4 = F[:, y0 + 1:y0 + 5, x + 1]
                any_st = f4[:, 0] | f4[:, 1] | f4[:, 2] | flags(y0 + 3, x)
                rl = act & xin[x] & (hl >= y0 + 4) \
                    & ((any_st & (0xFF | F_SIG | F_VIS)) == 0)
                if bool(rl.any()):
                    has = rl & (st.decode(RL, rl) == 1)
                    if bool(has.any()):
                        r = st.decode(UNI, has) << 1
                        r = r | st.decode(UNI, has)
            for dy in range(min(4, H - y0)):
                y = y0 + dy
                f = flags(y, x)
                normal = act & xin[x] & yin[y] \
                    & ((f & (F_SIG | F_VIS)) == 0) & ~(rl & (~has | (r >= dy)))
                first = has & (r == dy)
                if bool(normal.any()):
                    bit = st.decode(T.zc[ori + (f & 0xFF)], normal)
                    code_sc = (normal & (bit == 1)) | first
                else:
                    code_sc = first
                if not bool(code_sc.any()):
                    continue
                sc = T.sc[f & 0xFFF]
                sbit = st.decode(sc & 15, code_sc) ^ (sc >> 4)
                mark_sig(F, T, y, x, sbit, code_sc)
                out[:, y, x] = torch.where(code_sc, half, out[:, y, x])


def segment_table(npass, nbps, styles, seg_lens, dlens=None) -> tuple:
    """(npass, ptbl) for NL blocks from their pass counts, bitplane
    counts, code-block styles and codeword segment lengths (lists; an
    empty list = one segment over all of the block's bytes, of length
    seg_lens given as a single int).  npass is clamped to the passes the
    segments cover, as the scalar decoder stops where they end; ptbl is
    (NL, P, 3) int32 (see the module docstring).  dlens: each block's
    bytes present, where a stream was cut short: segment starts and ends
    are clamped to it, as the C block decoder clamps them."""
    NL = len(npass)
    rows = []
    out_np = np.zeros(NL, np.int32)
    for j in range(NL):
        n_j, nb_j, style = int(npass[j]), int(nbps[j]), int(styles[j])
        lens = list(seg_lens[j])
        counts = segment_pass_counts(n_j, style)
        if len(lens) < len(counts):
            counts = counts[:len(lens)]
        sched = pass_schedule(nb_j)[:n_j]
        starts = np.concatenate([[0], np.cumsum(lens)]).astype(int)
        if dlens is not None:
            starts = np.minimum(starts, int(dlens[j]))
        seg_of = [si for si, cnt in enumerate(counts) for _ in range(cnt)]
        n_eff = min(n_j, len(seg_of), len(sched))
        tbl = []
        prev = -1
        for pno in range(n_eff):
            si = seg_of[pno]
            opened = si != prev
            prev = si
            tbl.append((int(starts[si]) if opened else -1,
                        int(starts[si + 1]) if opened else 0,
                        int(is_raw_pass(pno, sched[pno][0], style))))
        out_np[j] = n_eff
        rows.append(tbl)
    P = max([1] + [len(t) for t in rows])
    ptbl = np.zeros((NL, P, 3), np.int32)
    ptbl[:, :, 0] = -1
    for j, tbl in enumerate(rows):
        if tbl:
            ptbl[j, :len(tbl)] = tbl
    return out_np, ptbl


def _check(name, t, dtype, device, shape=None):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _checked(body, start, npass, nbps, orient, w, h, style, ptbl, W: int,
             H: int, v1: bool = False) -> torch.device:
    """The wrappers' checks; returns the lanes' device.  Lanes of any
    legal code-block size (sides 1..1024, at most 4096 samples); the
    first design's of up to 64 x 64."""
    dev = body.device
    if not lane_dims_ok(W, H) or (v1 and (W > 64 or H > 64)):
        raise ValueError(f"block dims {W}x{H} outside 1..1024 with at most "
                         f"4096 samples" + (", 64x64 for the first design"
                                            if v1 else ""))
    NL = start.shape[0]
    _check("body", body, torch.uint8, dev)
    if body.dim() != 1 or body.numel() == 0:
        raise ValueError("body must be 1-D and not empty")
    for name, t in (("start", start), ("npass", npass), ("nbps", nbps),
                    ("orient", orient), ("w", w), ("h", h),
                    ("style", style)):
        _check(name, t, torch.int32, dev, (NL,))
    if ptbl.dim() != 3 or ptbl.shape[0] != NL or ptbl.shape[2] != 3 \
            or ptbl.shape[1] < 1:
        raise ValueError(f"ptbl must be (NL, P, 3), got {tuple(ptbl.shape)}")
    _check("ptbl", ptbl, torch.int32, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no Part-1 decode kernel for device {dev}")
    return dev


def _raise_on(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"Part-1 decode kernel launch failed: "
                           f"cudaError {rc}")


def t1_decode_lanes(body, start, npass, nbps, orient, w, h, style, ptbl,
                    W: int, H: int):
    """Decode NL Part-1 code-blocks -> signed mag2 (NL, H, W) int32.

    body: (NB,) uint8, every lane's codeword bytes; start: (NL,) int32,
    each lane's first byte in body; npass, nbps (<= 30), orient, w, h,
    style: (NL,) int32 with 1 <= w <= W, 1 <= h <= H (W, H: sides up to
    1024, at most 4096 samples); ptbl: (NL, P, 3)
    int32, the segment table (module docstring; offsets relative to
    start, the segments inside body).  Lanes with nbps outside
    [0, 30] decode to zeros.  CPU tensors run the plain version; CUDA
    tensors launch the kernel, and anything the kernel does not take
    raises."""
    dev = _checked(body, start, npass, nbps, orient, w, h, style, ptbl, W, H)
    if dev.type == "cpu":
        return t1_decode_lanes_ref(body, start, npass, nbps, orient, w, h,
                                   style, ptbl, W, H)
    from grok_tpu_torch._build import load_library
    lib = load_library().t1_decode
    NL = start.shape[0]
    out = torch.empty((NL, H, W), dtype=torch.int32, device=dev)
    if NL == 0:
        return out
    lut, mqt = lut_on(dev)
    # the persistent grid's queue: longest lanes first, by npass * w * h
    order = torch.argsort(npass.clamp(min=0).long() * w * h,
                          descending=True).to(torch.int32)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    _raise_on(lib.grk_t1_decode(
        body.data_ptr(), body.numel(), start.data_ptr(), npass.data_ptr(),
        nbps.data_ptr(), orient.data_ptr(), w.data_ptr(), h.data_ptr(),
        style.data_ptr(), ptbl.data_ptr(), ptbl.shape[1], lut.data_ptr(),
        mqt.data_ptr(), out.data_ptr(), order.data_ptr(),
        counter.data_ptr(), NL, W, H,
        torch.cuda.current_stream(dev).cuda_stream))
    t1_decode_lanes.launches += 1
    return out


t1_decode_lanes.launches = 0


def t1_decode_lanes_sharded(body, start, npass, nbps, orient, w, h, style,
                            ptbl, W: int, H: int, *, mesh):
    """t1_decode_lanes with the lanes split over a device mesh
    (parallel/sharding.py Mesh): the lanes in mesh.size contiguous shares
    (uneven where NL is not a multiple), each decoded by one
    t1_decode_lanes call on its shard's device (K3 on a card, the plain
    version on a CPU shard; the body copied to each device), the outputs
    back in lane order on the mesh's first device.  The arguments are
    t1_decode_lanes', on any device; a shard's failed launch raises.

    Every shard's inputs are copied before any launch is issued, and
    every launch before any output comes back.  A copy between cards runs
    on the source card's stream (PyTorch's cross-device copy), behind
    the work already issued there: a launch on the first card issued
    before the other cards' inputs would hold their launches back until
    it ends, and a copy back inside the loop would make the first card's
    stream wait for that shard; either runs the cards one after another.

    Traced (util/trace.py): the copies to the shards in a span
    `decode.program.k3.scatter`, shard i's launch in
    `decode.program.k3.card<i>` (arg `lanes`), the outputs' way back in
    `decode.program.k3.gather`; counters `decode.mesh.lanes_max` and
    `.lanes_min` (the fullest and the emptiest share) and
    `decode.mesh.peer_bytes` (the body, lanes and outputs that go
    between the first shard and the others)."""
    from grok_tpu_torch.parallel.sharding import on_device
    lanes = (start, npass, nbps, orient, w, h, style, ptbl)
    q, r = divmod(start.shape[0], mesh.size)   # torch.tensor_split's shares
    count("decode.mesh.lanes_max", q + (r > 0))
    count("decode.mesh.lanes_min", q)
    shards, lo = [], 0
    for i, d in enumerate(mesh.devices):
        hi = lo + q + (i < r)
        if hi > lo:
            shards.append((i, d, lo, hi))
        lo = hi
    with trace("decode.program.k3.scatter"):
        args = [(body.to(d),) + tuple(t[lo:hi].to(d).contiguous()
                                      for t in lanes)
                for _i, d, lo, hi in shards]
    outs = []
    for (i, d, lo, hi), a in zip(shards, args):
        with trace(f"decode.program.k3.card{i}", lanes=hi - lo), \
                on_device(d):
            outs.append(t1_decode_lanes(*a, W, H))
    count("decode.mesh.peer_bytes", sum(
        sum(t.nbytes for t in a) + o.nbytes
        for (i, *_), a, o in zip(shards, args, outs) if i))
    if not outs:
        return torch.empty((0, H, W), dtype=torch.int32, device=mesh.first)
    with trace("decode.program.k3.gather"):
        return torch.cat([o.to(mesh.first, non_blocking=True)
                          for o in outs])


def t1_decode_lanes_v1(body, start, npass, nbps, orient, w, h, style, ptbl,
                       W: int, H: int):
    """t1_decode_lanes through the first kernel design (csrc/
    t1_decode_v1.cu, one thread per lane, its flags in a device-memory
    scratch): the same arguments, checks and result, on lanes of up to
    64 x 64."""
    dev = _checked(body, start, npass, nbps, orient, w, h, style, ptbl, W, H,
                   v1=True)
    if dev.type == "cpu":
        return t1_decode_lanes_ref(body, start, npass, nbps, orient, w, h,
                                   style, ptbl, W, H)
    from grok_tpu_torch._build import load_library
    lib = load_library().t1_decode_v1
    NL = start.shape[0]
    out = torch.empty((NL, H, W), dtype=torch.int32, device=dev)
    if NL == 0:
        return out
    lut, mqt = lut_on(dev)
    flags = torch.empty((NL, (H + 2) * (W + 2)), dtype=torch.int32,
                        device=dev)
    _raise_on(lib.grk_t1_decode_v1(
        body.data_ptr(), body.numel(), start.data_ptr(), npass.data_ptr(),
        nbps.data_ptr(), orient.data_ptr(), w.data_ptr(), h.data_ptr(),
        style.data_ptr(), ptbl.data_ptr(), ptbl.shape[1], lut.data_ptr(),
        mqt.data_ptr(), out.data_ptr(), flags.data_ptr(), NL, W, H,
        torch.cuda.current_stream(dev).cuda_stream))
    t1_decode_lanes_v1.launches += 1
    return out


t1_decode_lanes_v1.launches = 0


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C entry point's signature on the loaded library."""
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.grk_t1_decode
    fn.argtypes = [vp, cl, vp, vp, vp, vp, vp, vp, vp, vp, ci, vp, vp, vp,
                   vp, vp, ci, ci, ci, vp]
    fn.restype = ci


def bind_v1(lib: ctypes.CDLL) -> None:
    """Declare the first design's C entry point on its library."""
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.grk_t1_decode_v1
    fn.argtypes = [vp, cl, vp, vp, vp, vp, vp, vp, vp, vp, ci, vp, vp, vp,
                   vp, ci, ci, ci, vp]
    fn.restype = ci
