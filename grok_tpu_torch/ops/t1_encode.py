"""Batched Part-1 (EBCOT/MQ) code-block encode: kernel K5 of the port.

One lane is one code-block.  Inputs per lane: its quantized samples as
mneg = (magnitude << 1) | sign in an (NL, H, W) int32 tensor, its band
orientation, its magnitude bitplane count numbps, its size (w, h):
exactly the w x h samples at the top left are coded, as grok_tpu/t1/
t1_scalar.py `encode_block` codes them; samples outside are never
visited and count as insignificant neighbours; and its code-block style
(optional, 0 by default): any combination of the six Part-1 mode
switches BYPASS 0x01 (raw SPP and MRP passes from pass 10 on), RESET
0x02 (context states at Table D.7 at every MQ pass), TERMALL 0x04 (a
segment per pass), VSC 0x08 (stripe-causal contexts), PTERM 0x10
(predictable MQ and raw terminations) and SEGSYM 0x20 (1010 on the
UNIFORM context after each cleanup), coded as grok_tpu/native/t1.c
`grk_t1_encode_ref` codes them.  The default style is the contract of
the TPU kernel grok_tpu/ops/pallas_t1_enc.py `pallas_t1_encode`; the
per-lane (w, h) and the styles extend it (the TPU kernel codes
exact-shape, default-style batches only; the JAX package codes styled
blocks on the host with its C coder).

  - `t1_encode_lanes` is the wrapper: a CUDA tensor launches the
    hand-written kernel in csrc/t1_encode.cu (one warp per lane, the
    lane's state in shared memory, a persistent grid that takes the
    lanes longest first; a lane over 64 wide codes each stripe in chunks
    of 64 columns), a CPU tensor runs `t1_encode_lanes_ref`.  There is no
    fallback from one to the other.
  - `t1_encode_lanes_sharded` splits the lanes over a device mesh: one
    t1_encode_lanes call per shard, on the shard's device.
  - `t1_encode_lanes_v1` launches the first design, csrc/t1_encode_v1.cu
    (one thread per lane, default style only), kept as the full-lane
    oracle and the speed yardstick of the kernel on the card
    (chip_smoke.py and the hardware-validation tool); no serving path
    reaches it.
  - `t1_encode_lanes_ref` is the plain PyTorch version: all lanes step in
    lockstep through the scan positions of every pass, each MQ decision
    a handful of tensor ops with masked lanes.
  - `pass_records` turns a lane's rate row into its per-pass rates and
    termination flags and its segments, as the C coder logs them.

Outputs: out (NL, L) uint8, the codeword of a lane (its segments back to
back) in bytes [1, 1 + length) of its row, byte 0 the MQ coder's carry
sentinel (bytes past the codeword are undefined: the kernel does not
write them); lengths (NL,) int32, the total length, each MQ segment
max(bp - 1, 0) after its flush and the trim of a trailing 0xFF, or -1
when the lane needed more than L bytes (its bytes are then incomplete);
rates (NL, R) int32, a row per pass, the cleanup of the MSB plane in row
0 and the SPP, MRP and CLN of plane k in rows 3k-2, 3k-1 and 3k (rows a
lane does not reach stay 0): the bytes of the closed segments plus, for
an open MQ segment, its watermark bp + 5 (bytes so far plus 5), for an
open raw one its bytes with a partial byte counted, and at a terminated
pass other than the last the exact bytes so far; sigtype (NL, H, W)
int8, the pass in which each sample became significant (records.SIG_*).
"""

from __future__ import annotations

import ctypes

import torch

from grok_tpu_torch.ops.t1_decode import (F_MU, F_SIG, F_VIS, VSC_MASK,
                                          _check, lut_on, mark_sig,
                                          stripe_order, tables_on)
from grok_tpu_torch.ops.ht_encode import lane_dims_ok
from grok_tpu_torch.t1 import mq
from grok_tpu_torch.core.params import (CBLK_BYPASS, CBLK_PTERM, CBLK_RESET,
                                        CBLK_SEGSYM, CBLK_TERMALL, CBLK_VSC)
from grok_tpu_torch.t1.records import (SIG_CLN, SIG_SPP,
                                       segment_pass_counts)


class _MQEnc:
    """Lockstep MQ encoders (C.2), one per lane.  B is the byte at bp
    (the one a carry can still change), kept out of `out` until bp moves
    on; a lane's segment starts at byte `base` of its row (the bytes of
    the segments before it), so byte bp of the segment lies at base + bp
    and a later segment's carry sentinel (bp 0, the previous segment's
    last byte) is never stored; writes at or past the capacity are
    dropped and flag the lane."""

    def __init__(self, T, NL: int, L: int, dev):
        i64 = torch.int64
        self.T = T
        self.L = L
        z = torch.zeros(NL, dtype=i64, device=dev)
        self.a, self.c, self.ct, self.bp, self.B = z + 0x8000, z, z + 12, z, z
        self.base = z
        self.ovf = torch.zeros(NL, dtype=torch.bool, device=dev)
        self.out = torch.zeros((NL, L), dtype=torch.uint8, device=dev)
        self.lane = torch.arange(NL, device=dev)
        self.ctx = T.ctx0.repeat(NL, 1)

    def store(self, pos, v, m):
        """out[lane, pos] = v where m, past the capacity flagging the
        lane."""
        ok = m & (pos < self.L)
        self.ovf |= m & ~ok
        idx = pos.clamp(max=self.L - 1)
        cur = self.out[self.lane, idx]
        self.out[self.lane, idx] = torch.where(ok, v.to(torch.uint8), cur)

    def put(self, m):
        """Store B at bp where m."""
        self.store(self.base + self.bp, self.B,
                   m & ((self.bp > 0) | (self.base == 0)))

    def byteout(self, m):
        """C.2.6 BYTEOUT where m."""
        c = self.c
        is_ff = self.B == 0xFF
        carry = ~is_ff & (c >= 0x8000000)
        self.B = torch.where(m & carry, self.B + 1, self.B)
        to_ff = carry & (self.B == 0xFF)
        c = torch.where(to_ff, c & 0x7FFFFFF, c)
        emit7 = is_ff | to_ff
        self.put(m)
        self.bp = self.bp + m
        self.B = torch.where(m, torch.where(emit7, c >> 20, (c >> 19) & 0xFF),
                             self.B)
        self.c = torch.where(m, torch.where(emit7, c & 0xFFFFF, c & 0x7FFFF),
                             self.c)
        self.ct = torch.where(m, torch.where(emit7, 7, 8), self.ct)

    def encode(self, d, cx, act):
        """C.2.5 ENCODE of decision d in context cx where act."""
        if not bool(act.any()):
            return
        T = self.T
        cell = self.ctx.gather(1, cx[:, None])[:, 0]
        qe = T.qe[cell]
        a1 = self.a - qe
        is_mps = d == (cell & 1)
        msb = a1 >= 0x8000
        small = a1 < qe
        keep_a1 = torch.where(is_mps, msb | ~small, small)
        add_c = torch.where(is_mps, keep_a1, small)
        rn = act & (~is_mps | ~msb)
        new = torch.where(is_mps, T.nm[cell], T.nl[cell])
        self.ctx.scatter_(1, cx[:, None], torch.where(rn, new, cell)[:, None])
        self.c = torch.where(act & add_c, self.c + qe, self.c)
        self.a = torch.where(act, torch.where(keep_a1, a1, qe), self.a)
        # RENORME: n shifts; a BYTEOUT each time CT reaches 0
        n = torch.where(rn, T.nsh[self.a], 0)
        for _ in range(3):
            m = n > 0
            if not bool(m.any()):
                break
            s = torch.minimum(n, self.ct)
            self.a = (self.a << s) & 0xFFFF
            self.c = (self.c << s) & 0xFFFFFFF
            self.ct = self.ct - s
            n = n - s
            fire = m & (self.ct == 0)
            if bool(fire.any()):
                self.byteout(fire)

    def flush(self, m, pterm, put_all: bool = False):
        """Terminate the segment where m: C.2.9 FLUSH, or under PTERM the
        predictable ERTERM flush (D.4.2: the register pushed out, at
        least 12 more bits, without SETBITS); the last byte stored (with
        put_all, B of every lane: a lane that coded nothing stores its
        sentinel).  Returns the segment lengths (a trailing 0xFF
        trimmed)."""
        mn = m & ~pterm
        tempc = self.c + self.a
        c1 = self.c | 0xFFFF
        c1 = torch.where(c1 >= tempc, c1 - 0x8000, c1)
        self.c = torch.where(mn, (c1 << self.ct) & 0xFFFFFFF, self.c)
        self.byteout(mn)
        self.c = torch.where(mn, (self.c << self.ct) & 0xFFFFFFF, self.c)
        self.byteout(mn)
        k = torch.where(m & pterm, 12 - self.ct, 0)
        for _ in range(3):
            mk = k > 0
            if not bool(mk.any()):
                break
            self.c = torch.where(mk, (self.c << self.ct) & 0xFFFFFFF,
                                 self.c)
            self.ct = torch.where(mk, 0, self.ct)
            self.byteout(mk)
            k = torch.where(mk, k - self.ct, k)
        self.put(torch.ones_like(m) if put_all else m)
        bp = torch.where(m & (self.B != 0xFF), self.bp + 1, self.bp)
        return (bp - 1).clamp(min=0)

    def restart(self, m):
        """A new segment where m: the coder's registers at INITENC, the
        context states kept."""
        for name, v in (("a", 0x8000), ("c", 0), ("ct", 12), ("bp", 0),
                        ("B", 0)):
            setattr(self, name, torch.where(m, v, getattr(self, name)))


class _RawEnc:
    """Lockstep raw (BYPASS) bit writers, one per lane, writing a raw
    segment's bytes at 1 + base + n of the lanes' rows (D.6): eight bits
    a byte, seven after a 0xFF."""

    def __init__(self, enc: _MQEnc):
        self.enc = enc
        z = torch.zeros_like(enc.a)
        self.n, self.cur, self.nb = z, z, z
        self.ff = torch.zeros_like(enc.ovf)

    def emit(self, v, m):
        self.enc.store(1 + self.enc.base + self.n, v, m)
        self.ff = torch.where(m, v == 0xFF, self.ff)
        self.n = self.n + m

    def bit(self, b, m):
        """Append bit b where m."""
        if not bool(m.any()):
            return
        limit = torch.where(self.ff, 7, 8)
        self.cur = torch.where(m, (self.cur << 1) | (b & 1), self.cur)
        self.nb = self.nb + m
        full = m & (self.nb == limit)
        self.emit(self.cur, full)
        self.cur = torch.where(full, 0, self.cur)
        self.nb = torch.where(full, 0, self.nb)

    def flush(self, m, pterm):
        """Terminate the raw segment where m: the last byte padded (with
        0, 1, 0, ... under PTERM, else zeros), a 0 after a final 0xFF.
        Returns the segment lengths and leaves the writers empty."""
        b = torch.zeros_like(self.n)
        for _ in range(8):
            mp = m & pterm & (self.nb > 0)
            if not bool(mp.any()):
                break
            self.bit(b, mp)
            b = b ^ 1
        mz = m & ~pterm & (self.nb > 0)
        limit = torch.where(self.ff, 7, 8)
        self.emit(self.cur << (limit - self.nb).clamp(min=0), mz)
        self.emit(torch.zeros_like(self.n), m & self.ff)
        n = self.n
        self.n = torch.where(m, 0, self.n)
        self.cur = torch.where(m, 0, self.cur)
        self.nb = torch.where(m, 0, self.nb)
        self.ff = self.ff & ~m
        return n

    def pending(self):
        """The bytes a raw segment holds so far, a partial byte
        included."""
        return self.n + (self.nb > 0).to(torch.int64)


def t1_encode_lanes_ref(mneg, orient, numbps, w, h, L: int, R: int,
                        style=None):
    """Plain PyTorch encode of NL lanes -> (out, lengths, rates, sigtype);
    see the module docstring for the layout."""
    dev = mneg.device
    i64 = torch.int64
    T = tables_on(dev)
    NL, H, W = mneg.shape
    m64 = mneg.to(i64)
    mag, neg = m64 >> 1, m64 & 1
    nbps = numbps.to(i64)
    ori = orient.to(i64) << 8
    sty = torch.zeros(NL, dtype=i64, device=dev) if style is None \
        else style.to(i64)
    bypass = (sty & CBLK_BYPASS) != 0
    reset = (sty & CBLK_RESET) != 0
    termall = (sty & CBLK_TERMALL) != 0
    vsc = (sty & CBLK_VSC) != 0
    pterm = (sty & CBLK_PTERM) != 0
    segsym = (sty & CBLK_SEGSYM) != 0
    any_vsc = bool(vsc.any())
    xin = [w.to(i64) > x for x in range(W)]
    yin = [h.to(i64) > y for y in range(H)]
    F = torch.zeros((NL, H + 2, W + 2), dtype=i64, device=dev)
    sigtype = torch.zeros((NL, H, W), dtype=torch.int8, device=dev)
    rates = torch.zeros((NL, R), dtype=torch.int32, device=dev)
    enc = _MQEnc(T, NL, L, dev)
    raw_w = _RawEnc(enc)
    RL = torch.full((NL,), mq.CTX_RL, dtype=i64, device=dev)
    UNI = torch.full((NL,), mq.CTX_UNI, dtype=i64, device=dev)
    lane = torch.arange(NL, device=dev)

    def flags(y, x):
        """The flag word of (y, x), the row below masked at stripe row 3
        under VSC."""
        f = F[:, y + 1, x + 1]
        if y % 4 == 3 and any_vsc:
            f = torch.where(vsc, f & VSC_MASK, f)
        return f

    def record(pno, act, v):
        ok = act & (pno >= 0) & (pno < R)
        idx = pno.clamp(0, R - 1)
        rates[lane, idx] = torch.where(ok, v.to(torch.int32),
                                       rates[lane, idx])

    def open_pass(pno, ptype, act):
        """The pass's raw flag where act, and RESET's context states."""
        raw = act & bypass & (pno >= 10) & (ptype != 2)
        rs = act & reset & ~raw
        if bool(rs.any()):
            enc.ctx = torch.where(rs[:, None], T.ctx0[None], enc.ctx)
        return raw

    def close_pass(pno, ptype, act, raw, last: bool):
        """End of pass pno where act: its rate row, and the termination
        of its segment (every pass under TERMALL, BYPASS's MQ run at pass
        9, each raw run and each later cleanup); the lanes' last pass is
        flushed after the loop."""
        pend = torch.where(raw, enc.base + raw_w.pending(),
                           enc.base + enc.bp + 5)
        term = act & (termall | (bypass & (pno >= 9) & (
            (ptype == 2) | ((ptype == 1) & (pno >= 10)))))
        if last:
            term = torch.zeros_like(term)
        record(pno, act & ~term, pend)
        if not bool(term.any()):
            return
        rt, mt = term & raw, term & ~raw
        if bool(rt.any()):
            enc.base = enc.base + torch.where(rt, raw_w.flush(rt, pterm), 0)
        if bool(mt.any()):
            enc.base = enc.base + torch.where(mt, enc.flush(mt, pterm), 0)
        enc.restart(term)
        record(pno, term, enc.base)

    def code_bit(b, cx, m, raw):
        """One decision where m: MQ-coded in context cx, or raw."""
        enc.encode(b, cx, m & ~raw)
        raw_w.bit(b, m & raw)

    def code_sign(y, x, m, f, stype, raw):
        sc = T.sc[f & 0xFFF]
        enc.encode(neg[:, y, x] ^ (sc >> 4), sc & 15, m & ~raw)
        raw_w.bit(neg[:, y, x], m & raw)
        mark_sig(F, T, y, x, neg[:, y, x], m)
        sigtype[:, y, x] = torch.where(m, stype, sigtype[:, y, x])

    inb = (torch.arange(H, device=dev)[None, :, None] < h.to(i64)[:, None,
                                                                   None]) \
        & (torch.arange(W, device=dev)[None, None, :] < w.to(i64)[:, None,
                                                                  None])
    order = stripe_order(H, W)

    def visits(mask):
        """The scan positions where some lane's sample is in `mask` at
        the start of a pass, in stripe order: those a pass may code (a
        sample significant at the start of the SPP stays so; the MRP and
        the cleanup code only samples unvisited and significant, or
        neither, at their start)."""
        anym = mask.any(0).cpu().numpy()
        return [(y, x) for y, x in order if anym[y, x]]

    maxbp = int(nbps.max()) if NL else 0
    for bpl in range(maxbp - 1, -1, -1):
        k = nbps - 1 - bpl
        bit = (mag >> bpl) & 1
        act = k >= 1
        if bool(act.any()):
            pno = 3 * k - 2                                       # SPP
            raw = open_pass(pno, 0, act)
            Fi = F[:, 1:H + 1, 1:W + 1]
            for y, x in visits(inb & act[:, None, None]
                               & ((Fi & F_SIG) == 0)):
                f = flags(y, x)
                coded = act & xin[x] & yin[y] \
                    & ((f & (F_SIG | F_VIS)) == 0) & ((f & 0xFF) != 0)
                if not bool(coded.any()):
                    continue
                code_bit(bit[:, y, x], T.zc[ori + (f & 0xFF)], coded, raw)
                became = coded & (bit[:, y, x] == 1)
                if bool(became.any()):
                    code_sign(y, x, became, f, SIG_SPP, raw)
                F[:, y + 1, x + 1] |= torch.where(coded, F_VIS, 0)
            close_pass(pno, 0, act, raw, False)
            pno = 3 * k - 1                                       # MRP
            raw = open_pass(pno, 1, act)
            Fi = F[:, 1:H + 1, 1:W + 1]
            for y, x in visits(inb & act[:, None, None]
                               & ((Fi & F_SIG) != 0) & ((Fi & F_VIS) == 0)):
                f = flags(y, x)
                coded = act & xin[x] & yin[y] & ((f & F_SIG) != 0) \
                    & ((f & F_VIS) == 0)
                if not bool(coded.any()):
                    continue
                mr = torch.where((f & F_MU) != 0, 16,
                                 torch.where((f & 0xFF) != 0, 15, 14))
                code_bit(bit[:, y, x], mr, coded, raw)
                F[:, y + 1, x + 1] |= torch.where(coded, F_MU, 0)
            close_pass(pno, 1, act, raw, False)
        act = k >= 0                                              # CLN
        pno = 3 * k
        raw = open_pass(pno, 2, act)
        Fi = F[:, 1:H + 1, 1:W + 1]
        cols = {(y - y % 4, x) for y, x in visits(
            inb & act[:, None, None] & ((Fi & (F_SIG | F_VIS)) == 0))}
        for y0 in range(0, H, 4):
            for x in range(W):
                if (y0, x) not in cols:
                    continue
                rl = torch.zeros_like(act)
                has, r = rl, torch.zeros_like(nbps)
                if y0 + 4 <= H:
                    f4 = [flags(y0 + d, x) for d in range(4)]
                    rl = act & xin[x] & yin[y0 + 3] & (
                        ((f4[0] | f4[1] | f4[2] | f4[3])
                         & (0xFF | F_SIG | F_VIS)) == 0)
                    if bool(rl.any()):
                        b4 = bit[:, y0:y0 + 4, x]
                        has = rl & (b4.sum(1) > 0)
                        enc.encode(has.to(i64), RL, rl)
                        r = torch.argmax(b4, 1)
                        if bool(has.any()):
                            enc.encode(r >> 1, UNI, has)
                            enc.encode(r & 1, UNI, has)
                for dy in range(min(4, H - y0)):
                    y = y0 + dy
                    f = flags(y, x)
                    normal = act & xin[x] & yin[y] \
                        & ((f & (F_SIG | F_VIS)) == 0) \
                        & ~(rl & (~has | (r >= dy)))
                    code_sc = has & (r == dy)
                    if bool(normal.any()):
                        enc.encode(bit[:, y, x], T.zc[ori + (f & 0xFF)],
                                   normal)
                        code_sc = code_sc | (normal & (bit[:, y, x] == 1))
                    if bool(code_sc.any()):
                        code_sign(y, x, code_sc, f, SIG_CLN, raw)
        ss = act & segsym
        if bool(ss.any()):
            for d in (1, 0, 1, 0):
                enc.encode(torch.full_like(nbps, d), UNI, ss)
        close_pass(pno, 2, act, raw, bpl == 0)
        F &= ~F_VIS
    seg = enc.flush(nbps > 0, pterm, put_all=True)
    lengths = torch.where(enc.ovf, -1, enc.base + seg)
    return enc.out, lengths.to(torch.int32), rates, sigtype


def pass_records(row, numbps: int, total: int, style: int = 0) -> tuple:
    """A lane's pass records from its rate row, as grok_tpu/native/t1.c
    `grk_t1_encode_ref` logs them: (rates, terms, seg_lens, seg_passes).
    The segments follow the style (records.segment_pass_counts); each
    pass's rate is clamped to its segment's end (the exact rate of its
    terminated last pass, the total for the last segment), then made
    monotonic, the last pass exact.  For the default style this is
    grok_tpu/ops/pallas_t1_enc.py `rates_from_watermarks`."""
    n = 3 * numbps - 2
    rates = [int(v) for v in row[:n]]
    seg_passes = segment_pass_counts(n, style)
    terms = [False] * n
    seg_lens = []
    t = prev = 0
    for i, sp in enumerate(seg_passes):
        t += sp
        end = total if i == len(seg_passes) - 1 else rates[t - 1]
        for q in range(t - sp, t):
            rates[q] = min(rates[q], end)
        terms[t - 1] = True
        seg_lens.append(end - prev)
        prev = end
    for q in range(1, n):
        rates[q] = max(rates[q], rates[q - 1])
    rates[-1] = total
    return rates, terms, seg_lens, seg_passes


def _checked(mneg, orient, numbps, w, h, L: int, R: int,
             style=None) -> torch.device:
    """The wrappers' checks; returns the lanes' device."""
    dev = mneg.device
    if mneg.dim() != 3:
        raise ValueError(f"mneg must be (NL, H, W), got {tuple(mneg.shape)}")
    NL, H, W = mneg.shape
    if not lane_dims_ok(W, H):
        raise ValueError(f"block dims {W}x{H} outside 1..1024 with at most "
                         f"4096 samples")
    _check("mneg", mneg, torch.int32, dev)
    for name, t in (("orient", orient), ("numbps", numbps), ("w", w),
                    ("h", h), ("style", style)):
        if t is not None:
            _check(name, t, torch.int32, dev, (NL,))
    if L < 4 or L % 4:
        raise ValueError(f"L = {L} is not a positive multiple of 4")
    if R < 1:
        raise ValueError(f"R = {R} watermark rows")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no Part-1 encode kernel for device {dev}")
    return dev


def _outputs(mneg, L: int, R: int) -> tuple:
    NL, H, W = mneg.shape
    dev = mneg.device
    return (torch.empty((NL, L), dtype=torch.uint8, device=dev),
            torch.empty(NL, dtype=torch.int32, device=dev),
            torch.empty((NL, R), dtype=torch.int32, device=dev),
            torch.empty((NL, H, W), dtype=torch.int8, device=dev))


def _raise_on(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"Part-1 encode kernel launch failed: "
                           f"cudaError {rc}")


def t1_encode_lanes(mneg, orient, numbps, w, h, L: int, R: int,
                    style=None):
    """Encode NL Part-1 code-blocks -> (out (NL, L) uint8, lengths (NL,)
    int32, rates (NL, R) int32, sigtype (NL, H, W) int8); see the module
    docstring for the layout.

    mneg: (NL, H, W) int32 with 1 <= W, H <= 1024, W * H <= 4096 (a
    stripe over 64 wide is walked in 64-column chunks); orient, numbps (<= 30),
    w, h: (NL,) int32, every lane with 1 <= w <= W and 1 <= h <= H (a
    lane with numbps 0 codes nothing).  L: per-lane byte capacity, a
    multiple of 4 and at least 4; R: watermark rows (3 * planes - 2
    covers a lane of that many planes); style: None (every lane in the
    default style) or (NL,) int32 mode-switch bits (0x3F at most).  CPU
    tensors run the plain version; CUDA tensors launch the kernel, and
    anything the kernel does not take raises."""
    dev = _checked(mneg, orient, numbps, w, h, L, R, style)
    if dev.type == "cpu":
        return t1_encode_lanes_ref(mneg, orient, numbps, w, h, L, R, style)
    from grok_tpu_torch._build import load_library
    lib = load_library().t1_encode
    out, lengths, rates, sigtype = res = _outputs(mneg, L, R)
    NL, H, W = mneg.shape
    if NL == 0:
        return res
    lut, mqt = lut_on(dev)
    # the persistent grid's queue: longest lanes first, by nbps * w * h
    order = torch.argsort(numbps.clamp(min=0).long() * w * h,
                          descending=True).to(torch.int32)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    _raise_on(lib.grk_t1_encode(
        mneg.data_ptr(), orient.data_ptr(), numbps.data_ptr(), w.data_ptr(),
        h.data_ptr(), None if style is None else style.data_ptr(),
        lut.data_ptr(), mqt.data_ptr(), out.data_ptr(), L,
        lengths.data_ptr(), rates.data_ptr(), R, sigtype.data_ptr(),
        order.data_ptr(), counter.data_ptr(), NL, W, H,
        torch.cuda.current_stream(dev).cuda_stream))
    t1_encode_lanes.launches += 1
    return res


t1_encode_lanes.launches = 0


def t1_encode_lanes_sharded(mneg, orient, numbps, w, h, L: int, R: int,
                            style=None, *, mesh):
    """t1_encode_lanes with the lanes split over a device mesh
    (parallel/sharding.py Mesh): the lanes in mesh.size contiguous shares
    (uneven where NL is not a multiple), each coded by one
    t1_encode_lanes call on its shard's device (K5 on a card, the plain
    version on a CPU shard), the four outputs back in lane order on the
    mesh's first device.  A shard's failed launch raises.  Every shard's
    launch is issued before any output comes back (as
    t1_decode_lanes_sharded does), so that the cards code at once."""
    from grok_tpu_torch.parallel.sharding import on_device
    lanes = (mneg, orient, numbps, w, h)
    outs = []
    for d, idx in zip(mesh.devices, torch.tensor_split(
            torch.arange(mneg.shape[0]), mesh.size)):
        if not idx.numel():
            continue
        lo, hi = int(idx[0]), int(idx[-1]) + 1
        with on_device(d):
            outs.append(t1_encode_lanes(
                *(t[lo:hi].to(d).contiguous() for t in lanes), L, R,
                None if style is None else style[lo:hi].to(d).contiguous()))
    if not outs:
        return _outputs(mneg[:0].to(mesh.first), L, R)
    return tuple(torch.cat([t.to(mesh.first, non_blocking=True) for t in ts])
                 for ts in zip(*outs))


def t1_encode_lanes_v1(mneg, orient, numbps, w, h, L: int, R: int):
    """t1_encode_lanes through the first kernel design (csrc/
    t1_encode_v1.cu, one thread per lane, its flags in a device-memory
    scratch): the same arguments, checks and result."""
    dev = _checked(mneg, orient, numbps, w, h, L, R)
    if mneg.shape[1] > 64 or mneg.shape[2] > 64:
        raise ValueError("the first design takes lanes of up to 64x64")
    if dev.type == "cpu":
        return t1_encode_lanes_ref(mneg, orient, numbps, w, h, L, R)
    from grok_tpu_torch._build import load_library
    lib = load_library().t1_encode_v1
    out, lengths, rates, sigtype = res = _outputs(mneg, L, R)
    NL, H, W = mneg.shape
    if NL == 0:
        return res
    lut, mqt = lut_on(dev)
    flags = torch.empty((NL, (H + 2) * (W + 2)), dtype=torch.int32,
                        device=dev)
    _raise_on(lib.grk_t1_encode_v1(
        mneg.data_ptr(), orient.data_ptr(), numbps.data_ptr(), w.data_ptr(),
        h.data_ptr(), lut.data_ptr(), mqt.data_ptr(), out.data_ptr(), L,
        lengths.data_ptr(), rates.data_ptr(), R, sigtype.data_ptr(),
        flags.data_ptr(), NL, W, H,
        torch.cuda.current_stream(dev).cuda_stream))
    t1_encode_lanes_v1.launches += 1
    return res


t1_encode_lanes_v1.launches = 0


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C entry point's signature on the loaded library."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.grk_t1_encode
    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, vp, vp, ci, vp,
                   vp, vp, ci, ci, ci, vp]
    fn.restype = ci


def bind_v1(lib: ctypes.CDLL) -> None:
    """Declare the first design's C entry point on its library."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.grk_t1_encode_v1
    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, vp, vp, ci, vp, vp,
                   ci, ci, ci, vp]
    fn.restype = ci
