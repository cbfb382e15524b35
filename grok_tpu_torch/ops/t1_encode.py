"""Batched Part-1 (EBCOT/MQ) code-block encode: kernel K5 of the port.

One lane is one code-block, coded in the default code-block style (no
mode switches, one codeword segment).  Inputs per lane: its quantized
samples as mneg = (magnitude << 1) | sign in an (NL, H, W) int32 tensor,
its band orientation, its magnitude bitplane count numbps and its size
(w, h): exactly the w x h samples at the top left are coded, as
grok_tpu/t1/t1_scalar.py `encode_block` codes them; samples outside are
never visited and count as insignificant neighbours.  This is the
contract of the TPU kernel grok_tpu/ops/pallas_t1_enc.py
`pallas_t1_encode`, extended by the per-lane (w, h) (the TPU kernel
codes exact-shape batches only).

  - `t1_encode_lanes` is the wrapper: a CUDA tensor launches the
    hand-written kernel in csrc/t1_encode.cu (one warp per lane, the
    lane's state in shared memory, a persistent grid that takes the
    lanes longest first; a lane over 64 wide codes each stripe in chunks
    of 64 columns), a CPU tensor runs `t1_encode_lanes_ref`.  There is no
    fallback from one to the other.
  - `t1_encode_lanes_v1` launches the first design, csrc/t1_encode_v1.cu
    (one thread per lane), kept as the full-lane oracle and the speed
    yardstick of the kernel on the card (chip_smoke.py and the
    hardware-validation tool); no serving path reaches it.
  - `t1_encode_lanes_ref` is the plain PyTorch version: all lanes step in
    lockstep through the scan positions of every pass, each MQ decision
    a handful of tensor ops with masked lanes.
  - `rates_from_watermarks` turns a lane's watermark row into per-pass
    cumulative rates (grok_tpu/ops/pallas_t1_enc.py).

Outputs: out (NL, L) uint8, the codeword of a lane in bytes
[1, 1 + length) of its row, byte 0 the MQ coder's carry sentinel (bytes
past the codeword are undefined: the kernel does not write them);
lengths (NL,) int32, max(bp - 1, 0) after the C.2.9 flush and the trim
of a trailing 0xFF, or -1 when the lane needed more than L bytes (its
bytes are then incomplete); rates (NL, R) int32, the watermark bp + 5
(bytes so far plus 5) at the end of each pass, the cleanup of the MSB
plane in row 0 and the SPP, MRP and CLN of plane k in rows 3k-2, 3k-1
and 3k (rows a lane does not reach stay 0); sigtype (NL, H, W) int8, the
pass in which each sample became significant (records.SIG_*).
"""

from __future__ import annotations

import ctypes

import torch

from grok_tpu_torch.ops.t1_decode import (F_MU, F_SIG, F_VIS, _check,
                                          lut_on, mark_sig, stripe_order,
                                          tables_on)
from grok_tpu_torch.ops.ht_encode import lane_dims_ok
from grok_tpu_torch.t1 import mq
from grok_tpu_torch.t1.records import SIG_CLN, SIG_SPP, pass_schedule


class _MQEnc:
    """Lockstep MQ encoders (C.2), one per lane.  B is the byte at bp
    (the one a carry can still change), kept out of `out` until bp moves
    on; writes at or past the capacity are dropped and flag the lane."""

    def __init__(self, T, NL: int, L: int, dev):
        i64 = torch.int64
        self.T = T
        self.L = L
        z = torch.zeros(NL, dtype=i64, device=dev)
        self.a, self.c, self.ct, self.bp, self.B = z + 0x8000, z, z + 12, z, z
        self.ovf = torch.zeros(NL, dtype=torch.bool, device=dev)
        self.out = torch.zeros((NL, L), dtype=torch.uint8, device=dev)
        self.lane = torch.arange(NL, device=dev)
        self.ctx = T.ctx0.repeat(NL, 1)

    def put(self, m):
        """Store B at bp where m."""
        ok = m & (self.bp < self.L)
        self.ovf |= m & ~ok
        idx = self.bp.clamp(max=self.L - 1)
        cur = self.out[self.lane, idx]
        self.out[self.lane, idx] = torch.where(ok, self.B.to(torch.uint8),
                                               cur)

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

    def flush(self, m):
        """C.2.9 FLUSH where m; returns the lengths (-1 on overflow)."""
        tempc = self.c + self.a
        c1 = self.c | 0xFFFF
        c1 = torch.where(c1 >= tempc, c1 - 0x8000, c1)
        self.c = torch.where(m, (c1 << self.ct) & 0xFFFFFFF, self.c)
        self.byteout(m)
        self.c = torch.where(m, (self.c << self.ct) & 0xFFFFFFF, self.c)
        self.byteout(m)
        self.put(torch.ones_like(m))        # the last byte (sentinel if none)
        bp = torch.where(m & (self.B != 0xFF), self.bp + 1, self.bp)
        return torch.where(self.ovf, -1, (bp - 1).clamp(min=0))


def t1_encode_lanes_ref(mneg, orient, numbps, w, h, L: int, R: int):
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
    xin = [w.to(i64) > x for x in range(W)]
    yin = [h.to(i64) > y for y in range(H)]
    F = torch.zeros((NL, H + 2, W + 2), dtype=i64, device=dev)
    sigtype = torch.zeros((NL, H, W), dtype=torch.int8, device=dev)
    rates = torch.zeros((NL, R), dtype=torch.int32, device=dev)
    enc = _MQEnc(T, NL, L, dev)
    RL = torch.full((NL,), mq.CTX_RL, dtype=i64, device=dev)
    UNI = torch.full((NL,), mq.CTX_UNI, dtype=i64, device=dev)
    lane = torch.arange(NL, device=dev)

    def record(pno, act):
        ok = act & (pno >= 0) & (pno < R)
        idx = pno.clamp(0, R - 1)
        rates[lane, idx] = torch.where(ok, (enc.bp + 5).to(torch.int32),
                                       rates[lane, idx])

    def code_sign(y, x, m, f, stype):
        sc = T.sc[f & 0xFFF]
        enc.encode(neg[:, y, x] ^ (sc >> 4), sc & 15, m)
        mark_sig(F, T, y, x, neg[:, y, x], m)
        sigtype[:, y, x] = torch.where(m, stype, sigtype[:, y, x])

    maxbp = int(nbps.max()) if NL else 0
    for bpl in range(maxbp - 1, -1, -1):
        k = nbps - 1 - bpl
        bit = (mag >> bpl) & 1
        act = k >= 1
        if bool(act.any()):
            for y, x in stripe_order(H, W):                       # SPP
                f = F[:, y + 1, x + 1]
                coded = act & xin[x] & yin[y] \
                    & ((f & (F_SIG | F_VIS)) == 0) & ((f & 0xFF) != 0)
                if not bool(coded.any()):
                    continue
                enc.encode(bit[:, y, x], T.zc[ori + (f & 0xFF)], coded)
                became = coded & (bit[:, y, x] == 1)
                if bool(became.any()):
                    code_sign(y, x, became, f, SIG_SPP)
                F[:, y + 1, x + 1] |= torch.where(coded, F_VIS, 0)
            record(3 * k - 2, act)
            for y, x in stripe_order(H, W):                       # MRP
                f = F[:, y + 1, x + 1]
                coded = act & xin[x] & yin[y] & ((f & F_SIG) != 0) \
                    & ((f & F_VIS) == 0)
                if not bool(coded.any()):
                    continue
                mr = torch.where((f & F_MU) != 0, 16,
                                 torch.where((f & 0xFF) != 0, 15, 14))
                enc.encode(bit[:, y, x], mr, coded)
                F[:, y + 1, x + 1] |= torch.where(coded, F_MU, 0)
            record(3 * k - 1, act)
        act = k >= 0                                              # CLN
        for y0 in range(0, H, 4):
            for x in range(W):
                rl = torch.zeros_like(act)
                has, r = rl, torch.zeros_like(nbps)
                if y0 + 4 <= H:
                    f4 = F[:, y0 + 1:y0 + 5, x + 1]
                    rl = act & xin[x] & yin[y0 + 3] & (
                        ((f4[:, 0] | f4[:, 1] | f4[:, 2] | f4[:, 3])
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
                    f = F[:, y + 1, x + 1]
                    normal = act & xin[x] & yin[y] \
                        & ((f & (F_SIG | F_VIS)) == 0) \
                        & ~(rl & (~has | (r >= dy)))
                    code_sc = has & (r == dy)
                    if bool(normal.any()):
                        enc.encode(bit[:, y, x], T.zc[ori + (f & 0xFF)],
                                   normal)
                        code_sc = code_sc | (normal & (bit[:, y, x] == 1))
                    if bool(code_sc.any()):
                        code_sign(y, x, code_sc, f, SIG_CLN)
        record(3 * k, act)
        F &= ~F_VIS
    lengths = enc.flush(nbps > 0)
    return enc.out, lengths.to(torch.int32), rates, sigtype


def rates_from_watermarks(row, numbps: int, total: int) -> list[int]:
    """Per-pass cumulative byte rates of a lane from its watermark row:
    clamped to the terminated total, made monotonic, the last pass exact
    (grok_tpu/ops/pallas_t1_enc.py `rates_from_watermarks`)."""
    out = []
    for ptype, bp in pass_schedule(numbps):
        k = numbps - 1 - bp
        out.append(min(int(row[3 * k + (ptype - 2 if ptype != 2 else 0)]),
                       total))
    for t in range(1, len(out)):
        out[t] = max(out[t], out[t - 1])
    out[-1] = total
    return out


def _checked(mneg, orient, numbps, w, h, L: int, R: int) -> torch.device:
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
                    ("h", h)):
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


def t1_encode_lanes(mneg, orient, numbps, w, h, L: int, R: int):
    """Encode NL Part-1 code-blocks -> (out (NL, L) uint8, lengths (NL,)
    int32, rates (NL, R) int32, sigtype (NL, H, W) int8); see the module
    docstring for the layout.

    mneg: (NL, H, W) int32 with 1 <= W, H <= 1024, W * H <= 4096 (a
    stripe over 64 wide is walked in 64-column chunks); orient, numbps (<= 30),
    w, h: (NL,) int32, every lane with 1 <= w <= W and 1 <= h <= H (a
    lane with numbps 0 codes nothing).  L: per-lane byte capacity, a
    multiple of 4 and at least 4; R: watermark rows (3 * planes - 2
    covers a lane of that many planes).  CPU tensors run the plain
    version; CUDA tensors launch the kernel, and anything the kernel
    does not take raises."""
    dev = _checked(mneg, orient, numbps, w, h, L, R)
    if dev.type == "cpu":
        return t1_encode_lanes_ref(mneg, orient, numbps, w, h, L, R)
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
        h.data_ptr(), lut.data_ptr(), mqt.data_ptr(), out.data_ptr(), L,
        lengths.data_ptr(), rates.data_ptr(), R, sigtype.data_ptr(),
        order.data_ptr(), counter.data_ptr(), NL, W, H,
        torch.cuda.current_stream(dev).cuda_stream))
    t1_encode_lanes.launches += 1
    return res


t1_encode_lanes.launches = 0


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
    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, vp, vp, ci, vp, vp,
                   vp, ci, ci, ci, vp]
    fn.restype = ci


def bind_v1(lib: ctypes.CDLL) -> None:
    """Declare the first design's C entry point on its library."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.grk_t1_encode_v1
    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, vp, vp, ci, vp, vp,
                   ci, ci, ci, vp]
    fn.restype = ci
