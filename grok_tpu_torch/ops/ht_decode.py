"""Batched HTJ2K (Part 15) cleanup-pass decode: kernel K1 of the port.

One lane is one code-block.  Inputs are the block's three clean
(un-stuffed, LSB-first) sub-streams — MagSgn, MEL and VLC — as zero-padded
uint8 rows, plus its cleanup plane p, its size and a valid flag; the
output is signed mag2 (negative = sign bit) with the Part-1 half-bit
below plane p, the contract of t1ht.scalar.ht_decode_block for
single-segment cleanup-only blocks.

  - `ht_decode_lanes` is the wrapper: a CUDA tensor launches the
    hand-written kernel in csrc/ht_decode.cu (one thread per lane), a
    CPU tensor runs `ht_decode_lanes_ref`.  There is no fallback from
    one to the other.
  - `ht_decode_lanes_ref` is the plain PyTorch version: vectorised over
    lanes, a Python loop over quad pairs in the order of the Pallas
    kernel's pair body (grok_tpu/ops/pallas_ht.py `_ht_decode_jit`).
  - `vlc_dec_lut` is the CxtVLC decode table both read, rebuilt from the
    current grok_tpu.t1ht.tables state per tables.VERSION, so
    install_tables() reaches the kernel.

Reads past a lane's buffer return 0, as the scalar readers specify.
The UVLC leaves out the 13-bit escape (u >= 36): the serving scope
guarantees numbps - p <= 24, so u <= 24 (pipeline/serve.py).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

# Longest per-lane clean sub-stream the serving path stages (bytes):
# dense 64x64 lossless streams are ~8 KB.
MAX_STREAM = 256 * 32 - 8


def _quant_len(maxlen: int) -> int:
    """Per-lane buffer length in multiples of 256 bytes, with at least 8
    zero bytes past the longest stream."""
    return max(256, -(-(maxlen + 8) // 256) * 256)


_LUT_CACHE: dict = {}


def vlc_dec_lut():
    """(lut, symb, nfam, pxor) for the CURRENT t1ht.tables state.

    lut is a flat int32 array: entry = sym | (len << symb) at index
    (fam*N_CTX + ctx)*128 + window7, fam 0 = non-initial quad rows,
    fam 1 = the initial quad row when tables.two_families().  Invalid
    windows decode as the benign (sym 0, len 1), as in the Pallas
    kernel.  Memoised per tables.VERSION."""
    from grok_tpu.t1ht import tables as _t
    got = _LUT_CACHE.get(_t.VERSION)
    if got is not None:
        return got
    fams = [_t.VLC_DEC]
    if _t.two_families():
        fams.append(_t.VLC_DEC_INIT)
    nfam = len(fams)
    symmax = max(sym for dec in fams for c in range(_t.N_CTX)
                 for sym, _ln in dec[c])
    symb = max(5, int(symmax).bit_length())
    lut = np.zeros(nfam * _t.N_CTX * 128, np.int32)
    for f, dec in enumerate(fams):
        for c in range(_t.N_CTX):
            for w7, (sym, ln) in enumerate(dec[c]):
                if sym < 0:
                    sym, ln = 0, 1
                lut[(f * _t.N_CTX + c) * 128 + w7] = sym | (ln << symb)
    got = (lut, symb, nfam, _t.UVLC_PXOR & 7)
    _LUT_CACHE.clear()          # older table versions are dead
    _LUT_CACHE[_t.VERSION] = got
    return got


_DEV_LUT: dict = {}


def _lut_on(device: torch.device) -> torch.Tensor:
    from grok_tpu.t1ht import tables as _t
    key = (_t.VERSION, str(device))
    got = _DEV_LUT.get(key)
    if got is None:
        _DEV_LUT.clear()
        got = torch.from_numpy(vlc_dec_lut()[0]).to(device)
        _DEV_LUT[key] = got
    return got


# e = MEL exponent table indexed by the MEL state k (0..12)
_MEL_E = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5)


def _bitlen(x: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative int64 values (< 2^32)."""
    n = torch.zeros_like(x)
    v = x
    for kbit in (16, 8, 4, 2, 1):
        big = v >= (1 << kbit)
        n = n + torch.where(big, kbit, 0)
        v = torch.where(big, v >> kbit, v)
    return n + (v >= 1).to(x.dtype)


def ht_decode_lanes_ref(ms, mel, vlc, p, w, h, valid, W: int,
                        H: int) -> torch.Tensor:
    """Plain PyTorch cleanup decode of NL lanes -> (NL, H, W) int32.

    ms/mel/vlc: (NL, L+1) uint8 clean streams (each its own L); p, w, h,
    valid: (NL,) int32.  Arithmetic runs in int64 and wraps to int32 at
    the end, which gives the Pallas kernel's int32 results."""
    from grok_tpu.t1ht.tables import N_CTX
    dev = ms.device
    i64 = torch.int64
    NL = ms.shape[0]
    _, symb, nfam, pxor = vlc_dec_lut()
    lut = _lut_on(dev).to(i64)
    ar4 = torch.arange(4, device=dev)
    shifts4 = torch.tensor([0, 8, 16, 24], device=dev, dtype=i64)

    def padded(buf):
        # four zero bytes past the row: every 4-byte read stays in range
        return torch.nn.functional.pad(buf.to(i64), (0, 4))

    msb, melb, vlcb = padded(ms), padded(mel), padded(vlc)

    def bits(buf, bp):
        """Word whose bit 0 is stream bit bp; >= 25 valid bits."""
        off = torch.clamp(bp >> 3, max=buf.shape[1] - 4)
        b = torch.gather(buf, 1, off[:, None] + ar4)
        return (b << shifts4).sum(1) >> (bp & 7)

    p = p.to(i64)
    val = valid.to(i64) == 1
    gw_l = (w.to(i64) + 1) >> 1
    gh_l = (h.to(i64) + 1) >> 1
    wv, hv = w.to(i64), h.to(i64)
    half = torch.where(p > 0, torch.ones_like(p) << p, 0)
    p1 = p + 1
    symmask = (1 << symb) - 1
    e_of_k = torch.tensor(_MEL_E, device=dev, dtype=i64)

    GH, GW = (H + 1) // 2, (W + 1) // 2
    rho = torch.zeros((NL, GH + 1, GW + 2), dtype=i64, device=dev)
    out = torch.zeros((NL, H, W), dtype=i64, device=dev)
    zero = torch.zeros(NL, dtype=i64, device=dev)
    false = torch.zeros(NL, dtype=torch.bool, device=dev)

    def mel_event(mask, k, run, pend, mel_bp):
        """One MEL event for `mask` lanes.  Spec polarity: a 1-bit closes
        a full run of 2^e zero-events; a 0-bit is a miss followed by e
        MSB-first partial-run bits."""
        owed = mask & (run > 0)
        pnd = mask & ~owed & (pend == 1)
        need = mask & ~owed & ~pnd
        e = e_of_k[k]
        w6 = bits(melb, mel_bp)
        bit0 = w6 & 1
        x5 = (w6 >> 1) & 31
        r5 = ((x5 & 1) << 4) | ((x5 & 2) << 2) | (x5 & 4) | \
            ((x5 & 8) >> 2) | ((x5 >> 4) & 1)
        rfld = r5 >> (5 - e)
        full_path = need & (bit0 == 1)
        miss_path = need & (bit0 == 0)
        ev = (pnd | (miss_path & (rfld == 0))).to(i64)
        mel_bp = mel_bp + torch.where(need, torch.where(bit0 == 0, 1 + e, 1),
                                      0)
        k = torch.where(full_path, torch.clamp(k + 1, max=12),
                        torch.where(miss_path, torch.clamp(k - 1, min=0), k))
        run = torch.where(owed, run - 1,
                          torch.where(full_path, (1 << e) - 1,
                                      torch.where(miss_path & (rfld > 0),
                                                  rfld - 1, run)))
        pend = torch.where(pnd, 0,
                           torch.where(miss_path & (rfld > 0), 1, pend))
        return ev, k, run, pend, mel_bp

    def quad_sym(g, qx, act, left, mstate, vlc_bp):
        """MEL significance event (context-0 quads) + CxtVLC symbol."""
        k, run, pend, mel_bp = mstate
        top_p = rho[:, g, qx + 1]
        top = top_p & 0xF
        topr = rho[:, g, qx + 2] & 0xF
        c = ((left & 0b1100) != 0).to(i64) | \
            (((top & 0b1010) != 0).to(i64) << 1) | \
            (((topr & 0b0010) != 0).to(i64) << 2)
        is_c0 = c == 0
        ev, k, run, pend, mel_bp = mel_event(act & is_c0, k, run, pend,
                                             mel_bp)
        vread = (act & is_c0 & (ev == 1)) | (act & ~is_c0)
        w7 = bits(vlcb, vlc_bp) & 0x7F
        fam = N_CTX if (nfam == 2 and g == 0) else 0
        entry = lut[((fam + c) << 7) | w7]
        sym = torch.where(vread, entry & symmask, 0)
        ln = (entry >> symb) & 7
        vlc_bp = vlc_bp + torch.where(vread, ln, 0)
        return sym, top_p, (k, run, pend, mel_bp), vlc_bp

    def pclass(wd):
        """UVLC prefix class at bit 0: (len, base, suffix len)."""
        wd = wd ^ pxor
        b0 = wd & 1
        b1 = (wd >> 1) & 1
        b2 = (wd >> 2) & 1
        ln = torch.where(b0 == 0, 1, torch.where(b1 == 0, 2, 3))
        base = torch.where(b0 == 0, 1,
                           torch.where(b1 == 0, 2,
                                       torch.where(b2 == 0, 3, 5)))
        sl = torch.where(b0 == 0, 0,
                         torch.where(b1 == 0, 0,
                                     torch.where(b2 == 0, 1, 5)))
        return ln, base, sl

    def uvlc_pair(initial, evu, off0, off1, vlc_bp):
        """Pair-coupled UVLC (t1ht.scalar._read_u_pair)."""
        wd = bits(vlcb, vlc_bp)
        both = off0 & off1
        l0c, base0, sl0c = pclass(wd)
        el0 = torch.where(off0, l0c, 0)
        w1 = wd >> el0
        quirk = both & (evu == 0) & (l0c == 3) if initial else false
        l1c, base1c, sl1c = pclass(w1)
        base1 = torch.where(quirk, (w1 & 1) + 1, base1c)
        el1 = torch.where(off1, torch.where(quirk, 1, l1c), 0)
        esl0 = torch.where(off0, sl0c, 0)
        esl1 = torch.where(off1, torch.where(quirk, 0, sl1c), 0)
        sfx0 = (wd >> (el0 + el1)) & ((1 << esl0) - 1)
        sfx1 = (wd >> (el0 + el1 + esl0)) & ((1 << esl1) - 1)
        add = torch.where(both & (evu == 1), 2, 0) if initial else zero
        u0 = torch.where(off0, base0 + sfx0 + add, 0)
        u1 = torch.where(off1, base1 + sfx1 + add, 0)
        return u0, u1, vlc_bp + el0 + el1 + esl0 + esl1

    def magsgn_quad(sym, top_p, u, act_q, ms_bp):
        """Four maskable MagSgn reads of U - eps_k bits each."""
        rhoq = sym & 0xF
        eb_above = top_p >> 4
        multi = (rhoq & (rhoq - 1)) != 0
        kappa = torch.where(multi, torch.clamp(eb_above - 1, min=1), 1)
        U = torch.clamp(kappa + u, max=25)
        ek = sym >> 5
        svals, smasks = [], []
        ebot = zero
        for i in range(4):
            m_i = act_q & (((rhoq >> i) & 1) == 1)
            k_i = (ek >> i) & 1
            m = U - k_i
            wd = bits(msb, ms_bp)
            full = (wd & ((1 << m) - 1)) | (k_i << (U - 1))
            ms_bp = ms_bp + torch.where(m_i, m, 0)
            vi = (full >> 1) + 1
            mag2 = (vi << p1) + half
            svals.append(torch.where((full & 1) == 1, -mag2, mag2))
            smasks.append(m_i)
            if i & 1:
                ebot = torch.maximum(ebot,
                                     torch.where(m_i, _bitlen(full), 0))
        return svals, smasks, rhoq | (ebot << 4), ms_bp

    def put(y, x, sel, v):
        out[:, y, x] = torch.where(sel, v, out[:, y, x])

    def write_quad(g, qx, svals, smasks):
        # quad scan order n0=(0,0) n1=(1,0) n2=(0,1) n3=(1,1)
        in_y1 = (2 * g + 1) < hv
        in_x1 = (2 * qx + 1) < wv
        put(2 * g, 2 * qx, smasks[0], svals[0])
        if 2 * qx + 1 < W:
            put(2 * g, 2 * qx + 1, smasks[2] & in_x1, svals[2])
        if 2 * g + 1 < H:
            put(2 * g + 1, 2 * qx, smasks[1] & in_y1, svals[1])
            if 2 * qx + 1 < W:
                put(2 * g + 1, 2 * qx + 1, smasks[3] & in_y1 & in_x1,
                    svals[3])

    ms_bp, mel_bp, vlc_bp = zero, zero, zero
    k, run, pend = zero, zero, zero
    for g in range(GH):
        initial = g == 0
        for qp in range((GW + 1) // 2):
            qx0, qx1 = 2 * qp, 2 * qp + 1
            has2 = qx1 < GW
            act0 = val & (g < gh_l) & (qx0 < gw_l)
            act1 = val & (g < gh_l) & (qx1 < gw_l)
            left0 = rho[:, g + 1, qx0] & 0xF
            sym0, top0, mst, vlc_bp = quad_sym(
                g, qx0, act0, left0, (k, run, pend, mel_bp), vlc_bp)
            if has2:
                sym1, top1, mst, vlc_bp = quad_sym(
                    g, qx1, act1, sym0 & 0xF, mst, vlc_bp)
            else:
                sym1 = top1 = zero
            off0 = (sym0 & 0x10) != 0
            off1 = (sym1 & 0x10) != 0
            k, run, pend, mel_bp = mst
            if has2:
                # initial-row-pair MEL event (both u_off = 1 only)
                evu, k, run, pend, mel_bp = mel_event(
                    act0 & initial & off0 & off1, k, run, pend, mel_bp)
            else:
                evu = zero
            u0, u1, vlc_bp = uvlc_pair(initial, evu, off0, off1, vlc_bp)
            sv0, sm0, st0, ms_bp = magsgn_quad(sym0, top0, u0, act0, ms_bp)
            rho[:, g + 1, qx0 + 1] = torch.where(act0, st0,
                                                 rho[:, g + 1, qx0 + 1])
            write_quad(g, qx0, sv0, sm0)
            if has2:
                sv1, sm1, st1, ms_bp = magsgn_quad(sym1, top1, u1, act1,
                                                   ms_bp)
                rho[:, g + 1, qx1 + 1] = torch.where(
                    act1, st1, rho[:, g + 1, qx1 + 1])
                write_quad(g, qx1, sv1, sm1)
    # wrap to int32 two's complement, as the int32 Pallas arithmetic does
    out = out & 0xFFFFFFFF
    return torch.where(out >= (1 << 31), out - (1 << 32), out).to(torch.int32)


def _check(name, t, dtype, shape0, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.shape[0] != shape0:
        raise ValueError(f"{name} has {t.shape[0]} lanes, expected {shape0}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def ht_decode_lanes(ms, mel, vlc, p, w, h, valid, W: int,
                    H: int) -> torch.Tensor:
    """Cleanup-decode NL lanes -> signed mag2 (NL, H, W) int32.

    ms/mel/vlc: (NL, L+1) uint8 clean LSB-first streams, zero-padded
    (each stream may have its own L); p, w, h, valid: (NL,) int32.
    W, H: the bucket's block dims (4..64); every lane has w <= W and
    h <= H.  CPU tensors run the plain version; CUDA tensors launch the
    kernel, and anything the kernel does not take raises."""
    dev = ms.device
    NL = ms.shape[0]
    for name, t in (("ms", ms), ("mel", mel), ("vlc", vlc)):
        _check(name, t, torch.uint8, NL, dev)
        if t.dim() != 2 or t.shape[1] < 1:
            raise ValueError(f"{name} must be (NL, L+1), got "
                             f"{tuple(t.shape)}")
    for name, t in (("p", p), ("w", w), ("h", h), ("valid", valid)):
        _check(name, t, torch.int32, NL, dev)
        if t.dim() != 1:
            raise ValueError(f"{name} must be (NL,), got {tuple(t.shape)}")
    if not (1 <= W <= 64 and 1 <= H <= 64):
        raise ValueError(f"block dims {W}x{H} outside 1..64")
    if dev.type == "cpu":
        return ht_decode_lanes_ref(ms, mel, vlc, p, w, h, valid, W, H)
    if dev.type != "cuda":
        raise ValueError(f"no HT decode kernel for device {dev}")
    from grok_tpu_torch._build import load_library
    lib = load_library()
    _, symb, nfam, pxor = vlc_dec_lut()
    lut = _lut_on(dev)
    out = torch.zeros((NL, H, W), dtype=torch.int32, device=dev)
    if NL == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.grk_ht_decode_cleanup(
        ms.data_ptr(), ms.shape[1], mel.data_ptr(), mel.shape[1],
        vlc.data_ptr(), vlc.shape[1], p.data_ptr(), w.data_ptr(),
        h.data_ptr(), valid.data_ptr(), lut.data_ptr(), lut.numel(),
        symb, nfam, pxor, out.data_ptr(), NL, W, H, stream)
    if rc != 0:
        raise RuntimeError(f"HT cleanup decode kernel launch failed: "
                           f"cudaError {rc}")
    ht_decode_lanes.launches += 1
    return out


ht_decode_lanes.launches = 0


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C entry point's signature on the loaded library."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.grk_ht_decode_cleanup
    fn.argtypes = [vp, ci, vp, ci, vp, ci, vp, vp, vp, vp, vp, ci,
                   ci, ci, ci, vp, ci, ci, ci, vp]
    fn.restype = ci
