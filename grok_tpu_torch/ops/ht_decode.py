"""Batched HTJ2K (Part 15) decode: kernels K1 (cleanup) and K2 (cleanup,
then HT SigProp and HT MagRef) of the port.

One lane is one code-block.  Inputs are the block's three clean
(un-stuffed, LSB-first) sub-streams — MagSgn, MEL and VLC — as zero-padded
uint8 rows, plus its cleanup plane p, its size and a valid flag; the
output is signed mag2 (negative = sign bit) with the Part-1 half-bit
below plane p, the contract of t1ht.scalar.ht_decode_block for
single-segment cleanup-only blocks.

  - `ht_decode_lanes` is the wrapper: a CUDA tensor launches the
    hand-written kernel in csrc/ht_decode.cu, a CPU tensor runs
    `ht_decode_lanes_ref`.  There is no fallback from one to the other.
    The kernel decodes each code-block with two warps: one runs the
    serial MEL / CxtVLC / UVLC chain, table-driven, into a quad map in
    shared memory, quad row by quad row; the other follows it and places
    the MagSgn bits one quad row per step, one thread per quad, by a warp
    scan of the quads' bit counts, and writes every output element.
  - `ht_decode_lanes_v1` launches the first design, csrc/
    ht_decode_v1.cu (one thread per code-block): the full-lane oracle
    and timing yardstick of chip_smoke.py and tools/hw_validate.py, on
    no decode path.
  - `ht_decode_lanes_ref` is the plain PyTorch version: vectorised over
    lanes, a Python loop over quad pairs in the order of the Pallas
    kernel's pair body (grok_tpu/ops/pallas_ht.py `_ht_decode_jit`).
  - `ht_decode_lanes(..., sp, mr, npass)` is K2, the refine=True variant
    of the same TPU kernel (`pallas_ht_decode_refine`): after the
    cleanup, the lanes with p > 0 and 2 or 3 passes run SigProp and
    MagRef at plane p - 1 from two more clean streams.  In the kernel,
    the second warp walks SigProp stripe by stripe behind the chain,
    over the columns that can hold a candidate, two rows at a time by a
    table, and the MagSgn step writes each sample refined, its MagRef bit
    placed by popcounts of the cleanup significance rows.
    Its plain version is `ht_decode_lanes_ref` with the same arguments.
  - `decode_ht_blocks` decodes one bucket of blocks of a refined stream
    (the general decode route): K1 on its cleanup-only blocks, K2 on
    the others.
  - `vlc_dec_lut` is the CxtVLC decode table both read, rebuilt from the
    port's t1ht.tables state per tables.VERSION, so the port's
    install_tables() reaches the kernel.

Reads past a lane's row return 1-bits, as the scalar readers read past
a segment's end (the staging fills each clean sub-stream's row with
1-bits past its last clean bit).  The UVLC decodes the 5-bit escape
(u >= 36) and U runs up to 40, as grok_tpu/t1ht/scalar.py decodes them.

Each lane also gets an error code, returned beside the planes, the
cases in which the scalar decoder gives up on a block: 0 decoded; 1 an
invalid CxtVLC codeword (`ERR_VLC`); 2 an exponent bound U > 40
(`ERR_EXP`), whichever the scalar meets first.  A flagged lane is all zeros, its SigProp and
MagRef passes not applied, as the scalar returns it.  A lane that decodes
but has a quad with U + p >= 31 is marked instead (`MARK_I64`): its
magnitudes may reach 2^31, where its int32 samples are the scalar's int64
ones modulo 2^32 only.  Only a corrupt block gets there; the decode
routes re-decode such lanes with `i64=True` (int64 output, arithmetic
modulo 2^64 as the scalar's numpy int64; on the card the wide design for
every lane size, its own launch counter) and dequantize their tile in
int64 (pipeline/device.py redecode_marked).  Lanes of W or H over 64
(W * H <= 4096) take the kernel's wide design.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from grok_tpu_torch.ops.ht_encode import lane_dims_ok, stripe_order
from grok_tpu_torch.t1ht import tables as _t

# Longest per-lane clean sub-stream the decode routes stage (bytes): a
# legal code-block's 4096 samples of at most 40 MagSgn bits each (U <=
# U_MAX; dense 64x64 lossless 8-bit streams are ~8 KB, 27-bit ones ~16 KB).
MAX_STREAM = 4096 * 40 // 8

# the lane error codes: the scalar decoder's "bad VLC
# code" and "bad exponent bound"
ERR_VLC = 1
ERR_EXP = 2
# a decoded lane whose magnitudes may reach 2^31 (a quad of U + p >= 31)
MARK_I64 = 8
# the largest exponent bound U the scalar decoder takes
U_MAX = 40
_M32 = 0xFFFFFFFF


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
    kernel; `vlc_dec_lut_marked` marks them.  Memoised per
    tables.VERSION."""
    return _luts()[:4]


def vlc_dec_lut_marked() -> np.ndarray:
    """vlc_dec_lut's table with the marker bit 1 << (symb + 3) on each
    invalid window, which raises the lane's ERR_VLC: the table the
    kernel and the plain version read."""
    return _luts()[4]


def _luts():
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
    bad = np.zeros(lut.size, np.int32)
    for f, dec in enumerate(fams):
        for c in range(_t.N_CTX):
            for w7, (sym, ln) in enumerate(dec[c]):
                i = (f * _t.N_CTX + c) * 128 + w7
                if sym < 0:
                    sym, ln = 0, 1
                    bad[i] = 1
                lut[i] = sym | (ln << symb)
    got = (lut, symb, nfam, _t.UVLC_PXOR & 7, lut | (bad << (symb + 3)))
    _LUT_CACHE.clear()          # older table versions are dead
    _LUT_CACHE[_t.VERSION] = got
    return got


_DEV_LUT: dict = {}


def _lut_on(device: torch.device) -> torch.Tensor:
    key = (_t.VERSION, str(device))
    got = _DEV_LUT.get(key)
    if got is None:
        _DEV_LUT.clear()
        got = torch.from_numpy(vlc_dec_lut_marked()).to(device)
        _DEV_LUT[key] = got
    return got


# e = MEL exponent table indexed by the MEL state k (0..12)
_MEL_E = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5)


def _bitlen(x: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative int64 values."""
    n = torch.zeros_like(x)
    v = x
    for kbit in (32, 16, 8, 4, 2, 1):
        big = v >= (1 << kbit)
        n = n + torch.where(big, kbit, 0)
        v = torch.where(big, v >> kbit, v)
    return n + (v >= 1).to(x.dtype)


def ht_decode_lanes_ref(ms, mel, vlc, p, w, h, valid, W: int, H: int,
                        sp=None, mr=None, npass=None, i64: bool = False):
    """Plain PyTorch decode of NL lanes -> ((NL, H, W) int32, each lane's
    error code (NL,) int32): the cleanup, then with sp, mr, npass given
    the refinement passes of `_refine_ref`.

    ms/mel/vlc: (NL, L+1) uint8 clean streams (each its own L); p, w, h,
    valid: (NL,) int32.  Magnitudes run modulo 2^32 beside their signs,
    which gives the int32 results of the kernel and, wrapped to int32,
    of the scalar decoder's int64 ones; with i64, modulo 2^64 into int64
    planes, the scalar decoder's own."""
    mask = -1 if i64 else _M32
    mag, neg, err = _cleanup_ref(ms, mel, vlc, p, w, h, valid, W, H, mask)
    if sp is not None:
        mag, neg = _refine_ref(mag, neg, sp, mr, p, w, h, valid, npass,
                               mask)
    out = torch.where(neg, -mag, mag)
    if not i64:
        out = _wrap32(out)
    out[(err != 0) & (err != MARK_I64)] = 0
    return out, err.to(torch.int32)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32 two's complement, as the int32
    Pallas arithmetic does."""
    x = x & _M32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _bit_reader(buf: torch.Tensor, nbytes: int):
    """bits(bp, n): per lane, the word whose bit 0 is bit bp of its row
    of `buf` (int64, (NL, L+1)) and which holds at least 8 n - 7 valid
    bits; bytes past the row read 0xFF."""
    dev = buf.device
    L1 = buf.shape[1]

    def bits(bp, n=nbytes):
        off = (bp >> 3)[:, None] + torch.arange(n, device=dev)
        b = torch.gather(buf, 1, off.clamp(max=L1 - 1))
        b = torch.where(off < L1, b, 0xFF)
        sh = 8 * torch.arange(n, device=dev, dtype=torch.int64)
        return (b << sh).sum(1) >> (bp & 7)
    return bits


def _refine_ref(mag, neg, sp, mr, p, w, h, valid, npass,
                mask: int = _M32) -> tuple:
    """HT SigProp (npass >= 2) and HT MagRef (npass >= 3) at plane p - 1
    over the cleanup's magnitudes (int64, modulo 2^32, or 2^64 with mask
    -1) and signs of the
    lanes with 0 < p < 32, in the 4-row stripe scan
    (grok_tpu/ops/pallas_ht.py:722-818): a sample SigProp makes
    significant becomes +-((1 << p) + half_bp), half_bp = 1 << (p - 1)
    for p > 1 and 0 at p = 1; MagRef appends one magnitude bit to each
    cleanup-significant sample only.  SigProp steps the scan position by
    position (its significance is causal); MagRef reads its bits at
    positions given by a prefix count.  Returns (mag, neg)."""
    dev = mag.device
    i64 = torch.int64
    NL, H, W = mag.shape
    pp = p.to(i64)
    npl = npass.to(i64)
    on = (valid.to(i64) == 1) & (pp > 0) & (pp < 32)
    v = mag.reshape(NL, H * W)
    ng = neg.reshape(NL, H * W)
    yy = torch.arange(H, device=dev)[:, None].expand(H, W).reshape(-1)
    xx = torch.arange(W, device=dev)[None, :].expand(H, W).reshape(-1)
    inside = (yy[None] < h.to(i64)[:, None]) & (xx[None] < w.to(i64)[:, None])
    csig = inside & (v != 0)                  # cleanup significant
    order = torch.from_numpy(stripe_order(W, H)).to(dev)
    pb = pp.clamp(0, 31)[:, None]
    half = torch.where(on, torch.ones_like(pp) << pp.clamp(0, 31), 0)[:, None]
    half_bp = torch.where(on & (pp > 1), torch.ones_like(pp) << (
        pp - 1).clamp(0, 30), 0)[:, None]

    def bit_at(bits, bp):
        return bits(bp, 1) & 1

    # MagRef first in the code, in effect after SigProp: it refines only
    # the cleanup-significant samples, which SigProp never touches
    cond = (csig & (on & (npl >= 3))[:, None])[:, order]
    bpos = torch.cumsum(cond.to(i64), 1) - cond.to(i64)
    off = bpos >> 3
    mrv = mr.to(i64)
    byte = torch.gather(mrv, 1, off.clamp(max=mrv.shape[1] - 1))
    byte = torch.where(off < mrv.shape[1], byte, 0xFF)
    bit = (byte >> (bpos & 7)) & 1
    cur = v[:, order]
    vq = ((cur - half) & mask) >> (pb + 1)
    nm = (((((vq << 1) | bit) << pb) & mask) + half_bp) & mask
    ref = v.clone()
    ref[:, order] = torch.where(cond, nm, cur)
    rng = ng.clone()

    spb = _bit_reader(sp.to(i64), 1)
    act = inside & (on & (npl >= 2))[:, None]
    st = torch.nn.functional.pad(csig.reshape(NL, H, W), (1, 1, 1, 1))
    mag_new = (half + half_bp)[:, 0]
    bp = torch.zeros(NL, dtype=i64, device=dev)
    for k in order.tolist():
        y, x = divmod(k, W)
        cand = act[:, k] & ~st[:, y + 1, x + 1] \
            & st[:, y:y + 3, x:x + 3].reshape(NL, 9).any(1)
        b = bit_at(spb, bp)
        s = bit_at(spb, bp + 1)
        new = cand & (b == 1)
        bp = bp + torch.where(new, 2, torch.where(cand, 1, 0))
        ref[:, k] = torch.where(new, mag_new, ref[:, k])
        rng[:, k] = torch.where(new, s == 1, rng[:, k])
        st[:, y + 1, x + 1] |= new
    return ref.reshape(NL, H, W), rng.reshape(NL, H, W)


def _cleanup_ref(ms, mel, vlc, p, w, h, valid, W: int, H: int,
                 mask: int = _M32) -> tuple:
    """Plain PyTorch cleanup decode of NL lanes -> (mag, neg, err): the
    magnitudes mag2 modulo 2^32 (int64; modulo 2^64 with mask -1), the
    signs (bool), (NL, H, W), and each lane's error code, (NL,) int64 (its
    planes are not meaningful where it is ERR_VLC or ERR_EXP; MARK_I64
    where it decodes with a quad of U + p >= 31)."""
    N_CTX = _t.N_CTX
    dev = ms.device
    i64 = torch.int64
    NL = ms.shape[0]
    _, symb, nfam, pxor = vlc_dec_lut()
    lut = _lut_on(dev).to(i64)
    # >= 41 valid bits: a UVLC pair with both escapes (<= 26 bits) and a
    # MagSgn value of U <= 40 bits
    msb, melb, vlcb = (_bit_reader(t.to(i64), 6) for t in (ms, mel, vlc))

    p = p.to(i64)
    val = valid.to(i64) == 1
    gw_l = (w.to(i64) + 1) >> 1
    gh_l = (h.to(i64) + 1) >> 1
    wv, hv = w.to(i64), h.to(i64)
    pq = p.clamp(0, 31)
    half = torch.where((p > 0) & (p < 32), torch.ones_like(p) << pq, 0)
    p1 = p + 1
    symmask = (1 << symb) - 1
    e_of_k = torch.tensor(_MEL_E, device=dev, dtype=i64)

    GH, GW = (H + 1) // 2, (W + 1) // 2
    rho = torch.zeros((NL, GH + 1, GW + 2), dtype=i64, device=dev)
    mag = torch.zeros((NL, H, W), dtype=i64, device=dev)
    neg = torch.zeros((NL, H, W), dtype=torch.bool, device=dev)
    err = torch.zeros(NL, dtype=i64, device=dev)
    big = torch.zeros(NL, dtype=torch.bool, device=dev)
    zero = torch.zeros(NL, dtype=i64, device=dev)
    false = torch.zeros(NL, dtype=torch.bool, device=dev)

    def flag(cond, code):
        """The lane's first error: later ones leave it as it is."""
        return torch.where(cond & (err == 0), code, err)

    def mel_event(mask, k, run, pend, mel_bp):
        """One MEL event for `mask` lanes.  Spec polarity: a 1-bit closes
        a full run of 2^e zero-events; a 0-bit is a miss followed by e
        MSB-first partial-run bits."""
        owed = mask & (run > 0)
        pnd = mask & ~owed & (pend == 1)
        need = mask & ~owed & ~pnd
        e = e_of_k[k]
        w6 = melb(mel_bp)
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
        """MEL significance event (context-0 quads) + CxtVLC symbol, and
        whether its codeword is invalid."""
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
        w7 = vlcb(vlc_bp) & 0x7F
        fam = N_CTX if (nfam == 2 and g == 0) else 0
        entry = lut[((fam + c) << 7) | w7]
        sym = torch.where(vread, entry & symmask, 0)
        ln = (entry >> symb) & 7
        bad = vread & (((entry >> (symb + 3)) & 1) == 1)
        vlc_bp = vlc_bp + torch.where(vread, ln, 0)
        return sym, top_p, (k, run, pend, mel_bp), vlc_bp, bad

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
        """Pair-coupled UVLC (t1ht.scalar._read_u_pair): both prefixes,
        then each suffix with its 5-bit escape (a 5-bit suffix of 31 is
        followed by e, u = 36 + e)."""
        wd = vlcb(vlc_bp)
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
        pos = el0 + el1
        sfx0 = (wd >> pos) & ((1 << esl0) - 1)
        esc0 = (esl0 == 5) & (sfx0 == 31)
        x0 = (wd >> (pos + esl0)) & 31
        pos = pos + esl0 + torch.where(esc0, 5, 0)
        sfx1 = (wd >> pos) & ((1 << esl1) - 1)
        esc1 = (esl1 == 5) & (sfx1 == 31)
        x1 = (wd >> (pos + esl1)) & 31
        pos = pos + esl1 + torch.where(esc1, 5, 0)
        add = torch.where(both & (evu == 1), 2, 0) if initial else zero
        u0 = torch.where(off0, torch.where(esc0, 36 + x0, base0 + sfx0)
                         + add, 0)
        u1 = torch.where(off1, torch.where(esc1, 36 + x1, base1 + sfx1)
                         + add, 0)
        return u0, u1, vlc_bp + pos

    def magsgn_quad(sym, top_p, u, act_q, ms_bp):
        """Four maskable MagSgn reads of U - eps_k bits each, and whether
        U is over 40."""
        rhoq = sym & 0xF
        eb_above = top_p >> 4
        multi = (rhoq & (rhoq - 1)) != 0
        kappa = torch.where(multi, torch.clamp(eb_above - 1, min=1), 1)
        bad = act_q & (rhoq != 0) & (kappa + u > U_MAX)
        wide = act_q & (rhoq != 0) & (kappa + u + p >= 31)
        # a lane over the bound is flagged: its reads only stay in range
        U = torch.clamp(kappa + u, max=U_MAX)
        ek = sym >> 5
        mags, negs, smasks = [], [], []
        ebot = zero
        for i in range(4):
            m_i = act_q & (((rhoq >> i) & 1) == 1)
            k_i = (ek >> i) & 1
            m = U - k_i
            wd = msb(ms_bp)
            full = (wd & ((1 << m) - 1)) | (k_i << (U - 1))
            ms_bp = ms_bp + torch.where(m_i, m, 0)
            vi = ((full >> 1) + 1) & mask
            nbits = 64 if mask == -1 else 32
            sh = torch.where(p1 < nbits, vi << p1.clamp(0, nbits - 1),
                             0) & mask
            mags.append((sh + half) & mask)
            negs.append((full & 1) == 1)
            smasks.append(m_i)
            if i & 1:
                ebot = torch.maximum(ebot,
                                     torch.where(m_i, _bitlen(full), 0))
        return mags, negs, smasks, rhoq | (ebot << 4), ms_bp, bad, wide

    def put(y, x, sel, m, n):
        mag[:, y, x] = torch.where(sel, m, mag[:, y, x])
        neg[:, y, x] = torch.where(sel, n, neg[:, y, x])

    def write_quad(g, qx, mags, negs, smasks):
        # quad scan order n0=(0,0) n1=(1,0) n2=(0,1) n3=(1,1)
        in_y1 = (2 * g + 1) < hv
        in_x1 = (2 * qx + 1) < wv
        put(2 * g, 2 * qx, smasks[0], mags[0], negs[0])
        if 2 * qx + 1 < W:
            put(2 * g, 2 * qx + 1, smasks[2] & in_x1, mags[2], negs[2])
        if 2 * g + 1 < H:
            put(2 * g + 1, 2 * qx, smasks[1] & in_y1, mags[1], negs[1])
            if 2 * qx + 1 < W:
                put(2 * g + 1, 2 * qx + 1, smasks[3] & in_y1 & in_x1,
                    mags[3], negs[3])

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
            sym0, top0, mst, vlc_bp, bad0 = quad_sym(
                g, qx0, act0, left0, (k, run, pend, mel_bp), vlc_bp)
            err = flag(bad0, ERR_VLC)
            if has2:
                sym1, top1, mst, vlc_bp, bad1 = quad_sym(
                    g, qx1, act1, sym0 & 0xF, mst, vlc_bp)
                err = flag(bad1, ERR_VLC)
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
            mg0, ng0, sm0, st0, ms_bp, ubad0, big0 = magsgn_quad(
                sym0, top0, u0, act0, ms_bp)
            err = flag(ubad0, ERR_EXP)
            big |= big0
            rho[:, g + 1, qx0 + 1] = torch.where(act0, st0,
                                                 rho[:, g + 1, qx0 + 1])
            write_quad(g, qx0, mg0, ng0, sm0)
            if has2:
                mg1, ng1, sm1, st1, ms_bp, ubad1, big1 = magsgn_quad(
                    sym1, top1, u1, act1, ms_bp)
                err = flag(ubad1, ERR_EXP)
                big |= big1
                rho[:, g + 1, qx1 + 1] = torch.where(
                    act1, st1, rho[:, g + 1, qx1 + 1])
                write_quad(g, qx1, mg1, ng1, sm1)
    return mag, neg, torch.where((err == 0) & big, MARK_I64, err)


def _check(name, t, dtype, shape0, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.shape[0] != shape0:
        raise ValueError(f"{name} has {t.shape[0]} lanes, expected {shape0}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _decode(v1: bool, counter, ms, mel, vlc, p, w, h, valid, W: int,
            H: int, sp, mr, npass, i64: bool = False):
    """ht_decode_lanes through the kernel design v1 or v2 (with i64 its
    int64 entry points), the launch counted on `counter`."""
    dev = ms.device
    NL = ms.shape[0]
    refine = sp is not None
    if refine != (mr is not None) or refine != (npass is not None):
        raise ValueError("sp, mr and npass come together")
    streams = (("ms", ms), ("mel", mel), ("vlc", vlc)) + (
        (("sp", sp), ("mr", mr)) if refine else ())
    for name, t in streams:
        _check(name, t, torch.uint8, NL, dev)
        if t.dim() != 2 or t.shape[1] < 1:
            raise ValueError(f"{name} must be (NL, L+1), got "
                             f"{tuple(t.shape)}")
    params = (("p", p), ("w", w), ("h", h), ("valid", valid)) + (
        (("npass", npass),) if refine else ())
    for name, t in params:
        _check(name, t, torch.int32, NL, dev)
        if t.dim() != 1:
            raise ValueError(f"{name} must be (NL,), got {tuple(t.shape)}")
    if not lane_dims_ok(W, H):
        raise ValueError(f"block dims {W}x{H} outside 1..1024 with at most "
                         f"4096 samples")
    if v1 and (W > 64 or H > 64):
        raise ValueError("the first design takes lanes of up to 64x64")
    if dev.type == "cpu":
        got = ht_decode_lanes_ref(ms, mel, vlc, p, w, h, valid, W, H, sp,
                                  mr, npass, i64)
        return got[0] if v1 else got
    if dev.type != "cuda":
        raise ValueError(f"no HT decode kernel for device {dev}")
    from grok_tpu_torch._build import load_library
    libs = load_library()
    lib = libs.ht_decode_v1 if v1 else libs.ht_decode
    sfx = "_v1" if v1 else "_i64" if i64 else ""
    _, symb, nfam, pxor = vlc_dec_lut()
    lut = _lut_on(dev)
    # v2 writes every element, v1 only the significant samples
    out = (torch.zeros if v1 else torch.empty)(
        (NL, H, W), dtype=torch.int64 if i64 else torch.int32, device=dev)
    err = torch.empty(NL, dtype=torch.int32, device=dev)
    if NL == 0:
        return out if v1 else (out, err)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (ms.data_ptr(), ms.shape[1], mel.data_ptr(), mel.shape[1],
            vlc.data_ptr(), vlc.shape[1], p.data_ptr(), w.data_ptr(),
            h.data_ptr(), valid.data_ptr(), lut.data_ptr(), lut.numel(),
            symb, nfam, pxor, out.data_ptr(), NL, W, H)
    tail = (stream,) if v1 else (err.data_ptr(), stream)
    if refine:
        rc = getattr(lib, f"grk_ht_decode_refine{sfx}")(
            *args, sp.data_ptr(), sp.shape[1], mr.data_ptr(), mr.shape[1],
            npass.data_ptr(), *tail)
    else:
        rc = getattr(lib, f"grk_ht_decode_cleanup{sfx}")(*args, *tail)
    if rc != 0:
        raise RuntimeError(f"HT {'refine' if refine else 'cleanup'} decode "
                           f"kernel launch failed: cudaError {rc}")
    if i64:
        counter.i64_launches += 1
    elif refine:
        counter.refine_launches += 1
    else:
        counter.launches += 1
    return out if v1 else (out, err)


def ht_decode_lanes(ms, mel, vlc, p, w, h, valid, W: int, H: int,
                    sp=None, mr=None, npass=None, i64: bool = False):
    """Cleanup-decode NL lanes -> (signed mag2 (NL, H, W) int32, each
    lane's error code (NL,) int32: 0, ERR_VLC or ERR_EXP, a flagged lane
    all zeros; MARK_I64, a decoded lane whose magnitudes may reach 2^31).
    With i64 the planes are int64, the scalar decoder's own (the decode
    routes' re-decode of the marked lanes; on the card every lane through
    the kernel's wide design, counted on `i64_launches`).

    ms/mel/vlc: (NL, L+1) uint8 clean LSB-first streams, each filled with
    1-bits past its last clean bit (each stream may have its own L); p,
    w, h, valid: (NL,) int32.  W, H: the bucket's block dims (1..1024,
    W * H <= 4096); every lane has w <= W and h <= H.  CPU tensors run
    the plain version; CUDA tensors launch the kernel, and anything the
    kernel does not take raises.

    With sp, mr ((NL, L+1) uint8 clean HT SigProp and HT MagRef streams)
    and npass ((NL,) int32, 1..3 passes) this is kernel K2: each lane's
    cleanup, then SigProp (npass >= 2) and MagRef (npass >= 3) at plane
    p - 1 for the lanes with p > 0, in one launch."""
    return _decode(False, ht_decode_lanes, ms, mel, vlc, p, w, h, valid, W,
                   H, sp, mr, npass, i64)


ht_decode_lanes.launches = 0            # K1 launches
ht_decode_lanes.refine_launches = 0     # K2 launches
ht_decode_lanes.i64_launches = 0        # int64 re-decodes (K1 or K2)


def ht_decode_lanes_v1(ms, mel, vlc, p, w, h, valid, W: int, H: int,
                       sp=None, mr=None, npass=None) -> torch.Tensor:
    """ht_decode_lanes through the first kernel design (csrc/
    ht_decode_v1.cu, one thread per lane): the same arguments, checks and
    result on valid lanes of up to 64 x 64 (it reads 0-bits past a row,
    caps U at 25 and flags no errors, so it returns the planes alone)."""
    return _decode(True, ht_decode_lanes_v1, ms, mel, vlc, p, w, h, valid,
                   W, H, sp, mr, npass)


ht_decode_lanes_v1.launches = 0         # K1 v1 launches
ht_decode_lanes_v1.refine_launches = 0  # K2 v1 launches


def decode_ht_blocks(ms, mel, vlc, sp, mr, p, w, h, valid, npass,
                     refine: np.ndarray, W: int, H: int, i64: bool = False):
    """Decode one bucket of W x H HT code-blocks -> ((NL, H, W) int32,
    the (NL,) int32 error codes): one K1 launch over the
    cleanup-only lanes and one K2 launch over the refined lanes (host
    mask `refine`), as grok_tpu/ops/pallas_ht.py `decode_ht_blocks`
    buckets them.  Arguments as ht_decode_lanes'; every lane is staged
    with its SigProp and MagRef streams (empty for cleanup-only
    blocks).  i64: int64 planes (ht_decode_lanes' i64)."""
    NL = ms.shape[0]
    refine = np.asarray(refine, bool)
    if refine.shape != (NL,):
        raise ValueError(f"refine must be ({NL},), got {refine.shape}")
    groups = ((np.nonzero(~refine)[0], False), (np.nonzero(refine)[0], True))
    if refine.all() or not refine.any():
        # one launch over every lane, no selection
        rf = bool(refine.any())
        return ht_decode_lanes(ms, mel, vlc, p, w, h, valid, W, H,
                               *((sp, mr, npass) if rf else ()), i64=i64)
    out = torch.zeros((NL, H, W), dtype=torch.int64 if i64 else torch.int32,
                      device=ms.device)
    err = torch.zeros(NL, dtype=torch.int32, device=ms.device)
    for idx, rf in groups:
        sel = torch.from_numpy(idx).to(ms.device)
        pick = [t.index_select(0, sel) for t in
                (ms, mel, vlc, p, w, h, valid)]
        extra = [t.index_select(0, sel) for t in (sp, mr, npass)] \
            if rf else []
        out[sel], err[sel] = ht_decode_lanes(*pick, W, H, *extra, i64=i64)
    return out, err


def bind(lib: ctypes.CDLL, sfx: str = "") -> None:
    """Declare the C entry points' signatures on the loaded library (sfx
    "_v1": the first design's, on its own library)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    head = [vp, ci, vp, ci, vp, ci, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp,
            ci, ci, ci]
    tail = [vp] if sfx else [vp, vp]      # v2: the error codes, stream
    fn = getattr(lib, f"grk_ht_decode_cleanup{sfx}")
    fn.argtypes = head + tail
    fn.restype = ci
    fn = getattr(lib, f"grk_ht_decode_refine{sfx}")
    fn.argtypes = head + [vp, ci, vp, ci, vp] + tail
    fn.restype = ci
    if not sfx:
        # the int64 re-decode of marked lanes: the same signatures
        for kind, extra in (("cleanup", []), ("refine", [vp, ci, vp, ci,
                                                         vp])):
            fn = getattr(lib, f"grk_ht_decode_{kind}_i64")
            fn.argtypes = head + extra + tail
            fn.restype = ci


def bind_v1(lib: ctypes.CDLL) -> None:
    """Declare the first design's C entry points on its library."""
    bind(lib, "_v1")
