"""Batched HTJ2K (Part 15) encode: kernels K4 (cleanup) and K4r (cleanup,
then HT SigProp and HT MagRef) of the port.

One lane is one code-block.  Inputs are the block's quantized samples as
mneg = (magnitude << 1) | sign in an (NL, H, W) int32 tensor, its
cleanup plane p (the cleanup codes magnitude >> p), its size (w, h) and
a valid flag.  Outputs are the three clean (un-stuffed, LSB-first)
sub-streams — MagSgn, MEL and VLC — and their bit counts: the streams
t1ht.scalar.ht_encode_block hands to assemble_cleanup, which the host
then stuffs and interleaves into the wire segment (native.ht_assemble_
batch).  This is the contract of the TPU kernel grok_tpu/ops/
pallas_ht_enc.py `_ht_encode_jit` with refine=False.

  - `ht_encode_lanes` is the wrapper: a CUDA tensor launches the
    hand-written kernel in csrc/ht_encode.cu (one warp per lane; lanes
    over 64 on a side, up to 1024 with at most 4096 samples, through its
    wide design, the warp's first thread coding the block serially), a
    CPU tensor runs `ht_encode_lanes_ref`.  There is no fallback from one
    to the other.
  - `ht_encode_lanes_v1` launches the first design, csrc/
    ht_encode_v1.cu (one thread per lane): the full-lane oracle and
    timing yardstick of chip_smoke.py and tools/hw_validate.py, on no
    serving path.
  - `ht_encode_lanes_ref` is the plain PyTorch version, vectorised over
    lanes: every quantity that depends only on the samples (significance
    patterns, contexts, exponent bounds, CxtVLC codewords, MagSgn
    fields, UVLC codes) is computed for all quads at once; the MEL
    run-length state is a Python loop over the event slots; each
    stream's writes are placed by a prefix sum of their bit lengths.
  - `ht_encode_lanes(..., refine=True)` is K4r, the refine=True variant
    of the same TPU kernel (the ht_planes encode): the lanes with p > 0
    also code SigProp and MagRef at plane p - 1 into two more clean
    streams, and report where SigProp made samples significant.  Its
    plain version is `ht_encode_lanes_ref` then `ht_refine_lanes_ref`.
  - `vlc_enc_lut` is the CxtVLC encode table both read, rebuilt from the
    port's t1ht.tables state per tables.VERSION (two table families,
    EMB symbols and the UVLC prefix polarity follow install_tables()).

Output layout: streams is (NL, LMS + LMEL + LVLC) uint8, each row the
lane's MagSgn stream in [0, LMS), MEL in [LMS, LMS + LMEL) and VLC in
[LMS + LMEL, end); bits is (3, NL) int32 (MagSgn, MEL, VLC).  Only the
first ceil(bits / 8) bytes of a stream are defined (bits past the count
in its last byte are 0): the kernel does not clear the rest, and readers
take the used bytes only (`clear_unused` zeroes the rest for a
comparison).  A stream longer than its capacity is not written past it:
its bit count is -1 and its bytes are undefined.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from grok_tpu_torch.t1ht import tables as _t


def lane_dims_ok(W: int, H: int) -> bool:
    """A legal code-block bucket: sides 1..1024, at most 4096 samples
    (ISO 15444-1 A.6.1)."""
    return 1 <= W <= 1024 and 1 <= H <= 1024 and W * H <= 4096

# e = MEL exponent table indexed by the MEL state k (0..12)
_MEL_E = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5)

_LUT_CACHE: dict = {}
_DEV_LUT: dict = {}


def vlc_enc_lut():
    """(lut, symb, nfam, pxor) for the CURRENT t1ht.tables state.

    lut is a flat int32 array: entry = code | (len << 7) at index
    ((fam*N_CTX + ctx) << symb) | sym, sym = [eps_k << 5 |] u_off << 4 |
    rho; symb = 9 when any family codes EMB symbols, else 5.  fam 0 =
    non-initial quad rows, fam 1 = the initial quad row when
    tables.two_families().  Entry 0 = symbol absent (every code has
    len >= 1): the coders then fall back to the eps_k = 0 symbol, which
    every table codes.  Memoised per tables.VERSION."""
    got = _LUT_CACHE.get(_t.VERSION)
    if got is not None:
        return got
    fams = [_t.VLC_ENC]
    if _t.two_families():
        fams.append(_t.VLC_ENC_INIT)
    nfam = len(fams)
    symb = 9 if _t.tables_have_ek() else 5
    lut = np.zeros(nfam * _t.N_CTX << symb, np.int32)
    for f, enc in enumerate(fams):
        for c in range(_t.N_CTX):
            for sym, (ln, code) in enc[c].items():
                if sym < (1 << symb):
                    lut[((f * _t.N_CTX + c) << symb) | sym] = code | (ln << 7)
    got = (lut, symb, nfam, _t.UVLC_PXOR & 7)
    _LUT_CACHE.clear()          # older table versions are dead
    _LUT_CACHE[_t.VERSION] = got
    return got


def _lut_on(device: torch.device) -> torch.Tensor:
    key = (_t.VERSION, str(device))
    got = _DEV_LUT.get(key)
    if got is None:
        _DEV_LUT.clear()
        got = torch.from_numpy(vlc_enc_lut()[0]).to(device)
        _DEV_LUT[key] = got
    return got


def _bitlen(x: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative int64 values (< 2^32)."""
    n = torch.zeros_like(x)
    v = x
    for kbit in (16, 8, 4, 2, 1):
        big = v >= (1 << kbit)
        n = n + torch.where(big, kbit, 0)
        v = torch.where(big, v >> kbit, v)
    return n + (v >= 1).to(x.dtype)


def _uvlc_parts(u: torch.Tensor, pxor: int):
    """(prefix len, prefix bits, suffix len, suffix bits) of u >= 1, the
    prefix polarity applied (t1ht.tables.uvlc_parts of the JAX
    package); the suffix carries the 5-bit escape extension for u >= 36."""
    pl = torch.where(u == 1, 1, torch.where(u == 2, 2, 3))
    pb = torch.where(u == 1, 0, torch.where(u == 2, 0b01,
                                            torch.where(u <= 4, 0b011,
                                                        0b111)))
    sl = torch.where(u <= 2, 0, torch.where(u <= 4, 1,
                                            torch.where(u <= 35, 5, 10)))
    sb = torch.where(u <= 2, 0, torch.where(
        u <= 4, u - 3, torch.where(u <= 35, u - 5,
                                   31 | ((u - 36).clamp(min=0) << 5))))
    pb = pb ^ (pxor & ((1 << pl) - 1))
    return pl, pb, sl, sb


def _place(vals: torch.Tensor, lens: torch.Tensor, cap: int):
    """Concatenate each lane's writes (vals, lens: (NL, S) int64, in
    stream order, LSB-first, len <= 32) into (NL, cap) bytes; returns
    (bytes uint8, bit counts int32, -1 where a lane's stream exceeds
    cap)."""
    NL = vals.shape[0]
    dev = vals.device
    nbits = lens.sum(1)
    pos = torch.cumsum(lens, 1) - lens
    v = vals & ((1 << lens) - 1)
    sh = v << (pos & 7)
    byte0 = pos >> 3
    out = torch.zeros(NL * (cap + 8), dtype=torch.int64, device=dev)
    row = (torch.arange(NL, device=dev) * (cap + 8))[:, None]
    for k in range(5):
        # bits of distinct writes never share a bit position, so adding
        # the byte parts is OR-ing them
        idx = row + (byte0 + k).clamp(max=cap + 7)
        out.scatter_add_(0, idx.reshape(-1),
                         ((sh >> (8 * k)) & 0xFF).reshape(-1))
    out = out.reshape(NL, cap + 8)[:, :cap].to(torch.uint8)
    over = (nbits + 7) >> 3 > cap
    return out, torch.where(over, -1, nbits).to(torch.int32)


def ht_encode_lanes_ref(mneg, p, w, h, valid, LMS: int, LMEL: int,
                        LVLC: int):
    """Plain PyTorch cleanup encode of NL lanes -> (streams, bits); see
    the module docstring for the layout.  mneg: (NL, H, W) int32; p, w,
    h, valid: (NL,) int32."""
    dev = mneg.device
    i64 = torch.int64
    NL, H, W = mneg.shape
    _, symb, nfam, pxor = vlc_enc_lut()
    lut = _lut_on(dev).to(i64)
    GH, GW = (H + 1) // 2, (W + 1) // 2
    GWP = (GW + 1) // 2

    m = torch.nn.functional.pad(mneg.to(i64), (0, 2 * GW - W, 0, 2 * GH - H))
    yy = torch.arange(2 * GH, device=dev)[None, :, None]
    xx = torch.arange(2 * GW, device=dev)[None, None, :]
    val = valid.to(i64) == 1
    inside = (yy < h.to(i64)[:, None, None]) & (xx < w.to(i64)[:, None, None]) \
        & val[:, None, None]
    vq = torch.where(inside, (m >> 1) >> p.to(i64)[:, None, None], 0)
    sig = vq > 0
    v = torch.where(sig, ((vq - 1) << 1) | (m & 1), 0)
    e = _bitlen(v)

    def quads(a):
        # (NL, 2GH, 2GW) -> (NL, GH, GW, 4), scan order i = 2*dx + dy
        return a.reshape(NL, GH, 2, GW, 2).permute(0, 1, 3, 4, 2) \
            .reshape(NL, GH, GW, 4)

    sq, vq4, eq = quads(sig), quads(v), quads(e)
    bit_i = torch.tensor([1, 2, 4, 8], device=dev, dtype=i64)
    rho = (sq.to(i64) * bit_i).sum(-1)
    ebot = torch.maximum(eq[..., 1], eq[..., 3])
    uact = eq.max(-1).values

    gw_l = ((w.to(i64) + 1) >> 1)[:, None, None]
    gh_l = ((h.to(i64) + 1) >> 1)[:, None, None]
    g_i = torch.arange(GH, device=dev)[None, :, None]
    q_i = torch.arange(GW, device=dev)[None, None, :]
    qa = val[:, None, None] & (g_i < gh_l) & (q_i < gw_l)

    # sample-level context from the left, above and above-right quads
    zc = torch.zeros((NL, GH, 1), dtype=i64, device=dev)
    zr = torch.zeros((NL, 1, GW), dtype=i64, device=dev)
    rl = torch.cat([zc, rho[:, :, :-1]], 2)
    ra = torch.cat([zr, rho[:, :-1]], 1)
    rar = torch.cat([torch.cat([zr, rho[:, :-1]], 1)[:, :, 1:], zc], 2)
    c = ((rl & 0xC) != 0).to(i64) | (((ra & 0xA) != 0).to(i64) << 1) \
        | (((rar & 0x2) != 0).to(i64) << 2)
    # exponent bound U = kappa + u, kappa from the quad above
    eab = torch.cat([zr, ebot[:, :-1]], 1)
    multi = (rho & (rho - 1)) != 0
    kappa = torch.where(multi, (eab - 1).clamp(min=1), 1)
    U = torch.maximum(kappa, uact)
    u = U - kappa
    sym = torch.where(rho != 0, ((u > 0).to(i64) << 4) | rho, 0)
    ek = (((eq == U[..., None]) & sq).to(i64) * bit_i).sum(-1)
    fam = torch.where(g_i == 0, 1 if nfam == 2 else 0, 0)
    base = ((fam * _t.N_CTX + c) << symb)
    ent = lut[base | sym]
    if symb == 9:
        ent_ek = lut[base | (ek << 5) | sym]
        use_ek = (ek != 0) & (ent_ek != 0)
        ent = torch.where(use_ek, ent_ek, ent)
        ek = torch.where(use_ek, ek, 0)
    else:
        ek = torch.zeros_like(ek)

    # --- MagSgn: U - eps_k bits per significant sample, quad raster order
    ms_len = torch.where(sq, U[..., None] - ((ek[..., None] >> torch.arange(
        4, device=dev)) & 1), 0)
    ms, ms_bits = _place(vq4.reshape(NL, -1), ms_len.reshape(NL, -1), LMS)

    # --- per quad pair: CxtVLC codewords, UVLC, MEL events
    cw_on = qa & ~((c == 0) & (rho == 0))
    cw_len = torch.where(cw_on, ent >> 7, 0)
    cw_val = ent & 0x7F
    off = qa & (rho != 0) & (u > 0)

    def pairs(a):
        a = torch.nn.functional.pad(a, (0, 2 * GWP - GW))
        return a[..., 0::2], a[..., 1::2]

    (cl0, cl1), (cv0, cv1) = pairs(cw_len), pairs(cw_val)
    (u0, u1), (o0, o1) = pairs(u), pairs(off.to(i64))
    o0, o1 = o0 == 1, o1 == 1
    (qa0, qa1), (c0, c1), (r0, r1) = pairs(qa.to(i64)), pairs(c), pairs(rho)
    initial = (torch.arange(GH, device=dev) == 0)[None, :, None]
    both = o0 & o1
    ini_both = both & initial
    big = (u0 > 2) & (u1 > 2)
    sub = torch.where(ini_both & big, 2, 0)
    l0, p0, s0, sb0 = _uvlc_parts(u0 - sub, pxor)
    l1, p1, s1, sb1 = _uvlc_parts(u1 - sub, pxor)
    onebit = ini_both & ~big & (l0 == 3)     # u0 >= 3 => u1 <= 2: one bit
    l1 = torch.where(onebit, 1, l1)
    p1 = torch.where(onebit, u1 - 1, p1)
    s1 = torch.where(onebit, 0, s1)
    sb1 = torch.where(onebit, 0, sb1)
    l0, p0, s0, sb0 = (torch.where(o0, a, 0) for a in (l0, p0, s0, sb0))
    l1, p1, s1, sb1 = (torch.where(o1, a, 0) for a in (l1, p1, s1, sb1))
    uv_val = p0 | (p1 << l0) | (sb0 << (l0 + l1)) | (sb1 << (l0 + l1 + s0))
    uv_len = l0 + l1 + s0 + s1
    vlc, vlc_bits = _place(
        torch.stack([cv0, cv1, uv_val], -1).reshape(NL, -1),
        torch.stack([cl0, cl1, uv_len], -1).reshape(NL, -1), LVLC)

    # --- MEL: significance events of context-0 quads and the initial
    # row pairs' "both u > 2" events, run-length coded in order
    ev_on = torch.stack([(qa0 == 1) & (c0 == 0), (qa1 == 1) & (c1 == 0),
                         ini_both], -1).reshape(NL, -1)
    ev = torch.stack([r0 != 0, r1 != 0, big], -1).reshape(NL, -1)
    e_of_k = torch.tensor(_MEL_E, device=dev, dtype=i64)
    k = torch.zeros(NL, dtype=i64, device=dev)
    run = torch.zeros_like(k)
    mvals, mlens = [], []
    for t in range(ev.shape[1]):
        on = ev_on[:, t]
        one = on & ev[:, t]
        zero = on & ~ev[:, t]
        e = e_of_k[k]
        full = zero & (run + 1 == (1 << e))
        rv = torch.zeros_like(run)           # run, e bits MSB-first
        for b in range(5):
            rv = rv | torch.where(b < e, ((run >> (e - 1 - b).clamp(min=0))
                                          & 1) << b, 0)
        mvals.append(torch.where(full, 1, torch.where(one, rv << 1, 0)))
        mlens.append(torch.where(full, 1, torch.where(one, 1 + e, 0)))
        run = torch.where(full | one, 0, torch.where(zero, run + 1, run))
        k = torch.where(full, (k + 1).clamp(max=12),
                        torch.where(one, (k - 1).clamp(min=0), k))
    # a pending partial run is flushed as a claimed full run (one 1-bit)
    mvals.append(torch.where(run > 0, 1, 0))
    mlens.append(torch.where(run > 0, 1, 0))
    mel, mel_bits = _place(torch.stack(mvals, 1), torch.stack(mlens, 1),
                           LMEL)

    return (torch.cat([ms, mel, vlc], 1),
            torch.stack([ms_bits, mel_bits, vlc_bits]))


def _cap_bytes(n: int) -> int:
    """A stream capacity of at least n + 8 bytes: a multiple of 32, at
    least 64 (grok_tpu/ops/pallas_ht_enc.py `_cap_bytes`)."""
    return max(64, -(-(n + 8) // 32) * 32)


def refine_caps(W: int, H: int) -> tuple[int, int]:
    """(LSP, LMR): the SigProp and MagRef stream capacities of W x H
    lanes (clean bits: SigProp <= 2 per sample, MagRef <= 1)."""
    return _cap_bytes(W * H * 2 // 8 + 16), _cap_bytes(W * H // 8 + 16)


def stripe_order(W: int, H: int) -> np.ndarray:
    """Flat sample indices y * W + x of a W x H block in the refinement
    passes' scan: 4-row stripes top to bottom, columns left to right
    within a stripe, rows top to bottom within a column (t1ht/scalar.py
    `_stripe_scan`).  A lane of w <= W, h <= H visits its own samples in
    this order when the others are masked."""
    return np.array([y * W + x for y0 in range(0, H, 4) for x in range(W)
                     for y in range(y0, min(y0 + 4, H))], np.int64)


def ht_refine_lanes_ref(mneg, p, w, h, valid, LSP: int, LMR: int):
    """Plain PyTorch HT SigProp + HT MagRef encode at plane p - 1 of the
    lanes with p > 0 (t1ht/scalar.py `_encode_sigprop`, `_encode_magref`)
    -> (sp (NL, LSP), mr (NL, LMR) uint8, bits (2, NL) int32, ns
    (NL, H, W) uint8, 1 where SigProp made a sample significant).

    SigProp is causal in the stripe scan (a sample it makes significant
    counts for the samples after it), so it steps the scan position by
    position over all lanes at once; MagRef reads only the cleanup
    significance and is placed in one pass."""
    dev = mneg.device
    i64 = torch.int64
    NL, H, W = mneg.shape
    pp = p.to(i64)
    rmask = (valid.to(i64) == 1) & (pp > 0)
    bp = (pp - 1).clamp(min=0)[:, None]
    m = mneg.to(i64).reshape(NL, H * W)
    yy = torch.arange(H, device=dev)[:, None].expand(H, W).reshape(-1)
    xx = torch.arange(W, device=dev)[None, :].expand(H, W).reshape(-1)
    inside = (yy[None] < h.to(i64)[:, None]) & (xx[None] < w.to(i64)[:, None])
    act = inside & rmask[:, None]
    sig0 = act & (((m >> 1) >> pp[:, None]) > 0)        # cleanup significant
    bit = ((m >> 1) >> bp) & 1
    order = torch.from_numpy(stripe_order(W, H)).to(dev)

    # MagRef: one raw bit per cleanup-significant sample, in scan order
    mr, mr_bits = _place(bit[:, order], sig0[:, order].to(i64), LMR)

    # SigProp: significance and sign of the insignificant samples with a
    # significant neighbour
    st = torch.nn.functional.pad(sig0.reshape(NL, H, W), (1, 1, 1, 1))
    vals, lens = [], []
    for k in order.tolist():
        y, x = divmod(k, W)
        cand = act[:, k] & ~st[:, y + 1, x + 1] \
            & st[:, y:y + 3, x:x + 3].reshape(NL, 9).any(1)
        b = bit[:, k]
        new = cand & (b == 1)
        vals.append(b | ((m[:, k] & 1) << 1))
        lens.append(torch.where(cand, 1 + b, 0))
        st[:, y + 1, x + 1] |= new
    sp, sp_bits = _place(torch.stack(vals, 1), torch.stack(lens, 1), LSP)
    ns = (st[:, 1:H + 1, 1:W + 1] & ~sig0.reshape(NL, H, W)).to(torch.uint8)
    return sp, mr, torch.stack([sp_bits, mr_bits]), ns


def _check(name, t, dtype, shape0, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.shape[0] != shape0:
        raise ValueError(f"{name} has {t.shape[0]} lanes, expected {shape0}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _encode(v1: bool, counter, mneg, p, w, h, valid, LMS: int, LMEL: int,
            LVLC: int, refine: bool):
    """ht_encode_lanes through the kernel design v1 or v2, the launch
    counted on `counter` (the wrapper function)."""
    dev = mneg.device
    if mneg.dim() != 3:
        raise ValueError(f"mneg must be (NL, H, W), got {tuple(mneg.shape)}")
    NL, H, W = mneg.shape
    _check("mneg", mneg, torch.int32, NL, dev)
    for name, t in (("p", p), ("w", w), ("h", h), ("valid", valid)):
        _check(name, t, torch.int32, NL, dev)
        if t.dim() != 1:
            raise ValueError(f"{name} must be (NL,), got {tuple(t.shape)}")
    if not lane_dims_ok(W, H) or (v1 and (W > 64 or H > 64)):
        raise ValueError(f"block dims {W}x{H} outside 1..1024 with at most "
                         f"4096 samples{' (64 x 64 for v1)' if v1 else ''}")
    for name, L in (("LMS", LMS), ("LMEL", LMEL), ("LVLC", LVLC)):
        if L < 4 or L % 4:
            raise ValueError(f"{name} = {L} is not a positive multiple of 4")
    LSP, LMR = refine_caps(W, H)
    if dev.type == "cpu":
        streams, bits = ht_encode_lanes_ref(mneg, p, w, h, valid, LMS, LMEL,
                                            LVLC)
        if not refine:
            return streams, bits
        sp, mr, rbits, ns = ht_refine_lanes_ref(mneg, p, w, h, valid, LSP,
                                                LMR)
        return (torch.cat([streams, sp, mr], 1), torch.cat([bits, rbits]),
                ns)
    if dev.type != "cuda":
        raise ValueError(f"no HT encode kernel for device {dev}")
    from grok_tpu_torch._build import load_library
    libs = load_library()
    lib = libs.ht_encode_v1 if v1 else libs.ht_encode
    sfx = "_v1" if v1 else ""
    _, symb, nfam, pxor = vlc_enc_lut()
    lut = _lut_on(dev)
    row = LMS + LMEL + LVLC + (LSP + LMR if refine else 0)
    # the kernel writes every bit count and each stream's used words; v2
    # writes ns whole, v1 only its 1s
    streams = torch.empty((NL, row), dtype=torch.uint8, device=dev)
    bits = torch.empty((5 if refine else 3, NL), dtype=torch.int32,
                       device=dev)
    ns = ((torch.zeros if v1 else torch.empty)(
        (NL, H, W), dtype=torch.uint8, device=dev) if refine else None)
    if NL == 0:
        return (streams, bits, ns) if refine else (streams, bits)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (mneg.data_ptr(), p.data_ptr(), w.data_ptr(), h.data_ptr(),
            valid.data_ptr(), lut.data_ptr(), lut.numel(), symb, nfam, pxor,
            streams.data_ptr(), row, LMS, LMEL, LVLC)
    if refine:
        rc = getattr(lib, f"grk_ht_encode_refine{sfx}")(
            *args, LSP, LMR, bits.data_ptr(), ns.data_ptr(), NL, W, H,
            stream)
    else:
        rc = getattr(lib, f"grk_ht_encode_cleanup{sfx}")(
            *args, bits.data_ptr(), NL, W, H, stream)
    if rc != 0:
        raise RuntimeError(f"HT {'refine' if refine else 'cleanup'} encode "
                           f"kernel launch failed: cudaError {rc}")
    if refine:
        counter.refine_launches += 1
        return streams, bits, ns
    counter.launches += 1
    return streams, bits


def ht_encode_lanes(mneg, p, w, h, valid, LMS: int, LMEL: int, LVLC: int,
                    refine: bool = False):
    """Cleanup-encode NL lanes -> (streams (NL, LMS+LMEL+LVLC) uint8,
    bits (3, NL) int32); see the module docstring for the layout.

    mneg: (NL, H, W) int32 with 1 <= W, H <= 1024, W * H <= 4096 (lanes
    over 64 on a side take the kernel's wide design); p, w, h, valid:
    (NL,) int32, every lane with w <= W and h <= H.  LMS, LMEL, LVLC: per-lane
    stream capacities in bytes, multiples of 4.  CPU tensors run the
    plain version; CUDA tensors launch the kernel, and anything the
    kernel does not take raises.

    refine=True is kernel K4r: the lanes with p > 0 also code HT SigProp
    and HT MagRef at plane p - 1, in the same launch.  It returns
    (streams (NL, LMS+LMEL+LVLC+LSP+LMR) uint8, bits (5, NL) int32, ns
    (NL, H, W) uint8), the two clean refinement streams after the
    cleanup's three (LSP, LMR = refine_caps(W, H)) and ns = 1 where
    SigProp made a sample significant; lanes with p = 0 code the cleanup
    only (0 refinement bits)."""
    return _encode(False, ht_encode_lanes, mneg, p, w, h, valid, LMS, LMEL,
                   LVLC, refine)


ht_encode_lanes.launches = 0            # K4 launches
ht_encode_lanes.refine_launches = 0     # K4r launches


def ht_encode_lanes_v1(mneg, p, w, h, valid, LMS: int, LMEL: int,
                       LVLC: int, refine: bool = False):
    """ht_encode_lanes through the first kernel design (csrc/
    ht_encode_v1.cu, one thread per lane): the same arguments, checks and
    result."""
    return _encode(True, ht_encode_lanes_v1, mneg, p, w, h, valid, LMS,
                   LMEL, LVLC, refine)


ht_encode_lanes_v1.launches = 0         # K4 v1 launches
ht_encode_lanes_v1.refine_launches = 0  # K4r v1 launches


def clear_unused(streams, bits, *caps: int):
    """streams with every byte past each stream's ceil(bits / 8) set to 0
    (all of a stream whose count is -1): the bytes two encodes of the
    same lanes must agree on.  caps: the capacities of every stream but
    the last (LMS, LMEL for the cleanup; LMS, LMEL, LVLC, LSP with the
    refinement streams)."""
    col = torch.arange(streams.shape[1], device=streams.device)[None]
    nbytes = (bits.to(torch.int64) + 7) >> 3            # -1 bits -> 0
    keep = torch.zeros(streams.shape, dtype=torch.bool,
                       device=streams.device)
    starts = np.concatenate([[0], np.cumsum(caps)]).tolist()
    for s, lo in enumerate(starts):
        keep |= (col >= lo) & (col < lo + nbytes[s][:, None])
    return torch.where(keep, streams, 0)


def bind(lib: ctypes.CDLL, sfx: str = "") -> None:
    """Declare the C entry points' signatures on the loaded library (sfx
    "_v1": the first design's, on its own library)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    head = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp, ci, ci, ci, ci]
    fn = getattr(lib, f"grk_ht_encode_cleanup{sfx}")
    fn.argtypes = head + [vp, ci, ci, ci, vp]
    fn.restype = ci
    fn = getattr(lib, f"grk_ht_encode_refine{sfx}")
    fn.argtypes = head + [ci, ci, vp, vp, ci, ci, ci, vp]
    fn.restype = ci


def bind_v1(lib: ctypes.CDLL) -> None:
    """Declare the first design's C entry points on its library."""
    bind(lib, "_v1")
