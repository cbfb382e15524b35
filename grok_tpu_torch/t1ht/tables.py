"""Coding tables for the HT cleanup pass: the port's own table state.

The port's copy of grok_tpu/t1ht/tables.py: the CxtVLC code tables, the
UVLC prefix polarity, and the install point for other tables.  The port
keeps its OWN state (VLC_ENC/VLC_DEC, their initial-row families,
UVLC_PXOR and VERSION): install_tables() here reaches the port's kernels
and caches, and the JAX package's install_tables() does not.  Every
cache of the port that bakes table state is keyed on VERSION and drops
older versions on its next use: the kernels' LUTs (ops/ht_decode.py
`vlc_dec_lut`, ops/ht_encode.py `vlc_enc_lut`, host and device copies)
and the decode programs kept on the serving plans (pipeline/serve.py
`_program`).  The context, kappa and UVLC
rules live in the coders that use them (ops/ht_encode.py,
ops/ht_decode.py and the CUDA kernels).

CxtVLC codes (<= 7 bits) jointly code a quad's significance pattern
rho, its u_off bit and, in tables that carry them, the EMB pattern
eps_k (sym = eps_k << 5 | u_off << 4 | rho).  The default code lengths
were trained on a synthetic corpus (the JAX package's
tools/gen_ht_tables.py) and are baked below; canonical codewords are
derived at import, stored with the transmitted-first bit at bit 0
(LSB-first streams).
"""

from __future__ import annotations

N_CTX = 8
MAX_CLEN = 7                    # decoder peeks a 7-bit window

# --- UVLC ------------------------------------------------------------------
#
# Prefix classes (transmitted-first bit at bit 0, shown for the default
# polarity UVLC_PXOR = 0):
#   "0"            -> u = 1                    (1-bit prefix, no suffix)
#   "1 0"          -> u = 2                    (2-bit prefix, no suffix)
#   "1 1 0" + s1   -> u = 3 + s1               (3-bit prefix, 1 suffix bit)
#   "1 1 1" + s5   -> u = 5 + s5  (s5 < 31)    (3-bit prefix, 5 suffix bits)
#                     u = 36 + e5 (s5 == 31)   (+5 extension bits)
#
# UVLC_PXOR (WIRE_AUDIT delta #2 knob): bit i of UVLC_PXOR flips the
# i-th TRANSMITTED prefix bit on the wire (suffix/extension bits are
# plain binary either way).  The class SHAPE (1/2/3-bit prefixes and
# suffix lengths) is structural; only the bit polarity is a normative
# unknown.  Set via install_tables(uvlc_prefix_xor=...); both of the
# port's kernels and their plain versions read it from here.
#
# Quads are UVLC-coded in PAIRS along each quad row (ISO/IEC 15444-15
# structure): when both quads of a pair have u_off = 1 the two PREFIXES
# are transmitted first, then the two suffixes (each suffix immediately
# followed by its extension bits when present) — see
# ops/ht_encode.py for the initial-row-pair MEL event and the one-bit u1
# special case.

UVLC_PXOR = 0


# --- CxtVLC ----------------------------------------------------------------
# Symbol encoding: sym = (eps_k << 5) | (u_off << 4) | rho.  rho == 0
# implies u_off == 0 and eps_k == 0 (sym 0); context 0 has no rho == 0
# entry (MEL signals significance there).  Default tables: eps_k = 0.

def _symbols(ctx: int):
    syms = [] if ctx == 0 else [0]
    for rho in range(1, 16):
        syms.append(rho)            # u_off = 0
        syms.append(0x10 | rho)     # u_off = 1
    return syms


def _canonical(lengths: dict[int, int]) -> dict[int, tuple[int, int]]:
    """Canonical codewords (MSB-first), shorter codes first then by
    symbol; returned bit-reversed so the transmitted-first bit is at
    bit 0."""
    code = 0
    prev_len = 0
    enc = {}
    for s in sorted(lengths, key=lambda s: (lengths[s], s)):
        ln = lengths[s]
        code <<= ln - prev_len
        rev = int(format(code, f"0{ln}b")[::-1], 2)
        enc[s] = (ln, rev)
        code += 1
        prev_len = ln
    return enc


# Trained code lengths (tools/gen_ht_tables.py over the synthetic
# corpus, 1.63 M quads, 2.58 bits/quad; regenerate after coding-model
# changes).
_TRAINED_LENS = {
    0: {1: 4, 2: 3, 3: 5, 4: 3, 5: 5, 6: 4, 7: 7, 8: 3, 9: 4, 10: 4, 11: 7, 12: 5, 13: 7, 14: 6, 15: 7, 17: 7, 18: 7, 19: 7, 20: 7, 21: 7, 22: 7, 23: 7, 24: 7, 25: 7, 26: 7, 27: 7, 28: 7, 29: 7, 30: 7, 31: 3},
    1: {0: 3, 1: 5, 2: 5, 3: 7, 4: 5, 5: 6, 6: 6, 7: 7, 8: 5, 9: 6, 10: 6, 11: 7, 12: 7, 13: 7, 14: 7, 15: 7, 17: 7, 18: 7, 19: 7, 20: 7, 21: 7, 22: 7, 23: 5, 24: 7, 25: 7, 26: 7, 27: 5, 28: 7, 29: 5, 30: 5, 31: 2},
    2: {0: 3, 1: 4, 2: 3, 3: 4, 4: 4, 5: 6, 6: 5, 7: 6, 8: 4, 9: 5, 10: 5, 11: 6, 12: 4, 13: 6, 14: 6, 15: 5, 17: 7, 18: 7, 19: 7, 20: 7, 21: 7, 22: 7, 23: 7, 24: 7, 25: 7, 26: 7, 27: 7, 28: 7, 29: 7, 30: 7, 31: 4},
    3: {0: 5, 1: 6, 2: 6, 3: 7, 4: 6, 5: 7, 6: 6, 7: 6, 8: 6, 9: 6, 10: 6, 11: 6, 12: 6, 13: 6, 14: 6, 15: 3, 17: 7, 18: 7, 19: 7, 20: 7, 21: 7, 22: 7, 23: 5, 24: 7, 25: 7, 26: 7, 27: 5, 28: 7, 29: 5, 30: 5, 31: 2},
    4: {0: 3, 1: 3, 2: 4, 3: 5, 4: 3, 5: 5, 6: 4, 7: 7, 8: 3, 9: 5, 10: 5, 11: 7, 12: 5, 13: 7, 14: 5, 15: 7, 17: 7, 18: 7, 19: 7, 20: 7, 21: 7, 22: 7, 23: 7, 24: 7, 25: 7, 26: 7, 27: 7, 28: 7, 29: 7, 30: 7, 31: 7},
    5: {0: 4, 1: 4, 2: 4, 3: 5, 4: 4, 5: 4, 6: 4, 7: 5, 8: 4, 9: 4, 10: 4, 11: 5, 12: 5, 13: 6, 14: 6, 15: 5, 17: 7, 18: 7, 19: 7, 20: 7, 21: 7, 22: 7, 23: 6, 24: 7, 25: 7, 26: 7, 27: 7, 28: 7, 29: 7, 30: 7, 31: 3},
    6: {0: 5, 1: 7, 2: 7, 3: 7, 4: 7, 5: 7, 6: 7, 7: 6, 8: 7, 9: 7, 10: 7, 11: 7, 12: 7, 13: 6, 14: 7, 15: 2, 17: 7, 18: 7, 19: 7, 20: 7, 21: 7, 22: 7, 23: 6, 24: 7, 25: 7, 26: 7, 27: 6, 28: 7, 29: 5, 30: 5, 31: 2},
    7: {0: 7, 1: 7, 2: 7, 3: 7, 4: 7, 5: 7, 6: 7, 7: 6, 8: 7, 9: 7, 10: 7, 11: 6, 12: 7, 13: 6, 14: 6, 15: 2, 17: 7, 18: 7, 19: 7, 20: 7, 21: 7, 22: 7, 23: 5, 24: 7, 25: 7, 26: 7, 27: 5, 28: 7, 29: 5, 30: 4, 31: 2},
}


def _dec_from_enc(enc_tables):
    """Peek-window decode LUTs from canonical encode maps (one list of
    128-entry (sym, len) tables per context)."""
    dec_tables = []
    for enc in enc_tables:
        dec = [(-1, 0)] * (1 << MAX_CLEN)
        for sym, (ln, code) in enc.items():
            for pad in range(1 << (MAX_CLEN - ln)):
                dec[code | (pad << ln)] = (sym, ln)
        dec_tables.append(dec)
    return dec_tables


def _repair_lens(lens: dict[int, int]) -> dict[int, int]:
    """Clamp to MAX_CLEN and repair the Kraft sum by lengthening."""
    syms = sorted(lens, key=lambda s: (lens[s], s))
    kraft = sum(2.0 ** -lens[s] for s in syms)
    i = 0
    while kraft > 1.0 + 1e-12:
        s = syms[i % len(syms)]
        if lens[s] < MAX_CLEN:
            kraft -= 2.0 ** -lens[s] - 2.0 ** -(lens[s] + 1)
            lens[s] += 1
        i += 1
    return lens


def _build():
    enc_tables = []
    for c in range(N_CTX):
        lens = dict(_TRAINED_LENS[c])
        # guarantee every legal symbol has a code (corpus gaps)
        for s in _symbols(c):
            lens.setdefault(s, MAX_CLEN)
        enc_tables.append(_canonical(_repair_lens(lens)))
    return enc_tables, _dec_from_enc(enc_tables)


VLC_ENC, VLC_DEC = _build()

# --- table families + normative drop-in point ------------------------------
#
# The spec defines SEPARATE CxtVLC tables for the INITIAL quad-row pair
# vs the rest (WIRE_AUDIT delta #3).  VLC_ENC/VLC_DEC is the
# non-initial family; VLC_ENC_INIT/VLC_DEC_INIT is the initial-row
# family.  By default both names point at the SAME objects (identity
# `VLC_ENC_INIT is VLC_ENC` is the one-family fast path the kernels
# key on); install_tables() is where a normative table drop-in lands.
# VERSION is bumped on every install so trace-time LUT caches
# (ops/pallas_ht.py, ops/pallas_ht_enc.py) rebuild and re-jit.

VLC_ENC_INIT, VLC_DEC_INIT = VLC_ENC, VLC_DEC
VERSION = 0


def two_families() -> bool:
    return VLC_ENC_INIT is not VLC_ENC


def tables_have_ek() -> bool:
    """Any installed table family codes an eps_k != 0 symbol (EMB)."""
    for fam in (VLC_ENC, VLC_ENC_INIT):
        for enc in fam:
            for sym in enc:
                if sym >= 32:
                    return True
        if not two_families():
            break
    return False


def install_tables(*, enc=None, enc_init=None, lens=None, lens_init=None,
                   uvlc_prefix_xor: int = 0):
    """Install CxtVLC tables + UVLC polarity (the normative drop-in
    point — WIRE_AUDIT deltas #1/#2/#3/#5 all land here).

    This is a FULL install, not a patch: every aspect is set on every
    call — an omitted enc/lens keeps the CURRENT non-initial family,
    but an omitted *_init always re-aliases the initial-row family to
    the non-initial one (single-family mode) and an omitted
    uvlc_prefix_xor always resets the polarity to 0.  Callers swapping
    one aspect must re-pass the others.

    enc / enc_init: per-context list of {sym: (len, code)} canonical
    maps (code with the transmitted-first bit at bit 0).  lens /
    lens_init: per-context {sym: len} maps (canonical codes derived
    here; Kraft-repaired).  Symbols may include eps_k bits (sym =
    eps<<5 | u_off<<4 | rho); every legal eps=0 symbol must be
    codeable (the encoders' fallback entries).

    Bumps VERSION, on which the port's table-derived caches are keyed."""
    global VLC_ENC, VLC_DEC, VLC_ENC_INIT, VLC_DEC_INIT
    global UVLC_PXOR, VERSION
    if enc is None and lens is not None:
        enc = [_canonical(_repair_lens(dict(lc))) for lc in lens]
    if enc_init is None and lens_init is not None:
        enc_init = [_canonical(_repair_lens(dict(lc)))
                    for lc in lens_init]
    if enc is not None:
        for c in range(N_CTX):
            for s in _symbols(c):
                assert s in enc[c], f"ctx {c}: base symbol {s} uncodeable"
        VLC_ENC = list(enc)
        VLC_DEC = _dec_from_enc(VLC_ENC)
    if enc_init is not None:
        for c in range(N_CTX):
            for s in _symbols(c):
                assert s in enc_init[c], \
                    f"init ctx {c}: base symbol {s} uncodeable"
        VLC_ENC_INIT = list(enc_init)
        VLC_DEC_INIT = _dec_from_enc(VLC_ENC_INIT)
    else:
        VLC_ENC_INIT, VLC_DEC_INIT = VLC_ENC, VLC_DEC
    UVLC_PXOR = int(uvlc_prefix_xor) & 7
    VERSION += 1


def reset_tables():
    """Restore the default trained single-family tables."""
    global VLC_ENC, VLC_DEC, VLC_ENC_INIT, VLC_DEC_INIT
    global UVLC_PXOR, VERSION
    VLC_ENC, VLC_DEC = _build()
    VLC_ENC_INIT, VLC_DEC_INIT = VLC_ENC, VLC_DEC
    UVLC_PXOR = 0
    VERSION += 1
