// HTJ2K (ISO 15444-15) decode of a batch of code-blocks: the cleanup pass
// (kernel K1, `ht_decode_kernel<false>`) and the cleanup followed by the HT
// SigProp and HT MagRef refinement passes at plane p - 1 (kernel K2,
// `ht_decode_kernel<true>`).
//
// Replaces the Pallas TPU kernel grok_tpu/ops/pallas_ht.py
// `_ht_decode_jit` (refine=False, reached through `pallas_ht_decode`, and
// the refine=True variant at :722-818, through `pallas_ht_decode_refine`),
// with the same contract: per lane, clean LSB-first MagSgn, MEL and VLC
// streams (and for K2 the SigProp and MagRef streams and the pass count)
// as uint8 rows filled with 1-bits past their clean bits, each stream with
// its own row length, the cleanup plane p, the block size and a valid flag
// in; signed mag2 (negative = sign bit) with the Part-1 half-bit below
// plane p out, as (NL, H, W) int32 in lane-major layout, and each lane's
// error code, bit-exact to grok_tpu/t1ht/scalar.py `ht_decode_block`
// (its int64 magnitudes modulo 2^32).  Reads past a lane's row give
// 1-bits, as the scalar readers read past a segment's end; the UVLC takes
// the 5-bit escape (u = 36 + e) and U runs up to 40.  The error code is
// the scalar's first reason to give up on a block: 1 an invalid CxtVLC
// codeword (a window the table marks), 2 an exponent bound U > 40; such a
// lane is all zeros, its refinement passes not applied.  The kernel
// writes every element: zeros outside each lane's w x h and on invalid
// lanes.  A lane that decodes may also be marked (code 8, HT_MARK_I64):
// some quad of it has U + p >= 31, so its magnitudes may reach 2^31 and
// its int32 samples be the scalar's int64 ones modulo 2^32 only.  Only a
// corrupt block gets there (an intact one's U stays under Mb + 2); the
// caller re-decodes the marked lanes with the int64 entry points
// (`grk_ht_decode_*_i64`: the wide design below, its output int64, its
// arithmetic modulo 2^64 as the scalar's numpy int64), whatever their
// size.  The plain PyTorch version is grok_tpu_torch/ops/ht_decode.py
// `ht_decode_lanes_ref`; the first design, csrc/ht_decode_v1.cu (one
// thread per code-block, no error codes), is kept as the full-lane oracle
// on valid lanes of up to 64 x 64.  The three are held identical on the
// card.
//
// Design (v2, lanes of up to 64 x 64).  Each code-block is decoded by two
// warps of a CTA (4
// code-blocks, 8 warps).  The only serial chain of the cleanup is the MEL
// / CxtVLC / UVLC decode, and it needs no MagSgn result: a quad's context
// comes from rho of its left and upper neighbours.  So the chain warp runs
// that chain over the block, quad row by quad row (all 32 threads alike,
// so the warp never diverges), and writes rho, eps_k and u of each quad to
// the lane's quad map in shared memory, counting the finished rows.  The
// chain is table-driven: the CxtVLC table is rebuilt per CTA so that an
// entry carries its codeword length and the next quad's left-context bit
// in place, the above-row context of a whole row is built in a register
// before the row, and a second table decodes a quad pair's UVLC prefixes
// and suffix lengths in one load (the initial-row rules as a mode of its
// index; a suffix that opens the escape is read behind a rare branch).
// Its MEL and VLC reads come from 32-bit word pairs refilled by
// whole aligned words, each loaded a refill ahead: the rows are L + 1
// bytes, so a lane's row is not word-aligned, and a reader loads the
// aligned words that cover it and starts at the row's byte offset.  An
// invalid codeword stops the chain: it zeroes the rest of the quad row
// from the failing pair on, notes the row and releases the second warp.
//
// The second warp follows the chain stripe by stripe (two quad rows),
// waiting on its count.  For each quad row it places the MagSgn bits, one
// thread per quad: kappa from the ebot its own thread found in the row
// above, U and the quad's bit count (a U over 40 fails the lane, found by
// the warp scan of the counts), a warp scan for the quad's offset,
// the samples drawn from five aligned words loaded at once straight from
// device memory (the MagSgn row is prefetched to L1 at lane start; a U
// over 25 reads each sample by itself, a rare branch), and
// the quad's 2 x 2 outputs stored by the thread, zeros included.  It
// stops at the chain's failing row, and a failed lane is zeroed whole.
//
// K2: SigProp needs no magnitude either, so the second warp runs it on each
// stripe before the stripe's MagSgn steps.  It builds the stripe's cleanup
// significance rows (one 64-bit word per sample row) from the quad map
// and, one thread per column, each column's candidate and significant rows
// as a byte, the row above's new significance included; the walk, in the
// causal scan order (column by column, top to bottom), visits only the
// columns that can hold a candidate and the right neighbours of columns
// with a new significance, decodes a column two rows at a time by a third
// table indexed by its candidate rows and the next 4 SigProp bits, and
// records each column's new significance and signs as a byte.  The MagSgn
// step then writes each sample's final value at once: a new SigProp
// significance as +-((1 << p) + half), and MagRef's bit of a
// cleanup-significant sample from the count of cleanup-significant
// samples before it in the stripe order (popcounts of the row words).
// The lane's state lives in its slice of shared memory, the tables once
// per CTA.
//
// Wide lanes (W or H over 64, W * H <= 4096: code-blocks such as 1024 x 4
// or 16 x 256) take a simple design, `ht_decode_wide_kernel`: one warp per
// code-block, whose first thread decodes the block serially in the
// scalar decoder's order (the pair's CxtVLC codewords, its UVLC, its
// MagSgn samples; then MagRef and SigProp in the stripe scan) with the
// above row's rho and ebot and the block's significance and sign bits in
// shared memory and the magnitudes in the output block; the warp zeroes
// the block first and applies the signs last.
//
// Bound.  The bytes are ~100x below the first design's time; a lane takes
// the chain warp's serial decode (a few hundred cycles a quad) and, for
// K2, the second warp's SigProp walk, which overlap.  A wide lane takes
// its one thread's serial decode of up to 1,024 quads.

#include "t1_warp.cuh"

#include <type_traits>

#define HT_N_CTX 8
#define HT_MAX_GW 32          // v2 blocks are at most 64 wide
#define HT_LANES 4            // code-blocks per CTA, two warps each
#define HT_WIDE_WARPS 4       // wide code-blocks per CTA, one warp each
#define HT_U_MAX 40           // the largest exponent bound U decoded
#define HT_BAD (1 << 13)      // a table entry of an invalid codeword
#define HT_ERR_VLC 1          // the lane error codes
#define HT_ERR_EXP 2
#define HT_MARK_I64 8         // decoded, some quad with U + p >= 31
#define HT_ROWS_ALL (1 << 30) // the chain's count once it has failed
#define HT_NO_ROW 0x7FFFFFFF  // no failing quad row
// a lane's shared memory: the chain's progress (quad rows done) and its
// failing quad row, then the quad map, rho | eps_k << 4 | u << 8 per quad
#define HT_MAP_BYTES (HT_MAX_GW * HT_MAX_GW * 2)
#define HT_CLN_BYTES (16 + HT_MAP_BYTES)
// K2: cleanup significance (one 64-bit word per sample row); each
// stripe's column mask and column bytes (stripe_cols); each stripe's news
// bytes (sp_stripe)
#define HT_REF_BYTES (HT_CLN_BYTES + 64 * 8 + 16 * 8 + 16 * 64 + 16 * 64)
// the CTA's decode tables: two CxtVLC families, the UVLC table and the
// SigProp table
#define HT_TAB_MAX (2 * HT_N_CTX * 128 + 256 + 512)

// The MEL exponent e of state k (0..12): 0 0 0 1 1 1 2 2 2 3 3 4 5, three
// bits each.
#define HT_MEL_E(k) ((int)((0x58DA489200ull >> (3 * (k))) & 7))

__device__ __forceinline__ uint32_t shl32(uint32_t x, int s)
{
    return (unsigned)s >= 32u ? 0u : x << s;
}

__device__ __forceinline__ uint32_t shr32(uint32_t x, int s)
{
    return (unsigned)s >= 32u ? 0u : x >> s;
}

// The same shifts on the word a wide lane keeps its magnitudes in: 32
// bits for the int32 output, 64 for the int64 one.
template <class M>
__device__ __forceinline__ M shlw(M x, int s)
{
    return (unsigned)s >= 8u * sizeof(M) ? (M)0 : (M)(x << s);
}

template <class M>
__device__ __forceinline__ M shrw(M x, int s)
{
    return (unsigned)s >= 8u * sizeof(M) ? (M)0 : (M)(x >> s);
}

// A lane's stream row of `len` bytes at any alignment, read as the aligned
// 32-bit words that cover it; bytes at and past len read 0.
struct Row {
    const uint8_t* a;         // the row rounded down to 4 bytes
    int mis;                  // row - a
    int len;
};

__device__ __forceinline__ Row row_at(const uint8_t* row, int len)
{
    const int mis = (int)((uintptr_t)row & 3u);
    Row r = { row - mis, mis, len };
    return r;
}

// Word k of the cover as loaded: row bytes 4k - mis .. 4k - mis + 3 (the
// bytes before the row, in word 0, are never read), all ones for a word
// wholly past the row, which is not loaded.  row_word sets the bytes past
// the row to 0xFF, as the scalar readers read past a segment's end; the
// two are apart so that a load's latency ends at its first use.
__device__ __forceinline__ uint32_t row_raw(const Row& r, int k)
{
    return r.len + r.mis - 4 * k > 0 ? t1_ldg32(r.a + 4 * k) : ~0u;
}

__device__ __forceinline__ uint32_t row_word(const Row& r, int k,
                                             uint32_t raw)
{
    const int in = r.len + r.mis - 4 * k;        // bytes of the word inside
    return in >= 4 ? raw : in <= 0 ? ~0u : raw | ~((1u << (8 * in)) - 1u);
}

// The m <= 57 bits of the row from bit b on (a rare path: U over 25).
__device__ __forceinline__ uint64_t row_bits(const Row& r, int b, int m)
{
    const int a = b + 8 * r.mis, k = a >> 5, s = a & 31;
    const uint32_t w0 = row_word(r, k, row_raw(r, k));
    const uint32_t w1 = row_word(r, k + 1, row_raw(r, k + 1));
    const uint32_t w2 = row_word(r, k + 2, row_raw(r, k + 2));
    uint64_t v = ((uint64_t)w1 << 32 | w0) >> s;
    if (s)
        v |= (uint64_t)w2 << (64 - s);
    return v & ((1ull << m) - 1ull);
}

// Bit length of a 64-bit value.
__device__ __forceinline__ int bitlen64(uint64_t x)
{
    const uint32_t hi = (uint32_t)(x >> 32);
    return hi ? 64 - t1_clz(hi) : 32 - t1_clz((uint32_t)x);
}

// Every line of the row into L1, spread over the warp.
__device__ __forceinline__ void row_prefetch(const uint8_t* row, int len)
{
    warp_for((len + 127) / 128 + 1, [&](int i) {
        t1_prefetch(row + min(128 * i, len - 1));
    });
}

// The bits of the row from bit b on, drawn in order, up to 25 at a time
// and 100 in all: five aligned words loaded at once, in registers.
struct Window {
    uint64_t acc;             // the next n bits
    int n;
    uint32_t q0, q1, q2;      // the words after them
};

__device__ __forceinline__ Window win_at(const Row& r, int b)
{
    const int a = b + 8 * r.mis;
    const int k = a >> 5;
    uint32_t w[5];
#pragma unroll
    for (int j = 0; j < 5; j++)
        w[j] = row_raw(r, k + j);
#pragma unroll
    for (int j = 0; j < 5; j++)
        w[j] = row_word(r, k + j, w[j]);
    Window x = { (w[0] | ((uint64_t)w[1] << 32)) >> (a & 31),
                 64 - (a & 31), w[2], w[3], w[4] };
    return x;
}

// The next m <= 25 bits.
__device__ __forceinline__ uint32_t win_take(Window& x, int m)
{
    if (x.n < 25) {
        x.acc |= (uint64_t)x.q0 << x.n;
        x.n += 32;
        x.q0 = x.q1;
        x.q1 = x.q2;
    }
    const uint32_t v = (uint32_t)x.acc & ((1u << m) - 1u);
    x.acc >>= m;
    x.n -= m;
    return v;
}

// A serial bit reader over a row: the next bits are those from bit b of
// the word pair w1:w0, and the word after w1 is loaded a refill ahead
// (masked only when it is used).
struct Reader {
    Row r;
    uint32_t w0, w1;
    uint32_t nxt;             // word k as loaded
    int b;                    // 0..31
    int k;
};

__device__ __forceinline__ void rd_init(Reader& s, const uint8_t* row,
                                        int len)
{
    s.r = row_at(row, len);
    const uint32_t w0 = row_raw(s.r, 0), w1 = row_raw(s.r, 1);
    s.nxt = row_raw(s.r, 2);
    s.w0 = row_word(s.r, 0, w0);
    s.w1 = row_word(s.r, 1, w1);
    s.b = 8 * s.r.mis;
    s.k = 2;
}

// The next 32 bits.
__device__ __forceinline__ uint32_t rd_peek(const Reader& s)
{
    return t1_fshr(s.w0, s.w1, s.b);
}

// Drop m <= 32 bits.
__device__ __forceinline__ void rd_skip(Reader& s, int m)
{
    s.b += m;
    if (s.b >= 32) {
        s.b -= 32;
        s.w0 = s.w1;
        s.w1 = row_word(s.r, s.k, s.nxt);
        s.k++;
        s.nxt = row_raw(s.r, s.k);
    }
}

// A UVLC suffix of sl bits on the prefix class's base, with the 5-bit
// escape: a 5-bit suffix of 31 is followed by e, u = 36 + e
// (t1ht.scalar._read_u_pair `val`).
__device__ __forceinline__ int uvlc_tail(Reader& r, int base, int sl)
{
    if (!sl)
        return base;
    const int v = (int)(rd_peek(r) & ((1u << sl) - 1u));
    rd_skip(r, sl);
    if (sl < 5 || v != 31)
        return base + v;
    const int e = (int)(rd_peek(r) & 31u);
    rd_skip(r, 5);
    return 36 + e;
}

struct MelState {
    int k, run, pend;
};

// One MEL event.  Spec polarity: a 1-bit closes a full run of 2^e zero
// events; a 0-bit is a miss followed by e MSB-first partial-run bits.
__device__ __forceinline__ int mel_event(MelState& m, Reader& s)
{
    if (m.run > 0) {                 // owed zero events of a full run
        m.run -= 1;
        return 0;
    }
    if (m.pend) {                    // the event closing a partial run
        m.pend = 0;
        return 1;
    }
    const int k = m.k, e = HT_MEL_E(k);
    const uint32_t w6 = rd_peek(s);
    if (w6 & 1u) {                   // full run
        rd_skip(s, 1);
        m.k = min(k + 1, 12);
        m.run = (1 << e) - 1;
        return 0;
    }
    const uint32_t x5 = (w6 >> 1) & 31u;
    const uint32_t r5 = ((x5 & 1u) << 4) | ((x5 & 2u) << 2) | (x5 & 4u)
        | ((x5 & 8u) >> 2) | ((x5 >> 4) & 1u);
    const int rfld = (int)(r5 >> (5 - e));
    rd_skip(s, 1 + e);               // miss
    m.k = max(k - 1, 0);
    if (rfld > 0) {
        m.run = rfld - 1;
        m.pend = 1;
        return 0;
    }
    return 1;
}

// UVLC prefix class at bit 0 (polarity pxor applied): len, base, suffix.
__device__ __forceinline__ void pclass(uint32_t wv, int pxor, int& ln,
                                       int& base, int& sl)
{
    wv ^= (uint32_t)pxor;
    const int b0 = wv & 1u, b1 = (wv >> 1) & 1u, b2 = (wv >> 2) & 1u;
    ln = b0 == 0 ? 1 : (b1 == 0 ? 2 : 3);
    base = b0 == 0 ? 1 : (b1 == 0 ? 2 : (b2 == 0 ? 3 : 5));
    sl = b0 == 0 ? 0 : (b1 == 0 ? 0 : (b2 == 0 ? 1 : 5));
}

// The decode tables of a CTA, built from the wrapper's CxtVLC table
// (entry = sym | len << symb at (fam * 8 + ctx) * 128 + window): at
// [0, lut_n) each CxtVLC entry as len | rho << 3 | (rho & 0xC != 0) << 7 |
// u_off << 8 | eps_k << 9 | HT_BAD where the wrapper's table marks the
// window invalid (bit symb + 3), so that bit 7 is the next quad's
// left-context bit in place; at [lut_n, lut_n + 256) the pair-coupled UVLC
// (t1ht.scalar._read_u_pair) of the prefixes and suffix lengths, indexed
// by mode << 6 | the next 6 bits, mode 1, 2: u_off of the first or the
// second quad only, 3: both, 0: both in the initial quad row with the
// pair's MEL event 0, where a 3-bit first prefix implies u1 <= 2, coded
// in one bit: prefix bits | suffix lengths << 3, << 6 | bases << 9, << 12
// | all bits << 15; at [lut_n + 256, lut_n + 768) HT SigProp on two rows
// of a stripe column, indexed by their candidates (through the cleanup
// significance around them or a new significance to their left or above
// the column) | the rows that are significant or past the block << 2 |
// a new significance just above them << 4 | the next 4 SigProp bits << 5:
// the rows made significant | their signs << 2 | the bits read << 4.
__device__ __forceinline__ void build_tables(const int* lut_g, int lut_n,
                                             int symb, int pxor, int* tab)
{
    for (int i = block_thread(); i < lut_n + 768; i += block_threads()) {
        if (i >= lut_n + 256) {
            const int j = i - lut_n - 256;
            const int cand = j & 3, blk = (j >> 2) & 3, sb = j >> 5;
            int prev = (j >> 4) & 1, pos = 0, nw = 0, sg = 0;
            for (int r = 0; r < 2; r++) {
                if (!((blk >> r) & 1) && (((cand >> r) & 1) || prev)) {
                    if ((sb >> pos) & 1) {
                        nw |= 1 << r;
                        sg |= ((sb >> (pos + 1)) & 1) << r;
                        pos += 2;
                    } else {
                        pos += 1;
                    }
                }
                prev = (nw >> r) & 1;
            }
            tab[i] = nw | (sg << 2) | (pos << 4);
            continue;
        }
        if (i < lut_n) {
            const int e = lut_g[i];
            const int sym = e & ((1 << symb) - 1);
            const int rho = sym & 15;
            tab[i] = ((e >> symb) & 7) | (rho << 3) | ((rho & 0xC) ? 128 : 0)
                | (((sym >> 4) & 1) << 8) | (((sym >> 5) & 15) << 9)
                | (((e >> (symb + 3)) & 1) ? HT_BAD : 0);
            continue;
        }
        const int mode = (i - lut_n) >> 6;
        const uint32_t w = (uint32_t)(i - lut_n) & 63u;
        const bool off0 = mode != 2, off1 = mode != 1;
        int l0c, base0, sl0c, l1c, base1, sl1c;
        pclass(w, pxor, l0c, base0, sl0c);
        const int el0 = off0 ? l0c : 0;
        const uint32_t w1 = w >> el0;
        pclass(w1, pxor, l1c, base1, sl1c);
        const bool quirk = mode == 0 && l0c == 3;
        if (quirk) {
            base1 = (int)(w1 & 1u) + 1;
            l1c = 1;
            sl1c = 0;
        }
        const int el1 = off1 ? l1c : 0;
        const int esl0 = off0 ? sl0c : 0, esl1 = off1 ? sl1c : 0;
        tab[i] = (el0 + el1) | (esl0 << 3) | (esl1 << 6)
            | ((off0 ? base0 : 0) << 9) | ((off1 ? base1 : 0) << 12)
            | ((el0 + el1 + esl0 + esl1) << 15);
    }
}

// The quad map entry of a decoded quad (its table entry e): rho | eps_k << 4
// | u << 8.
__device__ __forceinline__ uint16_t map_entry(int e, int u)
{
    return (uint16_t)(((e >> 3) & 15) | (((e >> 9) & 15) << 4) | (u << 8));
}

// Samples i = 0, 2 (dy = 0) or 1, 3 (dy = 1) of the quad with table entry
// e as columns 2 qx, +1.
__device__ __forceinline__ uint64_t rho_row(int e, int dy)
{
    return (uint64_t)(((e >> (3 + dy)) & 1) | ((e >> (4 + dy)) & 2));
}

// Bit i of a 32-bit mask to bit 2 i.
__device__ __forceinline__ uint64_t spread2(uint64_t m)
{
    m = (m | (m << 16)) & 0x0000FFFF0000FFFFull;
    m = (m | (m << 8)) & 0x00FF00FF00FF00FFull;
    m = (m | (m << 4)) & 0x0F0F0F0F0F0F0F0Full;
    m = (m | (m << 2)) & 0x3333333333333333ull;
    return (m | (m << 1)) & 0x5555555555555555ull;
}

// The chain's state between quad rows.
struct Chain {
    Reader mel, vlc;
    MelState m;
    uint64_t ab, bl;          // the quad row above: bit qx set where its
    //                           bottom samples (rho & 0xA) or its
    //                           bottom-left sample (rho & 2) are significant
};

// The chain warp's decode of quad row g (INITIAL: g = 0) into the quad
// map.  vt: the CxtVLC table of the row's family, ut: the UVLC table.
// Returns false at an invalid codeword, with the row's quads from the
// failing pair on zeroed.
template <bool INITIAL>
__device__ __forceinline__ bool chain_row(Chain& c, int g, int gw,
                                          t1_saddr vt, t1_saddr ut,
                                          uint16_t* map)
{
    // context bits 1 and 2 of every quad from the row above, two bits a
    // quad, in place for a table index (ctx << 7) after << 8
    uint64_t ca = spread2(c.ab) | (spread2(c.bl >> 1) << 1);
    uint64_t nab = 0, nbl = 0;
    int left = 0;                    // bit 7: the left quad's rho & 0xC
    for (int qx0 = 0; qx0 < gw; qx0 += 2) {
        const int qx1 = qx0 + 1;
        const bool has1 = qx1 < gw;
        const int ca0 = (int)(ca & 3) << 8, ca1 = (int)(ca & 12) << 6;
        ca >>= 4;
        // the pair's VLC bits: two CxtVLC codewords (<= 7 bits each) and
        // its UVLC (<= 16 bits without an escape) fit one peek
        const uint32_t v = rd_peek(c.vlc);
        int used = 0;
        // MEL significance event (context-0 quads) + CxtVLC symbol
        int e0 = 0, e1 = 0;
        if ((left | ca0) || mel_event(c.m, c.mel)) {
            e0 = t1_lds32(vt + 4 * (left | ca0 | (int)(v & 0x7Fu)));
            used = e0 & 7;
        }
        if (has1 && (((e0 & 128) | ca1) || mel_event(c.m, c.mel))) {
            e1 = t1_lds32(vt + 4 * ((e0 & 128) | ca1
                                    | (int)((v >> used) & 0x7Fu)));
            used += e1 & 7;
        }
        // the pair's UVLC (both u_off in the initial row: its MEL event
        // adds 2 to both u, or selects mode 0)
        const int off = ((e0 >> 8) & 1) | ((e1 >> 7) & 2);
        int u0 = 0, u1 = 0, add = 0, ue = 0;
        uint32_t sfx = 0;
        if (off) {
            int mode = off;
            if (INITIAL && off == 3) {
                if (mel_event(c.m, c.mel))
                    add = 2;
                else
                    mode = 0;
            }
            const uint32_t wv = v >> used;
            ue = t1_lds32(ut + 4 * ((mode << 6) | (int)(wv & 63u)));
            sfx = wv >> (ue & 7);
            const int esl0 = (ue >> 3) & 7, esl1 = (ue >> 6) & 7;
            u0 = ((ue >> 9) & 7) + (int)(sfx & ((1u << esl0) - 1u)) + add;
            u1 = ((ue >> 12) & 7)
                + (int)((sfx >> esl0) & ((1u << esl1) - 1u)) + add;
            used += ue >> 15;
        }
        rd_skip(c.vlc, used);
        // the rare cases, tested once the reader has moved on (off the
        // chain's critical path): an invalid codeword (the scalar decoder
        // gives up before the pair's UVLC), and a UVLC escape: a suffix
        // reads u = 36 only as a 5-bit suffix of 31, which the escape's
        // 5 bits follow (t1ht.scalar._read_u_pair `val`)
        if ((e0 | e1) & HT_BAD) {
            for (int qx = qx0; qx < gw; qx++)
                map[g * HT_MAX_GW + qx] = 0;
            return false;
        }
        if (u0 == 36 + add || u1 == 36 + add) {
            const int esl1 = (ue >> 6) & 7;
            if (u0 == 36 + add) {
                // the first suffix escapes: the table took its 5 bits (in
                // the peek: <= 14 + 6 + 5 + 5 bits) as the second suffix,
                // which follows them
                u0 = 36 + (int)((sfx >> 5) & 31u) + add;
                rd_skip(c.vlc, 5 - esl1);
                u1 = uvlc_tail(c.vlc, (ue >> 12) & 7, esl1) + add;
            } else {
                u1 = 36 + (int)(rd_peek(c.vlc) & 31u) + add;
                rd_skip(c.vlc, 5);
            }
        }
        map[g * HT_MAX_GW + qx0] = map_entry(e0, u0);
        if (has1)
            map[g * HT_MAX_GW + qx1] = map_entry(e1, u1);
        nab |= (uint64_t)((e0 & 0x50) != 0) << qx0
            | (uint64_t)((e1 & 0x50) != 0) << qx1;
        nbl |= (uint64_t)((e0 >> 4) & 1) << qx0
            | (uint64_t)((e1 >> 4) & 1) << qx1;
        left = e1 & 128;
    }
    c.ab = nab;
    c.bl = nbl;
    return true;
}

// The chain warp: the MEL, CxtVLC and UVLC decode of every quad of the
// w x h block into the quad map, quad row by quad row, each finished row
// counted at done[0].  At an invalid codeword the chain notes its quad row
// at done[1] (HT_NO_ROW until then) and counts HT_ROWS_ALL.  tab: the
// CTA's decode tables (build_tables).
__device__ __forceinline__ void cleanup_chain(const uint8_t* mel_row,
                                              int lmel,
                                              const uint8_t* vlc_row,
                                              int lvlc, int w, int h,
                                              const int* tab, int lut_n,
                                              int nfam, uint16_t* map,
                                              int* done)
{
    Chain c;
    rd_init(c.mel, mel_row, lmel);
    rd_init(c.vlc, vlc_row, lvlc);
    c.m.k = c.m.run = c.m.pend = 0;
    c.ab = c.bl = 0;
    done[1] = HT_NO_ROW;
    const t1_saddr vt = t1_smem(tab), ut = vt + 4 * lut_n;
    const int gw = (w + 1) >> 1, gh = (h + 1) >> 1;
    int g = 0;
    if (chain_row<true>(c, 0, gw, vt + (nfam == 2 ? 4 * (HT_N_CTX << 7) : 0),
                        ut, map)) {
        t1_publish(done, 1);
        for (g = 1; g < gh; g++) {
            if (!chain_row<false>(c, g, gw, vt, ut, map))
                break;
            t1_publish(done, g + 1);
        }
        if (g == gh)
            return;
    }
    done[1] = g;
    t1_publish(done, HT_ROWS_ALL);
}

// The cleanup significance rows y_from .. y_to - 1 of the w x h block from
// its quad map, by the whole warp: row y as the 32-bit words cs[2 y]
// (columns 0..31) and cs[2 y + 1], zero past w (cs zero on entry).
__device__ __forceinline__ void cs_rows(const uint16_t* map, int w,
                                        int y_from, int y_to, uint32_t* cs)
{
    const int gw = (w + 1) >> 1;
    warp_for((y_to - y_from) * gw, [&](int i) {
        const int dy = i / gw, qx = i - dy * gw, y = y_from + dy;
        const int rho = map[(y >> 1) * HT_MAX_GW + qx] & 15;
        uint32_t b = (uint32_t)rho_row(rho << 3, y & 1);
        if (2 * qx + 1 >= w)
            b &= 1u;
        if (b)
            warp_or(cs + 2 * y + (qx >> 4), b << ((2 * qx) & 31));
    });
}

// Stripe sx's column bytes, by the whole warp, from the cleanup
// significance rows 4 sx - 1 .. 4 sx + 4 and the news bytes of the stripe
// above (nabove, nullptr for the first): cols[x] = the rows that have a
// significant neighbour, in the cleanup significance or among the row
// above's new significance, and are not significant themselves | the
// rows that are, or lie past h, << 4; the columns with such a row in
// stmask[0], stmask[1] (zero on entry); and the stripe's news bytes zeroed.
__device__ __forceinline__ void stripe_cols(const uint32_t* cs, int w, int h,
                                            int sx, const uint8_t* nabove,
                                            uint8_t* cols, uint32_t* stmask,
                                            uint8_t* news)
{
    const uint64_t* row = reinterpret_cast<const uint64_t*>(cs);
    const int y0 = 4 * sx, nr = min(4, h - y0);
    warp_for(64, [&](int x) { news[x] = 0; });
    warp_for(w, [&](int x) {
        int st = 0, blk = (0xF << nr) & 15;
        // the row above's news at x - 1 .. x + 1 (its row 3)
        const int na = nabove && (((x > 0 ? nabove[x - 1] : 0) | nabove[x]
                                   | (x + 1 < w ? nabove[x + 1] : 0)) & 8);
        for (int r = 0; r < nr; r++) {
            const uint64_t own = row[y0 + r];
            const uint64_t up = y0 + r > 0 ? row[y0 + r - 1] : 0;
            const uint64_t dn = y0 + r + 1 < h ? row[y0 + r + 1] : 0;
            const uint64_t x3 = (x > 0 ? (up | own | dn) >> (x - 1)
                                       : (up | own | dn) << 1) & 7;
            if ((own >> x) & 1)
                blk |= 1 << r;
            else if (x3 || (r == 0 && na))
                st |= 1 << r;
        }
        cols[x] = (uint8_t)(st | (blk << 4));
        if (st)
            warp_or(stmask + (x >> 5), 1u << (x & 31));
    });
}

// HT SigProp of a stripe (the causal order of grok_tpu/t1ht/scalar.py:
// column by column, top to bottom) from its column bytes cb and column
// mask stm (stripe_cols): news[x] = the rows of column x that it makes
// significant | their signs << 4.  A sample is a candidate through the
// cleanup significance around it or the row above's new significance
// (both in the column bytes), or through a new significance in the column
// to its left or just above it; so only the columns with a candidate of
// the first kind, and the right neighbours of columns with a new
// significance, are visited, two rows at a time by the SigProp table spt.
__device__ __forceinline__ void sp_stripe(Reader& sp, int w, t1_saddr cb,
                                          uint64_t stm, t1_saddr spt,
                                          uint8_t* news)
{
    uint64_t pend = stm;
    int px = -2, pnew = 0;           // the last visited column, its news
    while (pend) {
        const int x = t1_ffs64(pend) - 1;
        pend &= pend - 1;
        const int c = t1_lds8(cb + x);
        const int blk = c >> 4;
        const int nl = px == x - 1 ? pnew : 0;
        const int cand = ((c & 15) | nl | (nl << 1) | (nl >> 1)) & ~blk;
        int nwc = 0;
        if (cand) {                  // rows 0, 1, then 2, 3 by the table
            const uint32_t b = rd_peek(sp);
            const int e1 = t1_lds32(spt + 4 * ((cand & 3) | ((blk & 3) << 2)
                                               | (int)((b & 15u) << 5)));
            const int e2 = t1_lds32(
                spt + 4 * (((cand >> 2) & 3) | (blk & 12) | ((e1 & 2) << 3)
                           | (int)(((b >> (e1 >> 4)) & 15u) << 5)));
            nwc = (e1 & 3) | ((e2 & 3) << 2);
            rd_skip(sp, (e1 >> 4) + (e2 >> 4));
            if (nwc) {
                news[x] = (uint8_t)(nwc | (((e1 >> 2) & 3) << 4)
                                    | ((e2 & 12) << 4));
                if (x + 1 < w)
                    pend |= 1ull << (x + 1);
            }
        }
        px = x;
        pnew = nwc;
    }
}

// The second warp of a valid lane: stripe by stripe, once the chain warp
// has counted the quad rows it needs at done[0], (K2) the stripe's cleanup
// significance rows, column bytes and SigProp walk, then the MagSgn steps
// of its two quad rows (one thread per quad: kappa from the ebot its own
// thread found in the row above, U and the bit count, a warp scan for the
// offset, the samples from five aligned words loaded at once, MagRef's bit
// of a cleanup-significant sample at the count of cleanup-significant
// samples before it in the stripe order, and the quad's 2 x 2 outputs);
// last, the rows below the block.  Every element of the lane's (H, W)
// block o is written.  ref (K2, 0 < p < 32, npass >= 2): SigProp, and
// MagRef with npass >= 3, from the rows sp_row and mr_row.  It stops past
// the chain's failing quad row (done[1]) or at a U over 40, zeroes the
// block and returns the lane's error code.
__device__ __forceinline__ int consume_lane(const uint8_t* ms_row, int lms,
                                            int p, int w, int h,
                                            const int* tab, int lut_n,
                                            unsigned char* ws, int* o,
                                            int W, int H, bool ref,
                                            const uint8_t* sp_row, int lsp,
                                            const uint8_t* mr_row, int lmr,
                                            int np)
{
    const int* done = reinterpret_cast<const int*>(ws);
    const uint16_t* map = reinterpret_cast<const uint16_t*>(ws + 16);
    uint64_t* cs = reinterpret_cast<uint64_t*>(ws + HT_CLN_BYTES);
    uint32_t* stmask = reinterpret_cast<uint32_t*>(cs + 64);
    uint8_t* cols = reinterpret_cast<uint8_t*>(stmask + 32);
    uint8_t* news = cols + 16 * 64;
    uint32_t* cs32 = reinterpret_cast<uint32_t*>(cs);
    const bool mref = ref && np >= 3;
    row_prefetch(ms_row, lms);
    if (mref)
        row_prefetch(mr_row, lmr);
    if (ref)
        warp_for(2 * 64 + 32, [&](int i) {
            (i < 128 ? cs32 : stmask - 128)[i] = 0;
        });
    warp_sync();

    const int gw = (w + 1) >> 1, gh = (h + 1) >> 1;
    const int p1 = p + 1;
    const uint32_t half = p > 0 ? shl32(1u, p) : 0u;
    const uint32_t half_bp = p > 1 ? shl32(1u, p - 1) : 0u;
    const uint32_t mag_new = half + half_bp;
    const Row rms = row_at(ms_row, lms);
    const Row rmr = row_at(mref ? mr_row : ms_row, mref ? lmr : 0);
    Reader sp;
    if (ref)
        rd_init(sp, sp_row, lsp);
    WarpReg<int> eb, len, ue, big;
    warp_each([&](int t) { eb[t] = big[t] = 0; });
    int base = 0;                    // MagSgn bits before the quad row
    int mr_base = 0;                 // MagRef bits before the stripe
    int cs_done = 0;                 // cleanup significance rows built
    uint64_t c4[4] = { 0, 0, 0, 0 }; // the stripe's
    bool uerr = false;               // a U over 40
    // the MagSgn step of quad row g
    auto quad_row = [&](int g) {
        // 1. kappa, U and the quad's MagSgn bit count; a U over 40 counts
        // 1 << 20 bits, which the scan's total shows
        warp_each([&](int t) {
            len[t] = 0;
            ue[t] = 0;
            if (t >= gw)
                return;
            const int e = map[g * HT_MAX_GW + t];
            const int rho = e & 15;
            if (!rho)
                return;
            const int kappa = (rho & (rho - 1)) ? max(1, eb[t] - 1) : 1;
            const int U = kappa + (e >> 8);
            if (U > HT_U_MAX) {
                len[t] = 1 << 20;
                return;
            }
            const int ek = (e >> 4) & rho;
            len[t] = U * t1_popc64((uint64_t)rho) - t1_popc64((uint64_t)ek);
            ue[t] = rho | (ek << 4) | (U << 8);
            big[t] |= U + p >= 31;
        });
        const int tot = warp_scan(len);
        if (tot >= 1 << 20) {
            uerr = true;
            return;
        }
        const uint8_t* nb = news + 64 * (g >> 1);   // the stripe's news
        // 2. the quad's samples, refined, and its 2 x 2 outputs
        warp_each([&](int t) {
            const int x0 = 2 * t;
            if (x0 >= W)
                return;
            const int rho = ue[t] & 15, ek = (ue[t] >> 4) & 15;
            const int U = ue[t] >> 8;
            uint32_t m[4] = { 0u, 0u, 0u, 0u };   // magnitudes
            int sg = 0;                           // signs
            int ebot = 0;
            if (rho && U <= 25) {
                Window x = win_at(rms, base + len[t]);
#pragma unroll
                for (int i = 0; i < 4; i++) {
                    if (!((rho >> i) & 1))
                        continue;
                    const int k_i = (ek >> i) & 1;
                    const uint32_t full = win_take(x, U - k_i)
                        | ((uint32_t)k_i << (U - 1));
                    m[i] = shl32((full >> 1) + 1u, p1) + half;
                    sg |= (int)(full & 1u) << i;
                    if (i & 1)
                        ebot = max(ebot, 32 - t1_clz(full));
                }
            } else if (rho) {                     // U of 26 .. 40
                int pos = base + len[t];
                for (int i = 0; i < 4; i++) {
                    if (!((rho >> i) & 1))
                        continue;
                    const int k_i = (ek >> i) & 1;
                    const uint64_t full = row_bits(rms, pos, U - k_i)
                        | ((uint64_t)k_i << (U - 1));
                    pos += U - k_i;
                    const uint64_t vi = (full >> 1) + 1u;
                    m[i] = (uint32_t)(p1 < 64 ? vi << p1 : 0u) + half;
                    sg |= (int)(full & 1u) << i;
                    if (i & 1)
                        ebot = max(ebot, bitlen64(full));
                }
            }
            eb[t] = ebot;
            if (ref) {
                // quad scan order n0=(0,0) n1=(1,0) n2=(0,1) n3=(1,1);
                // each column's 4-bit stripe mask, its own two rows, and
                // its MagRef bits from the count of cleanup-significant
                // samples before its first own one
                const int ys = (g & 1) << 1;        // row 0 or 2
                const uint64_t lo = (1ull << x0) - 1ull;
                int col[2], own[2], pos[2];
                const int before = mr_base + t1_popc64(c4[0] & lo)
                    + t1_popc64(c4[1] & lo) + t1_popc64(c4[2] & lo)
                    + t1_popc64(c4[3] & lo);
#pragma unroll
                for (int dx = 0; dx < 2; dx++) {
                    const int x = x0 + dx;       // cs is 0 past w
                    col[dx] = (int)(((c4[0] >> x) & 1)
                                    | (((c4[1] >> x) & 1) << 1)
                                    | (((c4[2] >> x) & 1) << 2)
                                    | (((c4[3] >> x) & 1) << 3));
                    own[dx] = (col[dx] >> ys) & 3;
                    pos[dx] = before + (dx ? t1_popc64((uint64_t)col[0]) : 0)
                        + t1_popc64((uint64_t)(col[dx] & ((1 << ys) - 1)));
                }
                uint32_t bits[2] = { 0u, 0u };
                if (mref) {
                    uint32_t raw[2][2];
#pragma unroll
                    for (int dx = 0; dx < 2; dx++) {
                        const int a = pos[dx] + 8 * rmr.mis;
                        raw[dx][0] = own[dx] ? row_raw(rmr, a >> 5) : 0u;
                        raw[dx][1] = own[dx] ? row_raw(rmr, (a >> 5) + 1)
                                             : 0u;
                    }
#pragma unroll
                    for (int dx = 0; dx < 2; dx++) {
                        const int a = pos[dx] + 8 * rmr.mis;
                        bits[dx] = (uint32_t)((row_word(rmr, a >> 5,
                                                        raw[dx][0])
                                               | ((uint64_t)row_word(
                                                      rmr, (a >> 5) + 1,
                                                      raw[dx][1]) << 32))
                                              >> (a & 31));
                    }
                }
#pragma unroll
                for (int dx = 0; dx < 2; dx++) {
                    const int x = x0 + dx;
#pragma unroll
                    for (int dy = 0; dy < 2; dy++) {
                        const int i = 2 * dx + dy;
                        if ((own[dx] >> dy) & 1) {
                            if (mref) {
                                // the magnitude modulo 2^32, its sign
                                // apart, as the scalar's int64 one
                                const uint32_t vq = shr32(m[i] - half, p + 1);
                                m[i] = shl32((vq << 1) | (bits[dx] & 1u), p)
                                    + half_bp;
                                bits[dx] >>= 1;
                            }
                        } else if ((nb[x] >> (ys + dy)) & 1) {
                            m[i] = mag_new;
                            sg = (sg & ~(1 << i))
                                | (((nb[x] >> (4 + ys + dy)) & 1) << i);
                        }
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < 4; i++) {
                const int x = x0 + (i >> 1), y = 2 * g + (i & 1);
                if (x < W && y < H)
                    o[y * W + x] = x < w && y < h
                        ? ((sg >> i) & 1 ? (int)(0u - m[i]) : (int)m[i])
                        : 0;
            }
        });
        base += tot;
    };
    int crow = HT_NO_ROW;            // the chain's failing quad row
    for (int y0 = 0; y0 < h && !uerr; y0 += 4) {
        const int sx = y0 >> 2, g_end = min(2 * sx + 2, gh);
        t1_wait_ge(done, min(gh, ref ? 2 * sx + 3 : g_end));
        {
            // one reading for the whole warp
            WarpReg<int> cr;
            warp_each([&](int t) {
                cr[t] = *reinterpret_cast<const volatile int*>(done + 1);
            });
            crow = warp_shfl(cr, 0);
        }
        if (crow != HT_NO_ROW)
            ref = false;             // the lane is zeroed: no SigProp
        if (ref) {
            const int y_to = min(y0 + 5, h);
            cs_rows(map, w, cs_done, y_to, cs32);
            cs_done = y_to;
            warp_sync();
            stripe_cols(cs32, w, h, sx, sx ? news + 64 * (sx - 1) : nullptr,
                        cols + 64 * sx, stmask + 2 * sx, news + 64 * sx);
            warp_sync();
            sp_stripe(sp, w, t1_smem(cols + 64 * sx),
                      reinterpret_cast<const uint64_t*>(stmask)[sx],
                      t1_smem(tab + lut_n + 256), news + 64 * sx);
            warp_sync();
            mr_base += t1_popc64(c4[0]) + t1_popc64(c4[1])
                + t1_popc64(c4[2]) + t1_popc64(c4[3]);
#pragma unroll
            for (int r = 0; r < 4; r++)
                c4[r] = y0 + r < h ? cs[y0 + r] : 0;
        }
        for (int g = 2 * sx; g < g_end && g <= crow && !uerr; g++)
            quad_row(g);
        if (g_end > crow)            // past the chain's failing row
            break;
    }
    if (uerr || crow != HT_NO_ROW) {
        warp_sync();
        warp_for(W * H, [&](int i) { o[i] = 0; });
        return uerr ? HT_ERR_EXP : HT_ERR_VLC;
    }
    // the rows below the block's quad rows
    const int y1 = 2 * gh;
    if (y1 < H)
        warp_for((H - y1) * W, [&](int i) { o[y1 * W + i] = 0; });
    return warp_ballot(big) ? HT_MARK_I64 : 0;
}

// Lane `lane` of the batch, its warp `role` (0: the chain, 1: the rest;
// the host runs role 0, then role 1): its parameters clamped as the
// contract says, then its decode, or zeros for an invalid or empty lane,
// and (role 1) its error code at err[lane].  tab: the CTA's decode tables
// (build_tables); ws: the lane's HT_CLN_BYTES (HT_REF_BYTES for K2) of
// shared memory, its first word 0.  sp == nullptr: K1; else K2 with the
// lane's SigProp and MagRef rows and pass count.
__device__ __forceinline__ void decode_one(
    int role, const int* tab, int lut_n, int nfam, unsigned char* ws,
    int lane, const uint8_t* ms, int lms, const uint8_t* mel, int lmel,
    const uint8_t* vlc, int lvlc, const int* pv, const int* wv,
    const int* hv, const int* valid, int* out, int W, int H,
    const uint8_t* sp, int lsp, const uint8_t* mr, int lmr, const int* npv,
    int* err)
{
    const int w = min(wv[lane], W), h = min(hv[lane], H);
    int* o = out + (size_t)lane * W * H;
    if (valid[lane] != 1 || w <= 0 || h <= 0) {
        if (role) {
            warp_for(W * H, [&](int i) { o[i] = 0; });
            if (warp_leader())
                err[lane] = 0;
        }
        return;
    }
    if (role == 0) {
        cleanup_chain(mel + (size_t)lane * lmel, lmel,
                      vlc + (size_t)lane * lvlc, lvlc, w, h, tab, lut_n,
                      nfam, reinterpret_cast<uint16_t*>(ws + 16),
                      reinterpret_cast<int*>(ws));
        return;
    }
    const int p = pv[lane];
    const int np = sp ? npv[lane] : 1;
    const bool ref = sp && np >= 2 && p > 0 && p < 32;
    const int code = consume_lane(
        ms + (size_t)lane * lms, lms, p, w, h, tab, lut_n, ws, o, W, H, ref,
        ref ? sp + (size_t)lane * lsp : nullptr, lsp,
        ref ? mr + (size_t)lane * lmr : nullptr, lmr, np);
    if (warp_leader())
        err[lane] = code;
}

// ---- wide lanes: one warp per code-block, its first thread serial -------

// A wide lane's shared memory: the above row's rho and ebot per quad, then
// the block's significance and sign bits (W x H each).
__host__ __device__ __forceinline__ int ht_wide_bytes(int W, int H)
{
    const int gw = (W + 1) >> 1;
    const int bits = (W * H + 127) / 128 * 16;
    return (2 * gw + 15) / 16 * 16 + 2 * bits;
}

__device__ __forceinline__ int vlc_bit(Reader& r)
{
    const int b = (int)(rd_peek(r) & 1u);
    rd_skip(r, 1);
    return b;
}

// A UVLC prefix (polarity pxor applied): whether it is 3 bits long, its
// base and its suffix length (t1ht.scalar._read_u_pair `pfx`).
__device__ __forceinline__ void uvlc_prefix(Reader& r, int pxor, int& l3,
                                            int& base, int& sl)
{
    l3 = 0;
    sl = 0;
    if ((vlc_bit(r) ^ (pxor & 1)) == 0) {
        base = 1;
    } else if ((vlc_bit(r) ^ ((pxor >> 1) & 1)) == 0) {
        base = 2;
    } else {
        l3 = 1;
        const bool b = (vlc_bit(r) ^ ((pxor >> 2) & 1)) == 0;
        base = b ? 3 : 5;
        sl = b ? 1 : 5;
    }
}

__device__ __forceinline__ bool bit_at(const uint32_t* m, int i)
{
    return (m[i >> 5] >> (i & 31)) & 1u;
}

__device__ __forceinline__ void bit_set(uint32_t* m, int i, bool v)
{
    m[i >> 5] = (m[i >> 5] & ~(1u << (i & 31))) | ((uint32_t)v << (i & 31));
}

// The serial decode of a wide lane by one thread, in the order of
// grok_tpu/t1ht/scalar.py `ht_decode_block`: the cleanup's magnitudes
// (modulo 2^32 for an int output T, 2^64 for a long long one) into o, row
// stride W, with their significance and sign bits, then (ref) MagRef on
// the cleanup-significant samples and SigProp, each in the stripe scan.
// Returns the lane's error code, or HT_MARK_I64 for a lane that decodes
// with a quad of U + p >= 31.
template <class T>
__device__ __forceinline__ int wide_serial(
    const t1_saddr vt0, const t1_saddr vti, int pxor, const uint8_t* ms_row,
    int lms, const uint8_t* mel_row, int lmel, const uint8_t* vlc_row,
    int lvlc, int p, int w, int h, int W, uint8_t* rrow, uint8_t* erow,
    uint32_t* sig, uint32_t* neg, T* o, bool ref, const uint8_t* sp_row,
    int lsp, const uint8_t* mr_row, int lmr, int np)
{
    // the magnitude word: 32 bits for int output, 64 for long long
    typedef typename std::conditional<sizeof(T) == 8, uint64_t,
                                      uint32_t>::type M;
    Reader mel, vlc;
    rd_init(mel, mel_row, lmel);
    rd_init(vlc, vlc_row, lvlc);
    MelState ms = { 0, 0, 0 };
    const Row rms = row_at(ms_row, lms);
    int msp = 0;
    const int gw = (w + 1) >> 1, gh = (h + 1) >> 1, p1 = p + 1;
    const M half = p > 0 ? shlw((M)1, p) : (M)0;
    const M half_bp = p > 1 ? shlw((M)1, p - 1) : (M)0;
    bool big = false;                // a quad of U + p >= 31
    for (int g = 0; g < gh; g++) {
        const t1_saddr vt = g ? vt0 : vti;
        int left = 0;                // rho of the quad to the left
        for (int qx0 = 0; qx0 < gw; qx0 += 2) {
            const int nq = min(2, gw - qx0);
            int e[2] = { 0, 0 };
            for (int j = 0; j < nq; j++) {
                const int qx = qx0 + j;
                const int ra = g ? rrow[qx] : 0;
                const int rar = g && qx + 1 < gw ? rrow[qx + 1] : 0;
                const int c = ((left & 0xC) != 0) | (((ra & 0xA) != 0) << 1)
                    | (((rar & 2) != 0) << 2);
                if (c || mel_event(ms, mel)) {
                    e[j] = t1_lds32(vt + 4 * ((c << 7)
                                              | (int)(rd_peek(vlc) & 0x7Fu)));
                    if (e[j] & HT_BAD)
                        return HT_ERR_VLC;
                    rd_skip(vlc, e[j] & 7);
                }
                left = (e[j] >> 3) & 15;
                rrow[qx] = (uint8_t)left;    // the row above is read first
            }
            // the pair's UVLC (t1ht.scalar._read_u_pair)
            const bool off0 = (e[0] >> 8) & 1;
            const bool off1 = nq > 1 && ((e[1] >> 8) & 1);
            int u[2] = { 0, 0 };
            int l0, b0, s0, l1, b1, s1;
            if (off0 && off1) {
                int add = 0;
                if (g == 0 && mel_event(ms, mel)) {
                    add = 2;
                    uvlc_prefix(vlc, pxor, l0, b0, s0);
                    uvlc_prefix(vlc, pxor, l1, b1, s1);
                } else {
                    uvlc_prefix(vlc, pxor, l0, b0, s0);
                    if (g == 0 && l0) {      // u0 >= 3 => u1 <= 2: one bit
                        b1 = vlc_bit(vlc) + 1;
                        s1 = 0;
                    } else {
                        uvlc_prefix(vlc, pxor, l1, b1, s1);
                    }
                }
                u[0] = uvlc_tail(vlc, b0, s0) + add;
                u[1] = uvlc_tail(vlc, b1, s1) + add;
            } else if (off0 || off1) {
                uvlc_prefix(vlc, pxor, l0, b0, s0);
                u[off0 ? 0 : 1] = uvlc_tail(vlc, b0, s0);
            }
            // the quads' MagSgn samples
            for (int j = 0; j < nq; j++) {
                const int qx = qx0 + j, rho = (e[j] >> 3) & 15;
                const int eb_above = g ? erow[qx] : 0;
                erow[qx] = 0;
                if (!rho)
                    continue;
                const int kappa = (rho & (rho - 1)) ? max(1, eb_above - 1)
                                                    : 1;
                const int U = kappa + u[j];
                if (U > HT_U_MAX)
                    return HT_ERR_EXP;
                big |= U + p >= 31;
                const int ek = (e[j] >> 9) & 15;
                int ebot = 0;
                for (int i = 0; i < 4; i++) {
                    if (!((rho >> i) & 1))
                        continue;
                    const int k = (ek >> i) & 1;
                    const uint64_t full = row_bits(rms, msp, U - k)
                        | ((uint64_t)k << (U - 1));
                    msp += U - k;
                    if (i & 1)
                        ebot = max(ebot, bitlen64(full));
                    const int y = 2 * g + (i & 1), x = 2 * qx + (i >> 1);
                    if (y < h && x < w) {
                        const uint64_t vi = (full >> 1) + 1u;
                        o[y * W + x] = (T)(M)((M)(p1 < 64 ? vi << p1 : 0u)
                                              + half);
                        bit_set(sig, y * W + x, true);
                        bit_set(neg, y * W + x, full & 1u);
                    }
                }
                erow[qx] = (uint8_t)ebot;
            }
        }
    }
    const int done = big ? HT_MARK_I64 : 0;
    if (!ref)
        return done;
    // MagRef first: it refines only the cleanup-significant samples,
    // which SigProp never touches, from a stream of its own
    if (np >= 3) {
        const Row rmr = row_at(mr_row, lmr);
        int pos = 0;
        for (int y0 = 0; y0 < h; y0 += 4)
            for (int x = 0; x < w; x++)
                for (int y = y0; y < min(y0 + 4, h); y++) {
                    if (!bit_at(sig, y * W + x))
                        continue;
                    const M b = (M)row_bits(rmr, pos++, 1);
                    const M m = (M)o[y * W + x];
                    o[y * W + x] = (T)(M)(shlw((M)(shrw((M)(m - half), p + 1)
                                                   << 1) | b, p) + half_bp);
                }
    }
    // SigProp: the significance grows as the scan goes
    const Row rsp = row_at(sp_row, lsp);
    int pos = 0;
    for (int y0 = 0; y0 < h; y0 += 4)
        for (int x = 0; x < w; x++)
            for (int y = y0; y < min(y0 + 4, h); y++) {
                if (bit_at(sig, y * W + x))
                    continue;
                bool nbr = false;
                for (int yy = max(y - 1, 0); yy <= min(y + 1, h - 1); yy++)
                    for (int xx = max(x - 1, 0); xx <= min(x + 1, w - 1);
                         xx++)
                        nbr |= bit_at(sig, yy * W + xx);
                if (!nbr)
                    continue;
                if (!row_bits(rsp, pos++, 1))
                    continue;
                bit_set(neg, y * W + x, row_bits(rsp, pos++, 1) != 0);
                bit_set(sig, y * W + x, true);
                o[y * W + x] = (T)(M)(half + half_bp);
            }
    return done;
}

// A wide lane, run by the whole warp: the block zeroed, its serial decode
// by the first thread, then the signs applied (or zeros for a failed
// lane) and its error code at err[lane].  ws: the lane's
// ht_wide_bytes(W, H) of shared memory.  T: int (K1/K2's output) or long
// long (the int64 re-decode of marked lanes, any lane size).
template <class T>
__device__ __forceinline__ void decode_wide_one(
    const int* tab, int nfam, int pxor, unsigned char* ws, int lane,
    const uint8_t* ms, int lms, const uint8_t* mel, int lmel,
    const uint8_t* vlc, int lvlc, const int* pv, const int* wv,
    const int* hv, const int* valid, T* out, int W, int H,
    const uint8_t* sp, int lsp, const uint8_t* mr, int lmr, const int* npv,
    int* err)
{
    typedef typename std::conditional<sizeof(T) == 8, uint64_t,
                                      uint32_t>::type M;
    const int w = min(wv[lane], W), h = min(hv[lane], H);
    T* o = out + (size_t)lane * W * H;
    const int GW = (W + 1) >> 1, nwords = (W * H + 31) >> 5;
    uint8_t* rrow = ws;
    uint8_t* erow = ws + GW;
    uint32_t* sig = reinterpret_cast<uint32_t*>(ws + (2 * GW + 15) / 16 * 16);
    uint32_t* neg = sig + (W * H + 127) / 128 * 4;
    warp_for(W * H, [&](int i) { o[i] = 0; });
    if (valid[lane] != 1 || w <= 0 || h <= 0) {
        if (warp_leader())
            err[lane] = 0;
        return;
    }
    warp_for(nwords, [&](int i) { sig[i] = neg[i] = 0; });
    warp_sync();
    const int p = pv[lane];
    const int np = sp ? npv[lane] : 1;
    const bool ref = sp && np >= 2 && p > 0 && p < 32;
    WarpReg<int> code;
    warp_each([&](int t) { code[t] = 0; });
    if (warp_leader()) {
        const t1_saddr vt0 = t1_smem(tab);
        code[0] = wide_serial<T>(
            vt0, vt0 + (nfam == 2 ? 4 * (HT_N_CTX << 7) : 0), pxor,
            ms + (size_t)lane * lms, lms, mel + (size_t)lane * lmel, lmel,
            vlc + (size_t)lane * lvlc, lvlc, p, w, h, W, rrow, erow, sig,
            neg, o, ref, ref ? sp + (size_t)lane * lsp : nullptr, lsp,
            ref ? mr + (size_t)lane * lmr : nullptr, lmr, np);
    }
    warp_sync();
    const int c = warp_shfl(code, 0);
    warp_for(W * H, [&](int i) {
        if (c & (HT_ERR_VLC | HT_ERR_EXP))
            o[i] = 0;
        else if (bit_at(neg, i))
            o[i] = (T)(M)((M)0 - (M)o[i]);
    });
    if (warp_leader())
        err[lane] = c;
}

#ifdef __CUDACC__

template <bool REFINE>
__global__ void __launch_bounds__(HT_LANES * 64, 1)
ht_decode_kernel(const uint8_t* __restrict__ ms, int lms,
                 const uint8_t* __restrict__ mel, int lmel,
                 const uint8_t* __restrict__ vlc, int lvlc,
                 const int* __restrict__ pv, const int* __restrict__ wv,
                 const int* __restrict__ hv, const int* __restrict__ valid,
                 const int* __restrict__ lut_g, int lut_n, int symb,
                 int nfam, int pxor, int* __restrict__ out, int nl, int W,
                 int H, const uint8_t* __restrict__ sp, int lsp,
                 const uint8_t* __restrict__ mr, int lmr,
                 const int* __restrict__ npv, int* __restrict__ err)
{
    __shared__ int tab[HT_TAB_MAX];
    extern __shared__ __align__(16) unsigned char smem[];
    const int bytes = REFINE ? HT_REF_BYTES : HT_CLN_BYTES;
    build_tables(lut_g, lut_n, symb, pxor, tab);
    if (threadIdx.x < HT_LANES)          // the chains' progress counters
        *reinterpret_cast<int*>(smem + threadIdx.x * bytes) = 0;
    __syncthreads();
    const int wi = threadIdx.x >> 5;
    const int lane = blockIdx.x * HT_LANES + (wi >> 1);
    if (lane >= nl)
        return;
    decode_one(wi & 1, tab, lut_n, nfam, smem + (wi >> 1) * bytes, lane, ms,
               lms, mel, lmel, vlc, lvlc, pv, wv, hv, valid, out, W, H,
               REFINE ? sp : nullptr, lsp, mr, lmr, npv, err);
}

template <bool REFINE, class T>
__global__ void __launch_bounds__(HT_WIDE_WARPS * 32)
ht_decode_wide_kernel(const uint8_t* __restrict__ ms, int lms,
                      const uint8_t* __restrict__ mel, int lmel,
                      const uint8_t* __restrict__ vlc, int lvlc,
                      const int* __restrict__ pv, const int* __restrict__ wv,
                      const int* __restrict__ hv,
                      const int* __restrict__ valid,
                      const int* __restrict__ lut_g, int lut_n, int symb,
                      int nfam, int pxor, T* __restrict__ out, int nl,
                      int W, int H, const uint8_t* __restrict__ sp, int lsp,
                      const uint8_t* __restrict__ mr, int lmr,
                      const int* __restrict__ npv, int* __restrict__ err)
{
    __shared__ int tab[HT_TAB_MAX];
    extern __shared__ __align__(16) unsigned char smem[];
    build_tables(lut_g, lut_n, symb, pxor, tab);
    __syncthreads();
    const int wi = threadIdx.x >> 5;
    const int lane = blockIdx.x * HT_WIDE_WARPS + wi;
    if (lane >= nl)
        return;
    decode_wide_one<T>(tab, nfam, pxor, smem + wi * ht_wide_bytes(W, H), lane,
                    ms, lms, mel, lmel, vlc, lvlc, pv, wv, hv, valid, out, W,
                    H, REFINE ? sp : nullptr, lsp, mr, lmr, npv, err);
}

template <bool REFINE, bool I64 = false>
static int launch(const void* ms, int lms, const void* mel, int lmel,
                  const void* vlc, int lvlc, const void* p, const void* w,
                  const void* h, const void* valid, const void* lut,
                  int lut_n, int symb, int nfam, int pxor, void* out, int nl,
                  int W, int H, const void* sp, int lsp, const void* mr,
                  int lmr, const void* npass, void* err, void* stream)
{
    typedef typename std::conditional<I64, long long, int>::type T;
    if (nl <= 0)
        return 0;
    if (lut_n + 768 > HT_TAB_MAX)
        return (int)cudaErrorInvalidValue;
    if (I64 || W > 64 || H > 64) {
        const int blocks = (nl + HT_WIDE_WARPS - 1) / HT_WIDE_WARPS;
        ht_decode_wide_kernel<REFINE, T><<<blocks, HT_WIDE_WARPS * 32,
                                           HT_WIDE_WARPS
                                           * ht_wide_bytes(W, H),
                                           (cudaStream_t)stream>>>(
            (const uint8_t*)ms, lms, (const uint8_t*)mel, lmel,
            (const uint8_t*)vlc, lvlc, (const int*)p, (const int*)w,
            (const int*)h, (const int*)valid, (const int*)lut, lut_n, symb,
            nfam, pxor, (T*)out, nl, W, H, (const uint8_t*)sp, lsp,
            (const uint8_t*)mr, lmr, (const int*)npass, (int*)err);
        return (int)cudaGetLastError();
    }
    const int smem = HT_LANES * (REFINE ? HT_REF_BYTES : HT_CLN_BYTES);
    const int blocks = (nl + HT_LANES - 1) / HT_LANES;
    ht_decode_kernel<REFINE><<<blocks, HT_LANES * 64, smem,
                               (cudaStream_t)stream>>>(
        (const uint8_t*)ms, lms, (const uint8_t*)mel, lmel,
        (const uint8_t*)vlc, lvlc, (const int*)p, (const int*)w,
        (const int*)h, (const int*)valid, (const int*)lut, lut_n, symb, nfam,
        pxor, (int*)out, nl, W, H, (const uint8_t*)sp, lsp,
        (const uint8_t*)mr, lmr, (const int*)npass, (int*)err);
    return (int)cudaGetLastError();
}

// out is written whole: zeros outside each lane's w x h, on invalid lanes
// and on failed ones; err gets each lane's error code.
// Lanes of W or H over 64 take the wide kernel.
extern "C" int grk_ht_decode_cleanup(const void* ms, int ms_len,
                                     const void* mel, int mel_len,
                                     const void* vlc, int vlc_len,
                                     const void* p, const void* w,
                                     const void* h, const void* valid,
                                     const void* lut, int lut_n, int symb,
                                     int nfam, int pxor, void* out, int nl,
                                     int W, int H, void* err, void* stream)
{
    return launch<false>(ms, ms_len, mel, mel_len, vlc, vlc_len, p, w, h,
                         valid, lut, lut_n, symb, nfam, pxor, out, nl, W, H,
                         nullptr, 0, nullptr, 0, nullptr, err, stream);
}

extern "C" int grk_ht_decode_refine(const void* ms, int ms_len,
                                    const void* mel, int mel_len,
                                    const void* vlc, int vlc_len,
                                    const void* p, const void* w,
                                    const void* h, const void* valid,
                                    const void* lut, int lut_n, int symb,
                                    int nfam, int pxor, void* out, int nl,
                                    int W, int H, const void* sp, int sp_len,
                                    const void* mr, int mr_len,
                                    const void* npass, void* err,
                                    void* stream)
{
    return launch<true>(ms, ms_len, mel, mel_len, vlc, vlc_len, p, w, h,
                        valid, lut, lut_n, symb, nfam, pxor, out, nl, W, H,
                        sp, sp_len, mr, mr_len, npass, err, stream);
}

// The int64 re-decode of marked lanes (code HT_MARK_I64): the same
// arguments, out (NL, H, W) int64, every lane through the wide design.
extern "C" int grk_ht_decode_cleanup_i64(const void* ms, int ms_len,
                                         const void* mel, int mel_len,
                                         const void* vlc, int vlc_len,
                                         const void* p, const void* w,
                                         const void* h, const void* valid,
                                         const void* lut, int lut_n,
                                         int symb, int nfam, int pxor,
                                         void* out, int nl, int W, int H,
                                         void* err, void* stream)
{
    return launch<false, true>(ms, ms_len, mel, mel_len, vlc, vlc_len, p, w,
                               h, valid, lut, lut_n, symb, nfam, pxor, out,
                               nl, W, H, nullptr, 0, nullptr, 0, nullptr,
                               err, stream);
}

extern "C" int grk_ht_decode_refine_i64(const void* ms, int ms_len,
                                        const void* mel, int mel_len,
                                        const void* vlc, int vlc_len,
                                        const void* p, const void* w,
                                        const void* h, const void* valid,
                                        const void* lut, int lut_n, int symb,
                                        int nfam, int pxor, void* out, int nl,
                                        int W, int H, const void* sp,
                                        int sp_len, const void* mr,
                                        int mr_len, const void* npass,
                                        void* err, void* stream)
{
    return launch<true, true>(ms, ms_len, mel, mel_len, vlc, vlc_len, p, w,
                              h, valid, lut, lut_n, symb, nfam, pxor, out,
                              nl, W, H, sp, sp_len, mr, mr_len, npass, err,
                              stream);
}

#endif
