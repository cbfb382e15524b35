// HTJ2K (ISO 15444-15) encode of a batch of code-blocks: the cleanup pass
// (kernel K4, `ht_encode_kernel<false>`) and the cleanup followed by the
// HT SigProp and HT MagRef refinement passes (kernel K4r,
// `ht_encode_kernel<true>`).
//
// Replaces the Pallas TPU kernel grok_tpu/ops/pallas_ht_enc.py
// `_ht_encode_jit` (refine=False, reached through `pallas_ht_encode`, and
// the refine=True variant at :722), with the same contract: per lane,
// mneg = (magnitude << 1) | sign as an (NL, H, W) int32 block, the
// cleanup plane p, the block size and a valid flag in; the clean
// LSB-first MagSgn, MEL and VLC sub-streams (and for K4r the SigProp and
// MagRef streams at plane p - 1) and their bit counts out, byte-identical
// to grok_tpu/t1ht/scalar.py `ht_encode_block`, `_encode_sigprop` and
// `_encode_magref`; K4r also writes the whole ns map (1 where SigProp made
// a sample significant).  The host stuffs and interleaves the streams
// into wire segments.  The plain PyTorch versions are grok_tpu_torch/ops/
// ht_encode.py `ht_encode_lanes_ref` and `ht_refine_lanes_ref`; the first
// design, csrc/ht_encode_v1.cu (one thread per code-block), is kept as
// the full-lane oracle.  All three are held identical on the card.
//
// Design (v2).  One warp codes one code-block; only the MEL run-length
// state is a serial chain, on the warp's lane 0.  The cleanup takes the
// block a step of whole quad rows at a time, one thread per quad
// (32 / gw rows per step, so a 32-wide block's 16 quad columns fill the
// warp two rows at once): each thread loads its quad's four samples a
// step ahead (the warp's loads cover its sample rows contiguously, and
// overlap the step before), computes rho, the
// exponents and ebot, and records (ebot << 4) | rho in the lane's quad map
// in shared memory; after a __syncwarp it reads its left, above and
// above-right neighbours from the map for the context and kappa, looks
// its CxtVLC codeword up in the shared table and settles the UVLC terms
// of its quad pair with its partner's u (a shuffle), the initial-row rule
// included.  Ballots collect the MEL events (in the scalar order: q0, q1,
// the pair's) for lane 0; a warp scan of the bit lengths places every
// thread's MagSgn and VLC fields, which are ORed into shared staging
// words; complete words go to the lane's stream regions in coalesced
// stores and the partial word is kept for the next step.  Stores stop at
// a stream's capacity: an overflowing stream reports -1 bits.
//
// For K4r the cleanup's threads also OR each sample's cleanup
// significance, bit p - 1 and sign into 64-bit rows in shared memory, so
// the refinement reads the block no more; it runs stripe by stripe, one
// thread per two columns.  In a
// 4-row stripe a column's SigProp depends on the columns before it only
// through the 4 bits the column to its left made significant (the row
// above the stripe is final, the column to the right and the row below
// hold only cleanup significance when the column is visited), so each
// column's step is a map from 4 bits to 4 bits, a 16-nibble table; a warp
// scan composes the tables, which gives every column its incoming state
// at once.  Each thread then emits its columns' SigProp bits and MagRef
// bits (placed by a scan) and marks its new significance; ns is written
// whole, coalesced, at the end.  The lane's state (quad map, staging
// words, significance rows) lives in the warp's slice of shared memory,
// the CxtVLC table once per CTA.
//
// Bound.  The bytes are ~100x below the first design's time; what bounds
// a lane is its chain of __syncwarp-separated steps (five per quad-row
// step, three per stripe) and lane 0's MEL events.
//
// Wide lanes (W or H over 64, sides up to 1024, at most 4096 samples)
// take a simple design of their own, `ht_encode_wide_kernel`: one warp
// per code-block, its first thread coding the block serially in the
// scalar coder's order (the first design's lane body), the two rows of
// quad states and the significance bits in the warp's shared memory; the
// warp zeroes ns first.

#include "t1_warp.cuh"

#define HT_N_CTX 8
#define HT_MAX_GW 32          // blocks are at most 64 wide
#define HT_WARPS 4            // code-blocks (warps) per CTA
// staging words: a step's MagSgn fields (32 quads x 4 x 32 bits) and the
// partial word before them; its VLC fields (32 x (7 + 26) bits) likewise
#define HT_MS_WORDS 132
#define HT_VLC_WORDS 36
#define HT_MAP_BYTES (HT_MAX_GW * HT_MAX_GW * 2)
#define HT_CLN_BYTES (HT_MAP_BYTES + 4 * (HT_MS_WORDS + HT_VLC_WORDS))
// K4r: cleanup significance, bit p - 1, sign (one 64-bit word per row)
// and SigProp's new significance (two 32-bit words per row)
#define HT_REF_BYTES (HT_CLN_BYTES + 3 * 64 * 8 + 64 * 8)

// The MEL exponent e of state k (0..12): 0 0 0 1 1 1 2 2 2 3 3 4 5, three
// bits each.
#define HT_MEL_E(k) ((int)((0x58DA489200ull >> (3 * (k))) & 7))

// A serial bit sink in registers, flushed to device memory as whole
// 32-bit words: the MEL stream, written by lane 0 alone.
struct Sink {
    uint32_t* w;              // the lane's region, 4-byte aligned
    int cap;                  // capacity in words
    int pos;                  // words stored
    uint64_t acc;
    int nacc;
    int nbits;
    bool ovf;
};

// n <= 32 low bits of v, transmitted LSB first.
__device__ __forceinline__ void sink_put(Sink& s, uint32_t v, int n)
{
    if (n <= 0)
        return;
    uint64_t m = n >= 32 ? 0xFFFFFFFFull : ((1ull << n) - 1ull);
    s.acc |= ((uint64_t)v & m) << s.nacc;
    s.nacc += n;
    s.nbits += n;
    if (s.nacc >= 32) {
        if (s.pos < s.cap)
            s.w[s.pos] = (uint32_t)s.acc;
        else
            s.ovf = true;
        s.pos++;
        s.acc >>= 32;
        s.nacc -= 32;
    }
}

__device__ __forceinline__ int sink_finish(Sink& s)
{
    if (s.nacc > 0) {
        if (s.pos < s.cap)
            s.w[s.pos] = (uint32_t)s.acc;
        else
            s.ovf = true;
        s.pos++;
    }
    return s.ovf ? -1 : s.nbits;
}

struct Mel {
    int k, run;
};

// One MEL event: a completed run of 2^e zero events emits a 1-bit; a
// one event emits a 0-bit and the partial run length, e bits MSB first.
__device__ __forceinline__ void mel_encode(Mel& m, Sink& s, int event)
{
    int e = HT_MEL_E(m.k);
    if (!event) {
        m.run += 1;
        if (m.run == (1 << e)) {
            sink_put(s, 1u, 1);
            m.run = 0;
            m.k = min(m.k + 1, 12);
        }
        return;
    }
    uint32_t r = 0;
    for (int t = 0; t < e; t++)
        r |= (uint32_t)((m.run >> (e - 1 - t)) & 1) << t;
    sink_put(s, r << 1, 1 + e);
    m.run = 0;
    m.k = max(m.k - 1, 0);
}

// A stream written by the whole warp: each step's fields are ORed into
// the staging words st (shared memory, zero past the partial word st[0]
// of `tail` bits) at offsets from a warp scan; stage_store then stores
// the complete words and stage_reset moves the partial one to st[0].
// Every thread holds the same copy of the counters.
struct WSink {
    uint32_t* st;
    uint32_t* g;              // the lane's region in device memory
    int cap;                  // capacity in words
    int pos;                  // words stored (or past the capacity)
    int tail;                 // bits in st[0]
    int nbits;
    int nw;                   // complete words of the last step
    uint32_t last;            // the partial word after them
};

// n <= 32 low bits of v at bit `off` of the staging words.
__device__ __forceinline__ void stage_put(uint32_t* st, int off, uint64_t v,
                                          int n)
{
    if (n <= 0)
        return;
    const uint64_t y = (v & ((1ull << n) - 1ull)) << (off & 31);
    if ((uint32_t)y)
        warp_or(st + (off >> 5), (uint32_t)y);
    if (y >> 32)
        warp_or(st + (off >> 5) + 1, (uint32_t)(y >> 32));
}

// After the step's puts and a warp_sync: store the complete words (none
// past the capacity).
__device__ __forceinline__ void stage_store(WSink& s, int nadd)
{
    const int bits = s.tail + nadd;
    const int nw = bits >> 5, pos = s.pos, cap = s.cap;
    uint32_t* st = s.st;
    uint32_t* g = s.g;
    s.last = st[nw];
    warp_for(nw, [&](int i) {
        if (pos + i < cap)
            g[pos + i] = st[i];
    });
    s.nw = nw;
    s.pos += nw;
    s.tail = bits & 31;
    s.nbits += nadd;
}

// After stage_store and a warp_sync: the partial word to st[0], the
// stored ones cleared.
__device__ __forceinline__ void stage_reset(WSink& s)
{
    uint32_t* st = s.st;
    const uint32_t last = s.last;
    warp_for(s.nw + 1, [&](int i) { st[i] = i ? 0u : last; });
}

// The stream's bit count (-1 past the capacity), its partial word stored
// by lane 0; after a warp_sync.
__device__ __forceinline__ int stage_finish(WSink& s)
{
    if (s.tail > 0 && s.pos < s.cap && warp_leader())
        s.g[s.pos] = s.st[0];
    return s.pos + (s.tail > 0) > s.cap ? -1 : s.nbits;
}

// UVLC prefix/suffix of u >= 1 (prefix polarity applied); the suffix
// carries the 5-bit escape extension for u >= 36.
__device__ __forceinline__ void uvlc_parts(int u, int pxor, int& pl, int& pb,
                                           int& sl, int& sb)
{
    if (u == 1) {
        pl = 1; pb = 0; sl = 0; sb = 0;
    } else if (u == 2) {
        pl = 2; pb = 1; sl = 0; sb = 0;
    } else if (u <= 4) {
        pl = 3; pb = 3; sl = 1; sb = u - 3;
    } else if (u <= 35) {
        pl = 3; pb = 7; sl = 5; sb = u - 5;
    } else {
        pl = 3; pb = 7; sl = 10; sb = 31 | ((u - 36) << 5);
    }
    pb ^= pxor & ((1 << pl) - 1);
}

// The UVLC bits of one quad pair (u0 of its first quad, u1 of its second,
// 0 where a quad is absent or has no u_off), as one field: both u_off,
// prefixes then suffixes; in the initial quad row a MEL event (big) codes
// whether both u > 2 (then u - 2 is coded); when it is clear, a 3-bit
// first prefix implies u1 <= 2, coded in one raw bit.  Returns the field
// and its length in bits 32 up.
__device__ __forceinline__ uint64_t uvlc_pair(bool initial, int u0, int u1,
                                              int pxor, bool& big)
{
    int l0 = 0, p0 = 0, s0 = 0, sb0 = 0, l1 = 0, p1 = 0, s1 = 0, sb1 = 0;
    big = false;
    if (u0 > 0 && u1 > 0) {
        if (initial) {
            big = u0 > 2 && u1 > 2;
            if (big) {
                uvlc_parts(u0 - 2, pxor, l0, p0, s0, sb0);
                uvlc_parts(u1 - 2, pxor, l1, p1, s1, sb1);
            } else {
                uvlc_parts(u0, pxor, l0, p0, s0, sb0);
                if (l0 == 3) {
                    l1 = 1; p1 = u1 - 1;
                } else {
                    uvlc_parts(u1, pxor, l1, p1, s1, sb1);
                }
            }
        } else {
            uvlc_parts(u0, pxor, l0, p0, s0, sb0);
            uvlc_parts(u1, pxor, l1, p1, s1, sb1);
        }
    } else if (u0 > 0 || u1 > 0) {
        uvlc_parts(u0 > 0 ? u0 : u1, pxor, l0, p0, s0, sb0);
    }
    const uint64_t v = (uint64_t)p0 | ((uint64_t)p1 << l0)
        | ((uint64_t)sb0 << (l0 + l1)) | ((uint64_t)sb1 << (l0 + l1 + s0));
    return v | ((uint64_t)(l0 + l1 + s0 + s1) << 32);
}

// The cleanup pass of one valid lane, run by the whole warp: its three
// streams at o, their bit counts at bits[lane], bits[nl + lane],
// bits[2 nl + lane].  ws: the warp's HT_CLN_BYTES of shared memory.
// With ref (K4r, p > 0), the rows of cleanup significance, bit p - 1 and
// sign of the refinement, two 32-bit words per sample row each, from the
// same loads.
__device__ void encode_cleanup(const int* blk, int W, int w, int h, int p,
                               const int* lut, int symb, int nfam, int pxor,
                               unsigned char* ws, uint8_t* o, int lms,
                               int lmel, int lvlc, int* bits, int nl,
                               int lane, bool ref)
{
    uint16_t* map = reinterpret_cast<uint16_t*>(ws);
    uint32_t* stm = reinterpret_cast<uint32_t*>(ws + HT_MAP_BYTES);
    uint32_t* stv = stm + HT_MS_WORDS;
    uint32_t* rsg = reinterpret_cast<uint32_t*>(ws + HT_CLN_BYTES);
    uint32_t* rbt = rsg + 128;
    uint32_t* rsn = rbt + 128;
    warp_for(HT_MS_WORDS + HT_VLC_WORDS, [&](int i) { stm[i] = 0; });
    if (ref)
        warp_for(3 * 128, [&](int i) { rsg[i] = 0; });
    WSink sms = { stm, (uint32_t*)o, lms / 4, 0, 0, 0, 0, 0u };
    WSink svlc = { stv, (uint32_t*)(o + lms + lmel), lvlc / 4, 0, 0, 0, 0,
                   0u };
    Sink smel = { (uint32_t*)(o + lms), lmel / 4, 0, 0ull, 0, 0, false };
    Mel mel = { 0, 0 };

    const int gw = (w + 1) >> 1, gh = (h + 1) >> 1;
    const int rows = HT_MAX_GW / gw;          // quad rows per step
    WarpReg<int> qr, qc;                      // the thread's row, column
    warp_each([&](int t) {
        qr[t] = t / gw;
        qc[t] = t - qr[t] * gw;
    });
    WarpReg<uint32_t> raw[4];                 // the step's samples
    WarpReg<uint32_t> v[4];                   // MagSgn values
    WarpReg<int> q;                           // rho | uact << 4
    WarpReg<int> cw;                          // CxtVLC entry, 0 for none
    WarpReg<int> ue;                          // U | eps_k << 6
    WarpReg<int> u;                           // u (0: no u_off)
    WarpReg<int> evq, evp;                    // MEL events: 1 | value << 1
    WarpReg<uint64_t> uv;                     // the pair's UVLC field
    WarpReg<int> len;                         // MagSgn | VLC << 16 bits
    // the samples of the step at quad row g0 (0 outside the block), loaded
    // a step ahead so that the loads overlap the step before
    auto fetch = [&](int g0) {
        const int nq = min(rows, gh - g0) * gw;
        warp_each([&](int t) {
            const int g = g0 + qr[t], qx = qc[t];
#pragma unroll
            for (int i = 0; i < 4; i++) {
                // quad scan order n0=(0,0) n1=(1,0) n2=(0,1) n3=(1,1),
                // (dy, dx)
                const int y = 2 * g + (i & 1), x = 2 * qx + (i >> 1);
                raw[i][t] = t < nq && y < h && x < w
                    ? (uint32_t)blk[y * W + x] : 0u;
            }
        });
    };
    fetch(0);
    warp_sync();

    for (int g0 = 0; g0 < gh; g0 += rows) {
        const int nq = min(rows, gh - g0) * gw;
        // 1. significance, exponents; the quad map (and the refinement's
        // rows)
        warp_each([&](int t) {
            const int g = g0 + qr[t], qx = qc[t];
            int rho = 0, ebot = 0, uact = 0, bit = 0, sgn = 0;
#pragma unroll
            for (int i = 0; i < 4; i++) {
                const uint32_t mn = raw[i][t];
                const uint32_t vq = (mn >> 1) >> p;
                uint32_t vi = 0;
                if (vq > 0) {
                    rho |= 1 << i;
                    vi = ((vq - 1u) << 1) | (mn & 1u);
                    const int e = 32 - t1_clz(vi);
                    uact = max(uact, e);
                    if (i & 1)
                        ebot = max(ebot, e);
                }
                v[i][t] = vi;
                if (ref) {
                    bit |= (int)(((mn >> 1) >> (p - 1)) & 1) << i;
                    sgn |= (int)(mn & 1) << i;
                }
            }
            if (t < nq)
                map[g * HT_MAX_GW + qx] = (uint16_t)(rho | (ebot << 4));
            q[t] = rho | (uact << 4);
            if (ref && t < nq) {
                // rows 2g + dy, columns 2qx and 2qx + 1: bits i = dy, dy + 2
#pragma unroll
                for (int dy = 0; dy < 2; dy++) {
                    const int k = 2 * (2 * g + dy) + (qx >> 4);
                    const int sh = (2 * qx) & 31;
                    const int m = 1 << dy | 4 << dy;
                    if (rho & m)
                        warp_or(rsg + k, (uint32_t)(((rho >> dy) & 1)
                                | ((rho >> (dy + 1)) & 2)) << sh);
                    if (bit & m)
                        warp_or(rbt + k, (uint32_t)(((bit >> dy) & 1)
                                | ((bit >> (dy + 1)) & 2)) << sh);
                    if (sgn & m)
                        warp_or(rsn + k, (uint32_t)(((sgn >> dy) & 1)
                                | ((sgn >> (dy + 1)) & 2)) << sh);
                }
            }
        });
        if (g0 + rows < gh)
            fetch(g0 + rows);
        warp_sync();
        // 2. context, exponent bound, CxtVLC codeword, u; the quad's MEL
        // event
        warp_each([&](int t) {
            const int g = g0 + qr[t], qx = qc[t];
            cw[t] = ue[t] = u[t] = evq[t] = 0;
            if (t >= nq)
                return;
            const int rho = q[t] & 15, uact = q[t] >> 4;
            const int rl = qx > 0 ? map[g * HT_MAX_GW + qx - 1] & 15 : 0;
            const int above = g > 0 ? map[(g - 1) * HT_MAX_GW + qx] : 0;
            const int rar = g > 0 && qx + 1 < gw
                ? map[(g - 1) * HT_MAX_GW + qx + 1] & 15 : 0;
            const int c = ((rl & 0xC) != 0) | (((above & 0xA) != 0) << 1)
                | (((rar & 0x2) != 0) << 2);
            const int famoff = (nfam == 2 && g == 0) ? HT_N_CTX : 0;
            const int base = (famoff + c) << symb;
            if (c == 0)
                evq[t] = 1 | ((rho != 0) << 1);
            if (rho == 0) {
                if (c != 0)
                    cw[t] = lut[base];
                return;
            }
            const int kappa = (rho & (rho - 1)) ? max(1, (above >> 4) - 1)
                                                : 1;
            const int U = max(kappa, uact);
            const int uu = U - kappa;
            const int sym = ((uu > 0) << 4) | rho;
            int ek = 0;
#pragma unroll
            for (int i = 0; i < 4; i++)
                if (((rho >> i) & 1) && 32 - t1_clz(v[i][t]) == U)
                    ek |= 1 << i;
            int ent = 0;
            if (ek && symb == 9)
                ent = lut[base | (ek << 5) | sym];
            if (ent == 0) {              // no EMB entry: the eps_k = 0 symbol
                ek = 0;
                ent = lut[base | sym];
            }
            cw[t] = ent;
            ue[t] = U | (ek << 6);
            u[t] = uu;
        });
        // 3. the pair's UVLC (on its second quad, or on the unpaired last
        // quad of a row), the initial-row MEL event; the bit lengths
        warp_each([&](int t) {
            const int up = warp_shfl(u, t - 1);
            const int g = g0 + qr[t], qx = qc[t];
            uv[t] = 0;
            evp[t] = 0;
            int nms = 0;
            if (t < nq) {
                const int rho = q[t] & 15, U = ue[t] & 63, ek = ue[t] >> 6;
#pragma unroll
                for (int i = 0; i < 4; i++)
                    if ((rho >> i) & 1)
                        nms += U - ((ek >> i) & 1);
                if ((qx & 1) || qx == gw - 1) {
                    const bool second = qx & 1;
                    bool big;
                    uv[t] = uvlc_pair(g == 0, second ? up : u[t],
                                      second ? u[t] : 0, pxor, big);
                    if (second && g == 0 && up > 0 && u[t] > 0)
                        evp[t] = 1 | (big << 1);
                }
            }
            len[t] = nms | (((cw[t] >> 7) + (int)(uv[t] >> 32)) << 16);
        });
        const uint32_t mq = warp_ballot(evq);
        WarpReg<int> val;
        warp_each([&](int t) { val[t] = evq[t] >> 1; });
        const uint32_t mqv = warp_ballot(val);
        const uint32_t mp = warp_ballot(evp);
        warp_each([&](int t) { val[t] = evp[t] >> 1; });
        const uint32_t mpv = warp_ballot(val);
        const int tot = warp_scan(len);
        // the MEL events in the scalar order: q0, q1, the pair's
        if (warp_leader()) {
            uint32_t m = mq | mp;
            while (m) {
                const int t = t1_ffs64(m) - 1;
                m &= m - 1;
                if ((mq >> t) & 1)
                    mel_encode(mel, smel, (mqv >> t) & 1);
                if ((mp >> t) & 1)
                    mel_encode(mel, smel, (mpv >> t) & 1);
            }
        }
        // 4. the fields into the staging words
        warp_each([&](int t) {
            if (t >= nq)
                return;
            const int rho = q[t] & 15, U = ue[t] & 63, ek = ue[t] >> 6;
            int off = sms.tail + (len[t] & 0xFFFF);
#pragma unroll
            for (int i = 0; i < 4; i++)
                if ((rho >> i) & 1) {
                    const int n = U - ((ek >> i) & 1);
                    stage_put(stm, off, v[i][t], n);
                    off += n;
                }
            off = svlc.tail + (len[t] >> 16);
            stage_put(stv, off, (uint32_t)cw[t] & 0x7F, cw[t] >> 7);
            stage_put(stv, off + (cw[t] >> 7), uv[t],
                      (int)(uv[t] >> 32));
        });
        warp_sync();
        stage_store(sms, tot & 0xFFFF);
        stage_store(svlc, tot >> 16);
        warp_sync();
        stage_reset(sms);
        stage_reset(svlc);
        warp_sync();
    }
    const int bms = stage_finish(sms), bvlc = stage_finish(svlc);
    if (warp_leader()) {
        if (mel.run > 0)             // a pending run as a claimed full run
            sink_put(smel, 1u, 1);
        bits[lane] = bms;
        bits[nl + lane] = sink_finish(smel);
        bits[2 * nl + lane] = bvlc;
    }
    warp_sync();
}

// ---- K4r: HT SigProp + HT MagRef at plane p - 1 -----------------------

// bits x-1, x, x+1 of a row word (0 beyond the row)
__device__ __forceinline__ int nb3(uint64_t row, int x)
{
    return (int)((x > 0 ? row >> (x - 1) : row << 1) & 7ull);
}

// f after g, as 16-nibble tables of 4-bit maps: (f o g)[s] = f[g[s]].
// f's entries become bytes (even and odd entries of each half apart), so
// byte permutes look up four entries at a time.
__device__ __forceinline__ uint64_t nib_compose(uint64_t f, uint64_t g)
{
    const uint32_t fl = (uint32_t)f, fh = (uint32_t)(f >> 32);
    const uint32_t fel = fl & 0x0F0F0F0Fu, fol = (fl >> 4) & 0x0F0F0F0Fu;
    const uint32_t feh = fh & 0x0F0F0F0Fu, foh = (fh >> 4) & 0x0F0F0F0Fu;
    uint64_t r = 0;
#pragma unroll
    for (int k = 0; k < 4; k++) {
        // entries s = 8 (k >> 1) + 2 j + (k & 1), j = 0..3: their g[s]
        const uint32_t gi = ((uint32_t)(g >> (32 * (k >> 1))) >> (4 * (k & 1)))
            & 0x0F0F0F0Fu;
        // f[i] is byte (i >> 1) & 3 of the even (i & 1 = 0) or odd word
        uint32_t sel = ((gi & 0x01010101u) << 2) | ((gi >> 1) & 0x03030303u);
        sel = (sel | (sel >> 4)) & 0x00FF00FFu;
        sel = (sel | (sel >> 8)) & 0xFFFFu;
        const uint32_t hi = ((gi >> 3) & 0x01010101u) * 0xFFu;
        const uint32_t v = (t1_prmt(fel, fol, sel) & ~hi)
            | (t1_prmt(feh, foh, sel) & hi);
        r |= (uint64_t)(v << (4 * (k & 1))) << (32 * (k >> 1));
    }
    return r;
}

// Bit s of a 16-bit mask to bit 4 s.
__device__ __forceinline__ uint64_t spread4(uint64_t m)
{
    m = (m | (m << 24)) & 0x000000FF000000FFull;
    m = (m | (m << 12)) & 0x000F000F000F000Full;
    m = (m | (m << 6)) & 0x0303030303030303ull;
    return (m | (m << 3)) & 0x1111111111111111ull;
}

// Four 16-bit masks over the incoming state s, mask r in bits 16 r up ->
// the 16-nibble table whose entry s has bit r of mask r's bit s.
__device__ __forceinline__ uint64_t nib_table(uint64_t pk)
{
    return spread4(pk & 0xFFFF) | (spread4((pk >> 16) & 0xFFFF) << 1)
        | (spread4((pk >> 32) & 0xFFFF) << 2) | (spread4(pk >> 48) << 3);
}

// Entry s of the same masks, as a nibble.
__device__ __forceinline__ int nib_at(uint64_t pk, int s)
{
    const uint64_t x = (pk >> s) & 0x0001000100010001ull;
    return (int)((x | (x >> 15) | (x >> 30) | (x >> 45)) & 15);
}

// SigProp on column x of the stripe at rows y0 .. y0 + nr - 1, as
// functions of s, the rows of column x - 1 that SigProp made significant:
// nm, the rows of column x it makes significant, and cm, the rows it
// codes, each as four 16-bit masks over s (row r in bits 16 r up).  sg:
// cleanup significance rows; above: the full significance of the row
// above the stripe (0 at the top); below: the cleanup significance of
// the row below it (0 at the bottom); bt: bit p - 1.
__device__ __forceinline__ void sp_column(const uint64_t* sg,
                                          const uint64_t* bt, int y0, int nr,
                                          uint64_t above, uint64_t below,
                                          int x, uint64_t& nm, uint64_t& cm)
{
    // bit r of s, as a mask over the 16 values of s
    const int ls[4] = { 0xAAAA, 0xCCCC, 0xF0F0, 0xFF00 };
    nm = cm = 0;
    int nprev = 0;                       // the row above's new bits
    int nbp = nb3(above, x) != 0 ? 0xFFFF : 0;   // the row above's part
#pragma unroll
    for (int r = 0; r < 4; r++) {        // constant indices: registers
        if (r >= nr)
            break;
        const uint64_t row = sg[y0 + r];
        const int own = nb3(row, x);
        const int nxt = r + 1 < nr ? nb3(sg[y0 + r + 1], x) : nb3(below, x);
        int dyn = ls[r] | (r + 1 < nr ? ls[r + 1] : 0);
        if (r > 0)
            dyn |= ls[r - 1] | nprev;
        const int cand = (own & 2) ? 0
            : (nbp | ((own & 5) || nxt ? 0xFFFF : 0) | dyn);
        nprev = ((bt[y0 + r] >> x) & 1) ? cand : 0;
        cm |= (uint64_t)cand << (16 * r);
        nm |= (uint64_t)nprev << (16 * r);
        nbp = own ? 0xFFFF : 0;      // this row, as the next one's above
    }
}

// The refinement passes of one valid lane with p > 0, run by the whole
// warp, after encode_cleanup: the SigProp and MagRef streams at o, their
// bit counts at bits[3 nl + lane], bits[4 nl + lane]; SigProp's new
// significance in the rows at ws + HT_REF_BYTES - 512.
__device__ void encode_refine(int w, int h, unsigned char* ws, uint8_t* o,
                              int lsp, int lmr, int* bits, int nl, int lane)
{
    uint32_t* stp = reinterpret_cast<uint32_t*>(ws + HT_MAP_BYTES);
    uint32_t* str = stp + HT_MS_WORDS;
    uint64_t* sg = reinterpret_cast<uint64_t*>(ws + HT_CLN_BYTES);
    uint64_t* bt = sg + 64;
    uint64_t* sn = bt + 64;
    uint32_t* sp = reinterpret_cast<uint32_t*>(sn + 64);
    warp_for(2 * 64, [&](int i) { sp[i] = 0; });
    warp_for(HT_MS_WORDS + HT_VLC_WORDS, [&](int i) { stp[i] = 0; });
    WSink ssp = { stp, (uint32_t*)o, lsp / 4, 0, 0, 0, 0, 0u };
    WSink smr = { str, (uint32_t*)(o + lsp), lmr / 4, 0, 0, 0, 0, 0u };
    WarpReg<uint64_t> n0, c0, n1, c1, f;
    WarpReg<int> fsp, fmr, len;
    warp_sync();

    for (int y0 = 0; y0 < h; y0 += 4) {
        const int nr = min(4, h - y0);
        const uint64_t above = y0 > 0
            ? sg[y0 - 1] | sp[2 * (y0 - 1)]
                | ((uint64_t)sp[2 * (y0 - 1) + 1] << 32) : 0;
        const uint64_t below = y0 + 4 < h ? sg[y0 + 4] : 0;
        // 1. each thread's two columns as maps of the incoming state
        warp_each([&](int t) {
            const int x = 2 * t;
            n0[t] = c0[t] = n1[t] = c1[t] = 0;
            if (x < w)
                sp_column(sg, bt, y0, nr, above, below, x, n0[t], c0[t]);
            if (x + 1 < w)
                sp_column(sg, bt, y0, nr, above, below, x + 1, n1[t],
                          c1[t]);
            f[t] = nib_compose(nib_table(n1[t]), nib_table(n0[t]));
        });
        warp_scan_incl(f, [](uint64_t a, uint64_t b) {
            return nib_compose(a, b);
        });
        // 2. the incoming state; the SigProp and MagRef fields, the new
        // significance
        warp_each([&](int t) {
            const int prev = (int)(warp_shfl(f, t - 1) & 15);
            int vsp = 0, nsp = 0, vmr = 0, nmr = 0, s = t > 0 ? prev : 0;
            for (int k = 0; k < 2; k++) {
                const int x = 2 * t + k;
                if (x >= w)
                    break;
                const int cand = nib_at(k ? c1[t] : c0[t], s);
                s = nib_at(k ? n1[t] : n0[t], s);
                for (int r = 0; r < nr; r++) {
                    const int b = (int)((bt[y0 + r] >> x) & 1);
                    if ((cand >> r) & 1) {    // the sign only after a 1
                        vsp |= (b | ((b & (int)(sn[y0 + r] >> x)) << 1))
                            << nsp;
                        nsp += 1 + b;
                    }
                    if ((sg[y0 + r] >> x) & 1) {
                        vmr |= b << nmr;
                        nmr++;
                    }
                    if ((s >> r) & 1)
                        warp_or(sp + 2 * (y0 + r) + (x >> 5),
                                1u << (x & 31));
                }
            }
            fsp[t] = vsp;
            fmr[t] = vmr;
            len[t] = nsp | (nmr << 16);
        });
        const int tot = warp_scan(len);
        warp_each([&](int t) {
            stage_put(stp, ssp.tail + (len[t] & 0xFFFF), (uint32_t)fsp[t],
                      32);
            stage_put(str, smr.tail + (len[t] >> 16), (uint32_t)fmr[t], 32);
        });
        warp_sync();
        stage_store(ssp, tot & 0xFFFF);
        stage_store(smr, tot >> 16);
        warp_sync();
        stage_reset(ssp);
        stage_reset(smr);
        warp_sync();
    }
    const int bsp = stage_finish(ssp), bmr = stage_finish(smr);
    if (warp_leader()) {
        bits[3 * nl + lane] = bsp;
        bits[4 * nl + lane] = bmr;
    }
    warp_sync();
}

// Lane `lane` of the batch, run by the whole warp: its parameters clamped
// as the contract says, the cleanup and, for K4r (ns != nullptr), the
// refinement and the whole ns map of the lane.  ws: the warp's
// HT_CLN_BYTES (HT_REF_BYTES for K4r) of shared memory.
__device__ __forceinline__ void encode_one(
    const int* lut, int symb, int nfam, int pxor, unsigned char* ws, int lane,
    const int* mneg, const int* pv, const int* wv, const int* hv,
    const int* valid, uint8_t* out, int row, int lms, int lmel, int lvlc,
    int lsp, int lmr, int* bits, uint8_t* ns, int nl, int W, int H)
{
    const int w = min(wv[lane], W), h = min(hv[lane], H);
    const bool on = valid[lane] == 1 && w > 0 && h > 0;
    const int p = pv[lane];
    const int* blk = mneg + (size_t)lane * W * H;
    uint8_t* o = out + (size_t)lane * row;
    const bool ref = ns != nullptr && on && p > 0;
    if (on)
        encode_cleanup(blk, W, w, h, p, lut, symb, nfam, pxor, ws, o, lms,
                       lmel, lvlc, bits, nl, lane, ref);
    if (ref)
        encode_refine(w, h, ws, o + lms + lmel + lvlc, lsp, lmr, bits, nl,
                      lane);
    if (warp_leader()) {
        const int nstreams = ns != nullptr ? 5 : 3;
        for (int s = on ? (ref ? 5 : 3) : 0; s < nstreams; s++)
            bits[s * nl + lane] = 0;
    }
    if (ns == nullptr)
        return;
    const uint32_t* sp = reinterpret_cast<const uint32_t*>(
        ws + HT_REF_BYTES - 64 * 8);
    uint8_t* nsl = ns + (size_t)lane * W * H;
    auto nsv = [&](int y, int x) -> uint32_t {
        return ref && y < h && x < w ? (sp[2 * y + (x >> 5)] >> (x & 31)) & 1
                                     : 0;
    };
    if ((W & 3) == 0) {              // 4-byte stores, rows 4-byte aligned
        const int wq = W >> 2;
        warp_for(H * wq, [&](int i) {
            const int y = i / wq, x = 4 * (i - y * wq);
            reinterpret_cast<uint32_t*>(nsl)[i] = nsv(y, x)
                | (nsv(y, x + 1) << 8) | (nsv(y, x + 2) << 16)
                | (nsv(y, x + 3) << 24);
        });
    } else {
        warp_for(H * W, [&](int i) {
            const int y = i / W;
            nsl[i] = (uint8_t)nsv(y, i - y * W);
        });
    }
}

// ---- wide lanes: one warp per code-block, its first thread serial ------

// A wide lane's shared memory: two rows of (ebot << 4) | rho quad states
// of GW + 2 entries, then the block's significance bits (W x H).
__host__ __device__ __forceinline__ int ht_enc_wide_bytes(int W, int H)
{
    const int gw = (W + 1) >> 1;
    return (8 * (gw + 2) + 15) / 16 * 16 + (W * H + 127) / 128 * 16;
}

// Significance, CxtVLC codeword and MagSgn fields of one quad; the MEL
// significance event for context-0 quads.  Writes the quad's state word
// into cur[qx + 1] and returns u (u_off = u > 0).
__device__ __forceinline__ int wide_quad(const int* blk, int W, int bw,
                                         int bh, int p, int g, int qx,
                                         const int* prev, int* cur,
                                         Mel& mel, Sink& smel, Sink& svlc,
                                         Sink& sms, const int* lut,
                                         int symb, int famoff)
{
    int rho = 0, ebot = 0, uact = 0;
    uint32_t v[4];
    int e[4];
    for (int i = 0; i < 4; i++) {
        // quad scan order n0=(0,0) n1=(1,0) n2=(0,1) n3=(1,1), (dy, dx)
        const int y = 2 * g + (i & 1), x = 2 * qx + (i >> 1);
        v[i] = 0;
        e[i] = 0;
        if (y < bh && x < bw) {
            const int mn = blk[y * W + x];
            const uint32_t vq = ((uint32_t)mn >> 1) >> p;
            if (vq > 0) {
                rho |= 1 << i;
                v[i] = ((vq - 1u) << 1) | ((uint32_t)mn & 1u);
                e[i] = 32 - t1_clz(v[i]);
                uact = max(uact, e[i]);
                if (i & 1)
                    ebot = max(ebot, e[i]);
            }
        }
    }
    cur[qx + 1] = rho | (ebot << 4);
    const int rl = cur[qx] & 0xF;
    const int ra = prev[qx + 1] & 0xF;
    const int rar = prev[qx + 2] & 0xF;
    const int c = ((rl & 0xC) != 0) | (((ra & 0xA) != 0) << 1)
        | (((rar & 0x2) != 0) << 2);
    const int base = (famoff + c) << symb;
    if (c == 0) {
        mel_encode(mel, smel, rho != 0);
        if (rho == 0)
            return 0;
    }
    if (rho == 0) {
        const int ent = lut[base];
        sink_put(svlc, (uint32_t)(ent & 0x7F), ent >> 7);
        return 0;
    }
    const int eab = prev[qx + 1] >> 4;
    const int kappa = (rho & (rho - 1)) ? max(1, eab - 1) : 1;
    const int U = max(kappa, uact);
    const int u = U - kappa;
    const int sym = ((u > 0) << 4) | rho;
    int ek = 0;
    for (int i = 0; i < 4; i++)
        if (((rho >> i) & 1) && e[i] == U)
            ek |= 1 << i;
    int ent = 0;
    if (ek && symb == 9)
        ent = lut[base | (ek << 5) | sym];
    if (ent == 0) {                  // no EMB entry: the eps_k = 0 symbol
        ek = 0;
        ent = lut[base | sym];
    }
    sink_put(svlc, (uint32_t)(ent & 0x7F), ent >> 7);
    for (int i = 0; i < 4; i++)
        if ((rho >> i) & 1)
            sink_put(sms, v[i], U - ((ek >> i) & 1));
    return u;
}

// The cleanup pass of one valid wide lane by one thread, quad pair by
// quad pair: its three streams at o, their bit counts at bits[lane],
// bits[nl + lane], bits[2 nl + lane].  rows: 2 (gw + 2) ints.
__device__ void wide_cleanup(const int* blk, int W, int w, int h, int p,
                             const int* lut, int symb, int nfam, int pxor,
                             int* rows, uint8_t* o, int lms, int lmel,
                             int lvlc, int* bits, int nl, int lane)
{
    Sink sms = { (uint32_t*)o, lms / 4, 0, 0ull, 0, 0, false };
    Sink smel = { (uint32_t*)(o + lms), lmel / 4, 0, 0ull, 0, 0, false };
    Sink svlc = { (uint32_t*)(o + lms + lmel), lvlc / 4, 0, 0ull, 0, 0,
                  false };
    Mel mel = { 0, 0 };
    const int gw = (w + 1) >> 1, gh = (h + 1) >> 1;
    for (int j = 0; j < gw + 2; j++)
        rows[j] = 0;
    for (int g = 0; g < gh; g++) {
        const int* prev = rows + (g & 1) * (gw + 2);
        int* cur = rows + ((g + 1) & 1) * (gw + 2);
        for (int j = 0; j < gw + 2; j++)
            cur[j] = 0;
        const bool initial = g == 0;
        const int famoff = (nfam == 2 && initial) ? HT_N_CTX : 0;
        for (int qx0 = 0; qx0 < gw; qx0 += 2) {
            const int u0 = wide_quad(blk, W, w, h, p, g, qx0, prev, cur, mel,
                                     smel, svlc, sms, lut, symb, famoff);
            int u1 = 0;
            if (qx0 + 1 < gw)
                u1 = wide_quad(blk, W, w, h, p, g, qx0 + 1, prev, cur, mel,
                               smel, svlc, sms, lut, symb, famoff);
            if (u0 > 0 || u1 > 0) {
                bool big;
                const uint64_t f = uvlc_pair(initial, u0, u1, pxor, big);
                if (initial && u0 > 0 && u1 > 0)
                    mel_encode(mel, smel, big ? 1 : 0);
                // at most 26 bits: two prefixes and two escaped suffixes
                sink_put(svlc, (uint32_t)f, (int)(f >> 32));
            }
        }
    }
    if (mel.run > 0)                 // a pending run as a claimed full run
        sink_put(smel, 1u, 1);
    bits[lane] = sink_finish(sms);
    bits[nl + lane] = sink_finish(smel);
    bits[2 * nl + lane] = sink_finish(svlc);
}

__device__ __forceinline__ bool wide_sig(const uint32_t* sg, int i)
{
    return (sg[i >> 5] >> (i & 31)) & 1u;
}

// HT SigProp and HT MagRef at plane p - 1 of one wide lane by one thread,
// each in the 4-row stripe scan (columns left to right, rows top to
// bottom in a stripe column): the streams after the cleanup's at o, their
// bit counts at bits[3 nl + lane], bits[4 nl + lane], the 1s of ns at nsl
// (row stride W).  sg: the significance bits, row stride w.
__device__ void wide_refine(const int* blk, int W, int w, int h, int p,
                            uint32_t* sg, uint8_t* o, int lsp, int lmr,
                            int* bits, int nl, int lane, uint8_t* nsl)
{
    const int bp = p - 1;
    for (int i = 0; i < (w * h + 31) >> 5; i++)
        sg[i] = 0;
    for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++)
            if ((((uint32_t)blk[y * W + x] >> 1) >> p) > 0)
                sg[(y * w + x) >> 5] |= 1u << ((y * w + x) & 31);
    Sink ssp = { (uint32_t*)o, lsp / 4, 0, 0ull, 0, 0, false };
    for (int y0 = 0; y0 < h; y0 += 4)
        for (int x = 0; x < w; x++)
            for (int y = y0; y < min(y0 + 4, h); y++) {
                if (wide_sig(sg, y * w + x))
                    continue;
                bool nbr = false;
                for (int yy = max(y - 1, 0); yy <= min(y + 1, h - 1); yy++)
                    for (int xx = max(x - 1, 0); xx <= min(x + 1, w - 1);
                         xx++)
                        nbr |= wide_sig(sg, yy * w + xx);
                if (!nbr)
                    continue;
                const uint32_t mn = (uint32_t)blk[y * W + x];
                const uint32_t bit = ((mn >> 1) >> bp) & 1u;
                sink_put(ssp, bit | ((mn & 1u) << 1), 1 + (int)bit);
                if (bit) {
                    sg[(y * w + x) >> 5] |= 1u << ((y * w + x) & 31);
                    nsl[y * W + x] = 1;
                }
            }
    bits[3 * nl + lane] = sink_finish(ssp);
    Sink smr = { (uint32_t*)(o + lsp), lmr / 4, 0, 0ull, 0, 0, false };
    for (int y0 = 0; y0 < h; y0 += 4)
        for (int x = 0; x < w; x++)
            for (int y = y0; y < min(y0 + 4, h); y++) {
                const uint32_t mag = (uint32_t)blk[y * W + x] >> 1;
                if ((mag >> p) > 0)
                    sink_put(smr, (mag >> bp) & 1u, 1);
            }
    bits[4 * nl + lane] = sink_finish(smr);
}

// Lane `lane` of a wide batch, run by the whole warp: ns zeroed (K4r),
// then the block coded by the first thread, the bit counts of an invalid
// lane and of a lane without refinement 0.  ws: the warp's
// ht_enc_wide_bytes(W, H) of shared memory.
__device__ __forceinline__ void encode_wide_one(
    const int* lut, int symb, int nfam, int pxor, unsigned char* ws, int lane,
    const int* mneg, const int* pv, const int* wv, const int* hv,
    const int* valid, uint8_t* out, int row, int lms, int lmel, int lvlc,
    int lsp, int lmr, int* bits, uint8_t* ns, int nl, int W, int H)
{
    const int w = min(wv[lane], W), h = min(hv[lane], H);
    const bool on = valid[lane] == 1 && w > 0 && h > 0;
    const int p = pv[lane];
    const int* blk = mneg + (size_t)lane * W * H;
    uint8_t* o = out + (size_t)lane * row;
    const bool ref = ns != nullptr && on && p > 0;
    uint8_t* nsl = ns != nullptr ? ns + (size_t)lane * W * H : nullptr;
    if (nsl != nullptr)
        warp_for(W * H, [&](int i) { nsl[i] = 0; });
    warp_sync();
    if (warp_leader()) {
        int* rows = reinterpret_cast<int*>(ws);
        uint32_t* sg = reinterpret_cast<uint32_t*>(
            ws + (8 * (((W + 1) >> 1) + 2) + 15) / 16 * 16);
        if (on)
            wide_cleanup(blk, W, w, h, p, lut, symb, nfam, pxor, rows, o,
                         lms, lmel, lvlc, bits, nl, lane);
        if (ref)
            wide_refine(blk, W, w, h, p, sg, o + lms + lmel + lvlc, lsp, lmr,
                        bits, nl, lane, nsl);
        const int nstreams = ns != nullptr ? 5 : 3;
        for (int k = on ? (ref ? 5 : 3) : 0; k < nstreams; k++)
            bits[k * nl + lane] = 0;
    }
    warp_sync();
}

#ifdef __CUDACC__

template <bool REFINE>
__global__ void __launch_bounds__(HT_WARPS * 32)
ht_encode_kernel(const int* __restrict__ mneg, const int* __restrict__ pv,
                 const int* __restrict__ wv, const int* __restrict__ hv,
                 const int* __restrict__ valid,
                 const int* __restrict__ lut_g, int lut_n, int symb,
                 int nfam, int pxor, uint8_t* __restrict__ out, int row,
                 int lms, int lmel, int lvlc, int lsp, int lmr,
                 int* __restrict__ bits, uint8_t* __restrict__ ns, int nl,
                 int W, int H)
{
    extern __shared__ __align__(16) unsigned char smem[];
    int* lut = reinterpret_cast<int*>(smem);
    for (int i = threadIdx.x; i < lut_n; i += blockDim.x)
        lut[i] = lut_g[i];
    __syncthreads();
    const int lane = blockIdx.x * HT_WARPS + (threadIdx.x >> 5);
    if (lane >= nl)
        return;
    unsigned char* ws = smem + ((lut_n * 4 + 15) & ~15)
        + (threadIdx.x >> 5) * (REFINE ? HT_REF_BYTES : HT_CLN_BYTES);
    encode_one(lut, symb, nfam, pxor, ws, lane, mneg, pv, wv, hv, valid, out,
               row, lms, lmel, lvlc, lsp, lmr, bits, REFINE ? ns : nullptr,
               nl, W, H);
}

template <bool REFINE>
__global__ void __launch_bounds__(HT_WARPS * 32)
ht_encode_wide_kernel(const int* __restrict__ mneg,
                      const int* __restrict__ pv,
                      const int* __restrict__ wv, const int* __restrict__ hv,
                      const int* __restrict__ valid,
                      const int* __restrict__ lut_g, int lut_n, int symb,
                      int nfam, int pxor, uint8_t* __restrict__ out, int row,
                      int lms, int lmel, int lvlc, int lsp, int lmr,
                      int* __restrict__ bits, uint8_t* __restrict__ ns,
                      int nl, int W, int H)
{
    extern __shared__ __align__(16) unsigned char smem[];
    int* lut = reinterpret_cast<int*>(smem);
    for (int i = threadIdx.x; i < lut_n; i += blockDim.x)
        lut[i] = lut_g[i];
    __syncthreads();
    const int lane = blockIdx.x * HT_WARPS + (threadIdx.x >> 5);
    if (lane >= nl)
        return;
    unsigned char* ws = smem + ((lut_n * 4 + 15) & ~15)
        + (threadIdx.x >> 5) * ht_enc_wide_bytes(W, H);
    encode_wide_one(lut, symb, nfam, pxor, ws, lane, mneg, pv, wv, hv, valid,
                    out, row, lms, lmel, lvlc, lsp, lmr, bits,
                    REFINE ? ns : nullptr, nl, W, H);
}

template <bool REFINE>
static int launch(const void* mneg, const void* p, const void* w,
                  const void* h, const void* valid, const void* lut,
                  int lut_n, int symb, int nfam, int pxor, void* out,
                  int row, int lms, int lmel, int lvlc, int lsp, int lmr,
                  void* bits, void* ns, int nl, int W, int H, void* stream)
{
    if (nl <= 0)
        return 0;
    if (W > 64 || H > 64) {
        const int smem = ((lut_n * 4 + 15) & ~15)
            + HT_WARPS * ht_enc_wide_bytes(W, H);
        cudaError_t err = cudaFuncSetAttribute(
            ht_encode_wide_kernel<REFINE>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess)
            return (int)err;
        const int blocks = (nl + HT_WARPS - 1) / HT_WARPS;
        ht_encode_wide_kernel<REFINE><<<blocks, HT_WARPS * 32, smem,
                                        (cudaStream_t)stream>>>(
            (const int*)mneg, (const int*)p, (const int*)w, (const int*)h,
            (const int*)valid, (const int*)lut, lut_n, symb, nfam, pxor,
            (uint8_t*)out, row, lms, lmel, lvlc, lsp, lmr, (int*)bits,
            (uint8_t*)ns, nl, W, H);
        return (int)cudaGetLastError();
    }
    const int smem = ((lut_n * 4 + 15) & ~15)
        + HT_WARPS * (REFINE ? HT_REF_BYTES : HT_CLN_BYTES);
    cudaError_t err = cudaFuncSetAttribute(
        ht_encode_kernel<REFINE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess)
        return (int)err;
    const int blocks = (nl + HT_WARPS - 1) / HT_WARPS;
    ht_encode_kernel<REFINE><<<blocks, HT_WARPS * 32, smem,
                               (cudaStream_t)stream>>>(
        (const int*)mneg, (const int*)p, (const int*)w, (const int*)h,
        (const int*)valid, (const int*)lut, lut_n, symb, nfam, pxor,
        (uint8_t*)out, row, lms, lmel, lvlc, lsp, lmr, (int*)bits,
        (uint8_t*)ns, nl, W, H);
    return (int)cudaGetLastError();
}

extern "C" int grk_ht_encode_cleanup(const void* mneg, const void* p,
                                     const void* w, const void* h,
                                     const void* valid, const void* lut,
                                     int lut_n, int symb, int nfam, int pxor,
                                     void* out, int row, int lms, int lmel,
                                     int lvlc, void* bits, int nl, int W,
                                     int H, void* stream)
{
    return launch<false>(mneg, p, w, h, valid, lut, lut_n, symb, nfam, pxor,
                         out, row, lms, lmel, lvlc, 0, 0, bits, nullptr, nl,
                         W, H, stream);
}

// ns is written whole: 1 where SigProp made a sample significant, else 0.
extern "C" int grk_ht_encode_refine(const void* mneg, const void* p,
                                    const void* w, const void* h,
                                    const void* valid, const void* lut,
                                    int lut_n, int symb, int nfam, int pxor,
                                    void* out, int row, int lms, int lmel,
                                    int lvlc, int lsp, int lmr, void* bits,
                                    void* ns, int nl, int W, int H,
                                    void* stream)
{
    return launch<true>(mneg, p, w, h, valid, lut, lut_n, symb, nfam, pxor,
                        out, row, lms, lmel, lvlc, lsp, lmr, bits, ns, nl, W,
                        H, stream);
}

#endif
