// HTJ2K (ISO 15444-15) cleanup-pass decode of a batch of code-blocks.
//
// Replaces the Pallas TPU kernel grok_tpu/ops/pallas_ht.py
// `_ht_decode_jit` (refine=False, reached through `pallas_ht_decode`),
// with the same contract: per lane, clean LSB-first MagSgn / MEL / VLC
// streams (uint8 rows, zero-padded), the cleanup plane p, the block size
// and a valid flag in; signed mag2 (negative = sign bit) with the Part-1
// half-bit below plane p out, as (NL, H, W) int32 in lane-major layout.
// The plain PyTorch version is grok_tpu_torch/ops/ht_decode.py
// `ht_decode_lanes_ref`; the two are held bit-exact on the card.
//
// Design.  One thread decodes one code-block, quad pair by quad pair, in
// the order of the Pallas pair body.  Its whole state lives in registers
// and local memory: the three bit positions, the MEL k/run/pending
// counters, and two rows of (ebot << 4) | rho words of GW + 2 entries
// (the previous quad row for context and kappa, the current one for the
// left neighbour).  Every bit read loads its 4 bytes straight from
// device memory and reads 0 past the lane's buffer, which replaces the
// TPU staging machinery (granule windows, the mid scratch, one-hot sums).
// The CxtVLC decode table (nfam * 8 * 128 int32) is copied into shared
// memory at block start.
//
// Bound.  Serial decode latency per block, and occupancy: the work is a
// bit-stream state machine with data-dependent reads, one serial chain
// per block.  Batch-8 512x512 with 32x32 blocks is 2048 lanes, only 16
// CTAs of 128 threads on 132 SMs.  Finer-grained parallelism (several
// threads per block, or many more blocks per launch) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define HT_N_CTX 8
#define HT_MAX_GW 32          // blocks are at most 64 wide

struct MelState {
    int k, run, pend, bp;
};

struct Stream {
    const uint8_t* row;
    int len;
};

// 32-bit word whose bit 0 is stream bit bp; bytes past the buffer are 0.
// The low 25 bits are always valid, which every read below needs at most.
__device__ __forceinline__ uint32_t bits_at(Stream s, int bp)
{
    int off = bp >> 3;
    uint32_t w = 0;
#pragma unroll
    for (int i = 0; i < 4; i++) {
        int j = off + i;
        uint32_t b = (j < s.len) ? (uint32_t)s.row[j] : 0u;
        w |= b << (8 * i);
    }
    return w >> (bp & 7);
}

__device__ __forceinline__ uint32_t shl32(uint32_t x, int s)
{
    return s >= 32 ? 0u : (x << s);
}

// One MEL event.  Spec polarity: a 1-bit closes a full run of 2^e zero
// events; a 0-bit is a miss followed by e MSB-first partial-run bits.
__device__ __forceinline__ int mel_event(bool mask, MelState& m, Stream s)
{
    if (!mask)
        return 0;
    if (m.run > 0) {                 // owed zero events of a full run
        m.run -= 1;
        return 0;
    }
    if (m.pend == 1) {               // the event closing a partial run
        m.pend = 0;
        return 1;
    }
    int k = m.k;
    int e = k >= 12 ? 5 : k >= 11 ? 4 : k >= 9 ? 3 : k >= 6 ? 2
                                                   : k >= 3 ? 1 : 0;
    uint32_t w6 = bits_at(s, m.bp);
    uint32_t x5 = (w6 >> 1) & 31u;
    uint32_t r5 = ((x5 & 1u) << 4) | ((x5 & 2u) << 2) | (x5 & 4u)
        | ((x5 & 8u) >> 2) | ((x5 >> 4) & 1u);
    int rfld = (int)(r5 >> (5 - e));
    if (w6 & 1u) {                   // full run
        m.bp += 1;
        m.k = min(k + 1, 12);
        m.run = (1 << e) - 1;
        return 0;
    }
    m.bp += 1 + e;                   // miss
    m.k = max(k - 1, 0);
    if (rfld > 0) {
        m.run = rfld - 1;
        m.pend = 1;
        return 0;
    }
    return 1;
}

// MEL significance event (context-0 quads) + CxtVLC symbol of one quad.
__device__ __forceinline__ int quad_sym(bool initial, int left, int top,
                                        int topr, MelState& mel,
                                        Stream smel, int& vlc_bp,
                                        Stream svlc, const int* lut,
                                        int symb, int nfam)
{
    int c = ((left & 0xC) != 0) | (((top & 0xA) != 0) << 1)
        | (((topr & 0x2) != 0) << 2);
    if (c == 0 && mel_event(true, mel, smel) == 0)
        return 0;                    // insignificant quad: no VLC read
    uint32_t w7 = bits_at(svlc, vlc_bp) & 0x7Fu;
    int fam = (nfam == 2 && initial) ? HT_N_CTX : 0;
    int entry = lut[((fam + c) << 7) | (int)w7];
    vlc_bp += (entry >> symb) & 7;
    return entry & ((1 << symb) - 1);
}

// UVLC prefix class at bit 0 (polarity pxor applied): len, base, suffix.
__device__ __forceinline__ void pclass(uint32_t wv, int pxor, int& ln,
                                       int& base, int& sl)
{
    wv ^= (uint32_t)pxor;
    int b0 = wv & 1u, b1 = (wv >> 1) & 1u, b2 = (wv >> 2) & 1u;
    ln = b0 == 0 ? 1 : (b1 == 0 ? 2 : 3);
    base = b0 == 0 ? 1 : (b1 == 0 ? 2 : (b2 == 0 ? 3 : 5));
    sl = b0 == 0 ? 0 : (b1 == 0 ? 0 : (b2 == 0 ? 1 : 5));
}

// Pair-coupled UVLC (t1ht.scalar._read_u_pair): prefixes, then suffixes.
// In the initial quad row with both u_off set, the MEL event evu adds 2
// to both u; when it is clear, a 3-bit first prefix implies u1 <= 2,
// coded in one bit.  No 13-bit escape: the serving scope keeps u <= 24.
__device__ __forceinline__ void uvlc_pair(bool initial, int evu, bool off0,
                                          bool off1, int& vlc_bp,
                                          Stream svlc, int pxor, int& u0,
                                          int& u1)
{
    uint32_t w = bits_at(svlc, vlc_bp);
    bool both = off0 && off1;
    int l0c, base0, sl0c;
    pclass(w, pxor, l0c, base0, sl0c);
    int el0 = off0 ? l0c : 0;
    uint32_t w1 = w >> el0;
    bool quirk = initial && both && evu == 0 && l0c == 3;
    int l1c, base1c, sl1c;
    pclass(w1, pxor, l1c, base1c, sl1c);
    int base1 = quirk ? (int)(w1 & 1u) + 1 : base1c;
    int el1 = off1 ? (quirk ? 1 : l1c) : 0;
    int esl0 = off0 ? sl0c : 0;
    int esl1 = off1 ? (quirk ? 0 : sl1c) : 0;
    int sfx0 = (int)((w >> (el0 + el1)) & ((1u << esl0) - 1u));
    int sfx1 = (int)((w >> (el0 + el1 + esl0)) & ((1u << esl1) - 1u));
    int add = (initial && both && evu == 1) ? 2 : 0;
    u0 = off0 ? base0 + sfx0 + add : 0;
    u1 = off1 ? base1 + sfx1 + add : 0;
    vlc_bp += el0 + el1 + esl0 + esl1;
}

// Four MagSgn reads of U - eps_k bits for the quad's significant samples
// (EMB known-MSB restore), written into the output block; returns the
// quad's state word (ebot << 4) | rho, ebot from the bottom samples only.
__device__ __forceinline__ int magsgn_quad(int sym, int top_p, int u,
                                           int& ms_bp, Stream sms, int p1,
                                           uint32_t half, int* o, int W,
                                           int x0, int y0, int bw, int bh)
{
    int rho = sym & 0xF;
    int eb_above = top_p >> 4;
    bool multi = (rho & (rho - 1)) != 0;
    int kappa = multi ? max(1, eb_above - 1) : 1;
    int U = min(kappa + u, 25);      // bounds shifts on corrupt streams
    int ek = sym >> 5;
    int ebot = 0;
#pragma unroll
    for (int i = 0; i < 4; i++) {
        if (!((rho >> i) & 1))
            continue;
        int k_i = (ek >> i) & 1;
        int m = U - k_i;
        uint32_t w = bits_at(sms, ms_bp);
        uint32_t full = (w & ((1u << m) - 1u)) | ((uint32_t)k_i << (U - 1));
        ms_bp += m;
        uint32_t mag2 = shl32((full >> 1) + 1u, p1) + half;
        int v = (full & 1u) ? (int)(0u - mag2) : (int)mag2;
        // quad scan order n0=(0,0) n1=(1,0) n2=(0,1) n3=(1,1)
        int x = x0 + (i >> 1), y = y0 + (i & 1);
        if (x < bw && y < bh)
            o[y * W + x] = v;
        if (i & 1)
            ebot = max(ebot, 32 - __clz(full));
    }
    return rho | (ebot << 4);
}

__global__ void __launch_bounds__(128)
ht_cleanup_kernel(const uint8_t* __restrict__ ms, int ms_len,
                  const uint8_t* __restrict__ mel, int mel_len,
                  const uint8_t* __restrict__ vlc, int vlc_len,
                  const int* __restrict__ pv, const int* __restrict__ wv,
                  const int* __restrict__ hv, const int* __restrict__ valid,
                  const int* __restrict__ lut_g, int lut_n, int symb,
                  int nfam, int pxor, int* __restrict__ out, int nl, int W,
                  int H)
{
    extern __shared__ int lut[];
    for (int i = threadIdx.x; i < lut_n; i += blockDim.x)
        lut[i] = lut_g[i];
    __syncthreads();

    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= nl || valid[lane] != 1)
        return;
    int w = min(wv[lane], W), h = min(hv[lane], H);
    if (w <= 0 || h <= 0)
        return;
    int p = pv[lane];
    int p1 = p + 1;
    uint32_t half = p > 0 ? shl32(1u, p) : 0u;
    Stream sms = { ms + (size_t)lane * ms_len, ms_len };
    Stream smel = { mel + (size_t)lane * mel_len, mel_len };
    Stream svlc = { vlc + (size_t)lane * vlc_len, vlc_len };
    int* o = out + (size_t)lane * W * H;

    int gw = (w + 1) >> 1, gh = (h + 1) >> 1;
    int rows[2][HT_MAX_GW + 2];
    for (int j = 0; j < HT_MAX_GW + 2; j++)
        rows[0][j] = 0;
    MelState m = { 0, 0, 0, 0 };
    int ms_bp = 0, vlc_bp = 0;

    for (int g = 0; g < gh; g++) {
        const int* prev = rows[g & 1];
        int* cur = rows[(g + 1) & 1];
        for (int j = 0; j < gw + 2; j++)
            cur[j] = 0;
        bool initial = g == 0;
        for (int qx0 = 0; qx0 < gw; qx0 += 2) {
            int qx1 = qx0 + 1;
            bool has1 = qx1 < gw;
            int top0 = prev[qx0 + 1];
            int sym0 = quad_sym(initial, cur[qx0] & 0xF, top0 & 0xF,
                                prev[qx0 + 2] & 0xF, m, smel, vlc_bp, svlc,
                                lut, symb, nfam);
            int top1 = 0, sym1 = 0;
            if (has1) {
                top1 = prev[qx1 + 1];
                sym1 = quad_sym(initial, sym0 & 0xF, top1 & 0xF,
                                prev[qx1 + 2] & 0xF, m, smel, vlc_bp, svlc,
                                lut, symb, nfam);
            }
            bool off0 = (sym0 & 0x10) != 0, off1 = (sym1 & 0x10) != 0;
            // initial-row-pair MEL event (both u_off = 1 only)
            int evu = mel_event(initial && off0 && off1, m, smel);
            int u0, u1;
            uvlc_pair(initial, evu, off0, off1, vlc_bp, svlc, pxor, u0, u1);
            cur[qx0 + 1] = magsgn_quad(sym0, top0, u0, ms_bp, sms, p1, half,
                                       o, W, 2 * qx0, 2 * g, w, h);
            if (has1)
                cur[qx1 + 1] = magsgn_quad(sym1, top1, u1, ms_bp, sms, p1,
                                           half, o, W, 2 * qx1, 2 * g, w, h);
        }
    }
}

extern "C" int grk_ht_decode_cleanup(const void* ms, int ms_len,
                                     const void* mel, int mel_len,
                                     const void* vlc, int vlc_len,
                                     const void* p, const void* w,
                                     const void* h, const void* valid,
                                     const void* lut, int lut_n, int symb,
                                     int nfam, int pxor, void* out, int nl,
                                     int W, int H, void* stream)
{
    if (nl <= 0)
        return 0;
    const int threads = 128;
    int blocks = (nl + threads - 1) / threads;
    size_t smem = (size_t)lut_n * sizeof(int);
    ht_cleanup_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)ms, ms_len, (const uint8_t*)mel, mel_len,
        (const uint8_t*)vlc, vlc_len, (const int*)p, (const int*)w,
        (const int*)h, (const int*)valid, (const int*)lut, lut_n, symb, nfam,
        pxor, (int*)out, nl, W, H);
    return (int)cudaGetLastError();
}
