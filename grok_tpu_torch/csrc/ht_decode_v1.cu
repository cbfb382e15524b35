// The first design of the HTJ2K decode kernels K1 (cleanup,
// `ht_cleanup_kernel_v1`) and K2 (cleanup, HT SigProp and HT MagRef,
// `ht_refine_kernel_v1`): one thread per code-block.  The kernels in use
// are csrc/ht_decode.cu (one warp per code-block); this file is kept as
// their full-lane oracle and timing yardstick, reached only through
// grok_tpu_torch/ops/ht_decode.py `ht_decode_lanes_v1`, which
// chip_smoke.py and grok_tpu_torch/tools/hw_validate.py call.  Its
// contract is that of ht_decode.cu, except that it writes only the
// significant samples: the caller zeroes the output.
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
// device memory and reads 0 past the lane's buffer.  The CxtVLC decode
// table (nfam * 8 * 128 int32) is copied into shared memory at block
// start.
//
// Bound.  Serial decode latency per block, and occupancy: one serial
// chain per block, one block per thread, 128 threads per CTA.

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

// The cleanup pass of one valid lane into its (H, W) output block o.
__device__ void decode_cleanup(Stream sms, Stream smel, Stream svlc, int p,
                               int w, int h, const int* lut, int symb,
                               int nfam, int pxor, int* o, int W)
{
    int p1 = p + 1;
    uint32_t half = p > 0 ? shl32(1u, p) : 0u;

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

__global__ void __launch_bounds__(128)
ht_cleanup_kernel_v1(const uint8_t* __restrict__ ms, int ms_len,
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
    Stream sms = { ms + (size_t)lane * ms_len, ms_len };
    Stream smel = { mel + (size_t)lane * mel_len, mel_len };
    Stream svlc = { vlc + (size_t)lane * vlc_len, vlc_len };
    decode_cleanup(sms, smel, svlc, pv[lane], w, h, lut, symb, nfam, pxor,
                   out + (size_t)lane * W * H, W);
}

// ---- K2: cleanup, then HT SigProp and HT MagRef at plane p - 1 --------
//
// Replaces the refine=True variant of the same Pallas kernel
// (`_ht_decode_jit` via `pallas_ht_decode_refine`, grok_tpu/ops/
// pallas_ht.py:293 and :722-818), bit-exact to grok_tpu/t1ht/scalar.py
// `ht_decode_block` for 2- and 3-pass blocks; the plain version is
// ht_decode.py `ht_decode_lanes_ref` with sp, mr and npass.  The same
// thread decodes the lane's cleanup into its output block, then scans it
// in 4-row stripes (columns left to right, rows top to bottom within a
// stripe column): SigProp reads one significance bit for each
// insignificant sample with a significant 3 x 3 neighbour (and its sign
// when set), setting it to +-((1 << p) + half_bp); MagRef appends one
// magnitude bit to each sample the cleanup made significant.  The
// significance lives in local memory as one 64-bit word per row for the
// whole scan (sg) plus the cleanup's own (cs), so a neighbourhood test
// is three shifts; the refinement streams are read like the cleanup's,
// four bytes straight from device memory per read, 0 past the buffer.
// The TPU kernel's staged windows and its H >= 4 padding of the stripe
// loops are not carried over.  Bound as for the cleanup: one serial
// chain per lane.

// bits x-1, x, x+1 of a row word (0 beyond the row)
__device__ __forceinline__ uint64_t nb3(uint64_t row, int x)
{
    return (x > 0 ? row >> (x - 1) : row << 1) & 7ull;
}

__global__ void __launch_bounds__(128)
ht_refine_kernel_v1(const uint8_t* __restrict__ ms, int ms_len,
                    const uint8_t* __restrict__ mel, int mel_len,
                    const uint8_t* __restrict__ vlc, int vlc_len,
                    const int* __restrict__ pv, const int* __restrict__ wv,
                    const int* __restrict__ hv, const int* __restrict__ valid,
                    const int* __restrict__ lut_g, int lut_n, int symb,
                    int nfam, int pxor, int* __restrict__ out, int nl, int W,
                    int H, const uint8_t* __restrict__ sp, int sp_len,
                    const uint8_t* __restrict__ mr, int mr_len,
                    const int* __restrict__ npv)
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
    Stream sms = { ms + (size_t)lane * ms_len, ms_len };
    Stream smel = { mel + (size_t)lane * mel_len, mel_len };
    Stream svlc = { vlc + (size_t)lane * vlc_len, vlc_len };
    int* o = out + (size_t)lane * W * H;
    decode_cleanup(sms, smel, svlc, p, w, h, lut, symb, nfam, pxor, o, W);
    int np = npv[lane];
    if (np < 2 || p <= 0)
        return;

    uint32_t half = shl32(1u, p);
    uint32_t half_bp = p > 1 ? shl32(1u, p - 1) : 0u;
    uint64_t sg[64], cs[64];
    for (int y = 0; y < h; y++) {
        uint64_t r = 0;
        for (int x = 0; x < w; x++)
            if (o[y * W + x] != 0)
                r |= 1ull << x;
        sg[y] = cs[y] = r;
    }

    Stream ssp = { sp + (size_t)lane * sp_len, sp_len };
    uint32_t mag_new = half + half_bp;
    int bp = 0;
    for (int y0 = 0; y0 < h; y0 += 4)
        for (int x = 0; x < w; x++)
            for (int y = y0; y < min(y0 + 4, h); y++) {
                if ((sg[y] >> x) & 1ull)
                    continue;
                uint64_t n = nb3(sg[y], x);
                if (y > 0)
                    n |= nb3(sg[y - 1], x);
                if (y + 1 < h)
                    n |= nb3(sg[y + 1], x);
                if (!n)
                    continue;
                uint32_t w2 = bits_at(ssp, bp);
                if (!(w2 & 1u)) {
                    bp += 1;
                    continue;
                }
                bp += 2;
                o[y * W + x] = (w2 & 2u) ? (int)(0u - mag_new)
                                         : (int)mag_new;
                sg[y] |= 1ull << x;
            }
    if (np < 3)
        return;

    Stream smr = { mr + (size_t)lane * mr_len, mr_len };
    bp = 0;
    for (int y0 = 0; y0 < h; y0 += 4)
        for (int x = 0; x < w; x++)
            for (int y = y0; y < min(y0 + 4, h); y++) {
                if (!((cs[y] >> x) & 1ull))
                    continue;
                uint32_t bit = bits_at(smr, bp) & 1u;
                bp += 1;
                int cur = o[y * W + x];
                uint32_t av = cur < 0 ? 0u - (uint32_t)cur : (uint32_t)cur;
                uint32_t vq = (av - half) >> (p + 1);
                uint32_t nm = shl32((vq << 1) | bit, p) + half_bp;
                o[y * W + x] = cur < 0 ? (int)(0u - nm) : (int)nm;
            }
}

extern "C" int grk_ht_decode_cleanup_v1(const void* ms, int ms_len,
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
    ht_cleanup_kernel_v1<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)ms, ms_len, (const uint8_t*)mel, mel_len,
        (const uint8_t*)vlc, vlc_len, (const int*)p, (const int*)w,
        (const int*)h, (const int*)valid, (const int*)lut, lut_n, symb, nfam,
        pxor, (int*)out, nl, W, H);
    return (int)cudaGetLastError();
}

// out must be zeroed by the caller: the kernel writes significant samples
// only.
extern "C" int grk_ht_decode_refine_v1(const void* ms, int ms_len,
                                       const void* mel, int mel_len,
                                       const void* vlc, int vlc_len,
                                       const void* p, const void* w,
                                       const void* h, const void* valid,
                                       const void* lut, int lut_n, int symb,
                                       int nfam, int pxor, void* out, int nl,
                                       int W, int H, const void* sp,
                                       int sp_len,
                                       const void* mr, int mr_len,
                                       const void* npass, void* stream)
{
    if (nl <= 0)
        return 0;
    const int threads = 128;
    int blocks = (nl + threads - 1) / threads;
    size_t smem = (size_t)lut_n * sizeof(int);
    ht_refine_kernel_v1<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)ms, ms_len, (const uint8_t*)mel, mel_len,
        (const uint8_t*)vlc, vlc_len, (const int*)p, (const int*)w,
        (const int*)h, (const int*)valid, (const int*)lut, lut_n, symb, nfam,
        pxor, (int*)out, nl, W, H, (const uint8_t*)sp, sp_len,
        (const uint8_t*)mr, mr_len, (const int*)npass);
    return (int)cudaGetLastError();
}
