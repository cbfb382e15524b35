// The first design of the HTJ2K encode kernels K4 (cleanup,
// `ht_encode_kernel_v1`) and K4r (cleanup, HT SigProp and HT MagRef,
// `ht_encode_refine_kernel_v1`): one thread per code-block.  The kernels
// in use are csrc/ht_encode.cu (one warp per code-block); this file is
// kept as their full-lane oracle and timing yardstick, reached only
// through grok_tpu_torch/ops/ht_encode.py `ht_encode_lanes_v1`, which
// chip_smoke.py and grok_tpu_torch/tools/hw_validate.py call.  Its
// contract is that of ht_encode.cu, except that K4r writes only the 1s of
// ns: the caller zeroes it.
//
// Replaces the Pallas TPU kernel grok_tpu/ops/pallas_ht_enc.py
// `_ht_encode_jit` (refine=False, reached through `pallas_ht_encode`),
// with the same contract: per lane, mneg = (magnitude << 1) | sign as an
// (NL, H, W) int32 block, the cleanup plane p, the block size and a
// valid flag in; the clean LSB-first MagSgn, MEL and VLC sub-streams and
// their bit counts out, byte-identical to the streams
// grok_tpu/t1ht/scalar.py `ht_encode_block` hands to assemble_cleanup.
//
// Design.  One thread encodes one code-block, quad pair by quad pair, in
// the order of the scalar coder.  Its state lives in registers and local
// memory: the MEL run-length state (k, run), two rows of
// (ebot << 4) | rho words of GW + 2 entries (the quad row above for the
// context and kappa, the current one for the left neighbour), and one
// 64-bit accumulator per stream that is flushed to global memory as
// whole 32-bit words, so each output word is stored once.  Stores stop
// at a stream's capacity: an overflowing stream reports -1 bits.  The
// CxtVLC encode table (nfam * 8 << symb int32) is copied into shared
// memory at block start.
//
// Bound.  Serial encode latency per block and occupancy: one serial
// chain per block, one block per thread, 128 threads per CTA.

#include <cuda_runtime.h>
#include <stdint.h>

#define HT_N_CTX 8
#define HT_MAX_GW 32          // blocks are at most 64 wide

__constant__ int c_mel_e[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5};

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
    int e = c_mel_e[m.k];
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

// UVLC of one quad pair.  Both u_off: prefixes then suffixes; in the
// initial quad row a MEL event codes whether both u > 2 (then u - 2 is
// coded); when it is clear, a 3-bit first prefix implies u1 <= 2, coded
// in one raw bit.
__device__ __forceinline__ void emit_u_pair(Sink& vlc, Mel& mel, Sink& smel,
                                            bool initial, int u0, bool off0,
                                            int u1, bool off1, int pxor)
{
    int l0 = 0, p0 = 0, s0 = 0, sb0 = 0, l1 = 0, p1 = 0, s1 = 0, sb1 = 0;
    if (off0 && off1) {
        if (initial) {
            bool big = u0 > 2 && u1 > 2;
            mel_encode(mel, smel, big ? 1 : 0);
            if (big) {
                uvlc_parts(u0 - 2, pxor, l0, p0, s0, sb0);
                uvlc_parts(u1 - 2, pxor, l1, p1, s1, sb1);
            } else {
                uvlc_parts(u0, pxor, l0, p0, s0, sb0);
                if (l0 == 3) {
                    l1 = 1; p1 = u1 - 1; s1 = 0; sb1 = 0;
                } else {
                    uvlc_parts(u1, pxor, l1, p1, s1, sb1);
                }
            }
        } else {
            uvlc_parts(u0, pxor, l0, p0, s0, sb0);
            uvlc_parts(u1, pxor, l1, p1, s1, sb1);
        }
        sink_put(vlc, (uint32_t)p0, l0);
        sink_put(vlc, (uint32_t)p1, l1);
        sink_put(vlc, (uint32_t)sb0, s0);
        sink_put(vlc, (uint32_t)sb1, s1);
    } else if (off0 || off1) {
        uvlc_parts(off0 ? u0 : u1, pxor, l0, p0, s0, sb0);
        sink_put(vlc, (uint32_t)p0, l0);
        sink_put(vlc, (uint32_t)sb0, s0);
    }
}

// Significance, CxtVLC codeword and MagSgn fields of one quad; the MEL
// significance event for context-0 quads.  Writes the quad's state word
// into cur[qx + 1] and returns u (u_off = u > 0).
__device__ __forceinline__ int code_quad(const int* blk, int W, int bw,
                                         int bh, int p, int g, int qx,
                                         const int* prev, int* cur,
                                         Mel& mel, Sink& smel, Sink& svlc,
                                         Sink& sms, const int* lut,
                                         int symb, int famoff)
{
    int rho = 0, ebot = 0, uact = 0;
    uint32_t v[4];
    int e[4];
#pragma unroll
    for (int i = 0; i < 4; i++) {
        // quad scan order n0=(0,0) n1=(1,0) n2=(0,1) n3=(1,1), (dy, dx)
        int y = 2 * g + (i & 1), x = 2 * qx + (i >> 1);
        v[i] = 0;
        e[i] = 0;
        if (y < bh && x < bw) {
            int mn = blk[y * W + x];
            uint32_t vq = ((uint32_t)mn >> 1) >> p;
            if (vq > 0) {
                rho |= 1 << i;
                v[i] = ((vq - 1u) << 1) | ((uint32_t)mn & 1u);
                e[i] = 32 - __clz(v[i]);
                uact = max(uact, e[i]);
                if (i & 1)
                    ebot = max(ebot, e[i]);
            }
        }
    }
    cur[qx + 1] = rho | (ebot << 4);
    int rl = cur[qx] & 0xF;
    int ra = prev[qx + 1] & 0xF;
    int rar = prev[qx + 2] & 0xF;
    int c = ((rl & 0xC) != 0) | (((ra & 0xA) != 0) << 1)
        | (((rar & 0x2) != 0) << 2);
    int base = (famoff + c) << symb;
    if (c == 0) {
        mel_encode(mel, smel, rho != 0);
        if (rho == 0)
            return 0;
    }
    if (rho == 0) {
        int ent = lut[base];
        sink_put(svlc, (uint32_t)(ent & 0x7F), ent >> 7);
        return 0;
    }
    int eab = prev[qx + 1] >> 4;
    int kappa = (rho & (rho - 1)) ? max(1, eab - 1) : 1;
    int U = max(kappa, uact);
    int u = U - kappa;
    int sym = ((u > 0) << 4) | rho;
    int ek = 0;
#pragma unroll
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
#pragma unroll
    for (int i = 0; i < 4; i++)
        if ((rho >> i) & 1)
            sink_put(sms, v[i], U - ((ek >> i) & 1));
    return u;
}

// The cleanup pass of one valid lane: its three streams at o, their bit
// counts at bits[lane], bits[nl + lane], bits[2 nl + lane].
__device__ void encode_cleanup(const int* blk, int W, int w, int h, int p,
                               const int* lut, int symb, int nfam, int pxor,
                               uint8_t* o, int lms, int lmel, int lvlc,
                               int* bits, int nl, int lane)
{
    Sink sms = { (uint32_t*)o, lms / 4, 0, 0ull, 0, 0, false };
    Sink smel = { (uint32_t*)(o + lms), lmel / 4, 0, 0ull, 0, 0, false };
    Sink svlc = { (uint32_t*)(o + lms + lmel), lvlc / 4, 0, 0ull, 0, 0,
                  false };
    Mel mel = { 0, 0 };

    int gw = (w + 1) >> 1, gh = (h + 1) >> 1;
    int rows[2][HT_MAX_GW + 2];
    for (int j = 0; j < HT_MAX_GW + 2; j++)
        rows[0][j] = 0;
    for (int g = 0; g < gh; g++) {
        const int* prev = rows[g & 1];
        int* cur = rows[(g + 1) & 1];
        for (int j = 0; j < gw + 2; j++)
            cur[j] = 0;
        bool initial = g == 0;
        int famoff = (nfam == 2 && initial) ? HT_N_CTX : 0;
        for (int qx0 = 0; qx0 < gw; qx0 += 2) {
            int u0 = code_quad(blk, W, w, h, p, g, qx0, prev, cur, mel,
                               smel, svlc, sms, lut, symb, famoff);
            int u1 = 0;
            if (qx0 + 1 < gw)
                u1 = code_quad(blk, W, w, h, p, g, qx0 + 1, prev, cur, mel,
                               smel, svlc, sms, lut, symb, famoff);
            if (u0 > 0 || u1 > 0)
                emit_u_pair(svlc, mel, smel, initial, u0, u0 > 0, u1,
                            u1 > 0, pxor);
        }
    }
    if (mel.run > 0)                 // a pending run as a claimed full run
        sink_put(smel, 1u, 1);
    bits[lane] = sink_finish(sms);
    bits[nl + lane] = sink_finish(smel);
    bits[2 * nl + lane] = sink_finish(svlc);
}

__global__ void __launch_bounds__(128)
ht_encode_kernel_v1(const int* __restrict__ mneg, const int* __restrict__ pv,
                 const int* __restrict__ wv, const int* __restrict__ hv,
                 const int* __restrict__ valid,
                 const int* __restrict__ lut_g, int lut_n, int symb,
                 int nfam, int pxor, uint8_t* __restrict__ out, int row,
                 int lms, int lmel, int lvlc, int* __restrict__ bits,
                 int nl, int W, int H)
{
    extern __shared__ int lut[];
    for (int i = threadIdx.x; i < lut_n; i += blockDim.x)
        lut[i] = lut_g[i];
    __syncthreads();

    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= nl)
        return;
    int w = min(wv[lane], W), h = min(hv[lane], H);
    if (valid[lane] != 1 || w <= 0 || h <= 0) {
        bits[lane] = bits[nl + lane] = bits[2 * nl + lane] = 0;
        return;
    }
    encode_cleanup(mneg + (size_t)lane * W * H, W, w, h, pv[lane], lut,
                   symb, nfam, pxor, out + (size_t)lane * row, lms, lmel,
                   lvlc, bits, nl, lane);
}

// ---- K4r: HT SigProp + HT MagRef at plane p - 1 -----------------------
//
// Replaces the refine=True variant of the same Pallas kernel
// (`_ht_encode_jit`, grok_tpu/ops/pallas_ht_enc.py:722-807), byte-
// identical to grok_tpu/t1ht/scalar.py `_encode_sigprop` and
// `_encode_magref`; the plain version is ht_encode.py
// `ht_refine_lanes_ref` after `ht_encode_lanes_ref`.  The same thread
// codes the lane's cleanup, then scans it twice in 4-row stripes
// (columns left to right, rows top to bottom within a stripe column),
// with the lane's significance as one 64-bit word per row in local
// memory: a 3 x 3 neighbourhood test is three shifts.  SigProp sets the
// bits of the samples it makes significant (causal for the rest of the
// scan) and writes them to ns; MagRef reads the cleanup significance
// again from the samples.  No TPU staging (16-word windows, H >= 4
// padding of the stripe loops) is carried over.  Bound as for the
// cleanup: one serial chain per lane.

// bits x-1, x, x+1 of a row word (0 beyond the row)
__device__ __forceinline__ uint64_t nb3(uint64_t row, int x)
{
    return (x > 0 ? row >> (x - 1) : row << 1) & 7ull;
}

__global__ void __launch_bounds__(128)
ht_encode_refine_kernel_v1(const int* __restrict__ mneg,
                        const int* __restrict__ pv,
                        const int* __restrict__ wv,
                        const int* __restrict__ hv,
                        const int* __restrict__ valid,
                        const int* __restrict__ lut_g, int lut_n, int symb,
                        int nfam, int pxor, uint8_t* __restrict__ out,
                        int row, int lms, int lmel, int lvlc, int lsp,
                        int lmr, int* __restrict__ bits,
                        uint8_t* __restrict__ ns, int nl, int W, int H)
{
    extern __shared__ int lut[];
    for (int i = threadIdx.x; i < lut_n; i += blockDim.x)
        lut[i] = lut_g[i];
    __syncthreads();

    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= nl)
        return;
    int w = min(wv[lane], W), h = min(hv[lane], H);
    if (valid[lane] != 1 || w <= 0 || h <= 0) {
        for (int s = 0; s < 5; s++)
            bits[s * nl + lane] = 0;
        return;
    }
    const int* blk = mneg + (size_t)lane * W * H;
    uint8_t* o = out + (size_t)lane * row;
    int p = pv[lane];
    encode_cleanup(blk, W, w, h, p, lut, symb, nfam, pxor, o, lms, lmel,
                   lvlc, bits, nl, lane);
    if (p <= 0) {
        bits[3 * nl + lane] = bits[4 * nl + lane] = 0;
        return;
    }
    int bp = p - 1;
    uint64_t sg[64];                 // significance, one word per row
    for (int y = 0; y < h; y++) {
        uint64_t r = 0;
        for (int x = 0; x < w; x++)
            if ((((uint32_t)blk[y * W + x] >> 1) >> p) > 0)
                r |= 1ull << x;
        sg[y] = r;
    }
    uint8_t* nsl = ns + (size_t)lane * W * H;
    Sink ssp = { (uint32_t*)(o + lms + lmel + lvlc), lsp / 4, 0, 0ull, 0, 0,
                 false };
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
                uint32_t mn = (uint32_t)blk[y * W + x];
                uint32_t bit = ((mn >> 1) >> bp) & 1u;
                sink_put(ssp, bit | ((mn & 1u) << 1), 1 + (int)bit);
                if (bit) {
                    sg[y] |= 1ull << x;
                    nsl[y * W + x] = 1;
                }
            }
    bits[3 * nl + lane] = sink_finish(ssp);

    Sink smr = { (uint32_t*)(o + lms + lmel + lvlc + lsp), lmr / 4, 0, 0ull,
                 0, 0, false };
    for (int y0 = 0; y0 < h; y0 += 4)
        for (int x = 0; x < w; x++)
            for (int y = y0; y < min(y0 + 4, h); y++) {
                uint32_t mag = (uint32_t)blk[y * W + x] >> 1;
                if ((mag >> p) > 0)
                    sink_put(smr, (mag >> bp) & 1u, 1);
            }
    bits[4 * nl + lane] = sink_finish(smr);
}

extern "C" int grk_ht_encode_cleanup_v1(const void* mneg, const void* p,
                                     const void* w, const void* h,
                                     const void* valid, const void* lut,
                                     int lut_n, int symb, int nfam, int pxor,
                                     void* out, int row, int lms, int lmel,
                                     int lvlc, void* bits, int nl, int W,
                                     int H, void* stream)
{
    if (nl <= 0)
        return 0;
    const int threads = 128;
    int blocks = (nl + threads - 1) / threads;
    size_t smem = (size_t)lut_n * sizeof(int);
    ht_encode_kernel_v1<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        (const int*)mneg, (const int*)p, (const int*)w, (const int*)h,
        (const int*)valid, (const int*)lut, lut_n, symb, nfam, pxor,
        (uint8_t*)out, row, lms, lmel, lvlc, (int*)bits, nl, W, H);
    return (int)cudaGetLastError();
}

// ns must be zeroed by the caller: the kernel writes only its 1s.
extern "C" int grk_ht_encode_refine_v1(const void* mneg, const void* p,
                                    const void* w, const void* h,
                                    const void* valid, const void* lut,
                                    int lut_n, int symb, int nfam, int pxor,
                                    void* out, int row, int lms, int lmel,
                                    int lvlc, int lsp, int lmr, void* bits,
                                    void* ns, int nl, int W, int H,
                                    void* stream)
{
    if (nl <= 0)
        return 0;
    const int threads = 128;
    int blocks = (nl + threads - 1) / threads;
    size_t smem = (size_t)lut_n * sizeof(int);
    ht_encode_refine_kernel_v1<<<blocks, threads, smem,
                              (cudaStream_t)stream>>>(
        (const int*)mneg, (const int*)p, (const int*)w, (const int*)h,
        (const int*)valid, (const int*)lut, lut_n, symb, nfam, pxor,
        (uint8_t*)out, row, lms, lmel, lvlc, lsp, lmr, (int*)bits,
        (uint8_t*)ns, nl, W, H);
    return (int)cudaGetLastError();
}
