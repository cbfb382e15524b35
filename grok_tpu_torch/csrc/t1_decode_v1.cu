// Part-1 (EBCOT Tier-1 + MQ arithmetic coder) decode of a batch of
// code-blocks, with every mode switch of the code-block style: the first
// design (v1), one thread per code-block.  The serving paths run the
// redesign in csrc/t1_decode.cu (v2, one warp per code-block); v1 stays
// as the full-lane oracle and the speed yardstick of v2 on the card,
// reached only through grok_tpu_torch/ops/t1_decode.py
// `t1_decode_lanes_v1` (chip_smoke.py and the hardware-validation tool).
// It compiles against its own copy of the shared helpers,
// csrc/t1_common_v1.cuh.
//
// Replaces the Pallas TPU kernel grok_tpu/ops/pallas_t1.py
// `pallas_t1_decode`, with its contract: per lane, the codeword bytes,
// the pass count, the magnitude bitplane count, the band orientation,
// the block size and the style bits in, and the signed reconstruction
// mag2 = +-(known bits * 2 + half bit at the last decoded plane) out,
// as grok_tpu/t1/t1_scalar.py `decode_block` returns it.  The mode
// switches: BYPASS raw segments, TERMALL and other multi-segment
// codewords through the per-lane segment table (start offset, end
// offset, raw flag per pass), RESET (context re-init per pass), VSC (the
// below-stripe neighbours masked at stripe row 3) and SEGSYM (four UNI
// decisions after each cleanup).  Reads past a segment's end see 0xFF
// (MQ, C.3.4) or 0 bits (raw).  The plain PyTorch version is
// grok_tpu_torch/ops/t1_decode.py `t1_decode_lanes_ref`; the two are
// held identical on the card.
//
// Design.  One thread decodes one code-block, pass by pass in the scalar
// decoder's order, reading its bytes straight from the uploaded body at
// the lane's start offset.  The MQ register state (A, C, CT, the byte
// pointer, the segment end), the raw reader and the 19 context states
// live in registers and local memory; the packed neighbour-flag words of
// the lane (t1_common.cuh) are a scratch region in device memory,
// lane-major, (h + 2) x (w + 2) words; the reconstruction accumulates in
// the lane's output block and takes its signs at the end.  The context
// LUT and the MQ table are copied into shared memory at block start.
// None of the TPU kernel's staging (quad-packed byte windows, the mid
// scratch, class-split context banks, sublane batching) is carried over.
//
// Bound.  Serial decoding latency per block and occupancy, as for the
// encoder (csrc/t1_encode.cu): a chain of dependent MQ decisions per
// block and a few thousand lanes per batch.

#include "t1_common_v1.cuh"

struct MQDec {
    uint32_t a, c;
    int ct, bp, send;
    int rct, rbyte, rprev;    // the raw (BYPASS) reader
    const uint8_t* body;
    long long nb, start;
};

__device__ __forceinline__ int dec_byte(const MQDec& d, int i, int past)
{
    if (i >= d.send)
        return past;
    long long k = d.start + i;
    k = k < 0 ? 0 : (k >= d.nb ? d.nb - 1 : k);
    return d.body[k];
}

// C.3.4 BYTEIN.
__device__ __forceinline__ void mq_bytein(MQDec& d)
{
    int cur = dec_byte(d, d.bp, 0xFF), nxt = dec_byte(d, d.bp + 1, 0xFF);
    if (cur == 0xFF) {
        if (nxt > 0x8F) {
            d.c += 0xFF00;
            d.ct = 8;
        } else {
            d.bp += 1;
            d.c += (uint32_t)nxt << 9;
            d.ct = 7;
        }
    } else {
        d.bp += 1;
        d.c += (uint32_t)nxt << 8;
        d.ct = 8;
    }
}

// C.3.5 INITDEC at the current byte position.
__device__ __forceinline__ void mq_initdec(MQDec& d)
{
    d.a = 0x8000;
    d.c = (uint32_t)dec_byte(d, d.bp, 0xFF) << 16;
    d.ct = 0;
    mq_bytein(d);
    d.c <<= 7;
    d.ct -= 7;
}

// C.3.2 DECODE in context cx, with C.3.3 RENORMD.
__device__ __forceinline__ int mq_decode(MQDec& d, uint8_t* ctx,
                                         const uint32_t* mqt, int cx)
{
    uint8_t s = ctx[cx];
    uint32_t row = mqt[s >> 1];
    uint32_t qe = row & 0xFFFF;
    int mps = s & 1, bit;
    d.a -= qe;
    if ((d.c >> 16) < qe) {               // LPS exchange
        bool m = d.a < qe;
        bit = m ? mps : 1 - mps;
        ctx[cx] = t1_next_state(row, s, m);
        d.a = qe;
    } else {
        d.c -= qe << 16;
        if (d.a & 0x8000)
            return mps;
        bool m = d.a >= qe;
        bit = m ? mps : 1 - mps;
        ctx[cx] = t1_next_state(row, s, m);
    }
    do {
        if (d.ct == 0)
            mq_bytein(d);
        d.a = (d.a << 1) & 0xFFFF;
        d.c <<= 1;
        d.ct -= 1;
    } while (!(d.a & 0x8000));
    return bit;
}

// One raw bit, MSB first, 7 bits after an 0xFF byte.
__device__ __forceinline__ int raw_bit(MQDec& d)
{
    if (d.rct == 0) {
        int cur = dec_byte(d, d.bp, 0);
        d.rct = d.rprev == 0xFF ? 7 : 8;
        d.rbyte = cur;
        d.rprev = cur;
        d.bp += 1;
    }
    d.rct -= 1;
    return (d.rbyte >> d.rct) & 1;
}

__device__ void decode_lane(const T1Tables& t, MQDec& d, int npass,
                            int nbps, int orient, int w, int h, int style,
                            const int* ptbl, int P, int* fl, int* out,
                            int W, int H)
{
    const int s = w + 2;
    const uint8_t* zc = t.lut + (orient << 8);
    const uint8_t* sc = t.lut + 1024;
    const bool vsc = style & 0x08, reset = style & 0x02,
               segsym = style & 0x20;
    for (int i = 0; i < (h + 2) * s; i++)
        fl[i] = 0;
    for (int i = 0; i < H * W; i++)
        out[i] = 0;
    uint8_t ctx[T1_N_CTX];
    t1_reset_ctx(ctx);
    d.a = 0x8000;
    d.c = 0;
    d.ct = 0;
    d.bp = 0;
    d.send = 0;
    d.rct = d.rbyte = d.rprev = 0;

    // the flag word of (y, x), below-stripe bits masked under VSC
    auto flags = [&](int y, int x) {
        int f = fl[(y + 1) * s + x + 1];
        return (vsc && (y & 3) == 3) ? (f & VSC_MASK) : f;
    };
    // sign decision (raw or MQ) and significance of (y, x) at plane bpl
    auto sign = [&](int y, int x, int f, bool raw, int bpl) {
        int neg;
        if (raw) {
            neg = raw_bit(d);
        } else {
            int v = sc[f & 0xFFF];
            neg = mq_decode(d, ctx, t.mq, v & 15) ^ (v >> 4);
        }
        t1_mark_sig(fl, s, y, x, neg);
        out[y * W + x] = 3 << bpl;
    };

    const int last = min(npass, 3 * nbps - 2);
    for (int pno = 0; pno < last; pno++) {
        const int k = (pno + 2) / 3;
        const int ptype = pno == 0 ? 2 : (pno + 2) % 3;   // 0 SPP 1 MRP 2 CLN
        const int bpl = nbps - 1 - k;
        // open the pass: the segment table's row, RESET
        bool raw = false;
        if (pno < P) {
            const int* row = ptbl + 3 * pno;
            raw = row[2] != 0;
            if (row[0] >= 0) {
                d.send = row[1];
                d.bp = row[0];
                if (raw) {
                    d.rct = 0;
                    d.rprev = 0;
                } else {
                    mq_initdec(d);
                }
            }
        }
        if (reset && !raw)
            t1_reset_ctx(ctx);

        if (ptype == 0) {                                      // SPP
            for (int y0 = 0; y0 < h; y0 += 4)
                for (int x = 0; x < w; x++)
                    for (int y = y0; y < min(y0 + 4, h); y++) {
                        int f = flags(y, x);
                        if ((f & (F_SIG | F_VIS)) || !(f & 0xFF))
                            continue;
                        int bit = raw ? raw_bit(d)
                            : mq_decode(d, ctx, t.mq, zc[f & 0xFF]);
                        if (bit)
                            sign(y, x, f, raw, bpl);
                        fl[(y + 1) * s + x + 1] |= F_VIS;
                    }
        } else if (ptype == 1) {                               // MRP
            for (int y0 = 0; y0 < h; y0 += 4)
                for (int x = 0; x < w; x++)
                    for (int y = y0; y < min(y0 + 4, h); y++) {
                        int f = flags(y, x);
                        if (!(f & F_SIG) || (f & F_VIS))
                            continue;
                        int bit = raw ? raw_bit(d)
                            : mq_decode(d, ctx, t.mq, t1_mr_ctx(f));
                        out[y * W + x] += (bit << (bpl + 1))
                            - (1 << (bpl + 1)) + (1 << bpl);
                        fl[(y + 1) * s + x + 1] |= F_MU;
                    }
        } else {                                               // CLN
            for (int y0 = 0; y0 < h; y0 += 4) {
                for (int x = 0; x < w; x++) {
                    int y = y0;
                    if (y0 + 4 <= h
                            && !((flags(y0, x) | flags(y0 + 1, x)
                                  | flags(y0 + 2, x) | flags(y0 + 3, x))
                                 & (0xFF | F_SIG | F_VIS))) {
                        if (!mq_decode(d, ctx, t.mq, T1_CTX_RL))
                            continue;
                        int r = mq_decode(d, ctx, t.mq, T1_CTX_UNI) << 1;
                        r |= mq_decode(d, ctx, t.mq, T1_CTX_UNI);
                        sign(y0 + r, x, flags(y0 + r, x), false, bpl);
                        y = y0 + r + 1;
                    }
                    for (; y < min(y0 + 4, h); y++) {
                        int f = flags(y, x);
                        if (f & (F_SIG | F_VIS))
                            continue;
                        if (mq_decode(d, ctx, t.mq, zc[f & 0xFF]))
                            sign(y, x, f, false, bpl);
                    }
                }
            }
            if (segsym)
                for (int i = 0; i < 4; i++)
                    mq_decode(d, ctx, t.mq, T1_CTX_UNI);
            for (int y = 1; y <= h; y++)
                for (int x = 1; x <= w; x++)
                    fl[y * s + x] &= ~F_VIS;
        }
    }
    for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++)
            if (fl[(y + 1) * s + x + 1] & F_NEG)
                out[y * W + x] = -out[y * W + x];
}

__global__ void __launch_bounds__(32)
t1_decode_v1_kernel(const uint8_t* __restrict__ body, long long nb,
                 const int* __restrict__ start, const int* __restrict__ npv,
                 const int* __restrict__ nbv, const int* __restrict__ ori,
                 const int* __restrict__ wv, const int* __restrict__ hv,
                 const int* __restrict__ stv, const int* __restrict__ ptbl,
                 int P, const uint8_t* __restrict__ lut,
                 const uint32_t* __restrict__ mqt, int* __restrict__ out,
                 int* __restrict__ flags, int nl, int W, int H)
{
    __shared__ T1Tables t;
    t1_load_tables(t, lut, mqt);
    __syncthreads();
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= nl)
        return;
    int nbps = nbv[lane];
    if (nbps < 0 || nbps > 30)
        nbps = 0;                     // outside the contract: zeros
    MQDec d;
    d.body = body;
    d.nb = nb;
    d.start = start[lane];
    decode_lane(t, d, npv[lane], nbps, ori[lane] & 3,
                max(min(wv[lane], W), 1), max(min(hv[lane], H), 1),
                stv[lane], ptbl + (size_t)lane * P * 3, P,
                flags + (size_t)lane * (W + 2) * (H + 2),
                out + (size_t)lane * W * H, W, H);
}

extern "C" int grk_t1_decode_v1(const void* body, long long nb,
                             const void* start, const void* npass,
                             const void* nbps, const void* orient,
                             const void* w, const void* h,
                             const void* style, const void* ptbl, int P,
                             const void* lut, const void* mqt, void* out,
                             void* flags, int nl, int W, int H,
                             void* stream)
{
    if (nl <= 0)
        return 0;
    const int threads = 32;           // one warp a block: spread the lanes over the SMs
    int blocks = (nl + threads - 1) / threads;
    t1_decode_v1_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)body, nb, (const int*)start, (const int*)npass,
        (const int*)nbps, (const int*)orient, (const int*)w, (const int*)h,
        (const int*)style, (const int*)ptbl, P, (const uint8_t*)lut,
        (const uint32_t*)mqt, (int*)out, (int*)flags, nl, W, H);
    return (int)cudaGetLastError();
}
