// Part-1 (EBCOT Tier-1 + MQ arithmetic coder) encode of a batch of
// code-blocks, default code-block style, one codeword segment per block:
// the first design (v1), one thread per code-block.  The serving paths
// run the redesign in csrc/t1_encode.cu (v2, one warp per code-block);
// v1 stays as the full-lane oracle and the speed yardstick of v2 on the
// card, reached only through grok_tpu_torch/ops/t1_encode.py
// `t1_encode_lanes_v1` (chip_smoke.py and the hardware-validation tool).
// It compiles against its own copy of the shared helpers,
// csrc/t1_common_v1.cuh.
//
// Replaces the Pallas TPU kernel grok_tpu/ops/pallas_t1_enc.py
// `pallas_t1_encode`, with its contract: per lane, mneg = (magnitude << 1)
// | sign as an (NL, H, W) int32 block, the band orientation and the
// magnitude bitplane count in; the codeword bytes (byte 0 the carry
// sentinel), the length after the C.2.9 flush and the trim of a trailing
// 0xFF, the per-pass rate watermarks and the significance-type map out,
// byte-identical to grok_tpu/t1/t1_scalar.py `encode_block` (style 0).
// One extension: each lane codes exactly its w x h samples (the TPU
// kernel takes exact-shape batches only), so edge blocks of any size
// share the launch.  The plain PyTorch version is grok_tpu_torch/ops/
// t1_encode.py `t1_encode_lanes_ref`; the two are held identical on the
// card.
//
// Design.  One thread codes one code-block, pass by pass in the scalar
// coder's order.  The MQ register state (A, C, CT, the byte pointer and
// the byte B that a carry can still change) and the 19 context states
// live in registers and local memory; B goes to the lane's output row
// when the pointer moves on, so every byte is stored once.  The packed
// neighbour-flag words of the lane (t1_common.cuh) are a scratch region
// in device memory, lane-major, (h + 2) x (w + 2) words; the flag word
// also carries the sample's significance type, stored once at the end.
// The context LUT and the MQ table are copied into shared memory at
// block start.  None of the TPU kernel's staging (the quad-packed 64-byte
// window, the mid scratch, lockstep lanes and one-hot selects) is carried
// over.
//
// Bound.  Serial coding latency per block and occupancy: the work is a
// chain of a few decisions per sample and bitplane, each dependent on
// the one before, and a batch has a few thousand lanes, so the card is
// far from its memory rate.  A warp per code-block with the flags in
// shared memory is v2's design (csrc/t1_encode.cu).

#include "t1_common_v1.cuh"

struct MQEnc {
    uint32_t a, c;
    int ct, bp;
    uint32_t B;               // the byte at bp, not yet stored
    bool ovf;
    uint8_t* out;
    int L;
};

__device__ __forceinline__ void mq_put(MQEnc& e)
{
    if (e.bp < e.L)
        e.out[e.bp] = (uint8_t)e.B;
    else
        e.ovf = true;
}

// C.2.6 BYTEOUT, with the carry propagated into B.
__device__ __forceinline__ void mq_byteout(MQEnc& e)
{
    bool emit7 = e.B == 0xFF;
    if (!emit7 && e.c >= 0x8000000u) {
        e.B += 1;
        if (e.B == 0xFF) {
            e.c &= 0x7FFFFFFu;
            emit7 = true;
        }
    }
    mq_put(e);
    e.bp += 1;
    if (emit7) {
        e.B = e.c >> 20;
        e.c &= 0xFFFFFu;
        e.ct = 7;
    } else {
        e.B = (e.c >> 19) & 0xFF;
        e.c &= 0x7FFFFu;
        e.ct = 8;
    }
}

// C.2.5 ENCODE of decision d in context cx, with C.2.8 RENORME.
__device__ __forceinline__ void mq_encode(MQEnc& e, uint8_t* ctx,
                                          const uint32_t* mqt, int d,
                                          int cx)
{
    uint8_t s = ctx[cx];
    uint32_t row = mqt[s >> 1];
    uint32_t qe = row & 0xFFFF;
    e.a -= qe;
    if (d == (s & 1)) {
        if (e.a & 0x8000) {
            e.c += qe;
            return;
        }
        if (e.a < qe)
            e.a = qe;
        else
            e.c += qe;
        ctx[cx] = t1_next_state(row, s, true);
    } else {
        if (e.a < qe)
            e.c += qe;
        else
            e.a = qe;
        ctx[cx] = t1_next_state(row, s, false);
    }
    do {
        e.a = (e.a << 1) & 0xFFFF;
        e.c = (e.c << 1) & 0xFFFFFFFu;
        if (--e.ct == 0)
            mq_byteout(e);
    } while (!(e.a & 0x8000));
}

// C.2.9 FLUSH; returns the codeword length (-1 past the capacity).
__device__ __forceinline__ int mq_flush(MQEnc& e)
{
    uint32_t tempc = e.c + e.a;
    e.c |= 0xFFFF;
    if (e.c >= tempc)
        e.c -= 0x8000;
    e.c = (e.c << e.ct) & 0xFFFFFFFu;
    mq_byteout(e);
    e.c = (e.c << e.ct) & 0xFFFFFFFu;
    mq_byteout(e);
    mq_put(e);
    int bp = e.B != 0xFF ? e.bp + 1 : e.bp;
    return e.ovf ? -1 : max(bp - 1, 0);
}

__device__ void encode_lane(const T1Tables& t, const int* blk, int W,
                            int w, int h, int orient, int nbps, int* fl,
                            uint8_t* out, int L, int* len_out, int* rates,
                            int R, int8_t* sigtype, int H)
{
    const int s = w + 2;
    const uint8_t* zc = t.lut + (orient << 8);
    const uint8_t* sc = t.lut + 1024;
    for (int i = 0; i < (h + 2) * s; i++)
        fl[i] = 0;
    uint8_t ctx[T1_N_CTX];
    t1_reset_ctx(ctx);
    MQEnc e = { 0x8000u, 0u, 12, 0, 0u, false, out, L };

    // sign coding and the significance of sample (y, x), flag word *f
    auto code_sign = [&](int y, int x, int* f, int neg, int stype) {
        int v = sc[*f & 0xFFF];
        mq_encode(e, ctx, t.mq, neg ^ (v >> 4), v & 15);
        t1_mark_sig(fl, s, y, x, neg);
        *f |= stype << F_ST_SHIFT;
    };
    auto record = [&](int pno) {
        if (pno >= 0 && pno < R)
            rates[pno] = e.bp + 5;
    };

    for (int k = 0; k < nbps; k++) {
        const int bpl = nbps - 1 - k;
        if (k >= 1) {
            for (int y0 = 0; y0 < h; y0 += 4)                  // SPP
                for (int x = 0; x < w; x++)
                    for (int y = y0; y < min(y0 + 4, h); y++) {
                        int* f = fl + (y + 1) * s + x + 1;
                        if ((*f & (F_SIG | F_VIS)) || !(*f & 0xFF))
                            continue;
                        int m = blk[y * W + x];
                        int bit = (m >> (bpl + 1)) & 1;
                        mq_encode(e, ctx, t.mq, bit, zc[*f & 0xFF]);
                        if (bit)
                            code_sign(y, x, f, m & 1, 1);
                        *f |= F_VIS;
                    }
            record(3 * k - 2);
            for (int y0 = 0; y0 < h; y0 += 4)                  // MRP
                for (int x = 0; x < w; x++)
                    for (int y = y0; y < min(y0 + 4, h); y++) {
                        int* f = fl + (y + 1) * s + x + 1;
                        if (!(*f & F_SIG) || (*f & F_VIS))
                            continue;
                        int bit = (blk[y * W + x] >> (bpl + 1)) & 1;
                        mq_encode(e, ctx, t.mq, bit, t1_mr_ctx(*f));
                        *f |= F_MU;
                    }
            record(3 * k - 1);
        }
        for (int y0 = 0; y0 < h; y0 += 4) {                    // CLN
            for (int x = 0; x < w; x++) {
                int y = y0;
                int* f0 = fl + (y0 + 1) * s + x + 1;
                if (y0 + 4 <= h
                        && !((f0[0] | f0[s] | f0[2 * s] | f0[3 * s])
                             & (0xFF | F_SIG | F_VIS))) {
                    int r = -1;
                    for (int dy = 3; dy >= 0; dy--)
                        if ((blk[(y0 + dy) * W + x] >> (bpl + 1)) & 1)
                            r = dy;
                    mq_encode(e, ctx, t.mq, r >= 0, T1_CTX_RL);
                    if (r < 0)
                        continue;
                    mq_encode(e, ctx, t.mq, r >> 1, T1_CTX_UNI);
                    mq_encode(e, ctx, t.mq, r & 1, T1_CTX_UNI);
                    code_sign(y0 + r, x, f0 + r * s,
                              blk[(y0 + r) * W + x] & 1, 2);
                    y = y0 + r + 1;
                }
                for (; y < min(y0 + 4, h); y++) {
                    int* f = fl + (y + 1) * s + x + 1;
                    if (*f & (F_SIG | F_VIS))
                        continue;
                    int m = blk[y * W + x];
                    int bit = (m >> (bpl + 1)) & 1;
                    mq_encode(e, ctx, t.mq, bit, zc[*f & 0xFF]);
                    if (bit)
                        code_sign(y, x, f, m & 1, 2);
                }
            }
        }
        record(3 * k);
        for (int y = 1; y <= h; y++)
            for (int x = 1; x <= w; x++)
                fl[y * s + x] &= ~F_VIS;
    }
    // rows a lane does not reach, the sigtype map and the flush
    for (int r = nbps > 0 ? 3 * nbps - 2 : 0; r < R; r++)
        rates[r] = 0;
    for (int y = 0; y < H; y++)
        for (int x = 0; x < W; x++)
            sigtype[y * W + x] = (y < h && x < w)
                ? (int8_t)(fl[(y + 1) * s + x + 1] >> F_ST_SHIFT) : 0;
    if (nbps > 0) {
        *len_out = mq_flush(e);
    } else {
        mq_put(e);                    // the sentinel alone
        *len_out = e.ovf ? -1 : 0;
    }
}

__global__ void __launch_bounds__(32)
t1_encode_v1_kernel(const int* __restrict__ mneg, const int* __restrict__ ori,
                 const int* __restrict__ nbv, const int* __restrict__ wv,
                 const int* __restrict__ hv, const uint8_t* __restrict__ lut,
                 const uint32_t* __restrict__ mqt, uint8_t* __restrict__ out,
                 int L, int* __restrict__ lengths, int* __restrict__ rates,
                 int R, int8_t* __restrict__ sigtype, int* __restrict__ flags,
                 int nl, int W, int H)
{
    __shared__ T1Tables t;
    t1_load_tables(t, lut, mqt);
    __syncthreads();
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= nl)
        return;
    int w = max(min(wv[lane], W), 1), h = max(min(hv[lane], H), 1);
    int nb = min(max(nbv[lane], 0), 30);
    encode_lane(t, mneg + (size_t)lane * W * H, W, w, h, ori[lane] & 3, nb,
                flags + (size_t)lane * (W + 2) * (H + 2),
                out + (size_t)lane * L, L, lengths + lane,
                rates + (size_t)lane * R, R,
                sigtype + (size_t)lane * W * H, H);
}

extern "C" int grk_t1_encode_v1(const void* mneg, const void* orient,
                             const void* numbps, const void* w,
                             const void* h, const void* lut,
                             const void* mqt, void* out, int L,
                             void* lengths, void* rates, int R,
                             void* sigtype, void* flags, int nl, int W,
                             int H, void* stream)
{
    if (nl <= 0)
        return 0;
    const int threads = 32;           // one warp a block: spread the lanes over the SMs
    int blocks = (nl + threads - 1) / threads;
    t1_encode_v1_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)mneg, (const int*)orient, (const int*)numbps,
        (const int*)w, (const int*)h, (const uint8_t*)lut,
        (const uint32_t*)mqt, (uint8_t*)out, L, (int*)lengths, (int*)rates,
        R, (int8_t*)sigtype, (int*)flags, nl, W, H);
    return (int)cudaGetLastError();
}
