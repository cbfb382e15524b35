// Part-1 (EBCOT Tier-1 + MQ arithmetic coder) decode of a batch of
// code-blocks, with every mode switch of the code-block style.
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
// grok_tpu_torch/ops/t1_decode.py `t1_decode_lanes_ref`; the first
// design, csrc/t1_decode_v1.cu, is kept as the full-lane oracle.  Both
// are held identical to this kernel on the card.
//
// Design (v2).  One warp decodes one code-block, with the lane's state
// in the warp's slice of dynamic shared memory (csrc/t1_common.cuh): the
// 16-bit flag words, the 19 context states and the reconstruction as
// 16-bit words (a lane of more than 15 planes accumulates it in its
// output block in device memory instead).  Lane 0 runs the serial chain,
// the MQ decoder (A, C and CT in registers, renormalisation in one
// __clz-sized shift per byte) over a register window of two 16-byte
// __ldg chunks of the codeword, and walks the samples a pass codes; the
// other lanes do the parallel work: they zero the state at lane start,
// build each stripe's visit masks before the walk (one 64-bit column
// mask per stripe row, eight ballots: csrc/t1_common.cuh
// `t1_stripe_masks`), so a pass visits only the samples it may code,
// clear F_VIS after each cleanup and write the signed output block,
// coalesced, at the end (csrc/t1_warp.cuh holds the warp steps and their
// host build).  A block wider than 64 (sides up to 1024, at most 4096
// samples) walks each stripe in chunks of 64 columns, left to right, each
// chunk's masks built once the chunk before it is walked.  The grid is persistent, sized from the occupancy of the
// (W, H) workspace (twelve 64 x 64 lanes per SM): each warp takes lane
// after lane from a device counter, in the order of a device argsort of
// npass * w * h, longest first, so the launch ends near max(slowest
// lane, total work / warps).
//
// Bound.  The serial MQ decision chain of each lane: a few dependent
// shared-memory loads (flags, zero-coding context, context state) and
// ALU steps per decision; the slowest lane of a 1920 x 1080 frame sets
// most of the launch.  The bytes moved are about a thousand times below
// the card's memory time.  v1's note named the same chain and occupancy
// for its one thread per lane, whose flags and reconstruction lived in
// device memory and whose passes scanned every sample.

#include "t1_common.cuh"

struct MQDec {
    uint32_t a, c;
    int ct, bp, send;
    int rct, rbyte, rprev;    // the raw (BYPASS) reader
    const uint8_t* body;
    long long nb, start;
    const uint8_t* wbase;     // the window: 16-byte aligned, 32 bytes
    uint4 lo, hi;             //   [wbase, wbase + 16) and the next chunk
};

// The chunk after `p` into the window's prefetch slot, or zeros past the
// body's last byte (never read: reads are clamped to the body).
__device__ __forceinline__ uint4 win_next(const MQDec& d, const uint8_t* p)
{
    uint4 z = { 0u, 0u, 0u, 0u };
    return p <= d.body + d.nb - 1 ? t1_ldg16(p) : z;
}

// Byte p of the body through the window: a read in the prefetched chunk
// slides the window on by 16 bytes, one elsewhere re-seats it.
__device__ __forceinline__ int win_byte(MQDec& d, const uint8_t* p)
{
    long long off = p - d.wbase;
    if (off >= 16 && off < 32) {
        d.lo = d.hi;
        d.wbase += 16;
        d.hi = win_next(d, d.wbase + 16);
        off -= 16;
    } else if (off < 0 || off >= 32) {
        d.wbase = (const uint8_t*)((uintptr_t)p & ~(uintptr_t)15);
        d.lo = t1_ldg16(d.wbase);
        d.hi = win_next(d, d.wbase + 16);
        off = p - d.wbase;
    }
    uint32_t wd = (off & 8) ? ((off & 4) ? d.lo.w : d.lo.z)
                            : ((off & 4) ? d.lo.y : d.lo.x);
    return (wd >> (8 * (off & 3))) & 0xFF;
}

__device__ __forceinline__ int dec_byte(MQDec& d, int i, int past)
{
    if (i >= d.send)
        return past;
    long long k = d.start + i;
    k = k < 0 ? 0 : (k >= d.nb ? d.nb - 1 : k);
    return win_byte(d, d.body + k);
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

// C.3.2 DECODE in context cx, with C.3.3 RENORMD: the shifts that bring
// A's bit 15 up, taken up to CT at a time with a BYTEIN wherever CT
// reaches 0 before a shift, as the one-bit loop takes them.
__device__ __forceinline__ int mq_decode(MQDec& d, uint32_t* ctx,
                                         const uint32_t* mqt, int cx)
{
    uint32_t s = ctx[cx];
    uint32_t qe = s & 0xFFFF;
    int mps = s >> 31, bit;
    d.a -= qe;
    if ((d.c >> 16) < qe) {               // LPS exchange
        bool m = d.a < qe;
        bit = m ? mps : 1 - mps;
        ctx[cx] = t1_next_state(mqt, s, m);
        d.a = qe;
    } else {
        d.c -= qe << 16;
        if (d.a & 0x8000)
            return mps;
        bool m = d.a >= qe;
        bit = m ? mps : 1 - mps;
        ctx[cx] = t1_next_state(mqt, s, m);
    }
    int n = t1_clz(d.a) - 16;
    do {
        if (d.ct == 0)
            mq_bytein(d);
        int k = min(n, d.ct);
        d.a <<= k;
        d.c <<= k;
        d.ct -= k;
        n -= k;
    } while (n > 0);
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

// The reconstruction of a lane of up to T1_SHARED_PLANES planes: 16-bit
// words in the warp's workspace, row stride w (mag2 < 2^16).
struct RecShared {
    uint16_t* r;
    int w;
    __device__ __forceinline__ int get(int y, int x) const
    {
        return r[y * w + x];
    }
    __device__ __forceinline__ void set(int y, int x, int v) const
    {
        r[y * w + x] = (uint16_t)v;
    }
    __device__ __forceinline__ void add(int y, int x, int v) const
    {
        r[y * w + x] = (uint16_t)(r[y * w + x] + v);
    }
};

// The reconstruction of a lane of more planes: the lane's output block
// in device memory, row stride W, signed in place at the end.
struct RecGlobal {
    int* o;
    int W;
    __device__ __forceinline__ int get(int y, int x) const
    {
        return o[y * W + x];
    }
    __device__ __forceinline__ void set(int y, int x, int v) const
    {
        o[y * W + x] = v;
    }
    __device__ __forceinline__ void add(int y, int x, int v) const
    {
        o[y * W + x] += v;
    }
};

// One code-block, run by the whole warp; ws is the warp's workspace
// (t1_lane_bytes(W, H, false)), rec the lane's reconstruction, out the
// lane's H x W output block.
template <class Rec>
__device__ void decode_lane(const T1Tables& t, unsigned char* ws,
                            MQDec& d, const Rec& rec, int npass, int nbps,
                            int orient, int w, int h, int style,
                            const int* ptbl, int P, int* out, int W, int H)
{
    uint32_t* ctx = reinterpret_cast<uint32_t*>(ws);
    uint16_t* fl = reinterpret_cast<uint16_t*>(
        ws + T1_CTX_BYTES + t1_samples_bytes(W, H));
    const int s = w + 2, nfl = (h + 2) * s;
    const uint8_t* zc = t.lut + (orient << 8);
    const uint8_t* sc = t.lut + 1024;
    const bool vsc = style & 0x08, reset = style & 0x02,
               segsym = style & 0x20;
    t1_lane_init(fl, nfl, ctx, t.mq);
    warp_for(h * w, [&](int i) {
        const int y = i / w;
        rec.set(y, i - y * w, 0);
    });
    d.a = 0x8000;
    d.c = 0;
    d.ct = 0;
    d.bp = 0;
    d.send = 0;
    d.rct = d.rbyte = d.rprev = 0;
    d.wbase = d.body - 64;             // an empty window
    warp_sync();

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
        t1_mark_sig(fl, s, y, x, neg, F_SIG | (neg ? F_NEG : 0));
        rec.set(y, x, 3 << bpl);
    };

    const int last = min(npass, 3 * nbps - 2);
    for (int pno = 0; pno < last; pno++) {
        const int k = (pno + 2) / 3;
        const int ptype = pno == 0 ? 2 : (pno + 2) % 3;   // 0 SPP 1 MRP 2 CLN
        const int bpl = nbps - 1 - k;
        // open the pass: the segment table's row, RESET
        const int* row = ptbl + 3 * pno;
        const bool raw = pno < P && row[2] != 0;
        if (warp_leader()) {
            if (pno < P && row[0] >= 0) {
                d.send = row[1];
                d.bp = row[0];
                if (raw) {
                    d.rct = 0;
                    d.rprev = 0;
                } else {
                    mq_initdec(d);
                }
            }
            if (reset && !raw)
                t1_reset_ctx(ctx, t.mq);
        }

        // stripe by stripe, each in chunks of 64 columns (one chunk up
        // to 64 wide): a chunk's masks are built after the walk of the
        // chunk before it, from flags that carry its new significance
        for (int y0 = 0; y0 < h; y0 += 4)
        for (int c0 = 0; c0 < w; c0 += 64) {
            const int y1 = min(y0 + 4, h), nr = y1 - y0;
            const int cw = min(w - c0, 64);
            const T1Nibbles m = ptype == 0
                ? t1_stripe_masks<0>(fl, s, w, y0, y1, c0)
                : ptype == 1 ? t1_stripe_masks<1>(fl, s, w, y0, y1, c0)
                : t1_stripe_masks<2>(fl, s, w, y0, y1, c0);
            if (warp_leader()) {
                uint64_t cols = t1_columns(m);
                int carry = 0;          // SPP: rows added to the next column
                while (cols) {
                    const int cx = t1_ffs64(cols) - 1;
                    const int x = c0 + cx;
                    cols &= cols - 1;
                    int nib = t1_nibble(m, cx) | carry;
                    carry = 0;
                    if (ptype == 0) {                          // SPP
                        for (int dy = 0; dy < nr; dy++) {
                            if (!((nib >> dy) & 1))
                                continue;
                            const int y = y0 + dy;
                            int f = flags(y, x);
                            if ((f & (F_SIG | F_VIS)) || !(f & 0xFF))
                                continue;
                            int bit = raw ? raw_bit(d)
                                : mq_decode(d, ctx, t.mq, zc[f & 0xFF]);
                            if (bit) {
                                sign(y, x, f, raw, bpl);
                                nib |= 2 << dy;
                                carry |= (7 << dy) >> 1;
                            }
                            fl[(y + 1) * s + x + 1] |= F_VIS;
                        }
                        carry &= (1 << nr) - 1;
                        // the next chunk's masks see these rows' flags
                        if (carry && cx + 1 < cw)
                            cols |= (uint64_t)1 << (cx + 1);
                    } else if (ptype == 1) {                   // MRP
                        for (int dy = 0; dy < nr; dy++) {
                            if (!((nib >> dy) & 1))
                                continue;
                            const int y = y0 + dy;
                            int bit = raw ? raw_bit(d)
                                : mq_decode(d, ctx, t.mq,
                                            t1_mr_ctx(flags(y, x)));
                            rec.add(y, x, (bit << (bpl + 1))
                                    - (1 << (bpl + 1)) + (1 << bpl));
                            fl[(y + 1) * s + x + 1] |= F_MU;
                        }
                    } else {                                   // CLN
                        int dy = 0;
                        if (nib == 0xF
                                && !((flags(y0, x) | flags(y0 + 1, x)
                                      | flags(y0 + 2, x) | flags(y0 + 3, x))
                                     & 0xFF)) {
                            if (!mq_decode(d, ctx, t.mq, T1_CTX_RL))
                                continue;
                            int r = mq_decode(d, ctx, t.mq, T1_CTX_UNI) << 1;
                            r |= mq_decode(d, ctx, t.mq, T1_CTX_UNI);
                            sign(y0 + r, x, flags(y0 + r, x), false, bpl);
                            dy = r + 1;
                        }
                        for (; dy < nr; dy++) {
                            if (!((nib >> dy) & 1))
                                continue;
                            const int y = y0 + dy;
                            int f = flags(y, x);
                            if (mq_decode(d, ctx, t.mq, zc[f & 0xFF]))
                                sign(y, x, f, false, bpl);
                        }
                    }
                }
            }
            warp_sync();
        }
        if (ptype == 2) {
            if (segsym && warp_leader())
                for (int i = 0; i < 4; i++)
                    mq_decode(d, ctx, t.mq, T1_CTX_UNI);
            t1_clear_vis(fl, nfl);
            warp_sync();
        }
    }
    warp_for(H * W, [&](int i) {
        const int y = i / W, x = i - y * W;
        int v = 0;
        if (y < h && x < w) {
            v = rec.get(y, x);
            if (fl[(y + 1) * s + x + 1] & F_NEG)
                v = -v;
        }
        out[i] = v;
    });
    warp_sync();
}

// Lane `lane` of the batch through decode_lane: its parameters clamped
// as the contract says, then the whole warp decodes it.
__device__ __forceinline__ void decode_one(
    const T1Tables& t, unsigned char* ws, int lane, const uint8_t* body,
    long long nb, const int* start, const int* npv, const int* nbv,
    const int* ori, const int* wv, const int* hv, const int* stv,
    const int* ptbl, int P, int* out, int W, int H)
{
    int nbps = nbv[lane];
    if (nbps < 0 || nbps > 30)
        nbps = 0;                     // outside the contract: zeros
    MQDec d;
    d.body = body;
    d.nb = nb;
    d.start = start[lane];
    const int w = max(min(wv[lane], W), 1), h = max(min(hv[lane], H), 1);
    int* o = out + (size_t)lane * W * H;
    if (nbps <= T1_SHARED_PLANES)
        decode_lane(t, ws, d, RecShared{ (uint16_t*)(ws + T1_CTX_BYTES), w },
                    npv[lane], nbps, ori[lane] & 3, w, h, stv[lane],
                    ptbl + (size_t)lane * P * 3, P, o, W, H);
    else
        decode_lane(t, ws, d, RecGlobal{ o, W }, npv[lane], nbps,
                    ori[lane] & 3, w, h, stv[lane],
                    ptbl + (size_t)lane * P * 3, P, o, W, H);
}

#ifdef __CUDACC__

// The minimum of two blocks per SM (the workspace of 64 x 64 lanes fits
// three) lets ptxas give the lane's serial chain the registers it needs:
// without it the build capped the kernel at 64 registers and spilled.
__global__ void __launch_bounds__(T1_WARPS * 32, 2)
t1_decode_kernel(const uint8_t* __restrict__ body, long long nb,
                 const int* __restrict__ start, const int* __restrict__ npv,
                 const int* __restrict__ nbv, const int* __restrict__ ori,
                 const int* __restrict__ wv, const int* __restrict__ hv,
                 const int* __restrict__ stv, const int* __restrict__ ptbl,
                 int P, const uint8_t* __restrict__ lut,
                 const uint32_t* __restrict__ mqt, int* __restrict__ out,
                 const int* __restrict__ order, int* __restrict__ counter,
                 int nl, int W, int H)
{
    extern __shared__ __align__(16) unsigned char smem[];
    T1Tables& t = *reinterpret_cast<T1Tables*>(smem);
    t1_load_tables(t, lut, mqt);
    __syncthreads();
    unsigned char* ws = smem + T1_TABLES_BYTES
        + (threadIdx.x >> 5) * t1_lane_bytes(W, H, false);
    for (;;) {
        int q = 0;
        if (warp_leader())
            q = atomicAdd(counter, 1);
        q = __shfl_sync(T1_FULL_MASK, q, 0);
        if (q >= nl)
            break;
        decode_one(t, ws, order[q], body, nb, start, npv, nbv, ori, wv, hv,
                   stv, ptbl, P, out, W, H);
    }
}

extern "C" int grk_t1_decode(const void* body, long long nb,
                             const void* start, const void* npass,
                             const void* nbps, const void* orient,
                             const void* w, const void* h,
                             const void* style, const void* ptbl, int P,
                             const void* lut, const void* mqt, void* out,
                             const void* order, void* counter, int nl,
                             int W, int H, void* stream)
{
    if (nl <= 0)
        return 0;
    const int threads = T1_WARPS * 32;
    const int smem = (int)T1_TABLES_BYTES
        + T1_WARPS * t1_lane_bytes(W, H, false);
    cudaError_t err = cudaFuncSetAttribute(
        t1_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess)
        return (int)err;
    int dev = 0, nsm = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, t1_decode_kernel, threads, smem);
    if (err != cudaSuccess)
        return (int)err;
    if (per_sm < 1)
        return (int)cudaErrorInvalidConfiguration;
    const int blocks = min(nsm * per_sm, (nl + T1_WARPS - 1) / T1_WARPS);
    t1_decode_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)body, nb, (const int*)start, (const int*)npass,
        (const int*)nbps, (const int*)orient, (const int*)w, (const int*)h,
        (const int*)style, (const int*)ptbl, P, (const uint8_t*)lut,
        (const uint32_t*)mqt, (int*)out, (const int*)order, (int*)counter,
        nl, W, H);
    return (int)cudaGetLastError();
}

#endif
