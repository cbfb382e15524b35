// Part-1 (EBCOT Tier-1 + MQ arithmetic coder) encode of a batch of
// code-blocks, in any code-block style of the six Part-1 mode switches.
//
// Replaces the Pallas TPU kernel grok_tpu/ops/pallas_t1_enc.py
// `pallas_t1_encode`, with its contract: per lane, mneg = (magnitude << 1)
// | sign as an (NL, H, W) int32 block, the band orientation and the
// magnitude bitplane count in; the codeword bytes (byte 0 the carry
// sentinel), the length after the C.2.9 flush and the trim of a trailing
// 0xFF, the per-pass rate watermarks and the significance-type map out,
// byte-identical to grok_tpu/t1/t1_scalar.py `encode_block` (style 0).
// Two extensions: each lane codes exactly its w x h samples (the TPU
// kernel takes exact-shape batches only), so edge blocks of any size
// share the launch; and each lane has a style (the TPU kernel codes the
// default style only; the JAX package codes the others with its C coder,
// grok_tpu/native/t1.c `grk_t1_encode_ref`, whose bytes and pass records
// this kernel computes): BYPASS's raw SPP and MRP passes from pass 10 on,
// written by a raw bit writer with its 0xFF stuffing; the segment
// terminations of TERMALL and BYPASS, each MQ segment flushed (C.2.9, or
// the ERTERM flush under PTERM) and the next started at INITENC with the
// context states kept, each raw segment padded (0, 1, 0, ... under PTERM)
// and ended by a 0 after a 0xFF; RESET's context states at every MQ
// pass; VSC's stripe-causal contexts (the row below masked at stripe row
// 3, which moves samples between the SPP and the cleanup and changes
// the run-length test); SEGSYM's 1010 on the UNIFORM context after each
// cleanup.  A lane's segments lie back to back in its row; its rate row
// holds the exact bytes at each terminated pass but the last.  The plain
// PyTorch version is grok_tpu_torch/ops/t1_encode.py
// `t1_encode_lanes_ref`; the first design, csrc/t1_encode_v1.cu (default
// style only), is kept as the full-lane oracle.  Both are held identical
// to this kernel on the card (the first design on default-style lanes).
//
// Design (v2).  One warp codes one code-block, with the lane's state in
// the warp's slice of dynamic shared memory (csrc/t1_common.cuh): the
// 16-bit flag words (bit 15, F_CLN, marks a sample that became
// significant in a cleanup pass: the sigtype map), the 19 context
// states, the lane's input samples as 16-bit words (a lane of more than
// 15 planes reads them from device memory) and the watermark rows.
// Lane 0 runs the serial chain, the MQ coder (A, C, CT and the byte B
// that a carry can still change in registers, renormalisation in one
// __clz-sized shift per byte out, each codeword byte stored once when
// the pointer moves on), and walks the samples a pass codes; the other
// lanes zero the state and load the samples at lane start, build each
// stripe's visit masks before the walk (one 64-bit column mask per
// stripe row, eight ballots: csrc/t1_common.cuh `t1_stripe_masks`),
// clear F_VIS after each cleanup, and write the watermark rows and the
// sigtype map, coalesced, at the end.  A block wider than 64 (sides up
// to 1024, at most 4096 samples) walks each stripe in chunks of 64
// columns, left to right, each chunk's masks built once the chunk before
// it is coded, as K3 walks it (csrc/t1_decode.cu); each lane codes its
// own w x h only.  The mode switches are lane 0's serial work too (the
// raw writer and the flushes in registers, as K4 keeps its MEL); the
// masks stay a superset under VSC, the walk reading the masked flags.
// The lane body is compiled twice, with and without the mode switches,
// so a default-style lane runs the walk it ran before them.  The grid
// is persistent, sized
// from the occupancy of the (W, H) workspace (twelve 64 x 64 lanes per
// SM): each warp takes lane after lane from a device counter, in the
// order of a device argsort of nbps * w * h, longest first.
//
// Bound.  The serial MQ coding chain of each lane (a few decisions per
// sample and bitplane, each dependent on the one before) and, for
// many-lane launches, the spread of work over the resident warps; the
// bytes moved are hundreds of times below the card's memory time.  v1's
// note named the same chain and occupancy for its one thread per lane,
// whose flags lived in device memory and whose passes scanned every
// sample.

#include "t1_common.cuh"

struct MQEnc {
    uint32_t a, c;
    int ct, bp;
    uint32_t B;               // the byte at bp, not yet stored
    bool ovf;
    uint8_t* out;
    int L;
    int base;                 // the bytes of the lane's closed segments
};

__device__ __forceinline__ void t1_store(MQEnc& e, int i, uint32_t v)
{
    if (i < e.L)
        e.out[i] = (uint8_t)v;
    else
        e.ovf = true;
}

// Byte bp of the open segment lies at base + bp of the lane's row; a
// later segment's carry sentinel (bp 0: the last byte of the segment
// before it) is never stored.
__device__ __forceinline__ void mq_put(MQEnc& e)
{
    if (e.bp > 0 || e.base == 0)
        t1_store(e, e.base + e.bp, e.B);
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

// C.2.5 ENCODE of decision d in context cx, with C.2.8 RENORME: the
// shifts that bring A's bit 15 up, taken up to CT at a time with a
// BYTEOUT wherever CT reaches 0, as the one-bit loop takes them.
__device__ __forceinline__ void mq_encode(MQEnc& e, uint32_t* ctx,
                                          const uint32_t* mqt, int d,
                                          int cx)
{
    uint32_t s = ctx[cx];
    uint32_t qe = s & 0xFFFF;
    e.a -= qe;
    if (d == (int)(s >> 31)) {
        if (e.a & 0x8000) {
            e.c += qe;
            return;
        }
        if (e.a < qe)
            e.a = qe;
        else
            e.c += qe;
        ctx[cx] = t1_next_state(mqt, s, true);
    } else {
        if (e.a < qe)
            e.c += qe;
        else
            e.a = qe;
        ctx[cx] = t1_next_state(mqt, s, false);
    }
    int n = t1_clz(e.a) - 16;
    do {
        int k = min(n, e.ct);
        e.a <<= k;
        e.c = (e.c << k) & 0xFFFFFFFu;
        e.ct -= k;
        n -= k;
        if (e.ct == 0)
            mq_byteout(e);
    } while (n > 0);
}

// C.2.9 FLUSH, or under PTERM the predictable ERTERM flush (D.4.2: the
// register pushed out, at least 12 more bits, without SETBITS); the
// last byte stored.  Returns the segment's length, a trailing 0xFF
// trimmed.
__device__ __forceinline__ int mq_flush(MQEnc& e, bool pterm)
{
    if (pterm) {
        for (int k = 12 - e.ct; k > 0; k -= e.ct) {
            e.c = (e.c << e.ct) & 0xFFFFFFFu;
            e.ct = 0;
            mq_byteout(e);
        }
    } else {
        uint32_t tempc = e.c + e.a;
        e.c |= 0xFFFF;
        if (e.c >= tempc)
            e.c -= 0x8000;
        e.c = (e.c << e.ct) & 0xFFFFFFFu;
        mq_byteout(e);
        e.c = (e.c << e.ct) & 0xFFFFFFFu;
        mq_byteout(e);
    }
    mq_put(e);
    int bp = e.B != 0xFF ? e.bp + 1 : e.bp;
    return max(bp - 1, 0);
}

// The coder's registers at INITENC for the lane's next segment, after
// the `len` bytes of the one just closed.
__device__ __forceinline__ void mq_restart(MQEnc& e, int len)
{
    e.base += len;
    e.a = 0x8000u;
    e.c = 0u;
    e.ct = 12;
    e.bp = 0;
    e.B = 0u;
}

// The raw (BYPASS) bit writer of a lane (D.6): a raw segment's bytes at
// 1 + base + n of the lane's row, eight bits a byte, seven after a 0xFF.
struct RawEnc {
    int n, cur, nbits;
    bool ff;                  // the last byte written is 0xFF
};

__device__ __forceinline__ void raw_emit(MQEnc& e, RawEnc& r, int v)
{
    t1_store(e, 1 + e.base + r.n, v);
    r.ff = v == 0xFF;
    r.n++;
}

__device__ __forceinline__ void raw_bit(MQEnc& e, RawEnc& r, int bit)
{
    r.cur = (r.cur << 1) | bit;
    if (++r.nbits == (r.ff ? 7 : 8)) {
        raw_emit(e, r, r.cur);
        r.cur = r.nbits = 0;
    }
}

// Terminate the raw segment: the last byte padded (0, 1, 0, ... under
// PTERM, else zeros), a 0 after a final 0xFF.  Returns its length and
// leaves the writer empty.
__device__ __forceinline__ int raw_flush(MQEnc& e, RawEnc& r, bool pterm)
{
    if (r.nbits) {
        if (pterm) {
            for (int b = 0; r.nbits; b ^= 1)
                raw_bit(e, r, b);
        } else {
            raw_emit(e, r, r.cur << ((r.ff ? 7 : 8) - r.nbits));
            r.cur = r.nbits = 0;
        }
    }
    if (r.ff)
        raw_emit(e, r, 0);
    const int n = r.n;
    r.n = 0;
    r.ff = false;
    return n;
}

// The input samples mneg of a lane of up to T1_SHARED_PLANES planes:
// 16-bit words in the warp's workspace, row stride w, loaded by the warp
// at lane start.
struct MagShared {
    uint16_t* m;
    int w;
    __device__ __forceinline__ uint32_t get(int y, int x) const
    {
        return m[y * w + x];
    }
};

// The input samples of a lane of more planes, read where they lie in
// device memory, row stride W.
struct MagGlobal {
    const int* blk;
    int W;
    __device__ __forceinline__ uint32_t get(int y, int x) const
    {
        return (uint32_t)blk[y * W + x];
    }
};

// One code-block, run by the whole warp; ws is the warp's workspace
// (t1_lane_bytes(W, H, true)), blk the lane's H x W input block, mag the
// lane's samples (MagShared: loaded here from blk), style its mode
// switches.  STY = false compiles the default style's walk alone (style
// 0): the mode switches cost its lanes nothing.
template <class Mag, bool STY>
__device__ void encode_lane(const T1Tables& t, unsigned char* ws,
                            const Mag& mag, const int* blk, int W, int w,
                            int h, int orient, int nbps, int style,
                            uint8_t* out, int L, int* len_out, int* rates,
                            int R, int8_t* sigtype, int H)
{
    uint32_t* ctx = reinterpret_cast<uint32_t*>(ws);
    uint16_t* fl = reinterpret_cast<uint16_t*>(
        ws + T1_CTX_BYTES + t1_samples_bytes(W, H));
    int* wm = reinterpret_cast<int*>(
        ws + t1_lane_bytes(W, H, false));        // the watermark rows
    const int s = w + 2, nfl = (h + 2) * s;
    const uint8_t* zc = t.lut + (orient << 8);
    const uint8_t* sc = t.lut + 1024;
    const bool bypass = STY && (style & 0x01), reset = STY && (style & 0x02),
               termall = STY && (style & 0x04), vsc = STY && (style & 0x08),
               pterm = STY && (style & 0x10), segsym = STY && (style & 0x20);
    t1_lane_init(fl, nfl, ctx, t.mq);
    uint16_t* m16 = reinterpret_cast<uint16_t*>(ws + T1_CTX_BYTES);
    if (nbps <= T1_SHARED_PLANES)
        warp_for(h * w, [&](int i) {
            const int y = i / w;
            m16[i] = (uint16_t)blk[y * W + i - y * w];
        });
    warp_for(T1_RATE_ROWS, [&](int i) { wm[i] = 0; });
    MQEnc e = { 0x8000u, 0u, 12, 0, 0u, false, out, L, 0 };
    RawEnc rw = { 0, 0, 0, false };
    warp_sync();

    // the flag word of (y, x) as the contexts see it: under VSC the row
    // below masked at stripe row 3
    auto fmask = [&](int y, int f) {
        return (STY && vsc && (y & 3) == 3) ? (f & VSC_MASK) : f;
    };
    // one decision: MQ-coded in context cx, or a raw bit
    auto code = [&](bool raw, int bit, int cx) {
        if (STY && raw)
            raw_bit(e, rw, bit);
        else
            mq_encode(e, ctx, t.mq, bit, cx);
    };
    // sign coding and the significance of sample (y, x), flag word f
    auto code_sign = [&](int y, int x, int f, uint32_t m, bool cln,
                         bool raw) {
        int v = sc[f & 0xFFF];
        int neg = m & 1;
        if (STY && raw)
            raw_bit(e, rw, neg);
        else
            mq_encode(e, ctx, t.mq, neg ^ (v >> 4), v & 15);
        t1_mark_sig(fl, s, y, x, neg, F_SIG | (cln ? F_CLN : 0));
    };

    const int last = 3 * nbps - 3;
    for (int k = 0; k < nbps; k++) {
        const int bpl = nbps - 1 - k;
        for (int ptype = k >= 1 ? 0 : 2; ptype < 3; ptype++) {
            const int pno = ptype == 2 ? 3 * k : 3 * k - 2 + ptype;
            const bool raw = bypass && pno >= 10 && ptype != 2;
            if (STY && reset && !raw && warp_leader())
                t1_reset_ctx(ctx, t.mq);
            // stripe by stripe, each in chunks of 64 columns (one chunk
            // up to 64 wide): a chunk's masks are built after the walk of
            // the chunk before it, from flags that carry its new
            // significance
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
                    int carry = 0;      // SPP: rows added to the next column
                    while (cols) {
                        const int cx = t1_ffs64(cols) - 1;
                        const int x = c0 + cx;
                        cols &= cols - 1;
                        int nib = t1_nibble(m, cx) | carry;
                        carry = 0;
                        if (ptype == 0) {                      // SPP
                            for (int dy = 0; dy < nr; dy++) {
                                if (!((nib >> dy) & 1))
                                    continue;
                                const int y = y0 + dy;
                                uint16_t* f = fl + (y + 1) * s + x + 1;
                                const int fv = fmask(y, *f);
                                if ((fv & (F_SIG | F_VIS)) || !(fv & 0xFF))
                                    continue;
                                const uint32_t mm = mag.get(y, x);
                                const int bit = (mm >> (bpl + 1)) & 1;
                                code(raw, bit, zc[fv & 0xFF]);
                                if (bit) {
                                    code_sign(y, x, fv, mm, false, raw);
                                    nib |= 2 << dy;
                                    carry |= (7 << dy) >> 1;
                                }
                                *f |= F_VIS;
                            }
                            carry &= (1 << nr) - 1;
                            // the next chunk's masks see these rows' flags
                            if (carry && cx + 1 < cw)
                                cols |= (uint64_t)1 << (cx + 1);
                        } else if (ptype == 1) {               // MRP
                            for (int dy = 0; dy < nr; dy++) {
                                if (!((nib >> dy) & 1))
                                    continue;
                                const int y = y0 + dy;
                                uint16_t* f = fl + (y + 1) * s + x + 1;
                                const int bit = (mag.get(y, x) >> (bpl + 1))
                                    & 1;
                                code(raw, bit, t1_mr_ctx(fmask(y, *f)));
                                *f |= F_MU;
                            }
                        } else {                               // CLN
                            int dy = 0;
                            const uint16_t* f0 = fl + (y0 + 1) * s + x + 1;
                            if (nib == 0xF && !((f0[0] | f0[s] | f0[2 * s]
                                                 | fmask(y0 + 3, f0[3 * s]))
                                                & 0xFF)) {
                                int r = -1;
                                for (int k4 = 3; k4 >= 0; k4--)
                                    if ((mag.get(y0 + k4, x) >> (bpl + 1))
                                            & 1)
                                        r = k4;
                                mq_encode(e, ctx, t.mq, r >= 0, T1_CTX_RL);
                                if (r < 0)
                                    continue;
                                mq_encode(e, ctx, t.mq, r >> 1, T1_CTX_UNI);
                                mq_encode(e, ctx, t.mq, r & 1, T1_CTX_UNI);
                                code_sign(y0 + r, x,
                                          fmask(y0 + r, f0[r * s]),
                                          mag.get(y0 + r, x), true, false);
                                dy = r + 1;
                            }
                            for (; dy < nr; dy++) {
                                if (!((nib >> dy) & 1))
                                    continue;
                                const int y = y0 + dy;
                                const int fv = fmask(y,
                                                     fl[(y + 1) * s + x + 1]);
                                const uint32_t mm = mag.get(y, x);
                                const int bit = (mm >> (bpl + 1)) & 1;
                                mq_encode(e, ctx, t.mq, bit, zc[fv & 0xFF]);
                                if (bit)
                                    code_sign(y, x, fv, mm, true, false);
                            }
                        }
                    }
                }
                warp_sync();
            }
            if (warp_leader()) {
                if (STY && segsym && ptype == 2)
                    for (int i = 0; i < 4; i++)
                        mq_encode(e, ctx, t.mq, (i & 1) ^ 1, T1_CTX_UNI);
                // the pass's rate row, and the termination of its segment
                // (every pass under TERMALL, BYPASS's MQ run at pass 9,
                // each raw run and each later cleanup); the last pass is
                // flushed after the walk
                int v = raw ? e.base + rw.n + (rw.nbits ? 1 : 0)
                            : e.base + e.bp + 5;
                if (STY && pno != last
                    && (termall || (bypass && pno >= 9
                                    && (ptype == 2
                                        || (ptype == 1 && pno >= 10))))) {
                    mq_restart(e, raw ? raw_flush(e, rw, pterm)
                                      : mq_flush(e, pterm));
                    v = e.base;
                }
                if (pno < R)
                    wm[pno] = v;
            }
        }
        t1_clear_vis(fl, nfl);
        warp_sync();
    }
    // the rate rows (those a lane does not reach stay 0), the sigtype
    // map and the flush
    warp_sync();
    warp_for(R, [&](int r) { rates[r] = r < T1_RATE_ROWS ? wm[r] : 0; });
    warp_for(H * W, [&](int i) {
        const int y = i / W, x = i - y * W;
        int8_t v = 0;
        const int f = y < h && x < w ? fl[(y + 1) * s + x + 1] : 0;
        if (f & F_SIG)
            v = (f & F_CLN) ? 2 : 1;
        sigtype[i] = v;
    });
    if (warp_leader()) {
        if (nbps > 0) {
            const int n = mq_flush(e, pterm);
            *len_out = e.ovf ? -1 : e.base + n;
        } else {
            mq_put(e);                // the sentinel alone
            *len_out = e.ovf ? -1 : 0;
        }
    }
    warp_sync();
}

// Lane `lane` of the batch through encode_lane: its parameters clamped
// as the contract says, then the whole warp codes it.
template <class Mag>
__device__ __forceinline__ void encode_styled(
    const T1Tables& t, unsigned char* ws, const Mag& mag, const int* blk,
    int W, int w, int h, int orient, int nb, int style, uint8_t* out, int L,
    int* len_out, int* rates, int R, int8_t* sigtype, int H)
{
    if (style)
        encode_lane<Mag, true>(t, ws, mag, blk, W, w, h, orient, nb, style,
                               out, L, len_out, rates, R, sigtype, H);
    else
        encode_lane<Mag, false>(t, ws, mag, blk, W, w, h, orient, nb, 0,
                                out, L, len_out, rates, R, sigtype, H);
}

__device__ __forceinline__ void encode_one(
    const T1Tables& t, unsigned char* ws, int lane, const int* mneg,
    const int* ori, const int* nbv, const int* wv, const int* hv,
    const int* stv, uint8_t* out, int L, int* lengths, int* rates, int R,
    int8_t* sigtype, int W, int H)
{
    int w = max(min(wv[lane], W), 1), h = max(min(hv[lane], H), 1);
    int nb = min(max(nbv[lane], 0), 30);
    const int style = stv ? stv[lane] & 0x3F : 0;
    const int* blk = mneg + (size_t)lane * W * H;
    if (nb <= T1_SHARED_PLANES)
        encode_styled(t, ws, MagShared{ (uint16_t*)(ws + T1_CTX_BYTES), w },
                      blk, W, w, h, ori[lane] & 3, nb, style,
                      out + (size_t)lane * L, L, lengths + lane,
                      rates + (size_t)lane * R, R,
                      sigtype + (size_t)lane * W * H, H);
    else
        encode_styled(t, ws, MagGlobal{ blk, W }, blk, W, w, h,
                      ori[lane] & 3, nb, style, out + (size_t)lane * L, L,
                      lengths + lane, rates + (size_t)lane * R, R,
                      sigtype + (size_t)lane * W * H, H);
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(T1_WARPS * 32)
t1_encode_kernel(const int* __restrict__ mneg, const int* __restrict__ ori,
                 const int* __restrict__ nbv, const int* __restrict__ wv,
                 const int* __restrict__ hv, const int* __restrict__ stv,
                 const uint8_t* __restrict__ lut,
                 const uint32_t* __restrict__ mqt, uint8_t* __restrict__ out,
                 int L, int* __restrict__ lengths, int* __restrict__ rates,
                 int R, int8_t* __restrict__ sigtype,
                 const int* __restrict__ order, int* __restrict__ counter,
                 int nl, int W, int H)
{
    extern __shared__ __align__(16) unsigned char smem[];
    T1Tables& t = *reinterpret_cast<T1Tables*>(smem);
    t1_load_tables(t, lut, mqt);
    __syncthreads();
    unsigned char* ws = smem + T1_TABLES_BYTES
        + (threadIdx.x >> 5) * t1_lane_bytes(W, H, true);
    for (;;) {
        int q = 0;
        if (warp_leader())
            q = atomicAdd(counter, 1);
        q = __shfl_sync(T1_FULL_MASK, q, 0);
        if (q >= nl)
            break;
        encode_one(t, ws, order[q], mneg, ori, nbv, wv, hv, stv, out, L,
                   lengths, rates, R, sigtype, W, H);
    }
}

extern "C" int grk_t1_encode(const void* mneg, const void* orient,
                             const void* numbps, const void* w,
                             const void* h, const void* style,
                             const void* lut,
                             const void* mqt, void* out, int L,
                             void* lengths, void* rates, int R,
                             void* sigtype, const void* order,
                             void* counter, int nl, int W, int H,
                             void* stream)
{
    if (nl <= 0)
        return 0;
    const int threads = T1_WARPS * 32;
    const int smem = (int)T1_TABLES_BYTES
        + T1_WARPS * t1_lane_bytes(W, H, true);
    cudaError_t err = cudaFuncSetAttribute(
        t1_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess)
        return (int)err;
    int dev = 0, nsm = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, t1_encode_kernel, threads, smem);
    if (err != cudaSuccess)
        return (int)err;
    if (per_sm < 1)
        return (int)cudaErrorInvalidConfiguration;
    const int blocks = min(nsm * per_sm, (nl + T1_WARPS - 1) / T1_WARPS);
    t1_encode_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        (const int*)mneg, (const int*)orient, (const int*)numbps,
        (const int*)w, (const int*)h, (const int*)style,
        (const uint8_t*)lut,
        (const uint32_t*)mqt, (uint8_t*)out, L, (int*)lengths, (int*)rates,
        R, (int8_t*)sigtype, (const int*)order, (int*)counter, nl, W, H);
    return (int)cudaGetLastError();
}

#endif
