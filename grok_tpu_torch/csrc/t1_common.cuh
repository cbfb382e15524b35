// Shared pieces of the Part-1 (EBCOT/MQ) block coders, csrc/t1_encode.cu
// (K5) and csrc/t1_decode.cu (K3), one code-block per warp with the
// lane's state in shared memory.  (The first, one-thread-per-block
// kernels keep their own copy, csrc/t1_common_v1.cuh.)
//
// The packed neighbour-flag word, one 16-bit word per sample of a lane's
// (h + 2) x (w + 2) flag array (a one-sample insignificant border), as in
// grok_tpu/ops/pallas_t1.py and grok_tpu_torch/ops/t1_decode.py: the
// significance of the 8 neighbours, the signs of the 4 orthogonal ones,
// and the sample's own state.  The zero-coding and sign-coding contexts
// are one lookup each in the context LUT built by ops/t1_decode.py
// `flag_luts` (5120 bytes): ZC at (orient << 8) | (f & 0xFF), SC at
// 1024 + (f & 0xFFF) with the context in the low nibble and the XOR bit
// at bit 4.  The MQ state table arrives packed from ops/t1_decode.py
// `mq_table`: qe | nmps << 16 | nlps << 22 | switch << 28 per state.  A
// context's state is its state's table word with the MPS in bit 31, so a
// decision that does not renormalise reads one word.
//
// The workspace of one warp in dynamic shared memory (t1_lane_bytes):
// the 19 context states (80 bytes), then H x W 16-bit sample words (K3's
// reconstruction, K5's input: a lane of up to 15 planes, whose mag2 and
// mneg fit 16 bits; a lane of more planes keeps them in device memory),
// then the (H + 2) x (W + 2) flag words, each part rounded up to 16
// bytes, then K5's watermark rows (T1_RATE_ROWS words).  The CUDA
// block's copy of the tables comes first, once per block
// (T1_TABLES_BYTES).  A 64 x 64 lane takes about 17 KB: twelve lanes fit
// an SM.

#pragma once

#include "t1_warp.cuh"

#define F_NW (1 << 0)
#define F_N (1 << 1)
#define F_NE (1 << 2)
#define F_W (1 << 3)
#define F_E (1 << 4)
#define F_SW (1 << 5)
#define F_S (1 << 6)
#define F_SE (1 << 7)
#define F_SGN_N (1 << 8)
#define F_SGN_E (1 << 9)
#define F_SGN_S (1 << 10)
#define F_SGN_W (1 << 11)
#define F_SIG (1 << 12)
#define F_VIS (1 << 13)
#define F_MU (1 << 14)
#define F_NEG (1 << 15)
#define F_CLN F_NEG             // encoder: became significant in a cleanup
#define VSC_MASK (~(F_SW | F_S | F_SE))

#define T1_LUT_BYTES 5120
#define T1_MQ_STATES 47
#define T1_N_CTX 19
#define T1_CTX_RL 17
#define T1_CTX_UNI 18
#define T1_WARPS 4              // code-block warps per CUDA block
#define T1_RATE_ROWS 88         // watermark rows of 30 planes: 3 * 30 - 2
#define T1_CTX_BYTES 80
#define T1_SHARED_PLANES 15     // the planes whose samples fit 16 bits

// The tables every warp of a block reads, copied into shared memory.
struct T1Tables {
    uint8_t lut[T1_LUT_BYTES];
    uint32_t mq[T1_MQ_STATES];
};

#define T1_TABLES_BYTES ((sizeof(T1Tables) + 15) / 16 * 16)

// The 16-bit sample words of a (W, H) lane, rounded up to 16 bytes.
__host__ __device__ __forceinline__ int t1_samples_bytes(int W, int H)
{
    return (2 * H * W + 15) / 16 * 16;
}

// One warp's shared-memory workspace for (W, H) lanes; K5 adds its
// watermark rows.
__host__ __device__ __forceinline__ int t1_lane_bytes(int W, int H,
                                                      bool rates)
{
    int flags = ((H + 2) * (W + 2) * 2 + 15) / 16 * 16;
    return T1_CTX_BYTES + t1_samples_bytes(W, H) + flags
        + (rates ? 4 * T1_RATE_ROWS : 0);
}

__device__ __forceinline__ void t1_load_tables(T1Tables& t,
                                               const uint8_t* lut,
                                               const uint32_t* mqt)
{
    for (int i = block_thread(); i < T1_LUT_BYTES; i += block_threads())
        t.lut[i] = lut[i];
    for (int i = block_thread(); i < T1_MQ_STATES; i += block_threads())
        t.mq[i] = mqt[i];
}

// Initial context states (ISO 15444-1 Table D.7): ZC 0 at state 4, RL
// at 3, UNI at 46, all others at 0, every MPS 0.
__device__ __forceinline__ void t1_reset_ctx(uint32_t* ctx,
                                             const uint32_t* mqt)
{
    for (int i = 0; i < T1_N_CTX; i++)
        ctx[i] = mqt[0];
    ctx[0] = mqt[4];
    ctx[T1_CTX_RL] = mqt[3];
    ctx[T1_CTX_UNI] = mqt[46];
}

// The context state after a renormalising decision: NMPS for an MPS,
// NLPS (and the MPS flipped on a switch state) for an LPS.
__device__ __forceinline__ uint32_t t1_next_state(const uint32_t* mqt,
                                                  uint32_t s, bool mps_path)
{
    uint32_t mps = s >> 31;
    if (mps_path)
        return mqt[(s >> 16) & 0x3F] | (mps << 31);
    return mqt[(s >> 22) & 0x3F] | ((mps ^ ((s >> 28) & 1)) << 31);
}

// Sample (y, x) of a flag array of row stride s becomes significant,
// negative when neg: its neighbours' flags, and `own` (F_SIG and the
// decoder's F_NEG or the encoder's F_CLN) on its own word.
__device__ __forceinline__ void t1_mark_sig(uint16_t* f, int s, int y,
                                            int x, int neg, int own)
{
    uint16_t* r0 = f + y * s + x;        // the row above, from column x - 1
    uint16_t* r1 = r0 + s;
    uint16_t* r2 = r1 + s;
    r0[0] |= F_SE;
    r0[1] |= F_S | (neg ? F_SGN_S : 0);
    r0[2] |= F_SW;
    r1[0] |= F_E | (neg ? F_SGN_E : 0);
    r1[1] |= own;
    r1[2] |= F_W | (neg ? F_SGN_W : 0);
    r2[0] |= F_NE;
    r2[1] |= F_N | (neg ? F_SGN_N : 0);
    r2[2] |= F_NW;
}

__device__ __forceinline__ int t1_mr_ctx(int f)
{
    return (f & F_MU) ? 16 : ((f & 0xFF) ? 15 : 14);
}

// The lane's state at lane start: flags zero (as 32-bit pairs; the
// workspace rounds the flag array up), the context states at Table D.7.
__device__ __forceinline__ void t1_lane_init(uint16_t* fl, int nfl,
                                             uint32_t* ctx,
                                             const uint32_t* mqt)
{
    uint32_t* f2 = reinterpret_cast<uint32_t*>(fl);
    warp_for((nfl + 1) >> 1, [&](int i) { f2[i] = 0; });
    if (warp_leader())
        t1_reset_ctx(ctx, mqt);
}

// Clear F_VIS on every flag word after a cleanup pass.
__device__ __forceinline__ void t1_clear_vis(uint16_t* fl, int nfl)
{
    uint32_t* f2 = reinterpret_cast<uint32_t*>(fl);
    const uint32_t keep = ~(uint32_t)(F_VIS | (F_VIS << 16));
    warp_for((nfl + 1) >> 1, [&](int i) { f2[i] &= keep; });
}

// The samples of a stripe (rows y0 .. y1 - 1, columns c0 .. c0 + 63 below
// w, flag row stride s) a pass may code, as one 64-bit column mask per
// stripe row (bit x for column c0 + x), built by the warp from the flags
// at the start of the stripe's 64-column chunk:
//   SPP: an insignificant, unvisited sample with a significant neighbour
//        (without the VSC masking: a superset); the serial walk adds the
//        samples after one that becomes significant, the one below it
//        and three in the next column;
//   MRP: a significant sample not visited in this plane's SPP (exact:
//        the pass changes neither);
//   CLN: a sample neither significant nor visited (exact: only the
//        sample being coded changes).
template <int PASS>
__device__ __forceinline__ T1Nibbles t1_stripe_masks(const uint16_t* fl,
                                                     int s, int w, int y0,
                                                     int y1, int c0 = 0)
{
    return warp_nibbles([&](int x) {
        int n = 0;
        if (c0 + x < w) {
            const uint16_t* f = fl + (y0 + 1) * s + c0 + x + 1;
            for (int y = y0; y < y1; y++, f += s) {
                int v = *f;
                bool c = PASS == 0 ? (!(v & (F_SIG | F_VIS)) && (v & 0xFF))
                    : PASS == 1 ? ((v & F_SIG) && !(v & F_VIS))
                    : !(v & (F_SIG | F_VIS));
                n |= (int)c << (y - y0);
            }
        }
        return n;
    });
}

// The stripe rows of column x a mask marks, as a nibble.
__device__ __forceinline__ int t1_nibble(const T1Nibbles& m, int x)
{
    return (int)((m.m[0] >> x) & 1) | (int)((m.m[1] >> x) & 1) << 1
        | (int)((m.m[2] >> x) & 1) << 2 | (int)((m.m[3] >> x) & 1) << 3;
}

// The columns a mask marks.
__device__ __forceinline__ uint64_t t1_columns(const T1Nibbles& m)
{
    return m.m[0] | m.m[1] | m.m[2] | m.m[3];
}
