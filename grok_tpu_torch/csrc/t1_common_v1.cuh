// Shared pieces of the first Part-1 (EBCOT/MQ) block coders, csrc/
// t1_encode_v1.cu and csrc/t1_decode_v1.cu (v1 of K5 and K3, kept as the
// oracle of the redesign): the helpers as v1 was built and measured
// against them.  The redesign's own are in csrc/t1_common.cuh.
//
// The packed neighbour-flag word, one int32 per sample of a lane's
// (h + 2) x (w + 2) flag array (a one-sample insignificant border), as in
// grok_tpu/ops/pallas_t1.py and grok_tpu_torch/ops/t1_decode.py: the
// significance of the 8 neighbours, the signs of the 4 orthogonal ones,
// and the sample's own state.  The zero-coding and sign-coding contexts
// are one lookup each in the context LUT built by ops/t1_decode.py
// `flag_luts` (5120 bytes): ZC at (orient << 8) | (f & 0xFF), SC at
// 1024 + (f & 0xFFF) with the context in the low nibble and the XOR bit
// at bit 4.  The MQ state table arrives packed from ops/t1_decode.py
// `mq_table`: qe | nmps << 16 | nlps << 22 | switch << 28 per state.
// A context's state is one byte, (state index << 1) | mps.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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
#define F_ST_SHIFT 16           // encoder: sigtype in bits 16-17
#define VSC_MASK (~(F_SW | F_S | F_SE))

#define T1_LUT_BYTES 5120
#define T1_MQ_STATES 47
#define T1_N_CTX 19
#define T1_CTX_RL 17
#define T1_CTX_UNI 18

// The tables every thread of a block reads, copied into shared memory.
struct T1Tables {
    uint8_t lut[T1_LUT_BYTES];
    uint32_t mq[T1_MQ_STATES];
};

__device__ __forceinline__ void t1_load_tables(T1Tables& t,
                                               const uint8_t* lut,
                                               const uint32_t* mqt)
{
    for (int i = threadIdx.x; i < T1_LUT_BYTES; i += blockDim.x)
        t.lut[i] = lut[i];
    for (int i = threadIdx.x; i < T1_MQ_STATES; i += blockDim.x)
        t.mq[i] = mqt[i];
}

// Initial context states (ISO 15444-1 Table D.7): ZC 0 at state 4, RL
// at 3, UNI at 46, all others at 0, every MPS 0.
__device__ __forceinline__ void t1_reset_ctx(uint8_t* ctx)
{
    for (int i = 0; i < T1_N_CTX; i++)
        ctx[i] = 0;
    ctx[0] = 4 << 1;
    ctx[T1_CTX_RL] = 3 << 1;
    ctx[T1_CTX_UNI] = 46 << 1;
}

// The context state after a renormalising decision: NMPS for an MPS,
// NLPS (and the MPS flipped on a switch state) for an LPS.
__device__ __forceinline__ uint8_t t1_next_state(uint32_t row, uint8_t s,
                                                 bool mps_path)
{
    int mps = s & 1;
    if (mps_path)
        return (uint8_t)((((row >> 16) & 0x3F) << 1) | mps);
    return (uint8_t)((((row >> 22) & 0x3F) << 1) | (mps ^ (row >> 28)));
}

// Sample (y, x) of a flag array of row stride s becomes significant,
// negative when neg: its own SIG/NEG bits and its neighbours' flags.
__device__ __forceinline__ void t1_mark_sig(int* f, int s, int y, int x,
                                            int neg)
{
    int* r0 = f + y * s + x;             // the row above, from column x - 1
    int* r1 = r0 + s;
    int* r2 = r1 + s;
    r0[0] |= F_SE;
    r0[1] |= F_S | (neg ? F_SGN_S : 0);
    r0[2] |= F_SW;
    r1[0] |= F_E | (neg ? F_SGN_E : 0);
    r1[1] |= F_SIG | (neg ? F_NEG : 0);
    r1[2] |= F_W | (neg ? F_SGN_W : 0);
    r2[0] |= F_NE;
    r2[1] |= F_N | (neg ? F_SGN_N : 0);
    r2[2] |= F_NW;
}

__device__ __forceinline__ int t1_mr_ctx(int f)
{
    return (f & F_MU) ? 16 : ((f & 0xFF) ? 15 : 14);
}
