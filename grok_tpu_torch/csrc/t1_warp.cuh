// The warp-level steps of the Part-1 block coders (csrc/t1_decode.cu, K3,
// and csrc/t1_encode.cu, K5), one code-block per warp: the lane bodies
// are written against these few calls, so the same source compiles for
// the card with nvcc and for the host with a plain C++ compiler.
//
//   warp_leader()       true on the thread that runs the lane's serial
//                       chain (lane 0 of the warp);
//   warp_sync()         orders the shared-memory writes of one step
//                       before the reads of the next (__syncwarp);
//   warp_for(n, fn)     fn(i) for i in [0, n), spread over the 32 lanes;
//   warp_nibbles(nib)   four 64-bit masks, bit x of mask k set where bit k
//                       of nib(x) is, over columns x in [0, 64): columns t
//                       and t + 32 on lane t, two __ballot_sync per mask;
//   block_thread(), block_threads()   the thread's index in its CUDA
//                       block and the block's size (shared table loads).
//
// On the host (no __CUDACC__) one thread plays the warp: warp_leader() is
// always true, warp_sync() does nothing, warp_for and warp_nibbles loop
// over the 32 lane ids in turn, and the CUDA qualifiers and intrinsics
// the lane bodies use are defined for a C++ compiler.  That build is how
// tests/test_torch_t1_lane_body.py holds the lane bodies against the
// plain versions without a card.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__

#include <cuda_runtime.h>

#define T1_FULL_MASK 0xFFFFFFFFu

__device__ __forceinline__ bool warp_leader()
{
    return (threadIdx.x & 31) == 0;
}

__device__ __forceinline__ void warp_sync()
{
    __syncwarp();
}

template <class F>
__device__ __forceinline__ void warp_for(int n, F fn)
{
    for (int i = threadIdx.x & 31; i < n; i += 32)
        fn(i);
}

// Four 64-bit masks: bit x of m[k] is bit k of nib(x).
struct T1Nibbles {
    uint64_t m[4];
};

template <class F>
__device__ __forceinline__ T1Nibbles warp_nibbles(F nib)
{
    const int t = threadIdx.x & 31;
    const int lo = nib(t), hi = nib(t + 32);
    T1Nibbles r;
#pragma unroll
    for (int k = 0; k < 4; k++)
        r.m[k] = (uint64_t)__ballot_sync(T1_FULL_MASK, (lo >> k) & 1)
            | ((uint64_t)__ballot_sync(T1_FULL_MASK, (hi >> k) & 1) << 32);
    return r;
}

__device__ __forceinline__ int block_thread()
{
    return threadIdx.x;
}

__device__ __forceinline__ int block_threads()
{
    return blockDim.x;
}

__device__ __forceinline__ int t1_clz(uint32_t x)
{
    return __clz(x);
}

// 1 + the index of the lowest set bit (x != 0)
__device__ __forceinline__ int t1_ffs64(uint64_t x)
{
    return __ffsll((long long)x);
}

__device__ __forceinline__ uint4 t1_ldg16(const uint8_t* p)
{
    return __ldg(reinterpret_cast<const uint4*>(p));
}

#else   // the host build of the lane bodies

#include <algorithm>
#include <string.h>

#define __device__
#define __host__
#define __forceinline__ inline

using std::max;
using std::min;

struct uint4 {
    unsigned int x, y, z, w;
};

inline bool warp_leader()
{
    return true;
}

inline void warp_sync()
{
}

template <class F>
inline void warp_for(int n, F fn)
{
    for (int t = 0; t < 32; t++)
        for (int i = t; i < n; i += 32)
            fn(i);
}

struct T1Nibbles {
    uint64_t m[4];
};

template <class F>
inline T1Nibbles warp_nibbles(F nib)
{
    T1Nibbles r = { { 0, 0, 0, 0 } };
    for (int t = 0; t < 32; t++)
        for (int x = t; x < 64; x += 32) {
            const int n = nib(x);
            for (int k = 0; k < 4; k++)
                r.m[k] |= (uint64_t)((n >> k) & 1) << x;
        }
    return r;
}

inline int block_thread()
{
    return 0;
}

inline int block_threads()
{
    return 1;
}

inline int t1_clz(uint32_t x)
{
    return x ? __builtin_clz(x) : 32;
}

inline int t1_ffs64(uint64_t x)
{
    return __builtin_ffsll((long long)x);
}

inline uint4 t1_ldg16(const uint8_t* p)
{
    uint4 v;
    memcpy(&v, p, sizeof v);
    return v;
}

#endif
