// The warp-level steps of the block coders that run one code-block per
// warp (csrc/t1_decode.cu, K3, csrc/t1_encode.cu, K5, csrc/ht_encode.cu,
// K4 and K4r, and csrc/ht_decode.cu, K1 and K2): the lane bodies are
// written against these few calls, so the same source compiles for the
// card with nvcc and for the host with a plain C++ compiler.
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
// One value per thread, for the steps whose data stays in registers:
//
//   WarpReg<T> r        r[t] is thread t's value (on the card each thread
//                       holds only its own, and r[t] ignores t);
//   warp_each(fn)       fn(t) once on each thread t of the warp;
//   warp_ballot(r)      the 32-bit mask of the threads whose r[t] != 0;
//   warp_shfl(r, s)     thread s's r[s] (called by every thread, and
//                       never on a register written in the same step);
//   warp_scan_incl(r, op)  r[t] = op(r[t], r[t - 1]) for t = 1 .. 31 in
//                       turn, the inclusive prefix of an associative op
//                       (log2 32 shuffle steps on the card);
//   warp_scan(r)        the exclusive prefix sum of r in place; returns
//                       the total;
//   warp_or(p, v)       *p |= v on a shared word that other threads of the
//                       warp may OR into at the same step (atomicOr);
//   t1_prmt(a, b, sel)  __byte_perm.
//
// Loads and bit counts of the HT decoders:
//
//   t1_ldg32(p)         the 4-byte-aligned word at p, read-only (__ldg);
//   t1_prefetch(p)      a hint to bring p's line into L1 (nothing on the
//                       host);
//   t1_popc64(x)        __popcll;
//   t1_fshr(lo, hi, s)  __funnelshift_r: bits s & 31 .. of hi:lo;
//   t1_saddr, t1_smem(p), t1_lds32(a), t1_lds8(a)
//                       a shared-memory address converted once (a 32-bit
//                       shared-window offset on the card, a pointer on the
//                       host) and 4- and 1-byte loads through it, so that a
//                       serial chain of table loads does not rebuild the
//                       shared base for each load;
//   t1_publish(p, v), t1_wait_ge(p, v)
//                       one warp's progress counter in shared memory for
//                       another warp of its CTA: store v after the warp's
//                       earlier shared stores, and wait (a bounded spin,
//                       which only guards against a hang) until it is at
//                       least v, the reads after it ordered behind it.  On
//                       the host the two warps run one after the other, so
//                       the wait has nothing to wait for.
//
// On the host (no __CUDACC__) one thread plays the warp: warp_leader() is
// always true, warp_sync() does nothing, warp_for, warp_each and
// warp_nibbles loop over the 32 lane ids in turn, a WarpReg holds 32
// values, and the CUDA qualifiers and intrinsics the lane bodies use are
// defined for a C++ compiler.  That build is how tests/
// test_torch_t1_lane_body.py and tests/test_torch_ht_lane_body.py hold the
// lane bodies against the plain versions without a card.

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

// byte n of the result: byte (sel >> 4 n) & 7 of the 8 bytes of (a, b)
__device__ __forceinline__ uint32_t t1_prmt(uint32_t a, uint32_t b,
                                            uint32_t sel)
{
    return __byte_perm(a, b, sel);
}

__device__ __forceinline__ uint32_t t1_ldg32(const uint8_t* p)
{
    return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ void t1_prefetch(const void* p)
{
    asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

__device__ __forceinline__ int t1_popc64(uint64_t x)
{
    return __popcll((unsigned long long)x);
}

__device__ __forceinline__ uint32_t t1_fshr(uint32_t lo, uint32_t hi, int s)
{
    return __funnelshift_r(lo, hi, s);
}

typedef uint32_t t1_saddr;

// volatile: an opaque register, not rebuilt from the CTA id at each use
__device__ __forceinline__ t1_saddr t1_smem(const void* p)
{
    uint64_t a;
    asm volatile("cvta.to.shared.u64 %0, %1;" : "=l"(a) : "l"(p));
    return (uint32_t)a;
}

__device__ __forceinline__ int t1_lds32(t1_saddr a)
{
    int v;
    asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(a));
    return v;
}

__device__ __forceinline__ int t1_lds8(t1_saddr a)
{
    unsigned short v;
    asm volatile("ld.shared.u8 %0, [%1];" : "=h"(v) : "r"(a));
    return v;
}

__device__ __forceinline__ void t1_publish(int* p, int v)
{
    __threadfence_block();
    *reinterpret_cast<volatile int*>(p) = v;
}

__device__ __forceinline__ void t1_wait_ge(const int* p, int v)
{
    for (int i = 0; i < (1 << 26)
         && *reinterpret_cast<const volatile int*>(p) < v; i++)
        __nanosleep(64);
    __threadfence_block();
}

template <class T>
struct WarpReg {
    T v;
    __device__ __forceinline__ T& operator[](int) { return v; }
    __device__ __forceinline__ const T& operator[](int) const { return v; }
};

template <class F>
__device__ __forceinline__ void warp_each(F fn)
{
    fn((int)(threadIdx.x & 31));
}

template <class T>
__device__ __forceinline__ uint32_t warp_ballot(const WarpReg<T>& r)
{
    return __ballot_sync(T1_FULL_MASK, r.v != 0);
}

template <class T>
__device__ __forceinline__ T warp_shfl(const WarpReg<T>& r, int src)
{
    return __shfl_sync(T1_FULL_MASK, r.v, src & 31);
}

template <class T, class Op>
__device__ __forceinline__ void warp_scan_incl(WarpReg<T>& r, Op op)
{
    const int t = threadIdx.x & 31;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const T y = __shfl_up_sync(T1_FULL_MASK, r.v, d);
        if (t >= d)
            r.v = op(r.v, y);
    }
}

__device__ __forceinline__ int warp_scan(WarpReg<int>& r)
{
    const int own = r.v;
    warp_scan_incl(r, [](int a, int b) { return a + b; });
    const int total = __shfl_sync(T1_FULL_MASK, r.v, 31);
    r.v -= own;
    return total;
}

__device__ __forceinline__ void warp_or(uint32_t* p, uint32_t v)
{
    atomicOr(p, v);
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

inline uint32_t t1_prmt(uint32_t a, uint32_t b, uint32_t sel)
{
    const uint64_t ab = (uint64_t)a | ((uint64_t)b << 32);
    uint32_t r = 0;
    for (int n = 0; n < 4; n++)
        r |= (uint32_t)((ab >> (8 * ((sel >> (4 * n)) & 7))) & 0xFF)
            << (8 * n);
    return r;
}

// as strict as the card: a word load must be 4-byte aligned
inline uint32_t t1_ldg32(const uint8_t* p)
{
    if ((uintptr_t)p & 3u)
        __builtin_trap();
    uint32_t v;
    memcpy(&v, p, sizeof v);
    return v;
}

inline void t1_prefetch(const void*)
{
}

inline int t1_popc64(uint64_t x)
{
    return __builtin_popcountll(x);
}

inline uint32_t t1_fshr(uint32_t lo, uint32_t hi, int s)
{
    return (uint32_t)((((uint64_t)hi << 32) | lo) >> (s & 31));
}

typedef const unsigned char* t1_saddr;

inline t1_saddr t1_smem(const void* p)
{
    return (const unsigned char*)p;
}

inline int t1_lds32(t1_saddr a)
{
    int v;
    memcpy(&v, a, sizeof v);
    return v;
}

inline int t1_lds8(t1_saddr a)
{
    return *a;
}

inline void t1_publish(int* p, int v)
{
    *p = v;
}

inline void t1_wait_ge(const int*, int)
{
}

template <class T>
struct WarpReg {
    T v[32];
    T& operator[](int t) { return v[t & 31]; }
    const T& operator[](int t) const { return v[t & 31]; }
};

template <class F>
inline void warp_each(F fn)
{
    for (int t = 0; t < 32; t++)
        fn(t);
}

template <class T>
inline uint32_t warp_ballot(const WarpReg<T>& r)
{
    uint32_t m = 0;
    for (int t = 0; t < 32; t++)
        m |= (uint32_t)(r.v[t] != 0) << t;
    return m;
}

template <class T>
inline T warp_shfl(const WarpReg<T>& r, int src)
{
    return r.v[src & 31];
}

template <class T, class Op>
inline void warp_scan_incl(WarpReg<T>& r, Op op)
{
    for (int t = 1; t < 32; t++)
        r.v[t] = op(r.v[t], r.v[t - 1]);
}

inline int warp_scan(WarpReg<int>& r)
{
    int acc = 0;
    for (int t = 0; t < 32; t++) {
        const int own = r.v[t];
        r.v[t] = acc;
        acc += own;
    }
    return acc;
}

inline void warp_or(uint32_t* p, uint32_t v)
{
    *p |= v;
}

#endif
