// Per-lane gather of an int32 (rows, L) array: out[r, l] = x[idx[r, l], l].
//
// Replaces the Pallas TPU kernel of tools/hw_validate.py
// `run_gather_probe`, whose body is jnp.take_along_axis(x, idx, axis=0)
// on one (rows, 128) VMEM block: a probe of whether Mosaic lowers a
// per-lane dynamic gather.  The port takes any lane count L >= 1.  The
// plain PyTorch version is grok_tpu_torch/ops/lane_gather.py
// `lane_gather_ref`; the first design, lane_gather_v1.cu, is the oracle.
// The three are held identical on the card.
//
// Bound.  Bytes: x and idx read once and out written once, 12 bytes an
// element, against the card's memory rate; there is no arithmetic to
// speak of.  Where the indices are random, each x read still costs the
// L2 one 32-byte sector request for its 4 useful bytes: 8.4 M requests
// at 65536 x 128, which is what bounds this kernel in practice.
//
// Design.  What held the first design back: a 64-bit i % L for every
// element, one dependent idx -> x chain in flight a thread, and x pushed
// out of L2 between its random touches.
//   - Column blocks: the card works through the lanes 32 at a time (128
//     bytes of a row), every row of one column block before the next, so
//     the x that the gathers touch at once is rows x 128 bytes (8 MiB at
//     65536 rows), which L2 keeps; all 128 lanes at once (32 MiB of x)
//     ran no faster than the first design on an H100.
//   - A 2D block: threadIdx.x walks a column block's lane groups of VEC
//     lanes (VEC = 4, 16 bytes, where L % 4 == 0 and the three pointers
//     are 16-byte aligned; else VEC = 1, the scalar form of the same
//     kernel), threadIdx.y and RPT rows a thread the row tile.  A lane's
//     index is the thread's position; a tile's column block and row tile
//     take one 32-bit division a tile.
//   - idx is read with streaming loads (__ldcs, evict-first) and out
//     written with streaming stores (__stcs), 16 bytes at a time: they
//     pass through L2 without displacing x.
//   - x is read with ld.global.L2::cache_hint under an evict_last policy
//     (createpolicy.fractional), local to this kernel's loads: no
//     process-wide persisting-L2 setting is touched.
//   - Each thread loads the indices of its RPT rows, then issues all
//     RPT * VEC gathers before it stores any result: 16 loads in flight
//     a thread with VEC = 4.
//   - A persistent grid of BLOCKS_PER_SM blocks an SM walking the tiles
//     in order: more blocks in flight spread the gathers over more column
//     blocks at once, and ran slower.
// An index outside [0, rows) yields 0 and reads nothing, as in the plain
// version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;     // a block
constexpr int RPT = 4;           // rows a thread takes in a row tile
constexpr int COL_LANES = 32;    // lanes of a column block
constexpr int BLOCKS_PER_SM = 2;

__device__ __forceinline__ uint64_t keep_in_l2()
{
    uint64_t policy;
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
        : "=l"(policy));
    return policy;
}

__device__ __forceinline__ int load_kept(const int* p, uint64_t policy)
{
    int v;
    asm("ld.global.L2::cache_hint.b32 %0, [%1], %2;"
        : "=r"(v) : "l"(p), "l"(policy));
    return v;
}

template <int VEC>
struct Lanes {
    int v[VEC];
};

__device__ __forceinline__ void load_stream(Lanes<4>& d, const int* p)
{
    const int4 t = __ldcs(reinterpret_cast<const int4*>(p));
    d.v[0] = t.x;
    d.v[1] = t.y;
    d.v[2] = t.z;
    d.v[3] = t.w;
}

__device__ __forceinline__ void load_stream(Lanes<1>& d, const int* p)
{
    d.v[0] = __ldcs(p);
}

__device__ __forceinline__ void store_stream(int* p, const Lanes<4>& s)
{
    __stcs(reinterpret_cast<int4*>(p),
           make_int4(s.v[0], s.v[1], s.v[2], s.v[3]));
}

__device__ __forceinline__ void store_stream(int* p, const Lanes<1>& s)
{
    __stcs(p, s.v[0]);
}

template <int VEC>
__global__ void __launch_bounds__(THREADS)
lane_gather_kernel(const int* __restrict__ x, const int* __restrict__ idx,
                   int* __restrict__ out, int rows, int L, int groups,
                   int row_tiles, int tiles)
{
    const uint64_t policy = keep_in_l2();
    const int tile_rows = blockDim.y * RPT;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int cb = t / row_tiles;          // the tile's column block
        const int g = cb * blockDim.x + threadIdx.x;       // lane group
        if (g >= groups)
            continue;
        const long long l0 = (long long)g * VEC;
        const int r0 = (t - cb * row_tiles) * tile_rows + threadIdx.y;
        Lanes<VEC> ix[RPT], v[RPT];
#pragma unroll
        for (int k = 0; k < RPT; ++k) {
            const int r = r0 + k * blockDim.y;
            if (r < rows) {
                load_stream(ix[k], idx + (long long)r * L + l0);
            } else {
#pragma unroll
                for (int j = 0; j < VEC; ++j)
                    ix[k].v[j] = -1;
            }
        }
#pragma unroll
        for (int k = 0; k < RPT; ++k) {
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
                const int s = ix[k].v[j];
                v[k].v[j] = (s >= 0 && s < rows)
                    ? load_kept(x + (long long)s * L + l0 + j, policy) : 0;
            }
        }
#pragma unroll
        for (int k = 0; k < RPT; ++k) {
            const int r = r0 + k * blockDim.y;
            if (r < rows)
                store_stream(out + (long long)r * L + l0, v[k]);
        }
    }
}

// blocks of the persistent grid: SMs x (BLOCKS_PER_SM, or fewer where
// fewer fit), per device and VEC, found once; a failed query's error
// code
cudaError_t resident_blocks(const void* kernel, int vec, int* n)
{
    static int cache[64][2];
    int dev = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc != cudaSuccess)
        return rc;
    int* slot = dev >= 0 && dev < 64 ? &cache[dev][vec == 4] : nullptr;
    if (slot == nullptr || *slot == 0) {
        int sms = 0, per_sm = 0;
        rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
        if (rc == cudaSuccess)
            rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, THREADS, 0);
        if (rc != cudaSuccess)
            return rc;
        per_sm = per_sm < BLOCKS_PER_SM ? per_sm : BLOCKS_PER_SM;
        *n = sms * (per_sm > 0 ? per_sm : 1);
        if (slot != nullptr)
            *slot = *n;
        return cudaSuccess;
    }
    *n = *slot;
    return cudaSuccess;
}

template <int VEC>
int launch(const int* x, const int* idx, int* out, long long rows, int L,
           cudaStream_t stream)
{
    const int groups = L / VEC;
    int tx = 1;                    // lane groups a column block
    while (tx < groups && tx < COL_LANES / VEC)
        tx *= 2;
    const int ty = THREADS / tx;
    const long long col_tiles = (groups + tx - 1) / tx;
    const long long row_tiles = (rows + (long long)ty * RPT - 1)
        / ((long long)ty * RPT);
    if (rows > INT32_MAX || col_tiles * row_tiles > INT32_MAX)
        return (int)cudaErrorInvalidValue;
    const int tiles = (int)(col_tiles * row_tiles);
    int resident = 0;
    const cudaError_t rc = resident_blocks(
        reinterpret_cast<const void*>(&lane_gather_kernel<VEC>), VEC,
        &resident);
    if (rc != cudaSuccess)
        return (int)rc;
    const int grid = resident < tiles ? resident : tiles;
    lane_gather_kernel<VEC><<<grid, dim3(tx, ty), 0, stream>>>(
        x, idx, out, (int)rows, L, groups, (int)row_tiles, tiles);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int grk_lane_gather(const void* x, const void* idx, void* out,
                               long long rows, int L, void* stream)
{
    if (rows <= 0 || L <= 0)
        return 0;
    const uintptr_t align = (uintptr_t)x | (uintptr_t)idx | (uintptr_t)out;
    if (L % 4 == 0 && align % 16 == 0)
        return launch<4>((const int*)x, (const int*)idx, (int*)out, rows, L,
                         (cudaStream_t)stream);
    return launch<1>((const int*)x, (const int*)idx, (int*)out, rows, L,
                     (cudaStream_t)stream);
}
