// Per-lane gather of an int32 (rows, L) array: out[r, l] = x[idx[r, l], l].
// The first design of P1, kept as the oracle of lane_gather.cu (the
// redesign): grok_tpu_torch/ops/lane_gather.py `lane_gather_v1` reaches
// it, and only chip_smoke.py and tools/hw_validate.py call that.
//
// Replaces the Pallas TPU kernel of tools/hw_validate.py
// `run_gather_probe`, whose body is jnp.take_along_axis(x, idx, axis=0)
// on one (rows, 128) VMEM block: a probe of whether Mosaic lowers a
// per-lane dynamic gather.  The port takes any lane count L >= 1.  The
// plain PyTorch version is grok_tpu_torch/ops/lane_gather.py
// `lane_gather_ref`; the two are held identical on the card.
//
// Design.  One thread per output element, a grid-stride loop over
// rows * L elements.  Neighbouring threads take neighbouring lanes l of
// one row, so the idx loads and the out stores are coalesced; the x
// loads of a warp hit 32 different rows (one sector each) unless their
// indices agree.  An index outside [0, rows) yields 0 and reads nothing,
// as in the plain version.
//
// Bound.  Bytes: x and idx read once and out written once, 12 bytes per
// element, against the card's memory rate; there is no arithmetic to
// speak of.  The scattered x reads make the real traffic up to 32 bytes
// per element where indices are random.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void lane_gather_v1_kernel(const int* __restrict__ x,
                                      const int* __restrict__ idx,
                                      int* __restrict__ out, long long rows,
                                      int L)
{
    const long long n = rows * (long long)L;
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += step) {
        const long long r = idx[i];
        const long long l = i % L;
        out[i] = (r >= 0 && r < rows) ? x[r * L + l] : 0;
    }
}

extern "C" int grk_lane_gather_v1(const void* x, const void* idx,
                                  void* out, long long rows, int L,
                                  void* stream)
{
    const long long n = rows * (long long)L;
    if (n <= 0)
        return 0;
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 64)            // grid-stride beyond 64 blocks per SM
        blocks = 132 * 64;
    lane_gather_v1_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
        (const int*)x, (const int*)idx, (int*)out, rows, L);
    return (int)cudaGetLastError();
}
