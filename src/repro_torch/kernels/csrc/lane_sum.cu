// Per-lane sums for Hopper (sm_90a), added in an order that does not depend
// on the batch.
//
// Replaces: no Pallas kernel.  It replaces the sums the reference's tol-mode
// LP makes over one lane's elements, which XLA compiles: the capped
// projection's sums over (T', D) (src/repro/core/batch.py:318-327), the power
// iteration's norm (:416) and the ratio test's path lengths and interaction
// (:650-659).
//
//   out[b, j] = sum_{r1 < R1, r2 < R2} x[b, r1, j, r2]
//
// x: (B, R1, M, R2) float32 or float64, contiguous; out: (B * M * chunks,) of
// the same type, where chunks = ceil(R1 * R2 / chunk).
//
// Why a kernel of its own: torch's CUDA sum takes its launch shape (how many
// threads and blocks share one output, how wide its loads are) from the whole
// tensor, so it adds one lane's elements in another order, and rounds them
// otherwise, in a batch of another size.  The sweep pipeline sharded over
// cards solves each card's lanes as a smaller batch, and with torch's sums its
// lanes part from the unsharded run's after some hundred iterations.  Here the
// order is a function of R1 * R2 and the chunk alone:
//   * the R = R1 * R2 elements of an output fall into chunks of `chunk`
//     elements (a multiple of 256); block (output, chunk) has 256 threads, and
//     thread t adds elements t, t + 256, t + 512, ... of its chunk, in that
//     order, in the input's precision, starting from +0;
//   * the 256 partial sums meet in a fixed tree: a butterfly in each warp
//     (shuffle xor 16, 8, 4, 2, 1), then the 8 warps' sums, padded with zeros
//     to 32, by the same butterfly in warp 0;
//   * block (output, c) writes out[output * chunks + c]; where chunks > 1 the
//     wrapper sums each output's row of chunk sums with a second launch.
// ref.lane_sum_ordered mirrors this order step for step, on any device.
//
// What bounds it: every element is read once and added once, so bytes; at the
// LP's sizes (a few thousand elements an output, tens of outputs) one launch
// costs more than the bytes.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__device__ __forceinline__ T butterfly(T v) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
    return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lane_sum_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t R1,
                int64_t M, int64_t R2, int64_t chunk, int64_t chunks) {
    const int64_t blk = blockIdx.x;
    const int64_t o = blk / chunks;          // the output (b, j)
    const int64_t c = blk - o * chunks;      // its chunk
    const int64_t b = o / M, j = o - b * M;
    const int64_t R = R1 * R2;
    const int64_t lo = c * chunk;
    const int64_t hi = lo + chunk < R ? lo + chunk : R;
    const T* base = x + b * R1 * M * R2 + j * R2;
    T acc = T(0);
    for (int64_t p = lo + threadIdx.x; p < hi; p += kThreads) {
        const int64_t r1 = p / R2;
        acc += base[r1 * M * R2 + (p - r1 * R2)];
    }
    acc = butterfly(acc);
    __shared__ T part[kWarps];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) part[warp] = acc;
    __syncthreads();
    if (warp == 0) {
        T v = lane < kWarps ? part[lane] : T(0);
        v = butterfly(v);
        if (lane == 0) out[o * chunks + c] = v;
    }
}

}  // namespace

// x, out: device pointers; wide: 0 for float32, 1 for float64; chunk: a
// positive multiple of 256.  Launches B * M * ceil(R1 * R2 / chunk) blocks.
extern "C" int lane_sum_launch(const void* x, void* out, long long B,
                               long long R1, long long M, long long R2,
                               long long chunk, int wide, void* stream) {
    if (chunk <= 0 || chunk % kThreads != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long R = R1 * R2;
    if (B * M == 0 || R == 0) return 0;
    const long long chunks = (R + chunk - 1) / chunk;
    const long long blocks = B * M * chunks;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    if (wide)
        lane_sum_kernel<double><<<static_cast<unsigned>(blocks), kThreads, 0,
                                  s>>>(static_cast<const double*>(x),
                                       static_cast<double*>(out), R1, M, R2,
                                       chunk, chunks);
    else
        lane_sum_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 s>>>(static_cast<const float*>(x),
                                      static_cast<float*>(out), R1, M, R2,
                                      chunk, chunks);
    return static_cast<int>(cudaGetLastError());
}
