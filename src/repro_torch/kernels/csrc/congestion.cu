// Interval-congestion kernel for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/congestion.py : congestion_many_pallas (and its
// G=1 wrapper congestion_pallas), the forward map of the LP solver's
// congestion operator (src/repro/core/batch.py, operator="pallas").
//
//   out[g, t, k] = sum_u [start[g,u] <= t <= end[g,u]] * w[g, u, k]
//
// start, end: (G, n) int32; w: (G, n, K) float32; out: (G, T, K) float32,
// all contiguous.  Accumulation is float32.
//
// What bounds it on this card: on the solver's path K = D is 2..5 and T is a
// trimmed timeline of a few dozen slots, so the output is tiny and the work is
// one pass over w (G*n*K floats) plus the spans; the kernel is bound by the
// bytes it reads (and, at these sizes, by launch latency), not by arithmetic.
// The mask-matmul has 2*G*T*n*K operations, far below the card's f32 rate.
//
// What the design does about it: the TPU kernel padded K to 128 lanes for its
// matrix unit; at K <= 5 that is almost all padding, so here K is not padded
// at all.  One block owns one (group, 32-slot tile): lane = time slot, warp =
// a slice of the tasks.  The block stages chunks of start/end/w in shared
// memory (read once from device memory, then broadcast to all 32 slots), each
// thread accumulates up to KC output columns in registers, and the warps'
// partial sums are added in shared memory at the end.  The activity mask is
// never written anywhere, as on the TPU.  Padding tasks (start=1, end=0, or
// any span with zero weight) add exact zeros.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kSlots = 32;     // time slots per block (one per lane)
constexpr int kWarps = 8;      // task slices per block
constexpr int kChunk = 256;    // tasks staged in shared memory per round
constexpr int kKC = 8;         // output columns accumulated per pass

__global__ void __launch_bounds__(kSlots * kWarps)
congestion_many_kernel(const int32_t* __restrict__ start,
                       const int32_t* __restrict__ end,
                       const float* __restrict__ w,
                       float* __restrict__ out,
                       int n, int T, int K, int t_tiles) {
    __shared__ int32_t s_start[kChunk];
    __shared__ int32_t s_end[kChunk];
    __shared__ float s_w[kChunk * kKC];
    __shared__ float s_red[kWarps][kKC][kSlots];

    const int g = blockIdx.x / t_tiles;
    const int t0 = (blockIdx.x % t_tiles) * kSlots;
    const int lane = threadIdx.x % kSlots;
    const int warp = threadIdx.x / kSlots;
    const int t = t0 + lane;

    const int64_t task0 = static_cast<int64_t>(g) * n;
    const int32_t* g_start = start + task0;
    const int32_t* g_end = end + task0;
    const float* g_w = w + task0 * K;

    for (int k0 = 0; k0 < K; k0 += kKC) {
        const int kc = min(kKC, K - k0);
        float acc[kKC];
#pragma unroll
        for (int j = 0; j < kKC; ++j) acc[j] = 0.0f;

        for (int u0 = 0; u0 < n; u0 += kChunk) {
            const int cn = min(kChunk, n - u0);
            __syncthreads();  // the previous round's readers are done
            for (int i = threadIdx.x; i < cn; i += blockDim.x) {
                s_start[i] = g_start[u0 + i];
                s_end[i] = g_end[u0 + i];
            }
            for (int i = threadIdx.x; i < cn * kc; i += blockDim.x) {
                const int u = i / kc;
                const int j = i % kc;
                s_w[u * kKC + j] = g_w[static_cast<int64_t>(u0 + u) * K + k0 + j];
            }
            __syncthreads();
            for (int u = warp; u < cn; u += kWarps) {
                const float a = (s_start[u] <= t && t <= s_end[u]) ? 1.0f : 0.0f;
#pragma unroll
                for (int j = 0; j < kKC; ++j) {
                    if (j < kc) acc[j] = fmaf(a, s_w[u * kKC + j], acc[j]);
                }
            }
        }

#pragma unroll
        for (int j = 0; j < kKC; ++j) s_red[warp][j][lane] = acc[j];
        __syncthreads();
        // one thread per (column, slot) adds the warps' partial sums
        for (int i = threadIdx.x; i < kc * kSlots; i += blockDim.x) {
            const int j = i / kSlots;
            const int l = i % kSlots;
            const int tt = t0 + l;
            if (tt < T) {
                float s = 0.0f;
#pragma unroll
                for (int q = 0; q < kWarps; ++q) s += s_red[q][j][l];
                out[(static_cast<int64_t>(g) * T + tt) * K + k0 + j] = s;
            }
        }
        __syncthreads();  // s_red is reused by the next column pass
    }
}

}  // namespace

extern "C" int congestion_many_launch(const void* start, const void* end,
                                      const void* w, void* out,
                                      int G, int n, int T, int K,
                                      void* stream) {
    if (G <= 0 || T <= 0 || K <= 0) return 0;
    const int t_tiles = (T + kSlots - 1) / kSlots;
    const int64_t blocks = static_cast<int64_t>(G) * t_tiles;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
    congestion_many_kernel<<<static_cast<unsigned>(blocks), kSlots * kWarps, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(start), static_cast<const int32_t*>(end),
        static_cast<const float*>(w), static_cast<float*>(out), n, T, K,
        t_tiles);
    return static_cast<int>(cudaGetLastError());
}
