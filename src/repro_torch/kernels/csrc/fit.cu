// Placement fit-scoring kernel for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fit.py : fit_scores_many_pallas (the lockstep
// placement's batched scorer, src/repro/core/place_batch.py) and, as its B=1
// call, fit_scores_pallas (TypePool.find_fit, src/repro/core/placement.py).
//
// For every (instance b, open node i), over the task's span [s_b, e_b] and all
// D dimensions of the node's remaining capacity rem[b, i, t, d]:
//
//   feas[b, i] = min_{t, d} (rem - dem[b, d])                 (float32, exact)
//   dot[b, i]  = sum_{t, d} (rem * inv_cap[b, d]) * (dem[b, d] * inv_cap[b, d])
//   norm[b, i] = sum_{t, d} (rem * inv_cap[b, d])^2
//
// rem: (B, N, T, D) float32 in the host's own layout; dem, inv_cap: (B, D)
// float32; s, e: (B,) int32 inclusive spans (or one scalar span for B = 1);
// outputs (B, N) float32.  Padded dimensions carry inv_cap = 0 and dem = 0.
//
// What bounds it on this card: each node's span is read once and reduced with
// a handful of operations per element, so it is bound by the bytes of the
// span it reads; at the lockstep's sizes (a few dozen nodes of T' * D <= 120
// floats) it is bound by launch latency.
//
// What the design does about it: the TPU kernel transposed rem to (T, D, N)
// so nodes rode its 128-lane axis.  Here one warp owns one (b, node): the
// node's (T, D) row is contiguous in the host layout, and the span [s, e] is
// the contiguous sub-range [s*D, (e+1)*D) of it, so the warp reads exactly the
// span with coalesced loads, no transpose and no mask.  The three reductions
// run in registers and finish with warp shuffles.  The margin is computed as
// float(rem) - float(dem) in float32, as the reference computes it, and a
// minimum is exact in any order, so the feasibility margin is bit-equal to
// the reference's.  dot and norm are float32 sums in another order.

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
fit_scores_many_kernel(const float* __restrict__ rem,
                       const float* __restrict__ dem,
                       const float* __restrict__ inv_cap,
                       const int32_t* __restrict__ s_ptr,
                       const int32_t* __restrict__ e_ptr,
                       int s0, int e0,
                       float* __restrict__ feas,
                       float* __restrict__ dot,
                       float* __restrict__ norm,
                       int B, int N, int T, int D) {
    const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock
                        + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (row >= static_cast<int64_t>(B) * N) return;
    const int b = static_cast<int>(row / N);
    const int s = s_ptr ? s_ptr[b] : s0;
    const int e = e_ptr ? e_ptr[b] : e0;
    const float* r = rem + row * T * D;
    const float* dm = dem + static_cast<int64_t>(b) * D;
    const float* ic = inv_cap + static_cast<int64_t>(b) * D;

    float mn = FLT_MAX;
    float sd = 0.0f;
    float sn = 0.0f;
    const int lo = max(s, 0) * D;
    const int hi = min(e + 1, T) * D;
    for (int i = lo + lane; i < hi; i += 32) {
        const int d = i % D;
        const float x = r[i];
        const float dd = __ldg(dm + d);
        const float inv = __ldg(ic + d);
        mn = fminf(mn, x - dd);
        const float xn = x * inv;
        sd = fmaf(xn, dd * inv, sd);
        sn = fmaf(xn, xn, sn);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
        sd += __shfl_xor_sync(0xffffffffu, sd, off);
        sn += __shfl_xor_sync(0xffffffffu, sn, off);
    }
    if (lane == 0) {
        feas[row] = mn;
        dot[row] = sd;
        norm[row] = sn;
    }
}

int launch(const void* rem, const void* dem, const void* inv_cap,
           const void* s_ptr, const void* e_ptr, int s0, int e0,
           void* feas, void* dot, void* norm, int B, int N, int T, int D,
           void* stream) {
    if (B <= 0 || N <= 0) return 0;
    const int64_t rows = static_cast<int64_t>(B) * N;
    const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
    fit_scores_many_kernel<<<static_cast<unsigned>(blocks), 32 * kWarpsPerBlock,
                             0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rem), static_cast<const float*>(dem),
        static_cast<const float*>(inv_cap),
        static_cast<const int32_t*>(s_ptr), static_cast<const int32_t*>(e_ptr),
        s0, e0, static_cast<float*>(feas), static_cast<float*>(dot),
        static_cast<float*>(norm), B, N, T, D);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Batched form: one span per instance, read from device memory.
extern "C" int fit_scores_many_launch(const void* rem, const void* dem,
                                      const void* inv_cap, const void* s,
                                      const void* e, void* feas, void* dot,
                                      void* norm, int B, int N, int T, int D,
                                      void* stream) {
    return launch(rem, dem, inv_cap, s, e, 0, 0, feas, dot, norm, B, N, T, D,
                  stream);
}

// Single-instance form (B = 1): the span travels as two kernel arguments.
extern "C" int fit_scores_launch(const void* rem, const void* dem,
                                 const void* inv_cap, int s, int e,
                                 void* feas, void* dot, void* norm,
                                 int N, int T, int D, void* stream) {
    return launch(rem, dem, inv_cap, nullptr, nullptr, s, e, feas, dot, norm,
                  1, N, T, D, stream);
}
