// RG-LRU linear scan for Hopper (sm_90a), forward and backward.
//
// Replaces: no Pallas kernel.  It replaces the reference's compiled
// log-depth scan, src/repro/models/rglru.py : rglru_scan's
// jax.lax.associative_scan (:84), which the port ran as one eager PyTorch
// step per token (three launches a step).  Griffin's own GPU path is a fused
// linear scan like this one (arXiv:2402.19427, section 4).
//
//   forward:   h_t = a_t * h_{t-1} + b_t,  h_{-1} = 0
//   backward:  dh_t = gh_t + a_{t+1} * dh_{t+1}  (dh_S = 0),
//              ga_t = dh_t * h_{t-1},  gb_t = dh_t
//
// a, b, h, gh, ga, gb: (B, S, W) float32, contiguous.
//
// What bounds it on this card: two reads and one write of 4 bytes per element
// (forward; three and two backward) and two operations, so bytes bound it;
// each (b, channel) is a serial chain of S steps, and the chain's latency
// bounds it where B * W is small beside the card.
//
// What the design does about it: one thread per (b, channel), consecutive
// threads on consecutive channels, so every step's loads and stores are
// coalesced; the loop loads UNROLL steps ahead of the dependent chain.  The
// multiply and the add are rounded apart (__fmul_rn, __fadd_rn, no fused
// multiply-add), as the plain PyTorch loop rounds them, so the two agree bit
// for bit; the reference's log-depth order rounds otherwise.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
linear_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ h, int B, int S, int W) {
    const int64_t x = static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x;
    if (x >= static_cast<int64_t>(B) * W) return;
    const int64_t bi = x / W, c = x % W;
    const int64_t base = bi * S * W + c;
    float acc = 0.f;
    int t = 0;
    for (; t + kUnroll <= S; t += kUnroll) {
        float av[kUnroll], bv[kUnroll];
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
            av[q] = a[base + static_cast<int64_t>(t + q) * W];
            bv[q] = b[base + static_cast<int64_t>(t + q) * W];
        }
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
            acc = __fadd_rn(__fmul_rn(av[q], acc), bv[q]);
            h[base + static_cast<int64_t>(t + q) * W] = acc;
        }
    }
    for (; t < S; ++t) {
        const int64_t o = base + static_cast<int64_t>(t) * W;
        acc = __fadd_rn(__fmul_rn(a[o], acc), b[o]);
        h[o] = acc;
    }
}

__global__ void __launch_bounds__(kThreads)
linear_scan_backward_kernel(const float* __restrict__ a,
                            const float* __restrict__ h,
                            const float* __restrict__ gh,
                            float* __restrict__ ga, float* __restrict__ gb,
                            int B, int S, int W) {
    const int64_t x = static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x;
    if (x >= static_cast<int64_t>(B) * W) return;
    const int64_t bi = x / W, c = x % W;
    const int64_t base = bi * S * W + c;
    float carry = 0.f;  // a_{t+1} * dh_{t+1}
    int t = S - 1;
    for (; t - kUnroll + 1 >= 0; t -= kUnroll) {
        float av[kUnroll], gv[kUnroll], hv[kUnroll];
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
            const int64_t o = base + static_cast<int64_t>(t - q) * W;
            av[q] = a[o];
            gv[q] = gh[o];
            hv[q] = t - q > 0 ? h[o - W] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
            const int64_t o = base + static_cast<int64_t>(t - q) * W;
            const float dh = __fadd_rn(gv[q], carry);
            gb[o] = dh;
            ga[o] = __fmul_rn(dh, hv[q]);
            carry = __fmul_rn(av[q], dh);
        }
    }
    for (; t >= 0; --t) {
        const int64_t o = base + static_cast<int64_t>(t) * W;
        const float dh = __fadd_rn(gh[o], carry);
        gb[o] = dh;
        ga[o] = __fmul_rn(dh, t > 0 ? h[o - W] : 0.f);
        carry = __fmul_rn(a[o], dh);
    }
}

int blocks(int B, int W) {
    return static_cast<int>((static_cast<int64_t>(B) * W + kThreads - 1)
                            / kThreads);
}

}  // namespace

extern "C" int linear_scan_launch(const void* a, const void* b, void* h,
                                  int B, int S, int W, void* stream) {
    if (static_cast<int64_t>(B) * W == 0) return 0;
    linear_scan_kernel<<<blocks(B, W), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(h), B, S, W);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int linear_scan_backward_launch(const void* a, const void* h,
                                           const void* gh, void* ga, void* gb,
                                           int B, int S, int W,
                                           void* stream) {
    if (static_cast<int64_t>(B) * W == 0) return 0;
    linear_scan_backward_kernel<<<blocks(B, W), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(h),
        static_cast<const float*>(gh), static_cast<float*>(ga),
        static_cast<float*>(gb), B, S, W);
    return static_cast<int>(cudaGetLastError());
}
