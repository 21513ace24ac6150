// RWKV-6 time-mix recurrence (WKV) for Hopper (sm_90a), forward and backward.
//
// Replaces: no Pallas kernel.  It replaces the reference's compiled time loop,
// src/repro/models/rwkv.py : timemix_scan's jax.lax.scan (:116), which the
// port ran as one eager PyTorch step per token (about ten launches a step).
//
// Per (batch b, head h), with the state S an (N, N) float32 matrix, S_0 = 0:
//
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t
//   y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//
// r, k, v: (B, S, H, N) float32 or bfloat16; w: (B, S, H, N) float32; u:
// (H, N) float32; y: (B, S, H, N) float32; the final state (B, H, N, N)
// float32, row i the k index and column j the v index.
//
// The backward takes gy (B, S, H, N) and gs (B, H, N, N), both float32, and
// returns gr, gk, gv (the inputs' type), gw (float32) and gu (H, N) float32:
//
//   dS_T = gs,  dS_{t-1} = diag(w_t) dS_t + r_t^T gy_t
//   gr_t[i] = sum_j gy_t[j] S_{t-1}[i,j] + u[i] k_t[i] (gy_t . v_t)
//   gk_t[i] = sum_j dS_t[i,j] v_t[j]     + u[i] r_t[i] (gy_t . v_t)
//   gv_t[j] = sum_i dS_t[i,j] k_t[i]     + gy_t[j] sum_i r_t[i] u[i] k_t[i]
//   gw_t[i] = sum_j dS_t[i,j] S_{t-1}[i,j]
//   gu[i]   = sum_{b,t} r_t[i] k_t[i] (gy_t . v_t)
//
// What bounds it on this card: each step is 4 N^2 float32 operations on a
// state that never leaves the chip, and S steps run one after another, so a
// (b, h) pair is bound by the latency of its serial chain; the card holds
// B * H such chains side by side.  Bytes (each input read once) and
// operations are far below that chain at every shape the model runs.
//
// What the design does about it.  Forward: one block per (b, h), one thread
// per column j holding S[:, j] (N floats) in registers for the whole
// sequence, as the RWKV paper's CUDA kernel does; y_t[j] is then a sum
// inside the thread, r_t, k_t and w_t reach every thread through shared
// memory (double-buffered, one barrier a step) and the next step's inputs are
// loaded while this one computes.  Backward, in three passes and a reduction,
// all from one entry:
//   1. the forward again, writing S at every CHUNK-th step (checkpoints);
//   2. per (b, h), one thread per ROW i (every sum but gv's runs along a
//      row): the chunks in reverse; each chunk recomputes its states from its
//      checkpoint into a scratch that the same thread reads back in reverse,
//      so S_{t-1} is never got by dividing by w_t (w underflows to exactly 0
//      in float32 where the true gw stays finite);  gr on the way forward,
//      gk, gw and the bonus sum on the way back, the bonus in float64;
//   3. gv by the reverse recurrence in the column layout (no state needed);
//   4. the bonus summed over the batch in float64, in a fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
        float x) {
    return __float2bfloat16(x);
}

// Forward in the column layout.  y may be null (the backward's pass 1);
// ckpt, when not null, receives S_t for t = 0, CHUNK, 2*CHUNK, ... (the state
// before token t) as [bh][c][i][j].
template <int N, typename T>
__global__ void __launch_bounds__(N)
wkv_forward_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ u, float* __restrict__ y,
                   float* __restrict__ s_out, float* __restrict__ ckpt,
                   int S, int H, int chunk) {
    const int bh = blockIdx.x;
    const int b = bh / H, h = bh % H, j = threadIdx.x;
    __shared__ float sr[2][N], sk[2][N], sw[2][N], su[N];
    su[j] = u[h * N + j];
    float st[N];
#pragma unroll
    for (int i = 0; i < N; ++i) st[i] = 0.f;
    const int64_t step = static_cast<int64_t>(H) * N;
    const int64_t base = (static_cast<int64_t>(b) * S * H + h) * N + j;
    const int n_chunks = (S + chunk - 1) / chunk;
    float rn = 0.f, kn = 0.f, vn = 0.f, wn = 0.f;
    if (S > 0) {
        rn = to_f(r[base]);
        kn = to_f(k[base]);
        vn = to_f(v[base]);
        wn = w[base];
    }
    for (int t = 0; t < S; ++t) {
        const int buf = t & 1;
        sr[buf][j] = rn;
        sk[buf][j] = kn;
        sw[buf][j] = wn;
        const float vj = vn;
        if (t + 1 < S) {
            const int64_t o = base + (t + 1) * step;
            rn = to_f(r[o]);
            kn = to_f(k[o]);
            vn = to_f(v[o]);
            wn = w[o];
        }
        if (ckpt != nullptr && t % chunk == 0) {
            float* c = ckpt + (static_cast<int64_t>(bh) * n_chunks
                               + t / chunk) * N * N + j;
#pragma unroll
            for (int i = 0; i < N; ++i) c[i * N] = st[i];
        }
        __syncthreads();
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < N; ++i) {
            const float kv = sk[buf][i] * vj;
            acc += sr[buf][i] * (st[i] + su[i] * kv);
            st[i] = sw[buf][i] * st[i] + kv;
        }
        if (y != nullptr) y[base + t * step] = acc;
    }
    float* so = s_out + static_cast<int64_t>(bh) * N * N + j;
#pragma unroll
    for (int i = 0; i < N; ++i) so[i * N] = st[i];
}

// Backward pass 2, in the row layout: thread i holds S[i, :] and dS[i, :].
// The chunk's inputs are staged in shared memory; hist ([bh][tt][j][i]) holds
// the chunk's states S_{t-1}, written and read by the same thread.
template <int N, int CHUNK, typename T>
__global__ void __launch_bounds__(N)
wkv_backward_state_kernel(const T* __restrict__ r, const T* __restrict__ k,
                          const T* __restrict__ v, const float* __restrict__ w,
                          const float* __restrict__ u,
                          const float* __restrict__ gy,
                          const float* __restrict__ gs,
                          const float* __restrict__ ckpt,
                          float* __restrict__ hist, T* __restrict__ gr,
                          T* __restrict__ gk, float* __restrict__ gw,
                          double* __restrict__ gu_part, int S, int H) {
    const int bh = blockIdx.x;
    const int b = bh / H, h = bh % H, i = threadIdx.x;
    __shared__ float cr[CHUNK][N], ck[CHUNK][N], cw[CHUNK][N], cv[CHUNK][N],
        cg[CHUNK][N], cgv[CHUNK];
    const float ui = u[h * N + i];
    const int64_t step = static_cast<int64_t>(H) * N;
    const int64_t base = (static_cast<int64_t>(b) * S * H + h) * N + i;
    const int n_chunks = (S + CHUNK - 1) / CHUNK;
    float* my_hist = hist + static_cast<int64_t>(bh) * CHUNK * N * N + i;
    float s[N], ds[N];
    const float* g0 = gs + static_cast<int64_t>(bh) * N * N + i * N;
#pragma unroll
    for (int j = 0; j < N; ++j) ds[j] = g0[j];
    double gu_acc = 0.0;
    for (int c = n_chunks - 1; c >= 0; --c) {
        const int t0 = c * CHUNK;
        const int len = min(CHUNK, S - t0);
        __syncthreads();  // the previous chunk is done with the staging
        for (int tt = 0; tt < len; ++tt) {
            const int64_t o = base + (t0 + tt) * step;
            cr[tt][i] = to_f(r[o]);
            ck[tt][i] = to_f(k[o]);
            cw[tt][i] = w[o];
            cv[tt][i] = to_f(v[o]);
            cg[tt][i] = gy[o];
        }
        __syncthreads();
        for (int tt = i; tt < len; tt += N) {
            float dot = 0.f;
#pragma unroll
            for (int j = 0; j < N; ++j) dot += cg[tt][j] * cv[tt][j];
            cgv[tt] = dot;
        }
        __syncthreads();
        const float* c0 = ckpt + (static_cast<int64_t>(bh) * n_chunks + c)
                                     * N * N + i * N;
#pragma unroll
        for (int j = 0; j < N; ++j) s[j] = c0[j];
        // forward through the chunk: keep S_{t-1}, and gr_t
        for (int tt = 0; tt < len; ++tt) {
            float* hp = my_hist + static_cast<int64_t>(tt) * N * N;
            float a = 0.f;
#pragma unroll
            for (int j = 0; j < N; ++j) {
                hp[j * N] = s[j];
                a += cg[tt][j] * s[j];
            }
            const float ki = ck[tt][i], wi = cw[tt][i];
            gr[base + (t0 + tt) * step] = from_f<T>(a + ui * ki * cgv[tt]);
#pragma unroll
            for (int j = 0; j < N; ++j) s[j] = wi * s[j] + ki * cv[tt][j];
        }
        // back through the chunk: gk_t, gw_t and the bonus, then dS_{t-1}
        for (int tt = len - 1; tt >= 0; --tt) {
            const float* hp = my_hist + static_cast<int64_t>(tt) * N * N;
            const float ri = cr[tt][i], ki = ck[tt][i], wi = cw[tt][i];
            const float gv_dot = cgv[tt];
            float sw_ = 0.f, sk_ = 0.f;
#pragma unroll
            for (int j = 0; j < N; ++j) {
                sw_ += ds[j] * hp[j * N];
                sk_ += ds[j] * cv[tt][j];
            }
            const int64_t o = base + (t0 + tt) * step;
            gw[o] = sw_;
            gk[o] = from_f<T>(sk_ + ui * ri * gv_dot);
            gu_acc += static_cast<double>(ri * ki * gv_dot);
#pragma unroll
            for (int j = 0; j < N; ++j) ds[j] = wi * ds[j] + ri * cg[tt][j];
        }
    }
    gu_part[static_cast<int64_t>(bh) * N + i] = gu_acc;
}

// Backward pass 3, in the column layout: thread j holds dS[:, j].
template <int N, typename T>
__global__ void __launch_bounds__(N)
wkv_backward_v_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const float* __restrict__ w, const float* __restrict__ u,
                      const float* __restrict__ gy,
                      const float* __restrict__ gs, T* __restrict__ gv,
                      int S, int H) {
    const int bh = blockIdx.x;
    const int b = bh / H, h = bh % H, j = threadIdx.x;
    __shared__ float sr[2][N], sk[2][N], sw[2][N], su[N];
    su[j] = u[h * N + j];
    float ds[N];
    const float* g0 = gs + static_cast<int64_t>(bh) * N * N + j;
#pragma unroll
    for (int i = 0; i < N; ++i) ds[i] = g0[i * N];
    const int64_t step = static_cast<int64_t>(H) * N;
    const int64_t base = (static_cast<int64_t>(b) * S * H + h) * N + j;
    float rn = 0.f, kn = 0.f, wn = 0.f, gn = 0.f;
    if (S > 0) {
        const int64_t o = base + (S - 1) * step;
        rn = to_f(r[o]);
        kn = to_f(k[o]);
        wn = w[o];
        gn = gy[o];
    }
    for (int t = S - 1; t >= 0; --t) {
        const int buf = t & 1;
        sr[buf][j] = rn;
        sk[buf][j] = kn;
        sw[buf][j] = wn;
        const float gj = gn;
        if (t > 0) {
            const int64_t o = base + (t - 1) * step;
            rn = to_f(r[o]);
            kn = to_f(k[o]);
            wn = w[o];
            gn = gy[o];
        }
        __syncthreads();
        float ruk = 0.f, acc = 0.f;
#pragma unroll
        for (int i = 0; i < N; ++i) {
            ruk += sr[buf][i] * su[i] * sk[buf][i];
            acc += ds[i] * sk[buf][i];
            ds[i] = sw[buf][i] * ds[i] + sr[buf][i] * gj;
        }
        gv[base + t * step] = from_f<T>(acc + gj * ruk);
    }
}

// The bonus gradient: gu[h, i] = sum over b of gu_part[b, h, i], in order.
__global__ void wkv_bonus_sum_kernel(const double* __restrict__ gu_part,
                                     float* __restrict__ gu, int B, int HN) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    if (x >= HN) return;
    double acc = 0.0;
    for (int b = 0; b < B; ++b) acc += gu_part[static_cast<int64_t>(b) * HN + x];
    gu[x] = static_cast<float>(acc);
}

constexpr int kChunk = 32;  // the backward's checkpoint interval

template <int N, typename T>
int forward_n(const void* r, const void* k, const void* v, const void* w,
              const void* u, void* y, void* s, void* ckpt, int B, int S,
              int H, cudaStream_t st) {
    wkv_forward_kernel<N, T><<<B * H, N, 0, st>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(w),
        static_cast<const float*>(u), static_cast<float*>(y),
        static_cast<float*>(s), static_cast<float*>(ckpt), S, H, kChunk);
    return static_cast<int>(cudaGetLastError());
}

template <int N, typename T>
int backward_n(const void* r, const void* k, const void* v, const void* w,
               const void* u, const void* gy, const void* gs, void* ckpt,
               void* hist, void* gu_part, void* s_scratch, void* gr,
               void* gk, void* gv, void* gw, void* gu, int B, int S, int H,
               cudaStream_t st) {
    int err = forward_n<N, T>(r, k, v, w, u, nullptr, s_scratch, ckpt, B, S,
                              H, st);
    if (err != 0) return err;
    wkv_backward_state_kernel<N, kChunk, T><<<B * H, N, 0, st>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(w),
        static_cast<const float*>(u), static_cast<const float*>(gy),
        static_cast<const float*>(gs), static_cast<const float*>(ckpt),
        static_cast<float*>(hist), static_cast<T*>(gr), static_cast<T*>(gk),
        static_cast<float*>(gw), static_cast<double*>(gu_part), S, H);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    wkv_backward_v_kernel<N, T><<<B * H, N, 0, st>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const float*>(w), static_cast<const float*>(u),
        static_cast<const float*>(gy), static_cast<const float*>(gs),
        static_cast<T*>(gv), S, H);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    const int HN = H * N;
    wkv_bonus_sum_kernel<<<(HN + 255) / 256, 256, 0, st>>>(
        static_cast<const double*>(gu_part), static_cast<float*>(gu), B, HN);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int forward_t(const void* r, const void* k, const void* v, const void* w,
              const void* u, void* y, void* s, int B, int S, int H, int N,
              cudaStream_t st) {
    switch (N) {
        case 8: return forward_n<8, T>(r, k, v, w, u, y, s, nullptr, B, S, H, st);
        case 16: return forward_n<16, T>(r, k, v, w, u, y, s, nullptr, B, S, H, st);
        case 32: return forward_n<32, T>(r, k, v, w, u, y, s, nullptr, B, S, H, st);
        case 64: return forward_n<64, T>(r, k, v, w, u, y, s, nullptr, B, S, H, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

template <typename T>
int backward_t(const void* r, const void* k, const void* v, const void* w,
               const void* u, const void* gy, const void* gs, void* ckpt,
               void* hist, void* gu_part, void* s_scratch, void* gr, void* gk,
               void* gv, void* gw, void* gu, int B, int S, int H, int N,
               cudaStream_t st) {
#define WKV_BWD(n) backward_n<n, T>(r, k, v, w, u, gy, gs, ckpt, hist, \
    gu_part, s_scratch, gr, gk, gv, gw, gu, B, S, H, st)
    switch (N) {
        case 8: return WKV_BWD(8);
        case 16: return WKV_BWD(16);
        case 32: return WKV_BWD(32);
        case 64: return WKV_BWD(64);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef WKV_BWD
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (r, k, v and gr, gk, gv).
extern "C" int wkv_forward_launch(const void* r, const void* k, const void* v,
                                  const void* w, const void* u, void* y,
                                  void* s, int B, int S, int H, int N,
                                  int dtype, void* stream) {
    auto st = static_cast<cudaStream_t>(stream);
    if (B * H == 0) return 0;
    return dtype == 1
        ? forward_t<__nv_bfloat16>(r, k, v, w, u, y, s, B, S, H, N, st)
        : forward_t<float>(r, k, v, w, u, y, s, B, S, H, N, st);
}

// The backward's scratch, allocated by the caller: ckpt (B*H, ceil(S/chunk),
// N, N) float32, hist (B*H, chunk, N, N) float32, gu_part (B, H, N) float64
// and s_scratch (B, H, N, N) float32.
extern "C" int wkv_backward_launch(const void* r, const void* k,
                                   const void* v, const void* w,
                                   const void* u, const void* gy,
                                   const void* gs, void* ckpt, void* hist,
                                   void* gu_part, void* s_scratch, void* gr,
                                   void* gk, void* gv, void* gw, void* gu,
                                   int B, int S, int H, int N, int dtype,
                                   void* stream) {
    auto st = static_cast<cudaStream_t>(stream);
    if (B * H == 0) return 0;
    return dtype == 1
        ? backward_t<__nv_bfloat16>(r, k, v, w, u, gy, gs, ckpt, hist,
                                    gu_part, s_scratch, gr, gk, gv, gw, gu,
                                    B, S, H, N, st)
        : backward_t<float>(r, k, v, w, u, gy, gs, ckpt, hist, gu_part,
                            s_scratch, gr, gk, gv, gw, gu, B, S, H, N, st);
}

extern "C" int wkv_chunk() { return kChunk; }
