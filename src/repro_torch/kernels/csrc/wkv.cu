// RWKV-6 time-mix recurrence (WKV) for Hopper (sm_90a), forward and backward,
// in the chunked form on the tensor cores.
//
// Replaces: no Pallas kernel.  It replaces the reference's compiled time loop,
// src/repro/models/rwkv.py : timemix_scan's jax.lax.scan (:116).
//
// Per (batch b, head h), with the state S an (N, N) float32 matrix, S_0 = 0:
//
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t,     w_t = exp(lw_t)
//   y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//
// r, k, v: (B, S, H, N) float32 or bfloat16; lw: (B, S, H, N) float32, the
// log-decays (<= 0, may be -inf); u: (H, N) float32; y: (B, S, H, N) float32;
// the final state (B, H, N, N) float32, row i the k index, column j the v
// index.  The backward takes gy (B, S, H, N) and gs (B, H, N, N), both
// float32, and returns gr, gk, gv (the inputs' type), glw (float32) and gu
// (H, N) float32.
//
// The chunked form (kernels/ref.py wkv_chunked_ref and
// wkv_chunked_backward_ref mirror it step for step).  Time is cut into
// chunks of L = 64 steps.  Inside a chunk, C[t] is the prefix sum of the
// log-decays, clamped at -1000 (exp underflows there anyway; the clamp also
// turns -inf into a finite number), in float64 and in log2 units, so that a
// difference of two sums keeps its small terms after a clamped step.  Every
// decay factor is 2^(C[x] - C[y]) with x >= y, so no factor exceeds 1, and
// nothing divides by w or by a product of decays.  With S_in the state
// entering the chunk:
//
//   y_t   = sum_{s <= t} A[t, s] v_s + (r_t 2^C[t-1]) S_in
//   A[t, s] = sum_i r_t[i] k_s[i] 2^(C[t-1, i] - C[s, i])   (s < t)
//   A[t, t] = r_t . (u k_t)                                  (the bonus)
//   S_out = diag(2^C[L-1]) S_in + (k 2^(C[L-1] - C))^T v
//
// A is computed by sub-chunks of 16: sub-chunk a's rows against earlier
// sub-chunks with r scaled to the anchor f = 16a - 1 and k from it (both
// factors <= 1) as tensor-core products, and its second half against its
// first the same way (anchor 16a + 7); inside each half of 8, elementwise.
// The backward carries dS_out, the gradient of the state after the chunk,
// by a reverse pass over chunks, dS_out[c-1] = diag(2^C[L-1]) dS_out[c] +
// (r 2^C[t-1])^T gy; then per chunk, with dA[t, s] = gy_t . v_s:
//
//   gv = A^T gy + (k 2^(C[L-1] - C)) dS_out
//   gr = sub-chunk-anchored (dA k) + 2^C[t-1] (gy S_in^T) + diagonal blocks
//        + u k (gy_t . v_t)
//   gk = sub-chunk-anchored (dA^T r) + 2^(C[L-1] - C) (v dS_out^T) + ...
//   glw_s = rowsum(dS_out * S_out) + sum_{t > s} r_t gr'_t
//           - sum_{t >= s} k_t gk'_t                (gr', gk' without bonus)
//
// (the reverse cumulative sum identity of the chunked form; glw is exactly
// 0 at the sequence's first step, since w_0 multiplies the zero state, and
// wherever the step's decay 2^(C[t] - C[t-1]) = exp(lw_t) is 0 in float32,
// as gw w is there: the identity's sums would leave their rounding, which
// the model's chain rule scales by |lw|), and gu summed in float64 in a
// fixed order.
//
// Every product runs on the tensor cores as mma.sync m16n8k8 in TF32 with
// the 3-pass split (a = a_hi + a_lo; a_hi b_hi + a_hi b_lo + a_lo b_hi),
// which keeps float32 accuracy where one TF32 pass would not (about 3e-4 of
// max |y|).  Operands are read from shared memory through small functors
// that apply the decay factors as the fragments load.
//
// The forward is one kernel (wkv_forward_kernel), one block a chunk, the
// chunks taken in ticket order from an atomic counter (chunk-major), so a
// block only ever waits for a block that started before it.  Warps 0-3
// compute the chunk's state increment, wait for the state entering the
// chunk (a flag set by the chunk before, release/acquire), publish the
// state leaving it to a two-slot ring in L2 and raise the next chunk's
// flag; warps 4-7 meanwhile compute A's tensor-core blocks; then every warp
// takes slices of A's elementwise pairs from a shared counter, and all
// eight compute y.  The serial chain is one handoff a chunk (65 at S =
// 4100, not 4100 steps), and a chunk's predecessor started a whole wave of
// blocks earlier, so a block seldom waits.
//
// The backward is four launches: chunk_state (per chunk, the state and
// state-gradient increments and the decay), state_scan (one thread a state
// entry: the states entering every chunk forward and the state gradients
// after every chunk in reverse, nc steps each, loads batched eight chunks
// ahead), chunk_grad (per chunk, the gradients) and bonus_sum (gu over
// batches and chunks in order).
//
// What bounds them on this card (scripts/wkv_phase_trace.py: the forward's
// phase timers, the backward's launches under torch.profiler).  Not bytes
// (moving each input and output once takes under a fifth of either
// pass's time) and not the serial chain: a chunk's successor is seldom waiting when it publishes,
// and 65 publishes and flag hand-overs are about a fifth of the forward.
// The forward is held by its blocks' own work at the residency shared
// memory allows (two blocks an SM in bfloat16, one in float32), wave after
// wave: in a block, the state increment and the scores on the tensor cores
// (issuing the fragment loads and their float64 decay factors), the
// elementwise pairs, and the state's read and write through L2 when it is
// handed on.  The backward is held by chunk_grad (about seven tenths of a
// call), then the state pass and chunk_state.  What the design does about
// it: every factor is computed once (full-width tiles for the increment
// and y, one score job a row of sub-chunks), the elementwise pairs are cut
// to the 8 x 8 leaf blocks (224 a chunk, not 480) and laid out so that no
// warp diverges, each product keeps the 3-pass split's small terms in an
// accumulator of its own (two chains, not one), the low pass is skipped
// where the B operand is exact (bfloat16 v), the forward's state work
// overlaps its score work, and inputs are staged with cp.async (log-decays
// first, so the prefix sums start while the rest lands).
//
// Scratch, allocated by the caller.  Forward: the ring (B H, 2, N, N)
// float32 and the ticket and flags (1 + B H nc) int32.  Backward: the chunk
// states (B H, nc + 1, N, N) (the last slot the final state) and their
// gradients (B H, nc, N, N) float32, the chunk
// decays (B H, nc, N) float32 and the float64 bonus partials (B, H, nc, N).
// No per-step state reaches device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int L = 64;          // time steps a chunk
constexpr int SUB = 16;        // sub-chunk of the intra-chunk scores
constexpr int NSUB = L / SUB;
constexpr int THREADS = 256;   // 8 warps a block
constexpr int WARPS = THREADS / 32;
constexpr int RA = L + 4;      // row stride of the L x L score matrices
constexpr double LOG2E = 1.4426950408889634;
constexpr double LW_FLOOR = -1000.0;

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

// 2^(a - b) for float64 prefix sums a, b of log2-decays (a - b <= 0): the
// difference in float64, then exp2 in float32; and 2^a
__device__ __forceinline__ float e2(double a, double b) {
    return exp2f(static_cast<float>(a - b));
}
__device__ __forceinline__ float e2(double a) {
    return exp2f(static_cast<float>(a));
}

// --- tensor-core tiles -------------------------------------------------------

__device__ __forceinline__ uint32_t tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[j] (a 16 x 8 tile) += sum_{k < K} fa(m, k) fb(k, 8 j + n) for m < 16,
// n < 8, j < NT, in TF32 with the 3-pass split; K a multiple of 8.  BX: the
// B operand is exact in TF32 (bfloat16 values), so its low part is 0 and
// its pass is skipped.  Called by a whole warp.
template <int NT, bool BX = false, typename FA, typename FB>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], int K, FA fa,
                                         FB fb) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    float corr[NT][4];  // the small terms: a chain of their own
#pragma unroll
    for (int j = 0; j < NT; ++j)
        corr[j][0] = corr[j][1] = corr[j][2] = corr[j][3] = 0.f;
    for (int k0 = 0; k0 < K; k0 += 8) {
        uint32_t ah[4], al[4];
        split(fa(g, k0 + t), ah[0], al[0]);
        split(fa(g + 8, k0 + t), ah[1], al[1]);
        split(fa(g, k0 + t + 4), ah[2], al[2]);
        split(fa(g + 8, k0 + t + 4), ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            uint32_t bh[2], bl[2];
            if (BX) {
                bh[0] = __float_as_uint(fb(k0 + t, 8 * j + g));
                bh[1] = __float_as_uint(fb(k0 + t + 4, 8 * j + g));
            } else {
                split(fb(k0 + t, 8 * j + g), bh[0], bl[0]);
                split(fb(k0 + t + 4, 8 * j + g), bh[1], bl[1]);
                mma(corr[j], ah, bl);
            }
            mma(corr[j], al, bh);
            mma(acc[j], ah, bh);
        }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] += corr[j][q];
}

// f(m, n, value) for every element this lane holds of the tiles
template <int NT, typename F>
__device__ __forceinline__ void warp_each(const float (&acc)[NT][4], F f) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
        f(g, 8 * j + 2 * t, acc[j][0]);
        f(g, 8 * j + 2 * t + 1, acc[j][1]);
        f(g + 8, 8 * j + 2 * t, acc[j][2]);
        f(g + 8, 8 * j + 2 * t + 1, acc[j][3]);
    }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// --- staging -----------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int n> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Shapes of the shared tiles for head size N and input type T.
template <int N, typename T> struct Tiles {
    static constexpr int RT = N + 16 / static_cast<int>(sizeof(T));
    static constexpr int RF = N + 4;
    static constexpr int T_BYTES = L * RT * static_cast<int>(sizeof(T));
    static constexpr int F_BYTES = L * RF * 4;
    static constexpr int S_BYTES = N * RF * 4;
    static constexpr int CS = N + 4;  // C's row stride: rows 4 banks apart
    static constexpr int C_BYTES = L * CS * 8;
    static constexpr int A_BYTES = L * RA * 4;
    // output tiles: 16-row tiles of N rows, column groups of 8 NTH columns
    static constexpr int NTH = N >= 16 ? N / 16 : 1;
    static constexpr int NCG = N / (8 * NTH);
    static constexpr int RTILES = (N + 15) / 16;
};

// The chunk's rows [t0, t0 + L) of x (B, S, H, N) for (b, h) into an [L][RS]
// tile of the same type, zeros past S; 16 bytes a copy, in flight until the
// caller waits.
template <int N, int RS, typename E>
__device__ __forceinline__ void stage(E* tile, const E* x, int b, int h,
                                      int t0, int S, int H) {
    constexpr int W = 16 / static_cast<int>(sizeof(E));
    constexpr int PER_ROW = N / W;
    for (int q = threadIdx.x; q < L * PER_ROW; q += THREADS) {
        const int tau = q / PER_ROW, piece = q % PER_ROW;
        const int t = t0 + tau;
        const bool ok = t < S;
        const E* src = ok ? x + ((static_cast<int64_t>(b) * S + t) * H + h)
                                    * N + piece * W
                          : x;
        cp_async16(tile + tau * RS + piece * W, src, ok);
    }
}

// an N x N state (contiguous) into an [N][N + 4] tile
template <int N>
__device__ __forceinline__ void stage_state(float* tile, const float* s) {
    constexpr int PER_ROW = N / 4;
    for (int q = threadIdx.x; q < N * PER_ROW; q += THREADS) {
        const int i = q / PER_ROW, piece = q % PER_ROW;
        cp_async16(tile + i * (N + 4) + piece * 4, s + i * N + piece * 4,
                   true);
    }
}

// C[t][i]: the prefix sums of the clamped log-decays in log2 units, float64;
// THREADS / N segments of the chunk summed side by side, then offset.
template <int N>
__device__ __forceinline__ void prefix(double* C, const float* lw_tile) {
    constexpr int CS = N + 4, SEGS = THREADS / N, LEN = L / SEGS;
    __shared__ double seg_total[THREADS];
    const int seg = threadIdx.x / N, i = threadIdx.x % N, t0 = seg * LEN;
    double part[LEN];
    double acc = 0.0;
#pragma unroll
    for (int x = 0; x < LEN; ++x) {
        acc += fmax(static_cast<double>(lw_tile[(t0 + x) * (N + 4) + i]),
                    LW_FLOOR) * LOG2E;
        part[x] = acc;
    }
    seg_total[threadIdx.x] = acc;
    __syncthreads();
    double off = 0.0;
    for (int q = 0; q < seg; ++q) off += seg_total[q * N + i];
#pragma unroll
    for (int x = 0; x < LEN; ++x) C[(t0 + x) * CS + i] = part[x] + off;
}

// C[t - 1][i], 0 before the chunk
template <int N>
__device__ __forceinline__ double cm(const double* C, int t, int i) {
    constexpr int CS = N + 4;
    return t > 0 ? C[(t - 1) * CS + i] : 0.0;
}

// --- the intra-chunk scores A ------------------------------------------------

constexpr int LEAF = 8;  // blocks of A computed elementwise
constexpr int LEAF_PAIRS = LEAF * (LEAF - 1) / 2;  // pairs s < t in a leaf
constexpr int SCORE_JOBS = 8;

// A's tensor-core blocks, eight jobs of one warp: (r_t 2^(C[t-1] - C[f])) .
// (k_s 2^(C[f] - C[s])), both factors <= 1, where
//   jobs 0-3: sub-chunk a's rows against all earlier sub-chunks, f = 16a -
//             1 (a = 1, 2: 16 x 16a; a = 3 in two jobs of 16 x 24);
//   jobs 4-7: in sub-chunk a = job - 4, its second half against its first,
//             f = 16a + 7 (rows 8-15 of a 16 x 8 tile).
template <int N, typename T>
__device__ __forceinline__ void scores_block(float* A, const T* R, const T* K,
                                             const double* C, int job) {
    constexpr int RT = Tiles<N, T>::RT, CS = N + 4;
    const bool half = job >= 4;
    const int a = half ? job - 4 : (job < 2 ? job + 1 : 3);
    const int r0 = a * SUB;
    const int c0 = half ? r0 : (job == 3 ? 24 : 0);
    const int f = half ? r0 + LEAF - 1 : r0 - 1;
    const int m0 = half ? LEAF : 0;  // the tile's rows before m0 are unused
    const double* cf = C + f * CS;
    auto fa = [&](int m, int i) {
        const int t = r0 + m;
        return m < m0 ? 0.f
                      : to_f(R[t * RT + i]) * e2(C[(t - 1) * CS + i], cf[i]);
    };
    auto fb = [&](int i, int n) {
        const int s = c0 + n;
        return to_f(K[s * RT + i]) * e2(cf[i], C[s * CS + i]);
    };
    auto put = [&](int m, int n, float x) {
        if (m >= m0) A[(r0 + m) * RA + c0 + n] = x;
    };
    if (half) {
        float acc[1][4];
        zero(acc);
        warp_mma<1>(acc, N, fa, fb);
        warp_each(acc, put);
    } else if (job == 0) {
        float acc[2][4];
        zero(acc);
        warp_mma<2>(acc, N, fa, fb);
        warp_each(acc, put);
    } else if (job == 1) {
        float acc[4][4];
        zero(acc);
        warp_mma<4>(acc, N, fa, fb);
        warp_each(acc, put);
    } else {
        float acc[3][4];
        zero(acc);
        warp_mma<3>(acc, N, fa, fb);
        warp_each(acc, put);
    }
}

template <int N, typename T>
__device__ void scores_mma(float* A, const T* R, const T* K, const double* C,
                           int warp) {
    for (int job = warp; job < SCORE_JOBS; job += WARPS)
        scores_block<N, T>(A, R, K, C, job);
}

// A's elementwise entries: in each leaf block of 8, A[t][s] = sum_i r_t k_s
// 2^(C[t-1] - C[s]) for s < t (224 pairs a chunk), then the bonus r_t . (u
// k_t) at s = t (64), in slices of 32 (a warp's: no warp mixes pairs and
// bonus).  A warp takes slice after slice from the counter *next* (zero at
// the start), so warps that arrive at different times share the work.  Each
// lane starts its channel loop at its own offset, so the warp's reads spread
// over the banks.
template <int N, typename T>
__device__ void scores_elementwise(float* A, const T* R, const T* K,
                                   const double* C, const float* us,
                                   int* next) {
    constexpr int RT = Tiles<N, T>::RT, CS = N + 4;
    constexpr int PAIRS = (L / LEAF) * LEAF_PAIRS;
    static_assert(PAIRS % 32 == 0, "no warp mixes pairs and bonus");
    const int lane = threadIdx.x & 31;
    for (;;) {
        int slice = 0;
        if (lane == 0) slice = atomicAdd(next, 1);
        slice = __shfl_sync(0xffffffffu, slice, 0);
        const int e = slice * 32 + lane;
        if (e >= PAIRS + L) break;
        float acc = 0.f;
        int t, s;
        if (e < PAIRS) {
            int p = e % LEAF_PAIRS, tl = 1;
            while (p >= tl) p -= tl++;
            t = (e / LEAF_PAIRS) * LEAF + tl;
            s = t - tl + p;
            const int rot = lane & (N - 1);
            const double* ct = C + (t - 1) * CS;
            const double* cs = C + s * CS;
            float part[4] = {0.f, 0.f, 0.f, 0.f};  // four chains in flight
#pragma unroll 4
            for (int q = 0; q < N; ++q) {
                const int i = (q + rot) & (N - 1);
                part[q & 3] += to_f(R[t * RT + i]) * to_f(K[s * RT + i])
                               * e2(ct[i], cs[i]);
            }
            acc = (part[0] + part[1]) + (part[2] + part[3]);
        } else {
            t = s = e - PAIRS;
            for (int i = 0; i < N; ++i)
                acc += to_f(R[t * RT + i]) * us[i] * to_f(K[t * RT + i]);
        }
        A[t * RA + s] = acc;
    }
}

// A's zeros above the diagonal inside each 16 x 16 diagonal block, by the
// threads numbered me < TH
template <int TH>
__device__ __forceinline__ void scores_zero(float* A, int me) {
    for (int e = me; e < NSUB * SUB * SUB; e += TH) {
        const int o = (e / (SUB * SUB)) * SUB, p = e % (SUB * SUB);
        if (p % SUB > p / SUB) A[(o + p / SUB) * RA + o + p % SUB] = 0.f;
    }
}

// --- pass 1: chunk state increments ------------------------------------------

template <int N, typename T>
constexpr int state_smem() {
    using Tl = Tiles<N, T>;
    return 3 * Tl::T_BYTES + 2 * Tl::F_BYTES + Tl::C_BYTES;
}

// For the backward: states[bh][c] = (k 2^(C[L-1] - C))^T v, dstates[bh][c]
// = (r 2^C[t-1])^T gy and dec[bh][c] = 2^C[L-1].
template <int N, typename T>
__global__ void __launch_bounds__(THREADS, 2)
wkv_chunk_state_kernel(const T* __restrict__ r, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ lw,
                       const float* __restrict__ gy, float* __restrict__ states,
                       float* __restrict__ dstates, float* __restrict__ dec,
                       int S, int H, int nc) {
    using Tl = Tiles<N, T>;
    constexpr int RT = Tl::RT, RF = Tl::RF, CS = Tl::CS;
    extern __shared__ __align__(16) unsigned char smem[];
    T* Ks = reinterpret_cast<T*>(smem);
    T* Vs = reinterpret_cast<T*>(smem + Tl::T_BYTES);
    float* LWs = reinterpret_cast<float*>(smem + 2 * Tl::T_BYTES);
    double* C = reinterpret_cast<double*>(smem + 2 * Tl::T_BYTES
                                          + Tl::F_BYTES);
    T* Rs = reinterpret_cast<T*>(smem + 2 * Tl::T_BYTES + Tl::F_BYTES
                                 + Tl::C_BYTES);
    float* GYs = reinterpret_cast<float*>(
        smem + 3 * Tl::T_BYTES + Tl::F_BYTES + Tl::C_BYTES);
    const int c = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
    const int t0 = c * L;
    stage<N, RF>(LWs, lw, b, h, t0, S, H);
    cp_async_commit();
    stage<N, RT>(Ks, k, b, h, t0, S, H);
    stage<N, RT>(Vs, v, b, h, t0, S, H);
    stage<N, RT>(Rs, r, b, h, t0, S, H);
    stage<N, RF>(GYs, gy, b, h, t0, S, H);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    prefix<N>(C, LWs);
    cp_async_wait<0>();
    __syncthreads();
    if (threadIdx.x < N)
        dec[(static_cast<int64_t>(bh) * nc + c) * N + threadIdx.x] =
            e2(C[(L - 1) * CS + threadIdx.x]);
    const int64_t off = (static_cast<int64_t>(bh) * (nc + 1) + c) * N * N;
    constexpr int TILES = Tl::RTILES * Tl::NCG, NTH = Tl::NTH;
    const int warp = threadIdx.x / 32;
    for (int job = warp; job < 2 * TILES; job += WARPS) {
        const int tile = job % TILES;
        const int i0 = (tile / Tl::NCG) * 16, j0 = (tile % Tl::NCG) * 8 * NTH;
        float acc[NTH][4];
        zero(acc);
        float* out;
        if (job < TILES) {
            warp_mma<NTH, sizeof(T) == 2>(
                acc, L,
                [&](int m, int s) {
                    const int i = i0 + m;
                    return i < N ? to_f(Ks[s * RT + i])
                                       * e2(C[(L - 1) * CS + i], C[s * CS + i])
                                 : 0.f;
                },
                [&](int s, int n) { return to_f(Vs[s * RT + j0 + n]); });
            out = states + off;
        } else {
            warp_mma<NTH>(
                acc, L,
                [&](int m, int t) {
                    const int i = i0 + m;
                    return i < N ? to_f(Rs[t * RT + i]) * e2(cm<N>(C, t, i))
                                 : 0.f;
                },
                [&](int t, int n) { return GYs[t * RF + j0 + n]; });
            out = dstates + (static_cast<int64_t>(bh) * nc + c) * N * N;
        }
        warp_each(acc, [&](int m, int n, float x) {
            if (i0 + m < N) out[(i0 + m) * N + j0 + n] = x;
        });
    }
}

// --- pass 2: the serial pass over chunks -------------------------------------

// Forward: states[bh][c] <- the state entering chunk c, states[bh][nc] <-
// the final state.  Reverse: dstates[bh][c] <- the gradient of the state
// after chunk c, from gs.
template <int N>
__global__ void __launch_bounds__(256)
wkv_state_scan_kernel(float* __restrict__ states, float* __restrict__ dstates,
                      const float* __restrict__ dec,
                      const float* __restrict__ gs, int BH, int nc) {
    constexpr int U = 8;  // chunks loaded ahead, all in flight at once
    const int64_t x = static_cast<int64_t>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
    if (x >= static_cast<int64_t>(BH) * N * N) return;
    const int bh = static_cast<int>(x / (N * N)), ij = static_cast<int>(
        x % (N * N)), i = ij / N;
    const float* d = dec + static_cast<int64_t>(bh) * nc * N + i;
    const int64_t step = static_cast<int64_t>(N) * N;
    {
        float* p = states + static_cast<int64_t>(bh) * (nc + 1) * step + ij;
        float s = 0.f;
        for (int c0 = 0; c0 < nc; c0 += U) {
            float inc[U], dd[U];
#pragma unroll
            for (int q = 0; q < U; ++q)
                if (c0 + q < nc) {
                    inc[q] = p[(c0 + q) * step];
                    dd[q] = d[(c0 + q) * N];
                }
#pragma unroll
            for (int q = 0; q < U; ++q)
                if (c0 + q < nc) {
                    p[(c0 + q) * step] = s;
                    s = fmaf(dd[q], s, inc[q]);
                }
        }
        p[nc * step] = s;
    }
    {
        float* p = dstates + static_cast<int64_t>(bh) * nc * step + ij;
        float g = gs[static_cast<int64_t>(bh) * step + ij];
        for (int c0 = nc - 1; c0 >= 0; c0 -= U) {
            float inc[U], dd[U];
#pragma unroll
            for (int q = 0; q < U; ++q)
                if (c0 - q >= 0) {
                    inc[q] = p[(c0 - q) * step];
                    dd[q] = d[(c0 - q) * N];
                }
#pragma unroll
            for (int q = 0; q < U; ++q)
                if (c0 - q >= 0) {
                    p[(c0 - q) * step] = g;
                    g = fmaf(dd[q], g, inc[q]);
                }
        }
    }
}

// --- the forward, one kernel ------------------------------------------------

// a barrier for warps 0-3 alone (the forward's state warps)
__device__ __forceinline__ void state_warps_sync() {
    asm volatile("bar.sync 1, %0;" ::"n"(NSUB * 32) : "memory");
}

// Phase timers of the forward, compiled in only with -DWKV_TRACE (see
// scripts/wkv_phase_trace.py): one row of TRACE_SLOTS %globaltimer
// readings (ns) a block, the row its ticket, written by one thread at each
// phase boundary.  The build the package loads has none of this.
constexpr int TRACE_SLOTS = 9;
#ifdef WKV_TRACE
__device__ long long* g_trace = nullptr;
__device__ __forceinline__ void trace_mark(bool who, int row, int slot) {
    if (who && g_trace != nullptr) {
        long long t;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
        g_trace[static_cast<int64_t>(row) * TRACE_SLOTS + slot] = t;
    }
}
#else
__device__ __forceinline__ void trace_mark(bool, int, int) {}
#endif

__device__ __forceinline__ int ld_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
                 : "memory");
    return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
    asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
                 : "memory");
}

template <int N, typename T>
constexpr int fwd_smem() {
    using Tl = Tiles<N, T>;
    return 3 * Tl::T_BYTES + Tl::C_BYTES + Tl::A_BYTES + Tl::S_BYTES + N * 4;
}

// One block a chunk, chunks taken in ticket order (sync[0], chunk-major),
// so a block only ever waits for a block that started before it.  The
// block computes its chunk's state increment (k 2^(C[L-1] - C))^T v, waits
// for the state entering the chunk (sync[1 + bh nc + c] set by the chunk
// before), publishes S_out = diag(2^C[L-1]) S_in + increment (the final
// state to s_fin), then computes y = A v + (r 2^C[t-1]) S_in.  The states
// pass between chunks through two slots a (b, h) of ring, in L2.
template <int N, typename T>
__global__ void __launch_bounds__(THREADS, 2)
wkv_forward_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ lw,
                   const float* __restrict__ u, float* __restrict__ ring,
                   int* __restrict__ sync, float* __restrict__ y,
                   float* __restrict__ s_fin, int S, int H, int nc) {
    using Tl = Tiles<N, T>;
    constexpr int RT = Tl::RT, RF = Tl::RF, CS = Tl::CS;
    constexpr int NT = N / 8;  // full-width tiles: every factor made once
    constexpr bool VX = sizeof(T) == 2;  // bfloat16 v is exact in TF32
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int ticket, next;  // the chunk; A's next elementwise slice
    T* Rs = reinterpret_cast<T*>(smem);
    T* Ks = reinterpret_cast<T*>(smem + Tl::T_BYTES);
    T* Vs = reinterpret_cast<T*>(smem + 2 * Tl::T_BYTES);
    double* C = reinterpret_cast<double*>(smem + 3 * Tl::T_BYTES);
    float* A = reinterpret_cast<float*>(smem + 3 * Tl::T_BYTES
                                        + Tl::C_BYTES);
    float* Sin = reinterpret_cast<float*>(smem + 3 * Tl::T_BYTES
                                          + Tl::C_BYTES + Tl::A_BYTES);
    float* us = Sin + N * RF;
    float* LWs = A;  // the log-decays land in A's place
    const int tid = threadIdx.x, warp = tid / 32;
    if (tid == 0) {
        ticket = atomicAdd(sync, 1);
        next = 0;
    }
    __syncthreads();
    const int BH = gridDim.x / nc;
    const int c = ticket / BH, bh = ticket % BH, b = bh / H, h = bh % H;
    const int t0 = c * L;
    // phase boundaries: 0 start, 1 log-decays staged, 2 prefix sums done
    // and r, k, v staged, 3 increment done, 4 the predecessor's state
    // ready, 5 own state published, 6 A whole, 7 y written (thread 0);
    // 8 warp 4's tensor-core score blocks done
    trace_mark(tid == 0, ticket, 0);
    stage<N, RF>(LWs, lw, b, h, t0, S, H);
    cp_async_commit();
    stage<N, RT>(Rs, r, b, h, t0, S, H);
    stage<N, RT>(Ks, k, b, h, t0, S, H);
    stage<N, RT>(Vs, v, b, h, t0, S, H);
    cp_async_commit();
    if (tid < N) us[tid] = u[h * N + tid];
    cp_async_wait<1>();
    __syncthreads();
    trace_mark(tid == 0, ticket, 1);
    prefix<N>(C, LWs);
    cp_async_wait<0>();
    __syncthreads();
    trace_mark(tid == 0, ticket, 2);
    float yacc[NT][4];  // warps 0-3: y's rows 16 warp..
    zero(yacc);
    if (warp < NSUB) {
        // warps 0-3: the state increment (rows 16 warp..), then the handoff
        const int i0 = warp * 16;
        const bool sw = i0 < N;
        float inc[NT][4];
        zero(inc);
        if (sw)
            warp_mma<NT, VX>(
                inc, L,
                [&](int m, int s) {
                    const int i = i0 + m;
                    return i < N ? to_f(Ks[s * RT + i])
                                       * e2(C[(L - 1) * CS + i], C[s * CS + i])
                                 : 0.f;
                },
                [&](int s, int n) { return to_f(Vs[s * RT + n]); });
        trace_mark(tid == 0, ticket, 3);
        const float* s_in =
            ring + (static_cast<int64_t>(bh) * 2 + (c & 1)) * N * N;
        float* s_out =
            ring + (static_cast<int64_t>(bh) * 2 + ((c + 1) & 1)) * N * N;
        int* ready = sync + 1 + static_cast<int64_t>(bh) * nc;
        scores_zero<THREADS / 2>(A, tid);
        if (c > 0 && tid == 0) {
            while (ld_acquire(ready + c) == 0) __nanosleep(32);
            __threadfence();
        }
        trace_mark(tid == 0, ticket, 4);
        state_warps_sync();
        if (sw) {
            // every load of S_in in flight before the first store
            float sin[NT][4];
            warp_each(inc, [&](int m, int j, float) {
                const int i = i0 + m;
                sin[j / 8][(m / 8) * 2 + (j & 1)] =
                    c > 0 && i < N ? __ldcg(s_in + i * N + j) : 0.f;
            });
            warp_each(inc, [&](int m, int j, float x) {
                const int i = i0 + m;
                if (i < N) {
                    const float si = sin[j / 8][(m / 8) * 2 + (j & 1)];
                    Sin[i * RF + j] = si;
                    const float so = fmaf(e2(C[(L - 1) * CS + i]), si, x);
                    if (c + 1 < nc)
                        s_out[i * N + j] = so;
                    else
                        s_fin[static_cast<int64_t>(bh) * N * N + i * N + j] =
                            so;
                }
            });
        }
        __threadfence();
        state_warps_sync();
        if (tid == 0 && c + 1 < nc) st_release(ready + c + 1, 1);
        trace_mark(tid == 0, ticket, 5);
        // y's inter-chunk term (r 2^C[t-1]) S_in, while warps 4-7 score
        const int r0 = warp * SUB;
        if (c > 0)
            warp_mma<NT>(
                yacc, N,
                [&](int m, int i) {
                    const int t = r0 + m;
                    return to_f(Rs[t * RT + i]) * e2(cm<N>(C, t, i));
                },
                [&](int i, int n) { return Sin[i * RF + n]; });
    } else {
        // warps 4-7 meanwhile: A's tensor-core blocks, two jobs each
        for (int job = warp - NSUB; job < SCORE_JOBS; job += NSUB)
            scores_block<N, T>(A, Rs, Ks, C, job);
        trace_mark(tid == NSUB * 32, ticket, 8);
    }
    // A's elementwise entries, shared by whichever warps are free
    scores_elementwise<N, T>(A, Rs, Ks, C, us, &next);
    __syncthreads();
    trace_mark(tid == 0, ticket, 6);
    // y = A v + that term, warps 0-3
    if (warp >= NSUB) return;
    const int r0 = warp * SUB;
    warp_mma<NT, VX>(
        yacc, r0 + SUB, [&](int m, int s) { return A[(r0 + m) * RA + s]; },
        [&](int s, int n) { return to_f(Vs[s * RT + n]); });
    warp_each(yacc, [&](int m, int n, float x) {
        const int t = t0 + r0 + m;
        if (t < S)
            y[((static_cast<int64_t>(b) * S + t) * H + h) * N + n] = x;
    });
    trace_mark(tid == 0, ticket, 7);
}

// --- pass 3, backward: the chunk's gradients ---------------------------------

template <int N, typename T>
constexpr int grad_smem() {
    using Tl = Tiles<N, T>;
    return 3 * Tl::T_BYTES + Tl::F_BYTES + Tl::C_BYTES + 2 * Tl::A_BYTES
           + 3 * Tl::S_BYTES + N * 4 + L * 4 + N * 8 + 2 * NSUB * N * 8;
}

template <int N, typename T>
__global__ void __launch_bounds__(THREADS, 1)
wkv_chunk_grad_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ lw,
                      const float* __restrict__ u,
                      const float* __restrict__ gy,
                      const float* __restrict__ states,
                      const float* __restrict__ dstates, T* __restrict__ gr,
                      T* __restrict__ gk, T* __restrict__ gv,
                      float* __restrict__ glw, double* __restrict__ gu_part,
                      int S, int H, int nc) {
    using Tl = Tiles<N, T>;
    constexpr int RT = Tl::RT, RF = Tl::RF, CS = Tl::CS, NTH = Tl::NTH;
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned char* p = smem;
    T* Rs = reinterpret_cast<T*>(p);
    T* Ks = reinterpret_cast<T*>(p += Tl::T_BYTES);
    T* Vs = reinterpret_cast<T*>(p += Tl::T_BYTES);
    float* GYs = reinterpret_cast<float*>(p += Tl::T_BYTES);
    double* C = reinterpret_cast<double*>(p += Tl::F_BYTES);
    float* A = reinterpret_cast<float*>(p += Tl::C_BYTES);
    float* dA = reinterpret_cast<float*>(p += Tl::A_BYTES);
    float* Sin = reinterpret_cast<float*>(p += Tl::A_BYTES);
    float* Sout = reinterpret_cast<float*>(p += Tl::S_BYTES);
    float* dSo = reinterpret_cast<float*>(p += Tl::S_BYTES);
    float* us = reinterpret_cast<float*>(p += Tl::S_BYTES);
    float* bon = reinterpret_cast<float*>(p += N * 4);
    double* kc = reinterpret_cast<double*>(p += L * 4);
    double* tot = reinterpret_cast<double*>(p += N * 8);
    double* gu4 = tot + NSUB * N;
    __shared__ int slice_next[1];  // A's next elementwise slice
    float* LWs = A;   // the log-decays land in A's place
    float* GR = GYs;  // gr' and gk' of the products, once gy and A are done
    float* GK = A;
    const int c = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
    const int t0 = c * L, tid = threadIdx.x, warp = tid / 32;
    const int64_t soff = (static_cast<int64_t>(bh) * (nc + 1) + c) * N * N;
    if (tid == 0) slice_next[0] = 0;
    stage<N, RF>(LWs, lw, b, h, t0, S, H);
    cp_async_commit();
    stage<N, RT>(Rs, r, b, h, t0, S, H);
    stage<N, RT>(Ks, k, b, h, t0, S, H);
    stage<N, RT>(Vs, v, b, h, t0, S, H);
    stage<N, RF>(GYs, gy, b, h, t0, S, H);
    stage_state<N>(Sin, states + soff);
    stage_state<N>(Sout, states + soff + N * N);
    stage_state<N>(dSo, dstates + (static_cast<int64_t>(bh) * nc + c) * N * N);
    cp_async_commit();
    if (tid < N) us[tid] = u[h * N + tid];
    cp_async_wait<1>();
    __syncthreads();
    prefix<N>(C, LWs);
    cp_async_wait<0>();
    __syncthreads();
    // kc = rowsum(dS_out * S_out); bon[t] = gy_t . v_t in float32, in order
    if (tid < N) {
        double acc = 0.0;
        for (int j = 0; j < N; ++j)
            acc += static_cast<double>(dSo[tid * RF + j] * Sout[tid * RF + j]);
        kc[tid] = acc;
    } else if (tid >= THREADS - L) {
        const int t = tid - (THREADS - L);
        float acc = 0.f;
        for (int j = 0; j < N; ++j) acc += GYs[t * RF + j] * to_f(Vs[t * RT + j]);
        bon[t] = acc;
    }
    // dA = gy v^T on and below the diagonal sub-blocks; A
    {
        const int a = warp % NSUB, hf = warp / NSUB, r0 = a * SUB;
        if (hf * 32 < r0 + SUB) {
            float acc[4][4];
            zero(acc);
            warp_mma<4, sizeof(T) == 2>(
                acc, N, [&](int m, int j) { return GYs[(r0 + m) * RF + j]; },
                [&](int j, int n) { return to_f(Vs[(hf * 32 + n) * RT + j]); });
            warp_each(acc, [&](int m, int n, float x) {
                dA[(r0 + m) * RA + hf * 32 + n] = x;
            });
        }
    }
    scores_mma<N, T>(A, Rs, Ks, C, warp);
    scores_zero<THREADS>(A, tid);
    scores_elementwise<N, T>(A, Rs, Ks, C, us, slice_next);
    __syncthreads();
    // gv to device memory; gr' and gk' of the products kept for the next step
    const int a = warp % NSUB, cg = warp / NSUB, r0 = a * SUB;
    const int j0 = cg * 8 * NTH;
    const bool busy = cg < Tl::NCG;
    float grv[NTH][4], gkv[NTH][4];
    if (busy) {
        float acc[NTH][4], acc2[NTH][4];
        zero(acc);
        warp_mma<NTH>(
            acc, L - r0, [&](int m, int kk) { return A[(r0 + kk) * RA + r0 + m]; },
            [&](int kk, int n) { return GYs[(r0 + kk) * RF + j0 + n]; });
        warp_mma<NTH>(
            acc, N,
            [&](int m, int i) {
                const int s = r0 + m;
                return to_f(Ks[s * RT + i]) * e2(C[(L - 1) * CS + i], C[s * CS + i]);
            },
            [&](int i, int n) { return dSo[i * RF + j0 + n]; });
        warp_each(acc, [&](int m, int n, float x) {
            const int t = t0 + r0 + m;
            if (t < S)
                gv[((static_cast<int64_t>(b) * S + t) * H + h) * N + j0 + n] =
                    from_f<T>(x);
        });
        // gr: earlier sub-chunks anchored at f = r0 - 1, and S_in
        zero(acc);
        zero(acc2);
        if (a > 0)
            warp_mma<NTH>(
                acc, r0, [&](int m, int s) { return dA[(r0 + m) * RA + s]; },
                [&](int s, int n) {
                    const int i = j0 + n;
                    return to_f(Ks[s * RT + i])
                           * e2(C[(r0 - 1) * CS + i], C[s * CS + i]);
                });
        warp_mma<NTH>(
            acc2, N, [&](int m, int j) { return GYs[(r0 + m) * RF + j]; },
            [&](int j, int n) { return Sin[(j0 + n) * RF + j]; });
#pragma unroll
        for (int jt = 0; jt < NTH; ++jt)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int lane = tid & 31;
                const int t = r0 + (lane >> 2) + (q >> 1) * 8;
                const int i = j0 + 8 * jt + 2 * (lane & 3) + (q & 1);
                const double cmt = cm<N>(C, t, i);
                grv[jt][q] = e2(cmt, cm<N>(C, r0, i)) * acc[jt][q]
                             + e2(cmt) * acc2[jt][q];
            }
        // gk: later sub-chunks anchored at e = r0 + 15, and dS_out
        zero(acc);
        zero(acc2);
        if (a < NSUB - 1)
            warp_mma<NTH>(
                acc, L - r0 - SUB,
                [&](int m, int kk) { return dA[(r0 + SUB + kk) * RA + r0 + m]; },
                [&](int kk, int n) {
                    const int t = r0 + SUB + kk, i = j0 + n;
                    return to_f(Rs[t * RT + i])
                           * e2(C[(t - 1) * CS + i], C[(r0 + SUB - 1) * CS + i]);
                });
        warp_mma<NTH>(
            acc2, N, [&](int m, int j) { return to_f(Vs[(r0 + m) * RT + j]); },
            [&](int j, int n) { return dSo[(j0 + n) * RF + j]; });
#pragma unroll
        for (int jt = 0; jt < NTH; ++jt)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int lane = tid & 31;
                const int s = r0 + (lane >> 2) + (q >> 1) * 8;
                const int i = j0 + 8 * jt + 2 * (lane & 3) + (q & 1);
                const double cs = C[s * CS + i];
                gkv[jt][q] = e2(C[(r0 + SUB - 1) * CS + i], cs) * acc[jt][q]
                             + e2(C[(L - 1) * CS + i], cs) * acc2[jt][q];
            }
    }
    __syncthreads();
    if (busy) {
        warp_each(grv, [&](int m, int n, float x) {
            GR[(r0 + m) * RF + j0 + n] = x;
        });
        warp_each(gkv, [&](int m, int n, float x) {
            GK[(r0 + m) * RF + j0 + n] = x;
        });
    }
    __syncthreads();
    // per (sub-chunk, channel): the diagonal sub-block's terms, the bonus,
    // gr and gk, then glw by the reverse cumulative sums
    const bool mine = tid < NSUB * N;
    const int sa = tid / N, i = tid % N, base = sa * SUB;
    float P[SUB], Q[SUB];
    // bit x: the step's decay 2^(C[t] - C[t-1]) is 0 in float32 (exp2f
    // rounds to 0 at or below -150), where exp(lw_t) is
    unsigned under = 0;
    if (mine) {
        float rv[SUB], kv[SUB];
        double cmv[SUB], cv[SUB];
#pragma unroll
        for (int x = 0; x < SUB; ++x) {
            const int t = base + x;
            rv[x] = to_f(Rs[t * RT + i]);
            kv[x] = to_f(Ks[t * RT + i]);
            P[x] = GR[t * RF + i];
            Q[x] = GK[t * RF + i];
            cmv[x] = cm<N>(C, t, i);
            cv[x] = C[t * CS + i];
            under |= (cv[x] - cmv[x] <= -150.0 ? 1u : 0u) << x;
        }
#pragma unroll
        for (int tl = 1; tl < SUB; ++tl)
#pragma unroll
            for (int sl = 0; sl < tl; ++sl) {
                const float e = e2(cmv[tl], cv[sl]);
                const float d = dA[(base + tl) * RA + base + sl] * e;
                P[tl] += d * kv[sl];
                Q[sl] += d * rv[tl];
            }
        double tsum = 0.0, gus = 0.0;
        const float ui = us[i];
#pragma unroll
        for (int x = 0; x < SUB; ++x) {
            const int t = t0 + base + x;
            const float bx = bon[base + x];
            if (t < S) {
                const int64_t o = ((static_cast<int64_t>(b) * S + t) * H + h)
                                  * N + i;
                gr[o] = from_f<T>(P[x] + ui * kv[x] * bx);
                gk[o] = from_f<T>(Q[x] + ui * rv[x] * bx);
            }
            gus += static_cast<double>(rv[x] * kv[x] * bx);
            P[x] *= rv[x];
            Q[x] *= kv[x];
            tsum += static_cast<double>(P[x]) - static_cast<double>(Q[x]);
        }
        tot[sa * N + i] = tsum;
        gu4[sa * N + i] = gus;
    }
    __syncthreads();
    if (mine) {
        double acc = kc[i];
        for (int a2 = sa + 1; a2 < NSUB; ++a2) acc += tot[a2 * N + i];
#pragma unroll
        for (int x = SUB - 1; x >= 0; --x) {
            acc -= static_cast<double>(Q[x]);
            const int t = t0 + base + x;
            if (t < S) {
                const int64_t o = ((static_cast<int64_t>(b) * S + t) * H + h)
                                  * N + i;
                // exactly 0 where w_t is 0 in float32, as glw = gw w is:
                // the sums would leave their rounding there
                glw[o] = t == 0 || ((under >> x) & 1u)
                             ? 0.f
                             : static_cast<float>(acc);
            }
            acc += static_cast<double>(P[x]);
        }
    }
    if (tid < N) {
        double g = 0.0;
        for (int a2 = 0; a2 < NSUB; ++a2) g += gu4[a2 * N + tid];
        gu_part[((static_cast<int64_t>(b) * H + h) * nc + c) * N + tid] = g;
    }
}

// gu[h, i] = sum over b, then chunks, of gu_part[b, h, c, i], in order.
__global__ void wkv_bonus_sum_kernel(const double* __restrict__ gu_part,
                                     float* __restrict__ gu, int B, int H,
                                     int nc, int N) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    if (x >= H * N) return;
    const int h = x / N, i = x % N;
    double acc = 0.0;
    for (int b = 0; b < B; ++b)
        for (int c = 0; c < nc; ++c)
            acc += gu_part[((static_cast<int64_t>(b) * H + h) * nc + c) * N + i];
    gu[x] = static_cast<float>(acc);
}

// --- host side ----------------------------------------------------------------

template <typename K>
int launch_check(K kernel, int smem_bytes) {
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes));
}

#define WKV_TRY(x)                                   \
    do {                                             \
        const int err_ = static_cast<int>(x);        \
        if (err_ != 0) return err_;                  \
    } while (0)

template <int N, typename T>
int forward_n(const void* r, const void* k, const void* v, const void* lw,
              const void* u, void* y, void* s, void* ring, void* sync, int B,
              int S, int H, cudaStream_t st) {
    const int nc = (S + L - 1) / L;
    WKV_TRY(cudaMemsetAsync(sync, 0,
                            (1 + static_cast<size_t>(B) * H * nc) * sizeof(int),
                            st));
    auto kern = wkv_forward_kernel<N, T>;
    constexpr int sm = fwd_smem<N, T>();
    WKV_TRY(launch_check(kern, sm));
    kern<<<nc * B * H, THREADS, sm, st>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(lw),
        static_cast<const float*>(u), static_cast<float*>(ring),
        static_cast<int*>(sync), static_cast<float*>(y),
        static_cast<float*>(s), S, H, nc);
    return static_cast<int>(cudaGetLastError());
}

template <int N, typename T>
int backward_n(const void* r, const void* k, const void* v, const void* lw,
               const void* u, const void* gy, const void* gs, void* states,
               void* dstates, void* dec, void* gu_part, void* gr, void* gk,
               void* gv, void* glw, void* gu, int B, int S, int H,
               cudaStream_t st) {
    const int nc = (S + L - 1) / L;
    {
        auto kern = wkv_chunk_state_kernel<N, T>;
        constexpr int sm = state_smem<N, T>();
        WKV_TRY(launch_check(kern, sm));
        kern<<<dim3(nc, B * H), THREADS, sm, st>>>(
            static_cast<const T*>(r), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<const float*>(lw),
            static_cast<const float*>(gy), static_cast<float*>(states),
            static_cast<float*>(dstates), static_cast<float*>(dec), S, H, nc);
        WKV_TRY(cudaGetLastError());
        const int64_t n = static_cast<int64_t>(B) * H * N * N;
        wkv_state_scan_kernel<N>
            <<<static_cast<int>((n + 255) / 256), 256, 0, st>>>(
                static_cast<float*>(states), static_cast<float*>(dstates),
                static_cast<const float*>(dec), static_cast<const float*>(gs),
                B * H, nc);
        WKV_TRY(cudaGetLastError());
    }
    auto kern = wkv_chunk_grad_kernel<N, T>;
    constexpr int sm = grad_smem<N, T>();
    WKV_TRY(launch_check(kern, sm));
    kern<<<dim3(nc, B * H), THREADS, sm, st>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(lw),
        static_cast<const float*>(u), static_cast<const float*>(gy),
        static_cast<const float*>(states), static_cast<const float*>(dstates),
        static_cast<T*>(gr), static_cast<T*>(gk), static_cast<T*>(gv),
        static_cast<float*>(glw), static_cast<double*>(gu_part), S, H, nc);
    WKV_TRY(cudaGetLastError());
    const int HN = H * N;
    wkv_bonus_sum_kernel<<<(HN + 255) / 256, 256, 0, st>>>(
        static_cast<const double*>(gu_part), static_cast<float*>(gu), B, H,
        nc, N);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int forward_t(const void* r, const void* k, const void* v, const void* lw,
              const void* u, void* y, void* s, void* ring, void* sync, int B,
              int S, int H, int N, cudaStream_t st) {
#define WKV_FWD(n) forward_n<n, T>(r, k, v, lw, u, y, s, ring, sync, B, S, H, st)
    switch (N) {
        case 8: return WKV_FWD(8);
        case 16: return WKV_FWD(16);
        case 32: return WKV_FWD(32);
        case 64: return WKV_FWD(64);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef WKV_FWD
}

template <typename T>
int backward_t(const void* r, const void* k, const void* v, const void* lw,
               const void* u, const void* gy, const void* gs, void* states,
               void* dstates, void* dec, void* gu_part, void* gr, void* gk,
               void* gv, void* glw, void* gu, int B, int S, int H, int N,
               cudaStream_t st) {
#define WKV_BWD(n) backward_n<n, T>(r, k, v, lw, u, gy, gs, states, dstates, \
    dec, gu_part, gr, gk, gv, glw, gu, B, S, H, st)
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

// dtype: 0 float32, 1 bfloat16 (r, k, v and gr, gk, gv).  Scratch, allocated
// by the caller: ring (B*H, 2, N, N) float32 and sync (1 + B*H*nc) int32, nc
// = ceil(S / wkv_chunk()); sync is zeroed here.
extern "C" int wkv_forward_launch(const void* r, const void* k, const void* v,
                                  const void* lw, const void* u, void* y,
                                  void* s, void* ring, void* sync, int B,
                                  int S, int H, int N, int dtype,
                                  void* stream) {
    auto st = static_cast<cudaStream_t>(stream);
    if (B * H == 0) return 0;
    if (S == 0)
        return static_cast<int>(cudaMemsetAsync(
            s, 0, static_cast<size_t>(B) * H * N * N * sizeof(float), st));
    return dtype == 1
        ? forward_t<__nv_bfloat16>(r, k, v, lw, u, y, s, ring, sync, B, S, H,
                                   N, st)
        : forward_t<float>(r, k, v, lw, u, y, s, ring, sync, B, S, H, N, st);
}

// The backward's scratch, allocated by the caller: states (B*H, nc + 1, N,
// N) and dstates (B*H, nc, N, N) float32, dec (B*H, nc, N) float32 and gu_part (B, H, nc, N)
// float64.
extern "C" int wkv_backward_launch(const void* r, const void* k,
                                   const void* v, const void* lw,
                                   const void* u, const void* gy,
                                   const void* gs, void* states,
                                   void* dstates, void* dec, void* gu_part,
                                   void* gr, void* gk, void* gv, void* glw,
                                   void* gu, int B, int S, int H, int N,
                                   int dtype, void* stream) {
    auto st = static_cast<cudaStream_t>(stream);
    if (H * N == 0) return 0;
    if (B == 0 || S == 0)
        return static_cast<int>(cudaMemsetAsync(
            gu, 0, static_cast<size_t>(H) * N * sizeof(float), st));
    return dtype == 1
        ? backward_t<__nv_bfloat16>(r, k, v, lw, u, gy, gs, states, dstates,
                                    dec, gu_part, gr, gk, gv, glw, gu, B, S,
                                    H, N, st)
        : backward_t<float>(r, k, v, lw, u, gy, gs, states, dstates, dec,
                            gu_part, gr, gk, gv, glw, gu, B, S, H, N, st);
}

extern "C" int wkv_chunk() { return L; }

#ifdef WKV_TRACE
// The forward's phase timers (a -DWKV_TRACE build only): rows of
// wkv_trace_slots() int64 a block, nc * B * H rows, or null to stop.
extern "C" int wkv_set_trace(void* rows) {
    long long* p = static_cast<long long*>(rows);
    return static_cast<int>(cudaMemcpyToSymbol(g_trace, &p, sizeof(p)));
}
extern "C" int wkv_trace_slots() { return TRACE_SLOTS; }
#endif

