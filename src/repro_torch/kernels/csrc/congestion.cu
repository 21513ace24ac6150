// Interval-congestion kernel for Hopper (sm_90a): one kernel, two entries.
//
// Replaces: src/repro/kernels/congestion.py : congestion_many_pallas (its
// pallas_call at :110) and its G=1 wrapper congestion_pallas (:37), the
// forward map of the LP solver's congestion operator.  On the reference's
// operator="pallas" route (src/repro/core/batch.py) XLA fused a permute, the
// product x * w and an m-fold repeat of the spans around that call; eager
// PyTorch fuses nothing, so the second entry does all of it in the launch.
//
//   out[b, t, c] = sum_u [start[b,u] <= t <= end[b,u]] * x[b,u,c/D] * w[b,u,c]
//
// start, end: (B, n) int32; w: (B, n, C) float32 with C = m * D columns (the
// LP's (B, n, m, D) weights); x: (B, n, m) float32, or null for x = 1;
// out: (B, T, C) float32, i.e. the LP's (B, T', m, D).  All contiguous.
// congestion_many_launch is the TPU contract: m = 1, D = K, no x.  The
// product x * w rounds once, as in the plain version; sums are float32.
//
// What bounds it on this card: on the LP's path C = m*D = 50 and T' = 24, so
// one apply reads the spans, x and w once (about 4 MB at B=16, n=1000) and
// writes 77 KB; its 2*B*T'*n*C masked adds are far below the f32 rate.  The
// least time is set by those bytes; at these sizes a launch is bound by its
// latency chain (stage, add, reduce) and by the instructions of one CTA's
// share of the tasks.
//
// What the design does about it:
// * The task axis is split over W task groups inside a CTA and then over a
//   thread-block cluster of S <= 8 CTAs (the portable size); the host picks
//   W and S so that about 16 warps per SM are in flight.  Each CTA stages
//   its slice's spans, x and w once into shared memory with asynchronous
//   copies (cp.async) of the contiguous slabs, issued before any is waited
//   for, and turns each span into a 32-bit mask of the task's active slots
//   in the CTA's time tile (the mask is never stored in device memory, as on
//   the TPU).
// * A thread owns one column c and R slots {ph, ph + P, ...} of the tile
//   (R = 8, 4, 2 or 1; the host picks the largest that keeps the warps'
//   lanes busy), so one product x*w, read from shared memory, feeds R
//   predicated adds held in registers; a batch of tasks' reads is issued
//   before its adds.  Nothing is padded: K and T' < 32 idle no lane beyond
//   the last warp's rounding.
// * Long timelines are tiled over T' (32 slots per tile, fewer when C is
//   wide).  Where C is wider than one CTA's kPartFloats partial sums can
//   hold at 8 slots, the columns are tiled too: the grid gains a column-tile
//   axis beside the time tiles and instances, and a CTA (or cluster) owns
//   the columns [c0, c1) of its tile, staging only that slab of w and the
//   x columns j in [c0 / D, (c1 - 1) / D] it touches.  The fewest tiles that
//   keep at least min(T', 8) slots per time tile are taken, as even as they
//   can be; where C <= kPartFloats there is one column tile and the plan is
//   the one-tile plan.  Each output element is still written once, by the
//   CTA that finishes it: no atomics, so a launch is deterministic.
// * Partial sums are added in a fixed order, so the result is deterministic:
//   task groups in group order, then the cluster's ranks in rank order.
//   Each CTA stores its partials into the shared memory of the rank that
//   finishes them (distributed shared memory) and the cluster meets at one
//   barrier; no float atomics, no second launch, and no CTA's shared memory
//   is read after that barrier, so none has to wait for its peers to exit.
// * Padding is exact: a task with start > end (the TPU contract's [1, 0])
//   has an empty mask; the LP's padded tasks carry zero weight.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kTileT = 32;          // slots per tile: one mask word per task
constexpr int kPartFloats = 8192;   // partial sums per CTA (32 KB)
constexpr int kStageFloats = 8192;  // staged w (and x) per chunk (32 KB)
constexpr int kMinTasks = 8;        // fewest tasks per cluster rank and group
constexpr int kWarpsPerSM = 16;     // warps in flight per SM the split aims at
constexpr int kBatch = 8;           // tasks whose reads are issued together
constexpr int kMinTileT = 8;        // fewest slots per time tile when C is tiled

// 4-byte asynchronous copy global -> shared (cp.async): a thread issues all
// of its copies of a chunk before it waits for any
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}

__device__ __forceinline__ void copy_async_wait() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                     : "memory");
}

// the two halves of a cluster barrier; arrive without ordering (relaxed),
// or releasing this thread's writes to the peers that wait (acquire)
__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int R, bool kX>
__global__ void __launch_bounds__(kMaxThreads)
congestion_many_kernel(const int32_t* __restrict__ start,
                       const int32_t* __restrict__ end,
                       const float* __restrict__ x,
                       const float* __restrict__ w,
                       float* __restrict__ out,
                       int n, int m, int D, int T, int t_tile, int t_tiles,
                       int c_tile, int c_tiles, int P, int W, int unit_pad,
                       int slice, int chunk) {
    // peers store into this CTA's shared memory only after every CTA of
    // the cluster has started: arrive now, wait before the first store
    cluster_arrive_relaxed();
    extern __shared__ float smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int S = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int C = m * D;
    const int row = blockIdx.x / S;
    const int bt = row / c_tiles;  // (instance, time tile)
    const int b = bt / t_tiles;
    const int t0 = (bt % t_tiles) * t_tile;
    const int t_eff = min(t_tile, T - t0);
    // this CTA's column tile [col0, col0 + cw) and the x columns it reads,
    // j in [j_lo, j_lo + xn); one tile: every column and every x column
    const int col0 = (row % c_tiles) * c_tile;
    const int cw = min(c_tile, C - col0);
    const int j_lo = col0 / D;
    const int xn = (col0 + cw - 1) / D - j_lo + 1;
    const int tc = t_tile * c_tile;  // partial sums of one task group
    const int n_out = t_eff * cw;
    const int share = (n_out + S - 1) / S;  // outputs each rank finishes

    float* part = smem;                                          // W * tc
    float* recv = part + W * tc;                                 // S * share
    auto* s_mask = reinterpret_cast<uint32_t*>(recv + S * share);  // chunk
    auto* s_end = reinterpret_cast<int32_t*>(s_mask + chunk);    // chunk
    float* s_w = reinterpret_cast<float*>(s_end + chunk);   // chunk * c_tile
    float* s_x = s_w + chunk * c_tile;  // chunk * the plan's x_tile

    const int tid = threadIdx.x;
    const int grp = tid / unit_pad;
    const int unit0 = tid % unit_pad;
    const int units = cw * P;

    const int64_t base = static_cast<int64_t>(b) * n;
    const int u_lo = min(n, rank * slice);
    const int u_hi = min(n, u_lo + slice);
    if (u_lo >= u_hi) {  // no task in this slice: every partial is 0
        for (int i = tid; i < W * tc; i += blockDim.x) part[i] = 0.0f;
    }
    for (int c0 = u_lo; c0 < u_hi; c0 += chunk) {
        const int cn = min(chunk, u_hi - c0);
        __syncthreads();  // the last chunk's readers are done
        // the chunk's spans, w slab and x slab, read once: contiguous with
        // one column tile, else a row segment of each task
        for (int i = tid; i < cn; i += blockDim.x) {
            copy_async(s_mask + i, start + base + c0 + i);
            copy_async(s_end + i, end + base + c0 + i);
        }
        const float* wc = w + (base + c0) * C + col0;
        if (cw == C) {
            for (int i = tid; i < cn * C; i += blockDim.x)
                copy_async(s_w + i, wc + i);
        } else {
            for (int i = tid; i < cn * cw; i += blockDim.x) {
                const int u = i / cw;
                copy_async(s_w + i, wc + static_cast<int64_t>(u) * C
                                        + (i - u * cw));
            }
        }
        if (kX) {
            const float* xc = x + (base + c0) * m + j_lo;
            if (xn == m) {
                for (int i = tid; i < cn * m; i += blockDim.x)
                    copy_async(s_x + i, xc + i);
            } else {
                for (int i = tid; i < cn * xn; i += blockDim.x) {
                    const int u = i / xn;
                    copy_async(s_x + i, xc + static_cast<int64_t>(u) * m
                                            + (i - u * xn));
                }
            }
        }
        copy_async_wait();
        // each task's active slots in this tile, in place of its start
        for (int i = tid; i < cn; i += blockDim.x) {
            const int lo = max(static_cast<int>(s_mask[i]) - t0, 0);
            const int hi = min(s_end[i] - t0, t_eff - 1);
            uint32_t mk = 0u;
            if (lo <= hi) {
                const uint32_t upto =
                    hi == 31 ? 0xffffffffu : (1u << (hi + 1)) - 1u;
                mk = upto & ~((1u << lo) - 1u);
            }
            s_mask[i] = mk;
        }
        __syncthreads();

        // this task group's share of the chunk
        const int g_lo = cn * grp / W;
        const int g_hi = cn * (grp + 1) / W;
        float* pg = part + grp * tc;
        for (int q = unit0; q < units; q += unit_pad) {
            const int c = q % cw;   // the column within the tile
            const int ph = q / cw;
            const int j = (col0 + c) / D - j_lo;
            uint32_t bit[R];
            float acc[R];
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int tl = ph + r * P;
                bit[r] = tl < t_eff ? 1u << tl : 0u;
                acc[r] = 0.0f;
            }
            // tasks in batches of kBatch: every shared-memory read of a
            // batch is issued before its first add (no branch per task)
            const float* wp = s_w + g_lo * cw + c;
            const float* xp = s_x + g_lo * xn + j;
            int u = g_lo;
            for (; u + kBatch <= g_hi; u += kBatch) {
                uint32_t mk[kBatch];
                float v[kBatch];
#pragma unroll
                for (int k = 0; k < kBatch; ++k) {
                    mk[k] = s_mask[u + k];
                    // x * w rounds once, as in the plain version
                    v[k] = kX ? __fmul_rn(wp[k * cw], xp[k * xn])
                              : wp[k * cw];
                }
#pragma unroll
                for (int k = 0; k < kBatch; ++k) {
#pragma unroll
                    for (int r = 0; r < R; ++r) {
                        if (mk[k] & bit[r]) acc[r] += v[k];
                    }
                }
                wp += kBatch * cw;
                xp += kBatch * xn;
            }
            for (; u < g_hi; ++u, wp += cw, xp += xn) {
                const uint32_t mk = s_mask[u];
                const float v = kX ? __fmul_rn(wp[0], xp[0]) : wp[0];
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    if (mk & bit[r]) acc[r] += v;
                }
            }
            const bool first = c0 == u_lo;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                if (!bit[r]) continue;
                float* dst = pg + (ph + r * P) * cw + c;
                *dst = first ? acc[r] : *dst + acc[r];
            }
        }
    }

    // each output's partial sums, task groups added in group order, go to
    // the rank that finishes it, into the slot of this rank; one cluster
    // barrier, then each rank adds the slots in rank order.  No peer reads
    // this CTA's shared memory after the barrier, so it may then exit.
    __syncthreads();
    cluster_wait();  // every CTA of the cluster has started
    for (int i = tid; i < n_out; i += blockDim.x) {
        float s = part[i];
        for (int g = 1; g < W; ++g) s += part[g * tc + i];
        const int owner = i / share;
        *cluster.map_shared_rank(recv + rank * share + (i - owner * share),
                                 owner) = s;
    }
    cluster_arrive();
    cluster_wait();
    // output k of the tile is slot k / cw, column col0 + k % cw
    float* o = out + (static_cast<int64_t>(b) * T + t0) * C + col0;
    const int mine = min(share, n_out - rank * share);
    for (int i = tid; i < mine; i += blockDim.x) {
        float sum = recv[i];
        for (int q = 1; q < S; ++q) sum += recv[q * share + i];
        const int k = rank * share + i;
        if (cw == C) {
            o[k] = sum;
        } else {
            const int t = k / cw;
            o[static_cast<int64_t>(t) * C + (k - t * cw)] = sum;
        }
    }
}

struct Plan {
    int t_tile, t_tiles, c_tile, c_tiles, x_tile, R, P, S, W, unit_pad, slice,
        chunk;
    int64_t rows;
    size_t smem;
};

int sm_count() {
    static int cached[64] = {0};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
    if (cached[dev] == 0) {
        int sms = 0;
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cached[dev] = sms > 0 ? sms : 132;
    }
    return cached[dev];
}

// The launch shape for B instances of n tasks, C = m * D columns, T
// slots; with_x when the launch reads x (m columns per task).
Plan make_plan(int64_t B, int n, int m, int D, int T, bool with_x) {
    Plan p{};
    const int C = m * D;
    // column tiles: one where every column fits the partial sums, else the
    // fewest that keep min(T, kMinTileT) slots per time tile, made even
    p.c_tiles = 1;
    p.c_tile = C;
    if (C > kPartFloats) {
        const int widest = kPartFloats / min(T, kMinTileT);
        p.c_tiles = (C + widest - 1) / widest;
        p.c_tile = (C + p.c_tiles - 1) / p.c_tiles;
        p.c_tiles = (C + p.c_tile - 1) / p.c_tile;  // no tile left empty
    }
    // x columns a tile can touch: all m with one tile, else at most the
    // D-blocks that a run of c_tile columns meets
    p.x_tile = with_x ? min(m, (p.c_tile + D - 2) / D + 1) : 0;
    p.t_tile = min(min(kTileT, T), kPartFloats / p.c_tile);
    p.t_tiles = (T + p.t_tile - 1) / p.t_tile;
    p.rows = B * p.t_tiles * p.c_tiles;
    // slots per thread: the largest R whose threads keep >= 70% of their
    // (slot, column) work live; else the busiest
    double best = -1.0;
    for (int R = 8; R >= 1; R /= 2) {
        const int P = (p.t_tile + R - 1) / R;
        const int units = p.c_tile * P;
        const int pad = min((units + 31) / 32 * 32, kMaxThreads);
        const int passes = (units + pad - 1) / pad;
        const double eff = static_cast<double>(p.c_tile) * p.t_tile
                           / (static_cast<double>(passes) * pad * R);
        if (eff > best) {
            best = eff;
            p.R = R;
        }
        if (eff >= 0.7) {
            p.R = R;
            break;
        }
    }
    p.P = (p.t_tile + p.R - 1) / p.R;
    p.unit_pad = min((p.c_tile * p.P + 31) / 32 * 32, kMaxThreads);
    // split the tasks until about kWarpsPerSM warps per SM are in flight:
    // first over the cluster, then over task groups inside each CTA
    const int64_t target = static_cast<int64_t>(sm_count()) * kWarpsPerSM;
    const int64_t warps = p.rows * (p.unit_pad / 32);
    const int tc = p.t_tile * p.c_tile;
    p.W = 1;
    while (2 * p.W * p.unit_pad <= kMaxThreads && 2 * p.W * tc <= kPartFloats
           && warps * p.W < target && n >= 2 * p.W * kMinTasks)
        p.W *= 2;
    p.S = 1;
    while (p.S < kMaxCluster && warps * p.W * p.S < target
           && n >= 2 * p.S * p.W * kMinTasks)
        p.S *= 2;
    p.slice = (n + p.S - 1) / p.S;
    const int per_task = 2 + p.c_tile + p.x_tile;  // start, end, w, x
    p.chunk = max(1, min(p.slice, kStageFloats / per_task));
    const int share = (tc + p.S - 1) / p.S;
    p.smem = (static_cast<size_t>(p.W) * tc + static_cast<size_t>(p.S) * share
              + static_cast<size_t>(p.chunk) * per_task) * sizeof(float);
    return p;
}

template <int R, bool kX>
cudaError_t launch_r(const Plan& p, const int32_t* start, const int32_t* end,
                     const float* x, const float* w, float* out, int n, int m,
                     int D, int T, cudaStream_t stream) {
    auto kernel = congestion_many_kernel<R, kX>;
    if (p.smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(p.smem));
        if (err != cudaSuccess) return err;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(p.rows * p.S), 1, 1);
    cfg.blockDim = dim3(static_cast<unsigned>(p.W * p.unit_pad), 1, 1);
    cfg.dynamicSmemBytes = p.smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(p.S);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, start, end, x, w, out, n, m, D, T,
                              p.t_tile, p.t_tiles, p.c_tile, p.c_tiles, p.P,
                              p.W, p.unit_pad, p.slice, p.chunk);
}

template <bool kX>
cudaError_t launch_x(const Plan& p, const int32_t* s, const int32_t* e,
                     const float* x, const float* w, float* out, int n, int m,
                     int D, int T, cudaStream_t st) {
    switch (p.R) {
        case 8: return launch_r<8, kX>(p, s, e, x, w, out, n, m, D, T, st);
        case 4: return launch_r<4, kX>(p, s, e, x, w, out, n, m, D, T, st);
        case 2: return launch_r<2, kX>(p, s, e, x, w, out, n, m, D, T, st);
        default: return launch_r<1, kX>(p, s, e, x, w, out, n, m, D, T, st);
    }
}

bool valid(int B, int n, int m, int D, int T) {
    return B > 0 && T > 0 && m > 0 && D > 0 && n >= 0;
}

int launch(const void* start, const void* end, const void* x, const void* w,
           void* out, int B, int n, int m, int D, int T, void* stream) {
    if (!valid(B, n, m, D, T)) return static_cast<int>(cudaErrorInvalidValue);
    const Plan p = make_plan(B, n, m, D, T, x != nullptr);
    if (p.rows * p.S > 0x7fffffff)
        return static_cast<int>(cudaErrorInvalidConfiguration);
    const auto* s = static_cast<const int32_t*>(start);
    const auto* e = static_cast<const int32_t*>(end);
    const auto* xf = static_cast<const float*>(x);
    const auto* wf = static_cast<const float*>(w);
    auto* of = static_cast<float*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        x != nullptr ? launch_x<true>(p, s, e, xf, wf, of, n, m, D, T, st)
                     : launch_x<false>(p, s, e, xf, wf, of, n, m, D, T, st);
    // a refused launch never runs: report it (and clear it) here
    const cudaError_t last = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

// The TPU contract: (G, T, K) congestion of G groups, w (G, n, K).
extern "C" int congestion_many_launch(const void* start, const void* end,
                                      const void* w, void* out, int G, int n,
                                      int T, int K, void* stream) {
    return launch(start, end, nullptr, w, out, G, n, 1, K, T, stream);
}

// The LP's forward apply: (B, T, m, D) from w (B, n, m, D) and x (B, n, m).
extern "C" int congestion_lp_launch(const void* start, const void* end,
                                    const void* x, const void* w, void* out,
                                    int B, int n, int m, int D, int T,
                                    void* stream) {
    return launch(start, end, x, w, out, B, n, m, D, T, stream);
}

// The launch shape an entry picks (with_x: the LP's), for reports: t_tile,
// R, P, S (cluster), W (task groups), threads, chunk, shared bytes, column
// tile width and column tiles.
extern "C" int congestion_plan(int B, int n, int m, int D, int T, int with_x,
                               int* info) {
    if (!valid(B, n, m, D, T)) return static_cast<int>(cudaErrorInvalidValue);
    const Plan p = make_plan(B, n, m, D, T, with_x != 0);
    const int vals[10] = {p.t_tile, p.R, p.P, p.S, p.W, p.W * p.unit_pad,
                          p.chunk, static_cast<int>(p.smem), p.c_tile,
                          p.c_tiles};
    for (int i = 0; i < 10; ++i) info[i] = vals[i];
    return 0;
}
