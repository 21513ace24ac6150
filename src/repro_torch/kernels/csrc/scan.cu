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
// (forward; three and two backward) and two operations, so bytes bound it.
// Each (b, channel) is a serial chain of S dependent steps, a few cycles
// each: tens of microseconds at S = 4100, well under the byte bound, so long
// as the bytes reach the chain in time.  By Little's law the card's rate
// needs several MB of loads in flight at once across all 132 SMs.
//
// What the design does about it:
//   * a block owns C consecutive channels (64, or 32, 16 or 8 where fewer
//     blocks would leave SMs idle) of one batch row for the whole sequence,
//     so B * ceil(W / C) blocks share the card (256 at B = 4, W = 4096), and
//     the shared memory of each is sized so that all are resident at once
//     (rows of 256 contiguous bytes beat 512 blocks of 128-byte rows by
//     4-7% on an H100; PERF.md);
//   * a ring of STAGES time tiles (T steps x C channels of each input) in
//     shared memory, filled STAGES - 1 tiles ahead of the chain by 16-byte
//     cp.async copies (4-byte ones where W is not a multiple of 4 or a
//     pointer is not 16-byte aligned); about 12 MB in flight across the card
//     at the path's shapes;
//   * warps 0-1 run the chains, one lane per channel, in time order,
//     reading the tile from shared memory and writing results into one of
//     two staging tiles; warps 2-7 start the copies and send the other
//     staging tile out as 16-byte pieces of whole rows while the chains go
//     on: one barrier a tile;
//   * the backward walks the tiles in reverse time; its h tile is shifted
//     by one step (row r holds h_{t0 + r - 1}, zero-filled at t = -1).
// Edges are masked: channels past W (copies skipped, results not stored),
// rows past S (not copied, not run), any B * W.  The chain rounds the
// multiply and the add apart (__fmul_rn, __fadd_rn, no fused multiply-add),
// as the plain PyTorch loop rounds them, so the two agree bit for bit; the
// reference's log-depth order rounds otherwise.
//
// make_plan is the one rule for the launch shape; linear_scan_plan reports
// it (tests/_torch_scan_tiles.py transcribes it and walks the tiles as the
// kernels do, on the CPU).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 64;        // the chain threads: warps 0-1
constexpr int kCopyThreads = kThreads - kMaxChannels;  // warps 2-7
constexpr int kSmemPerSM = 233472;     // 228 KB an SM ...
constexpr int kReservePerBlock = 1024;  // ... less 1 KB a resident block
constexpr int kMaxSmemPerBlock = 232448;  // 227 KB
constexpr int kMaxResident = 2048 / kThreads;
// (steps a tile, stages) in the order tried: the first that fits the
// budget of shared memory a block wins
constexpr int kShapes[][2] = {{64, 4}, {32, 4}, {32, 3}, {16, 4},
                              {16, 3}, {16, 2}, {8, 2}};
constexpr int kNumShapes = sizeof(kShapes) / sizeof(kShapes[0]);

struct Plan {
    int C, T, stages, blocks, col_blocks, smem, vec;
};

__host__ __device__ inline int ceil_div(int64_t a, int64_t b) {
    return static_cast<int>((a + b - 1) / b);
}

// ins / outs: arrays read / written (forward 2 / 1, backward 3 / 2)
int64_t smem_bytes(int T, int C, int stages, int ins, int outs) {
    return static_cast<int64_t>(ins * stages + 2 * outs) * T * C * 4;
}

// The time length does not change the shape: rows past S are masked.
Plan make_plan(int B, int W, int sms, bool backward) {
    const int ins = backward ? 3 : 2, outs = backward ? 2 : 1;
    Plan p{};
    p.C = kMaxChannels;
    while (p.C > 8 && static_cast<int64_t>(B) * ceil_div(W, p.C) < sms)
        p.C /= 2;
    p.col_blocks = ceil_div(W, p.C);
    p.blocks = B * p.col_blocks;
    int resident = ceil_div(p.blocks, sms);
    resident = resident < 1 ? 1 : (resident > kMaxResident ? kMaxResident
                                                            : resident);
    int64_t budget = kSmemPerSM / resident - kReservePerBlock;
    if (budget > kMaxSmemPerBlock) budget = kMaxSmemPerBlock;
    int pick = kNumShapes - 1;
    for (int i = 0; i < kNumShapes; ++i) {
        if (smem_bytes(kShapes[i][0], p.C, kShapes[i][1], ins, outs)
            <= budget) {
            pick = i;
            break;
        }
    }
    p.T = kShapes[pick][0];
    p.stages = kShapes[pick][1];
    p.smem = static_cast<int>(smem_bytes(p.T, p.C, p.stages, ins, outs));
    p.vec = W % 4 == 0 ? 4 : 1;
    return p;
}

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

// --- copies -------------------------------------------------------------------

template <int V>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem,
                                         bool valid) {
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(smem));
    if constexpr (V == 4) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     ::"r"(s), "l"(gmem), "r"(valid ? 16 : 0));
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     ::"r"(s), "l"(gmem), "r"(valid ? 4 : 0));
    }
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most n of this thread's groups are pending (n < 4)
__device__ __forceinline__ void cp_async_wait(int n) {
    switch (n) {
        case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
        case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
        case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
        default: asm volatile("cp.async.wait_group 3;\n" ::: "memory");
    }
}

// One block's view: batch row bi, channels [c0, c0 + C) of which the
// first nc lie below W.
struct Block {
    int64_t row0;  // offset of (bi, t = 0, c0)
    int nc;
};

__device__ __forceinline__ Block block_of(int W, int S, int C,
                                          int col_blocks) {
    const int bi = blockIdx.x / col_blocks;
    const int c0 = (blockIdx.x % col_blocks) * C;
    const int nc = W - c0 < C ? W - c0 : C;
    return {static_cast<int64_t>(bi) * S * W + c0, nc};
}

// Copy rows [0, rows) of a T x C tile whose row r is time step t0 + r +
// shift (zero-filled where that step is negative) from src into dst, one V
// floats a copy, by the copy threads (i = threadIdx.x - kMaxChannels).
template <int V>
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          const Block& blk, int W, int C,
                                          int t0, int rows, int shift) {
    const int per_row = C / V;
    for (int i = threadIdx.x - kMaxChannels; i < rows * per_row;
         i += kCopyThreads) {
        const int r = i / per_row, q = (i % per_row) * V;
        if (q >= blk.nc) continue;  // past W: never read back
        const int t = t0 + r + shift;
        const bool valid = t >= 0;
        const float* g = src + blk.row0 + static_cast<int64_t>(valid ? t : 0)
                         * W + q;
        cp_async<V>(dst + r * C + q, g, valid);
    }
}

// Send rows [0, rows) of a staged T x C tile out to dst, by the copy
// threads.
template <int V>
__device__ __forceinline__ void store_tile(float* dst, const float* stage,
                                           const Block& blk, int W, int C,
                                           int t0, int rows) {
    const int per_row = C / V;
    for (int i = threadIdx.x - kMaxChannels; i < rows * per_row;
         i += kCopyThreads) {
        const int r = i / per_row, q = (i % per_row) * V;
        if (q >= blk.nc) continue;
        float* g = dst + blk.row0 + static_cast<int64_t>(t0 + r) * W + q;
        if constexpr (V == 4) {
            *reinterpret_cast<float4*>(g) =
                *reinterpret_cast<const float4*>(stage + r * C + q);
        } else {
            *g = stage[r * C + q];
        }
    }
}

// --- forward --------------------------------------------------------------------

// Shared memory: the ring, STAGES x {a, b} tiles of T x C floats, then two
// staging tiles of h.
template <int V>
__global__ void __launch_bounds__(kThreads)
linear_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ h, int S, int W, int C, int T,
                   int stages, int col_blocks) {
    extern __shared__ __align__(16) float smem[];
    const int tile = T * C;
    float* ring = smem;                       // [stages][2][T][C]
    float* stage_h = smem + stages * 2 * tile;  // [2][T][C]
    const Block blk = block_of(W, S, C, col_blocks);
    const int nt = ceil_div(S, T);
    const bool chain = threadIdx.x < kMaxChannels;
    const int lane = threadIdx.x;

    auto fetch = [&](int k) {
        if (!chain && k < nt) {
            float* slot = ring + (k % stages) * 2 * tile;
            const int t0 = k * T, rows = min(T, S - t0);
            copy_tile<V>(slot, a, blk, W, C, t0, rows, 0);
            copy_tile<V>(slot + tile, b, blk, W, C, t0, rows, 0);
        }
        cp_async_commit();
    };
    for (int k = 0; k < stages - 1; ++k) fetch(k);

    float acc = 0.f;
    for (int k = 0; k < nt; ++k) {
        cp_async_wait(stages - 2);
        // tile k has landed; the chain is done with tile k - 1 (its slot is
        // free, its staging tile full) and the stores of k - 2 have left
        __syncthreads();
        fetch(k + stages - 1);
        if (chain) {
            if (lane < C) {
                const float* A = ring + (k % stages) * 2 * tile;
                const float* Bt = A + tile;
                float* H = stage_h + (k & 1) * tile;
                const int rows = min(T, S - k * T);
                int r = 0;
                for (; r + 8 <= rows; r += 8) {
                    float av[8], bv[8];
#pragma unroll
                    for (int q = 0; q < 8; ++q) {
                        av[q] = A[(r + q) * C + lane];
                        bv[q] = Bt[(r + q) * C + lane];
                    }
#pragma unroll
                    for (int q = 0; q < 8; ++q) {
                        acc = __fadd_rn(__fmul_rn(av[q], acc), bv[q]);
                        H[(r + q) * C + lane] = acc;
                    }
                }
                for (; r < rows; ++r) {
                    acc = __fadd_rn(__fmul_rn(A[r * C + lane], acc),
                                    Bt[r * C + lane]);
                    H[r * C + lane] = acc;
                }
            }
        } else if (k > 0) {
            const int t0 = (k - 1) * T;
            store_tile<V>(h, stage_h + ((k - 1) & 1) * tile, blk, W, C, t0,
                          min(T, S - t0));
        }
    }
    __syncthreads();
    if (!chain) {
        const int t0 = (nt - 1) * T;
        store_tile<V>(h, stage_h + ((nt - 1) & 1) * tile, blk, W, C, t0,
                      min(T, S - t0));
    }
}

// --- backward -------------------------------------------------------------------

// Tiles in reverse time: step k works on tile j = nt - 1 - k.  Shared
// memory: the ring, STAGES x {a, gh, h shifted} tiles, then two staging
// tiles each of ga and gb.
template <int V>
__global__ void __launch_bounds__(kThreads)
linear_scan_backward_kernel(const float* __restrict__ a,
                            const float* __restrict__ h,
                            const float* __restrict__ gh,
                            float* __restrict__ ga, float* __restrict__ gb,
                            int S, int W, int C, int T, int stages,
                            int col_blocks) {
    extern __shared__ __align__(16) float smem[];
    const int tile = T * C;
    float* ring = smem;                         // [stages][3][T][C]
    float* stage_g = smem + stages * 3 * tile;  // [2][{ga, gb}][T][C]
    const Block blk = block_of(W, S, C, col_blocks);
    const int nt = ceil_div(S, T);
    const bool chain = threadIdx.x < kMaxChannels;
    const int lane = threadIdx.x;

    auto fetch = [&](int k) {
        if (!chain && k < nt) {
            float* slot = ring + (k % stages) * 3 * tile;
            const int t0 = (nt - 1 - k) * T, rows = min(T, S - t0);
            copy_tile<V>(slot, a, blk, W, C, t0, rows, 0);
            copy_tile<V>(slot + tile, gh, blk, W, C, t0, rows, 0);
            copy_tile<V>(slot + 2 * tile, h, blk, W, C, t0, rows, -1);
        }
        cp_async_commit();
    };
    for (int k = 0; k < stages - 1; ++k) fetch(k);

    float carry = 0.f;  // a_{t+1} * dh_{t+1}
    for (int k = 0; k < nt; ++k) {
        cp_async_wait(stages - 2);
        __syncthreads();
        fetch(k + stages - 1);
        if (chain) {
            if (lane < C) {
                const float* A = ring + (k % stages) * 3 * tile;
                const float* G = A + tile;
                const float* Hs = A + 2 * tile;
                float* GA = stage_g + (k & 1) * 2 * tile;
                float* GB = GA + tile;
                const int rows = min(T, S - (nt - 1 - k) * T);
                int r = rows - 1;
                for (; r - 7 >= 0; r -= 8) {
                    float av[8], gv[8], hv[8];
#pragma unroll
                    for (int q = 0; q < 8; ++q) {
                        const int o = (r - q) * C + lane;
                        av[q] = A[o];
                        gv[q] = G[o];
                        hv[q] = Hs[o];
                    }
#pragma unroll
                    for (int q = 0; q < 8; ++q) {
                        const int o = (r - q) * C + lane;
                        const float dh = __fadd_rn(gv[q], carry);
                        GB[o] = dh;
                        GA[o] = __fmul_rn(dh, hv[q]);
                        carry = __fmul_rn(av[q], dh);
                    }
                }
                for (; r >= 0; --r) {
                    const int o = r * C + lane;
                    const float dh = __fadd_rn(G[o], carry);
                    GB[o] = dh;
                    GA[o] = __fmul_rn(dh, Hs[o]);
                    carry = __fmul_rn(A[o], dh);
                }
            }
        } else if (k > 0) {
            const int t0 = (nt - k) * T;  // tile j = nt - k
            const float* GA = stage_g + ((k - 1) & 1) * 2 * tile;
            const int rows = min(T, S - t0);
            store_tile<V>(ga, GA, blk, W, C, t0, rows);
            store_tile<V>(gb, GA + tile, blk, W, C, t0, rows);
        }
    }
    __syncthreads();
    if (!chain) {
        const float* GA = stage_g + ((nt - 1) & 1) * 2 * tile;
        const int rows = min(T, S);  // tile 0
        store_tile<V>(ga, GA, blk, W, C, 0, rows);
        store_tile<V>(gb, GA + tile, blk, W, C, 0, rows);
    }
}

template <typename K>
cudaError_t prepare(K kernel, const Plan& p) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
}

bool aligned16(const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename K>
int resident_blocks(K kernel, const Plan& p) {
    if (prepare(kernel, p) != cudaSuccess) return -1;
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                      p.smem) != cudaSuccess)
        return -1;
    return n;
}

}  // namespace

extern "C" int linear_scan_launch(const void* a, const void* b, void* h,
                                  int B, int S, int W, void* stream) {
    if (static_cast<int64_t>(B) * S * W == 0) return 0;
    Plan p = make_plan(B, W, sm_count(), false);
    if (!(aligned16(a) && aligned16(b) && aligned16(h))) p.vec = 1;
    auto kernel = p.vec == 4 ? linear_scan_kernel<4> : linear_scan_kernel<1>;
    cudaError_t err = prepare(kernel, p);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<p.blocks, kThreads, p.smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(h), S, W, p.C, p.T, p.stages, p.col_blocks);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int linear_scan_backward_launch(const void* a, const void* h,
                                           const void* gh, void* ga, void* gb,
                                           int B, int S, int W,
                                           void* stream) {
    if (static_cast<int64_t>(B) * S * W == 0) return 0;
    Plan p = make_plan(B, W, sm_count(), true);
    if (!(aligned16(a) && aligned16(h) && aligned16(gh) && aligned16(ga)
          && aligned16(gb)))
        p.vec = 1;
    auto kernel = p.vec == 4 ? linear_scan_backward_kernel<4>
                             : linear_scan_backward_kernel<1>;
    cudaError_t err = prepare(kernel, p);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<p.blocks, kThreads, p.smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(h),
        static_cast<const float*>(gh), static_cast<float*>(ga),
        static_cast<float*>(gb), S, W, p.C, p.T, p.stages, p.col_blocks);
    return static_cast<int>(cudaGetLastError());
}

// The launch shape for B rows of W channels on this card, forward or
// backward, with 16-byte-aligned pointers: info gets blocks, channels a
// block, steps a tile, stages, shared bytes a block, threads a block,
// floats a copy (4 or 1), and the blocks an SM holds at once by the
// occupancy calculator (-1 if it cannot say).
extern "C" int linear_scan_plan(int B, int W, int backward, int* info) {
    if (B <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const Plan p = make_plan(B, W, sm_count(), backward != 0);
    int resident;
    if (backward)
        resident = resident_blocks(p.vec == 4 ? linear_scan_backward_kernel<4>
                                              : linear_scan_backward_kernel<1>,
                                   p);
    else
        resident = resident_blocks(p.vec == 4 ? linear_scan_kernel<4>
                                              : linear_scan_kernel<1>, p);
    const int vals[8] = {p.blocks, p.C, p.T, p.stages, p.smem, kThreads,
                         p.vec, resident};
    for (int i = 0; i < 8; ++i) info[i] = vals[i];
    return 0;
}
