// Compiled placement stepper for Hopper (sm_90a): one launch runs every
// attempt step of one placement sub-phase, for every lane at once.
//
// Replaces: the lax.scan body of src/repro/core/place_step.py
// (_make_sub_phase.sub_phase) together with the scorer it calls every step,
// src/repro/kernels/ops.py : fit_scores_step.  On this card it is the
// redesign of the per-step fit kernel (csrc/fit.cu, fit_scores_many): that
// kernel is launched once per lockstep step with a host round trip around
// it; this one keeps the pool on the card and walks the steps itself.
//
// A lane a is one (instance, node-type) phase with its open-node pool
// pool[a, j, k] (k = t * D + d, slot-major), the first w[a] rows open.  At
// step l < lens[a] the lane's pending task has demand dem_seq[l, a, :] over
// the inclusive slot span [s_seq[l, a], e_seq[l, a]].  Exactly as the scan
// body (and the numpy lockstep engine) does:
//
//   feasible(j)  = j < w and not any over the span of rem[j, k] < dem - EPS
//   score(j)     = rint(q * dot / (dn * sqrt(norm2) + 1e-30)) / q
//                  with dot = sum rn * (dem / capx), norm2 = sum rn * rn,
//                  rn = rem / capx  (similarity fit only)
//   choice       = first maximum of score over feasible j (first fit: the
//                  lowest feasible j)
//   no feasible  : purchase -> j = w, w += 1 (bad[a] = l at the first such
//                  step whose demand exceeds the type's capacity + EPS; the
//                  row is still debited, as the scan does); otherwise no
//                  placement (j_rec = -1)
//   placement    : rem[j, k] -= dem over the span; j_rec[l, a] = j.
//
// Every elementwise operation is the numpy engine's float64 operation on the
// same values: this file is compiled with -fmad=false, so no a * b + c is
// contracted, the quantization divides by q (no reciprocal multiply), and
// the comparison uses thr = dem - EPS formed once, as numpy's thr does.  The
// dot and norm2 sums are taken in another order than numpy's einsum; the
// shared 9-decimal quantization collapses that, as in the JAX stepper.
//
// What bounds it on this card: the serial chain of L dependent steps of a
// lane (each step reads the pool its previous step wrote), not bytes: the
// whole sub-phase reads each sequence element once and touches a few
// hundred KB of pool per lane.
//
// What the design does about it: one CTA per lane, so all lanes advance at
// once (<= a couple of hundred lanes on the fleet: one wave over 132 SMs),
// and a step costs three block barriers and no host involvement.  The lane's
// open rows live in dynamic shared memory, sized to the rows the lane can
// reach (opted in up to the SM's shared memory, split between the CTAs that
// must share an SM); rows past that are read and written in device memory
// through the same row accessor.  Warps take the open nodes j = warp,
// warp + 8, ...; the 32 lanes of a warp walk the span's contiguous slot
// range [s * D, (e + 1) * D) of the row; warp votes and shuffles finish the
// feasibility test and the sums; a block-wide first-max argmax (ties to the
// lowest j) picks the node.  The next step's task is loaded into registers
// while the current step scores, so its device-memory latency is hidden.

#include <cuda_runtime.h>
#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr double kEps = 1e-7;  // the engines' feasibility slack (EPS)

__device__ __forceinline__ double* row_of(double* rows_s, double* rows_g,
                                          int j, int n_smem, int K) {
    return (j < n_smem ? rows_s : rows_g) + static_cast<int64_t>(j) * K;
}

__global__ void __launch_bounds__(kThreads, 2)
place_step_kernel(double* __restrict__ pool,
                  const int32_t* __restrict__ w_in,
                  const int32_t* __restrict__ lens,
                  const double* __restrict__ dem_seq,
                  const int32_t* __restrict__ s_seq,
                  const int32_t* __restrict__ e_seq,
                  const double* __restrict__ dn_seq,
                  const double* __restrict__ capx,
                  const double* __restrict__ cap_rows,
                  double quantum,
                  int32_t* __restrict__ w_out,
                  int32_t* __restrict__ bad_out,
                  int32_t* __restrict__ j_rec,
                  int A, int L, int n_cap, int K, int D, int n_smem,
                  int purchase, int similarity) {
    extern __shared__ double smem[];
    double* rows_s = smem;                                   // n_smem * K
    double* thr = smem + static_cast<int64_t>(n_smem) * K;   // D
    double* dem = thr + D;                                   // D
    double* dq = dem + D;                                    // D: dem / capx
    double* cx = dq + D;                                     // D: capx
    __shared__ double warp_key[kWarps];
    __shared__ int warp_j[kWarps];
    __shared__ int sh_s, sh_e, sh_j, sh_w;
    __shared__ double sh_dn;

    const int a = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    double* rows_g = pool + static_cast<int64_t>(a) * n_cap * K;
    const int w0 = w_in[a];
    const int len = lens[a];
    const int reach = min(n_cap, purchase ? w0 + len : w0);
    const int n_s = min(reach, n_smem);

    for (int i = tid; i < n_s * K; i += kThreads) rows_s[i] = rows_g[i];
    for (int d = tid; d < D; d += kThreads) cx[d] = capx[a * D + d];
    for (int l = len + tid; l < L; l += kThreads)
        j_rec[static_cast<int64_t>(l) * A + a] = -1;

    // step 0's task, then each step prefetches the next one
    double dm_next = 0.0, dn_next = 0.0;
    int s_next = 0, e_next = -1;
    if (len > 0) {
        if (tid < D) dm_next = dem_seq[static_cast<int64_t>(a) * D + tid];
        if (tid == 0) {
            s_next = s_seq[a];
            e_next = e_seq[a];
            dn_next = dn_seq[a];
        }
    }
    int w = w0;
    int bad = -1;  // thread 0's
    __syncthreads();

    for (int l = 0; l < len; ++l) {
        if (tid < D) {
            dem[tid] = dm_next;
            thr[tid] = dm_next - kEps;
            dq[tid] = dm_next / cx[tid];
        }
        if (tid == 0) {
            sh_s = s_next;
            sh_e = e_next;
            sh_dn = dn_next;
        }
        __syncthreads();
        if (l + 1 < len) {
            const int64_t nx = static_cast<int64_t>(l + 1) * A + a;
            if (tid < D) dm_next = dem_seq[nx * D + tid];
            if (tid == 0) {
                s_next = s_seq[nx];
                e_next = e_seq[nx];
                dn_next = dn_seq[nx];
            }
        }
        const int k0 = sh_s * D;
        const int k1 = (sh_e + 1) * D;
        const double dn = sh_dn;

        // each warp: the first maximum over its nodes (j ascending)
        double best = -INFINITY;
        int best_j = INT_MAX;
        for (int j = warp; j < w; j += kWarps) {
            const double* row = row_of(rows_s, rows_g, j, n_smem, K);
            bool viol = false;
            double dot = 0.0, norm2 = 0.0;
            for (int k = k0 + lane; k < k1; k += 32) {
                const int d = k % D;
                const double r = row[k];
                viol |= r < thr[d];
                if (similarity) {
                    const double rn = r / cx[d];
                    dot += rn * dq[d];
                    norm2 += rn * rn;
                }
            }
            if (__any_sync(0xffffffffu, viol)) continue;
            double key = 0.0;
            if (similarity) {
#pragma unroll
                for (int off = 16; off > 0; off >>= 1) {
                    dot += __shfl_xor_sync(0xffffffffu, dot, off);
                    norm2 += __shfl_xor_sync(0xffffffffu, norm2, off);
                }
                const double score = dot / (dn * sqrt(norm2) + 1e-30);
                key = rint(score * quantum) / quantum;
            }
            if (key > best) {
                best = key;
                best_j = j;
            }
        }
        if (lane == 0) {
            warp_key[warp] = best;
            warp_j[warp] = best_j;
        }
        __syncthreads();

        if (tid == 0) {
            double bk = -INFINITY;
            int bj = INT_MAX;
            for (int i = 0; i < kWarps; ++i) {
                const double k = warp_key[i];
                if (k > bk || (k == bk && warp_j[i] < bj)) {
                    bk = k;
                    bj = warp_j[i];
                }
            }
            int j = -1;
            if (bj != INT_MAX) {
                j = bj;
            } else if (purchase) {
                if (bad < 0) {
                    for (int d = 0; d < D; ++d) {
                        if (dem[d] > cap_rows[a * D + d] + kEps) {
                            bad = l;
                            break;
                        }
                    }
                }
                j = w;
                w += 1;
            }
            j_rec[static_cast<int64_t>(l) * A + a] = j;
            sh_j = j;
            sh_w = w;
        }
        __syncthreads();

        const int j = sh_j;
        w = sh_w;
        if (j >= 0) {
            double* row = row_of(rows_s, rows_g, j, n_smem, K);
            for (int k = k0 + tid; k < k1; k += kThreads) row[k] -= dem[k % D];
        }
        __syncthreads();
    }

    // opened rows held in shared memory go back to the pool
    for (int i = tid; i < min(w, n_s) * K; i += kThreads) rows_g[i] = rows_s[i];
    if (tid == 0) {
        w_out[a] = w;
        bad_out[a] = bad;
    }
}

}  // namespace

// Launches one sub-phase over A lanes.  ``rows`` bounds the rows any lane
// can reach (max w0 + L with purchases, max w0 without); the rows of a lane
// below the shared-memory budget live in shared memory, and that row count
// is written to *smem_rows.  Returns cudaGetLastError().
extern "C" int place_step_launch(void* pool, const void* w_in,
                                 const void* lens, const void* dem_seq,
                                 const void* s_seq, const void* e_seq,
                                 const void* dn_seq, const void* capx,
                                 const void* cap_rows, double quantum,
                                 void* w_out, void* bad_out, void* j_rec,
                                 int A, int L, int n_cap, int K, int D,
                                 int rows, int purchase, int similarity,
                                 void* smem_rows, void* stream) {
    if (A <= 0) return 0;
    if (D <= 0 || D > kThreads) return static_cast<int>(cudaErrorInvalidValue);
    int dev = 0, per_sm = 0, per_block = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    cudaFuncAttributes attr;
    if (err == cudaSuccess)
        err = cudaFuncGetAttributes(&attr, place_step_kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    // the CTAs that must share one SM for every lane to run in one wave
    // split its shared memory (1 KB of each CTA's is reserved by the system)
    const int per_sm_ctas = std::min(8, std::max(1, (A + sms - 1) / sms));
    int64_t budget = std::min<int64_t>(per_block, per_sm / per_sm_ctas - 1024);
    budget -= static_cast<int64_t>(attr.sharedSizeBytes) + 4LL * D * 8;
    const int64_t row_bytes = static_cast<int64_t>(K) * 8;
    int n_smem = 0;
    if (budget > 0 && row_bytes > 0)
        n_smem = static_cast<int>(std::min<int64_t>(rows, budget / row_bytes));
    n_smem = std::max(0, std::min(n_smem, n_cap));
    const size_t dyn = (static_cast<size_t>(n_smem) * K + 4 * D) * 8;
    err = cudaFuncSetAttribute(place_step_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dyn));
    if (err != cudaSuccess) return static_cast<int>(err);
    *static_cast<int*>(smem_rows) = n_smem;
    place_step_kernel<<<A, kThreads, dyn, static_cast<cudaStream_t>(stream)>>>(
        static_cast<double*>(pool), static_cast<const int32_t*>(w_in),
        static_cast<const int32_t*>(lens), static_cast<const double*>(dem_seq),
        static_cast<const int32_t*>(s_seq), static_cast<const int32_t*>(e_seq),
        static_cast<const double*>(dn_seq), static_cast<const double*>(capx),
        static_cast<const double*>(cap_rows), quantum,
        static_cast<int32_t*>(w_out), static_cast<int32_t*>(bad_out),
        static_cast<int32_t*>(j_rec), A, L, n_cap, K, D, n_smem, purchase,
        similarity);
    return static_cast<int>(cudaGetLastError());
}
