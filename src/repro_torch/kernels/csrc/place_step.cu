// Placement steppers for Hopper (sm_90a).  Two entries share one step:
//
//   place_step_launch  every attempt step of one placement sub-phase, for
//                      every lane at once (the compiled fleet path);
//   two_phase_launch   one instance's whole two_phase placement, every
//                      node-type's own pack and cross-fill, in one launch
//                      (the single-instance path; see the second part below).
//
// A third entry, barrier_chain_launch, places nothing: it measures the
// latency floor of two_phase's serial chain (one block barrier and one
// shared-memory hand-over per attempt), the bound the smoke prints beside
// the bytes and operations bound.
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
// lowest j) picks the node.  The next step's demand is copied into the
// other half of a double-buffered D-long demand array with asynchronous
// copies (cp.async) while the current step scores, so its device-memory
// latency is hidden; every loop over the D dimensions is strided by the
// block, so any D is taken.

#include <cuda_runtime.h>
#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr double kEps = 1e-7;  // the engines' feasibility slack (EPS)
constexpr unsigned kAll = 0xffffffffu;

// 8-byte asynchronous copy global -> shared (cp.async); the issuing thread
// waits for its own copies with copy_async_wait before it reads them
__device__ __forceinline__ void copy_async8(double* dst, const double* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
}

__device__ __forceinline__ void copy_async_wait() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                     : "memory");
}

// f(row) for pool row j, which lives in shared memory when j < n_smem and
// in device memory past that.  Each branch passes a pointer whose memory
// space the compiler can see, so a row in shared memory is read with
// shared-memory loads rather than generic ones.
template <typename F>
__device__ __forceinline__ void on_row(double* rows_s, double* rows_g, int j,
                                       int n_smem, int K, F f) {
    if (j < n_smem)
        f(rows_s + static_cast<int64_t>(j) * K);
    else
        f(rows_g + static_cast<int64_t>(j) * K);
}

// The first maximum, over this warp's open nodes j = warp, warp + kWarps,
// ... < w, of the step's key: 0 for first fit, the quantized cosine for
// similarity, over the feasible nodes only.  Returns (-inf, INT_MAX) when
// the warp has no feasible node.  Every elementwise operation is the numpy
// engine's float64 operation (thr = dem - EPS, rn = rem / cap, dq = dem /
// cap); the two sums are taken in lane order and then by shuffles.  The
// span starts at a slot boundary (k0 = s * D), so a lane's first dimension
// is lane_d = lane % D and each stride of 32 moves it on by r32 = 32 % D.
// This holds for any D: past 32, lane_d = lane and r32 = 32 < D, so one
// subtraction keeps d in [0, D).
// First fit keys every feasible node 0, so a warp stops at its first one.
__device__ __forceinline__ void warp_first_max(
        double* rows_s, double* rows_g, int n_smem, int K, int D, int w,
        int k0, int k1, const double* thr, const double* dq, const double* cx,
        double dn, double quantum, bool similarity, int warp, int lane,
        int lane_d, int r32, double* best_key, int* best_j) {
    double best = -INFINITY;
    int bj = INT_MAX;
    for (int j = warp; j < w; j += kWarps) {
        bool viol = false;
        double dot = 0.0, norm2 = 0.0;
        on_row(rows_s, rows_g, j, n_smem, K, [&](const double* row) {
            int d = lane_d;
            if (similarity) {
                for (int k = k0 + lane; k < k1; k += 32) {
                    const double r = row[k];
                    viol |= r < thr[d];
                    const double rn = r / cx[d];
                    dot += rn * dq[d];
                    norm2 += rn * rn;
                    d += r32;
                    if (d >= D) d -= D;
                }
            } else {
                for (int k = k0 + lane; k < k1; k += 32) {
                    viol |= row[k] < thr[d];
                    d += r32;
                    if (d >= D) d -= D;
                }
            }
        });
        if (__any_sync(kAll, viol)) continue;
        if (!similarity) {
            best = 0.0;
            bj = j;
            break;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            dot += __shfl_xor_sync(kAll, dot, off);
            norm2 += __shfl_xor_sync(kAll, norm2, off);
        }
        const double score = dot / (dn * sqrt(norm2) + 1e-30);
        const double key = rint(score * quantum) / quantum;
        if (key > best) {
            best = key;
            bj = j;
        }
    }
    *best_key = best;
    *best_j = bj;
}

// The block's first maximum from the warps' (key, j): ties go to the lowest
// j.  Returns -1 when no warp found a feasible node.
__device__ __forceinline__ int block_first_max(const double* warp_key,
                                               const int* warp_j) {
    double bk = -INFINITY;
    int bj = INT_MAX;
    for (int i = 0; i < kWarps; ++i) {
        const double k = warp_key[i];
        if (k > bk || (k == bk && warp_j[i] < bj)) {
            bk = k;
            bj = warp_j[i];
        }
    }
    return bj == INT_MAX ? -1 : bj;
}

// The same first maximum, found by one whole warp with shuffles (lanes
// 0..kWarps-1 read one warp's result each); every lane returns it.  The
// rule (greater key, or equal key and lower j) is a total order, so the
// tree finds what the sequential scan finds.
__device__ __forceinline__ int warp_pick(const double* warp_key,
                                         const int* warp_j, int lane) {
    double bk = lane < kWarps ? warp_key[lane] : -INFINITY;
    int bj = lane < kWarps ? warp_j[lane] : INT_MAX;
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1) {
        const double k = __shfl_xor_sync(kAll, bk, off);
        const int j = __shfl_xor_sync(kAll, bj, off);
        if (k > bk || (k == bk && j < bj)) {
            bk = k;
            bj = j;
        }
    }
    bj = __shfl_sync(kAll, bj, 0);
    return bj == INT_MAX ? -1 : bj;
}

// Whether the demand exceeds the node-type's capacity + EPS in some dim.
__device__ __forceinline__ bool exceeds(const double* dem, const double* cap,
                                        int D) {
    for (int d = 0; d < D; ++d)
        if (dem[d] > cap[d] + kEps) return true;
    return false;
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
    double* dem_buf = thr + D;           // 2 x D: step l's demand at l & 1
    double* dq = dem_buf + 2 * D;                            // D: dem / capx
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
    const int lane_d = lane % D;
    const int r32 = 32 % D;
    const int reach = min(n_cap, purchase ? w0 + len : w0);
    const int n_s = min(reach, n_smem);

    for (int i = tid; i < n_s * K; i += kThreads) rows_s[i] = rows_g[i];
    for (int d = tid; d < D; d += kThreads) cx[d] = capx[a * D + d];
    for (int l = len + tid; l < L; l += kThreads)
        j_rec[static_cast<int64_t>(l) * A + a] = -1;

    // step 0's task, then each step prefetches the next one; a thread
    // copies the same dimensions d = tid, tid + kThreads, ... at every step
    // and is the only reader of its copies before the block barrier
    double dn_next = 0.0;
    int s_next = 0, e_next = -1;
    if (len > 0) {
        for (int d = tid; d < D; d += kThreads)
            copy_async8(dem_buf + d, dem_seq + static_cast<int64_t>(a) * D + d);
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
        const double* dem = dem_buf + (l & 1) * D;
        copy_async_wait();
        for (int d = tid; d < D; d += kThreads) {
            thr[d] = dem[d] - kEps;
            dq[d] = dem[d] / cx[d];
        }
        if (tid == 0) {
            sh_s = s_next;
            sh_e = e_next;
            sh_dn = dn_next;
        }
        __syncthreads();
        if (l + 1 < len) {
            // the other half held step l - 1's demand, whose last readers
            // passed the barrier that ended that step
            const int64_t nx = static_cast<int64_t>(l + 1) * A + a;
            double* dem_nx = dem_buf + ((l + 1) & 1) * D;
            for (int d = tid; d < D; d += kThreads)
                copy_async8(dem_nx + d, dem_seq + nx * D + d);
            if (tid == 0) {
                s_next = s_seq[nx];
                e_next = e_seq[nx];
                dn_next = dn_seq[nx];
            }
        }
        const int k0 = sh_s * D;
        const int k1 = (sh_e + 1) * D;

        double best;
        int best_j;
        warp_first_max(rows_s, rows_g, n_smem, K, D, w, k0, k1, thr, dq, cx,
                       sh_dn, quantum, similarity, warp, lane, lane_d, r32,
                       &best, &best_j);
        if (lane == 0) {
            warp_key[warp] = best;
            warp_j[warp] = best_j;
        }
        __syncthreads();

        if (tid == 0) {
            int j = block_first_max(warp_key, warp_j);
            if (j < 0 && purchase) {
                if (bad < 0 && exceeds(dem, cap_rows + a * D, D)) bad = l;
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
            on_row(rows_s, rows_g, j, n_smem, K, [&](double* row) {
                for (int k = k0 + tid; k < k1; k += kThreads)
                    row[k] -= dem[k % D];
            });
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

// ---------------------------------------------------------------------------
// two_phase: one instance's whole placement in one launch.
//
// Replaces, on the single-instance path, the per-task loop of
// src/repro/core/placement.py : two_phase around TypePool.find_fit, whose
// scorer is src/repro/kernels/fit.py : fit_scores_pallas (pallas_call at
// :104).  Its B=1 port (csrc/fit.cu, fit_scores_launch) was launched once per
// attempted task with a host round trip around each launch; this entry keeps
// the node-type's pool on the card and walks every attempt itself.
//
// The host hands over one walk: for each phase p (a node-type, in two_phase's
// type order) the entries [lo_p, own_p) are the type's own tasks in start
// order and [own_p, hi_p) the cross-fill candidates (tasks mapped to later
// types) in increasing h_avg order; cap[p] is the type's capacity.  Exactly as
// two_phase does, and with the step above:
//
//   an entry whose task is already placed is skipped;
//   own part:   the policy fit places the task; on a miss a node is bought
//               (w += 1, its row set to cap), unless the demand exceeds
//               cap + EPS: then bad[p] = the task and the walk stops (the
//               host raises the reference's error naming it); a purchase
//               past ``rows`` nodes stops the walk too, with bad[p] = -2;
//   cross-fill: first fit, no purchase; a miss leaves the task unplaced; a
//               phase that attempted no own task has no node open, so every
//               attempt would miss and the part is skipped.
//
// out = [w (P) | bad (P) | steps (P) | phase (n) | node (n)]: the nodes each
// phase bought, its bad task (-1 = none), its attempts (skipped entries do
// not count), and per task the phase and the phase-local node it was placed
// in (-1 = not placed).  A type buys only in its own phase, so the host
// numbers its nodes as one block in type order.
//
// What bounds it on this card: the serial chain of dependent attempts (each
// reads the pool the previous one wrote): per attempt, the scoring of the
// open nodes' spans, two barriers and the pick, not bytes or operations.
//
// What the design does about it: with filling the phases are one sequential
// chain, so one CTA walks them all; without it they are independent, so
// there is one CTA per phase (type-parallel), still one launch.  The current
// type's open rows live in shared memory (rows past the budget spill to
// device memory through on_row), and so does the placed bitmap.  Eight warps
// score and debit; a ninth, the scheduler, prepares the next attempt while
// they do: it holds a window of 32 walk entries in its lanes, finds the next
// unplaced one with one ballot, takes its demand and span (its span and its
// first 32 dimensions loaded a step ahead for the entry that follows, so an
// attempt after an attempt finds them in registers) and writes dem,
// dem - EPS and dem / cap for d = lane, lane + 32, ... straight into the
// slot it prepares, so any D is taken.  The scorers wait
// for each other at a named barrier after scoring; every scorer warp picks
// the node from the warps' results (first fit: one min-reduction of the
// warps' first feasible nodes; similarity: a shuffle tree); one block
// barrier per attempt hands the next task over.  A task the scheduler reads
// ahead is never the one being placed (a phase's walk holds each task
// once), and it never reads past its phase's walk while an attempt runs.

// warp 0 is the scheduler and warps 1..8 score, so the scheduler shares an
// issue slot with the scorers of nodes 3 and 7 (warp % 4), not with the
// scorer of node 0, which every attempt needs
constexpr int kWalkThreads = kThreads + 32;

struct Task {
    int u, s, e, own;
    double dn;
};

__device__ __forceinline__ void scorers_sync() {
    asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
}

__global__ void __launch_bounds__(kWalkThreads, 1)
two_phase_kernel(const int32_t* __restrict__ walk,
                 const int32_t* __restrict__ bounds,
                 const double* __restrict__ cap,
                 const double* __restrict__ dem_all,
                 const int32_t* __restrict__ start,
                 const int32_t* __restrict__ end,
                 const double* __restrict__ dn_all,
                 double* __restrict__ pool,
                 double quantum,
                 int32_t* __restrict__ out,
                 int P, int n, int K, int D, int rows, int n_smem,
                 int similarity, int sequential) {
    extern __shared__ double smem[];
    double* rows_s = smem;                                    // n_smem * K
    double* cx = smem + static_cast<int64_t>(n_smem) * K;     // D
    double* buf = cx + D;                  // 2 x (dem, thr, dq), D each
    uint32_t* placed = reinterpret_cast<uint32_t*>(buf + 6 * D);
    __shared__ double warp_key[kWarps];
    __shared__ int warp_j[kWarps];
    __shared__ Task task[2];
    __shared__ int sh_stop;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const bool scheduler = tid < 32;
    const int st = tid - 32;         // a scorer's thread index
    const int sw = st >> 5;          // a scorer's warp index
    const int words = (n + 31) >> 5;
    double* rows_g = pool + static_cast<int64_t>(blockIdx.x) * rows * K;
    int32_t* w_out = out;
    int32_t* bad_out = out + P;
    int32_t* steps_out = out + 2 * P;
    int32_t* phase_out = out + 3 * P;
    int32_t* node_out = phase_out + n;
    // slot k = k0 + i of a span (k0 = s * D) holds dimension i % D
    const int lane_d = lane % D, r32 = 32 % D;
    const int st_d = (st + D) % D, r_all = kThreads % D;

    if (tid == 0) sh_stop = 0;
    for (int i = tid; i < words; i += kWalkThreads) placed[i] = 0u;
    // every task this CTA can place starts unplaced: all of them when one
    // CTA walks every phase, else this phase's own tasks
    const int p_lo = sequential ? 0 : blockIdx.x;
    const int p_hi = sequential ? P : blockIdx.x + 1;
    if (sequential) {
        for (int u = tid; u < n; u += kWalkThreads) {
            phase_out[u] = -1;
            node_out[u] = -1;
        }
        // phases a stopped walk never reaches keep these
        for (int p = tid; p < P; p += kWalkThreads) {
            w_out[p] = 0;
            bad_out[p] = -1;
            steps_out[p] = 0;
        }
    } else {
        for (int i = bounds[3 * p_lo] + tid; i < bounds[3 * p_lo + 1];
             i += kWalkThreads) {
            phase_out[walk[i]] = -1;
            node_out[walk[i]] = -1;
        }
    }

    int cur = 0;  // which of the two task slots is current
    for (int p = p_lo; p < p_hi; ++p) {
        const int lo = bounds[3 * p];
        const int own_hi = bounds[3 * p + 1];
        const int hi = sequential ? bounds[3 * p + 2] : own_hi;
        __syncthreads();  // the last phase's readers are done with task[cur]
        for (int d = tid; d < D; d += kWalkThreads) cx[d] = cap[p * D + d];
        __syncthreads();

        // the scheduler's window: lane i holds walk[wbase + i] (-1 past
        // hi); the entries before wnext are consumed.  spec_* hold the
        // span and the demand of dimension ``lane`` (lane < D) of task
        // spec_u, loaded a step ahead.
        int wbase = lo, wnext = 0, wval = -1;
        int spec_u = -1, spec_s = 0, spec_e = 0;
        double spec_dn = 0.0, spec_dm = 0.0;
        bool any_own = false;  // an own task was scheduled in this phase

        // the scheduler: the next unplaced entry's task into slot ``slot``
        // (u = -1 at the end of the phase's walk), then the loads of the
        // entry after it
        auto advance = [&](int slot) {
            int u = -1, pos = 0;
            for (;;) {
                if (wnext >= 32) {
                    wbase += 32;
                    wnext = 0;
                    if (wbase >= hi) break;
                    wval = wbase + lane < hi ? walk[wbase + lane] : -1;
                }
                const bool open_entry = lane >= wnext && wval >= 0
                    && !((placed[wval >> 5] >> (wval & 31)) & 1u);
                const unsigned m = __ballot_sync(kAll, open_entry);
                if (m == 0u) {
                    wnext = 32;
                    continue;
                }
                const int f = __ffs(m) - 1;
                wnext = f + 1;
                pos = wbase + f;
                u = __shfl_sync(kAll, wval, f);
                // cross-fill with no node open: every attempt would miss
                if (pos >= own_hi && !any_own) u = -1;
                break;
            }
            double* b = buf + slot * 3 * D;
            if (u >= 0) {
                const bool hit = u == spec_u;
                any_own |= pos < own_hi;
                const double* du = dem_all + static_cast<int64_t>(u) * D;
                if (D <= 32) {  // one dimension per lane, as read ahead
                    if (lane < D) {
                        const double dm = hit ? spec_dm : du[lane];
                        b[lane] = dm;
                        b[D + lane] = dm - kEps;
                        b[2 * D + lane] = dm / cx[lane];
                    }
                } else {  // four dimensions' loads in flight at a time
                    for (int d0 = lane; d0 < D; d0 += 4 * 32) {
                        double dm[4];
#pragma unroll
                        for (int r = 0; r < 4; ++r) {
                            const int d = d0 + 32 * r;
                            dm[r] = d >= D ? 0.0
                                    : hit && d == lane ? spec_dm : du[d];
                        }
#pragma unroll
                        for (int r = 0; r < 4; ++r) {
                            const int d = d0 + 32 * r;
                            if (d < D) {
                                b[d] = dm[r];
                                b[D + d] = dm[r] - kEps;
                                b[2 * D + d] = dm[r] / cx[d];
                            }
                        }
                    }
                }
                if (lane == 0) {
                    task[slot].s = hit ? spec_s : start[u];
                    task[slot].e = hit ? spec_e : end[u];
                    task[slot].dn = hit ? spec_dn : dn_all[u];
                    task[slot].own = pos < own_hi;
                }
                if (wnext < 32) {
                    const int c = __shfl_sync(kAll, wval, wnext);
                    if (c >= 0) {
                        spec_u = c;
                        if (lane < D)
                            spec_dm = dem_all[static_cast<int64_t>(c) * D
                                              + lane];
                        spec_s = start[c];
                        spec_e = end[c];
                        spec_dn = dn_all[c];
                    }
                }
            }
            if (lane == 0) task[slot].u = u;
        };

        if (scheduler) {
            wval = lo + lane < hi ? walk[lo + lane] : -1;
            advance(cur);
        }
        __syncthreads();

        int w = 0, steps = 0;
        bool stop = false;
        for (;;) {
            const Task t = task[cur];
            if (t.u < 0) break;
            if (scheduler) {
                advance(cur ^ 1);
            } else {
                const double* dem = buf + cur * 3 * D;
                const double* thr = dem + D;
                const double* dq = dem + 2 * D;
                const int k0 = t.s * D;
                const int k1 = (t.e + 1) * D;
                double best;
                int best_j;
                const bool sim = similarity && t.own;
                warp_first_max(rows_s, rows_g, n_smem, K, D, w, k0, k1, thr,
                               dq, cx, t.dn, quantum, sim, sw, lane, lane_d,
                               r32, &best, &best_j);
                if (lane == 0) {
                    warp_key[sw] = best;
                    warp_j[sw] = best_j;
                }
                scorers_sync();

                // every scorer warp picks the same node; first fit keys
                // every feasible node 0, so its pick is the lowest j
                int j;
                if (sim) {
                    j = warp_pick(warp_key, warp_j, lane);
                } else {
                    const unsigned lo = __reduce_min_sync(
                        kAll, lane < kWarps ? static_cast<unsigned>(
                                                  warp_j[lane])
                                            : 0xffffffffu);
                    j = lo == static_cast<unsigned>(INT_MAX)
                        ? -1 : static_cast<int>(lo);
                }
                bool opened = false;
                ++steps;
                if (j < 0 && t.own) {
                    const bool unfit = exceeds(dem, cx, D);
                    if (unfit || w == rows) {
                        // a task its type cannot hold, or no row left to
                        // buy: the walk stops (-2 tells the host ``rows``
                        // was too small)
                        if (st == 0) {
                            bad_out[p] = unfit ? t.u : -2;
                            sh_stop = 1;
                        }
                    } else {
                        j = w++;
                        opened = true;
                    }
                }
                if (j >= 0) {
                    on_row(rows_s, rows_g, j, n_smem, K, [&](double* row) {
                        int d = st_d;
                        if (opened) {
                            for (int k = st; k < K; k += kThreads) {
                                double v = cx[d];
                                if (k >= k0 && k < k1) v -= dem[d];
                                row[k] = v;
                                d += r_all;
                                if (d >= D) d -= D;
                            }
                        } else {
                            for (int k = k0 + st; k < k1; k += kThreads) {
                                row[k] -= dem[d];
                                d += r_all;
                                if (d >= D) d -= D;
                            }
                        }
                    });
                    if (st == 0) {
                        phase_out[t.u] = p;
                        node_out[t.u] = j;
                        placed[t.u >> 5] |= 1u << (t.u & 31);
                    }
                }
            }
            __syncthreads();
            if (sh_stop) {
                stop = true;
                break;
            }
            cur ^= 1;
        }
        if (st == 0) {
            w_out[p] = w;
            steps_out[p] = steps;
            if (!stop) bad_out[p] = -1;
        }
        if (stop) break;
    }
}

// The floor of two_phase's serial chain: ``steps`` hand-overs of one value
// through shared memory, each behind one block barrier, by one CTA shaped
// as two_phase's (a scheduler warp and eight scorer warps).  At each step
// one thread, of another warp each time, writes what it read plus one, and
// every thread reads it after the barrier, so no step starts before the
// last one ended.  Every two_phase attempt makes at least this hand-over
// (the next task, after the last one's debit).  out[0] = steps.
__global__ void __launch_bounds__(kWalkThreads, 1)
barrier_chain_kernel(int steps, int32_t* __restrict__ out) {
    __shared__ int slot[2];
    int v = 0, who = 0;
    for (int i = 0; i < steps; ++i) {
        if (static_cast<int>(threadIdx.x) == who) slot[i & 1] = v + 1;
        __syncthreads();
        v = slot[i & 1];
        who += 33;
        if (who >= kWalkThreads) who -= kWalkThreads;
    }
    if (threadIdx.x == 0) out[0] = v;
}

// Shared-memory bytes a CTA of ``kernel`` may give to pool rows, when
// ``ctas`` CTAs must share each SM and ``fixed`` bytes of its dynamic shared
// memory hold other things.
cudaError_t row_budget(const void* kernel, int ctas, int64_t fixed,
                       int64_t* budget) {
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
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    // the CTAs that must share one SM for every CTA to run in one wave
    // split its shared memory (1 KB of each CTA's is reserved by the system)
    const int per_sm_ctas = std::min(8, std::max(1, (ctas + sms - 1) / sms));
    *budget = std::min<int64_t>(per_block, per_sm / per_sm_ctas - 1024)
        - static_cast<int64_t>(attr.sharedSizeBytes) - fixed;
    return cudaSuccess;
}

// Rows of K doubles that fit ``budget`` bytes, at most ``rows``.
int rows_in(int64_t budget, int K, int rows) {
    const int64_t row_bytes = static_cast<int64_t>(K) * 8;
    if (budget <= 0 || row_bytes <= 0) return 0;
    return static_cast<int>(std::max<int64_t>(
        0, std::min<int64_t>(rows, budget / row_bytes)));
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
    if (D <= 0) return static_cast<int>(cudaErrorInvalidValue);
    // thr, the two demand buffers, dq and cx: D doubles each
    const int64_t fixed = 5LL * D * 8;
    int64_t budget = 0;
    cudaError_t err = row_budget(reinterpret_cast<const void*>(
                                     place_step_kernel),
                                 A, fixed, &budget);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_smem = std::min(rows_in(budget, K, rows), n_cap);
    const size_t dyn = static_cast<size_t>(n_smem) * K * 8 + fixed;
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

// Launches one instance's two_phase placement over P phases (module notes
// above): one CTA when ``sequential`` (filling), else one per phase.
// ``pool`` holds (CTAs, rows, K) float64 rows for those past the
// shared-memory budget; a phase that would buy more than ``rows`` nodes
// stops with bad = -2 instead of writing past them.  The
// rows kept in shared memory are written to *smem_rows.  Returns
// cudaGetLastError().
extern "C" int two_phase_launch(const void* walk, const void* bounds,
                                const void* cap, const void* dem,
                                const void* start, const void* end,
                                const void* dn, void* pool, double quantum,
                                void* out, int P, int n, int K, int D,
                                int rows, int similarity, int sequential,
                                void* smem_rows, void* stream) {
    if (P <= 0) return 0;
    if (D <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const int ctas = sequential ? 1 : P;
    const int64_t fixed = 7LL * D * 8 + 4LL * ((n + 31) / 32);
    int64_t budget = 0;
    cudaError_t err = row_budget(reinterpret_cast<const void*>(
                                     two_phase_kernel),
                                 ctas, fixed, &budget);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (budget < 0) return static_cast<int>(cudaErrorInvalidValue);
    const int n_smem = rows_in(budget, K, rows);
    const size_t dyn = static_cast<size_t>(n_smem) * K * 8 + fixed;
    err = cudaFuncSetAttribute(two_phase_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dyn));
    if (err != cudaSuccess) return static_cast<int>(err);
    *static_cast<int*>(smem_rows) = n_smem;
    two_phase_kernel<<<ctas, kWalkThreads, dyn,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(walk), static_cast<const int32_t*>(bounds),
        static_cast<const double*>(cap), static_cast<const double*>(dem),
        static_cast<const int32_t*>(start), static_cast<const int32_t*>(end),
        static_cast<const double*>(dn), static_cast<double*>(pool), quantum,
        static_cast<int32_t*>(out), P, n, K, D, rows, n_smem, similarity,
        sequential);
    return static_cast<int>(cudaGetLastError());
}

// Launches the barrier chain (``barrier_chain_kernel``) on one CTA; out is
// one int32.  Returns cudaGetLastError().
extern "C" int barrier_chain_launch(int steps, void* out, void* stream) {
    barrier_chain_kernel<<<1, kWalkThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        steps, static_cast<int32_t*>(out));
    return static_cast<int>(cudaGetLastError());
}
