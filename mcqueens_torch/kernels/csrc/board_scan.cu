// Board Metropolis scan sampler for Hopper (sm_90a).
//
// No Pallas counterpart: the JAX package runs this sampler as one compiled
// XLA scan (mcqueens/chain/board.py:_step under run_segment), kernels
// "tables" and "naive".  Plain-torch twin:
// mcqueens_torch/chain/board.py:segment_reference.
//
// Per step a chain draws, with JAX's threefry (threefry.cuh), key =
// fold_in(step_base, step), four keys split from it, the site (i, j) and
// height offset as three randints and the accept uniform: 18 threefry
// evaluations, ~1380 int32 operations.  dE comes from
//   * "tables": the chain's line-count table, 12 lookups each at the old
//     and the new cell, 24 updates on accept; or
//   * "naive": two O(N^2) conflict scans of the board.
// Both give the same integer, so both give the same trajectory.  A chain
// is a serial walk, so what bounds a launch is the latency of one step's
// dependent chain, not bytes or the card's int32 rate.
//
// Design: a warp per chain, one launch per segment.
//   * Draws ahead.  No draw depends on the chain's state (every key is
//     (step base, step)), and neither does the step's beta or bin.  So the
//     lanes compute 32 steps at once, lane l step t + l, and the serial walk
//     takes each step's site, offset, uniform, beta and bin from its lane
//     with __shfl_sync: the 18 hashes leave the chain's critical path.  A
//     batch may run past the segment, past n_steps or past the step at
//     which the chain stops; those draws are never used.
//   * The serial step across lanes.  Lane f < 12 owns line family f
//     (mcq::line_form): it loads the family's old and new count, the warp
//     sums new - old with __reduce_add_sync, and on accept lane f stores
//     both words.  The 24 words are distinct (every family's index involves
//     k) and each family is only ever touched by its own lane, so nothing
//     needs an atomic or a barrier.  Every lane stores the new height (the
//     same word), so every lane reads its own stores.  "naive" splits the
//     N^2 - 1 other cells over the lanes and reduces the same way.
//   * One step ahead.  While a step's accept test runs, the warp already
//     takes the next step's draws and reads its old height and (tables) its
//     24 words; if the step is accepted, a next site on the same cell is
//     read again and a word the step stored is taken from the registers.
//     So the critical path of a step is the reduce, the expf and the compare
//     (the ys row of a chunk is kept by the lane of its last step and
//     written after the batch).
//   * State in shared memory.  A block of chains_per_block warps copies its
//     chains' columns of heights, best_heights and table into shared memory
//     at the start (neighbouring chains, so a load reads their words of one
//     sector together) and back at the end; an improvement copies the N^2
//     board from shared to shared.  When a chain's 2 N^2 (+ T) words do not
//     fit a block's shared memory (tables above N = 42), the SMEM = false
//     instance walks the same code on the chains-minor device arrays: a
//     template parameter the wrapper picks from N (chain/board.py:
//     scan_layout), not a fallback.
//   * Bookkeeping in registers.  energy, best, no_improve, done and
//     stop_step live in registers; a step's bin is monotone in the step, so
//     accepts and totals are counted in registers and added to the bins
//     when the bin changes and at the end; the rows of the chunks not ended
//     by a step taken (after an early stop, or past n_steps) are written
//     after the walk.
//
// Bitwise contract with the JAX scan and the twin: threefry in uint32_t, %
// and / only on non-negative operands, expf (not __expf), built with
// -fmad=false and without --use_fast_math, bins by mcq::bin_of, best_step =
// step + 1, the stop at the step patience is reached; the per-step betas
// come from the wrapper (core/schedules.py:chunk_betas over the segment's
// steps).  Boards are (N*N, C) int32 and tables (T, C), chains minor.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

using mcq::Key;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxChainsPerBlock = 8;

struct Args {
  int32_t *heights, *best_heights, *table, *energy, *best_energy, *best_step,
      *no_improve, *done, *stop_step, *accept_bins, *total_bins;
  const int32_t* step_base;
  const float* beta;
  int32_t* ys;
  int start_outer, n_outer, stride, N, C, n_steps, n_bins, patience;
};

// One step's draws, site and heights, and (tables, lane f < 12) family f's
// two table words and their counts.
struct Step {
  int i, j, kr, bin, cell, base, old_k, new_k, io, in, to, tn;
  float u, b;
};

// One chain's segment, walked by one warp.  h, bh and tab point at the
// chain's first word and s is the distance between its words: 1 in shared
// memory, C in the chains-minor device arrays.
template <bool TABLES>
__device__ __forceinline__ void walk(const Args& a, int c, int lane,
                                     int32_t* h, int32_t* bh, int32_t* tab,
                                     size_t s) {
  const int N = a.N, NN = N * N;
  const size_t sC = (size_t)a.C;
  const Key sb = {(uint32_t)a.step_base[c], (uint32_t)a.step_base[sC + c]};
  int e = a.energy[c];
  int be = a.best_energy[c];
  int bs = a.best_step[c];
  int ni = a.no_improve[c];
  int dn = a.done[c];
  int st = a.stop_step[c];
  const int step0 = a.start_outer * a.stride;
  // Steps this launch may take: t in [0, total), chunk o = t / stride.
  const int total = min(a.n_outer * a.stride, a.n_steps - step0);

  mcq::LineForm lf = {0, 0, 0, 0};
  if (TABLES && lane < 12) lf = mcq::line_form(lane, N);
  // naive: lane's cells x = lane + 32 m as (row, column), advanced without
  // a division.
  const int r0 = lane / N, q0 = lane % N, dr = 32 / N, dq = 32 % N;

  // A step's heights from its old one, and family f's words at both ends.
  auto heights = [&](Step& p, int old_k) {
    p.old_k = old_k;
    // (old_k + 1 + kr) % N with 0 <= old_k < N and 0 <= kr <= N - 2
    p.new_k = old_k + 1 + p.kr;
    if (p.new_k >= N) p.new_k -= N;
    if (TABLES && lane < 12) {
      p.io = p.base + lf.ck * p.old_k;
      p.in = p.base + lf.ck * p.new_k;
      p.to = tab[(size_t)p.io * s];
      p.tn = tab[(size_t)p.in * s];
    }
  };

  int cur_bin = -1, n_acc = 0, n_tot = 0;
  int taken = 0;  // steps taken so far

  for (int tb = 0; tb < total && !dn; tb += 32) {
    // Draws of steps tb .. tb + 31, one a lane.
    const int tl = tb + lane;
    int di = 0, dj = 0, dk = 0, dbin = 0;
    float du = 0.0f, dbeta = 0.0f;
    if (tl < total) {
      const Key key = mcq::hash(sb, (uint32_t)(step0 + tl));  // fold_in
      di = (int)mcq::randint(mcq::hash(key, 0u), (uint32_t)N);
      dj = (int)mcq::randint(mcq::hash(key, 1u), (uint32_t)N);
      dk = (int)mcq::randint(mcq::hash(key, 2u), (uint32_t)(N - 1));
      du = mcq::uniform(mcq::hash(key, 3u));
      dbeta = a.beta[tl];
      dbin = mcq::bin_of(step0 + tl, a.n_bins, a.n_steps);
    }
    // Step q of the batch from lane q, its heights and words read from the
    // current state.  Lanes past the segment drew zeros: a valid cell.
    auto fetch = [&](int q) {
      Step p;
      p.i = __shfl_sync(kFull, di, q);
      p.j = __shfl_sync(kFull, dj, q);
      p.kr = __shfl_sync(kFull, dk, q);
      p.u = __shfl_sync(kFull, du, q);
      p.b = __shfl_sync(kFull, dbeta, q);
      p.bin = __shfl_sync(kFull, dbin, q);
      p.cell = p.i * N + p.j;
      p.base = lf.base + lf.ci * p.i + lf.cj * p.j;
      p.io = p.in = p.to = p.tn = 0;
      heights(p, h[(size_t)p.cell * s]);
      return p;
    };
    const int n = min(32, total - tb);
    Step p = fetch(0);
    int ye = e;  // lane l: the energy after step tb + l
    int q = 0;
    while (q < n) {
      const int gstep = step0 + tb + q;
      int v = 0;
      if (TABLES) {
        v = p.tn - p.to;  // 0 on lanes 12..31
      } else {
        int r = r0, q2 = q0;
        for (int x = lane; x < NN; x += 32) {
          if (x != p.cell) {
            const int hk = h[(size_t)x * s];
            v += mcq::attacks(r - p.i, q2 - p.j, hk - p.new_k) -
                 mcq::attacks(r - p.i, q2 - p.j, hk - p.old_k);
          }
          r += dr;
          q2 += dq;
          if (q2 >= N) {
            q2 -= N;
            r += 1;
          }
        }
      }
      // tables: new_sum - (old_sum - 12), the old cell counted once a line
      const int de = __reduce_add_sync(kFull, v) + (TABLES ? 12 : 0);
      // The next step, read while this one's accept test runs: before this
      // step's stores, so it is fixed below where they changed its words.
      Step nx = fetch((q + 1) & 31);

      const bool accept = p.u < expf(-p.b * (float)de);
      if (accept) {
        h[(size_t)p.cell * s] = p.new_k;
        if (TABLES && lane < 12) {
          tab[(size_t)p.io * s] = p.to - 1;
          tab[(size_t)p.in * s] = p.tn + 1;
        }
        e += de;
        if (nx.cell == p.cell) {
          heights(nx, p.new_k);  // the site moved: read its words again
        } else if (TABLES && lane < 12) {
          // family f's words of both steps are lane f's alone
          nx.to = nx.io == p.io ? p.to - 1 : nx.io == p.in ? p.tn + 1 : nx.to;
          nx.tn = nx.in == p.io ? p.to - 1 : nx.in == p.in ? p.tn + 1 : nx.tn;
        }
      }
      if (accept && e < be) {
        be = e;
        bs = gstep + 1;
        ni = 0;
        for (int x = lane; x < NN; x += 32) bh[(size_t)x * s] = h[(size_t)x * s];
      } else {
        ni += 1;
      }
      if (a.patience >= 0 && ni >= a.patience) {
        dn = 1;
        st = gstep;
      }
      if (p.bin != cur_bin) {
        if (n_tot && lane == 0) {
          a.accept_bins[(size_t)cur_bin * sC + c] += n_acc;
          a.total_bins[(size_t)cur_bin * sC + c] += n_tot;
        }
        cur_bin = p.bin;
        n_acc = 0;
        n_tot = 0;
      }
      n_acc += accept ? 1 : 0;
      n_tot += 1;
      ye = lane == q ? e : ye;
      p = nx;
      ++q;
      if (dn) break;
    }
    taken = tb + q;
    // The rows of the chunks that ended at a step of this batch.
    const int end = tl + 1;
    if (lane < q && end % a.stride == 0) {
      a.ys[(size_t)(end / a.stride - 1) * sC + c] = ye;
    }
  }
  if (n_tot && lane == 0) {
    a.accept_bins[(size_t)cur_bin * sC + c] += n_acc;
    a.total_bins[(size_t)cur_bin * sC + c] += n_tot;
  }
  // The chunks not ended by a step taken (after an early stop, or past
  // n_steps) keep the last energy.
  for (int r = taken / a.stride + lane; r < a.n_outer; r += 32) {
    a.ys[(size_t)r * sC + c] = e;
  }
  if (lane == 0) {
    a.energy[c] = e;
    a.best_energy[c] = be;
    a.best_step[c] = bs;
    a.no_improve[c] = ni;
    a.done[c] = dn;
    a.stop_step[c] = st;
  }
}

// Copy `rows` words of each of the block's chains between a chains-minor
// device array and the chains' shared-memory slots (W words apart, from
// word `at` of each slot), neighbouring threads on neighbouring chains.
__device__ __forceinline__ void copy_columns(int32_t* sm, int32_t* g,
                                             int rows, int W, int at, int c0,
                                             int cpb, size_t sC, int C,
                                             bool to_shared) {
  for (int idx = threadIdx.x; idx < rows * cpb; idx += blockDim.x) {
    const int x = idx / cpb, w = idx - x * cpb;
    if (c0 + w < C) {
      int32_t* p = sm + (size_t)w * W + at + x;
      int32_t* q = g + (size_t)x * sC + c0 + w;
      if (to_shared) {
        *p = *q;
      } else {
        *q = *p;
      }
    }
  }
}

template <bool SMEM, bool TABLES>
__global__ void __launch_bounds__(32 * kMaxChainsPerBlock)
    board_scan_kernel(Args a, int cpb) {
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * cpb, c = c0 + warp;
  const int NN = a.N * a.N;
  const size_t sC = (size_t)a.C;
  if (!SMEM) {
    if (c < a.C) {
      walk<TABLES>(a, c, lane, a.heights + c, a.best_heights + c,
                   TABLES ? a.table + c : nullptr, sC);
    }
    return;
  }
  const int T = TABLES ? (int)mcq::table_words(a.N, false) : 0;
  const int W = 2 * NN + T;  // a chain's slot: heights, best, table
  copy_columns(smem, a.heights, NN, W, 0, c0, cpb, sC, a.C, true);
  copy_columns(smem, a.best_heights, NN, W, NN, c0, cpb, sC, a.C, true);
  if (TABLES) copy_columns(smem, a.table, T, W, 2 * NN, c0, cpb, sC, a.C, true);
  __syncthreads();
  if (c < a.C) {
    int32_t* slot = smem + (size_t)warp * W;
    walk<TABLES>(a, c, lane, slot, slot + NN, slot + 2 * NN, 1);
  }
  __syncthreads();
  copy_columns(smem, a.heights, NN, W, 0, c0, cpb, sC, a.C, false);
  copy_columns(smem, a.best_heights, NN, W, NN, c0, cpb, sC, a.C, false);
  if (TABLES) copy_columns(smem, a.table, T, W, 2 * NN, c0, cpb, sC, a.C, false);
}

template <bool SMEM, bool TABLES>
int launch(const Args& a, int cpb, int smem, cudaStream_t stream) {
  const auto kernel = board_scan_kernel<SMEM, TABLES>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (a.C + cpb - 1) / cpb;
  kernel<<<blocks, 32 * cpb, smem, stream>>>(a, cpb);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch one segment on `stream`; returns cudaGetLastError() (0 on success).
// All pointers are device pointers to contiguous arrays: heights and
// best_heights (N*N, C); table (T, C), or null for the naive kernel; energy
// .. stop_step (C); accept_bins, total_bins (n_bins, C); step_base (2, C)
// key words; beta (n_outer * stride) float32, the betas of steps
// start_outer * stride onwards; ys (n_outer, C).  patience < 0 disables
// early stopping.  chains_per_block (1..8) warps a block, one a chain;
// smem_bytes the block's shared memory: 4 * chains_per_block * (2 N^2 + T)
// to keep the chains there (T = 0 for naive), or 0 to walk them in device
// memory.  Anything else returns cudaErrorInvalidValue.
extern "C" int mcq_board_scan_segment(
    void* heights, void* best_heights, void* table, void* energy,
    void* best_energy, void* best_step, void* no_improve, void* done,
    void* stop_step, void* accept_bins, void* total_bins,
    const void* step_base, const void* beta, void* ys, int start_outer,
    int n_outer, int stride, int N, int C, int n_steps, int n_bins,
    int patience, int chains_per_block, int smem_bytes, void* stream) {
  const Args a = {(int32_t*)heights, (int32_t*)best_heights,
                  (int32_t*)table, (int32_t*)energy, (int32_t*)best_energy,
                  (int32_t*)best_step, (int32_t*)no_improve, (int32_t*)done,
                  (int32_t*)stop_step, (int32_t*)accept_bins,
                  (int32_t*)total_bins, (const int32_t*)step_base,
                  (const float*)beta, (int32_t*)ys, start_outer, n_outer,
                  stride, N, C, n_steps, n_bins, patience};
  const int cpb = chains_per_block;
  const bool tables = table != nullptr;
  const long long words =
      2LL * N * N + (tables ? mcq::table_words(N, false) : 0);
  if (cpb < 1 || cpb > kMaxChainsPerBlock ||
      (smem_bytes != 0 && smem_bytes != 4 * cpb * words)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (smem_bytes == 0) {
    return tables ? launch<false, true>(a, cpb, 0, s)
                  : launch<false, false>(a, cpb, 0, s);
  }
  return tables ? launch<true, true>(a, cpb, smem_bytes, s)
                : launch<true, false>(a, cpb, smem_bytes, s);
}
