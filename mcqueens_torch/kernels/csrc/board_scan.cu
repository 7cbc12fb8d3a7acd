// Board Metropolis scan sampler for Hopper (sm_90a).
//
// No Pallas counterpart: the JAX package runs this sampler as one compiled
// XLA scan (mcqueens/chain/board.py:_step under run_segment), kernels
// "tables" and "naive".  Plain-torch twin:
// mcqueens_torch/chain/board.py:segment_reference.
//
// One thread per chain, one launch per segment: the thread loops over the
// segment's n_outer chunks of `stride` steps and writes the chain's energy
// after each chunk to its row of ys (n_outer, C).  Per step it draws, with
// JAX's threefry (threefry.cuh), key = fold_in(step_base, step), four keys
// split from it, the site (i, j) and height offset as three randints and
// the accept uniform: 18 threefry evaluations, ~1500 int32 operations,
// which bound the kernel rather than its bytes.  dE comes from
//   * "tables": the chain's line-count table, (T, C) int32 in global memory
//     with chains minor (like board_shared.cu's heights), 12 lookups each
//     at the old and the new cell, 24 updates on accept; or
//   * "naive" (table null): two O(N^2) conflict scans of the board.
// Both give the same integer, so both give the same trajectory.  A step
// that is inactive (the chain early-stopped, or the step is at or past
// n_steps) changes nothing and is skipped: every draw is keyed by (step
// base, step), so skipping needs no stream state.  An improvement copies the
// N*N board into the best board.  Boards are (N*N, C) int32, chains minor.
//
// Bitwise contract with the JAX scan and the twin: threefry in uint32_t, %
// and / only on non-negative operands, expf (not __expf), built with
// -fmad=false and without --use_fast_math; the per-step betas come from the
// wrapper (core/schedules.py:chunk_betas over the segment's steps).

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

using mcq::Key;

__global__ void __launch_bounds__(128) board_scan_kernel(
    int32_t* __restrict__ heights, int32_t* __restrict__ best_heights,
    int32_t* __restrict__ table, int32_t* __restrict__ energy,
    int32_t* __restrict__ best_energy, int32_t* __restrict__ best_step,
    int32_t* __restrict__ no_improve, int32_t* __restrict__ done,
    int32_t* __restrict__ stop_step, int32_t* __restrict__ accept_bins,
    int32_t* __restrict__ total_bins, const int32_t* __restrict__ step_base,
    const float* __restrict__ beta, int32_t* __restrict__ ys,
    int start_outer, int n_outer, int stride, int N, int C, int n_steps,
    int n_bins, int patience) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const size_t sC = (size_t)C;
  int32_t* const h = heights + c;  // cell x of this chain is h[x * sC]
  int32_t* const bh = best_heights + c;
  int32_t* const tab = table ? table + c : nullptr;
  const int NN = N * N;
  const Key sb = {(uint32_t)step_base[c], (uint32_t)step_base[sC + c]};
  int e = energy[c];
  int be = best_energy[c];
  int bs = best_step[c];
  int ni = no_improve[c];
  int dn = done[c];
  int st = stop_step[c];
  const int step0 = start_outer * stride;

  for (int o = 0; o < n_outer; ++o) {
    const int t_end = min((o + 1) * stride, n_steps - step0);
    for (int t = o * stride; t < t_end && !dn; ++t) {
      const int gstep = step0 + t;
      const Key key = mcq::hash(sb, (uint32_t)gstep);  // fold_in
      const int i = (int)mcq::randint(mcq::hash(key, 0u), (uint32_t)N);
      const int j = (int)mcq::randint(mcq::hash(key, 1u), (uint32_t)N);
      const int kr = (int)mcq::randint(mcq::hash(key, 2u), (uint32_t)(N - 1));
      const float u = mcq::uniform(mcq::hash(key, 3u));
      const int cell = i * N + j;
      const int old_k = h[(size_t)cell * sC];
      const int new_k = (old_k + 1 + kr) % N;

      int de = 0;
      int idx_old[13], idx_new[13];
      if (tab) {
        mcq::line_indices(i, j, old_k, N, false, idx_old);
        mcq::line_indices(i, j, new_k, N, false, idx_new);
        int old_sum = 0, new_sum = 0;
#pragma unroll
        for (int f = 0; f < 12; ++f) {
          old_sum += tab[(size_t)idx_old[f] * sC];
          new_sum += tab[(size_t)idx_new[f] * sC];
        }
        de = new_sum - (old_sum - 12);
      } else {
        for (int x = 0; x < NN; ++x) {
          if (x == cell) continue;
          const int di = x / N - i;
          const int dj = x % N - j;
          const int hk = h[(size_t)x * sC];
          de += mcq::attacks(di, dj, hk - new_k) - mcq::attacks(di, dj, hk - old_k);
        }
      }

      const bool accept = u < expf(-beta[t] * (float)de);
      if (accept) {
        h[(size_t)cell * sC] = new_k;
        if (tab) {
#pragma unroll
          for (int f = 0; f < 12; ++f) {
            tab[(size_t)idx_old[f] * sC] -= 1;
            tab[(size_t)idx_new[f] * sC] += 1;
          }
        }
        e += de;
      }
      if (accept && e < be) {
        be = e;
        bs = gstep + 1;
        ni = 0;
        for (int x = 0; x < NN; ++x) bh[(size_t)x * sC] = h[(size_t)x * sC];
      } else {
        ni += 1;
      }
      if (patience >= 0 && ni >= patience) {
        dn = 1;
        st = gstep;
      }
      const size_t b = (size_t)mcq::bin_of(gstep, n_bins, n_steps);
      accept_bins[b * sC + c] += accept ? 1 : 0;
      total_bins[b * sC + c] += 1;
    }
    ys[(size_t)o * sC + c] = e;
  }
  energy[c] = e;
  best_energy[c] = be;
  best_step[c] = bs;
  no_improve[c] = ni;
  done[c] = dn;
  stop_step[c] = st;
}

}  // namespace

// Launch one segment on `stream`; returns cudaGetLastError() (0 on success).
// All pointers are device pointers to contiguous arrays: heights and
// best_heights (N*N, C); table (T, C), or null for the naive kernel; energy
// .. stop_step (C); accept_bins, total_bins (n_bins, C); step_base (2, C)
// key words; beta (n_outer * stride) float32, the betas of steps
// start_outer * stride onwards; ys (n_outer, C).  patience < 0 disables
// early stopping.
extern "C" int mcq_board_scan_segment(
    void* heights, void* best_heights, void* table, void* energy,
    void* best_energy, void* best_step, void* no_improve, void* done,
    void* stop_step, void* accept_bins, void* total_bins,
    const void* step_base, const void* beta, void* ys, int start_outer,
    int n_outer, int stride, int N, int C, int n_steps, int n_bins,
    int patience, void* stream) {
  const int threads = 128;
  const int blocks = (C + threads - 1) / threads;
  board_scan_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (int32_t*)heights, (int32_t*)best_heights, (int32_t*)table,
      (int32_t*)energy, (int32_t*)best_energy, (int32_t*)best_step,
      (int32_t*)no_improve, (int32_t*)done, (int32_t*)stop_step,
      (int32_t*)accept_bins, (int32_t*)total_bins,
      (const int32_t*)step_base, (const float*)beta, (int32_t*)ys,
      start_outer, n_outer, stride, N, C, n_steps, n_bins, patience);
  return (int)cudaGetLastError();
}
