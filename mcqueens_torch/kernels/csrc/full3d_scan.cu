// Full-3D Metropolis scan sampler for Hopper (sm_90a).
//
// No Pallas counterpart: the JAX package runs this sampler as one compiled
// XLA scan (mcqueens/chain/full3d.py:_step under run_segment), kernels
// "tables" and "naive".  Plain-torch twin:
// mcqueens_torch/chain/full3d.py:segment_reference.
//
// Same design as board_scan.cu: one thread per chain, one launch per
// segment, ys rows written after each chunk, inactive steps skipped.  Per
// step, with JAX's threefry (threefry.cuh): key = fold_in(step_base, step),
// (k_q, k_cell, k_u) = split(key, 3), the mover randint(k_q, Q), a uniform
// unoccupied cell by exact rejection sampling (k, sub = split(k); cell =
// randint(sub, N^3); repeat while occupied: the per-chain form of JAX's
// batched lax.while_loop, full3d.py:_draw_unoccupied) and u = uniform(k_u).
// The occupancy cube is (N^3, C) uint8, chains minor, so the "occupied?"
// test is one byte load.  dE comes from
//   * "tables": the 13-family line-count table (T13, C) in global memory,
//     new lines' counts minus attack(old, new) (the mover still sits on
//     the old cell) minus (old lines' counts - 13); on accept 26 updates,
//     which overlap when the old cell attacks the new one and then
//     accumulate; or
//   * "naive" (table null): two O(Q) conflict scans over the other queens.
// Queens are (3Q, C) int32 (row 3q + axis); an improvement copies them into
// the best queens.
//
// Bitwise contract with the JAX scan and the twin: as board_scan.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

using mcq::Key;

__global__ void __launch_bounds__(128) full3d_scan_kernel(
    int32_t* __restrict__ queens, int32_t* __restrict__ best_queens,
    uint8_t* __restrict__ occ, int32_t* __restrict__ table,
    int32_t* __restrict__ energy, int32_t* __restrict__ best_energy,
    int32_t* __restrict__ best_step, int32_t* __restrict__ no_improve,
    int32_t* __restrict__ done, int32_t* __restrict__ stop_step,
    int32_t* __restrict__ accept_bins, int32_t* __restrict__ total_bins,
    const int32_t* __restrict__ step_base, const float* __restrict__ beta,
    int32_t* __restrict__ ys, int start_outer, int n_outer, int stride,
    int N, int Q, int C, int n_steps, int n_bins, int patience) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const size_t sC = (size_t)C;
  int32_t* const qs = queens + c;  // axis a of queen q is qs[(3q+a) * sC]
  int32_t* const bq = best_queens + c;
  uint8_t* const oc = occ + c;
  int32_t* const tab = table ? table + c : nullptr;
  const int NN = N * N;
  const uint32_t N3 = (uint32_t)(NN * N);
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
      const int q = (int)mcq::randint(mcq::hash(key, 0u), (uint32_t)Q);
      const Key k_cell = mcq::hash(key, 1u);
      const float u = mcq::uniform(mcq::hash(key, 2u));
      Key k = mcq::hash(k_cell, 0u);
      int cell = (int)mcq::randint(mcq::hash(k_cell, 1u), N3);
      while (oc[(size_t)cell * sC]) {
        const Key sub = mcq::hash(k, 1u);
        k = mcq::hash(k, 0u);
        cell = (int)mcq::randint(sub, N3);
      }
      const int ni_ = cell / NN, nj = (cell / N) % N, nk = cell % N;
      const int oi = qs[(size_t)(3 * q) * sC];
      const int oj = qs[(size_t)(3 * q + 1) * sC];
      const int ok = qs[(size_t)(3 * q + 2) * sC];

      int de = 0;
      int idx_old[13], idx_new[13];
      if (tab) {
        mcq::line_indices(oi, oj, ok, N, true, idx_old);
        mcq::line_indices(ni_, nj, nk, N, true, idx_new);
        int old_sum = 0, new_sum = 0;
#pragma unroll
        for (int f = 0; f < 13; ++f) {
          old_sum += tab[(size_t)idx_old[f] * sC];
          new_sum += tab[(size_t)idx_new[f] * sC];
        }
        const int oan = mcq::attacks(oi - ni_, oj - nj, ok - nk);
        de = (new_sum - oan) - (old_sum - 13);
      } else {
        for (int p = 0; p < Q; ++p) {
          if (p == q) continue;
          const int pi = qs[(size_t)(3 * p) * sC];
          const int pj = qs[(size_t)(3 * p + 1) * sC];
          const int pk = qs[(size_t)(3 * p + 2) * sC];
          de += mcq::attacks(pi - ni_, pj - nj, pk - nk)
              - mcq::attacks(pi - oi, pj - oj, pk - ok);
        }
      }

      const bool accept = u < expf(-beta[t] * (float)de);
      if (accept) {
        qs[(size_t)(3 * q) * sC] = ni_;
        qs[(size_t)(3 * q + 1) * sC] = nj;
        qs[(size_t)(3 * q + 2) * sC] = nk;
        oc[(size_t)((oi * N + oj) * N + ok) * sC] = 0;
        oc[(size_t)cell * sC] = 1;
        if (tab) {
#pragma unroll
          for (int f = 0; f < 13; ++f) {
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
        for (int x = 0; x < 3 * Q; ++x) bq[(size_t)x * sC] = qs[(size_t)x * sC];
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
// All pointers are device pointers to contiguous arrays: queens and
// best_queens (3Q, C) int32; occ (N^3, C) uint8; table (T13, C), or null for
// the naive kernel; energy .. stop_step (C); accept_bins, total_bins
// (n_bins, C); step_base (2, C) key words; beta (n_outer * stride) float32;
// ys (n_outer, C).  Requires 1 <= Q < N^3 (a free cell exists).  patience
// < 0 disables early stopping.
extern "C" int mcq_full3d_scan_segment(
    void* queens, void* best_queens, void* occ, void* table, void* energy,
    void* best_energy, void* best_step, void* no_improve, void* done,
    void* stop_step, void* accept_bins, void* total_bins,
    const void* step_base, const void* beta, void* ys, int start_outer,
    int n_outer, int stride, int N, int Q, int C, int n_steps, int n_bins,
    int patience, void* stream) {
  if (Q < 1 || Q >= N * N * N) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (C + threads - 1) / threads;
  full3d_scan_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (int32_t*)queens, (int32_t*)best_queens, (uint8_t*)occ,
      (int32_t*)table, (int32_t*)energy, (int32_t*)best_energy,
      (int32_t*)best_step, (int32_t*)no_improve, (int32_t*)done,
      (int32_t*)stop_step, (int32_t*)accept_bins, (int32_t*)total_bins,
      (const int32_t*)step_base, (const float*)beta, (int32_t*)ys,
      start_outer, n_outer, stride, N, Q, C, n_steps, n_bins, patience);
  return (int)cudaGetLastError();
}
