// Shared-site board Metropolis for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel mcqueens/kernels/board_shared.py:_kernel in
// all its modes: the main path (track_best, no freeze row), the tempered
// mode (a per-chain beta scale row), and the freeze mode with track_best off
// that recover_best_heights replays (a per-chain step horizon: chain c stops
// updating at step freeze[c], as the JAX kernel's `active &= gstep <
// freeze_row`).  With track_best off the best board is left as it is;
// best_energy, best_step and no_improve stay exact.
// Plain-torch twin: mcqueens_torch/kernels/board_shared.py:segment_reference.
//
// One thread per chain.  Chains [b*c_blk, (b+1)*c_blk) form semantic block
// b: they share each step's proposal site (i, j), hashed from the block's
// seed, while each chain draws its own new height and accept word from its
// own seed.  A move at (i, j) changes conflicts only on row i, column j and
// the two diagonals through (i, j), so dE sums O(4N) cells.
//
// What bounds it on the H100: memory traffic, not arithmetic.  Each proposal
// gathers up to 4(N-1) cells of the chain's board (~60 at N=16) and every
// improvement copies all N*N cells into the best board.  Boards are stored
// (N*N, C) int32 with chains minor, so the 32 threads of a warp (32 chains
// of one block, hence one site) read one cell index of 32 neighbouring
// chains: one 128-byte transaction per cell per warp.  At 32768 chains and
// N=16 the two boards take 64 MiB, heights alone 32 MiB, so the gathered
// heights mostly hit the 50 MB L2.  This first design keeps every per-chain
// scalar (energy, best energy, best step, patience counter, stop step) in
// registers for the whole chunk, issues the line loads independently of one
// another so many are in flight, copies the best board only on improvement
// (frequent early in an anneal, rare late), and read-modify-writes the
// accept/total bins in global memory each active step (coalesced).
//
// Bitwise contract with the JAX kernel and the twin: hash arithmetic in
// uint32_t (signed overflow is undefined in C++; int32 wrap-around is what
// the JAX kernel computes), % only on non-negative operands (C truncates
// where jnp floors), expf (not __expf), built with -fmad=false and without
// --use_fast_math.  The per-step betas come from the wrapper, which
// evaluates the schedule once per chunk for the kernel and the twin alike;
// a tempered chain multiplies its beta by its own scale in float32 before
// the exp, as the JAX kernel does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t lowbias32(uint32_t z) {
  z ^= z >> 16;
  z *= 0x7FEB352Du;
  z ^= z >> 15;
  z *= 0x846CA68Bu;
  z ^= z >> 16;
  return z;
}

// Net conflict change of one off-site cell of height hp at squared line
// offset d2 when the site's queen moves from old_k to new_k.
__device__ __forceinline__ int line_score(int hp, int old_k, int new_k,
                                          int d2) {
  const int dn = hp - new_k;
  const int dl = hp - old_k;
  return (dn == 0) - (dl == 0) + (dn * dn == d2) - (dl * dl == d2);
}

__global__ void __launch_bounds__(128) board_shared_kernel(
    int32_t* __restrict__ heights, int32_t* __restrict__ best_heights,
    int32_t* __restrict__ energy, int32_t* __restrict__ best_energy,
    int32_t* __restrict__ best_step, int32_t* __restrict__ no_improve,
    int32_t* __restrict__ stop_step, int32_t* __restrict__ accept_bins,
    int32_t* __restrict__ total_bins, const int32_t* __restrict__ chain_seeds,
    const int32_t* __restrict__ block_seeds, const float* __restrict__ beta,
    const float* __restrict__ beta_scale, const int32_t* __restrict__ freeze,
    int step0, int n_inner, int N, int C, int c_blk, int n_steps, int n_bins,
    int patience, int track_best) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  int st = stop_step[c];
  // Steps of a stopped chain, steps at or past n_steps and steps at or past
  // the chain's freeze horizon are inactive: they change no state and count
  // in no bin.
  int t_end = min(n_inner, n_steps - step0);
  if (freeze) t_end = min(t_end, freeze[c] - step0);
  if (st < n_steps || t_end <= 0) return;

  const size_t sC = (size_t)C;
  int32_t* const h = heights + c;  // cell x of this chain is h[x * sC]
  int32_t* const bh = best_heights + c;
  const int NN = N * N;
  const uint32_t site_base =
      (uint32_t)block_seeds[c / c_blk] * 0x2545F491u + 0x9E3779B9u;
  const uint32_t s = (uint32_t)chain_seeds[c];
  const uint32_t g = s * 0x85EBCA6Bu + lowbias32(s);
  const bool tempered = beta_scale != nullptr;
  const float scale = tempered ? beta_scale[c] : 1.0f;
  int e = energy[c];
  int be = best_energy[c];
  int bs = best_step[c];
  int ni = no_improve[c];

  for (int t = 0; t < t_end; ++t) {
    const int gstep = step0 + t;
    const uint32_t hv = lowbias32((uint32_t)gstep ^ site_base) & 0x7FFFFFFFu;
    const int cell = (int)(hv % (uint32_t)NN);
    const int i = cell / N;
    const int j = cell - i * N;
    const uint32_t base = lowbias32(g ^ ((uint32_t)gstep * 0x9E3779B9u));
    const uint32_t w0 = lowbias32(base ^ 0x68BC21EBu) & 0x7FFFFFFFu;
    const uint32_t w1 = lowbias32(base + 0x02E5BE93u);
    const int kr = (int)(w0 % (uint32_t)(N - 1));
    const float u = (float)((w1 >> 7) & 0xFFFFFFu) * (1.0f / 16777216.0f);
    const int old_k = h[(size_t)cell * sC];
    const int new_k = (old_k + 1 + kr) % N;

    int de = 0;
#pragma unroll 4
    for (int x = 0; x < N; ++x) {
      const int dj = x - j;  // offset along row i
      const int d = x - i;   // offset along column j and both diagonals
      if (dj != 0) {
        de += line_score(h[(size_t)(i * N + x) * sC], old_k, new_k, dj * dj);
      }
      if (d != 0) {
        const int d2 = d * d;
        de += line_score(h[(size_t)(x * N + j) * sC], old_k, new_k, d2);
        const int jd = j + d;
        if (jd >= 0 && jd < N) {
          de += line_score(h[(size_t)(x * N + jd) * sC], old_k, new_k, d2);
        }
        const int ja = j - d;
        if (ja >= 0 && ja < N) {
          de += line_score(h[(size_t)(x * N + ja) * sC], old_k, new_k, d2);
        }
      }
    }

    float bt = beta[t];
    if (tempered) bt = bt * scale;
    const bool accept = u < expf(-bt * (float)de);
    if (accept) {
      h[(size_t)cell * sC] = new_k;
      e += de;
    }
    if (accept && e < be) {
      be = e;
      bs = gstep + 1;
      ni = 0;
      if (track_best) {
        for (int x = 0; x < NN; ++x) bh[(size_t)x * sC] = h[(size_t)x * sC];
      }
    } else {
      ni += 1;
    }
    if (patience >= 0 && ni >= patience) st = gstep;
    // gstep < n_steps here and n_steps * n_bins < 2^31 (ChainSpec guard).
    const size_t b = (size_t)min(gstep * n_bins / n_steps, n_bins - 1);
    accept_bins[b * sC + c] += accept ? 1 : 0;
    total_bins[b * sC + c] += 1;
    if (st < n_steps) break;
  }
  energy[c] = e;
  best_energy[c] = be;
  best_step[c] = bs;
  no_improve[c] = ni;
  stop_step[c] = st;
}

}  // namespace

// Launch one chunk on `stream`; returns cudaGetLastError() (0 on success).
// All pointers are device pointers to contiguous arrays: heights and
// best_heights (N*N, C); energy .. stop_step, chain_seeds (C); accept_bins,
// total_bins (n_bins, C); block_seeds (C / c_blk); beta (n_inner) float32;
// beta_scale (C) float32, or null for an untempered run; freeze (C) int32
// step horizons, or null for none.  patience < 0 disables early stopping;
// track_best 0 leaves best_heights untouched.
extern "C" int mcq_board_shared_segment(
    void* heights, void* best_heights, void* energy, void* best_energy,
    void* best_step, void* no_improve, void* stop_step, void* accept_bins,
    void* total_bins, const void* chain_seeds, const void* block_seeds,
    const void* beta, const void* beta_scale, const void* freeze, int step0,
    int n_inner, int N, int C, int c_blk, int n_steps, int n_bins,
    int patience, int track_best, void* stream) {
  const int threads = 128;
  const int blocks = (C + threads - 1) / threads;
  board_shared_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (int32_t*)heights, (int32_t*)best_heights, (int32_t*)energy,
      (int32_t*)best_energy, (int32_t*)best_step, (int32_t*)no_improve,
      (int32_t*)stop_step, (int32_t*)accept_bins, (int32_t*)total_bins,
      (const int32_t*)chain_seeds, (const int32_t*)block_seeds,
      (const float*)beta, (const float*)beta_scale, (const int32_t*)freeze,
      step0, n_inner, N, C, c_blk, n_steps, n_bins, patience, track_best);
  return (int)cudaGetLastError();
}
