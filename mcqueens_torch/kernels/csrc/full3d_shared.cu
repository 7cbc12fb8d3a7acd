// Shared-site full-3D Metropolis for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel mcqueens/kernels/full3d_shared.py:_kernel,
// plain and tempered (a per-chain beta scale).  Plain-torch twin:
// mcqueens_torch/kernels/full3d_shared.py:segment_reference.
//
// One thread per chain over (Q, C) coordinate planes with chains minor, so
// a warp reads one queen row of 32 chains per coalesced load.  Chains
// [b*c_blk, (b+1)*c_blk) form semantic block b: they share each step's
// candidate cell (hashed from the block seed and the step) and each 8-step
// chunk's mover queen (hashed from the block seed and the chunk's first
// step).  Blocks hold whole multiples of 128 chains, so a CUDA block of 32
// threads lies inside one semantic block and every loop over queens is
// uniform across the warp.
//
// Design: one fused pass per mover chunk, as the TPU kernel does.  All
// queens but the mover stay put for the whole chunk, so one walk over the
// other Q-1 queens scores each of them against the chunk's (up to) 8
// candidates and the mover's cell at the chunk start: 9 attack counts plus
// an 8-bit occupancy mask, each queen row loaded once.  The chunk's steps
// then run from registers: dE = conf[k] - old_conf; an occupied candidate
// (another queen there, or the live mover) makes the step lazy; on accept
// the mover moves and old_conf <- conf[k].  At the chunk end the mover's
// live cell is written back, and a chain that improved copies the planes
// into its best planes with the mover row set to where it stood at its
// last improvement (exact: nothing else moved).  The TPU kernel's pad rows,
// pltpu.roll row reads, stale-plane algebra and group-amortized reverts
// were Mosaic workarounds and have no counterpart here.
//
// What bounds it on the H100: int32 ALU throughput, not memory.  Per chunk
// each chain reads its 3Q coordinates once (2.7 KB at Q=225) and does ~20
// int32 ops per (queen, target) pair: 9 x 225 x 20 ~ 40k ops per 8 steps.  At
// 65536 chains the planes (177 MB) stream from HBM once per chunk, ~1/3 of
// the time the int32 pipes need for the arithmetic.  The design keeps the
// arithmetic at the TPU kernel's count (one pass per chunk, not per step),
// keeps all per-chain scalars and the 8 candidates in registers, and
// accumulates the accept/total bins in registers until the bin changes.
//
// Bitwise contract with the JAX kernel and the twin: hash arithmetic in
// uint32_t (int32 wrap-around is what the JAX kernel computes; signed
// overflow is undefined in C++), % only on non-negative operands, expf (not
// __expf), built with -fmad=false and without --use_fast_math.  The per-step
// betas come from the wrapper, which evaluates the schedule once per launch
// for the kernel and the twin alike; a tempered chain multiplies its beta by
// its own scale in float32 before the exp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHold = 8;

__device__ __forceinline__ uint32_t lowbias32(uint32_t z) {
  z ^= z >> 16;
  z *= 0x7FEB352Du;
  z ^= z >> 15;
  z *= 0x846CA68Bu;
  z ^= z >> 16;
  return z;
}

// 1 iff two cells at distance (dx, dy, dz) attack: every nonzero |d| equals
// the largest (also 1 at distance 0, which the caller treats as occupied).
__device__ __forceinline__ int attacks(int dx, int dy, int dz) {
  const int a = abs(dx), b = abs(dy), c = abs(dz);
  const int m = max(a, max(b, c));
  return ((a == 0) | (a == m)) & ((b == 0) | (b == m)) & ((c == 0) | (c == m));
}

__global__ void __launch_bounds__(32) full3d_shared_kernel(
    int32_t* __restrict__ qi, int32_t* __restrict__ qj,
    int32_t* __restrict__ qk, int32_t* __restrict__ bqi,
    int32_t* __restrict__ bqj, int32_t* __restrict__ bqk,
    int32_t* __restrict__ energy, int32_t* __restrict__ best_energy,
    int32_t* __restrict__ best_step, int32_t* __restrict__ no_improve,
    int32_t* __restrict__ stop_step, int32_t* __restrict__ accept_bins,
    int32_t* __restrict__ total_bins, const int32_t* __restrict__ chain_seeds,
    const int32_t* __restrict__ block_seeds, const float* __restrict__ beta,
    const float* __restrict__ beta_scale, int step0, int n_inner, int N,
    int Q, int C, int c_blk, int n_steps, int n_bins, int patience) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  int st = stop_step[c];
  // Steps of a stopped chain, and steps at or past n_steps, are inactive:
  // they change no state and count in no bin.
  const int t_end = min(n_inner, n_steps - step0);
  if (st < n_steps || t_end <= 0) return;

  const size_t sC = (size_t)C;
  int32_t* const pi = qi + c;  // queen r of this chain is pi[r * sC]
  int32_t* const pj = qj + c;
  int32_t* const pk = qk + c;
  const int NN = N * N;
  const int N3 = NN * N;
  const uint32_t seed = (uint32_t)block_seeds[c / c_blk];
  const uint32_t cand_base = seed * 0x2545F491u + 0x7F4A7C15u;
  const uint32_t mover_base = seed * 0x2545F491u + 0x3C6EF372u;
  const uint32_t s = (uint32_t)chain_seeds[c];
  const uint32_t g = s * 0x85EBCA6Bu + lowbias32(s);
  const bool tempered = beta_scale != nullptr;
  const float scale = tempered ? beta_scale[c] : 1.0f;
  int e = energy[c];
  int be = best_energy[c];
  int bs = best_step[c];
  int ni = no_improve[c];
  int bin = -1, acc_a = 0, acc_t = 0;  // counts of the current bin

  for (int t0 = 0; t0 < t_end; t0 += kHold) {
    const int g0 = step0 + t0;
    const int len = min(kHold, t_end - t0);
    const int mover = (int)((lowbias32((uint32_t)g0 ^ mover_base) &
                             0x7FFFFFFFu) % (uint32_t)Q);
    int ox = pi[(size_t)mover * sC];
    int oy = pj[(size_t)mover * sC];
    int oz = pk[(size_t)mover * sC];
    int cx[kHold], cy[kHold], cz[kHold], conf[kHold];
#pragma unroll
    for (int k = 0; k < kHold; ++k) {
      const uint32_t hv =
          lowbias32(((uint32_t)g0 + k) ^ cand_base) & 0x7FFFFFFFu;
      const int cand = (int)(hv % (uint32_t)N3);
      cx[k] = cand / NN;
      cy[k] = (cand / N) % N;
      cz[k] = cand % N;
      conf[k] = 0;
    }

    // The fused pass: every other queen against the 8 candidates and the
    // mover's chunk-start cell.  (Candidates past len are scored too and
    // never read.)
    int old_conf = 0;
    unsigned occupied = 0;
    for (int r = 0; r < Q; ++r) {
      if (r == mover) continue;
      const int x = pi[(size_t)r * sC];
      const int y = pj[(size_t)r * sC];
      const int z = pk[(size_t)r * sC];
      old_conf += attacks(x - ox, y - oy, z - oz);
#pragma unroll
      for (int k = 0; k < kHold; ++k) {
        const int dx = x - cx[k], dy = y - cy[k], dz = z - cz[k];
        conf[k] += attacks(dx, dy, dz);
        occupied |= (unsigned)((dx | dy | dz) == 0) << k;
      }
    }

    bool improved_here = false;
    int bx = ox, by = oy, bz = oz;
#pragma unroll
    for (int k = 0; k < kHold; ++k) {
      if (k < len && st >= n_steps) {
        const int gstep = g0 + k;
        const uint32_t base = lowbias32(g ^ ((uint32_t)gstep * 0x9E3779B9u));
        const uint32_t w1 = lowbias32(base + 0x02E5BE93u);
        const float u = (float)((w1 >> 7) & 0xFFFFFFu) * (1.0f / 16777216.0f);
        const bool lazy = ((occupied >> k) & 1u) ||
                          (ox == cx[k] && oy == cy[k] && oz == cz[k]);
        const int de = conf[k] - old_conf;
        float b = beta[t0 + k];
        if (tempered) b = b * scale;
        const bool upd = !lazy && u < expf(-b * (float)de);
        if (upd) {
          ox = cx[k];
          oy = cy[k];
          oz = cz[k];
          old_conf = conf[k];
          e += de;
        }
        if (upd && e < be) {
          be = e;
          bs = gstep + 1;
          ni = 0;
          improved_here = true;
          bx = ox;
          by = oy;
          bz = oz;
        } else {
          ni += 1;
        }
        if (patience >= 0 && ni >= patience) st = gstep;
        // gstep < n_steps here and n_steps * n_bins < 2^31 (ChainSpec guard).
        const int b_now = min(gstep * n_bins / n_steps, n_bins - 1);
        if (b_now != bin) {
          if (bin >= 0) {
            accept_bins[(size_t)bin * sC + c] += acc_a;
            total_bins[(size_t)bin * sC + c] += acc_t;
          }
          bin = b_now;
          acc_a = 0;
          acc_t = 0;
        }
        acc_a += upd ? 1 : 0;
        acc_t += 1;
      }
    }

    pi[(size_t)mover * sC] = ox;
    pj[(size_t)mover * sC] = oy;
    pk[(size_t)mover * sC] = oz;
    if (improved_here) {
      for (int r = 0; r < Q; ++r) {
        const size_t at = (size_t)r * sC + c;
        const bool m = r == mover;
        bqi[at] = m ? bx : qi[at];
        bqj[at] = m ? by : qj[at];
        bqk[at] = m ? bz : qk[at];
      }
    }
    if (st < n_steps) break;
  }
  if (bin >= 0) {
    accept_bins[(size_t)bin * sC + c] += acc_a;
    total_bins[(size_t)bin * sC + c] += acc_t;
  }
  energy[c] = e;
  best_energy[c] = be;
  best_step[c] = bs;
  no_improve[c] = ni;
  stop_step[c] = st;
}

}  // namespace

// Launch one history chunk on `stream`; returns cudaGetLastError() (0 on
// success).  All pointers are device pointers to contiguous arrays: qi .. bqk
// (Q, C); energy .. stop_step, chain_seeds (C); accept_bins, total_bins
// (n_bins, C); block_seeds (C / c_blk); beta (n_inner) float32; beta_scale
// (C) float32, or null for an untempered run.  patience < 0 disables early
// stopping.
extern "C" int mcq_full3d_shared_segment(
    void* qi, void* qj, void* qk, void* bqi, void* bqj, void* bqk,
    void* energy, void* best_energy, void* best_step, void* no_improve,
    void* stop_step, void* accept_bins, void* total_bins,
    const void* chain_seeds, const void* block_seeds, const void* beta,
    const void* beta_scale, int step0, int n_inner, int N, int Q, int C,
    int c_blk, int n_steps, int n_bins, int patience, void* stream) {
  const int threads = 32;
  const int blocks = (C + threads - 1) / threads;
  full3d_shared_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (int32_t*)qi, (int32_t*)qj, (int32_t*)qk, (int32_t*)bqi, (int32_t*)bqj,
      (int32_t*)bqk, (int32_t*)energy, (int32_t*)best_energy,
      (int32_t*)best_step, (int32_t*)no_improve, (int32_t*)stop_step,
      (int32_t*)accept_bins, (int32_t*)total_bins,
      (const int32_t*)chain_seeds, (const int32_t*)block_seeds,
      (const float*)beta, (const float*)beta_scale, step0, n_inner, N, Q, C,
      c_blk, n_steps, n_bins, patience);
  return (int)cudaGetLastError();
}
