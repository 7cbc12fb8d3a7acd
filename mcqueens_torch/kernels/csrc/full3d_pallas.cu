// Per-chain full-3D Metropolis for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel mcqueens/kernels/full3d_pallas.py:_kernel.
// Plain-torch twin: mcqueens_torch/kernels/full3d_pallas.py:
// segment_reference.
//
// One warp per chain.  Every chain draws its own mover and target cell from
// its own seed's counter stream, so no two chains share anything and the
// grid may group them freely: a block holds up to 4 chains, one per warp
// (fewer where their state would not fit in a block's shared memory).  The
// chain's queens (packed x | y << 10 | z << 20), its best queens and its
// ceil(N^3/32)-word occupancy bitfield sit in shared memory for the whole
// launch (4*(2Q + N^3/32) bytes, 4.2 KB at N=20, Q=400) and go back to
// global memory once at its end.  A warp per chain, not a thread, for the
// reason given in metropolis.cu: independent chains are narrow work.
// Coordinates pack into 10 bits each (N <= 1023); shapes beyond a block's
// 227 KB of shared memory (N > 104 at Q = N^2) are refused, with the limit
// stated, by the wrapper and by the entry point; the repo's configs need
// N <= 20.
//
// Per step:
//   * mover q = w_q % Q;
//   * target: attempt a tests cell word_from_base(base, _A_SALT + a) % N^3
//     against the bitfield, and the first free attempt wins, with no cap (the
//     JAX kernel's few unrolled attempts, then a block-wide lax.while_loop
//     that drains the stragglers).  Lane l tests
//     attempt 32r + l; __ballot_sync and __ffs pick the lowest free one of
//     each round of 32, which is the serial first-free exactly.  N=3, Q=26
//     has one free cell in 27;
//   * dE = sum over the other Q-1 queens of attack(queen, new) -
//     attack(queen, old), lanes splitting the queens and __reduce_add_sync
//     summing them.  The JAX kernel sums over all rows and cancels the
//     mover's own row (attack(old, new) - 8) with -attack(old, new) + 8: the
//     same integer.  Two distinct cells attack iff every nonzero |d| equals
//     the largest;
//   * on accept the mover moves, its old bit is cleared and its new bit set
//     (bit 31 is the int32 word's sign bit in the carry), and an improvement
//     copies the queens into the best queens (Q/32 per lane).
// Patience, best_step = step + 1 and the bins are as in metropolis.cu.
//
// What bounds it on the H100: int32 operations, not bytes.  Per step a
// warp does three counter hashes plus one per round of attempts, and
// ~2 x 22 int32 ops per other queen (Q/32 queens per lane), against
// 4*(7Q + N^3/32) bytes of state read and written once per launch.  The
// queens are packed one word each so a lane reads a queen with one
// shared-memory load.
//
// Bitwise contract with the JAX kernel and the twin: hash arithmetic in
// uint32_t (base + salt wraps, as the JAX int32 sum does), / and % only on
// non-negative operands, expf (not __expf), built with -fmad=false and
// without --use_fast_math; the per-step betas come from the wrapper.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kAttemptSalt = 0x3C6EF372u;

__device__ __forceinline__ uint32_t lowbias32(uint32_t z) {
  z ^= z >> 16;
  z *= 0x7FEB352Du;
  z ^= z >> 15;
  z *= 0x846CA68Bu;
  z ^= z >> 16;
  return z;
}

// 1 iff two distinct cells at distance (dx, dy, dz) attack: every nonzero
// |d| equals the largest.
__device__ __forceinline__ int attacks(int dx, int dy, int dz) {
  const int a = abs(dx), b = abs(dy), c = abs(dz);
  const int m = max(a, max(b, c));
  return ((a == 0) | (a == m)) & ((b == 0) | (b == m)) & ((c == 0) | (c == m));
}

__device__ __forceinline__ int pack(int x, int y, int z) {
  return x | (y << 10) | (z << 20);
}

// Bin bookkeeping of one chain, as in metropolis.cu: the current bin's
// counts in registers, added to the chain's row when the bin changes.
struct Bins {
  int bin = -1, next_edge = 0, acc_a = 0, acc_t = 0;

  __device__ void flush(int32_t* accept_row, int32_t* total_row, int lane) {
    if (bin >= 0 && lane == 0) {
      accept_row[bin] += acc_a;
      total_row[bin] += acc_t;
    }
    acc_a = acc_t = 0;
  }

  __device__ void count(int gstep, bool accepted, int n_steps, int n_bins,
                        int32_t* accept_row, int32_t* total_row, int lane) {
    if (gstep >= next_edge) {
      flush(accept_row, total_row, lane);
      const int64_t b = (int64_t)gstep * n_bins / n_steps;
      bin = (int)(b < n_bins - 1 ? b : n_bins - 1);
      // First step of the next bin: ceil((bin + 1) * n_steps / n_bins).
      next_edge = bin == n_bins - 1
                      ? INT_MAX
                      : (int)(((int64_t)(bin + 1) * n_steps + n_bins - 1) /
                              n_bins);
    }
    acc_a += accepted ? 1 : 0;
    acc_t += 1;
  }
};

__global__ void __launch_bounds__(kWarpsPerBlock * 32) full3d_pallas_kernel(
    int32_t* __restrict__ qi, int32_t* __restrict__ qj,
    int32_t* __restrict__ qk, int32_t* __restrict__ bqi,
    int32_t* __restrict__ bqj, int32_t* __restrict__ bqk,
    int32_t* __restrict__ occ, int32_t* __restrict__ energy,
    int32_t* __restrict__ best_energy, int32_t* __restrict__ best_step,
    int32_t* __restrict__ no_improve, int32_t* __restrict__ stop_step,
    int32_t* __restrict__ accept_bins, int32_t* __restrict__ total_bins,
    const int32_t* __restrict__ chain_seeds, const float* __restrict__ beta,
    int step0, int n_inner, int N, int Q, int C, int n_steps, int n_bins,
    int patience) {
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * (blockDim.x >> 5) + warp;
  if (c >= C) return;  // the whole warp leaves together
  int st = stop_step[c];
  // Steps of a stopped chain, and steps at or past n_steps, are inactive:
  // they change no state and count in no bin.
  const int t_end = min(n_inner, n_steps - step0);
  if (st < n_steps || t_end <= 0) return;

  const int NN = N * N;
  const int n_words = (NN * N + 31) / 32;
  int32_t* const sq = smem + (size_t)warp * (2 * Q + n_words);
  int32_t* const sbq = sq + Q;
  uint32_t* const socc = (uint32_t*)(sbq + Q);
  const size_t row = (size_t)c * Q;
  for (int r = lane; r < Q; r += 32) {
    sq[r] = pack(qi[row + r], qj[row + r], qk[row + r]);
    sbq[r] = pack(bqi[row + r], bqj[row + r], bqk[row + r]);
  }
  const size_t occ_row = (size_t)c * n_words;
  for (int w = lane; w < n_words; w += 32) socc[w] = (uint32_t)occ[occ_row + w];
  __syncwarp();

  const uint32_t uN = (uint32_t)N, uNN = (uint32_t)NN, uN3 = uNN * uN;
  const uint32_t s = (uint32_t)chain_seeds[c];
  const uint32_t g = s * 0x85EBCA6Bu + lowbias32(s);
  int32_t* const accept_row = accept_bins + (size_t)c * n_bins;
  int32_t* const total_row = total_bins + (size_t)c * n_bins;
  int e = energy[c];
  int be = best_energy[c];
  int bs = best_step[c];
  int ni = no_improve[c];
  bool improved_any = false;
  Bins bins;

  for (int t = 0; t < t_end; ++t) {
    const int gstep = step0 + t;
    const uint32_t base = lowbias32(g ^ ((uint32_t)gstep * 0x9E3779B9u));
    const uint32_t w_q = lowbias32(base ^ 0x68BC21EBu) & 0x7FFFFFFFu;
    const uint32_t w_u = lowbias32(base + 0x02E5BE93u);
    const int mover = (int)(w_q % (uint32_t)Q);
    const float u = (float)((w_u >> 7) & 0xFFFFFFu) * (1.0f / 16777216.0f);
    const int op = sq[mover];
    const int ox = op & 1023, oy = (op >> 10) & 1023, oz = op >> 20;

    // Exact rejection sampling of a free cell, 32 attempts per round.
    uint32_t new_cell = 0;
    for (uint32_t a0 = 0;; a0 += 32) {
      const uint32_t w =
          lowbias32(base + kAttemptSalt + a0 + (uint32_t)lane) & 0x7FFFFFFFu;
      const uint32_t cand = w % uN3;
      const bool is_free = ((socc[cand >> 5] >> (cand & 31)) & 1u) == 0;
      const unsigned hits = __ballot_sync(kFull, is_free);
      if (hits) {
        new_cell = __shfl_sync(kFull, cand, __ffs(hits) - 1);
        break;
      }
    }
    const uint32_t nq = new_cell / uN;
    const int nz = (int)(new_cell - nq * uN);
    const int nx = (int)(nq / uN);
    const int ny = (int)(nq - (uint32_t)nx * uN);

    int de = 0;
    for (int r = lane; r < Q; r += 32) {
      if (r == mover) continue;
      const int p = sq[r];
      const int x = p & 1023, y = (p >> 10) & 1023, z = p >> 20;
      de += attacks(x - nx, y - ny, z - nz) - attacks(x - ox, y - oy, z - oz);
    }
    de = __reduce_add_sync(kFull, de);

    const bool accept = u < expf(-beta[t] * (float)de);
    __syncwarp();  // every lane has read the state before it changes
    if (accept) {
      if (lane == 0) {
        const uint32_t old_cell = (uint32_t)((ox * N + oy) * N + oz);
        sq[mover] = pack(nx, ny, nz);
        socc[old_cell >> 5] &= ~(1u << (old_cell & 31));
        socc[new_cell >> 5] |= 1u << (new_cell & 31);
      }
      e += de;
    }
    __syncwarp();
    if (accept && e < be) {
      be = e;
      bs = gstep + 1;
      ni = 0;
      improved_any = true;
      for (int r = lane; r < Q; r += 32) sbq[r] = sq[r];
    } else {
      ni += 1;
    }
    if (patience >= 0 && ni >= patience) st = gstep;
    bins.count(gstep, accept, n_steps, n_bins, accept_row, total_row, lane);
    if (st < n_steps) break;
  }
  bins.flush(accept_row, total_row, lane);
  __syncwarp();
  for (int r = lane; r < Q; r += 32) {
    const int p = sq[r];
    qi[row + r] = p & 1023;
    qj[row + r] = (p >> 10) & 1023;
    qk[row + r] = p >> 20;
  }
  if (improved_any) {
    for (int r = lane; r < Q; r += 32) {
      const int p = sbq[r];
      bqi[row + r] = p & 1023;
      bqj[row + r] = (p >> 10) & 1023;
      bqk[row + r] = p >> 20;
    }
  }
  for (int w = lane; w < n_words; w += 32) occ[occ_row + w] = (int32_t)socc[w];
  if (lane == 0) {
    energy[c] = e;
    best_energy[c] = be;
    best_step[c] = bs;
    no_improve[c] = ni;
    stop_step[c] = st;
  }
}

}  // namespace

// Launch one history chunk on `stream`; returns a cudaError_t (0 on
// success).  All pointers are device pointers to contiguous arrays, chains
// major: qi .. bqk (C, Q); occ (C, ceil(N^3/32)); energy .. stop_step,
// chain_seeds (C); accept_bins, total_bins (C, n_bins); beta (n_inner)
// float32.  patience < 0 disables early stopping.  A chain needs
// 4*(2Q + ceil(N^3/32)) bytes of shared memory; a shape beyond the block
// limit (N > 104 at Q = N^2) is refused with cudaErrorInvalidValue before
// anything is launched, as is Q >= N^3 (no free cell) or N > 1023.
extern "C" int mcq_full3d_pallas_segment(
    void* qi, void* qj, void* qk, void* bqi, void* bqj, void* bqk, void* occ,
    void* energy, void* best_energy, void* best_step, void* no_improve,
    void* stop_step, void* accept_bins, void* total_bins,
    const void* chain_seeds, const void* beta, int step0, int n_inner, int N,
    int Q, int C, int n_steps, int n_bins, int patience, void* stream) {
  int max_smem = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (N < 2 || N > 1023 || Q < 1 || (int64_t)Q >= (int64_t)N * N * N ||
      C <= 0 || n_inner < 0)
    return (int)cudaErrorInvalidValue;
  const size_t per_chain =
      (size_t)4 * (2 * (size_t)Q + ((size_t)N * N * N + 31) / 32);
  if (per_chain > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  const size_t fit = (size_t)max_smem / per_chain;
  const int warps = fit < (size_t)kWarpsPerBlock ? (int)fit : kWarpsPerBlock;
  const size_t smem = warps * per_chain;
  cudaError_t err = cudaFuncSetAttribute(
      full3d_pallas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (C + warps - 1) / warps;
  full3d_pallas_kernel<<<blocks, warps * 32, smem, (cudaStream_t)stream>>>(
      (int32_t*)qi, (int32_t*)qj, (int32_t*)qk, (int32_t*)bqi, (int32_t*)bqj,
      (int32_t*)bqk, (int32_t*)occ, (int32_t*)energy, (int32_t*)best_energy,
      (int32_t*)best_step, (int32_t*)no_improve, (int32_t*)stop_step,
      (int32_t*)accept_bins, (int32_t*)total_bins,
      (const int32_t*)chain_seeds, (const float*)beta, step0, n_inner, N, Q,
      C, n_steps, n_bins, patience);
  return (int)cudaGetLastError();
}
