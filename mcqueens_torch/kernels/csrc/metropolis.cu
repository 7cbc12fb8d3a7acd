// Per-chain board Metropolis for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel mcqueens/kernels/metropolis_pallas.py:_kernel.
// Plain-torch twin: mcqueens_torch/kernels/metropolis_pallas.py:
// segment_reference.
//
// One warp per chain.  Independent chains are narrow work: one thread per
// chain, the design of the shared-site kernels, would give a 128-run sweep
// 4 warps on a 132-SM card, where a warp per chain gives it 128.  Every
// chain draws its own site (i, j) and new height from its own seed's counter
// stream, so no two chains share anything and the grid may group them
// freely: a block holds up to 4 chains, one per warp (fewer where the boards
// would not fit in a block's shared memory).  The carry is still padded to
// whole blocks exactly as the JAX package pads it, though a block has no
// meaning here.  The chain's board and best board sit in shared memory for
// the whole launch (8*N^2 bytes, 8 KB at N=32) and go back to global memory
// once at its end; energy, best energy, best step, patience counter, stop
// step and the current bin's counts stay in registers, warp-uniform.  State
// stays chains major, the carry's own layout, so a segment copies it once
// and transposes nothing.  Boards beyond a block's 227 KB of shared memory
// (N > 170) are refused, with the limit stated, by the wrapper and by the
// entry point; the repo's configs need N <= 32.
//
// dE: the JAX kernel sums the dense identity of kernels/delta_e.py over all
// N^2 cells, because Mosaic has no per-lane gather on the TPU; the CUDA
// kernel can gather, so it scores only the lines.  The integrand is zero
// off the row, column and two diagonals
// through (i, j), and on an off-site cell of those lines at offset d != 0 it
// reduces to
//     [h == new] - [h == old] + [|h - new| == |d|] - [|h - old| == |d|],
// while the site's own cell gives -6, which the +6 cancels.  So lane x scores
// the (up to) four line cells of row offset x (x = lane, lane + 32, ...: one
// pass for N <= 32) and __reduce_add_sync sums the warp: the same integer as
// the dense sum, in 4N cells instead of N^2.
//
// What bounds it on the H100: operations, not bytes.  Per step a warp does
// three counter hashes, three integer divisions, four shared-memory cells
// per lane and one warp reduction, against 8*N^2 bytes of state read and
// written once per launch.  A chain's steps form one serial dependency
// chain, so the kernel is latency-bound well below the int32 issue rate;
// the design keeps up to 4 chains per block resident so that warps hide
// each other's latency, copies the best board in shared memory (N^2/32
// cells per lane) only when the energy improves, and flushes the bins to
// global memory only when the bin changes.
//
// Bitwise contract with the JAX kernel and the twin: hash arithmetic in
// uint32_t (int32 wrap-around is what the JAX kernel computes; signed
// overflow is undefined in C++), / and % only on non-negative operands (C
// truncates where jnp floors), expf (not __expf), built with -fmad=false and
// without --use_fast_math.  The per-step betas come from the wrapper, which
// evaluates the schedule once per chunk for the kernel and the twin alike.
// The bin of a step is min(step * n_bins / n_steps, n_bins - 1), recomputed
// in 64-bit arithmetic whenever the step reaches the next bin's first step.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t lowbias32(uint32_t z) {
  z ^= z >> 16;
  z *= 0x7FEB352Du;
  z ^= z >> 15;
  z *= 0x846CA68Bu;
  z ^= z >> 16;
  return z;
}

// Net conflict change of one off-site line cell of height hp at line offset
// |d| = ad > 0 when the site's queen moves from old_k to new_k.
__device__ __forceinline__ int line_score(int hp, int old_k, int new_k,
                                          int ad) {
  const int dn = abs(hp - new_k);
  const int dl = abs(hp - old_k);
  return (dn == 0) - (dl == 0) + (dn == ad) - (dl == ad);
}

// Bin bookkeeping of one chain: counts of the current bin live in
// registers and are added to the chain's row of the (C, n_bins) arrays when
// the bin changes and at the end of the launch.
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

__global__ void __launch_bounds__(kWarpsPerBlock * 32) metropolis_kernel(
    int32_t* __restrict__ heights, int32_t* __restrict__ best_heights,
    int32_t* __restrict__ energy, int32_t* __restrict__ best_energy,
    int32_t* __restrict__ best_step, int32_t* __restrict__ no_improve,
    int32_t* __restrict__ stop_step, int32_t* __restrict__ accept_bins,
    int32_t* __restrict__ total_bins, const int32_t* __restrict__ chain_seeds,
    const float* __restrict__ beta, int step0, int n_inner, int N, int C,
    int n_steps, int n_bins, int patience) {
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
  int32_t* const h = smem + (size_t)warp * 2 * NN;
  int32_t* const bh = h + NN;
  const size_t row = (size_t)c * NN;
  for (int x = lane; x < NN; x += 32) {
    h[x] = heights[row + x];
    bh[x] = best_heights[row + x];
  }
  __syncwarp();

  const uint32_t uN = (uint32_t)N, uNN = (uint32_t)NN, uNm1 = uN - 1;
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
    const uint32_t w0 = lowbias32(base ^ 0x68BC21EBu) & 0x7FFFFFFFu;
    const uint32_t w1 = lowbias32(base + 0x02E5BE93u);
    const uint32_t q = w0 / uN;
    const int i = (int)(w0 - q * uN);
    const int j = (int)(q % uN);
    const int kr = (int)((w0 / uNN) % uNm1);
    const float u = (float)((w1 >> 7) & 0xFFFFFFu) * (1.0f / 16777216.0f);
    const int site = i * N + j;
    const int old_k = h[site];
    const int new_k = (old_k + 1 + kr) % N;

    int de = 0;
    for (int x = lane; x < N; x += 32) {
      const int dj = x - j;  // offset along row i
      const int d = x - i;   // offset along column j and both diagonals
      if (dj != 0) de += line_score(h[i * N + x], old_k, new_k, abs(dj));
      if (d != 0) {
        const int ad = abs(d);
        de += line_score(h[x * N + j], old_k, new_k, ad);
        const int jd = j + d;
        if (jd >= 0 && jd < N) de += line_score(h[x * N + jd], old_k, new_k, ad);
        const int ja = j - d;
        if (ja >= 0 && ja < N) de += line_score(h[x * N + ja], old_k, new_k, ad);
      }
    }
    de = __reduce_add_sync(kFull, de);

    const bool accept = u < expf(-beta[t] * (float)de);
    __syncwarp();  // every lane has read the board before it changes
    if (accept) {
      if (lane == 0) h[site] = new_k;
      e += de;
    }
    __syncwarp();
    if (accept && e < be) {
      be = e;
      bs = gstep + 1;
      ni = 0;
      improved_any = true;
      for (int x = lane; x < NN; x += 32) bh[x] = h[x];
    } else {
      ni += 1;
    }
    if (patience >= 0 && ni >= patience) st = gstep;
    bins.count(gstep, accept, n_steps, n_bins, accept_row, total_row, lane);
    if (st < n_steps) break;
  }
  bins.flush(accept_row, total_row, lane);
  __syncwarp();
  for (int x = lane; x < NN; x += 32) heights[row + x] = h[x];
  if (improved_any) {
    for (int x = lane; x < NN; x += 32) best_heights[row + x] = bh[x];
  }
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
// major: heights and best_heights (C, N*N); energy .. stop_step, chain_seeds
// (C); accept_bins, total_bins (C, n_bins); beta (n_inner) float32.
// patience < 0 disables early stopping.  A chain needs 8*N^2 bytes of shared
// memory; a shape beyond the block limit (N > 170) is refused with
// cudaErrorInvalidValue before anything is launched.
extern "C" int mcq_metropolis_segment(
    void* heights, void* best_heights, void* energy, void* best_energy,
    void* best_step, void* no_improve, void* stop_step, void* accept_bins,
    void* total_bins, const void* chain_seeds, const void* beta, int step0,
    int n_inner, int N, int C, int n_steps, int n_bins, int patience,
    void* stream) {
  const size_t per_chain = (size_t)8 * N * N;
  int max_smem = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (N < 2 || C <= 0 || n_inner < 0 || per_chain > (size_t)max_smem)
    return (int)cudaErrorInvalidValue;
  const size_t fit = (size_t)max_smem / per_chain;
  const int warps = fit < (size_t)kWarpsPerBlock ? (int)fit : kWarpsPerBlock;
  const size_t smem = warps * per_chain;
  cudaError_t err = cudaFuncSetAttribute(
      metropolis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (C + warps - 1) / warps;
  metropolis_kernel<<<blocks, warps * 32, smem,
                      (cudaStream_t)stream>>>(
      (int32_t*)heights, (int32_t*)best_heights, (int32_t*)energy,
      (int32_t*)best_energy, (int32_t*)best_step, (int32_t*)no_improve,
      (int32_t*)stop_step, (int32_t*)accept_bins, (int32_t*)total_bins,
      (const int32_t*)chain_seeds, (const float*)beta, step0, n_inner, N, C,
      n_steps, n_bins, patience);
  return (int)cudaGetLastError();
}
