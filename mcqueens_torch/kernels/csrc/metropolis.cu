// Per-chain board Metropolis for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel mcqueens/kernels/metropolis_pallas.py:_kernel.
// Plain-torch twin: mcqueens_torch/kernels/metropolis_pallas.py:
// segment_reference.
//
// Every chain draws its own site (i, j), height offset kr and accept word
// from its own seed's counter stream, so no two chains share anything.  A
// move at (i, j) changes conflicts only on row i, column j and the two
// diagonals through (i, j): the JAX kernel sums the dense identity of
// kernels/delta_e.py over all N^2 cells (Mosaic has no per-lane gather on
// the TPU); this kernel scores only the lines.  On an off-site cell of height
// hp at line offset d != 0 the identity reduces to
//     [hp == new] - [hp == old] + [(hp - new)^2 == d^2] - [(hp - old)^2 == d^2]
// and the site's own cell gives -6, which the identity's +6 cancels: the
// same integer as the dense sum, in up to 4(N-1) cells instead of N^2.
//
// What bounds it: issued instructions where chains are many, and a step's
// serial latency where they are few (128 chains on 132 SMs is one warp an
// SM).  The parent design (a warp per chain, every lane repeating the
// step's three hashes, four run-time divisions, beta load and expf, boards
// as int32, the lines scored with branches) spent ~1700 cycles a step.
// Design:
//   * A team of L lanes a chain (L = 1, 2, 4, 8, 16 or 32; a team sits
//     inside one warp).  Lane r scores the row offsets x = r, r + L, ... of
//     the four lines and the team sums dE with __shfl_xor_sync (one
//     __reduce_add_sync at L = 32): an integer sum, so every lane holds the
//     same dE, hence the same accept decision, without a broadcast.  Few
//     chains take a whole warp (latency), many chains small teams (a warp
//     instruction serves 32 / L chains); the rule is
//     kernels/metropolis_pallas.py:layout, a cost model fitted to every
//     team size timed at the main paths' launches.
//   * The lines without a branch: every lane of the warp runs the same
//     passes, and a cell off the board or off the lines is read from a cell
//     inside it and counts 0.  Divergent branches there cost the parent a
//     pass per branch.
//   * Proposals a batch ahead.  No draw depends on the chain's state, and
//     neither does the step's beta: lane r computes step t + r's site,
//     height offset, uniform and beta (divisions by N, N^2 and N - 1 as
//     multiply-high by constants the entry point computes), a batch before
//     it is used, and the walk takes them with __shfl_sync.  The serial
//     path keeps: the site's height, new = old + 1 + kr wrapped by one
//     subtraction, the lines, the team's sum, the accept test and the
//     store.  A batch may run past the chain's last step; those draws are
//     unused.  A bin changes only at fixed steps, so the walk keeps the
//     step at which the current bin ends and divides only when it turns.
//     (Scoring step t + 1 before step t's move and mending its dE after
//     it, with both accept tests computed ahead, was slower on the card:
//     the mending costs more issue slots than the overlap saves.)
//   * Boards in shared memory, one byte a cell (heights lie in [0, N) and
//     N <= 170; the wrapper refuses heights outside [0, N)), rows padded to
//     an odd number of words (a team's column and diagonal reads fall in
//     different banks), a board padded to whole 16-byte words and a slot
//     (board and best board) to an odd number of them.  A CTA copies its
//     chains' heights in at the start (its chains' rows are one contiguous
//     run of the chains-major carry) and back at the end; best boards are
//     never read in (an improvement overwrites all of one) and are written
//     back only for the chains that improved in this launch.  An
//     improvement copies the board shared to shared, 16 bytes a lane at a
//     time.
//   * Every lane of a team stores the new height, so every lane reads its
//     own stores and no barrier separates a step's store from the next
//     step's reads.  A lane reads a step's cells before the team's sum and
//     any lane stores only after it, so no lane reads a height of the same
//     step's store; a best copy follows the store in each lane.
//   * Bookkeeping in registers: energy, best, best step, patience counter,
//     stop step; accepts and proposals counted in registers and added to
//     the chain's (n_bins) row when the bin changes and at the end.
//   * All 32 lanes of a warp take every shuffle (full masks).  A team whose
//     chain has stopped or does not exist keeps walking the warp's steps
//     and changes nothing; the warp stops when no team is live.
//
// Bitwise contract with the JAX kernel and the twin: hash arithmetic in
// uint32_t (signed overflow is undefined in C++; int32 wrap-around is what
// the JAX kernel computes), / and % only on non-negative operands (C
// truncates where jnp floors), expf (not __expf), built with -fmad=false and
// without --use_fast_math.  The per-step betas come from the wrapper, which
// evaluates the schedule once per chunk for the kernel and the twin alike.
// The bin of a step is min(step * n_bins / n_steps, n_bins - 1) in 64-bit
// arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

#include "exact_div.cuh"

namespace {

// The exact division by a launch's invariant divisors (exact_div.cuh).
using mcq::Div;
using mcq::make_div;
using mcq::quot;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreadsPerCta = 1024;
constexpr int kMaxN = 170;
constexpr int kNever = 0x7FFFFFFF;

// A board row's bytes in shared memory: N rounded up to an odd number of
// words.  Mirrored by kernels/metropolis_pallas.py:row_pitch.
__host__ __device__ inline int row_pitch(int N) {
  return 4 * (((N + 3) / 4) | 1);
}

// A board's bytes: N rows, rounded up to whole 16-byte words.
__host__ __device__ inline int board_bytes(int N) {
  return (N * row_pitch(N) + 15) / 16 * 16;
}

// A chain's slot: its board and best board, an odd number of 16-byte
// words.  Mirrored by kernels/metropolis_pallas.py:slot_bytes.
__host__ __device__ inline int slot_bytes(int N) {
  return 16 * ((2 * board_bytes(N) / 16) | 1);
}

__device__ __forceinline__ uint32_t lowbias32(uint32_t z) {
  z ^= z >> 16;
  z *= 0x7FEB352Du;
  z ^= z >> 15;
  z *= 0x846CA68Bu;
  z ^= z >> 16;
  return z;
}

// Net conflict change of one off-site cell of height hp at squared line
// offset d2 >= 1 when the site's queen moves from old_k to new_k: whether
// the cell attacks the new height less whether it attacks the old one
// (h == k and (h - k)^2 == d2 exclude each other, so the identity's sum of
// the two is their or).
__device__ __forceinline__ int line_score(int hp, int old_k, int new_k,
                                          int d2) {
  const int dn = hp - new_k;
  const int dl = hp - old_k;
  return (int)(dn == 0 || dn * dn == d2) - (int)(dl == 0 || dl * dl == d2);
}

struct Args {
  int32_t *heights, *best_heights, *energy, *best_energy, *best_step,
      *no_improve, *stop_step, *accept_bins, *total_bins;
  const int32_t* chain_seeds;
  const float* beta;
  int step0, n_inner, N, C, n_steps, n_bins, patience;
  Div by_n, by_nn, by_nm1;
};

template <int L>
__device__ __forceinline__ int team_sum(int v) {
  if (L == 32) return __reduce_add_sync(kFull, v);
#pragma unroll
  for (int m = 1; m < L; m <<= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

template <int L, typename T>
__device__ __forceinline__ T from_lane(T v, int lane) {
  return L > 1 ? __shfl_sync(kFull, v, lane) : v;
}

// dE of a proposal at (i, j) from old_k to new_k: lane r's share of the
// four lines (row offsets x = r, r + L, ...), before the team's sum.  The
// passes are the same for every lane of the warp and every cell is read
// from a row and column inside the board, a cell off the lines counting 0
// (selects, no branch), so the lanes never diverge here.
template <int L>
__device__ __forceinline__ int score_lines(const uint8_t* h, int pitch, int N,
                                           int r, int i, int j, int old_k,
                                           int new_k) {
  const uint8_t* const row_i = h + i * pitch;
  const int passes = (N + L - 1) / L;
  int de = 0;
#pragma unroll 1
  for (int p = 0; p < passes; ++p) {
    const int x = r + p * L;
    const int xs = x < N ? x : i;  // a lane past the board reads row i
    const int dj = xs - j;         // offset along row i
    const int d = xs - i;          // offset along column j and the diagonals
    const int d2 = d * d;
    const int jd = j + d, ja = j - d;
    const bool in_d = (unsigned)jd < (unsigned)N;
    const bool in_a = (unsigned)ja < (unsigned)N;
    const uint8_t* const row_x = h + xs * pitch;
    const int s_row = line_score(row_i[xs], old_k, new_k, dj * dj);
    const int s_col = line_score(row_x[j], old_k, new_k, d2);
    const int s_dia = line_score(row_x[in_d ? jd : j], old_k, new_k, d2);
    const int s_ant = line_score(row_x[in_a ? ja : j], old_k, new_k, d2);
    // xs == i (d == 0) at the site's row and past the board, where only
    // row i's cell counts, and only off the site.
    de += (dj != 0 && x < N ? s_row : 0) +
          (d != 0 ? s_col + (in_d ? s_dia : 0) + (in_a ? s_ant : 0) : 0);
  }
  return de;
}

// One chain's chunk, walked by its team's L lanes (lane r of the team); h
// and bh are its board and best board in shared memory.  Returns whether it
// improved.  A step is decided at its top from the dE and accept test that
// the step before it scored at its end, on the board after its own move.
template <int L>
__device__ __forceinline__ bool walk(const Args& a, int c, bool exists,
                                     int r, uint8_t* h, uint8_t* bh) {
  const int N = a.N, pitch = row_pitch(N);
  const int team_lane0 = (threadIdx.x & 31) - r;
  int e = 0, be = 0, bs = 0, ni = 0, st = 0, t_end = 0;
  uint32_t g = 0;
  if (exists) {
    e = a.energy[c];
    be = a.best_energy[c];
    bs = a.best_step[c];
    ni = a.no_improve[c];
    st = a.stop_step[c];
    // Steps of a stopped chain and steps at or past n_steps are inactive:
    // they change no state and count in no bin.
    t_end = min(a.n_inner, a.n_steps - a.step0);
    if (st < a.n_steps) t_end = 0;
    const uint32_t s = (uint32_t)a.chain_seeds[c];
    g = s * 0x85EBCA6Bu + lowbias32(s);
  }
  int32_t* const accept_row = a.accept_bins + (size_t)c * a.n_bins;
  int32_t* const total_row = a.total_bins + (size_t)c * a.n_bins;
  // The warp's steps: every lane walks them all.
  const int T = __reduce_max_sync(kFull, t_end);
  bool improved = false;
  // The current bin, the first step past it, and this chain's accepts and
  // proposals in it.
  int bin = 0, bin_end = -1, n_acc = 0, n_tot = 0;

  // Draws of a batch: lane r holds step tb + r's site (i | j << 8 | kr <<
  // 16, N <= 170; cell (0, 0) past the warp's steps), uniform and beta.
  const auto draw = [&](int tb, uint32_t& site, float& u, float& beta) {
    const int tl = tb + r;
    site = 0;
    u = 0.0f;
    beta = 0.0f;
    if (tl < T) {
      const uint32_t gs = (uint32_t)(a.step0 + tl);
      const uint32_t base = lowbias32(g ^ (gs * 0x9E3779B9u));
      const uint32_t w0 = lowbias32(base ^ 0x68BC21EBu) & 0x7FFFFFFFu;
      const uint32_t w1 = lowbias32(base + 0x02E5BE93u);
      const uint32_t q = quot(w0, a.by_n);
      const uint32_t i = w0 - q * (uint32_t)N;
      const uint32_t j = q - quot(q, a.by_n) * (uint32_t)N;
      const uint32_t q2 = quot(w0, a.by_nn);
      const uint32_t kr = q2 - quot(q2, a.by_nm1) * (uint32_t)(N - 1);
      site = i | j << 8 | kr << 16;
      u = (float)((w1 >> 7) & 0xFFFFFFu) * (1.0f / 16777216.0f);
      beta = a.beta[tl];
    }
  };

  // The batch in use and the next one, drawn a batch ahead.
  uint32_t dsite, xsite;
  float du, dbeta, xu, xbeta;
  draw(0, dsite, du, dbeta);
  // Step t's site, heights, dE on the board after step t - 1 and accept
  // test, scored at the end of the step before it.
  const uint32_t site = from_lane<L>(dsite, team_lane0);
  int i = site & 0xFF, j = (site >> 8) & 0xFF;
  int old_k = h[i * pitch + j];
  // (old_k + 1 + kr) % N with 0 <= old_k < N and 0 <= kr <= N - 2
  int new_k = old_k + 1 + (int)(site >> 16);
  if (new_k >= N) new_k -= N;
  int de = team_sum<L>(score_lines<L>(h, pitch, N, r, i, j, old_k, new_k));
  bool ok = from_lane<L>(du, team_lane0) <
            expf(-from_lane<L>(dbeta, team_lane0) * (float)de);

  for (int t = 0, tb = 0; t < T; ++t) {
    const int q = t - tb, gstep = a.step0 + t;
    if (q == 0) {
      if (!__any_sync(kFull, t < t_end && st >= a.n_steps)) break;
      draw(tb + L, xsite, xu, xbeta);
    }
    if (q == L - 1) {
      tb += L;
      dsite = xsite;
      du = xu;
      dbeta = xbeta;
    }
    // Step t + 1's draws: the batch's next, or the next batch's first.
    const int nq = t + 1 - tb;
    const uint32_t site1 = from_lane<L>(dsite, team_lane0 + nq);
    const float u1 = from_lane<L>(du, team_lane0 + nq);
    const float bt1 = from_lane<L>(dbeta, team_lane0 + nq);
    if (gstep >= bin_end) {
      // gstep < n_steps here and n_steps * n_bins < 2^31 (ChainSpec
      // guard); bin b ends at the first step s with s * n_bins >= (b + 1)
      // * n_steps.
      if (n_tot && r == 0) {
        accept_row[bin] += n_acc;
        total_row[bin] += n_tot;
      }
      bin = min(gstep * a.n_bins / a.n_steps, a.n_bins - 1);
      bin_end = bin == a.n_bins - 1
                    ? kNever
                    : (int)(((long long)(bin + 1) * a.n_steps + a.n_bins -
                             1) / a.n_bins);
      n_acc = 0;
      n_tot = 0;
    }
    const bool live = t < t_end && st >= a.n_steps;
    const bool accept = live && ok;
    if (accept) {
      h[i * pitch + j] = (uint8_t)new_k;
      e += de;
    }
    if (live) {
      if (accept && e < be) {
        be = e;
        bs = gstep + 1;
        ni = 0;
        improved = true;
        const uint4* const src = reinterpret_cast<const uint4*>(h);
        uint4* const dst = reinterpret_cast<uint4*>(bh);
        for (int w = r; w < board_bytes(N) / 16; w += L) dst[w] = src[w];
      } else {
        ni += 1;
      }
      if (a.patience >= 0 && ni >= a.patience) st = gstep;
      n_acc += accept ? 1 : 0;
      n_tot += 1;
    }
    // Step t + 1 on the board after step t's move.
    i = site1 & 0xFF;
    j = (site1 >> 8) & 0xFF;
    old_k = h[i * pitch + j];
    new_k = old_k + 1 + (int)(site1 >> 16);
    if (new_k >= N) new_k -= N;
    de = team_sum<L>(score_lines<L>(h, pitch, N, r, i, j, old_k, new_k));
    ok = u1 < expf(-bt1 * (float)de);
  }
  if (r == 0 && exists) {
    if (n_tot) {
      accept_row[bin] += n_acc;
      total_row[bin] += n_tot;
    }
    a.energy[c] = e;
    a.best_energy[c] = be;
    a.best_step[c] = bs;
    a.no_improve[c] = ni;
    a.stop_step[c] = st;
  }
  return improved;
}

// Launched with cpb * L threads a CTA, chains [blockIdx.x * cpb, + cpb).
// Dynamic shared memory: cpb slots of slot_bytes(N), then cpb words of
// flags (a chain improved in this launch).
template <int L>
__global__ void __launch_bounds__(kMaxThreadsPerCta, 1)
    metropolis_kernel(Args a, int cpb) {
  extern __shared__ int32_t smem[];
  const int team = threadIdx.x / L, r = threadIdx.x % L;
  const int c0 = blockIdx.x * cpb, c = c0 + team;
  const int N = a.N, NN = N * N, pitch = row_pitch(N), S = slot_bytes(N);
  uint8_t* const slots = reinterpret_cast<uint8_t*>(smem);
  int* const flags = reinterpret_cast<int*>(slots + (size_t)cpb * S);
  // The CTA's chains are rows c0 .. c0 + here - 1 of the chains-major
  // carry: one contiguous run of here * N^2 heights.
  const int here = min(cpb, a.C - c0);
  const size_t base = (size_t)c0 * NN;
  for (int idx = threadIdx.x; idx < here * NN; idx += blockDim.x) {
    const int w = idx / NN, x = idx - w * NN, i = x / N;
    slots[(size_t)w * S + i * pitch + (x - i * N)] =
        (uint8_t)a.heights[base + idx];
  }
  __syncthreads();
  uint8_t* const slot = slots + (size_t)team * S;
  const bool improved =
      walk<L>(a, c, team < here, r, slot, slot + board_bytes(N));
  if (r == 0) flags[team] = improved;
  __syncthreads();
  for (int idx = threadIdx.x; idx < here * NN; idx += blockDim.x) {
    const int w = idx / NN, x = idx - w * NN, i = x / N;
    const uint8_t* p = slots + (size_t)w * S + i * pitch + (x - i * N);
    a.heights[base + idx] = p[0];
    if (flags[w]) a.best_heights[base + idx] = p[board_bytes(N)];
  }
}

template <int L>
int launch(const Args& a, int cpb, int smem, cudaStream_t stream) {
  const auto kernel = metropolis_kernel<L>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (a.C + cpb - 1) / cpb;
  const int threads = cpb * L;
  kernel<<<blocks, threads, smem, stream>>>(a, cpb);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch one history chunk on `stream`; returns cudaGetLastError() (0 on
// success).  All pointers are device pointers to contiguous arrays, chains
// major: heights and best_heights (C, N*N), every height in [0, N); energy
// .. stop_step, chain_seeds (C); accept_bins, total_bins (C, n_bins); beta
// (n_inner) float32.  patience < 0 disables early stopping.  The layout
// (kernels/metropolis_pallas.py:layout): `lanes` (1, 2, 4, 8, 16 or 32)
// lanes a chain, `chains_per_cta` chains a CTA (lanes * chains_per_cta a
// multiple of 32 and at most 1024), and smem_bytes the CTA's shared memory,
// chains_per_cta * (slot_bytes(N) + 4).  Anything else, and N outside
// [2, 170], returns cudaErrorInvalidValue before anything is launched.
extern "C" int mcq_metropolis_segment(
    void* heights, void* best_heights, void* energy, void* best_energy,
    void* best_step, void* no_improve, void* stop_step, void* accept_bins,
    void* total_bins, const void* chain_seeds, const void* beta, int step0,
    int n_inner, int N, int C, int n_steps, int n_bins, int patience,
    int lanes, int chains_per_cta, int smem_bytes, void* stream) {
  const int cpb = chains_per_cta;
  const bool lanes_ok = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  const bool cpb_ok = cpb >= 1 && (cpb * lanes) % 32 == 0 &&
                      cpb * lanes <= kMaxThreadsPerCta;
  const bool n_ok = N >= 2 && N <= kMaxN;
  if (!lanes_ok || !cpb_ok || !n_ok || C < 1 || n_inner < 0 ||
      smem_bytes != cpb * (slot_bytes(N) + 4)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a = {(int32_t*)heights,    (int32_t*)best_heights,
                  (int32_t*)energy,     (int32_t*)best_energy,
                  (int32_t*)best_step,  (int32_t*)no_improve,
                  (int32_t*)stop_step,  (int32_t*)accept_bins,
                  (int32_t*)total_bins, (const int32_t*)chain_seeds,
                  (const float*)beta,   step0,
                  n_inner,              N,
                  C,                    n_steps,
                  n_bins,               patience,
                  make_div((uint32_t)N), make_div((uint32_t)(N * N)),
                  make_div((uint32_t)(N - 1))};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (lanes) {
    case 1:
      return launch<1>(a, cpb, smem_bytes, s);
    case 2:
      return launch<2>(a, cpb, smem_bytes, s);
    case 4:
      return launch<4>(a, cpb, smem_bytes, s);
    case 8:
      return launch<8>(a, cpb, smem_bytes, s);
    case 16:
      return launch<16>(a, cpb, smem_bytes, s);
    default:
      return launch<32>(a, cpb, smem_bytes, s);
  }
}
