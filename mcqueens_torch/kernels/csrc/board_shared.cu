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
// Chains [b*c_blk, (b+1)*c_blk) form semantic block b: they share each
// step's proposal site (i, j), hashed from the block's seed, while each
// chain draws its own new height and accept word from its own seed.  A move
// at (i, j) changes conflicts only on row i, column j and the two diagonals
// through (i, j), so dE sums up to 4(N-1) cells (60 at N=16).
//
// What bounds it: int32 instructions.  A step's cells, four hashes and the precise
// expf are ~800 int32 operations a chain, a chain is a serial walk, and the
// board is tiny; the parent design (a thread a chain, boards in device
// memory) spent its time waiting on L2 and idling SMs instead.  Design:
//   * A team of L lanes a chain (L = 1, 2, 4 or 8; a team sits inside one
//     warp).  Lane r scores the offsets x = r, r + L, ... of the four lines
//     and the team sums dE with __shfl_xor_sync: an integer sum, so every
//     lane holds the same dE, hence the same accept decision, without a
//     broadcast.  Few chains take large teams (4096 chains fill ~8 warps an
//     SM at L = 8), many chains small ones (32768 need L <= 4 to stay
//     resident in one wave).
//   * Draws ahead.  No draw depends on the chain's state, and neither does
//     the step's beta: lane r computes step t + r's site, height offset,
//     uniform and (scaled) beta, and the walk takes them with __shfl_sync.
//     A batch may run past the chain's last step; those draws are unused.
//     A step's bin changes only at fixed steps, so the walk keeps the step
//     at which the current bin ends and needs no division a step.
//   * Boards in shared memory, one byte a cell (heights lie in [0, N) and
//     N <= 127; the wrapper refuses heights outside [0, N)).  A CTA copies
//     its chains' heights in at the start, coalesced over neighbouring
//     chains, and back at the end; best boards are never read in (an
//     improvement overwrites all of one), and are written back only for
//     the chains that improved in this launch.  An improvement copies the
//     board shared to shared, a word a lane at a time.  With track_best off
//     a slot holds no best board.  Rows are padded to an odd number of
//     words and slots to an odd number of words, so that a team's column
//     and diagonal reads and the teams of a warp fall in different banks.
//     The SMEM = false instance walks the same code on the chains-minor
//     device arrays, for N > 127 (layout chosen by the wrapper's rule,
//     kernels/board_shared.py:layout, not a fallback).
//   * Every lane of a team stores the new height, so every lane reads its
//     own stores and no barrier separates a step's store from the next
//     step's reads.  A lane reads the step's old height before the team's
//     reduce and any lane stores only after it, so no lane reads a height
//     of this step's store.  A best copy follows the store in each lane.
//   * Bookkeeping in registers: energy, best, best step, patience counter,
//     stop step; accepts and proposals counted in registers and added to the
//     (n_bins, C) bins when the bin changes and at the end.
//   * All 32 lanes of a warp take every shuffle (full masks).  A team whose
//     chain has stopped, is frozen or does not exist keeps walking the
//     warp's steps and changes nothing; the warp stops when no team is live.
//
// Bitwise contract with the JAX kernel and the twin: hash arithmetic in
// uint32_t (signed overflow is undefined in C++; int32 wrap-around is what
// the JAX kernel computes), % and / only on non-negative operands (C
// truncates where jnp floors), expf (not __expf), built with -fmad=false and
// without --use_fast_math.  The per-step betas come from the wrapper, which
// evaluates the schedule once per chunk for the kernel and the twin alike;
// a tempered chain multiplies its beta by its own scale in float32 before
// the exp, as the JAX kernel does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxChainsPerCta = 128;
constexpr int kMaxThreadsPerCta = 1024;
constexpr int kMaxSharedN = 127;
constexpr int kNever = 0x7FFFFFFF;

// A board row's bytes in shared memory: N rounded up to an odd number of
// words.  Mirrored by kernels/board_shared.py:row_pitch.
__host__ __device__ inline int row_pitch(int N) {
  return 4 * (((N + 3) / 4) | 1);
}

// A chain's slot in shared memory: its board and (track_best) best board,
// an odd number of words.  Mirrored by kernels/board_shared.py:slot_bytes.
__host__ __device__ inline int slot_bytes(int N, int track_best) {
  return 4 * (((track_best ? 2 : 1) * N * row_pitch(N) / 4) | 1);
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
// offset d2 when the site's queen moves from old_k to new_k.
__device__ __forceinline__ int line_score(int hp, int old_k, int new_k,
                                          int d2) {
  const int dn = hp - new_k;
  const int dl = hp - old_k;
  return (dn == 0) - (dl == 0) + (dn * dn == d2) - (dl * dl == d2);
}

struct Args {
  int32_t *heights, *best_heights, *energy, *best_energy, *best_step,
      *no_improve, *stop_step, *accept_bins, *total_bins;
  const int32_t *chain_seeds, *block_seeds;
  const float *beta, *beta_scale;
  const int32_t* freeze;
  int step0, n_inner, N, C, c_blk, n_steps, n_bins, patience, track_best;
};

// One chain's board: bytes in a shared-memory slot (rows `pitch` apart) or
// the chain's int32 column of a chains-minor (N*N, C) device array.
template <bool SMEM>
struct Board;

template <>
struct Board<true> {
  uint8_t* p;
  int pitch;
  __device__ __forceinline__ int at(int i, int j) const {
    return p[i * pitch + j];
  }
  __device__ __forceinline__ void set(int i, int j, int v) const {
    p[i * pitch + j] = (uint8_t)v;
  }
  // Lane r of L copies words r, r + L, ... of the slot's board.
  __device__ __forceinline__ void copy_to(const Board& dst, int N, int r,
                                          int L) const {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(p);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst.p);
    for (int w = r; w < N * pitch / 4; w += L) d[w] = s[w];
  }
};

template <>
struct Board<false> {
  int32_t* p;
  int N;
  size_t sC;
  __device__ __forceinline__ int at(int i, int j) const {
    return p[(size_t)(i * N + j) * sC];
  }
  __device__ __forceinline__ void set(int i, int j, int v) const {
    p[(size_t)(i * N + j) * sC] = v;
  }
  __device__ __forceinline__ void copy_to(const Board& dst, int, int r,
                                          int L) const {
    for (int x = r; x < N * N; x += L) dst.p[(size_t)x * sC] = p[(size_t)x * sC];
  }
};

template <int L>
__device__ __forceinline__ int team_sum(int v) {
#pragma unroll
  for (int m = 1; m < L; m <<= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

template <int L, typename T>
__device__ __forceinline__ T from_lane(T v, int lane) {
  return L > 1 ? __shfl_sync(kFull, v, lane) : v;
}

// One chain's chunk, walked by its team's L lanes (lane r of the team);
// h and bh are its board and best board.  Returns whether it improved.
template <int L, bool SMEM>
__device__ __forceinline__ bool walk(const Args& a, int c, bool exists,
                                     int r, Board<SMEM> h, Board<SMEM> bh) {
  const int N = a.N, NN = N * N;
  const size_t sC = (size_t)a.C;
  const int team_lane0 = (threadIdx.x & 31) - r;
  int e = 0, be = 0, bs = 0, ni = 0, st = 0, t_end = 0;
  uint32_t site_base = 0, g = 0;
  float scale = 1.0f;
  if (exists) {
    e = a.energy[c];
    be = a.best_energy[c];
    bs = a.best_step[c];
    ni = a.no_improve[c];
    st = a.stop_step[c];
    // Steps of a stopped chain, steps at or past n_steps and steps at or
    // past the chain's freeze horizon are inactive: they change no state
    // and count in no bin.
    t_end = min(a.n_inner, a.n_steps - a.step0);
    if (a.freeze) t_end = min(t_end, a.freeze[c] - a.step0);
    if (st < a.n_steps) t_end = 0;
    site_base = (uint32_t)a.block_seeds[c / a.c_blk] * 0x2545F491u +
                0x9E3779B9u;
    const uint32_t s = (uint32_t)a.chain_seeds[c];
    g = s * 0x85EBCA6Bu + lowbias32(s);
    if (a.beta_scale) scale = a.beta_scale[c];
  }
  // The warp's steps: every lane walks them all.
  const int T = __reduce_max_sync(kFull, t_end);
  bool improved = false;
  // The current bin, the first step past it, and this chain's accepts and
  // proposals in it.
  int bin = 0, bin_end = -1, n_acc = 0, n_tot = 0;

  for (int tb = 0; tb < T; tb += L) {
    if (!__any_sync(kFull, tb < t_end && st >= a.n_steps)) break;
    // Draws of step tb + r.
    const int tl = tb + r;
    int dij = 0, dkr = 0;
    float du = 0.0f, dbeta = 0.0f;
    if (tl < T) {
      const uint32_t gs = (uint32_t)(a.step0 + tl);
      const uint32_t hv = lowbias32(gs ^ site_base) & 0x7FFFFFFFu;
      const int cell = (int)(hv % (uint32_t)NN);
      const int i = cell / N;
      dij = i | ((cell - i * N) << 16);
      const uint32_t base = lowbias32(g ^ (gs * 0x9E3779B9u));
      const uint32_t w0 = lowbias32(base ^ 0x68BC21EBu) & 0x7FFFFFFFu;
      const uint32_t w1 = lowbias32(base + 0x02E5BE93u);
      dkr = (int)(w0 % (uint32_t)(N - 1));
      du = (float)((w1 >> 7) & 0xFFFFFFu) * (1.0f / 16777216.0f);
      dbeta = a.beta[tl];
      if (a.beta_scale) dbeta = dbeta * scale;
    }
    const int n = min(L, T - tb);
    for (int q = 0; q < n; ++q) {
      const int t = tb + q, gstep = a.step0 + t;
      const int ij = from_lane<L>(dij, team_lane0 + q);
      const int kr = from_lane<L>(dkr, team_lane0 + q);
      const float u = from_lane<L>(du, team_lane0 + q);
      const float bt = from_lane<L>(dbeta, team_lane0 + q);
      const int i = ij & 0xFFFF, j = ij >> 16;
      if (gstep >= bin_end) {
        // gstep < n_steps here and n_steps * n_bins < 2^31 (ChainSpec
        // guard); bin b ends at the first step s with s * n_bins >= (b + 1)
        // * n_steps.
        if (n_tot && r == 0) {
          a.accept_bins[(size_t)bin * sC + c] += n_acc;
          a.total_bins[(size_t)bin * sC + c] += n_tot;
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
      const int old_k = h.at(i, j);
      // (old_k + 1 + kr) % N with 0 <= old_k < N and 0 <= kr <= N - 2
      int new_k = old_k + 1 + kr;
      if (new_k >= N) new_k -= N;
      int de = 0;
      for (int x = r; x < N; x += L) {
        const int dj = x - j;  // offset along row i
        const int d = x - i;   // offset along column j and both diagonals
        if (dj != 0) de += line_score(h.at(i, x), old_k, new_k, dj * dj);
        if (d != 0) {
          const int d2 = d * d;
          de += line_score(h.at(x, j), old_k, new_k, d2);
          const int jd = j + d;
          if (jd >= 0 && jd < N) de += line_score(h.at(x, jd), old_k, new_k, d2);
          const int ja = j - d;
          if (ja >= 0 && ja < N) de += line_score(h.at(x, ja), old_k, new_k, d2);
        }
      }
      de = team_sum<L>(de);
      const bool accept = live && u < expf(-bt * (float)de);
      if (accept) {
        h.set(i, j, new_k);
        e += de;
      }
      if (live) {
        if (accept && e < be) {
          be = e;
          bs = gstep + 1;
          ni = 0;
          improved = true;
          if (a.track_best) h.copy_to(bh, N, r, L);
        } else {
          ni += 1;
        }
        if (a.patience >= 0 && ni >= a.patience) st = gstep;
        n_acc += accept ? 1 : 0;
        n_tot += 1;
      }
    }
  }
  if (r == 0 && exists) {
    if (n_tot) {
      a.accept_bins[(size_t)bin * sC + c] += n_acc;
      a.total_bins[(size_t)bin * sC + c] += n_tot;
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
// SMEM: dynamic shared memory of 4 * cpb bytes of flags (a chain improved
// in this launch) and cpb slots of slot_bytes(N, track_best).
template <int L, bool SMEM>
__global__ void __launch_bounds__(kMaxThreadsPerCta, 1)
    board_shared_kernel(Args a, int cpb) {
  extern __shared__ int32_t smem[];
  const int team = threadIdx.x / L, r = threadIdx.x % L;
  const int c0 = blockIdx.x * cpb, c = c0 + team;
  const bool exists = c < a.C;
  const size_t sC = (size_t)a.C;
  if (!SMEM) {
    // A team past the last chain walks (and never writes) the last chain.
    const size_t cc = (size_t)min(c, a.C - 1);
    const Board<false> h = {a.heights + cc, a.N, sC};
    const Board<false> bh = {a.best_heights + cc, a.N, sC};
    walk<L, false>(a, c, exists, r, h, bh);
    return;
  }
  const int N = a.N, NN = N * N, pitch = row_pitch(N);
  const int S = slot_bytes(N, a.track_best);
  int* const flags = smem;
  uint8_t* const slots = reinterpret_cast<uint8_t*>(smem + cpb);
  // Neighbouring threads take neighbouring chains: a warp reads one cell of
  // 32 chains, contiguous in the device array.
  for (int idx = threadIdx.x; idx < NN * cpb; idx += blockDim.x) {
    const int x = idx / cpb, w = idx - x * cpb;
    if (c0 + w < a.C) {
      const int i = x / N;
      slots[(size_t)w * S + i * pitch + (x - i * N)] =
          (uint8_t)a.heights[(size_t)x * sC + c0 + w];
    }
  }
  __syncthreads();
  uint8_t* const slot = slots + (size_t)team * S;
  const Board<true> h = {slot, pitch};
  const Board<true> bh = {slot + N * pitch, pitch};
  const bool improved = walk<L, true>(a, c, exists, r, h, bh);
  if (r == 0) flags[team] = improved;
  __syncthreads();
  for (int idx = threadIdx.x; idx < NN * cpb; idx += blockDim.x) {
    const int x = idx / cpb, w = idx - x * cpb;
    if (c0 + w < a.C) {
      const int i = x / N;
      const uint8_t* p = slots + (size_t)w * S + i * pitch + (x - i * N);
      a.heights[(size_t)x * sC + c0 + w] = p[0];
      if (a.track_best && flags[w]) {
        a.best_heights[(size_t)x * sC + c0 + w] = p[N * pitch];
      }
    }
  }
}

template <int L, bool SMEM>
int launch(const Args& a, int cpb, int smem, cudaStream_t stream) {
  const auto kernel = board_shared_kernel<L, SMEM>;
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

template <bool SMEM>
int launch_lanes(const Args& a, int lanes, int cpb, int smem,
                 cudaStream_t s) {
  switch (lanes) {
    case 1:
      return launch<1, SMEM>(a, cpb, smem, s);
    case 2:
      return launch<2, SMEM>(a, cpb, smem, s);
    case 4:
      return launch<4, SMEM>(a, cpb, smem, s);
    default:
      return launch<8, SMEM>(a, cpb, smem, s);
  }
}

}  // namespace

// Launch one chunk on `stream`; returns cudaGetLastError() (0 on success).
// All pointers are device pointers to contiguous arrays: heights and
// best_heights (N*N, C), every height in [0, N); energy .. stop_step,
// chain_seeds (C); accept_bins, total_bins (n_bins, C); block_seeds (C /
// c_blk); beta (n_inner) float32; beta_scale (C) float32, or null for an
// untempered run; freeze (C) int32 step horizons, or null for none.
// patience < 0 disables early stopping; track_best 0 leaves best_heights
// untouched.  The layout (kernels/board_shared.py:layout): `lanes` (1, 2, 4
// or 8) lanes a chain, `chains_per_cta` (a power of two, at most 128, with
// lanes * chains_per_cta a multiple of 32 and at most 1024) chains a CTA,
// and smem_bytes the CTA's shared memory: 4 * chains_per_cta * (1 +
// slot_bytes(N, track_best) / 4) to keep the boards there (N <= 127), or 0
// to walk them in device memory.  Anything else returns
// cudaErrorInvalidValue.
extern "C" int mcq_board_shared_segment(
    void* heights, void* best_heights, void* energy, void* best_energy,
    void* best_step, void* no_improve, void* stop_step, void* accept_bins,
    void* total_bins, const void* chain_seeds, const void* block_seeds,
    const void* beta, const void* beta_scale, const void* freeze, int step0,
    int n_inner, int N, int C, int c_blk, int n_steps, int n_bins,
    int patience, int track_best, int lanes, int chains_per_cta,
    int smem_bytes, void* stream) {
  const Args a = {(int32_t*)heights,       (int32_t*)best_heights,
                  (int32_t*)energy,        (int32_t*)best_energy,
                  (int32_t*)best_step,     (int32_t*)no_improve,
                  (int32_t*)stop_step,     (int32_t*)accept_bins,
                  (int32_t*)total_bins,    (const int32_t*)chain_seeds,
                  (const int32_t*)block_seeds, (const float*)beta,
                  (const float*)beta_scale, (const int32_t*)freeze,
                  step0, n_inner, N, C, c_blk, n_steps, n_bins, patience,
                  track_best};
  const int cpb = chains_per_cta;
  const bool lanes_ok = lanes == 1 || lanes == 2 || lanes == 4 || lanes == 8;
  const bool cpb_ok = cpb >= 1 && cpb <= kMaxChainsPerCta &&
                      (cpb & (cpb - 1)) == 0 && (cpb * lanes) % 32 == 0 &&
                      cpb * lanes <= kMaxThreadsPerCta;
  const bool smem_ok =
      smem_bytes == 0 ||
      (N <= kMaxSharedN &&
       smem_bytes == 4 * cpb + cpb * slot_bytes(N, track_best));
  if (!lanes_ok || !cpb_ok || !smem_ok || C < 1 || c_blk < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  return smem_bytes ? launch_lanes<true>(a, lanes, cpb, smem_bytes, s)
                    : launch_lanes<false>(a, lanes, cpb, 0, s);
}
