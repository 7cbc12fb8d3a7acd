// Shared-site full-3D Metropolis for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel mcqueens/kernels/full3d_shared.py:_kernel,
// plain and tempered (a per-chain beta scale).  Plain-torch twin:
// mcqueens_torch/kernels/full3d_shared.py:segment_reference.
//
// Chains [b*c_blk, (b+1)*c_blk) form semantic block b: they share each
// step's candidate cell (hashed from the block seed and the step) and each
// H-step chunk's mover queen (hashed from the block seed and the chunk's
// first step).  All queens but the mover stay put for a chunk, so one pass
// over the other Q-1 queens scores them against the chunk's H candidates
// and the mover's chunk-start cell: H + 1 attack counts and an H-bit
// occupancy mask.  The chunk's steps then run from those counts: dE =
// conf[k] - old_conf; an occupied candidate (another queen there, or the
// live mover) makes the step lazy; on accept the mover moves and old_conf
// <- conf[k].  The hold H is a template parameter, 8 (the JAX package's
// _HOLD, every main path's) or 16 or 32 (tools/probe_hold.py's other
// lengths); the numbers below are at H = 8.  A longer hold costs
// (1 + 1/H) pass targets a step in place of 9/8, but holds H candidates'
// counts in registers: at H = 32 and L = 1, five int[32] arrays a lane,
// past the 128 registers __launch_bounds__ leaves, so it spills.
//
// What bounds it: int32 instructions.  The pass issues ~170 a queen (nine
// attack tests and eight occupancy tests, ~19 a (queen, target) pair; ~96
// of the 170 are IMADs, which the FMA pipe takes at half the issue rate, so
// the pass is bound by that pipe), and a chunk's hashes, draws, reduce and
// walk several hundred more.  The parent design (a thread a chain over
// chains-minor device planes) streamed every chain's 3Q words from device
// memory once a chunk (177 MB a chunk at 65536 chains, Q=225), left SMs
// with one warp at 4096 chains, and copied 6Q words device to device at
// every improving chunk.  Design:
//   * A team of L lanes a chain (L = 1, 2, 4, 8, 16 or 32; a team sits in
//     one warp).  Lane r scores the queens q = r, r + L, ... in the pass,
//     so a lane reads and writes only its own rows of the planes; the team
//     sums its counts with __shfl_xor_sync, two 16-bit counts a word (Q <=
//     65536, so no count carries into the next) and the occupancy mask in
//     the high half of the old count's word (a cell holds at most one
//     queen, so the sum is the union): five words, not ten (at H = 32
//     the mask takes a word of its own: 18).  The sums are
//     integers, so every lane holds the same counts and reaches the same
//     accept decision without a broadcast.  The layout rule
//     (kernels/full3d_shared.py:layout) takes large teams when chains are
//     few (more warps an SM) and small ones when they are many (less of each
//     chunk's walk repeated in every lane of a team).
//   * A CTA holds chains of one semantic block only (chains a CTA divide
//     c_blk), so the mover and the 8 candidates are uniform over the CTA:
//     lane l of a warp hashes candidate l % 8 and the warp takes them with
//     __shfl_sync; every lane hashes the mover.
//   * Draws ahead.  No draw depends on a chain's state: lane r draws the
//     accept words and (scaled) betas of steps r, r + L, ... of its chain's
//     chunk, and the walk takes them with __shfl_sync.
//   * The pass runs in two loops, the rows before and after the mover's
//     (uniform over the CTA), so no row is tested against the mover.  The
//     attack test is the identity below; a candidate is occupied iff the
//     least m over the queens is 0, one IMNMX a pair.
//   * Queens in shared memory for the whole launch, one word a queen (x |
//     y << 8 | z << 16; N <= 93).  A CTA copies its chains' (Q, C) planes
//     in at the start, coalesced over neighbouring chains, and back at the
//     end.  The mover's live cell stays in registers for its chunk; the
//     lane that owns the mover's row reads its chunk-start cell and hands it
//     to the team with __shfl_sync (so no lane reads a row another lane
//     stored), and stores the live cell at the chunk end.
//   * Best planes in shared memory too, after the live planes in a chain's
//     slot.  An improving chunk copies the live planes into them shared to
//     shared (each lane its own rows, the mover's row set to its cell at the
//     last improvement: exact, nothing else moved in the chunk); best planes
//     are never read in, and are written back only for the chains that
//     improved in this launch.  The JAX kernel's other scheme, a move log
//     undone newest first at a flush (flush_best), was weighed and not
//     taken: a slot's Q words would not shrink (the log needs room beside
//     them, in shared memory or ~16 registers a lane), and a log that fills
//     mid-launch must write the chain's 3Q best words to device memory one
//     strided word at a time, where this copy costs Q/L shared loads and
//     stores a lane.  Slots of 2Q words hold 128 chains an SM at Q=225
//     (230 KB; 65536 chains run in 3.9 waves of 132 x 128), a log's 1Q
//     words 256 (1.94 waves of 132 x 256): the same whole-card throughput
//     when an SM's warps keep its int32 pipes busy either way.
//   * A slot is 2Q words rounded up so that the words one warp instruction
//     reads fall in 32 different banks: stride = L (mod 2L) for L < 32 (team
//     t, lane r reads word t * stride + r + L * i), odd for L = 32.
//   * Bookkeeping in registers: energy, best, best step, patience counter,
//     stop step; accepts and proposals counted in registers and added to the
//     (n_bins, C) bins, out of line, when the bin changes (at a precomputed
//     step, no division a step) and at the end.  A chunk's eight steps run
//     without a branch, but for the few chunks in which a bin turns.
//   * All 32 lanes of a warp take every shuffle (full masks).  A team whose
//     chain has stopped keeps walking the warp's chunks and changes
//     nothing; the warp stops when no team is live.
//   * The SMEM = false instance walks the same code on the chains-minor
//     device planes (best planes copied device to device at an improving
//     chunk), for slots too large for shared memory, Q > 29055 (layout
//     chosen by the rule, not a fallback).
//
// Bitwise contract with the JAX kernel and the twin: hash arithmetic in
// uint32_t (int32 wrap-around is what the JAX kernel computes; signed
// overflow is undefined in C++), % and / only on non-negative operands,
// expf (not __expf), built with -fmad=false and without --use_fast_math.
// The attack test's int32 sums stay exact for |d| <= 92.  The per-step
// betas come from the wrapper, which evaluates the schedule once per launch
// for the kernel and the twin alike; a tempered chain multiplies its beta
// by its own scale in float32 before the exp.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxChainsPerCta = 128;
constexpr int kMaxThreadsPerCta = 512;
constexpr int kMaxQ = 65536;
constexpr int kMaxN = 93;
constexpr int kNever = 0x7FFFFFFF;

// A chain's shared-memory slot in words: its live and best planes, 2Q
// words rounded up to L (mod 2L), or to an odd count for L = 32.  Mirrored
// by kernels/full3d_shared.py:slot_words.
__host__ __device__ inline int slot_words(int Q, int L) {
  const int m = L < 32 ? 2 * L : 2;
  const int want = L < 32 ? L : 1;
  const int s = 2 * Q;
  return s + (want - s % m + m) % m;
}

__device__ __forceinline__ uint32_t lowbias32(uint32_t z) {
  z ^= z >> 16;
  z *= 0x7FEB352Du;
  z ^= z >> 15;
  z *= 0x846CA68Bu;
  z ^= z >> 16;
  return z;
}

__device__ __forceinline__ uint32_t pack(int x, int y, int z) {
  return (uint32_t)x | (uint32_t)y << 8 | (uint32_t)z << 16;
}

// Two cells at distance (dx, dy, dz) attack iff every nonzero |d| equals
// the largest.  Both tests below return 1 iff they attack (also at distance
// 0, where m == 0: the caller keeps the least m of a target to tell an
// occupied one).  hits_fma: with a = dx^2 etc. and m their largest, sum
// a * (a - m) is a sum of terms <= 0, each 0 iff a is 0 or m, so they
// attack iff a^2 + b^2 + c^2 == m * (a + b + c) (exact in int32 for |d| <=
// 92); most of its instructions are IMADs, which only the FMA pipe issues.
// hits_alu compares |d| with 0 and m, on the ALU pipe.  The pass takes
// hits_fma for 5 of the 8 candidates and hits_alu for 3 (of each 8 at a
// longer hold), the split of the two that ran fastest on the card (PERF.md,
// section 6).
__device__ __forceinline__ int hits_fma(int dx, int dy, int dz, int& m) {
  const int a = dx * dx, b = dy * dy, c = dz * dz;
  m = max(a, max(b, c));
  return a * a + b * b + c * c == m * (a + b + c);
}

__device__ __forceinline__ int hits_alu(int dx, int dy, int dz, int& m) {
  const int a = abs(dx), b = abs(dy), c = abs(dz);
  m = max(a, max(b, c));
  return ((a == 0) | (a == m)) & ((b == 0) | (b == m)) &
         ((c == 0) | (c == m));
}

struct Args {
  int32_t *qi, *qj, *qk, *bqi, *bqj, *bqk, *energy, *best_energy,
      *best_step, *no_improve, *stop_step, *accept_bins, *total_bins;
  const int32_t *chain_seeds, *block_seeds;
  const float *beta, *beta_scale;
  int step0, n_inner, N, Q, C, c_blk, n_steps, n_bins, patience;
};

// The bin of step gstep (< n_steps; n_steps * n_bins < 2^31, a ChainSpec
// guard) and the first step past it: bin b ends at the first step s with s
// * n_bins >= (b + 1) * n_steps.  Out of line, as is add_bins: a bin turns
// at most n_bins times a run, and inlined, the 64-bit division would sit in
// each of the eight unrolled steps of the walk's bin-turning copy.
struct BinSpan {
  int bin, end;
};

__device__ __noinline__ BinSpan bin_of(int gstep, int n_steps, int n_bins) {
  const int bin = min(gstep * n_bins / n_steps, n_bins - 1);
  const int end = bin == n_bins - 1
                      ? kNever
                      : (int)(((long long)(bin + 1) * n_steps + n_bins - 1) /
                              n_bins);
  return {bin, end};
}

// Adds a chain's accepts and proposals of one bin (at its word `at` of the
// (n_bins, C) bins).
__device__ __noinline__ void add_bins(int32_t* accept_bins,
                                      int32_t* total_bins, size_t at,
                                      int n_acc, int n_tot) {
  accept_bins[at] += n_acc;
  total_bins[at] += n_tot;
}

// One chain's queens, one packed word a queen: a shared-memory slot (live
// planes, then best planes) or the chain's column of the (Q, C) planes.
template <bool SMEM>
struct Planes;

template <>
struct Planes<true> {
  uint32_t* p;
  int Q;
  __device__ __forceinline__ uint32_t get(int q) const { return p[q]; }
  __device__ __forceinline__ void set(int q, uint32_t w) const { p[q] = w; }
  __device__ __forceinline__ void set_best(int q, uint32_t w) const {
    p[Q + q] = w;
  }
};

template <>
struct Planes<false> {
  int32_t *qi, *qj, *qk, *bqi, *bqj, *bqk;
  size_t sC;
  __device__ __forceinline__ uint32_t get(int q) const {
    const size_t at = (size_t)q * sC;
    return pack(qi[at], qj[at], qk[at]);
  }
  __device__ __forceinline__ void set(int q, uint32_t w) const {
    const size_t at = (size_t)q * sC;
    qi[at] = w & 0xFF;
    qj[at] = (w >> 8) & 0xFF;
    qk[at] = w >> 16;
  }
  __device__ __forceinline__ void set_best(int q, uint32_t w) const {
    const size_t at = (size_t)q * sC;
    bqi[at] = w & 0xFF;
    bqj[at] = (w >> 8) & 0xFF;
    bqk[at] = w >> 16;
  }
};

// One chain's launch, walked by its team's L lanes (lane r of the team) on
// its planes.  Returns whether the chain improved.
template <int L, bool SMEM, int H>
__device__ __forceinline__ bool walk(const Args& a, int c, int r,
                                     const Planes<SMEM>& pl) {
  constexpr int D = (H + L - 1) / L;  // steps a lane draws a chunk
  // The team's sums: H / 2 words of two counts, then the old count with
  // the occupancy mask in its high half, or beside it when H > 16.
  constexpr int W = H / 2 + (H > 16 ? 2 : 1);
  const int lane0 = (threadIdx.x & 31) - r;
  const int N = a.N, NN = N * N, N3 = NN * N, Q = a.Q;
  const size_t sC = (size_t)a.C;
  int e = a.energy[c];
  int be = a.best_energy[c];
  int bs = a.best_step[c];
  int ni = a.no_improve[c];
  int st = a.stop_step[c];
  // Steps of a stopped chain, and steps at or past n_steps, are inactive:
  // they change no state and count in no bin.
  int t_end = min(a.n_inner, a.n_steps - a.step0);
  if (st < a.n_steps) t_end = 0;
  const uint32_t seed = (uint32_t)a.block_seeds[c / a.c_blk];
  const uint32_t cand_base = seed * 0x2545F491u + 0x7F4A7C15u;
  const uint32_t mover_base = seed * 0x2545F491u + 0x3C6EF372u;
  const uint32_t s = (uint32_t)a.chain_seeds[c];
  const uint32_t g = s * 0x85EBCA6Bu + lowbias32(s);
  const float scale = a.beta_scale ? a.beta_scale[c] : 1.0f;
  // The warp's steps: every lane walks them all.
  const int T = __reduce_max_sync(kFull, t_end);
  bool improved = false;
  // The current bin, the first step past it, and this chain's accepts and
  // proposals in it.
  int bin = 0, bin_end = -1, n_acc = 0, n_tot = 0;

  for (int t0 = 0; t0 < T; t0 += H) {
    if (!__any_sync(kFull, t0 < t_end && st >= a.n_steps)) break;
    const uint32_t g0 = (uint32_t)a.step0 + (uint32_t)t0;
    const int mover =
        (int)((lowbias32(g0 ^ mover_base) & 0x7FFFFFFFu) % (uint32_t)Q);
    // Candidate (lane % H) of the chunk, one a lane; the warp takes all H.
    uint32_t cw[H];
    {
      const uint32_t hv =
          lowbias32((g0 + (threadIdx.x & (H - 1))) ^ cand_base) & 0x7FFFFFFFu;
      const int cell = (int)(hv % (uint32_t)N3);
      const int x = cell / NN, rest = cell - x * NN;
      const int y = rest / N;
      const uint32_t mine = pack(x, y, rest - y * N);
#pragma unroll
      for (int k = 0; k < H; ++k) cw[k] = __shfl_sync(kFull, mine, k);
    }
    // Draws of steps r, r + L, ... of this chunk (past the warp's steps
    // they are not drawn, and never read).
    float du[D], dbt[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const int tl = r + j * L;
      du[j] = 0.0f;
      dbt[j] = 0.0f;
      if (tl < H && t0 + tl < T) {
        const uint32_t gs = g0 + tl;
        const uint32_t base = lowbias32(g ^ (gs * 0x9E3779B9u));
        const uint32_t w1 = lowbias32(base + 0x02E5BE93u);
        du[j] = (float)((w1 >> 7) & 0xFFFFFFu) * (1.0f / 16777216.0f);
        dbt[j] = a.beta[t0 + tl];
        if (a.beta_scale) dbt[j] = dbt[j] * scale;
      }
    }
    // The mover's chunk-start cell, from the lane that owns its row.
    const int owner = mover & (L - 1);
    uint32_t start = r == owner ? pl.get(mover) : 0u;
    if (L > 1) start = __shfl_sync(kFull, start, lane0 + owner);
    const int ox = start & 0xFF, oy = (start >> 8) & 0xFF, oz = start >> 16;

    // The pass: this lane's queens but the mover against the mover's cell
    // and the H candidates, as two runs of rows either side of the mover's
    // (no test of the mover's row in the loop).  A candidate is occupied iff
    // some queen lies at distance 0 from it: least[k] ends 0.
    int cx[H], cy[H], cz[H], conf[H], least[H];
#pragma unroll
    for (int k = 0; k < H; ++k) {
      cx[k] = cw[k] & 0xFF;
      cy[k] = (cw[k] >> 8) & 0xFF;
      cz[k] = cw[k] >> 16;
      conf[k] = 0;
      least[k] = 1;
    }
    int old_hits = 0;
    const auto rows = [&](int q, int end) {
      for (; q < end; q += L) {
        const uint32_t w = pl.get(q);
        const int x = w & 0xFF, y = (w >> 8) & 0xFF, z = w >> 16;
        int m;
        old_hits += hits_fma(x - ox, y - oy, z - oz, m);
#pragma unroll
        for (int k = 0; k < H; ++k) {
          const int dx = x - cx[k], dy = y - cy[k], dz = z - cz[k];
          conf[k] += k % 8 < 5 ? hits_fma(dx, dy, dz, m)
                               : hits_alu(dx, dy, dz, m);
          least[k] = min(least[k], m);
        }
      }
    };
    rows(r, mover);
    rows(mover + 1 + ((r - mover - 1) & (L - 1)), Q);
    uint32_t occupied = 0;
#pragma unroll
    for (int k = 0; k < H; ++k) {
      occupied |= (uint32_t)(least[k] == 0) << k;
    }
    // The team's sums, two counts a word.
    uint32_t v[W];
#pragma unroll
    for (int i = 0; i < H / 2; ++i) {
      v[i] = (uint32_t)conf[2 * i] | (uint32_t)conf[2 * i + 1] << 16;
    }
    if (H > 16) {
      v[H / 2] = (uint32_t)old_hits;
      v[W - 1] = occupied;
    } else {
      v[H / 2] = (uint32_t)old_hits | occupied << 16;
    }
#pragma unroll
    for (int m = 1; m < L; m <<= 1) {
#pragma unroll
      for (int i = 0; i < W; ++i) v[i] += __shfl_xor_sync(kFull, v[i], m);
    }
    int old_conf = (int)(v[H / 2] & 0xFFFFu);
    occupied = H > 16 ? v[W - 1] : v[H / 2] >> 16;

    // The chunk's steps, without a branch but where a bin turns.  Bins
    // follow the warp's steps, live or not (a chain adds only its live
    // steps), so whether one turns inside the chunk is uniform over the
    // warp, and at most n_bins chunks a run take the test each step.
    uint32_t pos = start, best_pos = start;
    bool improved_here = false;
    const auto steps = [&](auto turns) {
#pragma unroll
      for (int k = 0; k < H; ++k) {
        const float u =
            L > 1 ? __shfl_sync(kFull, du[k / L], lane0 + k % L) : du[k];
        const float bt =
            L > 1 ? __shfl_sync(kFull, dbt[k / L], lane0 + k % L) : dbt[k];
        const int t = t0 + k, gstep = a.step0 + t;
        if (decltype(turns)::value && gstep >= bin_end && t < T) {
          if (n_tot && r == 0) {
            add_bins(a.accept_bins, a.total_bins, (size_t)bin * sC + c,
                     n_acc, n_tot);
          }
          const BinSpan span = bin_of(gstep, a.n_steps, a.n_bins);
          bin = span.bin;
          bin_end = span.end;
          n_acc = 0;
          n_tot = 0;
        }
        const bool live = t < t_end && st >= a.n_steps;
        const int ck = (int)((v[k / 2] >> (16 * (k % 2))) & 0xFFFFu);
        const bool lazy = ((occupied >> k) & 1u) || pos == cw[k];
        const int de = ck - old_conf;
        const float p = expf(-bt * (float)de);
        const bool upd = live & !lazy & (u < p);
        if (upd) {
          pos = cw[k];
          old_conf = ck;
          e += de;
        }
        const bool better = upd & (e < be);
        if (better) {
          be = e;
          bs = gstep + 1;
          best_pos = pos;
          improved_here = true;
        }
        ni = better ? 0 : ni + live;
        if (live & (a.patience >= 0) & (ni >= a.patience)) st = gstep;
        n_acc += upd;
        n_tot += live;
      }
    };
    if (t0 + H > bin_end - a.step0) {
      steps(std::true_type());
    } else {
      steps(std::false_type());
    }
    // The mover's live cell back into its row; an improving chunk's live
    // planes into the best planes, the mover where it stood at the last
    // improvement.  Each lane touches only its own rows.
    if (r == owner && pos != start) pl.set(mover, pos);
    if (improved_here) {
      improved = true;
      for (int q = r; q < Q; q += L) {
        pl.set_best(q, q == mover ? best_pos : pl.get(q));
      }
    }
  }
  if (r == 0) {
    if (n_tot) {
      add_bins(a.accept_bins, a.total_bins, (size_t)bin * sC + c, n_acc,
               n_tot);
    }
    a.energy[c] = e;
    a.best_energy[c] = be;
    a.best_step[c] = bs;
    a.no_improve[c] = ni;
    a.stop_step[c] = st;
  }
  return improved;
}

// Launched with cpb * L threads a CTA, chains [blockIdx.x * cpb, + cpb),
// the mover held H steps.  SMEM: dynamic shared memory of cpb flag words (a
// chain improved in this launch) and cpb slots of `slot` words.
template <int L, bool SMEM, int H>
__global__ void __launch_bounds__(kMaxThreadsPerCta, 1)
    full3d_shared_kernel(Args a, int cpb, int slot) {
  extern __shared__ uint32_t smem[];
  const int team = threadIdx.x / L, r = threadIdx.x % L;
  const int c0 = blockIdx.x * cpb, c = c0 + team;
  const size_t sC = (size_t)a.C;
  if (!SMEM) {
    const Planes<false> pl = {a.qi + c,  a.qj + c,  a.qk + c, a.bqi + c,
                              a.bqj + c, a.bqk + c, sC};
    walk<L, false, H>(a, c, r, pl);
    return;
  }
  const int Q = a.Q;
  uint32_t* const flags = smem;
  uint32_t* const slots = smem + cpb;
  // Neighbouring threads take neighbouring chains: a warp reads one queen
  // row of 32 chains, contiguous in the device planes.
  for (int idx = threadIdx.x; idx < Q * cpb; idx += blockDim.x) {
    const int q = idx / cpb, w = idx - q * cpb;
    const size_t at = (size_t)q * sC + c0 + w;
    slots[(size_t)w * slot + q] = pack(a.qi[at], a.qj[at], a.qk[at]);
  }
  __syncthreads();
  const Planes<true> pl = {slots + (size_t)team * slot, Q};
  const bool improved = walk<L, true, H>(a, c, r, pl);
  if (r == 0) flags[team] = improved;
  __syncthreads();
  for (int idx = threadIdx.x; idx < Q * cpb; idx += blockDim.x) {
    const int q = idx / cpb, w = idx - q * cpb;
    const size_t at = (size_t)q * sC + c0 + w;
    const uint32_t* p = slots + (size_t)w * slot + q;
    a.qi[at] = p[0] & 0xFF;
    a.qj[at] = (p[0] >> 8) & 0xFF;
    a.qk[at] = p[0] >> 16;
    if (flags[w]) {
      a.bqi[at] = p[Q] & 0xFF;
      a.bqj[at] = (p[Q] >> 8) & 0xFF;
      a.bqk[at] = p[Q] >> 16;
    }
  }
}

template <int L, bool SMEM, int H>
int launch(const Args& a, int cpb, int smem, cudaStream_t stream) {
  const auto kernel = full3d_shared_kernel<L, SMEM, H>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = a.C / cpb;
  const int threads = cpb * L;
  const int slot = slot_words(a.Q, L);
  kernel<<<blocks, threads, smem, stream>>>(a, cpb, slot);
  return (int)cudaGetLastError();
}

template <bool SMEM, int H>
int launch_lanes(const Args& a, int lanes, int cpb, int smem,
                 cudaStream_t s) {
  switch (lanes) {
    case 1:
      return launch<1, SMEM, H>(a, cpb, smem, s);
    case 2:
      return launch<2, SMEM, H>(a, cpb, smem, s);
    case 4:
      return launch<4, SMEM, H>(a, cpb, smem, s);
    case 8:
      return launch<8, SMEM, H>(a, cpb, smem, s);
    case 16:
      return launch<16, SMEM, H>(a, cpb, smem, s);
    default:
      return launch<32, SMEM, H>(a, cpb, smem, s);
  }
}

template <bool SMEM>
int launch_hold(const Args& a, int hold, int lanes, int cpb, int smem,
                cudaStream_t s) {
  switch (hold) {
    case 16:
      return launch_lanes<SMEM, 16>(a, lanes, cpb, smem, s);
    case 32:
      return launch_lanes<SMEM, 32>(a, lanes, cpb, smem, s);
    default:
      return launch_lanes<SMEM, 8>(a, lanes, cpb, smem, s);
  }
}

}  // namespace

// Launch one history chunk on `stream`; returns cudaGetLastError() (0 on
// success).  All pointers are device pointers to contiguous arrays: qi .. bqk
// (Q, C), every coordinate in [0, N); energy .. stop_step, chain_seeds (C);
// accept_bins, total_bins (n_bins, C); block_seeds (C / c_blk); beta
// (n_inner) float32; beta_scale (C) float32, or null for an untempered run.
// patience < 0 disables early stopping.  hold (8, 16 or 32) is the steps
// a mover is held (kernels/full3d_shared.py:_HOLD; the wrapper refuses a
// hold above 8 on a launch of fewer than 1024 steps, where the JAX kernel
// skips steps).  N <= 93 and Q <= 65536.  The
// layout (kernels/full3d_shared.py:layout): `lanes` (1, 2, 4, 8, 16 or 32)
// lanes a chain, `chains_per_cta` (a power of two, at most 128, dividing
// c_blk, with lanes * chains_per_cta a multiple of 32 and at most 512)
// chains a CTA, and smem_bytes the CTA's shared memory: 4 * chains_per_cta
// * (1 + slot_words(Q, lanes)) to keep the queens there, or 0 to walk them
// in device memory.  Anything else returns cudaErrorInvalidValue.
extern "C" int mcq_full3d_shared_segment(
    void* qi, void* qj, void* qk, void* bqi, void* bqj, void* bqk,
    void* energy, void* best_energy, void* best_step, void* no_improve,
    void* stop_step, void* accept_bins, void* total_bins,
    const void* chain_seeds, const void* block_seeds, const void* beta,
    const void* beta_scale, int step0, int n_inner, int N, int Q, int C,
    int c_blk, int n_steps, int n_bins, int patience, int hold, int lanes,
    int chains_per_cta, int smem_bytes, void* stream) {
  const Args a = {(int32_t*)qi,          (int32_t*)qj,
                  (int32_t*)qk,          (int32_t*)bqi,
                  (int32_t*)bqj,         (int32_t*)bqk,
                  (int32_t*)energy,      (int32_t*)best_energy,
                  (int32_t*)best_step,   (int32_t*)no_improve,
                  (int32_t*)stop_step,   (int32_t*)accept_bins,
                  (int32_t*)total_bins,  (const int32_t*)chain_seeds,
                  (const int32_t*)block_seeds, (const float*)beta,
                  (const float*)beta_scale, step0, n_inner, N, Q, C, c_blk,
                  n_steps, n_bins, patience};
  const int cpb = chains_per_cta;
  const bool lanes_ok = lanes >= 1 && lanes <= 32 &&
                        (lanes & (lanes - 1)) == 0;
  const bool cpb_ok = cpb >= 1 && cpb <= kMaxChainsPerCta &&
                      (cpb & (cpb - 1)) == 0 && (cpb * lanes) % 32 == 0 &&
                      cpb * lanes <= kMaxThreadsPerCta;
  const bool blocks_ok = C >= 1 && c_blk >= 1 && C % c_blk == 0 &&
                         c_blk % cpb == 0;
  const bool sizes_ok = N >= 1 && N <= kMaxN && Q >= 1 && Q <= kMaxQ;
  const bool hold_ok = hold == 8 || hold == 16 || hold == 32;
  const bool smem_ok =
      smem_bytes == 0 ||
      (lanes_ok && smem_bytes == 4 * cpb * (1 + slot_words(Q, lanes)));
  if (!lanes_ok || !cpb_ok || !blocks_ok || !sizes_ok || !hold_ok ||
      !smem_ok) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  return smem_bytes ? launch_hold<true>(a, hold, lanes, cpb, smem_bytes, s)
                    : launch_hold<false>(a, hold, lanes, cpb, 0, s);
}
