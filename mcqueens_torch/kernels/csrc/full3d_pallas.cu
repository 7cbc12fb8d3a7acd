// Per-chain full-3D Metropolis for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel mcqueens/kernels/full3d_pallas.py:_kernel.
// Plain-torch twin: mcqueens_torch/kernels/full3d_pallas.py:
// segment_reference.
//
// Q queens sit on distinct cells of the N^3 cube.  Every chain draws its own
// mover (w_q % Q), accept word and target cells from its own seed's counter
// stream, so no two chains share anything.  The target is the first free
// cell among the attempts a = 0, 1, ... (cell word_from_base(base, salt + a)
// % N^3, tested against the chain's ceil(N^3/32)-word occupancy bitfield;
// exact rejection sampling, no cap), and
//     dE = sum over the other Q-1 queens of attack(queen, new) -
//          attack(queen, old).
//
// What bounds it on the H100: issued instructions.  Per step a chain scores
// its Q queens against two cells (2 x 13 ops a queen for the attack test
// below and 3 to unpack the queen, the count chip_smoke.py's bound takes;
// the JAX kernel's form takes 2 x 22), against 4*(7Q + N^3/32) bytes of
// state read and written once a launch.  The parent design
// (a warp per chain, four chains a CTA) repeated every piece of a step's
// scalar work in all 32 lanes (three
// hashes, four run-time divisions, the beta load and expf, the bin
// bookkeeping with a 64-bit division at each bin edge), split Q queens
// unevenly over 32 lanes with a divergent skip of the mover's row, tested
// attacks on the ALU pipe alone, hashed and tested 32 rejection attempts on
// the serial path of every step, and copied the queens at every
// improvement.  Design:
//   * A team of L lanes a chain (L = 1, 2, 4, 8, 16 or 32; a team sits
//     inside one warp).  Lane r scores the queens r, r + L, ... and the team
//     sums dE with __shfl_xor_sync (one __reduce_add_sync at L = 32): an
//     integer sum, so every lane holds the same dE, hence the same accept
//     decision, without a broadcast.  Few chains take large teams (a step's
//     latency), many chains small ones (a warp instruction serves 32 / L
//     chains); the rule is kernels/full3d_pallas.py:layout, a cost model
//     fitted to every team size timed at the main paths' launches.
//   * Proposals a batch ahead.  No draw depends on the chain's state, and
//     neither does the step's beta: lane r computes step t + r's mover,
//     uniform, beta and the cells of its first kAttempts rejection attempts
//     (divisions by Q and N^3 as multiply-high by constants the entry point
//     computes), a batch before it is used, and the walk takes them with
//     __shfl_sync.  A step itself only tests those cells against the
//     bitfield and takes the first free one.  Attempts kAttempts,
//     kAttempts + 1, ... (one free cell in N^3 / (N^3 - Q) attempts
//     expected: N=12, Q=144 needs the third attempt in 0.7% of its steps)
//     are hashed in the step, L a round, the first free one picked by
//     __ballot_sync and __ffs in the team's bits; the rounds run while any
//     team of the warp still lacks a cell (__any_sync, full masks).  The
//     full-3D scan kernel (csrc/full3d_scan.cu) draws two attempts ahead for
//     the same reason.
//   * The pass without a branch: every row is scored, the mover's included,
//     in passes that are the same for every lane of the warp (kRowsAhead
//     rows loaded before any is scored, then the Q % L rows that remain,
//     where a lane without a row loads nothing and counts 0).  The attack
//     test (hits below) runs on exact small floats: the FP32 pipe issues a
//     warp's FADD, FMUL and FFMA at one a clock, where IMADs take the heavy
//     FMA pipe at half that and the ALU pipe is half-rate too.  It gives 1
//     at distance 0, so the mover's own row adds hits(old, new) - 1, which
//     the team's sum cancels (the JAX kernel's test gives 8 there and
//     cancels 8).  The JAX kernel's squared test ((a == 0) + (a == m) and
//     products) and the same identity in int32 were slower on the card
//     (pair_scan_slice.py --only full3d_pallas_variants builds and times
//     both, with their SASS by pipe).
//   * Queens in shared memory for the whole launch, one word a queen (x |
//     y << 8 | z << 16; a chain's bitfield in a block's shared memory caps N
//     at 122), then the best queens, then the bitfield: a slot of
//     slot_words(Q, N, L) words, rounded so that a warp's loads of its
//     teams' queens fall in 32 banks.  A team copies its chain's rows in at
//     the start and back at the end; best queens are never read in (an
//     improvement overwrites all of them) and are written back only for a
//     chain that improved in this launch.
//   * Cross-lane order: a lane reads only what it stored, what a shuffle
//     hands it, or what __syncwarp published.  Lane r owns rows r, r + L,
//     ...: it alone loads, stores, scores and copies them, so the mover's
//     cell is read by its owner and handed to the team by __shfl_sync, and
//     the owner stores the new cell.  Every lane of the team clears the old
//     cell's bit and sets the new one in the bitfield (the same stores in
//     every lane), so each lane's tests read its own stores; the bitfield
//     loaded at the start reaches the team through a __syncwarp.
//   * Bookkeeping in registers: energy, best, best step, patience counter,
//     stop step; accepts and proposals counted in registers and added to
//     the chain's (n_bins) row when the bin turns (at a precomputed step, no
//     division a step) and at the end.
//   * All 32 lanes of a warp take every shuffle, vote and ballot (full
//     masks).  A team whose chain has stopped, or does not exist (a ragged
//     last CTA), keeps walking the warp's steps and changes nothing; the
//     warp stops when no team is live.
//
// Bitwise contract with the JAX kernel and the twin: hash arithmetic in
// uint32_t (base + salt wraps, as the JAX int32 sum does), / and % only on
// non-negative operands (the dividends are masked to 31 bits), expf (not
// __expf), built with -fmad=false and without --use_fast_math; the
// per-step betas come from the wrapper.  The bin of a step is min(step *
// n_bins / n_steps, n_bins - 1) in 64-bit arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

#include "exact_div.cuh"

namespace {

// The exact division by a launch's invariant divisors (exact_div.cuh).
using mcq::Div;
using mcq::make_div;
using mcq::quot;
using mcq::quot2;

constexpr unsigned kFull = 0xffffffffu;
// __launch_bounds__(256, 2) lets ptxas use up to 128 registers a thread: the
// pass's eight rows in flight take ~76 (80 allocated), which
// kernels/full3d_pallas.py:REGISTERS reckons with and chip_smoke.py checks.
// The caps of (256, 3) and (256, 4), 80 and 64 registers, are timed beside
// it by pair_scan_slice.py --only full3d_pallas_variants.
constexpr int kMaxThreadsPerCta = 256;
constexpr int kMinCtasPerSm = 2;
constexpr int kMaxSmemPerCta = 232448;  // a block's opt-in limit on sm_90
constexpr int kMaxN = 122;
constexpr int kAttempts = 2;  // rejection attempts drawn a batch ahead
constexpr int kRowsAhead = 8;  // rows a lane loads before it scores them
constexpr uint32_t kAttemptSalt = 0x3C6EF372u;
constexpr int kNever = 0x7FFFFFFF;

// A chain's shared-memory slot in words: its Q queens, Q best queens and
// ceil(N^3/32) bitfield words, rounded up to L (mod 2L) for L < 32 so that
// team t, lane r's load of word t * slot + r + L * i falls in its own bank
// (at L = 32 a warp holds one team and no rounding is needed).  Mirrored by
// kernels/full3d_pallas.py:slot_words.
__host__ __device__ inline int slot_words(int Q, int N, int L) {
  const int s = 2 * Q + (N * N * N + 31) / 32;
  return L < 32 ? s + ((L - s % (2 * L)) % (2 * L) + 2 * L) % (2 * L) : s;
}

__device__ __forceinline__ uint32_t lowbias32(uint32_t z) {
  z ^= z >> 16;
  z *= 0x7FEB352Du;
  z ^= z >> 15;
  z *= 0x846CA68Bu;
  z ^= z >> 16;
  return z;
}

__device__ __forceinline__ uint32_t pack(uint32_t x, uint32_t y, uint32_t z) {
  return x | y << 8 | z << 16;
}

// Coordinate k (0, 1 or 2) of a packed cell as the float 2^23 + x, exact:
// one byte permute puts the byte under the exponent of 2^23.
__device__ __forceinline__ float coord(uint32_t w, int k) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7650 + k));
}

struct Cell {
  float x, y, z;
};

__device__ __forceinline__ Cell cell_of(uint32_t w) {
  return {coord(w, 0), coord(w, 1), coord(w, 2)};
}

// Whether cells at distance (rx, ry, rz) attack or coincide.  Two distinct
// cells attack iff every nonzero |r| equals the largest, m: the sum of
// |r| (m - |r|), whose terms are all >= 0, is 0.  So they attack iff
// sum r^2 == m * sum |r|, exact in float32 (integers below 2^16); at
// distance 0 both sides are 0.  Nine of its twelve instructions (the
// differences, squares, sums and the product) issue on the FP32 pipe at
// the full rate, the two maxima and the compare on the ALU pipe.
__device__ __forceinline__ bool hits(const Cell& q, const Cell& t) {
  const float rx = q.x - t.x, ry = q.y - t.y, rz = q.z - t.z;
  const float s2 = fmaf(rz, rz, fmaf(ry, ry, rx * rx));
  const float s1 = fabsf(rx) + fabsf(ry) + fabsf(rz);
  const float m = fmaxf(fabsf(rx), fmaxf(fabsf(ry), fabsf(rz)));
  return fmaf(m, s1, -s2) == 0.0f;
}

// attack(queen, new) - attack(queen, old) of the queen packed in w.
__device__ __forceinline__ int score(uint32_t w, const Cell& n,
                                     const Cell& o) {
  const Cell q = cell_of(w);
  return (int)hits(q, n) - (int)hits(q, o);
}

struct Args {
  int32_t *qi, *qj, *qk, *bqi, *bqj, *bqk, *occ, *energy, *best_energy,
      *best_step, *no_improve, *stop_step, *accept_bins, *total_bins;
  const int32_t* chain_seeds;
  const float* beta;
  int step0, n_inner, N, Q, C, n_steps, n_bins, patience, n_words, slot;
  Div by_q, by_n3, by_nn, by_n;
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

// One step's draws: the mover, the accept uniform, the beta and the cells
// of the first kAttempts rejection attempts.
struct Draw {
  uint32_t mover, cell[kAttempts];
  float u, beta;
};

template <int L>
__device__ __forceinline__ Draw draw_from(const Draw& d, int lane) {
  Draw s;
  s.mover = from_lane<L>(d.mover, lane);
#pragma unroll
  for (int k = 0; k < kAttempts; ++k) s.cell[k] = from_lane<L>(d.cell[k], lane);
  s.u = from_lane<L>(d.u, lane);
  s.beta = from_lane<L>(d.beta, lane);
  return s;
}

__device__ __forceinline__ bool is_free(const uint32_t* occ, uint32_t cell) {
  return ((occ[cell >> 5] >> (cell & 31)) & 1u) == 0;
}

// One chain's chunk, walked by its team's L lanes (lane r of the team) on
// its slot: queens sq, best queens sq + Q, bitfield socc.  Returns whether
// the chain improved.
template <int L>
__device__ __forceinline__ bool walk(const Args& a, int c, bool exists,
                                     int r, uint32_t* sq, uint32_t* socc) {
  const int N = a.N, Q = a.Q, NN = N * N;
  const uint32_t N3 = (uint32_t)(NN * N);
  uint32_t* const sbq = sq + Q;
  const int team_lane0 = (threadIdx.x & 31) - r;
  const unsigned team_bits =
      (L == 32 ? kFull : (1u << (L % 32)) - 1u) << team_lane0;
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

  // Lane r's draws for step tb + r of its chain (zeros past the warp's
  // steps, never used).
  const auto draw = [&](int tb) {
    Draw d = {};
    const int tl = tb + r;
    if (tl < T) {
      const uint32_t gs = (uint32_t)(a.step0 + tl);
      const uint32_t base = lowbias32(g ^ (gs * 0x9E3779B9u));
      const uint32_t wq = lowbias32(base ^ 0x68BC21EBu) & 0x7FFFFFFFu;
      const uint32_t wu = lowbias32(base + 0x02E5BE93u);
      d.mover = wq - quot(wq, a.by_q) * (uint32_t)Q;
      d.u = (float)((wu >> 7) & 0xFFFFFFu) * (1.0f / 16777216.0f);
      d.beta = a.beta[tl];
#pragma unroll
      for (int k = 0; k < kAttempts; ++k) {
        const uint32_t w =
            lowbias32(base + kAttemptSalt + (uint32_t)k) & 0x7FFFFFFFu;
        d.cell[k] = w - quot2(w, a.by_n3) * N3;
      }
    }
    return d;
  };

  // The batch in use and the next one, drawn a batch ahead; step t's
  // draws, taken from the batch during the step before it.
  Draw cur = draw(0), next;
  Draw now = draw_from<L>(cur, team_lane0);
  for (int t = 0, tb = 0; t < T; ++t) {
    const int q = t - tb, gstep = a.step0 + t;
    if (q == 0) {
      if (!__any_sync(kFull, t < t_end && st >= a.n_steps)) break;
      next = draw(tb + L);
    }
    if (q == L - 1) {
      tb += L;
      cur = next;
    }
    // Step t + 1's draws: the batch's next, or the next batch's first.
    const Draw then = draw_from<L>(cur, team_lane0 + (t + 1 - tb));
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
    // The mover's cell, from the lane that owns its row.
    const int mover = (int)now.mover, owner = mover & (L - 1);
    uint32_t op = 0;
    if (r == owner) op = sq[mover];
    op = from_lane<L>(op, team_lane0 + owner);
    const Cell o = cell_of(op);

    // The target: the first free attempt.  Every lane of the team tests the
    // cells drawn ahead against its own copy of the bitfield's words.
    uint32_t cell = now.cell[kAttempts - 1];
    bool found = false;
#pragma unroll
    for (int k = kAttempts - 1; k >= 0; --k) {
      if (is_free(socc, now.cell[k])) {
        cell = now.cell[k];
        found = true;
      }
    }
    bool need = live && !found;
    if (__any_sync(kFull, need)) {
      // Attempts kAttempts, kAttempts + 1, ..., L a round: lane r hashes
      // attempt a0 + r, and the team's lowest free lane wins.
      const uint32_t base =
          lowbias32(g ^ ((uint32_t)gstep * 0x9E3779B9u));
      for (uint32_t a0 = kAttempts;; a0 += L) {
        const uint32_t w =
            lowbias32(base + kAttemptSalt + a0 + (uint32_t)r) & 0x7FFFFFFFu;
        const uint32_t cand = w - quot2(w, a.by_n3) * N3;
        const bool hit = need && is_free(socc, cand);
        const unsigned hits = __ballot_sync(kFull, hit) & team_bits;
        const uint32_t pick = from_lane<L>(cand, hits ? __ffs(hits) - 1 : 0);
        if (hits) {
          cell = pick;
          need = false;
        }
        if (!__any_sync(kFull, need)) break;
      }
    }
    const uint32_t nx = quot2(cell, a.by_nn);
    const uint32_t rest = cell - nx * NN;
    const uint32_t ny = quot2(rest, a.by_n);
    const uint32_t np = pack(nx, ny, rest - ny * N);
    const Cell n = cell_of(np);

    // The pass: every row, the mover's included (hits(old, new) - 1).
    int de = 0;
    const int full = Q / L;
    int p = 0;
    for (; p + kRowsAhead <= full; p += kRowsAhead) {
      uint32_t w[kRowsAhead];
#pragma unroll
      for (int k = 0; k < kRowsAhead; ++k) w[k] = sq[r + (p + k) * L];
#pragma unroll
      for (int k = 0; k < kRowsAhead; ++k) de += score(w[k], n, o);
    }
    for (; p < full; ++p) de += score(sq[r + p * L], n, o);
    if (Q % L) {
      const int row = r + full * L;
      const uint32_t w = row < Q ? sq[row] : 0u;
      const int s = score(w, n, o);
      de += row < Q ? s : 0;
    }
    de = team_sum<L>(de) - (int)hits(o, n) + 1;

    const bool accept = live && now.u < expf(-now.beta * (float)de);
    if (accept) {
      if (r == owner) sq[mover] = np;
      const uint32_t old_cell =
          ((op & 0xFF) * N + ((op >> 8) & 0xFF)) * N + (op >> 16);
      socc[old_cell >> 5] &= ~(1u << (old_cell & 31));
      socc[cell >> 5] |= 1u << (cell & 31);
      e += de;
    }
    if (live) {
      if (accept && e < be) {
        be = e;
        bs = gstep + 1;
        ni = 0;
        improved = true;
        for (int row = r; row < Q; row += L) sbq[row] = sq[row];
      } else {
        ni += 1;
      }
      if (a.patience >= 0 && ni >= a.patience) st = gstep;
      n_acc += accept ? 1 : 0;
      n_tot += 1;
    }
    now = then;
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

// Launched with cpb * L threads a CTA, chains [blockIdx.x * cpb, + cpb);
// dynamic shared memory: cpb slots of a.slot words.
template <int L>
__global__ void __launch_bounds__(kMaxThreadsPerCta, kMinCtasPerSm)
    full3d_pallas_kernel(Args a, int cpb) {
  extern __shared__ uint32_t smem[];
  const int team = threadIdx.x / L, r = threadIdx.x % L;
  const int c = blockIdx.x * cpb + team;
  const bool exists = c < a.C;
  const int Q = a.Q;
  uint32_t* const sq = smem + (size_t)team * a.slot;
  uint32_t* const socc = sq + 2 * Q;
  const size_t row = (size_t)c * Q, occ_row = (size_t)c * a.n_words;
  if (exists) {
    for (int q = r; q < Q; q += L) {
      sq[q] = pack(a.qi[row + q], a.qj[row + q], a.qk[row + q]);
    }
    for (int w = r; w < a.n_words; w += L) {
      socc[w] = (uint32_t)a.occ[occ_row + w];
    }
  }
  __syncwarp();  // every lane of the team reads the whole bitfield
  const bool improved = walk<L>(a, c, exists, r, sq, socc);
  if (!exists) return;
  for (int q = r; q < Q; q += L) {
    const uint32_t p = sq[q];
    a.qi[row + q] = p & 0xFF;
    a.qj[row + q] = (p >> 8) & 0xFF;
    a.qk[row + q] = p >> 16;
    if (improved) {
      const uint32_t b = sq[Q + q];
      a.bqi[row + q] = b & 0xFF;
      a.bqj[row + q] = (b >> 8) & 0xFF;
      a.bqk[row + q] = b >> 16;
    }
  }
  for (int w = r; w < a.n_words; w += L) {
    a.occ[occ_row + w] = (int32_t)socc[w];
  }
}

template <int L>
int launch(const Args& a, int cpb, int smem, cudaStream_t stream) {
  const auto kernel = full3d_pallas_kernel<L>;
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
// major: qi .. bqk (C, Q), every coordinate in [0, N); occ (C,
// ceil(N^3/32)); energy .. stop_step, chain_seeds (C); accept_bins,
// total_bins (C, n_bins); beta (n_inner) float32.  patience < 0 disables
// early stopping.  The layout (kernels/full3d_pallas.py:layout): `lanes`
// (1, 2, 4, 8, 16 or 32) lanes a chain, `chains_per_cta` chains a CTA
// (lanes * chains_per_cta a multiple of 32 and at most 256), and
// smem_bytes the CTA's shared memory, 4 * chains_per_cta *
// slot_words(Q, N, lanes), at most the 232448 bytes a block may hold (a
// chain needs at least 4 * (2Q + ceil(N^3/32)): N <= 104 at Q = N^2, and N
// <= 122 at any Q).  Anything else, and Q outside [1, N^3), returns
// cudaErrorInvalidValue before anything is launched.
extern "C" int mcq_full3d_pallas_segment(
    void* qi, void* qj, void* qk, void* bqi, void* bqj, void* bqk, void* occ,
    void* energy, void* best_energy, void* best_step, void* no_improve,
    void* stop_step, void* accept_bins, void* total_bins,
    const void* chain_seeds, const void* beta, int step0, int n_inner, int N,
    int Q, int C, int n_steps, int n_bins, int patience, int lanes,
    int chains_per_cta, int smem_bytes, void* stream) {
  const int cpb = chains_per_cta;
  const bool lanes_ok = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  const bool cpb_ok = cpb >= 1 && (cpb * lanes) % 32 == 0 &&
                      cpb * lanes <= kMaxThreadsPerCta;
  const bool sizes_ok = N >= 2 && N <= kMaxN && Q >= 1 && Q < N * N * N;
  if (!lanes_ok || !cpb_ok || !sizes_ok || C < 1 || n_inner < 0 ||
      smem_bytes > kMaxSmemPerCta ||
      (long long)smem_bytes != 4LL * cpb * slot_words(Q, N, lanes)) {
    return (int)cudaErrorInvalidValue;
  }
  const uint32_t NN = (uint32_t)(N * N);
  const Args a = {(int32_t*)qi,          (int32_t*)qj,
                  (int32_t*)qk,          (int32_t*)bqi,
                  (int32_t*)bqj,         (int32_t*)bqk,
                  (int32_t*)occ,         (int32_t*)energy,
                  (int32_t*)best_energy, (int32_t*)best_step,
                  (int32_t*)no_improve,  (int32_t*)stop_step,
                  (int32_t*)accept_bins, (int32_t*)total_bins,
                  (const int32_t*)chain_seeds, (const float*)beta,
                  step0,                 n_inner,
                  N,                     Q,
                  C,                     n_steps,
                  n_bins,                patience,
                  (N * N * N + 31) / 32, slot_words(Q, N, lanes),
                  make_div((uint32_t)Q), make_div(NN * (uint32_t)N),
                  make_div(NN),          make_div((uint32_t)N)};
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
