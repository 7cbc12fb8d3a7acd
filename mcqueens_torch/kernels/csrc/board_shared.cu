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
// What bounds it: int32 issue.  A chain is a serial walk over a tiny board,
// so the card is kept busy by many chains at once, and a step costs the
// instructions its lanes issue (IADD3, LOP3, SHF, VABSDIFF4 on the ALU
// pipe, IMAD on the FMA pipe; shared-memory loads and shuffles through
// MIO): ~210 a lane and step at N=16 and L=4, about half of them scoring
// the lines.  Moving adds from the ALU pipe to IMADs (a runtime 1) was
// timed and lost 5-12%: the count, not the pipe balance, sets the time.
// The earlier design scored a cell at a time: a byte load, two
// differences, two squares and four compares a cell, and three runtime
// divisions a step, ~430 instructions a lane and step.  Design:
//   * A team of L lanes a chain (L = 1, 2, 4 or 8; a team sits inside one
//     warp).  Few chains take large teams, many chains small ones (32768
//     need L <= 4 to stay resident in one wave).
//   * Byte-SIMD scoring on packed rows.  A board row is bytes in shared
//     memory, padded to whole words; lane r scores the words w = r, r + L,
//     ... < ceil(N / 4) of each of the four lines: cells x = 4w .. 4w + 3
//     of row i (one word load) and of column j and both diagonals through
//     (i, j) (rows x, four byte loads packed into a word).  A cell h at
//     offset d along its line counts [|h - new| is 0 or d] - [|h - old| is
//     0 or d]; VABSDIFF4 takes the four |h - k| at once and two adds of
//     0x7F to each byte (no carry: every byte is below 0x80) test them
//     against 0 and d, so four cells cost a dozen instructions.  A byte
//     mask drops cells past N and diagonal cells off the board (bytes
//     compared with the diagonal's bounds the same way), and no branch
//     does; the site's own cell is counted on all four lines and taken
//     back as a constant (bias), which lane 0 adds to its part.  The team
//     sums dE with __shfl_xor_sync.
//   * Shared memory is zeroed before the boards are copied in, with a guard
//     before the first slot and after the last (guard_bytes), so every byte
//     the masked reads touch is a height, a flag or zero.
//   * Draws ahead.  No draw depends on the chain's state, and neither does
//     the step's beta: lane r computes step t + r's site, height offset,
//     uniform and (scaled) beta, and the walk takes them with __shfl_sync.
//     The three divisions of a draw (the site's cell by N^2, its row by N,
//     the height offset by N - 1) are multiply-highs by divisors the host
//     computes once a launch (exact_div.cuh).  A step's bin changes only at
//     fixed steps, so the walk keeps the step at which the current bin ends.
//   * Every lane evaluates the step's expf.  Skipping it where it cannot
//     change the outcome (dE <= 0 at a finite beta >= 0: u < 1 <= expf)
//     was timed and lost 4-5%: a warp skips only when all its teams may,
//     and the branch costs more than the expf it saves.
//   * Boards in shared memory, one byte a cell (heights lie in [0, N) and
//     N <= 127; the wrapper refuses heights outside [0, N)).  A CTA copies
//     its chains' heights in at the start, coalesced over neighbouring
//     chains, and back at the end; best boards are never read in (an
//     improvement overwrites all of one), and are written back only for
//     the chains that improved in this launch.  An improvement copies the
//     board shared to shared, a word a lane at a time.  With track_best off
//     a slot holds no best board.  Rows are padded to an odd number of
//     words and slots to an odd number of words, so that the teams of a
//     warp fall in different banks.  The SMEM = false instance (N > 127)
//     walks the chains-minor device arrays a cell at a time, as before the
//     redesign (layout chosen by the wrapper's rule,
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

#include "exact_div.cuh"

namespace {

// The exact division by a launch's invariant divisors (exact_div.cuh).
using mcq::Div;
using mcq::make_div;
using mcq::quot;
using mcq::quot2;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxChainsPerCta = 128;
constexpr int kMaxThreadsPerCta = 1024;
constexpr int kMaxSharedN = 127;
constexpr int kNever = 0x7FFFFFFF;
// A byte replicated four times is b * kOnes; kHigh is each byte's bit 7.
constexpr uint32_t kOnes = 0x01010101u;
constexpr uint32_t kHigh = 0x80808080u;
constexpr uint32_t kLow7 = 0x7F7F7F7Fu;

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

// Zeroed bytes before the first slot and after the last: a slot's masked
// reads reach N - 1 bytes before it (the diagonal's cells left of the
// board) and 3 * row_pitch(N) + 2N + 2 past its board (rows past N in a
// ragged last word, diagonal cells right of the board).  Mirrored by
// kernels/board_shared.py:guard_bytes.
__host__ __device__ inline int guard_bytes(int N) {
  return 4 * ((3 * row_pitch(N) + 2 * N + 6) / 4);
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

// Four cells h of one line, byte b of d their offsets along it, bit 7 of
// byte b of on set where the cell counts.  Byte b of the result is [h_b is
// on a line of the new height: |h_b - new| is 0 or d_b] + [h_b is on no
// line of the old one], 0 to 2.  Every byte of h, n4, o4 and d is below
// 0x80, so adding 0x7F to a byte never carries into the next and sets its
// bit 7 exactly where the byte is not 0.
__device__ __forceinline__ uint32_t score4(uint32_t h, uint32_t n4,
                                           uint32_t o4, uint32_t d,
                                           uint32_t on) {
  const uint32_t an = __vabsdiffu4(h, n4), ao = __vabsdiffu4(h, o4);
  const uint32_t hit_new = ~((an + kLow7) & ((an ^ d) + kLow7)) & on;
  const uint32_t miss_old = (ao + kLow7) & ((ao ^ d) + kLow7) & on;
  return (hit_new >> 7) + (miss_old >> 7);
}

// Bytes p[0], p[s], p[2s], p[3s] as one word, the first lowest.
__device__ __forceinline__ uint32_t gather4(const uint8_t* p, int s) {
  return (uint32_t)p[0] | (uint32_t)p[s] << 8 | (uint32_t)p[2 * s] << 16 |
         (uint32_t)p[3 * s] << 24;
}

struct Args {
  int32_t *heights, *best_heights, *energy, *best_energy, *best_step,
      *no_improve, *stop_step, *accept_bins, *total_bins;
  const int32_t *chain_seeds, *block_seeds;
  const float *beta, *beta_scale;
  const int32_t* freeze;
  int step0, n_inner, N, C, c_blk, n_steps, n_bins, patience, track_best;
  Div by_nn, by_n, by_nm1;  // N^2, N and N - 1
};

// One chain's board: bytes in a shared-memory slot (rows `pitch` apart) or
// the chain's int32 column of a chains-minor (N*N, C) device array.  Each
// scores a step's lines: lane r of a team of L returns its part of dE, and
// the team's sum is dE.
template <bool SMEM>
struct Board;

template <>
struct Board<true> {
  uint8_t* p;
  int pitch, N;
  int words;      // ceil(N / 4): the words of a row that hold cells
  uint32_t last;  // bit 7 of each byte of the last word that holds a cell
  __device__ Board(uint8_t* p_, int N_)
      : p(p_), pitch(row_pitch(N_)), N(N_), words((N_ + 3) / 4),
        last(kHigh >> (8 * (4 * ((N_ + 3) / 4) - N_))) {}
  __device__ __forceinline__ int at(int i, int j) const {
    return p[i * pitch + j];
  }
  __device__ __forceinline__ void set(int i, int j, int v) const {
    p[i * pitch + j] = (uint8_t)v;
  }
  // Lane r of L copies words r, r + L, ... of the slot's board.
  __device__ __forceinline__ void copy_to(const Board& dst, int r,
                                          int L) const {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(p);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst.p);
    for (int w = r; w < N * pitch / 4; w += L) d[w] = s[w];
  }
  // dE less the lines' score4 counts: each line's cells count 0 to 2 where
  // they should count -1 to 1, and the site itself, which every line
  // counts as 0 (|old - new| is neither 0 nor its offset 0; |old - old| is
  // 0), should not count.  The diagonal through (i, j) holds cells (x, j +
  // x - i) for x in [max(i - j, 0), min(N + i - j, N)), the antidiagonal
  // (x, j - x + i) for x in [max(i + j + 1 - N, 0), min(i + j + 1, N)).
  __device__ __forceinline__ int bias(int i, int j) const {
    const int on = 2 * N + min(N + i - j, N) - max(i - j, 0) +
                   min(i + j + 1, N) - max(i + j + 1 - N, 0);
    return 4 - on;
  }
  template <int L>
  __device__ __forceinline__ int delta(int r, int i, int j, int old_k,
                                       int new_k) const {
    const uint32_t n4 = new_k * kOnes, o4 = old_k * kOnes;
    const uint32_t i4 = i * kOnes, j4 = j * kOnes;
    const uint32_t dlo = max(i - j, 0) * kOnes, dhi = min(N + i - j, N) * kOnes;
    const uint32_t alo = max(i + j + 1 - N, 0) * kOnes,
                   ahi = min(i + j + 1, N) * kOnes;
    const uint8_t* const row = p + i * pitch;
    int sum = r == 0 ? bias(i, j) : 0;
    for (int w = r; w < words; w += L) {
      const int x = 4 * w;
      // Byte b: the cell's column along row i, its row along the others.
      const uint32_t x4 = 0x03020100u + x * kOnes, x8 = x4 | kHigh;
      const uint32_t on = w == words - 1 ? last : kHigh;
      // Bit 7 of (x | 0x80) - lo is [x >= lo] (no borrow: lo <= 127).
      const uint32_t on_d = (x8 - dlo) & ~(x8 - dhi) & on;
      const uint32_t on_a = (x8 - alo) & ~(x8 - ahi) & on;
      const uint32_t dr = __vabsdiffu4(x4, j4), dc = __vabsdiffu4(x4, i4);
      const uint8_t* const c = p + x * pitch + j;
      uint32_t n = score4(*reinterpret_cast<const uint32_t*>(row + x), n4, o4,
                          dr, on);
      n += score4(gather4(c, pitch), n4, o4, dc, on);
      n += score4(gather4(c + x - i, pitch + 1), n4, o4, dc, on_d);
      n += score4(gather4(c - x + i, pitch - 1), n4, o4, dc, on_a);
      sum += (n * kOnes) >> 24;  // at most 32: no byte of the sum carries
    }
    return sum;
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
  __device__ __forceinline__ void copy_to(const Board& dst, int r,
                                          int L) const {
    for (int x = r; x < N * N; x += L) dst.p[(size_t)x * sC] = p[(size_t)x * sC];
  }
  // Lane r scores the offsets x = r, r + L, ... of the four lines.
  template <int L>
  __device__ __forceinline__ int delta(int r, int i, int j, int old_k,
                                       int new_k) const {
    int de = 0;
    for (int x = r; x < N; x += L) {
      const int dj = x - j;  // offset along row i
      const int d = x - i;   // offset along column j and both diagonals
      if (dj != 0) de += line_score(at(i, x), old_k, new_k, dj * dj);
      if (d != 0) {
        const int d2 = d * d;
        de += line_score(at(x, j), old_k, new_k, d2);
        const int jd = j + d;
        if (jd >= 0 && jd < N) de += line_score(at(x, jd), old_k, new_k, d2);
        const int ja = j - d;
        if (ja >= 0 && ja < N) de += line_score(at(x, ja), old_k, new_k, d2);
      }
    }
    return de;
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
  const int N = a.N;
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
    // Draws of step tb + r: the site (i, j) and the height offset kr, each
    // below 2^16 (SMEM: below 2^8, packed into one word).
    const int tl = tb + r;
    int dij = 0, dkr = 0;
    float du = 0.0f, dbeta = 0.0f;
    if (tl < T) {
      const uint32_t gs = (uint32_t)(a.step0 + tl);
      const uint32_t hv = lowbias32(gs ^ site_base) & 0x7FFFFFFFu;
      const uint32_t cell = hv - quot2(hv, a.by_nn) * (uint32_t)(N * N);
      const uint32_t i = quot2(cell, a.by_n);
      const uint32_t base = lowbias32(g ^ (gs * 0x9E3779B9u));
      const uint32_t w0 = lowbias32(base ^ 0x68BC21EBu) & 0x7FFFFFFFu;
      const uint32_t w1 = lowbias32(base + 0x02E5BE93u);
      dkr = (int)(w0 - quot(w0, a.by_nm1) * (uint32_t)(N - 1));
      if (SMEM) {
        dij = (int)(i | (cell - i * N) << 8) | dkr << 16;
      } else {
        dij = (int)(i | (cell - i * N) << 16);
      }
      du = (float)((w1 >> 7) & 0xFFFFFFu) * (1.0f / 16777216.0f);
      dbeta = a.beta[tl];
      if (a.beta_scale) dbeta = dbeta * scale;
    }
    const int n = min(L, T - tb);
    for (int q = 0; q < n; ++q) {
      const int t = tb + q, gstep = a.step0 + t;
      const int ij = from_lane<L>(dij, team_lane0 + q);
      const float u = from_lane<L>(du, team_lane0 + q);
      const float bt = from_lane<L>(dbeta, team_lane0 + q);
      int i, j, kr;
      if (SMEM) {
        i = ij & 0xFF;
        j = (ij >> 8) & 0xFF;
        kr = ij >> 16;
      } else {
        i = ij & 0xFFFF;
        j = ij >> 16;
        kr = from_lane<L>(dkr, team_lane0 + q);
      }
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
      const int de = team_sum<L>(h.template delta<L>(r, i, j, old_k, new_k));
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
          if (a.track_best) h.copy_to(bh, r, L);
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
// in this launch), a guard, cpb slots of slot_bytes(N, track_best) and a
// guard of guard_bytes(N) each, all zeroed first.
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
  const int S = slot_bytes(N, a.track_best), G = guard_bytes(N);
  int* const flags = smem;
  uint8_t* const slots = reinterpret_cast<uint8_t*>(smem + cpb) + G;
  for (int w = threadIdx.x; w < cpb + (cpb * S + 2 * G) / 4;
       w += blockDim.x) {
    smem[w] = 0;
  }
  __syncthreads();
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
  const Board<true> h(slot, N);
  const Board<true> bh(slot + N * pitch, N);
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
// and smem_bytes the CTA's shared memory: 4 * chains_per_cta +
// chains_per_cta * slot_bytes(N, track_best) + 2 * guard_bytes(N) to keep
// the boards there (N <= 127), or 0 to walk them in device memory.
// Anything else returns cudaErrorInvalidValue.
extern "C" int mcq_board_shared_segment(
    void* heights, void* best_heights, void* energy, void* best_energy,
    void* best_step, void* no_improve, void* stop_step, void* accept_bins,
    void* total_bins, const void* chain_seeds, const void* block_seeds,
    const void* beta, const void* beta_scale, const void* freeze, int step0,
    int n_inner, int N, int C, int c_blk, int n_steps, int n_bins,
    int patience, int track_best, int lanes, int chains_per_cta,
    int smem_bytes, void* stream) {
  const int cpb = chains_per_cta;
  const bool lanes_ok = lanes == 1 || lanes == 2 || lanes == 4 || lanes == 8;
  const bool cpb_ok = cpb >= 1 && cpb <= kMaxChainsPerCta &&
                      (cpb & (cpb - 1)) == 0 && (cpb * lanes) % 32 == 0 &&
                      cpb * lanes <= kMaxThreadsPerCta;
  const bool smem_ok =
      smem_bytes == 0 ||
      (N <= kMaxSharedN &&
       smem_bytes == 4 * cpb + cpb * slot_bytes(N, track_best) +
                         2 * guard_bytes(N));
  if (!lanes_ok || !cpb_ok || !smem_ok || C < 1 || c_blk < 1 || N < 2) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a = {(int32_t*)heights,       (int32_t*)best_heights,
                  (int32_t*)energy,        (int32_t*)best_energy,
                  (int32_t*)best_step,     (int32_t*)no_improve,
                  (int32_t*)stop_step,     (int32_t*)accept_bins,
                  (int32_t*)total_bins,    (const int32_t*)chain_seeds,
                  (const int32_t*)block_seeds, (const float*)beta,
                  (const float*)beta_scale, (const int32_t*)freeze,
                  step0, n_inner, N, C, c_blk, n_steps, n_bins, patience,
                  track_best, make_div((uint32_t)(N * N)),
                  make_div((uint32_t)N), make_div((uint32_t)(N - 1))};
  const cudaStream_t s = (cudaStream_t)stream;
  return smem_bytes ? launch_lanes<true>(a, lanes, cpb, smem_bytes, s)
                    : launch_lanes<false>(a, lanes, cpb, 0, s);
}
