// Full-3D Metropolis scan sampler for Hopper (sm_90a).
//
// No Pallas counterpart: the JAX package runs this sampler as one compiled
// XLA scan (mcqueens/chain/full3d.py:_step under run_segment), kernels
// "tables" and "naive".  Plain-torch twin:
// mcqueens_torch/chain/full3d.py:segment_reference.
//
// Per step a chain draws, with JAX's threefry (threefry.cuh), key =
// fold_in(step_base, step), (k_q, k_cell, k_u) = split(key, 3), the mover
// randint(k_q, Q), a uniform unoccupied cell by exact rejection sampling
// (attempt 0: k = hash(k_cell, 0), cell = randint(hash(k_cell, 1), N^3);
// while the cell is occupied: sub = hash(k, 1), k = hash(k, 0), cell =
// randint(sub, N^3): full3d.py:_draw_unoccupied) and u = uniform(k_u).  dE
// comes from
//   * "tables": the chain's 13-family line-count table, the new lines'
//     counts minus attacks(old, new) (the mover still sits on the old cell)
//     minus (the old lines' counts - 13); or
//   * "naive": two O(Q) conflict scans over the other queens.
// Both give the same integer, so both give the same trajectory.  A chain is
// a serial walk, so what bounds a launch is the latency of one step's
// dependent chain, not bytes or the card's int32 rate.
//
// Design: a warp per chain, one launch per segment (board_scan.cu's).
//   * Draws ahead.  No draw depends on the chain's state, and neither do the
//     rejection attempts' cells: only which attempt is the first free one
//     does.  So lane l computes step t + l's mover, uniform, beta, bin and
//     its first kAhead attempt cells with their coordinates, and the key
//     after them (21 threefry evaluations a lane), and the serial walk takes
//     them with __shfl_sync.  kAhead = 2: at config.yaml's N=12, Q=144 both
//     are occupied in (Q/N^3)^2 = 0.7% of the steps, where the walk goes on
//     from that key, every lane computing the same hashes (no shuffle); a
//     third attempt ahead would cost every step 6 more hashes a lane, about
//     what those fall-backs cost at that fill, and more at any lower one.
//   * The serial step across lanes.  Lane f < 13 owns line family f
//     (mcq::line_form): it loads the family's count at the old and the new
//     cell, the warp sums new - old with __reduce_add_sync, and on accept
//     lane f stores both words.  A move along a line of family f has the
//     same index at both ends: the -1 and the +1 then fall on one word and
//     cancel, so the lane stores its old count there.  Every lane stores
//     the mover's new coordinates and both occupancy bytes (the same words),
//     so every lane reads its own stores.  "naive" splits the Q - 1 other
//     queens over the lanes and reduces the same way.
//   * One step ahead.  While a step's accept test runs, the warp already
//     takes the next step's draws, reads its mover's cell, the occupancy of
//     its attempt cells and (tables) its 26 words.  If the step is accepted
//     they are repaired: a next mover equal to this mover sits on this
//     step's new cell; an attempt cell equal to the new cell is now
//     occupied, one equal to the old cell free; if the mover or an attempt's
//     occupancy changed, or the next step's cell came from attempts past
//     kAhead (whose walk read the old occupancy), its cell and words are
//     read again; otherwise a word this step stored is taken from the
//     registers (lane f owns family f, so only its own two words can alias).
//     A __syncwarp between the reads and the stores keeps a lane's reads
//     from seeing another lane's stores of the same step: every lane must
//     see the same occupancy to take the same path.
//   * State in shared memory.  A block of chains_per_block warps copies its
//     chains' queens, best queens, occupancy bytes and table into shared
//     memory at the start (neighbouring chains, so a load reads their words
//     of one sector together) and back at the end; an improvement copies
//     the 3Q coordinates from shared to shared.  When a chain's slot does
//     not fit a block's shared memory (tables at N >= 36 with Q = N^2), the
//     SMEM = false instance walks the same code on the chains-minor device
//     arrays: a template parameter the wrapper picks from (N, Q, kernel)
//     (chain/full3d.py:scan_layout), not a fallback.
//   * Bookkeeping in registers.  energy, best, no_improve, done and
//     stop_step live in registers; a step's bin is monotone in the step, so
//     accepts and totals are counted in registers and added to the bins
//     when the bin changes and at the end; the ys row of a chunk is kept by
//     the lane of its last step, and the rows of the chunks not ended by a
//     step taken (after an early stop, or past n_steps) are written after
//     the walk.
//
// Bitwise contract with the JAX scan and the twin: threefry in uint32_t, %
// and / only on non-negative operands, expf (not __expf), built with
// -fmad=false and without --use_fast_math, bins by mcq::bin_of, best_step =
// step + 1, the stop at the step patience is reached; the per-step betas
// come from the wrapper (core/schedules.py:chunk_betas over the segment's
// steps).  Queens are (3Q, C) int32 (row 3q + axis), occupancy (N^3, C)
// uint8 and tables (T13, C), chains minor.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

using mcq::Key;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxChainsPerBlock = 8;
constexpr int kFamilies = 13;

struct Args {
  int32_t *queens, *best_queens;
  uint8_t* occ;
  int32_t *table, *energy, *best_energy, *best_step, *no_improve, *done,
      *stop_step, *accept_bins, *total_bins;
  const int32_t* step_base;
  const float* beta;
  int32_t* ys;
  int start_outer, n_outer, stride, N, Q, C, n_steps, n_bins, patience;
};

// One step: its draws (the batch lane that drew them, the mover, the two
// attempt cells with their coordinates), then what the chain's state gives
// it: the attempts' occupancy, whether the cell came from attempts past
// them, the mover's cell, the first free attempt, and (tables, lane f < 13)
// family f's two indices and counts.
struct Step {
  int src, q, c0, i0, j0, k0, c1, i1, j1, k1, bin;
  float u, b;
  int o0, o1, past, oi, oj, ok, cell, ni, nj, nk, io, in, to, tn;
};

// One chain's segment, walked by one warp.  qs, bq, oc and tab point at the
// chain's first element and s is the distance between its elements: 1 in
// shared memory, C in the chains-minor device arrays.
template <bool TABLES>
__device__ __forceinline__ void walk(const Args& a, int c, int lane,
                                     int32_t* qs, int32_t* bq, uint8_t* oc,
                                     int32_t* tab, size_t s) {
  const int N = a.N, NN = N * N, Q = a.Q;
  const uint32_t N3 = (uint32_t)(NN * N);
  const uint32_t mult_q = mcq::randint_mult((uint32_t)Q);
  const uint32_t mult_c = mcq::randint_mult(N3);
  const size_t sC = (size_t)a.C;
  const Key sb = {(uint32_t)a.step_base[c], (uint32_t)a.step_base[sC + c]};
  int e = a.energy[c];
  int be = a.best_energy[c];
  int bs = a.best_step[c];
  int ni = a.no_improve[c];
  int dn = a.done[c];
  int st = a.stop_step[c];
  const int step0 = a.start_outer * a.stride;
  // Steps this launch may take: t in [0, total), chunk o = t / stride.
  const int total = min(a.n_outer * a.stride, a.n_steps - step0);

  mcq::LineForm lf = {0, 0, 0, 0};
  if (TABLES && lane < kFamilies) lf = mcq::line_form(lane, N);

  // Family f's indices at both ends of a step and their counts.
  auto words = [&](Step& p) {
    if (TABLES && lane < kFamilies) {
      p.io = lf.base + lf.ci * p.oi + lf.cj * p.oj + lf.ck * p.ok;
      p.in = lf.base + lf.ci * p.ni + lf.cj * p.nj + lf.ck * p.nk;
      p.to = tab[(size_t)p.io * s];
      p.tn = tab[(size_t)p.in * s];
    }
  };
  // The step's cell from its attempts' occupancy: the first free one, or
  // the rejection walk on from the key after them (the same on every lane).
  // Then its words.
  auto resolve = [&](Step& p, Key k) {
    p.past = p.o0 && p.o1;
    if (!p.o0) {
      p.cell = p.c0, p.ni = p.i0, p.nj = p.j0, p.nk = p.k0;
    } else if (!p.o1) {
      p.cell = p.c1, p.ni = p.i1, p.nj = p.j1, p.nk = p.k1;
    } else {
      int cell;
      do {
        const Key sub = mcq::hash(k, 1u);
        k = mcq::hash(k, 0u);
        cell = (int)mcq::randint(sub, N3, mult_c);
      } while (oc[(size_t)cell * s]);
      p.cell = cell;
      p.ni = cell / NN;
      const int r = cell - p.ni * NN;
      p.nj = r / N;
      p.nk = r - p.nj * N;
    }
    words(p);
  };

  int cur_bin = -1, n_acc = 0, n_tot = 0;
  int taken = 0;  // steps taken so far

  for (int tb = 0; tb < total && !dn; tb += 32) {
    // Draws of steps tb .. tb + 31, one a lane.
    const int tl = tb + lane;
    int dq = 0, dc[2] = {0, 0}, di[2] = {0, 0}, dj[2] = {0, 0},
        dk[2] = {0, 0}, dbin = 0;
    uint32_t dkey0 = 0, dkey1 = 0;
    float du = 0.0f, dbeta = 0.0f;
    if (tl < total) {
      const Key key = mcq::hash(sb, (uint32_t)(step0 + tl));  // fold_in
      dq = (int)mcq::randint(mcq::hash(key, 0u), (uint32_t)Q, mult_q);
      const Key k_cell = mcq::hash(key, 1u);
      du = mcq::uniform(mcq::hash(key, 2u));
      Key k = mcq::hash(k_cell, 0u);
      Key sub = mcq::hash(k_cell, 1u);
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        if (x) {
          sub = mcq::hash(k, 1u);
          k = mcq::hash(k, 0u);
        }
        const int cell = (int)mcq::randint(sub, N3, mult_c);
        dc[x] = cell;
        di[x] = cell / NN;
        const int r = cell - di[x] * NN;
        dj[x] = r / N;
        dk[x] = r - dj[x] * N;
      }
      dkey0 = k.k0;
      dkey1 = k.k1;
      dbeta = a.beta[tl];
      dbin = mcq::bin_of(step0 + tl, a.n_bins, a.n_steps);
    }
    // The key after step x's attempts, from its lane.
    auto key_of = [&](const Step& p) {
      return Key{__shfl_sync(kFull, dkey0, p.src),
                 __shfl_sync(kFull, dkey1, p.src)};
    };
    // Step x of the batch from lane x, read from the current state.  Lanes
    // past the segment drew zeros: a valid mover and cell.
    auto fetch = [&](int x) {
      Step p;
      p.src = x;
      p.q = __shfl_sync(kFull, dq, x);
      p.c0 = __shfl_sync(kFull, dc[0], x);
      p.i0 = __shfl_sync(kFull, di[0], x);
      p.j0 = __shfl_sync(kFull, dj[0], x);
      p.k0 = __shfl_sync(kFull, dk[0], x);
      p.c1 = __shfl_sync(kFull, dc[1], x);
      p.i1 = __shfl_sync(kFull, di[1], x);
      p.j1 = __shfl_sync(kFull, dj[1], x);
      p.k1 = __shfl_sync(kFull, dk[1], x);
      p.u = __shfl_sync(kFull, du, x);
      p.b = __shfl_sync(kFull, dbeta, x);
      p.bin = __shfl_sync(kFull, dbin, x);
      p.io = p.in = p.to = p.tn = 0;
      p.oi = qs[(size_t)(3 * p.q) * s];
      p.oj = qs[(size_t)(3 * p.q + 1) * s];
      p.ok = qs[(size_t)(3 * p.q + 2) * s];
      p.o0 = oc[(size_t)p.c0 * s];
      p.o1 = oc[(size_t)p.c1 * s];
      // uniform across the warp: the shuffles run on every lane or none
      resolve(p, (p.o0 && p.o1) ? key_of(p) : Key{0u, 0u});
      return p;
    };
    const int n = min(32, total - tb);
    Step p = fetch(0);
    int ye = e;  // lane l: the energy after step tb + l
    int q = 0;
    while (q < n) {
      const int gstep = step0 + tb + q;
      int v = 0;
      if (TABLES) {
        v = p.tn - p.to;  // 0 on lanes 13..31
      } else {
        for (int x = lane; x < Q; x += 32) {
          if (x != p.q) {
            const int xi = qs[(size_t)(3 * x) * s];
            const int xj = qs[(size_t)(3 * x + 1) * s];
            const int xk = qs[(size_t)(3 * x + 2) * s];
            v += mcq::attacks(xi - p.ni, xj - p.nj, xk - p.nk) -
                 mcq::attacks(xi - p.oi, xj - p.oj, xk - p.ok);
          }
        }
      }
      int de = __reduce_add_sync(kFull, v);
      if (TABLES) {
        // (new_sum - attacks(old, new)) - (old_sum - 13)
        de += kFamilies - mcq::attacks(p.oi - p.ni, p.oj - p.nj, p.ok - p.nk);
      }
      // The next step, read while this one's accept test runs: before this
      // step's stores, so it is repaired below where they changed it.  Its
      // occupancy decides whether the warp shuffles and walks on, so no
      // lane may store before every lane has read (lanes stay converged on
      // the card, but the memory model promises it only at a sync).
      const bool more = q + 1 < n;
      Step nx;
      if (more) nx = fetch(q + 1);
      __syncwarp();

      const bool accept = p.u < expf(-p.b * (float)de);
      if (accept) {
        const int old_cell = (p.oi * N + p.oj) * N + p.ok;
        qs[(size_t)(3 * p.q) * s] = p.ni;
        qs[(size_t)(3 * p.q + 1) * s] = p.nj;
        qs[(size_t)(3 * p.q + 2) * s] = p.nk;
        oc[(size_t)old_cell * s] = 0;
        oc[(size_t)p.cell * s] = 1;
        // A line through both cells keeps its count.
        const int d = p.io != p.in;
        const int wo = p.to - d, wn = p.tn + d;
        if (TABLES && lane < kFamilies) {
          tab[(size_t)p.io * s] = wo;
          tab[(size_t)p.in * s] = wn;
        }
        e += de;
        if (more) {
          bool again = nx.past;  // its walk read the old occupancy
          if (nx.q == p.q) {
            nx.oi = p.ni, nx.oj = p.nj, nx.ok = p.nk;
            again = true;
          }
          const int o0 = nx.c0 == p.cell ? 1 : nx.c0 == old_cell ? 0 : nx.o0;
          const int o1 = nx.c1 == p.cell ? 1 : nx.c1 == old_cell ? 0 : nx.o1;
          again = again || o0 != nx.o0 || o1 != nx.o1;
          if (again) {
            nx.o0 = o0;
            nx.o1 = o1;
            resolve(nx, (o0 && o1) ? key_of(nx) : Key{0u, 0u});
          } else if (TABLES && lane < kFamilies) {
            nx.to = nx.io == p.io ? wo : nx.io == p.in ? wn : nx.to;
            nx.tn = nx.in == p.io ? wo : nx.in == p.in ? wn : nx.tn;
          }
        }
      }
      if (accept && e < be) {
        be = e;
        bs = gstep + 1;
        ni = 0;
        for (int x = lane; x < 3 * Q; x += 32) {
          bq[(size_t)x * s] = qs[(size_t)x * s];
        }
      } else {
        ni += 1;
      }
      if (a.patience >= 0 && ni >= a.patience) {
        dn = 1;
        st = gstep;
      }
      if (p.bin != cur_bin) {
        if (n_tot && lane == 0) {
          a.accept_bins[(size_t)cur_bin * sC + c] += n_acc;
          a.total_bins[(size_t)cur_bin * sC + c] += n_tot;
        }
        cur_bin = p.bin;
        n_acc = 0;
        n_tot = 0;
      }
      n_acc += accept ? 1 : 0;
      n_tot += 1;
      ye = lane == q ? e : ye;
      p = nx;
      ++q;
      if (dn) break;
    }
    taken = tb + q;
    // The rows of the chunks that ended at a step of this batch.
    const int end = tl + 1;
    if (lane < q && end % a.stride == 0) {
      a.ys[(size_t)(end / a.stride - 1) * sC + c] = ye;
    }
  }
  if (n_tot && lane == 0) {
    a.accept_bins[(size_t)cur_bin * sC + c] += n_acc;
    a.total_bins[(size_t)cur_bin * sC + c] += n_tot;
  }
  // The chunks not ended by a step taken (after an early stop, or past
  // n_steps) keep the last energy.
  for (int r = taken / a.stride + lane; r < a.n_outer; r += 32) {
    a.ys[(size_t)r * sC + c] = e;
  }
  if (lane == 0) {
    a.energy[c] = e;
    a.best_energy[c] = be;
    a.best_step[c] = bs;
    a.no_improve[c] = ni;
    a.done[c] = dn;
    a.stop_step[c] = st;
  }
}

// Copy `rows` elements of each of the block's chains between a
// chains-minor device array and the chains' shared-memory slots (W
// elements apart, from element `at` of each slot), neighbouring threads on
// neighbouring chains.
template <typename T>
__device__ __forceinline__ void copy_columns(T* sm, T* g, int rows, int W,
                                             int at, int c0, int cpb,
                                             size_t sC, int C,
                                             bool to_shared) {
  for (int idx = threadIdx.x; idx < rows * cpb; idx += blockDim.x) {
    const int x = idx / cpb, w = idx - x * cpb;
    if (c0 + w < C) {
      T* p = sm + (size_t)w * W + at + x;
      T* q = g + (size_t)x * sC + c0 + w;
      if (to_shared) {
        *p = *q;
      } else {
        *q = *p;
      }
    }
  }
}

// A chain's slot in words: queens and best queens (3Q each), the occupancy
// bytes rounded up to words, and (tables) the table.
__host__ __device__ __forceinline__ long long slot_words(int N, int Q,
                                                         bool tables) {
  const long long N3 = 1LL * N * N * N;
  return 6LL * Q + (N3 + 3) / 4 + (tables ? mcq::table_words(N, true) : 0);
}

template <bool SMEM, bool TABLES>
__global__ void __launch_bounds__(32 * kMaxChainsPerBlock)
    full3d_scan_kernel(Args a, int cpb) {
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * cpb, c = c0 + warp;
  const size_t sC = (size_t)a.C;
  if (!SMEM) {
    if (c < a.C) {
      walk<TABLES>(a, c, lane, a.queens + c, a.best_queens + c, a.occ + c,
                   TABLES ? a.table + c : nullptr, sC);
    }
    return;
  }
  const int Q3 = 3 * a.Q, N3 = a.N * a.N * a.N;
  const int T = TABLES ? (int)mcq::table_words(a.N, true) : 0;
  const int W = (int)slot_words(a.N, a.Q, TABLES);
  const int occ_at = 2 * Q3, tab_at = occ_at + (N3 + 3) / 4;
  uint8_t* const smem8 = reinterpret_cast<uint8_t*>(smem);
  for (int pass = 0; pass < 2; ++pass) {
    const bool in = pass == 0;
    if (!in) __syncthreads();
    copy_columns(smem, a.queens, Q3, W, 0, c0, cpb, sC, a.C, in);
    copy_columns(smem, a.best_queens, Q3, W, Q3, c0, cpb, sC, a.C, in);
    copy_columns(smem8, a.occ, N3, 4 * W, 4 * occ_at, c0, cpb, sC, a.C, in);
    if (TABLES) copy_columns(smem, a.table, T, W, tab_at, c0, cpb, sC, a.C, in);
    if (in) {
      __syncthreads();
      if (c < a.C) {
        int32_t* slot = smem + (size_t)warp * W;
        walk<TABLES>(a, c, lane, slot, slot + Q3,
                     reinterpret_cast<uint8_t*>(slot + occ_at),
                     slot + tab_at, 1);
      }
    }
  }
}

template <bool SMEM, bool TABLES>
int launch(const Args& a, int cpb, int smem, cudaStream_t stream) {
  const auto kernel = full3d_scan_kernel<SMEM, TABLES>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (a.C + cpb - 1) / cpb;
  kernel<<<blocks, 32 * cpb, smem, stream>>>(a, cpb);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch one segment on `stream`; returns cudaGetLastError() (0 on success).
// All pointers are device pointers to contiguous arrays: queens and
// best_queens (3Q, C) int32; occ (N^3, C) uint8; table (T13, C), or null for
// the naive kernel; energy .. stop_step (C); accept_bins, total_bins
// (n_bins, C); step_base (2, C) key words; beta (n_outer * stride) float32,
// the betas of steps start_outer * stride onwards; ys (n_outer, C).
// Requires 1 <= Q < N^3 (a free cell exists).  patience < 0 disables early
// stopping.  chains_per_block (1..8) warps a block, one a chain; smem_bytes
// the block's shared memory: 4 * chains_per_block * (6Q + ceil(N^3 / 4) +
// T13) to keep the chains there (T13 = 0 for naive), or 0 to walk them in
// device memory.  Anything else returns cudaErrorInvalidValue.
extern "C" int mcq_full3d_scan_segment(
    void* queens, void* best_queens, void* occ, void* table, void* energy,
    void* best_energy, void* best_step, void* no_improve, void* done,
    void* stop_step, void* accept_bins, void* total_bins,
    const void* step_base, const void* beta, void* ys, int start_outer,
    int n_outer, int stride, int N, int Q, int C, int n_steps, int n_bins,
    int patience, int chains_per_block, int smem_bytes, void* stream) {
  const Args a = {(int32_t*)queens, (int32_t*)best_queens, (uint8_t*)occ,
                  (int32_t*)table, (int32_t*)energy, (int32_t*)best_energy,
                  (int32_t*)best_step, (int32_t*)no_improve, (int32_t*)done,
                  (int32_t*)stop_step, (int32_t*)accept_bins,
                  (int32_t*)total_bins, (const int32_t*)step_base,
                  (const float*)beta, (int32_t*)ys, start_outer, n_outer,
                  stride, N, Q, C, n_steps, n_bins, patience};
  const int cpb = chains_per_block;
  const bool tables = table != nullptr;
  if (Q < 1 || Q >= 1LL * N * N * N || cpb < 1 || cpb > kMaxChainsPerBlock ||
      (smem_bytes != 0 &&
       smem_bytes != 4LL * cpb * slot_words(N, Q, tables))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (smem_bytes == 0) {
    return tables ? launch<false, true>(a, cpb, 0, s)
                  : launch<false, false>(a, cpb, 0, s);
  }
  return tables ? launch<true, true>(a, cpb, smem_bytes, s)
                : launch<true, false>(a, cpb, smem_bytes, s);
}
