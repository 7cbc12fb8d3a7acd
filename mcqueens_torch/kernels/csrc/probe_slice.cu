// Dynamic-slice, reduction and PRNG-draw probes for Hopper (sm_90a).
//
// Replace the TPU Pallas kernels of tools/probe_slice.py:
//   slice copy  dyn_sublane_load: rows [off, off + w) of x (S, C); and
//               dyn_sublane_store: a copy of x with `value` in those rows.
//               off is one int32 word in device memory that the kernel
//               reads, as the TPU kernel reads its offset from SMEM.
//   slice loop  dyn_slice_loop_cost: from x, step t adds t + 1 to rows
//               [(16 t) mod S, + w), in place.
//   reduce      sublane_reduce_cost: acc (1, C) from zeros, n_iter times
//               acc = sum over the S rows of (x + acc).
//   PRNG draws  prng_cost: the wrapping sum of n_iter draws per word.  The
//               TPU's hardware generator has no stream to match, so this
//               times the generators the port's kernels draw from: mode 0
//               w0 + w1 of lowbias32 step_words(chain_streams(seed + e),
//               step0 + t) (mcqueens_torch/kernels/prng.py), mode 1
//               random_bits(fold_in(key(seed), step0 + t))[e] of threefry
//               (threefry.cuh).
// Plain-torch twins: mcqueens_torch/kernels/probes_mem.py:*_reference.
//
// What bounds them on the H100.  The slice copy is one pass over device
// memory.  The slice loop runs out of shared memory: per (row, step) it
// loads and stores a word there and adds; shared memory serves 32 banks x 4
// bytes per SM per clock, which binds before the int32 pipes.  The reduce
// needs two adds per (row, step) and nothing more (a column of up to 64
// words fits in registers): int32 issue.  The PRNG draws are int32 issue
// too: 30 uint32 operations per lowbias32 draw and 75 per threefry draw,
// and one word written per element.
//
// Design.  The slice copy moves 16 bytes an access (int4) when every row
// starts 16-byte aligned (C a multiple of 4, both base pointers aligned),
// else 4, one template each, picked by the launcher from the shape.  A 2-D
// grid gives each thread columns and rows, so no index is divided; in store
// mode the stored rows write `value` and never read x, and in load mode the
// rows, contiguous in x, are one run.  Each thread moves two accesses, both
// loads in flight before the stores, with streaming (evict-first) loads and
// stores, as each word is touched once: on the card, fewer threads with
// longer loops lost to this for the store's 69 MB, and more threads with
// one access each, or cached accesses, for the load's 4 MB.
// The slice loop is one thread per column, 32 columns a block, the block's
// (S, 32) strip in shared memory: each thread owns its column, so the
// threads never wait for each other, and each step loads, adds and stores
// its w rows (a runtime count) at a runtime offset.  The reduce is one
// thread per column, 128 columns a block, one template instance per row
// count S <= 64 (ROWS = S): the thread loads its S words once, coalesced,
// into registers, and each step adds x_s + acc into four partial sums (sums
// mod 2^32 are associative, so the words match, and four chains of S/4
// adds keep the ALU pipe busy), one IADD3 per row written as inline PTX
// (add s, s, x_s; add s, s, acc): LLVM would rewrite sum(x_s + acc) as
// sum(x_s) + S * acc and hoist sum(x_s) out of the step loop.  That is half
// the function's two ops per (row, step) on the ALU pipe alone, exactly the
// ops bound at both pipes' rate.  Above 64 rows (no tool runs them) the
// instance ROWS = 0 stages x's (S, 128) strip in shared memory and each step
// walks the S rows there, each x_s tied to acc through a runtime zero (the
// wrapper passes 0): x_s ^ (acc & zero) is x_s, one LOP3.  The wrapper picks
// the instance from S (probes_mem.reduce_instance).  The lowbias32 draws
// are one thread per word, the draw loop over a runtime n_iter.  The
// threefry draws share each step's key, fold_in(key(seed), step0 + t), the
// same for every word: a block hashes the keys of a chunk of kKeyChunk
// steps once, one step a thread, into shared memory with the per-step
// constants of the draw's hash (k2 = k0 ^ k1 ^ 0x1BD11BDA and the key
// injections' addends), and each step every thread reads them as two
// broadcast 16-byte loads and draws kDrawWords words under them: four
// independent hash chains a thread.  A round is an add, a rotate (SHF)
// and a xor (LOP3); the rotate and the xor can only issue on the ALU pipe,
// so tf_draw puts every add and key injection on the FMA pipe, as kernel A
// does (csrc/probe_alu.cu): IMAD with a runtime multiplier `one` (the
// wrapper passes 1), which ptxas cannot fold back into an IADD3.  Left to
// itself ptxas issued about half the adds as IADD3, 46.5 ALU-pipe
// instructions a draw against 42.5.  kFmaAdds, kFmaRotates and
// kFmaInjections choose each round's forms (a rotate as IMAD.SHL and IMAD.HI
// by a runtime 2^r was slower on the card).  mcq::hash in threefry.cuh,
// which the scan samplers call, is unchanged.  Every count, offset and
// width is a runtime argument; all arithmetic is uint32_t.
// The strips' fill and drain unroll 8 rows, so each thread keeps 8 loads in
// flight (one at a time left the fill at 7 warps per SM latency-bound, a
// fixed cost as large as 500 steps of the loop), and the row loops over a
// strip unroll 16: the hot loop stays the largest loop of its kernel, the
// one the smoke test's SASS check reads.  The register reduce's step loop is
// not unrolled: one trip walks the S rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "threefry.cuh"

namespace {

constexpr int kCopyThreads = 256;
constexpr int kCopyItems = 2;
constexpr int kLoopCols = 32;
constexpr int kReduceCols = 128;
constexpr int kReduceRegRows = 64;  // rows a column holds in registers
constexpr int kReducePartials = 4;
constexpr int kPrngThreads = 128;

template <typename V>
__device__ __forceinline__ V splat(int v);
template <>
__device__ __forceinline__ int32_t splat<int32_t>(int v) {
  return v;
}
template <>
__device__ __forceinline__ int4 splat<int4>(int v) {
  return make_int4(v, v, v, v);
}

// V is int4 when every row starts 16-byte aligned, else int32_t.  Threads
// (x, y) of a 2-D grid walk columns and rows, kCopyItems accesses at a time
// (both loads before the stores): down the rows of a column, or along a
// single row.  No index is divided.  Store mode copies x (rows, pitch) with
// `value` in the rows [off, off + width); load mode copies the one run of
// `cols` V that the rows [off, off + width) of a contiguous x make, as one
// row.
template <typename V>
__global__ void __launch_bounds__(kCopyThreads)
    slice_probe_kernel(const V* __restrict__ x,
                       const int32_t* __restrict__ off_word,
                       V* __restrict__ out, int pitch, long long cols,
                       int rows, int width, int store, int value) {
  const long long off = *off_word;
  const V* __restrict__ src = store ? x : x + off * pitch;
  const long long c0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long cstep = (long long)gridDim.x * blockDim.x;
  const V fill = splat<V>(value);
  // a stored row writes `value` and does not read x
  auto filled = [&](long long r) {
    return store && r >= off && r < off + width;
  };
  V v[kCopyItems];
  if (rows == 1) {
    const bool f = filled(0);
    for (long long col = c0; col < cols; col += kCopyItems * cstep) {
#pragma unroll
      for (int u = 0; u < kCopyItems; ++u) {
        const long long cu = col + u * cstep;
        if (cu < cols) v[u] = f ? fill : __ldcs(src + cu);
      }
#pragma unroll
      for (int u = 0; u < kCopyItems; ++u) {
        const long long cu = col + u * cstep;
        if (cu < cols) __stcs(out + cu, v[u]);
      }
    }
    return;
  }
  const int r0 = blockIdx.y * blockDim.y + threadIdx.y;
  const int rstep = gridDim.y * blockDim.y;
  for (long long col = c0; col < cols; col += cstep) {
    for (long long r = r0; r < rows; r += kCopyItems * rstep) {
#pragma unroll
      for (int u = 0; u < kCopyItems; ++u) {
        const long long ru = r + u * rstep;
        if (ru < rows) {
          v[u] = filled(ru) ? fill : __ldcs(src + ru * pitch + col);
        }
      }
#pragma unroll
      for (int u = 0; u < kCopyItems; ++u) {
        const long long ru = r + u * rstep;
        if (ru < rows) __stcs(out + ru * cols + col, v[u]);
      }
    }
  }
}

// The slice copy's grid: about kCopyItems accesses a thread, up to
// kCopyItems rows of a column and the rest along the row.
template <typename V>
int launch_slice(const void* x, const void* off_word, void* out, int pitch,
                 long long cols, int rows, int width, int store, int value,
                 cudaStream_t s) {
  const int bx = (int)std::min<long long>(kCopyThreads, (cols + 31) / 32 * 32);
  const int by = kCopyThreads / bx;
  const int ky = std::min(kCopyItems, (rows + by - 1) / by);
  const int kx = std::max(1, kCopyItems / ky);
  const long long gx = (cols + (long long)bx * kx - 1) / ((long long)bx * kx);
  const int gy = std::min((rows + by * ky - 1) / (by * ky), 65535);
  const dim3 grid((unsigned)gx, gy), block(bx, by);
  slice_probe_kernel<V><<<grid, block, 0, s>>>(
      (const V*)x, (const int32_t*)off_word, (V*)out, pitch, cols, rows,
      width, store, value);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(kLoopCols) slice_loop_probe_kernel(
    const int32_t* __restrict__ x, int32_t* __restrict__ out, int S, int C,
    int width, int n_iter, int stride) {
  extern __shared__ uint32_t strip[];  // (S, kLoopCols)
  const int lane = threadIdx.x;
  const int c = blockIdx.x * kLoopCols + lane;
  const bool live = c < C;
#pragma unroll 8
  for (int r = 0; r < S; ++r) {
    strip[r * kLoopCols + lane] =
        live ? (uint32_t)x[(long long)r * C + c] : 0u;
  }
  uint32_t acc = 1;
  int off = 0;
  for (int t = 0; t < n_iter; ++t) {
    uint32_t* p = strip + off * kLoopCols + lane;
#pragma unroll 16
    for (int i = 0; i < width; ++i) p[i * kLoopCols] += acc;
    acc += 1u;
    off += stride;
    if (off >= S) off -= S;
  }
  if (live) {
#pragma unroll 8
    for (int r = 0; r < S; ++r) {
      out[(long long)r * C + c] = (int32_t)strip[r * kLoopCols + lane];
    }
  }
}

// s + x + acc: one IADD3 that LLVM cannot reassociate.  (Host C++, as the
// emulation builds this file, has no PTX: there it is the plain sum.)
__device__ __forceinline__ uint32_t add_row(uint32_t s, uint32_t x,
                                           uint32_t acc) {
#ifdef __CUDA_ARCH__
  asm volatile("add.u32 %0, %0, %1;\n\tadd.u32 %0, %0, %2;"
               : "+r"(s)
               : "r"(x), "r"(acc));
  return s;
#else
  return s + x + acc;
#endif
}

// ROWS = S in 1..kReduceRegRows: the column in registers; ROWS = 0: x's
// (S, kReduceCols) strip staged in shared memory.
template <int ROWS>
__global__ void __launch_bounds__(kReduceCols) reduce_probe_kernel(
    const int32_t* __restrict__ x, int32_t* __restrict__ out, int S, int C,
    int n_iter, uint32_t zero) {
  const int lane = threadIdx.x;
  const int c = blockIdx.x * kReduceCols + lane;
  uint32_t acc = 0;
  if constexpr (ROWS > 0) {
    if (c >= C) return;
    uint32_t xr[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) xr[r] = (uint32_t)x[(long long)r * C + c];
    constexpr int P = ROWS < kReducePartials ? ROWS : kReducePartials;
#pragma unroll 1
    for (int t = 0; t < n_iter; ++t) {
      uint32_t s[P] = {};
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r % P] = add_row(s[r % P], xr[r], acc);
      acc = s[0];
#pragma unroll
      for (int p = 1; p < P; ++p) acc += s[p];
    }
    out[c] = (int32_t)acc;
  } else {
    extern __shared__ uint32_t xs[];  // (S, kReduceCols)
    const bool live = c < C;
#pragma unroll 8
    for (int r = 0; r < S; ++r) {
      xs[r * kReduceCols + lane] =
          live ? (uint32_t)x[(long long)r * C + c] : 0u;
    }
    for (int t = 0; t < n_iter; ++t) {
      const uint32_t tie = acc & zero;
      uint32_t s = 0;
#pragma unroll 16
      for (int r = 0; r < S; ++r) {
        s += (xs[r * kReduceCols + lane] ^ tie) + acc;
      }
      acc = s;
    }
    if (live) out[c] = (int32_t)acc;
  }
}

// Launches the register instance ROWS = rows, searched from R up.
template <int R>
int launch_reduce_rows(int rows, const int32_t* x, int32_t* out, int C,
                       int n_iter, cudaStream_t s) {
  if (rows == R) {
    reduce_probe_kernel<R><<<(C + kReduceCols - 1) / kReduceCols,
                             kReduceCols, 0, s>>>(x, out, rows, C, n_iter,
                                                  0u);
    return (int)cudaGetLastError();
  }
  if constexpr (R < kReduceRegRows) {
    return launch_reduce_rows<R + 1>(rows, x, out, C, n_iter, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

// mcqueens_torch/kernels/prng.py, in uint32_t (logical shifts need no mask).
constexpr uint32_t kM1 = 0x7FEB352Du, kM2 = 0x846CA68Bu;
constexpr uint32_t kStepK = 0x9E3779B9u, kChainK = 0x85EBCA6Bu;
constexpr uint32_t kW0K = 0x68BC21EBu, kW1K = 0x02E5BE93u;

__device__ __forceinline__ uint32_t lowbias32(uint32_t z) {
  z ^= z >> 16;
  z *= kM1;
  z ^= z >> 15;
  z *= kM2;
  return z ^ (z >> 16);
}

// a * b + c, b a runtime value: one IMAD (FMA pipe).
__device__ __forceinline__ uint32_t mad_lo(uint32_t a, uint32_t b,
                                          uint32_t c) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
#else
  return a * b + c;
#endif
}

// rotl(x, r) as x * 2^r | umulhi(x, 2^r), pow2 = 2^r a runtime value: IMAD.SHL
// and IMAD.HI (FMA pipe); the | folds into the round's xor (one LOP3).
__device__ __forceinline__ uint32_t rotl_mul(uint32_t x, uint32_t pow2) {
#ifdef __CUDA_ARCH__
  uint32_t lo, hi;
  asm("mul.lo.u32 %0, %1, %2;" : "=r"(lo) : "r"(x), "r"(pow2));
  asm("mul.hi.u32 %0, %1, %2;" : "=r"(hi) : "r"(x), "r"(pow2));
  return lo | hi;
#else
  return x * pow2 | __umulhi(x, pow2);
#endif
}

// The rounds of the threefry draws whose add (kFmaAdds) or rotate
// (kFmaRotates) issues on the FMA pipe, bit r for round r; a clear bit
// leaves it to ptxas (an add as IADD3 or IMAD, a rotate as SHF on the ALU
// pipe).  kFmaInjections puts the key injections on the FMA pipe too, x0's
// apart from the next round's add; else x0 += k and that add are one IADD3.
// On the card every rotate put on the FMA pipe (IMAD.SHL + IMAD.HI) made
// the draws slower, whatever it took off the ALU pipe (`pair_scan_slice.py
// --only prng_variants`), so the rotates stay SHF.
constexpr uint32_t kFmaAdds = 0xFFFFFu;
constexpr uint32_t kFmaRotates = 0u;
constexpr bool kFmaInjections = true;
constexpr int kDrawWords = 4;  // threefry words a thread
constexpr int kKeyChunk = kPrngThreads;  // steps whose keys a block hashes

// The rotation of round r (threefry.cuh's MCQ_TF_ROUND amounts).
__host__ __device__ constexpr int tf_rot(int r) {
  return r % 8 == 0   ? 13
         : r % 8 == 1 ? 15
         : r % 8 == 2 ? 26
         : r % 8 == 3 ? 6
         : r % 8 == 4 ? 17
         : r % 8 == 5 ? 29
         : r % 8 == 6 ? 16
                      : 24;
}

__device__ __forceinline__ uint32_t add_fma(uint32_t a, uint32_t b, bool fma,
                                           uint32_t one) {
  return fma ? mad_lo(a, one, b) : a + b;
}

// x0 + k + x1 at an injection round: one IADD3, or with kFmaInjections
// x0 + k as IMAD and the round's add as its kFmaAdds bit says.
__device__ __forceinline__ uint32_t inject(uint32_t x0, uint32_t k,
                                          uint32_t x1, bool fma_add,
                                          uint32_t one) {
  return kFmaInjections ? add_fma(mad_lo(x0, one, k), x1, fma_add, one)
                        : x0 + k + x1;
}

// Round R of the 20: x0 += x1; x1 = rotl(x1, r) ^ x0.
template <int R>
__device__ __forceinline__ void tf_round(uint32_t& x0, uint32_t& x1,
                                         uint32_t one, const uint32_t* pow2) {
  constexpr bool fma_add = kFmaAdds >> R & 1;
  constexpr bool fma_rot = kFmaRotates >> R & 1;
  x0 = add_fma(x0, x1, fma_add, one);
  const uint32_t r =
      fma_rot ? rotl_mul(x1, pow2[R % 8]) : mcq::rotl(x1, tf_rot(R));
  x1 = r ^ x0;
}

// Rounds 4 g + 1 .. 4 g + 3 after the first of group g.
template <int G>
__device__ __forceinline__ void tf_group_tail(uint32_t& x0, uint32_t& x1,
                                              uint32_t one,
                                              const uint32_t* pow2) {
  tf_round<4 * G + 1>(x0, x1, one, pow2);
  tf_round<4 * G + 2>(x0, x1, one, pow2);
  tf_round<4 * G + 3>(x0, x1, one, pow2);
}

// x0 ^ x1 of threefry2x32 of the counter (0, e) under a step's key, from its
// words a = (k0, k1, k2, k2 + 1) and b = (k0 + 2, k1 + 3, k2 + 4, k0 + 5):
// mcq::hash(k, e), with each round's pipe chosen as above.
__device__ __forceinline__ uint32_t tf_draw(uint32_t e, const uint4& a,
                                           const uint4& b, uint32_t one,
                                           const uint32_t* pow2) {
  constexpr bool fi = kFmaInjections;
  uint32_t x1 = e + a.y;
  uint32_t x0 = add_fma(x1, a.x, kFmaAdds & 1, one);  // round 0: k0 + x1
  uint32_t r = (kFmaRotates & 1) ? rotl_mul(x1, pow2[0]) : mcq::rotl(x1, 13);
  x1 = r ^ x0;
  tf_group_tail<0>(x0, x1, one, pow2);
  // each injection: x1 += its addend; x0 += k and the next round's add
  x1 = add_fma(x1, a.w, fi, one);
  x0 = inject(x0, a.y, x1, kFmaAdds >> 4 & 1, one);
  x1 = (kFmaRotates >> 4 & 1 ? rotl_mul(x1, pow2[4]) : mcq::rotl(x1, 17)) ^ x0;
  tf_group_tail<1>(x0, x1, one, pow2);
  x1 = add_fma(x1, b.x, fi, one);
  x0 = inject(x0, a.z, x1, kFmaAdds >> 8 & 1, one);
  x1 = (kFmaRotates >> 8 & 1 ? rotl_mul(x1, pow2[0]) : mcq::rotl(x1, 13)) ^ x0;
  tf_group_tail<2>(x0, x1, one, pow2);
  x1 = add_fma(x1, b.y, fi, one);
  x0 = inject(x0, a.x, x1, kFmaAdds >> 12 & 1, one);
  x1 = (kFmaRotates >> 12 & 1 ? rotl_mul(x1, pow2[4]) : mcq::rotl(x1, 17)) ^
       x0;
  tf_group_tail<3>(x0, x1, one, pow2);
  x1 = add_fma(x1, b.z, fi, one);
  x0 = inject(x0, a.y, x1, kFmaAdds >> 16 & 1, one);
  x1 = (kFmaRotates >> 16 & 1 ? rotl_mul(x1, pow2[0]) : mcq::rotl(x1, 13)) ^
       x0;
  tf_group_tail<4>(x0, x1, one, pow2);
  return add_fma(x0, a.z, fi, one) ^ add_fma(x1, b.w, fi, one);
}

// MODE 0 (lowbias32): one thread per word.  MODE 1 (threefry): kDrawWords
// words a thread, w = block base + threadIdx.x + j * kPrngThreads; the
// steps' keys a chunk at a time in shared memory (two uint4 a step).
template <int MODE>
__global__ void __launch_bounds__(kPrngThreads) prng_probe_kernel(
    int32_t* __restrict__ out, int n, int n_iter, uint32_t seed,
    uint32_t step0, uint32_t one) {
  if constexpr (MODE == 0) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n) return;
    uint32_t acc = 0;
    const uint32_t s = seed + (uint32_t)e;
    const uint32_t g = s * kChainK + lowbias32(s);
#pragma unroll 1
    for (int t = 0; t < n_iter; ++t) {
      const uint32_t base = lowbias32(g ^ ((step0 + (uint32_t)t) * kStepK));
      const uint32_t w0 = lowbias32(base ^ kW0K) & 0x7FFFFFFFu;
      const uint32_t w1 = lowbias32(base + kW1K);
      acc += w0 + w1;
    }
    out[e] = (int32_t)acc;
  } else {
    extern __shared__ uint4 step_keys[];  // (kKeyChunk, 2)
    const int tid = threadIdx.x;
    const uint32_t e0 = blockIdx.x * (kPrngThreads * kDrawWords) + tid;
    uint32_t pow2[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) pow2[i] = one << tf_rot(i);
    uint32_t acc[kDrawWords] = {};
    const mcq::Key root = {0u, seed};
    for (int c0 = 0; c0 < n_iter; c0 += kKeyChunk) {
      if (c0 > 0) __syncthreads();  // the last chunk's keys are read
      if (c0 + tid < n_iter) {
        const mcq::Key k = mcq::hash(root, step0 + (uint32_t)(c0 + tid));
        const uint32_t k2 = k.k0 ^ k.k1 ^ 0x1BD11BDAu;
        step_keys[2 * tid] = make_uint4(k.k0, k.k1, k2, k2 + 1u);
        step_keys[2 * tid + 1] =
            make_uint4(k.k0 + 2u, k.k1 + 3u, k2 + 4u, k.k0 + 5u);
      }
      __syncthreads();
      const int steps = min(kKeyChunk, n_iter - c0);
#pragma unroll 1
      for (int s = 0; s < steps; ++s) {
        const uint4 a = step_keys[2 * s], b = step_keys[2 * s + 1];
#pragma unroll
        for (int j = 0; j < kDrawWords; ++j) {
          acc[j] += tf_draw(e0 + j * kPrngThreads, a, b, one, pow2);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kDrawWords; ++j) {
      const uint32_t e = e0 + j * kPrngThreads;
      if (e < (uint32_t)n) out[e] = (int32_t)acc[j];
    }
  }
}

int set_smem(const void* kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// The slice copy on `stream`: x (S, C) int32; off_word one int32 device word
// with 0 <= off and off + width <= S (the wrapper checks).  store 0: out is
// (width, C), the rows [off, off + width); store 1: out is (S, C), x with
// `value` in those rows.  n_out is out's element count.  Rows move as int4
// when C is a multiple of 4 and both arrays are 16-byte aligned, else as
// int32.
extern "C" int mcq_probe_slice(const void* x, const void* off_word,
                               void* out, int C, int width, int n_out,
                               int store, int value, void* stream) {
  if (C < 1 || n_out < 1) return (int)cudaErrorInvalidValue;
  const bool vec = C % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const int k = vec ? 4 : 1;
  const int pitch = C / k;
  const int rows = store ? n_out / C : 1;
  const long long cols = store ? pitch : (long long)n_out / k;
  const cudaStream_t s = (cudaStream_t)stream;
  return vec ? launch_slice<int4>(x, off_word, out, pitch, cols, rows, width,
                                  store, value, s)
             : launch_slice<int32_t>(x, off_word, out, pitch, cols, rows,
                                     width, store, value, s);
}

// The slice loop on `stream`: x, out (S, C) int32; stride = 16 mod S; every
// offset a step reaches plus width stays within S (the wrapper checks);
// S * 32 words of shared memory per block.
extern "C" int mcq_probe_slice_loop(const void* x, void* out, int S, int C,
                                    int width, int n_iter, int stride,
                                    void* stream) {
  const int smem = S * kLoopCols * (int)sizeof(uint32_t);
  const int err = set_smem((const void*)slice_loop_probe_kernel, smem);
  if (err != 0) return err;
  const int blocks = (C + kLoopCols - 1) / kLoopCols;
  slice_loop_probe_kernel<<<blocks, kLoopCols, smem, (cudaStream_t)stream>>>(
      (const int32_t*)x, (int32_t*)out, S, C, width, n_iter, stride);
  return (int)cudaGetLastError();
}

// The reduce on `stream`: x (S, C) int32, out (1, C); rows is the
// instance, S itself for 1 <= S <= 64 (the column in registers) or 0 (the
// strip staged in shared memory, S * 128 words a block; zero must be 0);
// returns cudaErrorInvalidValue for another.
extern "C" int mcq_probe_reduce(const void* x, void* out, int S, int C,
                                int n_iter, int zero, int rows,
                                void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (rows != 0) {
    if (rows != S) return (int)cudaErrorInvalidValue;
    return launch_reduce_rows<1>(rows, (const int32_t*)x, (int32_t*)out, C,
                                 n_iter, s);
  }
  const int smem = S * kReduceCols * (int)sizeof(uint32_t);
  const int err = set_smem((const void*)reduce_probe_kernel<0>, smem);
  if (err != 0) return err;
  const int blocks = (C + kReduceCols - 1) / kReduceCols;
  reduce_probe_kernel<0><<<blocks, kReduceCols, smem, s>>>(
      (const int32_t*)x, (int32_t*)out, S, C, n_iter, (uint32_t)zero);
  return (int)cudaGetLastError();
}

// The PRNG draws on `stream`: out holds n int32 words; mode 0 lowbias32,
// 1 threefry; one must be 1 (the FMA-pipe rounds' runtime multiplier);
// returns cudaErrorInvalidValue for another mode.
extern "C" int mcq_probe_prng(void* out, int n, int mode, int n_iter,
                              int seed, int step0, int one, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  int32_t* o = (int32_t*)out;
  switch (mode) {
    case 0:
      prng_probe_kernel<0><<<(n + kPrngThreads - 1) / kPrngThreads,
                             kPrngThreads, 0, s>>>(
          o, n, n_iter, (uint32_t)seed, (uint32_t)step0, (uint32_t)one);
      break;
    case 1: {
      constexpr int words = kPrngThreads * kDrawWords;
      prng_probe_kernel<1><<<(n + words - 1) / words, kPrngThreads,
                             2 * kKeyChunk * (int)sizeof(uint4), s>>>(
          o, n, n_iter, (uint32_t)seed, (uint32_t)step0, (uint32_t)one);
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
