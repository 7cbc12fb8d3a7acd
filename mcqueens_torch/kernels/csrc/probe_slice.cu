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
// the instance from S (probes_mem.reduce_instance).  The PRNG
// kernel is one thread per word, its draw loop over a runtime n_iter.  Every
// count, offset and width is a runtime argument; all arithmetic is uint32_t.
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

// s + x + acc: one IADD3 that LLVM cannot reassociate.
__device__ __forceinline__ uint32_t add_row(uint32_t s, uint32_t x,
                                           uint32_t acc) {
  asm volatile("add.u32 %0, %0, %1;\n\tadd.u32 %0, %0, %2;"
               : "+r"(s)
               : "r"(x), "r"(acc));
  return s;
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

template <int MODE>
__global__ void __launch_bounds__(kPrngThreads) prng_probe_kernel(
    int32_t* __restrict__ out, int n, int n_iter, uint32_t seed,
    uint32_t step0) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  uint32_t acc = 0;
  if (MODE == 0) {
    const uint32_t s = seed + (uint32_t)e;
    const uint32_t g = s * kChainK + lowbias32(s);
#pragma unroll 1
    for (int t = 0; t < n_iter; ++t) {
      const uint32_t base = lowbias32(g ^ ((step0 + (uint32_t)t) * kStepK));
      const uint32_t w0 = lowbias32(base ^ kW0K) & 0x7FFFFFFFu;
      const uint32_t w1 = lowbias32(base + kW1K);
      acc += w0 + w1;
    }
  } else {
    const mcq::Key root = {0u, seed};
#pragma unroll 1
    for (int t = 0; t < n_iter; ++t) {
      const mcq::Key k = mcq::hash(root, step0 + (uint32_t)t);
      const mcq::Key b = mcq::hash(k, (uint32_t)e);
      acc += b.k0 ^ b.k1;
    }
  }
  out[e] = (int32_t)acc;
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
// 1 threefry; returns cudaErrorInvalidValue for another mode.
extern "C" int mcq_probe_prng(void* out, int n, int mode, int n_iter,
                              int seed, int step0, void* stream) {
  const int blocks = (n + kPrngThreads - 1) / kPrngThreads;
  const cudaStream_t s = (cudaStream_t)stream;
  int32_t* o = (int32_t*)out;
  switch (mode) {
    case 0: prng_probe_kernel<0><<<blocks, kPrngThreads, 0, s>>>(o, n, n_iter, (uint32_t)seed, (uint32_t)step0); break;
    case 1: prng_probe_kernel<1><<<blocks, kPrngThreads, 0, s>>>(o, n, n_iter, (uint32_t)seed, (uint32_t)step0); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
