// Dynamic-gather probes for Hopper (sm_90a): the gather and the gather chain.
//
// The gather replaces the TPU Pallas kernels of
// tools/probe_gather.py:gather_correct and gather_narrow_idx:
// out = take_along_axis(x, idx, axis) on int32, axis 1 out[s, k] =
// x[s, idx[s, k]] with idx (S, K), axis 0 out[k, l] = x[idx[k, l], l] with
// idx (K, L).  The gather chain replaces the one of :gather_cost: from
// acc = x, n_iter times acc = take_along_axis(acc, idx, axis) + 1, idx
// (S, L).  Plain-torch twins: mcqueens_torch/kernels/probes_mem.py:
// gather_reference, gather_chain_reference.
//
// What bounds them on the H100.  The gather is one pass: each output word
// costs an index word read, a gathered word read and a word written, so
// device-memory bytes.  The gather chain runs out of shared memory: every
// step of every element is one gathered load and one store there (and one
// add), and shared memory serves 32 banks x 4 bytes per SM per clock.
//
// Design.  The gather is one thread per output word; the axis is a runtime
// argument.  The gather chain keeps a tile of whole segments in shared
// memory: on axis 1 a tile of whole rows (every output of a row depends on
// every input of that row; the wrapper's rule, probes_mem.chain_tile, takes
// rows up to 1024 words a tile), on axis 0 all S rows of a strip of G
// columns.  The tile is double-buffered, so each step is one
// __syncthreads: a step reads one buffer and writes the other.  n_iter is
// a runtime argument; all arithmetic is uint32_t (int32 wrap-around, as on
// the TPU).
//
// Axis 0: each of the block's 256 threads holds E elements (E a template
// parameter, E * 256 >= the tile), their gather sources in registers as
// shared-memory offsets, so the hot loop is a load, an add and a store per
// element.  The strip is row-major and 32 wide, so a warp's lanes read 32
// different columns, one bank each: no conflict.  Elements past the tile's
// edge gather from and write to their own slot of the padded buffer.
//
// Axis 1: a warp's 32 gathered loads of random sources fall in random banks
// and conflict (~3.2 wavefronts a load at L = 256).  The index is the same
// at every step, so a prologue in the launch (build_schedule) computes a
// bank schedule from it once, and every step then issues instructions whose
// 32 loads and 32 stores each hit 32 distinct banks:
//   (a) a layout: the tile's words are placed in the buffers by their
//       in-degree in idx (how many elements gather them), highest first,
//       dealt to the 32 banks in snake order, so each bank holds at most
//       ceil(tile / 32) words and about the same number of gathers;
//   (b) an assignment of elements to (instruction, lane): warp 0's lane b
//       takes the elements whose source lies in bank b, one a round (all
//       lanes in lockstep), and puts each in the first instruction that
//       holds no other load from bank b and whose lane for the element's
//       store bank is free, found from two bitmasks (each load bank's
//       instructions, the lane's own; each store bank's, claimed by a
//       shared-memory atomicOr, so a claim another lane won moves on to the
//       next).  An element that finds none within the kInstr = 8 * kSlots
//       instructions goes to the first whose store lane is free, a load
//       conflict (a bank holds at most 8 E words, so one is).
// Instruction c is warp c % 8's slot c / 8; a slot with no element is
// predicated off.  Every step still gathers, adds and stores every element
// once; only the order of the accesses and the words' places change.  The
// step loop runs two steps a trip, so both buffers' offsets are immediates.
// Beside the buffers the schedule takes kInstr * 32 words, the two bitmasks
// 2 * 32 * ceil(kInstr / 32), four 32-word counters and a 16-bit position
// per word (16 KB a block at E = 4, so 8 blocks fit an SM); during the
// prologue the second buffer holds the in-degrees, then the elements
// grouped by source bank.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGatherThreads = 256;
constexpr int kChainThreads = 256;

__global__ void __launch_bounds__(kGatherThreads) gather_probe_kernel(
    const int32_t* __restrict__ x, const int32_t* __restrict__ idx,
    int32_t* __restrict__ out, int L, int n_out, int out_cols, int axis) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_out) return;
  const int r = e / out_cols, c = e - r * out_cols;
  const long long i = idx[e];
  out[e] = axis == 1 ? x[(long long)r * L + i] : x[i * L + c];
}

constexpr int kChainWarps = kChainThreads / 32;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr uint32_t kNoElement = 0xFFFFFFFFu;  // an empty (instruction, lane)

// The shapes of instance E: a buffer's words, a thread's instruction slots
// (room for the schedule's extra instructions), the instructions a step at
// most, and the words of a bit per instruction.
template <int E>
struct Chain {
  static constexpr int kPad = E * kChainThreads;
  static constexpr int kSlots = E + (E + 3) / 4;
  static constexpr int kInstr = kSlots * kChainWarps;
  static constexpr int kOccWords = (kInstr + 31) / 32;
  // shared words: two buffers, the schedule, each store bank's and each
  // load bank's instructions taken (word o of bank b at o * 32 + b), four
  // counters, the positions (16 bits)
  static constexpr int kSched = 2 * kPad;
  static constexpr int kTaken = kSched + kInstr * 32;
  static constexpr int kOcc = kTaken + kOccWords * 32;
  static constexpr int kCounts = kOcc + kOccWords * 32;
  static constexpr int kPos = kCounts + 4 * 32;
  static constexpr int kWords = kPos + kPad / 2;
  static constexpr int kMinBlocks = E <= 4 ? 8 : E == 8 ? 4 : E == 16 ? 2 : 1;
};

// Exclusive prefix sum of v over the 32 lanes of a warp.
__device__ __forceinline__ uint32_t warp_exclusive_sum(uint32_t v) {
  const int lane = threadIdx.x & 31;
  uint32_t s = v;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const uint32_t t = __shfl_sync(kFull, s, lane >= d ? lane - d : lane);
    if (lane >= d) s += t;
  }
  return s - v;
}

// Axis 1's prologue (the file's header): reads the tile's x and idx, puts
// each word's x at its position in the first buffer, and leaves each
// thread's slots (load and store byte offsets in a buffer, live bits) and
// its own words' positions.  T words: the tile's rows * L.
template <int E>
__device__ __forceinline__ void build_schedule(
    uint32_t* sm, const int32_t* __restrict__ x,
    const int32_t* __restrict__ idx, long long g0, int L, int T,
    uint32_t (&ld)[Chain<E>::kSlots], uint32_t (&st)[Chain<E>::kSlots],
    uint64_t& live, uint32_t (&mypos)[E]) {
  using C = Chain<E>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t* deg = sm + C::kPad;  // the second buffer, then the lists
  uint32_t* list = sm + C::kPad;
  uint32_t* sched = sm + C::kSched;
  uint32_t* taken = sm + C::kTaken;  // by store bank, claimed by atomicOr
  uint32_t* occ = sm + C::kOcc;      // by load bank, one lane's own
  uint16_t* pos = reinterpret_cast<uint16_t*>(sm + C::kPos);
  uint32_t* hist = sm + C::kCounts;     // words by degree bucket
  uint32_t* cursor = hist + 32;         // their next rank
  uint32_t* lbcnt = hist + 64;          // elements by source bank
  uint32_t* lboff = hist + 96;          // where their list starts
  for (int i = tid; i < T; i += kChainThreads) deg[i] = 0;
  for (int i = tid; i < C::kInstr * 32; i += kChainThreads) {
    sched[i] = kNoElement;
  }
  for (int i = C::kTaken + tid; i < C::kPos; i += kChainThreads) {
    // taken and occ (instructions past kInstr taken), the counters
    const int o = (i - C::kTaken) / 32 % C::kOccWords;
    sm[i] = i < C::kCounts && o == C::kOccWords - 1 && C::kInstr % 32
                ? ~((1u << C::kInstr % 32) - 1)
                : 0u;
  }
  uint32_t val[E], src[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int w = tid + j * kChainThreads;
    src[j] = 0;
    val[j] = 0;
    if (w < T) {
      const int r = w / L;
      val[j] = (uint32_t)x[g0 + w];
      src[j] = (uint32_t)(r * L + idx[g0 + w]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < E; ++j) {
    if (tid + j * kChainThreads < T) atomicAdd(&deg[src[j]], 1u);
  }
  __syncthreads();
  uint32_t bucket[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int w = tid + j * kChainThreads;
    bucket[j] = w < T ? 31 - min(deg[w], 31u) : 0;  // highest degree first
    if (w < T) atomicAdd(&hist[bucket[j]], 1u);
  }
  __syncthreads();
  if (warp == 0) cursor[lane] = warp_exclusive_sum(hist[lane]);
  __syncthreads();
  // (a) the layout: rank r in degree order -> round r / 32, bank r % 32 in
  // even rounds, 31 - r % 32 in odd ones
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int w = tid + j * kChainThreads;
    if (w < T) {
      const uint32_t r = atomicAdd(&cursor[bucket[j]], 1u);
      const uint32_t q = r >> 5, b = (q & 1) ? 31 - (r & 31) : r & 31;
      mypos[j] = q * 32 + b;
      pos[w] = (uint16_t)mypos[j];
      sm[mypos[j]] = val[j];
    }
  }
  __syncthreads();
  uint32_t packed[E], slot[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    packed[j] = kNoElement;
    if (tid + j * kChainThreads < T) {
      packed[j] = pos[src[j]] | mypos[j] << 16;
      slot[j] = atomicAdd(&lbcnt[packed[j] & 31], 1u);
    }
  }
  __syncthreads();
  if (warp == 0) lboff[lane] = warp_exclusive_sum(lbcnt[lane]);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < E; ++j) {
    if (packed[j] != kNoElement) {
      list[lboff[packed[j] & 31] + slot[j]] = packed[j];
    }
  }
  __syncthreads();
  // (b) the assignment: lane b places the elements whose source is in
  // bank b
  if (warp == 0) {
    // in rounds: each lane places its k-th element in round k
    const uint32_t n = lbcnt[lane], begin = lboff[lane];
    const uint32_t rounds = (uint32_t)__reduce_max_sync(kFull, (int)n);
    for (uint32_t k = 0; k < rounds; __syncwarp(), ++k) {
      if (k >= n) continue;
      const uint32_t v = list[begin + k], sb = v >> 16 & 31;
      // the first instruction with both banks free, else (a load
      // conflict) the first with the store bank free; a claim another lane
      // won meanwhile moves on to the next
      bool placed = false;
      for (int pass = 0; pass < 2 && !placed; ++pass) {
        for (int o = 0; o < C::kOccWords && !placed; ++o) {
          const uint32_t held = pass ? 0u : occ[o * 32 + lane];
          uint32_t avail = ~(held | taken[o * 32 + sb]);
          while (avail) {
            const int bit = __ffs((int)avail) - 1;
            avail &= avail - 1;
            if (!(atomicOr(&taken[o * 32 + sb], 1u << bit) >> bit & 1)) {
              if (!pass) occ[o * 32 + lane] = held | 1u << bit;
              sched[(o * 32 + bit) * 32 + sb] = v;
              placed = true;
              break;
            }
          }
        }
      }
    }
  }
  __syncthreads();
  live = 0;
#pragma unroll
  for (int j = 0; j < C::kSlots; ++j) {
    const uint32_t v = sched[(j * kChainWarps + warp) * 32 + lane];
    ld[j] = (v & 0xFFFFu) * 4;
    st[j] = (v >> 16) * 4;
    if (v != kNoElement) live |= 1ull << j;
  }
}

// One step of axis 1 from buffer `from` to buffer `to` (byte addresses).
template <int S>
__device__ __forceinline__ void chain_step(const char* from, char* to,
                                           const uint32_t (&ld)[S],
                                           const uint32_t (&st)[S],
                                           uint64_t live) {
#pragma unroll
  for (int j = 0; j < S; ++j) {
    if (live >> j & 1) {
      *reinterpret_cast<uint32_t*>(to + st[j]) =
          *reinterpret_cast<const uint32_t*>(from + ld[j]) + 1u;
    }
  }
}

template <int E>
__global__ void __launch_bounds__(kChainThreads, Chain<E>::kMinBlocks)
    gather_chain_probe_kernel(const int32_t* __restrict__ x,
                              const int32_t* __restrict__ idx,
                              int32_t* __restrict__ out,
                              int32_t* __restrict__ sched_out, int S, int L,
                              int axis, int tile_rows, int tile_cols,
                              int n_iter) {
  extern __shared__ uint32_t buf[];  // Chain<E>: two buffers (+ schedule)
  using C = Chain<E>;
  constexpr int kPad = C::kPad;
  const int tid = threadIdx.x;
  if (axis == 1) {
    const int row0 = blockIdx.x * tile_rows;
    const int T = min(tile_rows, S - row0) * L;
    const long long g0 = (long long)row0 * L;
    uint32_t ld[C::kSlots], st[C::kSlots], mypos[E];
    uint64_t live;
    build_schedule<E>(buf, x, idx, g0, L, T, ld, st, live, mypos);
    if (sched_out) {
      int32_t* o = sched_out + (long long)blockIdx.x * C::kInstr * 32;
      for (int i = tid; i < C::kInstr * 32; i += kChainThreads) {
        o[i] = (int32_t)buf[C::kSched + i];
      }
    }
    char* b0 = reinterpret_cast<char*>(buf);
    char* b1 = reinterpret_cast<char*>(buf + kPad);
#pragma unroll 1
    for (int t = 1; t < n_iter; t += 2) {
      chain_step(b0, b1, ld, st, live);
      __syncthreads();
      chain_step(b1, b0, ld, st, live);
      __syncthreads();
    }
    int cur = 0;
    if (n_iter & 1) {
      chain_step(b0, b1, ld, st, live);
      __syncthreads();
      cur = kPad;
    }
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int w = tid + j * kChainThreads;
      if (w < T) out[g0 + w] = (int32_t)buf[cur + mypos[j]];
    }
    return;
  }
  const int col0 = blockIdx.x * tile_cols;
  const int rows = S;
  const int cols = min(tile_cols, L - col0);
  int src[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int e = tid + j * kChainThreads;
    const int r = e / tile_cols, c = e - r * tile_cols;
    src[j] = e;
    uint32_t v = 0;
    if (r < rows && c < cols) {
      const long long g = (long long)r * L + col0 + c;
      src[j] = idx[g] * tile_cols + c;
      v = (uint32_t)x[g];
    }
    buf[e] = v;
  }
  __syncthreads();
  int cur = 0;
#pragma unroll 1
  for (int t = 0; t < n_iter; ++t) {
    const int nxt = kPad - cur;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      buf[nxt + tid + j * kChainThreads] = buf[cur + src[j]] + 1u;
    }
    __syncthreads();
    cur = nxt;
  }
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int e = tid + j * kChainThreads;
    const int r = e / tile_cols, c = e - r * tile_cols;
    if (r < rows && c < cols) {
      out[(long long)r * L + col0 + c] = (int32_t)buf[cur + e];
    }
  }
}

template <int E>
int launch_chain(const int32_t* x, const int32_t* idx, int32_t* out,
                 int32_t* sched_out, int S, int L, int axis, int tile_rows,
                 int tile_cols, int n_iter, cudaStream_t stream) {
  const int smem = (axis == 1 ? Chain<E>::kWords : 2 * Chain<E>::kPad) *
                   (int)sizeof(uint32_t);
  const cudaError_t err = cudaFuncSetAttribute(
      gather_chain_probe_kernel<E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = axis == 1 ? (S + tile_rows - 1) / tile_rows
                               : (L + tile_cols - 1) / tile_cols;
  gather_chain_probe_kernel<E><<<blocks, kChainThreads, smem, stream>>>(
      x, idx, out, sched_out, S, L, axis, tile_rows, tile_cols, n_iter);
  return (int)cudaGetLastError();
}

}  // namespace

// The gather on `stream`: x is (rows of x, L) int32, idx and out are the
// (n_out / out_cols, out_cols) output shape; every index lies in [0, dim)
// of `axis` (the wrapper checks).  Returns cudaGetLastError().
extern "C" int mcq_probe_gather(const void* x, const void* idx, void* out,
                                int L, int n_out, int out_cols, int axis,
                                void* stream) {
  const int blocks = (n_out + kGatherThreads - 1) / kGatherThreads;
  gather_probe_kernel<<<blocks, kGatherThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)idx, (int32_t*)out, L, n_out,
      out_cols, axis);
  return (int)cudaGetLastError();
}

// The gather chain on `stream`: x, idx, out (S, L) int32; a block holds a
// (tile_rows, tile_cols) tile (axis 1: (G, L); axis 0: (S, G)), e threads'
// elements each, e in {1, 2, 4, 8, 16, 32} with e * 256 >= the tile.  On
// axis 1, sched_out, unless null, receives each block's schedule: 8 *
// (e + ceil(e / 4)) instructions of 32 lanes, each lane's element as (its
// source's position | its own position << 16), or -1 if it has none.
// Returns cudaErrorInvalidValue for another e.
extern "C" int mcq_probe_gather_chain(const void* x, const void* idx,
                                      void* out, void* sched_out, int S,
                                      int L, int axis, int tile_rows,
                                      int tile_cols, int e, int n_iter,
                                      void* stream) {
  const int32_t* xi = (const int32_t*)x;
  const int32_t* ii = (const int32_t*)idx;
  int32_t* o = (int32_t*)out;
  int32_t* so = (int32_t*)sched_out;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (e) {
    case 1: return launch_chain<1>(xi, ii, o, so, S, L, axis, tile_rows, tile_cols, n_iter, s);
    case 2: return launch_chain<2>(xi, ii, o, so, S, L, axis, tile_rows, tile_cols, n_iter, s);
    case 4: return launch_chain<4>(xi, ii, o, so, S, L, axis, tile_rows, tile_cols, n_iter, s);
    case 8: return launch_chain<8>(xi, ii, o, so, S, L, axis, tile_rows, tile_cols, n_iter, s);
    case 16: return launch_chain<16>(xi, ii, o, so, S, L, axis, tile_rows, tile_cols, n_iter, s);
    case 32: return launch_chain<32>(xi, ii, o, so, S, L, axis, tile_rows, tile_cols, n_iter, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
