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
// memory: on axis 1 a tile of G whole rows (every output of a row depends on
// every input of that row), on axis 0 all S rows of a strip of G columns.
// The tile is double-buffered, so each step is one __syncthreads: a step
// reads one buffer and writes the other.  Each of the block's 256 threads
// holds E elements (E a template parameter, E * 256 >= the tile): their
// gather sources stay in registers as shared-memory offsets, so the hot loop
// is a load, an add and a store per element.  Elements past the tile's edge
// gather from and write to their own slot of the padded buffer, so the loop
// has no branch.  On axis 1 a warp's 32 random sources fall in random banks
// and conflict; on axis 0 the strip is row-major and 32 wide, so a warp's
// lanes read 32 different columns, one bank each.  Both are what the layout
// costs and are kept.  n_iter is a runtime argument; all arithmetic is
// uint32_t (int32 wrap-around, as on the TPU).

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

template <int E>
__global__ void __launch_bounds__(kChainThreads) gather_chain_probe_kernel(
    const int32_t* __restrict__ x, const int32_t* __restrict__ idx,
    int32_t* __restrict__ out, int S, int L, int axis, int tile_rows,
    int tile_cols, int n_iter) {
  extern __shared__ uint32_t buf[];  // two buffers of E * kChainThreads
  constexpr int kPad = E * kChainThreads;
  const int row0 = axis == 1 ? blockIdx.x * tile_rows : 0;
  const int col0 = axis == 1 ? 0 : blockIdx.x * tile_cols;
  const int rows = min(tile_rows, S - row0);
  const int cols = min(tile_cols, L - col0);
  int src[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int e = threadIdx.x + j * kChainThreads;
    const int r = e / tile_cols, c = e - r * tile_cols;
    src[j] = e;
    uint32_t v = 0;
    if (r < rows && c < cols) {
      const long long g = (long long)(row0 + r) * L + col0 + c;
      const int i = idx[g];
      src[j] = axis == 1 ? r * tile_cols + i : i * tile_cols + c;
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
      buf[nxt + threadIdx.x + j * kChainThreads] = buf[cur + src[j]] + 1u;
    }
    __syncthreads();
    cur = nxt;
  }
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int e = threadIdx.x + j * kChainThreads;
    const int r = e / tile_cols, c = e - r * tile_cols;
    if (r < rows && c < cols) {
      out[(long long)(row0 + r) * L + col0 + c] = (int32_t)buf[cur + e];
    }
  }
}

template <int E>
int launch_chain(const int32_t* x, const int32_t* idx, int32_t* out, int S,
                 int L, int axis, int tile_rows, int tile_cols, int n_iter,
                 cudaStream_t stream) {
  const int smem = 2 * E * kChainThreads * (int)sizeof(uint32_t);
  const cudaError_t err = cudaFuncSetAttribute(
      gather_chain_probe_kernel<E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = axis == 1 ? (S + tile_rows - 1) / tile_rows
                               : (L + tile_cols - 1) / tile_cols;
  gather_chain_probe_kernel<E><<<blocks, kChainThreads, smem, stream>>>(
      x, idx, out, S, L, axis, tile_rows, tile_cols, n_iter);
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
// elements each, e in {1, 2, 4, 8, 16, 32} with e * 256 >= the tile.
// Returns cudaErrorInvalidValue for another e.
extern "C" int mcq_probe_gather_chain(const void* x, const void* idx,
                                      void* out, int S, int L, int axis,
                                      int tile_rows, int tile_cols, int e,
                                      int n_iter, void* stream) {
  const int32_t* xi = (const int32_t*)x;
  const int32_t* ii = (const int32_t*)idx;
  int32_t* o = (int32_t*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (e) {
    case 1: return launch_chain<1>(xi, ii, o, S, L, axis, tile_rows, tile_cols, n_iter, s);
    case 2: return launch_chain<2>(xi, ii, o, S, L, axis, tile_rows, tile_cols, n_iter, s);
    case 4: return launch_chain<4>(xi, ii, o, S, L, axis, tile_rows, tile_cols, n_iter, s);
    case 8: return launch_chain<8>(xi, ii, o, S, L, axis, tile_rows, tile_cols, n_iter, s);
    case 16: return launch_chain<16>(xi, ii, o, S, L, axis, tile_rows, tile_cols, n_iter, s);
    case 32: return launch_chain<32>(xi, ii, o, S, L, axis, tile_rows, tile_cols, n_iter, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
