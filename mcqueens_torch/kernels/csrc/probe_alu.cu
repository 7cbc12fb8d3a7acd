// Int32 issue-rate probes for Hopper (sm_90a): kernels A and C.
//
// A replaces the TPU Pallas kernel of tools/roofline.py:vpu_ns_per_vreg:
// K int32 accumulators x + i, each doubled `inner` times per iteration for
// n_iter iterations, then summed (the dependent variant is K = 1 over
// n_iter * k iterations).  C replaces the one of
// tools/probe_full3d_alternatives.py:_op_rate: K accumulators x + i, each u
// times per iteration (a * x) | 1 or (a + x) | 1, XOR-folded.  Plain-torch
// twins: mcqueens_torch/kernels/probes.py:vpu_doubling_reference and
// op_chain_reference.
//
// What bounds them on the H100: int32 issue.  Each thread reads one word
// and writes one; everything between is register arithmetic on K
// independent chains, K * n_iter * inner (A) or 2 * K * n_iter * u (C)
// operations per element.  A probe that finishes faster than that count
// allows at the card's int32 rate measured a loop the compiler shortened,
// not the card.
//
// Design: one thread per (row, column) element, 128 threads a block, the
// accumulators in registers (K is a template parameter, dispatched from
// the runtime k; an array indexed at run time would live in local memory).
// Every trip count (n_iter, inner, u) is a runtime argument, so no loop can
// be evaluated at compile time.  The operations are inline PTX: LLVM would
// merge 16 doublings a + a into one shift, and the | 1 after a multiply by
// an odd value into nothing.  Each doubling also adds a runtime zero (the
// wrapper passes 0), so ptxas emits one three-input IADD3 per doubling and
// cannot merge two of them either.  All arithmetic is uint32_t: int32
// wrap-around is what the TPU kernels compute, and signed overflow is
// undefined in C++.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t double_plus(uint32_t a, uint32_t zero) {
  asm volatile("add.u32 %0, %0, %0;\n\tadd.u32 %0, %0, %1;"
               : "+r"(a)
               : "r"(zero));
  return a;
}

template <int K>
__global__ void __launch_bounds__(128) vpu_probe_kernel(
    const int32_t* __restrict__ x, int32_t* __restrict__ out, int n,
    int n_iter, int inner, uint32_t zero) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const uint32_t x0 = (uint32_t)x[e];
  uint32_t acc[K];
#pragma unroll
  for (int i = 0; i < K; ++i) acc[i] = x0 + (uint32_t)i;
  for (int t = 0; t < n_iter; ++t) {
#pragma unroll 16
    for (int r = 0; r < inner; ++r) {
#pragma unroll
      for (int i = 0; i < K; ++i) acc[i] = double_plus(acc[i], zero);
    }
  }
  uint32_t s = acc[0];
#pragma unroll
  for (int i = 1; i < K; ++i) s += acc[i];
  out[e] = (int32_t)s;
}

template <bool MUL>
__device__ __forceinline__ uint32_t op_or1(uint32_t a, uint32_t x) {
  if (MUL) {
    asm volatile("mul.lo.u32 %0, %0, %1;\n\tor.b32 %0, %0, 1;"
                 : "+r"(a)
                 : "r"(x));
  } else {
    asm volatile("add.u32 %0, %0, %1;\n\tor.b32 %0, %0, 1;"
                 : "+r"(a)
                 : "r"(x));
  }
  return a;
}

template <int K, bool MUL>
__global__ void __launch_bounds__(128) op_probe_kernel(
    const int32_t* __restrict__ x, int32_t* __restrict__ out, int n,
    int n_iter, int u) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const uint32_t x0 = (uint32_t)x[e];
  uint32_t acc[K];
#pragma unroll
  for (int i = 0; i < K; ++i) acc[i] = x0 + (uint32_t)i;
  for (int t = 0; t < n_iter; ++t) {
#pragma unroll 8
    for (int r = 0; r < u; ++r) {
#pragma unroll
      for (int i = 0; i < K; ++i) acc[i] = op_or1<MUL>(acc[i], x0);
    }
  }
  uint32_t s = acc[0];
#pragma unroll
  for (int i = 1; i < K; ++i) s ^= acc[i];
  out[e] = (int32_t)s;
}

template <int K>
void launch_vpu(const int32_t* x, int32_t* out, int n, int n_iter, int inner,
                uint32_t zero, cudaStream_t stream) {
  vpu_probe_kernel<K><<<(n + 127) / 128, 128, 0, stream>>>(x, out, n, n_iter,
                                                            inner, zero);
}

template <int K>
void launch_op(const int32_t* x, int32_t* out, int n, int mul, int n_iter,
               int u, cudaStream_t stream) {
  const int blocks = (n + 127) / 128;
  if (mul) {
    op_probe_kernel<K, true><<<blocks, 128, 0, stream>>>(x, out, n, n_iter, u);
  } else {
    op_probe_kernel<K, false><<<blocks, 128, 0, stream>>>(x, out, n, n_iter,
                                                           u);
  }
}

}  // namespace

// Kernel A on `stream`: x and out are n int32 device words; k in {1, 4, 8}
// (the roofline's 8 chains and its dependent chain, and 4); zero must be 0.
// Returns cudaGetLastError() (0 on success), cudaErrorInvalidValue for
// another k.
extern "C" int mcq_probe_vpu(const void* x, void* out, int n, int k,
                             int n_iter, int inner, int zero, void* stream) {
  const int32_t* xi = (const int32_t*)x;
  int32_t* o = (int32_t*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  const uint32_t z = (uint32_t)zero;
  switch (k) {
    case 1: launch_vpu<1>(xi, o, n, n_iter, inner, z, s); break;
    case 4: launch_vpu<4>(xi, o, n, n_iter, inner, z, s); break;
    case 8: launch_vpu<8>(xi, o, n, n_iter, inner, z, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Kernel C on `stream`: op 0 is add, 1 is mul; k in {1, 4, 16} (the
// alternatives probe's 16 chains, 4, and one chain with no XOR fold).
extern "C" int mcq_probe_op(const void* x, void* out, int n, int op, int k,
                            int n_iter, int u, void* stream) {
  const int32_t* xi = (const int32_t*)x;
  int32_t* o = (int32_t*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1: launch_op<1>(xi, o, n, op, n_iter, u, s); break;
    case 4: launch_op<4>(xi, o, n, op, n_iter, u, s); break;
    case 16: launch_op<16>(xi, o, n, op, n_iter, u, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
