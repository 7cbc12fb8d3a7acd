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
// operations per element.  An SM issues int32 work on two pipes of 64 lanes,
// the ALU pipe (IADD3, LOP3) and the FMA pipe (IMAD), one warp instruction
// per scheduler per clock: a probe that finishes faster than its count at
// both pipes' rate measured a loop the compiler shortened, not the card.
//
// Design: one thread per (row, column) element, 128 threads a block, the
// accumulators in registers (K is a template parameter, dispatched from
// the runtime k; an array indexed at run time would live in local memory).
// Every trip count (n_iter, inner, u) is a runtime argument, so no loop can
// be evaluated at compile time.  The operations are inline PTX: LLVM would
// merge 16 doublings a + a into one shift, and the | 1 after a multiply by
// an odd value into nothing.  A doubling is one instruction with a runtime
// operand, so no compiler can fold two of them: a + a + zero (one IADD3,
// ALU pipe) or a * two + zero (one IMAD, FMA pipe), the wrapper passing
// zero = 0 and two = 2; a * 2 + 0 = a + a mod 2^32, so the words do not
// depend on the form.  Kernel A issues half its doublings in each form, so
// that both pipes are busy (all in IADD3, it ran at the ALU pipe's half of
// the card's rate): with K > 1 the even chains use IMAD and the odd ones
// IADD3; with one chain, doubling r uses IADD3 for even r and IMAD for odd
// r.  All arithmetic is uint32_t: int32 wrap-around is what the TPU
// kernels compute, and signed overflow is undefined in C++.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// a + a + zero: one IADD3 (ALU pipe).
__device__ __forceinline__ uint32_t double_add(uint32_t a, uint32_t zero) {
  asm volatile("add.u32 %0, %0, %0;\n\tadd.u32 %0, %0, %1;"
               : "+r"(a)
               : "r"(zero));
  return a;
}

// a * two + zero: one IMAD (FMA pipe).
__device__ __forceinline__ uint32_t double_mad(uint32_t a, uint32_t two,
                                               uint32_t zero) {
  asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(a) : "r"(two), "r"(zero));
  return a;
}

// One doubling of every chain: IMAD on the even chains, IADD3 on the odd.
template <int K>
__device__ __forceinline__ void double_chains(uint32_t (&acc)[K],
                                              uint32_t two, uint32_t zero) {
#pragma unroll
  for (int i = 0; i < K; i += 2) acc[i] = double_mad(acc[i], two, zero);
#pragma unroll
  for (int i = 1; i < K; i += 2) acc[i] = double_add(acc[i], zero);
}

template <int K>
__global__ void __launch_bounds__(128) vpu_probe_kernel(
    const int32_t* __restrict__ x, int32_t* __restrict__ out, int n,
    int n_iter, int inner, uint32_t two, uint32_t zero) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const uint32_t x0 = (uint32_t)x[e];
  uint32_t acc[K];
#pragma unroll
  for (int i = 0; i < K; ++i) acc[i] = x0 + (uint32_t)i;
  // Each chain is doubled n_iter * inner times, in one loop: a loop over
  // inner restarted every iteration cost the one-chain roofline variant
  // (inner 16) more in set-up than in doublings.
  const int total = n_iter * inner;
  // doublings r - 1 and r (r odd); 16 trips unrolled: 32 doublings a
  // chain, so the loop's own three instructions cost one chain under 10%
#pragma unroll 16
  for (int r = 1; r < total; r += 2) {
    if constexpr (K == 1) {
      acc[0] = double_add(acc[0], zero);
      acc[0] = double_mad(acc[0], two, zero);
    } else {
      double_chains<K>(acc, two, zero);
      double_chains<K>(acc, two, zero);
    }
  }
  if (total & 1) {  // doubling total - 1, whose index is even
    if constexpr (K == 1) {
      acc[0] = double_add(acc[0], zero);
    } else {
      double_chains<K>(acc, two, zero);
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
                uint32_t two, uint32_t zero, cudaStream_t stream) {
  vpu_probe_kernel<K><<<(n + 127) / 128, 128, 0, stream>>>(
      x, out, n, n_iter, inner, two, zero);
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
// (the roofline's 8 chains and its dependent chain, and 4); two must be 2
// and zero 0; n_iter * inner < 2^31.  Returns cudaGetLastError() (0 on
// success), cudaErrorInvalidValue for another k or a longer chain.
extern "C" int mcq_probe_vpu(const void* x, void* out, int n, int k,
                             int n_iter, int inner, int two, int zero,
                             void* stream) {
  if ((long long)n_iter * inner >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const int32_t* xi = (const int32_t*)x;
  int32_t* o = (int32_t*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  const uint32_t w = (uint32_t)two, z = (uint32_t)zero;
  switch (k) {
    case 1: launch_vpu<1>(xi, o, n, n_iter, inner, w, z, s); break;
    case 4: launch_vpu<4>(xi, o, n, n_iter, inner, w, z, s); break;
    case 8: launch_vpu<8>(xi, o, n, n_iter, inner, w, z, s); break;
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
