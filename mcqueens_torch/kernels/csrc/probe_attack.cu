// Full-3D attack-test probes for Hopper (sm_90a): kernels B and D.
//
// B replaces the TPU Pallas kernel of
// tools/probe_full3d_alternatives.py:_test_rate: K int32 accumulators, each
// updated u times per iteration by a += fn(xi ^ a, xi + 1, xi + 2, cx,
// cx + 1, cx + 2) with cx = c0, fn the production two-test form, its
// multiply-free twin or the packed two-queens-per-lane (SWAR) form; the
// accumulators are summed.  D replaces the one of
// tools/probe_swar_sweep.py:_sweep_time: per chunk t, 9 targets hashed from
// t (lowbias32, its first shift arithmetic and unmasked) are scored against
// every row of (QS, C) coordinate planes (production: attack + occupancy at
// bit 16; SWAR: biased 16-bit halves, attack and occupancy summed apart),
// and each target's column sums are XOR-folded into carried rows; the
// output is acc_att + acc_occ.  Plain-torch twins:
// mcqueens_torch/kernels/probes.py:attack_test_reference, sweep_reference.
//
// What bounds them on the H100: int32 issue.  B touches one word in and
// one out per element.  D reads 3 * QS words per column per chunk and does
// 22 (production) or 105 (SWAR, two queens) int32 operations per row and
// target as the TPU source writes them, 9 targets a row: operations
// outweigh bytes by two orders.
//
// Design: B is one thread per (row, column) element with the accumulators
// in registers (K a template parameter dispatched from the runtime k; n_iter
// and u runtime).  In the TPU body only xi ^ a depends on the accumulator;
// everything that depends on xj and xk alone is loop-invariant, and LLVM
// would hoist it, leaving a third of an attack test per evaluation.  So each
// evaluation ties xj and xk to its accumulator through a runtime zero (the
// wrapper passes 0): xj ^ (a & zero) is xj, one LOP3 the compiler cannot
// drop, and every evaluation is a whole attack test.  D is one thread per column, as the port's production
// full-3D kernel (full3d_shared.cu) runs one thread per chain: the 9
// targets and their 9 (SWAR: 18) accumulators stay in registers while the
// thread walks the rows of its column, one coalesced load per plane a row;
// the TPU kernel's 8-row blocks and tree reductions were its vector layout
// (int32 addition mod 2^32 is associative, so the sums are bitwise the
// same).  n_chunks, QS and C are runtime arguments.  All arithmetic is
// uint32_t; the JAX code's arithmetic right shifts (lowbias32's first
// shift, the halves' guard-bit shifts) cast to int32 first.  Signed max and
// compares cast to int32 as jnp.maximum and == on int32 do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kHint = 0x80008000u;
constexpr uint32_t kGuard = 0x7FFF7FFFu;
constexpr uint32_t kOnes = 0x00010001u;
constexpr uint32_t kM128 = 0x00800080u;
constexpr uint32_t kB64 = 0x00400040u;
constexpr int kTargets = 9;

__device__ __forceinline__ uint32_t sar(uint32_t x, int s) {
  return (uint32_t)((int32_t)x >> s);
}

__device__ __forceinline__ uint32_t smax32(uint32_t a, uint32_t b) {
  return (uint32_t)max((int32_t)a, (int32_t)b);
}

// 1 in each 16-bit field's low bit iff that field of e is zero.
__device__ __forceinline__ uint32_t zero_halves(uint32_t e) {
  const uint32_t t = (e & kGuard) + kGuard;
  const uint32_t nz = (t | e) & kHint;
  const uint32_t m = sar(nz, 15) & kOnes;
  return kOnes - m;
}

__device__ __forceinline__ uint32_t eq_halves(uint32_t a, uint32_t b) {
  return zero_halves(a ^ b);
}

// Per-16-bit-field max via the guard-bit subtract trick.
__device__ __forceinline__ uint32_t smax_halves(uint32_t a, uint32_t b) {
  const uint32_t z = (a | kHint) - (b & kGuard);
  const uint32_t s = z & kHint;
  const uint32_t mask = (sar(s, 15) & kOnes) * 0xFFFFu;
  return (a & mask) | (b & ~mask);
}

// The live two-test form: 1 iff the cells attack (or coincide), plus `occ`
// iff all three deltas are zero.
__device__ __forceinline__ uint32_t two_test(uint32_t di, uint32_t dj,
                                             uint32_t dk, uint32_t occ) {
  const uint32_t p2 = di * di, q2 = dj * dj, r2 = dk * dk;
  const uint32_t m = smax32(p2, smax32(q2, r2));
  const uint32_t t = (p2 * (p2 - m)) | (q2 * (q2 - m)) | (r2 * (r2 - m));
  return (t == 0u ? 1u : 0u) + (m == 0u ? occ : 0u);
}

// Packed biased diffs (per half coord - cand + 64): the 7-relation attack
// per half in *att, occupancy (all three deltas zero) per half in *occ.
__device__ __forceinline__ void swar_scores(uint32_t di, uint32_t dj,
                                            uint32_t dk, uint32_t* att,
                                            uint32_t* occ) {
  const uint32_t zi = eq_halves(di, kB64), zj = eq_halves(dj, kB64),
                 zk = eq_halves(dk, kB64);
  const uint32_t ai = smax_halves(di, kM128 - di);
  const uint32_t aj = smax_halves(dj, kM128 - dj);
  const uint32_t ak = smax_halves(dk, kM128 - dk);
  const uint32_t eij = eq_halves(ai, aj), eik = eq_halves(ai, ak),
                 ejk = eq_halves(aj, ak);
  const uint32_t two_axis = (zi & zj) | (zi & zk) | (zj & zk);
  *att = (two_axis | (zk & eij) | (zj & eik) | (zi & ejk) | (eij & eik)) &
         kOnes;
  *occ = (zi & zj) & zk;
}

// Kernel B's three forms (KIND 0 production, 1 nomul, 2 swar).
template <int KIND>
__device__ __forceinline__ uint32_t test_fn(uint32_t xi, uint32_t xj,
                                            uint32_t xk, uint32_t cx,
                                            uint32_t cy, uint32_t cz) {
  if (KIND == 0) return two_test(xi - cx, xj - cy, xk - cz, 2u);
  if (KIND == 1) {
    const uint32_t di = xi - cx, dj = xj - cy, dk = xk - cz;
    const uint32_t ai = smax32(di, 0u - di), aj = smax32(dj, 0u - dj),
                   ak = smax32(dk, 0u - dk);
    const uint32_t m = smax32(ai, smax32(aj, ak));
    const bool att = ((ai == 0u) | (ai == m)) & ((aj == 0u) | (aj == m)) &
                     ((ak == 0u) | (ak == m));
    return (att ? 1u : 0u) + (m == 0u ? 2u : 0u);
  }
  uint32_t att, occ;
  swar_scores(xi + cx, xj + cy, xk + cz, &att, &occ);
  return att;
}

template <int K, int KIND>
__global__ void __launch_bounds__(128) test_probe_kernel(
    const int32_t* __restrict__ x, int32_t* __restrict__ out, int n,
    int n_iter, int u, uint32_t c0, uint32_t zero) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const uint32_t xi = (uint32_t)x[e];
  const uint32_t xj = xi + 1u, xk = xi + 2u;
  const uint32_t cx = c0, cy = cx + 1u, cz = cx + 2u;
  uint32_t acc[K];
#pragma unroll
  for (int i = 0; i < K; ++i) acc[i] = (uint32_t)i;
  for (int t = 0; t < n_iter; ++t) {
#pragma unroll 1
    for (int r = 0; r < u; ++r) {
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const uint32_t tie = acc[i] & zero;  // 0
        acc[i] += test_fn<KIND>(xi ^ acc[i], xj ^ tie, xk ^ tie, cx, cy, cz);
      }
    }
  }
  uint32_t s = acc[0];
#pragma unroll
  for (int i = 1; i < K; ++i) s += acc[i];
  out[e] = (int32_t)s;
}

// lowbias32 as the sweep inlines it: the first shift is arithmetic on the
// int32 value and unmasked; the later two are masked (logical).
__device__ __forceinline__ uint32_t sweep_hash(uint32_t x) {
  x ^= sar(x, 16);
  x *= 0x7FEB352Du;
  x ^= (x >> 15) & 0x1FFFFu;
  x *= 0x846CA68Bu;
  return x ^ ((x >> 16) & 0xFFFFu);
}

template <bool SWAR>
__global__ void __launch_bounds__(128) sweep_probe_kernel(
    const int32_t* __restrict__ qi, const int32_t* __restrict__ qj,
    const int32_t* __restrict__ qk, int32_t* __restrict__ out, int QS, int C,
    int n_chunks) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const size_t sC = (size_t)C;
  uint32_t acc_att = 0u, acc_occ = 0u;
  for (int t = 0; t < n_chunks; ++t) {
    uint32_t tx[kTargets], ty[kTargets], tz[kTargets];
    uint32_t att[kTargets], occ[kTargets];
#pragma unroll
    for (int k = 0; k < kTargets; ++k) {
      const uint32_t h =
          sweep_hash((uint32_t)t * kTargets + (uint32_t)k + 0x7F4A7C15u);
      const uint32_t cx = h & 15u, cy = sar(h, 4) & 15u,
                     cz = sar(h, 8) & 15u;
      if (SWAR) {
        tx[k] = kB64 - (cx | (cx << 16));
        ty[k] = kB64 - (cy | (cy << 16));
        tz[k] = kB64 - (cz | (cz << 16));
      } else {
        tx[k] = cx;
        ty[k] = cy;
        tz[k] = cz;
      }
      att[k] = 0u;
      occ[k] = 0u;
    }
#pragma unroll 1
    for (int r = 0; r < QS; ++r) {
      const uint32_t bi = (uint32_t)qi[(size_t)r * sC + c];
      const uint32_t bj = (uint32_t)qj[(size_t)r * sC + c];
      const uint32_t bk = (uint32_t)qk[(size_t)r * sC + c];
#pragma unroll
      for (int k = 0; k < kTargets; ++k) {
        if (SWAR) {
          uint32_t a, o;
          swar_scores(bi + tx[k], bj + ty[k], bk + tz[k], &a, &o);
          att[k] += a;
          occ[k] += o;
        } else {
          att[k] += two_test(bi - tx[k], bj - ty[k], bk - tz[k], 1u << 16);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kTargets; ++k) {
      acc_att ^= att[k];
      if (SWAR) acc_occ ^= occ[k];
    }
  }
  out[c] = (int32_t)(acc_att + acc_occ);
}

template <int K>
void launch_test(const int32_t* x, int32_t* out, int n, int kind, int n_iter,
                 int u, uint32_t c0, uint32_t zero, cudaStream_t stream) {
  const int blocks = (n + 127) / 128;
  if (kind == 0) {
    test_probe_kernel<K, 0><<<blocks, 128, 0, stream>>>(x, out, n, n_iter, u,
                                                         c0, zero);
  } else if (kind == 1) {
    test_probe_kernel<K, 1><<<blocks, 128, 0, stream>>>(x, out, n, n_iter, u,
                                                         c0, zero);
  } else {
    test_probe_kernel<K, 2><<<blocks, 128, 0, stream>>>(x, out, n, n_iter, u,
                                                         c0, zero);
  }
}

}  // namespace

// Kernel B on `stream`: x and out are n int32 device words; kind 0
// production, 1 nomul, 2 swar; k in {2, 4, 8, 16, 32} (the alternatives
// probe's ILP sweep); c0 the candidate
// constant; zero must be 0.  Returns cudaGetLastError() (0 on success),
// cudaErrorInvalidValue for another k or kind.
extern "C" int mcq_probe_test(const void* x, void* out, int n, int kind,
                              int k, int n_iter, int u, int c0, int zero,
                              void* stream) {
  const int32_t* xi = (const int32_t*)x;
  int32_t* o = (int32_t*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  const uint32_t c = (uint32_t)c0, z = (uint32_t)zero;
  if (kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  switch (k) {
    case 2: launch_test<2>(xi, o, n, kind, n_iter, u, c, z, s); break;
    case 4: launch_test<4>(xi, o, n, kind, n_iter, u, c, z, s); break;
    case 8: launch_test<8>(xi, o, n, kind, n_iter, u, c, z, s); break;
    case 16: launch_test<16>(xi, o, n, kind, n_iter, u, c, z, s); break;
    case 32: launch_test<32>(xi, o, n, kind, n_iter, u, c, z, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Kernel D on `stream`: qi, qj, qk are (QS, C) int32 device planes, out is
// (C) int32; swar 0 production, 1 packed halves.
extern "C" int mcq_probe_sweep(const void* qi, const void* qj, const void* qk,
                               void* out, int QS, int C, int n_chunks,
                               int swar, void* stream) {
  const int blocks = (C + 127) / 128;
  const cudaStream_t s = (cudaStream_t)stream;
  if (swar) {
    sweep_probe_kernel<true><<<blocks, 128, 0, s>>>(
        (const int32_t*)qi, (const int32_t*)qj, (const int32_t*)qk,
        (int32_t*)out, QS, C, n_chunks);
  } else {
    sweep_probe_kernel<false><<<blocks, 128, 0, s>>>(
        (const int32_t*)qi, (const int32_t*)qj, (const int32_t*)qk,
        (int32_t*)out, QS, C, n_chunks);
  }
  return (int)cudaGetLastError();
}
