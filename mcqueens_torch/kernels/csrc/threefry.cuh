// JAX's threefry2x32 PRNG (partitionable mode) for the scan-sampler kernels
// (board_scan.cu, full3d_scan.cu).  Plain-torch twin:
// mcqueens_torch/core/rng.py, which holds these words bitwise to
// jax.random.
//
//   threefry(k, (x0, x1))   20 add/rotate/xor rounds, a key injection after
//                           every 4 (jax._src.prng._threefry2x32_lowering);
//   fold_in(k, d)           = threefry(k, (0, d));
//   split(k, n)[m]          = threefry(k, (0, m));
//   bits(k)                 = x0 ^ x1 of threefry(k, (0, 0)) (one 32-bit
//                             word, shape ());
//   randint(k, span)        two words from split(k, 2), combined modulo the
//                           span with JAX's uint32 wrap-around
//                           (jax._src.random._randint);
//   uniform(k)              (bits >> 9) | 0x3F800000 as float, minus 1.
//
// All arithmetic is uint32_t, so sums wrap as JAX's uint32 ops do.

#pragma once

#include <stdint.h>

namespace mcq {

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

#define MCQ_TF_ROUND(r) \
  x0 += x1;             \
  x1 = rotl(x1, r) ^ x0;

// threefry2x32 of the counter (0, lo) under key k.
__device__ __forceinline__ Key hash(Key k, uint32_t lo) {
  const uint32_t k2 = k.k0 ^ k.k1 ^ 0x1BD11BDAu;
  uint32_t x0 = k.k0;
  uint32_t x1 = lo + k.k1;
  MCQ_TF_ROUND(13) MCQ_TF_ROUND(15) MCQ_TF_ROUND(26) MCQ_TF_ROUND(6)
  x0 += k.k1;
  x1 += k2 + 1u;
  MCQ_TF_ROUND(17) MCQ_TF_ROUND(29) MCQ_TF_ROUND(16) MCQ_TF_ROUND(24)
  x0 += k2;
  x1 += k.k0 + 2u;
  MCQ_TF_ROUND(13) MCQ_TF_ROUND(15) MCQ_TF_ROUND(26) MCQ_TF_ROUND(6)
  x0 += k.k0;
  x1 += k.k1 + 3u;
  MCQ_TF_ROUND(17) MCQ_TF_ROUND(29) MCQ_TF_ROUND(16) MCQ_TF_ROUND(24)
  x0 += k.k1;
  x1 += k2 + 4u;
  MCQ_TF_ROUND(13) MCQ_TF_ROUND(15) MCQ_TF_ROUND(26) MCQ_TF_ROUND(6)
  x0 += k2;
  x1 += k.k0 + 5u;
  return {x0, x1};
}

#undef MCQ_TF_ROUND

// One 32-bit random word of key k (jax.random.bits, shape ()).
__device__ __forceinline__ uint32_t bits(Key k) {
  const Key b = hash(k, 0u);
  return b.k0 ^ b.k1;
}

// randint's multiplier for a span >= 1: 2^32 mod span, as (2^16 mod span)^2
// mod span, so a kernel that draws from one span many times computes it once.
__device__ __forceinline__ uint32_t randint_mult(uint32_t span) {
  const uint32_t m = 65536u % span;
  return (m * m) % span;
}

// jax.random.randint(k, (), 0, span) for span >= 1, with mult =
// randint_mult(span).
__device__ __forceinline__ uint32_t randint(Key k, uint32_t span,
                                           uint32_t mult) {
  const uint32_t hi = bits(hash(k, 0u));
  const uint32_t lo = bits(hash(k, 1u));
  return ((hi % span) * mult + lo % span) % span;
}

__device__ __forceinline__ uint32_t randint(Key k, uint32_t span) {
  return randint(k, span, randint_mult(span));
}

// jax.random.uniform(k) on [0, 1), float32.
__device__ __forceinline__ float uniform(Key k) {
  return __uint_as_float((bits(k) >> 9) | 0x3F800000u) - 1.0f;
}

// 1 iff two distinct cells at offset (dx, dy, dz) attack: every nonzero |d|
// equals the largest (the 7 relations of mcqueens_torch/core/energy.py).
__device__ __forceinline__ int attacks(int dx, int dy, int dz) {
  const int a = abs(dx), b = abs(dy), c = abs(dz);
  const int m = max(a, max(b, c));
  return ((a == 0) | (a == m)) & ((b == 0) | (b == m)) & ((c == 0) | (c == m));
}

// Flat count-table indices of the 12 (13 with full3d) lines through cell
// (i, j, k): mcqueens_torch/core/tables.py:line_indices.
__device__ __forceinline__ void line_indices(int i, int j, int k, int N,
                                             bool full3d, int idx[13]) {
  const int D = 2 * N - 1;
  const int NN = N * N, ND = N * D, DD = D * D;
  const int o2 = 2 * NN, o8 = o2 + 6 * ND;
  idx[0] = i * N + k;
  idx[1] = NN + j * N + k;
  idx[2] = o2 + k * D + (i - j + N - 1);
  idx[3] = o2 + ND + k * D + (i + j);
  idx[4] = o2 + 2 * ND + j * D + (i - k + N - 1);
  idx[5] = o2 + 3 * ND + j * D + (i + k);
  idx[6] = o2 + 4 * ND + i * D + (j - k + N - 1);
  idx[7] = o2 + 5 * ND + i * D + (j + k);
  idx[8] = o8 + (j - i + N - 1) * D + (k - i + N - 1);
  idx[9] = o8 + DD + (j - i + N - 1) * D + (k + i);
  idx[10] = o8 + 2 * DD + (j + i) * D + (k - i + N - 1);
  idx[11] = o8 + 3 * DD + (j + i) * D + (k + i);
  if (full3d) idx[12] = o8 + 4 * DD + i * N + j;
}

// Line family f (0..12; 12 is full3d's) of line_indices as a linear form:
// its index at cell (i, j, k) is base + ci * i + cj * j + ck * k.  A warp
// that gives family f to lane f computes a move's two indices with it.
struct LineForm {
  int base, ci, cj, ck;
};

__device__ __forceinline__ LineForm line_form(int f, int N) {
  const int D = 2 * N - 1;
  const int NN = N * N, ND = N * D, DD = D * D;
  const int o2 = 2 * NN, o8 = o2 + 6 * ND;
  switch (f) {
    case 0: return {0, N, 0, 1};
    case 1: return {NN, 0, N, 1};
    case 2: return {o2 + N - 1, 1, -1, D};
    case 3: return {o2 + ND, 1, 1, D};
    case 4: return {o2 + 2 * ND + N - 1, 1, D, -1};
    case 5: return {o2 + 3 * ND, 1, D, 1};
    case 6: return {o2 + 4 * ND + N - 1, D, 1, -1};
    case 7: return {o2 + 5 * ND, D, 1, 1};
    case 8: return {o8 + (N - 1) * D + N - 1, -D - 1, D, 1};
    case 9: return {o8 + DD + (N - 1) * D, 1 - D, D, 1};
    case 10: return {o8 + 2 * DD + N - 1, D - 1, D, 1};
    case 11: return {o8 + 3 * DD, D + 1, D, 1};
    default: return {o8 + 4 * DD, N, 1, 0};  // 12
  }
}

// Words of the count table: the board's 12 families, or full3d's 13.
__host__ __device__ __forceinline__ long long table_words(int N,
                                                          bool full3d) {
  const long long D = 2 * N - 1;
  return 2LL * N * N + 6 * N * D + 4 * D * D + (full3d ? 1LL * N * N : 0);
}

// Bin of a step: min(step * n_bins / n_steps, n_bins - 1), in 64 bits.
__device__ __forceinline__ int bin_of(int step, int n_bins, int n_steps) {
  const long long b = (long long)step * n_bins / n_steps;
  return (int)(b < n_bins - 1 ? b : n_bins - 1);
}

}  // namespace mcq
