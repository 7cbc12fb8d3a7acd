// Exact division by a launch's invariant divisors.
//
// floor(n / d) for 0 <= n < 2^31 as a multiply-high: with l = ceil(log2 d)
// and m = ceil(2^(31 + l) / d) < 2^32, n * m / 2^(31 + l) exceeds n / d by
// less than 1 / d, so its floor is the quotient (Granlund and Montgomery,
// with the dividend's spare top bit); d = 1 passes n through.  make_div runs
// on the host, once a launch; quot on the card (board_shared.cu,
// metropolis.cu, full3d_pallas.cu).  The host emulation checks every
// divisor of their draws over the whole range of n (kernels/emu/checks.cpp,
// tests/test_torch_shared_emulation.py).

#pragma once

#include <stdint.h>

namespace mcq {

struct Div {
  uint32_t m;
  int shift;
  uint32_t d;
};

inline Div make_div(uint32_t d) {
  int l = 0;
  while ((1ull << l) < d) ++l;
  if (l == 0) return {0u, 0, 1u};
  const uint64_t m = ((1ull << (31 + l)) + d - 1) / d;
  return {(uint32_t)m, l - 1, d};
}

__device__ __forceinline__ uint32_t quot(uint32_t n, const Div& q) {
  return q.d == 1 ? n : __umulhi(n, q.m) >> q.shift;
}

// quot for a divisor of at least 2.
__device__ __forceinline__ uint32_t quot2(uint32_t n, const Div& q) {
  return __umulhi(n, q.m) >> q.shift;
}

}  // namespace mcq
