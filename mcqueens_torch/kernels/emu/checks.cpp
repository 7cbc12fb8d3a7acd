// Elementwise entry points of the host emulation's integer intrinsics and
// of the kernels' exact divider (csrc/exact_div.cuh), built into the host
// emulation library only (kernels/host_emulation.py), so that tests can
// hold them to plain models (tests/test_torch_shared_emulation.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "exact_div.cuh"

// out[k] = f(a[k], b[k]) for k < n: f is __vabsdiffu4 (op 0) or __umulhi
// (op 1).  Returns 0, or 1 for an unknown op.
extern "C" int mcq_emu_intrinsic(int op, const uint32_t* a, const uint32_t* b,
                                 uint32_t* out, int64_t n) {
  for (int64_t k = 0; k < n; ++k) {
    if (op == 0) {
      out[k] = __vabsdiffu4(a[k], b[k]);
    } else if (op == 1) {
      out[k] = __umulhi(a[k], b[k]);
    } else {
      return 1;
    }
  }
  return 0;
}

// The operands n in [0, 2^31) whose mcq::quot(n, make_div(d)) (and, for
// d >= 2, quot2) is not floor(n / d), over the whole range.  quot is
// floor(n * m / 2^s) (s = 32 + shift: a multiply-high, then a shift), and
// m * d - 2^s = e >= 0, so for n = q d + r it is q + floor((r 2^s + n e) /
// (d 2^s)): q exactly while r 2^s + n e < d 2^s, which for each residue r
// holds for every n of it if it holds for the largest.  So the check takes
// every n below 2^20, then the largest n below 2^31 of each residue mod d,
// and returns the mismatches found, or -1 if m * d < 2^s.
extern "C" int64_t mcq_emu_quot_mismatches(uint32_t d) {
  const mcq::Div q = mcq::make_div(d);
  const auto wrong = [&](uint32_t n) {
    return (mcq::quot(n, q) != n / d) + (d > 1 && mcq::quot2(n, q) != n / d);
  };
  if (d > 1 && (uint64_t)q.m * d < 1ull << (32 + q.shift)) return -1;
  int64_t bad = 0;
  for (uint32_t n = 0; n < 1u << 20; ++n) bad += wrong(n);
  const uint32_t top = 0x7FFFFFFFu;
  for (uint32_t r = 0; r < d && r <= top; ++r) {
    bad += wrong(top - (top % d + d - r) % d);
  }
  return bad;
}
