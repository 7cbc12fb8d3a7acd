"""The measurement probes' kernels, port of the JAX tools' Pallas probes.

Four hand-written CUDA kernels time what the samplers' speed depends on:
the card's int32 issue rate and the cost of full-3D's attack test.  Each
computes, element for element, what its TPU kernel body computes, in int32
wrap-around arithmetic:

  A. :func:`vpu_doubling` (``csrc/probe_alu.cu``) replaces
     ``tools/roofline.py:vpu_ns_per_vreg``: ``k`` accumulators ``x + i``,
     each doubled ``inner`` times per iteration for ``n_iter`` iterations,
     then summed; the dependent variant is one accumulator over
     ``n_iter * k`` iterations.
  B. :func:`attack_test` (``csrc/probe_attack.cu``) replaces
     ``tools/probe_full3d_alternatives.py:_test_rate``: ``k`` accumulators,
     each updated ``u = max(1, 16 // k)`` times per iteration by
     ``a += fn(xi ^ a, xi + 1, xi + 2, cx, cx + 1, cx + 2)`` with ``fn`` the
     production two-test form, its multiply-free twin or the packed SWAR
     form; the accumulators are summed.
  C. :func:`op_chain` (``csrc/probe_alu.cu``) replaces
     ``tools/probe_full3d_alternatives.py:_op_rate``: ``k`` accumulators
     ``x + i``, each ``u`` times per iteration ``(a * x) | 1`` or
     ``(a + x) | 1``, XOR-folded.
  D. :func:`sweep` (``csrc/probe_attack.cu``) replaces
     ``tools/probe_swar_sweep.py:_sweep_time``: per chunk, 9 hashed targets
     scored against every row of ``(QS, C)`` coordinate planes, each
     target's column sums XOR-folded into carried rows.

Each wrapper takes the plain-torch twin (``*_reference``) for CPU tensors
and launches the CUDA kernel for CUDA tensors, with no fallback between
them, and counts its launches in :data:`LAUNCHES`.  The public functions
keep the JAX layout: ``(S, C)`` int32 rows, ``(QS, C)`` coordinate planes,
a ``(1, C)`` sweep output.
"""

from __future__ import annotations

import ctypes

import torch

from mcqueens_torch.kernels import segment

# Launches of each CUDA kernel in this process (read and reset by callers
# that check a path really ran on the card).
LAUNCHES = {"vpu": 0, "test": 0, "op": 0, "sweep": 0}

# The kernels keep their accumulators in registers, one template instance
# per count: the counts the tools launch (the roofline's 8 chains and its
# dependent chain; the alternatives probe's ILP sweep and its 16 op chains)
# and those the parity checks use.
VPU_KS = (1, 4, 8)
TEST_KS = (2, 4, 8, 16, 32)
OP_KS = (1, 4, 16)
TEST_KINDS = ("production", "nomul", "swar")
OPS = ("add", "mul")
SWEEP_KINDS = ("production", "swar")
SWEEP_TARGETS = 9  # 8 candidates + the old cell per chunk


def _i32(v: int) -> int:
    """``v`` mod 2^32 as a signed int32 value."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


# Packed-field constants: two 16-bit halves per int32 lane.
_HINT = _i32(0x80008000)
_GUARD = 0x7FFF7FFF
_ONES = 1 | (1 << 16)
_M128 = 128 | (128 << 16)
_B64 = 64 | (64 << 16)
# Kernel B's candidate constant: cx = xi * 0 + c0.
TEST_C0 = {"production": 3, "nomul": 3, "swar": 61 | (61 << 16)}
_SWEEP_SALT = 0x7F4A7C15


def _check_k(k: int, counts: tuple) -> None:
    if k not in counts:
        raise ValueError(f"k={k}: the kernel takes k in {counts}")


def _check_rows(name: str, x: torch.Tensor) -> None:
    from mcqueens_torch.kernels import _build

    _build.check_args(x.device, {name: (x, tuple(x.shape), torch.int32)})
    if x.dim() != 2 or x.numel() == 0 or x.numel() >= 2 ** 31:
        raise ValueError(f"{name}: want a non-empty 2-D tensor of fewer than "
                         f"2^31 elements, got shape {tuple(x.shape)}")


def _launch(key: str, fn, *args, counts: dict = LAUNCHES) -> None:
    """Call entry point ``fn`` on the current stream; count the launch in
    ``counts[key]``."""
    dev = args[0].device
    ptrs = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
            else a for a in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*ptrs, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"probe kernel '{key}' launch failed "
                           f"(cudaError {err})")
    counts[key] += 1


def _lib():
    from mcqueens_torch.kernels import _build

    return _build.load_library()


# -- A: int32 doubling chains -----------------------------------------------

def _vpu_shape(independent: bool, n_iter: int, k: int):
    """(accumulators, iterations): the dependent variant is one
    accumulator over ``n_iter * k`` iterations."""
    return (k, n_iter) if independent else (1, n_iter * k)


def vpu_doubling_reference(x: torch.Tensor, independent: bool = True, *,
                           n_iter: int = 2048, k: int = 8,
                           inner: int = 16) -> torch.Tensor:
    """Plain-torch twin of kernel A (the accumulators stacked on a leading
    axis; each row of the stack is one accumulator's own chain)."""
    n_acc, n_it = _vpu_shape(independent, n_iter, k)
    accs = torch.stack([x + i for i in range(n_acc)])
    for _ in range(n_it * inner):
        # 32 doublings wrap every int32 to 0, and 0 stays 0: stopping there
        # gives the same words as the kernel's full loop.
        if not bool(accs.any()):
            break
        accs = accs + accs
    out = accs[0]
    for a in accs[1:]:
        out = out + a
    return out


def vpu_doubling_cuda(x: torch.Tensor, independent: bool = True, *,
                      n_iter: int = 2048, k: int = 8,
                      inner: int = 16) -> torch.Tensor:
    """Kernel A on the card (asynchronous; counts the launch)."""
    n_acc, n_it = _vpu_shape(independent, n_iter, k)
    out = torch.empty_like(x)
    # The last two arguments are a runtime two and zero: every doubling is
    # one instruction a + a + zero (IADD3) or a * two + zero (IMAD), which no
    # compiler can merge into a shift.
    _launch("vpu", _lib().mcq_probe_vpu, x, out, x.numel(), n_acc, n_it,
            inner, 2, 0)
    return out


def vpu_doubling(x: torch.Tensor, independent: bool = True, *,
                 n_iter: int = 2048, k: int = 8,
                 inner: int = 16) -> torch.Tensor:
    """Kernel A: ``k`` accumulators ``x + i``, each doubled ``inner`` times
    per iteration for ``n_iter`` iterations, summed (``independent``), or
    one accumulator ``x`` over ``n_iter * k`` iterations."""
    _check_rows("x", x)
    n_acc, n_it = _vpu_shape(independent, n_iter, k)
    _check_k(n_acc, VPU_KS)
    if n_it * inner >= 2 ** 31:
        raise ValueError(f"{n_it} x {inner} doublings a chain: the kernel "
                         f"takes fewer than 2^31")
    return segment.on_device("vpu_doubling", x.device,
                             vpu_doubling_reference, vpu_doubling_cuda, x,
                             independent, n_iter=n_iter, k=k, inner=inner)


# -- B: the attack test in three forms --------------------------------------

def _two_test(di, dj, dk, occ: int):
    """The live 2-test form: 1 iff attacked (or the same cell), plus
    ``occ`` iff all three deltas are zero."""
    p2, q2, r2 = di * di, dj * dj, dk * dk
    m = torch.maximum(p2, torch.maximum(q2, r2))
    t = (p2 * (p2 - m)) | (q2 * (q2 - m)) | (r2 * (r2 - m))
    return (t == 0).int() + (m == 0).int() * occ


def _production(xi, xj, xk, cx, cy, cz):
    return _two_test(xi - cx, xj - cy, xk - cz, 2)


def _nomul(xi, xj, xk, cx, cy, cz):
    # Multiply-free: |d| via max(d, -d), membership in {0, m} by compares.
    di, dj, dk = xi - cx, xj - cy, xk - cz
    ai = torch.maximum(di, -di)
    aj = torch.maximum(dj, -dj)
    ak = torch.maximum(dk, -dk)
    m = torch.maximum(ai, torch.maximum(aj, ak))
    att = (((ai == 0) | (ai == m)) & ((aj == 0) | (aj == m))
           & ((ak == 0) | (ak == m)))
    return att.int() + (m == 0).int() * 2


def _zero_halves(e):
    """1 in each 16-bit field's low bit iff that field is zero (fields must
    have bit 15 clear)."""
    t = (e & _GUARD) + _GUARD
    nz = (t | e) & _HINT
    m = (nz >> 15) & _ONES
    return _ONES - m


def _eq_halves(a, b):
    return _zero_halves(a ^ b)


def _smax(a, b):
    """Per-16-bit-field max via the guard-bit subtract trick."""
    z = (a | _HINT) - (b & _GUARD)
    s = z & _HINT
    mask = ((s >> 15) & _ONES) * 0xFFFF
    return (a & mask) | (b & ~mask)


def _swar_test(xi, xj, xk, cx, cy, cz):
    # Biased per-field diffs: cx holds (64 - cand) duplicated in both halves.
    return swar_scores(xi + cx, xj + cy, xk + cz)[0]


_TEST_FNS = {"production": _production, "nomul": _nomul, "swar": _swar_test}


def _test_u(k: int) -> int:
    return max(1, 16 // k)


def attack_test_reference(x: torch.Tensor, kind: str, *, n_iter: int = 2048,
                          k: int = 4) -> torch.Tensor:
    """Plain-torch twin of kernel B (accumulators stacked)."""
    fn = _TEST_FNS[kind]
    xi = x
    xj, xk = xi + 1, xi + 2
    cx = xi * 0 + TEST_C0[kind]
    cy, cz = cx + 1, cx + 2
    accs = torch.stack([xi * 0 + i for i in range(k)])
    for _ in range(n_iter * _test_u(k)):
        accs = accs + fn(xi ^ accs, xj, xk, cx, cy, cz)
    out = accs[0]
    for a in accs[1:]:
        out = out + a
    return out


def attack_test_cuda(x: torch.Tensor, kind: str, *, n_iter: int = 2048,
                     k: int = 4) -> torch.Tensor:
    """Kernel B on the card (asynchronous; counts the launch)."""
    out = torch.empty_like(x)
    # The last argument is a runtime zero that ties each evaluation's xj and
    # xk to its accumulator, so no part of the test is hoisted.
    _launch("test", _lib().mcq_probe_test, x, out, x.numel(),
            TEST_KINDS.index(kind), k, n_iter, _test_u(k), TEST_C0[kind], 0)
    return out


def attack_test(x: torch.Tensor, kind: str, *, n_iter: int = 2048,
                k: int = 4) -> torch.Tensor:
    """Kernel B: ``k`` accumulators, each updated ``max(1, 16 // k)`` times
    per iteration by ``a += fn(xi ^ a, xi + 1, xi + 2, cx, cx + 1, cx + 2)``
    (``cx = TEST_C0[kind]``), summed."""
    if kind not in TEST_KINDS:
        raise ValueError(f"kind must be one of {TEST_KINDS}, got {kind!r}")
    _check_rows("x", x)
    _check_k(k, TEST_KS)
    return segment.on_device("attack_test", x.device, attack_test_reference,
                             attack_test_cuda, x, kind, n_iter=n_iter, k=k)


# -- C: multiply or add chains ----------------------------------------------

def op_chain_reference(x: torch.Tensor, op: str, *, n_iter: int = 4096,
                       k: int = 16, u: int = 8) -> torch.Tensor:
    """Plain-torch twin of kernel C (accumulators stacked)."""
    accs = torch.stack([x + i for i in range(k)])
    for _ in range(n_iter * u):
        accs = (accs * x if op == "mul" else accs + x) | 1
    out = accs[0]
    for a in accs[1:]:
        out = out ^ a
    return out


def op_chain_cuda(x: torch.Tensor, op: str, *, n_iter: int = 4096,
                  k: int = 16, u: int = 8) -> torch.Tensor:
    """Kernel C on the card (asynchronous; counts the launch)."""
    out = torch.empty_like(x)
    _launch("op", _lib().mcq_probe_op, x, out, x.numel(), OPS.index(op), k,
            n_iter, u)
    return out


def op_chain(x: torch.Tensor, op: str, *, n_iter: int = 4096, k: int = 16,
             u: int = 8) -> torch.Tensor:
    """Kernel C: ``k`` accumulators ``x + i``, each ``u`` times per
    iteration ``(a * x) | 1`` (``op='mul'``) or ``(a + x) | 1``,
    XOR-folded."""
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    _check_rows("x", x)
    _check_k(k, OP_KS)
    return segment.on_device("op_chain", x.device, op_chain_reference,
                             op_chain_cuda, x, op, n_iter=n_iter, k=k, u=u)


# -- D: the production-shaped sweep -----------------------------------------

def hash32(x: int) -> int:
    """The sweep's inlined lowbias32 on an int32 value (its first shift is
    arithmetic and unmasked, as the JAX tool writes it)."""
    x = _i32(x)
    x ^= x >> 16
    x = _i32(x * 0x7FEB352D)
    x ^= (x >> 15) & 0x1FFFF
    x = _i32(x * 0x846CA68B)
    return _i32(x ^ ((x >> 16) & 0xFFFF))


def sweep_targets(t: int, kind: str) -> list[tuple[int, int, int]]:
    """Chunk ``t``'s 9 targets: cells in [0, 16)^3 hashed from the chunk
    index, or for ``swar`` their duplicated ``64 - c`` bias constants."""
    out = []
    for k in range(SWEEP_TARGETS):
        h = hash32(t * SWEEP_TARGETS + k + _SWEEP_SALT)
        c = (h & 15, (h >> 4) & 15, (h >> 8) & 15)
        if kind == "swar":
            c = tuple(_B64 - (v | (v << 16)) for v in c)
        out.append(c)
    return out


def prod_scores(di, dj, dk):
    """The live 2-test form (full3d_shared.py:scores): attack in the low
    bits, occupancy at bit 16."""
    return _two_test(di, dj, dk, 1 << 16)


def swar_scores(di, dj, dk):
    """(attack, occupancy) per half of packed biased diffs (per-half
    ``coord - cand + 64``): attack is the 7-relation equality form,
    occupancy all three deltas zero."""
    zi, zj, zk = _eq_halves(di, _B64), _eq_halves(dj, _B64), _eq_halves(
        dk, _B64)
    ai = _smax(di, _M128 - di)
    aj = _smax(dj, _M128 - dj)
    ak = _smax(dk, _M128 - dk)
    eij = _eq_halves(ai, aj)
    eik = _eq_halves(ai, ak)
    ejk = _eq_halves(aj, ak)
    two_axis = (zi & zj) | (zi & zk) | (zj & zk)
    att = two_axis | (zk & eij) | (zj & eik) | (zi & ejk) | (eij & eik)
    return att & _ONES, (zi & zj) & zk


def sweep_reference(qi: torch.Tensor, qj: torch.Tensor, qk: torch.Tensor,
                    kind: str, *, n_chunks: int = 512) -> torch.Tensor:
    """Plain-torch twin of kernel D: ``(1, C)`` int32."""
    C = qi.shape[1]
    acc_att = torch.zeros((1, C), dtype=torch.int32, device=qi.device)
    acc_occ = torch.zeros_like(acc_att)
    for t in range(n_chunks):
        for cx, cy, cz in sweep_targets(t, kind):
            if kind == "swar":
                a, o = swar_scores(qi + cx, qj + cy, qk + cz)
                acc_occ = acc_occ ^ o.sum(0, keepdim=True, dtype=torch.int32)
            else:
                a = prod_scores(qi - cx, qj - cy, qk - cz)
            acc_att = acc_att ^ a.sum(0, keepdim=True, dtype=torch.int32)
    return acc_att + acc_occ


def sweep_cuda(qi: torch.Tensor, qj: torch.Tensor, qk: torch.Tensor,
               kind: str, *, n_chunks: int = 512) -> torch.Tensor:
    """Kernel D on the card (asynchronous; counts the launch)."""
    QS, C = qi.shape
    out = torch.empty((1, C), dtype=torch.int32, device=qi.device)
    _launch("sweep", _lib().mcq_probe_sweep, qi, qj, qk, out, QS, C,
            n_chunks, SWEEP_KINDS.index(kind))
    return out


def sweep(qi: torch.Tensor, qj: torch.Tensor, qk: torch.Tensor, kind: str,
          *, n_chunks: int = 512) -> torch.Tensor:
    """Kernel D: ``n_chunks`` production-shaped chunk sweeps over the
    ``(QS, C)`` int32 planes (``swar``: two queens per lane as biased 16-bit
    halves); returns ``acc_att + acc_occ`` as ``(1, C)`` int32."""
    from mcqueens_torch.kernels import _build

    if kind not in SWEEP_KINDS:
        raise ValueError(f"kind must be one of {SWEEP_KINDS}, got {kind!r}")
    _check_rows("qi", qi)
    shape = tuple(qi.shape)
    _build.check_args(qi.device, {name: (t, shape, torch.int32) for name, t in
                                  (("qj", qj), ("qk", qk))})
    return segment.on_device("sweep", qi.device, sweep_reference, sweep_cuda,
                             qi, qj, qk, kind, n_chunks=n_chunks)
