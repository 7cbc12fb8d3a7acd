"""The gather and slice probes' kernels, port of the Pallas kernels of
``tools/probe_gather.py`` and ``tools/probe_slice.py``.

Six hand-written CUDA kernels serve eight of the eleven TPU kernels; each
function computes, word for word, what its TPU kernel body computes, in
int32 wrap-around arithmetic:

  * :func:`gather` (``csrc/probe_gather.cu``) replaces ``gather_correct``
    and ``gather_narrow_idx``: ``take_along_axis(x, idx, axis)``;
  * :func:`gather_chain` (``csrc/probe_gather.cu``) replaces
    ``gather_cost``: ``n_iter`` times ``acc = take_along_axis(acc, idx,
    axis) + 1`` from ``acc = x``;
  * :func:`slice_load` and :func:`slice_store` (``csrc/probe_slice.cu``)
    replace ``dyn_sublane_load`` and ``dyn_sublane_store``: rows ``[off, off
    + width)`` of ``x``, or ``x`` with ``value`` written there, the offset
    an int32 word on the device that the kernel reads;
  * :func:`slice_loop` (``csrc/probe_slice.cu``) replaces
    ``dyn_slice_loop_cost``: step ``t`` adds ``t + 1`` to rows ``[(16 t) mod
    S, + width)``;
  * :func:`sublane_reduce` (``csrc/probe_slice.cu``) replaces
    ``sublane_reduce_cost``: ``n_iter`` times ``acc = (x + acc).sum(0)``
    from zeros;
  * :func:`prng_draws` (``csrc/probe_slice.cu``) replaces ``prng_cost``.  The
    TPU kernel sums ``n_iter`` draws of the TPU's hardware generator, which
    has no stream to match (Pallas interpret mode returns zeros for it).  The
    port times the generators its own kernels draw from, and the composition
    is fixed here: with ``e`` the flat index of an output word, ``n_iter``
    draws ``t = 0, 1, ...`` summed with int32 wrap-around, each

      - ``"lowbias32"``: ``w0 + w1`` of ``prng.step_words(g, 9 + t)`` with
        ``g = prng.chain_streams(7 + e)``
        (:mod:`mcqueens_torch.kernels.prng`);
      - ``"threefry"``: ``rng.random_bits(rng.fold_in(rng.key(7), 9 + t),
        shape)[e]`` (:mod:`mcqueens_torch.core.rng`, ``csrc/threefry.cuh``),

    7 and 9 being the TPU kernel's ``prng_seed(7, 9)``; the steps ``9 + t``
    wrap modulo 2^32, and a caller may start them elsewhere (``step0``).

The other three, ``add_cost``, ``pass_cost`` and ``independent_pass_cost``,
compute kernel A's function: the tools call :func:`.probes.vpu_doubling`
with every doubling in its unrolled inner loop (``n_iter=1, inner=n``).

Each wrapper takes the plain-torch twin (``*_reference``) for CPU tensors and
launches the CUDA kernel (``*_cuda``) for CUDA tensors, with no fallback
between them, and counts its launches in :data:`LAUNCHES`.
:func:`launch_chain` and :func:`launch_prng` call a kernel library's entry
point, the CUDA one or its host emulation
(:mod:`mcqueens_torch.kernels.host_emulation`, CPU tensors).  The wrappers
refuse what the JAX tools never make and the kernels do not take: an index
outside the gathered axis, an offset or width that runs past the rows.
Checking an
index or an offset on the card reads it back, so the checks wait for the
device; the ``*_cuda`` functions launch without them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mcqueens_torch.core import rng
from mcqueens_torch.kernels import _build, prng, probes, segment

# Launches of each kernel in this process, read and reset by callers that
# check a path ran on the card.
LAUNCHES = {"gather": 0, "gather_chain": 0, "slice_load": 0,
            "slice_store": 0, "slice_loop": 0, "reduce": 0,
            "prng_lowbias32": 0, "prng_threefry": 0}

CHAIN_THREADS = 256
CHAIN_ES = (1, 2, 4, 8, 16, 32)  # the gather chain's template instances
CHAIN_MAX_TILE = CHAIN_THREADS * CHAIN_ES[-1]
CHAIN_STRIP = 32  # columns of an axis-0 tile
# Words of whole rows an axis-1 tile takes at most: the bank schedule packs
# a larger tile closer to 32 distinct banks an instruction.
CHAIN_ROW_TILE = 1024
LOOP_COLS = 32  # the slice loop's columns per block
REDUCE_COLS = 128  # the reduce's columns per block
REDUCE_REG_ROWS = 64  # rows of a column the reduce holds in registers
SLICE_STRIDE = 16  # the TPU loop's row step
PRNG_MODES = ("lowbias32", "threefry")
PRNG_SEED, PRNG_STEP0 = 7, 9  # the TPU kernel's prng_seed(7, 9)
# Words a thread draws under each step's key (threefry; lowbias32 draws 1).
PRNG_WORDS = {"lowbias32": 1, "threefry": 4}
# Draws the PRNG twin makes at once (steps x words), which bounds its memory.
_TWIN_BLOCK_WORDS = 1 << 24


def _launch(key: str, fn, *args) -> None:
    probes._launch(key, fn, *args, counts=LAUNCHES)


def _check_count(name: str, n: int) -> None:
    if not 0 <= n < 2 ** 31:
        raise ValueError(f"{name}={n}: want 0 <= {name} < 2^31")


def _check_index(idx: torch.Tensor, dim: int) -> None:
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= dim):
        raise ValueError(f"idx: every index must lie in [0, {dim}), got "
                         f"[{int(idx.min())}, {int(idx.max())}]")


# -- gather ------------------------------------------------------------------

def _flat_index(idx: torch.Tensor, L: int, axis: int) -> torch.Tensor:
    """Flat positions in an ``(S, L)`` array that ``idx`` gathers."""
    rows, cols = idx.shape
    if axis == 1:
        base = torch.arange(rows, device=idx.device).unsqueeze(1) * L
        return base + idx
    return idx.long() * L + torch.arange(cols, device=idx.device)


def gather_reference(x: torch.Tensor, idx: torch.Tensor,
                     axis: int) -> torch.Tensor:
    """Plain-torch twin of the gather."""
    return x.reshape(-1)[_flat_index(idx, x.shape[1], axis)]


def gather_cuda(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """The gather on the card (asynchronous; counts the launch)."""
    out = torch.empty_like(idx)
    _launch("gather", probes._lib().mcq_probe_gather, x, idx, out, x.shape[1],
            idx.numel(), idx.shape[1], axis)
    return out


def _check_gather(x, idx, axis, same_shape: bool) -> None:
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    probes._check_rows("x", x)
    probes._check_rows("idx", idx)
    S, L = x.shape
    shape = (S, L) if same_shape else (
        (S, idx.shape[1]) if axis == 1 else (idx.shape[0], L))
    _build.check_args(x.device, {"idx": (idx, shape, torch.int32)})
    _check_index(idx, L if axis == 1 else S)


def gather(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """``take_along_axis(x, idx, axis)`` for int32 ``x`` ``(S, L)``: ``idx``
    ``(S, K)`` on axis 1, ``(K, L)`` on axis 0, every index in range."""
    _check_gather(x, idx, axis, same_shape=False)
    return segment.on_device("gather", x.device, gather_reference,
                             gather_cuda, x, idx, axis)


# -- gather chain -------------------------------------------------------------

def chain_tile(S: int, L: int, axis: int) -> tuple[int, int, int]:
    """(tile rows, tile columns, elements per thread) of a gather-chain
    block: whole rows on axis 1 (as many as fit :data:`CHAIN_ROW_TILE`
    words), all ``S`` rows of up to 32 columns on axis 0."""
    if axis == 1:
        rows, cols = min(S, max(1, CHAIN_ROW_TILE // L)), L
    else:
        rows, cols = S, min(CHAIN_STRIP, L, max(1, CHAIN_MAX_TILE // S))
    e = next((e for e in CHAIN_ES if e * CHAIN_THREADS >= rows * cols), None)
    if e is None:
        raise ValueError(f"gather chain on axis {axis}: a segment of "
                         f"{L if axis == 1 else S} words does not fit a "
                         f"block's {CHAIN_MAX_TILE}-word tile")
    return rows, cols, e


def gather_chain_reference(x: torch.Tensor, idx: torch.Tensor, axis: int, *,
                           n_iter: int) -> torch.Tensor:
    """Plain-torch twin of the gather chain."""
    flat = _flat_index(idx, x.shape[1], axis).reshape(-1)
    acc = x.reshape(-1)
    for _ in range(n_iter):
        acc = acc[flat] + 1
    return acc.reshape(x.shape).clone()


def chain_instructions(e: int) -> int:
    """Instructions a step of an axis-1 block of instance ``e`` holds at
    most: 8 warps of ``e + ceil(e / 4)`` slots."""
    return (CHAIN_THREADS // 32) * (e + -(-e // 4))


def launch_chain(lib, x: torch.Tensor, idx: torch.Tensor, out: torch.Tensor,
                 axis: int, *, n_iter: int, schedule: torch.Tensor | None = None,
                 stream: int = 0) -> None:
    """The gather chain through ``lib.mcq_probe_gather_chain`` on
    ``stream`` into ``out``; on axis 1, ``schedule`` (int32, blocks x
    :func:`chain_instructions` x 32), unless None, receives each block's
    bank schedule: each (instruction, lane)'s element as its source's buffer
    position | its own position << 16, or -1.  Raises if the entry point
    returns an error."""
    S, L = x.shape
    rows, cols, e = chain_tile(S, L, axis)
    ptrs = [ctypes.c_void_p(t.data_ptr() if t is not None else 0)
            for t in (x, idx, out, schedule)]
    err = lib.mcq_probe_gather_chain(*ptrs, S, L, axis, rows, cols, e,
                                     n_iter, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"probe kernel 'gather_chain' launch failed "
                           f"(cudaError {err})")


def gather_chain_cuda(x: torch.Tensor, idx: torch.Tensor, axis: int, *,
                      n_iter: int) -> torch.Tensor:
    """The gather chain on the card (asynchronous; counts the launch)."""
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        launch_chain(probes._lib(), x, idx, out, axis, n_iter=n_iter,
                     stream=torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES["gather_chain"] += 1
    return out


def gather_chain(x: torch.Tensor, idx: torch.Tensor, axis: int, *,
                 n_iter: int) -> torch.Tensor:
    """``n_iter`` times ``acc = take_along_axis(acc, idx, axis) + 1`` from
    ``acc = x``; ``x`` and ``idx`` int32 ``(S, L)``."""
    _check_gather(x, idx, axis, same_shape=True)
    _check_count("n_iter", n_iter)
    chain_tile(*x.shape, axis)
    return segment.on_device("gather_chain", x.device,
                             gather_chain_reference, gather_chain_cuda, x,
                             idx, axis, n_iter=n_iter)


# -- slice copy ---------------------------------------------------------------

def slice_load_reference(x: torch.Tensor, off: torch.Tensor,
                         width: int) -> torch.Tensor:
    """Plain-torch twin of the slice copy's load mode."""
    o = int(off.reshape(-1)[0])
    return x[o:o + width].clone()


def slice_store_reference(x: torch.Tensor, off: torch.Tensor, width: int,
                          value: int = 7) -> torch.Tensor:
    """Plain-torch twin of the slice copy's store mode."""
    o = int(off.reshape(-1)[0])
    out = x.clone()
    out[o:o + width] = value
    return out


def _slice_cuda(key, x, off, width, out, store, value):
    _launch(key, probes._lib().mcq_probe_slice, x, off, out, x.shape[1], width,
            out.numel(), store, value)
    return out


def slice_load_cuda(x: torch.Tensor, off: torch.Tensor,
                    width: int) -> torch.Tensor:
    """The slice copy's load mode on the card (asynchronous; counts)."""
    out = torch.empty((width, x.shape[1]), dtype=x.dtype, device=x.device)
    return _slice_cuda("slice_load", x, off, width, out, 0, 0)


def slice_store_cuda(x: torch.Tensor, off: torch.Tensor, width: int,
                     value: int = 7) -> torch.Tensor:
    """The slice copy's store mode on the card (asynchronous; counts)."""
    return _slice_cuda("slice_store", x, off, width, torch.empty_like(x), 1,
                       value)


def _check_slice(x, off, width) -> None:
    probes._check_rows("x", x)
    _build.check_args(x.device, {"off": (off, (1,), torch.int32)})
    o, S = int(off[0]), x.shape[0]
    if width < 1 or o < 0 or o + width > S:
        raise ValueError(f"rows [{o}, {o + width}) do not lie in the "
                         f"{S} rows of x")


def slice_load(x: torch.Tensor, off: torch.Tensor,
               width: int) -> torch.Tensor:
    """Rows ``[off, off + width)`` of int32 ``x``; ``off`` is a one-word
    int32 tensor on ``x``'s device."""
    _check_slice(x, off, width)
    return segment.on_device("slice_load", x.device, slice_load_reference,
                             slice_load_cuda, x, off, width)


def slice_store(x: torch.Tensor, off: torch.Tensor, width: int,
                value: int = 7) -> torch.Tensor:
    """A copy of int32 ``x`` with ``value`` in rows ``[off, off + width)``;
    ``off`` is a one-word int32 tensor on ``x``'s device."""
    _check_slice(x, off, width)
    return segment.on_device("slice_store", x.device, slice_store_reference,
                             slice_store_cuda, x, off, width, value)


# -- slice loop ---------------------------------------------------------------

def slice_offsets(S: int, n_iter: int) -> list[int]:
    """The distinct row offsets ``(16 t) mod S`` of steps ``t < n_iter``."""
    period = S // math.gcd(SLICE_STRIDE, S)
    return sorted({SLICE_STRIDE * t % S for t in range(min(n_iter, period))})


def slice_loop_reference(x: torch.Tensor, width: int, *,
                         n_iter: int) -> torch.Tensor:
    """Plain-torch twin of the slice loop."""
    out = x.clone()
    S = x.shape[0]
    for t in range(n_iter):
        off = SLICE_STRIDE * t % S
        out[off:off + width] += t + 1
    return out


def slice_loop_cuda(x: torch.Tensor, width: int, *,
                    n_iter: int) -> torch.Tensor:
    """The slice loop on the card (asynchronous; counts the launch)."""
    S, C = x.shape
    out = torch.empty_like(x)
    _launch("slice_loop", probes._lib().mcq_probe_slice_loop, x, out, S, C,
            width, n_iter, SLICE_STRIDE % S)
    return out


def _check_strip(x: torch.Tensor, cols: int) -> None:
    probes._check_rows("x", x)
    if x.shape[0] * cols * 4 > _build.SMEM_PER_BLOCK:
        raise ValueError(f"{x.shape[0]} rows x {cols} columns of int32 do "
                         f"not fit a block's shared memory")


def slice_loop(x: torch.Tensor, width: int, *, n_iter: int) -> torch.Tensor:
    """From int32 ``x`` ``(S, C)``: step ``t < n_iter`` adds ``t + 1`` to
    rows ``[(16 t) mod S, + width)``; every such slice must lie in ``x``."""
    _check_strip(x, LOOP_COLS)
    _check_count("n_iter", n_iter)
    S = x.shape[0]
    offs = slice_offsets(S, n_iter)
    if width < 1 or (offs and offs[-1] + width > S):
        raise ValueError(f"width {width}: the step at row offset "
                         f"{offs[-1] if offs else 0} runs past the {S} rows")
    return segment.on_device("slice_loop", x.device, slice_loop_reference,
                             slice_loop_cuda, x, width, n_iter=n_iter)


# -- reduce -------------------------------------------------------------------

def sublane_reduce_reference(x: torch.Tensor, *, n_iter: int) -> torch.Tensor:
    """Plain-torch twin of the reduce."""
    acc = torch.zeros((1, x.shape[1]), dtype=torch.int32, device=x.device)
    for _ in range(n_iter):
        acc = (x + acc).sum(0, keepdim=True, dtype=torch.int32)
    return acc


def reduce_instance(S: int) -> int:
    """The reduce's template instance for ``S`` rows: ``S`` up to
    :data:`REDUCE_REG_ROWS` (each thread's column in registers), else 0
    (x's strip staged in shared memory)."""
    return S if S <= REDUCE_REG_ROWS else 0


def sublane_reduce_cuda(x: torch.Tensor, *, n_iter: int) -> torch.Tensor:
    """The reduce on the card (asynchronous; counts the launch)."""
    S, C = x.shape
    out = torch.empty((1, C), dtype=torch.int32, device=x.device)
    # The runtime zero ties each row to the accumulator in the staged
    # instance, so the row sum cannot be hoisted out of the step loop.
    _launch("reduce", probes._lib().mcq_probe_reduce, x, out, S, C, n_iter, 0,
            reduce_instance(S))
    return out


def sublane_reduce(x: torch.Tensor, *, n_iter: int) -> torch.Tensor:
    """``n_iter`` times ``acc = sum over rows of (x + acc)`` from a zero
    ``(1, C)`` row, int32 ``x`` ``(S, C)``."""
    _check_strip(x, REDUCE_COLS)
    _check_count("n_iter", n_iter)
    return segment.on_device("sublane_reduce", x.device,
                             sublane_reduce_reference, sublane_reduce_cuda, x,
                             n_iter=n_iter)


# -- PRNG draws ---------------------------------------------------------------

def _step_blocks(n_words: int, n_iter: int):
    """Ranges of steps whose draws a twin makes at once."""
    block = max(1, _TWIN_BLOCK_WORDS // max(1, n_words))
    for t0 in range(0, n_iter, block):
        yield t0, min(n_iter, t0 + block)


def prng_draws_reference(shape, mode: str, *, n_iter: int, device,
                         step0: int = PRNG_STEP0) -> torch.Tensor:
    """Plain-torch twin of the PRNG draws (the composition in the module
    docstring), computed a block of steps at a time."""
    n = math.prod(shape)
    acc = torch.zeros(n, dtype=torch.int64, device=device)
    if mode == "lowbias32":
        g = prng.chain_streams(torch.arange(n, dtype=torch.int32,
                                            device=device) + PRNG_SEED)
    else:
        root = rng.key(PRNG_SEED, device)
    for t0, t1 in _step_blocks(n, n_iter):
        steps = rng.as_int32((torch.arange(t0, t1, device=device) + step0)
                             & 0xFFFFFFFF)
        if mode == "lowbias32":
            w0, w1 = prng.step_words(g, steps.unsqueeze(1))
            draws = (w0 + w1).to(torch.int64)
        else:
            draws = rng.random_bits(rng.fold_in(root, steps), (n,))
        acc = (acc + draws.sum(0)) & 0xFFFFFFFF
    return rng.as_int32(acc).reshape(shape)


def launch_prng(lib, out: torch.Tensor, mode: str, *, n_iter: int,
                step0: int = PRNG_STEP0, stream: int = 0) -> None:
    """The PRNG draws through ``lib.mcq_probe_prng`` on ``stream`` into the
    int32 ``out``; raises if the entry point returns an error."""
    err = lib.mcq_probe_prng(ctypes.c_void_p(out.data_ptr()), out.numel(),
                             PRNG_MODES.index(mode), n_iter, PRNG_SEED,
                             probes._i32(step0), 1, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"probe kernel 'prng_{mode}' launch failed "
                           f"(cudaError {err})")


def prng_draws_cuda(shape, mode: str, *, n_iter: int, device,
                    step0: int = PRNG_STEP0) -> torch.Tensor:
    """The PRNG draws on the card (asynchronous; counts the launch)."""
    out = torch.empty(shape, dtype=torch.int32, device=device)
    with torch.cuda.device(out.device):
        launch_prng(probes._lib(), out, mode, n_iter=n_iter, step0=step0,
                    stream=torch.cuda.current_stream(out.device).cuda_stream)
    LAUNCHES[f"prng_{mode}"] += 1
    return out


def prng_draws(shape, mode: str, *, n_iter: int, device,
               step0: int = PRNG_STEP0) -> torch.Tensor:
    """An int32 tensor of ``shape``: the wrapping sum of ``n_iter`` draws
    of generator ``mode`` per word, steps from ``step0`` (the composition in
    the module docstring); not the TPU's hardware generator."""
    if mode not in PRNG_MODES:
        raise ValueError(f"mode must be one of {PRNG_MODES}, got {mode!r}")
    shape = tuple(shape)
    if not 0 < math.prod(shape) < 2 ** 31:
        raise ValueError(f"shape {shape}: want 1 to 2^31 - 1 words")
    _check_count("n_iter", n_iter)
    if not 0 <= step0 < 2 ** 32:
        raise ValueError(f"step0={step0}: want 0 <= step0 < 2^32")
    dev = torch.device(device)
    return segment.on_device("prng_draws", dev, prng_draws_reference,
                             prng_draws_cuda, shape, mode, n_iter=n_iter,
                             device=dev, step0=step0)
