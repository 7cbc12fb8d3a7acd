"""Counter-based PRNG shared by the board sampler's kernel and its twin.

Port of :mod:`mcqueens.kernels.prng`: the "lowbias32" integer finalizer over
int32 tensors.  torch int32 ``*`` wraps like uint32 (two's complement) and
``>>`` is arithmetic, so logical shifts keep the mask of :func:`_shr`.  The
CUDA kernel (``csrc/board_shared.cu``) does the same arithmetic in
``uint32_t``; every word here equals the JAX word bit for bit.
"""

from __future__ import annotations

import torch


def _i32(x: int) -> int:
    """A 32-bit pattern as the signed int32 value torch stores for it."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


_M1 = _i32(0x7FEB352D)
_M2 = _i32(0x846CA68B)
_STEP_K = _i32(0x9E3779B9)   # step stride (golden ratio)
_CHAIN_K = _i32(0x85EBCA6B)  # chain-id stride
_W0_K = _i32(0x68BC21EB)
_W1_K = _i32(0x02E5BE93)


def _shr(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32 by a static amount."""
    return (z >> k) & ((1 << (32 - k)) - 1)


def lowbias32(z: torch.Tensor) -> torch.Tensor:
    """Full-avalanche 32-bit integer hash of an int32 tensor."""
    z = z ^ _shr(z, 16)
    z = z * _M1
    z = z ^ _shr(z, 15)
    z = z * _M2
    return z ^ _shr(z, 16)


def _wrapping_mul(x, k: int):
    """int32 product that wraps for a Python int operand too."""
    return _i32(x * k) if isinstance(x, int) else x * k


def chain_ids(block_seed, lane_iota: torch.Tensor) -> torch.Tensor:
    """Per-lane stream key from a block seed (layout-dependent; see JAX)."""
    return _wrapping_mul(block_seed, _CHAIN_K) + lowbias32(
        lane_iota + block_seed)


def chain_streams(seeds: torch.Tensor) -> torch.Tensor:
    """Per-chain stream keys from the chains' own integer seeds."""
    s = seeds.to(torch.int32)
    return s * _CHAIN_K + lowbias32(s)


def step_base(g: torch.Tensor, step) -> torch.Tensor:
    """Per-(chain, step) mixing base; ``step`` is an int32 tensor or int."""
    return lowbias32(g ^ _wrapping_mul(step, _STEP_K))


def words_from_base(base: torch.Tensor):
    """(w0, w1) from a step base: w0 masked non-negative, w1 full 32 bits."""
    w0 = lowbias32(base ^ _W0_K)
    w1 = lowbias32(base + _W1_K)
    return w0 & 0x7FFFFFFF, w1


def word_from_base(base: torch.Tensor, salt) -> torch.Tensor:
    """One extra 31-bit word per (base, salt)."""
    return lowbias32(base + salt) & 0x7FFFFFFF


def step_words(g: torch.Tensor, step):
    """Two 32-bit words for (chain stream ``g``, int32 step counter)."""
    return words_from_base(step_base(g, step))


def uniform01(w: torch.Tensor) -> torch.Tensor:
    """24-bit uniform float32 in [0, 1) from a 32-bit word."""
    return (_shr(w, 7) & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24))
