"""The counter hashes that define the 3D N^2-queens chains' random streams.

Plain integer arithmetic on uint32 values held in int64 tensors (or Python
ints): every product is split into 16-bit halves so that nothing overflows
64 bits, and every result is reduced mod 2^32.  The constants are those of
the published sampler definition (the JAX package's ``kernels/prng.py``,
``core/fastinit.py`` and ``search/tempering.py``), written out here.
"""

from __future__ import annotations

MASK = 0xFFFFFFFF

# lowbias32 finalizer and the samplers' stream keys.
LB_M1, LB_M2 = 0x7FEB352D, 0x846CA68B
STEP_K = 0x9E3779B9
CHAIN_K = 0x85EBCA6B
W0_K, W1_K = 0x68BC21EB, 0x02E5BE93
SITE_MUL, SITE_SALT = 0x2545F491, 0x9E3779B9
CAND_SALT, MOVER_SALT = 0x7F4A7C15, 0x3C6EF372
# Block seeds of the shared-site samplers: seeds[0] + BLOCK_SEED_STRIDE * b.
BLOCK_SEED_STRIDE = 7919
# Replica exchange: group, pair and round strides.
GROUP_K, PAIR_K, ROUND_K = 0xB5297A4D, 0x1B873593, 0x9E3779B9
# murmur3 finalizer of the hash-based initial states.
MIX_M1, MIX_M2 = 0x85EBCA6B, 0xC2B2AE35
SALT_MUL, IDX_SALT = 0x632BE59B, 0xDEADBEEF


def mul32(a, k: int):
    """``a * k mod 2^32`` for uint32 values ``a`` (int64 tensor or int)."""
    return (a * (k & 0xFFFF) + (((a * (k >> 16)) & 0xFFFF) << 16)) & MASK


def lowbias32(z):
    z = z & MASK
    z = z ^ (z >> 16)
    z = mul32(z, LB_M1)
    z = z ^ (z >> 15)
    z = mul32(z, LB_M2)
    return z ^ (z >> 16)


def mix(x):
    """murmur3's 32-bit finalizer."""
    x = x & MASK
    x = x ^ (x >> 16)
    x = mul32(x, MIX_M1)
    x = x ^ (x >> 13)
    x = mul32(x, MIX_M2)
    return x ^ (x >> 16)


def chain_stream(seed):
    """A chain's stream key from its own uint32 seed."""
    return (mul32(seed, CHAIN_K) + lowbias32(seed)) & MASK


def step_words(g, step):
    """(w0 31-bit, w1 32-bit) of chain stream ``g`` at ``step``."""
    base = lowbias32(g ^ mul32(step, STEP_K))
    return lowbias32(base ^ W0_K) & 0x7FFFFFFF, lowbias32((base + W1_K) & MASK)


def uniform24(w):
    """The 24-bit integer ``k`` of the uniform ``k / 2^24`` a word draws."""
    return (w >> 7) & 0xFFFFFF


def round_key(swap_seed: int, round_idx: int) -> int:
    """A replica-exchange sweep's counter: (swap seed, round) mixed mod 2^32."""
    return ((swap_seed & MASK) * CHAIN_K + round_idx * ROUND_K) & MASK
