"""Peaks of one NVIDIA H100 SXM (80 GB HBM3, 700 W), frozen.

The int32 rate is architectural: 132 SMs, each issuing 128 int32 lanes a
clock over its two int32 pipes (IMAD on the FMA pipe beside IADD3 and LOP3
on the ALU pipe), at the 1980 MHz maximum SM clock.  A probe that doubles
words alternately with IADD3 and IMAD reads 0.982-0.995 of it on the card.
The memory rate is the data sheet's HBM3 bandwidth.
"""

SMS = 132
INT32_LANES_PER_SM = 128
SM_CLOCK_HZ = 1980e6
INT32_OPS_PER_S = SMS * INT32_LANES_PER_SM * SM_CLOCK_HZ  # 3.3454e13
HBM_BYTES_PER_S = 3.35e12


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card needs for ``ops`` int32 operations and
    ``nbytes`` bytes of device memory traffic: the larger of the two."""
    return max(ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
