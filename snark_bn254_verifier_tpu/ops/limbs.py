"""Multi-limb representation of 254-bit field elements.

Field elements are arrays of ``NUM_LIMBS = 16`` limbs of ``LIMB_BITS = 16``
bits stored in uint32 lanes, least-significant limb first, with the limb axis
LEADING: shape ``(16, *batch)``. The batch is the contiguous trailing axis,
so one limb of many elements is one unit-stride row; 16x16-bit products
fit exactly in uint32, so every op is plain 32-bit integer arithmetic.

This replaces the reference's external bignum backend
(`substrate-bn::arith::U256`, Cargo.lock pin; see SURVEY.md §2.2).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

LIMB_BITS = 16
NUM_LIMBS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
TOTAL_BITS = LIMB_BITS * NUM_LIMBS  # 256


def int_to_limbs(value: int) -> np.ndarray:
    """Python int -> uint32[NUM_LIMBS], little-endian limbs."""
    if value < 0 or value >= 1 << TOTAL_BITS:
        raise ValueError("value out of range for 256-bit limbs")
    return np.array(
        [(value >> (LIMB_BITS * i)) & LIMB_MASK for i in range(NUM_LIMBS)],
        dtype=np.uint32,
    )


def limbs_to_int(limbs) -> int:
    arr = np.asarray(limbs, dtype=np.uint64).reshape(-1)
    assert arr.shape[0] == NUM_LIMBS
    return sum(int(limb) << (LIMB_BITS * i) for i, limb in enumerate(arr))


def ints_to_limbs_batch(values: Sequence[int]) -> np.ndarray:
    """[ints] -> uint32[NUM_LIMBS, B] (limb axis leading)."""
    return np.stack([int_to_limbs(v) for v in values], axis=1)


def limbs_batch_to_ints(limbs) -> list:
    arr = np.asarray(limbs)
    assert arr.shape[0] == NUM_LIMBS
    flat = arr.reshape(NUM_LIMBS, -1)
    return [
        sum(int(flat[i, j]) << (LIMB_BITS * i) for i in range(NUM_LIMBS))
        for j in range(flat.shape[1])
    ]
