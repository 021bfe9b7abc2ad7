"""The adaptive-bit model's scale and the -log2 price table.

The port's own copy of ``lzma_tpu/core/prices.py``: 11-bit probabilities
(RangeBase.java:4-13) and prices in 1/64-bit units over 512 quantized
probability buckets (ProbPrices.java:5-18).
"""

from __future__ import annotations

import numpy as np

NUM_BIT_MODEL_TOTAL_BITS = 11
BIT_MODEL_TOTAL = 1 << NUM_BIT_MODEL_TOTAL_BITS   # 2048
NUM_MOVE_REDUCING_BITS = 2
NUM_BIT_PRICE_SHIFT_BITS = 6


def _build_prices() -> np.ndarray:
    """Piecewise-log price table (ProbPrices.java:8-18)."""
    n = BIT_MODEL_TOTAL >> NUM_MOVE_REDUCING_BITS  # 512
    num_bits = NUM_BIT_MODEL_TOTAL_BITS - NUM_MOVE_REDUCING_BITS  # 9
    table = np.zeros(n, dtype=np.int32)
    for i in range(num_bits - 1, -1, -1):
        start = 1 << (num_bits - i - 1)
        end = 1 << (num_bits - i)
        j = np.arange(start, end)
        table[j] = (i << NUM_BIT_PRICE_SHIFT_BITS) + (
            ((end - j) << NUM_BIT_PRICE_SHIFT_BITS) >> (num_bits - i - 1)
        )
    return table


PRICE_TABLE = _build_prices()
