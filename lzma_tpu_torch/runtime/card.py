"""What the kernels' wrappers ask of the card (``csrc/card.cu``)."""

from __future__ import annotations

import ctypes
import functools

from . import build


@functools.cache
def smem_limit(device_index: int) -> int:
    """The card's opt-in shared memory per block, in bytes
    (cudaDevAttrMaxSharedMemoryPerBlockOptin)."""
    fn = build.load().lzt_smem_limit
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    v = fn(device_index)
    if v <= 0:
        raise RuntimeError(f"shared memory limit query failed: CUDA error {-v}")
    return v
