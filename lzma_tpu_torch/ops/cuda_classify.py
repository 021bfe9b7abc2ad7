"""The classify scan's carry as a CUDA kernel (``csrc/classify.cu``, K6).

Counterpart of the ``lax.scan`` in ``lzma_tpu/ops/device_encoder.py``
``classify_tokens``, which JAX compiles for the device (it has no
``pallas_call``).  ``classify_carry_cuda`` replaces the serial part,
``device_encoder._classify_carry``: the state machine and the rep MTF
carried over every lane's tokens.  A CUDA tensor launches the kernel (or
the wrapper raises); a CPU tensor takes the plain version.  The carry is
a scan: the reps before a token are the most recent distinct distances
before it and its state the composition of the earlier tokens' state
maps, both associative, so the kernel spreads every lane's rows over the
card in tiles (five grids, one call; the source says how).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..runtime import build
from .device_encoder import _classify_carry

#: kernel launches made through classify_carry_cuda since the count was
#: last set
LAUNCHES = 0


@functools.cache
def _kernel():
    lib = build.load()
    fn = lib.lzt_classify
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size = lib.lzt_classify_scratch
    size.argtypes = [ctypes.c_int] * 2
    size.restype = ctypes.c_longlong
    return fn, size


def scratch_bytes(T: int, N: int) -> int:
    """Bytes of the kernel's scratch for (T, N) token rows: the tiles'
    and the chunks' lists and maps (csrc/classify.cu's layout)."""
    return int(_kernel()[1](T, N))


def _check(dist_r, len_r, valid_r):
    if dist_r.dim() != 2 or len_r.shape != dist_r.shape \
            or valid_r.shape != dist_r.shape:
        raise ValueError(f"shapes: dist {tuple(dist_r.shape)}, len "
                         f"{tuple(len_r.shape)}, valid {tuple(valid_r.shape)}")
    for name, t, dtype in (("dist", dist_r, torch.int32),
                           ("len", len_r, torch.int32),
                           ("valid", valid_r, torch.bool)):
        if t.device != dist_r.device:
            raise ValueError(f"{name} is on {t.device}, dist on {dist_r.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def classify_carry_cuda(dist_r, len_r, valid_r):
    """The classify carry over token rows (T, N): dist and len int32,
    valid bool (``device_encoder._classify_rows``).  Returns (case_r,
    state_r, r0_r), (T, N) int32, as ``_classify_carry``."""
    global LAUNCHES
    if dist_r.device.type == "cpu":
        return _classify_carry(dist_r, len_r, valid_r)
    if dist_r.device.type != "cuda":
        raise ValueError(f"classify_carry_cuda takes CPU or CUDA tensors, "
                         f"got {dist_r.device}")
    _check(dist_r, len_r, valid_r)
    T, N = dist_r.shape
    dev = dist_r.device
    outs = [torch.empty((T, N), dtype=torch.int32, device=dev) for _ in range(3)]
    if T == 0 or N == 0:
        return tuple(outs)
    case_r, state_r, r0_r = outs
    fn = _kernel()[0]
    scratch = torch.empty((scratch_bytes(T, N),), dtype=torch.uint8,
                          device=dev)
    with torch.cuda.device(dev):
        err = fn(dist_r.data_ptr(), len_r.data_ptr(), valid_r.data_ptr(),
                 scratch.data_ptr(), case_r.data_ptr(), state_r.data_ptr(),
                 r0_r.data_ptr(), T, N,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"classify launch failed: CUDA error {err}")
    LAUNCHES += 1
    return case_r, state_r, r0_r
