"""The classify scan's carry (K6) and the whole of classify_tokens (K19) as
CUDA kernels (``csrc/classify.cu``, K19's per-token closed forms in
``csrc/classify_meta.cuh``).

Counterparts of ``lzma_tpu/ops/device_encoder.py`` ``classify_tokens``,
its ``lax.scan`` and the gathers around it, which JAX compiles for the
device under ``jax.jit`` (no ``pallas_call``):

- ``classify_carry_cuda`` (K6) replaces the serial part,
  ``device_encoder._classify_carry``: the state machine and the rep MTF
  carried over every lane's token rows (T, N).  No path of the package
  calls it since K19 classifies the tokens; it stays as the carry's own
  kernel, held to ``_classify_carry`` on the card;
- ``classify_tokens_cuda`` (K19) replaces the whole of
  ``device_encoder._classify_tokens_plain`` (``_classify_rows``, the
  carry and ``_classify_finish``, some 30 operations a call):
  ``classify_tokens`` calls it on every encode.  K6's scan grids read
  the (N, T) token planes through their strides, and its last grid
  writes the seven int64 planes, a thread a token.

The carry is a scan: the reps before a token are the most recent
distinct distances before it and its state the composition of the
earlier tokens' state maps, both associative, so the kernels spread
every lane's rows over the card in tiles (five grids, one call; the
source says how).  A CUDA tensor launches the kernel (or the wrapper
raises); a CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..runtime import build
from .device_encoder import _classify_carry, _classify_tokens_plain

#: kernel launches made through classify_carry_cuda (K6) since the count
#: was last set
LAUNCHES = 0
#: kernel launches made through classify_tokens_cuda (K19)
TOKEN_LAUNCHES = 0


@functools.cache
def _kernel():
    lib = build.load()
    fn = lib.lzt_classify
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size = lib.lzt_classify_scratch
    size.argtypes = [ctypes.c_int] * 2
    size.restype = ctypes.c_longlong
    whole = lib.lzt_classify_tokens
    whole.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] \
        + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    whole.restype = ctypes.c_int
    return fn, size, whole


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


def _token_planes(data, t_pos, t_len, t_dist, t_valid):
    """K19's inputs as it reads them: data (N, max_n) uint8 with unit byte
    stride, the token planes (N, T) int64 and t_valid bool, each on the
    data's device (a plane of another integer type is converted)."""
    if data.dim() != 2 or data.dtype != torch.uint8:
        raise ValueError(f"data must be (N, max_n) uint8, got "
                         f"{tuple(data.shape)} {data.dtype}")
    N = data.shape[0]
    planes = []
    for name, t in (("t_pos", t_pos), ("t_len", t_len), ("t_dist", t_dist),
                    ("t_valid", t_valid)):
        if t.dim() != 2 or t.shape[0] != N or t.shape != t_pos.shape:
            raise ValueError(f"{name} must be ({N}, T) as t_pos "
                             f"{tuple(t_pos.shape)}, got {tuple(t.shape)}")
        if t.device != data.device:
            raise ValueError(f"{name} is on {t.device}, data on {data.device}")
        if t.is_floating_point() or t.is_complex():
            raise TypeError(f"{name} must be an integer tensor, got {t.dtype}")
        planes.append(t.bool() if name == "t_valid" else t.long())
    if data.stride(1) != 1:
        data = data.contiguous()
    return data, planes


def classify_tokens_cuda(data, t_pos, t_len, t_dist, t_valid):
    """classify_tokens whole (K19): data (N, max_n) uint8; token arrays
    (N, T).  Returns kind, rep_idx, state_before, match_mode, match_byte,
    prev_byte and lit_byte, (N, T) int64, as ``_classify_tokens_plain``
    (views of one (7, N, T) allocation on the card)."""
    global TOKEN_LAUNCHES
    if data.device.type == "cpu":
        return _classify_tokens_plain(data, t_pos, t_len, t_dist, t_valid)
    if data.device.type != "cuda":
        raise ValueError(f"classify_tokens_cuda takes CPU or CUDA tensors, "
                         f"got {data.device}")
    data, planes = _token_planes(data, t_pos, t_len, t_dist, t_valid)
    N, T = planes[0].shape
    dev = data.device
    out = torch.empty((7, N, T), dtype=torch.int64, device=dev)
    if T == 0 or N == 0:
        return tuple(out.unbind(0))
    if data.shape[1] == 0:
        raise ValueError("data has no bytes: a token's bytes lie outside "
                         "its lane")
    _, size, whole = _kernel()
    scratch = torch.empty((int(size(T, N)),), dtype=torch.uint8, device=dev)
    # each plane's (row, lane) strides: its T axis's, then its N axis's
    strides = (ctypes.c_longlong * 8)(*(s for p in planes
                                        for s in reversed(p.stride())))
    with torch.cuda.device(dev):
        err = whole(data.data_ptr(), data.stride(0), data.shape[1],
                    *(p.data_ptr() for p in planes), strides,
                    scratch.data_ptr(), out.data_ptr(), T, N,
                    torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"classify_tokens launch failed: CUDA error {err}")
    TOKEN_LAUNCHES += 1
    return tuple(out.unbind(0))
