"""The range encoder as a CUDA kernel (``csrc/rc_serializer.cu``).

Counterpart of ``lzma_tpu/ops/pallas_serializer.py``: ``serialize_cuda``
replaces ``serialize_pallas`` and ``serialize_checked`` replaces
``serialize_with_fallback``.  A CUDA tensor launches the kernel (or the
wrapper raises); a CPU tensor takes the plain version,
``device_encoder.serialize``.  Nothing reroutes a failed launch or an
incomplete lane to the plain version.

A lane's probability arena lives in shared memory when it fits beside the
staged tiles of (ctx, bit) pairs, else in device memory
(``arena_placement``); the placement is decided before the launch and a
lane never takes the other one.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..runtime import build
from ..runtime.card import smem_limit
from .device_encoder import serialize

#: kernel launches made through serialize_cuda since the count was last set
LAUNCHES = 0

#: (ctx, bit) pairs a tile, staged into shared memory ahead of the coder
#: (csrc/rc_serializer.cu kTile), two tiles of int32 ctx and bits
TILE = 1 << 10
PLACEMENTS = ("shared", "device")


def smem_bytes(placement: str, arena_size: int) -> int:
    """Dynamic shared memory a block of the kernel takes: the two tiles,
    and for the "shared" placement the uint16 arena rounded up to 16 B."""
    if placement not in PLACEMENTS:
        raise ValueError(f"placement must be one of {PLACEMENTS}, got {placement!r}")
    arena = (2 * arena_size + 15) // 16 * 16 if placement == "shared" else 0
    return 2 * 2 * TILE * 4 + arena


def arena_placement(arena_size: int, limit: int) -> str:
    """Where a lane's arena of `arena_size` probabilities goes on a card
    that gives a block `limit` bytes of shared memory: "shared" when it
    fits beside the tiles, else "device"."""
    return "shared" if smem_bytes("shared", arena_size) <= limit else "device"


@functools.cache
def _kernel():
    fn = build.load().lzt_rc_serialize
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(ctx, bits, totals):
    if ctx.dim() != 2 or bits.shape != ctx.shape or totals.shape != ctx.shape[:1]:
        raise ValueError(f"shapes: ctx {tuple(ctx.shape)}, bits "
                         f"{tuple(bits.shape)}, totals {tuple(totals.shape)}")
    for name, t in (("ctx", ctx), ("bits", bits), ("totals", totals)):
        if t.device != ctx.device:
            raise ValueError(f"{name} is on {t.device}, ctx on {ctx.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def serialize_cuda(ctx, bits, totals, arena_size: int, max_out: int):
    """Range-code per-lane (ctx, bit) streams.  ctx, bits: (N, B) int32;
    totals: (N,) int32.  ctx >= 0 is an adaptive slot, -1 a direct bit,
    anything else a step that codes nothing.  Returns (out (N, max_out)
    uint8, lens (N,) int32, consumed (N,) int32): consumed is -1 for a
    lane whose output would pass max_out, else totals.  The arena goes
    where ``arena_placement`` puts `arena_size` probabilities on this
    card."""
    global LAUNCHES
    if ctx.device.type == "cpu":
        out, lens = serialize(ctx, bits, totals, arena_size, max_out)
        consumed = torch.where(lens > max_out, -1, totals.to(torch.int32))
        return out, lens, consumed.to(torch.int32)
    if ctx.device.type != "cuda":
        raise ValueError(f"serialize_cuda takes CPU or CUDA tensors, got {ctx.device}")
    _check(ctx, bits, totals)
    n, b = ctx.shape
    dev = ctx.device
    limit = smem_limit(dev.index if dev.index is not None
                       else torch.cuda.current_device())
    placement = arena_placement(arena_size, limit)
    smem = smem_bytes(placement, arena_size)
    shared = placement == "shared"
    probs = None if shared else torch.empty((n, arena_size), dtype=torch.int16,
                                            device=dev)
    out = torch.zeros((n, max_out), dtype=torch.uint8, device=dev)
    lens = torch.empty((n,), dtype=torch.int32, device=dev)
    consumed = torch.empty((n,), dtype=torch.int32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        err = fn(ctx.data_ptr(), bits.data_ptr(), totals.data_ptr(),
                 None if shared else probs.data_ptr(), out.data_ptr(),
                 lens.data_ptr(), consumed.data_ptr(), n, b, arena_size,
                 max_out, int(shared), smem,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"rc_serialize launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out, lens, consumed


def serialize_checked(ctx, bits, totals, arena_size: int, max_out: int):
    """serialize_cuda that raises unless every lane consumed all its bits
    (the counterpart of serialize_with_fallback, which rerouted).
    Returns (out, lens)."""
    totals = totals.to(torch.int32)
    out, lens, consumed = serialize_cuda(ctx.to(torch.int32).contiguous(),
                                         bits.to(torch.int32).contiguous(),
                                         totals, arena_size, max_out)
    if bool((consumed != totals).any()):
        bad = torch.nonzero(consumed != totals).flatten().tolist()
        raise RuntimeError(f"range coder output passed {max_out} bytes "
                           f"on lanes {bad}")
    return out, lens
