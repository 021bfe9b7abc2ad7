"""The LZMA decoder as a CUDA kernel (``csrc/ring_decoder.cu``).

Counterpart of ``lzma_tpu/ops/pallas_ring.py``: ``decode_cuda`` replaces
``decode_pallas_ring`` and ``decode_batch_cuda`` replaces
``decode_batch_ring`` with ``pallas_decoder.batched_decode``.  The lane
groups of the TPU route existed for its VMEM budget and are gone.  A
CUDA tensor launches the kernel (or the wrapper raises); a CPU tensor
takes the plain version, ``device_decoder._decode_fsm``.  A lane that
fails raises CorruptStreamError; it is never re-decoded another way.

A lane's probability arena lives in shared memory when it fits beside
the staged input tiles, else in device memory (``arena_placement``); the
placement is a pure function of the arena's size and the card's limit,
decided before the launch, and a lane never takes the other one.  The
lane's stream comes into shared memory by tiles of ``IN_TILE`` bytes,
two at a time; its window is its output row in device memory.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import fields

import torch

from ..core.layout import ProbLayout
from ..format.properties import LzmaParams
from ..runtime import build
from ..runtime.card import smem_limit
from .device_decoder import _decode_fsm, decode_lanes

#: kernel launches made through decode_cuda since the count was last set
LAUNCHES = 0

#: input bytes a tile, staged into shared memory ahead of the decoder
#: (csrc/lzma_decode.cuh kInTile), two tiles in a ring
IN_TILE = 1 << 12
#: the ring's control words (csrc/lzma_decode.cuh kCtrlBytes)
CTRL_BYTES = 16


def smem_bytes(arena_size: int) -> int:
    """Dynamic shared memory a block takes with its arena of `arena_size`
    probabilities in shared memory: the control words, the two input
    tiles and the uint16 arena rounded up to 16 B (the kernel's own
    count is csrc/lzma_decode.cuh ring_smem_bytes)."""
    return CTRL_BYTES + 2 * IN_TILE + (2 * arena_size + 15) // 16 * 16


def arena_placement(arena_size: int, limit: int) -> str:
    """Where a lane's arena of `arena_size` probabilities goes on a card
    that gives a block `limit` bytes of shared memory: "shared" when it
    fits beside the input tiles, else "device"."""
    return "shared" if smem_bytes(arena_size) <= limit else "device"

_LAYOUT_FIELDS = ("is_match", "is_rep", "is_rep_g0", "is_rep_g1", "is_rep_g2",
                  "is_rep0_long", "pos_slot", "spec_pos", "align", "len_coder",
                  "rep_len_coder", "literal", "size", "pos_bits", "len_choice",
                  "len_choice2", "len_low", "len_mid", "len_high")
assert set(_LAYOUT_FIELDS) <= {f.name for f in fields(ProbLayout)}


class _Layout(ctypes.Structure):
    """ProbLayout's offsets, passed by value (struct LztLayout in the .cu)."""
    _fields_ = [(name, ctypes.c_int) for name in _LAYOUT_FIELDS]


@functools.cache
def _kernel():
    fn = build.load().lzt_ring_decode
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [_Layout, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(comp, comp_lens, out_sizes, preset, max_out):
    if comp.dim() != 2 or comp_lens.shape != comp.shape[:1] \
            or out_sizes.shape != comp.shape[:1]:
        raise ValueError(f"shapes: comp {tuple(comp.shape)}, comp_lens "
                         f"{tuple(comp_lens.shape)}, out_sizes "
                         f"{tuple(out_sizes.shape)}")
    want = [("comp", comp, torch.uint8), ("comp_lens", comp_lens, torch.int32),
            ("out_sizes", out_sizes, torch.int32)]
    if preset is not None:
        want.append(("preset", preset, torch.uint8))
        if preset.dim() != 1 or preset.shape[0] > max_out:
            raise ValueError(f"preset must be (P,) with P <= max_out, got "
                             f"{tuple(preset.shape)}")
    for name, t, dtype in want:
        if t.device != comp.device:
            raise ValueError(f"{name} is on {t.device}, comp on {comp.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def launch_args(comp, layout: ProbLayout):
    """What a launch of csrc/ring_decoder.cu's block needs beside its
    tensors, on comp's card: (shared (0/1), the device arena (N,
    layout.size) int16 or None)."""
    dev = comp.device
    limit = smem_limit(dev.index if dev.index is not None
                       else torch.cuda.current_device())
    placement = arena_placement(layout.size, limit)
    probs = None if placement == "shared" else torch.empty(
        (comp.shape[0], layout.size), dtype=torch.int16, device=dev)
    return int(placement == "shared"), probs


def decode_cuda(comp, comp_lens, out_sizes, dict_size: int, lc: int, lp: int,
                pb: int, max_out: int, preset=None):
    """Decode N padded raw LZMA streams, one lane each.  comp: (N, max_in)
    uint8; comp_lens, out_sizes: (N,) int32 (a negative size -cap marks
    an EOS lane).  `preset` ((P,) uint8 or None) primes every lane's
    window: out_sizes are then absolute end positions and the payload
    sits at out[:, P:].  Returns (out (N, max_out) uint8, ok (N,) bool,
    out_pos (N,) int32).  The arena goes where ``arena_placement`` puts
    it on this card."""
    global LAUNCHES
    if comp.device.type == "cpu":
        return _decode_fsm(comp, comp_lens, out_sizes, dict_size, lc, lp, pb,
                           max_out, preset=preset)
    if comp.device.type != "cuda":
        raise ValueError(f"decode_cuda takes CPU or CUDA tensors, got {comp.device}")
    _check(comp, comp_lens, out_sizes, preset, max_out)
    layout = ProbLayout(lc, lp, pb, pos_bits=pb)
    n, max_in = comp.shape
    dev = comp.device
    shared, probs = launch_args(comp, layout)
    out = torch.zeros((n, max_out), dtype=torch.uint8, device=dev)
    ok = torch.empty((n,), dtype=torch.bool, device=dev)
    out_pos = torch.empty((n,), dtype=torch.int32, device=dev)
    plen = 0 if preset is None else int(preset.shape[0])
    fn = _kernel()
    with torch.cuda.device(dev):
        err = fn(comp.data_ptr(), comp_lens.data_ptr(), out_sizes.data_ptr(),
                 preset.data_ptr() if plen else None, plen,
                 None if probs is None else probs.data_ptr(), out.data_ptr(),
                 ok.data_ptr(), out_pos.data_ptr(), n, max_in, int(dict_size),
                 lc, lp, pb, max_out, shared,
                 _Layout(*(getattr(layout, f) for f in _LAYOUT_FIELDS)),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"ring_decode launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out, ok, out_pos


def decode_batch_cuda(streams, params: LzmaParams, out_sizes, max_out=None,
                      preset: bytes = b"", device="cuda"):
    """Decode a list of raw LZMA streams through decode_cuda.  Same
    contract as device_decoder.decode_batch (pow2 shape buckets, absolute
    sizes under a preset, a failed lane raises CorruptStreamError).
    Returns a list of bytes."""
    return decode_lanes(streams, params, out_sizes, decode_cuda,
                        max_out=max_out, preset=preset, device=device)
