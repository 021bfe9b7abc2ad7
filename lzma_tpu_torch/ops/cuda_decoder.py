"""The LZMA decoder with each lane's block resident in shared memory, as
a CUDA kernel (``csrc/block_decoder.cu``).

Counterpart of ``lzma_tpu/ops/pallas_decoder.py`` (K5): ``decode_resident``
replaces ``decode_pallas`` and ``decode_batch_resident`` replaces
``decode_batch_pallas`` with ``fallback=False``.  A lane's arena, stream
and whole window must fit the card's opt-in shared memory per block
(``resident_layout``); a batch beyond it raises ValueError and is not
rerouted.  The lane groups and the iteration budget of the TPU route
(VMEM and Mosaic limits) are not ported.  A CUDA tensor launches the
kernel (or the wrapper raises); a CPU tensor takes the plain version,
``device_decoder._decode_fsm``.  ``api.decode_blocks`` keeps K1
(``cuda_ring``), as the JAX package's keeps the ring kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.layout import ProbLayout
from ..format.properties import LzmaParams
from ..runtime import build
from ..runtime.card import smem_limit
from .cuda_ring import _LAYOUT_FIELDS, _Layout, _check
from .device_decoder import _decode_fsm, decode_lanes

#: kernel launches made through decode_resident since the count was last set
LAUNCHES = 0


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def resident_layout(max_in: int, max_out: int, arena: int):
    """Where the kernel puts a lane in shared memory: the int16 arena of
    `arena` probabilities at 0, the window at win_off, the input at
    in_off, each rounded up to 16 bytes.  Returns (win_off, in_off, the
    bytes a lane needs: max_in + max_out + 2 x arena, so rounded)."""
    win_off = _round16(2 * arena)
    in_off = win_off + _round16(max_out)
    return win_off, in_off, in_off + _round16(max_in)


@functools.cache
def _kernel():
    fn = build.load().lzt_block_decode
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10
                   + [_Layout, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def decode_resident(comp, comp_lens, out_sizes, dict_size: int, lc: int,
                    lp: int, pb: int, max_out: int, preset=None):
    """Decode N padded raw LZMA streams, one lane a block, each lane's
    arena, stream and window in shared memory.  The arguments and results
    are those of ``cuda_ring.decode_cuda``: comp (N, max_in) uint8,
    comp_lens and out_sizes (N,) int32 (a negative size -cap marks an EOS
    lane), `preset` ((P,) uint8 or None; out_sizes are then absolute).
    Returns (out (N, max_out) uint8, ok (N,) bool, out_pos (N,) int32).
    Raises ValueError when a lane does not fit the card's shared memory."""
    global LAUNCHES
    if comp.device.type == "cpu":
        return _decode_fsm(comp, comp_lens, out_sizes, dict_size, lc, lp, pb,
                           max_out, preset=preset)
    if comp.device.type != "cuda":
        raise ValueError(f"decode_resident takes CPU or CUDA tensors, got "
                         f"{comp.device}")
    _check(comp, comp_lens, out_sizes, preset, max_out)
    layout = ProbLayout(lc, lp, pb, pos_bits=pb)
    n, max_in = comp.shape
    dev = comp.device
    win_off, in_off, need = resident_layout(max_in, max_out, layout.size)
    limit = smem_limit(dev.index if dev.index is not None
                       else torch.cuda.current_device())
    if need > limit:
        raise ValueError(
            f"a lane needs {need} B of shared memory (input {max_in} B, "
            f"window {max_out} B, arena {2 * layout.size} B) and the card "
            f"gives a block {limit} B")
    out = torch.empty((n, max_out), dtype=torch.uint8, device=dev)
    ok = torch.empty((n,), dtype=torch.bool, device=dev)
    out_pos = torch.empty((n,), dtype=torch.int32, device=dev)
    plen = 0 if preset is None else int(preset.shape[0])
    fn = _kernel()
    with torch.cuda.device(dev):
        err = fn(comp.data_ptr(), comp_lens.data_ptr(), out_sizes.data_ptr(),
                 preset.data_ptr() if plen else None, plen, out.data_ptr(),
                 ok.data_ptr(), out_pos.data_ptr(), n, max_in, int(dict_size),
                 lc, lp, pb, max_out, win_off, in_off, need,
                 _Layout(*(getattr(layout, f) for f in _LAYOUT_FIELDS)),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"block_decode launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out, ok, out_pos


def decode_batch_resident(streams, params: LzmaParams, out_sizes, max_out=None,
                          preset: bytes = b"", device="cuda"):
    """Decode a list of raw LZMA streams through decode_resident.  Same
    contract as device_decoder.decode_batch (pow2 shape buckets, absolute
    sizes under a preset, a failed lane raises CorruptStreamError); a
    batch beyond the kernel's envelope raises ValueError.  Returns a list
    of bytes."""
    return decode_lanes(streams, params, out_sizes, decode_resident,
                        max_out=max_out, preset=preset, device=device)
