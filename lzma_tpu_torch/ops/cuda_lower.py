"""The bit lowering as a CUDA kernel (``csrc/lower.cu``, K7).

Counterpart of ``lzma_tpu/ops/device_encoder.py`` ``lower_tokens``, a
``jax.jit`` function that XLA compiles for the device (it has no
``pallas_call``).  ``lower_tokens_cuda`` replaces
``device_encoder._lower_tokens_plain``: every valid token's (ctx, bit)
pairs at its offset in flat per-lane streams, the rest of each stream
filled with the direct ctx and bit 0, and each lane's total.  A CUDA
tensor launches the kernel (or the wrapper raises); a CPU tensor takes
the plain version.  A token's offset is an exclusive sum of the bit
counts before it, so the kernel spreads every lane's tokens over the
card in tiles (four grids, one call; the source says how), and reads
each input plane through its own strides, in place.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.layout import ProbLayout
from ..runtime import build
from .device_encoder import _lower_tokens_plain

#: kernel launches made through lower_tokens_cuda since the count was
#: last set
LAUNCHES = 0

#: ProbLayout's offsets in the order of csrc/lower_token.cuh's Layout,
#: which ends with lc, lp, pb
LAYOUT_FIELDS = ("is_match", "is_rep", "is_rep_g0", "is_rep_g1", "is_rep_g2",
                 "is_rep0_long", "pos_slot", "spec_pos", "align", "len_coder",
                 "rep_len_coder", "literal", "len_choice", "len_choice2",
                 "len_low", "len_mid", "len_high")

#: the status bits the kernel sets, and the plain version's errors
_TOTAL_OVER, _LONG_OVER = 1, 2


@functools.cache
def _kernel():
    lib = build.load()
    fn = lib.lzt_lower
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 2 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    size = lib.lzt_lower_scratch
    size.argtypes = [ctypes.c_int] * 2
    size.restype = ctypes.c_longlong
    return fn, size


def scratch_bytes(N: int, T: int) -> int:
    """Bytes of the kernel's scratch for N lanes of T tokens: the status
    word, the tiles' bit sums and long counts and the lanes' totals
    (csrc/lower.cu's layout)."""
    return int(_kernel()[1](N, T))


def layout_ints(lc: int, lp: int, pb: int) -> list[int]:
    """The kernel's layout argument: ProbLayout(lc, lp, pb, pos_bits=pb)'s
    offsets in LAYOUT_FIELDS order, then lc, lp, pb."""
    layout = ProbLayout(lc, lp, pb, pos_bits=pb)
    return [getattr(layout, f) for f in LAYOUT_FIELDS] + [lc, lp, pb]


def _check(meta, t_pos, t_len, t_dist, t_valid):
    if len(meta) != 7:
        raise ValueError(f"meta has {len(meta)} planes, not 7")
    if t_pos.dim() != 2:
        raise ValueError(f"t_pos must be (N, T), got {tuple(t_pos.shape)}")
    names = ("kind", "rep_idx", "state", "match_mode", "match_byte",
             "prev_byte", "lit_byte", "t_pos", "t_len", "t_dist", "t_valid")
    planes = (*meta, t_pos, t_len, t_dist, t_valid)
    for name, t in zip(names, planes):
        want = torch.bool if name == "t_valid" else torch.int64
        if t.shape != t_pos.shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, t_pos "
                             f"{tuple(t_pos.shape)}")
        if t.device != t_pos.device:
            raise ValueError(f"{name} is on {t.device}, t_pos on {t_pos.device}")
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if t.layout != torch.strided:
            raise ValueError(f"{name} must be a strided tensor, got {t.layout}")


def lower_tokens_cuda(meta, t_pos, t_len, t_dist, t_valid, lc: int, lp: int,
                      pb: int, max_bits: int, pos_base: int = 0):
    """The lowering of (N, T) tokens: meta (classify_tokens' seven int64
    planes), t_pos, t_len, t_dist int64, t_valid bool, any strides.
    Returns ctx (N, max_bits) int32, bit (N, max_bits) int32, total (N,)
    int32, as ``_lower_tokens_plain``, and raises its ValueError where a
    lane's bits pass max_bits or its long tokens pass T // 2 + 2."""
    global LAUNCHES
    if t_pos.device.type == "cpu":
        return _lower_tokens_plain(meta, t_pos, t_len, t_dist, t_valid, lc,
                                   lp, pb, max_bits, pos_base)
    if t_pos.device.type != "cuda":
        raise ValueError(f"lower_tokens_cuda takes CPU or CUDA tensors, "
                         f"got {t_pos.device}")
    _check(meta, t_pos, t_len, t_dist, t_valid)
    if max_bits < 0:
        raise ValueError(f"max_bits must be >= 0, got {max_bits}")
    N, T = t_pos.shape
    dev = t_pos.device
    if T == 0 or N == 0:
        return (torch.full((N, max_bits), -1, dtype=torch.int32, device=dev),
                torch.zeros((N, max_bits), dtype=torch.int32, device=dev),
                torch.zeros((N,), dtype=torch.int32, device=dev))
    planes = (*meta, t_pos, t_len, t_dist, t_valid)
    ptrs = (ctypes.c_void_p * len(planes))(*(t.data_ptr() for t in planes))
    strides = (ctypes.c_longlong * (2 * len(planes)))(
        *(s for t in planes for s in t.stride()))
    layout = (ctypes.c_int * (len(LAYOUT_FIELDS) + 3))(*layout_ints(lc, lp, pb))
    ctx = torch.empty((N, max_bits), dtype=torch.int32, device=dev)
    bits = torch.empty((N, max_bits), dtype=torch.int32, device=dev)
    total = torch.empty((N,), dtype=torch.int32, device=dev)
    fn = _kernel()[0]
    scratch = torch.empty((scratch_bytes(N, T),), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = fn(ptrs, strides, layout, int(pos_base), N, T, int(max_bits),
                 scratch.data_ptr(), ctx.data_ptr(), bits.data_ptr(),
                 total.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"lower launch failed: CUDA error {err}")
    LAUNCHES += 1
    status = int(scratch[:4].view(torch.int32).item())
    if status & _TOTAL_OVER:
        raise ValueError(f"token bits exceed the {max_bits}-entry stream")
    if status & _LONG_OVER:
        raise ValueError("long tokens overflow the compacted lowering buffer")
    return ctx, bits, total
