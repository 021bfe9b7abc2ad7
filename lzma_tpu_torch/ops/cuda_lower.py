"""The bit lowering (K7) and its slot counts (K8) as CUDA kernels
(``csrc/lower.cu``, both on the closed forms of ``csrc/lower_token.cuh``).

K7 is the counterpart of ``lzma_tpu/ops/device_encoder.py``
``lower_tokens``, a ``jax.jit`` function that XLA compiles for the device
(it has no ``pallas_call``).  ``lower_tokens_cuda`` replaces
``device_encoder._lower_tokens_plain``: every valid token's (ctx, bit)
pairs at its offset in flat per-lane streams, the rest of each stream
filled with the direct ctx and bit 0, and each lane's total.  A token's
offset is an exclusive sum of the bit counts before it, so the kernel
spreads every lane's tokens over the card in tiles and writes each
round's pairs through a shared-memory stage (four grids, one call; the
source says how).

K8 is the counterpart of what the optimal parse's rounds make of that
lowering, ``lzma_tpu/ops/device_parser.py`` ``empirical_probs(
lower_tokens(...))`` up to the probabilities: ``lower_counts_cuda``
replaces ``device_encoder._lower_counts_plain``, each lane's count of
pairs a probability slot (n) and of those with bit 1 (n1), and its
total.  It writes no stream: each round's pairs are staged in shared
memory at their scanned offsets, as K7 stages them, and the block walks
the stage converged, adding every pair into a histogram, in the block's
shared memory where a lane's slots fit it (``count_placement``), else in
device memory.

A CUDA tensor launches the kernel (or the wrapper raises); a CPU tensor
takes the plain version.  Both read each input plane through its own
strides, in place, and raise the plain version's ValueError where a
lane's bits pass max_bits or its long tokens pass T // 2 + 2.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.layout import ProbLayout
from ..runtime import build
from ..runtime.card import smem_limit
from .device_encoder import _lower_counts_plain, _lower_tokens_plain

#: kernel launches made through lower_tokens_cuda (K7) since the count
#: was last set
LAUNCHES = 0
#: kernel launches made through lower_counts_cuda (K8) since the count
#: was last set
COUNT_LAUNCHES = 0

#: ProbLayout's offsets in the order of csrc/lower_token.cuh's Layout,
#: which ends with lc, lp, pb
LAYOUT_FIELDS = ("is_match", "is_rep", "is_rep_g0", "is_rep_g1", "is_rep_g2",
                 "is_rep0_long", "pos_slot", "spec_pos", "align", "len_coder",
                 "rep_len_coder", "literal", "len_choice", "len_choice2",
                 "len_low", "len_mid", "len_high")

#: the status bits the kernels set, and the plain version's errors
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


@functools.cache
def _count_kernel():
    lib = build.load()
    fn = lib.lzt_lower_counts
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 2 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    size = lib.lzt_lower_counts_scratch
    size.argtypes = [ctypes.c_int]
    size.restype = ctypes.c_longlong
    return fn, size


def scratch_bytes(N: int, T: int) -> int:
    """Bytes of the kernel's scratch for N lanes of T tokens: the status
    word, the tiles' bit sums and long counts and the lanes' totals
    (csrc/lower.cu's layout)."""
    return int(_kernel()[1](N, T))


def count_smem_bytes(arena_size: int) -> int:
    """Shared bytes of a K8 block whose histogram is in shared memory: a
    32-bit word a slot, rounded up to 16 B."""
    return (4 * arena_size + 15) // 16 * 16


#: shared bytes a K8 block holds beside its histogram, at most: its pair
#: stage (csrc/lower.cu kStage 32-bit words) and its scans' slots
COUNT_STAGE_BYTES = 4 * 4096 + 256


def count_placement(arena_size: int, limit: int) -> str:
    """Where K8 keeps a lane's histogram of `arena_size` slots on a card
    that gives a block `limit` bytes of shared memory: "shared" when it
    fits beside the block's pair stage, else "device" (global atomics
    into n and n1)."""
    fits = count_smem_bytes(arena_size) + COUNT_STAGE_BYTES <= limit
    return "shared" if fits else "device"


@functools.cache
def layout_ints(lc: int, lp: int, pb: int) -> list[int]:
    """The kernel's layout argument: ProbLayout(lc, lp, pb, pos_bits=pb)'s
    offsets in LAYOUT_FIELDS order, then lc, lp, pb (cached: every
    wrapper call asks for it)."""
    layout = ProbLayout(lc, lp, pb, pos_bits=pb)
    return [getattr(layout, f) for f in LAYOUT_FIELDS] + [lc, lp, pb]


@functools.cache
def _slots(lc: int, lp: int, pb: int) -> int:
    return ProbLayout(lc, lp, pb, pos_bits=pb).size


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
    ptrs, strides, layout = _arguments(meta, t_pos, t_len, t_dist, t_valid,
                                       lc, lp, pb)
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
    _raise_on_status(scratch, max_bits)
    return ctx, bits, total


def lower_counts_cuda(meta, t_pos, t_len, t_dist, t_valid, lc: int, lp: int,
                      pb: int, max_bits: int, pos_base: int = 0):
    """The slot counts of the lowering of (N, T) tokens (arguments as
    ``lower_tokens_cuda``'s).  Returns n (N, S) int32, n1 (N, S) int32
    and total (N,) int32, S = ProbLayout(lc, lp, pb).size: for each slot
    the lowered pairs with that ctx and those of them with bit 1 (the
    direct bits, ctx -1, are not counted), as ``_lower_counts_plain``;
    raises its ValueError where a lane's bits pass max_bits or its long
    tokens pass T // 2 + 2."""
    global COUNT_LAUNCHES
    if t_pos.device.type == "cpu":
        return _lower_counts_plain(meta, t_pos, t_len, t_dist, t_valid, lc,
                                   lp, pb, max_bits, pos_base)
    if t_pos.device.type != "cuda":
        raise ValueError(f"lower_counts_cuda takes CPU or CUDA tensors, "
                         f"got {t_pos.device}")
    _check(meta, t_pos, t_len, t_dist, t_valid)
    if max_bits < 0:
        raise ValueError(f"max_bits must be >= 0, got {max_bits}")
    N, T = t_pos.shape
    dev = t_pos.device
    S = _slots(lc, lp, pb)
    # the kernel zeroes n and n1 itself
    new = torch.zeros if T == 0 or N == 0 else torch.empty
    n = new((N, S), dtype=torch.int32, device=dev)
    n1 = new((N, S), dtype=torch.int32, device=dev)
    total = new((N,), dtype=torch.int32, device=dev)
    if T == 0 or N == 0:
        return n, n1, total
    ptrs, strides, layout = _arguments(meta, t_pos, t_len, t_dist, t_valid,
                                       lc, lp, pb)
    limit = smem_limit(dev.index if dev.index is not None
                       else torch.cuda.current_device())
    smem = count_smem_bytes(S) if count_placement(S, limit) == "shared" else 0
    fn, size = _count_kernel()
    scratch = torch.empty((int(size(N)),), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = fn(ptrs, strides, layout, int(pos_base), N, T, int(max_bits), S,
                 smem, scratch.data_ptr(), n.data_ptr(), n1.data_ptr(),
                 total.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"lower_counts launch failed: CUDA error {err}")
    COUNT_LAUNCHES += 1
    _raise_on_status(scratch, max_bits)
    return n, n1, total


def _arguments(meta, t_pos, t_len, t_dist, t_valid, lc, lp, pb):
    """The C entries' plane pointers, element strides and layout ints."""
    planes = (*meta, t_pos, t_len, t_dist, t_valid)
    ptrs = (ctypes.c_void_p * len(planes))(*(t.data_ptr() for t in planes))
    strides = (ctypes.c_longlong * (2 * len(planes)))(
        *(s for t in planes for s in t.stride()))
    layout = (ctypes.c_int * (len(LAYOUT_FIELDS) + 3))(*layout_ints(lc, lp, pb))
    return ptrs, strides, layout


def _raise_on_status(scratch, max_bits: int):
    """The plain version's ValueError for the status word the kernel left
    in the scratch's first 4 bytes (one readback)."""
    status = int(scratch[:4].view(torch.int32).item())
    if status & _TOTAL_OVER:
        raise ValueError(f"token bits exceed the {max_bits}-entry stream")
    if status & _LONG_OVER:
        raise ValueError("long tokens overflow the compacted lowering buffer")
