"""The optimal-parse DP scan as CUDA kernels (``csrc/dp_parse.cu``,
``csrc/dp_parse2.cu``).

Counterparts of K3 and K4, ``lzma_tpu/ops/device_parser.py``
``dp_parse_pallas`` and ``dp_parse_pallas2``: ``dp_parse_cuda`` (K3, a
finalize step and a history band) and ``dp_parse2_cuda`` (K4, node state
carried in the band) take the packed inputs of ``device_parser.dp_inputs``
and return the same (from, choice) planes.  A CUDA tensor launches the
kernel (or the wrapper raises); a CPU tensor takes the plain version of
both, ``device_parser.dp_parse_band``.  Each block's layout (rings, tiles
of staged rows, shared memory) is its plan's: ``dp_parse_plan`` (K3) and
``dp_parse2_plan`` (K4).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..runtime import build
from .device_parser import dp_parse_band, table_size

#: kernel launches made through dp_parse_cuda since the count was last set
LAUNCHES = 0
#: the same for dp_parse2_cuda
LAUNCHES2 = 0

#: packed rows a tile, staged into K3's and K4's shared memory
#: (csrc/dp_rows.cuh kTile)
TILE_ROWS = 64
#: candidate pairs a row K3 and K4 take at most (kMaxPairs)
MAX_PAIRS = 16
#: ints of a node's relax terms handed from K3's finalize warp to its
#: relax warps (csrc/dp_parse.cu kNodeVals)
NODE_VALS = 16
#: the largest fb at which K3 and K4 relax a length on 4 lanes, a lane a
#: pair (rows of at most 4 pairs; kSplitFb)
SPLIT_FB = 65


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def dp_parse_plan(fb: int, pb: int, C: int):
    """K3's block for fast bytes `fb`, pb and rows of C int32: (threads,
    B, H, shared bytes).  The relax threads own the lengths 2..fb, 4
    lanes a length (a lane a pair) at fb <= SPLIT_FB with at most 4
    pairs a row, else one thread, rounded up to warps; one more warp
    finalizes the next node while they relax; B >= fb + 2 and H >= fb + 1
    are the future and history rings, powers of two; the shared memory
    holds the table row, the rings (price, from, choice, kind; state, 4
    reps), two entries of NODE_VALS relax terms and two tiles of
    TILE_ROWS rows."""
    threads = _relax_threads(fb, C) + 32
    B, H = _pow2_at_least(fb + 2), _pow2_at_least(fb + 1)
    smem = 4 * (table_size(pb, fb) + 4 * B + 5 * H + 2 * NODE_VALS
                + 2 * TILE_ROWS * C)
    return threads, B, H, smem


def dp_parse2_plan(fb: int, pb: int, C: int):
    """K4's block for fast bytes `fb`, pb and rows of C int32: (threads,
    B, shared bytes).  The relax threads own the lengths 2..fb as in
    K3's plan; one more warp relaxes the literal/shortRep edge and writes
    the node's outputs; B >= fb + 1 is the future band, a power of two,
    whose slots carry each node's price, from, choice, state and 4 reps;
    the shared memory holds the table row, the band and two tiles of
    TILE_ROWS rows."""
    threads = _relax_threads(fb, C) + 32
    B = _pow2_at_least(fb + 1)
    smem = 4 * (table_size(pb, fb) + 8 * B + 2 * TILE_ROWS * C)
    return threads, B, smem


def _relax_threads(fb: int, C: int) -> int:
    """The relax warps' threads: 4 lanes a length 2..fb (a lane a pair)
    at fb <= SPLIT_FB with at most 4 pairs a row, else one, rounded up to
    warps."""
    split = 4 if fb <= SPLIT_FB and (C - 5) // 6 <= 4 else 1
    return (split * (fb - 1) + 31) // 32 * 32


@functools.cache
def _kernel(name: str):
    fn = getattr(build.load(), name)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(packed, tables, lens, fb, pb):
    if not (5 <= fb <= 273 and 0 <= pb <= 4):
        raise ValueError(f"fb must be in 5..273 and pb in 0..4, got {fb}, {pb}")
    if packed.dim() != 3 or (packed.shape[2] - 5) % 6 or packed.shape[2] < 11:
        raise ValueError(f"packed must be (L, N, 6M+5), got {tuple(packed.shape)}")
    L = packed.shape[0]
    if tables.shape != (L, table_size(pb, fb)) or lens.shape != (L,):
        raise ValueError(f"shapes: tables {tuple(tables.shape)}, lens "
                         f"{tuple(lens.shape)} for {L} lanes, pb {pb}, fb {fb}")
    for name, t in (("packed", packed), ("tables", tables), ("lens", lens)):
        if t.device != packed.device:
            raise ValueError(f"{name} is on {t.device}, packed on {packed.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(name: str, packed, tables, lens, fb: int, pb: int):
    if packed.device.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {packed.device}")
    if packed.dim() == 3 and (packed.shape[2] - 5) // 6 > MAX_PAIRS:
        raise ValueError(f"{name} takes at most {MAX_PAIRS} pairs a row, got "
                         f"{(packed.shape[2] - 5) // 6}")
    _check(packed, tables, lens, fb, pb)
    L, N, C = packed.shape
    dev = packed.device
    out_from = torch.empty((L, N + 1), dtype=torch.int32, device=dev)
    out_choice = torch.empty((L, N + 1), dtype=torch.int32, device=dev)
    fn = _kernel(f"lzt_{name}")
    plan = (dp_parse_plan(fb, pb, C)[1:] if name == "dp_parse"
            else dp_parse2_plan(fb, pb, C))
    with torch.cuda.device(dev):
        err = fn(packed.data_ptr(), tables.data_ptr(), lens.data_ptr(),
                 out_from.data_ptr(), out_choice.data_ptr(), L, N, C,
                 (C - 5) // 6, fb, pb, tables.shape[1], *plan,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out_from, out_choice


def dp_parse_cuda(packed, tables, lens, fb: int, pb: int):
    """The scan over positions, one lane per block (K3).  packed (L, N,
    6M+5), tables (L, T), lens (L,), all int32 (``device_parser.dp_inputs``).
    Returns (from, choice), each (L, N + 1) int32."""
    global LAUNCHES
    if packed.device.type == "cpu":
        return dp_parse_band(packed, tables, lens, fb, pb)
    out = _launch("dp_parse", packed, tables, lens, fb, pb)
    LAUNCHES += 1
    return out


def dp_parse2_cuda(packed, tables, lens, fb: int, pb: int):
    """The same scan with each node's state and reps carried in the band
    (K4): the same arguments, results and bound on the pairs a row as
    ``dp_parse_cuda``."""
    global LAUNCHES2
    if packed.device.type == "cpu":
        return dp_parse_band(packed, tables, lens, fb, pb)
    out = _launch("dp_parse2", packed, tables, lens, fb, pb)
    LAUNCHES2 += 1
    return out
