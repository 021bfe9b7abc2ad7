"""The optimal rounds' price model as a CUDA kernel (K18,
``csrc/price_model.cu``, on the closed forms of ``csrc/price_model.cuh``).

K18 is the counterpart of the position-free half of the price model in
``lzma_tpu/ops/device_parser.py``'s ``tokenize_optimal``, jitted JAX
device code (no ``pallas_call``) that XLA compiles for the device:
``empirical_probs``' arithmetic after its scatter-adds and
``build_price_model``'s planes and tables (``lit_cost`` and
``mlit_cost`` are K12's).  ``price_model_cuda`` replaces
``device_parser._price_model_plain`` (``probs_from_counts`` ->
``_price_planes`` -> ``price_tables`` -> ``_dp_tables``, some 400 small
operations a call): from the slot counts n, n1 of K8 (``lower_counts``)
one launch writes the two price planes, the distance tables K12 reads
and the DP tables' row K3 and K4 read, int32.  A block a lane prices the
slots before the literal coders in shared memory and walks each table
entry's bit tree there; the other blocks walk the planes, four slots a
thread.

A CUDA tensor launches the kernel (or the wrapper raises); a CPU tensor
takes the plain version.  The outputs are the plain version's, bit for
bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.layout import ProbLayout
from ..runtime import build
from .device_parser import _price_model_plain, table_size

#: kernel launches made through price_model_cuda (K18) since the count was
#: last set
LAUNCHES = 0

#: a lane's distance tables as K18 writes them and K12 reads them:
#: ps_price (4, 64), dfull (4, 128), align_price (16)
DIST_ENTRIES = 4 * 64 + 4 * 128 + 16

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _lib():
    lib = build.load()
    lib.lzt_price_model.argtypes = [_P, _P, _I, _L, _I, _I, _I, _I] + [_P] * 5
    lib.lzt_price_model.restype = ctypes.c_int
    return lib


@functools.cache
def _arena(lc: int, lp: int, pb: int) -> int:
    return ProbLayout(lc, lp, pb, pos_bits=pb).size


def _check(n, n1, lc: int, lp: int, pb: int, fb: int):
    if not (0 <= lc <= 8 and 0 <= lp <= 4 and 0 <= pb <= 4):
        raise ValueError(f"lc, lp, pb must be in 0..8, 0..4, 0..4, got "
                         f"{lc}, {lp}, {pb}")
    if not 2 <= fb <= 273:
        raise ValueError(f"fb must be in 2..273, got {fb}")
    S = _arena(lc, lp, pb)
    for name, t in (("n", n), ("n1", n1)):
        if t.dim() != 2 or t.shape[1] != S or t.shape != n.shape \
                or t.device != n.device:
            raise ValueError(f"{name} must be (L, {S}) (lc{lc} lp{lp} pb{pb}'s "
                             f"arena) on {n.device}, got {tuple(t.shape)} on "
                             f"{t.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 (K8's counts), got {t.dtype}")


def price_model_cuda(n, n1, lc: int, lp: int, pb: int, fb: int):
    """The price model of one optimal round (K18) from its slot counts n,
    n1 (L, S) int32 (``lower_counts``): returns (EP0, EP1 (L, S),
    ps_price (L, 4, 64), dfull (L, 4, 128), align_price (L, 16), the DP
    tables' row (L, table_size(pb, fb))), int32, as
    ``_price_model_plain``.  The planes and the distance tables are views
    of one allocation (K12 takes them together), the row another (the
    scans keep it past the planes)."""
    global LAUNCHES
    if n.device.type == "cpu":
        return _price_model_plain(n, n1, lc, lp, pb, fb)
    if n.device.type != "cuda":
        raise ValueError(f"price_model_cuda takes CPU or CUDA tensors, got "
                         f"{n.device}")
    _check(n, n1, lc, lp, pb, fb)
    L, S = n.shape
    dev = n.device
    n, n1 = n.contiguous(), n1.contiguous()
    # ep0, ep1, dist, each starting on a 16-byte boundary
    plane = -(-L * S // 4) * 4
    buf = torch.empty(2 * plane + L * DIST_ENTRIES, dtype=torch.int32,
                      device=dev)
    ep0 = buf[:L * S].view(L, S)
    ep1 = buf[plane:plane + L * S].view(L, S)
    dist = buf[2 * plane:].view(L, DIST_ENTRIES)
    rows = torch.empty((L, table_size(pb, fb)), dtype=torch.int32, device=dev)
    if L:
        with torch.cuda.device(dev):
            err = _lib().lzt_price_model(
                n.data_ptr(), n1.data_ptr(), L, S, lc, lp, pb, fb,
                ep0.data_ptr(), ep1.data_ptr(), dist.data_ptr(),
                rows.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"price_model launch failed: CUDA error {err}")
        LAUNCHES += 1
    return (ep0, ep1, dist[:, :256].view(L, 4, 64),
            dist[:, 256:768].view(L, 4, 128), dist[:, 768:], rows)
