"""The optimal parse's DP rows as a CUDA kernel (K12, ``csrc/dp_inputs.cu``,
on the per-position closed form of ``csrc/dp_input_row.cuh``), and the
rep0 trace those rows read (K20, ``csrc/rep0.cu`` on ``csrc/rep0.cuh``).

K12 is the counterpart of the per-position half of the price model in
``lzma_tpu/ops/device_parser.py``'s ``tokenize_optimal``, jitted JAX
device code (no ``pallas_call``) that XLA compiles for the device:
``build_price_model``'s ``lit_cost`` and ``matched_lit_cost``,
``_pair_dist_cost``, ``device_matcher.rep_match_lens_rmq`` and
``_pack_inputs``.  ``dp_inputs_cuda`` replaces
``device_parser._dp_inputs_plain``: each position's int32 row of 6M + 5
entries, written once (no int64 row on the card).  A block stages the
lane's distance tables in shared memory and reads the literal coders'
price slots of the two planes through L1 (staged in shared memory as
well, they were no faster: a block's shared bytes come out of the SM's
L1, which holds the rows' other reads; PERF.md, section 6).

K20 is the counterpart of ``device_parser.py``'s ``rep0_trace``, jitted
JAX device code (no ``pallas_call``): ``rep0_trace_cuda`` replaces the
plain ``device_parser.rep0_trace`` (two (L, N + 1) int64 scatters, a
cummax and a gather) by a fill from the token side in three grids, one
call; it takes the valid tokens at strictly ascending t_pos >= 0 (each
round's tokens are K14's compaction) and raises ValueError where they
are not (``device_parser.check_rep0_order``'s error).

A CUDA tensor launches the kernel (or the wrapper raises); a CPU tensor
takes the plain version.  The rows are the plain version's, bit for bit,
and so is the trace.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.layout import LITERAL_CODER_SIZE, ProbLayout
from ..runtime import build
from .device_parser import REP0_ORDER, _dp_inputs_plain, rep0_trace

#: kernel launches made through dp_inputs_cuda (K12) since the count was
#: last set
LAUNCHES = 0
#: kernel launches made through rep0_trace_cuda (K20)
REP0_LAUNCHES = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: a lane's distance tables as the kernel reads them: ps_price (4, 64),
#: dfull (4, 128), align_price (16)
_TABLE_SHAPES = ((4, 64), (4, 128), (16,))


@functools.cache
def _lib():
    lib = build.load()
    lib.lzt_dp_inputs.argtypes = [_P] * 6 + [_I] + [_P] * 3 + [_L] * 3 + [
        _P, _I, _L, _I, _I, _I, _P, _P]
    lib.lzt_dp_inputs.restype = ctypes.c_int
    lib.lzt_dp_inputs_smem.argtypes = [_I]
    lib.lzt_dp_inputs_smem.restype = ctypes.c_longlong
    lib.lzt_dp_inputs_occupancy.argtypes = [_I]
    lib.lzt_dp_inputs_occupancy.restype = ctypes.c_int
    lib.lzt_rep0_trace.argtypes = [_P] * 4 + [_I, _I, _L, _P, _P, _P]
    lib.lzt_rep0_trace.restype = ctypes.c_int
    lib.lzt_rep0_scratch.argtypes = [_I, _I]
    lib.lzt_rep0_scratch.restype = ctypes.c_longlong
    return lib


def lit_slots(lc: int, lp: int) -> int:
    """A lane's literal coders' slots: LITERAL_CODER_SIZE << (lc + lp)."""
    return LITERAL_CODER_SIZE << (lc + lp)


#: K12's block: positions a tile (its threads; csrc/dp_inputs.cu kThreads)
TILE_ROWS = 256


#: a lane's distance tables: ps_price (4 x 64), dfull (4 x 128),
#: align_price (16) entries
TABLE_ENTRIES = 4 * 64 + 4 * 128 + 16


def smem_bytes(m: int) -> int:
    """Shared bytes of a K12 block for rows of m pairs: the row stage (and
    4 words to align it) and the distance tables, int32
    (lzt_dp_inputs_smem's count)."""
    return 4 * (TILE_ROWS * (6 * m + 5) + 4 + TABLE_ENTRIES)


def occupancy(m: int) -> int:
    """K12's blocks an SM on this card for rows of m pairs: its grid's
    four, or fewer where the runtime's occupancy query fits fewer."""
    return _lib().lzt_dp_inputs_occupancy(m)


def _check(data, ld, dd, r0pos, suffix, lens, planes, dist_tables):
    if data.dim() != 2 or data.dtype != torch.uint8:
        raise ValueError(f"data must be (L, N) uint8, got "
                         f"{tuple(data.shape)} {data.dtype}")
    L, N = data.shape
    dev = data.device
    if ld.dim() != 3 or ld.shape[2] < 1:
        raise ValueError(f"ld must be (L, N, M), M >= 1, got {tuple(ld.shape)}")
    rank, T = suffix
    M = ld.shape[2]
    S = planes[0].shape[-1]
    want = [("ld", ld, (L, N, M)), ("dd", dd, (L, N, M)),
            ("r0pos", r0pos, (L, N)), ("rank", rank, (L, N)),
            ("lens", lens, (L,)), ("EP0", planes[0], (L, S)),
            ("EP1", planes[1], (L, S))]
    want += [(name, t, (L, *shape)) for name, t, shape in zip(
        ("ps_price", "dfull", "align_price"), dist_tables, _TABLE_SHAPES)]
    for name, t, shape in want:
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{name} must be {shape} on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
        if t.is_floating_point() or t.dtype == torch.bool:
            raise TypeError(f"{name} must be an integer tensor, got {t.dtype}")
    if T.dim() != 3 or T.shape[0] != L or T.shape[2] != N or T.shape[1] < 1 \
            or T.dtype != torch.int32 or T.device != dev:
        raise ValueError(f"T must be ({L}, levels, {N}) int32 on {dev}, got "
                         f"{tuple(T.shape)} {T.dtype} on {T.device}")


def dp_inputs_cuda(data, ld, dd, r0pos, suffix, lens, planes, dist_tables,
                   lc: int, lp: int, pb: int, fb: int):
    """The DP scan's rows (K12): data (L, N) uint8; ld, dd (L, N, M) the
    candidate pairs; r0pos (L, N) the rep0 trace; suffix = (rank (L, N),
    T (L, levels, N) int32), the search's suffix table; lens (L,); planes
    = (EP0, EP1) (L, S), the price of a 0 and of a 1 at each slot;
    dist_tables = (ps_price (L, 4, 64), dfull (L, 4, 128), align_price
    (L, 16)).  Returns packed (L, N, 6M + 5) int32, as
    ``_dp_inputs_plain``."""
    global LAUNCHES
    if data.device.type == "cpu":
        return _dp_inputs_plain(data, ld, dd, r0pos, suffix, lens, planes,
                                dist_tables, lc, lp, pb, fb)
    if data.device.type != "cuda":
        raise ValueError(f"dp_inputs_cuda takes CPU or CUDA tensors, got "
                         f"{data.device}")
    _check(data, ld, dd, r0pos, suffix, lens, planes, dist_tables)
    L, N, M = ld.shape
    dev = data.device
    out = torch.empty((L, N, 6 * M + 5), dtype=torch.int32, device=dev)
    if L == 0 or N == 0:
        return out
    layout = ProbLayout(lc, lp, pb, pos_bits=pb)
    slots = lit_slots(lc, lp)
    S = planes[0].shape[1]
    if layout.literal + slots > S:
        raise ValueError(f"the planes hold {S} slots, lc{lc} lp{lp} pb{pb}'s "
                         f"literal coders end at {layout.literal + slots}")
    rank, T = suffix
    i64 = [t.to(torch.int64).contiguous() for t in (ld, dd, r0pos, rank, lens)]
    ep = [t.to(torch.int32).contiguous() for t in planes]
    tables = torch.cat([t.reshape(L, -1) for t in dist_tables],
                       dim=1).to(torch.int32).contiguous()
    data = data.contiguous()
    T = T.contiguous()
    with torch.cuda.device(dev):
        err = _lib().lzt_dp_inputs(
            data.data_ptr(), i64[0].data_ptr(), i64[1].data_ptr(),
            i64[2].data_ptr(), i64[3].data_ptr(), T.data_ptr(), T.shape[1],
            i64[4].data_ptr(), ep[0].data_ptr(), ep[1].data_ptr(), S,
            layout.literal, slots, tables.data_ptr(), L, N, M, lc, lp,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"dp_inputs launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def rep0_trace_cuda(t_pos, t_dist, t_valid, N: int):
    """The rep0 in effect at every position (K20): t_pos, t_dist, t_valid
    (L, T) a round's tokens.  Returns r0pos (L, N) int64, as
    ``device_parser.rep0_trace``; raises ValueError where a lane's valid
    tokens do not lie at strictly ascending t_pos >= 0."""
    global REP0_LAUNCHES
    if t_pos.device.type == "cpu":
        return rep0_trace(t_pos, t_dist, t_valid, N)
    if t_pos.device.type != "cuda":
        raise ValueError(f"rep0_trace_cuda takes CPU or CUDA tensors, got "
                         f"{t_pos.device}")
    if t_pos.dim() != 2:
        raise ValueError(f"t_pos must be (L, T), got {tuple(t_pos.shape)}")
    for name, t in (("t_dist", t_dist), ("t_valid", t_valid)):
        if t.shape != t_pos.shape or t.device != t_pos.device:
            raise ValueError(f"{name} must be {tuple(t_pos.shape)} on "
                             f"{t_pos.device}, got {tuple(t.shape)} on "
                             f"{t.device}")
    for name, t in (("t_pos", t_pos), ("t_dist", t_dist)):
        if t.is_floating_point() or t.dtype == torch.bool:
            raise TypeError(f"{name} must be an integer tensor, got {t.dtype}")
    if not 0 <= N < 1 << 31:
        raise ValueError(f"N must be in [0, 2**31), got {N}")
    L, T = t_pos.shape
    dev = t_pos.device
    out = torch.empty((L, N), dtype=torch.int64, device=dev)
    if L == 0 or N == 0:
        return out
    planes = (t_pos.long(), t_dist.long(), t_valid.bool())
    # each plane's (slot, lane) strides: its T axis's, then its L axis's
    strides = (ctypes.c_longlong * 6)(*(s for p in planes
                                        for s in reversed(p.stride())))
    lib = _lib()
    scratch = torch.empty((int(lib.lzt_rep0_scratch(L, T)),),
                          dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = lib.lzt_rep0_trace(*(p.data_ptr() for p in planes), strides, L,
                                 T, N, scratch.data_ptr(), out.data_ptr(),
                                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"rep0_trace launch failed: CUDA error {err}")
    REP0_LAUNCHES += 1
    if int(scratch[:4].view(torch.int32).item()):
        raise ValueError(REP0_ORDER)
    return out
