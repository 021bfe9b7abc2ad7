"""The lazy search's prefix doubling and best matches as CUDA kernels
(``csrc/lazy_search.cu``, on the closed forms of ``csrc/lazy_search.cuh``):
a doubling level's group ids (K15), the consecutive LCP at full depth
(K16) and each position's best match (K17).

They are the counterparts of ``lzma_tpu/ops/device_matcher.py``'s
``find_best_matches_rmq`` and its ``_suffix_rank_lcp`` past depth 32,
jitted JAX device code (no ``pallas_call``) that XLA compiles for the
device; the sorts between them stay ``torch.sort``, and K9 and K10
(``ops/cuda_search.py``) make the keys and the table.
``device_matcher.find_best_matches_rmq`` (and through it every lazy
tokenize: the lazy encode, the ``.lzma`` stream, the lazy hybrid, a
preset's lanes, the trace dump) and ``_suffix_rank_lcp`` (also the
optimal search's past fb 32) call these wrappers:

- ``doubling_groups_cuda`` (K15) replaces ``_doubling_groups_plain``: a
  level's ids from its sort's order (a doubling level's flags from its
  sorted key, which ``_suffix_rank_lcp`` passes as ``sorted_key``), then
  the next sort's key;
- ``descent_lcp_cuda`` (K16) replaces ``_descent_lcp_plain``: the
  consecutive LCP that K10 turns into the sparse min table;
- ``best_matches_cuda`` (K17) replaces ``_best_matches_plain``: a tile
  of the hash key's sort staged with its neighbours' positions and ranks,
  then a thread a place: its neighbours' exact lengths and the
  selection.

A CUDA tensor launches the kernel (or the wrapper raises); a CPU tensor
takes the plain version.  Every output is the plain version's, bit for
bit, in its dtype.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..runtime import build
from .cuda_search import _on_card, _raise, _stream, levels_of
from .device_matcher import (_best_matches_plain, _descent_lcp_plain,
                             _doubling_groups_plain)

#: kernel launches made through doubling_groups_cuda (K15) since the count
#: was last set
GROUP_LAUNCHES = 0
#: kernel launches made through descent_lcp_cuda (K16)
DESCENT_LAUNCHES = 0
#: kernel launches made through best_matches_cuda (K17)
BEST_LAUNCHES = 0

#: the group levels a descent reads and the neighbours a position takes
#: at most (csrc/lazy_search.cuh kMaxLevels, kMaxCandidates)
MAX_LEVELS = 8
MAX_CANDIDATES = 16
#: places a K15 tile, a block of grid A (csrc/lazy_search.cu kTile)
TILE = 512
#: places a lane K16 takes (csrc/lazy_search.cu kMaxPlaces: its indices
#: are 32-bit ints)
MAX_PLACES = 1 << 30
#: K16 in a lane wider than this (csrc/lazy_search.cuh kWideLane) compares
#: the first 32-byte keys first and reads no id where they differ
WIDE_LANE = 508

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _lib():
    lib = build.load()
    lib.lzt_doubling_groups.argtypes = [_P] * 4 + [_L, _I, _L] + [_P] * 4
    lib.lzt_doubling_groups_scratch.argtypes = [_I, _L]
    lib.lzt_descent_lcp.argtypes = [_P, _P, _I, _P, _P, _I, _I, _L, _P, _P]
    lib.lzt_best_matches.argtypes = [_P, _P, _P, _P, _I, _P, _L, _I, _I, _I,
                                     _L, _P, _P, _P]
    for fn in (lib.lzt_doubling_groups, lib.lzt_descent_lcp,
               lib.lzt_best_matches):
        fn.restype = ctypes.c_int
    lib.lzt_doubling_groups_scratch.restype = ctypes.c_longlong
    return lib


def _planes(name: str, shape, dev, **planes):
    """Each plane contiguous in its int dtype, after a shape check."""
    out = []
    for key, (t, dtype) in planes.items():
        if tuple(t.shape) != tuple(shape) or t.device != dev:
            raise ValueError(f"{name}: {key} must be {tuple(shape)} on {dev}, "
                             f"got {tuple(t.shape)} on {t.device}")
        out.append(t.to(dtype).contiguous())
    return out


def _lanes(name: str, data, n, dev):
    if data.dim() != 2 or data.dtype != torch.uint8:
        raise ValueError(f"{name}: data must be (N, max_n) uint8, got "
                         f"{tuple(data.shape)} {data.dtype}")
    if n.shape != (data.shape[0],) or n.device != dev:
        raise ValueError(f"{name}: n must be ({data.shape[0]},) on {dev}, got "
                         f"{tuple(n.shape)} on {n.device}")
    return data.contiguous(), n.to(torch.int64).contiguous()


def doubling_groups_cuda(order, data, n, g=None, span: int = 0,
                         next_span: int = 0, sorted_key=None):
    """A prefix-doubling level's group ids (K15), as
    ``_doubling_groups_plain``: order (N, max_n) the level's stable sort;
    `g` None for the 32-byte level (the prefix words of data (N, max_n)
    uint8, marked past n (N,)), else the previous level's ids and its
    `span`; `next_span` > 0 gives the next sort's key.  On the card a
    doubling level also takes `sorted_key` (N, max_n) int64, the values of
    the sort that gave `order` (the previous call's key, g[i] * max_n +
    g[(i + span) mod max_n], in its order): the kernel flags a new group
    where it differs from the place before's, which is where the
    reference's pair of gathered ids differs, and reads no id of `g`.
    Returns (ids (N, max_n) int64, key (N, max_n) int64 or None)."""
    global GROUP_LAUNCHES
    if not _on_card("doubling_groups_cuda", order):
        return _doubling_groups_plain(order, data, n, g, span, next_span,
                                      sorted_key)
    dev = order.device
    data, n = _lanes("doubling_groups_cuda", data, n, dev)
    N, max_n = data.shape
    (order,) = _planes("doubling_groups_cuda", (N, max_n), dev,
                       order=(order, torch.int64))
    if g is not None:
        (g,) = _planes("doubling_groups_cuda", (N, max_n), dev,
                       g=(g, torch.int64))
        if span < 1:
            raise ValueError(f"a doubling level's span must be >= 1, got {span}")
        if sorted_key is None:
            raise ValueError("doubling_groups_cuda: a doubling level takes "
                             "sorted_key, the values of its order's sort")
        (sorted_key,) = _planes("doubling_groups_cuda", (N, max_n), dev,
                                sorted_key=(sorted_key, torch.int64))
    else:
        sorted_key = None
    if next_span < 0:
        raise ValueError(f"next_span must be >= 0, got {next_span}")
    ids = torch.empty((N, max_n), dtype=torch.int64, device=dev)
    key = (torch.empty((N, max_n), dtype=torch.int64, device=dev)
           if next_span else None)
    if N and max_n:
        lib = _lib()
        scratch = torch.empty(
            (int(lib.lzt_doubling_groups_scratch(N, max_n)),),
            dtype=torch.uint8, device=dev)
        with torch.cuda.device(dev):
            err = lib.lzt_doubling_groups(
                order.data_ptr(), data.data_ptr(), n.data_ptr(),
                None if sorted_key is None else sorted_key.data_ptr(),
                int(next_span), N, max_n, scratch.data_ptr(), ids.data_ptr(),
                None if key is None else key.data_ptr(), _stream(dev))
        _raise("doubling_groups", err)
        GROUP_LAUNCHES += 1
    return ids, key


def descent_lcp_cuda(order, grps, data, n, depth: int):
    """The consecutive LCP at full depth in the final order (K16), as
    ``_descent_lcp_plain``: order (N, max_n); grps the doubling's levels
    (each (N, max_n), all but the last read; in a lane past WIDE_LANE
    places the kernel relies on their ids being equal exactly where the
    suffixes' marked keys are, and reads none where the first 32 bytes
    differ); data (N, max_n) uint8, n (N,).  Returns cl (N, max_n)
    int64."""
    global DESCENT_LAUNCHES
    if not _on_card("descent_lcp_cuda", order):
        return _descent_lcp_plain(order, grps, data, n, depth)
    dev = order.device
    data, n = _lanes("descent_lcp_cuda", data, n, dev)
    N, max_n = data.shape
    read = grps[:-1]
    if len(read) > MAX_LEVELS:
        raise ValueError(f"the descent reads at most {MAX_LEVELS} levels, "
                         f"got {len(read)}")
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    if max_n > MAX_PLACES:
        raise ValueError(f"descent_lcp_cuda takes lanes of at most "
                         f"{MAX_PLACES} places, got {max_n}")
    order, *levels = _planes(
        "descent_lcp_cuda", (N, max_n), dev, order=(order, torch.int64),
        **{f"grps[{t}]": (x, torch.int64) for t, x in enumerate(read)})
    cl = torch.empty((N, max_n), dtype=torch.int64, device=dev)
    if N and max_n:
        ptrs = (ctypes.c_void_p * max(1, len(levels)))(
            *(x.data_ptr() for x in levels))
        with torch.cuda.device(dev):
            err = _lib().lzt_descent_lcp(
                order.data_ptr(), ptrs, len(levels), data.data_ptr(),
                n.data_ptr(), int(depth), N, max_n, cl.data_ptr(),
                _stream(dev))
        _raise("descent_lcp", err)
        DESCENT_LAUNCHES += 1
    return cl


def best_matches_cuda(sorted_key, order, rank, T, n, dict_size: int, fb: int,
                      num_candidates: int):
    """Each position's best (length, distance) (K17), as
    ``_best_matches_plain``: sorted_key, order (N, max_n) the hash key's
    stable sort values (int32) and indices (the kernel takes a
    position's candidates as the run of equal keys just before its
    place); rank (N, max_n), T (N, levels, max_n) int32 the suffix table;
    n (N,).  Returns (best_len, best_dist) (N, max_n) int64."""
    global BEST_LAUNCHES
    if not _on_card("best_matches_cuda", order):
        return _best_matches_plain(sorted_key, order, rank, T, n, dict_size,
                                   fb, num_candidates)
    dev = order.device
    if order.dim() != 2:
        raise ValueError(f"order must be (N, max_n), got {tuple(order.shape)}")
    N, max_n = order.shape
    if not 1 <= num_candidates <= MAX_CANDIDATES:
        raise ValueError(f"num_candidates must be in [1, {MAX_CANDIDATES}], "
                         f"got {num_candidates}")
    levels = levels_of(max_n) if max_n else 1
    if T.shape != (N, levels, max_n) or T.dtype != torch.int32 \
            or T.device != dev:
        raise ValueError(f"T must be ({N}, {levels}, {max_n}) int32 on {dev}, "
                         f"got {tuple(T.shape)} {T.dtype} on {T.device}")
    sorted_key, order, rank = _planes(
        "best_matches_cuda", (N, max_n), dev,
        sorted_key=(sorted_key, torch.int32), order=(order, torch.int64),
        rank=(rank, torch.int64))
    (n,) = _planes("best_matches_cuda", (N,), dev, n=(n, torch.int64))
    T = T.contiguous()
    best_len = torch.empty((N, max_n), dtype=torch.int64, device=dev)
    best_dist = torch.empty((N, max_n), dtype=torch.int64, device=dev)
    if N and max_n:
        with torch.cuda.device(dev):
            err = _lib().lzt_best_matches(
                sorted_key.data_ptr(), order.data_ptr(), rank.data_ptr(),
                T.data_ptr(), levels, n.data_ptr(),
                int(dict_size), int(fb), int(num_candidates), N, max_n,
                best_len.data_ptr(), best_dist.data_ptr(), _stream(dev))
        _raise("best_matches", err)
        BEST_LAUNCHES += 1
    return best_len, best_dist
