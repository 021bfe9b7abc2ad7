"""The optimal parse's candidate search as CUDA kernels (``csrc/search.cu``,
on the per-position closed forms of ``csrc/search_list.cuh``): the sort
keys (K9), the suffix rank and LCP min table (K10) and the per-position
match lists (K11).

They are the counterparts of ``lzma_tpu/ops/device_matcher.py``'s
``_rmq_search`` between and around its sorts, jitted JAX device code
(no ``pallas_call``) that XLA compiles for the device; the sorts stay
``torch.sort``.  ``device_matcher._rmq_search`` (and through it the
optimal parse, the hybrid, the trace dump, the mesh and the file codec)
and ``_suffix_rank_lcp`` (the lazy parse's 273-deep table: K10 only)
call these wrappers:

- ``search_keys_cuda`` (K9) replaces ``_search_keys_plain``: the suffix
  lexsort's packed int64 keys and each used tier's int32 hash key;
- ``suffix_table_cuda`` (K10) replaces ``_suffix_table_plain``: rank and
  the (N, levels, max_n) table: T[0] from each place's window in 32-bit
  words, levels 1-11 in 2,048-place tiles, the wider ones by column
  stripes or a pass a level (``upper_route``);
- ``match_lists_cuda`` (K11) replaces ``_match_lists_plain``: the tiers'
  inverse orders, then a thread a position gathers its candidates tier
  by tier into a row in shared memory, then takes their dedup and cap,
  exact lengths and merge;
- ``list_pairs_cuda`` (K21) replaces ``device_parser._list_pairs_plain``
  (``_select_dp_pairs``' clone and gathers and the head of
  ``_seed_from_lists``, its gathers of the lists' last entries again):
  a thread a position reads its count, its lists' first M_DP entries and
  their last once and writes the DP pairs and the seed's pair.

A CUDA tensor launches the kernel (or the wrapper raises); a CPU tensor
takes the plain version.  Every output is the plain version's, bit for
bit, in its dtype.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..runtime import build
from ..runtime.card import smem_limit
from .device_matcher import (TIER_SPANS, _match_lists_plain,
                             _search_keys_plain, _suffix_table_plain)

#: kernel launches made through search_keys_cuda (K9) since the count was
#: last set
KEYS_LAUNCHES = 0
#: kernel launches made through suffix_table_cuda (K10)
TABLE_LAUNCHES = 0
#: kernel launches made through match_lists_cuda (K11)
LIST_LAUNCHES = 0
#: kernel launches made through list_pairs_cuda (K21)
PAIR_LAUNCHES = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _lib():
    lib = build.load()
    lib.lzt_search_keys.argtypes = [_P, _P, _I, _L, _I, _I, _P, _P, _P]
    lib.lzt_suffix_table.argtypes = [_P, _P, _P, _P, _I, _L, _I, _I, _I, _P,
                                     _P, _P]
    lib.lzt_match_lists.argtypes = [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I,
                                    _P, _P, _I, _P, _L, _I, _L, _P, _P, _P,
                                    _P]
    lib.lzt_list_pairs.argtypes = [_P, _P, _P, _I, _I, _L] + [_P] * 5
    for fn in (lib.lzt_search_keys, lib.lzt_suffix_table, lib.lzt_match_lists,
               lib.lzt_list_pairs):
        fn.restype = ctypes.c_int
    return lib


def _on_card(name: str, t) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {t.device}")
    return True


def _check_lanes(data, n):
    if data.dim() != 2 or data.dtype != torch.uint8:
        raise ValueError(f"data must be (N, max_n) uint8, got "
                         f"{tuple(data.shape)} {data.dtype}")
    if n.shape != (data.shape[0],) or n.device != data.device:
        raise ValueError(f"n must be ({data.shape[0]},) on {data.device}, got "
                         f"{tuple(n.shape)} on {n.device}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _raise(name: str, err: int):
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def levels_of(max_n: int) -> int:
    """The sparse min table's levels for lanes of max_n positions."""
    return max(1, (max_n - 1).bit_length())


#: K10's tiles (csrc/search.cu kTile): places a block of levels 1..TILE_LEVELS
TILE, TILE_LEVELS = 2048, 11
#: a stripe's shared bytes K10 keeps to while it can take fewer columns
STRIPE_BYTES = 64 * 1024


def upper_route(max_n: int, limit: int):
    """How K10 builds the levels past its tiles' for lanes of max_n
    places on a card that gives a block `limit` shared bytes: ("tile",
    0) where there are none; ("stripes", cols) where max_n is a multiple
    of TILE, its rows max_n / TILE of a stripe of cols columns (32, or 16
    or 8 to keep two levels of the stripe within STRIPE_BYTES) fitting
    `limit`; else ("levels", 0), a pass a level."""
    if levels_of(max_n) - 1 <= TILE_LEVELS:
        return "tile", 0
    if max_n % TILE:
        return "levels", 0
    rows, cols = max_n // TILE, 32
    while cols > 8 and 8 * rows * cols > STRIPE_BYTES:
        cols //= 2
    return ("stripes", cols) if 8 * rows * cols <= limit else ("levels", 0)


def search_keys_cuda(data, n, depth: int, spans):
    """The sort keys of the search (K9): for depth <= 32 the suffix
    order's ceil(ceil(depth / 4) / 2) packed int64 keys (none past 32),
    and an int32 hash key for each of `spans` (tier spans, ascending, out
    of TIER_SPANS).  data (N, max_n) uint8, n (N,).  Returns (suffix
    keys, tier keys), lists of (N, max_n) planes, as
    ``_search_keys_plain``."""
    global KEYS_LAUNCHES
    if not _on_card("search_keys_cuda", data):
        return _search_keys_plain(data, n, depth, spans)
    _check_lanes(data, n)
    spans = list(spans)
    if spans != sorted(set(spans)) or not set(spans) <= set(TIER_SPANS):
        raise ValueError(f"spans must be ascending and out of {TIER_SPANS}, "
                         f"got {spans}")
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    N, max_n = data.shape
    dev = data.device
    nw = -(-depth // 4) if depth <= 32 else 0
    suffix = torch.empty(((nw + 1) // 2, N, max_n), dtype=torch.int64,
                         device=dev)
    tiers = torch.empty((len(spans), N, max_n), dtype=torch.int32, device=dev)
    if N and max_n and (nw or spans):
        mask = sum(1 << TIER_SPANS.index(s) for s in spans)
        data = data.contiguous()
        n = n.to(torch.int64).contiguous()
        with torch.cuda.device(dev):
            err = _lib().lzt_search_keys(
                data.data_ptr(), n.data_ptr(), N, max_n, nw, mask,
                suffix.data_ptr(), tiers.data_ptr(), _stream(dev))
        _raise("search_keys", err)
        KEYS_LAUNCHES += 1
    return list(suffix.unbind(0)), list(tiers.unbind(0))


def suffix_table_cuda(data, n, order, depth: int, cl=None):
    """Rank and the consecutive-LCP sparse min table from the suffix order
    (K10): rank (N, max_n) int64 and T (N, levels, max_n) int32,
    levels = max(1, bit_length(max_n - 1)), as ``_suffix_table_plain``.
    `cl` (N, max_n), the consecutive LCP by place, is given past depth 32;
    at or below it the kernel compares the prefix words itself."""
    global TABLE_LAUNCHES
    if not _on_card("suffix_table_cuda", order):
        return _suffix_table_plain(data, n, order, depth, cl)
    _check_lanes(data, n)
    N, max_n = data.shape
    if order.shape != (N, max_n) or order.device != data.device:
        raise ValueError(f"order must be ({N}, {max_n}) on {data.device}, got "
                         f"{tuple(order.shape)} on {order.device}")
    if cl is None and depth > 32:
        raise ValueError(f"past depth 32 the consecutive LCP is given, got "
                         f"none at depth {depth}")
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    dev = data.device
    levels = levels_of(max_n)
    rank = torch.empty((N, max_n), dtype=torch.int64, device=dev)
    T = torch.empty((N, levels, max_n), dtype=torch.int32, device=dev)
    if N and max_n:
        _, cols = upper_route(max_n, smem_limit(
            dev.index if dev.index is not None else torch.cuda.current_device()))
        data = data.contiguous()
        n = n.to(torch.int64).contiguous()
        order = order.to(torch.int64).contiguous()
        if cl is not None:
            cl = cl.to(torch.int64).contiguous()
        with torch.cuda.device(dev):
            err = _lib().lzt_suffix_table(
                data.data_ptr(), n.data_ptr(), order.data_ptr(),
                None if cl is None else cl.data_ptr(), N, max_n, depth,
                levels, cols, rank.data_ptr(), T.data_ptr(), _stream(dev))
        _raise("suffix_table", err)
        TABLE_LAUNCHES += 1
    return rank, T


def list_columns(ranks, m_cap: int, m_cap_order: str):
    """The candidates' (tier, rank) pairs in the order K11 takes them, and
    whether it keeps the first m_cap ("rr", the round-robin order: every
    tier's first rank, then every tier's second, ...) or the m_cap nearest
    (the column order).  `ranks`: ``tier_ranks``' list; a tier is its
    place among those with ranks.  Returns (cols, rr, width): the lists'
    width is m_cap where 0 < m_cap < M, else M."""
    used = [r for _, r in ranks if r]
    M = sum(len(r) for r in used)
    rr = m_cap_order == "rr" and 0 < m_cap < M
    if rr:
        cols = [(t, r[i]) for i in range(max(len(r) for r in used))
                for t, r in enumerate(used) if i < len(r)]
    else:
        cols = [(t, j) for t, r in enumerate(used) for j in r]
    return cols, rr, m_cap if 0 < m_cap < M else M


def tier_columns(cols, n_tiers: int):
    """K11's columns as its gather takes them, tier by tier: the (rank,
    column) pairs of ``list_columns``' cols grouped by tier, the column a
    pair's index in cols, where each tier's pairs start (n_tiers + 1
    offsets) and each tier's largest rank."""
    grouped = [(j, c) for t in range(n_tiers)
               for c, (tt, j) in enumerate(cols) if tt == t]
    start = [0]
    for t in range(n_tiers):
        start.append(start[-1] + sum(1 for tt, _ in cols if tt == t))
    top = [max((j for tt, j in cols if tt == t), default=0)
           for t in range(n_tiers)]
    return grouped, start, top


def match_lists_cuda(sorted_keys, orders, ranks, rank, T, n, dict_size: int,
                     m_cap: int, m_cap_order: str):
    """Each position's ascending (len, dist) list (K11), as
    ``_match_lists_plain``: sorted_keys, orders, the stable sort values
    (int32) and indices (int64) of each tier of `ranks` that has ranks
    (the lists are emptied as the plain version empties them); rank, T
    K10's; n (N,).  Returns (lens, dists) (N, max_n, width) int64 and
    counts (N, max_n) int64."""
    global LIST_LAUNCHES
    if not _on_card("match_lists_cuda", rank):
        return _match_lists_plain(sorted_keys, orders, ranks, rank, T, n,
                                  dict_size, m_cap, m_cap_order)
    cols, rr, width = list_columns(ranks, m_cap, m_cap_order)
    nt = len(sorted_keys)
    if not cols:
        raise ValueError("the tiers have no ranks: there are no candidates")
    if nt != len(orders) or nt != sum(1 for _, r in ranks if r):
        raise ValueError(f"{nt} sorted tiers and {len(orders)} orders for "
                         f"{sum(1 for _, r in ranks if r)} tiers with ranks")
    N, max_n = rank.shape
    dev = rank.device
    levels = levels_of(max_n)
    if T.shape != (N, levels, max_n) or T.dtype != torch.int32:
        raise ValueError(f"T must be ({N}, {levels}, {max_n}) int32, got "
                         f"{tuple(T.shape)} {T.dtype}")
    planes = [k.to(torch.int32).contiguous() for k in sorted_keys]
    idx = [o.to(torch.int64).contiguous() for o in orders]
    sorted_keys.clear()
    orders.clear()
    for p in (*planes, *idx):
        if p.shape != (N, max_n) or p.device != dev:
            raise ValueError(f"a tier plane is {tuple(p.shape)} on {p.device}, "
                             f"not ({N}, {max_n}) on {dev}")
    lens = torch.empty((N, max_n, width), dtype=torch.int64, device=dev)
    dists = torch.empty((N, max_n, width), dtype=torch.int64, device=dev)
    counts = torch.empty((N, max_n), dtype=torch.int64, device=dev)
    if N and max_n:
        rank = rank.to(torch.int64).contiguous()
        T = T.contiguous()
        n = n.to(device=dev, dtype=torch.int64).contiguous()
        inv = torch.empty((nt, N, max_n), dtype=torch.int32, device=dev)
        grouped, start, top = tier_columns(cols, nt)
        col_t = torch.tensor(grouped, dtype=torch.int32).reshape(-1).to(dev)
        starts = (ctypes.c_int * (nt + 1))(*start)
        tops = (ctypes.c_int * nt)(*top)
        ptrs = (ctypes.c_void_p * nt)(*(p.data_ptr() for p in planes))
        optrs = (ctypes.c_void_p * nt)(*(o.data_ptr() for o in idx))
        with torch.cuda.device(dev):
            err = _lib().lzt_match_lists(
                ptrs, optrs, nt, inv.data_ptr(), col_t.data_ptr(), starts,
                tops, len(cols), int(rr), width, rank.data_ptr(), T.data_ptr(),
                levels, n.data_ptr(), int(dict_size), N, max_n,
                lens.data_ptr(), dists.data_ptr(), counts.data_ptr(),
                _stream(dev))
        _raise("match_lists", err)
        LIST_LAUNCHES += 1
    return lens, dists, counts


def list_pairs_cuda(cl, cd, counts):
    """The optimal round's DP pairs and the seed's pairs from K11's lists
    (K21): cl, cd (L, N, width) int64, width > M_DP; counts (L, N) int64.
    Returns (ld, dd) (L, N, M_DP) and (bl, bd) (L, N), int64, as
    ``device_parser._list_pairs_plain``."""
    global PAIR_LAUNCHES
    from .device_parser import M_DP, _list_pairs_plain

    if not _on_card("list_pairs_cuda", cl):
        return _list_pairs_plain(cl, cd, counts)
    if cl.dim() != 3 or cl.shape[2] <= M_DP:
        raise ValueError(f"the lists must be (L, N, width), width > {M_DP}, "
                         f"got {tuple(cl.shape)}")
    L, N, width = cl.shape
    dev = cl.device
    for name, t, shape in (("cl", cl, (L, N, width)), ("cd", cd, (L, N, width)),
                           ("counts", counts, (L, N))):
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{name} must be {shape} on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
        if t.dtype != torch.int64:
            raise TypeError(f"{name} must be int64 (K11's), got {t.dtype}")
    pairs = torch.empty((2, L, N, M_DP), dtype=torch.int64, device=dev)
    seed = torch.empty((2, L, N), dtype=torch.int64, device=dev)
    if L and N:
        cl, cd, counts = cl.contiguous(), cd.contiguous(), counts.contiguous()
        with torch.cuda.device(dev):
            err = _lib().lzt_list_pairs(
                cl.data_ptr(), cd.data_ptr(), counts.data_ptr(), width, M_DP,
                L * N, pairs[0].data_ptr(), pairs[1].data_ptr(),
                seed[0].data_ptr(), seed[1].data_ptr(), _stream(dev))
        _raise("list_pairs", err)
        PAIR_LAUNCHES += 1
    return (*pairs.unbind(0), *seed.unbind(0))
