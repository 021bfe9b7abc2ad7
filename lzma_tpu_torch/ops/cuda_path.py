"""The parse path's marking (K13) and compaction (K14) as CUDA kernels
(``csrc/path.cu``).

They are the counterparts of the pointer doubling and the prefix-sum
compaction in ``lzma_tpu/ops/device_parser.py``'s ``extract_tokens`` and
``lzma_tpu/ops/device_matcher.py``'s ``greedy_path`` and ``_compact``,
jitted JAX device code (no ``pallas_call``) that XLA compiles for the
device.  Every optimal encode runs them three times (the seed's lazy
path, then each round's DP path) and every lazy tokenize once:

- ``extract_mark_cuda`` (K13) replaces ``device_parser._extract_mark``
  and ``greedy_mark_cuda`` (K13) ``device_matcher._greedy_mark``: the
  nodes a lane's walk reaches from its start node, backward over the DP's
  from pointers or forward over pos + adv.  What holds it on the card is
  the walk's dependence, not its bytes: the kernel gives each tile of
  4,096 nodes a door map (where the walk leaves the tile from each of the
  288 nodes it can enter by, a hop being at most 273 long, from each
  node's segment exit found in windows of 32 nodes a warp, with no
  doubling rounds), composes the maps along the lane for each tile's
  entry (in groups of 128 tiles on the stream's long lane) and marks each
  tile from its entry, a lane walking each segment of 512 nodes.  It takes
  pointers that run one way (each route's do) and raises ValueError where
  the walk steps against its way (back into a tile it has left), or a
  pointer or start lies outside the lane.  Its status flags are in
  pinned host memory the kernels write through their mapping: the one
  readback before the wrapper returns is the stream's synchronise, in
  the C entry, with no copy;
- ``extract_compact_cuda`` (K14) replaces ``device_parser.
  _extract_compact`` and ``greedy_compact_cuda`` (K14) ``device_matcher.
  _compact_taken``: the marked nodes' tokens in order, filled past each
  lane's count.  Its bytes bound it (25 B a slot written): one grid whose
  tiles find their first slot by decoupled look-back along the lane,
  stage their tokens in shared memory and write each plane's slots, the
  fill and t_valid as 16-byte stores.

A CUDA tensor launches the kernel (or the wrapper raises); a CPU tensor
takes the plain version.  Every output is the plain version's, bit for
bit, in its dtype.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from ..runtime import build
from .device_matcher import _compact_taken, _greedy_mark
from .device_parser import _extract_compact, _extract_mark

#: kernel launches made through extract_mark_cuda and greedy_mark_cuda
#: (K13) since the count was last set
MARK_LAUNCHES = 0
#: kernel launches made through extract_compact_cuda and
#: greedy_compact_cuda (K14)
COMPACT_LAUNCHES = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: K13's and K14's grids, in lzt_path_occupancy's order (csrc/path.cu)
GRIDS = ("door", "group", "lane", "entry", "mark", "compact")


@functools.cache
def _lib():
    lib = build.load()
    lib.lzt_path_mark.argtypes = [_P] * 4 + [_L, _I, _I, _L] + [_P] * 4
    lib.lzt_path_mapped.argtypes = [_P, ctypes.POINTER(_P)]
    lib.lzt_path_compact.argtypes = [_P] * 6 + [_I, _I, _L] + [_P] * 7
    lib.lzt_path_mark_scratch.argtypes = [_I, _L]
    lib.lzt_path_compact_scratch.argtypes = [_I, _L]
    lib.lzt_path_occupancy.argtypes = [_I]
    for fn in (lib.lzt_path_mark, lib.lzt_path_compact, lib.lzt_path_mapped,
               lib.lzt_path_occupancy):
        fn.restype = ctypes.c_int
    for fn in (lib.lzt_path_mark_scratch, lib.lzt_path_compact_scratch):
        fn.restype = ctypes.c_longlong
    return lib


def _on_card(name: str, t) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {t.device}")
    return True


def _check(name: str, shape, dev, **planes):
    for key, (t, dtypes) in planes.items():
        if tuple(t.shape) != tuple(shape) or t.device != dev:
            raise ValueError(f"{name}: {key} must be {tuple(shape)} on {dev}, "
                             f"got {tuple(t.shape)} on {t.device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: {key} must be {dtypes[0]}, got {t.dtype}")


_INTS = (torch.int64, torch.int32)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


_PINNED = threading.local()


def _status(lib):
    """K13's two status flags, zeroed, in pinned host memory that the
    kernels write through its mapping, and their device pointer (looked
    up once): the calling thread's own pair (a call reads them back
    before it returns)."""
    pair = getattr(_PINNED, "pair", None)
    if pair is None:
        flags = torch.zeros((2,), dtype=torch.int32, pin_memory=True)
        mapped = _P()
        err = lib.lzt_path_mapped(flags.data_ptr(), ctypes.byref(mapped))
        if err:
            raise RuntimeError(f"path_mark: no mapping of the status flags: "
                               f"CUDA error {err}")
        pair = _PINNED.pair = (flags, mapped.value)
    else:
        pair[0].zero_()
    return pair


def _mark(from_, lens, adv, n, start: int, L: int, n_nodes: int, width: int,
          dev):
    global MARK_LAUNCHES
    mark = torch.empty((L, width), dtype=torch.bool, device=dev)
    if L == 0 or width == 0:
        return mark
    lib = _lib()
    scratch = torch.empty((int(lib.lzt_path_mark_scratch(L, n_nodes)),),
                          dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        status, mapped = _status(lib)
        err = lib.lzt_path_mark(
            None if from_ is None else from_.data_ptr(),
            None if lens is None else lens.data_ptr(),
            None if adv is None else adv.data_ptr(),
            None if n is None else n.data_ptr(), int(start),
            int(adv is not None), L, n_nodes, scratch.data_ptr(), mapped,
            mark.data_ptr(), _stream(dev))
    if err:
        raise RuntimeError(f"path_mark launch failed: CUDA error {err}")
    MARK_LAUNCHES += 1
    out_of_range, passed = status.tolist()
    if out_of_range:
        raise ValueError("a pointer or the start node lies outside the lane")
    if passed:
        raise ValueError("the walk goes back into a tile it has left: the "
                         "pointers must run one way")
    return mark


def occupancy() -> dict:
    """{grid: blocks an SM on this card} for K13's and K14's grids (the
    walk grids with a whole group's door maps in shared memory)."""
    lib = _lib()
    return {name: lib.lzt_path_occupancy(i) for i, name in enumerate(GRIDS)}


def extract_mark_cuda(from_, lens):
    """The DP path's nodes (K13): from_ (L, NP) each node's predecessor,
    lens (L,) each lane's end node.  Returns mark (L, NP) bool, the nodes
    1..lens reached from node lens, as ``_extract_mark``."""
    if not _on_card("extract_mark_cuda", from_):
        return _extract_mark(from_, lens)
    if from_.dim() != 2:
        raise ValueError(f"from_ must be (L, NP), got {tuple(from_.shape)}")
    L, NP = from_.shape
    _check("extract_mark_cuda", (L, NP), from_.device, from_=(from_, _INTS))
    _check("extract_mark_cuda", (L,), from_.device, lens=(lens, _INTS))
    return _mark(from_.to(torch.int32).contiguous(),
                 lens.to(torch.int64).contiguous(), None, None, 0, L, NP, NP,
                 from_.device)


def greedy_mark_cuda(adv, n, start: int = 0):
    """The lazy path's positions (K13): adv (N, max_n) each position's
    advance, n (N,) the lanes' lengths, `start` the first node.  Returns
    on_path (N, max_n) bool, the positions below n reached from `start`
    over pos -> min(pos + adv, max_n), as ``_greedy_mark``."""
    if not _on_card("greedy_mark_cuda", adv):
        return _greedy_mark(adv, n, start)
    if adv.dim() != 2:
        raise ValueError(f"adv must be (N, max_n), got {tuple(adv.shape)}")
    N, max_n = adv.shape
    _check("greedy_mark_cuda", (N, max_n), adv.device, adv=(adv, _INTS))
    _check("greedy_mark_cuda", (N,), adv.device, n=(n, _INTS))
    if not 0 <= start <= max_n:
        raise ValueError(f"start must be in [0, {max_n}], got {start}")
    return _mark(None, None, adv.to(torch.int64).contiguous(),
                 n.to(torch.int64).contiguous(), start, N, max_n + 1, max_n,
                 adv.device)


def _compact(mark, from_, choice, best_len, best_dist, take, dev):
    global COMPACT_LAUNCHES
    L, W = mark.shape
    out = [torch.empty((L, W), dtype=torch.int64, device=dev)
           for _ in range(3)]
    t_valid = torch.empty((L, W), dtype=torch.bool, device=dev)
    if L == 0 or W == 0:
        return (*out, t_valid, torch.zeros((L,), dtype=torch.int64, device=dev))
    ntok = torch.empty((L,), dtype=torch.int64, device=dev)
    lib = _lib()
    scratch = torch.empty((int(lib.lzt_path_compact_scratch(L, W)),),
                          dtype=torch.uint8, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        err = lib.lzt_path_compact(
            mark.data_ptr(), ptr(from_), ptr(choice), ptr(best_len),
            ptr(best_dist), ptr(take), int(take is not None), L, W,
            scratch.data_ptr(), *(t.data_ptr() for t in out),
            t_valid.data_ptr(), ntok.data_ptr(), _stream(dev))
    if err:
        raise RuntimeError(f"path_compact launch failed: CUDA error {err}")
    COMPACT_LAUNCHES += 1
    return (*out, t_valid, ntok)


def extract_compact_cuda(from_, choice, mark):
    """The DP path's tokens (K14): from_, choice (L, NP), mark (L, NP)
    bool (K13's).  Returns (t_pos, t_len, t_dist) (L, NP) int64, t_valid
    (L, NP) bool and ntok (L,) int64, as ``_extract_compact``."""
    if not _on_card("extract_compact_cuda", mark):
        return _extract_compact(from_, choice, mark)
    if mark.dim() != 2:
        raise ValueError(f"mark must be (L, NP), got {tuple(mark.shape)}")
    _check("extract_compact_cuda", mark.shape, mark.device,
           mark=(mark, (torch.bool,)), from_=(from_, _INTS),
           choice=(choice, _INTS))
    return _compact(mark.contiguous(), from_.to(torch.int32).contiguous(),
                    choice.to(torch.int32).contiguous(), None, None, None,
                    mark.device)


def greedy_compact_cuda(best_len, best_dist, take, on_path):
    """The lazy path's tokens (K14): best_len, best_dist (N, max_n), take
    (N, max_n) bool (_decide's), on_path (N, max_n) bool (K13's).  Returns
    (t_pos, t_len, t_dist) (N, max_n) int64, t_valid (N, max_n) bool and
    num_tokens (N,) int64, as ``_compact_taken``."""
    if not _on_card("greedy_compact_cuda", on_path):
        return _compact_taken(best_len, best_dist, take, on_path)
    if on_path.dim() != 2:
        raise ValueError(f"on_path must be (N, max_n), got "
                         f"{tuple(on_path.shape)}")
    _check("greedy_compact_cuda", on_path.shape, on_path.device,
           on_path=(on_path, (torch.bool,)), take=(take, (torch.bool,)),
           best_len=(best_len, _INTS), best_dist=(best_dist, _INTS))
    return _compact(on_path.contiguous(), None, None,
                    best_len.to(torch.int64).contiguous(),
                    best_dist.to(torch.int64).contiguous(),
                    take.contiguous(), on_path.device)
