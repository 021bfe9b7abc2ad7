"""The hybrid encode: the match search on the card, the serial coder on
the host.

Port of ``lzma_tpu/ops/hybrid.py``.  The card does the parallel part:
the lazy tokenizer (``encode_blocks_hybrid``), or the multi-tier
candidate lists of every position, flattened on the card
(``encode_blocks_hybrid_optimal``, ``encode_stream_hybrid_optimal``).
The host does the bit-serial part over those tokens or lists: the LZMA
state machine and range coder, and for the lists the reference's optimal
parser (``runtime.native``, the encoder half of the JAX package's C++
runtime), a thread a block.  The containers are the JAX package's, byte
for byte; the lazy hybrid's also equals the all-device lazy encoder's
(the same tokens through another serializer).

The card's work runs on `device` ("cuda" unless the caller asks for the
CPU).  The list search holds several (lanes, width, M) int64 tensors, M
the tiers' candidates a position (29 at DEFAULT_TIERS), so it runs in
groups of lanes sized from the card's free memory (``_group_lanes``);
the grouping changes no output.  A ``utils.profiling.PhaseTimer`` passed
as `timer` splits an encode into "search" (on the card), "transfer",
"flatten" (the optimal one's lists) and "host_parse".
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..format.properties import LzmaParams
from ..parallel import blocks as blk
from ..runtime import native
from ..utils.profiling import PhaseTimer
from .device_encoder import clamp_fb
from .device_matcher import (_rmq_search, pack_match_lists, tier_ranks,
                             tokenize)

#: Candidate-tier depths of the hybrid-optimal pipeline
#: (lzma_tpu.ops.hybrid.DEFAULT_TIERS, k2 and k3 at their default 1)
DEFAULT_TIERS = dict(k4=12, k6=4, k8=6, k16=3, k32=2)

#: the list search's device bytes a lane position, per candidate column
#: and on top: 16,666 MiB of peak for 27 lanes of 262,144 positions at 29
#: columns (NVIDIA H100, chip_smoke phase 16) is ~2,470 B a position;
#: these give 2,832 at 29 columns
_BYTES_PER_CANDIDATE = 80
_BYTES_PER_POSITION = 512
#: the share of the card's free memory a group may take
_MEM_SHARE = 0.5


def _tokenize_lanes(arr, lens, dict_size: int, fb: int, num_candidates: int,
                    start: int = 0, device="cuda", timer=None):
    """The lazy tokenizer over (N, W) uint8 lanes on `device`
    (hybrid._tokenize_lanes).  Returns numpy (t_pos, t_len, t_dist,
    ntok)."""
    timer = timer or PhaseTimer()
    out = []
    with timer.phase("search", sync_arrays=out):
        data = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
        n = torch.from_numpy(np.asarray(lens, dtype=np.int32)).to(device)
        tp, tl, td, _, ntok = tokenize(data, n, dict_size, fb, num_candidates,
                                       start=start)
        out.extend((tp, tl, td, ntok))
    with timer.phase("transfer"):
        return tuple(x.cpu().numpy() for x in out)


def _lanes(blocks, bs: int):
    arr = np.zeros((len(blocks), bs), dtype=np.uint8)
    lens = np.zeros(len(blocks), dtype=np.int32)
    for i, b in enumerate(blocks):
        arr[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        lens[i] = len(b)
    return arr, lens


def _primed(preset: bytes, arr):
    return np.concatenate(
        [np.broadcast_to(np.frombuffer(preset, dtype=np.uint8),
                         (arr.shape[0], len(preset))), arr], axis=1)


def _container(params, bs, data, n, preset_len, dictionary, sizes, payload):
    dict_stream = native.encode_stream(dictionary, params) if dictionary else b""
    head = blk.pack_header(params, bs, len(data), n, preset_len,
                           len(dictionary), len(dict_stream))
    return head + struct.pack(f"<{n}I", *sizes) + dict_stream + payload


def encode_blocks_hybrid(
    data: bytes,
    params: LzmaParams | None = None,
    block_size: int = 1 << 18,
    num_threads: int = 0,
    fb: int | None = None,
    num_candidates: int = 4,
    preset_len: int = 0,
    dictionary: bytes = b"",
    device="cuda",
    timer: PhaseTimer | None = None,
) -> bytes:
    """The lazy tokenizer on the card, the host serializer over its tokens
    (hybrid.encode_blocks_hybrid), into an LZTB container.  `preset_len`
    writes LZTB v2 (block 0 plain, every other lane searching
    preset||block from the boundary); `dictionary` writes LZTB v3 (the
    dictionary stored as its own stream, priming every lane).  `timer`
    splits it into "search", "transfer" and "host_parse"."""
    timer = timer or PhaseTimer()
    params = (params or LzmaParams()).validated_for_encode()
    if params.write_eos:
        raise ValueError("block container uses known sizes; EOS not supported")
    preset_len = blk.validated_preset_len(preset_len, block_size, len(data))
    dictionary = blk.validated_dictionary(dictionary, preset_len)
    if len(data) <= block_size:
        preset_len = 0  # single block: a preset would be pointless
    blocks = blk.split_blocks(data, block_size)
    if not blocks:
        return blk.build_container(params, block_size, 0, [])
    fb = clamp_fb(fb if fb is not None else params.fast_bytes)
    n, bs = len(blocks), block_size
    arr, lens = _lanes(blocks, bs)
    preset = dictionary or (data[:preset_len] if preset_len else b"")

    def lanes(a, ln, start):
        return _tokenize_lanes(a, ln, min(params.dict_size, a.shape[1]), fb,
                               num_candidates, start=start, device=device,
                               timer=timer)

    if dictionary:
        dlen = len(dictionary)
        tp, tl, td, counts = lanes(_primed(dictionary, arr), lens + dlen, dlen)
        tp = tp - dlen                                   # block-relative
    elif preset_len:
        # block 0 (the preset source) parses plain on one lane; the
        # others search preset||block with the parse at the boundary
        t0 = lanes(arr[:1], lens[:1], 0)
        t1 = lanes(_primed(preset, arr[1:]), lens[1:] + preset_len, preset_len)
        w = max(t0[0].shape[1], t1[0].shape[1])
        pad = [np.pad(a, ((0, 0), (0, w - a.shape[1]))) for a in t0[:3] + t1[:3]]
        tp = np.concatenate([pad[0], pad[3] - preset_len])
        tl = np.concatenate([pad[1], pad[4]])
        td = np.concatenate([pad[2], pad[5]])
        counts = np.concatenate([t0[3], t1[3]])
    else:
        tp, tl, td, counts = lanes(arr, lens, 0)

    with timer.phase("host_parse"):
        # the compacted token prefixes, flat
        counts = counts.astype(np.int64)
        offsets = np.zeros(n, dtype=np.int64)
        np.cumsum(counts[:-1], out=offsets[1:])
        keep = np.arange(tp.shape[1])[None, :] < counts[:, None]
        payload, sizes = native.encode_token_blocks(
            arr.reshape(-1), bs, params.lc, params.lp, params.pb, tp[keep],
            tl[keep], td[keep], offsets, counts, num_threads=num_threads,
            preset=preset, preset_first=bool(dictionary))
        return _container(params, bs, data, n, preset_len, dictionary, sizes,
                          payload)


def _group_lanes(n: int, width: int, M: int, device,
                 share: float = _MEM_SHARE) -> int:
    """Lanes a list search runs at once: all of them on the CPU; on a CUDA
    device as many as fit in `share` of its free memory by the search's
    bytes a position (at least one)."""
    device = torch.device(device)
    if device.type != "cuda":
        return max(n, 1)
    free, _ = torch.cuda.mem_get_info(device)
    per_lane = width * (_BYTES_PER_CANDIDATE * M + _BYTES_PER_POSITION)
    return max(1, min(n, int(free * share // per_lane)))


def _match_lists_grouped(arr, lane_lens, dict_size: int, fb: int, tiers,
                         device="cuda", timer: PhaseTimer | None = None,
                         group: int | None = None):
    """The uncapped candidate lists of every lane, flattened on the card by
    pack_match_lists at 3 pairs a position, in groups of lanes
    (hybrid._match_lists_grouped): `group` lanes at once, by default
    _group_lanes'.  Returns numpy (fl (n, cap) int32, fd (n, cap) int32,
    counts (n, width) int32)."""
    timer = timer or PhaseTimer()
    n, width = arr.shape
    cap = 3 * width
    if group is None:
        group = _group_lanes(n, width, _columns(tiers), device)
    fls, fds, cnts = [], [], []
    for i in range(0, n, group):
        out = []
        with timer.phase("search", sync_arrays=out):
            data = torch.from_numpy(np.ascontiguousarray(arr[i:i + group])).to(device)
            lens = torch.from_numpy(
                np.asarray(lane_lens[i:i + group], dtype=np.int32)).to(device)
            cl, cd, counts = _rmq_search(data, lens, dict_size, fb, tiers,
                                         m_cap=0, m_cap_order="near")[:3]
            del data
            out.extend(pack_match_lists(cl, cd, counts, cap))
            del cl, cd, counts
        with timer.phase("transfer"):
            fl, fd, ce = (x.cpu().numpy() for x in out)
        del out
        fls.append(fl)
        fds.append(fd)
        cnts.append(ce)
    return np.concatenate(fls), np.concatenate(fds), np.concatenate(cnts)


def _columns(tiers) -> int:
    """The candidates a position of the list search at `tiers`."""
    return sum(len(r) for _, r in tier_ranks(tiers))


def _flatten_packed(fl, fd, counts, n_pos_per_lane):
    """Packed per-lane pair buffers -> flat pair arrays and the offset
    tables of native.encode_candidate_blocks (hybrid._flatten_packed).
    `counts` rows are zero past each lane's length, and the buffers were
    laid out on the card from exactly these counts: no re-masking here,
    or the offsets would desync from the buffers."""
    n_lanes, cap = fl.shape
    max_n = counts.shape[1]
    c = counts.astype(np.int64)
    used = c.sum(axis=1)                                    # pairs a lane
    m = np.arange(cap, dtype=np.int64)[None, :] < used[:, None]
    flat_l = np.ascontiguousarray(fl[m])
    flat_d = np.ascontiguousarray(fd[m])
    return (flat_l, flat_d) + _offset_tables(c, n_pos_per_lane, max_n)


def _offset_tables(c, n_pos_per_lane, max_n: int):
    """(flat_off, pos_base): lane i's table is G[i*max_n + j], j in
    [0, npos_i], G[k] the pairs before flat (lane, pos) index k; counts
    past npos are zero, so G at j == npos_i is the next lane's base."""
    n_lanes = c.shape[0]
    npos = np.asarray(n_pos_per_lane, dtype=np.int64)
    G = np.zeros(n_lanes * max_n + 1, dtype=np.int64)
    np.cumsum(c.reshape(-1), out=G[1:])
    j = np.arange(max_n + 1, dtype=np.int64)[None, :]
    sel = j <= npos[:, None]
    gidx = np.arange(n_lanes, dtype=np.int64)[:, None] * max_n + j
    pos_base = np.zeros(n_lanes, dtype=np.int64)
    np.cumsum(npos[:-1] + 1, out=pos_base[1:])
    return G[gidx[sel]], pos_base


def _flatten_lists(cl, cd, counts, n_pos_per_lane):
    """Per-lane (max_n, M) candidate arrays -> flat pair arrays and offset
    tables (hybrid._flatten_lists): the tests' oracle for the packed
    form."""
    n_lanes, max_n, M = cl.shape
    if n_lanes == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.int64), np.zeros(0, np.int64))
    npos = np.asarray(n_pos_per_lane, dtype=np.int64)
    pos_valid = np.arange(max_n, dtype=np.int64)[None, :] < npos[:, None]
    c = np.where(pos_valid, counts, 0)                      # (n_lanes, max_n)
    mask = np.arange(M)[None, None, :] < c[:, :, None]      # (n_lanes, max_n, M)
    flat_l = np.ascontiguousarray(cl[mask])                 # lane, pos, pair
    flat_d = np.ascontiguousarray(cd[mask])
    return (flat_l, flat_d) + _offset_tables(c.astype(np.int64), npos, max_n)


def _tiers(tiers):
    tiers = dict(DEFAULT_TIERS) if tiers is None else dict(tiers)
    tiers.setdefault("k4", DEFAULT_TIERS["k4"])
    tiers.setdefault("k8", DEFAULT_TIERS["k8"])
    return tiers


def encode_blocks_hybrid_optimal(
    data: bytes,
    params: LzmaParams | None = None,
    block_size: int = 1 << 18,
    num_threads: int = 0,
    fb: int | None = None,
    tiers: dict | None = None,
    preset_len: int = 0,
    dictionary: bytes = b"",
    device="cuda",
    timer: PhaseTimer | None = None,
) -> bytes:
    """Multi-tier candidate lists on the card, the reference's optimal
    parse over them on the host (hybrid.encode_blocks_hybrid_optimal), into
    an LZTB container.  fb may be 5..273 (the lists' depth and the
    parser's); `tiers` are find_match_lists_rmq's keyword ks (k4 and k8
    at DEFAULT_TIERS' where not named); `preset_len` and `dictionary` as
    in encode_blocks_hybrid."""
    timer = timer or PhaseTimer()
    params = (params or LzmaParams()).validated_for_encode()
    if params.write_eos:
        raise ValueError("block container uses known sizes; EOS not supported")
    preset_len = blk.validated_preset_len(preset_len, block_size, len(data))
    dictionary = blk.validated_dictionary(dictionary, preset_len)
    if len(data) <= block_size:
        preset_len = 0
    blocks = blk.split_blocks(data, block_size)
    if not blocks:
        return blk.build_container(params, block_size, 0, [])
    fb = int(fb if fb is not None else params.fast_bytes)
    tiers = _tiers(tiers)
    n, bs = len(blocks), block_size
    arr, lens = _lanes(blocks, bs)
    preset = dictionary or (data[:preset_len] if preset_len else b"")
    plen = len(preset)
    preset_first = bool(dictionary)

    if plen:
        first = 0 if preset_first else 1
        primed = _primed(preset, arr[first:])
        if first:
            # v2: block 0 (the preset source) searches plain, its row
            # padded to the primed width so one batch holds every lane
            row0 = np.concatenate([arr[:1], np.zeros((1, plen), np.uint8)],
                                  axis=1)
            primed = np.concatenate([row0, primed], axis=0)
            n_pos = np.concatenate([lens[:1], lens[1:] + plen])
        else:
            n_pos = lens + plen
    else:
        primed, n_pos = arr, lens
    fl, fd, counts = _match_lists_grouped(
        primed, n_pos, min(params.dict_size, bs + plen), fb, tiers,
        device=device, timer=timer)
    with timer.phase("flatten"):
        flat = _flatten_packed(fl, fd, counts, n_pos)
    del fl, fd, counts
    with timer.phase("host_parse"):
        payload, sizes = native.encode_candidate_blocks(
            arr.reshape(-1), bs, params.lc, params.lp, params.pb,
            min(params.dict_size, 1 << 29), fb, *flat, num_threads=num_threads,
            preset=preset, preset_first=preset_first,
            total_len=(n - 1) * bs + int(lens[-1]))
        return _container(params, bs, data, n, preset_len, dictionary, sizes,
                          payload)


def encode_stream_hybrid_optimal(
    data: bytes,
    params: LzmaParams | None = None,
    fb: int | None = None,
    tiers: dict | None = None,
    device="cuda",
) -> bytes:
    """One raw LZMA stream by the hybrid-optimal pipeline on one lane
    (hybrid.encode_stream_hybrid_optimal): the card's candidate lists,
    the host's optimal parse.  Known size; any decoder reads it."""
    params = (params or LzmaParams()).validated_for_encode()
    if params.write_eos:
        raise ValueError("raw hybrid streams use known sizes; EOS not supported")
    fb = int(fb if fb is not None else params.fast_bytes)
    n = len(data)
    width = max(n, 16)
    arr = np.zeros((1, width), dtype=np.uint8)
    arr[0, :n] = np.frombuffer(data, dtype=np.uint8)
    lens = np.array([n], dtype=np.int32)
    fl, fd, ce = _match_lists_grouped(
        arr, lens, min(params.dict_size, width), fb, _tiers(tiers),
        device=device)
    payload, _ = native.encode_candidate_blocks(
        arr.reshape(-1), width, params.lc, params.lp, params.pb,
        min(params.dict_size, 1 << 29), fb, *_flatten_packed(fl, fd, ce, lens),
        num_threads=1, total_len=n)
    return payload
