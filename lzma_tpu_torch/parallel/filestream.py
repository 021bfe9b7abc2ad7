"""The LZTB file codec on the device: a file of any size through the card
in batches of blocks, with O(batch) memory.

Port of ``lzma_tpu/parallel/filestream.py``.  Blocks are independent
streams, so a file passes through the codec one batch of blocks at a
time and the container is byte-identical to the port's in-memory
``ops.api.encode_blocks`` of the whole input (same parse, same
preset or dictionary).  Encode writes the header with a zeroed size
table, streams the payload behind it, then seeks back and patches the
table; decode reads the header and the table, then decodes a batch of
blocks at a time without a back-seek.

The codec is the card's (``_backend``): ``device_encoder.encode_batch``
(K6, K3 under the optimal parse, K2) and ``cuda_ring.decode_batch_cuda``
(K1), their plain versions for a CPU `device`.  A batch holds as many
blocks as the card's memory takes (``encode_batch_blocks``,
``decode_batch_blocks``), at most the caller's `batch_bytes`; on the CPU
`batch_bytes` alone sets it.  A block that cannot fit raises before any
launch; an out-of-memory error is never retried smaller.

The `.lzma` routes (``encode_file_alone``, ``decode_file_alone``) read
the whole file: one stream is one lane, and its O(dict) sliding window
needs lane state that survives across launches, which the device path
lacks.
"""

from __future__ import annotations

import json
import os
import queue
import struct
import threading
import time

import torch

from ..core.layout import ProbLayout
from ..core.rangecoder import CorruptStreamError
from ..format.properties import LzmaParams
from ..ops.cuda_ring import decode_batch_cuda
from ..ops.device_decoder import _pow2_at_least
from ..ops.device_encoder import encode_batch
from . import blocks as blk

#: uncompressed bytes a batch holds at most (a multiple of block_size)
DEFAULT_BATCH_BYTES = 64 << 20

# The encode's peak device bytes a lane position, from the largest tensors
# live at once (int64 unless named), per parse, as A + B x levels, where
# levels = bit_length(width - 1) is the depth of the suffix table and
# width the lane's pow2 bucket plus its preset.
# - optimal, at the plain _rmq_search's tier candidates and their dedup
#   (the stage "match_lists", the plain encode's peak): the 29 candidate
#   columns of DP_TIERS
#   held twice, as _neighbor_candidates' list and its stack (2 x 29 x 8
#   = 464 B), the 32 rolled byte planes of the tier hashes (256 B) and
#   the 7 hash planes (56 B), the dedup's permuted copy, its priority
#   keys and their sort (3 x 29 x 8 = 696 B freed as the stack goes),
#   beside the suffix rank (8 B) and the sparse min table (int32, 4 B a
#   level, held twice while it is stacked).  Then model (price planes)
#   and lower (the bit slots) peak lower.
# - lazy, at the lowering (the stage "lower": the bit slots), since the
#   search's plain pieces (K9's keys, a doubling level at a time, the
#   descent; device_matcher._suffix_rank_lcp) no longer hold the 32
#   rolled byte planes across the 273-deep table: its stages peak below
#   it, the first doubling level highest (the 32 planes and 8 words while
#   its ids are made), the table's levels (int32, held twice while
#   stacked) in the suffix_table and best_matches stages.
# Fitted to the peaks a storage-tracking run of the plain versions
# measures (python -m lzma_tpu_torch.bench.memory_model): optimal 1,251 B
# a position at 12 levels (1,255 at fb 273), the model 4-6% above; lazy
# 547.3, 545.9, 544.9 and 544.6 B at 9, 10, 12 and 14 levels (632, 652
# and 668 at 10, 12 and 14 before its search's kernels), the model 8-16%
# above, its B term kept for the table's levels and its A high enough
# that a preset lane (lazy, twice as wide) still sizes a batch of
# 256 KiB optimal blocks.  On the card
# the search no longer allocates the plain versions' tensors: its
# kernels (K9-K11, ops/cuda_search.py) write int32 tier keys, the sorts'
# values and indices, the table once, in place, and the lists; K12
# (ops/cuda_inputs.py) writes the DP rows once in int32, where the plain
# version builds them in int64 and casts; the lazy search's kernels
# (K15-K17, ops/cuda_lazy.py) hold no rolled planes.  main8M's optimal
# encode (18 levels) peaks at 3,181.1 MiB, 398 B a position (6,840.1 MiB,
# 855 B, before K12; 10,175.4 MiB before K9-K11), and file128M-opt's
# 116-block batches at 11,513.0 MiB against this model's 38,744.0; its
# lazy encode at 1,301.0 MiB, 163 B (4,968.9 MiB, 621 B, before
# K15-K17), and file256M-lazy's 226-block batches at 9,153.9 MiB
# against 37,516.0 (PERF.md sections 5 and 6).  So the model is ~3.4x
# the card's optimal peak and ~4.1x its lazy one until it is refitted
# to the card (ROADMAP.md).
ENC_BYTES_A = {"optimal": 1264, "lazy": 520}
ENC_BYTES_B = {"optimal": 4, "lazy": 8}
#: the share of the card's available memory a batch may take
MEM_SHARE = 0.5
#: where set, a file the codec appends one JSON line a batch to: its
#: kind, blocks, bytes in and out, modelled bytes, seconds, the kernels'
#: launches in it and, on a card, the bytes allocated as it began and its
#: peak device bytes above them (the peak counter is reset before each
#: batch, so this is for measurement runs only)
BATCH_LOG_ENV = "LZMA_TPU_TORCH_BATCH_LOG"


def lane_width(block_size: int, preset_len: int = 0) -> int:
    """A lane's positions on the card: the pow2 bucket of the block (at
    least 16, ``device_decoder.pad_rows``) plus the preset it searches."""
    return _pow2_at_least(block_size, 16) + preset_len


def encode_lane_bytes(parse: str, block_size: int, preset_len: int = 0) -> int:
    """Modelled peak device bytes of the widest lane of an ``encode_batch``
    of `block_size` blocks: the bytes a position of its parse
    (ENC_BYTES_A/B) times its width.  With a preset, block 0 parses plain
    (`parse`) and the others lazy against it, as in
    ``ops.api.encode_blocks``: the larger of the two lanes."""
    def lane(parse, width):
        # the optimal parse's variants ("optimal:<seed>") search as it does;
        # every other parse is lazy (device_encoder._lower_lanes)
        kind = "optimal" if parse.startswith("optimal") else "lazy"
        levels = max(1, (width - 1).bit_length())
        return width * (ENC_BYTES_A[kind] + ENC_BYTES_B[kind] * levels)

    plain = lane(parse, lane_width(block_size))
    if not preset_len:
        return plain
    return max(plain, lane("lazy", lane_width(block_size, preset_len)))


def decode_lane_bytes(params: LzmaParams, block_size: int, max_comp: int,
                      preset_len: int = 0) -> int:
    """Device bytes of one lane of ``decode_batch_cuda``: its input row
    (the pow2 bucket of the longest stream), its output row, which is K1's
    window (the block and the preset, pow2), the int16 arena where it
    goes to device memory, and its lengths, sizes and flags."""
    arena = ProbLayout(params.lc, params.lp, params.pb, pos_bits=params.pb).size
    return (lane_width(max_comp) + lane_width(block_size + preset_len)
            + 2 * arena + 16)


def _available(device) -> int:
    """Bytes the allocator can hand out on `device`: the card's free memory
    and what PyTorch's cache holds unallocated."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) \
        - torch.cuda.memory_allocated(device)


def _fit(lane_bytes: int, block_size: int, batch_bytes: int, device,
         what: str) -> int:
    ceiling = max(1, batch_bytes // block_size)
    device = torch.device(device)
    if device.type != "cuda":
        return ceiling
    room = int(_available(device) * MEM_SHARE)
    if lane_bytes > room:
        raise ValueError(
            f"one {block_size}-byte block needs ~{lane_bytes} B of device "
            f"memory to {what}; {room} B ({MEM_SHARE} of what the card has "
            "free) are available: use a smaller block_size")
    return min(ceiling, room // lane_bytes)


def encode_batch_blocks(parse: str, block_size: int, preset_len: int = 0,
                        batch_bytes: int = DEFAULT_BATCH_BYTES,
                        device="cuda", dict_len: int = 0) -> int:
    """Blocks an encode batch holds: on a CUDA device as many lanes as
    MEM_SHARE of its available memory takes by ``encode_lane_bytes``, at
    most batch_bytes // block_size and at least one; on the CPU
    batch_bytes // block_size (at least one).  `preset_len` is the v2
    preset's length, `dict_len` a stored dictionary's (v3), which primes
    every lane and is coded as one lane of its own: both are checked.
    Raises ValueError, before any launch, where one lane does not fit.
    The window (dict_size) moves no tensor's size."""
    if dict_len:
        _fit(encode_lane_bytes(parse, dict_len), dict_len, dict_len, device,
             "encode")
    return _fit(encode_lane_bytes(parse, block_size, preset_len or dict_len),
                block_size, batch_bytes, device, "encode")


def decode_batch_blocks(params: LzmaParams, block_size: int, max_comp: int,
                        preset_len: int = 0,
                        batch_bytes: int = DEFAULT_BATCH_BYTES,
                        device="cuda") -> int:
    """Blocks a decode batch holds, as ``encode_batch_blocks`` by
    ``decode_lane_bytes`` (`max_comp`: the longest stream of the size
    table)."""
    lane = decode_lane_bytes(params, block_size, max_comp, preset_len)
    return _fit(lane, block_size, batch_bytes, device, "decode")


def _launches() -> dict:
    """The kernels' launch counts (K1 ring_decode, K2 rc_serialize, K3
    dp_parse, K6 classify, K7 lower, K8 lower_counts, K9 search_keys, K10
    suffix_table, K11 match_lists, K12 dp_inputs, K13 path_mark, K14
    path_compact, K15 doubling_groups, K16 descent_lcp, K17
    best_matches, K18 price_model, K19 classify_tokens, K20 rep0_trace,
    K21 list_pairs)."""
    from ..ops import (cuda_classify, cuda_inputs, cuda_lazy, cuda_lower,
                       cuda_model, cuda_parser, cuda_path, cuda_ring,
                       cuda_search, cuda_serializer)

    return {"ring_decode": cuda_ring.LAUNCHES,
            "rc_serialize": cuda_serializer.LAUNCHES,
            "dp_parse": cuda_parser.LAUNCHES,
            "classify": cuda_classify.LAUNCHES,
            "lower": cuda_lower.LAUNCHES,
            "lower_counts": cuda_lower.COUNT_LAUNCHES,
            "search_keys": cuda_search.KEYS_LAUNCHES,
            "suffix_table": cuda_search.TABLE_LAUNCHES,
            "match_lists": cuda_search.LIST_LAUNCHES,
            "dp_inputs": cuda_inputs.LAUNCHES,
            "path_mark": cuda_path.MARK_LAUNCHES,
            "path_compact": cuda_path.COMPACT_LAUNCHES,
            "doubling_groups": cuda_lazy.GROUP_LAUNCHES,
            "descent_lcp": cuda_lazy.DESCENT_LAUNCHES,
            "best_matches": cuda_lazy.BEST_LAUNCHES,
            "price_model": cuda_model.LAUNCHES,
            "classify_tokens": cuda_classify.TOKEN_LAUNCHES,
            "rep0_trace": cuda_inputs.REP0_LAUNCHES,
            "list_pairs": cuda_search.PAIR_LAUNCHES}


class _BatchLog:
    """The per-batch lines of BATCH_LOG_ENV, where it is set."""

    def __init__(self, kind: str, device, lane_bytes: int):
        self.path = os.environ.get(BATCH_LOG_ENV)
        self.kind, self.lane_bytes = kind, lane_bytes
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"

    def start(self):
        if not self.path:
            return
        if self.cuda:
            torch.cuda.synchronize(self.device)
            self.base = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.launches = _launches()
        self.t = time.perf_counter()

    def end(self, blocks: int, in_bytes: int, out_bytes: int):
        if not self.path:
            return
        line = dict(kind=self.kind, blocks=blocks, in_bytes=in_bytes,
                    out_bytes=out_bytes, estimate=blocks * self.lane_bytes)
        if self.cuda:
            torch.cuda.synchronize(self.device)
            line["base"] = self.base
            line["peak"] = (torch.cuda.max_memory_allocated(self.device)
                            - self.base)
        line["seconds"] = time.perf_counter() - self.t
        line["launches"] = {k: v - self.launches[k]
                            for k, v in _launches().items()}
        with open(self.path, "a") as f:
            f.write(json.dumps(line) + "\n")


def _backend(parse: str, device):
    """(enc, dec) on `device`.  enc(blocks, params, preset=b"") -> streams:
    ``encode_batch`` with `parse`, or lazy where a preset primes the lanes
    (as ``ops.api.encode_blocks``).  dec(streams, params, out_sizes,
    preset=b"") -> blocks: ``decode_batch_cuda``."""
    def enc(blocks, params, preset=b""):
        return encode_batch(blocks, params, preset=preset,
                            parse="lazy" if preset else parse, device=device)

    def dec(streams, params, out_sizes, preset=b""):
        return decode_batch_cuda(streams, params, out_sizes, preset=preset,
                                 device=device)

    return enc, dec


def _encode_batch(enc, chunk, params, block_size, preset_req, preset, first):
    """Encode one uncompressed batch, handling the LZTB v2 first-batch
    split (block 0, the preset source, encodes plain, the rest against
    the preset).  Shared by encode_file and LZTBWriter (fileobj.py).
    Returns (payload, sizes, preset)."""
    blocks = blk.split_blocks(chunk, block_size)
    if preset_req and first:
        preset = chunk[: min(preset_req, block_size, len(chunk))]
        streams = enc(blocks[:1], params) + enc(blocks[1:], params, preset)
    else:
        streams = enc(blocks, params, preset)
    return b"".join(streams), [len(s) for s in streams], preset


def _split(payload, sizes):
    out, off = [], 0
    for s in sizes:
        out.append(bytes(payload[off:off + s]))
        off += s
    return out


def _decode_batch(dec, payload, params, block_size, batch_total, batch,
                  preset_len, preset, first):
    """Decode one batch of blocks, handling the LZTB v2 first-batch split
    (block 0 decodes plain and donates the preset).  Shared by
    decode_file and LZTBReader (fileobj.py).  Returns (out, preset)."""
    streams = _split(payload, batch)
    sizes = [min(block_size, batch_total - i * block_size)
             for i in range(len(batch))]
    if preset_len and first:
        head = dec(streams[:1], params, sizes[:1])
        preset = head[0][:preset_len]
        parts = head + dec(streams[1:], params, sizes[1:], preset)
    else:
        parts = dec(streams, params, sizes, preset)
    out = b"".join(parts)
    if len(out) != batch_total:
        raise CorruptStreamError("decoded size mismatch")
    return out, preset


def check_total_size_plausible(total_size: int, fileobj) -> None:
    """Anti-DoS guard shared by every streaming reader: a forged
    total_size drives upfront output allocations, so it must be possible
    for the actual payload size.  Skipped when the source size cannot be
    determined (unseekable pipe without fileno)."""
    try:
        src_size = os.fstat(fileobj.fileno()).st_size
    except (AttributeError, OSError):
        try:
            pos = fileobj.tell()
            src_size = fileobj.seek(0, os.SEEK_END)
            fileobj.seek(pos)
        except (AttributeError, OSError, ValueError):
            return
    if total_size > src_size * blk.MAX_EXPANSION + (1 << 16):
        raise CorruptStreamError(
            "claimed total_size is impossible for this payload"
        )


def encode_file(
    src,
    dst,
    params: LzmaParams | None = None,
    block_size: int = blk.DEFAULT_BLOCK_SIZE,
    parse: str = "optimal",
    batch_bytes: int = DEFAULT_BATCH_BYTES,
    progress=None,
    preset_len: int = 0,
    dictionary: bytes = b"",
    device="cuda",
) -> int:
    """Stream-encode file `src` into an LZTB container at `dst` on
    `device`, byte-identical to ``ops.api.encode_blocks`` of the whole
    file with the same `parse`, `preset_len` and `dictionary`.

    Memory is O(batch): a batch is ``encode_batch_blocks`` blocks, read
    ahead by one batch on a thread.  `progress(in_bytes, out_bytes)`
    follows each batch (the reference's ICodeProgress).  `preset_len`
    shares the file's first bytes with every block after block 0 (LZTB
    v2); `dictionary` primes every block (LZTB v3); primed lanes parse
    lazy, and the dictionary's own stream takes `parse`.  Returns the
    container size in bytes."""
    params = (params or LzmaParams()).validated_for_encode()
    if params.write_eos:
        raise ValueError("block container uses known sizes; EOS not supported")
    if block_size < 1:
        raise ValueError("block_size must be positive")
    total_size = os.path.getsize(src)
    num_blocks = (total_size + block_size - 1) // block_size
    preset_len = blk.validated_preset_len(preset_len, block_size, total_size)
    dictionary = blk.validated_dictionary(dictionary, preset_len)
    if num_blocks < 2:
        preset_len = 0  # single block: a preset would be pointless
    if num_blocks == 0:
        dictionary = b""
    per_batch = encode_batch_blocks(parse, block_size, preset_len,
                                    batch_bytes, device, len(dictionary))
    batch_bytes = per_batch * block_size
    enc, _ = _backend(parse, device)
    log = _BatchLog("encode", device, encode_lane_bytes(
        parse, block_size, preset_len or len(dictionary)))

    dict_stream = b""
    if dictionary:
        (dict_stream,) = enc([dictionary], params)
    sizes: list[int] = []
    written = 0
    preset = dictionary
    with open(src, "rb") as fi, open(dst, "wb") as fo:
        head = blk.pack_header(params, block_size, total_size, num_blocks,
                               preset_len, len(dictionary), len(dict_stream))
        fo.write(head)
        table_offset = len(head)
        fo.write(b"\x00" * (4 * num_blocks))  # patched after the payload
        fo.write(dict_stream)
        written += len(dict_stream)
        consumed = 0
        # read-ahead thread: overlap input IO with encoding (one batch of
        # look-ahead, bounded so memory stays O(batch)).  Every put is
        # bounded and stop-aware: if the consumer dies, stop is set and
        # the thread retires instead of blocking on the full queue.
        q: queue.Queue = queue.Queue(maxsize=1)
        stop = threading.Event()

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def _reader():
            try:
                while not stop.is_set():
                    c = fi.read(batch_bytes)
                    if not _put(c) or not c:
                        return
            except Exception as e:  # surfaced by the consumer
                _put(e)

        rt = threading.Thread(target=_reader, daemon=True)
        rt.start()
        try:
            while True:
                chunk = q.get()
                if isinstance(chunk, Exception):
                    raise chunk
                if not chunk:
                    break
                consumed += len(chunk)
                if consumed > total_size:
                    raise ValueError(f"{src} grew while encoding")
                log.start()
                payload, bsizes, preset = _encode_batch(
                    enc, chunk, params, block_size, preset_len, preset,
                    first=not sizes)
                log.end(len(bsizes), len(chunk), len(payload))
                fo.write(payload)
                written += len(payload)
                sizes.extend(bsizes)
                if progress is not None:
                    progress(consumed, table_offset + 4 * num_blocks + written)
        finally:
            stop.set()
            rt.join(timeout=5)
        if consumed != total_size or len(sizes) != num_blocks:
            raise ValueError(f"{src} changed size while encoding")
        fo.seek(table_offset)
        fo.write(struct.pack(f"<{num_blocks}I", *sizes))
    return table_offset + 4 * num_blocks + written


def decode_file(
    src,
    dst,
    batch_bytes: int = DEFAULT_BATCH_BYTES,
    progress=None,
    device="cuda",
) -> int:
    """Stream-decode an LZTB container file `src` (versions 1-3) to `dst`
    on `device`.  Reads the header and the size table, then decodes
    ``decode_batch_blocks`` blocks at a time: O(batch) memory.  Returns
    the decoded size in bytes."""
    _, dec = _backend("lazy", device)
    with open(src, "rb") as fi, open(dst, "wb") as fo:
        (params, block_size, total_size, n, preset_len,
         dict_len, dict_comp, head_size) = (
            blk.read_header(fi)  # validates the block geometry
        )
        check_total_size_plausible(total_size, fi)
        table = fi.read(4 * n)
        if len(table) < 4 * n:
            raise CorruptStreamError("container size table truncated")
        comp_sizes = struct.unpack(f"<{n}I", table)
        max_comp = max(comp_sizes, default=0)
        per_batch = decode_batch_blocks(params, block_size, max_comp,
                                        preset_len or dict_len, batch_bytes,
                                        device)
        log = _BatchLog("decode", device, decode_lane_bytes(
            params, block_size, max_comp, preset_len or dict_len))
        done = 0  # uncompressed bytes written
        comp_done = 0  # compressed payload bytes consumed
        preset = b""
        if dict_len:  # LZTB v3: the stored dictionary primes every block
            ds = fi.read(dict_comp)
            if len(ds) < dict_comp:
                raise CorruptStreamError("container dict stream truncated")
            (preset,) = dec([ds], params, [dict_len])
            comp_done += dict_comp
        for start in range(0, n, per_batch):
            batch = comp_sizes[start : start + per_batch]
            need = sum(batch)
            payload = fi.read(need)
            if len(payload) < need:
                raise CorruptStreamError("container payload truncated")
            batch_total = min(block_size * len(batch), total_size - done)
            log.start()
            out, preset = _decode_batch(
                dec, payload, params, block_size, batch_total, batch,
                preset_len, preset, first=start == 0)
            log.end(len(batch), need, len(out))
            fo.write(out)
            done += batch_total
            comp_done += need
            if progress is not None:
                progress(done, head_size + 4 * n + comp_done)
        if done != total_size:
            raise CorruptStreamError("decoded size mismatch")
    return done


# --- .lzma (LZMA_Alone) single-stream files ---------------------------------
# One stream is one lane, coded whole: O(file) memory on the host and the
# card (the JAX package's O(dict) sliding window runs on its native host
# codec, which the port does not carry).

def encode_file_alone(src, dst, params: LzmaParams | None = None,
                      device="cuda") -> int:
    """Encode file `src` into a `.lzma` (LZMA_Alone) file at `dst` through
    ``ops.api.encode_alone`` (the lazy parse; with params.write_eos the
    size field is -1 and the stream ends with the marker).  Reads the
    whole file: memory is O(file).  Returns the container size."""
    from ..ops import api

    params = (params or LzmaParams()).validated_for_encode()
    with open(src, "rb") as f:
        data = f.read()
    out = api.encode_alone(data, params, device=device)
    with open(dst, "wb") as f:
        f.write(out)
    return len(out)


def decode_file_alone(src, dst, device="cuda") -> int:
    """Decode a `.lzma` (LZMA_Alone) file, known-size or EOS-terminated,
    to `dst` through ``ops.api.decode_alone``.  Reads the whole file:
    memory is O(file).  Returns the decoded size."""
    from ..ops import api

    with open(src, "rb") as f:
        out = api.decode_alone(f.read(), device=device)
    with open(dst, "wb") as f:
        f.write(out)
    return len(out)
