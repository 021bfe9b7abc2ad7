"""The device codec's surface: raw and `.lzma` streams, LZTB containers.

Port of ``lzma_tpu/ops/api.py`` (``encode_stream``, ``decode_stream``,
``encode_alone``, ``decode_alone``, ``encode_blocks``, ``decode_blocks``)
and the carry-over helper ``from_numpy``.  A single stream is one lane;
blocks are batched across lanes.  On a CUDA device the classify carry,
the optimal parse's DP scan, the range encoder and the decoder run as
the CUDA kernels of ``cuda_classify``, ``cuda_parser``,
``cuda_serializer`` and ``cuda_ring``, on the CPU as their plain PyTorch
versions.  The formats are ``lzma_tpu``'s (the port's copies are
``format/properties.py`` and ``parallel/blocks.py``), so either package
decodes the other's.  There is no host-codec fallback: a stream the
device path cannot decode raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.rangecoder import CorruptStreamError
from ..format.properties import LzmaParams, decode_props, validate_alone_size
from ..parallel import blocks as blk
from ..parallel.filestream import decode_batch_blocks, encode_batch_blocks
from .cuda_ring import decode_batch_cuda
from .device_decoder import CapExceededError
from .device_encoder import encode_batch

#: the `.lzma` size field of an EOS-terminated stream (size unknown)
UNKNOWN_SIZE = 0xFFFFFFFFFFFFFFFF


def from_numpy(*arrays, device="cuda"):
    """Tensors on `device` from numpy arrays, e.g. the JAX package's
    outputs (tokens, (ctx, bit) streams, padded comp buffers) passed
    through ``np.asarray``, so any stage of the port can be fed the
    reference stage's exact output.  The arrays are copied (the JAX
    package's are read-only).  Returns a tuple of tensors."""
    return tuple(torch.from_numpy(np.array(a, copy=True, order="C")).to(device)
                 for a in arrays)


def encode_stream(data: bytes, params: LzmaParams, device="cuda") -> bytes:
    """One raw LZMA stream on one lane (api.encode_stream): the lazy
    parse, ended by the EOS marker where ``params.write_eos``."""
    (s,) = encode_batch([data], params, write_eos=params.write_eos,
                        device=device)
    return s


def decode_stream(comp: bytes, params: LzmaParams, out_size: int,
                  device="cuda") -> bytes:
    """One raw LZMA stream of `out_size` bytes on one lane
    (api.decode_stream); a negative size -cap marks an EOS-terminated
    stream decoded up to cap bytes."""
    (d,) = decode_batch_cuda([comp], params, [out_size], device=device)
    return d


def encode_alone(data: bytes, params: LzmaParams, device="cuda") -> bytes:
    """A `.lzma` (LZMA_Alone) file (api.encode_alone): the 5 props bytes,
    the 8-byte size (all ones where ``params.write_eos``: the stream ends
    with the marker) and the stream."""
    size = UNKNOWN_SIZE if params.write_eos else len(data)
    return (params.encode_props() + size.to_bytes(8, "little")
            + encode_stream(data, params, device=device))


def decode_alone(data: bytes, device="cuda") -> bytes:
    """Decode a `.lzma` (LZMA_Alone) file (api.decode_alone).  A known size
    is checked against the payload before it sizes any buffer.  An
    EOS-terminated stream decodes under a cap that starts at 16 bytes a
    coded byte (64 KiB at least) and grows 4x each time the lane runs out
    of it, up to a ceiling: 273 bytes a coded byte plus 512 (the
    reference's bound) or $LZMA_TPU_DEVICE_EOS_CEILING (32 MiB unset),
    whichever is smaller; past that it raises CapExceededError.
    A corrupt stream raises CorruptStreamError; nothing falls back to a
    host decoder."""
    if len(data) < 13:
        raise CorruptStreamError(".lzma input too short")
    params = decode_props(data[:5])
    out_size = int.from_bytes(data[5:13], "little")
    comp_len = len(data) - 13
    if out_size != UNKNOWN_SIZE:
        validate_alone_size(out_size, comp_len)
        return decode_stream(data[13:], params, out_size, device=device)
    ceiling = min(273 * comp_len + 512,
                  int(os.environ.get("LZMA_TPU_DEVICE_EOS_CEILING", 1 << 25)))
    cap = min(max(16 * comp_len, 1 << 16), ceiling)
    while True:
        try:
            return decode_stream(data[13:], params, -cap, device=device)
        except CapExceededError as e:
            if cap >= ceiling:
                raise CapExceededError(
                    f"EOS stream not ended within the {ceiling}-byte "
                    "ceiling") from e
            cap = min(cap * 4, ceiling)


def encode_blocks(
    data: bytes,
    params: LzmaParams | None = None,
    block_size: int = 1 << 18,
    preset_len: int = 0,
    dictionary: bytes = b"",
    parse: str = "lazy",
    device="cuda",
) -> bytes:
    """Lane-parallel block encode to an LZTB container (api.encode_blocks).
    `preset_len > 0` writes LZTB v2 (block 0 plain, every other lane
    primed with block 0's prefix); `dictionary` writes LZTB v3 (the
    dictionary stored as its own stream, priming every lane).
    parse="optimal" tokenizes with the optimal-parse DP; preset-primed
    lanes keep the lazy parse.  On a CUDA device the lanes run in groups
    that fit its memory (``parallel.filestream.encode_batch_blocks``; all
    at once on the CPU): the bytes do not depend on the grouping."""
    params = (params or LzmaParams()).validated_for_encode()
    if params.write_eos:
        raise ValueError("block container uses known sizes; EOS not supported")
    preset_len = blk.validated_preset_len(preset_len, block_size, len(data))
    dictionary = blk.validated_dictionary(dictionary, preset_len)
    if len(data) <= block_size:
        preset_len = 0  # single block: the reference drops the preset too
    if not data:
        dictionary = b""
    blocks = blk.split_blocks(data, block_size)
    group = encode_batch_blocks(parse, block_size, preset_len,
                                max(len(blocks), 1) * block_size, device,
                                len(dictionary))

    def enc(bs, **kw):
        return [s for i in range(0, len(bs), group)
                for s in encode_batch(bs[i:i + group], params, device=device,
                                      **kw)]

    dict_stream = b""
    if dictionary:
        streams = enc(blocks, preset=dictionary)
        (dict_stream,) = enc([dictionary], parse=parse)
    elif preset_len:
        streams = enc(blocks[:1], parse=parse)
        streams += enc(blocks[1:], preset=data[:preset_len])
    else:
        streams = enc(blocks, parse=parse) if blocks else []
    return blk.build_container(params, block_size, len(data), streams,
                               preset_len, dict_stream, len(dictionary))


def decode_blocks(blob, device="cuda") -> bytes:
    """Lane-parallel block decode of an LZTB container, versions 1-3
    (api.decode_blocks with use_pallas=True), in groups of lanes that fit
    the card's memory (``parallel.filestream.decode_batch_blocks``)."""
    frame = blk.parse_container(blob)
    n = len(frame.comp_sizes)
    if n == 0:
        return b""
    offsets, sizes = frame.stream_extents(len(blob))
    streams = [bytes(blob[offsets[i] : offsets[i + 1]]) for i in range(n)]

    group = decode_batch_blocks(frame.params, frame.block_size,
                                max(frame.comp_sizes),
                                frame.preset_len or frame.dict_len,
                                n * frame.block_size, device)

    def dec(s, o, preset=b""):
        return [part for i in range(0, len(s), group)
                for part in decode_batch_cuda(s[i:i + group], frame.params,
                                              o[i:i + group], preset=preset,
                                              device=device)]

    if frame.dict_len:
        # LZTB v3: decode the stored dictionary on one lane, then all
        # blocks in parallel against it
        (dictionary,) = dec([bytes(blob[frame.payload_offset : frame.blocks_offset])],
                            [frame.dict_len])
        parts = dec(streams, sizes, preset=dictionary)
    elif frame.preset_len:
        # LZTB v2: block 0 decodes plain and is the preset source
        head = dec(streams[:1], sizes[:1])
        preset = head[0][: frame.preset_len]
        rest = dec(streams[1:], sizes[1:], preset=preset) if n > 1 else []
        parts = head + rest
    else:
        parts = dec(streams, sizes)
    out = b"".join(parts)
    if len(out) != frame.total_size:
        raise CorruptStreamError("decoded size mismatch")
    return out
