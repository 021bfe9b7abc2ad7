"""The LZTB block container: header, size table, framing arithmetic.

The port's own copy of the container half of ``lzma_tpu/parallel/blocks.py``
(the host encode/decode loops there drive the scalar codec and are not
copied).  Both packages write and read the same bytes.  Layout, all
little-endian:

    magic  b"LZTB"                      4
    version u8 = 1 | 2 | 3              1
    props   5 bytes (lc/lp/pb + dict)   5   -- shared by every block
    block_size u32                      4   -- uncompressed bytes per block
    total_size u64                      8   -- original length
    num_blocks u32                      4
    preset_len u32                      4   -- version 2 only
    dict_len u32, dict_comp u32         8   -- version 3 only
    comp_sizes u32[num_blocks]          4*n
    [v3: the stored dictionary's stream]
    payload: concatenated raw LZMA streams (no per-block headers)

Version 2 primes every block i >= 1 with the first `preset_len` bytes of
block 0; version 3 primes every block with a stored dictionary.
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass

from ..core.rangecoder import CorruptStreamError
from ..format.properties import MAX_EXPANSION, LzmaParams, decode_props

MAGIC = b"LZTB"
VERSION = 1
VERSION_PRESET = 2
VERSION_TRAINED = 3
_HEAD = struct.Struct("<4sB5sIQI")
_PRESET_FIELD = struct.Struct("<I")
_DICT_FIELD = struct.Struct("<II")
#: the file codec's block size where a caller names none
DEFAULT_BLOCK_SIZE = 1 << 20
#: hard ceiling on stored-dictionary length (int32 window positions)
MAX_DICT_LEN = 1 << 27


@dataclass(frozen=True)
class BlockFrame:
    """Parsed container header + payload offsets."""

    params: LzmaParams
    block_size: int
    total_size: int
    comp_sizes: tuple
    payload_offset: int  # v3: the stored dict stream starts here
    preset_len: int = 0
    dict_len: int = 0  # v3 only: uncompressed stored-dictionary length
    dict_comp: int = 0  # v3 only: compressed dict stream size

    @property
    def blocks_offset(self) -> int:
        """Offset of the first block stream (skips the v3 dict stream)."""
        return self.payload_offset + self.dict_comp

    def stream_extents(self, blob_len: int):
        """(offsets, out_sizes) for the block streams: block i's
        compressed bytes live at [offsets[i], offsets[i+1]) and decode
        to out_sizes[i] bytes.  Raises CorruptStreamError when the
        payload is truncated."""
        offsets = [self.blocks_offset]
        for s in self.comp_sizes:
            offsets.append(offsets[-1] + s)
        if offsets[-1] > blob_len:
            raise CorruptStreamError("container payload truncated")
        n = len(self.comp_sizes)
        sizes = [self.block_size] * n
        if n:
            sizes[-1] = self.total_size - self.block_size * (n - 1)
        return offsets, sizes


def split_blocks(data: bytes, block_size: int):
    return [data[i : i + block_size] for i in range(0, len(data), block_size)]


def validated_preset_len(preset_len: int, block_size: int, total_size: int) -> int:
    """Clamp-and-check a requested shared-preset length: it must be a
    prefix of block 0, so at most min(block_size, total_size)."""
    if preset_len < 0:
        raise ValueError("preset_len must be >= 0")
    return min(preset_len, block_size, total_size)


def validated_dictionary(dictionary, preset_len: int = 0) -> bytes:
    """Check a stored-dictionary request (LZTB v3) against the format's
    bounds and its exclusivity with the v2 prefix preset."""
    dictionary = bytes(dictionary or b"")
    if dictionary and preset_len:
        raise ValueError("preset_len and a stored dictionary are exclusive")
    if len(dictionary) > MAX_DICT_LEN:
        raise ValueError(f"dictionary exceeds {MAX_DICT_LEN} bytes")
    return dictionary


def pack_header(params: LzmaParams, block_size: int, total_size: int,
                num_blocks: int, preset_len: int = 0,
                dict_len: int = 0, dict_comp: int = 0) -> bytes:
    """Fixed container header (everything before the size table).
    `dict_len`/`dict_comp` nonzero writes version 3; `preset_len`
    nonzero version 2; the two are exclusive."""
    if dict_len and preset_len:
        raise ValueError("preset_len and a stored dictionary are exclusive")
    version = (VERSION_TRAINED if dict_len
               else VERSION_PRESET if preset_len else VERSION)
    head = _HEAD.pack(
        MAGIC, version, params.encode_props(), block_size, total_size, num_blocks
    )
    if dict_len:
        head += _DICT_FIELD.pack(dict_len, dict_comp)
    elif preset_len:
        head += _PRESET_FIELD.pack(preset_len)
    return head


def build_container(params: LzmaParams, block_size: int, total_size: int,
                    streams, preset_len: int = 0,
                    dict_stream: bytes = b"", dict_len: int = 0) -> bytes:
    head = pack_header(params, block_size, total_size, len(streams),
                       preset_len, dict_len, len(dict_stream))
    sizes = struct.pack(f"<{len(streams)}I", *(len(s) for s in streams))
    return head + sizes + dict_stream + b"".join(streams)


def read_header(fileobj):
    """Stream-parse the fixed header from a file object (the reading twin
    of pack_header).  Returns (params, block_size, total_size,
    num_blocks, preset_len, dict_len, dict_comp, header_size)."""
    head = fileobj.read(_HEAD.size)
    if len(head) < _HEAD.size or head[:4] != MAGIC:
        raise CorruptStreamError("not an LZTB container")
    magic, version, props, block_size, total_size, n = _HEAD.unpack(head)
    preset_len = dict_len = dict_comp = 0
    header_size = _HEAD.size
    if version == VERSION_PRESET:
        field = fileobj.read(_PRESET_FIELD.size)
        if len(field) < _PRESET_FIELD.size:
            raise CorruptStreamError("LZTB v2 header truncated")
        (preset_len,) = _PRESET_FIELD.unpack(field)
        header_size += _PRESET_FIELD.size
        if preset_len > min(block_size, max(total_size, 1)):
            raise CorruptStreamError("preset_len exceeds block 0")
    elif version == VERSION_TRAINED:
        field = fileobj.read(_DICT_FIELD.size)
        if len(field) < _DICT_FIELD.size:
            raise CorruptStreamError("LZTB v3 header truncated")
        dict_len, dict_comp = _DICT_FIELD.unpack(field)
        header_size += _DICT_FIELD.size
        if not (1 <= dict_len <= MAX_DICT_LEN) or dict_comp < 1:
            raise CorruptStreamError("LZTB v3 dictionary geometry invalid")
        # dict_len drives an allocation before any decode, so a forged
        # length must be impossible for the claimed stream size
        if dict_len > dict_comp * MAX_EXPANSION + (1 << 16):
            raise CorruptStreamError(
                "claimed dict_len is impossible for this dict stream")
    elif version != VERSION:
        raise CorruptStreamError(f"unsupported LZTB version {version}")
    # decoders write block i at i*block_size into a total_size buffer, so
    # forged counts must die here
    if block_size < 1:
        raise CorruptStreamError("block_size must be positive")
    if n != (total_size + block_size - 1) // block_size and not (
        total_size == 0 and n == 0
    ):
        raise CorruptStreamError("block count inconsistent with total_size")
    return (decode_props(props), block_size, total_size, n, preset_len,
            dict_len, dict_comp, header_size)


def parse_container(blob) -> BlockFrame:
    head = io.BytesIO(bytes(blob[: _HEAD.size + _DICT_FIELD.size]))
    (params, block_size, total_size, n, preset_len,
     dict_len, dict_comp, off) = read_header(head)
    if len(blob) < off + 4 * n:
        raise CorruptStreamError("container size table truncated")
    if total_size > (len(blob) - off) * MAX_EXPANSION + (1 << 16):
        raise CorruptStreamError(
            "claimed total_size is impossible for this payload")
    if dict_comp > len(blob) - off - 4 * n:
        raise CorruptStreamError("container dict stream truncated")
    sizes = struct.unpack_from(f"<{n}I", blob, off)
    return BlockFrame(
        params=params,
        block_size=block_size,
        total_size=total_size,
        comp_sizes=sizes,
        payload_offset=off + 4 * n,
        preset_len=preset_len,
        dict_len=dict_len,
        dict_comp=dict_comp,
    )
