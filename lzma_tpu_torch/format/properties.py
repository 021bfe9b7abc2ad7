"""LZMA coder properties: the 5-byte header and the validated parameter set.

The port's own copy of what it uses from ``lzma_tpu/format/properties.py``.
Props byte = (pb*5 + lp)*9 + lc, then the 4-byte LE dictionary size
(Encoder.java:1079-1085, Decoder.java:303-318).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from ..core.constants import (
    DICT_LOG_SIZE_MAX_COMPRESS,
    MATCH_MAX_LEN,
    NUM_LIT_CONTEXT_BITS_MAX,
    NUM_LIT_POS_BITS_MAX,
    NUM_POS_STATES_BITS_MAX,
)

PROPS_SIZE = 5

MF_BT2 = "bt2"
MF_BT4 = "bt4"
MF_HC4 = "hc4"
MF_FAST4 = "fast4"

DEFAULT_DICT_LOG = 22        # Encoder.java:26
DEFAULT_FAST_BYTES = 0x20    # Encoder.java:27

#: loose bound on LZMA's expansion (output bytes per compressed byte);
#: the guard against forged sizes in container headers
MAX_EXPANSION = 8192


def validate_alone_size(out_size: int, payload_len: int) -> None:
    """Reject a `.lzma` 8-byte size field impossible for its payload before
    any output buffer is sized from it (properties.validate_alone_size).
    EOS-terminated streams (out_size < 0) are exempt."""
    if out_size >= 0 and out_size > payload_len * MAX_EXPANSION + (1 << 16):
        from ..core.rangecoder import CorruptStreamError

        raise CorruptStreamError(
            "claimed .lzma size is impossible for this payload")


@dataclass(frozen=True)
class LzmaParams:
    """Full encoder/decoder parameter set."""

    lc: int = 3
    lp: int = 0
    pb: int = 2
    dict_size: int = 1 << DEFAULT_DICT_LOG
    fast_bytes: int = DEFAULT_FAST_BYTES
    match_finder: str = MF_BT4
    write_eos: bool = False

    def validated_for_encode(self) -> "LzmaParams":
        if not (0 <= self.lc <= NUM_LIT_CONTEXT_BITS_MAX):
            raise ValueError(f"lc out of range 0..8: {self.lc}")
        if not (0 <= self.lp <= NUM_LIT_POS_BITS_MAX):
            raise ValueError(f"lp out of range 0..4: {self.lp}")
        if not (0 <= self.pb <= NUM_POS_STATES_BITS_MAX):
            raise ValueError(f"pb out of range 0..4: {self.pb}")
        if not (1 <= self.dict_size <= (1 << DICT_LOG_SIZE_MAX_COMPRESS)):
            raise ValueError(f"dict_size out of range 2^0..2^29: {self.dict_size}")
        if not (5 <= self.fast_bytes <= MATCH_MAX_LEN):
            raise ValueError(f"fast_bytes out of range 5..273: {self.fast_bytes}")
        if self.match_finder not in (MF_BT2, MF_BT4, MF_HC4, MF_FAST4):
            raise ValueError(f"unknown match finder: {self.match_finder}")
        return self

    @property
    def props_byte(self) -> int:
        return (self.pb * 5 + self.lp) * 9 + self.lc

    def encode_props(self) -> bytes:
        """5-byte properties header (Encoder.java:1079-1085)."""
        return bytes([self.props_byte]) + struct.pack("<I", self.dict_size)


def decode_props(props: bytes) -> LzmaParams:
    """Parse a 5-byte properties header (Decoder.java:303-318)."""
    if len(props) < PROPS_SIZE:
        raise ValueError("properties must be at least 5 bytes")
    val = props[0]
    lc = val % 9
    rem = val // 9
    lp = rem % 5
    pb = rem // 5
    if lc > NUM_LIT_CONTEXT_BITS_MAX or lp > 4 or pb > NUM_POS_STATES_BITS_MAX:
        raise ValueError(f"invalid properties byte {val:#x}")
    dict_size = struct.unpack("<I", props[1:5])[0]
    return LzmaParams(lc=lc, lp=lp, pb=pb, dict_size=dict_size)
