"""CRC-32 (reflected 0xEDB88320), the digest of the benchmark's checks.

The port's own copy of ``crc32`` from ``lzma_tpu/utils/crc.py`` (held
equal to it by the tests), the reference's SevenZip/CRC.java; zlib
computes the same polynomial.  The table that doubles as the BT4 hash
mixer lives in the host encoder's C++ (``runtime/src/host_encoder.cpp``).
"""

from __future__ import annotations

import zlib


def crc32(data) -> int:
    return zlib.crc32(bytes(data)) & 0xFFFFFFFF
