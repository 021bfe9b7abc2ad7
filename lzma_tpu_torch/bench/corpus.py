"""The text part of the frozen benchmark corpus.

The port's own copy of ``text_part`` from ``lzma_tpu/bench/corpus.py``:
3 MiB of Python sources kept xz-compressed in the repository at
``lzma_tpu/bench/data/corpus_text.bin.xz``.  The file is read as data (it
is not a module) and checked against the same SHA-256.
"""

from __future__ import annotations

import hashlib
import lzma
import os

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TEXT_PATH = os.path.join(_ROOT, "lzma_tpu", "bench", "data", "corpus_text.bin.xz")
TEXT_SHA256 = "7077138c62b248a472eca5ce8ab94838a17f2d6746e3f4999bbb53f6617c287a"


def text_part() -> bytes:
    with open(TEXT_PATH, "rb") as fh:
        text = lzma.decompress(fh.read())
    if hashlib.sha256(text).hexdigest() != TEXT_SHA256:
        raise RuntimeError("committed corpus text part corrupted")
    return text
