"""File objects over the LZTB container and `.lzma` streams, on the device.

Port of ``lzma_tpu/parallel/fileobj.py``.  ``open_lztb(path, "wb")``
returns a writer that takes incremental ``write()`` calls with O(batch)
memory and a size unknown until ``close()``; ``open_lztb(path, "rb")`` a
reader with incremental ``read()``.  Both run on filestream's backend
(the card's encoder and K1, their plain versions for a CPU `device`),
batched by its sizer, and write and read the bytes of
``filestream.encode_file`` / ``decode_file``.

The LZTB header carries num_blocks and the size table before the
payload, but a streaming writer learns both only at close(): payload
batches stream to an anonymous spill file, and close() writes the
header and the table and splices the payload in (one sequential copy of
the compressed bytes).

``AloneWriter`` and ``AloneReader`` are whole-buffer adapters for the
`.lzma` container: the device codec codes one stream as one lane, so
the writer buffers every write and encodes on close(), and the reader
decodes the whole stream on its first read.  Their memory is O(file).
"""

from __future__ import annotations

import dataclasses
import io
import os
import shutil
import struct
import tempfile

from ..core.rangecoder import CorruptStreamError
from ..format.properties import LzmaParams
from . import blocks as blk
from .filestream import (
    DEFAULT_BATCH_BYTES,
    _backend,
    _decode_batch,
    _encode_batch,
    check_total_size_plausible,
    decode_batch_blocks,
    encode_batch_blocks,
)


class LZTBWriter(io.RawIOBase):
    """Incremental LZTB writer: buffers up to a batch of input (the
    sizer's blocks, at most batch_bytes), then encodes it on `device` to
    a spill file; close() assembles the container."""

    def __init__(self, target, params: LzmaParams | None = None,
                 block_size: int = blk.DEFAULT_BLOCK_SIZE,
                 parse: str = "optimal", preset_len: int = 0,
                 dictionary: bytes = b"",
                 batch_bytes: int = DEFAULT_BATCH_BYTES, device="cuda"):
        # until construction completes, close() must be a no-op (the
        # io finalizer calls it even when __init__ raises)
        self._closed = True
        self._params = (params or LzmaParams()).validated_for_encode()
        if self._params.write_eos:
            raise ValueError("block container uses known sizes; EOS not supported")
        if block_size < 1:
            raise ValueError("block_size must be positive")
        self._block_size = block_size
        self._preset_req = blk.validated_preset_len(
            preset_len, block_size, 1 << 62)
        self._dictionary = blk.validated_dictionary(dictionary, preset_len)
        self._preset = self._dictionary
        self._batch_bytes = block_size * encode_batch_blocks(
            parse, block_size, self._preset_req, batch_bytes, device,
            len(self._dictionary))
        self._enc, _ = _backend(parse, device)
        self._own_target = isinstance(target, (str, os.PathLike))
        self._out = open(target, "wb") if self._own_target else target
        try:
            self._spill = tempfile.TemporaryFile()
        except Exception:
            if self._own_target:
                self._out.close()
            raise
        self._buf = bytearray()
        self._sizes: list[int] = []
        self._total = 0
        self._closed = False

    # -- io plumbing --
    def writable(self):
        return True

    def write(self, data) -> int:
        if self._closed:
            raise ValueError("I/O operation on closed file")
        with memoryview(data) as mv:
            n = mv.nbytes
            self._buf.extend(mv)
        self._total += n
        while len(self._buf) >= self._batch_bytes:
            # one copy per flushed batch
            with memoryview(self._buf) as mv:
                chunk = bytes(mv[: self._batch_bytes])
            del self._buf[: self._batch_bytes]
            self._flush_batch(chunk)
        return n

    def _flush_batch(self, chunk: bytes) -> None:
        # shared with encode_file: the v2 first-batch split lives in ONE
        # place (filestream._encode_batch); a stored dictionary primes
        # every batch alike
        payload, sizes, self._preset = _encode_batch(
            self._enc, chunk, self._params, self._block_size,
            0 if self._dictionary else self._preset_req, self._preset,
            first=not self._sizes)
        self._spill.write(payload)
        self._sizes.extend(sizes)

    def close(self) -> None:
        if self._closed:
            return
        try:
            if self._buf:
                self._flush_batch(bytes(self._buf))
                self._buf.clear()
            n = len(self._sizes)
            dict_stream = b""
            if self._dictionary and n > 0:
                (dict_stream,) = self._enc([self._dictionary], self._params)
                preset_len, dict_len = 0, len(self._dictionary)
            else:
                preset_len = len(self._preset) if n > 1 else 0
                dict_len = 0
            head = blk.pack_header(self._params, self._block_size,
                                   self._total, n, preset_len,
                                   dict_len, len(dict_stream))
            self._out.write(head)
            self._out.write(struct.pack(f"<{n}I", *self._sizes))
            self._out.write(dict_stream)
            self._spill.seek(0)
            shutil.copyfileobj(self._spill, self._out)
        finally:
            self._spill.close()
            if self._own_target:
                self._out.close()
            self._closed = True
            super().close()


class LZTBReader(io.RawIOBase):
    """Incremental LZTB reader: decodes a batch of blocks at a time on
    `device` and serves `read()` from the decoded buffer."""

    def __init__(self, source, batch_bytes: int = DEFAULT_BATCH_BYTES,
                 device="cuda"):
        self._closed = True  # no-op close() until fully constructed
        _, self._dec = _backend("lazy", device)
        self._own_source = isinstance(source, (str, os.PathLike))
        self._in = open(source, "rb") if self._own_source else source
        try:
            (self._params, self._block_size, self._total, self._n,
             self._preset_len, dict_len, dict_comp, _) = blk.read_header(
                self._in)
            # anti-DoS (same guard as decode_file): total_size drives the
            # decoders' output allocations
            check_total_size_plausible(self._total, self._in)
            table = self._in.read(4 * self._n)
            if len(table) < 4 * self._n:
                raise CorruptStreamError("container size table truncated")
            self._comp_sizes = struct.unpack(f"<{self._n}I", table)
            self._batch_blocks = decode_batch_blocks(
                self._params, self._block_size, max(self._comp_sizes, default=0),
                self._preset_len or dict_len, batch_bytes, device)
            self._next_block = 0
            self._done = 0
            self._preset = b""
            if dict_len:  # LZTB v3: the stored dictionary primes every block
                ds = self._in.read(dict_comp)
                if len(ds) < dict_comp:
                    raise CorruptStreamError("container dict stream truncated")
                (self._preset,) = self._dec([ds], self._params, [dict_len])
        except BaseException:
            if self._own_source:
                self._in.close()
            raise
        self._buf = memoryview(b"")
        self._closed = False

    def readable(self):
        return True

    def _fill(self) -> bool:
        """Decode the next batch into the buffer; False at EOF."""
        if self._next_block >= self._n:
            return False
        start = self._next_block
        batch = self._comp_sizes[start : start + self._batch_blocks]
        need = sum(batch)
        payload = self._in.read(need)
        if len(payload) < need:
            raise CorruptStreamError("container payload truncated")
        batch_total = min(self._block_size * len(batch), self._total - self._done)
        # shared with decode_file: the v2 first-batch split and the
        # size-mismatch check live in filestream._decode_batch
        out, self._preset = _decode_batch(
            self._dec, payload, self._params, self._block_size, batch_total,
            batch, self._preset_len, self._preset, first=start == 0)
        self._next_block = start + len(batch)
        self._done += batch_total
        self._buf = memoryview(out)
        return True

    def read(self, size: int = -1) -> bytes:
        if self._closed:
            raise ValueError("I/O operation on closed file")
        parts = []
        remaining = None if size is None or size < 0 else size
        while remaining is None or remaining > 0:
            if not self._buf:
                if not self._fill():
                    break
            take = len(self._buf) if remaining is None else min(remaining, len(self._buf))
            parts.append(bytes(self._buf[:take]))
            self._buf = self._buf[take:]
            if remaining is not None:
                remaining -= take
        return b"".join(parts)

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)

    def close(self) -> None:
        if not self._closed:
            if self._own_source:
                self._in.close()
            self._closed = True
        super().close()


def open_lztb(path, mode: str = "rb", **kw):
    """Open an LZTB container for streaming ('rb' -> LZTBReader,
    'wb' -> LZTBWriter).  Keyword args pass through to the class."""
    if mode in ("rb", "r"):
        return LZTBReader(path, **kw)
    if mode in ("wb", "w"):
        return LZTBWriter(path, **kw)
    raise ValueError(f"mode must be 'rb' or 'wb', not {mode!r}")


# --- .lzma (LZMA_Alone) single-stream file objects --------------------------

class AloneWriter(io.RawIOBase):
    """Writer of a `.lzma` (LZMA_Alone) stream, whole-buffer: every write
    is buffered, and close() encodes the lot as one lane on `device`
    (``ops.api.encode_alone``, the lazy parse) with the size field -1 and
    the end-of-stream marker, the reference's unknown-size mode
    (LzmaAlone.java:215-217).  Memory is O(file)."""

    def __init__(self, target, params: LzmaParams | None = None,
                 device="cuda"):
        super().__init__()
        p = dataclasses.replace(params or LzmaParams(), write_eos=True)
        self._params = p.validated_for_encode()
        self._device = device
        self._owns = not hasattr(target, "write")
        self._file = open(target, "wb") if self._owns else target
        self._buf = bytearray()

    def writable(self):
        return True

    def write(self, data) -> int:
        if self.closed:
            raise ValueError("write after close")
        with memoryview(data) as mv:
            self._buf.extend(mv)
            return mv.nbytes

    def close(self):
        if self.closed:
            return
        from ..ops import api

        try:
            self._file.write(api.encode_alone(bytes(self._buf), self._params,
                                              device=self._device))
        finally:
            self._buf = bytearray()
            if self._owns:
                self._file.close()
            super().close()


class AloneReader(io.RawIOBase):
    """Reader of a `.lzma` (LZMA_Alone) stream, known-size or
    EOS-terminated, whole-buffer: the first read decodes the whole stream
    on `device` (``ops.api.decode_alone``) and later reads serve it.  The
    header is checked on open.  Memory is O(file)."""

    def __init__(self, source, device="cuda"):
        super().__init__()
        from ..format.properties import decode_props

        self._owns = not hasattr(source, "read")
        self._file = open(source, "rb") if self._owns else source
        try:
            head = self._file.read(13)
            if len(head) < 13:
                raise CorruptStreamError(".lzma input too short")
            try:
                decode_props(head[:5])
            except ValueError as e:
                raise CorruptStreamError(str(e)) from e
        except BaseException:
            if self._owns:
                self._file.close()
            raise
        self._head, self._device, self._out = head, device, None

    def readable(self):
        return True

    def read(self, size: int = -1) -> bytes:
        if self.closed:
            raise ValueError("read on closed file")
        if self._out is None:
            from ..ops import api

            self._out = memoryview(api.decode_alone(
                self._head + self._file.read(), device=self._device))
        take = len(self._out) if size is None or size < 0 else size
        out, self._out = bytes(self._out[:take]), self._out[take:]
        return out

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)

    def close(self):
        if self.closed:
            return
        if self._owns:
            self._file.close()
        super().close()
