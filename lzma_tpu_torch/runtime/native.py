"""The host encoder of the hybrid pipeline, built with g++ and loaded with
ctypes.

The port's own copy of what ``lzma_tpu/runtime/native.py`` gives the
hybrid: ``encode_token_blocks`` (the lazy hybrid's serializer),
``encode_candidate_blocks`` (the optimal parser over the card's candidate
lists) and ``encode_stream`` (one raw stream, after a preset or not: an
LZTB v3 container's trained dictionary, and the sizes by which
``utils.autotune`` and ``utils.dicttrain`` choose).  The source is
``runtime/src/host_encoder.cpp``, the encoder half of the JAX package's
C++ runtime.  At first use it is
compiled with the JAX package's flags into ``lzma_tpu_torch/_build/``,
under a name made of the SHA-256 of the source, the flags and the host's
CPU model (``-march=native``), so an edited source builds anew and never
loads the JAX package's library.  A missing ``g++`` raises; there is no
fallback.

Usage: python -m lzma_tpu_torch.runtime.native
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from ..format.properties import LzmaParams

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "runtime", "src", "host_encoder.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")

#: lzma_tpu/runtime/build.py's flags
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-march=native",
            "-funroll-loops", "-fno-exceptions", "-pthread", "-Wall"]

_MF_INDEX = {"bt2": 0, "bt4": 1, "hc4": 2, "fast4": 3}

#: single-stream ceiling: the match finder's positions are int32
MAX_STREAM = (1 << 31) - (1 << 20)

_LOCK = threading.Lock()
_LIB: list = []


def _host_cpu() -> str:
    """The host's CPU model: -march=native builds for it, so a library
    built on another CPU is not loaded."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line
    except OSError:
        pass
    return platform.machine()


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    h.update(_host_cpu().encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libhost_encoder_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the host encoder unless the library for this source exists.
    Processes that build at once wait on a lock file; the first compiles,
    the others load its library.  Returns the library path."""
    lib = library_path()
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the hybrid's host encoder needs a "
                           "C++ compiler")
    with open(os.path.join(BUILD_DIR, "host_encoder.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(lib):
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                res = subprocess.run([cxx, *CXXFLAGS, SRC, "-o", tmp],
                                     capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(f"g++ failed on {SRC} "
                                       f"({res.returncode}):\n{res.stderr}")
                os.replace(tmp, lib)  # atomic: never a torn library
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
    return lib


def _lib() -> ctypes.CDLL:
    with _LOCK:
        if not _LIB:
            _LIB.append(_bind(ctypes.CDLL(build())))
        return _LIB[0]


def _bind(lib):
    p, i64, i32, u32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint32
    lib.lzt_encode.restype = i64
    lib.lzt_encode.argtypes = [ctypes.c_char_p, i64, i32, i32, i32, u32, i32,
                               i32, i32, i32, p, i64]
    lib.lzt_encode_pre.restype = i64
    lib.lzt_encode_pre.argtypes = [ctypes.c_char_p, i64, i64, i32, i32, i32,
                                   u32, i32, i32, i32, i32, p, i64]
    lib.lzt_encode_bound.restype = i64
    lib.lzt_encode_bound.argtypes = [i64]
    lib.lzt_encode_token_blocks.restype = i64
    lib.lzt_encode_token_blocks.argtypes = [
        p, i64, i64, i32, i32, i32, p, p, p, p, p, i64, i32, p, i64, p,
        ctypes.c_char_p, i64, i32]
    lib.lzt_encode_candidate_blocks.restype = i64
    lib.lzt_encode_candidate_blocks.argtypes = [
        p, i64, i64, i32, i32, i32, u32, i32, p, p, p, p, i64, i32, p, i64, p,
        ctypes.c_char_p, i64, i32]
    return lib


def available() -> bool:
    """Whether the host encoder is built or can be; a failed build
    raises in the entry points."""
    try:
        _lib()
        return True
    except RuntimeError:
        return False


def require(caller: str) -> None:
    """Build and load the host encoder for `caller`, which sizes its
    choices with it, or raise a RuntimeError whose cause is the build's
    error: the port has no scalar codec to size them with instead."""
    try:
        _lib()
    except (RuntimeError, OSError) as e:
        raise RuntimeError(f"{caller} needs the host encoder, which did not "
                           "build") from e


def _threads(num_threads: int) -> int:
    return num_threads if num_threads > 0 else (os.cpu_count() or 1)


def _c(a, dtype):
    return np.ascontiguousarray(a, dtype=dtype)


def encode_token_blocks(data_padded, block_size: int, lc: int, lp: int,
                        pb: int, t_pos, t_len, t_dist, tok_offsets,
                        tok_counts, num_threads: int = 0, preset: bytes = b"",
                        preset_first: bool = False):
    """Serialize each block's token stream (native.encode_token_blocks).
    data_padded: uint8, block i at [i * block_size, ...); t_*: flat int32
    with block-relative positions; tok_offsets/tok_counts: int64 a block.
    `preset` primes every block after block 0 (LZTB v2), or every block
    with `preset_first` (LZTB v3).  Returns (payload, [sizes])."""
    lib = _lib()
    num_blocks = len(tok_counts)
    data_padded = _c(data_padded, np.uint8)
    n = len(data_padded)
    cap = lib.lzt_encode_bound(n) + 4096 * num_blocks
    out = ctypes.create_string_buffer(cap)
    sizes = (ctypes.c_uint32 * num_blocks)()
    arrays = [_c(t_pos, np.int32), _c(t_len, np.int32), _c(t_dist, np.int32),
              _c(tok_offsets, np.int64), _c(tok_counts, np.int64)]
    total = lib.lzt_encode_token_blocks(
        data_padded.ctypes.data, n, block_size, lc, lp, pb,
        *(a.ctypes.data for a in arrays), num_blocks, _threads(num_threads),
        out, cap, sizes, preset, len(preset), 1 if preset_first else 0)
    if total < 0:
        raise ValueError(f"host token serialize failed: {total}")
    return out.raw[:total], list(sizes)


def encode_candidate_blocks(data_padded, block_size: int, lc: int, lp: int,
                            pb: int, dict_size: int, fb: int, cand_len,
                            cand_dist, cand_off, pos_base,
                            num_threads: int = 0, preset: bytes = b"",
                            preset_first: bool = False,
                            total_len: int | None = None):
    """The optimal parse over per-position ascending (len, dist) lists
    (native.encode_candidate_blocks).  cand_len/cand_dist: flat int32
    pairs; cand_off: int64, block i's table starts at pos_base[i] and has
    (primed length + 1) absolute pair indices.  `total_len` trims the
    last block's padding.  Returns (payload, [sizes])."""
    lib = _lib()
    num_blocks = len(pos_base)
    data_padded = _c(data_padded, np.uint8)
    n = len(data_padded) if total_len is None else int(total_len)
    cap = lib.lzt_encode_bound(len(data_padded)) + 4096 * num_blocks
    out = ctypes.create_string_buffer(cap)
    sizes = (ctypes.c_uint32 * num_blocks)()
    arrays = [_c(cand_len, np.int32), _c(cand_dist, np.int32),
              _c(cand_off, np.int64), _c(pos_base, np.int64)]
    total = lib.lzt_encode_candidate_blocks(
        data_padded.ctypes.data, n, block_size, lc, lp, pb, dict_size, fb,
        *(a.ctypes.data for a in arrays), num_blocks, _threads(num_threads),
        out, cap, sizes, preset, len(preset), 1 if preset_first else 0)
    if total < 0:
        raise ValueError(f"host candidate encode failed: {total}")
    return out.raw[:total], list(sizes)


def encode_stream(data: bytes, params: LzmaParams,
                  preset: bytes = b"") -> bytes:
    """One raw LZMA stream by the optimal parse with `params`' match
    finder (native.encode_stream).  A `preset` primes the window: matches
    and literal context reach into it, and only `data` is coded."""
    if len(data) + len(preset) > MAX_STREAM:
        raise ValueError("single LZMA stream too large for int32 window "
                         "positions")
    params = params.validated_for_encode()
    lib = _lib()
    cap = lib.lzt_encode_bound(len(data))
    out = ctypes.create_string_buffer(cap)
    args = (params.lc, params.lp, params.pb, params.dict_size,
            params.fast_bytes, _MF_INDEX[params.match_finder],
            1 if params.write_eos else 0, 1, out, cap)
    if preset:
        buf = preset + data
        n = lib.lzt_encode_pre(buf, len(buf), len(preset), *args)
    else:
        n = lib.lzt_encode(data, len(data), *args)
    if n < 0:
        raise ValueError(f"host encode failed: {n}")
    return out.raw[:n]


if __name__ == "__main__":
    print(build())
