"""Build the CUDA kernels into a shared library and load it with ctypes.

Counterpart of ``lzma_tpu/runtime/build.py`` (which builds the C++ host
runtime).  At first use, each ``csrc/*.cu`` is compiled by its own ``nvcc`` for
Hopper (``sm_90a``), all at once, and the objects are linked into one
shared library with a plain C interface, under ``lzma_tpu_torch/_build/``,
named by the SHA-256 of the sources and flags: an edited source builds
anew, an unchanged one loads the cached library.  A missing ``nvcc``
raises; there is no fallback.

Usage: python -m lzma_tpu_torch.runtime.build [--verbose]
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """The kernel sources: every .cu file under csrc/ (headers are hashed
    too, since the .cu files include them)."""
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then the toolkit PyTorch
    itself finds.  Raises when there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"liblzma_tpu_torch_{source_hash()}.so")


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu unless the library for these sources exists.
    Returns the library path.  `verbose` adds ptxas register/spill
    reports and prints nvcc's output."""
    lib = library_path()
    if not os.path.exists(lib) or verbose:
        compile_to(lib, verbose)
    return lib


def compile_to(lib: str, verbose: bool = False) -> None:
    """One nvcc per source, started together, then one link into `lib`."""
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    work = tempfile.mkdtemp(dir=os.path.dirname(lib))
    try:
        jobs = []
        for src in sources():
            obj = os.path.join(work, os.path.basename(src) + ".o")
            cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
                   "-c", "-o", obj, src]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        logs = [(src, *p.communicate()) for src, _, p in jobs]
        for (src, out, err), (_, _, p) in zip(logs, jobs):
            if verbose:
                print(f"{os.path.basename(src)}:\n{out}{err}", file=sys.stderr)
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} ({p.returncode}):\n{err}")
        tmp = os.path.join(work, "lib.so")
        result = subprocess.run([nvcc(), "-shared", "-o", tmp,
                                 *(obj for _, obj, _ in jobs)],
                                capture_output=True, text=True)
        if result.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({result.returncode}):\n"
                               f"{result.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent build never sees a torn file
    finally:
        shutil.rmtree(work, ignore_errors=True)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    with _LOCK:
        lib = library_path()
        if lib not in _LOADED:
            _LOADED[lib] = ctypes.CDLL(build())
        return _LOADED[lib]


if __name__ == "__main__":
    print(build(verbose="--verbose" in sys.argv))
