"""Direct and one-hot gathers on the H100: the counterpart of
``tools/probe_gather.py`` (``probe_native``, ``probe_onehot``,
``probe_scatter``).

The TPU probe asked whether a per-lane dynamic gather lowers at all, and
what the one-hot masked reduction the kernels used instead costs at each
width.  On Hopper a lane indexes its row directly; ``probe_native`` does
so with the rows in shared memory or in device memory, and
``probe_onehot`` / ``probe_scatter`` take the TPU's one-hot forms
literally (``csrc/probe_gather.cu``), to measure what direct indexing
saves.  With arr (n, width) int32 and idx (n,) int32, each step t:

    probe_native, probe_onehot   acc += arr[i, (idx_i + t) % width]
    probe_scatter                s[i, (idx_i + t) % width] = t, then the
                                 sum of each row of s (s starts as arr)

Each returns (n,) int32; idx is taken modulo the width as a floor
(Python's %), so any int32 is an index.  A CUDA tensor launches the
kernel; a CPU tensor takes the plain version.

    python -m lzma_tpu_torch.probes.probe_gather    # the table, on the card
"""

from __future__ import annotations

import functools
from collections import Counter

import torch

from ..runtime.card import smem_limit
from . import _cuda

N = 32
ITERS = 2048
WIDTHS = (128, 256, 512, 1024, 4096, 8192)
#: a direct gather's step is a few ns, so its slope is taken over this
#: many steps (a launch of ITERS is bound by the host's submission)
NATIVE_SLOPE_ITERS = 32 * ITERS
PLACEMENTS = ("shared", "device")

#: kernel launches by function since the counts were last cleared
LAUNCHES = Counter()


def inputs(width: int, n: int = N, device="cuda"):
    """The TPU probe's inputs: arr = arange(n * width) % 1000 as (n,
    width), idx = arange(n) % width."""
    arr = torch.arange(n * width, dtype=torch.int32, device=device).reshape(
        n, width) % 1000
    idx = torch.arange(n, dtype=torch.int32, device=device) % width
    return arr, idx


def scatter_inputs(width: int, n: int = N, device="cuda"):
    """probe_scatter's: arr zeros, idx = arange(n) % width."""
    return (torch.zeros((n, width), dtype=torch.int32, device=device),
            torch.arange(n, dtype=torch.int32, device=device) % width)


def lanes_per_block(width: int, device) -> int:
    """Rows of `width` int32 a block stages in shared memory: as many as
    the card's opt-in shared memory per block holds, at most 32."""
    lpb = min(32, smem_limit(device.index or 0) // (width * 4))
    if lpb < 1:
        raise ValueError(f"a row of {width} int32 is over the block's shared memory")
    return lpb


@functools.cache
def _kernels():
    P, I = _cuda.P, _cuda.I
    return (_cuda.kernel("lzt_probe_native", [I, P, P, P, I, I, I, I, P]),
            _cuda.kernel("lzt_probe_onehot", [I, P, P, P, I, I, I, P]))


def _checked(what, arr, idx):
    _cuda.check(what, arr, idx)
    if arr.dim() != 2 or idx.shape != arr.shape[:1] or arr.shape[1] < 1:
        raise ValueError(f"{what}: arr (n, width >= 1) and idx (n,), got "
                         f"{tuple(arr.shape)} and {tuple(idx.shape)}")
    return _cuda.on_device(arr, what)


def probe_native_plain(arr, idx, iters):
    n, width = arr.shape
    rows = torch.arange(n, device=arr.device)
    acc = torch.zeros((n,), dtype=torch.int32, device=arr.device)
    for t in range(iters):
        acc = acc + arr[rows, (idx + t) % width]
    return acc


def probe_onehot_plain(arr, idx, iters):
    n, width = arr.shape
    cols = torch.arange(width, device=arr.device)[None, :]
    acc = torch.zeros((n,), dtype=torch.int32, device=arr.device)
    for t in range(iters):
        m = cols == ((idx + t) % width)[:, None]
        acc = acc + torch.where(m, arr, 0).sum(dim=1, dtype=torch.int32)
    return acc


def probe_scatter_plain(arr, idx, iters):
    n, width = arr.shape
    cols = torch.arange(width, device=arr.device)[None, :]
    s = arr.clone()
    for t in range(iters):
        s = torch.where(cols == ((idx + t) % width)[:, None], t, s)
    return s.sum(dim=1, dtype=torch.int32)


def probe_native(arr, idx, iters: int = ITERS, placement: str = "shared"):
    """Each lane's sum of iters direct gathers, (n,) int32."""
    if not _checked("probe_native", arr, idx):
        return probe_native_plain(arr, idx, iters)
    if placement not in PLACEMENTS:
        raise ValueError(f"placement must be one of {PLACEMENTS}, got {placement!r}")
    n, width = arr.shape
    out = torch.empty((n,), dtype=torch.int32, device=arr.device)
    with torch.cuda.device(arr.device):
        err = _kernels()[0](int(placement == "shared"), arr.data_ptr(),
                            idx.data_ptr(), out.data_ptr(), n, width, iters,
                            lanes_per_block(width, arr.device), _cuda.stream(arr))
    _cuda.raise_on(err, "probe_native")
    LAUNCHES["probe_native"] += 1
    return out


def _onehot(scatter, what, arr, idx, iters):
    n, width = arr.shape
    out = torch.empty((n,), dtype=torch.int32, device=arr.device)
    with torch.cuda.device(arr.device):
        err = _kernels()[1](scatter, arr.data_ptr(), idx.data_ptr(),
                            out.data_ptr(), n, width, iters, _cuda.stream(arr))
    _cuda.raise_on(err, what)
    LAUNCHES[what] += 1
    return out


def probe_onehot(arr, idx, iters: int = ITERS):
    """probe_native's sum through the one-hot masked reduction, a warp
    a lane, (n,) int32."""
    if not _checked("probe_onehot", arr, idx):
        return probe_onehot_plain(arr, idx, iters)
    return _onehot(0, "probe_onehot", arr, idx, iters)


def probe_scatter(arr, idx, iters: int = ITERS):
    """The one-hot scatter of t at each step's column, then each row's
    sum, (n,) int32."""
    if not _checked("probe_scatter", arr, idx):
        return probe_scatter_plain(arr, idx, iters)
    return _onehot(1, "probe_scatter", arr, idx, iters)


def sweep(device, widths=WIDTHS, iters=ITERS):
    """The probe's table on the card: (form, width, ms a launch of
    `iters` steps, ns a step) for the direct gather in each placement
    (its slope over NATIVE_SLOPE_ITERS), the one-hot gather and the
    one-hot scatter, by CUDA events (_cuda.per_step)."""
    rows = []
    for width in widths:
        arr, idx = inputs(width, device=device)
        zeros, _ = scatter_inputs(width, device=device)
        for placement in PLACEMENTS:
            rows.append((f"native {placement}", width, *_cuda.per_step(
                lambda k: probe_native(arr, idx, k, placement), iters,
                slope_iters=NATIVE_SLOPE_ITERS)))
        rows.append(("one-hot gather", width, *_cuda.per_step(
            lambda k: probe_onehot(arr, idx, k), iters)))
        rows.append(("one-hot scatter", width, *_cuda.per_step(
            lambda k: probe_scatter(zeros, idx, k), iters)))
    return rows


def main():
    dev = _cuda.cuda_device()
    _cuda.print_table(
        f"probe_gather: {N} lanes, {ITERS} steps",
        [(f"{form:15s} w={width:5d}", f"{ms:8.3f} ms, {ns:9.1f} ns/iter")
         for form, width, ms, ns in sweep(dev)])


if __name__ == "__main__":
    main()
