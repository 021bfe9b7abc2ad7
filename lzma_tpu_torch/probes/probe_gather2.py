"""Dependent gather+scatter chains on the H100: the counterpart of
``tools/probe_gather2.py`` (``probe_chain``, ``probe_taa``).

The TPU probe asked how the one-hot gather+scatter pair scales with the
lane count, and what adding pairs to the dependency chain costs.  Here
(``csrc/probe_gather.cu``) a thread per lane runs ``n_gathers`` dependent
pairs a step on its own row, in shared or device memory:

    v = row[(idx + t + v) % width] & 1023;  row[...] = v + 1

so the time a step is the latency of the chain of pairs: what the DP
scans' finalize step (K3) and every decode step wait on.  ``probe_chain``
returns each lane's last v (idx taken modulo the width as a floor),
``probe_taa`` one gather a lane, ``arr[i, idx_i]`` (0 where idx_i lies
outside the row), both (n,) int32.  A CUDA tensor launches the kernel; a
CPU tensor takes the plain version.

    python -m lzma_tpu_torch.probes.probe_gather2    # the table, on the card
"""

from __future__ import annotations

import functools
from collections import Counter

import torch

from . import _cuda
from .probe_gather import PLACEMENTS, _checked, lanes_per_block

ITERS = 4096
#: the TPU probe's rows: (lanes, width, pairs a step)
CHAINS = tuple((n, w, 1) for n in (8, 32, 64, 128, 256) for w in (2688, 8064)) \
    + tuple((64, 4096, g) for g in (1, 2, 4))
TAA_WIDTHS = (128, 512)

#: kernel launches by function since the counts were last cleared
LAUNCHES = Counter()


def chain_inputs(n: int, width: int, device="cuda"):
    """The TPU probe's: arr = (arange(n * width) * 7) % 1000 as (n,
    width), idx = arange(n) % width."""
    arr = (torch.arange(n * width, dtype=torch.int32, device=device).reshape(
        n, width) * 7) % 1000
    idx = torch.arange(n, dtype=torch.int32, device=device) % width
    return arr, idx


def taa_inputs(n: int, width: int, device="cuda"):
    """probe_taa's: arr = arange(n * width) as (n, width), idx =
    (arange(n) * 37) % width."""
    arr = torch.arange(n * width, dtype=torch.int32, device=device).reshape(n, width)
    idx = (torch.arange(n, dtype=torch.int32, device=device) * 37) % width
    return arr, idx


@functools.cache
def _kernels():
    P, I = _cuda.P, _cuda.I
    return (_cuda.kernel("lzt_probe_chain", [I, I, P, P, P, I, I, I, I, P]),
            _cuda.kernel("lzt_probe_taa", [P, P, P, I, I, P]))


def probe_chain_plain(arr, idx, n_gathers, iters):
    n, width = arr.shape
    rows = torch.arange(n, device=arr.device)
    a = arr.clone()
    v = torch.zeros((n,), dtype=torch.int32, device=arr.device)
    for t in range(iters):
        for _ in range(n_gathers):
            ii = (idx + t + v) % width
            v = a[rows, ii] & 1023
            a[rows, ii] = v + 1
    return v


def probe_taa_plain(arr, idx):
    inside = (idx >= 0) & (idx < arr.shape[1])
    got = arr.gather(1, torch.where(inside, idx, 0).long()[:, None])[:, 0]
    return torch.where(inside, got, 0)


def probe_chain(arr, idx, n_gathers: int, iters: int = ITERS,
                placement: str = "shared"):
    """Each lane's v after iters steps of n_gathers (1, 2 or 4 on the
    card) dependent gather+scatter pairs, (n,) int32.  arr is not
    changed."""
    if not _checked("probe_chain", arr, idx):
        return probe_chain_plain(arr, idx, n_gathers, iters)
    if placement not in PLACEMENTS:
        raise ValueError(f"placement must be one of {PLACEMENTS}, got {placement!r}")
    n, width = arr.shape
    shared = placement == "shared"
    # the device-memory chain updates its rows in place: a copy of arr
    work = arr if shared else arr.clone()
    out = torch.empty((n,), dtype=torch.int32, device=arr.device)
    with torch.cuda.device(arr.device):
        err = _kernels()[0](int(shared), n_gathers, work.data_ptr(),
                            idx.data_ptr(), out.data_ptr(), n, width, iters,
                            lanes_per_block(width, arr.device), _cuda.stream(arr))
    if err == -1:
        raise ValueError(f"no chain kernel for {n_gathers} pairs a step")
    _cuda.raise_on(err, "probe_chain")
    LAUNCHES["probe_chain"] += 1
    return out


def probe_taa(arr, idx):
    """One gather a lane, arr[i, idx_i] (0 outside the row), (n,) int32:
    what the TPU's take_along_axis was checked to return."""
    if not _checked("probe_taa", arr, idx):
        return probe_taa_plain(arr, idx)
    n, width = arr.shape
    out = torch.empty((n,), dtype=torch.int32, device=arr.device)
    with torch.cuda.device(arr.device):
        err = _kernels()[1](arr.data_ptr(), idx.data_ptr(), out.data_ptr(), n,
                            width, _cuda.stream(arr))
    _cuda.raise_on(err, "probe_taa")
    LAUNCHES["probe_taa"] += 1
    return out


def sweep(device, chains=CHAINS, iters=ITERS):
    """The probe's table on the card: probe_taa's answer and µs a launch
    (a launch this small is bound by the host's submission) at each
    width, then (lanes, width, pairs, placement, ms a launch of `iters`
    steps, ns a step, ns a pair) for each chain, by CUDA events
    (_cuda.per_step)."""
    taa = []
    for width in TAA_WIDTHS:
        arr, idx = taa_inputs(16, width, device)
        taa.append((width, torch.equal(probe_taa(arr, idx),
                                       probe_taa_plain(arr, idx)),
                    _cuda.event_ms(lambda: probe_taa(arr, idx), 20) * 1e3))
    rows = []
    for n, width, g in chains:
        arr, idx = chain_inputs(n, width, device)
        for placement in PLACEMENTS:
            ms, ns = _cuda.per_step(
                lambda k: probe_chain(arr, idx, g, k, placement), iters)
            rows.append((n, width, g, placement, ms, ns, ns / g))
    return taa, rows


def main():
    dev = _cuda.cuda_device()
    taa, rows = sweep(dev)
    _cuda.print_table(
        f"probe_gather2: {ITERS} steps",
        [(f"taa w={w}", f"arr[i, idx_i] for every lane: {ok}, {us:.2f} us")
         for w, ok, us in taa]
        + [(f"chain n={n:3d} w={w} g={g} {pl:6s}",
            f"{ms:8.3f} ms, {ns:8.1f} ns/iter, {pair:7.1f} ns/pair")
           for n, w, g, pl, ms, ns, pair in rows])


if __name__ == "__main__":
    main()
