"""The five forms of a per-lane copy, on the H100: the counterpart of
``tools/probe_dma2.py`` (``run`` over its kernels ``kA``-``kE``).

The TPU probe bisected why a per-lane DMA did not lower by trying five
forms of it.  On Hopper each form is a TMA bulk copy into shared memory
(``csrc/probe_copy.cu``, ``probe_dma2``):

    kA  the whole (8, 128) tile: a bulk copy a row, one mbarrier
    kB  a copy a lane at the static offset 8i, each waited before the
        next, a barrier each
    kC  the same at the dynamic offsets (``probe_dma.OFFS1``)
    kD  a copy a lane at 8i, issued by the lane's own thread on its own
        barrier
    kE  the dynamic offsets, all eight on one barrier

A row whose segment is not 16-byte aligned (offsets 3 and 777 in kC and
kE) is refused on the host, before the launch, and is -1 in the output
on the card and in the plain version alike.  The table reports the SM
cycles each form's copies take inside the kernel beside the launch
time (see ``probe_dma``).  ``run`` returns (out (8,
128) int32, the refused lanes); a CUDA tensor launches the kernel, a
CPU tensor takes the plain version.

    python -m lzma_tpu_torch.probes.probe_dma2    # the table, on the card
"""

from __future__ import annotations

import functools
from collections import Counter

import torch

from . import _cuda
from .probe_dma import (C, M, N, OFFS1, _mask, check_tile, clocked, describe,
                        offsets, raise_on_timeout, refused, scratch, source)

#: the forms of csrc/probe_copy.cu's probe_dma2, by the TPU kernel's name
KERNELS = {"kA": 0, "kB": 1, "kC": 2, "kD": 3, "kE": 4}
DYNAMIC = ("kC", "kE")

#: kernel launches by function since the counts were last cleared
LAUNCHES = Counter()


def starts(kernel: str, offs):
    """Each lane's first int32 in src for `kernel`."""
    if kernel == "kA":
        return [i * M for i in range(N)]
    if kernel in DYNAMIC:
        return [i * M + o for i, o in enumerate(offs)]
    return [i * M + 8 * i for i in range(N)]


def expected(kernel: str, offs=OFFS1) -> torch.Tensor:
    """What the JAX probe's check asserts (ck_a, ck_static, ck_dyn), on
    the CPU."""
    return torch.stack([torch.arange(s, s + C, dtype=torch.int32)
                        for s in starts(kernel, offs)])


@functools.cache
def _kernel():
    P, I = _cuda.P, _cuda.I
    return _cuda.kernel("lzt_probe_dma2", [I, P, P, I, P, P, P, P])


def launch(kernel, src, offs_t, mask, out, err_flag, cycles):
    """One launch of `kernel` over the rows in `mask`, which the caller
    has checked; the timeout flag is left in err_flag, the copies' SM
    cycles in cycles."""
    with torch.cuda.device(src.device):
        err = _kernel()(KERNELS[kernel], src.data_ptr(), offs_t.data_ptr(), mask,
                        out.data_ptr(), err_flag.data_ptr(), cycles.data_ptr(),
                        _cuda.stream(src))
    _cuda.raise_on(err, f"probe_dma2 {kernel}")
    LAUNCHES["run"] += 1


def run_plain(src, first, lanes_refused):
    """The tile with row i the C int32 of src from its first[i]; a
    refused lane's row -1."""
    out = torch.full((N, C), -1, dtype=torch.int32, device=src.device)
    for i, s in enumerate(first):
        if i not in lanes_refused:
            out[i] = src.reshape(-1)[s:s + C]
    return out


def run(kernel: str, src, offs):
    """Stage the tile by the TPU kernel `kernel`'s form: (out (8, 128)
    int32, refused lanes).  offs (8,) int32 are read by kC and kE."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {tuple(KERNELS)}, got {kernel!r}")
    offs_h = check_tile(src, offs, 1)
    first = starts(kernel, offs_h)
    lanes = refused(src, first, "bulk", row_start=lambda i, s: s)
    if not _cuda.on_device(src, "run"):
        return run_plain(src, first, lanes), lanes
    out = torch.full((N, C), -1, dtype=torch.int32, device=src.device)
    mask = _mask(lanes)
    if mask:
        flag, cycles = scratch(src.device)
        launch(kernel, src, offs, mask, out, flag, cycles)
        raise_on_timeout(flag, f"probe_dma2 {kernel}")
    return out, lanes


def sweep(device, reps: int = 20):
    """The probe's table on the card: (kernel, refused lanes, equal to
    the JAX probe's check on the rest, µs a launch by CUDA events, ns of
    the copies by the kernel's clock, the mean over the launches)."""
    src, offs_t = source(device), offsets(OFFS1, device)
    flag, cycles = scratch(device)
    rows = []
    for kernel in KERNELS:
        out, lanes = run(kernel, src, offs_t)
        keep = [i for i in range(N) if i not in lanes]
        equal = torch.equal(out.cpu()[keep], expected(kernel)[keep])
        us, ns = clocked(lambda: launch(kernel, src, offs_t, _mask(lanes), out,
                                        flag, cycles), cycles, reps)
        raise_on_timeout(flag, f"probe_dma2 {kernel}")
        rows.append((kernel, lanes, equal, us, ns))
    return rows


def main():
    dev = _cuda.cuda_device()
    _cuda.print_table(
        "probe_dma2: the bulk-copy forms, one block",
        [(kernel, f"{us:7.2f} us a launch, {ns:7.1f} ns in the kernel, "
          f"{describe(lanes, OFFS1)}; the rest equal the JAX probe's check: "
          f"{equal}") for kernel, lanes, equal, us, ns in sweep(dev)])


if __name__ == "__main__":
    main()
