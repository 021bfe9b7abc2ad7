"""Per-lane copies at a dynamic offset into shared memory, on the H100:
the counterpart of ``tools/probe_dma.py`` (``probe1``, ``probe2``,
``probe3``).

The TPU probe asked whether a DMA of each lane's window, at a dynamic
(row, column) offset, lowers in Mosaic (P1), inside a loop too (P2), and
whether a scalar can be read from VMEM (P3).  On Hopper
(``csrc/probe_copy.cu``) the question is which copy engine takes which
offset.  One block stages the (8, 128) int32 tile, row i from
``src[i, o_i + r*128 : o_i + r*128 + 128]`` of an (8, 1024) source, in
one of ``FORMS``:

    plain    loads and stores
    async4   cp.async, 4 bytes a thread
    async16  cp.async, 16 bytes a thread
    bulk     TMA bulk copies, one a row, on one mbarrier (expect_tx)

async16 and bulk need 16-byte-aligned addresses: offsets 3 and 777 int32
are 12 and 3,108 bytes into their rows, so those rows are refused on the
host, before any launch, and never copied another way.  A refused row
of the output is -1 on the card and in the plain version alike.  A
launch of one block is bound by the host's submission, so the table
reports, beside its time, the SM cycles the kernel counts from the
first copy's issue to the barrier after the last wait.
``probe1`` stages one round, ``probe2`` two (the sum; the mbarrier's
phase flips each round); each returns (out (8, 128) int32, the refused
lanes).  ``probe3`` returns x + x[3, 5] for an (8, 128) int32 x, the
scalar read from shared memory.  A CUDA tensor launches the kernel; a
CPU tensor takes the plain version.

    python -m lzma_tpu_torch.probes.probe_dma    # the table, on the card
"""

from __future__ import annotations

import functools
from collections import Counter

import torch

from . import _cuda

N, M, C = 8, 1024, 128
OFFS1 = (0, 8, 16, 120, 3, 500, 777, 896)
OFFS2 = (0, 8, 16, 120, 3, 500, 700, 640)
ROUNDS = {"probe1": 1, "probe2": 2}
#: the copy forms of csrc/probe_copy.cu, by id
FORMS = {"plain": 0, "async4": 1, "async16": 2, "bulk": 3}
#: the forms that need 16-byte-aligned addresses
ALIGNED = ("async16", "bulk")
#: the shared-memory destination rows are 512 B apart: aligned for all
ALIGN = 16

#: kernel launches by function since the counts were last cleared
LAUNCHES = Counter()


def source(device="cuda") -> torch.Tensor:
    """The TPU probe's source: arange(8 * 1024) as (8, 1024) int32."""
    return torch.arange(N * M, dtype=torch.int32, device=device).reshape(N, M)


def tile(device="cuda") -> torch.Tensor:
    """probe3's input: arange(8 * 128) as (8, 128) int32."""
    return torch.arange(N * C, dtype=torch.int32, device=device).reshape(N, C)


def offsets(offs, device="cuda") -> torch.Tensor:
    return torch.tensor(offs, dtype=torch.int32, device=device)


def reference(offs, rounds: int = 1) -> torch.Tensor:
    """What the JAX probe asserts, on the CPU: row i the sum over rounds
    r of arange(i*M + o_i + r*C, ... + C)."""
    return torch.stack([
        sum(torch.arange(i * M + o + r * C, i * M + o + r * C + C,
                         dtype=torch.int32) for r in range(rounds))
        for i, o in enumerate(offs)])


def refused(src, offs, form: str, row_start=None):
    """The lanes `form` may not copy: for the aligned forms, each lane
    whose row segment does not start on a 16-byte boundary
    (`row_start(i, o)` gives the segment's first int32 in src; the
    default is i*M + o).  Decided on the host, before any launch."""
    if form not in FORMS:
        raise ValueError(f"form must be one of {tuple(FORMS)}, got {form!r}")
    if form not in ALIGNED:
        return []
    start = row_start or (lambda i, o: i * M + o)
    return [i for i, o in enumerate(offs)
            if (src.data_ptr() + 4 * start(i, o)) % ALIGN]


def _mask(lanes_refused):
    return sum(1 << i for i in range(N) if i not in lanes_refused)


def check_tile(src, offs_t, rounds):
    """Validate src (8, 1024), offs (8,) int32 on one device and every
    row segment inside its row; returns the offsets on the host."""
    _cuda.check("probe_dma", src, offs_t)
    if tuple(src.shape) != (N, M) or tuple(offs_t.shape) != (N,):
        raise ValueError(f"src (8, 1024) and offs (8,), got {tuple(src.shape)} "
                         f"and {tuple(offs_t.shape)}")
    offs = [int(o) for o in offs_t.tolist()]
    if any(o < 0 or o + rounds * C > M for o in offs):
        raise ValueError(f"offsets {offs} leave the row in {rounds} rounds")
    return offs


@functools.cache
def _kernels():
    P, I = _cuda.P, _cuda.I
    return (_cuda.kernel("lzt_probe_copy", [I, P, P, I, I, P, P, P, P]),
            _cuda.kernel("lzt_probe_scalar", [P, P, P, P]))


def copy_plain(src, offs, rounds, lanes_refused):
    out = torch.full((N, C), -1, dtype=torch.int32, device=src.device)
    for i, o in enumerate(offs):
        if i not in lanes_refused:
            out[i] = sum(src[i, o + r * C:o + r * C + C] for r in range(rounds))
    return out


def _copy(what, src, offs_t, form):
    rounds = ROUNDS[what]
    offs = check_tile(src, offs_t, rounds)
    lanes_refused = refused(src, offs, form)
    if not _cuda.on_device(src, what):
        return copy_plain(src, offs, rounds, lanes_refused), lanes_refused
    out = torch.full((N, C), -1, dtype=torch.int32, device=src.device)
    mask = _mask(lanes_refused)
    if mask:
        flag, cycles = scratch(src.device)
        launch(what, form, src, offs_t, mask, out, flag, cycles)
        raise_on_timeout(flag, f"{what} {form}")
    return out, lanes_refused


def scratch(device):
    """A launch's timeout flag ((1,) int32 zeros) and cycle count ((1,)
    int64)."""
    return (torch.zeros((1,), dtype=torch.int32, device=device),
            torch.zeros((1,), dtype=torch.int64, device=device))


def launch(what, form, src, offs_t, mask, out, err_flag, cycles):
    """One launch of csrc/probe_copy.cu's `what` (probe1 or probe2) in
    `form` over the rows in `mask`, which the caller has checked
    (check_tile, refused); the kernel's timeout flag is left in err_flag
    for raise_on_timeout and its staging's SM cycles in cycles."""
    with torch.cuda.device(src.device):
        err = _kernels()[0](FORMS[form], src.data_ptr(), offs_t.data_ptr(),
                            ROUNDS[what], mask, out.data_ptr(),
                            err_flag.data_ptr(), cycles.data_ptr(),
                            _cuda.stream(src))
    _cuda.raise_on(err, f"{what} {form}")
    LAUNCHES[what] += 1


def raise_on_timeout(err_flag, what):
    """Raise if a launch that shared `err_flag` gave up on a barrier."""
    if int(err_flag.max()):
        raise RuntimeError(f"{what}: a barrier wait timed out")


def probe1(src, offs, form: str = "bulk"):
    """Each lane's 128 int32 at its offset (offs (8,) int32), staged by
    `form`: (out (8, 128) int32, refused lanes)."""
    return _copy("probe1", src, offs, form)


def probe2(src, offs, form: str = "bulk"):
    """probe1 in a loop of two rounds, row i at o_i + r*128, summed."""
    return _copy("probe2", src, offs, form)


def probe3_plain(x):
    return x + x[3, 5]


def probe3(x):
    """x + x[3, 5] for x (8, 128) int32, the scalar read from shared
    memory."""
    _cuda.check("probe3", x)
    if tuple(x.shape) != (N, C):
        raise ValueError(f"probe3 takes (8, 128), got {tuple(x.shape)}")
    if not _cuda.on_device(x, "probe3"):
        return probe3_plain(x)
    return launch3(x, scratch(x.device)[1])


def launch3(x, cycles):
    """One launch of probe3's kernel; its SM cycles from the scalar's
    read to the barrier after the adds are left in cycles."""
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _kernels()[1](x.data_ptr(), out.data_ptr(), cycles.data_ptr(),
                            _cuda.stream(x))
    _cuda.raise_on(err, "probe3")
    LAUNCHES["probe3"] += 1
    return out


def sweep(device, reps: int = 20):
    """The probe's table on the card: for P1 and P2 in each form, (probe,
    form, refused lanes, equal to the JAX probe's reference on the rest,
    µs a launch by CUDA events, ns of the staging by the kernel's clock,
    the mean over the launches), then P3's."""
    src = source(device)
    flag, cycles = scratch(device)
    rows = []
    timed = functools.partial(clocked, cycles=cycles, reps=reps)
    for name, fn, offs in (("probe1", probe1, OFFS1), ("probe2", probe2, OFFS2)):
        offs_t = offsets(offs, device)
        want = reference(offs, ROUNDS[name])
        for form in FORMS:
            out, lanes = fn(src, offs_t, form)
            keep = [i for i in range(N) if i not in lanes]
            equal = torch.equal(out.cpu()[keep], want[keep])
            # the same launch, its rows decided once (no host sync between)
            us, ns = timed(lambda: launch(name, form, src, offs_t, _mask(lanes),
                                          out, flag, cycles))
            raise_on_timeout(flag, f"{name} {form}")
            rows.append((name, form, lanes, equal, us, ns))
    x = tile(device)
    equal = torch.equal(probe3(x).cpu(), tile("cpu") + 3 * C + 5)
    rows.append(("probe3", "scalar", [], equal, *timed(lambda: launch3(x, cycles))))
    return rows


def clocked(run, cycles, reps):
    """(µs a launch of run() by CUDA events, ns its kernel counted in
    `cycles`, the mean over the launches)."""
    total = torch.zeros_like(cycles)

    def once():
        run()
        total.add_(cycles)
    us = _cuda.event_ms(once, reps) * 1e3
    return us, _cuda.cycles_ns(total, cycles.device) / (reps + 1)


def describe(lanes, offs):
    if not lanes:
        return "all rows"
    return "refused: not 16-B aligned: " + ", ".join(
        f"lane {i} (offset {offs[i]} = {4 * offs[i]} B)" for i in lanes)


def main():
    dev = _cuda.cuda_device()
    offs = {"probe1": OFFS1, "probe2": OFFS2, "probe3": (0,) * N}
    _cuda.print_table(
        "probe_dma: per-lane copies into shared memory, one block",
        [(f"{name} {form:7s}", f"{us:7.2f} us a launch, {ns:7.1f} ns in the "
          f"kernel, {describe(lanes, offs[name])}; the rest equal the JAX "
          f"probe's reference: {equal}")
         for name, form, lanes, equal, us, ns in sweep(dev)])


if __name__ == "__main__":
    main()
