"""What makes a decode step dear on the H100: the counterpart of
``tools/probe_fsm_cost2.py`` (``make``).

The TPU probe added three suspects to ``probe_fsm_cost.v1``'s step
(without its input byte): a loop whose condition reduces over the lanes,
a long chain of selects, and many registers carried through the loop.
Here (``csrc/probe_fsm.cu``, form ``make``) the chain of ``selects``
selects is unrolled, ``nregs`` registers ride the loop, and
``loop="while"`` ends the loop on a block-wide vote
(``__syncthreads_or``, the counterpart of ``jnp.any``).  ``make`` returns
each lane's ``bit + pos`` (n,) int32, or with ``digest=True`` (result,
digest), the digest the lane's sum of its arena, window and carried
registers (as ``probe_fsm_cost``); a CUDA tensor launches the kernel
(``placement`` "shared" or "device"), a CPU tensor takes the plain
version.

    python -m lzma_tpu_torch.probes.probe_fsm_cost2    # the table, on the card
"""

from __future__ import annotations

from collections import Counter

import torch

from . import _cuda
from .probe_fsm_cost import (PLACEMENTS, S, W, arena_step, lane_sum, run_kernel,
                             seeds)

ITERS = 8192
LOOPS = ("fori", "while")
#: the TPU probe's rows: (label, keyword arguments)
CASES = (
    ("fori plain", dict(loop="fori")),
    ("while plain", dict(loop="while")),
    ("fori +150sel", dict(loop="fori", selects=150)),
    ("while +150sel", dict(loop="while", selects=150)),
    ("fori +24regs", dict(loop="fori", nregs=24)),
    ("while +24regs", dict(loop="while", nregs=24)),
    ("while +24regs+120sel", dict(loop="while", nregs=24, selects=120)),
)
LANES = (32, 128)

#: kernel launches by function since the counts were last cleared
LAUNCHES = Counter()


def make_plain(seed, iters, loop, selects, nregs):
    n, dev = seed.shape[0], seed.device
    rows = torch.arange(n, device=dev)
    probs = torch.full((n, S), 1024, dtype=torch.int32, device=dev)
    win = torch.zeros((n, W), dtype=torch.int32, device=dev)
    bit = torch.zeros((n,), dtype=torch.int32, device=dev)
    pos = torch.zeros_like(bit)
    regs = [torch.full((n,), r + 1, dtype=torch.int32, device=dev)
            for r in range(nregs)]
    sd = seed * 131
    t = 0
    while (bool((pos < iters).any()) and t < iters) if loop == "while" \
            else t < iters:
        p = arena_step(probs, rows, sd, t, bit)
        bb = win[rows, (pos - p) & (W - 1)]
        win[rows, pos & (W - 1)] = bb + p
        x = bb
        for r in range(nregs):
            x = torch.where((x & 1) == 0, x + regs[r], x - regs[r])
            regs[r] = torch.where((x & 3) == 0, regs[r] + 1, regs[r])
        for _ in range(selects):
            x = torch.where((x & 1) == 0, x + 3, x >> 1)
        bit = (p + x) & 1
        pos = pos + 1
        t += 1
    return bit + pos, lane_sum(probs, win, *(r[:, None] for r in regs))


def make(seed, iters: int = ITERS, loop: str = "fori", selects: int = 0,
         nregs: int = 0, placement: str = "shared", digest: bool = False):
    """tools/probe_fsm_cost2.py make: each lane's bit + pos after `iters`
    steps, (n,) int32, or (result, digest).  selects is 0, 120 or 150 and
    nregs 0 or 24 on the card (the kernels the library holds); any on the
    CPU."""
    if loop not in LOOPS:
        raise ValueError(f"loop must be one of {LOOPS}, got {loop!r}")
    if not _cuda.on_device(seed, "make"):
        _cuda.check("make", seed)
        out, dig = make_plain(seed, iters, loop, selects, nregs)
        return (out, dig) if digest else out
    res = run_kernel("make", seed, iters, placement, loop_while=loop == "while",
                     selects=selects, regs=nregs, digest=digest)
    LAUNCHES["make"] += 1
    return res


def sweep(device, lanes=LANES, iters=ITERS):
    """The probe's table on the card: (label, placement, lanes, ms a
    launch of `iters` steps, ns a step) for each case, by CUDA events
    (_cuda.per_step)."""
    rows = []
    for label, kw in CASES:
        for placement in PLACEMENTS:
            for n in lanes:
                seed = seeds(n, device)
                rows.append((label, placement, n, *_cuda.per_step(
                    lambda k: make(seed, k, placement=placement, **kw), iters)))
    return rows


def main():
    dev = _cuda.cuda_device()
    _cuda.print_table(
        f"probe_fsm_cost2: ns a step, {ITERS} steps",
        [(f"{label:22s} {pl:6s} n={n:4d}", f"{ms:8.3f} ms, {ns:9.1f} ns/iter")
         for label, pl, n, ms, ns in sweep(dev)])


if __name__ == "__main__":
    main()
