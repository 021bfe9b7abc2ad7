"""What one synthetic decode step costs on the H100: the counterpart of
``tools/probe_fsm_cost.py`` (``v1``, ``v2``, ``v_i16``).

The TPU probe timed the decode step's wide masked operations as a
function of the lane count.  Here each lane is a thread that indexes its
own arena, window and input (``csrc/probe_fsm.cu``), and the question is
what one step of that dependent chain costs with the lane's memory in
shared memory (K5's placement) or in device memory (K1's).

    v1     int32 arena (S) by the >>5 rule, int32 window (W) read at
           (pos - p) & (W-1) and written at pos & (W-1), one input byte
    v2     two probabilities a word, window and input in words, a
           4-byte write accumulator
    v_i16  the arena step alone, in int16

Each function takes the lanes' seeds, ``seeds(n)`` ((n,) int32, the TPU
probe's ``arange(n)``), and returns each lane's result (n,) int32: v1
and v2 ``bit + pos``, v_i16 ``bit``.  With ``digest=True`` it returns
(result, digest), the digest each lane's int32 sum of its arena and
window after the steps (v2: its words and the pending accumulator): the
TPU probe has no such output, it checks the kernel's memory against the
plain version's.  A CUDA tensor launches the kernel (``placement``
"shared" or "device"); a CPU tensor takes the plain version, vectorised
over the lanes with a Python loop over the steps.

    python -m lzma_tpu_torch.probes.probe_fsm_cost    # the table, on the card
"""

from __future__ import annotations

import functools
from collections import Counter

import torch

from . import _cuda

ITERS = 8192
S = 2688      # the arena at lc0
W = 4096      # the window (dict 4 KiB)
C = 1024      # the staged input
#: the TPU probe's lane counts, then two past one block an SM
LANES = (32, 64, 128, 256)
MORE_LANES = (1024, 4096)
PLACEMENTS = ("shared", "device")
#: the form ids of csrc/probe_fsm.cu
FORMS = {"v1": 0, "v2": 1, "v_i16": 2, "make": 3}

#: kernel launches by function since the counts were last cleared
LAUNCHES = Counter()


def seeds(n: int, device="cuda") -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


@functools.cache
def _kernel():
    P, I = _cuda.P, _cuda.I
    return _cuda.kernel("lzt_probe_fsm", [I] * 5 + [P] * 4 + [I, I, P])


@functools.cache
def lane_bytes(form: str) -> int:
    """Bytes of arena, window and input one lane of `form` holds."""
    return _cuda.kernel("lzt_probe_fsm_lane_bytes", [_cuda.I])(FORMS[form])


@functools.cache
def lanes_per_block() -> int:
    return _cuda.kernel("lzt_probe_fsm_lanes_per_block", [])()


def run_kernel(form: str, seed, iters: int, placement: str, loop_while=0,
               selects=0, regs=0, digest=False):
    """One launch of csrc/probe_fsm.cu; returns (n,) int32, or (out,
    digest) where `digest`.  The wrappers count it."""
    _cuda.check(form, seed)
    if placement not in PLACEMENTS:
        raise ValueError(f"placement must be one of {PLACEMENTS}, got {placement!r}")
    n = seed.shape[0]
    out = torch.empty((n,), dtype=torch.int32, device=seed.device)
    dig = torch.empty_like(out) if digest else None
    shared = placement == "shared"
    scratch = None if shared else torch.empty(
        (n * lane_bytes(form),), dtype=torch.uint8, device=seed.device)
    with torch.cuda.device(seed.device):
        err = _kernel()(FORMS[form], int(shared), int(loop_while), selects, regs,
                        seed.data_ptr(), out.data_ptr(),
                        dig.data_ptr() if digest else None,
                        None if shared else scratch.data_ptr(), n, iters,
                        _cuda.stream(seed))
    if err == -1:
        raise ValueError(f"no {form} kernel for selects={selects}, regs={regs}")
    _cuda.raise_on(err, f"probe_fsm {form}")
    return (out, dig) if digest else out


def lane_sum(*parts):
    """The kernels' digest: each lane's words of `parts`, one row after
    the other, each times its index + 1, summed modulo 2^32, (n,) int32."""
    row = torch.cat([p.long() & 0xFFFFFFFF for p in parts], dim=1)
    w = torch.arange(1, row.shape[1] + 1, device=row.device)
    return _i32((row * w).sum(dim=1) & 0xFFFFFFFF)


def adapt(p, bit):
    """The >>5 probability update, towards 0 on a 0 bit."""
    return torch.where(bit == 0, p + ((2048 - p) >> 5), p - (p >> 5))


def arena_step(probs, rows, sd, t, bit):
    """Read the lane's probability at its step-t index and adapt it in
    place; returns the probability read."""
    idx = (sd + t * 7 + bit * 3) % S
    p = probs[rows, idx].int()
    probs[rows, idx] = adapt(p, bit).to(probs.dtype)
    return p


def v1_plain(seed, iters):
    n, dev = seed.shape[0], seed.device
    rows = torch.arange(n, device=dev)
    probs = torch.full((n, S), 1024, dtype=torch.int32, device=dev)
    win = torch.zeros((n, W), dtype=torch.int32, device=dev)
    inp = torch.ones((n, C), dtype=torch.int32, device=dev)
    bit = torch.zeros((n,), dtype=torch.int32, device=dev)
    pos = torch.zeros_like(bit)
    sd = seed * 131
    for t in range(iters):
        p = arena_step(probs, rows, sd, t, bit)
        ib = inp[rows, pos % C]
        bb = win[rows, (pos - p) & (W - 1)]
        win[rows, pos & (W - 1)] = bb + ib
        bit = (p + bb) & 1
        pos = pos + 1
    return bit + pos, lane_sum(probs, win)


def _i32(x):
    """int64 values in [0, 2^32) as the int32 of the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def v2_plain(seed, iters):
    n, dev = seed.shape[0], seed.device
    sh, wh, ch = S // 2, W // 4, C // 4
    rows = torch.arange(n, device=dev)
    probs = torch.full((n, sh), 1024 | (1024 << 16), dtype=torch.int32, device=dev)
    win = torch.zeros((n, wh), dtype=torch.int32, device=dev)
    inp = torch.ones((n, ch), dtype=torch.int32, device=dev)
    bit = torch.zeros((n,), dtype=torch.int32, device=dev)
    pos = torch.zeros_like(bit)
    accum = torch.zeros((n,), dtype=torch.int64, device=dev)
    sd = seed * 131
    for t in range(iters):
        idx = (sd + t * 7 + bit * 3) % S
        wi, half = idx >> 1, (idx & 1) == 1
        word = probs[rows, wi]
        p = torch.where(half, word >> 16, word) & 0xFFFF
        np_ = adapt(p, bit)
        probs[rows, wi] = torch.where(half, (word & 0xFFFF) | (np_ << 16),
                                      (word & ~0xFFFF) | np_)
        ipos = pos % C
        ib = (inp[rows, ipos >> 2] >> ((ipos & 3) * 8)) & 0xFF
        gpos = (pos - p) & (W - 1)
        bb = (win[rows, gpos >> 2] >> ((gpos & 3) * 8)) & 0xFF
        accum = accum | (((bb + ib) & 0xFF).long() << ((pos & 3) * 8).long())
        flushing = (pos & 3) == 3
        col = (pos >> 2) & (wh - 1)
        win[rows, col] = torch.where(flushing, _i32(accum), win[rows, col])
        accum = torch.where(flushing, 0, accum)
        bit = (p + bb) & 1
        pos = pos + 1
    return bit + pos, lane_sum(probs, win, accum[:, None])


def v_i16_plain(seed, iters):
    n, dev = seed.shape[0], seed.device
    rows = torch.arange(n, device=dev)
    probs = torch.full((n, S), 1024, dtype=torch.int16, device=dev)
    bit = torch.zeros((n,), dtype=torch.int32, device=dev)
    sd = seed * 131
    for t in range(iters):
        bit = arena_step(probs, rows, sd, t, bit) & 1
    return bit, lane_sum(probs)


def _wrapper(form, plain):
    def fn(seed, iters: int = ITERS, placement: str = "shared",
           digest: bool = False):
        if not _cuda.on_device(seed, form):
            _cuda.check(form, seed)
            out, dig = plain(seed, iters)
            return (out, dig) if digest else out
        res = run_kernel(form, seed, iters, placement, digest=digest)
        LAUNCHES[form] += 1
        return res

    fn.__name__ = fn.__qualname__ = form
    fn.__doc__ = (f"tools/probe_fsm_cost.py {form}: each lane's result after "
                  f"`iters` steps, (n,) int32, or (result, digest) (see the "
                  f"module docstring).")
    return fn


v1 = _wrapper("v1", v1_plain)
v2 = _wrapper("v2", v2_plain)
v_i16 = _wrapper("v_i16", v_i16_plain)


def sweep(device, lanes=LANES + MORE_LANES, iters=ITERS):
    """The probe's table on the card: (form, placement, lanes, ms a
    launch of `iters` steps, ns a step) for each, by CUDA events
    (_cuda.per_step: the slope, so setting a lane's memory cancels)."""
    rows = []
    for form, fn in (("v1", v1), ("v2", v2), ("v_i16", v_i16)):
        for placement in PLACEMENTS:
            for n in lanes:
                seed = seeds(n, device)
                rows.append((form, placement, n, *_cuda.per_step(
                    lambda k: fn(seed, k, placement), iters)))
    return rows


def main():
    dev = _cuda.cuda_device()
    rows = sweep(dev)
    _cuda.print_table(
        f"probe_fsm_cost: ns a step, {ITERS} steps, {lanes_per_block()} lanes "
        f"a block (a lane holds v1 {lane_bytes('v1')} B, v2 "
        f"{lane_bytes('v2')} B, v_i16 {lane_bytes('v_i16')} B)",
        [(f"{f:6s} {pl:6s} n={n:5d}", f"{ms:8.3f} ms, {ns:9.1f} ns/iter")
         for f, pl, n, ms, ns in rows])


if __name__ == "__main__":
    main()
