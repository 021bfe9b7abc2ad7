"""K1's decode body with one group knocked out, on random input: the
counterpart of ``tools/probe_packed_ablate.py`` (``ablate``).

The TPU probe ablated its packed ring decoder (two probabilities a word,
window and input in words) at 32 and 128 lanes of random input, every
lane kept alive.  K1's arena is already uint16 and its window bytes, so
the packing itself has no counterpart; the groups it knocked out do, on
the same body and kernel as ``probe_ring_ablate`` (``csrc/probe_ablate.cu``):
``full``, ``noarena``, ``noinput``, ``nowin``, ``noring``, ``notrans``.
``noflush`` has none (K1 writes its output row directly).  ``ablate``
fixes lp 0, pb 2 and, as the TPU probe did, reads every lane's whole row
(comp_lens = max_in) to ``max_out`` bytes (or to ``out_sizes``).  It
returns ``probe_ring_ablate.ablate``'s tuple; a CPU tensor takes the
plain version of ``full``, the exact decoder, which equals the kernel on
valid streams only.

    python -m lzma_tpu_torch.probes.probe_packed_ablate    # the table, on the card
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from . import _cuda
from .probe_ring_ablate import checksum, per_lane, plain, run_kernel, same

VARIANTS = ("full", "noarena", "noinput", "nowin", "noring", "notrans")
LANES = (32, 128)
#: the TPU probe's shape: 2,048 input words a lane (8 KiB), 16 KiB out,
#: dict 4 KiB, lc0
MAX_IN, MAX_OUT, DICT = 8192, 1 << 14, 1 << 12

#: kernel launches by function since the counts were last cleared
LAUNCHES = Counter()


def random_input(n: int, seed: int = 0, device="cuda") -> torch.Tensor:
    """The TPU probe's input, (n, 8192) uint8: 2,048 int32 words a lane
    drawn from [0, 255), as their little-endian bytes."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 255, (n, MAX_IN // 4), dtype=np.int32)
    return torch.from_numpy(words.astype("<i4").view(np.uint8).copy()).to(device)


def ablate(comp, dict_size: int, lc: int, max_out: int, variant: str = "full",
           out_sizes=None):
    """Decode every lane's whole row of comp ((N, max_in) uint8) with
    `variant` to out_sizes ((N,) int32, default max_out each).  Returns
    (out, ok, out_pos, counts) as probe_ring_ablate.ablate."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    n, max_in = comp.shape
    lens = torch.full((n,), max_in, dtype=torch.int32, device=comp.device)
    if out_sizes is None:
        out_sizes = torch.full((n,), max_out, dtype=torch.int32, device=comp.device)
    args = (comp, lens, out_sizes, dict_size, lc, 0, 2, max_out)
    if not _cuda.on_device(comp, "ablate"):
        return plain(*args, variant)
    res = run_kernel(variant, *args)
    LAUNCHES["ablate"] += 1
    return res


def sweep(device, lanes=LANES, variants=VARIANTS):
    """The probe's table on the card: (variant, lanes, ms a launch by
    CUDA events, then probe_ring_ablate.per_lane's seven numbers,
    checksum), each variant run twice with equal results, on
    random_input(lanes)."""
    rows = []
    for n in lanes:
        comp = random_input(n, device=device)
        for variant in variants:
            first, again = (ablate(comp, DICT, 0, MAX_OUT, variant)
                            for _ in range(2))
            if not same(first, again):
                raise AssertionError(f"packed ablate {variant} gave two results")
            ms = _cuda.event_ms(lambda: ablate(comp, DICT, 0, MAX_OUT, variant))
            rows.append((variant, n, ms, *per_lane(first), checksum(first)))
    return rows


def main():
    dev = _cuda.cuda_device()
    _cuda.print_table(
        f"probe_packed_ablate: random input, {MAX_OUT} B a lane, dict {DICT}, lc0",
        [(f"{v:8s} n={n:3d}", f"{ms:8.3f} ms ({lane_ms:.3f} a lane, {slow:.3f} "
          f"the slowest), a lane {nb:7.1f} ns/byte, {nst:6.1f} ns/step, "
          f"{nbit:6.1f} ns/bit, {bits:7.0f} bits and {cp:6.0f} copied bytes, "
          f"checksum {cs}")
         for v, n, ms, nb, nst, nbit, bits, cp, lane_ms, slow, cs in sweep(dev)])


if __name__ == "__main__":
    main()
