"""K12's literal price slots in shared memory against device memory, on
the card.

    python -m lzma_tpu_torch.bench.row_placement [LC:LP ...]

For each literal setting named (default 3:0 4:0 4:1 5:0 5:1 8:4), the
main path's lanes (text_part() + generate_bench_data(5 << 20), 32 lanes
of 256 KiB, pb 2, fb 32, dict 4 MiB, chip_smoke.py's main8M-opt) go
through device_parser.tokenize_optimal once and the arguments of its
last K12 call (ops.cuda_inputs.dp_inputs_cuda) are kept.  K12 is then
timed on them by CUDA events after a warm launch, with the lane's
literal slots staged in shared memory ("shared", where both planes' slots
fit a block beside the row stage) and read from device memory
("device"), in the order device, shared, shared, device; the two
placements' rows must be equal.  The placement is forced by replacing
``cuda_inputs.input_placement`` for the timed calls.  Needs a CUDA device
and nvcc.  Prints the card (nvidia-smi name, power limit), one line a
setting, then one JSON line.
"""

from __future__ import annotations

import json
import sys

import torch

from ..ops import cuda_inputs, device_parser
from ..probes._cuda import card, event_ms
from ..runtime.card import smem_limit
from .corpus import text_part
from .datagen import generate_bench_data

BLOCK = 1 << 18
SETTINGS = ((3, 0), (4, 0), (4, 1), (5, 0), (5, 1), (8, 4))


def k12_args(data, lens, lc: int, lp: int):
    """The arguments of tokenize_optimal's last K12 call at lc, lp."""
    seen = []
    real = cuda_inputs.dp_inputs_cuda

    def spy(*args):
        seen.append(args)
        return real(*args)

    cuda_inputs.dp_inputs_cuda = spy
    try:
        device_parser.tokenize_optimal(data, lens, 1 << 22, lc=lc, lp=lp,
                                       pb=2, fb=32)
    finally:
        cuda_inputs.dp_inputs_cuda = real
    return seen[-1]


def timed(args, placement: str, reps: int):
    """K12's ms a call and its rows, the literal slots in `placement`."""
    chosen = cuda_inputs.input_placement
    cuda_inputs.input_placement = lambda m, slots, limit: placement
    try:
        return (event_ms(lambda: cuda_inputs.dp_inputs_cuda(*args), reps),
                cuda_inputs.dp_inputs_cuda(*args))
    finally:
        cuda_inputs.input_placement = chosen


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    settings = [tuple(int(v) for v in a.split(":")) for a in argv] or SETTINGS
    dev = torch.device("cuda", 0)
    raw = text_part() + generate_bench_data(5 << 20)
    n_lanes = len(raw) // BLOCK
    data = torch.frombuffer(bytearray(raw[:n_lanes * BLOCK]), dtype=torch.uint8
                            ).reshape(n_lanes, BLOCK).to(dev)
    lens = torch.full((n_lanes,), BLOCK, dtype=torch.int32, device=dev)
    limit = smem_limit(0)
    name = card()
    print(name)
    out = []
    for lc, lp in settings:
        args = k12_args(data, lens, lc, lp)
        M = args[1].shape[2]
        slots = cuda_inputs.lit_slots(lc, lp)
        fits = cuda_inputs.smem_bytes(M, slots, True) <= limit
        rec = {"lc": lc, "lp": lp, "slots": slots,
               "smem_shared": cuda_inputs.smem_bytes(M, slots, True),
               "smem_device": cuda_inputs.smem_bytes(M, slots, False),
               "chosen": cuda_inputs.input_placement(M, slots, limit)}
        order = ("device", "shared", "shared", "device") if fits else \
            ("device", "device")
        ms = {}
        rows = {}
        for placement in order:
            t, r = timed(args, placement, reps=10)
            ms.setdefault(placement, []).append(t)
            if placement in rows and not torch.equal(rows[placement], r):
                raise AssertionError(f"K12 {placement} rows vary at "
                                     f"lc{lc} lp{lp}")
            rows[placement] = r
        if fits and not torch.equal(rows["shared"], rows["device"]):
            raise AssertionError(f"K12's placements disagree at lc{lc} lp{lp}")
        rec.update({f"{k}_ms": v for k, v in ms.items()})
        out.append(rec)
        print(f"lc{lc} lp{lp}: {slots} literal slots a plane, "
              + ", ".join(f"{k} {v} ms" for k, v in ms.items())
              + f"; chosen {rec['chosen']}", flush=True)
        del args, rows
        torch.cuda.empty_cache()
    print(json.dumps({"card": name, "lanes": n_lanes, "block": BLOCK,
                      "smem_limit": limit, "settings": out}))


if __name__ == "__main__":
    main()
