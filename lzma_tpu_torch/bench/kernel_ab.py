"""Time the DP scans (K3, K4) and the range encoder (K2) of this checkout
against those of another checkout, on the main path's whole lanes, on one
card, in turns.

    python -m lzma_tpu_torch.bench.kernel_ab OTHER_CHECKOUT

The inputs are chip_smoke.py's main path: text_part() +
generate_bench_data(5 << 20), LzmaParams() defaults (lc3 lp0 pb2, fb 32),
parse="optimal", 32 lanes of 256 KiB; an encode inside
device_encoder.probing() records the last DP round's packed rows, tables
and lens and the final (ctx, bit) streams.  OTHER_CHECKOUT's package is
loaded under another name and its kernels are built by its own
runtime/build.py and called through its own wrappers
(``ops.cuda_parser.dp_parse_cuda``, ``dp_parse2_cuda``,
``ops.cuda_serializer.serialize_cuda``), whose signatures both checkouts
share.  Each kernel is timed by CUDA events after a warm launch, in the
order other, this, this, other; the two checkouts' outputs must be
equal.  Needs a CUDA device and nvcc.  Prints the card (nvidia-smi name,
power limit), then one JSON line.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys

import torch

from ..core.layout import ProbLayout
from ..format.properties import LzmaParams
from ..ops import api, cuda_parser, cuda_serializer
from ..ops.device_encoder import probing
from ..probes._cuda import card, event_ms
from .corpus import text_part
from .datagen import generate_bench_data

BLOCK = 1 << 18
OTHER = "_kernel_ab_other"


def other_wrappers(root: str):
    """OTHER_CHECKOUT's ops.cuda_parser and ops.cuda_serializer, its
    package loaded as OTHER."""
    pkg = os.path.join(os.path.abspath(root), "lzma_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        OTHER, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[OTHER] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module(f"{OTHER}.ops.cuda_parser"),
            importlib.import_module(f"{OTHER}.ops.cuda_serializer"))


def main_path_inputs(dev):
    """(packed, tables, lens) of the last DP round and (ctx, bits, totals)
    of the final lowering, from one probed optimal encode of main8M."""
    data = text_part() + generate_bench_data(5 << 20)
    with probing() as probe:
        api.encode_blocks(data, LzmaParams(), block_size=BLOCK,
                          parse="optimal", device=dev)
    ctx, bits, totals = probe["lowered"][3:]
    return probe["dp_inputs"], (ctx, bits, totals)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    name = card().splitlines()[0]
    print(name, flush=True)
    dev = torch.device("cuda", 0)
    o_parser, o_serializer = other_wrappers(argv[0])
    params = LzmaParams()
    fb, pb = params.fast_bytes, params.pb
    arena = ProbLayout(params.lc, params.lp, pb, pos_bits=pb).size
    (packed, tables, lens), (ctx, bits, totals) = main_path_inputs(dev)
    L, N, _ = packed.shape
    max_out = BLOCK + BLOCK // 4 + 128
    scan = (packed, tables, lens, fb, pb)
    code = (ctx, bits, totals, arena, max_out)
    kernels = {
        "dp_parse": {"other": lambda: o_parser.dp_parse_cuda(*scan),
                     "this": lambda: cuda_parser.dp_parse_cuda(*scan)},
        "dp_parse2": {"other": lambda: o_parser.dp_parse2_cuda(*scan),
                      "this": lambda: cuda_parser.dp_parse2_cuda(*scan)},
        "rc_serialize": {"other": lambda: o_serializer.serialize_cuda(*code),
                         "this": lambda: cuda_serializer.serialize_cuda(*code)},
    }
    result = {"card": name, "lanes": L, "positions": N,
              "pairs_longest_lane": int(totals.max()), "pairs": int(totals.sum())}
    for kernel, fns in kernels.items():
        outs = {k: fn() for k, fn in fns.items()}
        if not all(torch.equal(a, b) for a, b in zip(outs["other"], outs["this"])):
            raise AssertionError(f"{kernel}: this checkout's output differs "
                                 "from the other's")
        del outs
        reps = 3 if kernel == "rc_serialize" else 2
        times = {k: [] for k in fns}
        for k in ("other", "this", "this", "other"):
            times[k].append(event_ms(fns[k], reps))
        result[kernel] = times
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
