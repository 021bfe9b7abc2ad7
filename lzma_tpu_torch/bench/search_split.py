"""The optimal parse's candidate search on the card, split by stage.

    python -m lzma_tpu_torch.bench.search_split [plain|kernels] ...

For each route named (default: both, plain first), main8M-opt (text_part()
+ generate_bench_data(5 << 20), LzmaParams() defaults, parse="optimal",
32 lanes of 256 KiB, chip_smoke.py's main path) is encoded three times:
a warm-up, an encode as it runs (its seconds and peak device memory),
and one inside device_encoder.probing(), whose stage seconds (the device
synchronized around each) and peak device memory above what each stage
began with are printed: the search's stages (device_parser.
SEARCH_STAGES) and their sum as "search", then the encode's other
stages; then hybrid8M-opt's search (the same lanes at
hybrid.DEFAULT_TIERS, uncapped, "near": device_matcher._rmq_search as
hybrid._match_lists_grouped calls it, all 32 lanes at once) likewise.
"kernels" is the port as it runs (K9-K11, ops.cuda_search); "plain" puts
the three kernels' plain versions (device_matcher._search_keys_plain,
_suffix_table_plain, _match_lists_plain) in their place, on the same card
tensors, and checks that the containers are the same.  Needs a CUDA
device.  Prints the card (nvidia-smi name, power limit), one line a route
and workload, then one JSON line.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import torch

ROUTES = ("plain", "kernels")
BLOCK = 1 << 18


@contextlib.contextmanager
def _route(name: str):
    """The search's kernel wrappers as they are ("kernels") or replaced by
    their plain versions ("plain") inside the block."""
    from ..ops import cuda_search as cs
    from ..ops import device_matcher as dm

    if name not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {name!r}")
    kept = (cs.search_keys_cuda, cs.suffix_table_cuda, cs.match_lists_cuda)
    if name == "plain":
        cs.search_keys_cuda = dm._search_keys_plain
        cs.suffix_table_cuda = dm._suffix_table_plain
        cs.match_lists_cuda = dm._match_lists_plain
    try:
        yield
    finally:
        cs.search_keys_cuda, cs.suffix_table_cuda, cs.match_lists_cuda = kept


def _split(probe, names):
    """{stage: (ms summed over its calls, peak MiB over its calls)}."""
    return {k: (sum(probe["seconds"][k]) * 1e3,
                max(probe["peak_bytes"][k]) / 2**20)
            for k in names if k in probe["seconds"]}


def run(route: str, dev):
    """One route's main8M-opt encode split and hybrid8M-opt search split."""
    from ..bench.corpus import text_part
    from ..bench.datagen import generate_bench_data
    from ..format.properties import LzmaParams
    from ..ops import api
    from ..ops.device_decoder import pad_rows
    from ..ops.device_encoder import probing
    from ..ops.device_matcher import _rmq_search
    from ..ops.device_parser import SEARCH_STAGES
    from ..ops.hybrid import DEFAULT_TIERS

    data = text_part() + generate_bench_data(5 << 20)
    params = LzmaParams()
    out = {}
    with _route(route):
        api.encode_blocks(data, params, block_size=BLOCK, parse="optimal",
                          device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        blob = api.encode_blocks(data, params, block_size=BLOCK,
                                 parse="optimal", device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        with probing() as probe:
            t = time.perf_counter()
            again = api.encode_blocks(data, params, block_size=BLOCK,
                                      parse="optimal", device=dev)
            torch.cuda.synchronize()
            probed = time.perf_counter() - t
        if again != blob:
            raise AssertionError("the probed encode wrote another container")
        split = _split(probe, SEARCH_STAGES)
        rest = _split(probe, [k for k in probe["seconds"]
                              if k not in SEARCH_STAGES])
        out["main8M-opt"] = dict(
            encode_s=secs, peak_mib=peak, probed_s=probed,
            search_ms=sum(v[0] for v in split.values()), split=split, rest=rest,
            container=len(blob))
        lanes, lens = pad_rows([data[i:i + BLOCK]
                                for i in range(0, len(data), BLOCK)], dev)
        for _ in range(2):
            torch.cuda.synchronize()
            with probing() as probe:
                t = time.perf_counter()
                lists = _rmq_search(lanes, lens, params.dict_size,
                                    params.fast_bytes, DEFAULT_TIERS,
                                    m_cap=0, m_cap_order="near")[:3]
                torch.cuda.synchronize()
                secs = time.perf_counter() - t
        split = _split(probe, SEARCH_STAGES)
        out["hybrid8M-opt search"] = dict(
            search_s=secs, split=split,
            pairs=int(lists[2].sum()), width=int(lists[0].shape[2]))
    return out, blob


def main(argv=None) -> int:
    routes = (sys.argv[1:] if argv is None else argv) or list(ROUTES)
    if not torch.cuda.is_available():
        raise SystemExit("search_split: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    result, blobs = {"card": card}, {}
    for route in routes:
        result[route], blobs[route] = run(route, dev)
        for work, v in result[route].items():
            print(f"[{route}] {work}: " + ", ".join(
                f"{k} {x:.3f}" if isinstance(x, float) else f"{k} {x}"
                for k, x in v.items() if k not in ("split", "rest"))
                + "; " + ", ".join(f"{k} {ms:.1f} ms / {mib:.1f} MiB"
                                   for k, (ms, mib) in v["split"].items())
                + ("; other stages " + ", ".join(
                    f"{k} {ms:.1f} ms / {mib:.1f} MiB"
                    for k, (ms, mib) in v["rest"].items()) if "rest" in v
                   else ""), flush=True)
    if len(set(blobs.values())) > 1:
        raise AssertionError("the routes wrote different containers")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
