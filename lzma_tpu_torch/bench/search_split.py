"""The search on the card, split by stage: the optimal parse's candidate
search, or the lazy parse's.

    python -m lzma_tpu_torch.bench.search_split [lazy] [plain|kernels] ...

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
With "lazy" first, main8M-lazy (the same lanes, parse="lazy") is encoded
likewise and its tokenize split by device_matcher.LAZY_STAGES (summed
as "tokenize"), then lzma8M-stream (the same 8 MiB as one .lzma stream,
api.encode_alone) likewise.
"kernels" is the port as it runs (K9-K11 and K15-K17, ops.cuda_search
and ops.cuda_lazy); "plain" puts those kernels' plain versions
(device_matcher._search_keys_plain, _suffix_table_plain,
_match_lists_plain, _doubling_groups_plain, _descent_lcp_plain,
_best_matches_plain) in their place, on the same card tensors, and
checks that the containers are the same; on the lazy path that is the
arithmetic the port ran before K9 and K15-K17 took it over (K10, K13 and
K14 stay kernels).  Needs a CUDA device.  Prints the card (nvidia-smi
name, power limit), one line a route and workload, then one JSON line.
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


#: the wrappers the "plain" route replaces: (module, wrapper, plain
#: version in device_matcher)
SWAPPED = (("cuda_search", "search_keys_cuda", "_search_keys_plain"),
           ("cuda_search", "suffix_table_cuda", "_suffix_table_plain"),
           ("cuda_search", "match_lists_cuda", "_match_lists_plain"),
           ("cuda_lazy", "doubling_groups_cuda", "_doubling_groups_plain"),
           ("cuda_lazy", "descent_lcp_cuda", "_descent_lcp_plain"),
           ("cuda_lazy", "best_matches_cuda", "_best_matches_plain"))


@contextlib.contextmanager
def _route(name: str):
    """The search's kernel wrappers as they are ("kernels") or replaced by
    their plain versions ("plain") inside the block."""
    import importlib

    from ..ops import device_matcher as dm

    if name not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {name!r}")
    mods = [importlib.import_module(f"lzma_tpu_torch.ops.{m}")
            for m, _, _ in SWAPPED]
    kept = [getattr(m, w) for m, (_, w, _) in zip(mods, SWAPPED)]
    if name == "plain":
        for m, (_, w, plain) in zip(mods, SWAPPED):
            setattr(m, w, getattr(dm, plain))
    try:
        yield
    finally:
        for m, (_, w, _), f in zip(mods, SWAPPED, kept):
            setattr(m, w, f)


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
        out["main8M-opt"], blob = _encode_split(
            lambda: api.encode_blocks(data, params, block_size=BLOCK,
                                      parse="optimal", device=dev),
            SEARCH_STAGES, "search_ms")
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


def _encode_split(encode, stages, total: str):
    """A warm-up, an encode (its seconds and peak device memory), then one
    inside probing(), which must write the same bytes: its `stages` split
    and their sum (under `total`), and its other stages."""
    from ..ops.device_encoder import probing

    dev = torch.device("cuda", 0)
    encode()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    blob = encode()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    with probing() as probe:
        t = time.perf_counter()
        again = encode()
        torch.cuda.synchronize()
        probed = time.perf_counter() - t
    if again != blob:
        raise AssertionError("the probed encode wrote another container")
    split = _split(probe, stages)
    rest = _split(probe, [k for k in probe["seconds"] if k not in stages])
    return {"encode_s": secs, "peak_mib": peak, "probed_s": probed,
            total: sum(v[0] for v in split.values()), "split": split,
            "rest": rest, "container": len(blob)}, blob


def run_lazy(route: str, dev):
    """One route's main8M-lazy and lzma8M-stream encodes, split by
    LAZY_STAGES."""
    from ..bench.corpus import text_part
    from ..bench.datagen import generate_bench_data
    from ..format.properties import LzmaParams
    from ..ops import api
    from ..ops.device_matcher import LAZY_STAGES

    data = text_part() + generate_bench_data(5 << 20)
    params = LzmaParams()
    out, blobs = {}, []
    with _route(route):
        out["main8M-lazy"], blob = _encode_split(
            lambda: api.encode_blocks(data, params, block_size=BLOCK,
                                      parse="lazy", device=dev), LAZY_STAGES,
            "tokenize_ms")
        blobs.append(blob)
        out["lzma8M-stream"], blob = _encode_split(
            lambda: api.encode_alone(data, LzmaParams(write_eos=True),
                                     device=dev), LAZY_STAGES, "tokenize_ms")
        blobs.append(blob)
    return out, b"".join(blobs)


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    lazy = bool(args) and args[0] == "lazy"
    routes = args[1:] if lazy else args
    routes = routes or list(ROUTES)
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
        result[route], blobs[route] = (run_lazy if lazy else run)(route, dev)
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
