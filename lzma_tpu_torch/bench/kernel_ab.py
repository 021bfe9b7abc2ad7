"""Time the kernels of this checkout against those of another checkout, on
one card, in turns: the DP scans (K3, K4), the range encoder (K2), the
decoders (K1, K5), the classify carry (K6), the bit lowering (K7), its
slot counts (K8), the suffix table (K10), the optimal search's match
lists (K11), the DP rows (K12), the parse path's marking and
compaction (K13, K14), the lazy search's doubling groups, descent and
best matches (K15, K16, K17), the optimal rounds' price model (K18),
classify_tokens whole (K19), the rep0 trace (K20) and the DP pairs with
the seed's pairs (K21).

    python -m lzma_tpu_torch.bench.kernel_ab OTHER_CHECKOUT [KERNEL ...]

KERNEL picks among dp_parse, dp_parse2, rc_serialize, ring_decode,
ring_input, classify, lower, lower_counts, classify_stream,
lower_stream, ring_decode_champion, block_decode_champion and
ring_input_champion, tokenize_lazy, tokenize_stream, match_lists,
match_lists_hybrid, suffix_table, suffix_table_stream, dp_inputs,
path_mark, path_compact, path_mark_stream, path_compact_stream,
path_mark_tile, doubling_groups, best_matches, descent_lcp,
doubling_groups_stream, best_matches_stream, descent_lcp_stream,
price_model, classify_tokens, rep0_trace, list_pairs and round_stages
(default: all).  The
inputs are chip_smoke.py's: the main path is text_part() +
generate_bench_data(5 << 20), LzmaParams() defaults (lc3 lp0 pb2, fb
32), parse="optimal", 32 lanes of 256 KiB; an encode inside
device_encoder.probing() records the last DP round's packed rows, tables
and lens, the final (ctx, bit) streams, the final tokens' classify
rows, the final lowering's arguments and the last round's slot counts'
arguments (K3, K4, K2, K6 as classify, K7 as lower, K8 as
lower_counts), and its container's streams are K1's
(ring_decode).  lower_counts is K8 (``ops.cuda_lower.
lower_counts_cuda``) on both sides where the other checkout has it;
where it has not, the other side is the route K8 replaced: the other
checkout's K7 on the same arguments, then this checkout's
``device_encoder.pair_counts`` of its planes.  classify_stream and
lower_stream are K6 and K7 on the same 8 MiB as
ONE `.lzma` stream (ops.api.encode_alone, lazy, the EOS marker): one
lane of 8,388,609 token rows.  For K7 and K8 (lower, lower_counts,
lower_stream) it also splits this checkout's call by its device
operations (``utils.profiling``: torch.profiler over three calls, each
operation's microseconds a launch and launches a call).  The champion shape
(bench.py:344-390) is 128 lanes of 16 KiB of bench data, lc0, dict 4
KiB, fb 8, lazy: K1 and K5 decode its streams.  tokenize_lazy and
tokenize_stream are each checkout's whole lazy tokenize
(``ops.device_matcher.tokenize``: its search, path and compaction, the
status readbacks included) on the main path's 32 lanes and on the 8 MiB
as one lane, LzmaParams() defaults, 4 candidates.  match_lists is
K11 (``ops.cuda_search.match_lists_cuda``, the wrapper) on the arguments
the main path's ``device_matcher._rmq_search`` gives it (spied) on the
same 32 lanes: DP_TIERS cut to 12 "rr" at fb 32; match_lists_hybrid on
the hybrid's (``hybrid.DEFAULT_TIERS``, 29 columns uncapped, "near").
suffix_table is K10 (``ops.cuda_search.suffix_table_cuda``) on the
arguments the same ``_rmq_search`` gives it (the 32 lanes' suffix
order at depth 32: the column-stripe route of its upper levels);
suffix_table_stream on those of the lazy `.lzma` stream of the 8 MiB
with the EOS marker (``api.encode_alone``; one lane of 8,388,609
places, the consecutive LCP given: the per-level route); dp_inputs is
K12 (``ops.cuda_inputs.dp_inputs_cuda``) on the main path's last DP
round's arguments (``api.encode_blocks``, spied).  path_mark is K13
(``ops.cuda_path.extract_mark_cuda`` and ``greedy_mark_cuda``, with
their status readback) and path_compact K14 (``extract_compact_cuda``,
``greedy_compact_cuda``) on the last calls the same encode makes
(spied): "dp" the last round's DP path, "seed" the seed's lazy path;
path_mark_stream and path_compact_stream on the calls of the lazy
`.lzma` stream of the 8 MiB with the EOS marker (one lane of 8,388,609
nodes); path_mark_tile is K13 on the first 4,097 nodes of one lane of
that DP path (one tile: the call's fixed cost, its launches and
readback).  price_model is K18 (``ops.cuda_model.price_model_cuda``)
on the main path's last round's slot counts (spied), against the other
checkout's K18 or, where it has none, the op chain K18 replaced (its
``probs_from_counts``, ``_price_planes`` in int32, ``price_tables``,
``_dp_tables`` on the card); it also runs each checkout's probed
main8M-opt encode in turns (other, this, this, other) for the stages
``empirical_probs`` and ``build_price_model`` (seconds a call).
doubling_groups is K15 (``ops.cuda_lazy.doubling_groups_cuda``),
descent_lcp K16 (``descent_lcp_cuda``, and the share of places whose
consecutive LCP is below 32, where K16 reads no id) and best_matches
K17 (``best_matches_cuda``) on every call one lazy search makes (spied in main8M-lazy's
``api.encode_blocks(parse="lazy")``: 32 lanes of 262,144 places; K15's
five calls, the 32-byte level and the doublings at spans 32-256, timed
as one run and each alone), doubling_groups_stream, best_matches_stream
and descent_lcp_stream on those of the 8 MiB as one lazy `.lzma` stream
with the EOS marker (one lane of 8,388,608 places); a keyword the other
checkout's wrapper does not take (``sorted_key``) is left out of its
calls.  classify_tokens is K19 (``ops.cuda_classify.classify_tokens_cuda``)
on main8M-opt's last call (the final tokens), rep0_trace K20
(``ops.cuda_inputs.rep0_trace_cuda``) on its last round's and
list_pairs K21 (``ops.cuda_search.list_pairs_cuda``) on its one call
(all spied in one optimal ``api.encode_blocks``), each against the
other checkout's kernel where it has one, else the op chain the kernel
replaced there (its ``device_encoder.classify_tokens``: the rows, K6 and
the finish; its ``device_parser.rep0_trace``; its ``_select_dp_pairs``
and this checkout's ``_seed_pair``, the head of its
``_seed_from_lists``).  round_stages runs each checkout's main8M-opt
encode in turns (other, this, this, other), unprobed (seconds) and then
probed, for the stages classify, rep0_trace, select_pairs and seed
(seconds a call).  For K7, K8, K10-K18 it also splits this checkout's call
by its device operations.  OTHER_CHECKOUT's package
is loaded under another name and its kernels are built by its own
runtime/build.py and called through its own wrappers
(``ops.cuda_parser.dp_parse_cuda``, ``dp_parse2_cuda``,
``ops.cuda_serializer.serialize_cuda``, ``ops.cuda_ring.decode_cuda``,
``ops.cuda_decoder.decode_resident``,
``ops.cuda_classify.classify_carry_cuda``,
``ops.cuda_lower.lower_tokens_cuda``, ``lower_counts_cuda``,
``ops.cuda_search.match_lists_cuda``, ``suffix_table_cuda``,
``ops.cuda_inputs.dp_inputs_cuda``, ``ops.cuda_path``'s four,
``ops.cuda_lazy``'s K15 and K17), whose signatures both
checkouts share.  ring_input and ring_input_champion compare no checkouts: on
K1's main-path and champion streams they time this checkout's K1 body
with its input staged in the shared-memory ring ("this",
``probes.probe_ring_ablate`` realrow) against the same body reading the
row straight from device memory ("other", ldgin).  Each kernel is timed
by CUDA events after a warm launch, in the order other, this, this,
other; the two sides' outputs must be equal.  Beside the decoders' times: the bits the longest lane decodes,
the bytes its matches copy and the shares of its cycles by kind of
symbol (this checkout's ``probes.probe_ring_ablate`` spans, K1 with
clock64 spans), so that a time reads as ns a decoded bit of the longest
lane.  Needs a CUDA device and nvcc.  Prints the card
(nvidia-smi name, power limit), then one JSON line.
"""

from __future__ import annotations

import importlib
import importlib.util
import inspect
import json
import os
import sys
import time

import torch

from ..core.layout import ProbLayout
from ..format.properties import LzmaParams
from ..ops import (api, cuda_classify, cuda_decoder, cuda_lower, cuda_parser,
                   cuda_ring, cuda_serializer)
from ..ops.device_decoder import pad_rows
from ..ops.device_encoder import (_classify_rows, encode_batch, pair_counts,
                                  probing)
from ..parallel import blocks as blk
from ..probes import probe_ring_ablate
from ..probes._cuda import card, event_ms
from ..utils.profiling import device_busy, profiler_trace
from .corpus import text_part
from .datagen import generate_bench_data

BLOCK = 1 << 18
OTHER = "_kernel_ab_other"
#: the champion shape (chip_smoke CH_*)
CH_LANES, CH_BLOCK, CH_DICT = 128, 1 << 14, 1 << 12
KERNELS = ("dp_parse", "dp_parse2", "rc_serialize", "ring_decode",
           "ring_input", "classify", "lower", "lower_counts",
           "classify_stream", "lower_stream", "ring_decode_champion",
           "block_decode_champion", "ring_input_champion", "tokenize_lazy",
           "tokenize_stream", "match_lists", "match_lists_hybrid",
           "suffix_table", "suffix_table_stream", "dp_inputs", "path_mark",
           "path_compact", "path_mark_stream", "path_compact_stream",
           "path_mark_tile", "doubling_groups", "best_matches",
           "descent_lcp", "doubling_groups_stream", "best_matches_stream",
           "descent_lcp_stream", "price_model", "classify_tokens",
           "rep0_trace", "list_pairs", "round_stages")
MAIN_PATH = KERNELS[:8]
STREAM = ("classify_stream", "lower_stream")
TOKENIZE = ("tokenize_lazy", "tokenize_stream")
LISTS = ("match_lists", "match_lists_hybrid")
TABLE = ("suffix_table", "suffix_table_stream", "dp_inputs", "price_model")
PATH = ("path_mark", "path_compact", "path_mark_stream", "path_compact_stream",
        "path_mark_tile")
LAZY = ("doubling_groups", "best_matches", "descent_lcp",
        "doubling_groups_stream", "best_matches_stream", "descent_lcp_stream")
#: K13's and K14's wrappers (ops.cuda_path): the DP path's, the lazy path's
MARK_WRAPPERS = ("extract_mark_cuda", "greedy_mark_cuda")
COMPACT_WRAPPERS = ("extract_compact_cuda", "greedy_compact_cuda")
#: K15's, K17's and K16's wrappers (ops.cuda_lazy), by kernel
LAZY_WRAPPERS = {"doubling_groups": "doubling_groups_cuda",
                 "best_matches": "best_matches_cuda",
                 "descent_lcp": "descent_lcp_cuda"}
#: K19-K21: kernel -> (its wrapper's module, its wrapper)
ROUND = {"classify_tokens": ("cuda_classify", "classify_tokens_cuda"),
         "rep0_trace": ("cuda_inputs", "rep0_trace_cuda"),
         "list_pairs": ("cuda_search", "list_pairs_cuda")}
#: the main8M-opt stages round_stages reads
ROUND_STAGES = ("classify", "rep0_trace", "select_pairs", "seed")
#: the wrappers a split by device operations is printed for
SPLIT = ("lower", "lower_counts", "lower_stream", *LISTS, *TABLE, *PATH,
         *LAZY, *ROUND)


def other_wrappers(root: str, name: str = OTHER):
    """OTHER_CHECKOUT's ops.cuda_parser, ops.cuda_serializer,
    ops.cuda_ring, ops.cuda_decoder, ops.cuda_classify, ops.cuda_lower,
    ops.device_matcher, ops.cuda_search, ops.cuda_inputs, ops.cuda_path
    and ops.cuda_lazy, its package loaded as `name`."""
    pkg = os.path.join(os.path.abspath(root), "lzma_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f"{name}.ops.{m}") for m in
                 ("cuda_parser", "cuda_serializer", "cuda_ring", "cuda_decoder",
                  "cuda_classify", "cuda_lower", "device_matcher",
                  "cuda_search", "cuda_inputs", "cuda_path", "cuda_lazy"))


def main_data():
    return text_part() + generate_bench_data(5 << 20)


def main_path_inputs(dev):
    """(packed, tables, lens) of the last DP round, (ctx, bits, totals)
    of the final lowering, K1's arguments over the container's streams,
    the final tokens' classify rows, the final lowering's arguments and
    the last round's slot counts' arguments, from one probed optimal
    encode of main8M."""
    data = main_data()
    params = LzmaParams()
    with probing() as probe:
        blob = api.encode_blocks(data, params, block_size=BLOCK,
                                 parse="optimal", device=dev)
    ctx, bits, totals = probe["lowered"][3:]
    frame = blk.parse_container(blob)
    offs, sizes = frame.stream_extents(len(blob))
    comp, comp_lens = pad_rows([blob[offs[i]:offs[i + 1]]
                                for i in range(len(sizes))], dev)
    sizes = torch.tensor(sizes, dtype=torch.int32, device=dev)
    decode = (comp, comp_lens, sizes, params.dict_size, params.lc, params.lp,
              params.pb, BLOCK)
    return probe["dp_inputs"], (ctx, bits, totals), decode, \
        _classify_rows(*probe["classify_args"][2:]), probe["lower_args"], \
        probe["count_args"]


def stream_inputs(dev):
    """The classify rows and the lowering's arguments of main8M as one
    `.lzma` stream with the EOS marker (one lane)."""
    with probing() as probe:
        api.encode_alone(main_data(), LzmaParams(write_eos=True), device=dev)
    return _classify_rows(*probe["classify_args"][2:]), probe["lower_args"]


def spied_calls(module, wrappers, fn) -> dict:
    """{wrapper: the arguments of the last call fn() makes to
    module.wrapper} (lists in them copied: K11 empties the lists it is
    given)."""
    seen = {}
    kept = {w: getattr(module, w) for w in wrappers}

    def spy(w):
        def call(*args):
            seen[w] = tuple(list(a) if isinstance(a, list) else a
                            for a in args)
            return kept[w](*args)
        return call

    for w in wrappers:
        setattr(module, w, spy(w))
    try:
        fn()
    finally:
        for w, f in kept.items():
            setattr(module, w, f)
    return seen


def spied_args(module, wrapper: str, fn):
    """The arguments of the last call fn() makes to module.wrapper."""
    return spied_calls(module, (wrapper,), fn)[wrapper]


def _main_search(dev, *search):
    """main8M's 32 lanes through _rmq_search (fb 32, LzmaParams())."""
    from ..ops import device_matcher

    data = main_data()
    params = LzmaParams()
    lanes, lens = pad_rows([data[i:i + BLOCK]
                            for i in range(0, len(data), BLOCK)], dev)
    return lambda: device_matcher._rmq_search(
        lanes, lens, min(params.dict_size, lanes.shape[1]),
        params.fast_bytes, *search)


def list_inputs(dev, hybrid_tiers: bool = False):
    """match_lists_cuda's arguments as the main path's _rmq_search gives
    them (spied) on main8M's 32 lanes: DP_TIERS cut to 12 "rr", or the
    hybrid's DEFAULT_TIERS uncapped, "near"."""
    from ..ops import cuda_search
    from ..ops.hybrid import DEFAULT_TIERS

    search = (DEFAULT_TIERS, 0, "near") if hybrid_tiers else ()
    return spied_args(cuda_search, "match_lists_cuda", _main_search(dev, *search))


def table_inputs(dev, stream: bool = False):
    """suffix_table_cuda's arguments (K10): main8M's 32 lanes through the
    main path's _rmq_search, or the 8 MiB as one lazy `.lzma` stream with
    the EOS marker (one lane, the consecutive LCP given)."""
    from ..ops import cuda_search

    if stream:
        return spied_args(cuda_search, "suffix_table_cuda", lambda: (
            api.encode_alone(main_data(), LzmaParams(write_eos=True),
                             device=dev)))
    return spied_args(cuda_search, "suffix_table_cuda", _main_search(dev))


def row_inputs(dev):
    """dp_inputs_cuda's arguments (K12) in the main path's last DP round:
    main8M's optimal api.encode_blocks, spied."""
    from ..ops import cuda_inputs

    return spied_args(cuda_inputs, "dp_inputs_cuda", lambda: api.encode_blocks(
        main_data(), LzmaParams(), block_size=BLOCK, parse="optimal",
        device=dev))


def model_inputs(dev):
    """price_model_cuda's arguments (K18) in the main path's last DP round:
    main8M's optimal api.encode_blocks, spied."""
    from ..ops import cuda_model

    return spied_args(cuda_model, "price_model_cuda", lambda: (
        api.encode_blocks(main_data(), LzmaParams(), block_size=BLOCK,
                          parse="optimal", device=dev)))


def model_stages(pkg: str, dev) -> list:
    """The probed stages empirical_probs and build_price_model (seconds a
    call, the two rounds) of main8M's optimal encode through package
    `pkg`'s own api and probing()."""
    o_api = importlib.import_module(f"{pkg}.ops.api")
    o_enc = importlib.import_module(f"{pkg}.ops.device_encoder")
    with o_enc.probing() as probe:
        o_api.encode_blocks(main_data(), LzmaParams(), block_size=BLOCK,
                            parse="optimal", device=dev)
    return [probe["seconds"][k] for k in ("empirical_probs",
                                          "build_price_model")]


def model_route(pkg: str, args):
    """Package `pkg`'s price model on K18's arguments and its name: its K18
    where it has one, else the op chain K18 replaced (its
    probs_from_counts, _price_planes in int32, price_tables,
    _dp_tables)."""
    try:
        mod = importlib.import_module(f"{pkg}.ops.cuda_model")
        return (lambda: mod.price_model_cuda(*args)), "K18"
    except ModuleNotFoundError:
        pass
    o_parser = importlib.import_module(f"{pkg}.ops.device_parser")
    n, n1, lc, lp, pb, fb = args

    def route():
        planes = o_parser._price_planes(o_parser.probs_from_counts(n, n1),
                                        torch.int32)
        model = o_parser.price_tables(*planes, lc, lp, pb)
        return (*planes, *(model[k].to(torch.int32) for k in
                           ("ps_price", "dfull", "align_price")),
                o_parser._dp_tables(model, fb))
    return route, "the op chain"


def round_inputs(dev) -> dict:
    """{kernel: its wrapper's last call's arguments} of K19, K20 and K21 in
    one optimal api.encode_blocks of main8M (spied)."""
    mods = {k: importlib.import_module(f"..ops.{m}", __package__)
            for k, (m, _) in ROUND.items()}
    seen = {}
    kept = {k: getattr(mods[k], w) for k, (_, w) in ROUND.items()}

    def spy(k):
        def call(*args):
            seen[k] = args
            return kept[k](*args)
        return call

    for k, (_, w) in ROUND.items():
        setattr(mods[k], w, spy(k))
    try:
        api.encode_blocks(main_data(), LzmaParams(), block_size=BLOCK,
                          parse="optimal", device=dev)
    finally:
        for k, (_, w) in ROUND.items():
            setattr(mods[k], w, kept[k])
    return seen


def round_route(pkg: str, kernel: str, args):
    """Package `pkg`'s K19, K20 or K21 on `args` and its name: its kernel
    where it has one, else the op chain the kernel replaced there."""
    mod_name, wrapper = ROUND[kernel]
    mod = importlib.import_module(f"{pkg}.ops.{mod_name}")
    if hasattr(mod, wrapper):
        return (lambda: getattr(mod, wrapper)(*args)), "kernel"
    if kernel == "classify_tokens":
        enc = importlib.import_module(f"{pkg}.ops.device_encoder")
        return (lambda: enc.classify_tokens(*args)), "the op chain"
    parser = importlib.import_module(f"{pkg}.ops.device_parser")
    if kernel == "rep0_trace":
        return (lambda: parser.rep0_trace(*args)), "the op chain"
    from ..ops.device_parser import _seed_pair

    return (lambda: (*parser._select_dp_pairs(*args), *_seed_pair(*args))), \
        "the op chain"


def encode_stages(pkg: str, dev, stages=ROUND_STAGES) -> dict:
    """main8M's optimal encode through package `pkg`'s own api, unprobed
    ("encode_s", the host clock around a synchronised call) then inside
    its probing() (each of `stages`, seconds a call)."""
    o_api = importlib.import_module(f"{pkg}.ops.api")
    o_enc = importlib.import_module(f"{pkg}.ops.device_encoder")
    data = main_data()
    torch.cuda.synchronize()
    t = time.perf_counter()
    o_api.encode_blocks(data, LzmaParams(), block_size=BLOCK, parse="optimal",
                        device=dev)
    torch.cuda.synchronize()
    out = {"encode_s": time.perf_counter() - t}
    with o_enc.probing() as probe:
        o_api.encode_blocks(data, LzmaParams(), block_size=BLOCK,
                            parse="optimal", device=dev)
    out.update({k: probe["seconds"][k] for k in stages})
    return out


def path_inputs(dev, stream: bool = False) -> dict:
    """{wrapper: its last call's arguments} of K13's and K14's wrappers
    (ops.cuda_path): main8M-opt's optimal api.encode_blocks (extract_*:
    the last round's DP path; greedy_*: the seed's lazy path), or the 8
    MiB as one lazy `.lzma` stream with the EOS marker (greedy_*)."""
    from ..ops import cuda_path

    if stream:
        def fn():
            api.encode_alone(main_data(), LzmaParams(write_eos=True),
                             device=dev)
    else:
        def fn():
            api.encode_blocks(main_data(), LzmaParams(), block_size=BLOCK,
                              parse="optimal", device=dev)
    return spied_calls(cuda_path, MARK_WRAPPERS + COMPACT_WRAPPERS, fn)


def lazy_inputs(dev, stream: bool = False) -> dict:
    """{wrapper: [(args, kwargs) a call]} of K15's and K17's wrappers
    (ops.cuda_lazy) in one lazy encode: main8M-lazy's api.encode_blocks
    (32 lanes of 256 KiB), or the 8 MiB as one lazy `.lzma` stream with
    the EOS marker."""
    from ..ops import cuda_lazy

    seen = {}
    kept = {w: getattr(cuda_lazy, w) for w in LAZY_WRAPPERS.values()}

    def spy(w):
        def call(*args, **kw):
            seen.setdefault(w, []).append((args, kw))
            return kept[w](*args, **kw)
        return call

    for w in kept:
        setattr(cuda_lazy, w, spy(w))
    try:
        if stream:
            api.encode_alone(main_data(), LzmaParams(write_eos=True),
                             device=dev)
        else:
            api.encode_blocks(main_data(), LzmaParams(), block_size=BLOCK,
                              parse="lazy", device=dev)
    finally:
        for w, f in kept.items():
            setattr(cuda_lazy, w, f)
    return seen


def lazy_call(lazy_mod, wrapper: str, calls, only=None):
    """A run of lazy_mod.`wrapper` over the spied `calls` (or the one
    call at index `only`), each with the keywords that wrapper takes;
    returns every output tensor of the run."""
    fn = getattr(lazy_mod, wrapper)
    takes = inspect.signature(fn).parameters
    run = calls if only is None else calls[only:only + 1]

    def call():
        out = []
        for args, kw in run:
            res = fn(*args, **{k: v for k, v in kw.items() if k in takes})
            out.extend(t for t in outputs(res) if t is not None)
        return tuple(out)
    return call


def outputs(x) -> tuple:
    """A wrapper's result as a tuple of tensors."""
    return x if isinstance(x, tuple) else (x,)


def lists_call(search_mod, args):
    """A call of search_mod's K11 wrapper on fresh copies of the lists
    in `args` (the wrapper empties the lists it is given)."""
    return lambda: search_mod.match_lists_cuda(list(args[0]), list(args[1]),
                                               *args[2:])


def counts_route(o_lower, args, arena):
    """The other side of lower_counts: the other checkout's K8, or where
    it has none the route K8 replaced (its K7, then pair_counts)."""
    if hasattr(o_lower, "lower_counts_cuda"):
        return lambda: o_lower.lower_counts_cuda(*args)

    def route():
        ctx, bits, total = o_lower.lower_tokens_cuda(*args)
        return (*pair_counts(ctx, bits, total, arena), total)
    return route


def champion_inputs(dev):
    """K1's and K5's arguments at the champion shape."""
    params = LzmaParams(lc=0, dict_size=CH_DICT, fast_bytes=8)
    data = generate_bench_data(CH_LANES * CH_BLOCK)
    blocks = [data[i:i + CH_BLOCK] for i in range(0, len(data), CH_BLOCK)]
    comp, comp_lens = pad_rows(encode_batch(blocks, params, device=dev), dev)
    sizes = torch.full((CH_LANES,), CH_BLOCK, dtype=torch.int32, device=dev)
    return (comp, comp_lens, sizes, CH_DICT, 0, 0, params.pb, CH_BLOCK)


def decoded_work(args):
    """(bits, copied bytes, {kind of symbol: share of its cycles}) of the
    lane that decodes the most bits, by this checkout's K1 with its
    counts and clock64 spans (probe_ring_ablate spans)."""
    counts = probe_ring_ablate.ablate(*args, "spans")[3]
    k = int(torch.argmax(counts[:, 0]))
    shares = probe_ring_ablate.breakdown(counts, k)
    return (int(counts[k, 0]), int(counts[k, 1]),
            dict(zip(probe_ring_ablate.SPANS, (round(x, 4) for x in shares))))


def ring_input(args):
    """K1's body on args with its input in the ring ("this") and read
    from device memory ("other"), their outputs less the clocks."""
    def run(variant):
        out, ok, out_pos, counts = probe_ring_ablate.ablate(*args, variant)
        return out, ok, out_pos, counts[:, :2]
    return {"other": lambda: run("ldgin"), "this": lambda: run("realrow")}


def grid_split(fn, calls: int = 3) -> list:
    """fn's device operations over `calls` traced calls after a warm one:
    (name, microseconds a launch, launches a call), heaviest first (the
    trace may keep fewer than every call's launches: launches a call then
    reads below the call's own)."""
    import tempfile

    fn()
    with tempfile.TemporaryDirectory() as tmp:
        with profiler_trace(tmp) as prof:
            for _ in range(calls):
                fn()
        busy = device_busy(prof.trace_path, top=8)
    return [(name, round(us / n, 3), n / calls) for name, us, n in busy["top"]]


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1 or any(k not in KERNELS for k in argv[1:]):
        raise SystemExit(__doc__)
    chosen = argv[1:] or list(KERNELS)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    name = card().splitlines()[0]
    print(name, flush=True)
    dev = torch.device("cuda", 0)
    other = other_wrappers(argv[0])
    o_parser, o_serializer, o_ring, o_decoder, o_classify, o_lower, \
        o_matcher, o_search, o_inputs = other[:9]
    result = {"card": name}
    kernels = {}
    calls = {}  # kernel -> {side: [a run of one call of the kernel's]}
    if any(k in MAIN_PATH for k in chosen):
        params = LzmaParams()
        fb, pb = params.fast_bytes, params.pb
        arena = ProbLayout(params.lc, params.lp, pb, pos_bits=pb).size
        (packed, tables, lens), (ctx, bits, totals), dec, c_rows, l_args, \
            n_args = main_path_inputs(dev)
        L, N, _ = packed.shape
        max_out = BLOCK + BLOCK // 4 + 128
        scan = (packed, tables, lens, fb, pb)
        code = (ctx, bits, totals, arena, max_out)
        result.update(lanes=L, positions=N,
                      pairs_longest_lane=int(totals.max()),
                      pairs=int(totals.sum()))
        kernels.update({
            "dp_parse": {"other": lambda: o_parser.dp_parse_cuda(*scan),
                         "this": lambda: cuda_parser.dp_parse_cuda(*scan)},
            "dp_parse2": {"other": lambda: o_parser.dp_parse2_cuda(*scan),
                          "this": lambda: cuda_parser.dp_parse2_cuda(*scan)},
            "rc_serialize": {
                "other": lambda: o_serializer.serialize_cuda(*code),
                "this": lambda: cuda_serializer.serialize_cuda(*code)},
            "ring_decode": {"other": lambda: o_ring.decode_cuda(*dec),
                            "this": lambda: cuda_ring.decode_cuda(*dec)},
            "ring_input": ring_input(dec),
            "classify": {
                "other": lambda: o_classify.classify_carry_cuda(*c_rows),
                "this": lambda: cuda_classify.classify_carry_cuda(*c_rows)},
            "lower": {"other": lambda: o_lower.lower_tokens_cuda(*l_args),
                      "this": lambda: cuda_lower.lower_tokens_cuda(*l_args)},
            "lower_counts": {
                "other": counts_route(o_lower, n_args, arena),
                "this": lambda: cuda_lower.lower_counts_cuda(*n_args)},
        })
        result["classify_rows"] = list(c_rows[0].shape)
        result["lower_tokens"] = int(l_args[4].sum())
        result["lower_counts_tokens"] = int(n_args[4].sum())
        result["lower_counts_other"] = (
            "K8" if hasattr(o_lower, "lower_counts_cuda")
            else "K7 + pair_counts")
        if "ring_decode" in chosen:
            result["ring_decode_longest_lane"] = decoded_work(dec)
    if any(k in STREAM for k in chosen):
        s_rows, s_args = stream_inputs(dev)
        kernels["classify_stream"] = {
            "other": lambda: o_classify.classify_carry_cuda(*s_rows),
            "this": lambda: cuda_classify.classify_carry_cuda(*s_rows)}
        kernels["lower_stream"] = {
            "other": lambda: o_lower.lower_tokens_cuda(*s_args),
            "this": lambda: cuda_lower.lower_tokens_cuda(*s_args)}
        result["classify_stream_rows"] = list(s_rows[0].shape)
    if any(k.endswith("champion") for k in chosen):
        ch = champion_inputs(dev)
        kernels.update({
            "ring_decode_champion": {"other": lambda: o_ring.decode_cuda(*ch),
                                     "this": lambda: cuda_ring.decode_cuda(*ch)},
            "block_decode_champion": {
                "other": lambda: o_decoder.decode_resident(*ch),
                "this": lambda: cuda_decoder.decode_resident(*ch)},
            "ring_input_champion": ring_input(ch),
        })
        result["champion_longest_lane"] = decoded_work(ch)
    if any(k in TOKENIZE for k in chosen):
        from ..ops import device_matcher

        data = main_data()
        params = LzmaParams()
        for kernel, blocks in (
                ("tokenize_lazy", [data[i:i + BLOCK]
                                   for i in range(0, len(data), BLOCK)]),
                ("tokenize_stream", [data])):
            lanes, lens = pad_rows(blocks, dev)
            args = (lanes, lens, min(params.dict_size, lanes.shape[1]),
                    params.fast_bytes, 4)
            kernels[kernel] = {
                "other": lambda a=args: o_matcher.tokenize(*a),
                "this": lambda a=args: device_matcher.tokenize(*a)}
            result[kernel + "_lanes"] = list(lanes.shape)
    if any(k in LISTS for k in chosen):
        from ..ops import cuda_search

        for kernel in LISTS:
            if kernel in chosen:
                args = list_inputs(dev, kernel == "match_lists_hybrid")
                kernels[kernel] = {"other": lists_call(o_search, args),
                                   "this": lists_call(cuda_search, args)}
                result[kernel + "_columns"] = sum(len(r) for _, r in args[2])
                result[kernel + "_cap"] = args[7]
    if any(k in TABLE for k in chosen):
        from ..ops import cuda_inputs, cuda_model, cuda_search

        for kernel in TABLE:
            if kernel not in chosen:
                continue
            if kernel == "dp_inputs":
                args = row_inputs(dev)
                kernels[kernel] = {
                    "other": lambda a=args: o_inputs.dp_inputs_cuda(*a),
                    "this": lambda a=args: cuda_inputs.dp_inputs_cuda(*a)}
            elif kernel == "price_model":
                args = model_inputs(dev)
                other_fn, result["price_model_other"] = model_route(OTHER,
                                                                    args)
                kernels[kernel] = {
                    "other": other_fn,
                    "this": lambda a=args: cuda_model.price_model_cuda(*a)}
                # the two stages it replaces, each checkout's whole encode
                # probed, in turns
                stages = {"other": [], "this": []}
                for side in ("other", "this", "this", "other"):
                    stages[side].append(model_stages(
                        OTHER if side == "other" else "lzma_tpu_torch", dev))
                result["price_model_stages"] = stages
            else:
                args = table_inputs(dev, kernel == "suffix_table_stream")
                kernels[kernel] = {
                    "other": lambda a=args: o_search.suffix_table_cuda(*a),
                    "this": lambda a=args: cuda_search.suffix_table_cuda(*a)}
            result[kernel + "_shape"] = list(args[0].shape)
    if any(k in PATH for k in chosen):
        o_path = other[9]
        from ..ops import cuda_path

        for stream, names in ((False, PATH[:2]), (True, PATH[2:4])):
            if not any(k in chosen for k in names + PATH[4:] * (not stream)):
                continue
            seen = path_inputs(dev, stream)
            works = (("stream", 1),) if stream else (("dp", 0), ("seed", 1))
            for kernel, ws in zip(names, (MARK_WRAPPERS, COMPACT_WRAPPERS)):
                if kernel not in chosen:
                    continue
                kernels[kernel] = {work: {
                    "other": lambda w=ws[i], a=seen[ws[i]]: getattr(o_path, w)(*a),
                    "this": lambda w=ws[i], a=seen[ws[i]]: getattr(cuda_path, w)(*a)}
                    for work, i in works}
            result["path_stream_nodes" if stream else "path_nodes"] = list(
                seen[MARK_WRAPPERS[1]][0].shape)
            if not stream and "path_mark_tile" in chosen:
                # one lane's first tile of the DP path: the call's fixed cost
                frm, lens = seen[MARK_WRAPPERS[0]]
                a = (frm[:1, :4097].contiguous(), lens[:1].clamp(max=4096))
                kernels["path_mark_tile"] = {
                    "other": lambda: o_path.extract_mark_cuda(*a),
                    "this": lambda: cuda_path.extract_mark_cuda(*a)}
    if any(k in LAZY for k in chosen):
        from ..ops import cuda_lazy

        o_lazy = other[10]
        for stream, names in ((False, LAZY[:3]), (True, LAZY[3:])):
            if not any(k in chosen for k in names):
                continue
            seen = lazy_inputs(dev, stream)
            for kernel, w in zip(names, LAZY_WRAPPERS.values()):
                if kernel not in chosen:
                    continue
                kernels[kernel] = {"other": lazy_call(o_lazy, w, seen[w]),
                                   "this": lazy_call(cuda_lazy, w, seen[w])}
                if w == "doubling_groups_cuda":
                    # each level alone: the 32-byte level, then the doublings
                    calls[kernel] = {side: [
                        lazy_call(mod, w, seen[w], i)
                        for i in range(len(seen[w]))]
                        for side, mod in (("other", o_lazy),
                                          ("this", cuda_lazy))}
            result["lazy_stream_places" if stream else "lazy_places"] = list(
                seen["best_matches_cuda"][0][0][1].shape)
            if names[2] in chosen:
                # K16 reads no id where a consecutive LCP is below 32 (the
                # first 32-byte keys differ) in a lane past 508 places
                cl = torch.cat([cuda_lazy.descent_lcp_cuda(*a, **kw).reshape(-1)
                                for a, kw in seen["descent_lcp_cuda"]])
                result[names[2] + "_short_share"] = float((cl < 32).double().mean())
                del cl
            del seen
    if any(k in ROUND for k in chosen):
        seen = round_inputs(dev)
        for kernel in ROUND:
            if kernel not in chosen:
                continue
            args = seen[kernel]
            other_fn, result[kernel + "_other"] = round_route(OTHER, kernel,
                                                              args)
            this_fn, _ = round_route("lzma_tpu_torch", kernel, args)
            kernels[kernel] = {"other": other_fn, "this": this_fn}
            result[kernel + "_shape"] = list(args[1 if kernel ==
                                                "classify_tokens" else 0].shape)
        del seen
    if "round_stages" in chosen:
        # each checkout's whole encode, in turns; no kernel to time after
        stages = {"other": [], "this": []}
        for side in ("other", "this", "this", "other"):
            stages[side].append(encode_stages(
                OTHER if side == "other" else "lzma_tpu_torch", dev))
        result["round_stages"] = stages
        chosen = [k for k in chosen if k != "round_stages"]
    for kernel in chosen:
        cases = kernels.pop(kernel)
        if "this" in cases:
            cases = {None: cases}
        reps = 3 if kernel in ("rc_serialize", "ring_decode", "ring_input") else 2
        if kernel.endswith("champion") or kernel.startswith(("classify",
                                                             "lower",
                                                             "match")) \
                or kernel in TABLE or kernel in PATH or kernel in LAZY \
                or kernel in ROUND:
            reps = 5
        if kernel in TOKENIZE:
            reps = 3
        for work, fns in cases.items():
            key = kernel if work is None else f"{kernel} {work}"
            outs = {k: outputs(fn()) for k, fn in fns.items()}
            if not all(torch.equal(a, b)
                       for a, b in zip(outs["other"], outs["this"])):
                raise AssertionError(f"{key}: this checkout's output differs "
                                     "from the other's")
            del outs
            times = {k: [] for k in fns}
            for k in ("other", "this", "this", "other"):
                times[k].append(event_ms(fns[k], reps))
            result[key] = times
            if kernel in SPLIT:
                result[key + "_grids"] = grid_split(fns["this"])
        if kernel in calls:
            by_call = calls.pop(kernel)
            per = result[kernel + "_calls"] = {"other": [], "this": []}
            for side in ("other", "this", "this", "other"):
                per[side].append([event_ms(fn, reps) for fn in by_call[side]])
        del cases
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
