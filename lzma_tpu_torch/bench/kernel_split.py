"""K11's and K8's calls split on the card: by grid (torch.profiler) and by
bench-side variants of a checkout's own sources.

    python -m lzma_tpu_torch.bench.kernel_split [CHECKOUT] [VARIANT ...]

CHECKOUT (default: this one) is copied under ``lzma_tpu_torch/_build/
variants/``, once as it is and once a variant, each variant's source
edited as VARIANTS says (a variant whose anchor the checkout's source
lacks stops the run: the anchors are this tree's sources); each copy's
package is loaded under a name of its own and builds its kernels with
its own runtime/build.py.  The inputs are kernel_ab's: K11
(``match_lists``) on the arguments ``_rmq_search`` gives it on main8M's
32 lanes of 256 KiB, main8M-opt's (DP_TIERS cut to 12 "rr", fb 32) and
hybrid8M-opt's (``hybrid.DEFAULT_TIERS``, 29 columns uncapped, "near"),
K8 (``lower_counts``) on the last optimal round's slot counts'
arguments.  Each variant is timed on each of its kernel's inputs by
CUDA events in turns with the checkout as it is (as it is, variant,
variant, as it is), and each side's device operations by torch.profiler
(three calls after a warm one).  A variant that keeps the kernel's output must give the same
tensors; an ablation (``"keeps": False``) gives other numbers by design
and is only timed.  Needs a CUDA device and nvcc.  Prints the card
(nvidia-smi name, power limit), then one JSON line.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import torch

#: name -> (kernel, source file under csrc/, anchor: the line after which
#: the text goes (or, with "replace", a list of (text, its replacement)),
#: text, whether the output is kept, what it removes or adds)
VARIANTS = {
    "k11_no_lcp": (
        "match_lists", "search_list.cuh",
        "LZT_HD int64_t lcp_query(const Lane& ln, int64_t rp, int64_t c) {",
        "  if (c >= 0) return 2 + (c & 7);  // variant: no rank or T read",
        False, "the merge's reads of rank and the table (lcp_query)"),
    "k11_no_gather": (
        "match_lists", "search_list.cuh",
        "                            const int32_t* tcols, int k, int32_t* row) {",
        "  for (int i = 0; i < k; ++i) row[tcols[2 * i + 1]] = -1;\n"
        "  if (k >= 0) return;  // variant: no neighbour read",
        False, "the gather's reads of the tier planes (every candidate -1: "
        "no insert, no merge work but the zero rows)"),
    "k11_no_insert": (
        "match_lists", "search_list.cuh", "replace",
        [("    if (arrival) push(list, len, cap, v); else insert(list, len, cap, v);",
          "    len += v == 0x7FFFFFFF;  // variant: no list")],
        False, "the dedup and cap (the gather's reads stay; no list, so no "
        "merge work but the zero rows)"),
    "k11_insert_only": (
        "match_lists", "search_list.cuh", "replace",
        [("  const bool arrival = L::kBound > 0 && (rr || cap >= m);",
          "  const bool arrival = false;  // variant: insert only")],
        True, "nothing: every register list takes insert (no arrival "
        "order, no bitonic sort)"),
    "k8_warp_sum": (
        "lower_counts", "lower.cu", "replace",
        [("  h.add(lower_token::pair_slot(w), 1, lower_token::pair_bit(w));",
          "  const int c = lower_token::pair_slot(w);\n"
          "  const unsigned active = __activemask();\n"
          "  const unsigned peers = __match_any_sync(active, c);\n"
          "  const unsigned ones =\n"
          "      __ballot_sync(active, lower_token::pair_bit(w) != 0) & peers;\n"
          "  if (static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1) {\n"
          "    h.add(c, __popc(peers), __popc(ones));  // variant: a warp sum\n"
          "  }")],
        True, "nothing: it adds the warp's sum of equal slots before the "
        "shared add (__match_any_sync)"),
    "k8_no_count": (
        "lower_counts", "lower.cu", "replace",
        [("count_pair(h, stage[i]);",
          "if (stage[i] == 0xFFFFFFFFu) count_pair(h, stage[i]);")],
        False, "the walk's adds (the stage is written and read)"),
    "k8_loads_only": (
        "lower_counts", "lower.cu", "replace",
        [("if (mine && ex < lo + kStage && ex + mine > lo) {", "if (mine < 0) {"),
         ("count_pair(h, stage[i]);",
          "if (i < 0 && stage[i] == 0u) count_pair(h, stage[i]);")],
        False, "the staging and the adds (the token loads, geometry and "
        "scans stay)"),
}
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
WORK = os.path.join(ROOT, "lzma_tpu_torch", "_build", "variants")


def edit(src: str, anchor: str, text) -> str | None:
    """src with `text` after the line `anchor` (or, for anchor "replace",
    each (old, new) pair of `text` replaced); None where an anchor is
    missing."""
    if anchor == "replace":
        for old, new in text:
            if old not in src:
                return None
            src = src.replace(old, new)
        return src
    if anchor not in src:
        return None
    at = src.index(anchor) + len(anchor)
    return src[:at] + "\n" + text + src[at:]


def copy(checkout: str, name: str, variant=None):
    """The checkout's package copied to WORK/name, edited by `variant`;
    None where the variant's anchor is missing."""
    dst = os.path.join(WORK, name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(checkout, "lzma_tpu_torch"),
                    os.path.join(dst, "lzma_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    if variant is not None:
        _, fname, anchor, text = variant[:4]
        path = os.path.join(dst, "lzma_tpu_torch", "csrc", fname)
        with open(path) as f:
            out = edit(f.read(), anchor, text)
        if out is None:
            return None
        with open(path, "w") as f:
            f.write(out)
    return dst


def main(argv=None) -> None:
    from ..probes._cuda import card, event_ms
    from .kernel_ab import (grid_split, lists_call, list_inputs,
                            main_path_inputs, other_wrappers)

    argv = sys.argv[1:] if argv is None else argv
    checkout = ROOT
    if argv and argv[0] not in VARIANTS:
        checkout, argv = os.path.abspath(argv[0]), argv[1:]
    chosen = argv or list(VARIANTS)
    if any(v not in VARIANTS for v in chosen):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_split: no CUDA device")
    name = card().splitlines()[0]
    print(name, flush=True)
    dev = torch.device("cuda", 0)
    kernels = {VARIANTS[v][0] for v in chosen}
    inputs = {}  # kernel -> {workload: arguments}
    if "match_lists" in kernels:
        inputs["match_lists"] = {"main8M-opt": list_inputs(dev),
                                 "hybrid8M-opt": list_inputs(dev, True)}
    if "lower_counts" in kernels:
        inputs["lower_counts"] = {"main8M-opt": main_path_inputs(dev)[5]}

    def call(mods, kernel, args):
        if kernel == "match_lists":
            return lists_call(mods[7], args)
        return lambda: mods[5].lower_counts_cuda(*args)

    copies = {v: copy(checkout, v, VARIANTS[v]) for v in chosen}
    missing = [v for v, where in copies.items() if where is None]
    if missing:
        raise SystemExit(f"kernel_split: {checkout}'s sources lack the "
                         f"anchors of {missing}")
    base = other_wrappers(copy(checkout, "base"), "_split_base")
    result = {"card": name, "checkout": checkout}
    for k in sorted(kernels):
        for work, args in inputs[k].items():
            fn = call(base, k, args)
            result[f"{k} {work}"] = {"ms": event_ms(fn, 5),
                                     "grids": grid_split(fn)}
    for v in chosen:
        kernel, *_, keeps, removes = VARIANTS[v]
        mods = other_wrappers(copies[v], f"_split_{v}")
        result[v] = {"kernel": kernel, "removes": removes}
        for work, args in inputs[kernel].items():
            fns = {"base": call(base, kernel, args),
                   "variant": call(mods, kernel, args)}
            outs = {s: fn() for s, fn in fns.items()}
            same = all(torch.equal(a, b)
                       for a, b in zip(outs["base"], outs["variant"]))
            del outs
            if keeps and not same:
                raise AssertionError(f"{v} on {work}: the variant's output "
                                     "differs")
            times = {s: [] for s in fns}
            for s in ("base", "variant", "variant", "base"):
                times[s].append(event_ms(fns[s], 5))
            result[v][work] = {"same": same, "ms": times,
                               "grids": grid_split(fns["variant"])}
            print(f"{v} on {work}: {times}", flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
