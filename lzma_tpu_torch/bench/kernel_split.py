"""K11's, K8's, K10's, K12's, K13's, K14's, K15's, K16's and K17's calls split on
the card: by grid (torch.profiler) and by bench-side variants of a
checkout's own sources; K18's and K20's calls by their wrappers' parts.

    python -m lzma_tpu_torch.bench.kernel_split [CHECKOUT] [VARIANT ...]

CHECKOUT (default: this one) is copied under ``lzma_tpu_torch/_build/
variants/``, once as it is and once a variant, each variant's source
edited as VARIANTS says (a variant whose anchors the checkout's source
lacks stops the run; a variant may name alternative edits, the first
whose anchors are all there is made (an alternative may name a file of
its own): k10_no_levels and k12_no_replen carry the anchors of the
sources before and after their redesign, as do k13_no_status,
k13_no_walk and k14_no_fill, and k12_blocks goes either way).  The K15
and K17 variants are the split that chose their redesign, on the
sources before it (commit 185a482's: run them with a checkout of
those sources as CHECKOUT): k15_window_words (the 32-byte level's
window read as words by search_list::window_words, no 64-bit remainder
a byte), k15_wrap32 (every wrap a 32-bit conditional subtract, the span
below max_n as on both inputs), k15_no_pair_reads (the doubling levels
without their two random id reads), k15_no_flag_trip (no flag plane
written and read back) and k17_no_rank (no rank read a candidate);
k17_no_table (no table reads) and k17_no_scatter (the pair written at
its sorted place, not its position) carry the anchors of the sources
before and after the redesign, and k15_no_scatter (grid A's ids
written at their places) applies to the redesign's.  K16's ablations
k16_no_refine (no refinement: the descent's length alone) and
k16_no_descent (no id read: the refinement at the suffixes
themselves) carry the anchors of the sources before and after its
redesign; k16_window_words (the refinement's windows read as words by
search_list::window_words where no word reaches 2 max_n, the descent as
it was) is the split that chose the redesign, on the sources before it
(commit a04930c's).  The small kernels' calls, K18 (``price_model``,
on main8M-opt's last round's counts) and K20 (``rep0_trace``, on its
last round's tokens), are split by variants that take one part out of
the call each: k18_empty_grid and k20_empty_grid (the grids' work: an
empty launch stays), k18_no_launch and k20_no_launch (the launches),
k18_no_ctypes and k20_no_ctypes (the C call; K20's status readback with
it), k18_no_guard and k20_no_guard (the ``torch.cuda.device`` guard),
k18_no_alloc and k20_no_alloc (the ``torch.empty`` allocations, kept
a shape), k20_no_readback (the status word's synchronise and copy); their
edits are of the wrappers (``ops/cuda_model.py``, ``ops/cuda_inputs.py``)
where the name holds a "/".  Each copy's
package is loaded under a name of its own and builds its kernels with
its own runtime/build.py.  The inputs are kernel_ab's: K11
(``match_lists``) on the arguments ``_rmq_search`` gives it on main8M's
32 lanes of 256 KiB, main8M-opt's (DP_TIERS cut to 12 "rr", fb 32) and
hybrid8M-opt's (``hybrid.DEFAULT_TIERS``, 29 columns uncapped, "near"),
K8 (``lower_counts``) on the last optimal round's slot counts'
arguments, K10 (``suffix_table``) on main8M-opt's suffix order (32
lanes of 262,144 places, depth 32), K12 (``dp_inputs``) on main8M-opt's
last DP round's arguments, K13 and K14 (``path_mark``,
``path_compact``) on main8M-opt's last DP path, its seed's lazy path
and lzma8M-stream's lane, K15, K16 and K17 (``doubling_groups``,
``descent_lcp``, ``best_matches``) on every call of main8M-lazy's search (32 lanes of
262,144 places; K15's five calls as one run, and each alone) and of
lzma8M-stream's (one lane of 8,388,608 places).  Each variant is timed
on each of its kernel's inputs by
CUDA events in turns with the checkout as it is (as it is, variant,
variant, as it is), and each side's device operations by torch.profiler
(three calls after a warm one).  A variant that keeps the kernel's output must give the same
tensors; an ablation (``"keeps": False``) gives other numbers by design
and is only timed.  For K10 and K12-K17 the JSON line also holds ptxas -v's
report of the checkout's search.cu, dp_inputs.cu, path.cu and
lazy_search.cu (registers, stack, spills a kernel), K13's and K14's grids'
blocks an SM where the checkout's library says
(``lzt_path_occupancy``), and K12's blocks an SM, from those registers and the
block's shared bytes (lzt_dp_inputs_smem) at main8M-opt's M and lc3
lp0 ("computed"; the sources before the redesign staged that setting's
literal slots), and from cudaOccupancyMaxActiveBlocksPerMultiprocessor
where the checkout's library has lzt_dp_inputs_occupancy ("runtime").
Needs a CUDA device and nvcc.  Prints the card (nvidia-smi name, power
limit), then one JSON line.
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
import sys

import torch

#: name -> (kernel, source file under csrc/, anchor: the line after which
#: the text goes (or, with "replace", a list of (text, its replacement);
#: with "any", a list of such lists, the first that applies; with
#: "files", a list of (file, such a list), every one applied), text,
#: whether the output is kept, what it removes or adds)
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
    "k10_no_window": (
        "suffix_table", "search.cu", "any",
        [[("  if (cl != nullptr) {\n"
           "    if (live) T0[i] = static_cast<int>(cl[lane * max_n + i]);",
           "  if (true) {  // variant: no window reads\n"
           "    if (live) T0[i] = cl != nullptr ? static_cast<int>(cl[lane * max_n + i])"
           " : static_cast<int>(o & 31);")]],
        False, "the base grid's window reads and LCPs (T[0] written from "
        "the place, as the given-LCP path writes it)"),
    "k10_no_levels": (
        "suffix_table", "search.cu", "any",
        [[("  if (top >= levels - 1) return 0;",
           "  if (top >= 0) return 0;  // variant: no levels past the tile")],
         [("  for (int k = top; k < levels - 1; ++k) {",
           "  for (int k = levels; k < levels - 1; ++k) {  // variant")]],
        False, "the levels past the tile (before the stripes: the per-level "
        "passes)"),
    "k12_no_replen": (
        "dp_inputs", "dp_input_row.cuh", "any",
        [[("search_list::lcp_query(ln.sfx, ln.sfx.rank[i], src) : 0;",
           "(src & 7) : 0;  // variant: no lcp_query")],
         [("    replen = search_list::lcp_query(ln.sfx, ln.sfx.rank[i], src);",
           "    replen = src & 7;  // variant: no lcp_query")]],
        False, "the rep0 length's rank and table reads (lcp_query)"),
    "k12_no_lit": (
        "dp_inputs", "dp_input_row.cuh", "replace",
        [("  tail[0] = lit_price(ln.ep0, ln.ep1, sub, byte);\n"
          "  tail[1] = matched_lit_price(ln.ep0, ln.ep1, sub, byte, mbyte);",
          "  tail[0] = static_cast<int32_t>(sub) + byte;  // variant: no walks\n"
          "  tail[1] = mbyte;")],
        False, "the literal walks (their price-slot reads)"),
    "k12_blocks": (
        "dp_inputs", "dp_inputs.cu", "any",
        [[("constexpr int kBlocksPerSM = 4;",
           "constexpr int kBlocksPerSM = 2;  // variant")],
         [("constexpr int kBlocksPerSM = 2;",
           "constexpr int kBlocksPerSM = 4;  // variant")]],
        True, "nothing: a grid of 2 blocks an SM where the source has 4, "
        "of 4 where it has 2 (the rest of the SM's shared memory L1)"),
    "k12_staged_slots": (
        "dp_inputs", "dp_inputs.cu", "replace",
        [("  int* out;                 // (n_lanes, n_pos, 6m + 5)\n",
          "  int* out;                 // (n_lanes, n_pos, 6m + 5)\n"
          "  int64_t lit_slots;        // variant\n"),
         ("  int* tab = smem + stage_words(a.m);\n",
          "  int* tab = smem + stage_words(a.m);\n"
          "  int* lit = tab + kTableInts;  // variant: both planes' slots\n"),
         ("  for (int k = tid; k < kTableInts; k += kThreads) tab[k] = __ldg(tsrc + k);\n",
          "  for (int k = tid; k < kTableInts; k += kThreads) tab[k] = __ldg(tsrc + k);\n"
          "  for (int64_t k = tid; k < a.lit_slots; k += kThreads) {\n"
          "    lit[k] = __ldg(a.ep0 + lane * a.S + a.lit_base + k);\n"
          "    lit[a.lit_slots + k] = __ldg(a.ep1 + lane * a.S + a.lit_base + k);\n"
          "  }\n"),
         ("  ln.ep0 = a.ep0 + lane * a.S + a.lit_base;\n"
          "  ln.ep1 = a.ep1 + lane * a.S + a.lit_base;\n",
          "  ln.ep0 = lit;\n"
          "  ln.ep1 = lit + a.lit_slots;\n"),
         ("  const long long smem = lzt_dp_inputs_smem(m);\n  int dev",
          "  a.lit_slots = lit_slots;\n"
          "  const long long smem = lzt_dp_inputs_smem(m) + 8 * lit_slots;\n"
          "  int dev")],
        True, "nothing: both planes' literal slots staged in shared memory "
        "(int32, beside the tables) and read there, the carve-out grown "
        "for them"),
    "k13_no_status": (
        "path_mark", "../ops/cuda_path.py", "any",
        [[("    status = int(scratch[:4].view(torch.int32).item())",
           "    status = 0  # variant: no readback")],
         ("path.cu",
          [("  if (err == cudaSuccess) err = cudaStreamSynchronize(s);\n",
            "  // variant: no readback\n")])],
        True, "the status readback (before the redesign .item(): the "
        "drain of the stream and a copy; after, the stream's synchronise "
        "in the C entry)"),
    "k13_device_status": (
        "path_mark", "path.cu", "replace",
        [("  int *gmap, *gentry, *entry;\n};",
          "  int *gmap, *gentry, *entry;\n"
          "  int* word;  // variant: the status in device memory\n};"),
         ("  m.entry = take(n_lanes * nt);\n",
          "  m.entry = take(n_lanes * nt);\n  m.word = take(2);  // variant\n"),
         ("  const Graph g{from, lens, adv, n, status, start,",
          "  int* mapped = status;  // variant: a device word, zeroed, copied\n"
          "  status = m.word;\n"
          "  cudaMemsetAsync(status, 0, 2 * sizeof(int),\n"
          "                  static_cast<cudaStream_t>(stream));\n"
          "  const Graph g{from, lens, adv, n, status, start,"),
         ("  if (err == cudaSuccess) err = cudaStreamSynchronize(s);\n",
          "  if (err == cudaSuccess) err = cudaStreamSynchronize(s);\n"
          "  if (err == cudaSuccess) {  // variant\n"
          "    err = cudaMemcpy(mapped, status, 2 * sizeof(int), cudaMemcpyDefault);\n"
          "  }\n")],
        True, "nothing: the status flags in device memory (a fill launch, "
        "then a copy to the mapped page after the synchronise) in place of "
        "the kernels writing the mapped page"),
    "k13_no_walk": (
        "path_mark", "path.cu", "any",
        [[("  if (threadIdx.x == 0) entry[lane * g.n_tiles + t] = -1;",
           "  if (threadIdx.x == 0) entry[lane * g.n_tiles + t] = static_cast<int>(lo);"
           "  // variant: entries given"),
          ("  walk_kernel<<<(n_lanes + kWalkThreads - 1) / kWalkThreads, kWalkThreads, 0,\n"
           "                s>>>(g, exits, entry, status);",
           "  // variant: no walk grid")],
         [("  const int e = entry[tile];",
           "  const int e = node_at<F>(t, kTile - 1) < g.n_nodes"
           " ? node_at<F>(t, kTile - 1) : lo;  // variant: entries given"),
          ("  if (ng > 1) {\n"
           "    group_kernel<F><<<ng * L, kGroupThreads, map_bytes, s>>>(\n"
           "        g, m.door, m.start_exit, m.gmap, m.gexit);\n"
           "    lane_kernel<F><<<L, kWalkThreads, map_bytes, s>>>(g, m.door, m.gmap,\n"
           "                                                      m.gexit, m.gentry);\n"
           "  }\n"
           "  entry_kernel<F><<<ng * L, kWalkThreads, map_bytes, s>>>(\n"
           "      g, m.door, m.start_exit, m.gentry, m.entry);",
           "  // variant: no walk grids")]],
        False, "the walk (before the redesign its grid; after, the group, "
        "lane and entry grids): each tile's entry given, the first node of "
        "its door, so every tile marks"),
    "k14_no_fill": (
        "path_compact", "path.cu", "any",
        [[("    k.t_valid[row + s] = valid;\n    if (!valid) {",
           "    if (s < 0) k.t_valid[row + s] = valid;  // variant: no fill\n"
           "    if (s < 0) {")],
         [("  if (lane >= 1) {  // the previous lane's fill over this tile's slots",
           "  if (lane < 0) {  // variant: no fill")]],
        False, "the fill past ntok (t_valid and the three planes' fill)"),
    "k14_no_tokens": (
        "path_compact", "path.cu", "replace",
        [("    for (int plane = 0; plane < 3; ++plane) {",
          "    for (int plane = 0; plane < 0; ++plane) {  // variant: no tokens")],
        False, "the tokens' staging and writes (the count, scan, look-back "
        "and fill stay)"),
    "k14_no_lookback": (
        "path_compact", "path.cu", "replace",
        [("        for (int64_t q = t - 1;; q -= 32) {",
          "        for (int64_t q = t - 1; q < 0; q -= 32) {  // variant: no look-back")],
        False, "the look-back (each tile's first slot taken as 0; it still "
        "publishes its sum for the fill)"),
    "k15_window_words": (
        "doubling_groups", "lazy_search.cu", "replace",
        [("      for (int b = 0; b < kWindow; ++b) win[threadIdx.x][b] = row[wrap(o + b, v.max_n)];",
          "      uint32_t w8[lazy_search::kWords];  // variant: the window as words\n"
          "      search_list::window_words(row, v.max_n, o, lazy_search::kWords, w8);\n"
          "      for (int b = 0; b < kWindow; ++b) win[threadIdx.x][b] = w8[b >> 2] >> (24 - 8 * (b & 3));"),
         ("        for (int b = 0; b < kWindow; ++b) own[b] = row[wrap(q + b, v.max_n)];",
          "        uint32_t w8[lazy_search::kWords];  // variant\n"
          "        search_list::window_words(row, v.max_n, q, lazy_search::kWords, w8);\n"
          "        for (int b = 0; b < kWindow; ++b) own[b] = w8[b >> 2] >> (24 - 8 * (b & 3));")],
        True, "nothing: the 32-byte level's windows read by search_list::"
        "window_words (16-byte loads, a funnel shift) in place of a byte "
        "and a 64-bit remainder at a time"),
    "k15_wrap32": (
        "doubling_groups", "lazy_search.cu", "files",
        [("lazy_search.cu",
          [("  i %= m;\n  return i < 0 ? i + m : i;",
            "  int x = static_cast<int>(i);  // variant: -m <= i < 2m\n"
            "  const int mm = static_cast<int>(m);\n"
            "  x += x < 0 ? mm : 0;\n"
            "  return x >= mm ? x - mm : x;")]),
         ("lazy_search.cuh",
          [("  return Pair{g[i], g[(i + span) % max_n]};",
            "  int64_t j = i + span;  // variant: span < max_n\n"
            "  if (j >= max_n) j -= max_n;\n"
            "  return Pair{g[i], g[j]};"),
           ("  return ids[i] * max_n + ids[(i + span) % max_n];",
            "  int64_t j = i + span;  // variant: span < max_n\n"
            "  if (j >= max_n) j -= max_n;\n"
            "  return ids[i] * max_n + ids[j];")])],
        True, "nothing: every wrap (the windows' bytes, the place before "
        "the tile, the pairs' and the next key's i + span) a conditional "
        "subtract in place of a 64-bit remainder (span < max_n and max_n "
        ">= 32 on both inputs)"),
    "k15_no_pair_reads": (
        "doubling_groups", "lazy_search.cu", "replace",
        [("    if (live) pairs[threadIdx.x] = lazy_search::pair_at(g, v.max_n, v.span, o);",
          "    if (live) pairs[threadIdx.x] = lazy_search::Pair{o >> 4, o & 1};"
          "  // variant: no id reads"),
         ("                          : lazy_search::pair_at(g, v.max_n, v.span, q);",
          "                          : lazy_search::Pair{q >> 4, q & 1};")],
        False, "the doubling levels' two random reads of the previous ids a "
        "place (each place's pair made from its position)"),
    "k15_no_flag_trip": (
        "doubling_groups", "lazy_search.cu", "replace",
        [("  if (live) v.flags[lane * v.max_n + i] = fresh;",
          "  if (live && v.span < 0) v.flags[lane * v.max_n + i] = fresh;"
          "  // variant: no flag stored"),
         ("  const int f = live ? v.flags[at + i] : 0;",
          "  const int f = live ? static_cast<int>(i & 1) : 0;"
          "  // variant: no flag read")],
        False, "the flags' round trip through device memory (grid 1 "
        "stores none, grid 3 reads none)"),
    "k17_no_rank": (
        "best_matches", "search_list.cuh", "replace",
        [("  const int64_t rq = ln.rank[c < ln.max_n ? c : ln.max_n - 1];",
          "  const int64_t rq = c;  // variant: no rank read")],
        False, "each candidate's rank read (its position taken as its "
        "rank)"),
    "k17_no_table": (
        "best_matches", "search_list.cuh", "any",
        [("lazy_search.cuh",
          [("  const int32_t v1 = Tk[b], v2 = Tk[a2];",
            "  const int32_t v1 = (b & 15) + (Tk == nullptr), v2 = a2 & 15;"
            "  // variant: no table read")]),
         [("  const int32_t v1 = Tk[b], v2 = Tk[a2];",
           "  const int32_t v1 = static_cast<int32_t>(b & 15) + (Tk == nullptr),\n"
           "                v2 = static_cast<int32_t>(a2 & 15);  // variant: no table read")]],
        False, "the two table reads a candidate (a length made from the "
        "indices)"),
    "k17_no_scatter": (
        "best_matches", "lazy_search.cu", "replace",
        [("  best_len[at + p] = bl;\n  best_dist[at + p] = bd;",
          "  best_len[at + j] = bl;  // variant: at the sorted place\n"
          "  best_dist[at + j] = bd;")],
        False, "the pair's scatter to its position (written at its place "
        "of the hash sort, coalesced)"),
    "k15_no_scatter": (
        "doubling_groups", "lazy_search.cu", "replace",
        [("  if (live) v.ids[at + o] = static_cast<int64_t>(shared_base + excl + f - 1);",
          "  if (live) v.ids[at + i] = static_cast<int64_t>(shared_base + excl + f - 1)"
          " + (o < 0);  // variant: at the place")],
        False, "grid A's scatter of the ids to their positions (each written "
        "at its place, coalesced)"),
    "k16_no_refine": (
        "descent_lcp", "lazy_search.cuh", "any",
        [[("  const int64_t cl = l + refine(row, max_n, n, a, b, l);",
           "  const int64_t cl = l + (row == nullptr);  // variant: no refinement")],
         [("  const int head = max_n > kWideLane ? refine_words(row, max_n, n, a, b, 0)\n"
           "                                     : kWindow;",
           "  const int head = kWindow;  // variant: no refinement"),
          ("  const int r = words_inside(max_n, a, b, l)\n"
           "                    ? refine_words(row, max_n, n, a, b, l)\n"
           "                    : refine(row, max_n, n, a, b, l);",
           "  const int r = row == nullptr;  // variant: no refinement")]],
        False, "the <=32-byte refinement (no byte or window read: the "
        "descent's length alone)"),
    "k16_no_descent": (
        "descent_lcp", "lazy_search.cuh", "any",
        [[("  const int64_t l = descend(g, n_levels, max_n, a, b);",
           "  const int64_t l = 0 * n_levels;  // variant: no descent")],
         [("  const int l = descend(g, n_levels, max_n, a, b);",
           "  const int l = 0 * n_levels;  // variant: no descent")]],
        False, "the descent's reads, 4 levels x 2 random int64 ids (l = 0: "
        "the refinement at the suffixes themselves)"),
    "k16_window_words": (
        "descent_lcp", "lazy_search.cuh", "replace",
        [("// The consecutive LCP at place i of the final order",
          "// variant: the refinement's windows as words where no word\n"
          "// reaches 2 max_n\n"
          "LZT_HD int refine_words_v(const uint8_t* row, int64_t max_n, int64_t n,\n"
          "                          int64_t a, int64_t b, int64_t l) {\n"
          "  if (a + l + 28 >= 2 * max_n || b + l + 28 >= 2 * max_n)\n"
          "    return refine(row, max_n, n, a, b, l);\n"
          "  int64_t ia = a + l, ib = b + l;\n"
          "  if (ia >= max_n) ia -= max_n;\n"
          "  if (ib >= max_n) ib -= max_n;\n"
          "  uint32_t wa[kWords], wb[kWords];\n"
          "  search_list::window_words(row, max_n, ia, kWords, wa);\n"
          "  search_list::window_words(row, max_n, ib, kWords, wb);\n"
          "  return search_list::consecutive_lcp_words(wa, ia, wb, ib, n, kWords,\n"
          "                                            kWindow);\n"
          "}\n\n"
          "// The consecutive LCP at place i of the final order"),
         ("  const int64_t cl = l + refine(row, max_n, n, a, b, l);",
          "  const int64_t cl = l + refine_words_v(row, max_n, n, a, b, l);")],
        True, "nothing: the refinement's two 32-byte windows read by "
        "search_list::window_words and compared as words (the byte path "
        "where a word reaches 2 max_n), in place of a byte and a 64-bit "
        "remainder at a time; the descent as it is"),
    # a small kernel's call split into its parts (K18, K20): each variant
    # takes one part out of the wrapper's path; a file name with a "/" is
    # the package's, not csrc's
    "k18_empty_grid": (
        "price_model", "price_model.cu",
        "__global__ void __launch_bounds__(kThreads) model_kernel(Args a) {",
        "  if (a.n_lanes >= 0) return;  // variant: an empty grid",
        False, "the grid's work (the launch of an empty grid stays)"),
    "k18_no_launch": (
        "price_model", "price_model.cu", "replace",
        [("  model_kernel<<<static_cast<int>(n_lanes + plane_blocks), kThreads, smem,",
          "  if (n_lanes > 0) return 0;  // variant: no launch\n"
          "  model_kernel<<<static_cast<int>(n_lanes + plane_blocks), kThreads, smem,")],
        False, "the launch (the C entry's checks and device queries stay)"),
    "k18_no_ctypes": (
        "price_model", "ops/cuda_model.py", "replace",
        [("            err = _lib().lzt_price_model(",
          "            err = 0 if True else _lib().lzt_price_model(")],
        False, "the ctypes call (the wrapper's checks, allocations, views "
        "and device guard stay)"),
    "k18_no_guard": (
        "price_model", "ops/cuda_model.py", "replace",
        [("        with torch.cuda.device(dev):\n"
          "            err = _lib().lzt_price_model(",
          "        if True:  # variant: no device guard\n"
          "            err = _lib().lzt_price_model(")],
        True, "the torch.cuda.device guard around the call"),
    "k18_no_alloc": (
        "price_model", "ops/cuda_model.py", "replace",
        [("    buf = torch.empty(2 * plane + L * DIST_ENTRIES, dtype=torch.int32,\n"
          "                      device=dev)",
          "    cache = globals().setdefault('_VARIANT_CACHE', {})  # variant\n"
          "    if (L, S, fb) not in cache:\n"
          "        cache[L, S, fb] = (torch.empty(2 * plane + L * DIST_ENTRIES,\n"
          "                                       dtype=torch.int32, device=dev),\n"
          "                           torch.empty((L, table_size(pb, fb)),\n"
          "                                       dtype=torch.int32, device=dev))\n"
          "    buf = cache[L, S, fb][0]"),
         ("    rows = torch.empty((L, table_size(pb, fb)), dtype=torch.int32, device=dev)",
          "    rows = cache[L, S, fb][1]")],
        True, "the two torch.empty allocations (outputs kept a shape)"),
    "k20_empty_grid": (
        "rep0_trace", "rep0.cu", "replace",
        [("    tiles_kernel(Tokens tk, int n_tok, int n_tiles, rep0::Agg* tile_agg) {",
          "    tiles_kernel(Tokens tk, int n_tok, int n_tiles, rep0::Agg* tile_agg) {\n"
          "  if (n_tok >= 0) return;  // variant: an empty grid"),
         ("  const long long at = static_cast<long long>(blockIdx.x) * n_tiles;\n"
          "  const int per",
          "  if (n_tiles >= 0) return;  // variant: an empty grid\n"
          "  const long long at = static_cast<long long>(blockIdx.x) * n_tiles;\n"
          "  const int per"),
         ("  const rep0::Agg pre = tile_pre[at];",
          "  if (n_tok >= 0) return;  // variant: an empty grid\n"
          "  const rep0::Agg pre = tile_pre[at];")],
        False, "the three grids' work (their launches and the memset stay)"),
    "k20_no_launch": (
        "rep0_trace", "rep0.cu", "replace",
        [("  if (n_tok <= 0) {\n"
          "    return static_cast<int>(cudaMemsetAsync(",
          "  if (n_lanes > 0) return 0;  // variant: no launch\n"
          "  if (n_tok <= 0) {\n"
          "    return static_cast<int>(cudaMemsetAsync(")],
        False, "the three launches (the status word's memset and readback "
        "stay)"),
    "k20_no_readback": (
        "rep0_trace", "ops/cuda_inputs.py", "replace",
        [("    if int(scratch[:4].view(torch.int32).item()):",
          "    if False:  # variant: no status readback")],
        True, "the status word's readback (a synchronise and a copy)"),
    "k20_no_ctypes": (
        "rep0_trace", "ops/cuda_inputs.py", "replace",
        [("        err = lib.lzt_rep0_trace(*(p.data_ptr() for p in planes), strides, L,",
          "        err = 0 if True else lib.lzt_rep0_trace(*(p.data_ptr() for p in planes), strides, L,"),
         ("    if int(scratch[:4].view(torch.int32).item()):",
          "    if False:  # variant: no status readback")],
        False, "the ctypes call and the readback (the checks, the planes' "
        "views, the allocations and the device guard stay)"),
    "k20_no_guard": (
        "rep0_trace", "ops/cuda_inputs.py", "replace",
        [("    with torch.cuda.device(dev):\n"
          "        err = lib.lzt_rep0_trace(",
          "    if True:  # variant: no device guard\n"
          "        err = lib.lzt_rep0_trace(")],
        True, "the torch.cuda.device guard around the call"),
    "k20_no_alloc": (
        "rep0_trace", "ops/cuda_inputs.py", "replace",
        [("    out = torch.empty((L, N), dtype=torch.int64, device=dev)\n"
          "    if L == 0 or N == 0:\n"
          "        return out",
          "    cache = globals().setdefault('_VARIANT_CACHE', {})  # variant\n"
          "    if (L, T, N) not in cache:\n"
          "        cache[L, T, N] = (torch.empty((L, N), dtype=torch.int64, device=dev),\n"
          "                          torch.empty((int(_lib().lzt_rep0_scratch(L, T)),),\n"
          "                                      dtype=torch.uint8, device=dev))\n"
          "    out = cache[L, T, N][0]"),
         ("    scratch = torch.empty((int(lib.lzt_rep0_scratch(L, T)),),\n"
          "                          dtype=torch.uint8, device=dev)",
          "    scratch = cache[L, T, N][1]")],
        True, "the two torch.empty allocations (output and scratch kept a "
        "shape)"),
}
#: the kernels whose ptxas report and (K12) blocks an SM are recorded,
#: their source and the names of their grids
PTXAS = {"suffix_table": ("search.cu", ("table_",)),
         "dp_inputs": ("dp_inputs.cu", ("rows_kernel",)),
         "path_mark": ("path.cu", ("kernel",)),
         "path_compact": ("path.cu", ("kernel",)),
         "doubling_groups": ("lazy_search.cu", ("kernel",)),
         "descent_lcp": ("lazy_search.cu", ("kernel",)),
         "best_matches": ("lazy_search.cu", ("kernel",))}
#: K13's and K14's workloads: name -> (the wrappers' index in
#: kernel_ab.MARK_WRAPPERS / COMPACT_WRAPPERS, stream or main8M-opt)
PATH_WORK = {"main8M-opt dp": (0, False), "main8M-opt seed": (1, False),
             "lzma8M-stream": (1, True)}
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
WORK = os.path.join(ROOT, "lzma_tpu_torch", "_build", "variants")


def edit(src: str, anchor: str, text) -> str | None:
    """src with `text` after the line `anchor` (or, for anchor "replace",
    each (old, new) pair of `text` replaced; for "any", the first list
    of pairs of `text` whose olds are all there); None where an anchor is
    missing."""
    if anchor == "any":
        for pairs in text:
            if all(old in src for old, _ in pairs):
                return edit(src, "replace", pairs)
        return None
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


def source_path(root: str, f_name: str) -> str:
    """A variant's file in the copy at root: csrc/f_name, or the package's
    own f_name where it holds a "/"."""
    sub = f_name if "/" in f_name else os.path.join("csrc", f_name)
    return os.path.join(root, "lzma_tpu_torch", sub)


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
        files = ([f for f, _ in text] if anchor == "files" else
                 [pairs[0] if isinstance(pairs, tuple) else fname
                  for pairs in text] if anchor == "any" else [fname])
        if all("/" in f for f in files):
            # the kernels' sources are the base copy's: its library serves
            os.symlink(os.path.join(WORK, "base", "lzma_tpu_torch", "_build"),
                       os.path.join(dst, "lzma_tpu_torch", "_build"))
        if anchor == "files":
            for f_name, pairs in text:
                path = source_path(dst, f_name)
                with open(path) as f:
                    out = edit(f.read(), "replace", pairs)
                if out is None:
                    return None
                with open(path, "w") as f:
                    f.write(out)
            return dst
        # "any" alternatives may name a file of their own: (file, pairs)
        tries = ([(fname, [pairs]) if isinstance(pairs, list) else
                  (pairs[0], [pairs[1]]) for pairs in text]
                 if anchor == "any" else [(fname, text)])
        for f_name, f_text in tries:
            path = source_path(dst, f_name)
            with open(path) as f:
                out = edit(f.read(), anchor, f_text)
            if out is not None:
                with open(path, "w") as f:
                    f.write(out)
                return dst
        return None
    return dst


def ptxas(root: str, pkg: str, source: str, names) -> dict:
    """ptxas -v's report of csrc/`source` of the package `pkg` (loaded,
    copied at root): {kernel's mangled name: its "Used ..." and stack
    lines}, for the kernels whose names hold one of `names`."""
    import importlib
    import re
    import subprocess
    import tempfile

    build = importlib.import_module(f"{pkg}.runtime.build")
    with tempfile.TemporaryDirectory(dir=WORK) as tmp:
        res = subprocess.run(
            [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas=-v", "-c", "-o",
             os.path.join(tmp, "k.o"),
             os.path.join(root, "lzma_tpu_torch", "csrc", source)],
            capture_output=True, text=True, check=True)
    out, fn = {}, None
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?([\w$]+)", line)
        if m:
            fn = m.group(1)
        elif fn and any(n in fn for n in names) and (
                "Used" in line or "stack" in line):
            out.setdefault(fn, []).append(line.strip())
    return out


def blocks_per_sm(regs: int, threads: int, smem: int) -> int:
    """Blocks of `threads` threads, `regs` registers a thread and `smem`
    shared bytes that an H100 SM holds: 65,536 registers (256 a warp at
    a time), 233,472 shared bytes (1,024 more a block), 64 warps, 32
    blocks."""
    warps = -(-threads // 32)
    by_regs = 65536 // (warps * (-(-regs * 32 // 256) * 256)) if regs else 32
    return min(by_regs, 233472 // (smem + 1024), 64 // warps, 32)


def occupancy(root: str, pkg: str, report: dict) -> dict:
    """K12's blocks an SM at main8M-opt's M 4, lc3 lp0: computed from
    ptxas' registers, and the runtime's where the checkout's library can
    say (its lzt_dp_inputs_smem takes M alone there; before, M, the
    literal slots and whether they are staged, as lc3 lp0's were)."""
    import ctypes
    import importlib
    import re

    inputs = importlib.import_module(f"{pkg}.ops.cuda_inputs")
    lib = inputs._lib()
    runtime = hasattr(lib, "lzt_dp_inputs_occupancy")
    smem = (lib.lzt_dp_inputs_smem(4) if runtime else
            lib.lzt_dp_inputs_smem(4, inputs.lit_slots(3, 0), 1))
    out = {"smem_bytes": smem}
    for fn, lines in report.items():
        regs = [int(m.group(1)) for line in lines
                for m in [re.search(r"Used (\d+) registers", line)] if m]
        if regs:
            out[fn] = {"registers": regs[0],
                       "computed": blocks_per_sm(regs[0], 256, smem)}
    if runtime:
        lib.lzt_dp_inputs_occupancy.argtypes = [ctypes.c_int]
        out["runtime"] = lib.lzt_dp_inputs_occupancy(4)
    return out


def path_occupancy(pkg: str) -> dict:
    """K13's and K14's grids' blocks an SM (ops.cuda_path.occupancy),
    where the checkout has it."""
    import importlib

    path = importlib.import_module(f"{pkg}.ops.cuda_path")
    return path.occupancy() if hasattr(path, "occupancy") else {}


def main(argv=None) -> None:
    from ..probes._cuda import card, event_ms
    from .kernel_ab import (COMPACT_WRAPPERS, LAZY_WRAPPERS, MARK_WRAPPERS,
                            grid_split, lazy_call, lazy_inputs, lists_call,
                            list_inputs, main_path_inputs, model_inputs,
                            other_wrappers, outputs, path_inputs,
                            round_inputs, row_inputs, table_inputs)

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
    if "suffix_table" in kernels:
        inputs["suffix_table"] = {"main8M-opt": table_inputs(dev)}
    if "dp_inputs" in kernels:
        inputs["dp_inputs"] = {"main8M-opt": row_inputs(dev)}
    if "price_model" in kernels:
        inputs["price_model"] = {"main8M-opt": model_inputs(dev)}
    if "rep0_trace" in kernels:
        inputs["rep0_trace"] = {"main8M-opt": round_inputs(dev)["rep0_trace"]}
    if kernels & {"path_mark", "path_compact"}:
        seen = {s: path_inputs(dev, s) for s in (False, True)}
        for kernel, ws in (("path_mark", MARK_WRAPPERS),
                           ("path_compact", COMPACT_WRAPPERS)):
            if kernel in kernels:
                inputs[kernel] = {work: (ws[i], seen[s][ws[i]])
                                  for work, (i, s) in PATH_WORK.items()}
    if kernels & set(LAZY_WRAPPERS):
        seen = {work: lazy_inputs(dev, stream) for work, stream in
                (("main8M-lazy", False), ("lzma8M-stream", True))}
        for kernel in kernels & set(LAZY_WRAPPERS):
            w = LAZY_WRAPPERS[kernel]
            inputs[kernel] = {work: (w, calls[w])
                              for work, calls in seen.items()}
        del seen

    def call(mods, kernel, args, only=None):
        if kernel in LAZY_WRAPPERS:
            return lazy_call(mods[10], *args, only)
        if kernel.startswith("path_"):
            return lambda: getattr(mods[9], args[0])(*args[1])
        if kernel == "match_lists":
            return lists_call(mods[7], args)
        if kernel == "suffix_table":
            return lambda: mods[7].suffix_table_cuda(*args)
        if kernel == "dp_inputs":
            return lambda: mods[8].dp_inputs_cuda(*args)
        if kernel == "price_model":
            model = importlib.import_module(
                mods[0].__name__.split(".")[0] + ".ops.cuda_model")
            return lambda: model.price_model_cuda(*args)
        if kernel == "rep0_trace":
            return lambda: mods[8].rep0_trace_cuda(*args)
        return lambda: mods[5].lower_counts_cuda(*args)

    copies = {v: copy(checkout, v, VARIANTS[v]) for v in chosen}
    missing = [v for v, where in copies.items() if where is None]
    if missing:
        raise SystemExit(f"kernel_split: {checkout}'s sources lack the "
                         f"anchors of {missing}")
    base_dir = copy(checkout, "base")
    os.makedirs(os.path.join(base_dir, "lzma_tpu_torch", "_build"),
                exist_ok=True)
    base = other_wrappers(base_dir, "_split_base")
    result = {"card": name, "checkout": checkout}
    reported = set()
    for k in sorted(kernels & set(PTXAS)):
        if PTXAS[k] in reported:
            continue
        reported.add(PTXAS[k])
        report = ptxas(base_dir, "_split_base", *PTXAS[k])
        result[f"{k} ptxas"] = report
        if k == "dp_inputs":
            result[f"{k} blocks_per_sm"] = occupancy(base_dir, "_split_base",
                                                     report)
        if k.startswith("path_"):
            result[f"{k} blocks_per_sm"] = path_occupancy("_split_base")
        print(f"{k} ptxas: {report}", flush=True)
    for k in sorted(kernels):
        for work, args in inputs[k].items():
            fn = call(base, k, args)
            result[f"{k} {work}"] = {"ms": event_ms(fn, 5),
                                     "grids": grid_split(fn)}
            if k == "doubling_groups":  # each level alone
                result[f"{k} {work}"]["calls_ms"] = [
                    event_ms(call(base, k, args, i), 5)
                    for i in range(len(args[1]))]
    for v in chosen:
        kernel, *_, keeps, removes = VARIANTS[v]
        mods = other_wrappers(copies[v], f"_split_{v}")
        result[v] = {"kernel": kernel, "removes": removes}
        for work, args in inputs[kernel].items():
            fns = {"base": call(base, kernel, args),
                   "variant": call(mods, kernel, args)}
            outs = {s: outputs(fn()) for s, fn in fns.items()}
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
            if kernel == "doubling_groups":
                result[v][work]["calls_ms"] = {s: [
                    event_ms(call(m, kernel, args, i), 5)
                    for i in range(len(args[1]))]
                    for s, m in (("base", base), ("variant", mods))}
            print(f"{v} on {work}: {times}", flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
