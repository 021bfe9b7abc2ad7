"""Lane-parallel optimal-parse DP in PyTorch.

Port of the ``parse="optimal"`` route of ``lzma_tpu/ops/device_parser.py``:

  search   tier candidate lists with exact RMQ lengths
           (device_matcher._rmq_search: K9's keys, their sorts, K10's
           suffix table and K11's lists on the card), the first M_DP
           ascending pairs per position kept for the DP
           (_select_dp_pairs) and each list's longest pair for the seed
           (_seed_pair), both K21 on the card (cuda_search.
           list_pairs_cuda, whose plain version is _list_pairs_plain);
           stages SEARCH_STAGES
  seed     a lazy parse over the lists' longest entries (_seed_tokens;
           its path and tokens K13 and K14 on the card, cuda_path)
  model    the block's own (ctx, bit) statistics (classify, K19 on the
           card, + the slot counts of the current token stream's
           lowering, lower_counts: K8 on the card) -> empirical
           probabilities -> the price planes
           and the tables that do not depend on the position
           (price_tables, _dp_tables; all four K18 on the card,
           cuda_model.price_model_cuda, whose plain version is
           _price_model_plain), the rep0-by-position trace (K20 on the
           card, cuda_inputs.rep0_trace_cuda, whose plain version is
           rep0_trace), then each
           position's row (K12 on the card, cuda_inputs.dp_inputs_cuda,
           whose plain version _dp_inputs_plain is lit_cost,
           matched_lit_cost, _pair_dist_cost, rep_match_lens_rmq and the
           packing)
  DP       the scan over positions: K3 or K4, the CUDA kernels in
           cuda_parser (dp_parse_pallas and dp_parse_pallas2 on the TPU),
           whose plain version is dp_parse_band, or the naive plane scan
           dp_parse
  extract  the backward path's marks + compaction (extract_tokens; K13
           and K14 on the card, cuda_path)

Model, DP and extract run N_ITER times, each round pricing against the
previous round's tokens.  The route's settings are fixed as the JAX
package's encoder passes them (seed "lists", n_iter 2, m_dp 4, the DP
tiers and cap of device_matcher, full_len_only False).  Lanes are the
leading axis of every tensor; values the reference keeps in int32 ride
in int64 here (prices never come near 2**31, and INF + any price stays
below it, as in the reference).
"""

from __future__ import annotations

import torch

from ..core.layout import LITERAL_CODER_SIZE, POS_SLOT_TREE_SIZE, ProbLayout
from ..core.prices import BIT_MODEL_TOTAL, PRICE_TABLE
from .device_decoder import _next_lit, _next_longrep, _next_match, _wrap_i32
from .device_encoder import (classify_tokens, keep, lower_counts,
                             pair_counts, stage)
from .device_matcher import (_bit_length, _compact, _rmq_search, greedy_path,
                             rep_match_lens_rmq)

INF = 0x0FFFFFFF
#: candidate pairs fed to the DP per position (device_parser.DEFAULT_M_DP)
M_DP = 4
#: rounds of model + DP + extract (the n_iter device_encoder passes)
N_ITER = 2
#: the seed keeps list entries this long and longer
SEED_MIN_LEN = 4
#: additive-smoothing pseudo-count of the empirical model
EMP_ALPHA = 16

#: node kinds in the band (0..3 are rep indices)
RK_LIT = -1
RK_MATCH = 4
RK_SHORTREP = 5

_w = torch.where


# ------------------------------------------------------------- model
def empirical_probs(ctx, bits, totals, arena_size: int):
    """Per-slot probabilities from a lowered (ctx, bit) stream
    (device_parser.empirical_probs): the counts of ``pair_counts``, then
    ``probs_from_counts``.  ctx, bits (L, B); totals (L,).  Returns (L,
    arena_size) int64."""
    return probs_from_counts(*pair_counts(ctx, bits, totals, arena_size))


def probs_from_counts(n, n1):
    """Per-slot probabilities from the slot counts n and n1 (L, S) of a
    lowered stream (the arithmetic of device_parser.empirical_probs after
    its scatter-adds): EMP_ALPHA pseudo-counts toward 1/2, clamped to the
    coder's reachable band; unseen slots keep 1024.  Returns (L, S)
    int64.  The numerator wraps in int32 as in the reference."""
    n = n.long()
    n0 = n - n1.long()
    num = _wrap_i32(BIT_MODEL_TOTAL * (2 * n0 + EMP_ALPHA))
    p = _w(n > 0, torch.div(num, 2 * n + 2 * EMP_ALPHA, rounding_mode="floor"),
           1024)
    return torch.clamp(p, 32, 2016)


def _flat_args(device, *arrays):
    a = torch.broadcast_tensors(*(torch.as_tensor(x, dtype=torch.int64, device=device)
                                  for x in arrays))
    return a[0].shape, [x.reshape(-1) for x in a]


def _tree_price(EP0, EP1, tree_base, nbits_max: int, nbits, value):
    """MSB-first bit-tree price (device_parser._tree_price).  tree_base,
    nbits and value broadcast together (no lane axis); EP0/EP1 are the
    (L, S) price planes, and the result gains a leading lane axis.
    Levels at or past `nbits` cost 0."""
    L, S = EP0.shape
    shape, (tb, nb, v) = _flat_args(EP0.device, tree_base, nbits, value)
    cost = torch.zeros((L, v.numel()), dtype=torch.int64, device=EP0.device)
    m = torch.ones_like(v)
    for j in range(nbits_max):
        active = j < nb
        b = (v >> torch.clamp(nb - 1 - j, 0, 31)) & 1
        cx = torch.clamp(tb + m, 0, S - 1)
        pr = _w(b == 1, EP1[:, cx], EP0[:, cx])
        cost = cost + _w(active, pr, 0)
        m = _w(active, (m << 1) | b, m)
    return cost.reshape((L,) + shape)


def _rev_tree_price(EP0, EP1, tree_base, nbits_max: int, nbits, value):
    """LSB-first (reverse) bit-tree price (device_parser._rev_tree_price)."""
    L, S = EP0.shape
    shape, (tb, nb, v) = _flat_args(EP0.device, tree_base, nbits, value)
    cost = torch.zeros((L, v.numel()), dtype=torch.int64, device=EP0.device)
    m = torch.ones_like(v)
    for j in range(nbits_max):
        active = j < nb
        b = v & 1
        cx = torch.clamp(tb + m, 0, S - 1)
        pr = _w(b == 1, EP1[:, cx], EP0[:, cx])
        cost = cost + _w(active, pr, 0)
        m = _w(active, (m << 1) | b, m)
        v = _w(active, v >> 1, v)
    return cost.reshape((L,) + shape)


def _lit_sub(data, layout, lc: int, lp: int):
    """Arena offset of each position's literal sub-coder (L, N)."""
    N = data.shape[1]
    pos = torch.arange(N, dtype=torch.int64, device=data.device)
    prev = torch.nn.functional.pad(data[:, :-1].long(), (1, 0))
    return layout.literal + (
        ((pos & ((1 << lp) - 1)) << lc) + (prev >> (8 - lc))) * LITERAL_CODER_SIZE


def matched_lit_cost(data, probs_ep, r0pos, layout, lc: int, lp: int):
    """Matched-mode literal price per position (L, N), the match byte taken
    from the rep0-by-position trace (device_parser.matched_lit_cost)."""
    EP0, EP1 = probs_ep
    N = data.shape[1]
    pos = torch.arange(N, dtype=torch.int64, device=data.device)
    sub = _lit_sub(data, layout, lc, lp)
    byte = data.long()
    mbyte = byte.gather(1, torch.clamp(pos - r0pos.long() - 1, 0, N - 1))
    x = byte ^ mbyte
    m = torch.ones_like(byte)
    cost = torch.zeros_like(byte)
    for k in range(8):
        b = (byte >> (7 - k)) & 1
        mbit = (mbyte >> (7 - k)) & 1
        prefix_eq = (x >> (8 - k)) == 0
        cx = sub + _w(prefix_eq, ((1 + mbit) << 8) + m, m)
        cost = cost + _w(b == 1, EP1.gather(1, cx), EP0.gather(1, cx))
        m = (m << 1) | b
    return cost


def _price_planes(probs, dtype=torch.int64):
    """The per-slot bit prices (EP0, EP1), each (L, S) of `dtype`, of
    per-lane probabilities (L, S): the price of a 0 and of a 1 at every
    slot.  A price fits int32, which the card's route asks for: K12 reads
    int32 planes, and lc8 lp4's are 3.1 M slots a lane."""
    PT = torch.as_tensor(PRICE_TABLE, dtype=dtype, device=probs.device)
    probs = probs.long() if dtype == torch.int64 else probs.int()
    return PT[probs >> 2], PT[(BIT_MODEL_TOTAL - probs) >> 2]


def lit_cost(data, probs_ep, layout, lc: int, lp: int):
    """Normal-mode literal price per position (L, N): the 8-step tree walk
    of build_price_model's lit_cost."""
    EP0, EP1 = probs_ep
    sub = _lit_sub(data, layout, lc, lp)
    byte = data.long()
    m = torch.ones_like(byte)
    cost = torch.zeros_like(byte)
    for k in range(8):
        b = (byte >> (7 - k)) & 1
        cx = sub + m
        cost = cost + _w(b == 1, EP1.gather(1, cx), EP0.gather(1, cx))
        m = (m << 1) | b
    return cost


def price_tables(EP0, EP1, lc: int, lp: int, pb: int):
    """build_price_model's tables that do not depend on the position,
    from the price planes of ``_price_planes``: lt_match, lt_rep (L, n_ps,
    272); ps_price (L, 4, 64); dfull (L, 4, 128); align_price (L, 16);
    im0, im1, r0l0, r0l1 (L, 12, n_ps); ir0, ir1 (L, 12); rep_sel
    (L, 4, 12), int64 (the lookups int32 from int32 planes, the same
    values)."""
    device = EP0.device
    layout = ProbLayout(lc, lp, pb, pos_bits=pb)
    n_ps = 1 << pb

    def ar(n):
        return torch.arange(n, dtype=torch.int64, device=device)

    # ---- length tables (L, n_ps, 272), match + rep ----
    def len_table(base):
        lsym = ar(272)[None, :].expand(n_ps, 272)
        ps = ar(n_ps)[:, None]
        band0 = lsym < 8
        band1 = (lsym >= 8) & (lsym < 16)
        c0 = EP0[:, base + layout.len_choice][:, None, None]
        c1 = EP1[:, base + layout.len_choice][:, None, None]
        c20 = EP0[:, base + layout.len_choice2][:, None, None]
        c21 = EP1[:, base + layout.len_choice2][:, None, None]
        head = _w(band0[None], c0, _w(band1[None], c1 + c20, c1 + c21))
        v = _w(band0, lsym, _w(band1, lsym - 8, lsym - 16))
        nb = _w(band0 | band1, 3, 8)
        tree = _w(band0, base + layout.len_low + (ps << 3),
                  _w(band1, base + layout.len_mid + (ps << 3),
                     base + layout.len_high))
        return head + _tree_price(EP0, EP1, tree, 8, nb, v)

    lt_match = len_table(layout.len_coder)
    lt_rep = len_table(layout.rep_len_coder)

    # ---- pos_slot prices (L, 4, 64) ----
    slot_v = ar(64)[None, :].expand(4, 64)
    tree = layout.pos_slot + ar(4)[:, None] * POS_SLOT_TREE_SIZE
    ps_price = _tree_price(EP0, EP1, tree, 6, 6, slot_v)

    # ---- full-distance table d < 128 (L, 4, 128) ----
    d128 = ar(128)
    nb128 = _bit_length(torch.clamp(d128, min=1)) - 1
    slot128 = _w(d128 < 4, d128,
                 (nb128 << 1) | ((d128 >> torch.clamp(nb128 - 1, min=0)) & 1))
    footer128 = torch.clamp((slot128 >> 1) - 1, min=0)
    base_val128 = (2 | (slot128 & 1)) << footer128
    reduced128 = d128 - base_val128
    spec_base = layout.spec_pos + base_val128 - slot128 - 1
    spec_nb = _w(slot128 >= 4, footer128, 0)
    spec_price = _rev_tree_price(EP0, EP1, spec_base, 5, spec_nb, reduced128)
    dfull = ps_price[:, :, slot128] + spec_price[:, None, :]

    # ---- align prices (L, 16) ----
    a16 = ar(16)
    align_price = _rev_tree_price(EP0, EP1, layout.align, 4, 4, a16)

    # ---- flag tables ----
    st = ar(12)[:, None]
    psv = ar(n_ps)[None, :]
    im_ctx = layout.is_match + (st << layout.pos_bits) + psv          # (12, n_ps)
    r0l_ctx = layout.is_rep0_long + (st << layout.pos_bits) + psv
    s12 = ar(12)
    g00 = EP0[:, layout.is_rep_g0 + s12]
    g01 = EP1[:, layout.is_rep_g0 + s12]
    g10 = EP0[:, layout.is_rep_g1 + s12]
    g11 = EP1[:, layout.is_rep_g1 + s12]
    g20 = EP0[:, layout.is_rep_g2 + s12]
    g21 = EP1[:, layout.is_rep_g2 + s12]
    # rep-selector price per rep index: the is_rep_g0/g1/g2 bit chain
    rep_sel = torch.stack([g00, g01 + g10, g01 + g11 + g20, g01 + g11 + g21],
                          dim=1)
    return dict(
        lt_match=lt_match, lt_rep=lt_rep, ps_price=ps_price, dfull=dfull,
        align_price=align_price, im0=EP0[:, im_ctx], im1=EP1[:, im_ctx],
        ir0=EP0[:, layout.is_rep + s12], ir1=EP1[:, layout.is_rep + s12],
        rep_sel=rep_sel, r0l0=EP0[:, r0l_ctx], r0l1=EP1[:, r0l_ctx],
    )


def build_price_model(data, probs, lc: int, lp: int, pb: int, r0pos):
    """Every DP price table from per-lane empirical probabilities
    (device_parser.build_price_model with r0pos given).  data (L, N)
    uint8, probs (L, S), r0pos (L, N), the rep0 trace that prices the
    matched-mode literals.
    Returns a dict of int64 tensors: lit_cost, mlit_cost (L, N) and
    ``price_tables``' tables."""
    layout = ProbLayout(lc, lp, pb, pos_bits=pb)
    planes = _price_planes(probs)
    return dict(lit_cost=lit_cost(data, planes, layout, lc, lp),
                mlit_cost=matched_lit_cost(data, planes, r0pos, layout, lc, lp),
                **price_tables(*planes, lc, lp, pb))


def _pair_dist_cost(model, dd, valid):
    """Distance price of each candidate pair at each lps (L, N, M, 4)
    (device_parser._pair_dist_cost): the exact spec-tree price below 128,
    above it pos_slot + 64 units a direct bit + the align tree; INF for
    an invalid pair."""
    L = dd.shape[0]
    d = torch.clamp(dd.long(), min=0)
    nb = _bit_length(torch.clamp(d, min=1)) - 1
    slot = _w(d < 4, d, (nb << 1) | ((d >> torch.clamp(nb - 1, min=0)) & 1))
    footer = torch.clamp((slot >> 1) - 1, min=0)
    lps = torch.arange(4, dtype=torch.int64, device=dd.device)

    def take(table, idx):
        return table.reshape(L, -1).gather(1, idx.reshape(L, -1)).reshape(idx.shape)

    big = (take(model["ps_price"], lps * 64 + slot[..., None])
           + ((footer - 4) * 64)[..., None]
           + take(model["align_price"], d & 15)[..., None])
    small = take(model["dfull"], lps * 128 + torch.clamp(d, max=127)[..., None])
    cost = _w((d < 128)[..., None], small, big)
    return _w(valid[..., None], cost, INF)


def rep0_trace(t_pos, t_dist, t_valid, N: int):
    """rep0 in effect at every position from a token stream
    (device_parser.rep0_trace): each match's distance scattered at its
    position, forward-filled by a running max; 0 before the first match."""
    L = t_pos.shape[0]
    device = t_pos.device
    is_match = t_valid & (t_dist >= 0)
    tgt = _w(is_match, torch.clamp(t_pos.long(), max=N - 1), N)
    zeros = torch.zeros((L, N + 1), dtype=torch.int64, device=device)
    dist_at = zeros.scatter(1, tgt, t_dist.long())[:, :N]
    marked = zeros.scatter(1, tgt, torch.ones_like(tgt))[:, :N]
    pos = torch.arange(N, dtype=torch.int64, device=device)
    last = torch.cummax(_w(marked > 0, pos, -1), dim=1).values
    r0 = dist_at.gather(1, torch.clamp(last, min=0))
    return _w(last >= 0, r0, 0)


#: why rep0_trace_cuda (K20) refuses a token stream: its fill from the
#: token side holds where each lane's valid tokens ascend
REP0_ORDER = ("rep0_trace_cuda takes each lane's valid tokens at strictly "
              "ascending t_pos >= 0")


def check_rep0_order(t_pos, t_valid):
    """Raise ValueError(REP0_ORDER) where K20 (``cuda_inputs.
    rep0_trace_cuda``) would: a valid token's t_pos below 0, or not above
    the valid token's before it in its lane.  K14's compactions (each
    round's tokens) never do."""
    pos = t_pos.long()
    valid = t_valid.bool()
    T = pos.shape[1]
    idx = torch.arange(T, device=pos.device).expand_as(pos)
    # each slot's last valid slot before it, -1 where none
    seen = torch.cummax(_w(valid, idx, -1), dim=1).values
    before = torch.cat([torch.full_like(seen[:, :1], -1), seen[:, :-1]], dim=1)
    prev = pos.gather(1, torch.clamp(before, min=0))
    if bool((valid & ((pos < 0) | ((before >= 0) & (pos <= prev)))).any()):
        raise ValueError(REP0_ORDER)


# ------------------------------------------------------------- DP scan
def _dp_tables(model, fb: int):
    """One lane's DP tables as a flat int32 row (L, T), the layout the
    kernel copies into shared memory: ltm, ltr (n_ps, W); im0, im1, r0l0,
    r0l1 (n_ps, 12); ir0, ir1 (12); rep_sel (4, 12).  W = fb - 1."""
    W = fb - 1
    L = model["ir0"].shape[0]
    parts = [model["lt_match"][:, :, :W], model["lt_rep"][:, :, :W]]
    parts += [model[k].transpose(1, 2) for k in ("im0", "im1", "r0l0", "r0l1")]
    parts += [model["ir0"], model["ir1"], model["rep_sel"]]
    return torch.cat([p.reshape(L, -1) for p in parts], dim=1).to(torch.int32)


def _price_model_plain(n, n1, lc: int, lp: int, pb: int, fb: int):
    """K18's plain version (``cuda_model.price_model_cuda``): the price
    model of one optimal round from its slot counts n, n1 (L, S) (K8's,
    ``lower_counts``), the chain ``probs_from_counts`` ->
    ``_price_planes`` -> ``price_tables`` -> ``_dp_tables``.  Returns
    (EP0, EP1 (L, S), ps_price (L, 4, 64), dfull (L, 4, 128), align_price
    (L, 16), the DP row (L, table_size(pb, fb)) int32): int32 on the card,
    the planes and the distance tables int64 on the CPU (the plain
    encode's peak, which the sizer's memory model was fitted to)."""
    dtype = torch.int32 if n.device.type == "cuda" else torch.int64
    planes = _price_planes(probs_from_counts(n, n1), dtype)
    model = price_tables(*planes, lc, lp, pb)
    dist = (model[k].to(dtype) for k in ("ps_price", "dfull", "align_price"))
    return (*planes, *dist, _dp_tables(model, fb))


def _split_tables(tables, n_ps: int, W: int):
    """Views of a _dp_tables row: (ltm, ltr, im0, im1, r0l0, r0l1, ir0,
    ir1, rep_sel), the flag tables indexed [lane, ps, state]."""
    L = tables.shape[0]
    sizes = [n_ps * W] * 2 + [n_ps * 12] * 4 + [12, 12, 48]
    shapes = [(n_ps, W)] * 2 + [(n_ps, 12)] * 4 + [(12,), (12,), (4, 12)]
    parts = torch.split(tables, sizes, dim=1)
    return [p.reshape((L,) + s) for p, s in zip(parts, shapes)]


def table_size(pb: int, fb: int) -> int:
    """Entries of one lane's _dp_tables row."""
    n_ps = 1 << pb
    return 2 * n_ps * (fb - 1) + 4 * n_ps * 12 + 72


def _pack_rows(data, ld, dd, model, r0pos, replen):
    """The scan's per-position rows (device_parser._pack_inputs, lanes
    first), (L, N, C) int32, C = 6M + 5: a position's row holds ld (M), dd
    (M), the distance prices (M x 4, pair-major), lit, mlit, r0pos, replen
    and sr_eq, the shortRep byte equality against the rep0 trace."""
    L, N = data.shape
    M = ld.shape[2]
    dcost = _pair_dist_cost(model, dd, (ld >= 2) & (dd >= 0))
    pos = torch.arange(N, dtype=torch.int64, device=data.device)
    src = pos - r0pos.long() - 1
    sbyte = data.gather(1, torch.clamp(src, 0, N - 1))
    sr_eq = ((data == sbyte) & (src >= 0)).long()
    return torch.cat([
        ld.long(), dd.long(), dcost.reshape(L, N, 4 * M),
        model["lit_cost"][:, :, None], model["mlit_cost"][:, :, None],
        r0pos.long()[:, :, None], replen.long()[:, :, None], sr_eq[:, :, None],
    ], dim=2).to(torch.int32)


def dp_inputs(data, ld, dd, model, fb: int, r0pos, replen):
    """The scan's inputs (device_parser._pack_inputs, lanes first) from a
    ``build_price_model`` dict and the rep0 lengths.  Returns (packed
    (L, N, C) int32 as ``_pack_rows``, tables (L, T) int32)."""
    return _pack_rows(data, ld, dd, model, r0pos, replen), _dp_tables(model, fb)


def _dp_inputs_plain(data, ld, dd, r0pos, suffix, lens, planes, dist_tables,
                     lc: int, lp: int, pb: int, fb: int):
    """K12's plain version (``cuda_inputs.dp_inputs_cuda``): the scan's
    per-position rows (L, N, 6M + 5) int32, as ``_pack_rows``, from what
    they depend on -- the per-position literal prices (lit_cost,
    matched_lit_cost) from the price planes (EP0, EP1), the rep0 lengths
    (rep_match_lens_rmq) from the suffix table (rank, T) and lens, the
    pairs' distance prices (_pair_dist_cost) from dist_tables (ps_price,
    dfull, align_price), and r0pos.  Today's arithmetic, in int64."""
    layout = ProbLayout(lc, lp, pb, pos_bits=pb)
    replen = rep_match_lens_rmq(*suffix, r0pos, lens, fb)
    model = dict(zip(("ps_price", "dfull", "align_price"), dist_tables),
                 lit_cost=lit_cost(data, planes, layout, lc, lp),
                 mlit_cost=matched_lit_cost(data, planes, r0pos, layout, lc,
                                            lp))
    return _pack_rows(data, ld, dd, model, r0pos, replen)


def _node(st_prev, r_prev, k_i, c_i):
    """Node i's state and rep set (L,), (L, 4) from its best predecessor's
    and the kind and distance of the edge that reached it: a literal or
    shortRep keeps the reps, rep k moves reps[k] to the front, a match
    pushes its distance (Encoder.java:969-973, 1001-1003)."""
    is_rep_e = (k_i >= 0) & (k_i < 4)
    is_m_e = k_i == RK_MATCH
    st_i = _w(k_i == RK_LIT, _next_lit(st_prev),
              _w(k_i == RK_SHORTREP, _w(st_prev < 7, 9, 11),
                 _w(is_rep_e, _next_longrep(st_prev), _next_match(st_prev))))
    kk = torch.clamp(k_i, 0, 3)
    picked = r_prev.gather(1, kk[:, None])[:, 0]
    r_i = torch.stack([
        _w(is_rep_e, picked, _w(is_m_e, c_i, r_prev[:, 0])),
        _w((is_rep_e & (kk >= 1)) | is_m_e, r_prev[:, 0], r_prev[:, 1]),
        _w((is_rep_e & (kk >= 2)) | is_m_e, r_prev[:, 1], r_prev[:, 2]),
        _w((is_rep_e & (kk >= 3)) | is_m_e, r_prev[:, 2], r_prev[:, 3]),
    ], dim=1)
    return st_i, r_i


def _edges(row, tabs, ps: int, p_i, st_i, r_i, live, rem, rl, lvec, lps):
    """The edges out of node i, the step both scans share.  row (L, C) is
    position i's packed row, tabs the _split_tables views; rem = lens - i
    (at least 0) caps the pair lengths, `rl` is the rep0 source's length.
    Returns (cand1, use_sr): the literal/shortRep edge's price to i+1 and
    whether shortRep (strictly cheaper) won, and (best, bdist, bkind), each
    (L, W): per length 2..fb the first cheapest source over the M pairs
    (rep-priced when the distance is in node i's rep set, the first equal
    rep index wins), then the rep0 source, with a strict `<`; INF where
    none."""
    ltm, ltr, im0, im1, r0l0, r0l1, ir0, ir1, rep_sel = tabs
    L, C = row.shape
    M = (C - 5) // 6
    W = lvec.shape[0]
    lanes = torch.arange(L, device=row.device)
    ld_i, dd_i = row[:, :M], row[:, M:2 * M]
    dc_i = row[:, 2 * M:6 * M].reshape(L, M, 4)
    lit_i, mlit_i, r0p_i, _, sr_eq_i = row[:, 6 * M:6 * M + 5].unbind(1)
    f_im0, f_im1 = im0[lanes, ps, st_i], im1[lanes, ps, st_i]
    f_r0l0, f_r0l1 = r0l0[lanes, ps, st_i], r0l1[lanes, ps, st_i]
    f_ir0, f_ir1 = ir0[lanes, st_i], ir1[lanes, st_i]
    f_sel = rep_sel[lanes, :, st_i]                               # (L, 4)

    cand_l = p_i + f_im0 + _w(st_i >= 7, mlit_i, lit_i)
    sr_ok = (sr_eq_i > 0) & (r_i[:, 0] == r0p_i)
    cand_sr = _w(sr_ok, p_i + f_im1 + f_ir1 + f_sel[:, 0] + f_r0l0, INF)
    use_sr = cand_sr < cand_l
    cand1 = torch.minimum(cand_l, cand_sr)

    ld_c = torch.minimum(ld_i, rem[:, None])
    pv = (ld_c >= 2) & (dd_i >= 0) & live[:, None]
    eq = dd_i[:, :, None] == r_i[:, None, :]                      # (L, M, 4)
    any_eq = eq.any(dim=2)
    rix = _w(eq[..., 0], 0, _w(eq[..., 1], 1, _w(eq[..., 2], 2, 3)))
    rep_base = (p_i + f_im1 + f_ir1)[:, None] + f_sel
    rep_base[:, 0] += f_r0l1
    rb = rep_base.gather(1, rix)                                  # (L, M)
    mbase = p_i + f_im1 + f_ir0
    ltm_i, ltr_i = ltm[:, ps], ltr[:, ps]                         # (L, W)
    cost = _w(any_eq[..., None], rb[..., None] + ltr_i[:, None, :],
              mbase[:, None, None] + dc_i[:, :, lps] + ltm_i[:, None, :])
    lm = lvec <= ld_c[..., None]
    cost = _w(lm & pv[..., None], cost, INF)                      # (L, M, W)
    kind_t = _w(any_eq, rix, RK_MATCH)

    def full(v):
        return torch.full((L, W), v, dtype=torch.int64, device=row.device)

    best, bdist, bkind = full(INF), full(0), full(RK_MATCH)
    for m in range(M):
        better = cost[:, m] < best
        best = _w(better, cost[:, m], best)
        bdist = _w(better, dd_i[:, m, None], bdist)
        bkind = _w(better, kind_t[:, m, None], bkind)
    rep0_ok = live & (r_i[:, 0] == r0p_i) & (rl >= 2)
    cost0 = _w(rep0_ok[:, None] & (lvec <= rl[:, None]),
               rep_base[:, :1] + ltr_i, INF)
    better = cost0 < best
    best = _w(better, cost0, best)
    bdist = _w(better, r0p_i[:, None], bdist)
    bkind = _w(better, 0, bkind)
    return cand1, use_sr, best, bdist, bkind


def _scan_setup(packed, tables, lens, fb: int, pb: int):
    """What both scans read: packed and tables in int64, the table views,
    lens, and the lengths 2..fb with their len-to-pos-state index."""
    device = packed.device
    tabs = _split_tables(tables.long(), 1 << pb, fb - 1)
    lvec = torch.arange(2, fb + 1, dtype=torch.int64, device=device)
    return packed.long(), tabs, lens.long(), lvec, torch.clamp(lvec - 2, max=3)


def dp_parse(packed, tables, lens, fb: int, pb: int):
    """The naive plane scan (device_parser.dp_parse) over the packed
    inputs of ``dp_inputs`` (not JAX's argument list: the test builds
    these from the same numpy arrays JAX's takes).  Plain PyTorch on any
    device; no encode route takes it (``tokenize_optimal(scan="naive")``).

    Every node keeps price, from (absolute), choice, kind, state and reps
    in full (L, N + fb + 1) planes; step i finalizes node i's state and
    reps from its best predecessor's plane entries and relaxes its edges
    into the window i+1..i+fb.  The rep0 source's length is the packed
    replen as it is, not capped at lens - i (the band scans cap it; the
    candidate trace already stops there).  Returns (price, from, choice,
    rkind), each (L, N + fb + 1) int32."""
    L, N, C = packed.shape
    NP = N + fb + 1
    W = fb - 1
    device = packed.device
    x, tabs, lens, lvec, lps = _scan_setup(packed, tables, lens, fb, pb)
    lanes = torch.arange(L, device=device)

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.int64, device=device)

    price, from_, choice, rkind = (full((L, NP), INF), full((L, NP), 0),
                                   full((L, NP), -1), full((L, NP), RK_LIT))
    price[:, 0] = 0
    state, reps = full((L, NP), 0), full((L, NP, 4), 0)
    for i in range(N):
        row = x[:, i]
        p_i, f_i = price[:, i], from_[:, i]
        st_i, r_i = _node(state[lanes, f_i], reps[lanes, f_i], rkind[:, i],
                          choice[:, i])
        if i == 0:
            st_i, r_i = torch.zeros_like(st_i), torch.zeros_like(r_i)
        state[:, i] = st_i
        reps[:, i] = r_i
        live = i < lens
        cand1, use_sr, best, bdist, bkind = _edges(
            row, tabs, i & ((1 << pb) - 1), p_i, st_i, r_i, live,
            torch.clamp(lens - i, min=0), row[:, C - 2], lvec, lps)

        imp = live & (cand1 < price[:, i + 1])
        price[:, i + 1] = _w(imp, cand1, price[:, i + 1])
        from_[:, i + 1] = _w(imp, i, from_[:, i + 1])
        choice[:, i + 1] = _w(imp, _w(use_sr, r_i[:, 0], -1), choice[:, i + 1])
        rkind[:, i + 1] = _w(imp, _w(use_sr, RK_SHORTREP, RK_LIT),
                             rkind[:, i + 1])
        win = slice(i + 2, i + 2 + W)
        impw = best < price[:, win]
        price[:, win] = _w(impw, best, price[:, win])
        from_[:, win] = _w(impw, i, from_[:, win])
        choice[:, win] = _w(impw, torch.clamp(bdist, min=0), choice[:, win])
        rkind[:, win] = _w(impw, bkind, rkind[:, win])
    return tuple(a.to(torch.int32) for a in (price, from_, choice, rkind))


def dp_parse_band(packed, tables, lens, fb: int, pb: int):
    """The optimal-parse scan (device_parser.dp_parse_band) over the
    packed inputs of ``dp_inputs``; the plain PyTorch version of both
    CUDA scans (``cuda_parser.dp_parse_cuda`` and ``dp_parse2_cuda``, K3
    ``dp_parse_pallas`` and K4 ``dp_parse_pallas2`` on the TPU).  One step
    per position, all lanes at once.

    The future band (price, from offset, choice, kind of nodes i..i+fb)
    and the history band (state and reps of nodes i-1..i-fb) are ring
    buffers indexed by node mod B (B = fb + 1) and mod H (H = fb), as in
    K3.  Each step finalizes node i from its best predecessor, relaxes
    the literal/shortRep edge to i+1 and, for lengths 2..fb, the M
    candidate pairs and then the rep0 source (``_edges``).  Returns
    (from, choice), each (L, N + 1) int32: node j's best predecessor and
    its distance (-1 for a literal)."""
    L, N, C = packed.shape
    B, H = fb + 1, fb
    device = packed.device
    x, tabs, lens, lvec, lps = _scan_setup(packed, tables, lens, fb, pb)
    lanes = torch.arange(L, device=device)

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.int64, device=device)

    bp, bf, bc, bk = full((L, B), INF), full((L, B), 0), full((L, B), -1), \
        full((L, B), RK_LIT)
    bp[:, 0] = 0
    hst, hrp = full((L, H), 0), full((L, H, 4), 0)
    out_from, out_choice = full((L, N + 1), 0), full((L, N + 1), 0)

    for i in range(N):
        s0 = i % B

        # --- finalize node i from its predecessor (history band) ---
        p_i, d_i, c_i, k_i = bp[:, s0], bf[:, s0], bc[:, s0], bk[:, s0]
        hs = (i - 1 - torch.clamp(d_i - 1, 0, H - 1)) % H
        st_i, r_i = _node(hst[lanes, hs], hrp[lanes, hs], k_i, c_i)
        if i == 0:
            st_i, r_i = torch.zeros_like(st_i), torch.zeros_like(r_i)
        out_from[:, i] = i - d_i
        out_choice[:, i] = c_i

        live = i < lens
        rem = torch.clamp(lens - i, min=0)
        row = x[:, i]
        cand1, use_sr, best, bdist, bkind = _edges(
            row, tabs, i & ((1 << pb) - 1), p_i, st_i, r_i, live, rem,
            torch.minimum(row[:, C - 2], rem), lvec, lps)

        # --- literal / shortRep edge -> node i+1 ---
        s1 = (i + 1) % B
        imp = live & (cand1 < bp[:, s1])
        bp[:, s1] = _w(imp, cand1, bp[:, s1])
        bf[:, s1] = _w(imp, 1, bf[:, s1])
        bc[:, s1] = _w(imp, _w(use_sr, r_i[:, 0], -1), bc[:, s1])
        bk[:, s1] = _w(imp, _w(use_sr, RK_SHORTREP, RK_LIT), bk[:, s1])

        # --- match / rep relax over lengths 2..fb -> nodes i+2..i+fb ---
        cols = (i + lvec) % B
        impw = best < bp[:, cols]
        bp[:, cols] = _w(impw, best, bp[:, cols])
        bf[:, cols] = _w(impw, lvec, bf[:, cols])
        bc[:, cols] = _w(impw, torch.clamp(bdist, min=0), bc[:, cols])
        bk[:, cols] = _w(impw, bkind, bk[:, cols])

        # --- advance: node i enters the history, its slot becomes node i+B ---
        hst[:, i % H] = st_i
        hrp[:, i % H] = r_i
        bp[:, s0], bf[:, s0], bc[:, s0], bk[:, s0] = INF, 0, -1, RK_LIT

    sN = N % B
    out_from[:, N] = N - bf[:, sN]
    out_choice[:, N] = bc[:, sN]
    return out_from.to(torch.int32), out_choice.to(torch.int32)


# ------------------------------------------------------------- extract
def _extract_mark(from_, lens):
    """K13's plain version on the DP path (``cuda_path.extract_mark_cuda``):
    pointer doubling marks the nodes reached from node lens over from_,
    kept in 1..lens.  from_ (L, NP), lens (L,).  Returns mark (L, NP)
    bool.

    Any pointers in the lane are taken here.  K13 on the card takes only
    a walk that runs one way (each from_[j] < j on it, as the DP's are)
    and pointers and lens in [0, NP), and raises ValueError otherwise."""
    L, NP = from_.shape
    device = from_.device
    lens = lens.long()
    reach = torch.zeros((L, NP), dtype=torch.int64, device=device)
    reach[torch.arange(L, device=device), lens] = 1
    h = from_.long()
    for _ in range(max(1, (NP - 1).bit_length())):
        hop = _w(reach > 0, h, 0)
        reach = reach.scatter_reduce(1, hop, reach, reduce="amax",
                                     include_self=True)
        h = h.gather(1, h)
    node = torch.arange(NP, dtype=torch.int64, device=device)
    return (reach > 0) & (node > 0) & (node <= lens[:, None])


def _extract_compact(from_, choice, mark):
    """K14's plain version in extract's form (``cuda_path.
    extract_compact_cuda``): each marked node j, in order, is the token
    (from[j], j - from[j], choice[j]); (0, 1, -1) past ntok.  Returns
    (t_pos, t_len, t_dist, t_valid, ntok)."""
    L, NP = from_.shape
    device = from_.device
    node = torch.arange(NP, dtype=torch.int64, device=device)
    tgt = _w(mark, torch.cumsum(mark.long(), dim=1) - 1, NP)

    def put(values, fill):
        out = torch.full((L, NP + 1), fill, dtype=torch.int64, device=device)
        return out.scatter_(1, tgt, values)[:, :NP]

    ntok = mark.long().sum(dim=1)
    t_valid = node[None, :] < ntok[:, None]
    return (put(from_.long(), 0), put(node - from_.long(), 1),
            put(choice.long(), -1), t_valid, ntok)


def extract_tokens(from_, choice, lens):
    """DP path -> compacted (pos, len, dist) token stream
    (device_parser.extract_tokens): pointer doubling marks the path from
    node lens back to 0; each marked node j > 0 is the token (from[j],
    j - from[j], choice[j]).  Returns (t_pos, t_len, t_dist, t_valid,
    ntok), the layout of device_matcher.tokenize.

    ``cuda_path.extract_mark_cuda`` (K13) then ``extract_compact_cuda``
    (K14) for CUDA tensors, their plain ``_extract_mark`` and
    ``_extract_compact`` for CPU ones."""
    from .cuda_path import extract_compact_cuda, extract_mark_cuda

    return extract_compact_cuda(from_, choice, extract_mark_cuda(from_, lens))


# ------------------------------------------------------------- pipeline
def _select_dp_pairs(cl, cd, counts):
    """The first M_DP ascending pairs per position, always keeping the
    longest list entry in slot M_DP-1 (device_parser._select_dp_pairs;
    the lists are DP_M_CAP > M_DP wide).  Returns (ld, dd) (L, N, M_DP);
    an empty slot has dd = -1."""
    last = torch.clamp(counts - 1, min=0)[:, :, None]
    ld = cl[:, :, :M_DP].clone()
    dd = _w(cl[:, :, :M_DP] >= 2, cd[:, :, :M_DP], -1)
    deeper = counts > M_DP
    ld[:, :, -1] = _w(deeper, cl.gather(2, last)[:, :, 0], ld[:, :, -1])
    dd[:, :, -1] = _w(deeper, cd.gather(2, last)[:, :, 0], dd[:, :, -1])
    return ld, dd


def _seed_pair(cl, cd, counts):
    """Each position's seed pair (bl, bd) (L, N): the last (longest) pair
    of its list, kept at SEED_MIN_LEN and above, else 0 (the head of
    device_parser._seed_from_lists)."""
    last = torch.clamp(counts - 1, min=0)[:, :, None]
    bl = cl.gather(2, last)[:, :, 0]
    bd = cd.gather(2, last)[:, :, 0]
    has = (counts > 0) & (bl >= SEED_MIN_LEN)
    return _w(has, bl, 0), _w(has, bd, 0)


def _list_pairs_plain(cl, cd, counts):
    """The plain version of ``cuda_search.list_pairs_cuda`` (K21): the DP
    pairs (ld, dd) (L, N, M_DP) of ``_select_dp_pairs`` and the seed pair
    (bl, bd) (L, N) of ``_seed_pair``, from the lists (L, N, width) and
    their counts."""
    return (*_select_dp_pairs(cl, cd, counts), *_seed_pair(cl, cd, counts))


def _seed_from_lists(cl, cd, counts, n):
    """The statistics seed from the candidate lists, no second search
    (device_parser._seed_from_lists with min_len SEED_MIN_LEN and no
    extension past the list depth): the last (longest) pair of each
    list, kept at SEED_MIN_LEN and above, through the lazy parse path and
    compaction."""
    return _seed_tokens(*_seed_pair(cl, cd, counts), n)


def _seed_tokens(bl, bd, n):
    """The seed's lazy parse path and compaction over its pairs (bl, bd)
    (the tail of device_parser._seed_from_lists)."""
    on_path = greedy_path(bl, bd, n, bl.shape[1], 0, True)
    return _compact(bl, bd, on_path, n, True)


def _lists_and_seed(data, lens, dict_size: int, fb: int):
    """The search and seed stages of tokenize_optimal: the (ld, dd) DP
    pairs, the seed tokens (t_pos, t_len, t_dist, t_valid) and the
    suffix (rank, T) kept for the rep0 length queries.  The DP pairs and
    the seed's pairs come from the lists in one call,
    ``cuda_search.list_pairs_cuda`` (K21 on the card, ``_list_pairs_plain``
    on the CPU), in stage "select_pairs"."""
    from .cuda_search import list_pairs_cuda

    # the search's stages (SEARCH_STAGES; the first four inside
    # _rmq_search, not nested: a stage resets the card's peak statistics)
    cl, cd, counts, s_rank, s_T = _rmq_search(data, lens, dict_size, fb)
    with stage("select_pairs", data.device):
        ld, dd, bl, bd = list_pairs_cuda(cl, cd, counts)
        del cl, cd, counts
    with stage("seed", data.device):
        tok = _seed_tokens(bl, bd, lens)
    return ld, dd, tok[:4], (s_rank, s_T)


def _round_inputs(data, lens, tokens, ld, dd, suffix, lc: int, lp: int,
                  pb: int, fb: int):
    """One round's DP inputs from the current tokens: classify (K19) + the
    lowering's slot counts (K8); the rep0 trace (K20, rep0_trace_cuda);
    the price model from the
    counts (K18, price_model_cuda: the empirical probabilities, the price
    planes, the distance tables and the DP tables' row); the rows (K12,
    dp_inputs_cuda: the rep0 lengths, the per-position literal prices and
    the pairs' distance prices).  Returns (packed, tables)."""
    from .cuda_inputs import dp_inputs_cuda, rep0_trace_cuda
    from .cuda_model import price_model_cuda

    N = data.shape[1]
    device = data.device
    tp, tl, td, tv = tokens
    with stage("classify", device):
        meta = classify_tokens(data, tp, tl, td, tv)
    count_args = (tuple(m.long() for m in meta), tp.long(), tl.long(),
                  td.long(), tv.bool(), lc, lp, pb, 10 * N + 128, 0)
    keep("count_args", count_args)
    del meta
    with stage("lower", device):
        n, n1, _ = lower_counts(*count_args)
    del count_args
    # the price model's parts, each its own stage (MODEL_STAGES; not
    # nested: a stage resets the card's peak statistics).  The empirical
    # probabilities are K18's, in stage "build_price_model", and the rep0
    # lengths K12's, in stage "dp_inputs": both stages keep their places,
    # empty
    with stage("empirical_probs", device):
        pass
    with stage("rep0_trace", device):
        r0pos = rep0_trace_cuda(tp, td, tv, N)
    with stage("rep_match_lens_rmq", device):
        pass
    with stage("build_price_model", device):
        ep0, ep1, *dist_tables, tables = price_model_cuda(n, n1, lc, lp, pb,
                                                          fb)
        del n, n1
    with stage("dp_inputs", device):
        packed = dp_inputs_cuda(data, ld, dd, r0pos, suffix, lens, (ep0, ep1),
                                tuple(dist_tables), lc, lp, pb, fb)
    return packed, tables


#: the stages of _lists_and_seed's search, in order: K9's keys, their
#: sorts, K10's table, K11's lists (device_matcher._rmq_search) and the DP
#: pairs; their sum is the one "search" stage of earlier breakdowns
SEARCH_STAGES = ("search_keys", "search_sort", "suffix_table", "match_lists",
                 "select_pairs")

#: the stages of _round_inputs' price model, in order; their sum is the
#: one "model" stage of earlier breakdowns
MODEL_STAGES = ("empirical_probs", "rep0_trace", "rep_match_lens_rmq",
                "build_price_model", "dp_inputs")

#: tokenize_optimal's scans: JAX's band=True, "pallas2" and False
SCANS = ("band", "band2", "naive")


def tokenize_optimal(data, lens, dict_size: int, *, lc: int, lp: int, pb: int,
                     fb: int, scan: str = "band"):
    """Candidate lists -> empirical prices -> DP -> tokens for N blocks
    (device_parser.tokenize_optimal as device_encoder calls it: the lists
    seed, n_iter 2, m_dp 4, DP_TIERS, cap 12 "rr").  `scan` picks the DP:
    "band" is K3 (``dp_parse_cuda``) and "band2" K4 (``dp_parse2_cuda``),
    each ``dp_parse_band`` on the CPU; "naive" is the plane scan
    ``dp_parse`` on any device.  All three give the same tokens; the
    encode route takes "band".  data (L, N) uint8, lens (L,).  Returns
    (t_pos, t_len, t_dist, t_valid, ntok) with the contract of
    device_matcher.tokenize."""
    from .cuda_parser import dp_parse2_cuda, dp_parse_cuda

    if scan not in SCANS:
        raise ValueError(f"scan must be one of {SCANS}, got {scan!r}")
    N = data.shape[1]
    device = data.device
    lens32 = lens.to(torch.int32)
    ld, dd, tokens, suffix = _lists_and_seed(data, lens, dict_size, fb)
    for _ in range(N_ITER):
        packed, tables = _round_inputs(data, lens, tokens, ld, dd, suffix,
                                       lc, lp, pb, fb)
        keep("dp_inputs", (packed, tables, lens32))
        with stage("dp_parse", device):
            if scan == "naive":
                _, from_, choice, _ = dp_parse(packed, tables, lens32, fb, pb)
            else:
                scan_fn = dp_parse2_cuda if scan == "band2" else dp_parse_cuda
                from_, choice = scan_fn(packed, tables, lens32, fb, pb)
        del packed, tables
        with stage("extract", device):
            tp, tl, td, tv, ntok = extract_tokens(from_, choice, lens)
            tokens = (tp[:, :N], tl[:, :N], td[:, :N], tv[:, :N])
    return (*tokens, ntok)
