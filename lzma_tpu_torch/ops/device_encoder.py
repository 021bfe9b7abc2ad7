"""Lane-parallel LZMA encoder in PyTorch: parse, classify, lower, serialize.

Port of ``lzma_tpu/ops/device_encoder.py`` (all but the TPU's two-dispatch
``encode_lanes_pallas``; ``encode_batch(trace=)`` dumps the decisions).
Once the token stream is fixed, the (context, bit) sequence fed to the
range coder is fully determined, so the encoder splits into

  A. tokenization                     (ops/device_matcher.tokenize, the
                                       lazy parse, or
                                       ops/device_parser.tokenize_optimal)
  B. token classification scan        (classify_tokens: state machine and
                                       rep-distance MTF per token; on the
                                       card the CUDA kernel K19 of
                                       cuda_classify, around K6's carry)
  C. bit lowering                     (lower_tokens: every token's
                                       (ctx, bit) pairs from closed forms,
                                       scattered into a flat stream; the
                                       optimal parse's rounds take only
                                       their slot counts, lower_counts)
  D. range-coder serialization        (serialize, the plain version of
                                       the CUDA kernel in cuda_serializer)

``encode_lanes`` runs D through ``cuda_serializer.serialize_checked``:
the kernel for CUDA tensors, the plain ``serialize`` for CPU tensors.
A preset (a dictionary shared by every lane) primes each lane's window:
it is searched as match history and never coded, and preset-primed
lanes keep the lazy parse, as in the reference.
The coder's uint32 ``low``/``range`` ride in int64 masked to 32 bits.
"""

from __future__ import annotations

import contextlib
import time

import torch

from ..core.layout import LITERAL_CODER_SIZE, POS_SLOT_TREE_SIZE, ProbLayout
from ..format.properties import LzmaParams

from .device_decoder import (_next_lit, _next_longrep, _next_match,
                             _next_shortrep, _wrap_i32, pad_rows)
from .device_matcher import _bit_length, tokenize

K_LIT = 0
K_MATCH = 1
K_REP = 2

#: sort-neighbor candidate tiers per position (device_encoder default)
DEFAULT_NUM_CANDIDATES = 4

MAXB = 50          # bits-with-context per token, upper bound
CTX_DIRECT = -1    # sentinel ctx: equiprobable direct bit
#: wire-distance sentinel of the end-of-stream marker token
EOS_DIST = -2

_M32 = 0xFFFFFFFF
_w = torch.where


def clamp_fb(fast_bytes: int) -> int:
    """Validate fast bytes against the reference's 5..273 range
    (device_encoder.clamp_fb)."""
    fb = int(fast_bytes)
    if not 5 <= fb <= 273:
        raise ValueError(f"fast_bytes must be in 5..273, got {fb}")
    return fb


# ---------------------------------------------------------------- phase B
# Scan cases: 0 fresh match, 1..4 rep0..rep3, 5 literal, 6 invalid token
# (the carry holds).  _REP_PERM[case] picks the new reps from
# [dist, r0, r1, r2, r3]; _state_table()[case, short, state] is the next
# state (short = len < 2, the shortRep transition of a rep).
_REP_PERM = [[0, 1, 2, 3], [1, 2, 3, 4], [2, 1, 3, 4], [3, 1, 2, 4],
             [4, 1, 2, 3], [1, 2, 3, 4], [1, 2, 3, 4]]


def _state_table(device):
    s = torch.arange(12)
    rows = []
    for case in range(7):
        for short in range(2):
            if case == 6:
                rows.append(s)
            elif case == 5:
                rows.append(_next_lit(s))
            elif case == 0:
                rows.append(_next_match(s))
            else:
                rows.append(_next_shortrep(s) if short else _next_longrep(s))
    return torch.cat(rows).to(device)


def _classify_rows(t_len, t_dist, t_valid):
    """The scan's per-token operands as (T, N) rows, one per step, so that
    a step reads one contiguous row: dist int32, len int32, valid bool."""
    return (t_dist.T.to(torch.int32).contiguous(),
            t_len.T.to(torch.int32).contiguous(),
            t_valid.T.bool().contiguous())


def _case_of(reps, dist, lit, weights):
    """First matching rep (r0 priority) -> case 1..4, none -> 0; a
    literal -> 5.  weights: [4, 3, 2, 1]."""
    m = ((reps == dist[..., None]) * weights).amax(dim=-1)
    return _w(lit, 5, _w(m > 0, 5 - m, 0))


def _classify_carry(dist_r, len_r, valid_r):
    """The serial part of classify_tokens: the state machine and the rep
    MTF carried over the token rows (T, N) of ``_classify_rows``.
    Returns (case_r, state_r, r0_r), (T, N) int32: each token's scan case
    (0 fresh match, 1..4 rep0..rep3, 5 literal), the state before it and
    rep0 before it.  An invalid token holds the carry (case 6 of the
    transition); past a lane's last valid token the carry holds to the
    end.  The plain version of ``cuda_classify.classify_carry_cuda``."""
    T, N = dist_r.shape
    device = dist_r.device
    dist_r = dist_r.long()
    # EOS_DIST is a MATCH (the end marker), not a literal
    lit_r = (dist_r < 0) & (dist_r != EOS_DIST)
    short_r = (len_r < 2).long() * 12
    table = _state_table(device)
    perm = torch.tensor(_REP_PERM, dtype=torch.int64, device=device)
    weights = torch.tensor([4, 3, 2, 1], dtype=torch.int64, device=device)
    case_r = torch.empty((T, N), dtype=torch.int32, device=device)
    state_r = torch.empty((T, N), dtype=torch.int32, device=device)
    r0_r = torch.empty((T, N), dtype=torch.int32, device=device)

    state = torch.zeros((N,), dtype=torch.int64, device=device)
    reps = torch.zeros((N, 4), dtype=torch.int64, device=device)
    any_valid = torch.nonzero(valid_r.any(dim=1))
    n_loop = int(any_valid.max()) + 1 if any_valid.numel() else 0

    for i in range(n_loop):
        dist = dist_r[i]
        state_r[i] = state
        r0_r[i] = reps[:, 0]
        case = _case_of(reps, dist, lit_r[i], weights)
        case_r[i] = case
        ucase = _w(valid_r[i], case, 6)
        reps = torch.cat([dist[:, None], reps], dim=1).gather(1, perm[ucase])
        state = table[ucase * 24 + short_r[i] + state]
    if n_loop < T:
        state_r[n_loop:] = state
        r0_r[n_loop:] = reps[:, 0]
        case_r[n_loop:] = _case_of(reps[None], dist_r[n_loop:], lit_r[n_loop:],
                                   weights)
    return case_r, state_r, r0_r


def _classify_finish(data, t_pos, t_dist, carry):
    """The vectorized part of classify_tokens: from the carry's (case,
    state, r0) rows to the per-token outputs (see classify_tokens)."""
    max_n = data.shape[1]
    d8 = data.long()
    t_pos = t_pos.long()
    t_dist = t_dist.long()
    case_r, state_r, r0_r = carry
    is_lit = (t_dist < 0) & (t_dist != EOS_DIST)
    prev_byte = _w(t_pos > 0, d8.gather(1, torch.clamp(t_pos - 1, min=0)), 0)
    lit_byte = d8.gather(1, torch.clamp(t_pos, max=max_n - 1))
    case = case_r.T.long()
    state_b = state_r.T.long()
    is_rep = (case >= 1) & (case <= 4)
    kind = _w(is_lit, K_LIT, _w(is_rep, K_REP, K_MATCH))
    rep_idx = _w(is_rep, case - 1, 3)
    match_mode = ((state_b >= 7) & is_lit).long()
    match_byte = d8.gather(1, torch.clamp(t_pos - r0_r.T.long() - 1, 0,
                                          max_n - 1))
    return kind, rep_idx, state_b, match_mode, match_byte, prev_byte, lit_byte


def _classify_tokens_plain(data, t_pos, t_len, t_dist, t_valid):
    """The plain version of ``cuda_classify.classify_tokens_cuda`` (K19):
    the carry over the token rows (``_classify_rows``, ``_classify_carry``)
    and the vectorized finish (arguments and result as
    ``classify_tokens``)."""
    rows = _classify_rows(t_len, t_dist, t_valid)
    return _classify_finish(data, t_pos, t_dist, _classify_carry(*rows))


def classify_tokens(data, t_pos, t_len, t_dist, t_valid):
    """LZMA state machine and rep MTF over the token stream
    (device_encoder.classify_tokens).

    data: (N, max_n) uint8; token arrays (N, T).  Returns per-token int64
    tensors: kind, rep_idx, state_before, match_mode, match_byte,
    prev_byte, lit_byte.  ``cuda_classify.classify_tokens_cuda``: the CUDA
    kernel K19 for CUDA tensors (the reference's lax.scan and the gathers
    around it in one call), the plain ``_classify_tokens_plain`` for CPU
    ones."""
    from .cuda_classify import classify_tokens_cuda

    keep("classify_args", (data, t_pos, t_len, t_dist, t_valid))
    return classify_tokens_cuda(data, t_pos, t_len, t_dist, t_valid)


# ---------------------------------------------------------------- phase C
def _bitrev_low(v, k_vec, width):
    """Reverse the low k bits of v (k <= width), elementwise."""
    out = torch.zeros_like(v)
    for j in range(width):
        bit = (v >> j) & 1
        shift = torch.clamp(k_vec - 1 - j, min=0)
        out = out | _w(j < k_vec, bit << shift, 0)
    return out


def lower_tokens(data, meta, t_pos, t_len, t_dist, t_valid, lc, lp, pb,
                 max_bits, pos_base: int = 0):
    """Expand tokens into (ctx, bit) pairs scattered into flat per-lane
    streams (device_encoder.lower_tokens).  `pos_base` is the preset
    length when the window is primed: token positions are absolute and
    coded positions start at pos_base.  Returns ctx (N, max_bits) int32,
    bit (N, max_bits) int32, total (N,) int32.  `data` is not read.

    ``cuda_lower.lower_tokens_cuda``: the CUDA kernel for CUDA tensors,
    the plain ``_lower_tokens_plain`` for CPU ones.  Where the reference
    silently drops bits that do not fit (a long token past the compacted
    buffer, a bit past max_bits), both raise: valid inputs never reach
    either."""
    from .cuda_lower import lower_tokens_cuda

    return lower_tokens_cuda(tuple(m.long() for m in meta), t_pos.long(),
                             t_len.long(), t_dist.long(), t_valid.bool(), lc,
                             lp, pb, max_bits, pos_base)


def _lower_tokens_plain(meta, t_pos, t_len, t_dist, t_valid, lc, lp, pb,
                        max_bits, pos_base: int = 0):
    """The plain version of ``cuda_lower.lower_tokens_cuda``: the
    reference's lowering as ~60 tensor ops a bit slot, 9 short slots then
    up to MAXB long ones, one scatter a slot (arguments and result as
    ``lower_tokens``)."""
    layout = ProbLayout(lc, lp, pb, pos_bits=pb)
    kind, rep_idx, state, match_mode, match_byte, prev_byte, lit_byte = meta
    N, T = t_pos.shape
    device = t_pos.device
    t_pos = t_pos.long()
    t_len = t_len.long()
    t_dist = t_dist.long()
    coded_pos = t_pos - pos_base
    pos_state = coded_pos & ((1 << pb) - 1)
    valid = t_valid.bool()

    is_lit = kind == K_LIT
    is_match = kind == K_MATCH
    is_rep = kind == K_REP

    # ---- per-token geometry ----
    l_sym = torch.clamp(t_len - 2, min=0)
    dlen = _w(l_sym < 8, 4, _w(l_sym < 16, 5, 10))
    rbits = _w(rep_idx < 2, 2, 3)
    srep = is_rep & (t_len < 2)

    # the EOS marker's wire distance is 0xFFFFFFFF == int32 -1: slot 63;
    # base_val and reduced wrap in int32 exactly as in the reference
    is_eos = t_dist == EOS_DIST
    dist = _w(is_eos, -1, torch.clamp(t_dist, min=0))
    nb = _bit_length(_w(is_eos, _M32, torch.clamp(dist, min=1))) - 1
    slot = _w(dist < 4, dist,
              (nb << 1) | ((dist >> torch.clamp(nb - 1, min=0)) & 1))
    slot = _w(is_eos, 63, slot)
    footer = torch.clamp((slot >> 1) - 1, min=0)
    base_val = _wrap_i32((2 | (slot & 1)) << footer)
    reduced = _wrap_i32(dist - base_val)
    spec = is_match & (slot >= 4) & (slot < 14)
    huge = is_match & (slot >= 14)
    tail_bits = _w(spec | huge, footer, 0)   # direct + align == footer

    repsel_s = 2
    len_s = _w(is_rep, 2 + rbits, 2)
    slot_s = len_s + dlen
    tail_s = slot_s + 6

    nbits = _w(is_lit, 9, _w(is_rep, len_s + dlen, tail_s + tail_bits))
    nbits = _w(srep, 4, nbits)
    nbits = _w(valid, nbits, 0)

    base_off = torch.cumsum(nbits, dim=1) - nbits
    total = nbits.sum(dim=1)

    L = layout
    im_ctx = L.is_match + (state << L.pos_bits) + pos_state
    lit_sub = L.literal + (
        ((coded_pos & ((1 << lp) - 1)) << lc) + (prev_byte >> (8 - lc))
    ) * LITERAL_CODER_SIZE
    len_base = _w(is_rep, L.rep_len_coder, L.len_coder)
    lps = torch.clamp(t_len - 2, max=3)
    slot_tree = L.pos_slot + lps * POS_SLOT_TREE_SIZE
    x = lit_byte ^ match_byte

    band = _w(l_sym < 8, 0, _w(l_sym < 16, 1, 2))
    band_bits = _w(band == 2, 8, 3)
    band_v = _w(band == 0, l_sym, _w(band == 1, l_sym - 8, l_sym - 16))
    band_tree = _w(
        band == 0, len_base + L.len_low + (pos_state << 3),
        _w(band == 1, len_base + L.len_mid + (pos_state << 3),
           len_base + L.len_high))
    choice_bits = _w(band == 0, 1, 2)

    F_full = dict(
        nbits=nbits, base_off=base_off, is_lit=is_lit, is_rep=is_rep,
        is_match=is_match, srep=srep, im_ctx=im_ctx, lit_sub=lit_sub,
        lit_byte=lit_byte, match_byte=match_byte, x=x,
        match_mode=match_mode, state=state, pos_state=pos_state,
        rep_idx=rep_idx, rbits=rbits, len_s=len_s, dlen=dlen, band=band,
        band_v=band_v, band_bits=band_bits, band_tree=band_tree,
        choice_bits=choice_bits, len_base=len_base, slot=slot,
        slot_tree=slot_tree, slot_s=slot_s, tail_s=tail_s, spec=spec,
        huge=huge, footer=footer, reduced=reduced, base_val=base_val,
    )

    def emit_slot(F, cls, t, short_side, ctx_out):
        """Scatter bit-slot t of every class-selected token.
        short_side: literal and shortRep tokens (slots 0..8); otherwise
        len >= 2 matches and reps (the literal section never fires)."""
        in_tok = (t < F["nbits"]) & cls
        width = in_tok.shape[1]
        ctx_t = torch.zeros((N, width), dtype=torch.int64, device=device)
        bit_t = torch.zeros((N, width), dtype=torch.int64, device=device)
        lit = F["is_lit"] if short_side else torch.zeros_like(in_tok)

        # -- slot 0: is_match bit --
        sel = in_tok & (t == 0)
        ctx_t = _w(sel, F["im_ctx"], ctx_t)
        bit_t = _w(sel, _w(lit, 0, 1), bit_t)

        if short_side:
            # -- literal bits (k = t-1 in 0..7) --
            k = min(max(t - 1, 0), 7)
            sel = in_tok & lit & (t >= 1)
            m = (1 << k) | (F["lit_byte"] >> (8 - k))
            b = (F["lit_byte"] >> (7 - k)) & 1
            prefix_eq = (F["x"] >> (8 - k)) == 0
            mbit = (F["match_byte"] >> (7 - k)) & 1
            use_matched = (F["match_mode"] > 0) & prefix_eq
            c = F["lit_sub"] + _w(use_matched, ((1 + mbit) << 8) + m, m)
            ctx_t = _w(sel, c, ctx_t)
            bit_t = _w(sel, b, bit_t)

        # -- is_rep bit (match/rep slot 1) --
        sel = in_tok & ~lit & (t == 1)
        ctx_t = _w(sel, L.is_rep + F["state"], ctx_t)
        bit_t = _w(sel, F["is_rep"].long(), bit_t)

        # -- rep selector bits: r0 -> [g0=0, rep0long=1]; r1 -> [1,0];
        #    r2 -> [1,1,0]; r3 -> [1,1,1] --
        kk = t - repsel_s
        sel = in_tok & F["is_rep"] & (kk >= 0) & (kk < F["rbits"])
        c1 = _w(F["rep_idx"] == 0,
                L.is_rep0_long + (F["state"] << L.pos_bits) + F["pos_state"],
                L.is_rep_g1 + F["state"])
        b1v = _w(F["rep_idx"] == 0, _w(F["srep"], 0, 1),
                 _w(F["rep_idx"] == 1, 0, 1))
        if kk == 0:
            c = L.is_rep_g0 + F["state"]
            b = _w(F["rep_idx"] == 0, 0, 1)
        elif kk == 1:
            c, b = c1, b1v
        else:
            c = L.is_rep_g2 + F["state"]
            b = _w(F["rep_idx"] == 2, 0, 1)
        ctx_t = _w(sel, c, ctx_t)
        bit_t = _w(sel, b, bit_t)

        if not short_side:
            # -- length bits (match + rep) --
            kk = t - F["len_s"]
            sel_len = in_tok & (kk >= 0) & (kk < F["dlen"])
            sel = sel_len & (kk == 0)
            ctx_t = _w(sel, F["len_base"] + L.len_choice, ctx_t)
            bit_t = _w(sel, _w(F["band"] == 0, 0, 1), bit_t)
            sel = sel_len & (kk == 1) & (F["band"] > 0)
            ctx_t = _w(sel, F["len_base"] + L.len_choice2, ctx_t)
            bit_t = _w(sel, _w(F["band"] == 1, 0, 1), bit_t)
            #   band tree (MSB-first): after j bits m = (1<<j) | (v >> (nb-j))
            j = torch.clamp(kk - F["choice_bits"], 0, 8)
            sel = sel_len & (kk - F["choice_bits"] >= 0)
            m = (1 << j) | (F["band_v"] >> torch.clamp(F["band_bits"] - j, 0, 31))
            b = (F["band_v"] >> torch.clamp(F["band_bits"] - 1 - j, 0, 31)) & 1
            ctx_t = _w(sel, F["band_tree"] + m, ctx_t)
            bit_t = _w(sel, b, bit_t)

            # -- pos_slot tree (match only), 6 bits MSB-first --
            j_raw = t - F["slot_s"]
            j = torch.clamp(j_raw, 0, 5)
            sel = in_tok & F["is_match"] & (j_raw >= 0) & (j_raw < 6)
            m = (1 << j) | (F["slot"] >> (6 - j))
            b = (F["slot"] >> (5 - j)) & 1
            ctx_t = _w(sel, F["slot_tree"] + m, ctx_t)
            bit_t = _w(sel, b, bit_t)

            # -- distance tail --
            j_raw = t - F["tail_s"]
            #   spec_pos reverse tree: footer (<=5) bits LSB-first
            j = torch.clamp(j_raw, 0, 4)
            sel = in_tok & F["spec"] & (j_raw >= 0) & (j_raw < F["footer"])
            m_rev = (1 << j) | _bitrev_low(F["reduced"], j, 5)
            b = (F["reduced"] >> j) & 1
            ctx_t = _w(sel, L.spec_pos + F["base_val"] - F["slot"] - 1 + m_rev,
                       ctx_t)
            bit_t = _w(sel, b, bit_t)
            #   huge: direct bits MSB-first then 4-bit align rev tree
            nd = F["footer"] - 4
            sel = in_tok & F["huge"] & (j_raw >= 0) & (j_raw < nd)
            b = (F["reduced"] >> torch.clamp(F["footer"] - 1 - j_raw, 0, 31)) & 1
            ctx_t = _w(sel, CTX_DIRECT, ctx_t)
            bit_t = _w(sel, b, bit_t)
            ja = torch.clamp(j_raw - nd, 0, 3)
            sel = in_tok & F["huge"] & (j_raw - nd >= 0) & (j_raw - nd < 4)
            align_v = F["reduced"] & 15
            m_rev = (1 << ja) | _bitrev_low(align_v, ja, 4)
            b = (align_v >> ja) & 1
            ctx_t = _w(sel, L.align + m_rev, ctx_t)
            bit_t = _w(sel, b, bit_t)

        # one packed scatter into the flat stream; column max_bits is the
        # sink of the slots no token emits
        dest = _w(in_tok, F["base_off"] + t, max_bits)
        packed = _w(in_tok, ctx_t * 2 + bit_t, 0).to(torch.int32)
        return ctx_out.scatter_(1, dest, packed)

    if bool((total > max_bits).any()):
        raise ValueError(f"token bits exceed the {max_bits}-entry stream")
    # packed plane: ctx * 2 + bit, initialized to the direct-bit ctx
    ctx_out = torch.full((N, max_bits + 1), CTX_DIRECT * 2, dtype=torch.int32,
                         device=device)

    short_cls = valid & (is_lit | srep)
    for t in range(9):
        ctx_out = emit_slot(F_full, short_cls, t, True, ctx_out)

    # LONG tokens (len >= 2, so at most T/2 + 1 per lane) compacted to a
    # half-width buffer; column Tc is the sink of the others
    Tc = T // 2 + 2
    long_cls = valid & ~(is_lit | srep)
    lidx = torch.cumsum(long_cls.long(), dim=1) - 1
    if bool((long_cls & (lidx >= Tc)).any()):
        raise ValueError("long tokens overflow the compacted lowering buffer")
    ltgt = _w(long_cls, lidx, Tc)

    def comp(a):
        out = torch.zeros((N, Tc + 1), dtype=a.dtype, device=device)
        return out.scatter_(1, ltgt, a)[:, :Tc]

    LONG_FIELDS = ("nbits", "base_off", "im_ctx", "is_rep", "is_match",
                   "state", "pos_state", "rep_idx", "srep", "rbits", "len_s",
                   "dlen", "band", "band_v", "band_bits", "band_tree",
                   "choice_bits", "len_base", "slot", "slot_tree",
                   "slot_s", "tail_s", "spec", "huge", "footer",
                   "reduced", "base_val")
    F_long = {kk: comp(F_full[kk]) for kk in LONG_FIELDS}
    long_c = comp(long_cls)
    maxb = min(int(_w(long_cls, nbits, 0).max()) if N * T else 0, MAXB)
    for t in range(maxb):
        ctx_out = emit_slot(F_long, long_c, t, False, ctx_out)
    ctx_out = ctx_out[:, :max_bits]
    return ctx_out >> 1, ctx_out & 1, total.to(torch.int32)


def lower_counts(meta, t_pos, t_len, t_dist, t_valid, lc, lp, pb, max_bits,
                 pos_base: int = 0):
    """The slot counts of the lowering of these tokens, without the
    streams: n and n1 (N, S) int32 (S = ProbLayout(lc, lp, pb).size),
    for each probability slot the pairs ``lower_tokens`` would write with
    that ctx and those of them with bit 1 (the direct bits are not
    counted), and total (N,) int32.  It raises where ``lower_tokens``
    raises.

    ``cuda_lower.lower_counts_cuda``: the CUDA kernel (K8) for CUDA
    tensors, the plain ``_lower_counts_plain`` for CPU ones."""
    from .cuda_lower import lower_counts_cuda

    return lower_counts_cuda(tuple(m.long() for m in meta), t_pos.long(),
                             t_len.long(), t_dist.long(), t_valid.bool(), lc,
                             lp, pb, max_bits, pos_base)


def _lower_counts_plain(meta, t_pos, t_len, t_dist, t_valid, lc, lp, pb,
                        max_bits, pos_base: int = 0):
    """The plain version of ``cuda_lower.lower_counts_cuda``: the plain
    lowering, then ``pair_counts`` of its streams (arguments and result
    as ``lower_counts``)."""
    ctx, bits, total = _lower_tokens_plain(meta, t_pos, t_len, t_dist,
                                           t_valid, lc, lp, pb, max_bits,
                                           pos_base)
    size = ProbLayout(lc, lp, pb, pos_bits=pb).size
    return (*pair_counts(ctx, bits, total, size), total)


def pair_counts(ctx, bits, totals, arena_size: int):
    """Each lane's count of the pairs of its lowered (ctx, bit) stream a
    probability slot, and of those with bit 1, by scatter-add (the counts
    of lzma_tpu's device_parser.empirical_probs): pairs at [0, total)
    with ctx >= 0.  ctx, bits (L, B); totals (L,).  Returns (n, n1), each
    (L, arena_size) int32."""
    L, B = ctx.shape
    j = torch.arange(B, device=ctx.device)
    valid = (j < totals.long()[:, None]) & (ctx >= 0)
    cix = _w(valid, ctx.long(), arena_size)
    zeros = torch.zeros((L, arena_size + 1), dtype=torch.int64, device=ctx.device)
    n = zeros.scatter_add(1, cix, valid.long())[:, :arena_size]
    n1 = zeros.scatter_add(1, cix, _w(valid, bits.long(), 0))[:, :arena_size]
    return n.to(torch.int32), n1.to(torch.int32)


# ---------------------------------------------------------------- phase D
#: iterations between the any-lane-unfinished checks; a finished lane's
#: step changes nothing, so the extra steps are harmless
_CHECK_EVERY = 32


def serialize(ctx, bits, totals, arena_size: int, max_out: int):
    """Range-code the per-lane (ctx, bit) streams (device_encoder.serialize).
    One op per iteration per lane: adaptive bit, direct bit, drain-filler
    byte, or flush step.  The plain PyTorch version of
    ``cuda_serializer.serialize_cuda``.  Returns (out (N, max_out) uint8,
    out_pos (N,) int32); out_pos can pass max_out, whose last byte then
    takes the overflow writes as in the reference."""
    N, B = ctx.shape
    device = ctx.device
    lanes = torch.arange(N, device=device)
    totals = totals.long()

    probs = torch.full((N, arena_size + 1), 1024, dtype=torch.int64,
                       device=device)                # column arena_size: sink
    out = torch.zeros((N, max_out + 1), dtype=torch.int64, device=device)

    def z(v=0):
        return torch.full((N,), v, dtype=torch.int64, device=device)

    low, carry, rng, cache = z(), z(), z(_M32), z()
    pending, drain, drain_byte = z(), z(), z()
    bit_pos, out_pos, flush_i = z(), z(), z()

    it = 0
    while True:
        if it % _CHECK_EVERY == 0:
            unfinished = (bit_pos < totals) | (drain > 0) | (flush_i < 5)
            if not bool(unfinished.any()):
                break
        it += 1
        draining = drain > 0
        has_bits = bit_pos < totals
        flushing = ~draining & ~has_bits & (flush_i < 5)
        coding = ~draining & has_bits

        bp = torch.clamp(bit_pos, max=B - 1)
        cx = ctx[lanes, bp].long()
        bt = bits[lanes, bp].long()
        adaptive = coding & (cx >= 0)
        direct = coding & (cx == CTX_DIRECT)

        # adaptive bit
        safe_cx = _w(adaptive, cx, arena_size)
        prob = probs[lanes, safe_cx]
        bound = (rng >> 11) * prob
        low_add_a = _w(bt == 1, bound, 0)
        rng_a = _w(bt == 0, bound, rng - bound)
        probs[lanes, safe_cx] = _w(bt == 0, prob + ((2048 - prob) >> 5),
                                   prob - (prob >> 5))

        # direct bit
        rng_d = rng >> 1
        low_add_d = _w(bt == 1, rng_d, 0)

        rng1 = _w(adaptive, rng_a, _w(direct, rng_d, rng))
        low_add = _w(adaptive, low_add_a, _w(direct, low_add_d, 0))
        wide = low + low_add
        new_low = wide & _M32
        new_carry = carry | (wide >> 32)

        # renormalize / flush -> shiftLow
        shift_bit = coding & (rng1 < (1 << 24))
        need_shift = shift_bit | flushing
        rng = _w(shift_bit, rng1 << 8, rng1)

        fire = need_shift & ((new_carry == 1) | (new_low < 0xFF000000))
        stall = need_shift & ~fire
        emit_byte = (cache + new_carry) & 0xFF
        filler = (0xFF + new_carry) & 0xFF

        # one write per iteration: a drain filler or the fired cache byte
        wpos = torch.clamp(out_pos, max=max_out - 1)
        wi = _w(draining | fire, wpos, max_out)
        out[lanes, wi] = _w(draining, drain_byte, emit_byte)

        out_pos = out_pos + (draining | fire).long()
        drain = _w(draining, drain - 1, _w(fire, pending, drain))
        drain_byte = _w(fire, filler, drain_byte)
        pending = _w(fire, 0, _w(stall, pending + 1, pending))
        cache = _w(fire, new_low >> 24, cache)
        low = _w(need_shift, (new_low & 0xFFFFFF) << 8, new_low)
        carry = _w(need_shift, 0, new_carry)
        bit_pos = bit_pos + coding.long()
        flush_i = flush_i + flushing.long()

    return out[:, :max_out].to(torch.uint8), out_pos.to(torch.int32)


# ------------------------------------------------------------------ API
_PROBE = None


@contextlib.contextmanager
def probing():
    """Record what the encodes inside the block do, into the dict it
    yields: each stage's seconds under "seconds" (a list a stage, one
    entry a call; the device is synchronized around each stage), on a
    CUDA device each stage's peak bytes above what was allocated when it
    began under "peak_bytes" (the same lists; the card's peak statistics
    are reset at each stage's start), the
    last DP round's inputs under "dp_inputs", the last classify call's
    arguments under "classify_args", the final tokens and (ctx, bit)
    streams under "lowered", the final lowering's arguments
    (``cuda_lower.lower_tokens_cuda``'s) under "lower_args" and the last
    optimal round's slot counts' arguments (``cuda_lower.
    lower_counts_cuda``'s) under "count_args", all held by
    reference.  For
    diagnostics; an encode outside such a block records nothing."""
    global _PROBE
    outer, _PROBE = _PROBE, {}
    try:
        yield _PROBE
    finally:
        _PROBE = outer


def keep(name: str, value):
    """Hand `value` to the enclosing probing() block under `name`."""
    if _PROBE is not None:
        _PROBE[name] = value


@contextlib.contextmanager
def stage(name: str, device):
    """Time one encode stage into the probing() block's seconds,
    synchronizing `device` on both sides, and on a CUDA device record its
    peak memory; nothing outside such a block."""
    if _PROBE is None:
        yield
        return
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    t = time.perf_counter()
    yield
    if cuda:
        torch.cuda.synchronize(device)
        _PROBE.setdefault("peak_bytes", {}).setdefault(name, []).append(
            torch.cuda.max_memory_allocated(device) - base)
    _PROBE.setdefault("seconds", {}).setdefault(name, []).append(
        time.perf_counter() - t)


def _append_eos_tokens(t_pos, t_len, t_dist, t_valid, ntok, lens):
    """Append the end-of-stream marker token to every lane's compacted
    stream (device_encoder._append_eos_tokens): a len-2 match at the
    EOS_DIST sentinel distance coded at the end position.  The token
    arrays grow by one column, padded as the reference pads them (pos 0,
    len 1, dist -1); token ntok of each lane becomes the marker."""
    N, T = t_pos.shape
    device = t_pos.device

    def pad(a, value):
        return torch.cat([a, torch.full((N, 1), value, dtype=a.dtype,
                                        device=device)], dim=1)

    t_pos, t_len, t_dist = pad(t_pos, 0), pad(t_len, 1), pad(t_dist, -1)
    lanes = torch.arange(N, device=device)
    ntok = ntok.long()
    t_pos[lanes, ntok] = lens.to(t_pos.dtype)
    t_len[lanes, ntok] = 2
    t_dist[lanes, ntok] = EOS_DIST
    t_valid = torch.arange(T + 1, device=device)[None, :] < (ntok + 1)[:, None]
    return t_pos, t_len, t_dist, t_valid


def _lower_lanes(data, lens, dict_size, lc, lp, pb, fb, num_candidates,
                 preset=None, write_eos: bool = False, parse: str = "lazy"):
    """Phases A-C for a lane batch (device_encoder._lower_lanes).
    `preset` ((P,) uint8 tensor or None) primes every lane's window;
    preset-primed lanes keep the lazy parse.  parse="optimal" tokenizes
    with device_parser.tokenize_optimal.  `write_eos` appends the end
    marker after either parse.  Returns (ctx, bits, totals, max_out)."""
    N, max_n = data.shape
    device = data.device
    plen = 0 if preset is None else int(preset.shape[0])
    if plen:
        data = torch.cat([preset.to(data.dtype).expand(N, plen), data], dim=1)
        lens = lens + plen
    if parse.startswith("optimal") and plen == 0:
        from .device_parser import tokenize_optimal

        if parse != "optimal":
            raise NotImplementedError(
                f"parse={parse!r}: only the default list seed is ported")
        tok = tokenize_optimal(data, lens, dict_size, lc=lc, lp=lp, pb=pb,
                               fb=fb)
    else:
        # the stages of device_matcher.LAZY_STAGES, inside tokenize
        tok = tokenize(data, lens, dict_size, fb, num_candidates, start=plen)
    t_pos, t_len, t_dist, t_valid, ntok = tok
    if write_eos:
        t_pos, t_len, t_dist, t_valid = _append_eos_tokens(
            t_pos, t_len, t_dist, t_valid, ntok, lens)
    with stage("classify", device):
        meta = classify_tokens(data, t_pos, t_len, t_dist, t_valid)
    max_bits = 10 * max_n + 128
    with stage("lower", device):
        ctx, bits, totals = lower_tokens(data, meta, t_pos, t_len, t_dist,
                                         t_valid, lc, lp, pb, max_bits,
                                         pos_base=plen)
    keep("lowered", (t_pos, t_len, t_valid, ctx, bits, totals))
    keep("lower_args", (meta, t_pos, t_len, t_dist, t_valid, lc, lp, pb,
                        max_bits, plen))
    return ctx, bits, totals, max_n + max_n // 4 + 128


def encode_lanes(data, lens, dict_size, *, lc: int, lp: int, pb: int,
                 fb: int, num_candidates: int = DEFAULT_NUM_CANDIDATES,
                 preset=None, write_eos: bool = False, parse: str = "lazy"):
    """The lane-parallel encode on tensors (device_encoder.encode_lanes):
    phases A-C, then the range coder through
    ``cuda_serializer.serialize_checked`` (the CUDA kernel for CUDA
    tensors, the plain ``serialize`` for CPU ones).  data: (N, max_n)
    uint8, lens: (N,) int32, dict_size an int (or a 0-d tensor).
    `preset` ((P,) uint8 or None) primes every lane's window.  Returns
    (comp (N, max_out) uint8, comp_lens (N,) int32)."""
    from .cuda_serializer import serialize_checked

    ctx, bits, totals, max_out = _lower_lanes(
        data, lens, int(dict_size), lc, lp, pb, fb, num_candidates,
        preset=preset, write_eos=write_eos, parse=parse)
    layout = ProbLayout(lc, lp, pb, pos_bits=pb)
    with stage("rc_serialize", data.device):
        return serialize_checked(ctx, bits, totals, layout.size, int(max_out))


def _dump_device_trace(trace, data_t, lens_t, dict_j: int, fb: int,
                       num_candidates: int, preset_t, parse: str, params):
    """Run the (deterministic) tokenizer once more, outside the encode, and
    print every lane's decision stream and the candidate lists at each
    decision through `trace` (device_encoder._dump_device_trace): the
    optimal parse's lists are find_match_lists_rmq's at DP_TIERS with the
    DP's cap, the lists the DP saw; the lazy parse's are its best pair,
    a list of one.  Lines and their order are the reference's; the parse
    is the encode's own lc/lp/pb (the reference's dump prices it at lc3
    lp0 pb2 whatever the encode's)."""
    from .device_matcher import (DP_M_CAP, DP_TIER_KS, find_best_matches_rmq,
                                 find_match_lists_rmq)

    N, max_n = data_t.shape
    dj, lj, plen = data_t, lens_t, 0
    if preset_t is not None:
        plen = int(preset_t.shape[0])
        dj = torch.cat([preset_t.to(dj.dtype).expand(N, plen), dj], dim=1)
        lj = lj + plen
    optimal = parse.startswith("optimal") and plen == 0
    if optimal:
        from .device_parser import tokenize_optimal

        tok = tokenize_optimal(dj, lj, dict_j, lc=params.lc, lp=params.lp,
                               pb=params.pb, fb=fb)
        cl, cd, cn = find_match_lists_rmq(dj, lj, dict_j, fb, m_cap=DP_M_CAP,
                                          m_cap_order="rr", **DP_TIER_KS)
    else:
        tok = tokenize(dj, lj, dict_j, fb, num_candidates, start=plen)
        bl, bd = find_best_matches_rmq(dj, lj, dict_j, fb, num_candidates)
        cl = bl[:, :, None]
        cd = torch.where(bl > 0, bd, 0)[:, :, None]
        cn = (bl >= 2).long()
    tp, tl, td, tv, ntok = tok
    meta = classify_tokens(dj, tp, tl, td, tv)
    kinds, rep_idx = meta[0].cpu().numpy(), meta[1].cpu().numpy()
    tp, tl, td, ntok, cl, cd, cn = (x.cpu().numpy()
                                    for x in (tp, tl, td, ntok, cl, cd, cn))
    for i in range(N):
        trace.tokens(i, tp[i] - plen, tl[i], td[i], kinds[i], rep_idx[i],
                     int(ntok[i]))
        for j in range(int(ntok[i])):
            pos = int(tp[i, j])
            pairs = [(int(cl[i, pos, m]), int(cd[i, pos, m]))
                     for m in range(int(cn[i, pos]))]
            trace.matches(pos - plen, pairs)


def encode_batch(blocks, params: LzmaParams, fb=None,
                 num_candidates: int = DEFAULT_NUM_CANDIDATES,
                 preset: bytes = b"", write_eos: bool = False,
                 parse: str = "lazy", device="cuda", trace=None):
    """Encode independent blocks lane-parallel (device_encoder.encode_batch)
    through ``encode_lanes``.  `preset` primes every lane's window with
    one shared dictionary (LZTB v2/v3 blocks); `write_eos` ends every
    stream with the end marker.  The range coder is the CUDA kernel for a
    CUDA `device` and the plain ``serialize`` for the CPU (``probing``
    records the stages).  `trace` (``utils.trace.CodecTrace``), where it
    is enabled, prints every lane's decisions and candidate lists in the
    scalar per-symbol format (``_dump_device_trace``).  Returns a list of
    raw LZMA streams."""
    if not blocks:
        return []
    params = params.validated_for_encode()
    fb = clamp_fb(fb if fb is not None else params.fast_bytes)
    data_t, lens_t = pad_rows(blocks, device)  # pow2 bucket, as the reference
    # the match window never reaches past the bucket (and the preset):
    # this bound changes the distances searched, hence the bytes, exactly
    # as in the reference
    dict_j = min(params.dict_size, data_t.shape[1] + len(preset))
    preset_t = (torch.frombuffer(bytearray(preset), dtype=torch.uint8).to(device)
                if preset else None)
    if trace is not None and getattr(trace, "enabled", False):
        _dump_device_trace(trace, data_t, lens_t, dict_j, fb, num_candidates,
                           preset_t, parse, params)
    out, out_lens = encode_lanes(
        data_t, lens_t, dict_j, lc=params.lc, lp=params.lp, pb=params.pb,
        fb=fb, num_candidates=num_candidates, preset=preset_t,
        write_eos=write_eos, parse=parse)
    out = out.cpu().numpy()
    out_lens = out_lens.cpu().numpy()
    return [out[i, : out_lens[i]].tobytes() for i in range(len(blocks))]
