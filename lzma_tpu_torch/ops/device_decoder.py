"""Lane-parallel LZMA decoder as a vectorized bit FSM, in PyTorch.

Port of ``lzma_tpu/ops/device_decoder.py``.  Every lane (one independent
block stream) performs the same uniform step each iteration: an adaptive
or direct bit decode through a context gather, a renormalization, and a
pure select-network transition (``_transition``).  ``_decode_fsm`` is the
plain PyTorch version of the CUDA ring decoder (``ops/cuda_ring.py``) and
runs on any device; ``decode_batch`` is the list-of-bytes front end that both
routes share.

The JAX reference keeps the coder's ``range``/``code`` in uint32.  PyTorch
has no shifts or compares on uint32 on the CPU, so they ride in int64
masked to 32 bits, which keeps the unsigned order and wrap-around exact.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.constants import (
    NEXT_STATE_LITERAL,
    NEXT_STATE_LONGREP,
    NEXT_STATE_MATCH,
    NEXT_STATE_SHORTREP,
)
from ..core.layout import LITERAL_CODER_SIZE, POS_SLOT_TREE_SIZE, ProbLayout
from ..core.rangecoder import CorruptStreamError
from ..format.properties import LzmaParams


class CapExceededError(CorruptStreamError):
    """An EOS-terminated lane hit its expansion cap before the end
    marker (counterpart of device_decoder.CapExceededError)."""


# FSM phases (same numbering as the JAX reference)
PH_ISMATCH = 0
PH_LIT = 1
PH_LITM = 2
PH_ISREP = 3
PH_ISREPG0 = 4
PH_ISREP0LONG = 5
PH_ISREPG1 = 6
PH_ISREPG2 = 7
PH_LENCHOICE = 8
PH_LENCHOICE2 = 9
PH_TREE = 10
PH_DIRECT = 11
PH_REV = 12
PH_COPY = 13
PH_DONE = 14
PH_ERROR = 15

TK_LEN_MATCH = 0
TK_LEN_REP = 1
TK_POS_SLOT = 2
RK_SPEC = 0
RK_ALIGN = 1

_TOP = 1 << 24
_M32 = 0xFFFFFFFF

_w = torch.where


def _wrap_i32(x):
    """Reinterpret the low 32 bits of an int64 tensor as int32 (the JAX
    reference's int32 wrap-around)."""
    return ((x + (1 << 31)) & _M32) - (1 << 31)


# Closed forms of the 12-state machine (device_decoder._next_*)
def _next_lit(state):
    return _w(state < 4, 0, _w(state < 10, state - 3, state - 6))


def _next_match(state):
    return _w(state < 7, 7, 10)


def _next_longrep(state):
    return _w(state < 7, 8, 11)


def _next_shortrep(state):
    return _w(state < 7, 9, 11)


assert [0 if s < 4 else s - 3 if s < 10 else s - 6 for s in range(12)] == list(NEXT_STATE_LITERAL)
assert [7 if s < 7 else 10 for s in range(12)] == list(NEXT_STATE_MATCH)
assert [8 if s < 7 else 11 for s in range(12)] == list(NEXT_STATE_LONGREP)
assert [9 if s < 7 else 11 for s in range(12)] == list(NEXT_STATE_SHORTREP)


def _state_struct(n_lanes: int, device):
    """Initial per-lane register file (device_decoder._state_struct)."""
    def z(v=0):
        return torch.full((n_lanes,), v, dtype=torch.int64, device=device)
    return dict(
        phase=z(PH_ISMATCH), state=z(0),
        rep0=z(0), rep1=z(0), rep2=z(0), rep3=z(0),
        sym=z(1), lit_base=z(0), mb=z(0),
        tree_base=z(0), tree_top=z(0), tree_kind=z(0),
        rev_base=z(0), rev_sym=z(0), rev_i=z(0), rev_n=z(0), rev_kind=z(0),
        rev_m=z(1),
        acc=z(0), bits_left=z(0), dist_base=z(0),
        length=z(0),
        out_pos=z(0), in_pos=z(5),
        overrun=z(0),
    )


def _ctx_index(st, layout, pb, pos_base=0, present=None):
    """Arena index of this iteration's adaptive bit, per lane
    (device_decoder._ctx_index).  `present` (set of phases some lane is
    in, or None for all) skips the selects of absent phases, which would
    change nothing.  Returns (idx, is_adaptive, is_direct, consumes_bit)."""
    def has(ph):
        return present is None or ph in present

    phase = st["phase"]
    state = st["state"]
    sym = st["sym"]
    coded_pos = st["out_pos"] - pos_base if pos_base else st["out_pos"]
    pos_state = coded_pos & ((1 << pb) - 1)
    idx = torch.zeros_like(phase)
    if has(PH_ISMATCH):
        idx = _w(phase == PH_ISMATCH,
                 layout.is_match + (state << layout.pos_bits) + pos_state, idx)
    if has(PH_LIT):
        idx = _w(phase == PH_LIT, st["lit_base"] + sym, idx)
    if has(PH_LITM):
        match_bit = (st["mb"] >> 7) & 1
        idx = _w(phase == PH_LITM,
                 st["lit_base"] + ((1 + match_bit) << 8) + sym, idx)
    if has(PH_ISREP):
        idx = _w(phase == PH_ISREP, layout.is_rep + state, idx)
    if has(PH_ISREPG0):
        idx = _w(phase == PH_ISREPG0, layout.is_rep_g0 + state, idx)
    if has(PH_ISREP0LONG):
        idx = _w(phase == PH_ISREP0LONG,
                 layout.is_rep0_long + (state << layout.pos_bits) + pos_state,
                 idx)
    if has(PH_ISREPG1):
        idx = _w(phase == PH_ISREPG1, layout.is_rep_g1 + state, idx)
    if has(PH_ISREPG2):
        idx = _w(phase == PH_ISREPG2, layout.is_rep_g2 + state, idx)
    if has(PH_LENCHOICE) or has(PH_LENCHOICE2):
        len_base = _w(st["tree_kind"] == TK_LEN_REP, layout.rep_len_coder,
                      layout.len_coder)
        idx = _w(phase == PH_LENCHOICE, len_base + layout.len_choice, idx)
        idx = _w(phase == PH_LENCHOICE2, len_base + layout.len_choice2, idx)
    if has(PH_TREE):
        idx = _w(phase == PH_TREE, st["tree_base"] + sym, idx)
    if has(PH_REV):
        idx = _w(phase == PH_REV, st["rev_base"] + st["rev_m"], idx)
    is_adaptive = (phase <= PH_TREE) | (phase == PH_REV)
    is_direct = phase == PH_DIRECT
    return idx, is_adaptive, is_direct, is_adaptive | is_direct


def _bit_decode(rng, code, prob, is_adaptive, is_direct):
    """Uniform range-decoder step, adaptive and direct, masked
    (device_decoder._bit_decode).  rng/code: int64 holding uint32."""
    bound = (rng >> 11) * prob
    bit_a = (code >= bound).long()
    new_rng_a = _w(bit_a == 0, bound, rng - bound)
    new_code_a = _w(bit_a == 0, code, code - bound)
    new_prob = _w(bit_a == 0, prob + ((2048 - prob) >> 5), prob - (prob >> 5))
    rng_d = rng >> 1
    diff = (code - rng_d) & _M32
    bit_d = 1 - (diff >> 31)            # the reference's uint32 sign trick
    new_code_d = _w(bit_d == 1, diff, code)
    bit = _w(is_direct, bit_d, bit_a)
    new_rng = _w(is_direct, rng_d, _w(is_adaptive, new_rng_a, rng))
    new_code = _w(is_direct, new_code_d, _w(is_adaptive, new_code_a, code))
    return bit, new_rng, new_code, new_prob


def _transition(st, bit, prev_byte, back_byte, out_sizes, dict_check,
                layout, lc, lp, pb, pos_base=0, present=None):
    """FSM transition: next register file plus this iteration's output
    byte (device_decoder._transition).  `present` (set of phases some lane
    is in, or None for all) skips the blocks of absent phases: each of
    their selects is masked by its phase, so skipping them changes
    nothing.  Returns (new_st, emit, emit_byte)."""
    def has(ph):
        return present is None or ph in present

    phase = st["phase"]
    out_pos = st["out_pos"]
    coded_pos = out_pos - pos_base if pos_base else out_pos
    pos_state = coded_pos & ((1 << pb) - 1)
    lit_pos_mask = (1 << lp) - 1
    state = st["state"]
    sym = st["sym"]
    len_base = _w(st["tree_kind"] == TK_LEN_REP, layout.rep_len_coder,
                  layout.len_coder)
    no = torch.zeros_like(phase, dtype=torch.bool)

    nphase = phase
    nstate = state
    nsym = sym
    nlit_base = st["lit_base"]
    nmb = st["mb"]
    nrep0, nrep1, nrep2, nrep3 = st["rep0"], st["rep1"], st["rep2"], st["rep3"]
    ntree_base, ntree_top, ntree_kind = st["tree_base"], st["tree_top"], st["tree_kind"]
    nrev_base, nrev_sym, nrev_i, nrev_n = st["rev_base"], st["rev_sym"], st["rev_i"], st["rev_n"]
    nrev_kind, nrev_m = st["rev_kind"], st["rev_m"]
    nacc, nbits_left, ndist_base = st["acc"], st["bits_left"], st["dist_base"]
    nlength = st["length"]
    nout_pos = out_pos

    # --- PH_ISMATCH ---
    if has(PH_ISMATCH):
        lit_sub = layout.literal + (
            ((coded_pos & lit_pos_mask) << lc) + (prev_byte >> (8 - lc))
        ) * LITERAL_CODER_SIZE
        p = phase == PH_ISMATCH
        to_lit = p & (bit == 0)
        nphase = _w(to_lit & (state < 7), PH_LIT, nphase)
        nphase = _w(to_lit & (state >= 7), PH_LITM, nphase)
        nsym = _w(to_lit, 1, nsym)
        nlit_base = _w(to_lit, lit_sub, nlit_base)
        nmb = _w(to_lit, back_byte, nmb)
        nphase = _w(p & (bit == 1), PH_ISREP, nphase)

    # --- PH_LIT / PH_LITM tree walk ---
    lit_done = no
    lit_byte = None
    if has(PH_LIT) or has(PH_LITM):
        match_bit = (st["mb"] >> 7) & 1
        p_lit = phase == PH_LIT
        p_litm = phase == PH_LITM
        new_sym_l = (sym << 1) | bit
        lit_done = (p_lit | p_litm) & (new_sym_l >= 0x100)
        mism = p_litm & (match_bit != bit) & (new_sym_l < 0x100)
        nphase = _w(mism, PH_LIT, nphase)
        nmb = _w(p_litm, (st["mb"] << 1) & 0xFF, nmb)
        nsym = _w(p_lit | p_litm, new_sym_l, nsym)
        lit_byte = new_sym_l & 0xFF
        nout_pos = _w(lit_done, out_pos + 1, nout_pos)
        nstate = _w(lit_done, _next_lit(state), nstate)
        nphase = _w(lit_done, PH_ISMATCH, nphase)

    # --- PH_ISREP ---
    if has(PH_ISREP):
        p = phase == PH_ISREP
        fresh = p & (bit == 0)          # fresh match: shift rep history now
        nrep3 = _w(fresh, st["rep2"], nrep3)
        nrep2 = _w(fresh, st["rep1"], nrep2)
        nrep1 = _w(fresh, st["rep0"], nrep1)
        nphase = _w(fresh, PH_LENCHOICE, nphase)
        ntree_kind = _w(fresh, TK_LEN_MATCH, ntree_kind)
        nphase = _w(p & (bit == 1), PH_ISREPG0, nphase)

    # --- PH_ISREPG0 ---
    if has(PH_ISREPG0):
        p = phase == PH_ISREPG0
        nphase = _w(p & (bit == 0), PH_ISREP0LONG, nphase)
        nphase = _w(p & (bit == 1), PH_ISREPG1, nphase)

    # --- PH_ISREP0LONG ---
    if has(PH_ISREP0LONG):
        p = phase == PH_ISREP0LONG
        srep = p & (bit == 0)           # short rep: copy 1 byte at rep0
        nstate = _w(srep, _next_shortrep(state), nstate)
        nlength = _w(srep, 1, nlength)
        nphase = _w(srep, PH_COPY, nphase)
        longrep = p & (bit == 1)
        nphase = _w(longrep, PH_LENCHOICE, nphase)
        ntree_kind = _w(longrep, TK_LEN_REP, ntree_kind)

    # --- PH_ISREPG1 ---
    if has(PH_ISREPG1):
        p = phase == PH_ISREPG1
        g1 = p & (bit == 0)
        nrep1 = _w(g1, st["rep0"], nrep1)
        nrep0 = _w(g1, st["rep1"], nrep0)
        nphase = _w(g1, PH_LENCHOICE, nphase)
        ntree_kind = _w(g1, TK_LEN_REP, ntree_kind)
        nphase = _w(p & (bit == 1), PH_ISREPG2, nphase)

    # --- PH_ISREPG2 ---
    if has(PH_ISREPG2):
        p = phase == PH_ISREPG2
        g2 = p & (bit == 0)
        g3 = p & (bit == 1)
        nrep0 = _w(g2, st["rep2"], nrep0)
        nrep0 = _w(g3, st["rep3"], nrep0)
        nrep3 = _w(g3, st["rep2"], nrep3)
        nrep2 = _w(g2 | g3, st["rep1"], nrep2)
        nrep1 = _w(g2 | g3, st["rep0"], nrep1)
        nphase = _w(p, PH_LENCHOICE, nphase)
        ntree_kind = _w(p, TK_LEN_REP, ntree_kind)

    # --- PH_LENCHOICE ---
    if has(PH_LENCHOICE):
        p = phase == PH_LENCHOICE
        low = p & (bit == 0)
        nphase = _w(low, PH_TREE, nphase)
        ntree_base = _w(low, len_base + layout.len_low + (pos_state << 3),
                        ntree_base)
        ntree_top = _w(low, 8, ntree_top)
        nsym = _w(low, 1, nsym)
        nacc = _w(low, 0, nacc)          # acc reused as len band offset
        nphase = _w(p & (bit == 1), PH_LENCHOICE2, nphase)

    # --- PH_LENCHOICE2 ---
    if has(PH_LENCHOICE2):
        p = phase == PH_LENCHOICE2
        mid = p & (bit == 0)
        high = p & (bit == 1)
        nphase = _w(p, PH_TREE, nphase)
        ntree_base = _w(mid, len_base + layout.len_mid + (pos_state << 3),
                        ntree_base)
        ntree_top = _w(mid, 8, ntree_top)
        nacc = _w(mid, 8, nacc)
        ntree_base = _w(high, len_base + layout.len_high, ntree_base)
        ntree_top = _w(high, 256, ntree_top)
        nacc = _w(high, 16, nacc)
        nsym = _w(p, 1, nsym)

    # --- PH_TREE (len trees and pos_slot share this) ---
    if has(PH_TREE):
        p = phase == PH_TREE
        new_m = (sym << 1) | bit
        tree_done = p & (new_m >= st["tree_top"])
        nsym = _w(p, new_m, nsym)
        tree_symbol = new_m - st["tree_top"]

        # length decoded (match or rep)
        len_done = tree_done & (st["tree_kind"] != TK_POS_SLOT)
        decoded_len = st["acc"] + tree_symbol + 2
        nlength = _w(len_done, decoded_len, nlength)
        # rep length -> start copy at rep0
        rep_len_done = len_done & (st["tree_kind"] == TK_LEN_REP)
        nstate = _w(rep_len_done, _next_longrep(state), nstate)
        nphase = _w(rep_len_done, PH_COPY, nphase)
        # match length -> pos_slot tree (ctx by len_to_pos_state)
        mat_len_done = len_done & (st["tree_kind"] == TK_LEN_MATCH)
        lps = torch.clamp(decoded_len - 2, max=3)
        nstate = _w(mat_len_done, _next_match(state), nstate)
        nphase = _w(mat_len_done, PH_TREE, nphase)
        ntree_base = _w(mat_len_done, layout.pos_slot + lps * POS_SLOT_TREE_SIZE,
                        ntree_base)
        ntree_top = _w(mat_len_done, 64, ntree_top)
        ntree_kind = _w(mat_len_done, TK_POS_SLOT, ntree_kind)
        nsym = _w(mat_len_done, 1, nsym)

        # pos_slot decoded
        slot_done = tree_done & (st["tree_kind"] == TK_POS_SLOT)
        slot = tree_symbol
        small = slot_done & (slot < 4)
        nrep0 = _w(small, slot, nrep0)
        nphase = _w(small, PH_COPY, nphase)
        big = slot_done & (slot >= 4)
        direct_bits = (slot >> 1) - 1
        # int32 in the reference: slots 62/63 wrap negative, which
        # _wrap_i32 restores where the distance is formed; the shift is
        # only read on `big` lanes, so its low clamp changes nothing
        base_dist = (2 | (slot & 1)) << torch.clamp(direct_bits, 0, 30)
        ndist_base = _w(big, base_dist, ndist_base)
        spec = big & (slot < 14)
        nphase = _w(spec, PH_REV, nphase)
        nrev_base = _w(spec, layout.spec_pos + base_dist - slot - 1, nrev_base)
        nrev_n = _w(spec, direct_bits, nrev_n)
        nrev_i = _w(spec, 0, nrev_i)
        nrev_sym = _w(spec, 0, nrev_sym)
        nrev_m = _w(spec, 1, nrev_m)
        nrev_kind = _w(spec, RK_SPEC, nrev_kind)
        huge = big & (slot >= 14)
        nphase = _w(huge, PH_DIRECT, nphase)
        nbits_left = _w(huge, direct_bits - 4, nbits_left)
        nacc = _w(huge, 0, nacc)

    # --- PH_DIRECT ---
    if has(PH_DIRECT):
        p = phase == PH_DIRECT
        nacc = _w(p, (st["acc"] << 1) | bit, nacc)
        nbits_left = _w(p, st["bits_left"] - 1, nbits_left)
        dir_done = p & (st["bits_left"] == 1)
        nphase = _w(dir_done, PH_REV, nphase)
        nrev_base = _w(dir_done, layout.align, nrev_base)
        nrev_n = _w(dir_done, 4, nrev_n)
        nrev_i = _w(dir_done, 0, nrev_i)
        nrev_sym = _w(dir_done, 0, nrev_sym)
        nrev_m = _w(dir_done, 1, nrev_m)
        nrev_kind = _w(dir_done, RK_ALIGN, nrev_kind)

    # --- PH_REV ---
    # negative out_sizes mark EOS-terminated lanes: the end marker
    # (distance -1) completes them; any other negative distance, or the
    # marker in a known-size lane, is corruption
    eos = out_sizes < 0
    bound = torch.abs(out_sizes)
    marker = no
    if has(PH_REV):
        p = phase == PH_REV
        nrev_m = _w(p, (st["rev_m"] << 1) | bit, nrev_m)
        rev_val = st["rev_sym"] | (bit << st["rev_i"])
        nrev_sym = _w(p, rev_val, nrev_sym)
        nrev_i = _w(p, st["rev_i"] + 1, nrev_i)
        rev_done = p & (st["rev_i"] == st["rev_n"] - 1)
        spec_done = rev_done & (st["rev_kind"] == RK_SPEC)
        nrep0 = _w(spec_done, st["dist_base"] + rev_val, nrep0)
        align_done = rev_done & (st["rev_kind"] == RK_ALIGN)
        dist_full = _wrap_i32(st["dist_base"] + (st["acc"] << 4) + rev_val)
        nrep0 = _w(align_done, dist_full, nrep0)
        nphase = _w(rev_done, PH_COPY, nphase)
        marker = align_done & (dist_full == -1) & eos
        bad_dist = align_done & (dist_full < 0) & ~marker
        nphase = _w(bad_dist, PH_ERROR, nphase)

    # distance validity on entering copy (every entry: fresh and rep);
    # only the ISREP0LONG, TREE and REV blocks enter it
    if has(PH_ISREP0LONG) or has(PH_TREE) or has(PH_REV):
        entering = (nphase == PH_COPY) & (phase != PH_COPY)
        bad = entering & ~marker & ((nrep0 >= nout_pos) | (nrep0 >= dict_check))
        nphase = _w(bad, PH_ERROR, nphase)
        nphase = _w(marker, PH_DONE, nphase)

    # --- PH_COPY: one byte per iteration ---
    p = no
    if has(PH_COPY):
        p = phase == PH_COPY
        nout_pos = _w(p, out_pos + 1, nout_pos)
        nlength = _w(p, st["length"] - 1, nlength)
        nphase = _w(p & (st["length"] == 1), PH_ISMATCH, nphase)

    # --- the byte this iteration emits (literal or copy) ---
    emit = lit_done | p
    emit_byte = back_byte if lit_byte is None else _w(lit_done, lit_byte,
                                                      back_byte)

    # --- completion / error ---
    nphase = _w(nout_pos > bound, PH_ERROR, nphase)  # overran size/cap
    done = ~eos & (nout_pos >= bound) & (nphase == PH_ISMATCH)
    nphase = _w(done, PH_DONE, nphase)
    nphase = _w(st["overrun"] > 40, PH_ERROR, nphase)

    st2 = dict(
        phase=nphase, state=nstate,
        rep0=nrep0, rep1=nrep1, rep2=nrep2, rep3=nrep3,
        sym=nsym, lit_base=nlit_base, mb=nmb,
        tree_base=ntree_base, tree_top=ntree_top, tree_kind=ntree_kind,
        rev_base=nrev_base, rev_sym=nrev_sym, rev_i=nrev_i, rev_n=nrev_n,
        rev_kind=nrev_kind, rev_m=nrev_m,
        acc=nacc, bits_left=nbits_left, dist_base=ndist_base,
        length=nlength, out_pos=nout_pos, in_pos=st["in_pos"],
        overrun=st["overrun"],
    )
    return st2, emit, emit_byte


_FINISHED = {PH_DONE, PH_ERROR}


def _decode_fsm(comp, comp_lens, out_sizes, dict_size: int, lc: int, lp: int,
                pb: int, max_out: int, preset=None):
    """Decode N padded streams lane-parallel (device_decoder._decode_fsm).

    comp: (N, max_in) uint8; comp_lens, out_sizes: (N,) integer tensors
    on the same device.  `preset` ((P,) uint8 tensor or None) primes
    every lane's window: out_sizes are then ABSOLUTE end positions
    (P + coded size) and the payload sits at out[:, P:].  Negative
    out_sizes mark EOS-terminated lanes bounded by their magnitude.
    Returns (out (N, max_out) uint8, ok (N,) bool, out_pos (N,) int32).
    The plain PyTorch version of ``cuda_ring.decode_cuda``.
    """
    device = comp.device
    layout = ProbLayout(lc, lp, pb, pos_bits=pb)
    n_lanes, max_in = comp.shape
    lanes = torch.arange(n_lanes, device=device)
    pos_base = 0 if preset is None else int(preset.shape[0])
    comp = comp.long()
    comp_lens = comp_lens.long()
    out_sizes = out_sizes.long()

    # one sink column each: non-adaptive lanes write their prob to column
    # S, non-emitting lanes their byte to column max_out
    probs = torch.full((n_lanes, layout.size + 1), 1024, dtype=torch.int64,
                       device=device)
    out = torch.zeros((n_lanes, max_out + 1), dtype=torch.int64, device=device)
    if pos_base:
        out[:, :pos_base] = preset.long()[None, :]

    code = torch.zeros((n_lanes,), dtype=torch.int64, device=device)
    for i in range(5):
        byte = _w(i < comp_lens, comp[:, min(i, max_in - 1)], 0)
        code = ((code << 8) | byte) & _M32
    rng = torch.full((n_lanes,), _M32, dtype=torch.int64, device=device)

    st = _state_struct(n_lanes, device)
    if pos_base:
        st["out_pos"] = torch.full((n_lanes,), pos_base, dtype=torch.int64,
                                   device=device)
        prev = torch.full((n_lanes,), int(preset[-1]), dtype=torch.int64,
                          device=device)
    else:
        prev = torch.zeros((n_lanes,), dtype=torch.int64, device=device)
    dict_check = max(int(dict_size), 1)
    sink_p = layout.size

    while True:
        # the phases some lane is in: the loop ends when every lane is
        # DONE or ERROR, and the select network skips absent phases
        present = set(st["phase"].tolist())
        if present <= _FINISHED:
            break
        out_pos = st["out_pos"]

        idx, is_adaptive, is_direct, consumes_bit = _ctx_index(
            st, layout, pb, pos_base, present)
        prob = probs.gather(1, idx[:, None])[:, 0]
        bit, new_rng, new_code, new_prob = _bit_decode(
            rng, code, prob, is_adaptive, is_direct)
        probs.scatter_(1, _w(is_adaptive, idx, sink_p)[:, None],
                       new_prob[:, None])

        need = (new_rng < _TOP) & consumes_bit
        in_pos = st["in_pos"]
        safe_ip = torch.clamp(in_pos, max=max_in - 1)
        next_byte = _w(in_pos < comp_lens, comp[lanes, safe_ip], 0)
        overrun = st["overrun"] + (need & (in_pos >= comp_lens)).long()
        rng = _w(need, new_rng << 8, new_rng)
        code = _w(need, ((new_code << 8) | next_byte) & _M32, new_code)
        in_pos = in_pos + need.long()
        st = dict(st, in_pos=in_pos, overrun=overrun)

        back_byte = out[lanes, torch.clamp(out_pos - st["rep0"] - 1, 0,
                                           max_out - 1)]
        st2, emit, emit_byte = _transition(
            st, bit, prev, back_byte, out_sizes, dict_check,
            layout, lc, lp, pb, pos_base, present)
        write_idx = _w(emit, torch.clamp(out_pos, max=max_out - 1), max_out)
        out[lanes, write_idx] = emit_byte
        prev = _w(emit, emit_byte, prev)
        st = st2

    ok = st["phase"] == PH_DONE
    return (out[:, :max_out].to(torch.uint8), ok,
            st["out_pos"].to(torch.int32))


def _pow2_at_least(x: int, floor: int) -> int:
    return 1 << (max(x, floor) - 1).bit_length()


def pad_rows(rows, device):
    """Byte strings as one zero-padded (N, W) uint8 tensor, W the pow2
    bucket (at least 16) of the longest, and their (N,) int32 lengths:
    the lane layout of both the encoder's blocks and the decoder's
    streams (the reference's shape buckets)."""
    width = _pow2_at_least(max(len(r) for r in rows), 16)
    mat = np.zeros((len(rows), width), dtype=np.uint8)
    for i, r in enumerate(rows):
        mat[i, : len(r)] = np.frombuffer(r, dtype=np.uint8)
    lens = np.asarray([len(r) for r in rows], dtype=np.int32)
    return torch.from_numpy(mat).to(device), torch.from_numpy(lens).to(device)


def decode_lanes(streams, params: LzmaParams, out_sizes, decode_fn,
                 max_out=None, preset: bytes = b"", device="cuda"):
    """The list-of-bytes front end shared by ``decode_batch`` (plain FSM)
    and ``cuda_ring.decode_batch_cuda`` (the kernel): the zero-size
    short circuit, pow2 shape buckets, absolute sizes under a preset,
    and the not-ok rule.  `decode_fn` has ``_decode_fsm``'s signature."""
    n = len(streams)
    if n == 0:
        return []
    if any(abs(sz) >= 2**31 for sz in out_sizes):
        raise CorruptStreamError("output size exceeds device decoder range")
    if any(sz == 0 for sz in out_sizes):
        # the FSM always decodes one symbol before its done check, so
        # zero-output lanes (empty streams) short-circuit here
        keep = [i for i, sz in enumerate(out_sizes) if sz != 0]
        redone = decode_lanes([streams[i] for i in keep], params,
                              [out_sizes[i] for i in keep], decode_fn,
                              max_out=max_out, preset=preset, device=device)
        redo = dict(zip(keep, redone))
        return [redo.get(i, b"") for i in range(n)]
    plen = len(preset)
    comp_t, lens_t = pad_rows(streams, device)
    caps = [abs(sz) for sz in out_sizes]
    mo = _pow2_at_least(int(max_out if max_out is not None else max(caps)) + plen,
                        16)
    abs_sizes = np.asarray([sz + plen if sz > 0 else sz - plen
                            for sz in out_sizes], dtype=np.int32)
    sizes_t = torch.from_numpy(abs_sizes).to(device)
    preset_t = (torch.frombuffer(bytearray(preset), dtype=torch.uint8).to(device)
                if plen else None)
    out, ok, out_pos = decode_fn(
        comp_t, lens_t, sizes_t, min(params.dict_size, 2**31 - 1),
        params.lc, params.lp, params.pb, mo, preset=preset_t)
    out = out.cpu().numpy()
    ok = ok.cpu().numpy()
    out_pos = out_pos.cpu().numpy()
    results = []
    for i in range(n):
        if not ok[i]:
            if out_sizes[i] < 0 and int(out_pos[i]) > caps[i] + plen - 273:
                raise CapExceededError(
                    f"EOS lane {i} exceeded its {caps[i]}-byte cap")
            raise CorruptStreamError(f"device decode failed for lane {i}")
        end = out_sizes[i] + plen if out_sizes[i] > 0 else int(out_pos[i])
        results.append(out[i, plen:end].tobytes())
    return results


def decode_batch(streams, params: LzmaParams, out_sizes, max_out=None,
                 preset: bytes = b"", device="cuda"):
    """Decode a list of raw LZMA streams lane-parallel with the plain FSM
    (device_decoder.decode_batch).  out_sizes: known uncompressed sizes;
    a negative entry -cap marks an EOS-terminated stream.  `preset`
    primes every lane's window with one shared dictionary.  A lane that
    fails raises CorruptStreamError (CapExceededError for an EOS lane
    that ran out of cap).  Returns a list of bytes."""
    return decode_lanes(streams, params, out_sizes, _decode_fsm,
                        max_out=max_out, preset=preset, device=device)
