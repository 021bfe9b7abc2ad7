"""The flat probability-arena layout of every coder in the codec.

The port's own copy of ``lzma_tpu/core/layout.py``: one contiguous
arena per lane with fixed offsets derived from (lc, lp, pb), the sub-model
sizes of the reference (Decoder.java:132-147).  ``pos_bits`` is the
posState stride of the position-conditioned tables; the device coders
pass ``pos_bits=pb``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .constants import (
    ALIGN_TABLE_SIZE,
    END_POS_MODEL_INDEX,
    NUM_FULL_DISTANCES,
    NUM_LEN_TO_POS_STATES,
    NUM_LOW_LEN_SYMBOLS,
    NUM_MID_LEN_SYMBOLS,
    NUM_POS_STATES_BITS_MAX,
    NUM_STATES,
)

POS_SLOT_TREE_SIZE = 1 << 6          # 64 nodes per tree, root at index 1
LEN_HIGH_SIZE = 1 << 8
LITERAL_CODER_SIZE = 0x300


@dataclass(frozen=True)
class ProbLayout:
    """Offsets of every sub-model inside the flat arena for lc/lp/pb."""

    lc: int
    lp: int
    pb: int
    pos_bits: int = NUM_POS_STATES_BITS_MAX

    is_match: int = field(init=False)
    is_rep: int = field(init=False)
    is_rep_g0: int = field(init=False)
    is_rep_g1: int = field(init=False)
    is_rep_g2: int = field(init=False)
    is_rep0_long: int = field(init=False)
    pos_slot: int = field(init=False)
    spec_pos: int = field(init=False)
    align: int = field(init=False)
    len_coder: int = field(init=False)
    rep_len_coder: int = field(init=False)
    literal: int = field(init=False)
    size: int = field(init=False)
    # relative offsets inside one length coder (stride-dependent)
    len_choice: int = field(init=False)
    len_choice2: int = field(init=False)
    len_low: int = field(init=False)
    len_mid: int = field(init=False)
    len_high: int = field(init=False)

    def __post_init__(self):
        assert self.pb <= self.pos_bits <= NUM_POS_STATES_BITS_MAX
        n_ps = 1 << self.pos_bits
        off = 0

        def take(n):
            nonlocal off
            cur = off
            off += n
            return cur

        put = object.__setattr__
        put(self, "is_match", take(NUM_STATES * n_ps))
        put(self, "is_rep", take(NUM_STATES))
        put(self, "is_rep_g0", take(NUM_STATES))
        put(self, "is_rep_g1", take(NUM_STATES))
        put(self, "is_rep_g2", take(NUM_STATES))
        put(self, "is_rep0_long", take(NUM_STATES * n_ps))
        put(self, "pos_slot", take(NUM_LEN_TO_POS_STATES * POS_SLOT_TREE_SIZE))
        put(self, "spec_pos", take(NUM_FULL_DISTANCES - END_POS_MODEL_INDEX))
        put(self, "align", take(ALIGN_TABLE_SIZE))
        put(self, "len_choice", 0)
        put(self, "len_choice2", 1)
        put(self, "len_low", 2)
        put(self, "len_mid", 2 + n_ps * NUM_LOW_LEN_SYMBOLS)
        put(self, "len_high", 2 + n_ps * (NUM_LOW_LEN_SYMBOLS + NUM_MID_LEN_SYMBOLS))
        len_size = self.len_high + LEN_HIGH_SIZE
        put(self, "len_coder", take(len_size))
        put(self, "rep_len_coder", take(len_size))
        put(self, "literal", take(LITERAL_CODER_SIZE << (self.lc + self.lp)))
        put(self, "size", off)
