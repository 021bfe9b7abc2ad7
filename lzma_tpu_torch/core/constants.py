"""LZMA format constants and the 12-state machine's transition tables.

The port's own copy of what it uses from ``lzma_tpu/core/constants.py``
(Base.java:6-85); the two are held equal by tests/test_torch_parser.py.
"""

from __future__ import annotations

import numpy as np

NUM_REP_DISTANCES = 4
NUM_STATES = 12

_STATES = np.arange(NUM_STATES)
NEXT_STATE_LITERAL = np.where(
    _STATES < 4, 0, np.where(_STATES < 10, _STATES - 3, _STATES - 6)
).astype(np.int32)
NEXT_STATE_MATCH = np.where(_STATES < 7, 7, 10).astype(np.int32)
NEXT_STATE_SHORTREP = np.where(_STATES < 7, 9, 11).astype(np.int32)
NEXT_STATE_LONGREP = np.where(_STATES < 7, 8, 11).astype(np.int32)

MATCH_MIN_LEN = 2
NUM_LOW_LEN_SYMBOLS = 1 << 3
NUM_MID_LEN_SYMBOLS = 1 << 3
NUM_LEN_SYMBOLS = NUM_LOW_LEN_SYMBOLS + NUM_MID_LEN_SYMBOLS + (1 << 8)
MATCH_MAX_LEN = MATCH_MIN_LEN + NUM_LEN_SYMBOLS - 1  # 273

NUM_LEN_TO_POS_STATES = 1 << 2
ALIGN_TABLE_SIZE = 1 << 4
END_POS_MODEL_INDEX = 14
NUM_FULL_DISTANCES = 1 << (END_POS_MODEL_INDEX // 2)  # 128

NUM_POS_STATES_BITS_MAX = 4
NUM_POS_STATES_MAX = 1 << NUM_POS_STATES_BITS_MAX
NUM_LIT_POS_BITS_MAX = 4
NUM_LIT_CONTEXT_BITS_MAX = 8

DICT_LOG_SIZE_MAX_COMPRESS = 29
