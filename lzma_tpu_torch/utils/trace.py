"""Per-symbol trace logging of the device encoder's decisions.

The port's own copy of what the device path uses of
``lzma_tpu/utils/trace.py``: ``CodecTrace`` (its ``tokens`` and
``matches`` lines, in the scalar encoder's per-symbol format, the
reference's FINE logging, Encoder.java:871-1018 and BinTree.java:139-150),
``trace_formatter`` and ``enable_trace``, on the stdlib logging module
under the logger "lzma_tpu_torch.codec".  A trace whose logger does not
accept DEBUG costs the encoder one attribute check.
"""

from __future__ import annotations

import logging

logger = logging.getLogger("lzma_tpu_torch.codec")

K_REP = 2  # device_encoder's kind of a rep match


class CodecTrace:
    """Per-symbol trace sink; enabled iff the logger accepts DEBUG."""

    def __init__(self, log: logging.Logger | None = None):
        self.log = log or logger
        self.enabled = self.log.isEnabledFor(logging.DEBUG)

    def matches(self, pos: int, pairs) -> None:
        if self.enabled:
            self.log.debug("pos=%d matches=%s", pos, pairs)

    def tokens(self, lane: int, t_pos, t_len, t_dist, kinds, rep_idx,
               ntok: int) -> None:
        """A lane's decision stream: each (pos, len, dist) token with its
        classify kind and rep index as a `pos=... <kind> len=...` line, the
        scalar encoder's per-symbol format."""
        if not self.enabled:
            return
        self.log.debug("lane=%d tokens=%d", lane, ntok)
        for j in range(ntok):
            d = int(t_dist[j])
            ln = int(t_len[j])
            if d < 0:
                kind = "literal"
            elif int(kinds[j]) == K_REP:
                k = int(rep_idx[j])
                kind = f"rep{k}" if ln > 1 else "short-rep"
            else:
                kind = f"match dist={d + 1}"
            self.log.debug("pos=%d %s len=%d", int(t_pos[j]), kind, ln)


def trace_formatter() -> logging.Formatter:
    """Compact single-line formatter for codec traces."""
    return logging.Formatter("%(relativeCreated)6dms %(name)s: %(message)s")


def enable_trace(stream=None) -> logging.Handler:
    """Route codec traces to a stream at DEBUG level."""
    h = logging.StreamHandler(stream)
    h.setFormatter(trace_formatter())
    logger.addHandler(h)
    logger.setLevel(logging.DEBUG)
    return h
