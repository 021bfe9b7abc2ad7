"""The lane encode step and its example batch (counterpart of the root
``__graft_entry__.entry()``).

``entry()`` returns ``(fn, example_args)``: ``fn`` is
``ops.device_encoder.encode_lanes`` with the optimal parse bound in
(lc3 lp0 pb2, fb 32, 2 candidates), the device pipeline search ->
price model -> DP scan -> classify -> lower -> range coder over a batch
of independent blocks; ``fn(*example_args)`` returns (comp (4, max_out)
uint8, comp_lens (4,) int32).  The args are tensors on `device` (the
card unless the caller passes "cpu").  The multi-card dry run waits for
the port of the mesh.

    python -m lzma_tpu_torch.entry [cpu]
"""

from __future__ import annotations

import sys
from functools import partial

import numpy as np
import torch

from .ops.device_encoder import encode_lanes


def _example_batch(n_lanes=4, max_n=512, seed=0):
    """Lanes of a repeated random 37-byte pattern, each 16 bytes shorter
    than the one before (the same bytes as __graft_entry__'s)."""
    rng = np.random.default_rng(seed)
    data = np.zeros((n_lanes, max_n), dtype=np.uint8)
    lens = np.zeros((n_lanes,), dtype=np.int32)
    for i in range(n_lanes):
        n = max_n - 16 * i
        pat = rng.integers(0, 256, 37, dtype=np.uint8).tobytes()
        buf = (pat * (n // len(pat) + 1))[:n]
        data[i, :n] = np.frombuffer(buf, dtype=np.uint8)
        lens[i] = n
    return data, lens


def entry(device="cuda"):
    """(fn, example_args): the optimal-parse lane encode and its batch."""
    data, lens = _example_batch()
    fn = partial(encode_lanes, lc=3, lp=0, pb=2, fb=32, num_candidates=2,
                 parse="optimal")
    example_args = (torch.from_numpy(data).to(device),
                    torch.from_numpy(lens).to(device), 1 << 16)
    return fn, example_args


if __name__ == "__main__":
    fn, args = entry(sys.argv[1] if len(sys.argv) > 1 else "cuda")
    out, lens = fn(*args)
    print("entry OK:", tuple(out.shape), lens.tolist())
