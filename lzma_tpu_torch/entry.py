"""The lane encode step and its example batch, and the multi-rank dry
run (counterparts of the root ``__graft_entry__.entry()`` and
``dryrun_multichip``).

``entry()`` returns ``(fn, example_args)``: ``fn`` is
``ops.device_encoder.encode_lanes`` with the optimal parse bound in
(lc3 lp0 pb2, fb 32, 2 candidates), the device pipeline search ->
price model -> DP scan -> classify -> lower -> range coder over a batch
of independent blocks; ``fn(*example_args)`` returns (comp (4, max_out)
uint8, comp_lens (4,) int32).  The args are tensors on `device` (the
card unless the caller passes "cpu").

``dryrun_multichip(n)`` spawns n ranks of one process group and runs the
block-parallel codec of ``parallel/mesh.py`` over them: lazy, optimal,
LZTB v2 and v3, and the hybrid where g++ is, each a round trip.

    python -m lzma_tpu_torch.entry [cpu]
    python -m lzma_tpu_torch.entry dryrun N [cpu]
"""

from __future__ import annotations

import os
import sys
import tempfile
from functools import partial

import numpy as np
import torch

from .format.properties import LzmaParams
from .ops.device_encoder import encode_lanes
from .parallel import mesh as mesh_mod
from .parallel import multihost
from .runtime import native


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


def _dryrun_data(n_ranks: int) -> bytes:
    """__graft_entry__.dryrun_multichip's bytes: two blocks a rank of a
    repeated random 23-byte word, each 13 bytes longer than the one
    before."""
    rng = np.random.default_rng(7)
    pieces = []
    for i in range(2 * n_ranks):
        word = rng.integers(0, 256, 23, dtype=np.uint8).tobytes()
        pieces.append((word * 40)[: 700 + 13 * i])
    return b"".join(pieces)


def _dryrun_rank(rank: int, n: int, init_method: str, device: str,
                 backend) -> None:
    """One rank of dryrun_multichip: join the group, round-trip each case
    over the mesh, check that no module of JAX or of the JAX package was
    loaded, leave the group."""
    torch.set_num_threads(1)
    multihost.initialize(init_method, n, rank, backend, device)
    try:
        mesh = multihost.global_mesh(device)
        data = _dryrun_data(n)
        params = LzmaParams(dict_size=1 << 12, fast_bytes=16)
        cases = [("lazy", {}, 1), ("optimal", dict(parse="optimal"), 1),
                 ("v2 preset", dict(preset_len=1 << 9), 2),
                 ("v3 dictionary", dict(dictionary=data[256:768]), 3)]
        for name, kw, version in cases:
            blob = mesh_mod.encode_blocks_mesh(data, params, block_size=1 << 10,
                                               mesh=mesh, **kw)
            out = mesh_mod.decode_blocks_mesh(blob, mesh=mesh)
            if blob is not None and (blob[4] != version or out != data):
                raise RuntimeError(f"rank {rank}: {name} mesh round trip "
                                   "mismatch")
        if native.available():
            blob = mesh_mod.encode_blocks_mesh_hybrid(
                data, params, block_size=1 << 10, mesh=mesh)
            out = mesh_mod.decode_blocks_mesh(blob, mesh=mesh)
            if blob is not None and out != data:
                raise RuntimeError(f"rank {rank}: hybrid mesh round trip "
                                   "mismatch")
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib")
                     or m == "lzma_tpu" or m.startswith("lzma_tpu."))
        if bad:
            raise RuntimeError(f"rank {rank} loaded {bad[:8]}")
    finally:
        torch.distributed.destroy_process_group()


def dryrun_multichip(n: int, device="cuda", backend=None) -> None:
    """Spawn `n` ranks (torch.multiprocessing, a file:// store in a
    temporary directory) that run the block-parallel codec over the mesh
    of all of them, each case a round trip (__graft_entry__.
    dryrun_multichip).  `backend` defaults to multihost.backend_for(device)
    (NCCL for the card, one card a rank; Gloo for the CPU).  Raises where
    a rank fails."""
    if multihost.backend_for(device, backend) == "nccl":
        mesh_mod.check_nccl_ranks(n)
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        torch.multiprocessing.start_processes(
            _dryrun_rank, args=(n, init, str(device), backend), nprocs=n,
            start_method="spawn")


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["dryrun"]:
        n = int(args[1])
        dev = args[2] if len(args) > 2 else "cuda"
        dryrun_multichip(n, dev)
        print(f"dryrun OK: {n} ranks on {dev}")
    else:
        fn, args = entry(args[0] if args else "cuda")
        out, lens = fn(*args)
        print("entry OK:", tuple(out.shape), lens.tolist())
