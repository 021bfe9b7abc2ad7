"""Multi-host scaling: one process a card, the block mesh over all of them.

Port of ``lzma_tpu/parallel/multihost.py`` on torch.distributed.
``initialize()`` joins the default process group; the block-parallel
codec of ``parallel/mesh.py`` then runs unchanged over every rank of
every host, its collectives on the backend chosen here.  Input
distribution and the final ordered concat stay on rank 0, the natural
layout for a file codec.  Every rank calls each entry point with the
same arguments (SPMD).

Under torchrun, ``initialize()`` with no arguments reads ``env://``
(MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..format.properties import LzmaParams
from .mesh import (check_nccl_ranks, decode_blocks_mesh, encode_blocks_mesh,
                   local_rank, local_world, make_mesh)


def backend_for(device, backend: str | None = None) -> str:
    """`backend`, or by default "nccl" for a CUDA `device` and "gloo" for
    the CPU."""
    if backend is not None:
        return backend
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None,
               device="cuda") -> None:
    """Join the default process group (idempotent: nothing happens once
    one is initialised).  With no `init_method`, ``env://``.  `backend`
    defaults to backend_for(device); an NCCL rank takes the card of its
    local rank, and a host with fewer cards than NCCL ranks raises before
    any rank joins."""
    if dist.is_initialized():
        return
    backend = backend_for(device, backend)
    if backend == "nccl":
        world = (world_size if world_size is not None
                 else int(os.environ["WORLD_SIZE"]))
        check_nccl_ranks(local_world(world))
        own = rank if rank is not None else int(os.environ["RANK"])
        torch.cuda.set_device(local_rank(own))
    kwargs = {k: v for k, v in (("world_size", world_size), ("rank", rank))
              if v is not None}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            **kwargs)


def global_mesh(device="cuda"):
    """The mesh over every rank of every host."""
    return make_mesh(device)


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def encode_blocks_pod(data: bytes, params: LzmaParams | None = None,
                      block_size: int = 1 << 18, preset_len: int = 0,
                      dictionary: bytes = b"", device="cuda") -> bytes | None:
    """Pod-wide block-parallel encode: the container on the coordinator,
    None elsewhere.  `preset_len` writes LZTB v2 and `dictionary` LZTB
    v3, the shared dictionary broadcast to every rank."""
    blob = encode_blocks_mesh(data, params, block_size=block_size,
                              mesh=global_mesh(device), preset_len=preset_len,
                              dictionary=dictionary)
    return blob if is_coordinator() else None


def decode_blocks_pod(blob, device="cuda") -> bytes | None:
    out = decode_blocks_mesh(blob, mesh=global_mesh(device))
    return out if is_coordinator() else None
