"""Block-parallel codec over the ranks of a torch.distributed group.

Port of ``lzma_tpu/parallel/mesh.py``.  The input is cut into
independent LZMA block streams, sharded contiguously over the ranks (one
device a rank), each rank running the lane-parallel kernels on its
shard, then an ordered ragged gather: the compressed sizes first (one
int32 a lane), then the payloads padded to the longest stream of any
rank; rank 0 (or, with ``gather=True``, every rank) frames the
container.

A mesh is the default process group: ``make_mesh`` reads its rank and
world size (world size 1, in this process, where no group is
initialised; ``multihost.initialize`` starts one).  The collectives take
the group's backend as the caller chose it: NCCL moves tensors on the
card, one card a rank; Gloo moves host tensors, whatever device the
kernels ran on.  Every rank calls an entry point with the same
arguments (SPMD).

Each rank's shard runs ``device_encoder.encode_lanes`` (the range coder
K2; with ``parse="optimal"`` also the DP scan K3 and the classify carry
K6) or ``cuda_ring.decode_cuda`` (K1) on CUDA tensors, their plain
versions on CPU ones.  The lanes are padded to a multiple of the world
size with idle lanes of length 0; they ride the gathers as empty rows
and never reach a kernel.  The v2/v3 dictionary is sent from rank 0 to
every rank by ``dist.broadcast`` on both sides.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..core.rangecoder import CorruptStreamError
from ..format.properties import LzmaParams
from ..ops import hybrid
from ..ops.cuda_ring import decode_batch_cuda, decode_cuda
from ..ops.device_encoder import clamp_fb, encode_batch, encode_lanes
from ..runtime import native
from ..utils.profiling import PhaseTimer
from . import blocks as blk

#: the mesh's one axis: blocks (data parallelism; a block's stream is serial)
BLOCK_AXIS = "blocks"


@dataclass(frozen=True)
class Mesh:
    """This process's place in the block mesh."""

    rank: int
    world: int
    #: where this rank's kernels run
    device: torch.device
    #: the process group's backend; None where there is no group
    backend: str | None
    #: the ranks whose kernels share this rank's card (Gloo only)
    per_card: int = 1

    @property
    def comm_device(self) -> torch.device:
        """Where the collectives' tensors live: the card for NCCL, the
        host for any other backend."""
        return self.device if self.backend == "nccl" else torch.device("cpu")


def local_rank(rank: int) -> int:
    """The rank's index among the ranks of its host: $LOCAL_RANK (torchrun
    sets it), else the global rank (one host)."""
    return int(os.environ.get("LOCAL_RANK", rank))


def local_world(world: int) -> int:
    """The ranks of this host: $LOCAL_WORLD_SIZE, else the world size."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world))


def check_nccl_ranks(n_local: int) -> None:
    """NCCL takes one card a rank: raise where this host would run more
    NCCL ranks than it has cards."""
    cards = torch.cuda.device_count()
    if n_local > cards:
        raise ValueError(f"{n_local} NCCL ranks on a host with {cards} CUDA "
                         "device(s): NCCL takes one card a rank")


def make_mesh(device="cuda") -> Mesh:
    """The mesh of the default process group (world size 1 where none is
    initialised).  A CUDA `device` without an index becomes the card of
    the rank's local index (modulo the cards, for Gloo; NCCL raises where
    the host has fewer cards than ranks); "cpu" keeps the kernels on the
    host, which an NCCL group cannot serve."""
    device = torch.device(device)
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        backend = dist.get_backend()
    else:
        rank, world, backend = 0, 1, None
    per_card = 1
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("no CUDA device: pass device='cpu' for the host")
        if backend == "nccl":
            check_nccl_ranks(local_world(world))
        elif backend is not None:
            per_card = -(-local_world(world) // cards)
        if device.index is None:
            device = torch.device("cuda", local_rank(rank) % cards)
    elif backend == "nccl":
        raise ValueError("an NCCL group moves CUDA tensors: its mesh runs on "
                         "the card")
    return Mesh(rank, world, device, backend, per_card)


def _pad_lanes(num: int, num_devices: int) -> int:
    return ((num + num_devices - 1) // num_devices) * num_devices


def _shard(mesh: Mesh, lens):
    """(this rank's slice of the padded lanes, lanes a rank, its real
    lanes): the idle lanes (length 0) all sit at the end."""
    per = len(lens) // mesh.world
    sl = slice(mesh.rank * per, (mesh.rank + 1) * per)
    return sl, per, int(np.count_nonzero(lens[sl]))


def _local(mesh: Mesh, gather: bool) -> bool:
    """No collective: one rank and nothing to replicate, or no group."""
    return mesh.backend is None or (mesh.world == 1 and not gather)


def _collect(mesh: Mesh, t, to_all: bool):
    """Every rank's (per, ...) tensor `t`, concatenated in rank order, as
    numpy: on every rank (all_gather) where `to_all`, else on rank 0
    (gather) and None elsewhere."""
    if _local(mesh, to_all):
        return t.cpu().numpy()
    t = t.to(mesh.comm_device).contiguous()
    parts = ([torch.empty_like(t) for _ in range(mesh.world)]
             if to_all or mesh.rank == 0 else None)
    if to_all:
        dist.all_gather(parts, t)
    else:
        dist.gather(t, parts, dst=0)
    return None if parts is None else torch.cat(parts).cpu().numpy()


def _padded(t, per: int, width: int | None = None):
    """`t`'s k rows zero-padded to `per` rows (cut or padded to `width`
    columns), on the same device."""
    shape = (per,) + ((width,) if width is not None else tuple(t.shape[1:]))
    out = torch.zeros(shape, dtype=t.dtype, device=t.device)
    if width is None:
        out[: t.shape[0]] = t
    else:
        w = min(width, t.shape[1])
        out[: t.shape[0], :w] = t[:, :w]
    return out


def _ragged_gather(mesh: Mesh, rows, lens, per: int, gather: bool):
    """The ordered ragged gather of this rank's k real rows (rows (k, W)
    uint8, lens (k,) int32): the sizes go to every rank (each needs the
    padded width), then the payloads, cut to the longest row of any rank,
    to every rank (`gather`) or to rank 0.  Returns world * per byte
    strings, rank by rank, lane by lane (b"" for an idle lane), or None
    on a rank that gathers nothing."""
    if _local(mesh, gather):
        rows, lens = rows.cpu().numpy(), lens.cpu().numpy()
        return ([rows[i, : lens[i]].tobytes() for i in range(len(lens))]
                + [b""] * (per - len(lens)))
    sizes = _collect(mesh, _padded(lens.to(torch.int32), per), True)
    width = max(int(sizes.max()), 1)
    payload = _collect(mesh, _padded(rows, per, width), gather)
    if payload is None:
        return None
    return [payload[i, : sizes[i]].tobytes() for i in range(len(sizes))]


def _broadcast(mesh: Mesh, payload: bytes | None, size: int | None = None):
    """Rank 0's `payload` on every rank.  `size` is its length where every
    rank knows it, else rank 0 sends the length first."""
    if mesh.world == 1:
        return payload
    dev = mesh.comm_device
    if size is None:
        n = torch.tensor([len(payload) if mesh.rank == 0 else 0],
                         dtype=torch.int64, device=dev)
        dist.broadcast(n, src=0)
        size = int(n.item())
    if mesh.rank == 0:
        t = torch.frombuffer(bytearray(payload), dtype=torch.uint8).to(dev)
    else:
        t = torch.empty(size, dtype=torch.uint8, device=dev)
    dist.broadcast(t, src=0)
    return t.cpu().numpy().tobytes()


def _on(mesh: Mesh, a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(mesh.device)


def _bytes_on(mesh: Mesh, b: bytes):
    return torch.frombuffer(bytearray(b), dtype=torch.uint8).to(mesh.device)


def _encode_step(data, lens, dict_size, *, lc, lp, pb, fb, mesh: Mesh,
                 gather: bool, parse: str = "lazy", preset: bytes = b"",
                 timer: PhaseTimer | None = None):
    """One sharded encode step (mesh._encode_step, _encode_step_preset and
    _encode_step_pallas): this rank's lanes of the padded (lanes, W)
    uint8 `data` through encode_lanes, `preset` priming every lane's
    window (preset-primed lanes keep the lazy parse), then the ordered
    ragged gather.  Returns every lane's stream, or None on a rank that
    gathers nothing.  `timer` splits it into "shard" (the kernels,
    synchronised) and "gather"."""
    timer = timer or PhaseTimer()
    sl, per, k = _shard(mesh, lens)
    out = []
    with timer.phase("shard", sync_arrays=out):
        if k:
            out.extend(encode_lanes(
                _on(mesh, data[sl][:k]), _on(mesh, lens[sl][:k], np.int32),
                dict_size, lc=lc, lp=lp, pb=pb, fb=fb, parse=parse,
                preset=_bytes_on(mesh, preset) if preset else None))
        else:
            out.extend((torch.zeros((0, 1), dtype=torch.uint8, device=mesh.device),
                        torch.zeros(0, dtype=torch.int32, device=mesh.device)))
    comp, comp_lens = out
    with timer.phase("gather"):
        return _ragged_gather(mesh, comp, comp_lens, per, gather)


def _decode_step(comp, comp_lens, out_sizes, dict_size, *, lc, lp, pb,
                 max_out, mesh: Mesh, gather: bool, preset: bytes = b""):
    """One sharded decode step (mesh._decode_step, _decode_step_preset and
    _decode_step_pallas): this rank's lanes of the padded streams through
    decode_cuda, `preset` priming every window (out_sizes are then
    absolute end positions), then the ordered gather of each lane's
    payload and ok flag.  Returns (blocks, ok (lanes,) uint8), both None
    on a rank that gathers nothing; an idle lane's ok is 0."""
    sl, per, k = _shard(mesh, comp_lens)
    skip = len(preset)
    sizes = _on(mesh, out_sizes[sl][:k] - skip, np.int32)
    if k:
        out, ok, _ = decode_cuda(
            _on(mesh, comp[sl][:k]), _on(mesh, comp_lens[sl][:k], np.int32),
            _on(mesh, out_sizes[sl][:k], np.int32), dict_size, lc, lp, pb,
            max_out, preset=_bytes_on(mesh, preset) if preset else None)
    else:
        out = torch.zeros((0, max_out), dtype=torch.uint8, device=mesh.device)
        ok = torch.zeros(0, dtype=torch.bool, device=mesh.device)
    blocks = _ragged_gather(mesh, out[:, skip:], sizes, per, gather)
    return blocks, _collect(mesh, _padded(ok.to(torch.uint8), per), gather)


def _hybrid_search_step(arr, lens, dict_size, *, fb, tiers, mesh: Mesh,
                        gather: bool):
    """The sharded half of the mesh hybrid (mesh._hybrid_search_step):
    this rank's lanes through ops.hybrid._match_lists_grouped (the
    uncapped lists at `tiers`, packed on the card at 3 pairs a position),
    then a plain gather of the fixed-shape (fl, fd, counts) int32 to rank
    0 (every rank where `gather`).  On a card the lane groups are sized
    from this rank's share of the memory free while no rank allocates.
    Returns numpy (fl, fd, counts) of every lane, or None."""
    sl, per, k = _shard(mesh, lens)
    width = arr.shape[1]
    group = None
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
        _barrier(mesh)  # every rank has released its cached blocks ...
        group = hybrid._group_lanes(k, width, hybrid._columns(tiers),
                                    mesh.device,
                                    share=hybrid._MEM_SHARE / mesh.per_card)
        _barrier(mesh)  # ... and read the free memory before any allocates
    if k:
        lists = hybrid._match_lists_grouped(arr[sl][:k], lens[sl][:k],
                                            dict_size, fb, tiers,
                                            device=mesh.device, group=group)
    else:
        lists = (np.zeros((0, 3 * width), np.int32),) * 2 + (
            np.zeros((0, width), np.int32),)
    out = [_collect(mesh, _padded(torch.from_numpy(a), per), gather)
           for a in lists]
    return None if out[0] is None else tuple(out)


def _barrier(mesh: Mesh):
    if mesh.backend is not None and mesh.world > 1:
        dist.barrier()


def _lanes(blocks, width: int, n_lanes: int):
    arr = np.zeros((n_lanes, width), dtype=np.uint8)
    lens = np.zeros(n_lanes, dtype=np.int32)
    for i, b in enumerate(blocks):
        arr[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        lens[i] = len(b)
    return arr, lens


def encode_blocks_mesh_hybrid(
    data: bytes,
    params: LzmaParams | None = None,
    block_size: int = 1 << 18,
    mesh: Mesh | None = None,
    fb: int | None = None,
    tiers: dict | None = None,
    num_threads: int = 0,
    gather: bool | None = None,
    device="cuda",
) -> bytes | None:
    """The hybrid-optimal encode over the mesh
    (mesh.encode_blocks_mesh_hybrid): every rank searches its blocks'
    candidate lists, rank 0 (every rank where `gather`) runs the host's
    optimal parse over all of them.  The container is
    ops.hybrid.encode_blocks_hybrid_optimal's byte for byte; None on a
    rank that gathers nothing.  `mesh` defaults to make_mesh(device);
    `gather` to world size > 1."""
    params = (params or LzmaParams()).validated_for_encode()
    if params.write_eos:
        raise ValueError("block container uses known sizes; EOS not supported")
    mesh = mesh or make_mesh(device)
    blocks = blk.split_blocks(data, block_size)
    if not blocks:
        return blk.build_container(params, block_size, 0, [])
    if gather is None:
        gather = mesh.world > 1
    fb = int(fb if fb is not None else params.fast_bytes)
    n, bs = len(blocks), block_size
    arr, lens = _lanes(blocks, bs, _pad_lanes(n, mesh.world))
    lists = _hybrid_search_step(arr, lens, min(params.dict_size, bs), fb=fb,
                                tiers=hybrid._tiers(tiers), mesh=mesh,
                                gather=gather)
    if lists is None:
        return None
    fl, fd, counts = (a[:n] for a in lists)
    payload, sizes = native.encode_candidate_blocks(
        arr[:n].reshape(-1), bs, params.lc, params.lp, params.pb,
        min(params.dict_size, 1 << 29), fb,
        *hybrid._flatten_packed(fl, fd, counts, lens[:n]),
        num_threads=num_threads, total_len=(n - 1) * bs + int(lens[n - 1]))
    return hybrid._container(params, bs, data, n, 0, b"", sizes, payload)


def encode_blocks_mesh(
    data: bytes,
    params: LzmaParams | None = None,
    block_size: int = 1 << 18,
    mesh: Mesh | None = None,
    fb: int | None = None,
    preset_len: int = 0,
    dictionary: bytes = b"",
    gather: bool | None = None,
    parse: str = "lazy",
    device="cuda",
    timer: PhaseTimer | None = None,
) -> bytes | None:
    """Data-parallel block encode over every rank of the mesh
    (mesh.encode_blocks_mesh).  `preset_len > 0` writes LZTB v2: block 0
    encodes plain on one lane on rank 0, and its prefix, broadcast from
    rank 0, primes every other block.  `dictionary` writes LZTB v3: the
    dictionary is stored as its own stream and, broadcast the same way,
    primes every block.  Both head streams take the lazy parse, and so do
    the primed lanes.  `mesh` defaults to make_mesh(device); `gather` to
    world size > 1 (every rank returns the container; without it rank 0
    does and the others return None).  `timer` splits the lanes' step
    into "shard" (the kernels, synchronised) and "gather"."""
    params = (params or LzmaParams()).validated_for_encode()
    if params.write_eos:
        raise ValueError("block container uses known sizes; EOS not supported")
    mesh = mesh or make_mesh(device)
    preset_len = blk.validated_preset_len(preset_len, block_size, len(data))
    dictionary = blk.validated_dictionary(dictionary, preset_len)
    if len(data) <= block_size:
        preset_len = 0  # single block: a preset would be pointless
    if not data:
        dictionary = b""
    blocks = blk.split_blocks(data, block_size)
    if not blocks:
        return blk.build_container(params, block_size, 0, [])
    n = len(blocks)
    fb = clamp_fb(fb if fb is not None else params.fast_bytes)
    if gather is None:
        gather = mesh.world > 1

    first = 0
    head = pre_bytes = b""
    if dictionary or preset_len:
        if mesh.rank == 0:
            (head,) = encode_batch([dictionary] if dictionary else blocks[:1],
                                   params, fb=fb, device=mesh.device)
        if gather:
            head = _broadcast(mesh, head)
        pre_bytes = _broadcast(mesh, dictionary or data[:preset_len],
                               len(dictionary) or preset_len)
        first = 0 if dictionary else 1
    m = n - first
    max_n = max(block_size, 16)
    arr, lens = _lanes(blocks[first:], max_n, _pad_lanes(m, mesh.world))
    streams = _encode_step(
        arr, lens, min(params.dict_size, max_n + len(pre_bytes)), lc=params.lc,
        lp=params.lp, pb=params.pb, fb=fb, mesh=mesh, gather=gather,
        parse=parse, preset=pre_bytes, timer=timer)
    if streams is None:
        return None
    streams = streams[:m]
    dict_stream = head if dictionary else b""
    if preset_len:
        streams.insert(0, head)
    return blk.build_container(params, block_size, len(data), streams,
                               preset_len, dict_stream, len(dictionary))


def decode_blocks_mesh(blob, mesh: Mesh | None = None,
                       gather: bool | None = None,
                       device="cuda") -> bytes | None:
    """Data-parallel block decode over every rank of the mesh
    (mesh.decode_blocks_mesh), LZTB versions 1-3.  v3: rank 0 decodes the
    stored dictionary on one lane and broadcasts it, then every block
    decodes against it.  v2: rank 0 decodes block 0 on one lane and
    broadcasts it (its prefix is the preset), then the other blocks decode
    against the preset.  A block that fails raises CorruptStreamError.
    `mesh` and `gather` as in encode_blocks_mesh; None on a rank that
    gathers nothing."""
    frame = blk.parse_container(blob)
    mesh = mesh or make_mesh(device)
    n = len(frame.comp_sizes)
    if n == 0:
        return b""
    if gather is None:
        gather = mesh.world > 1
    offsets, sizes = frame.stream_extents(len(blob))
    params = frame.params

    first = 0
    head = preset = b""
    if frame.dict_len or frame.preset_len:
        if frame.dict_len:
            stream = bytes(blob[frame.payload_offset : frame.blocks_offset])
            size = frame.dict_len
        else:
            stream = bytes(blob[offsets[0] : offsets[1]])
            size = sizes[0]
            first = 1
        if mesh.rank == 0:
            (head,) = decode_batch_cuda([stream], params, [size],
                                        device=mesh.device)
        head = _broadcast(mesh, head, size)
        preset = head if frame.dict_len else head[: frame.preset_len]
    if first == n:
        return head if gather or mesh.rank == 0 else None
    m = n - first
    lanes = _pad_lanes(m, mesh.world)
    streams = [bytes(blob[offsets[i] : offsets[i + 1]]) for i in range(first, n)]
    comp, comp_lens = _lanes(streams, max(max(frame.comp_sizes[first:]), 16),
                             lanes)
    out_sizes = np.zeros(lanes, dtype=np.int32)
    out_sizes[:m] = np.asarray(sizes[first:]) + len(preset)
    parts, ok = _decode_step(
        comp, comp_lens, out_sizes, min(params.dict_size, 2**31 - 1),
        lc=params.lc, lp=params.lp, pb=params.pb,
        max_out=max(frame.block_size, 1) + len(preset), mesh=mesh,
        gather=gather, preset=preset)
    if parts is None:
        return None
    if not ok[:m].all():
        bad = int(np.argmin(ok[:m])) + first
        raise CorruptStreamError(f"mesh decode failed for block {bad}")
    out = (head if first else b"") + b"".join(parts[:m])
    if len(out) != frame.total_size:
        raise CorruptStreamError("decoded size mismatch")
    return out
