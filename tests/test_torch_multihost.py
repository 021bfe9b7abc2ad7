"""The port's multi-process mesh (lzma_tpu_torch.parallel.multihost over
parallel.mesh) against the JAX package's mesh on 4 of the conftest's 8
virtual CPU devices, and lzma_tpu_torch.entry.dryrun_multichip.

Exact equality throughout: the codec is integer-only.  World size 4 is
one Gloo group of four spawned ranks (tests/torch_multihost_worker.py,
which loads nothing of JAX), started once for the module while this
process computes the JAX containers.  The ranks decode their own
containers, which equal JAX's, and the JAX package's scalar v2
container; this process decodes each with the JAX package's scalar
block decoder.
"""

import json
import os
import tempfile

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp_mp

import jax

from lzma_tpu.format.properties import LzmaParams as JParams
from lzma_tpu.parallel import blocks as jblk
from lzma_tpu.parallel import mesh as jmesh
from lzma_tpu.runtime import native as jnative
from lzma_tpu_torch import entry
from lzma_tpu_torch.parallel import multihost
from lzma_tpu_torch.runtime import native

import torch_multihost_worker as worker


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """Four spawned Gloo ranks run every case of torch_mesh_worker; this
    process meanwhile computes the JAX package's containers on a 4-device
    mesh.  Returns (the ranks' output directory, the JAX containers)."""
    out = tmp_path_factory.mktemp("mesh4")
    d = worker.data()
    # the scalar encoder's v2 container, which the ranks decode
    (out / "blocks_v2.bin").write_bytes(jblk.encode_blocks(
        d, JParams(**worker.params()), block_size=worker.BLOCK,
        preset_len=1 << 9))
    ctx = tmp_mp.start_processes(
        worker._rank, args=("file://" + str(out / "store"), str(out)),
        nprocs=worker.WORLD, start_method="spawn", join=False)
    try:
        m4 = jmesh.make_mesh(jax.devices()[:worker.WORLD])
        want = {}
        for name, (size, seed, p, bs, kw) in worker.ENCODES.items():
            dd = worker.data(size, seed)
            want[name] = jmesh.encode_blocks_mesh(
                dd, JParams(**p), block_size=bs, mesh=m4,
                **worker.encode_kwargs(kw, dd))
        if jnative.available():
            size, seed, p, bs = worker.HYBRID
            want["hybrid"] = jmesh.encode_blocks_mesh_hybrid(
                worker.data(size, seed), JParams(**p), block_size=bs, mesh=m4)
        while not ctx.join(timeout=600):
            pass
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
    return out, want


@pytest.mark.parametrize("case", sorted(worker.ENCODES))
def test_world4_container_equals_jax_four_device_mesh(world4, case):
    out, want = world4
    blob = (out / f"enc_{case}.bin").read_bytes()
    assert blob == want[case]
    size, seed = worker.ENCODES[case][:2]
    assert jblk.decode_blocks(blob) == worker.data(size, seed)


def test_world4_gather_settings_and_pod_give_one_container(world4):
    out, want = world4
    assert (out / "enc_pod.bin").read_bytes() == (out / "enc_lazy.bin").read_bytes()


@pytest.mark.parametrize("case", ["lazy", "optimal", "v2", "v3", "uneven",
                                  "blocks_v2"])
def test_world4_decodes(world4, case):
    out, _ = world4
    size, seed = (worker.ENCODES[case][:2] if case in worker.ENCODES
                  else (24_000, 3))
    assert (out / f"dec_{case}.bin").read_bytes() == worker.data(size, seed)


def test_world4_coordinator_calls_return_on_rank0_only(world4):
    out, _ = world4
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(worker.WORLD)]
    for r, got in enumerate(ranks):
        assert got["jax-free"], r
        # gather=False and the pod wrappers: rank 0 only; gather=True: all
        for key in ("encode lazy", "encode pod", "decode lazy", "decode optimal"):
            assert got[key] == (r == 0), (r, key)
        for key in ("encode optimal", "encode v2", "encode v3", "encode uneven",
                    "decode v2", "decode v3", "decode uneven", "decode blocks_v2"):
            assert got[key], (r, key)


def test_world4_mesh_hybrid_equals_jax(world4):
    if not (native.available() and jnative.available()):
        pytest.skip("no C++ toolchain")
    out, want = world4
    blob = (out / "enc_hybrid.bin").read_bytes()
    assert blob == want["hybrid"]
    size, seed = worker.HYBRID[:2]
    assert jblk.decode_blocks(blob) == worker.data(size, seed)


def test_dryrun_multichip_four_ranks_on_the_cpu():
    entry.dryrun_multichip(4, device="cpu")


def test_nccl_takes_one_card_a_rank():
    """More NCCL ranks than cards raises before any rank joins (here, with
    no card, at one rank)."""
    n = torch.cuda.device_count() + 1
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(ValueError, match="NCCL takes one card a rank"):
            multihost.initialize("file://" + os.path.join(d, "store"), n, 0,
                                 "nccl", "cuda")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="NCCL takes one card a rank"):
        entry.dryrun_multichip(n, device="cuda")
