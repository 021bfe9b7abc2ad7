"""The port's block mesh (lzma_tpu_torch.parallel.mesh) at world size 1
against the JAX package's one-device mesh (the conftest's virtual CPU
devices).

Exact equality throughout: the codec is integer-only.  The mesh runs in
this process over a Gloo group of one rank on a file:// store.  Every
container round-trips through the port's mesh decoder and the JAX
package's scalar block decoder.  World size 4 and the dry run are
tests/test_torch_multihost.py's.
"""

import os
import tempfile

import pytest
import torch.distributed as dist

import jax

from lzma_tpu.format.properties import LzmaParams as JParams
from lzma_tpu.parallel import blocks as jblk
from lzma_tpu.parallel import mesh as jmesh
from lzma_tpu.runtime import native as jnative
from lzma_tpu_torch.format.properties import LzmaParams
from lzma_tpu_torch.ops.hybrid import encode_blocks_hybrid_optimal
from lzma_tpu_torch.parallel import mesh, multihost
from lzma_tpu_torch.runtime import native

import torch_multihost_worker as worker

#: world size 1: three 1 KiB lanes keep the plain decoder's steps few
W1 = dict(size=3_000, seed=4, block=1 << 10)
W1_CASES = {"lazy": {}, "optimal": dict(parse="optimal"),
            "v2": dict(preset_len=1 << 9), "v3": dict(dictionary="256:768")}


def _jmesh(k):
    return jmesh.make_mesh(jax.devices()[:k])


def _needs_gxx():
    if not (native.available() and jnative.available()):
        pytest.skip("no C++ toolchain")


@pytest.fixture(scope="module")
def group():
    """A Gloo group of world size 1 in this process (file:// store),
    destroyed after the module's world-size-1 tests."""
    with tempfile.TemporaryDirectory() as d:
        multihost.initialize("file://" + os.path.join(d, "store"), 1, 0,
                             "gloo", "cpu")
        try:
            yield mesh.make_mesh("cpu")
        finally:
            dist.destroy_process_group()


@pytest.mark.parametrize("case", sorted(W1_CASES))
def test_world1_container_equals_jax_one_device_mesh(group, case):
    d = worker.data(W1["size"], W1["seed"])
    kw = worker.encode_kwargs(W1_CASES[case], d)
    p = worker.params()
    blob = mesh.encode_blocks_mesh(d, LzmaParams(**p), block_size=W1["block"],
                                   mesh=group, **kw)
    want = jmesh.encode_blocks_mesh(d, JParams(**p), block_size=W1["block"],
                                    mesh=_jmesh(1), **kw)
    assert blob == want
    assert mesh.decode_blocks_mesh(blob, mesh=group) == d
    assert jblk.decode_blocks(blob) == d


def test_world1_gather_settings_agree_and_initialize_is_idempotent(group):
    assert (group.rank, group.world, group.backend) == (0, 1, "gloo")
    multihost.initialize("file:///nonexistent/store", 4, 3, "nccl", "cuda")
    assert dist.get_world_size() == 1 and multihost.is_coordinator()
    assert multihost.global_mesh("cpu") == group
    d = worker.data(W1["size"], W1["seed"])
    p = LzmaParams(**worker.params())
    blob_g = mesh.encode_blocks_mesh(d, p, block_size=W1["block"], mesh=group,
                                     gather=True)
    blob_s = mesh.encode_blocks_mesh(d, p, block_size=W1["block"], mesh=group,
                                     gather=False)
    assert blob_g == blob_s
    assert mesh.decode_blocks_mesh(blob_g, mesh=group, gather=True) == d


def test_world1_mesh_hybrid_equals_jax_and_the_hybrid(group):
    _needs_gxx()
    size, seed, p, bs = worker.HYBRID
    d = worker.data(size, seed)
    blob = mesh.encode_blocks_mesh_hybrid(d, LzmaParams(**p), block_size=bs,
                                          mesh=group)
    assert blob == jmesh.encode_blocks_mesh_hybrid(d, JParams(**p),
                                                   block_size=bs, mesh=_jmesh(1))
    assert blob == encode_blocks_hybrid_optimal(d, LzmaParams(**p),
                                                block_size=bs, device="cpu")
    assert jblk.decode_blocks(blob) == d
    assert mesh.decode_blocks_mesh(blob, mesh=group) == d
