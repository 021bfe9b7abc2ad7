"""One rank of tests/test_torch_multihost.py's world-size-4 Gloo group,
and the inputs both mesh test files share.

Spawned by that test's module fixture (torch.multiprocessing, a file://
store).  It imports nothing of JAX or of the JAX package, and checks so.
Every rank runs every case with the same arguments; rank 0 writes its
containers and decodes into the output directory, every rank a JSON
record of what the coordinator-only calls returned on it.
"""

import json
import os
import sys

import numpy as np
import torch

from lzma_tpu_torch.format.properties import LzmaParams
from lzma_tpu_torch.parallel import mesh, multihost
from lzma_tpu_torch.runtime import native

WORLD = 4
BLOCK = 1 << 11


def data(n=24_000, seed=3):
    """tests/test_mesh.py's _data."""
    rng = np.random.default_rng(seed)
    words = [rng.integers(0, 256, int(rng.integers(4, 24)), dtype=np.uint8).tobytes()
             for _ in range(40)]
    out = bytearray()
    while len(out) < n:
        out.extend(words[int(rng.integers(0, 40))])
    return bytes(out[:n])


def params(dict_size=1 << 12):
    return dict(dict_size=dict_size, fast_bytes=16)


#: name -> (input size, seed, LzmaParams fields, block size, encode kwargs)
ENCODES = {
    "lazy": (24_000, 3, params(), BLOCK, dict(gather=False)),
    "optimal": (24_000, 3, params(), BLOCK, dict(parse="optimal")),
    "v2": (24_000, 3, params(), BLOCK, dict(preset_len=1 << 9)),
    "v3": (24_000, 3, params(), BLOCK, dict(dictionary="256:768")),
    "uneven": (13_077, 5, params(1 << 11), BLOCK, {}),
}
#: the mesh hybrid's case (tests/test_mesh.py:145-171)
HYBRID = (40_000, 11, params(), 1 << 12)


def encode_kwargs(kw, d):
    """kwargs with the dictionary's "start:end" slice of `d` resolved."""
    kw = dict(kw)
    if "dictionary" in kw:
        a, b = map(int, kw["dictionary"].split(":"))
        kw["dictionary"] = d[a:b]
    return kw


def _rank(rank, init_method, out_dir):
    torch.set_num_threads(1)
    multihost.initialize(init_method, WORLD, rank, "gloo", "cpu")
    try:
        _cases(rank, out_dir)
    finally:
        torch.distributed.destroy_process_group()


def _write(out_dir, name, blob):
    with open(os.path.join(out_dir, name), "wb") as f:
        f.write(blob)


def _cases(rank, out_dir):
    m = multihost.global_mesh("cpu")
    if (m.rank, m.world, m.device.type, m.comm_device.type) != (rank, WORLD, "cpu", "cpu"):
        raise RuntimeError(f"mesh {m}")
    returned = {}
    blobs = {}
    for name, (size, seed, p, bs, kw) in ENCODES.items():
        d = data(size, seed)
        blob = mesh.encode_blocks_mesh(d, LzmaParams(**p), block_size=bs,
                                       mesh=m, **encode_kwargs(kw, d))
        returned[f"encode {name}"] = blob is not None
        blobs[name] = blob if rank == 0 else None
        if rank == 0:
            _write(out_dir, f"enc_{name}.bin", blob)
    # the pod wrappers: gather=True underneath, the container on rank 0 only
    d = data()
    pod = multihost.encode_blocks_pod(d, LzmaParams(**params()), block_size=BLOCK,
                                      device="cpu")
    returned["encode pod"] = pod is not None
    if rank == 0:
        _write(out_dir, "enc_pod.bin", pod)

    # decodes: the lazy container with gather=False, the optimal one through
    # the pod wrapper, the rest with the default gather (every rank decodes)
    with open(os.path.join(out_dir, "blocks_v2.bin"), "rb") as f:
        ref_v2 = f.read()
    for name in ("lazy", "optimal", "v2", "v3", "uneven", "blocks_v2"):
        blob = ref_v2 if name == "blocks_v2" else _shared(m, blobs[name])
        if name == "lazy":
            out = mesh.decode_blocks_mesh(blob, mesh=m, gather=False)
        elif name == "optimal":
            out = multihost.decode_blocks_pod(blob, device="cpu")
        else:
            out = mesh.decode_blocks_mesh(blob, mesh=m)
        returned[f"decode {name}"] = out is not None
        if rank == 0:
            _write(out_dir, f"dec_{name}.bin", out)

    if native.available():
        size, seed, p, bs = HYBRID
        blob = mesh.encode_blocks_mesh_hybrid(data(size, seed), LzmaParams(**p),
                                              block_size=bs, mesh=m)
        returned["encode hybrid"] = blob is not None
        if rank == 0:
            _write(out_dir, "enc_hybrid.bin", blob)

    bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib")
                 or k == "lzma_tpu" or k.startswith("lzma_tpu."))
    returned["jax-free"] = not bad
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(returned, f)


def _shared(m, blob):
    """Rank 0's container on every rank (the decodes are SPMD too)."""
    return mesh._broadcast(m, blob)
