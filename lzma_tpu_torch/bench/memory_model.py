"""The encode's peak bytes a lane position, measured on the CPU.

Tracks every tensor storage the plain versions of ``encode_batch``
allocate (a TorchDispatchMode and a finalizer on each storage) and prints
the peak of live bytes, over the whole encode and within each stage of
``device_encoder.stage``, divided by the lanes' positions (pow2 bucket
plus preset).  The CUDA versions allocate the same tensors, so these are
what ``parallel.filestream.ENC_BYTES_A/B`` model; the allocator's
rounding and the kernels' scratch are not counted.

    python -m lzma_tpu_torch.bench.memory_model [parse:lanes:block[:preset[:fb]]] ...

(the default: optimal:2:4096 lazy:2:4096; ~1-2 min each at these sizes).
"""

from __future__ import annotations

import contextlib
import sys
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..bench.corpus import text_part
from ..bench.datagen import generate_bench_data
from ..format.properties import LzmaParams
from ..ops import device_encoder
from ..parallel.filestream import lane_width


class _LiveBytes(TorchDispatchMode):
    """Live storage bytes of the tensors made inside the mode, and their
    peak."""

    def __init__(self):
        super().__init__()
        self.live, self.peak, self.sizes = 0, 0, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            s = t.untyped_storage()
            key = s.data_ptr()
            if key in self.sizes or s.nbytes() == 0:
                continue
            self.sizes[key] = s.nbytes()
            self.live += s.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(s, self._free, key)
        return out

    def _free(self, key):
        self.live -= self.sizes.pop(key, 0)


def measure(parse: str, lanes: int, block: int, preset_len: int = 0,
            fb: int | None = None):
    """Peak live bytes of one CPU ``encode_batch`` of `lanes` blocks of
    `block` bytes (text, then bench data) with a `preset_len`-byte preset.
    Returns (positions, peak bytes, {stage: peak bytes within it})."""
    data = (text_part()[: lanes * block // 2]
            + generate_bench_data(lanes * block + preset_len))
    preset, data = data[:preset_len], data[preset_len:lanes * block + preset_len]
    blocks = [data[i:i + block] for i in range(0, len(data), block)]
    params = LzmaParams() if fb is None else LzmaParams(fast_bytes=fb)
    track, by_stage = _LiveBytes(), {}
    plain_stage = device_encoder.stage

    @contextlib.contextmanager
    def stage(name, device):
        outer, track.peak = track.peak, track.live
        with plain_stage(name, device):
            yield
        by_stage[name] = max(by_stage.get(name, 0), track.peak)
        track.peak = max(track.peak, outer)

    device_encoder.stage = stage
    try:
        with track:
            device_encoder.encode_batch(blocks, params, preset=preset,
                                        parse=parse, device="cpu")
    finally:
        device_encoder.stage = plain_stage
    positions = lanes * lane_width(block, preset_len)
    return positions, track.peak, by_stage


def main(argv=None) -> int:
    specs = (sys.argv[1:] if argv is None else argv) or [
        "optimal:2:4096", "lazy:2:4096"]
    for spec in specs:
        parse, *nums = spec.split(":")
        t = time.perf_counter()
        pos, peak, by_stage = measure(parse, *(int(x) for x in nums))
        print(f"{spec}: {pos} positions, peak {peak} B = {peak / pos:.1f} B a "
              "position; by stage " + ", ".join(
                  f"{k} {v / pos:.1f}" for k, v in by_stage.items())
              + f" ({time.perf_counter() - t:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
