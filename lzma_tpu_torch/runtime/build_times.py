"""Time a cold build of the CUDA kernels two ways, in turns.

``build.compile_to`` runs one nvcc a source, all started together, then one
link; the other way is a single nvcc call over every source.  Each build
goes into its own empty directory under lzma_tpu_torch/_build (nvcc keeps
no cache), in the
order parallel, single, single, parallel.  Prints one JSON line with the
seconds of each build.  Needs nvcc; run on the machine with the card:

    python -m lzma_tpu_torch.runtime.build_times
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import tempfile
import time

from . import build


def _single(lib: str) -> None:
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-shared", "-o", lib,
                    *build.sources()], check=True, capture_output=True)


def main() -> None:
    times = {"parallel": [], "single": []}
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    for way in ("parallel", "single", "single", "parallel"):
        work = tempfile.mkdtemp(dir=build.BUILD_DIR)
        try:
            lib = os.path.join(work, "lib.so")
            t = time.perf_counter()
            (build.compile_to if way == "parallel" else _single)(lib)
            times[way].append(time.perf_counter() - t)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"sources": [os.path.basename(s) for s in build.sources()],
                      "seconds": times}))


if __name__ == "__main__":
    main()
