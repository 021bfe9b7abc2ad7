"""The port's streamed file routes against the JAX package, on the CPU:
encode_file and the command line's `e -bs{N}` (parallel.filestream, the
lazy parse) write lzma_tpu.ops.api.encode_blocks' container and the file
of lzma_tpu.cli.main([..., "-backendtpu"]); `-tune` sees only the
input's first TRAIN_SAMPLE_BYTES; `d` of an LZTB file streams; and the
sizer's memory model covers the plain encode's measured peak.
"""

import numpy as np
import pytest

from lzma_tpu_torch import cli as tcli
from lzma_tpu_torch.format.properties import LzmaParams
from lzma_tpu_torch.ops import api
from lzma_tpu_torch.parallel import filestream as fs

BLOCK, TAIL = 512, 175


def mixed(n, seed):
    rng = np.random.default_rng(seed)
    words = [rng.integers(0, 256, int(k), dtype=np.uint8).tobytes()
             for k in rng.integers(3, 12, 24)]
    out = bytearray()
    while len(out) < n * 3 // 4:
        out += words[int(rng.integers(0, len(words)))]
    out = bytes(out[: n * 3 // 4])
    return out + rng.integers(0, 256, n - len(out), dtype=np.uint8).tobytes()


DATA = mixed(6 * BLOCK + TAIL, seed=BLOCK)


def test_stream_files_match_jax(tmp_path):
    """One shape: encode_file in batches of 3 blocks (the last the lone
    tail), the command line's streamed `e -bs512` and JAX's `-backendtpu`
    file and ops.api.encode_blocks (the Pallas range coder in interpret
    mode, as the JAX package's tests run it) are one container."""
    pytest.importorskip("jax")
    from lzma_tpu import cli as jcli
    from lzma_tpu.format.properties import LzmaParams as JParams
    from lzma_tpu.ops import api as japi

    src = tmp_path / "in"
    src.write_bytes(DATA)
    params = LzmaParams(dict_size=256, fast_bytes=16)
    fs.encode_file(src, tmp_path / "fs.lztb", params, block_size=BLOCK,
                   parse="lazy", batch_bytes=3 * BLOCK, device="cpu")
    args = ["e", f"-bs{BLOCK}", "-d8", "-fb16", "-lc3", "-lp0", "-pb2"]
    assert tcli.main([*args, "-q", str(src), str(tmp_path / "t.lztb")],
                     device="cpu") == 0
    assert jcli.main([*args, "-backendtpu", str(src),
                      str(tmp_path / "j.lztb")]) == 0
    want = japi.encode_blocks(DATA, JParams(dict_size=256, fast_bytes=16),
                              block_size=BLOCK)
    for name in ("fs", "t", "j"):
        assert (tmp_path / f"{name}.lztb").read_bytes() == want, name
    assert want == api.encode_blocks(DATA, params, block_size=BLOCK,
                                     device="cpu")


def test_cli_streams_and_tune_reads_only_the_sample(tmp_path, monkeypatch):
    """`e -tune -bs{N}` reads the input's first TRAIN_SAMPLE_BYTES for
    select_params and streams the rest through encode_file with the tuned
    values; `d` streams through decode_file; the command line itself
    never reads a file whole on these routes."""
    src, mid, out = tmp_path / "in", tmp_path / "c.lztb", tmp_path / "out"
    src.write_bytes(DATA)
    monkeypatch.setattr(tcli, "TRAIN_SAMPLE_BYTES", 600)
    seen = {}

    def select_params(sample, base, block_size):
        seen["sample"] = sample
        return LzmaParams(lc=1, lp=1, pb=0, dict_size=base.dict_size,
                          fast_bytes=base.fast_bytes)

    import lzma_tpu_torch.utils.autotune as autotune

    monkeypatch.setattr(autotune, "select_params", select_params)
    reads = []
    real_open = open

    class Spy:
        def __init__(self, f):
            self.f = f

        def read(self, n=-1):
            reads.append(n)
            return self.f.read(n)

        def __enter__(self):
            return self

        def __exit__(self, *a):
            self.f.close()

    monkeypatch.setattr(tcli, "open", lambda *a, **k: Spy(real_open(*a, **k)),
                        raising=False)
    calls = []
    for name in ("encode_file", "decode_file"):
        real = getattr(fs, name)
        monkeypatch.setattr(fs, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    assert tcli.main(["e", "-tune", f"-bs{BLOCK}", "-d12", "-fb16", str(src),
                      str(mid)], device="cpu") == 0
    assert seen["sample"] == DATA[:600]
    tuned = LzmaParams(lc=1, lp=1, pb=0, dict_size=1 << 12, fast_bytes=16)
    assert mid.read_bytes() == api.encode_blocks(DATA, tuned, block_size=BLOCK,
                                                 device="cpu")
    assert tcli.main(["d", "-q", str(mid), str(out)], device="cpu") == 0
    assert out.read_bytes() == DATA
    assert calls == ["encode_file", "decode_file"]
    assert reads == [600, 4] and -1 not in reads


def test_model_covers_the_measured_peak():
    """The sizer's model is at or above the live bytes the plain encode
    holds at its peak (bench.memory_model), by at most 15%."""
    from lzma_tpu_torch.bench import memory_model

    for parse in ("lazy", "optimal"):
        pos, peak, _ = memory_model.measure(parse, 1, 512)
        model = fs.encode_lane_bytes(parse, 512)
        assert peak <= model <= 1.15 * peak, (parse, peak / pos, model / pos)
