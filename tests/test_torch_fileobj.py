"""The port's file objects (lzma_tpu_torch.open, parallel.fileobj) and
its file routes against the JAX package's files, on the CPU.

LZTBWriter fed odd-sized writes writes encode_file's container; LZTBReader
reads it back across batch seams; the whole-buffer `.lzma` adapters; and
the LZTB files of lzma_tpu.compress_file (its native default route,
v1-v3) read by the port, the port's read by lzma_tpu.decompress_file.
"""

import functools
import io

import numpy as np
import pytest

import lzma_tpu_torch
from lzma_tpu_torch.core.rangecoder import CorruptStreamError
from lzma_tpu_torch.format.properties import LzmaParams
from lzma_tpu_torch.ops import api
from lzma_tpu_torch.parallel import blocks as blk
from lzma_tpu_torch.parallel.fileobj import (AloneReader, AloneWriter,
                                             LZTBReader, LZTBWriter)

BLOCK, TAIL = 512, 175
PARAMS = LzmaParams(dict_size=1 << 15, fast_bytes=16)
CPU = dict(device="cpu")


@functools.cache
def data(n=6 * BLOCK + TAIL, seed=30):
    rng = np.random.default_rng(seed)
    words = [rng.integers(0, 256, int(k), dtype=np.uint8).tobytes()
             for k in rng.integers(3, 12, 24)]
    out = bytearray()
    while len(out) < n:
        out += words[int(rng.integers(0, len(words)))]
    return bytes(out[:n])


@functools.cache
def container(parse="lazy", preset_len=0):
    return api.encode_blocks(data(), PARAMS, block_size=BLOCK, parse=parse,
                             preset_len=preset_len, device="cpu")


@pytest.mark.parametrize("preset_len", [0, 200], ids=["v1", "v2"])
def test_writer_matches_in_memory_container(preset_len, tmp_path):
    dst = tmp_path / "c.lztb"
    with lzma_tpu_torch.open(dst, "wb", params=PARAMS, block_size=BLOCK,
                             parse="lazy", preset_len=preset_len,
                             batch_bytes=3 * BLOCK, **CPU) as w:
        # odd-sized writes exercise the buffering across batch seams
        for off in range(0, len(data()), 333):
            w.write(data()[off:off + 333])
    assert dst.read_bytes() == container("lazy", preset_len)


def test_reader_round_trip_across_batches(tmp_path):
    src = tmp_path / "c.lztb"
    src.write_bytes(container("lazy", 200))
    out = bytearray()
    with lzma_tpu_torch.open(src, "rb", batch_bytes=3 * BLOCK, **CPU) as r:
        for chunk in iter(lambda: r.read(701), b""):   # reads across seams
            out += chunk
    assert bytes(out) == data()


def test_file_object_targets_and_readinto():
    sink = io.BytesIO()
    w = LZTBWriter(sink, params=PARAMS, block_size=1 << 12, parse="lazy", **CPU)
    w.write(data()[:700])
    w.close()
    blob = sink.getvalue()
    assert blob == api.encode_blocks(data()[:700], PARAMS, block_size=1 << 12,
                                     device="cpu")
    with lzma_tpu_torch.open(io.BytesIO(blob), "rb", **CPU) as r:
        buf = bytearray(1000)
        assert r.readinto(buf) == 700 and bytes(buf[:700]) == data()[:700]


def test_empty_stream(tmp_path):
    dst = tmp_path / "e.lztb"
    with lzma_tpu_torch.open(dst, "wb", params=PARAMS, **CPU):
        pass
    assert dst.read_bytes() == api.encode_blocks(
        b"", PARAMS, block_size=blk.DEFAULT_BLOCK_SIZE, device="cpu")
    with lzma_tpu_torch.open(dst, "rb", **CPU) as r:
        assert r.read() == b""


def test_single_block_drops_preset(tmp_path):
    dst = tmp_path / "s.lztb"
    with lzma_tpu_torch.open(dst, "wb", params=PARAMS, block_size=1 << 12,
                             parse="lazy", preset_len=1 << 10, **CPU) as w:
        w.write(data()[:300])
    blob = dst.read_bytes()
    assert blob[4] == blk.VERSION
    assert blob == api.encode_blocks(data()[:300], PARAMS, block_size=1 << 12,
                                     device="cpu")


def test_bad_mode_and_kwargs():
    with pytest.raises(ValueError):
        lzma_tpu_torch.open("x", "ab")
    with pytest.raises(TypeError):
        lzma_tpu_torch.open("x", "wb", params=PARAMS, dict_size=1 << 12)


def test_reader_rejects_forged_total_size(tmp_path):
    import struct

    head = (b"LZTB" + bytes([1]) + PARAMS.encode_props()
            + struct.pack("<IQI", 0xFFFFFFFF, 0xFFFFFFFF, 1))
    forged = tmp_path / "forged.lztb"
    forged.write_bytes(head + struct.pack("<I", 5) + b"\x00" * 5)
    with pytest.raises(CorruptStreamError):
        LZTBReader(forged, **CPU)


def test_partial_construction_close_is_noop(tmp_path):
    """A constructor that raises leaves close() a no-op and no fd open."""
    import gc
    import os

    def nfds():
        return len(os.listdir("/proc/self/fd"))

    bad = tmp_path / "garbage.bin"
    bad.write_bytes(b"\x13" * 64)
    short = tmp_path / "short.lzma"
    short.write_bytes(b"\x5d" * 12)
    gc.collect()
    before = nfds()
    for _ in range(5):
        with pytest.raises(ValueError):
            LZTBWriter(tmp_path / "w.lztb", block_size=0, **CPU)
        with pytest.raises(CorruptStreamError):
            LZTBReader(bad, **CPU)
        with pytest.raises(CorruptStreamError):
            AloneReader(short, **CPU)   # shorter than the 13-byte header
    gc.collect()
    assert nfds() <= before + 1


def test_alone_file_objects_are_whole_buffer(tmp_path):
    """The `.lzma` writer buffers and encodes on close with the EOS
    marker (the stdlib reads it); the reader decodes on its first read;
    open tells the containers apart by the LZTB magic."""
    import lzma

    part = data()[:400]
    dst = tmp_path / "c.lzma"
    with lzma_tpu_torch.open(dst, "wb", container="alone", params=PARAMS,
                             **CPU) as w:
        w.write(part[:150])
        w.write(part[150:])
    blob = dst.read_bytes()
    eos = LzmaParams(dict_size=PARAMS.dict_size, fast_bytes=16, write_eos=True)
    assert blob == api.encode_alone(part, eos, device="cpu")
    assert lzma.decompress(blob, format=lzma.FORMAT_ALONE) == part
    with lzma_tpu_torch.open(dst, "rb", **CPU) as r:
        assert isinstance(r, AloneReader)
        assert r.read(100) == part[:100] and r.read() == part[100:]
    sink = io.BytesIO()
    with AloneWriter(sink, PARAMS, **CPU) as w:
        w.write(b"")
    assert lzma.decompress(sink.getvalue(), format=lzma.FORMAT_ALONE) == b""


# ------------------------------------------------ against the JAX package
@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    """lzma_tpu.compress_file's LZTB files (v1, v2, v3; its native block
    codec) of the same input."""
    pytest.importorskip("jax")
    import lzma_tpu
    from lzma_tpu.format.properties import LzmaParams as JParams
    from lzma_tpu.runtime import native

    if not native.available():
        pytest.skip("no C++ toolchain for lzma_tpu's native codec")
    d = tmp_path_factory.mktemp("jax")
    src = d / "in"
    src.write_bytes(data())
    files = {}
    for name, kw in (("v1", {}), ("v2", dict(preset_len=200)),
                     ("v3", dict(dictionary=data()[:300]))):
        files[name] = d / f"{name}.lztb"
        lzma_tpu.compress_file(src, files[name], JParams(
            dict_size=PARAMS.dict_size, fast_bytes=16), block_size=BLOCK, **kw)
    return files


@pytest.mark.parametrize("version", ["v1", "v2", "v3"])
def test_port_reads_jax_files(version, jax_files, tmp_path):
    path = jax_files[version]
    assert path.read_bytes()[4] == int(version[1])
    if version == "v2":   # the reader, in batches of 3 blocks
        with LZTBReader(path, batch_bytes=3 * BLOCK, **CPU) as r:
            assert r.read() == data()
    else:
        out = tmp_path / "out"
        assert lzma_tpu_torch.decompress_file(path, out, **CPU) == len(data())
        assert out.read_bytes() == data()


def test_jax_reads_port_files(tmp_path):
    pytest.importorskip("jax")
    import lzma_tpu
    from lzma_tpu.runtime import native

    if not native.available():
        pytest.skip("no C++ toolchain for lzma_tpu's native codec")
    src = tmp_path / "in"
    src.write_bytes(data())
    for name, kw in (("v1", {}), ("v2", dict(preset_len=200)),
                     ("v3", dict(dictionary=data()[:300]))):
        dst, out = tmp_path / f"{name}.lztb", tmp_path / f"{name}.out"
        lzma_tpu_torch.compress_file(src, dst, PARAMS, block_size=BLOCK,
                                     parse="lazy", **CPU, **kw)
        assert lzma_tpu.decompress_file(dst, out) == len(data())
        assert out.read_bytes() == data()
