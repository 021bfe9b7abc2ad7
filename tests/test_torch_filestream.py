"""The port's LZTB file codec (lzma_tpu_torch.parallel.filestream) on the
CPU, against its own in-memory container and the JAX package's.

encode_file must write the bytes of ops.api.encode_blocks of the whole
file, whatever the batching: here 6 blocks and a short tail in batches of
3 blocks, so the last batch is the lone tail (the encode's match window
is bounded by a batch's own bucket; these pin that it moves no byte).
Sizes stay small: the plain range coder and decoder take a step a pair
and a bit, and every batch is one more such loop.
"""

import functools
import struct

import numpy as np
import pytest
import torch

from lzma_tpu_torch.core.rangecoder import CorruptStreamError
from lzma_tpu_torch.format.properties import LzmaParams
from lzma_tpu_torch.ops import api
from lzma_tpu_torch.parallel import blocks as blk
from lzma_tpu_torch.parallel import filestream as fs

#: (block size, tail): 6 blocks and a tail, encoded 3 blocks a batch
SHAPES = {"2K": (2048, 700), "512": (512, 175)}
BATCH_BLOCKS = 3


def mixed(n, seed):
    """n bytes: repeated random words (compressible), then random bytes."""
    rng = np.random.default_rng(seed)
    words = [rng.integers(0, 256, int(k), dtype=np.uint8).tobytes()
             for k in rng.integers(3, 12, 24)]
    out = bytearray()
    while len(out) < n * 3 // 4:
        out += words[int(rng.integers(0, len(words)))]
    out = bytes(out[: n * 3 // 4])
    return out + rng.integers(0, 256, n - len(out), dtype=np.uint8).tobytes()


def shape_data(shape):
    bs, tail = SHAPES[shape]
    return mixed(6 * bs + tail, seed=bs)


@functools.cache
def reference(shape, parse, dict_size):
    bs, _ = SHAPES[shape]
    return api.encode_blocks(shape_data(shape), LzmaParams(dict_size=dict_size,
                                                           fast_bytes=16),
                             block_size=bs, parse=parse, device="cpu")


@pytest.mark.parametrize("shape,parse,dict_size", [
    ("2K", "lazy", 1 << 16), ("512", "optimal", 1 << 16),
    ("512", "lazy", 256), ("512", "optimal", 256)],
    ids=["2K-lazy", "512-optimal", "512-lazy-dict256", "512-optimal-dict256"])
def test_encode_file_matches_encode_blocks(shape, parse, dict_size, tmp_path):
    bs, tail = SHAPES[shape]
    data = shape_data(shape)
    src, dst = tmp_path / "in", tmp_path / "out.lztb"
    src.write_bytes(data)
    seen = []
    n = fs.encode_file(src, dst, LzmaParams(dict_size=dict_size, fast_bytes=16),
                       block_size=bs, parse=parse,
                       batch_bytes=BATCH_BLOCKS * bs, device="cpu",
                       progress=lambda i, o: seen.append((i, o)))
    blob = dst.read_bytes()
    assert blob == reference(shape, parse, dict_size)
    assert n == len(blob)
    # three batches, the last the lone tail
    assert [i for i, _ in seen] == [3 * bs, 6 * bs, 6 * bs + tail]


# ------------------------------------------------ the JAX package's cases
TINY = LzmaParams(dict_size=1 << 12, fast_bytes=16)


def tiny_file(tmp_path, n=200, block=64):
    """A file of a few 64-byte blocks and its container (the plain coder
    runs a step a pair: a block this small costs little)."""
    data = mixed(n, seed=5)
    src, dst = tmp_path / "t.in", tmp_path / "t.lztb"
    src.write_bytes(data)
    fs.encode_file(src, dst, TINY, block_size=block, batch_bytes=2 * block,
                   parse="lazy", device="cpu")
    return data, dst


def test_empty_file(tmp_path):
    src, mid, out = tmp_path / "e", tmp_path / "e.lztb", tmp_path / "e.out"
    src.write_bytes(b"")
    n = fs.encode_file(src, mid, TINY, block_size=64, device="cpu",
                       dictionary=b"dictionary bytes")
    assert mid.read_bytes() == api.encode_blocks(b"", TINY, block_size=64,
                                                 device="cpu")
    assert n == len(mid.read_bytes())
    assert fs.decode_file(mid, out, device="cpu") == 0
    assert out.read_bytes() == b""


def test_progress_callback(tmp_path):
    data = mixed(300, seed=6)
    src, dst = tmp_path / "in", tmp_path / "c.lztb"
    src.write_bytes(data)
    seen = []
    n = fs.encode_file(src, dst, TINY, block_size=64, batch_bytes=150,
                       parse="lazy", device="cpu",
                       progress=lambda i, o: seen.append((i, o)))
    # batch_bytes rounds down to whole blocks: 2 a batch
    assert [i for i, _ in seen] == [128, 256, 300]
    assert seen[-1][1] == n
    assert all(a < b for (_, a), (_, b) in zip(seen, seen[1:]))


def test_corrupt_header_rejected(tmp_path):
    bad, out = tmp_path / "bad.lztb", tmp_path / "out"
    bad.write_bytes(b"NOPE" + b"\x00" * 40)
    with pytest.raises(CorruptStreamError):
        fs.decode_file(bad, out, device="cpu")


def test_truncated_payload_rejected(tmp_path):
    _, mid = tiny_file(tmp_path)
    blob = mid.read_bytes()
    mid.write_bytes(blob[: len(blob) - 7])
    with pytest.raises(CorruptStreamError):
        fs.decode_file(mid, tmp_path / "out", device="cpu")


def test_inconsistent_block_count_rejected(tmp_path):
    _, mid = tiny_file(tmp_path)
    blob = bytearray(mid.read_bytes())
    magic, version, props, block_size, total, n = blk._HEAD.unpack_from(blob, 0)
    blk._HEAD.pack_into(blob, 0, magic, version, props, block_size, total, n + 1)
    mid.write_bytes(bytes(blob))
    with pytest.raises(CorruptStreamError):
        fs.decode_file(mid, tmp_path / "out", device="cpu")


def test_forged_total_size_rejected(tmp_path):
    """A ~30-byte container that claims a multi-GiB total_size is refused
    before any decoder allocation."""
    head = (b"LZTB" + bytes([1]) + TINY.encode_props()
            + struct.pack("<IQI", 0xFFFFFFFF, 0xFFFFFFFF, 1))
    forged = tmp_path / "forged.lztb"
    forged.write_bytes(head + struct.pack("<I", 5) + b"\x00" * 5)
    with pytest.raises(CorruptStreamError):
        fs.decode_file(forged, tmp_path / "out", device="cpu")


def test_encode_file_reader_thread_not_leaked(tmp_path, monkeypatch):
    """When the encode raises, the read-ahead thread retires instead of
    blocking on the full queue."""
    import threading
    import time

    src = tmp_path / "src"
    src.write_bytes(mixed(4000, seed=7))
    real = fs._backend

    def broken(parse, device):
        enc, dec = real(parse, device)

        def bad_enc(*a, **k):
            raise RuntimeError("simulated encoder failure")

        return bad_enc, dec

    monkeypatch.setattr(fs, "_backend", broken)
    base = threading.active_count()
    with pytest.raises(RuntimeError, match="simulated"):
        fs.encode_file(src, tmp_path / "dst", TINY, block_size=64,
                       batch_bytes=128, device="cpu")
    for _ in range(50):  # the reader retires within the 0.2 s put timeout
        if threading.active_count() <= base:
            break
        time.sleep(0.1)
    assert threading.active_count() <= base


def test_file_alone_round_trip_and_stdlib(tmp_path):
    """The whole-buffer `.lzma` routes: the file is api.encode_alone's and
    the stdlib reads it; decode_file_alone reads it back."""
    import lzma

    data = mixed(300, seed=8)
    src, mid, out = tmp_path / "in", tmp_path / "c.lzma", tmp_path / "out"
    src.write_bytes(data)
    n = fs.encode_file_alone(src, mid, TINY, device="cpu")
    blob = mid.read_bytes()
    assert n == len(blob) and blob == api.encode_alone(data, TINY, device="cpu")
    assert lzma.decompress(blob, format=lzma.FORMAT_ALONE) == data
    assert fs.decode_file_alone(mid, out, device="cpu") == len(data)
    assert out.read_bytes() == data


# ------------------------------------------------ the sizer
def fake_card(monkeypatch, free, reserved=0, allocated=0):
    """A card with `free` bytes free and a cache of `reserved` bytes, of
    which `allocated` are in use."""
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d=None: (free, 8 * free))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d=None: reserved)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d=None: allocated)


def test_sizer_rounds_down_to_whole_lanes_and_at_least_one(monkeypatch):
    lane = fs.encode_lane_bytes("optimal", 1 << 18)
    # 2.5 lanes in the share, plus 1 MiB of cache held but unallocated
    fake_card(monkeypatch, int(2.5 * lane / fs.MEM_SHARE) - (2 << 20),
              reserved=3 << 20, allocated=1 << 20)
    assert fs.encode_batch_blocks("optimal", 1 << 18, device="cuda") == 2
    fake_card(monkeypatch, int(1.01 * lane / fs.MEM_SHARE))
    assert fs.encode_batch_blocks("optimal", 1 << 18, device="cuda") == 1
    # a preset lane parses lazy and is wider: the larger lane sizes it
    wide = fs.encode_lane_bytes("optimal", 1 << 18, 1 << 18)
    assert wide > lane and wide == fs.encode_lane_bytes("lazy", 1 << 18, 1 << 18)
    fake_card(monkeypatch, int(3 * wide / fs.MEM_SHARE))
    assert fs.encode_batch_blocks("optimal", 1 << 18, 1 << 18,
                                  device="cuda") == 3


def test_sizer_raises_where_one_block_cannot_fit(monkeypatch, tmp_path):
    lane = fs.encode_lane_bytes("lazy", 1 << 20)
    fake_card(monkeypatch, int(0.9 * lane / fs.MEM_SHARE))
    with pytest.raises(ValueError, match="smaller block_size"):
        fs.encode_batch_blocks("lazy", 1 << 20, device="cuda")
    # before any launch: encode_file raises before it opens the output
    src = tmp_path / "in"
    src.write_bytes(b"x" * 100)
    with pytest.raises(ValueError, match="smaller block_size"):
        fs.encode_file(src, tmp_path / "out", TINY, block_size=1 << 20,
                       parse="lazy", device="cuda")
    assert not (tmp_path / "out").exists()
    dlane = fs.decode_lane_bytes(TINY, 1 << 20, 1 << 20)
    fake_card(monkeypatch, int(0.5 * dlane / fs.MEM_SHARE))
    with pytest.raises(ValueError):
        fs.decode_batch_blocks(TINY, 1 << 20, 1 << 20, device="cuda")


def test_sizer_batch_bytes_is_a_ceiling(monkeypatch):
    fake_card(monkeypatch, 1 << 45)
    assert fs.encode_batch_blocks("lazy", 1 << 16, batch_bytes=5 << 16,
                                  device="cuda") == 5
    assert fs.decode_batch_blocks(TINY, 1 << 16, 1 << 15,
                                  batch_bytes=(7 << 16) + 1,
                                  device="cuda") == 7
    # and on the CPU it alone sets the batch, at least one block
    assert fs.encode_batch_blocks("lazy", 1 << 16, batch_bytes=100,
                                  device="cpu") == 1


def test_sizer_never_runs_on_the_cpu_path(monkeypatch, tmp_path):
    def no_card(*a, **k):
        raise AssertionError("the CPU path asked the card")

    for name in ("mem_get_info", "memory_reserved", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    assert fs.encode_batch_blocks("optimal", 1 << 20, device="cpu") == 64
    data, mid = tiny_file(tmp_path)
    assert fs.decode_file(mid, tmp_path / "out", device="cpu") == len(data)


def test_the_default_device_raises_without_a_card(tmp_path):
    """No CPU fallback: with no CUDA device the default device="cuda"
    raises before anything is written."""
    import lzma_tpu_torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src = tmp_path / "in"
    src.write_bytes(b"abc" * 100)
    with pytest.raises((RuntimeError, AssertionError)):
        lzma_tpu_torch.compress_file(src, tmp_path / "out")
    assert not (tmp_path / "out").exists()
    lztb = tmp_path / "c.lztb"
    lztb.write_bytes(api.encode_blocks(b"abc" * 100, TINY, device="cpu"))
    with pytest.raises((RuntimeError, AssertionError)):
        lzma_tpu_torch.decompress_file(lztb, tmp_path / "back")
