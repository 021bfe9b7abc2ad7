"""The port's file codec with a shared preset (LZTB v2) and a stored
dictionary (LZTB v3), and ops.api's lane groups, on the CPU.

encode_file in batches of 3 blocks (the first batch splits block 0, the
preset's source, from the primed lanes; the last batch is the lone tail)
must write ops.api.encode_blocks' container of the whole file, lazy and
optimal; api.encode_blocks and decode_blocks in lane groups must give
the bytes of one group.
"""

import functools

import numpy as np
import pytest

from lzma_tpu_torch.format.properties import LzmaParams
from lzma_tpu_torch.ops import api
from lzma_tpu_torch.parallel import filestream as fs

BLOCK, TAIL = 512, 175
PARAMS = LzmaParams(dict_size=1 << 16, fast_bytes=16)


@functools.cache
def data():
    rng = np.random.default_rng(41)
    words = [rng.integers(0, 256, int(k), dtype=np.uint8).tobytes()
             for k in rng.integers(3, 12, 24)]
    out = bytearray()
    while len(out) < 6 * BLOCK + TAIL:
        out += words[int(rng.integers(0, len(words)))]
    return bytes(out[: 6 * BLOCK + TAIL])


DICT = bytes(range(256)) * 2   # a stored dictionary of 512 B
KW = {"v2": dict(preset_len=200), "v3": dict(dictionary=DICT)}


@pytest.mark.parametrize("version", ["v2", "v3"])
@pytest.mark.parametrize("parse", ["lazy", "optimal"])
def test_encode_file_with_presets_matches_encode_blocks(version, parse,
                                                        tmp_path):
    src, dst = tmp_path / "in", tmp_path / "out.lztb"
    src.write_bytes(data())
    seen = []
    fs.encode_file(src, dst, PARAMS, block_size=BLOCK, parse=parse,
                   batch_bytes=3 * BLOCK, device="cpu",
                   progress=lambda i, o: seen.append(i), **KW[version])
    want = api.encode_blocks(data(), PARAMS, block_size=BLOCK, parse=parse,
                             device="cpu", **KW[version])
    assert dst.read_bytes() == want
    assert want[4] == int(version[1])
    assert seen == [3 * BLOCK, 6 * BLOCK, 6 * BLOCK + TAIL]


def test_api_lane_groups_keep_the_bytes(monkeypatch):
    """encode_blocks and decode_blocks run their lanes in the sizer's
    groups (here 2 lanes, as a card short of memory would give): the
    container and the decode are those of one group."""
    one = api.encode_blocks(data(), PARAMS, block_size=BLOCK, device="cpu",
                            **KW["v2"])
    monkeypatch.setattr(api, "encode_batch_blocks", lambda *a, **k: 2)
    monkeypatch.setattr(api, "decode_batch_blocks", lambda *a, **k: 2)
    calls = []
    real = api.decode_batch_cuda

    def spy(streams, *a, **k):
        calls.append(len(streams))
        return real(streams, *a, **k)

    monkeypatch.setattr(api, "decode_batch_cuda", spy)
    assert api.encode_blocks(data(), PARAMS, block_size=BLOCK, device="cpu",
                             **KW["v2"]) == one
    assert api.decode_blocks(one, device="cpu") == data()
    assert calls == [1, 2, 2, 2]   # block 0, then the primed lanes by 2


@pytest.mark.parametrize("version", ["v2", "v3"])
def test_decode_file_round_trip_in_batches(version, tmp_path):
    """decode_file in batches of 3 blocks: block 0 donates the v2 preset
    in the first batch; the v3 dictionary primes every batch."""
    src, out = tmp_path / "c.lztb", tmp_path / "out"
    src.write_bytes(api.encode_blocks(data(), PARAMS, block_size=BLOCK,
                                      device="cpu", **KW[version]))
    seen = []
    n = fs.decode_file(src, out, batch_bytes=3 * BLOCK, device="cpu",
                       progress=lambda o, i: seen.append(o))
    assert n == len(data()) and out.read_bytes() == data()
    assert seen == [3 * BLOCK, 6 * BLOCK, n]
