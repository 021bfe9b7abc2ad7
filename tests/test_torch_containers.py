"""The port's decode_blocks on lzma_tpu's containers, on the CPU.

LZTB v2 (shared preset) and v3 (stored dictionary) containers written by
lzma_tpu.ops.api.encode_blocks must decode through the port (its decoder
takes a preset), and damaged containers must raise CorruptStreamError.
"""

import pytest

jax = pytest.importorskip("jax")

from lzma_tpu.bench.datagen import generate_bench_data  # noqa: E402
from lzma_tpu.format.properties import LzmaParams  # noqa: E402
from lzma_tpu.ops import api as japi  # noqa: E402
from lzma_tpu_torch.core.rangecoder import CorruptStreamError  # noqa: E402
from lzma_tpu_torch.ops import api as tapi  # noqa: E402


@pytest.mark.parametrize("kind", ["preset", "dictionary"])
def test_decode_blocks_reads_lzma_tpu_v2_v3(kind):
    data = generate_bench_data(1600)
    params = LzmaParams(dict_size=1 << 12)
    if kind == "preset":
        blob = japi.encode_blocks(data, params, block_size=640, preset_len=320)
        assert blob[4] == 2
    else:
        blob = japi.encode_blocks(data, params, block_size=640,
                                  dictionary=data[100:500])
        assert blob[4] == 3
    assert tapi.decode_blocks(blob, device="cpu") == data


def test_decode_blocks_rejects_corrupt_containers():
    data, params = generate_bench_data(900), LzmaParams(dict_size=1 << 12)
    blob = bytearray(tapi.encode_blocks(data, params, block_size=512,
                                        device="cpu"))
    with pytest.raises(CorruptStreamError):
        tapi.decode_blocks(bytes(blob[:-40]), device="cpu")
    blob[len(blob) - 150] ^= 0xFF
    with pytest.raises(CorruptStreamError):
        tapi.decode_blocks(bytes(blob), device="cpu")
