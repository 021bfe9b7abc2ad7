"""The port's block codec surface against lzma_tpu's, on the CPU.

encode_blocks must write byte-identical LZTB containers to
lzma_tpu.ops.api.encode_blocks(..., use_pallas=True, parse="lazy");
decode_blocks must read them back, and lzma_tpu must read the port's.
The pin test ties chip_smoke.py's card run to the JAX reference through
one SHA-256.  (lzma_tpu's v2/v3 containers: test_torch_containers.py.)
"""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import lzma_tpu  # noqa: E402
from lzma_tpu.bench.corpus import text_part  # noqa: E402
from lzma_tpu.bench.datagen import generate_bench_data  # noqa: E402
from lzma_tpu.format.properties import LzmaParams  # noqa: E402
from lzma_tpu.ops import api as japi  # noqa: E402
from lzma_tpu_torch.ops import api as tapi  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {
    "bench-3-lanes": (generate_bench_data(2500), LzmaParams(dict_size=1 << 12), 1024),
    "text-defaults": (text_part()[:2500], LzmaParams(), 1024),
    "single-short": (b"abracadabra, abracadabra!", LzmaParams(lc=0, lp=0, pb=0), 1024),
    "empty": (b"", LzmaParams(), 1024),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_encode_blocks_matches_jax_and_round_trips(name):
    data, params, block = CASES[name]
    ref = japi.encode_blocks(data, params, block_size=block, use_pallas=True,
                             parse="lazy")
    got = tapi.encode_blocks(data, params, block_size=block, device="cpu")
    assert got == ref
    assert tapi.decode_blocks(got, device="cpu") == data
    assert lzma_tpu.decompress(got) == data


def test_smoke_pin_is_the_jax_container():
    """chip_smoke.py compares the card's container with PIN_SHA256; this
    holds the pin to the JAX reference (JAX is absent on the card)."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    data, params, block = chip_smoke.pin_input()
    blob = japi.encode_blocks(data, params, block_size=block, parse="lazy")
    assert len(data) // block == 8
    assert hashlib.sha256(blob).hexdigest() == chip_smoke.PIN_SHA256


def test_not_ported_options_raise():
    data = generate_bench_data(3000)
    with pytest.raises(NotImplementedError):
        tapi.encode_blocks(data, block_size=1024, parse="optimal", device="cpu")
    with pytest.raises(NotImplementedError):
        tapi.encode_blocks(data, block_size=1024, preset_len=100, device="cpu")
    with pytest.raises(NotImplementedError):
        tapi.encode_blocks(data, block_size=1024, dictionary=b"xyz" * 50,
                           device="cpu")
    with pytest.raises(ValueError):
        tapi.encode_blocks(data, LzmaParams(write_eos=True), device="cpu")


def test_from_numpy_carries_arrays_over():
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    b = np.asarray(jax.numpy.asarray(np.array([True, False])))  # read-only
    ta, tb = tapi.from_numpy(a, b, device="cpu")
    assert ta.dtype == torch.int32 and tb.dtype == torch.bool
    assert ta.tolist() == a.tolist() and tb.tolist() == [True, False]
    ta[0, 0] = 99
    assert a[0, 0] == 0  # copied


def test_port_imports_no_jax():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "import lzma_tpu_torch.ops.api, lzma_tpu_torch.ops.cuda_ring,"
        " lzma_tpu_torch.ops.cuda_serializer, lzma_tpu_torch.runtime.build;"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'));"
        "assert not bad, bad"
    )
    # -I: no PYTHONPATH or site hooks that might import jax on their own
    subprocess.run([sys.executable, "-I", "-c", code, ROOT], check=True,
                   timeout=120)
