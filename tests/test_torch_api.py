"""The port's block codec surface against lzma_tpu's, on the CPU.

encode_blocks must write byte-identical LZTB containers to
lzma_tpu.ops.api.encode_blocks(..., use_pallas=True, parse="lazy");
decode_blocks must read them back, and lzma_tpu must read the port's.
The pin tests tie chip_smoke.py's card run to the JAX reference through
SHA-256s of its containers.  (lzma_tpu's v2/v3 containers:
test_torch_containers.py; the optimal parse: test_torch_optimal.py.)
"""

import dataclasses
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
from lzma_tpu.ops import device_encoder as jde  # noqa: E402
from lzma_tpu_torch.ops import api as tapi  # noqa: E402
from lzma_tpu_torch.ops.device_encoder import encode_batch as tencode_batch  # noqa: E402

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


def _smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def _jax_params(params):
    return LzmaParams(**dataclasses.asdict(params))


@pytest.mark.parametrize("parse", ["lazy", "optimal"])
def test_smoke_pin_is_the_jax_container(parse):
    """chip_smoke.py compares the card's containers with PIN_SHA256 and
    PIN_OPT_SHA256; this holds the pins to the JAX reference (JAX is
    absent on the card)."""
    smoke = _smoke()
    data, params, block = smoke.pin_input()
    blob = japi.encode_blocks(data, _jax_params(params), block_size=block,
                              parse=parse)
    assert len(data) // block == 8
    pin = smoke.PIN_SHA256 if parse == "lazy" else smoke.PIN_OPT_SHA256
    assert hashlib.sha256(blob).hexdigest() == pin


def test_smoke_bench_pin_is_the_jax_container():
    """The bench's device round trip (bench.py:297-328) through the JAX
    reference: BENCH_r05.json's device_ratio, the container's size and
    PIN_BENCH_SHA256, which chip_smoke.py holds the card to."""
    smoke = _smoke()
    # bench.py slices a longer stream; the generator is sequential
    assert generate_bench_data(1 << 16)[: 1 << 13] == generate_bench_data(1 << 13)
    data, params, block = smoke.bench_input()
    blob = japi.encode_blocks(data, _jax_params(params), block_size=block,
                              parse="optimal")
    assert len(data) // block == 32
    assert len(blob) == smoke.BENCH_BYTES
    assert round(len(data) / len(blob), 3) == smoke.BENCH_RATIO == 2.256
    assert hashlib.sha256(blob).hexdigest() == smoke.PIN_BENCH_SHA256


def test_smoke_alone_pins_are_the_jax_streams():
    """chip_smoke.py holds the card's `.lzma` files of 64 KiB of bench data,
    with a known size and with the EOS marker, to these JAX streams."""
    smoke = _smoke()
    data = generate_bench_data(smoke.ALONE_PIN_SIZE)
    for eos, pin in ((False, smoke.PIN_ALONE_SHA256),
                     (True, smoke.PIN_ALONE_EOS_SHA256)):
        blob = japi.encode_alone(data, LzmaParams(write_eos=eos))
        assert hashlib.sha256(blob).hexdigest() == pin


def test_smoke_entry_pin_is_the_jax_entry():
    """__graft_entry__.entry()'s output (JAX) and lzma_tpu_torch.entry's
    (the port, CPU) hash to chip_smoke.py's PIN_ENTRY_SHA256."""
    from lzma_tpu_torch.entry import entry

    smoke = _smoke()
    sys.path.insert(0, ROOT)
    try:
        import __graft_entry__
    finally:
        sys.path.remove(ROOT)
    fn, args = __graft_entry__.entry()
    out, lens = fn(*args)
    assert smoke.entry_digest(np.asarray(out), np.asarray(lens)) == \
        smoke.PIN_ENTRY_SHA256
    t_fn, t_args = entry("cpu")
    t_out, t_lens = t_fn(*t_args)
    assert t_args[0].dtype == torch.uint8 and t_args[1].dtype == torch.int32
    assert smoke.entry_digest(t_out.numpy(), t_lens.numpy()) == \
        smoke.PIN_ENTRY_SHA256


def test_smoke_hybrid_pins_are_the_jax_containers():
    """chip_smoke.py holds the card's hybrid containers (optimal and lazy)
    to PIN_HYBRID_OPT_SHA256 and PIN_HYBRID_LAZY_SHA256: the JAX package's
    ops.hybrid encodes of the same input."""
    from lzma_tpu.ops import hybrid as jhybrid
    from lzma_tpu.runtime import native as jnative

    if not jnative.available():
        pytest.skip("no C++ toolchain")
    smoke = _smoke()
    data, params, block = smoke.hybrid_pin_input()
    assert len(data) == (1 << 16) + 1234 and block == 1 << 14
    for fn, pin in ((jhybrid.encode_blocks_hybrid_optimal,
                     smoke.PIN_HYBRID_OPT_SHA256),
                    (jhybrid.encode_blocks_hybrid, smoke.PIN_HYBRID_LAZY_SHA256)):
        blob = fn(data, _jax_params(params), block_size=block)
        assert hashlib.sha256(blob).hexdigest() == pin


def test_not_ported_options_raise():
    data = generate_bench_data(3000)
    with pytest.raises(NotImplementedError):
        tapi.encode_blocks(data, block_size=1024, parse="optimal:lazy",
                           device="cpu")
    # the EOS marker is ported: the optimal parse's stream equals JAX's
    eos = LzmaParams(write_eos=True)
    assert tencode_batch([data[:500]], eos, parse="optimal", write_eos=True,
                         device="cpu") == \
        jde.encode_batch([data[:500]], eos, parse="optimal", write_eos=True)
    with pytest.raises(ValueError):
        tapi.encode_blocks(data, LzmaParams(write_eos=True), device="cpu")
    # what the port has since added: the optimal parse and the
    # preset-primed containers
    for kw in (dict(parse="optimal"), dict(preset_len=100),
               dict(dictionary=b"xyz" * 50)):
        blob = tapi.encode_blocks(data, block_size=1024, device="cpu", **kw)
        assert tapi.decode_blocks(blob, device="cpu") == data
        assert lzma_tpu.decompress(blob) == data


def test_from_numpy_carries_arrays_over():
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    b = np.asarray(jax.numpy.asarray(np.array([True, False])))  # read-only
    ta, tb = tapi.from_numpy(a, b, device="cpu")
    assert ta.dtype == torch.int32 and tb.dtype == torch.bool
    assert ta.tolist() == a.tolist() and tb.tolist() == [True, False]
    ta[0, 0] = 99
    assert a[0, 0] == 0  # copied


def test_port_imports_no_jax():
    """Importing every module of the port (cli, entry, utils, ops.hybrid
    and the host encoder's runtime.native among them) and running a CPU
    encode (lazy and optimal) and decode, a `.lzma` round trip with the
    EOS marker and, where g++ is, both hybrid encodes, loads nothing of
    JAX and nothing of the JAX package (lzma_tpu_torch starts with
    lzma_tpu, hence the exact test), and no library of lzma_tpu/runtime."""
    code = (
        "import sys, pkgutil, importlib; sys.path.insert(0, sys.argv[1]);"
        "import lzma_tpu_torch as P;"
        "[importlib.import_module(m.name) for m in"
        " pkgutil.walk_packages(P.__path__, 'lzma_tpu_torch.')];"
        "from lzma_tpu_torch.ops import api;"
        "from lzma_tpu_torch.bench.datagen import generate_bench_data as g;"
        "d = g(3000);"
        "[api.decode_blocks(api.encode_blocks(d, block_size=1024, parse=p,"
        " device='cpu'), device='cpu') == d or sys.exit(p)"
        " for p in ('lazy', 'optimal')];"
        "e = P.LzmaParams(write_eos=True);"
        "api.decode_alone(api.encode_alone(d[:300], e, device='cpu'),"
        " device='cpu') == d[:300] or sys.exit('alone');"
        "from lzma_tpu_torch.ops import hybrid;"
        "from lzma_tpu_torch.runtime import native;"
        "native.available() and [api.decode_blocks(f(d, block_size=1024,"
        " device='cpu'), device='cpu') == d or sys.exit(f.__name__) for f in"
        " (hybrid.encode_blocks_hybrid, hybrid.encode_blocks_hybrid_optimal)];"
        "maps = open('/proc/self/maps').read();"
        "assert 'lzma_tpu/runtime' not in maps, 'lzma_tpu/runtime library';"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib') or m == 'lzma_tpu' or m.startswith('lzma_tpu.'));"
        "assert not bad, bad"
    )
    # -I: no PYTHONPATH or site hooks that might import jax on their own
    subprocess.run([sys.executable, "-I", "-c", code, ROOT], check=True,
                   timeout=300)
