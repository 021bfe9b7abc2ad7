"""The Hopper probes' plain versions against the TPU probes, on the CPU.

Each ``tools/probe_*.py`` is loaded by path as it stands, its module
``ITERS`` set small, and its Pallas kernels run in interpret mode
(``pltpu.force_tpu_interpret_mode()``).  The port's function in
``lzma_tpu_torch/probes/`` takes a CPU tensor, so it runs its plain
version, which must give the same integers.  Where a TPU probe returns
only its timing, the test reads what its kernel wrote by wrapping the
loaded module's ``pl.pallas_call``.  The scripts set the JAX compilation
cache directory (in ``jax.config`` and the environment) and ``sys.path``
when imported; the fixture puts all three back.
"""

import contextlib
import importlib.util
import lzma
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from lzma_tpu_torch.bench.datagen import generate_bench_data  # noqa: E402
from lzma_tpu_torch.probes import (probe_dma, probe_dma2, probe_fsm_cost,  # noqa: E402
                                   probe_fsm_cost2, probe_gather, probe_gather2,
                                   probe_packed_ablate, probe_ring_ablate)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("probe_fsm_cost", "probe_fsm_cost2", "probe_gather", "probe_gather2",
           "probe_ring_ablate", "probe_dma", "probe_dma2")
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


@pytest.fixture(scope="module")
def tpu():
    """The TPU probe scripts, loaded by path: {name: module}."""
    path, cache = list(sys.path), jax.config.jax_compilation_cache_dir
    env = os.environ.get(CACHE_ENV)
    try:
        mods = {}
        for name in SCRIPTS:
            spec = importlib.util.spec_from_file_location(
                f"_tpu_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
            mods[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
    finally:
        sys.path[:] = path
        jax.config.update("jax_compilation_cache_dir", cache)
        if env is None:
            os.environ.pop(CACHE_ENV, None)
        else:
            os.environ[CACHE_ENV] = env
    return mods


@contextlib.contextmanager
def interpret(mod, iters=None):
    """Run `mod`'s kernels in interpret mode, its ITERS set to `iters`,
    and record what each pallas_call returns: yields the list."""
    outs = []
    real, old_iters = mod.pl, getattr(mod, "ITERS", None)

    class Recorder:
        def __getattr__(self, name):
            return getattr(real, name)

        def pallas_call(self, *args, **kwargs):
            f = real.pallas_call(*args, **kwargs)

            def call(*a):
                out = f(*a)
                outs.append(out)
                return out
            return call

    mod.pl = Recorder()
    if iters is not None:
        mod.ITERS = iters
    try:
        with pltpu.force_tpu_interpret_mode():
            yield outs
    finally:
        mod.pl = real
        if iters is not None:
            mod.ITERS = old_iters


def col(x):
    return np.asarray(x)[:, 0]


# ------------------------------------------------ P10-P13: the decode step
@pytest.mark.parametrize("name", ["v1", "v2", "v_i16"])
def test_fsm_cost_equals_the_tpu_probe(tpu, name):
    m, iters = tpu["probe_fsm_cost"], 96
    with interpret(m, iters):
        f, seed = getattr(m, name)(8)
        want = col(f(seed))
    got = getattr(probe_fsm_cost, name)(probe_fsm_cost.seeds(8, "cpu"), iters)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", [dict(loop="fori"), dict(loop="while"),
                                dict(loop="fori", selects=150),
                                dict(loop="while", nregs=24, selects=120)],
                         ids=["fixed", "while", "selects", "registers"])
def test_fsm_cost2_make_equals_the_tpu_probe(tpu, kw):
    m, iters = tpu["probe_fsm_cost2"], 64
    with interpret(m, iters):
        f, seed = m.make(8, **kw)
        want = col(f(seed))
    got = probe_fsm_cost2.make(probe_fsm_cost.seeds(8, "cpu"), iters, **kw)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------ P5-P9: gathers
@pytest.mark.parametrize("width", [128, 512])
@pytest.mark.parametrize("name", ["probe_native", "probe_onehot", "probe_scatter"])
def test_gather_equals_the_tpu_probe(tpu, name, width):
    m, iters = tpu["probe_gather"], 48
    with interpret(m, iters) as outs:
        getattr(m, name)(width)
    inputs = (probe_gather.scatter_inputs if name == "probe_scatter"
              else probe_gather.inputs)(width, device="cpu")
    got = getattr(probe_gather, name)(*inputs, iters)
    np.testing.assert_array_equal(got.numpy(), col(outs[-1]))


@pytest.mark.parametrize("g", [1, 2])
def test_chain_equals_the_tpu_probe(tpu, g):
    m, iters = tpu["probe_gather2"], 64
    with interpret(m, iters) as outs:
        _, ok = m.probe_chain(8, 256, g)
    assert ok   # the TPU probe's own numpy check
    arr, idx = probe_gather2.chain_inputs(8, 256, "cpu")
    before = arr.clone()
    got = probe_gather2.probe_chain(arr, idx, g, iters)
    np.testing.assert_array_equal(got.numpy(), col(outs[-1]))
    assert torch.equal(arr, before)


@pytest.mark.parametrize("width", [128, 512])
def test_taa_equals_the_tpu_probe(tpu, width):
    with interpret(tpu["probe_gather2"]):
        out, want = tpu["probe_gather2"].probe_taa(16, width)
    np.testing.assert_array_equal(out, want)
    got = probe_gather2.probe_taa(*probe_gather2.taa_inputs(16, width, "cpu"))
    np.testing.assert_array_equal(got.numpy(), out)


# ------------------------------------------------ P1-P4: copies
@pytest.fixture(scope="module")
def dma_outputs(tpu):
    """What P1, P2 and P3 of the TPU probe wrote (each asserts its own
    reference as it runs)."""
    with interpret(tpu["probe_dma"]) as outs:
        tpu["probe_dma"].probe1()
        tpu["probe_dma"].probe2()
        tpu["probe_dma"].probe3()
    return {"probe1": np.asarray(outs[0]), "probe2": np.asarray(outs[1]),
            "probe3": np.asarray(outs[2])}


#: the lanes a 16-byte-aligned copy must refuse: offsets 3 and 777 int32
#: (12 and 3,108 B into their rows) in P1, 3 in P2
REFUSED = {"probe1": [4, 6], "probe2": [4]}


@pytest.mark.parametrize("form", list(probe_dma.FORMS))
@pytest.mark.parametrize("name", ["probe1", "probe2"])
def test_copy_probe_equals_the_tpu_probe(dma_outputs, name, form):
    offs = probe_dma.OFFS1 if name == "probe1" else probe_dma.OFFS2
    out, refused = getattr(probe_dma, name)(
        probe_dma.source("cpu"), probe_dma.offsets(offs, "cpu"), form)
    want_refused = REFUSED[name] if form in probe_dma.ALIGNED else []
    assert refused == want_refused
    keep = [i for i in range(probe_dma.N) if i not in refused]
    np.testing.assert_array_equal(out.numpy()[keep], dma_outputs[name][keep])
    np.testing.assert_array_equal(
        out.numpy()[keep],
        probe_dma.reference(offs, probe_dma.ROUNDS[name]).numpy()[keep])
    assert (out.numpy()[refused] == -1).all()


def test_scalar_probe_equals_the_tpu_probe(dma_outputs):
    got = probe_dma.probe3(probe_dma.tile("cpu"))
    np.testing.assert_array_equal(got.numpy(), dma_outputs["probe3"])


@pytest.mark.parametrize("kernel", list(probe_dma2.KERNELS))
def test_dma2_form_equals_the_tpu_probe(tpu, kernel):
    m = tpu["probe_dma2"]
    sem = pltpu.SemaphoreType.DMA if kernel == "kE" else pltpu.SemaphoreType.DMA((1,))
    check = {"kA": m.ck_a, "kC": m.ck_dyn, "kE": m.ck_dyn}.get(kernel, m.ck_static)
    with interpret(m) as outs:
        m.run(getattr(m, kernel), sem, kernel, check)
    out, refused = probe_dma2.run(kernel, probe_dma.source("cpu"),
                                  probe_dma.offsets(probe_dma.OFFS1, "cpu"))
    assert refused == ([4, 6] if kernel in probe_dma2.DYNAMIC else [])
    keep = [i for i in range(probe_dma.N) if i not in refused]
    np.testing.assert_array_equal(out.numpy()[keep], np.asarray(outs[-1])[keep])
    np.testing.assert_array_equal(out.numpy()[keep],
                                  probe_dma2.expected(kernel).numpy()[keep])


# ------------------------------------------------ P15: K1's body on real rows
def test_ring_ablate_realrow_equals_the_data_and_the_port(tpu):
    """2 lanes x 256 B of raw streams from the stdlib (lc0, dict 4 KiB):
    the TPU probe's realrow decodes them, and the port's full (the plain
    decoder on the CPU) gives the same bytes and output positions."""
    n, bs, dict_size = 2, 256, 1 << 12
    data = generate_bench_data(n * bs)
    filters = [{"id": lzma.FILTER_LZMA1, "lc": 0, "lp": 0, "pb": 2,
                "dict_size": dict_size}]
    streams = [lzma.compress(data[i * bs:(i + 1) * bs], format=lzma.FORMAT_RAW,
                             filters=filters) for i in range(n)]
    max_in = 1 << (max(len(s) for s in streams) - 1).bit_length()
    comp = np.zeros((n, max_in), np.uint8)
    for i, s in enumerate(streams):
        comp[i, :len(s)] = np.frombuffer(s, np.uint8)
    lens = np.asarray([len(s) for s in streams], np.int32)
    sizes = np.full((n,), bs, np.int32)
    with pltpu.force_tpu_interpret_mode():
        out, okv = tpu["probe_ring_ablate"].ablate(
            jnp.asarray(comp.astype(np.int32)), dict_size, 0, 0, 2, bs, 2048,
            "realrow", max_in, comp_lens=jnp.asarray(lens),
            out_sizes=jnp.asarray(sizes))
    want = np.frombuffer(data, np.uint8).reshape(n, bs)
    np.testing.assert_array_equal(np.asarray(out)[:, :bs].astype(np.uint8), want)
    got, ok, out_pos, counts = probe_ring_ablate.ablate(
        torch.from_numpy(comp), torch.from_numpy(lens), torch.from_numpy(sizes),
        dict_size, 0, 0, 2, bs, "full")
    assert counts is None and bool(ok.all())
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(out_pos.numpy(), col(okv))


# ------------------------------------------------ the wrappers on the CPU
def test_packed_ablate_full_decodes_valid_rows_on_the_cpu():
    """P14's full, read to each row's whole width as the TPU probe reads
    it, is the exact decoder on valid streams."""
    data = generate_bench_data(2 * 300)
    filters = [{"id": lzma.FILTER_LZMA1, "lc": 0, "lp": 0, "pb": 2,
                "dict_size": 1 << 12}]
    comp = torch.zeros((2, 512), dtype=torch.uint8)
    for i in range(2):
        s = lzma.compress(data[i * 300:(i + 1) * 300], format=lzma.FORMAT_RAW,
                          filters=filters)
        comp[i, :len(s)] = torch.frombuffer(bytearray(s), dtype=torch.uint8)
    out, ok, out_pos, _ = probe_packed_ablate.ablate(
        comp, 1 << 12, 0, 512, "full",
        out_sizes=torch.full((2,), 300, dtype=torch.int32))
    assert bool(ok.all()) and out_pos.tolist() == [300, 300]
    assert out[:, :300].numpy().tobytes() == data


def test_gather_plain_versions_take_any_index():
    """A negative index is taken modulo the width as a floor; probe_taa
    gives 0 outside the row (the kernels do the same, tests/test_torch_cuda.py)."""
    arr, idx = probe_gather.inputs(128, 4, "cpu")
    moved = idx - 3 * 128
    assert torch.equal(probe_gather.probe_native(arr, moved, 20),
                       probe_gather.probe_native(arr, idx, 20))
    arr, idx = probe_gather2.taa_inputs(4, 128, "cpu")
    idx[1], idx[2] = 128, -1
    got = probe_gather2.probe_taa(arr, idx)
    assert got.tolist() == [int(arr[0, idx[0]]), 0, 0, int(arr[3, idx[3]])]


@pytest.mark.parametrize("variant", ["noarena", "barebit"])
def test_knockouts_have_no_plain_version(variant):
    comp = torch.zeros((1, 16), dtype=torch.uint8)
    n = torch.full((1,), 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="timing only"):
        probe_ring_ablate.ablate(comp, n, n, 1 << 12, 0, 0, 2, 16, variant)


def test_cpu_calls_count_no_launch():
    seed = probe_fsm_cost.seeds(4, "cpu")
    before = [sum(m.LAUNCHES.values()) for m in (probe_fsm_cost, probe_gather,
                                                  probe_dma)]
    probe_fsm_cost.v1(seed, 8)
    probe_gather.probe_native(*probe_gather.inputs(128, 4, "cpu"), 8)
    probe_dma.probe1(probe_dma.source("cpu"), probe_dma.offsets(probe_dma.OFFS1, "cpu"))
    assert [sum(m.LAUNCHES.values()) for m in (probe_fsm_cost, probe_gather,
                                               probe_dma)] == before


@pytest.mark.parametrize("mod", [probe_fsm_cost, probe_fsm_cost2, probe_gather,
                                 probe_gather2, probe_ring_ablate,
                                 probe_packed_ablate, probe_dma, probe_dma2],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_a_probe_table_needs_a_card(mod, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA device"):
        mod.main()
