"""The optimal parse's DP rows (K12), on the CPU.

K12's plain version (``device_parser._dp_inputs_plain``, which
``cuda_inputs.dp_inputs_cuda`` takes for CPU tensors) against the JAX
package's ``_pack_inputs`` (after its moveaxis) over its
``build_price_model`` (lit_cost, matched_lit_cost), ``_pair_dist_cost``
and ``rep_match_lens_rmq``, exactly: at lc3 lp0 pb2, lc0 lp2 pb0 and lc8
lp4 pb4, at fb 5, 32 and 273, on six lanes (bench data, text with lens
below max_n, all zeros, lanes of 0, 1 and 3 bytes) with random pairs
(invalid, near and far distances) and a random rep0 trace whose sources
lie before the block too.  Then ``csrc/dp_input_row.cuh``, the kernel's
per-position closed form, built by g++ into a serial host loop, gives
the plain version's rows on the same inputs (no g++ skips those).
"""

import ctypes
import functools
import os
import shutil
import subprocess

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lzma_tpu.core.layout import ProbLayout as JLayout  # noqa: E402
from lzma_tpu.ops import device_matcher as jm  # noqa: E402
from lzma_tpu.ops import device_parser as jp  # noqa: E402
from lzma_tpu_torch.bench.corpus import text_part  # noqa: E402
from lzma_tpu_torch.bench.datagen import generate_bench_data  # noqa: E402
from lzma_tpu_torch.core.layout import ProbLayout  # noqa: E402
from lzma_tpu_torch.ops import cuda_inputs  # noqa: E402
from lzma_tpu_torch.ops import device_parser as tp  # noqa: E402

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "lzma_tpu_torch", "csrc")
W = 1024
M = 4
PRESETS = {"lc3lp0pb2": (3, 0, 2), "lc0lp2pb0": (0, 2, 0),
           "lc8lp4pb4": (8, 4, 4)}


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def _lanes():
    """Six lanes of W bytes: bench data, text (lens 700), all zeros, and
    lanes of 0, 1 and 3 bytes."""
    bench = np.frombuffer(generate_bench_data(W), np.uint8)
    text = np.frombuffer(text_part()[:2 * W], np.uint8)
    rows = [bench, text[W:], np.zeros(W, np.uint8), text[:W], bench[::-1],
            text[::2]]
    lens = np.array([W, 700, W, 0, 1, 3], np.int32)
    return np.ascontiguousarray(np.stack(rows)), lens


DATA, LENS = _lanes()


@functools.cache
def _suffix(fb):
    """JAX's suffix rank and min table of the lanes at depth fb."""
    pos = jnp.arange(W, dtype=jnp.int32)
    rank, Tt = jax.jit(jax.vmap(
        lambda d, n: jm._suffix_rank_lcp(d, n, pos, W, fb)))(
            jnp.asarray(DATA), jnp.asarray(LENS))
    return np.asarray(rank), np.asarray(Tt)


def _inputs(lc, lp, pb, fb, seed):
    """Random pairs (lengths 0..fb, distances -1, below 128, up to 2^30),
    probabilities in the coder's band, and a rep0 trace up to W + 300 (a
    source before the block where it passes the position)."""
    rng = np.random.default_rng(seed)
    L = DATA.shape[0]
    ld = rng.integers(0, fb + 1, (L, W, M)).astype(np.int32)
    dd = np.where(rng.random((L, W, M)) < 0.5, rng.integers(-1, 128, (L, W, M)),
                  rng.integers(128, 1 << 30, (L, W, M))).astype(np.int32)
    S = ProbLayout(lc, lp, pb, pos_bits=pb).size
    probs = rng.integers(32, 2017, (L, S)).astype(np.int32)
    r0pos = rng.integers(0, W + 300, (L, W)).astype(np.int32)
    r0pos[0, ::3] = rng.integers(0, 4, r0pos[0, ::3].shape)   # near sources
    return ld, dd, probs, r0pos


def _jax_rows(lc, lp, pb, fb, ld, dd, probs, r0pos):
    rank, Tt = _suffix(fb)
    dj, lj, r0j = jnp.asarray(DATA), jnp.asarray(LENS), jnp.asarray(r0pos)
    ldj, ddj = jnp.asarray(ld), jnp.asarray(dd)
    model = jp.build_price_model(dj, jnp.asarray(probs), lc, lp, pb, fb,
                                 r0pos=r0j)
    dcost = jp._pair_dist_cost(model, ddj, (ldj >= 2) & (ddj >= 0))
    replen = jax.vmap(lambda r, t, rp, n: jm.rep_match_lens_rmq(r, t, rp, n, fb)
                      )(jnp.asarray(rank), jnp.asarray(Tt), r0j, lj)
    packed = jp._pack_inputs(dj, ldj, ddj, dcost, model, r0j, replen, fb)
    return np.transpose(np.asarray(packed), (2, 0, 1))      # (L, N, C)


def _port_args(lc, lp, pb, fb, ld, dd, probs, r0pos):
    rank, Tt = _suffix(fb)
    planes = tp._price_planes(T(probs))
    tables = tp.price_tables(*planes, lc, lp, pb)
    return (T(DATA), T(ld), T(dd), T(r0pos), (T(rank).long(), T(Tt)),
            T(LENS), planes, (tables["ps_price"], tables["dfull"],
                              tables["align_price"]), lc, lp, pb, fb)


@pytest.mark.parametrize("fb", [5, 32, 273])
@pytest.mark.parametrize("preset", list(PRESETS))
def test_plain_rows_match_jax_pack_inputs(preset, fb):
    lc, lp, pb = PRESETS[preset]
    assert JLayout(lc, lp, pb, pos_bits=pb).literal == \
        ProbLayout(lc, lp, pb, pos_bits=pb).literal
    inputs = _inputs(lc, lp, pb, fb, seed=fb * 7 + lc)
    want = _jax_rows(lc, lp, pb, fb, *inputs)
    got = cuda_inputs.dp_inputs_cuda(*_port_args(lc, lp, pb, fb, *inputs))
    assert got.dtype == torch.int32 and got.shape == (6, W, 6 * M + 5)
    np.testing.assert_array_equal(got.numpy(), want)
    # the rep0 lengths saw sources before the block and inside it
    r0pos = inputs[3]
    src = np.arange(W) - r0pos - 1
    assert (src < 0).any() and (want[:, :, 6 * M + 3] > 0).any()


@pytest.mark.parametrize("preset", list(PRESETS))
def test_int32_planes_give_the_same_tables_and_rows(preset):
    """The card's route prices from int32 planes: the same prices, the
    same DP tables and the same rows as from the CPU's int64 planes."""
    lc, lp, pb = PRESETS[preset]
    inputs = _inputs(lc, lp, pb, 32, seed=11 + lc)
    args = list(_port_args(lc, lp, pb, 32, *inputs))
    planes32 = tp._price_planes(T(inputs[2]), torch.int32)
    assert all(p.dtype == torch.int32 for p in planes32)
    for p32, p64 in zip(planes32, args[6]):
        assert p64.dtype == torch.int64 and torch.equal(p32.long(), p64)
    t32 = tp.price_tables(*planes32, lc, lp, pb)
    t64 = tp.price_tables(*args[6], lc, lp, pb)
    for k, v in t64.items():
        assert torch.equal(t32[k].long(), v), k
    assert torch.equal(tp._dp_tables(t32, 32), tp._dp_tables(t64, 32))
    want = tp._dp_inputs_plain(*args)
    args[6] = planes32
    args[7] = (t32["ps_price"], t32["dfull"], t32["align_price"])
    assert torch.equal(tp._dp_inputs_plain(*args), want)


def test_placements_on_the_h100():
    """K12 stages only the row stage and the distance tables (the literal
    slots are read from device memory at every lc and lp): its shared
    bytes do not depend on lc and lp, and its grid's four blocks fit an
    H100 SM's 228 KB (1 KB more a block) at M 1 to 6, the DP's M_DP 4
    among them."""
    sm = 233_472
    assert cuda_inputs.smem_bytes(M) == 4 * (256 * 29 + 4 + 784)
    for m in (1, 2, 4, 6, 8):
        assert cuda_inputs.smem_bytes(m) == 4 * (256 * (6 * m + 5) + 4 + 784)
        assert (4 * (cuda_inputs.smem_bytes(m) + 1024) <= sm) == (m <= 6)
    assert tp.M_DP == M


# ------------------------------------------------ the closed form by g++
HOST_LOOP = r"""
#include "dp_input_row.cuh"

extern "C" void rows_host(const uint8_t* data, const int64_t* ld,
                          const int64_t* dd, const int64_t* r0pos,
                          const int64_t* rank, const int32_t* T, int levels,
                          const int64_t* lens, const int32_t* ep0,
                          const int32_t* ep1, int64_t S, int64_t lit_base,
                          const int32_t* tables, int n_lanes, int64_t n_pos,
                          int m, int lc, int lp, int32_t* out) {
  const int C = 6 * m + 5;
  for (int lane = 0; lane < n_lanes; ++lane) {
    const int64_t base = lane * n_pos;
    dp_input_row::Lane ln;
    ln.data = data + base;
    ln.ld = ld + base * m;
    ln.dd = dd + base * m;
    ln.r0pos = r0pos + base;
    ln.ep0 = ep0 + lane * S + lit_base;
    ln.ep1 = ep1 + lane * S + lit_base;
    ln.tables = tables + lane * dp_input_row::kTableInts;
    ln.sfx = search_list::Lane{};
    ln.sfx.rank = rank + base;
    ln.sfx.T = T + base * levels;
    ln.sfx.max_n = n_pos;
    ln.n_pos = n_pos;
    ln.len = lens[lane];
    ln.m = m;
    ln.lc = lc;
    ln.lp = lp;
    ln.pairs16 = false;
    for (int64_t i = 0; i < n_pos; ++i) dp_input_row::row(ln, i, out + (base + i) * C);
  }
}
"""


@pytest.fixture(scope="module")
def host_rows(tmp_path_factory):
    """csrc/dp_input_row.cuh built by g++ into a serial host loop."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no C++ toolchain")
    work = tmp_path_factory.mktemp("rows_host")
    src, lib = work / "rows_host.cpp", work / "librows_host.so"
    src.write_text(HOST_LOOP)
    subprocess.run([gxx, "-std=c++17", "-O1", "-Wall", "-Werror", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(lib), str(src)], check=True)
    return ctypes.CDLL(str(lib))


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


@pytest.mark.parametrize("preset,fb", [("lc3lp0pb2", 32), ("lc8lp4pb4", 273),
                                       ("lc0lp2pb0", 5)])
def test_host_rows_equal_the_plain_rows(host_rows, preset, fb):
    lc, lp, pb = PRESETS[preset]
    inputs = _inputs(lc, lp, pb, fb, seed=fb + 3 * lc)
    args = _port_args(lc, lp, pb, fb, *inputs)
    want = tp._dp_inputs_plain(*args).numpy()
    data, ld, dd, r0pos, (rank, Tt), lens, planes, tables = args[:8]
    arr = [np.ascontiguousarray(t.numpy()) for t in
           (data, ld.long(), dd.long(), r0pos.long(), rank, lens.long())]
    ep = [np.ascontiguousarray(p.numpy().astype(np.int32)) for p in planes]
    tab = np.ascontiguousarray(np.concatenate(
        [t.reshape(t.shape[0], -1).numpy() for t in tables], axis=1
    ).astype(np.int32))
    t_np = np.ascontiguousarray(Tt.numpy())
    L, N = data.shape
    S = ep[0].shape[1]
    got = np.full((L, N, 6 * M + 5), -7, np.int32)
    i64 = ctypes.c_longlong
    host_rows.rows_host(*(_ptr(a) for a in arr[:5]), _ptr(t_np), t_np.shape[1],
                        _ptr(arr[5]), _ptr(ep[0]), _ptr(ep[1]), i64(S),
                        i64(ProbLayout(lc, lp, pb, pos_bits=pb).literal),
                        _ptr(tab), L, i64(N), M, lc, lp, _ptr(got))
    np.testing.assert_array_equal(got, want)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """On CPU tensors dp_inputs_cuda is _dp_inputs_plain and counts no
    launch; the optimal route's rounds call it (stage "dp_inputs");
    another device raises."""
    from lzma_tpu_torch.ops.device_encoder import probing
    from lzma_tpu_torch.ops.device_parser import tokenize_optimal

    args = _port_args(3, 0, 2, 32, *_inputs(3, 0, 2, 32, seed=1))
    before = cuda_inputs.LAUNCHES
    assert torch.equal(cuda_inputs.dp_inputs_cuda(*args),
                       tp._dp_inputs_plain(*args))
    with probing() as probe:
        tokenize_optimal(T(DATA[:2, :256]), T(LENS[:2]).clamp(max=256), 256,
                         lc=3, lp=0, pb=2, fb=32)
    assert cuda_inputs.LAUNCHES == before
    assert len(probe["seconds"]["dp_inputs"]) == tp.N_ITER
    assert probe["dp_inputs"][0].shape == (2, 256, 6 * M + 5)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError):
        cuda_inputs.dp_inputs_cuda(*meta)
