"""The lowering's slot counts (K8's contract) on the CPU.

The optimal parse's rounds take only the slot counts of the current
tokens' lowering: ``device_encoder.lower_counts`` (the plain
``_lower_counts_plain`` behind ``cuda_lower.lower_counts_cuda``) and
then ``device_parser.probs_from_counts``.  Both are held to the JAX
package's ``empirical_probs(lower_tokens(...))`` with exact equality
(the counts to a numpy count of JAX's lowered pairs, the probabilities
as int32), on hand-built token streams (test_torch_lower.py's: the EOS
marker, every slot band, rep0-rep3 and the short rep, matched literals,
gaps, all-literal and empty lanes) at lc0 lp0 pb0 and lc8 lp4 pb4 with
a preset (pos_base > 0), and on the lazy and the optimal parse's tokens
of 8 lanes of 1 KiB at lc3 lp0 pb2 with the EOS marker appended.  They
raise where the plain lowering raises.  ``tokenize_optimal`` routes its
rounds through ``lower_counts`` and still gives JAX's tokens.

The kernel's staged count over ``csrc/lower_token.cuh`` (each round's
counted pairs, the direct bits left out, scanned and staged at their
offsets, a stage at a time, then each staged pair counted under its
slot) is built by g++ into a serial host count and held to the plain
counts at the kernel's round and stage sizes and at small ones; those
tests skip without g++.  ``count_placement`` leaves room for the stage.  The kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lzma_tpu.core.layout import ProbLayout as JLayout  # noqa: E402
from lzma_tpu.ops import device_encoder as jde  # noqa: E402
from lzma_tpu.ops import device_parser as jp  # noqa: E402
from lzma_tpu_torch.bench.corpus import text_part  # noqa: E402
from lzma_tpu_torch.bench.datagen import generate_bench_data  # noqa: E402
from lzma_tpu_torch.ops import cuda_lower  # noqa: E402
from lzma_tpu_torch.ops import device_encoder as tde  # noqa: E402
from lzma_tpu_torch.ops import device_parser as tp  # noqa: E402
from lzma_tpu_torch.ops.device_decoder import pad_rows  # noqa: E402
from lzma_tpu_torch.ops.device_encoder import (  # noqa: E402
    _append_eos_tokens, _lower_counts_plain, lower_counts, tokenize)
from test_torch_lower import CSRC, _jax_meta, _long_overflow, _tokens  # noqa: E402

MODES = ("mixed", "mixed", "lit", "empty", "reps", "match", "mixed", "lit")
# lc3 lp0 pb2 is the parsed tokens' (below); each JAX lowering shape
# compiles for ~3 s
SHAPES = {
    # name: (seed, T, modes, eos lanes, gap lanes, lc, lp, pb, pos_base)
    "lc0lp0pb0": (32, 256, MODES, (0, 5), (1,), 0, 0, 0, 0),
    "lc8lp4pb4_preset": (33, 160, ("mixed", "reps", "match", "lit"), (1,),
                         (), 8, 4, 4, 77),
}


def _torch(tok, meta):
    return (tuple(torch.from_numpy(np.ascontiguousarray(m)).long()
                  for m in meta),
            *(torch.from_numpy(np.ascontiguousarray(a)) for a in tok))


def _jax_lowering(data, meta, tok, lc, lp, pb, max_bits, pos_base):
    """JAX's lowered (ctx, bits, totals) and empirical_probs of them, as
    numpy."""
    ctx, bits, totals = jde.lower_tokens(
        jnp.asarray(data), tuple(jnp.asarray(m) for m in meta),
        *(jnp.asarray(a) for a in tok), lc, lp, pb, max_bits,
        pos_base=pos_base)
    S = JLayout(lc, lp, pb, pos_bits=pb).size
    probs = jp.empirical_probs(ctx, bits, totals, S)
    return tuple(np.asarray(x) for x in (ctx, bits, totals, probs))


def _numpy_counts(ctx, bits, totals, S):
    """n and n1 of lowered streams, counted pair by pair."""
    L, B = ctx.shape
    n = np.zeros((L, S), np.int64)
    n1 = np.zeros((L, S), np.int64)
    for i in range(L):
        c, b = ctx[i, :totals[i]], bits[i, :totals[i]]
        keep = c >= 0
        np.add.at(n[i], c[keep], 1)
        np.add.at(n1[i], c[keep], b[keep])
    return n, n1


@pytest.fixture(scope="module", params=sorted(SHAPES))
def case(request):
    """Hand-built tokens, JAX's meta, the fitting max_bits (the longest
    lane's total) and JAX's lowering and probabilities at it."""
    seed, T, modes, eos, gaps, lc, lp, pb, pos_base = SHAPES[request.param]
    data, *tok = _tokens(seed, T, modes, eos, gaps, pos_base)
    meta = _jax_meta(data, *tok)
    _, _, total = _lower_counts_plain(*_torch(tok, meta), lc, lp, pb,
                                      50 * T + 128, pos_base)
    max_bits = int(total.max())
    want = _jax_lowering(data, meta, tok, lc, lp, pb, max_bits, pos_base)
    return dict(tok=tok, meta=meta, lc=lc, lp=lp, pb=pb, pos_base=pos_base,
                max_bits=max_bits, want=want,
                S=JLayout(lc, lp, pb, pos_bits=pb).size)


def _counts(case, max_bits=None):
    return lower_counts(*_torch(case["tok"], case["meta"]), case["lc"],
                        case["lp"], case["pb"],
                        case["max_bits"] if max_bits is None else max_bits,
                        case["pos_base"])


def _assert_equal_to_jax(got, want, S):
    ctx, bits, totals, probs = want
    n, n1, total = got
    assert n.dtype == n1.dtype == total.dtype == torch.int32
    assert n.shape == n1.shape == (len(totals), S)
    np.testing.assert_array_equal(total.numpy(), totals, err_msg="total")
    wn, wn1 = _numpy_counts(ctx, bits, totals, S)
    np.testing.assert_array_equal(n.numpy(), wn, err_msg="n")
    np.testing.assert_array_equal(n1.numpy(), wn1, err_msg="n1")
    got_probs = tp.probs_from_counts(n, n1)
    assert probs.dtype == np.int32
    np.testing.assert_array_equal(got_probs.numpy().astype(np.int32), probs,
                                  err_msg="probs")


def test_plain_counts_and_probs_equal_jax(case):
    got = _counts(case)
    _assert_equal_to_jax(got, case["want"], case["S"])
    # a roomier stream counts the same pairs
    for g, w in zip(_counts(case, case["max_bits"] + 333), got):
        assert torch.equal(g, w)


def test_plain_counts_raise_where_the_lowering_raises(case):
    with pytest.raises(ValueError, match="exceed"):
        _counts(case, case["max_bits"] - 1)
    meta, *tok = _long_overflow()
    with pytest.raises(ValueError, match="long tokens"):
        lower_counts(tuple(torch.from_numpy(m) for m in meta),
                     *(torch.from_numpy(a) for a in tok), case["lc"],
                     case["lp"], case["pb"], 1000)


def test_lower_counts_takes_the_plain_version_on_the_cpu(case, monkeypatch):
    """A CPU tensor never reaches the kernel's library; another device
    raises."""
    def no_kernel():
        raise AssertionError("the CPU path loaded the kernel")

    monkeypatch.setattr(cuda_lower, "_count_kernel", no_kernel)
    before = cuda_lower.COUNT_LAUNCHES
    _counts(case)
    assert cuda_lower.COUNT_LAUNCHES == before
    z = torch.zeros((1, 2), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cuda_lower.lower_counts_cuda(
            tuple(z for _ in range(7)), z, z, z,
            torch.zeros((1, 2), dtype=torch.bool, device="meta"), 3, 0, 2, 64)


@pytest.mark.parametrize("N,T", [(2, 0), (0, 5)])
def test_plain_counts_of_no_tokens_are_zero(N, T):
    z = torch.zeros((N, T), dtype=torch.int64)
    n, n1, total = lower_counts(tuple(z for _ in range(7)), z, z + 1, z - 1,
                                z.bool(), 3, 0, 2, 40)
    S = JLayout(3, 0, 2, pos_bits=2).size
    assert n.shape == n1.shape == (N, S) and total.shape == (N,)
    assert not n.any() and not n1.any() and not total.any()


@pytest.fixture(scope="module")
def parsed():
    """The port's lazy and optimal tokens of 8 lanes of 1 KiB (mixed
    bench data, text and an incompressible tail; one lane short), the EOS
    marker appended, on the CPU."""
    n = 1024
    rng = np.random.default_rng(5)
    bench = np.frombuffer(generate_bench_data(4 * n), np.uint8)
    text = np.frombuffer(text_part()[:4 * n], np.uint8)
    rows = [bench[i * n:(i + 1) * n] if i % 2 else text[i // 2 * n:(i // 2 + 1) * n]
            for i in range(8)]
    rows[5] = np.concatenate([rows[5][:n // 2],
                              rng.integers(0, 256, n // 2, dtype=np.uint8)])
    blocks = [r.tobytes() for r in rows]
    blocks[6] = blocks[6][:700]
    data, lens = pad_rows(blocks, "cpu")
    out = {}
    for parse in ("lazy", "optimal"):
        if parse == "lazy":
            tok = tokenize(data, lens, n, 32, 4)
        else:
            tok = tp.tokenize_optimal(data, lens, n, lc=3, lp=0, pb=2, fb=32)
        out[parse] = (data.numpy(),
                      [t.numpy() for t in _append_eos_tokens(*tok[:4], tok[4],
                                                             lens)])
    return out


@pytest.mark.parametrize("parse", ["lazy", "optimal"])
def test_plain_counts_on_parsed_tokens_with_eos_equal_jax(parsed, parse):
    data, tok = parsed[parse]
    assert (tok[2] == tde.EOS_DIST).sum() == 8
    meta = _jax_meta(data, *tok)
    max_bits = 10 * data.shape[1] + 128      # the rounds' stream
    want = _jax_lowering(data, meta, tok, 3, 0, 2, max_bits, 0)
    got = lower_counts(*_torch(tok, meta), 3, 0, 2, max_bits)
    _assert_equal_to_jax(got, want, JLayout(3, 0, 2, pos_bits=2).size)


def test_tokenize_optimal_counts_its_rounds_and_equals_jax(monkeypatch):
    """The rounds take lower_counts (twice) and no lowering's streams; the
    tokens are JAX's."""
    from test_torch_optimal import _lanes

    data, lens = _lanes(256, seed=6, short=200)
    data, lens = data[:2], lens[:2]
    kw = dict(lc=3, lp=0, pb=2, fb=16)
    calls = []

    def spy(*args):
        calls.append(args[0][0].shape)
        return lower_counts(*args)

    monkeypatch.setattr(tp, "lower_counts", spy)
    with tde.probing() as probe:
        got = tp.tokenize_optimal(torch.from_numpy(data.copy()),
                                  torch.from_numpy(lens.copy()), 256, **kw)
    want = jp.tokenize_optimal(jnp.asarray(data), jnp.asarray(lens),
                               jnp.int32(256), tiers_key=jp.DP_TIERS,
                               n_iter=2, **kw)
    for name, g, r in zip(("t_pos", "t_len", "t_dist", "t_valid", "ntok"),
                          got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    assert calls == [(2, 256)] * 2
    assert "lowered" not in probe and len(probe["count_args"]) == 10
    assert len(probe["seconds"]["lower"]) == 2


# ----------------------------------------------- the kernel's count put
HOST_DRIVER = r"""
#include <cstdint>
#include <cstring>
#include <vector>

#include "lower_token.cuh"

// K8's staged count serially on the host, on contiguous (n_lanes, n_tok)
// int64 planes: each round of `round` tokens, every valid token's counted
// pairs (lower_token::counted) scanned in token order, staged
// (stage_counted) `stage_n` words at a time and counted from the stage
// (n; n1 with bit 1), as the kernel's block walks it; the totals and
// status bits as the kernel's.  Status bit 4: a staged slot past the
// arena; 8: a stage word the round's tokens did not write.
extern "C" int lzt_counts_host(const long long* const* p,
                               const uint8_t* valid, const int* layout,
                               long long pos_base, int n_lanes, int n_tok,
                               long long max_bits, int S, int round,
                               int stage_n, int* n, int* n1, int* total) {
  using namespace lower_token;
  Layout L;
  std::memcpy(&L, layout, sizeof(Layout));
  int status = 0;
  std::vector<uint32_t> stage(stage_n);
  for (int lane = 0; lane < n_lanes; ++lane) {
    long long sum = 0, longs = 0;
    int* n_row = n + static_cast<long long>(lane) * S;
    int* n1_row = n1 + static_cast<long long>(lane) * S;
    for (int t0 = 0; t0 < n_tok; t0 += round) {
      std::vector<Token> ks(round);
      std::vector<Geo> gs(round);
      std::vector<int> ex(round), mine(round, 0);
      int pairs = 0;
      for (int i = 0; i < round && t0 + i < n_tok; ++i) {
        const long long e = static_cast<long long>(lane) * n_tok + t0 + i;
        if (!valid[e]) continue;
        Token& k = ks[i];
        k.kind = static_cast<int>(p[0][e]);
        k.rep_idx = static_cast<int>(p[1][e]);
        k.state = static_cast<int>(p[2][e]);
        k.match_mode = static_cast<int>(p[3][e]);
        k.match_byte = static_cast<int>(p[4][e]);
        k.prev_byte = static_cast<int>(p[5][e]);
        k.lit_byte = static_cast<int>(p[6][e]);
        k.coded_pos = static_cast<int>(p[7][e] - pos_base);
        k.len = static_cast<int>(p[8][e]);
        k.dist = static_cast<int>(p[9][e]);
        gs[i] = geometry(k);
        sum += gs[i].nbits;
        longs += is_long(gs[i]) ? 1 : 0;
        mine[i] = counted(gs[i]);
        ex[i] = pairs;
        pairs += mine[i];
      }
      for (int lo = 0; lo < pairs; lo += stage_n) {
        std::fill(stage.begin(), stage.end(), 0xFFFFFFFFu);
        for (int i = 0; i < round; ++i) {
          if (mine[i] && ex[i] < lo + stage_n && ex[i] + mine[i] > lo)
            stage_counted(ks[i], gs[i], L, ex[i], lo, stage_n, stage.data());
        }
        const int staged = pairs - lo < stage_n ? pairs - lo : stage_n;
        for (int q = 0; q < staged; ++q) {
          if (stage[q] == 0xFFFFFFFFu) {
            status |= 8;
            continue;
          }
          const int c = pair_slot(stage[q]);
          if (c >= S) {
            status |= 4;
            continue;
          }
          n_row[c] += 1;
          n1_row[c] += pair_bit(stage[q]);
        }
      }
    }
    total[lane] = static_cast<int>(sum);
    if (sum > max_bits) status |= 1;
    if (longs > n_tok / 2 + 2) status |= 2;
  }
  return status;
}
"""


@pytest.fixture(scope="module")
def host_counts(tmp_path_factory):
    """csrc/lower_token.cuh built by g++ into a serial host count."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no C++ toolchain")
    work = tmp_path_factory.mktemp("counts_host")
    src, lib = work / "counts_host.cpp", work / "libcounts_host.so"
    src.write_text(HOST_DRIVER)
    subprocess.run([gxx, "-std=c++17", "-O1", "-Wall", "-Werror", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).lzt_counts_host
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 2 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int

    def run(meta, t_pos, t_len, t_dist, t_valid, lc, lp, pb, max_bits,
            pos_base=0, stage=(256, 4096)):
        planes = [np.ascontiguousarray(a, dtype=np.int64)
                  for a in (*meta, t_pos, t_len, t_dist)]
        valid = np.ascontiguousarray(t_valid, dtype=np.uint8)
        N, T = valid.shape
        S = JLayout(lc, lp, pb, pos_bits=pb).size
        ptrs = (ctypes.c_void_p * 10)(*(a.ctypes.data for a in planes))
        layout = np.array(cuda_lower.layout_ints(lc, lp, pb), np.int32)
        n = np.zeros((N, S), np.int32)
        n1 = np.zeros((N, S), np.int32)
        total = np.zeros(N, np.int32)
        status = fn(ptrs, valid.ctypes.data, layout.ctypes.data, pos_base, N,
                    T, max_bits, S, *stage, n.ctypes.data, n1.ctypes.data,
                    total.ctypes.data)
        return status, n, n1, total

    return run


#: (tokens a round, stage words) of the host's staged count: K8's own
#: (kThreads, kStage), and small ones whose stage cuts most tokens' pairs
#: and most rounds into several passes
STAGES = {"kernel": (256, 4096), "small": (5, 7), "one": (3, 1)}


@pytest.mark.parametrize("stage", list(STAGES))
def test_kernel_count_put_equals_the_plain_counts(case, host_counts, stage):
    """lower_token.cuh's staged count (each round's counted pairs scanned,
    staged at their offsets and counted from the stage) gives the plain
    counts; the status bits as the plain version's raises."""
    args = (case["meta"], *case["tok"], case["lc"], case["lp"], case["pb"])
    st = STAGES[stage]
    status, *got = host_counts(*args, case["max_bits"], case["pos_base"], st)
    assert status == 0
    for g, w in zip(got, _counts(case)):
        np.testing.assert_array_equal(g, w.numpy())
    status, *_ = host_counts(*args, case["max_bits"] - 1, case["pos_base"], st)
    assert status == 1
    meta, *tok = _long_overflow()
    assert host_counts(meta, *tok, case["lc"], case["lp"], case["pb"],
                       1000, 0, st)[0] == 2


def test_count_placement_leaves_room_for_the_stage():
    """K8's histogram goes to shared memory only where it fits beside the
    block's pair stage (csrc/lower.cu kStage words): lc3 lp0 pb2's on the
    H100's 232,448 bytes, not lc8 lp4 pb4's; the boundary is the stage's."""
    import pathlib
    import re

    src = (pathlib.Path(CSRC) / "lower.cu").read_text()
    k_stage = int(re.search(r"constexpr int kStage = (\d+);", src).group(1))
    assert 4 * k_stage < cuda_lower.COUNT_STAGE_BYTES <= 4 * k_stage + 256
    limit = 232448
    assert cuda_lower.count_placement(JLayout(3, 0, 2, pos_bits=2).size,
                                      limit) == "shared"
    assert cuda_lower.count_placement(JLayout(8, 4, 4, pos_bits=4).size,
                                      limit) == "device"
    S = (limit - cuda_lower.COUNT_STAGE_BYTES) // 4
    assert cuda_lower.count_placement(S, limit) == "shared"
    assert cuda_lower.count_placement(S + 4, limit) == "device"
