"""The bit lowering (K7's contract) on the CPU.

The port's plain ``lower_tokens`` (``device_encoder._lower_tokens_plain``
behind ``cuda_lower.lower_tokens_cuda``) is held to the JAX package's
``lzma_tpu.ops.device_encoder.lower_tokens`` with exact equality of ctx,
bits and total, on hand-built token streams (numpy, seeded) and the
meta of JAX's ``classify_tokens``: the EOS marker (slot 63), distances
in slots 0-3, 4-13 (spec_pos) and >= 14 up to 2^27 and past it on a
small buffer (classify's gathers clamp alike), rep0-rep3 and the short
rep, lengths 2, 9, 17 and 273, matched literals, lanes with gaps in
their valid tokens, an all-literal lane, an empty lane, lc8 lp4 pb4
with a preset (pos_base), T == 0, and max_bits equal to the longest
lane's total.  One bit less raises in the port (the reference drops
bits silently); so do more long tokens than the compacted buffer holds.

The kernel's own per-token arithmetic (``csrc/lower_token.cuh``, the
closed forms K7's grids run) is built by g++ into a serial host
lowering and held to the plain version on the same inputs; those tests
skip without g++.  The kernel itself is held to the plain version on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lzma_tpu.ops import device_encoder as jde  # noqa: E402
from lzma_tpu_torch.ops import cuda_lower  # noqa: E402
from lzma_tpu_torch.ops.device_encoder import (EOS_DIST, K_LIT,  # noqa: E402
                                               K_MATCH, K_REP, MAXB,
                                               lower_tokens)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "lzma_tpu_torch", "csrc")
LENS = (2, 9, 17, 273)


# ---------------------------------------------------------------- inputs
def _lane(rng, n_tok, mode):
    """One lane's tokens (pos, len, dist) from position 0: a literal is
    (len 1, dist -1); reps reuse one of the generator's own last four
    distances (classify decides the real rep index)."""
    reps = [0, 0, 0, 0]
    pos, out = 0, []
    for _ in range(n_tok):
        r = rng.random()
        if mode == "lit" or (mode == "mixed" and r < 0.35):
            out.append((pos, 1, -1))
            pos += 1
            continue
        if (mode == "reps" and r > 0.3) or (mode == "mixed" and r < 0.6):
            idx = int(rng.integers(4))
            d = reps[idx]
            ln = 1 if idx == 0 and rng.random() < 0.3 else int(
                rng.choice(LENS) if rng.random() < 0.5 else rng.integers(2, 274))
            reps = [d] + reps[:idx] + reps[idx + 1:]
        else:
            band = int(rng.integers(5))
            d = int((rng.integers(0, 4), rng.integers(4, 128),
                     rng.integers(128, 1 << 20), rng.integers(1 << 20, 1 << 27),
                     rng.integers(1 << 27, 1 << 31))[band])
            ln = int(rng.choice(LENS) if rng.random() < 0.5
                     else rng.integers(2, 274))
            reps = [d] + [x for x in reps if x != d][:3]
            while len(reps) < 4:
                reps.append(0)
        out.append((pos, ln, d))
        pos += ln
    return out, pos


def _tokens(seed, T, modes, eos=(), gaps=(), pos_base=0):
    """(data, t_pos, t_len, t_dist, t_valid) numpy, N = len(modes) lanes
    of T token slots; lanes in `eos` end with the EOS marker, lanes in
    `gaps` have invalid tokens among their valid ones; pads as the
    compaction pads (pos 0, len 1, dist -1).  Positions are absolute:
    the first pos_base bytes of data are a preset."""
    rng = np.random.default_rng(seed)
    N = len(modes)
    t_pos = np.zeros((N, T), np.int32)
    t_len = np.ones((N, T), np.int32)
    t_dist = np.full((N, T), -1, np.int32)
    t_valid = np.zeros((N, T), bool)
    ends = []
    for i, mode in enumerate(modes):
        # at most T // 2 tokens, as a parse of T positions has at most
        # T // 2 + 1 of two bytes or more
        n = 0 if mode == "empty" else T // 2 - (1 if i in eos else 0) - 3 * i
        toks, end = _lane(rng, n, mode)
        if i in eos:
            toks.append((end, 2, EOS_DIST))
        for j, (p, ln, d) in enumerate(toks):
            t_pos[i, j], t_len[i, j], t_dist[i, j] = p + pos_base, ln, d
        t_valid[i, :len(toks)] = True
        if i in gaps:
            t_valid[i, :len(toks)] &= rng.random(len(toks)) > 0.1
        ends.append(end)
    # a small alphabet, so literals often share a prefix with their match byte
    data = rng.choice(np.array([0x41, 0x42, 0x61, 0xC3], np.uint8),
                      size=(N, pos_base + max(ends) + 1))
    return data, t_pos, t_len, t_dist, t_valid


def _jax_meta(data, t_pos, t_len, t_dist, t_valid):
    meta = jde.classify_tokens(jnp.asarray(data), jnp.asarray(t_pos),
                               jnp.asarray(t_len), jnp.asarray(t_dist),
                               jnp.asarray(t_valid))
    return tuple(np.array(m) for m in meta)


def _port(meta, t_pos, t_len, t_dist, t_valid, lc, lp, pb, max_bits,
          pos_base=0):
    tt = [torch.from_numpy(np.ascontiguousarray(a)) for a in
          (t_pos, t_len, t_dist, t_valid)]
    return lower_tokens(None, tuple(torch.from_numpy(m).long() for m in meta),
                        *tt, lc, lp, pb, max_bits, pos_base=pos_base)


def _jax(data, meta, t_pos, t_len, t_dist, t_valid, lc, lp, pb, max_bits,
         pos_base=0):
    out = jde.lower_tokens(jnp.asarray(data), tuple(jnp.asarray(m) for m in meta),
                           jnp.asarray(t_pos), jnp.asarray(t_len),
                           jnp.asarray(t_dist), jnp.asarray(t_valid), lc, lp,
                           pb, max_bits, pos_base=pos_base)
    return tuple(np.array(x) for x in out)


MODES = ("mixed", "mixed", "lit", "empty", "reps", "match")
SHAPES = {
    # name: (seed, T, modes, eos lanes, gap lanes, lc, lp, pb, pos_base)
    "lc3lp0pb2": (5, 600, MODES, (0, 5), (1,), 3, 0, 2, 0),
    "lc8lp4pb4_preset": (9, 320, ("mixed", "reps", "match"), (2,), (), 8, 4,
                         4, 101),
}


@pytest.fixture(scope="module", params=sorted(SHAPES))
def case(request):
    """Inputs, JAX's meta, the fitting max_bits (the longest lane's
    total) and JAX's lowering at it, a shape each."""
    seed, T, modes, eos, gaps, lc, lp, pb, pos_base = SHAPES[request.param]
    data, *tok = _tokens(seed, T, modes, eos, gaps, pos_base)
    meta = _jax_meta(data, *tok)
    _, _, total = _port(meta, *tok, lc, lp, pb, MAXB * T + 128, pos_base)
    max_bits = int(total.max())
    want = _jax(data, meta, *tok, lc, lp, pb, max_bits, pos_base)
    return dict(data=data, tok=tok, meta=meta, lc=lc, lp=lp, pb=pb,
                pos_base=pos_base, max_bits=max_bits, want=want, T=T)


def test_inputs_cover_the_closed_forms(case):
    """The hand-built streams reach every branch the kernel's closed
    forms take (checked on JAX's meta)."""
    kind, rep_idx, state, match_mode = case["meta"][:4]
    t_pos, t_len, t_dist, t_valid = case["tok"]
    v = t_valid
    assert (kind[v] == K_LIT).any() and (kind[v] == K_MATCH).any()
    rep = v & (kind == K_REP)
    assert set(rep_idx[rep].tolist()) == {0, 1, 2, 3}
    assert (rep & (t_len < 2)).any()                       # short rep
    assert (v & (kind == K_LIT) & (match_mode > 0)).any()  # matched literal
    long_ = v & (kind != K_LIT) & (t_len >= 2)
    assert {2, 9, 17, 273} <= set(t_len[long_].tolist())
    m = v & (kind == K_MATCH)
    assert (m & (t_dist >= 0) & (t_dist < 4)).any()
    assert (m & (t_dist >= 4) & (t_dist < 128)).any()     # spec_pos slots
    assert (m & (t_dist >= 1 << 27)).any()                 # past 2^27
    if case["T"] == 600:
        assert (m & (t_dist == EOS_DIST)).any()
        assert not v[3].any() and (kind[2][v[2]] == K_LIT).all()


def test_plain_lowering_equals_jax(case):
    got = _port(case["meta"], *case["tok"], case["lc"], case["lp"], case["pb"],
                case["max_bits"], case["pos_base"])
    for name, g, w in zip(("ctx", "bits", "total"), got, case["want"]):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    # max_bits is the longest lane's total: nothing of the stream is fill
    assert int(got[2].max()) == case["max_bits"]


def test_plain_lowering_raises_one_bit_short(case):
    with pytest.raises(ValueError, match="exceed"):
        _port(case["meta"], *case["tok"], case["lc"], case["lp"], case["pb"],
              case["max_bits"] - 1, case["pos_base"])


@pytest.mark.parametrize("N,T", [(2, 0), (0, 5)])
def test_plain_lowering_of_no_tokens_fills_the_stream(N, T):
    """No token slots, or no lanes: every slot is fill and every total 0
    (the reference's lowering cannot take T == 0: its max over the token
    axis has no identity)."""
    tok = (np.zeros((N, T), np.int32), np.ones((N, T), np.int32),
           np.full((N, T), -1, np.int32), np.zeros((N, T), bool))
    meta = tuple(np.zeros((N, T), np.int32) for _ in range(7))
    ctx, bits, total = _port(meta, *tok, 3, 0, 2, 40)
    assert ctx.shape == bits.shape == (N, 40) and total.shape == (N,)
    assert (ctx == -1).all() and (bits == 0).all() and (total == 0).all()


def _long_overflow():
    """One lane of T = 10 slots, 8 of them matches: more long tokens than
    the T // 2 + 2 = 7 the compacted buffer holds (no parse gives that;
    the reference drops the eighth's bits)."""
    T = 10
    t_pos = np.arange(T, dtype=np.int64)[None] * 3
    t_len = np.full((1, T), 3, np.int64)
    t_dist = np.full((1, T), 7, np.int64)
    t_valid = np.zeros((1, T), bool)
    t_valid[0, :8] = True
    meta = [np.zeros((1, T), np.int64) for _ in range(7)]
    meta[0][:] = K_MATCH
    meta[1][:] = 3
    return tuple(meta), t_pos, t_len, t_dist, t_valid


def test_plain_lowering_raises_on_long_overflow():
    meta, *tok = _long_overflow()
    with pytest.raises(ValueError, match="long tokens"):
        _port(meta, *tok, 3, 0, 2, 1000)


def test_lower_tokens_takes_the_plain_version_on_the_cpu(case, monkeypatch):
    """A CPU tensor never reaches the kernel's library; another device
    raises."""
    def no_kernel():
        raise AssertionError("the CPU path loaded the kernel")

    monkeypatch.setattr(cuda_lower, "_kernel", no_kernel)
    before = cuda_lower.LAUNCHES
    _port(case["meta"], *case["tok"], case["lc"], case["lp"], case["pb"],
          case["max_bits"], case["pos_base"])
    assert cuda_lower.LAUNCHES == before
    meta = tuple(torch.zeros((1, 2), dtype=torch.int64, device="meta")
                 for _ in range(7))
    tok = [torch.zeros((1, 2), dtype=torch.int64, device="meta")] * 3
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cuda_lower.lower_tokens_cuda(
            meta, *tok, torch.zeros((1, 2), dtype=torch.bool, device="meta"),
            3, 0, 2, 64)


# ----------------------------------------------- the kernel's arithmetic
HOST_DRIVER = r"""
#include <cstdint>
#include <cstring>

#include "lower_token.cuh"

// K7's lowering serially on the host, token by token, on contiguous
// (n_lanes, n_tok) int64 planes: the kernel's statuses, totals, pairs
// and fill from the same per-token functions.  Status bits 4 and 8: a
// token emitted a pair out of order or past its row, or other than
// nbits pairs (never written).
extern "C" int lzt_lower_host(const long long* const* p, const uint8_t* valid,
                              const int* layout, long long pos_base,
                              int n_lanes, int n_tok, long long max_bits,
                              int* ctx, int* bits, int* total) {
  using namespace lower_token;
  Layout L;
  std::memcpy(&L, layout, sizeof(Layout));
  int status = 0;
  for (int n = 0; n < n_lanes; ++n) {
    long long sum = 0, longs = 0;
    int* c_row = ctx + n * max_bits;
    int* b_row = bits + n * max_bits;
    for (int pass = 0; pass < 2; ++pass) {
      long long off = 0;
      for (int t = 0; t < n_tok; ++t) {
        const long long e = static_cast<long long>(n) * n_tok + t;
        if (!valid[e]) continue;
        Token k;
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
        const Geo g = geometry(k);
        if (pass == 0) {
          sum += g.nbits;
          longs += is_long(g) ? 1 : 0;
          continue;
        }
        int n = 0;
        emit(k, g, L, [&](int j, int c, int b) {
          if (j != n++ || off + j >= max_bits) {
            status |= 4;   // out of order or past the row: not written
            return;
          }
          c_row[off + j] = c;
          b_row[off + j] = b;
        });
        if (n != g.nbits) status |= 8;
        off += g.nbits;
      }
      if (pass == 0) {
        total[n] = static_cast<int>(sum);
        if (longs > n_tok / 2 + 2) status |= 2;
        if (sum > max_bits) {
          status |= 1;
          break;
        }
      }
    }
    if (sum <= max_bits) {
      for (long long i = sum; i < max_bits; ++i) {
        c_row[i] = kCtxDirect;
        b_row[i] = 0;
      }
    }
  }
  return status;
}
"""


@pytest.fixture(scope="module")
def host_lowering(tmp_path_factory):
    """csrc/lower_token.cuh built by g++ into a serial host lowering."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no C++ toolchain")
    work = tmp_path_factory.mktemp("lower_host")
    src, lib = work / "lower_host.cpp", work / "liblower_host.so"
    src.write_text(HOST_DRIVER)
    subprocess.run([gxx, "-std=c++17", "-O1", "-Wall", "-Werror", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).lzt_lower_host
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 2 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int

    def run(meta, t_pos, t_len, t_dist, t_valid, lc, lp, pb, max_bits,
            pos_base=0):
        planes = [np.ascontiguousarray(a, dtype=np.int64)
                  for a in (*meta, t_pos, t_len, t_dist)]
        valid = np.ascontiguousarray(t_valid, dtype=np.uint8)
        N, T = valid.shape
        ptrs = (ctypes.c_void_p * 10)(*(a.ctypes.data for a in planes))
        layout = np.array(cuda_lower.layout_ints(lc, lp, pb), np.int32)
        ctx = np.zeros((N, max_bits), np.int32)
        bits = np.zeros((N, max_bits), np.int32)
        total = np.zeros(N, np.int32)
        status = fn(ptrs, valid.ctypes.data, layout.ctypes.data, pos_base, N,
                    T, max_bits, ctx.ctypes.data, bits.ctypes.data,
                    total.ctypes.data)
        return status, ctx, bits, total

    return run


def test_kernel_token_arithmetic_equals_the_plain_version(case, host_lowering):
    args = (case["meta"], *case["tok"], case["lc"], case["lp"], case["pb"])
    for max_bits in (case["max_bits"], case["max_bits"] + 77):
        status, *got = host_lowering(*args, max_bits, case["pos_base"])
        want = _port(*args, max_bits, case["pos_base"])
        assert status == 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())
    status, _, _, total = host_lowering(*args, case["max_bits"] - 1,
                                        case["pos_base"])
    assert status == 1 and int(total.max()) == case["max_bits"]


def test_kernel_token_arithmetic_flags_long_overflow(host_lowering):
    meta, *tok = _long_overflow()
    status, _, _, _ = host_lowering(meta, *tok, 3, 0, 2, 1000)
    assert status == 2
