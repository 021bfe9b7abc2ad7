"""classify_tokens whole (K19's contract) on the CPU.

``cuda_classify.classify_tokens_cuda`` is K19 on the card: K6's scan grids
reading the (N, T) token planes through their strides and a finish grid
writing the seven int64 planes.  Its plain version
(``device_encoder._classify_tokens_plain``, which ``classify_tokens``
takes for CPU tensors) is held here to JAX's ``classify_tokens`` on
numpy-seeded token streams, exactly: literals, reps 0-3, short reps, the
EOS marker, invalid tokens inside a lane and after its last token, t_pos
at 0 and at max_n - 1 (and the EOS marker's at max_n), a match whose
rep0 reaches back to position 0 and one past it.  Then
``csrc/classify_meta.cuh``, the finish's closed forms, built by g++ into a
serial host loop over the plain carry's rows, gives ``_classify_finish``'s
seven planes on the same tokens (no g++ skips that).  The finish over
K6's wrapper's carry (``cuda_classify.classify_carry_cuda``, its CPU
route) is classify_tokens too: K19's plain check on the card reuses that
carry.
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
from lzma_tpu_torch.ops import cuda_classify  # noqa: E402
from lzma_tpu_torch.ops import device_encoder as tde  # noqa: E402

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "lzma_tpu_torch", "csrc")
EOS = tde.EOS_DIST
#: distances drawn from a small pool, so that reps 1-3 come up often
POOL = np.array([0, 1, 2, 3, 5, 8, 13, 40])


def _streams(seed, N=6, max_n=96, T=90):
    """N lanes of max_n bytes (a 4-letter alphabet) and their (N, T)
    token planes: lane 0 by hand (a literal at 0, a match reaching back
    before 0, then a literal whose rep0 points at position 0, a literal
    at max_n - 1, the EOS marker at max_n), the others drawn (literals,
    fresh matches, reps of the pool with lengths 1 to 5, some with the
    EOS marker), every lane padded past its last token with drawn invalid
    tokens, and some lanes with invalid tokens inside."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 4, (N, max_n)).astype(np.uint8)
    t_pos = rng.integers(0, max_n + 1, (N, T))
    t_len = rng.integers(0, 6, (N, T))
    t_dist = rng.choice(np.concatenate([POOL, [-1, EOS]]), (N, T))
    t_valid = np.zeros((N, T), bool)
    hand = [(0, 1, -1), (1, 1, -1), (2, 2, 3), (4, 1, -1), (5, 3, 40),
            (8, 1, 5), (9, 1, -1)]
    for k, (p, ln, d) in enumerate(hand):
        t_pos[0, k], t_len[0, k], t_dist[0, k] = p, ln, d
    k = len(hand)
    t_pos[0, k:k + 2], t_len[0, k:k + 2] = [max_n - 1, max_n], [1, 2]
    t_dist[0, k:k + 2] = [-1, EOS]
    t_valid[0, :k + 2] = True
    for lane in range(1, N):
        pos, k = 0, 0
        while pos < max_n and k < T - 1:
            r = rng.random()
            if r < 0.35:
                ln, d = 1, -1
            elif r < 0.75:
                ln, d = int(rng.integers(1, 6)), int(rng.choice(POOL))
            else:
                ln, d = int(rng.integers(2, 6)), int(rng.integers(0, pos + 3))
            ln = min(ln, max_n - pos)
            t_pos[lane, k], t_len[lane, k], t_dist[lane, k] = pos, ln, d
            t_valid[lane, k] = True
            pos, k = pos + ln, k + 1
        if lane % 2 and k < T:
            t_pos[lane, k], t_len[lane, k], t_dist[lane, k] = pos, 2, EOS
            t_valid[lane, k] = True
    holes = t_valid.copy()
    holes[2, 3::7] = False
    holes[4, 1::4] = False
    return data, (t_pos, t_len, t_dist), (t_valid, holes)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_classify_tokens_equals_jax(seed):
    data, planes, valids = _streams(seed)
    for valid in valids:
        want = jde.classify_tokens(*(jnp.asarray(a) for a in
                                     (data, *planes, valid)))
        got = tde.classify_tokens(*_torch(data, *planes, valid))
        assert len(got) == 7
        for name, g, w in zip(("kind", "rep_idx", "state_before",
                               "match_mode", "match_byte", "prev_byte",
                               "lit_byte"), got, want):
            assert g.dtype == torch.int64 and g.shape == planes[0].shape
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)
        # every case of the scan comes up: literal, match, rep0-rep3 and
        # the short reps
        case = tde._classify_carry(*tde._classify_rows(
            *_torch(planes[1], planes[2], valid)))[0].T
        v = torch.from_numpy(valid)
        assert set(case[v].tolist()) == {0, 1, 2, 3, 4, 5}
        assert bool((v & (case >= 1) & (case <= 4)
                     & (torch.from_numpy(planes[1]) < 2)).any())


def test_classify_tokens_cuda_takes_the_plain_version_on_the_cpu():
    data, planes, valids = _streams(4)
    args = _torch(data, *planes, valids[1])
    before = cuda_classify.TOKEN_LAUNCHES
    got = cuda_classify.classify_tokens_cuda(*args)
    want = tde._classify_tokens_plain(*args)
    assert cuda_classify.TOKEN_LAUNCHES == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    # the planes as the rounds give them: sliced views, int32 lengths
    t_pos, t_len, t_dist, t_valid = (torch.cat([a, a[:, :5]], dim=1)[:, :-5]
                                     for a in args[1:])
    got = cuda_classify.classify_tokens_cuda(args[0], t_pos, t_len.int(),
                                             t_dist, t_valid)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cuda_classify.classify_tokens_cuda(*(a.to("meta") for a in args))


def test_finish_on_k6_carry_is_classify_tokens():
    data, planes, valids = _streams(5)
    for valid in valids:
        args = _torch(data, *planes, valid)
        before = cuda_classify.LAUNCHES
        carry = cuda_classify.classify_carry_cuda(
            *tde._classify_rows(*args[2:]))
        assert cuda_classify.LAUNCHES == before
        got = tde._classify_finish(args[0], args[1], args[3], carry)
        want = tde.classify_tokens(*args)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------- classify_meta.cuh by g++
HOST_LOOP = r"""
#include <cstdint>
#include "classify_meta.cuh"

// the finish over the carry's (T, N) rows, a token at a time, into the
// (7, N, T) planes
extern "C" void finish_host(const uint8_t* data, int64_t max_n,
                            const int64_t* pos, const int64_t* dist,
                            const int32_t* case_r, const int32_t* state_r,
                            const int32_t* r0_r, int n_lanes, int n_tok,
                            int64_t* out) {
  const int64_t plane = static_cast<int64_t>(n_lanes) * n_tok;
  for (int l = 0; l < n_lanes; ++l) {
    for (int j = 0; j < n_tok; ++j) {
      const int64_t e = static_cast<int64_t>(j) * n_lanes + l;
      const int64_t t = static_cast<int64_t>(l) * n_tok + j;
      int64_t v[classify_meta::kPlanes];
      classify_meta::finish(case_r[e], classify_meta::is_literal(dist[t]),
                            state_r[e], r0_r[e], pos[t], data + l * max_n,
                            max_n, v);
      for (int k = 0; k < classify_meta::kPlanes; ++k) out[k * plane + t] = v[k];
    }
  }
}
"""


@pytest.fixture(scope="module")
def host_finish(tmp_path_factory):
    """csrc/classify_meta.cuh built by g++ into a serial host loop."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no C++ toolchain")
    work = tmp_path_factory.mktemp("classify_meta_host")
    src, lib = work / "finish_host.cpp", work / "libfinish_host.so"
    src.write_text(HOST_LOOP)
    subprocess.run([gxx, "-std=c++17", "-O1", "-Wall", "-Werror", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).finish_host
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 5 \
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    return fn


@pytest.mark.parametrize("seed", [1, 6])
def test_finish_closed_forms_equal_the_plain_finish(host_finish, seed):
    data, planes, valids = _streams(seed, N=5, max_n=70, T=64)
    for valid in valids:
        d, t_pos, t_len, t_dist, v = _torch(data, *planes, valid)
        carry = tde._classify_carry(*tde._classify_rows(t_len, t_dist, v))
        want = tde._classify_finish(d, t_pos, t_dist, carry)
        N, T = t_pos.shape
        out = torch.empty((7, N, T), dtype=torch.int64)
        t_pos, t_dist = t_pos.long().contiguous(), t_dist.long().contiguous()
        host_finish(d.data_ptr(), d.shape[1], t_pos.data_ptr(),
                    t_dist.data_ptr(), *(c.data_ptr() for c in carry), N, T,
                    out.data_ptr())
        for k, w in enumerate(want):
            assert torch.equal(out[k], w), k
