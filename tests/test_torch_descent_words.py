"""K16's refinement by words (``csrc/lazy_search.cuh``) on the CPU.

K16 (``cuda_lazy.descent_lcp_cuda``) takes the consecutive LCP at full
depth by the binary descent over the group levels and then the <=32-byte
refinement.  Where neither suffix's last word reaches 2 max_n
(``words_inside``), the refinement reads the two 32-byte windows as
words (``refine_words``: ``search_list::window_words`` and
``consecutive_lcp_words``); elsewhere (the clamp breaks the window) it
keeps the byte-at-a-time ``refine``.  In a lane past 508 places it
compares the first 32-byte keys first and reads no id where they
differ, which holds for levels whose ids are equal exactly where their
keys are (the doubling's, K15's).  Built by g++ into serial host
loops, both paths and the whole of ``deep_lcp`` are held to the plain
version ``device_matcher._descent_lcp_plain`` (and ``refine_words`` to
``refine`` wherever ``words_inside`` holds), on random orders with random
group levels (equal ids common, the descent reaching every length up to
480) at max_n 1, 2, 3, 17, 33 and 508 and the doubling's own levels at
509, 510, 600 and 2,051, with lanes of n = max_n, n below max_n
and n = 0 (places at and past n), windows that cross max_n, a + l past
2 max_n, and depths 5, 32 and 273 (no level read, and four); then on
the real doubling levels of bench data, runs and text.  No g++ skips
them.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from lzma_tpu_torch.bench.corpus import text_part
from lzma_tpu_torch.ops import cuda_lazy
from lzma_tpu_torch.ops import device_matcher as tm

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "lzma_tpu_torch", "csrc")
MAX_NS = (1, 2, 3, 17, 33, 508, 509, 510, 600, 2051)
#: lazy_search.cuh kWideLane: wider lanes read their first 32-byte keys first
WIDE = cuda_lazy.WIDE_LANE
#: depth -> the group levels the descent reads (its levels but the last)
DEPTHS = {5: 0, 32: 0, 273: 4}

HOST = r"""
#include <cstdint>
#include "lazy_search.cuh"

using namespace lazy_search;

// the kernel's body, a place at a time; path: 0 where the first 32-byte
// keys differ in a wide lane (no id read), 1 the descent and the word
// windows, 2 the descent and the byte path
extern "C" void descent_words_host(const int64_t* order,
                                   const int64_t* const* levels, int n_levels,
                                   const uint8_t* data, const int64_t* n,
                                   int depth, int lanes, int max_n,
                                   int64_t* cl, int64_t* path) {
  for (int l = 0; l < lanes; ++l) {
    const int64_t at = static_cast<int64_t>(l) * max_n;
    const int64_t* g[kMaxLevels];
    for (int t = 0; t < n_levels; ++t) g[t] = levels[t] + at;
    for (int i = 0; i < max_n; ++i) {
      const int a = static_cast<int>(order[at + i]);
      const int b = static_cast<int>(order[at + (i == 0 ? max_n - 1 : i - 1)]);
      cl[at + i] = deep_lcp(g, n_levels, data + at, max_n, n[l], i, a, b,
                            depth);
      const bool head = max_n > kWideLane &&
                        refine_words(data + at, max_n, n[l], a, b, 0) < kWindow;
      path[at + i] = head ? 0
                     : words_inside(max_n, a, b,
                                    descend(g, n_levels, max_n, a, b)) ? 1 : 2;
    }
  }
}

// refine_words against refine at given (a, b, l) where words_inside holds
// (-1 where it does not)
extern "C" void refine_pair_host(const uint8_t* row, int max_n, int64_t n,
                                 const int* a, const int* b, const int* l,
                                 int count, int* words, int* bytes) {
  for (int k = 0; k < count; ++k) {
    const bool in = words_inside(max_n, a[k], b[k], l[k]);
    words[k] = in ? refine_words(row, max_n, n, a[k], b[k], l[k]) : -1;
    bytes[k] = refine(row, max_n, n, a[k], b[k], l[k]);
  }
}
"""


@pytest.fixture(scope="module")
def host():
    """csrc/lazy_search.cuh's K16 closed forms built by g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no C++ toolchain")
    import tempfile

    work = tempfile.mkdtemp(prefix="descent_words_")
    src, lib = os.path.join(work, "host.cpp"), os.path.join(work, "libhost.so")
    with open(src, "w") as f:
        f.write(HOST)
    subprocess.run([gxx, "-std=c++17", "-O1", "-Wall", "-Werror", "-shared",
                    "-fPIC", "-I", CSRC, "-o", lib, src], check=True)
    yield ctypes.CDLL(lib)
    shutil.rmtree(work, ignore_errors=True)


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


def _lanes(max_n, seed):
    """Four lanes of max_n bytes: a 2-letter alphabet (long LCPs), all
    zeros, a period-7 pattern, random bytes; n = max_n, max_n - max_n // 3
    (places past n), 0 and max_n."""
    rng = np.random.default_rng(seed)
    data = np.stack([
        rng.integers(0, 2, max_n),
        np.zeros(max_n, np.int64),
        np.tile(rng.integers(0, 256, 7), max_n // 7 + 1)[:max_n],
        rng.integers(0, 256, max_n)]).astype(np.uint8)
    n = np.array([max_n, max_n - max_n // 3, 0, max_n], np.int64)
    return data, n


def _random_levels(N, max_n, count, seed):
    """`count` + 1 planes of ids (the last is not read), each from a small
    alphabet so that equal ids, and so the descent's steps, are common;
    a random order a lane."""
    rng = np.random.default_rng(seed)
    order = np.stack([rng.permutation(max_n) for _ in range(N)]).astype(np.int64)
    grps = [rng.integers(0, 2 + (t % 2), (N, max_n)).astype(np.int64)
            for t in range(count + 1)]
    return order, grps


def _levels(data, n, count, seed):
    """A random order a lane and `count` + 1 levels: random ids in lanes of
    at most WIDE places (the descent and its clamps on any ids), the
    doubling's own in wider ones (the kernel reads a wide lane's first
    32-byte keys first and relies on the levels' ids being equal exactly
    where their keys are)."""
    N, max_n = data.shape
    order, grps = _random_levels(N, max_n, count, seed)
    if max_n > WIDE:
        grps = _real_levels(data, n)[1][:count + 1]
    return order, grps


def _host_descent(host, order, grps, data, n, depth):
    N, max_n = data.shape
    read = [np.ascontiguousarray(g) for g in grps[:-1]]
    ptrs = (ctypes.c_void_p * max(1, len(read)))(*(g.ctypes.data for g in read))
    cl = np.full((N, max_n), -7, np.int64)
    path = np.full((N, max_n), -1, np.int64)
    host.descent_words_host(_ptr(np.ascontiguousarray(order)), ptrs, len(read),
                            _ptr(np.ascontiguousarray(data)),
                            _ptr(np.ascontiguousarray(n)), depth, N, max_n,
                            _ptr(cl), _ptr(path))
    return cl, path


def _plain(order, grps, data, n, depth):
    return tm._descent_lcp_plain(
        torch.from_numpy(order), [torch.from_numpy(g) for g in grps],
        torch.from_numpy(data), torch.from_numpy(n), depth).numpy()


@pytest.mark.parametrize("depth", list(DEPTHS))
@pytest.mark.parametrize("max_n", MAX_NS)
def test_host_descent_equals_the_plain_version(host, max_n, depth):
    """deep_lcp (in a wide lane the first keys first, then words where
    words_inside holds, bytes elsewhere) = the plain descent, on random
    orders; every path taken where the lane allows it."""
    data, n = _lanes(max_n, seed=max_n)
    order, grps = _levels(data, n, DEPTHS[depth], seed=max_n + depth)
    got, path = _host_descent(host, order, grps, data, n, depth)
    np.testing.assert_array_equal(got, _plain(order, grps, data, n, depth))
    took = set(np.unique(path).tolist())
    if max_n <= 14:
        assert took == {2}           # every window reaches 2 max_n
    elif max_n > WIDE:
        assert took == {0, 1}        # no word reaches 2 max_n
    else:
        assert took and took <= {1, 2}  # no key read first
    if max_n == 17 and depth == 32:
        assert took == {1, 2}        # windows inside, and reaching 2 max_n


@pytest.mark.parametrize("max_n", [17, 33, 509, 600, 2051])
def test_refine_words_equals_refine_where_words_inside(host, max_n):
    """Every (a, b, l) with l a multiple of 32 up to 480: where no word
    reaches 2 max_n, the word path gives the byte path's length, windows
    that cross max_n and places at and past n among them."""
    data, n = _lanes(max_n, seed=3 * max_n)
    rng = np.random.default_rng(max_n)
    a = rng.integers(0, max_n, 4000).astype(np.int32)
    b = np.where(rng.random(4000) < 0.5, (a + rng.integers(1, 40, 4000)) % max_n,
                 rng.integers(0, max_n, 4000)).astype(np.int32)
    a[:64] = max_n - 1 - np.arange(64) % min(max_n, 40)  # windows across max_n
    l = (32 * rng.integers(0, 16, 4000)).astype(np.int32)
    for lane in range(data.shape[0]):
        row = np.ascontiguousarray(data[lane])
        words = np.zeros(4000, np.int32)
        bytes_ = np.zeros(4000, np.int32)
        host.refine_pair_host(_ptr(row), max_n, ctypes.c_int64(int(n[lane])),
                              _ptr(a), _ptr(b), _ptr(l), 4000, _ptr(words),
                              _ptr(bytes_))
        inside = words >= 0
        assert inside.any() and (max_n > 508 or not inside.all())
        np.testing.assert_array_equal(words[inside], bytes_[inside])
        crossing = inside & ((a + l) % max_n + 32 > max_n)
        assert crossing.any()


def _real_levels(data, n, depth=273):
    """The plain doubling's order and levels (_suffix_rank_lcp's pieces)."""
    d, nn = torch.from_numpy(data), torch.from_numpy(n)
    keys = tm._search_keys_plain(d, nn, 32, [])[0]
    order = tm._sort_packed(keys)
    g, key = tm._doubling_groups_plain(order, d, nn, next_span=32)
    grps, span = [g], 32
    while span < depth:
        order = torch.sort(key, dim=1, stable=True).indices
        g, key = tm._doubling_groups_plain(order, d, nn, g, span,
                                           2 * span if 2 * span < depth else 0)
        grps.append(g)
        span *= 2
    return order.numpy(), [x.numpy() for x in grps]


@pytest.mark.parametrize("max_n", [3, 40, 509, 3000])
def test_host_descent_on_real_levels(host, max_n):
    """The real 273-deep doubling of text, runs past 273 bytes and a
    period-20 pattern (long LCPs: the descent reaches 480)."""
    rng = np.random.default_rng(9)
    text = np.frombuffer(text_part()[:max_n].ljust(max_n, b"x"), np.uint8)
    runs = np.where(np.arange(max_n) % 700 < 600, 97,
                    rng.integers(0, 256, max_n)).astype(np.uint8)
    period = np.tile(rng.integers(0, 256, 20), max_n // 20 + 1)[:max_n]
    data = np.stack([text, runs, period.astype(np.uint8)])
    n = np.array([max_n, max_n - max_n // 4, max_n], np.int64)
    order, grps = _real_levels(data, n)
    got, path = _host_descent(host, order, grps, data, n, 273)
    want = _plain(order, grps, data, n, 273)
    np.testing.assert_array_equal(got, want)
    if max_n > WIDE:
        assert want.max() == 273
        assert set(np.unique(path).tolist()) == {0, 1}


def test_constants_match_the_sources():
    """The wrapper's lane limit and wide-lane width are the kernel's
    (csrc/lazy_search.cu kMaxPlaces, lazy_search.cuh kWideLane)."""
    import re

    with open(os.path.join(CSRC, "lazy_search.cu")) as f:
        cu = f.read()
    with open(os.path.join(CSRC, "lazy_search.cuh")) as f:
        cuh = f.read()
    assert cuda_lazy.MAX_PLACES == 1 << int(
        re.search(r"kMaxPlaces = 1LL << (\d+);", cu).group(1))
    assert WIDE == int(re.search(r"kWideLane = (\d+);", cuh).group(1))
