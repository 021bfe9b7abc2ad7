"""lzma_tpu_torch's lazy tokenizer against lzma_tpu's, on the CPU.

The same numpy inputs go through jax.vmap(device_matcher.tokenize) and
through the port's lane-batched tokenize; the codec is integer-only, so
every token array must be exactly equal (tolerance zero).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lzma_tpu.bench.datagen import generate_bench_data  # noqa: E402
from lzma_tpu.ops import device_matcher as jm  # noqa: E402
from lzma_tpu_torch.ops import device_matcher as tm  # noqa: E402


def _lanes(max_n, seed):
    """Bench data, text-like repeats, incompressible, all-zero lanes."""
    rng = np.random.default_rng(seed)
    rows = [
        np.frombuffer(generate_bench_data(max_n), np.uint8),
        np.frombuffer((b"the quick brown fox, " * (max_n // 8))[:max_n], np.uint8),
        rng.integers(0, 256, max_n).astype(np.uint8),
        np.zeros(max_n, np.uint8),
    ]
    return np.stack(rows)


def _jax_tokens(data, lens, dict_size, fb, k=4, lazy=True):
    out = jax.vmap(lambda d, n: jm.tokenize(d, n, dict_size, fb, k, lazy=lazy))(
        jnp.asarray(data), jnp.asarray(lens))
    return [np.asarray(a) for a in out]


def _torch_tokens(data, lens, dict_size, fb, k=4, lazy=True):
    out = tm.tokenize(torch.from_numpy(data), torch.from_numpy(lens),
                      dict_size, fb, k, lazy=lazy)
    return [a.numpy() for a in out]


def _assert_equal(ref, got):
    names = ("t_pos", "t_len", "t_dist", "t_valid", "ntok")
    for name, r, g in zip(names, ref, got):
        np.testing.assert_array_equal(g, r, err_msg=name)


@pytest.mark.parametrize("fb", [5, 32, 273])
def test_tokenize_matches_jax_across_fast_bytes(fb):
    data = _lanes(2048, seed=fb)
    lens = np.array([2048, 2048, 1500, 2048], np.int32)
    _assert_equal(_jax_tokens(data, lens, 2048, fb),
                  _torch_tokens(data, lens, 2048, fb))


def test_tokenize_dict_smaller_than_block():
    data = _lanes(2048, seed=3)
    lens = np.full(4, 2048, np.int32)
    _assert_equal(_jax_tokens(data, lens, 100, 32),
                  _torch_tokens(data, lens, 100, 32))


@pytest.mark.parametrize("max_n", [16, 64, 256])
def test_tokenize_tiny_blocks_and_short_lanes(max_n):
    # n < 4 leaves no hashable window; tiny buckets make the suffix
    # descent step past twice the row (the reference clamps the gather)
    rng = np.random.default_rng(max_n)
    data = np.stack([np.zeros(max_n, np.uint8), np.full(max_n, 7, np.uint8),
                     rng.integers(0, 2, max_n).astype(np.uint8)])
    lens = np.array([3, max_n - 1, max_n], np.int32)
    _assert_equal(_jax_tokens(data, lens, max_n, 273),
                  _torch_tokens(data, lens, max_n, 273))


@pytest.mark.parametrize("k,lazy", [(1, False), (4, False), (8, True)])
def test_tokenize_candidates_and_greedy(k, lazy):
    data = _lanes(1024, seed=11)
    lens = np.full(4, 1024, np.int32)
    _assert_equal(_jax_tokens(data, lens, 1024, 32, k, lazy),
                  _torch_tokens(data, lens, 1024, 32, k, lazy))


def test_best_matches_and_path_match_jax():
    data = _lanes(1024, seed=5)
    lens = np.array([1024, 900, 1024, 10], np.int32)
    bl, bd = jax.vmap(lambda d, n: jm.find_best_matches_rmq(d, n, 512, 32, 4))(
        jnp.asarray(data), jnp.asarray(lens))
    tbl, tbd = tm.find_best_matches_rmq(torch.from_numpy(data),
                                        torch.from_numpy(lens), 512, 32, 4)
    np.testing.assert_array_equal(tbl.numpy(), np.asarray(bl))
    np.testing.assert_array_equal(tbd.numpy(), np.asarray(bd))
    on = jax.vmap(lambda a, b, n: jm.greedy_path(a, b, n, 1024, 0, True))(
        bl, bd, jnp.asarray(lens))
    ton = tm.greedy_path(tbl, tbd, torch.from_numpy(lens), 1024, 0, True)
    np.testing.assert_array_equal(ton.numpy(), np.asarray(on))


def test_lexsort_rows_is_stable_and_lexicographic():
    rng = np.random.default_rng(0)
    keys = [rng.integers(0, 3, (2, 64)).astype(np.int64) for _ in range(3)]
    keys[2][0, :5] = 0xFFFFFFFF                    # the top of the uint32 range
    order = tm._lexsort_rows([torch.from_numpy(k) for k in keys]).numpy()
    for row in range(2):
        ref = np.lexsort(tuple([np.arange(64)] + [k[row] for k in keys]))
        np.testing.assert_array_equal(order[row], ref)


def test_bit_length_is_exact_at_powers_of_two():
    x = torch.tensor([1, 2, 3, 4, 255, 256, (1 << 31) - 1, 1 << 31, 0xFFFFFFFF])
    assert tm._bit_length(x).tolist() == [int(v).bit_length() for v in x]
