"""The parse path's marking (K13) and compaction (K14), on the CPU.

The plain versions the kernels are held to on the card
(``device_parser._extract_mark`` and ``_extract_compact``, which make
``extract_tokens``; ``device_matcher._greedy_mark`` and
``_compact_taken``, which make ``greedy_path`` and ``_compact``) against
the JAX package's ``extract_tokens``, ``greedy_path`` and ``_compact``,
exactly: an all-literal path, a path of 273-long matches, random DP
paths at fb 5 and 273, lanes of length 0 and 1, a preset start > 0, lazy
and greedy.  Then K13's and K14's tile designs (``csrc/path.cu``, restated
in numpy in tests/test_torch_path_tiles.py: the tiles' door maps composed
along the lane, each entered tile marked from its entry; the tickets,
look-back and staged writes) give the plain versions' marks and tokens
at tiles of 4, 16 and 4,096 nodes.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lzma_tpu.ops import device_matcher as jm  # noqa: E402
from lzma_tpu.ops import device_parser as jp  # noqa: E402
from lzma_tpu_torch.ops import device_matcher as tm  # noqa: E402
from lzma_tpu_torch.ops import device_parser as tp  # noqa: E402

N = 1024          # positions a lane; the DP's nodes are 0..N
MATCH_MAX = 273


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def eq(got, ref, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(ref), err_msg=msg)


def _dp_graph(fb, seed):
    """Six lanes of a DP's (from, choice) over N + 1 nodes: all literals,
    273-long matches, random edges of 1..fb with lens 700 (the nodes past
    it point to themselves, as the scan leaves them), lens 0, lens 1,
    random edges with lens N."""
    rng = np.random.default_rng(seed)
    NP = N + 1
    node = np.arange(NP)
    frm = np.empty((6, NP), np.int32)
    frm[0] = np.maximum(node - 1, 0)
    frm[1] = np.where(node >= MATCH_MAX, node - MATCH_MAX, np.maximum(node - 1, 0))
    for lane in (2, 3, 4, 5):
        frm[lane] = np.maximum(node - rng.integers(1, fb + 1, NP), 0)
    frm[2, 701:] = node[701:]
    frm[:, 0] = 0
    lens = np.array([N, N, 700, 0, 1, N], np.int32)
    choice = rng.integers(-1, 1 << 20, (6, NP)).astype(np.int32)
    return frm, choice, lens


def _lazy_lists(seed):
    """Five lanes of best (len, dist): no matches, 273-long matches
    everywhere, a random mix (lengths 0..273, many short), the mix with
    n 700, and n 0."""
    rng = np.random.default_rng(seed)
    bl = np.zeros((5, N), np.int32)
    bl[1] = MATCH_MAX
    mix = np.where(rng.random(N) < 0.5, rng.integers(0, 4, N),
                   rng.integers(2, MATCH_MAX + 1, N))
    bl[2] = bl[3] = mix
    bl[4] = mix[::-1]
    bd = rng.integers(0, 1 << 17, (5, N)).astype(np.int32)
    n = np.array([N, N, N, 700, 0], np.int32)
    return bl, bd, n


@pytest.mark.parametrize("fb", [5, 273])
def test_extract_tokens_match_jax(fb):
    frm, choice, lens = _dp_graph(fb, seed=fb)
    want = jp.extract_tokens(jnp.asarray(frm), jnp.asarray(choice),
                             jnp.asarray(lens))
    mark = tp._extract_mark(T(frm), T(lens))
    got = tp._extract_compact(T(frm), T(choice), mark)
    for name, g, w in zip(("t_pos", "t_len", "t_dist", "t_valid", "ntok"),
                          got, want):
        eq(g, w, name)
    for g, w in zip(tp.extract_tokens(T(frm), T(choice), T(lens)), got):
        eq(g, w)
    assert int(got[4][0]) == N and int(got[4][3]) == 0 and int(got[4][4]) == 1
    assert int(got[4][1]) == N // MATCH_MAX + N % MATCH_MAX


@pytest.mark.parametrize("start", [0, 300])
@pytest.mark.parametrize("lazy", [True, False])
def test_greedy_path_and_compact_match_jax(start, lazy):
    bl, bd, n = _lazy_lists(seed=start + lazy)
    jl, jd, jn = jnp.asarray(bl), jnp.asarray(bd), jnp.asarray(n)
    on = jax.vmap(lambda a, b, k: jm.greedy_path(a, b, k, N, start, lazy))(
        jl, jd, jn)
    want = jax.vmap(lambda a, b, o, k: jm._compact(a, b, o, k, lazy))(
        jl, jd, on, jn)
    tbl, tbd, tn = T(bl).long(), T(bd).long(), T(n)
    eq(tm.greedy_path(tbl, tbd, tn, N, start, lazy), on, "on_path")
    take, adv = tm._decide(tbl, tbd, lazy)
    t_on = tm._greedy_mark(adv, tn, start)
    eq(t_on, on, "_greedy_mark")
    got = tm._compact_taken(tbl, tbd, take, t_on)
    for name, g, w in zip(("t_pos", "t_len", "t_dist", "t_valid", "ntok"),
                          got, want):
        eq(g, w, name)
    for g, w in zip(tm._compact(tbl, tbd, t_on, tn, lazy), got):
        eq(g, w)


# ------------------------------------------------ the kernels' tile designs
# K13's and K14's designs restated in numpy (tests/test_torch_path_tiles.py)
from test_torch_path_tiles import (SMALL, design_compact, design_mark,  # noqa: E402
                                   dp_values, greedy_values)

TILES = {4: "tile4", 16: "tile16", 4096: "tile4096"}


@pytest.mark.parametrize("tile", [4, 16, 4096])
def test_tile_designs_equal_the_plain_extract(tile):
    sz = SMALL[TILES[tile]]
    for fb in (5, 273):
        frm, choice, lens = _dp_graph(fb, seed=fb + 1)
        mark = tp._extract_mark(T(frm), T(lens)).numpy()
        got = tp._extract_compact(T(frm), T(choice), T(mark))
        node = np.arange(frm.shape[1])
        for lane in range(frm.shape[0]):
            reach, status = design_mark(frm[lane], lens[lane], False, sz)
            assert status == [0, 0]
            kept = reach & (node > 0) & (node <= lens[lane])
            eq(kept, mark[lane], f"fb {fb} lane {lane} marks")
        for g, w in zip(design_compact(mark, dp_values(frm, choice), sz,
                                       seed=fb), got):
            eq(g, w, f"fb {fb} tokens")


@pytest.mark.parametrize("tile", [4, 16, 4096])
def test_tile_designs_equal_the_plain_greedy(tile):
    sz = SMALL[TILES[tile]]
    bl, bd, n = _lazy_lists(seed=tile)
    tbl, tbd = T(bl).long(), T(bd).long()
    take, adv = tm._decide(tbl, tbd, True)
    pos = np.arange(N)
    for start in (0, 300):
        on = tm._greedy_mark(adv, T(n), start).numpy()
        got = tm._compact_taken(tbl, tbd, take, T(on))
        for lane in range(bl.shape[0]):
            f = np.append(np.minimum(pos + adv[lane].numpy(), N), N)
            reach, status = design_mark(f, start, True, sz)
            assert status == [0, 0]
            kept = reach[:N] & (pos < n[lane])
            eq(kept, on[lane], f"start {start} lane {lane} marks")
        for g, w in zip(design_compact(on, greedy_values(bl, bd, take.numpy()),
                                       sz, seed=start), got):
            eq(g, w, f"start {start} tokens")


def test_tile_walk_refuses_a_walk_back_into_a_passed_tile():
    f = np.arange(64)
    f[40] = 3            # tile 10 -> tile 0, then 3 -> 50 (tile 12): back
    f[3] = 50
    f[50] = 40
    assert design_mark(f, 50, False, SMALL["tile4"])[1] == [0, 1]
    # the plain version takes any pointers: the reached set
    reach = tp._extract_mark(torch.from_numpy(f[None].astype(np.int32)),
                             torch.tensor([50]))
    eq(reach[0].nonzero()[:, 0], [3, 40, 50])


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors the four wrappers are the plain versions and count
    no launch, through the optimal and the lazy routes too; another
    device raises."""
    from lzma_tpu_torch.ops import cuda_path

    before = (cuda_path.MARK_LAUNCHES, cuda_path.COMPACT_LAUNCHES)
    frm, choice, lens = (T(a) for a in _dp_graph(32, seed=3))
    mark = cuda_path.extract_mark_cuda(frm, lens)
    assert torch.equal(mark, tp._extract_mark(frm, lens))
    for g, w in zip(cuda_path.extract_compact_cuda(frm, choice, mark),
                    tp._extract_compact(frm, choice, mark)):
        assert torch.equal(g, w)
    bl, bd, n = (T(a).long() for a in _lazy_lists(seed=3))
    take, adv = tm._decide(bl, bd, True)
    on = cuda_path.greedy_mark_cuda(adv, n, 7)
    assert torch.equal(on, tm._greedy_mark(adv, n, 7))
    for g, w in zip(cuda_path.greedy_compact_cuda(bl, bd, take, on),
                    tm._compact_taken(bl, bd, take, on)):
        assert torch.equal(g, w)
    data = torch.from_numpy(np.frombuffer(bytes(range(256)) * 2, np.uint8)
                            .reshape(2, 256).copy())
    tm.tokenize(data, torch.tensor([256, 100]), 256, 32)
    tp.tokenize_optimal(data, torch.tensor([256, 100]), 256, lc=3, lp=0,
                        pb=2, fb=32)
    assert (cuda_path.MARK_LAUNCHES, cuda_path.COMPACT_LAUNCHES) == before
    with pytest.raises(ValueError):
        cuda_path.extract_mark_cuda(frm.to("meta"), lens.to("meta"))
    with pytest.raises(ValueError):
        cuda_path.greedy_compact_cuda(bl, bd, take, on.to("meta"))
