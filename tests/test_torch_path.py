"""The parse path's marking (K13) and compaction (K14), on the CPU.

The plain versions the kernels are held to on the card
(``device_parser._extract_mark`` and ``_extract_compact``, which make
``extract_tokens``; ``device_matcher._greedy_mark`` and
``_compact_taken``, which make ``greedy_path`` and ``_compact``) against
the JAX package's ``extract_tokens``, ``greedy_path`` and ``_compact``,
exactly: an all-literal path, a path of 273-long matches, random DP
paths at fb 5 and 273, lanes of length 0 and 1, a preset start > 0, lazy
and greedy.  Then K13's and K14's tile designs (``csrc/path.cu``)
restated in numpy -- each tile's exits by pointer doubling, the walk over
the tiles' exits, each entered tile's marks by doubling again from its
entry; the tiles' counts, their scan and each tile's scatter -- give the
plain versions' marks and tokens at tiles of 4, 16 and 4,096 nodes.
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
def _jump(p):
    """One synchronous doubling of a tile's relative pointers."""
    inside = (p >= 0) & (p < len(p))
    return np.where(inside, p[np.clip(p, 0, len(p) - 1)], p)


def tile_mark(f, start, tile, forward):
    """K13's three grids on one lane, restated: f (n_nodes,) pointers that
    run forward (the lazy path) or backward (the DP's).  Returns the
    reached set (n_nodes,) bool; raises where the walk goes back into a
    tile it has left (the kernel's status bit)."""
    n_nodes = len(f)
    n_tiles = -(-n_nodes // tile)
    rounds = (tile - 1).bit_length() + 1
    exits = np.empty(n_nodes, np.int64)
    for t in range(n_tiles):                                # grid 1
        lo = t * tile
        p = f[lo:lo + tile] - lo
        for _ in range(rounds):
            p = _jump(p)
        exits[lo:lo + tile] = p + lo
    entry = np.full(n_tiles, -1)                            # grid 2
    cur = start
    t = cur // tile
    while True:
        entry[t] = cur
        nx = exits[cur]
        if nx // tile == t:
            break
        if (nx // tile < t) if forward else (nx // tile > t):
            raise ValueError("back into a passed tile")
        cur, t = nx, nx // tile
    reach = np.zeros(n_nodes, bool)
    for t in np.nonzero(entry >= 0)[0]:                     # grid 3
        lo = t * tile
        p = f[lo:lo + tile] - lo
        r = np.zeros(len(p), bool)
        r[entry[t] - lo] = True
        for _ in range(rounds):
            q = p[r & (p >= 0) & (p < len(p))]
            r[q] = True
            p = _jump(p)
        reach[lo:lo + tile] = r
    return reach


def tile_compact(mark, tile):
    """K14's slots on one lane, restated: each tile's count, their
    exclusive scan, then each tile's own scan.  Returns (the slot of each
    marked node, ntok)."""
    counts = [int(mark[lo:lo + tile].sum()) for lo in range(0, len(mark), tile)]
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    slot = np.full(len(mark), -1)
    for t, lo in enumerate(range(0, len(mark), tile)):
        m = mark[lo:lo + tile]
        slot[lo:lo + tile][m] = offsets[t] + np.arange(int(m.sum()))
    return slot, int(sum(counts))


@pytest.mark.parametrize("tile", [4, 16, 4096])
def test_tile_designs_equal_the_plain_extract(tile):
    for fb in (5, 273):
        frm, choice, lens = _dp_graph(fb, seed=fb + 1)
        mark = tp._extract_mark(T(frm), T(lens)).numpy()
        got = tp._extract_compact(T(frm), T(choice), T(mark))
        node = np.arange(frm.shape[1])
        for lane in range(frm.shape[0]):
            reach = tile_mark(frm[lane].astype(np.int64), int(lens[lane]), tile,
                              False)
            kept = reach & (node > 0) & (node <= lens[lane])
            eq(kept, mark[lane], f"fb {fb} lane {lane} marks")
            slot, ntok = tile_compact(kept, tile)
            assert ntok == int(got[4][lane])
            on = slot >= 0
            eq(got[0][lane, slot[on]], frm[lane, on])
            eq(got[1][lane, slot[on]], node[on] - frm[lane, on])
            eq(got[2][lane, slot[on]], choice[lane, on])


@pytest.mark.parametrize("tile", [4, 16, 4096])
def test_tile_designs_equal_the_plain_greedy(tile):
    bl, bd, n = _lazy_lists(seed=tile)
    tbl, tbd = T(bl).long(), T(bd).long()
    take, adv = tm._decide(tbl, tbd, True)
    pos = np.arange(N)
    for start in (0, 300):
        on = tm._greedy_mark(adv, T(n), start).numpy()
        got = tm._compact_taken(tbl, tbd, take, T(on))
        for lane in range(bl.shape[0]):
            f = np.append(np.minimum(pos + adv[lane].numpy(), N), N)
            reach = tile_mark(f, start, tile, True)[:N]
            kept = reach & (pos < n[lane])
            eq(kept, on[lane], f"start {start} lane {lane} marks")
            slot, ntok = tile_compact(kept, tile)
            assert ntok == int(got[4][lane])
            tk = take[lane].numpy() & kept
            eq(got[0][lane, slot[kept]], pos[kept])
            eq(got[1][lane, slot[kept]], np.where(tk, bl[lane], 1)[kept])
            eq(got[2][lane, slot[kept]], np.where(tk, bd[lane], -1)[kept])


def test_tile_walk_refuses_a_walk_back_into_a_passed_tile():
    f = np.arange(64)
    f[40] = 3            # tile 10 -> tile 0, then 3 -> 50 (tile 12): back
    f[3] = 50
    f[50] = 40
    with pytest.raises(ValueError):
        tile_mark(f, 50, 4, False)
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
