"""K15's and K17's designs (``lzma_tpu_torch/csrc/lazy_search.cu``),
restated in numpy and held to the plain versions and to the JAX package,
on the CPU.

K15, a doubling level in two grids.  Grid A's blocks take tickets in
lane-major order, each a tile of places, a thread a place.  At the
32-byte level a thread's flag compares its suffix's 8 marked words, read
as ``search_list::window_words`` reads them (the 16-byte aligned chunks
that hold the window, shifted down and joined by a funnel shift; byte by
byte with a running index where the window crosses max_n), with the
place before's: a shuffle from the lane below, a warp's first lane from
the last words the warp before left in shared memory, the tile's first
thread one window more.  At a doubling level it compares its sorted key
with the place before's (no read of the previous ids: the key holds
both).  The tile scans its flags, looks back along its lane for its
first id (a warp reads 32 predecessors at a time, up to the first
prefix) under random interleavings of the blocks, and scatters each id
to its position; grid B makes the next key, the span taken mod max_n
once.  K17: a block a tile of sorted places staged with the k places
before it (key, position, the position's rank), a thread a place taking
its candidates from the stage until a key differs, the places past a
short run standing for one candidate of position -1.  Sizes: the
kernels' (tiles of 512 and 256 places, warps of 32) and cut ones (tiles
of 1-8 places, warps of 4), so that every edge is common.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lzma_tpu.ops import device_matcher as jm  # noqa: E402
from lzma_tpu_torch.bench.datagen import generate_bench_data  # noqa: E402
from lzma_tpu_torch.ops import cuda_lazy  # noqa: E402
from lzma_tpu_torch.ops import device_matcher as tm  # noqa: E402

DEPTH = tm.MATCH_MAX
MARK = 0x80000000
#: (tile, warp, look-back width) of the kernel's grid A and cut ones
K15_SIZES = {"kernel": (512, 32, 32), "tile8": (8, 4, 4), "tile3": (3, 4, 2),
             "tile1": (1, 32, 32)}


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def lanes(widths, seed):
    """Lanes of bench data, a small alphabet (long hash groups, long
    repeats) and zeros, max_n = max(widths), n = each width."""
    rng = np.random.default_rng(seed)
    max_n = max(widths)
    rows = []
    for i, w in enumerate(widths):
        kind = i % 3
        if kind == 0:
            row = np.frombuffer(generate_bench_data(max_n + i), np.uint8)[i:]
        elif kind == 1:
            row = rng.integers(0, 3, max_n).astype(np.uint8)
        else:
            row = np.zeros(max_n, np.uint8)
        rows.append(row.copy())
    return np.stack(rows), np.array(widths, np.int64)


# ------------------------------------------------------------------ K15
def ref_words(data, n):
    """The reference's 8 prefix words of every position (np.roll), word 0
    marked past n: (N, max_n, 8)."""
    N, max_n = data.shape
    b = [np.roll(data.astype(np.int64), -i, axis=1) for i in range(32)]
    words = [(b[4 * w] << 24) | (b[4 * w + 1] << 16) | (b[4 * w + 2] << 8)
             | b[4 * w + 3] for w in range(8)]
    pos = np.arange(max_n)
    words[0] = np.where(pos[None] < n[:, None], words[0], MARK ^ pos[None])
    return np.stack(words, axis=2)


def bswap32(x):
    return int.from_bytes(int(x).to_bytes(4, "little"), "big")


def window_words(buf, row_at, max_n, o, nw=8):
    """search_list::window_words on a flat byte buffer whose lane row
    starts at byte row_at: the window's aligned chunks (none past the one
    holding its last byte), shifted down off / 4 words, each word joined
    with the next by a funnel shift; a window crossing max_n byte by byte
    with a running index."""
    if o + 4 * nw <= max_n:
        at = row_at + o
        base, off = at & ~15, at & 15
        chunks = (off + 4 * nw + 15) >> 4
        w = [0] * 13
        for c in range(min(chunks, 3)):
            w[4 * c:4 * c + 4] = buf[base + 16 * c:base + 16 * c + 16].view(
                "<u4").tolist()
        if off & 4:
            w[:12] = w[1:13]
        if off & 8:
            w[:11] = w[2:13]
        s = (off & 3) * 8
        return [bswap32((((w[k + 1] << 32) | w[k]) >> s) & 0xFFFFFFFF)
                for k in range(nw)]
    out, q = [], o
    for _ in range(nw):
        x = 0
        for _ in range(4):
            x = (x << 8) | int(buf[row_at + q])
            q = q + 1 if q + 1 < max_n else 0
        out.append(x)
    return out


def laid_out(data, offset):
    """The lanes as one flat buffer, row r at offset + r * max_n, with
    room for the last chunk; returns (buffer, row start of each lane)."""
    N, max_n = data.shape
    buf = np.full(offset + N * max_n + 48, 0xA5, np.uint8)
    buf[offset:offset + N * max_n] = data.reshape(-1)
    return buf, [offset + r * max_n for r in range(N)]


def marked_words(buf, rows, max_n, n, lane, o):
    w = window_words(buf, rows[lane], max_n, o)
    if o >= n[lane]:
        w[0] = MARK ^ o
    return w


def design_groups(order, next_span, sizes, seed, sorted_key=None,
                  words=None):
    """K15's two grids on a lane group: order (L, W); `words(lane, o)` a
    suffix's marked words (the 32-byte level) or sorted_key (L, W).  The
    blocks take tickets in order and run their phases in a random
    interleaving (a look-back reads only predecessors that have
    published).  Returns (ids, key or None) and checks every position
    gets its id exactly once."""
    tile, warp, look = sizes
    L, W = order.shape
    nt = -(-W // tile)
    ids = np.full((L, W), -7, np.int64)
    written = np.zeros((L, W), int)
    state = {}
    rng = np.random.default_rng(seed)

    def block(ticket):
        lane, t = divmod(ticket, nt)
        places = range(t * tile, min((t + 1) * tile, W))
        fresh = []
        if words is not None:
            own = [words(lane, int(order[lane, i])) for i in places]
            edge = {x // warp: own[x] for x in range(len(own))
                    if x % warp == warp - 1 or x == len(own) - 1}
            for x, i in enumerate(places):
                if x % warp:
                    prev = own[x - 1]                  # the shuffle
                elif x:
                    prev = edge[x // warp - 1]         # shared memory
                elif i:
                    prev = words(lane, int(order[lane, i - 1]))  # one more
                fresh.append(i == 0 or own[x] != prev)
        else:
            for x, i in enumerate(places):
                fresh.append(i == 0 or
                             sorted_key[lane, i] != sorted_key[lane, i - 1])
        f = np.array(fresh, np.int64)
        total = int(f.sum())
        state[lane, t] = ("prefix" if t == 0 else "aggregate", total)
        yield
        before, q = 0, t - 1
        while t > 0:
            chunk = [x for x in range(q, q - look, -1) if x >= 0]
            while any((lane, x) not in state for x in chunk):
                yield                                    # spin
            seen = [state[lane, x] for x in chunk]
            for flag, v in seen:
                before += v
                if flag == "prefix":
                    break
            if any(flag == "prefix" for flag, _ in seen):
                break
            q -= look
        if t > 0:
            state[lane, t] = ("prefix", before + total)
        yield
        incl = np.cumsum(f)
        for x, i in enumerate(places):
            p = int(order[lane, i])
            ids[lane, p] = before + incl[x] - 1
            written[lane, p] += 1

    live = {}
    next_ticket = 0
    while next_ticket < nt * L or live:
        if next_ticket < nt * L and (not live or rng.random() < 0.5):
            live[next_ticket] = block(next_ticket)
            next_ticket += 1
            continue
        k = rng.choice(sorted(live))
        try:
            next(live[k])
        except StopIteration:
            del live[k]
    assert (written == 1).all()
    if not next_span:
        return ids, None
    s = next_span % W
    j = np.arange(W) + s
    j = np.where(j >= W, j - W, j)                   # a conditional subtract
    return ids, ids * W + ids[:, j]


def by_design(sizes, seed, offset=0):
    """A stand-in for doubling_groups_cuda that runs design_groups: the
    32-byte level by window words of the lanes laid out at `offset`, a
    doubling level by the sorted key the route passes."""
    def fn(order, data, n, g=None, span=0, next_span=0, sorted_key=None):
        o = order.numpy()
        if g is None:
            d, nn = data.numpy(), n.numpy()
            buf, rows = laid_out(d, offset)
            out = design_groups(o, next_span, sizes, seed, words=lambda lane, p:
                                marked_words(buf, rows, d.shape[1], nn, lane, p))
        else:
            assert sorted_key is not None and span >= 1
            out = design_groups(o, next_span, sizes, seed,
                                sorted_key=sorted_key.numpy())
        return T(out[0]), None if out[1] is None else T(out[1])
    return fn


def levels_of(data, n):
    """The route's levels with the plain pieces: (order, sorted key or
    None, span, next span, plain ids, plain key) a level."""
    d, nn = T(data), T(n)
    order = tm._sort_packed(tm._search_keys_plain(d, nn, 32, [])[0])
    g, key = tm._doubling_groups_plain(order, d, nn, next_span=32)
    out = [(order, None, 0, 32, g, key)]
    span = 32
    while span < DEPTH:
        s = torch.sort(key, dim=1, stable=True)
        nxt = 2 * span if 2 * span < DEPTH else 0
        g2, key2 = tm._doubling_groups_plain(s.indices, d, nn, g, span, nxt,
                                             s.values)
        out.append((s.indices, s.values, span, nxt, g2, key2))
        g, key, span = g2, key2, 2 * span
    return out


SHAPES = {"w300": ([300, 300, 250, 0], 1), "max_n1": ([1, 1, 0], 2),
          "max_n2": ([2, 1, 2], 3), "max_n3": ([3, 3, 2, 1], 4),
          "max_n33": ([33, 20, 33], 5), "w70": ([70, 70, 69], 6)}


@pytest.mark.parametrize("name", list(SHAPES))
def test_sorted_key_flags_equal_the_pair_gathers(name):
    """At every doubling level (spans 32-256, past max_n at max_n 1-3 and
    33) the sorted key differs from the place before's exactly where the
    reference's gathered pair (g[i], g[(i + span) mod max_n]) does, and
    the key is the previous ids' pair at the level's span."""
    data, n = lanes(*SHAPES[name])
    W = data.shape[1]
    prev = None
    for order, sk, span, _, g, key in levels_of(data, n):
        if sk is not None:
            o = order.numpy()
            gp = prev.numpy()
            hi = np.take_along_axis(gp, o, 1)
            lo = np.take_along_axis(np.roll(gp, -span, axis=1), o, 1)
            pair = (hi != np.roll(hi, 1, axis=1)) | (lo != np.roll(lo, 1, axis=1))
            flags = sk.numpy() != np.roll(sk.numpy(), 1, axis=1)
            pair[:, 0] = flags[:, 0] = True
            np.testing.assert_array_equal(flags, pair, err_msg=f"span {span}")
            np.testing.assert_array_equal(
                sk.numpy(), hi * W + lo, err_msg=f"key at span {span}")
        prev = g


@pytest.mark.parametrize("offset", [0, 1, 7, 13])
@pytest.mark.parametrize("name", ["w300", "max_n1", "max_n2", "max_n3",
                                  "max_n33", "w70"])
def test_window_words_across_the_wrap_and_past_n(name, offset):
    """window_words' words at every position, the row at every
    alignment: the reference's rolled words, across the max_n wrap (byte
    by byte) and past n (word 0 marked)."""
    data, n = lanes(*SHAPES[name])
    N, W = data.shape
    buf, rows = laid_out(data, offset)
    want = ref_words(data, n)
    got = np.array([[marked_words(buf, rows, W, n, lane, o) for o in range(W)]
                    for lane in range(N)], np.int64).reshape(N, W, 8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sizes", list(K15_SIZES))
@pytest.mark.parametrize("name", list(SHAPES))
def test_design_groups_equal_the_plain_levels(name, sizes):
    """Both grids at every level, under a random schedule, give the plain
    ids and next key."""
    data, n = lanes(*SHAPES[name])
    W = data.shape[1]
    buf, rows = laid_out(data, 5)
    for t, (order, sk, span, nxt, g, key) in enumerate(levels_of(data, n)):
        ids, k = design_groups(
            order.numpy(), nxt, K15_SIZES[sizes], seed=t,
            sorted_key=None if sk is None else sk.numpy(),
            words=None if sk is not None else
            (lambda lane, o: marked_words(buf, rows, W, n, lane, o)))
        np.testing.assert_array_equal(ids, g.numpy(), err_msg=f"level {t}")
        assert (k is None) == (key is None)
        if key is not None:
            np.testing.assert_array_equal(k, key.numpy(), err_msg=f"key {t}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lookback_under_random_schedules(seed):
    """Lanes of one tile and of many (tiles of 2 and 4 places, look-backs
    of 1-3 predecessors a read), random group flags: the ids are the
    running count of new groups, every position once."""
    rng = np.random.default_rng(seed)
    L, W = 6, 37
    order = np.stack([rng.permutation(W) for _ in range(L)])
    keys = np.sort(rng.integers(0, [[1], [2], [5], [40], [1000], [3]],
                                (L, W)), axis=1)
    flags = np.concatenate([np.ones((L, 1), bool),
                            keys[:, 1:] != keys[:, :-1]], axis=1)
    want = np.zeros((L, W), np.int64)
    np.put_along_axis(want, order, np.cumsum(flags, axis=1) - 1, axis=1)
    for sizes in ((W, 32, 32), (4, 2, 1), (2, 4, 3), (1, 1, 2)):
        ids, key = design_groups(order, 0, sizes, seed * 7 + sizes[0],
                                 sorted_key=keys)
        np.testing.assert_array_equal(ids, want, err_msg=f"{sizes}")
        assert key is None


@pytest.mark.parametrize("name", ["w300", "max_n3", "max_n33"])
def test_suffix_rank_by_the_design_equals_jax(name, monkeypatch):
    """The port's _suffix_rank_lcp with K15's wrapper replaced by the
    design (tiles of 3 places, the lanes at an odd offset): JAX's rank
    and table."""
    data, n = lanes(*SHAPES[name])
    max_n = data.shape[1]
    pos = jnp.arange(max_n, dtype=jnp.int32)
    w_rank, w_T = jax.jit(jax.vmap(lambda d, k: jm._suffix_rank_lcp(
        d, k, pos, max_n, DEPTH)))(jnp.asarray(data), jnp.asarray(n))
    monkeypatch.setattr(cuda_lazy, "doubling_groups_cuda",
                        by_design(K15_SIZES["tile3"], 11, offset=3))
    d, k = T(data), T(n)
    rank, tab = tm._suffix_rank_lcp(
        d, k, DEPTH, tm._search_keys_plain(d, k, 32, [])[0])
    np.testing.assert_array_equal(rank.numpy(), np.asarray(w_rank))
    np.testing.assert_array_equal(tab.numpy(), np.asarray(w_T))


# ------------------------------------------------------------------ K17
def lcp_ranks(Tl, max_n, rp, rq):
    """lazy_search::lcp_ranks: two reads of the lane's table (levels,
    max_n)."""
    a, b = min(rp, rq) + 1, max(rp, rq)
    w = b - a + 1
    if w < 1:
        return 0
    k = w.bit_length() - 1
    a2 = min(a + (1 << k) - 1, max_n - 1)
    return int(min(Tl[k, b], Tl[k, a2]))


def take(cand, best):
    """The selection's order: the largest sel, then the nearest, then the
    longest."""
    sel, dist, ln = cand
    top, bd, bl = best
    if sel > top or (sel == top and (dist < bd or (dist == bd and ln > bl))):
        return cand
    return best


def design_best(sorted_key, order, rank, tab, n, dict_size, fb, k, tile):
    """K17's design: a tile of `tile` places staged with the k before it,
    then a thread a place.  Returns (best_len, best_dist) and checks each
    position is written once."""
    L, W = order.shape
    bl = np.full((L, W), -7, np.int64)
    bd = np.full((L, W), -7, np.int64)
    written = np.zeros((L, W), int)
    for lane in range(L):
        for j0 in range(0, W, tile):
            first = j0 - k
            r = np.arange(first, j0 + tile)
            ok = (r >= 0) & (r < W)
            rc = np.clip(r, 0, W - 1)
            key_s = np.where(ok, sorted_key[lane, rc], -7)
            pos_s = np.where(ok, order[lane, rc], -7)
            rank_s = np.where(ok, rank[lane, np.clip(pos_s, 0, W - 1)], -7)
            for j in range(j0, min(j0 + tile, W)):
                s = j - first
                p, rp = int(pos_s[s]), int(rank_s[s])
                room = max(int(n[lane]) - p, 0)
                best = (-2, 1 << 30, 0)
                c = 1
                while c <= k and c <= j:
                    if key_s[s - c] != key_s[s]:
                        break
                    q = int(pos_s[s - c])
                    inside = q < p and p - q <= dict_size
                    ln = (min(lcp_ranks(tab[lane], W, rp, int(rank_s[s - c])),
                              room) if inside else 0)
                    best = take((min(ln, fb) if inside else -1, p - q - 1, ln),
                                best)
                    c += 1
                if c <= k:
                    best = take((-1, p, 0), best)     # a place of no run
                top, dist, ln = best
                bl[lane, p] = ln if top >= 2 else 0
                bd[lane, p] = max(dist, 0)
                written[lane, p] += 1
    assert (written == 1).all()
    return bl, bd


def best_inputs(data, n):
    """The hash key's stable sort and the plain 273-deep rank and table."""
    d, k = T(data), T(n)
    keys, (h,) = tm._search_keys_plain(d, k, 32, [4])
    rank, tab = tm._suffix_rank_lcp(d, k, DEPTH, keys)
    s = torch.sort(h, dim=1, stable=True)
    return s.values, s.indices, rank, tab, k


@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("tile", [1, 3, 8, 256])
def test_best_halo_where_a_hash_group_straddles_a_tile(tile, k):
    """Long hash groups (a 3-symbol alphabet, zeros) cross every tile
    edge: the design's halo of k places gives the plain matches, fb 5
    and 273, the window cut to 40 and 250."""
    data, n = lanes([300, 300, 300, 150, 280], 21)
    sv, si, rank, tab, kk = best_inputs(data, n)
    groups = np.diff(np.flatnonzero(np.diff(sv.numpy(), axis=1)))
    assert groups.max() > max(tile, k)
    for fb, dict_size in ((5, 40), (273, 250)):
        want = tm._best_matches_plain(sv, si, rank, tab, kk, dict_size, fb, k)
        got = design_best(sv.numpy(), si.numpy(), rank.numpy(), tab.numpy(),
                          n, dict_size, fb, k, tile)
        np.testing.assert_array_equal(got[0], want[0].numpy())
        np.testing.assert_array_equal(got[1], want[1].numpy())


@pytest.mark.parametrize("dict_size", [1, 2, 7])
def test_no_candidate_in_the_window_keeps_the_smallest_distance(dict_size):
    """With the window cut to a few bytes most positions have no
    candidate in it: the distance is the smallest p - q - 1 over all k,
    a place past the position's run counting as q = -1 (distance p), and
    the length 0; the design and the plain version agree."""
    data, n = lanes([200, 200, 120], 31)
    sv, si, rank, tab, kk = best_inputs(data, n)
    k = 4
    got = design_best(sv.numpy(), si.numpy(), rank.numpy(), tab.numpy(), n,
                      dict_size, 32, k, 8)
    want = tm._best_matches_plain(sv, si, rank, tab, kk, dict_size, 32, k)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    # the rule itself: the reference's k candidates, each -1 off its run
    svn, sin = sv.numpy(), si.numpy()
    seen = 0
    for lane in range(svn.shape[0]):
        for j in range(svn.shape[1]):
            p = int(sin[lane, j])
            cands = [int(sin[lane, j - c]) if j - c >= 0 and
                     svn[lane, j - c] == svn[lane, j] else -1
                     for c in range(1, k + 1)]
            if any(0 <= q < p and p - q <= dict_size for q in cands):
                continue
            seen += 1
            assert got[0][lane, p] == 0
            assert got[1][lane, p] == max(min(p - q - 1 for q in cands), 0)
    assert seen > 100


@pytest.mark.parametrize("fb", [5, 273])
def test_best_matches_by_the_design_equal_jax(fb, monkeypatch):
    """The port's find_best_matches_rmq with K15's and K17's wrappers
    replaced by their designs (tiles of 8 and 3 places): JAX's best
    matches."""
    data, n = lanes([300, 300, 260, 0], 41)
    dict_size = 200
    want = jax.jit(jax.vmap(lambda d, k: jm.find_best_matches_rmq(
        d, k, dict_size, fb, 4)))(jnp.asarray(data), jnp.asarray(n))

    def best(sorted_key, order, rank, tab, nn, dict_size, fb, k):
        got = design_best(sorted_key.numpy(), order.numpy(), rank.numpy(),
                          tab.numpy(), nn.numpy(), dict_size, fb, k, 3)
        return T(got[0]), T(got[1])

    monkeypatch.setattr(cuda_lazy, "doubling_groups_cuda",
                        by_design(K15_SIZES["tile8"], 5, offset=9))
    monkeypatch.setattr(cuda_lazy, "best_matches_cuda", best)
    got = tm.find_best_matches_rmq(T(data), T(n), dict_size, fb, 4)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
