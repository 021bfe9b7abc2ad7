"""K13's and K14's designs (``lzma_tpu_torch/csrc/path.cu``), restated in
numpy and held to the plain versions and to the JAX package, on the CPU.

K13: each tile's door map (every node's segment exit by windows of
lanes going up the segment, a pointer into its own window resolved by
pointer jumping while any lane waits, then the door nodes' tile exits a
segment at a time), the maps composed along the lane (in groups of
tiles: each group's map, the walk over the groups, then each group's
tiles) to each tile's entry, a hop longer than the door followed a
pointer at a time, and each tile marked from its entry (each segment's
entry through the segment exits kept for the segments' doors, then a
walk a segment, or the tile in one run from an entry off the doors);
the status flags for a pointer or start outside the lane and a step
against the walk.  K14: the tiles' tickets in lane-major order, each
tile's count, the decoupled
look-back for its first slot under random interleavings of the blocks,
the staged token runs written as 16-byte pairs, the fill past the count
and t_valid as 16-byte chunks, by the next lane's blocks.  The sizes are
the kernel's (tiles of 4,096 nodes, segments of 512, windows of 32, a
door of 288, groups of 128) and cut ones (tiles of 4 and 16 nodes, doors
shorter than a hop, so that hops past the door are common), with doors
of exactly 273 against 273-long hops at a tile's edge.
"""

import math
from dataclasses import dataclass

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lzma_tpu.ops import device_matcher as jm  # noqa: E402
from lzma_tpu.ops import device_parser as jp  # noqa: E402
from lzma_tpu_torch.ops import device_matcher as tm  # noqa: E402
from lzma_tpu_torch.ops import device_parser as tp  # noqa: E402

BAD = -1
MATCH_MAX = 273


@dataclass(frozen=True)
class Sizes:
    """A K13 and K14 shape: nodes a tile, a warp's segment, a window (the
    warp's lanes), the door, tiles a group; K14's nodes a tile."""
    tile: int = 4096
    seg: int = 512
    win: int = 32
    door: int = 288
    group: int = 128
    ctile: int = 4096


KERNEL = Sizes()


# ------------------------------------------------------------------ K13
class Lane:
    """One lane's graph: f (n_nodes,) each node's pointer, forward or
    backward, and its start node."""

    def __init__(self, f, start, forward, sz):
        self.n_nodes = len(f)
        self.forward = forward
        self.sz = sz
        self.status = [0, 0]
        out = (f < 0) | (f >= self.n_nodes)
        if out.any():
            self.status[0] = 1
        self.f = np.where(out, np.arange(self.n_nodes), f).astype(np.int64)
        self.raw = f
        self.start = start
        self.n_tiles = -(-self.n_nodes // sz.tile)
        assert sz.seg >= sz.door and sz.tile % sz.seg == 0

    def u_of(self, t, j):
        lo = t * self.sz.tile
        return lo + self.sz.tile - 1 - j if self.forward else j - lo

    def node_at(self, t, u):
        lo = t * self.sz.tile
        return lo + self.sz.tile - 1 - u if self.forward else lo + u

    def tile_of(self, x):
        return x // self.sz.tile

    def pointers(self, t):
        """p[u] of tile t: the pointer (outside the lane: the node
        itself), BAD where the node does not exist."""
        j = self.node_at(t, np.arange(self.sz.tile))
        ok = j < self.n_nodes
        return np.where(ok, self.f[np.where(ok, j, 0)], BAD)

    def segment_exits(self, t):
        """Grid 1's scan of tile t: ex[u]."""
        sz = self.sz
        p = self.pointers(t)
        ex = np.empty(sz.tile, np.int64)
        lanes = np.arange(sz.win)
        rounds = max(1, math.ceil(math.log2(sz.win)))
        for base in range(0, sz.tile, sz.seg):
            for wb in range(base, base + sz.seg, sz.win):
                u = wb + lanes
                f = p[u]
                st = f.copy()       # a value, or -2 - lane: waits on a lane
                live = (f != BAD) & (f != self.node_at(t, u))
                q = self.u_of(t, f)
                against = live & (q >= u)
                inwin = live & ~against & (q >= wb)
                below = live & ~against & ~inwin & (q >= base)
                st[against] = BAD
                st[inwin] = -2 - (q[inwin] - wb)
                st[below] = ex[q[below]]
                n_rounds = 0
                while (st <= -2).any():             # pointer jumping
                    wait = st <= -2
                    st = np.where(wait, st[np.where(wait, -2 - st, lanes)], st)
                    n_rounds += 1
                assert n_rounds <= rounds
                ex[u] = st
        return ex

    def tile_exit(self, t, ex, u):
        x = ex[u]
        while True:
            if x == BAD:
                return BAD
            q = self.u_of(t, x)
            if q < 0:
                return x
            y = ex[q]
            if y == x:
                return x
            x = y

    def door_maps(self):
        """Grid 1: each tile's door map and the start's tile exit."""
        sz = self.sz
        maps = np.empty((self.n_tiles, sz.door), np.int64)
        start_exit = None
        for t in range(self.n_tiles):
            ex = self.segment_exits(t)
            for d in range(sz.door):
                maps[t, d] = self.tile_exit(t, ex, sz.tile - sz.door + d)
            if self.in_lane(self.start) and self.tile_of(self.start) == t:
                start_exit = self.tile_exit(t, ex, self.u_of(t, self.start))
        return maps, start_exit

    def in_lane(self, x):
        return 0 <= x < self.n_nodes

    def exit_from(self, t, x, maps):
        d = self.u_of(t, x) - (self.sz.tile - self.sz.door)
        if d >= 0:
            return maps[t, d]
        while True:                       # a hop longer than the door
            f = self.raw[x]
            if not self.in_lane(f) or f == x:
                return x
            if self.tile_of(f) != t:
                return f
            if (f < x) if self.forward else (f > x):
                return BAD
            x = f

    def step(self, t, x):
        if x == BAD:
            return -1
        tx = self.tile_of(x)
        if tx == t:
            return 0
        return 1 if (tx > t if self.forward else tx < t) else -1

    def walk_tiles(self, t, x, t0, t1, maps, entry=None):
        while True:
            k = self.step(t, x)
            if k == 0:
                return x
            if k < 0:
                return BAD
            tn = self.tile_of(x)
            if tn < t0 or tn >= t1:
                return x
            if entry is not None:
                entry[tn] = x
            x = self.exit_from(tn, x, maps)
            t = tn

    def entries(self):
        """Grids 1-4: each tile's entry node (-1 where the walk does not
        enter it)."""
        sz = self.sz
        maps, start_exit = self.door_maps()
        entry = np.full(self.n_tiles, -1)
        if not self.in_lane(self.start):
            self.status[0] = 1
            return entry
        ng = -(-self.n_tiles // sz.group)
        bounds = [(g * sz.group, min((g + 1) * sz.group, self.n_tiles))
                  for g in range(ng)]
        gs = self.tile_of(self.start) // sz.group
        gentry = np.full(ng, -1)
        gentry[gs] = self.start
        if ng > 1:
            gmap = np.empty((ng, sz.door), np.int64)     # grid 2
            for g, (t0, t1) in enumerate(bounds):
                te = t0 if self.forward else t1 - 1
                for d in range(sz.door):
                    gmap[g, d] = self.walk_tiles(te, maps[te, d], t0, t1, maps)
            t0, t1 = bounds[gs]
            x = self.walk_tiles(self.tile_of(self.start), start_exit, t0, t1,
                                maps)
            gc = gs                                       # grid 3
            while True:
                if x == BAD:
                    self.status[1] = 1
                    break
                gx = self.tile_of(x) // sz.group
                if gx == gc:
                    break
                if (gx < gc) if self.forward else (gx > gc):
                    self.status[1] = 1
                    break
                gentry[gx] = x
                t0, t1 = bounds[gx]
                te = t0 if self.forward else t1 - 1
                d = (self.u_of(te, x) - (sz.tile - sz.door)
                     if self.tile_of(x) == te else -1)
                if d < 0:
                    e = self.exit_from(self.tile_of(x), x, maps)
                    x = self.walk_tiles(self.tile_of(x), e, t0, t1, maps)
                else:
                    x = gmap[gx, d]
                gc = gx
        for g, (t0, t1) in enumerate(bounds):             # grid 4
            e = gentry[g]
            if e < 0:
                continue
            t = self.tile_of(e)
            entry[t] = e
            x = start_exit if g == gs else self.exit_from(t, e, maps)
            if self.walk_tiles(t, x, t0, t1, maps, entry) == BAD:
                self.status[1] = 1
        return entry

    def marks(self):
        """Grid 5 after grids 1-4: the reached nodes (n_nodes,) bool.  An
        entered tile finds each segment's entry through the segment exits
        grid 1 kept for each segment's door nodes (an entry off its
        segment's door walks the tile in one run), then walks each
        segment from its entry a pointer at a time."""
        sz = self.sz
        reach = np.zeros(self.n_nodes, bool)
        for t, e in enumerate(self.entries()):
            if e < 0:
                continue
            ex = self.segment_exits(t)
            segx = [ex[s * sz.seg + sz.seg - sz.door:(s + 1) * sz.seg]
                    for s in range(sz.tile // sz.seg)]
            p = self.pointers(t)
            seg_in = np.full(sz.tile // sz.seg, -1)
            x, whole = e, False
            while True:
                q = self.u_of(t, x)
                if q < 0:
                    break
                sg = q // sz.seg
                seg_in[sg] = x
                d = q - (sg * sz.seg + sz.seg - sz.door)
                if d < 0:
                    whole = True
                    break
                y = segx[sg][d]
                if y == BAD or self.u_of(t, y) >= sg * sz.seg:
                    break               # a fixed point in this segment
                x = y
            starts = ([(e, 0)] if whole else
                      [(x, s * sz.seg) for s, x in enumerate(seg_in)])
            for x, floor in starts:
                while x >= 0:
                    q = self.u_of(t, x)
                    if q < floor:
                        break
                    reach[x] = True
                    f = p[q]
                    if f == x or f == BAD or self.u_of(t, f) >= q:
                        break
                    x = f
        return reach


def design_mark(f, start, forward, sz=KERNEL):
    """K13's reached set of one lane and its status flags."""
    lane = Lane(np.asarray(f, np.int64), int(start), forward, sz)
    return lane.marks(), lane.status


# ------------------------------------------------------------------ K14
def write_pairs(out, at, values, written):
    """A run of int64 slots from element `at`: 8 bytes at an odd element,
    16-byte pairs where aligned, 8 at the tail (out: the flat plane)."""
    n = len(values)
    if n == 0:
        return
    head = at % 2
    pairs = (n - head) // 2
    for i in range(pairs):
        k = head + 2 * i
        assert (at + k) % 2 == 0
        out[at + k:at + k + 2] = values[k:k + 2]
        written[at + k:at + k + 2] += 1
    for k in ([0] if head else []) + ([head + 2 * pairs]
                                       if head + 2 * pairs < n else []):
        out[at + k] = values[k]
        written[at + k] += 1


def write_valid(valid, a0, lo, hi, ntok, written):
    """t_valid's bytes [lo, hi) of a row at byte address a0: 16-byte
    chunks inside the range, bytes at its ends."""
    a_lo, a_hi = a0 + lo, a0 + hi
    c0 = -(-a_lo // 16) * 16
    c1 = a_hi // 16 * 16
    if c0 > c1:
        c0 = c1 = a_hi
    for a in list(range(a_lo, c0)) + list(range(c1, a_hi)):
        valid[a] = (a - a0) < ntok
        written[a] += 1
    for c in range(c0, c1, 16):
        s0 = c - a0
        valid[c:c + 16] = (s0 + np.arange(16)) < ntok
        written[c:c + 16] += 1


def design_compact(mark, values, sz=KERNEL, seed=0, offset=0):
    """K14 on a lane group: mark (L, W) bool, values(lane, j) -> (pos,
    len, dist) of marked node j.  The blocks take tickets in order and
    run their phases in a random interleaving (a look-back only reads
    predecessors that have published).  Rows lie at byte `offset` +
    lane * W (t_valid) and element offset + lane * W (the planes), so
    every alignment occurs.  Returns (t_pos, t_len, t_dist, t_valid,
    ntok) and checks every slot is written exactly once."""
    L, W = mark.shape
    nt = -(-W // sz.ctile)
    size = offset + L * W
    planes = [np.full(size, 7777, np.int64) for _ in range(3)]
    p_written = [np.zeros(size, int) for _ in range(3)]
    valid = np.zeros(size + 16, bool)
    v_written = np.zeros(size + 16, int)
    ntok = np.full(L, -1)
    state = {}                # (lane, tile) -> (flag, sum)
    rng = np.random.default_rng(seed)

    def block(ticket):
        lane, t = divmod(ticket, nt)
        lo, hi = t * sz.ctile, min((t + 1) * sz.ctile, W)
        if lane < L:
            m = mark[lane, lo:hi]
            total = int(m.sum())
            state[lane, t] = ("prefix" if t == 0 else "aggregate", total)
            yield
            excl, q = 0, t - 1
            while t > 0:
                while (lane, q) not in state:
                    yield                                 # spin
                flag, v = state[lane, q]
                excl += v
                if flag == "prefix":
                    break
                q -= 1
            if t > 0:
                state[lane, t] = ("prefix", excl + total)
            if t == nt - 1:
                ntok[lane] = excl + total
            yield
            nodes = lo + np.nonzero(m)[0]
            toks = np.array([values(lane, j) for j in nodes],
                            np.int64).reshape(-1, 3)
            for k in range(3):
                write_pairs(planes[k], offset + lane * W + excl, toks[:, k],
                            p_written[k])
            yield
        if lane >= 1:
            fl = lane - 1
            while state.get((fl, nt - 1), ("", 0))[0] != "prefix":
                yield
            n_tok = state[fl, nt - 1][1]
            row = offset + fl * W
            write_valid(valid, row, lo, hi, n_tok, v_written)
            f0 = max(lo, n_tok)
            for k, fill in enumerate((0, 1, -1)):
                write_pairs(planes[k], row + f0,
                            np.full(max(0, hi - f0), fill), p_written[k])

    live = {}
    next_ticket = 0
    n_blocks = nt * (L + 1)
    while next_ticket < n_blocks or live:
        if next_ticket < n_blocks and (not live or rng.random() < 0.5):
            live[next_ticket] = block(next_ticket)
            next_ticket += 1
            continue
        k = rng.choice(sorted(live))
        try:
            next(live[k])
        except StopIteration:
            del live[k]
    body = slice(offset, offset + L * W)
    for w in p_written:
        assert (w[body] == 1).all() and w[:offset].sum() == 0
    assert (v_written[body] == 1).all() and v_written[:offset].sum() == 0
    shape = (L, W)
    return (*(p[body].reshape(shape) for p in planes),
            valid[body].reshape(shape), ntok)


def dp_values(frm, choice):
    return lambda lane, j: (frm[lane, j], j - frm[lane, j], choice[lane, j])


def greedy_values(bl, bd, take):
    return lambda lane, j: (j, bl[lane, j] if take[lane, j] else 1,
                            bd[lane, j] if take[lane, j] else -1)


# ------------------------------------------------------------ the graphs
def dp_graph(n, lanes, seed, fb=MATCH_MAX):
    """lanes of a DP's (from, choice) over n + 1 nodes: random edges of
    1..fb, one all-literal lane, one of fb-long edges; lens n, n // 2
    (the nodes past it pointing to themselves), 0, 1, n."""
    rng = np.random.default_rng(seed)
    NP = n + 1
    node = np.arange(NP)
    frm = np.maximum(node - rng.integers(1, fb + 1, (lanes, NP)), 0)
    frm[1] = np.maximum(node - 1, 0)
    frm[2] = np.where(node >= fb, node - fb, np.maximum(node - 1, 0))
    frm[:, 0] = 0
    lens = np.full(lanes, n)
    lens[3 % lanes] = n // 2
    frm[3 % lanes, n // 2 + 1:] = node[n // 2 + 1:]
    if lanes > 5:
        lens[4], lens[5] = 0, 1
    choice = rng.integers(-1, 1 << 20, (lanes, NP))
    return frm.astype(np.int32), choice.astype(np.int32), lens


def lazy_lists(n, lanes, seed):
    """lanes of best (len, dist) over n positions (a mix of short and
    273-long matches, no matches, 273 everywhere) and their lengths."""
    rng = np.random.default_rng(seed)
    bl = np.where(rng.random((lanes, n)) < 0.5, rng.integers(0, 4, (lanes, n)),
                  rng.integers(2, MATCH_MAX + 1, (lanes, n)))
    bl[1 % lanes] = 0
    bl[2 % lanes] = MATCH_MAX
    bd = rng.integers(0, 1 << 17, (lanes, n))
    nn = np.full(lanes, n)
    nn[0] = n * 2 // 3
    if lanes > 3:
        nn[3] = 0
    return bl, bd, nn


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def eq(got, ref, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(ref), err_msg=msg)


def extract_by_design(frm, choice, lens, sz, seed=0, offset=0):
    """extract_tokens by the two designs: K13's marks, K14's tokens."""
    L, NP = frm.shape
    node = np.arange(NP)
    mark = np.zeros((L, NP), bool)
    for lane in range(L):
        reach, status = design_mark(frm[lane], lens[lane], False, sz)
        assert status == [0, 0]
        mark[lane] = reach & (node > 0) & (node <= lens[lane])
    return mark, design_compact(mark, dp_values(frm, choice), sz, seed, offset)


def greedy_by_design(bl, bd, nn, start, lazy, sz, seed=0, offset=0):
    take, adv = (t.numpy() for t in tm._decide(T(bl).long(), T(bd).long(),
                                                lazy))
    L, N = bl.shape
    pos = np.arange(N)
    on = np.zeros((L, N), bool)
    for lane in range(L):
        f = np.append(np.minimum(pos + adv[lane], N), N)
        reach, status = design_mark(f, start, True, sz)
        assert status == [0, 0]
        on[lane] = reach[:N] & (pos < nn[lane])
    return take, on, design_compact(on, greedy_values(bl, bd, take), sz, seed,
                                    offset)


SMALL = {
    "tile4": Sizes(tile=4, seg=4, win=2, door=2, group=3, ctile=4),
    "tile16": Sizes(tile=16, seg=8, win=4, door=5, group=4, ctile=16),
    "tile4096": KERNEL,
}


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("name", list(SMALL))
@pytest.mark.parametrize("fb", [5, MATCH_MAX])
def test_designs_equal_plain_and_jax_extract(name, fb):
    sz = SMALL[name]
    frm, choice, lens = dp_graph(1000, 6, seed=fb, fb=fb)
    mark, got = extract_by_design(frm, choice, lens, sz, seed=fb, offset=fb % 7)
    eq(mark, tp._extract_mark(T(frm), T(lens)), "marks")
    want = jp.extract_tokens(jnp.asarray(frm), jnp.asarray(choice),
                             jnp.asarray(lens.astype(np.int32)))
    plain = tp._extract_compact(T(frm), T(choice), T(mark))
    for k, (g, w, p) in enumerate(zip(got, want, plain)):
        eq(g, w, f"JAX {k}")
        eq(g, p, f"plain {k}")


@pytest.mark.parametrize("name", list(SMALL))
@pytest.mark.parametrize("start,lazy", [(0, True), (300, False), (299, True)])
def test_designs_equal_plain_and_jax_greedy(name, start, lazy):
    sz = SMALL[name]
    bl, bd, nn = lazy_lists(1000, 5, seed=start)
    take, on, got = greedy_by_design(bl, bd, nn, start, lazy, sz, seed=start,
                                     offset=start % 5)
    jl, jd, jn = (jnp.asarray(a.astype(np.int32)) for a in (bl, bd, nn))
    want_on = jax.vmap(lambda a, b, k: jm.greedy_path(a, b, k, 1000, start,
                                                      lazy))(jl, jd, jn)
    eq(on, want_on, "on_path")
    adv = tm._decide(T(bl).long(), T(bd).long(), lazy)[1]
    eq(on, tm._greedy_mark(adv, T(nn), start), "plain on_path")
    want = jax.vmap(lambda a, b, o, k: jm._compact(a, b, o, k, lazy))(
        jl, jd, jnp.asarray(on), jn)
    plain = tm._compact_taken(T(bl).long(), T(bd).long(), T(take), T(on))
    for k, (g, w, p) in enumerate(zip(got, want, plain)):
        eq(g, w, f"JAX {k}")
        eq(g, p, f"plain {k}")


@pytest.mark.parametrize("forward", [False, True])
def test_mark_over_many_tiles_in_groups(forward):
    """One lane of 301 tiles (the stream's 2,049, cut: tiles of 16 nodes,
    groups of 8): the group maps, the walk over the groups and each
    group's tiles give the plain marks; so do groups of one tile and one
    group of them all."""
    n = 16 * 300
    if forward:
        bl, bd, nn = lazy_lists(n, 1, seed=7)
        adv = tm._decide(T(bl).long(), T(bd).long(), True)[1].numpy()[0]
        f = np.append(np.minimum(np.arange(n) + adv, n), n)
        want = tm._greedy_mark(T(adv[None]), T(np.array([n + 1])), 0)[0]
        start = 0
    else:
        frm, _, _ = dp_graph(n, 4, seed=7)
        f = frm[0]
        start = n
        want = tp._extract_mark(T(frm[:1]), T(np.array([n])))[0].numpy()
        want[0] = True                  # node 0: reached, not kept
    for group in (8, 1, 4096):
        sz = Sizes(tile=16, seg=8, win=4, door=5, group=group, ctile=16)
        lane = Lane(np.asarray(f, np.int64), start, forward, sz)
        reach = lane.marks()
        assert lane.status == [0, 0]
        eq(reach[:n] if forward else reach, want, f"group {group}")


@pytest.mark.parametrize("forward", [False, True])
def test_hops_of_273_across_a_tile_edge_at_the_door_end(forward):
    """Hops of exactly 273 that cross a tile's edge land on the door's
    last node where the door is 273 (and inside the kernel's 288); lens
    0 and 1 and a start past 0."""
    n = 4096 * 3 + 100
    node = np.arange(n + 1)
    if forward:
        f = np.minimum(node + MATCH_MAX, n)
        f[-1] = n
        starts = [0, 4096 - MATCH_MAX, 4096 - 1, 5]
    else:
        f = np.maximum(node - MATCH_MAX, 0)
        starts = [n, 4096 + MATCH_MAX - 1, 4096, 4096 * 3, 0, 1]
    for start in starts:
        want = np.zeros(n + 1, bool)
        x = start
        while True:
            want[x] = True
            if f[x] == x:
                break
            x = f[x]
        for door in (MATCH_MAX, 288):
            sz = Sizes(door=door)
            reach, status = design_mark(f, start, forward, sz)
            assert status == [0, 0]
            eq(reach, want, f"start {start} door {door}")
    frm = f[None].astype(np.int32)
    if not forward:
        for lens in (0, 1, 4096 + MATCH_MAX):
            reach, _ = design_mark(f, lens, False, Sizes(door=MATCH_MAX))
            eq(reach & (node > 0) & (node <= lens),
               tp._extract_mark(T(frm), T(np.array([lens])))[0],
               f"lens {lens}")


def test_hops_past_the_door_are_followed():
    """Tiles of 4 nodes with a door of 2: most hops land past the door
    and are followed a pointer at a time; the marks are the plain ones."""
    frm, _, lens = dp_graph(600, 6, seed=11, fb=40)
    sz = Sizes(tile=4, seg=4, win=4, door=2, group=2, ctile=4)
    node = np.arange(601)
    for lane in range(6):
        reach, status = design_mark(frm[lane], lens[lane], False, sz)
        assert status == [0, 0]
        eq(reach & (node > 0) & (node <= lens[lane]),
           tp._extract_mark(T(frm[lane:lane + 1]), T(lens[lane:lane + 1]))[0])


def test_status_flags_where_the_kernel_cannot_follow():
    """A hop of 8,400 nodes and then a step back (the card test's case):
    the walk is followed past the door and the step against it flagged;
    a start or a pointer outside the lane flags the other."""
    frm = np.arange(9000)
    frm[8500], frm[100] = 100, 8800
    frm[8800] = 8500
    assert design_mark(frm, 8800, False)[1] == [0, 1]
    assert design_mark(frm, 9000, False)[1] == [1, 0]
    frm[5] = 9005
    reach, status = design_mark(frm, 3, False)
    assert status == [1, 0]
    eq(np.nonzero(reach)[0], [3])
    # a step against the walk inside a tile, and one off the walk
    f = np.arange(64)
    f[40], f[20] = 20, 30
    assert design_mark(f, 40, False, SMALL["tile16"])[1] == [0, 1]
    assert design_mark(f, 19, False, SMALL["tile16"])[1] == [0, 0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lookback_under_random_schedules(seed):
    """K14's tickets, look-back and staged writes under random
    interleavings of many tiles a lane (tiles of 4 slots, 9 lanes of 103
    slots, every row offset): the plain tokens, every slot once."""
    rng = np.random.default_rng(seed)
    L, W = 9, 103
    mark = rng.random((L, W)) < [[0.0], [1.0], [0.2], [0.5], [0.9], [0.05],
                                 [0.3], [0.0], [0.7]]
    frm = np.maximum(np.arange(W) - rng.integers(1, 9, (L, W)), 0).astype(np.int32)
    choice = rng.integers(-1, 99, (L, W)).astype(np.int32)
    plain = tp._extract_compact(T(frm), T(choice), T(mark))
    for offset in range(4):
        got = design_compact(mark, dp_values(frm, choice),
                             Sizes(ctile=4), seed=seed * 10 + offset,
                             offset=offset)
        for k, (g, p) in enumerate(zip(got, plain)):
            eq(g, p, f"offset {offset} output {k}")
