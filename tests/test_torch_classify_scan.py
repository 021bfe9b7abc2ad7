"""K6's design as a chunked scan, modelled in PyTorch on the CPU.

``csrc/classify.cu`` computes the classify carry (``device_encoder.
_classify_carry``) as a scan over each lane's token rows: a chunk of rows
is summarised by the distinct distances of its valid non-literal tokens
(at most 4, most recent first) and, once its reps are known, by its
12-entry state map; summaries join associatively (lists: the first 4 of
dedupe(later ++ earlier); maps: the later after the earlier), and each
chunk is then rescanned from its carry.  The model here restates those
phases with the kernel's grouping (chunks of K rows, PER chunks a tile
joined by a Hillis-Steele scan, tiles joined in order down the lane) and
its byte-lane arithmetic for the state maps, and is held to
``_classify_carry`` at chunk sizes 1, 3, 32 and T, to JAX's
``classify_tokens`` through the port's ``classify_tokens``, and its joins
to associativity.  The kernel itself is held to the plain version on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lzma_tpu.ops import device_encoder as jde  # noqa: E402
from lzma_tpu_torch.bench.datagen import generate_bench_data  # noqa: E402
from lzma_tpu_torch.ops import device_encoder as tde  # noqa: E402
from lzma_tpu_torch.ops.device_decoder import pad_rows  # noqa: E402
from lzma_tpu_torch.ops.device_encoder import EOS_DIST  # noqa: E402
from lzma_tpu_torch.ops.device_matcher import tokenize  # noqa: E402

EMPTY = -1                       # an unused list entry (never a distance)
IDENTITY = 0xBA9876543210        # the identity state map, 12 nibbles
PER = 8                          # chunks a tile (the kernel: 256 / lanes)
_W = torch.where


# ---------------------------------------------------------------- model
def case_of(reps, d):
    """The scan case of distance d against reps (..., 4): 0 fresh match,
    1..4 the first equal rep, 5 literal."""
    lit = (d < 0) & (d != EOS_DIST)
    eq = reps == d[..., None]
    first = _W(eq.any(-1), eq.int().argmax(-1) + 1, 0)
    return _W(lit, 5, first)


def mtf(reps, c, d, valid):
    """The reps after a token of case c (held where not valid)."""
    moves = valid & (c != 5)
    s1 = moves & (c != 1)
    s2 = moves & ((c == 0) | (c >= 3))
    s3 = moves & ((c == 0) | (c == 4))
    return torch.stack([_W(moves, d, reps[..., 0]),
                        _W(s1, reps[..., 0], reps[..., 1]),
                        _W(s2, reps[..., 1], reps[..., 2]),
                        _W(s3, reps[..., 2], reps[..., 3])], dim=-1)


def join_lists(a, b):
    """An earlier segment's list a, then a later one's b: the first 4 of
    dedupe(b ++ a)."""
    out = b.clone()
    for k in range(4):
        x = a[..., k]
        keep = (x != EMPTY) & ~(b == x[..., None]).any(-1)
        empty = out == EMPTY
        slot = empty.int().argmax(-1)
        put = keep & empty.any(-1)
        at = put[..., None] & (torch.arange(4) == slot[..., None])
        out = _W(at, x[..., None], out)
    return out


def join_maps(a, b):
    """An earlier segment's state map a, then a later one's b: b after a."""
    out = torch.zeros_like(a)
    for s in range(12):
        x = (a >> (4 * s)) & 15
        out |= ((b >> (4 * x)) & 15) << (4 * s)
    return out


def step4(x, lit, lo, dhi):
    """The kernel's byte lanes: 4 states (one a byte of x) after a
    literal, or after a match / rep / shortRep taking s < 7 to lo and
    s >= 7 to lo + dhi."""
    ge4 = ((x + 0x7C7C7C7C) >> 7) & 0x01010101
    ge7 = ((x + 0x79797979) >> 7) & 0x01010101
    ge10 = ((x + 0x76767676) >> 7) & 0x01010101
    lit_x = (x - 3 * (ge4 + ge10)) & (ge4 * 0xFF)
    return _W(lit, lit_x, lo * 0x01010101 + ge7 * dhi)


def exclusive_scan(s, join, identity, per=PER):
    """s (n, ...) joined in order: each entry's exclusive prefix, in the
    kernel's grouping -- tiles of `per`, a Hillis-Steele scan inside a
    tile, the tiles' totals joined in order down the lane."""
    n = s.shape[0]
    n_t = -(-n // per)
    pad = torch.full((n_t * per - n, *s.shape[1:]), identity, dtype=s.dtype)
    tiles = torch.cat([s, pad]).reshape(n_t, per, *s.shape[1:])
    incl, off = tiles, 1
    while off < per:
        incl = torch.cat([incl[:, :off], join(incl[:, :-off], incl[:, off:])],
                         dim=1)
        off *= 2
    tile_pre, pre = [], torch.full_like(incl[0, 0], identity)
    for t in range(n_t):
        tile_pre.append(pre)
        pre = join(pre, incl[t, -1])
    within = torch.cat([torch.full_like(incl[:, :1], identity),
                        incl[:, :-1]], dim=1)
    tile_pre = torch.stack(tile_pre)[:, None].expand_as(within)
    return join(tile_pre, within).reshape(n_t * per, *s.shape[1:])[:n]


def chunked_carry(dist_r, len_r, valid_r, K):
    """_classify_carry's (case_r, state_r, r0_r) by K6's phases with
    chunks of K rows."""
    T, N = dist_r.shape
    n_c = -(-T // K)
    extra = n_c * K - T

    def chunks(t, fill):
        t = torch.cat([t.long(), torch.full((extra, N), fill, dtype=torch.long)])
        return t.reshape(n_c, K, N)

    d = chunks(dist_r, 0)
    v = chunks(valid_r, 0).bool()
    short = chunks(len_r, 2) < 2

    # 1-2. each chunk's own list, then the lists before it
    lst = torch.full((n_c, N, 4), EMPTY, dtype=torch.long)
    for i in range(K):
        lst = mtf(lst, case_of(lst, d[:, i]), d[:, i], v[:, i])
    before = exclusive_scan(lst, join_lists, EMPTY)
    reps = _W(before == EMPTY, 0, before)

    # 3-4. each chunk's state map from its exact reps, then the maps before
    x = torch.tensor([0x03020100, 0x07060504, 0x0B0A0908]).expand(n_c, N, 3)
    r = reps
    for i in range(K):
        c = case_of(r, d[:, i])
        lo = _W(c == 0, 7, _W(short[:, i], 9, 8))
        dhi = _W(c == 0, 3, _W(short[:, i], 2, 3))
        stepped = step4(x, (c == 5)[..., None], lo[..., None], dhi[..., None])
        x = _W(v[:, i, :, None], stepped, x)
        r = mtf(r, c, d[:, i], v[:, i])
    maps = sum(((x[..., s >> 2] >> (8 * (s & 3))) & 15) << (4 * s)
               for s in range(12))
    state = (exclusive_scan(maps, join_maps, IDENTITY) & 15)  # map(0)

    # 5. each chunk rescanned from its reps and state
    out = torch.zeros((3, n_c, K, N), dtype=torch.int32)
    r = reps
    for i in range(K):
        c = case_of(r, d[:, i])
        out[0, :, i], out[1, :, i], out[2, :, i] = c, state, r[..., 0]
        high = state >= 7
        lit_s = _W(state < 4, 0, _W(state < 10, state - 3, state - 6))
        rep_s = _W(high, 11, _W(short[:, i], 9, 8))
        nxt = _W(c == 5, lit_s, _W(c == 0, _W(high, 10, 7), rep_s))
        state = _W(v[:, i], nxt, state)
        r = mtf(r, c, d[:, i], v[:, i])
    return tuple(o.reshape(n_c * K, N)[:T] for o in out)


# ---------------------------------------------------------------- rows
def _token_rows(T, N, seed, gaps=True):
    """(T, N) rows: literals, zero and small distances (rep hits), EOS
    markers, fresh distances; lens 1, 2, 5 and long; each lane valid up
    to its own end, with invalid gaps; lane 0 has no valid token; lanes
    1..5 end their valid tokens at rows 1, 3, 6, 32, 64 (a chunk's last
    row at K = 1, 3 and 32)."""
    rng = np.random.default_rng(seed)
    choice = np.array([-1, -1, -1, 0, 1, 2, 3, 5, 7, EOS_DIST])
    dist = choice[rng.integers(0, len(choice), (T, N))]
    fresh = rng.random((T, N)) < 0.1
    dist = np.where(fresh, rng.integers(8, 1 << 20, (T, N)), dist)
    ln = np.array([1, 2, 5, 273])[rng.integers(0, 4, (T, N))]
    ends = rng.integers(0, T + 1, N)
    ends[0] = 0
    ends[1:6] = np.minimum([1, 3, 6, 32, 64], T)[: max(min(N - 1, 5), 0)]
    valid = np.arange(T)[:, None] < ends[None, :]
    if gaps:
        valid &= rng.random((T, N)) > 0.15
        valid[ends[1:6] - 1, np.arange(1, 6)[: len(ends[1:6])]] = True
    return (torch.from_numpy(dist.astype(np.int32)),
            torch.from_numpy(ln.astype(np.int32)), torch.from_numpy(valid))


@pytest.mark.parametrize("K", [1, 3, 32, "T"])
@pytest.mark.parametrize("T,N,seed", [(200, 12, 1), (97, 7, 2), (1, 3, 3),
                                      (65, 1, 4)])
def test_chunked_model_equals_the_plain_carry(K, T, N, seed):
    rows = _token_rows(T, N, seed)
    want = tde._classify_carry(*rows)
    got = chunked_carry(*rows, T if K == "T" else K)
    for name, g, w in zip(("case", "state", "r0"), got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("K", [1, 3, 32])
def test_chunked_model_on_one_kind_lanes(K):
    """All literals, all rep0 (dist 0 from the start), all hits of one
    fresh distance, all EOS markers; lens 1 and 2."""
    T = 70
    for dist in (-1, 0, 5, EOS_DIST):
        d = torch.full((T, 4), dist, dtype=torch.int32)
        ln = torch.tensor([1, 2, 1, 2], dtype=torch.int32).expand(T, 4).contiguous()
        v = torch.ones((T, 4), dtype=torch.bool)
        v[:, 3] = torch.arange(T) < 17
        for g, w in zip(chunked_carry(d, ln, v, K), tde._classify_carry(d, ln, v)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("K", [1, 3, 32, "T"])
def test_chunked_model_through_classify_tokens_equals_jax(monkeypatch, K):
    """8 lanes x 2 KiB of the lazy parse with the EOS marker appended and
    invalid gaps: the port's classify_tokens with the model as its carry
    equals JAX's classify_tokens."""
    n, size = 8, 2048
    data = generate_bench_data(n * size)
    blocks = [data[i * size:(i + 1) * size] for i in range(n)]
    blocks[3] = blocks[3][:700]
    blocks[5] = b""
    d, lens = pad_rows(blocks, "cpu")
    tok = tokenize(d, lens, size, 32, 4)
    t_pos, t_len, t_dist, t_valid = tde._append_eos_tokens(*tok[:4], tok[4], lens)
    holes = t_valid.clone()
    holes[::3, 5::7] = False
    T = t_pos.shape[1]
    k = T if K == "T" else K
    monkeypatch.setattr(tde, "_classify_carry",
                        lambda *rows: chunked_carry(*rows, k))
    for valid in (t_valid, holes):
        got = tde.classify_tokens(d, t_pos, t_len, t_dist, valid)
        want = jde.classify_tokens(*(jnp.asarray(t.numpy()) for t in
                                     (d, t_pos, t_len, t_dist, valid)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------- joins
# the joins' laws on seeded random draws: lists of up to 4 distinct
# distances (zero and EOS among them) padded with EMPTY, and maps of 12
# states in nibbles
_DISTS = np.array([0, 1, 2, 3, 5, 7, 1 << 20, EOS_DIST])


def _random_list(rng):
    xs = rng.choice(_DISTS, size=rng.integers(0, 5), replace=False).tolist()
    return torch.tensor(xs + [EMPTY] * (4 - len(xs)))


def _random_map(rng):
    return torch.tensor(sum(int(x) << (4 * s) for s, x in
                            enumerate(rng.integers(0, 12, size=12))))


def test_joins_are_associative_with_identities():
    rng = np.random.default_rng(8)
    empty, ident = torch.full((4,), EMPTY), torch.tensor(IDENTITY)
    for _ in range(200):
        la, lb, lc = (_random_list(rng) for _ in range(3))
        assert torch.equal(join_lists(join_lists(la, lb), lc),
                           join_lists(la, join_lists(lb, lc)))
        assert torch.equal(join_lists(empty, la), la)
        assert torch.equal(join_lists(la, empty), la)
        mf, mg, mh = (_random_map(rng) for _ in range(3))
        assert torch.equal(join_maps(join_maps(mf, mg), mh),
                           join_maps(mf, join_maps(mg, mh)))
        assert torch.equal(join_maps(ident, mf), mf)
        assert torch.equal(join_maps(mf, ident), mf)


def test_list_of_a_split_segment_is_the_join_of_its_parts():
    """The MTF from an empty list over a segment equals the join of the
    lists of its two parts, at every cut: the summary is a homomorphism."""
    def summary(part):
        r = torch.full((4,), EMPTY)
        for dist, valid in part:
            d = torch.tensor(dist)
            r = mtf(r, case_of(r, d), d, torch.tensor(valid))
        return r

    rng = np.random.default_rng(9)
    for _ in range(100):
        n = int(rng.integers(1, 13))
        xs = list(zip(rng.choice(np.append(_DISTS, -1), size=n).tolist(),
                      rng.integers(0, 2, size=n).astype(bool).tolist()))
        cut = int(rng.integers(0, 13))
        assert torch.equal(summary(xs), join_lists(summary(xs[:cut]),
                                                   summary(xs[cut:])))
