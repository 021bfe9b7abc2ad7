"""Parallel match finding and the lazy parse, in PyTorch.

Port of the RMQ routes of ``lzma_tpu/ops/device_matcher.py``: 4-byte hash
sort-neighbor candidates, exact match lengths from suffix-rank LCP range
minimum queries (prefix doubling to the 273-byte depth), the pointwise
lazy decision, pointer-doubling path marking and prefix-sum compaction;
and, for the optimal parse, the multi-tier candidate lists
(``_rmq_search``) and the rep0 match lengths (``rep_match_lens_rmq``).

The JAX functions run on one lane under ``jax.vmap``; here the lane axis
is written out: every tensor is (N, max_n, ...) and rolls, sorts,
gathers and scatters run along dim 1.  Hashes, packed words and the
``0x80000000 ^ pos`` sentinels are uint32 in the reference; they ride in
int64 here, so their unsigned order is the integer order.
``jnp.lexsort`` (stable, last key first) becomes a chain of stable sorts
from the last key to the first, with two 32-bit keys packed into one
int64 where they fit.
"""

from __future__ import annotations

import torch

MIN_MATCH = 2
MATCH_MAX = 273  # kMatchMaxLen (Base.java:85)

_M32 = 0xFFFFFFFF
_HASH_MULS = (2654435761, 2246822519, 3266489917, 668265263)

#: the optimal parse's search tiers: (bytes hashed, nearest previous
#: occurrences kept), 29 candidates a position before the cap
#: (device_parser.DP_TIERS, with k2 and k3 at _rmq_search's default 1)
DP_TIERS = ((2, 1), (3, 1), (4, 12), (6, 4), (8, 6), (16, 3), (32, 2))
#: unique candidates a position kept before the LCP queries
#: (device_parser.DP_M_CAP, with DP_M_CAP_ORDER "rr")
DP_M_CAP = 12


def _take(best_len, best_dist):
    """Worth-taking heuristic (device_matcher._take): longer matches
    always; len-3 below 64K; len-2 only when the distance is cheap."""
    return (best_len >= 4) | \
           ((best_len == 3) & (best_dist < (1 << 16))) | \
           ((best_len == 2) & (best_dist < (1 << 9)))


def _decide(best_len, best_dist, lazy: bool):
    """(take-as-match, advance) per position (device_matcher._decide);
    `lazy` demotes a match when position i+1 holds a strictly longer
    worthwhile one.  best_len, best_dist: (N, max_n)."""
    take = _take(best_len, best_dist)
    if lazy:
        next_len = torch.roll(best_len, -1, dims=1)
        next_len[:, -1] = 0
        next_take = torch.roll(take, -1, dims=1)
        next_take[:, -1] = False
        take = take & ~(next_take & (next_len > best_len))
    adv = torch.where(take, best_len, 1)
    return take, adv


def _bit_length(x, width: int = 32):
    """Integer bit length of nonnegative x < 2**width (lax.clz's
    complement: 32 - clz(x) for uint32), by binary descent."""
    r = torch.zeros_like(x)
    s = width // 2
    while s:
        big = x >= (1 << s)
        x = torch.where(big, x >> s, x)
        r = r + big * s
        s //= 2
    return r + (x > 0)


def _lead_zero_bytes(x):
    """clz(x) >> 3 for nonzero uint32 x held in int64."""
    return (x < (1 << 24)).long() + (x < (1 << 16)).long() + (x < (1 << 8)).long()


def _scatter_rows(order, values, fill=0):
    """out[lane, order[lane, j]] = values[lane, j] (``.at[order].set``)."""
    out = torch.full_like(values, fill)
    return out.scatter_(1, order, values)


def _lexsort_rows(keys):
    """Stable lexicographic sort of each row by `keys` (last key is the
    primary one, as in jnp.lexsort); ties keep position order.  Keys are
    nonnegative int64 below 2**32.  Adjacent key pairs are packed into
    one int64, (hi - 2**31) * 2**32 + lo, which keeps their order."""
    keys = list(keys)
    packed = []
    while keys:
        hi = keys.pop()
        if keys:
            lo = keys.pop()
            packed.append((hi - (1 << 31)) * (1 << 32) + lo)
        else:
            packed.append(hi)
    # packed[0] is primary: sort by the least significant key first
    order = None
    for key in reversed(packed):
        if order is None:
            order = torch.sort(key, dim=1, stable=True).indices
        else:
            k = key.gather(1, order)
            order = order.gather(1, torch.sort(k, dim=1, stable=True).indices)
    return order


def _hash4(d, pos, n):
    """The 4-byte multiplicative hash of every window, invalid tails given
    unique sentinels (device_matcher.find_best_matches step 1)."""
    h = torch.zeros_like(d)
    for i, mul in enumerate(_HASH_MULS):
        h = h ^ ((torch.roll(d, -i, dims=1) * mul) & _M32)
    valid = pos + 3 < n[:, None]
    return torch.where(valid, h, (0x80000000 ^ pos).expand_as(h))


def _wrap_once(i, max_n: int):
    """One wrap past the end (the reference's ``where(i >= max_n, i -
    max_n, i)``), then the clamp JAX applies to an out-of-range gather
    index; small blocks can step past twice their length."""
    return torch.clamp(torch.where(i >= max_n, i - max_n, i), max=max_n - 1)


def _suffix_rank_lcp(data, n, pos, max_n: int, depth: int):
    """Suffix order by the `depth`-byte prefix, ranks, and the
    consecutive-LCP sparse min table (device_matcher._suffix_rank_lcp).
    data (N, max_n) uint8, n (N,).  Returns (rank (N, max_n) int64,
    T (N, levels, max_n) int32)."""
    N = data.shape[0]
    d = data.long()
    base = min(depth, 32)
    nw = -(-base // 4)
    b = [torch.roll(d, -i, dims=1) for i in range(nw * 4)]
    words = []
    for w in range(nw):
        ww = torch.zeros_like(d)
        for j in range(4):
            ww = ((ww << 8) | (b[w * 4 + j] & 0xFF)) & _M32
        words.append(ww)
    uniq = (0x80000000 ^ pos).expand(N, max_n)
    w0_unmarked = words[0]
    words[0] = torch.where(pos < n[:, None], words[0], uniq)

    # lexsort((pos, *words[::-1])): words[0] primary, position last
    order = _lexsort_rows(words[::-1])
    arange = pos.expand(N, max_n).contiguous()
    rank = _scatter_rows(order, arange)

    if depth <= 32:
        sw = [w.gather(1, order) for w in words]
        cl = torch.zeros_like(d)
        still = torch.ones_like(d, dtype=torch.bool)
        for w in range(nw):
            x = sw[w] ^ torch.roll(sw[w], 1, dims=1)
            eqb = torch.where(x == 0, 4, _lead_zero_bytes(x))
            cl = cl + torch.where(still, torch.clamp(eqb, max=4), 0)
            still = still & (x == 0)
        cl = torch.clamp(cl, max=depth)
        cl[:, 0] = 0
    else:
        # prefix doubling: group ids equal <=> (32 << t)-byte prefixes equal
        sw = [w.gather(1, order) for w in words]
        newg = torch.zeros_like(d, dtype=torch.bool)
        for w in range(nw):
            newg = newg | (sw[w] != torch.roll(sw[w], 1, dims=1))
        newg[:, 0] = True
        grp0 = _scatter_rows(order, torch.cumsum(newg.long(), dim=1) - 1)
        grps = [grp0]
        span = 32
        while span < depth:
            g_hi = grps[-1]
            g_lo = torch.roll(g_hi, -span, dims=1)   # group of suffix i+span
            # lexsort((pos, g_lo, g_hi)): group ids < max_n, one packed key
            order = torch.sort(g_hi * max_n + g_lo, dim=1, stable=True).indices
            sh = g_hi.gather(1, order)
            sl = g_lo.gather(1, order)
            newg = ((sh != torch.roll(sh, 1, dims=1))
                    | (sl != torch.roll(sl, 1, dims=1)))
            newg[:, 0] = True
            grps.append(_scatter_rows(order, torch.cumsum(newg.long(), dim=1) - 1))
            span *= 2
        rank = _scatter_rows(order, arange)

        # consecutive LCP at full depth: binary descent over the levels
        a = order
        ap = torch.roll(order, 1, dims=1)
        l = torch.zeros_like(d)
        for t in range(len(grps) - 2, -1, -1):
            step = 32 << t
            ia = _wrap_once(a + l, max_n)
            ib = _wrap_once(ap + l, max_n)
            eq = grps[t].gather(1, ia) == grps[t].gather(1, ib)
            l = l + torch.where(eq, step, 0)
        # <=32-byte refinement; the first word of each block is the
        # marked one, the rest plain data words
        rem = torch.zeros_like(d)
        still = torch.ones_like(d, dtype=torch.bool)
        for w in range(8):
            src = words[0] if w == 0 else w0_unmarked
            ia = _wrap_once(a + l + 4 * w, max_n)
            ib = _wrap_once(ap + l + 4 * w, max_n)
            x = src.gather(1, ia) ^ src.gather(1, ib)
            eqb = torch.where(x == 0, 4, _lead_zero_bytes(x))
            rem = rem + torch.where(still, torch.clamp(eqb, max=4), 0)
            still = still & (x == 0)
        cl = torch.clamp(l + rem, max=depth)
        cl[:, 0] = 0

    # sparse min table: T[k][j] = min(cl[j - 2^k + 1 .. j]) (wrapping)
    levels = max(1, (max_n - 1).bit_length())
    cl = cl.to(torch.int32)
    T = [cl]
    for k in range(levels - 1):
        T.append(torch.minimum(T[-1], torch.roll(T[-1], 1 << k, dims=1)))
    return rank, torch.stack(T, dim=1)


def _lcp_query(rank, T, q, max_n: int, p=None):
    """Exact LCP(suffix p, suffix q) up to the sort depth
    (device_matcher._lcp_query): two sparse-table gathers per pair.  q
    (N, max_n, K) candidates; p (the same shape) or None for p = every
    position (the reference's rp = rank).  Invalid q (< 0) yields 0."""
    N, levels, _ = T.shape
    if p is None:
        rp = rank[:, :, None]
    else:
        rp = rank.gather(1, torch.clamp(p, 0, max_n - 1).reshape(N, -1)).reshape(p.shape)
    rq = rank.gather(1, torch.clamp(q, 0, max_n - 1).reshape(N, -1)).reshape(q.shape)
    a = torch.minimum(rp, rq) + 1
    bb = torch.maximum(rp, rq)
    w = bb - a + 1
    k = _bit_length(torch.clamp(w, min=1)) - 1
    flat = T.reshape(N, levels * max_n)
    v1 = flat.gather(1, (k * max_n + bb).reshape(N, -1))
    v2 = flat.gather(1, (k * max_n + torch.clamp(a + (torch.ones_like(k) << k) - 1,
                                                max=max_n - 1))
                     .reshape(N, -1))
    lcp = torch.minimum(v1, v2).reshape(q.shape).long()
    return torch.where((q >= 0) & (w >= 1), lcp, 0)


def find_best_matches_rmq(data, n, dict_size: int, fb: int,
                          num_candidates: int = 4):
    """Best (length, distance) per position, every lane at once
    (device_matcher.find_best_matches_rmq).  data (N, max_n) uint8, n
    (N,) lengths.  Candidates are the 4-byte-hash sort neighbours; lengths
    are exact LCPs against a 273-deep suffix order.  Selection ranks by
    min(LCP, fb) with nearest-distance tie-break; the chosen length is
    min(LCP, 273, n - pos).  Returns (best_len, best_dist) (N, max_n)
    int64; dist is the LZMA wire distance (actual - 1)."""
    N, max_n = data.shape
    device = data.device
    pos = torch.arange(max_n, dtype=torch.int64, device=device)
    n = n.long()
    rank, T = _suffix_rank_lcp(data, n, pos, max_n, MATCH_MAX)

    h = _hash4(data.long(), pos, n)
    cand = torch.stack(_neighbor_candidates(h, pos, num_candidates), dim=2)

    p3 = pos[None, :, None]
    in_window = (cand >= 0) & (p3 - cand <= dict_size) & (cand < p3)
    lf = _lcp_query(rank, T, cand, max_n)
    lf = torch.minimum(lf, torch.clamp(n[:, None] - pos, min=0)[:, :, None])
    lf = torch.where(in_window, lf, 0)
    sel_len = torch.clamp(lf, max=fb)

    dist = p3 - cand - 1
    masked_sel = torch.where(in_window, sel_len, -1)
    best_sel = masked_sel.amax(dim=2)
    tied = masked_sel == best_sel[:, :, None]
    best_dist = torch.where(tied, dist, 1 << 30).amin(dim=2)
    chosen = tied & (dist == best_dist[:, :, None])
    best_len = torch.where(chosen, lf, 0).amax(dim=2)
    best_len = torch.where(best_sel >= MIN_MATCH, best_len, 0)
    return best_len, torch.clamp(best_dist, min=0)


def _neighbor_candidates(h, pos, k: int):
    """The k nearest previous positions with the same hash, ranks 1..k
    (device_matcher._neighbor_candidates): one stable sort groups equal
    hashes, and rank j's candidate is the sort neighbour j back.  h (N,
    max_n).  Returns a list of k (N, max_n) tensors, -1 = none."""
    # lexsort((pos, h)): a stable sort of h keeps position order in ties
    order = torch.sort(h, dim=1, stable=True).indices
    sorted_h = h.gather(1, order)
    cands = []
    for j in range(1, k + 1):
        prev = torch.roll(order, j, dims=1)
        same = (torch.roll(sorted_h, j, dims=1) == sorted_h) & (pos >= j)
        cands.append(_scatter_rows(order, torch.where(same, prev, -1), -1))
    return cands


def _mul32(h, m: int):
    """(h * m) mod 2**32 for h < 2**32 held in int64, without passing
    2**63 (a 32x32-bit product would)."""
    lo = (h & 0xFFFF) * m
    hi = (((h >> 16) * m) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _tier_candidates(data, n, pos):
    """The multi-tier candidate build (device_matcher._tier_candidates)
    over DP_TIERS: exact 2/3-byte values and 4/6/8/16/32-byte
    multiplicative hashes, each tier's k nearest previous occurrences.
    data (N, max_n) uint8, n (N,).  Returns cand (N, max_n, 29), tier by
    tier; -1 = no candidate."""
    d = data.long()
    b = [torch.roll(d, -i, dims=1) for i in range(32)]
    uniq = 0x80000000 ^ pos
    n2 = n[:, None]

    def mark(h, span):
        return torch.where(pos + span - 1 < n2, h, uniq)

    def extend(h, lo, hi):
        for i in range(lo, hi):
            h = _mul32(h, _HASH_MULS[0]) ^ ((b[i] * _HASH_MULS[1]) & _M32)
        return mark(h, hi)

    h = {2: mark(b[0] | (b[1] << 8), 2),
         3: mark(b[0] | (b[1] << 8) | (b[2] << 16), 3),
         4: mark(((b[0] * _HASH_MULS[0]) ^ (b[1] * _HASH_MULS[1])
                  ^ (b[2] * _HASH_MULS[2]) ^ (b[3] * _HASH_MULS[3])) & _M32, 4)}
    h[6] = extend(h[4], 4, 6)
    h[8] = extend(h[4], 4, 8)
    h[16] = extend(h[8], 8, 16)
    h[32] = extend(h[16], 16, 32)
    return torch.stack([c for span, k in DP_TIERS
                        for c in _neighbor_candidates(h[span], pos, k)], dim=2)


def _rmq_search(data, n, dict_size: int, fb: int):
    """Ascending (len, dist) candidate lists per position, every lane at
    once (device_matcher._rmq_search at DP_TIERS, m_cap DP_M_CAP,
    m_cap_order "rr"): tier candidates, deduplicated across tiers and
    capped to DP_M_CAP by round-robin tier priority (every tier's rank-1
    candidate first), exact lengths from the fb-deep suffix table, then
    the merge that keeps strictly increasing lengths at ascending
    distance.  data (N, max_n) uint8, n (N,).  Returns (lens (N, max_n,
    M), dists (N, max_n, M), counts (N, max_n), rank, T); the suffix rank
    and min table come back for the rep0 length queries."""
    N, max_n = data.shape
    device = data.device
    pos = torch.arange(max_n, dtype=torch.int64, device=device)
    n = n.long()
    rank, T = _suffix_rank_lcp(data, n, pos, max_n, fb)
    cand = _tier_candidates(data, n, pos)
    big = 1 << 30

    sizes = [k for _, k in DP_TIERS]
    offs = [sum(sizes[:i]) for i in range(len(sizes))]
    perm = [base + r for r in range(max(sizes))
            for sz, base in zip(sizes, offs) if r < sz]
    cp = cand[:, :, perm]
    dup = [torch.zeros_like(cp[:, :, 0], dtype=torch.bool)]
    for j in range(1, cp.shape[2]):
        eqa = (cp[:, :, j:j + 1] == cp[:, :, :j]).any(dim=2)
        dup.append(eqa & (cp[:, :, j] >= 0))
    cp = torch.where(torch.stack(dup, dim=2), -1, cp)
    # pack survivors by priority, truncate, then nearest first
    prio = torch.arange(cp.shape[2], device=device)
    pk = torch.where(cp >= 0, prio, big)
    ordp = torch.sort(pk, dim=2, stable=True).indices[:, :, :DP_M_CAP]
    cp = cp.gather(2, ordp)
    key = torch.sort(torch.where(cp >= 0, -cp, big), dim=2).values
    cand = torch.where(key >= big, -1, -key)
    M = cand.shape[2]

    p3 = pos[None, :, None]
    in_window = (cand >= 0) & (p3 - cand <= dict_size) & (cand < p3)
    length = _lcp_query(rank, T, cand, max_n)
    length = torch.minimum(length, torch.clamp(n[:, None] - pos, min=0)[:, :, None])
    dist = torch.where(in_window, p3 - cand - 1, big)
    length = torch.where(in_window, length, 0)

    # merge: columns are nearest first; keep strictly increasing lengths
    runmax = torch.zeros_like(length[:, :, 0])
    keeps = []
    for j in range(M):
        sl = length[:, :, j]
        keeps.append((sl >= MIN_MATCH) & (sl > runmax) & (dist[:, :, j] < big))
        runmax = torch.maximum(runmax, sl)
    keep = torch.stack(keeps, dim=2)
    tgt = torch.where(keep, torch.cumsum(keep.long(), dim=2) - 1, M)

    def put(values):
        out = torch.zeros((N, max_n, M + 1), dtype=torch.int64, device=device)
        return out.scatter_(2, tgt, values)[:, :, :M]

    return put(length), put(dist), keep.long().sum(dim=2), rank, T


def rep_match_lens_rmq(rank, T, r0pos, n, fb: int):
    """LCP of each position with its rep0 source data[pos - r0pos - 1]
    through the suffix table (device_matcher.rep_match_lens_rmq), capped
    at the table depth (fb) and at n - pos; a source before the block
    yields 0.  rank (N, max_n), r0pos (N, max_n), n (N,)."""
    max_n = rank.shape[1]
    pos = torch.arange(max_n, dtype=torch.int64, device=rank.device)
    src = (pos - r0pos.long() - 1)[:, :, None]
    lcp = _lcp_query(rank, T, src, max_n, p=pos.expand_as(r0pos)[:, :, None])
    return torch.minimum(lcp[:, :, 0], torch.clamp(n.long()[:, None] - pos, min=0))


def greedy_path(best_len, best_dist, n, max_n: int, start: int = 0,
                lazy: bool = False):
    """Mark the greedy/lazy parse path with pointer doubling
    (device_matcher.greedy_path).  advance(i) = best_len[i] when the
    match is worth taking, else 1.  Returns on_path (N, max_n) bool."""
    N = best_len.shape[0]
    device = best_len.device
    pos = torch.arange(max_n, dtype=torch.int64, device=device)
    _, adv = _decide(best_len, best_dist, lazy)
    nxt = torch.clamp(pos + adv, max=max_n)        # sentinel node max_n
    steps = max(1, max_n.bit_length())
    f = torch.cat([nxt, torch.full((N, 1), max_n, dtype=torch.int64,
                                   device=device)], dim=1)
    reach = torch.zeros((N, max_n + 1), dtype=torch.int64, device=device)
    reach[:, start] = 1
    for _ in range(steps):
        hop = torch.where(reach > 0, f, max_n)
        reach = reach.scatter_reduce(1, hop, reach, reduce="amax",
                                     include_self=True)
        f = f.gather(1, f)
    return (reach[:, :max_n] > 0) & (pos < n[:, None])


def _compact(best_len, best_dist, on_path, n, lazy: bool = False):
    """Token stream by prefix-sum compaction (device_matcher._compact).
    Returns (t_pos, t_len, t_dist, t_valid, num_tokens)."""
    N, max_n = best_len.shape
    device = best_len.device
    pos = torch.arange(max_n, dtype=torch.int64, device=device).expand(N, max_n)
    take, _ = _decide(best_len, best_dist, lazy)
    is_match = on_path & take
    t_len = torch.where(is_match, best_len, 1)
    t_dist = torch.where(is_match, best_dist, -1)
    idx = torch.cumsum(on_path.long(), dim=1) - 1
    tgt = torch.where(on_path, idx, max_n)         # column max_n is the sink

    def put(values, fill):
        out = torch.full((N, max_n + 1), fill, dtype=torch.int64, device=device)
        return out.scatter_(1, tgt, values)[:, :max_n]

    num_tokens = on_path.long().sum(dim=1)
    t_valid = torch.arange(max_n, device=device)[None, :] < num_tokens[:, None]
    return put(pos, 0), put(t_len, 1), put(t_dist, -1), t_valid, num_tokens


def tokenize(data, n, dict_size: int, fb: int, num_candidates: int = 4,
             start: int = 0, lazy: bool = True):
    """Parallel tokenization of N blocks (device_matcher.tokenize under
    jax.vmap).  data (N, max_n) uint8, n (N,).  `start` > 0 makes
    data[:, :start] a preset dictionary: searched, never emitted.
    Returns (t_pos, t_len, t_dist, t_valid, ntok); token i covers
    data[t_pos[i] : t_pos[i] + t_len[i]]; t_dist < 0 marks a literal."""
    max_n = data.shape[1]
    best_len, best_dist = find_best_matches_rmq(data, n, dict_size, fb,
                                                num_candidates)
    on_path = greedy_path(best_len, best_dist, n, max_n, start, lazy)
    return _compact(best_len, best_dist, on_path, n, lazy)
