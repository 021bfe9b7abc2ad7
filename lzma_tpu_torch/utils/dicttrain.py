"""Trained preset dictionary: fastcover-style segment selection.

The port's own copy of ``train_dictionary`` from
``lzma_tpu/utils/dicttrain.py`` (held equal to it by the tests): count
d-mer hash frequencies over the corpus, score each length-k segment by
its d-mers' frequencies, take the best segment of each epoch while
zeroing the d-mers it covers, and lay the best segments at the END of
the dictionary, nearest the coded data.  The dictionary primes every
lane of an LZTB v3 container (``ops/api.encode_blocks(dictionary=)``).
Pure NumPy, deterministic.  ``select_dictionary`` sizes the dictionary
against its storage cost (``compress(train_dict="auto")``), by the host
encoder's streams (``runtime.native.encode_stream``); where that encoder
cannot be built, it raises.
"""

from __future__ import annotations

import numpy as np

from ..format.properties import LzmaParams
from ..parallel.blocks import MAX_DICT_LEN
from ..runtime import native

_FNV = np.uint64(0x100000001B3)
_MIX = np.uint64(0x9E3779B97F4A7C15)


def _dmer_index(arr: np.ndarray, d: int, table_bits: int) -> np.ndarray:
    """Hash every d-byte window of `arr` into [0, 2^table_bits)."""
    n = arr.shape[0]
    m = n - d + 1
    v = np.zeros(m, dtype=np.uint64)
    for j in range(d):
        v = v * _FNV + arr[j : m + j].astype(np.uint64)
    return ((v * _MIX) >> np.uint64(64 - table_bits)).astype(np.int64)


def train_dictionary(
    data,
    dict_size: int = 1 << 16,
    *,
    k: int = 32,
    d: int = 6,
    table_bits: int = 19,
) -> bytes:
    """Build a preset dictionary of (at most) `dict_size` bytes.

    `data` is the training corpus: bytes-like, or an iterable of
    bytes-like samples (concatenated; d-mers spanning sample boundaries
    are a vanishing fraction and are deliberately not special-cased).
    `k` is the selected-segment length, `d` the match-seed length the
    scorer counts (LZMA finds matches from 2 bytes up, but length-d
    repeats are what a dictionary is for), `table_bits` the frequency
    table size.  Deterministic for fixed inputs.

    Defaults from the measured knee (MEASUREMENTS.md): k=32/d=6 beats
    larger segments on every tested corpus — many short high-frequency
    shards cover more distinct match seeds than few long segments, and
    LZMA's rep-distance machinery stitches adjacent shard hits cheaply.
    table_bits=19 is the measured aliasing knee (17 loses ~0.1pp on MB
    corpora; >=20 is neutral); selection-order and exact-count
    refinements measured neutral-or-worse (tools/dict_proto.py).
    """
    if isinstance(data, (bytes, bytearray, memoryview)):
        buf = bytes(data)
    else:
        buf = b"".join(bytes(s) for s in data)
    if dict_size < 1:
        raise ValueError("dict_size must be >= 1")
    dict_size = min(dict_size, MAX_DICT_LEN)
    n = len(buf)
    if n <= dict_size:
        return buf
    d = max(2, min(d, 16))
    k = max(d, min(k, dict_size, n))

    arr = np.frombuffer(buf, dtype=np.uint8)
    idx = _dmer_index(arr, d, table_bits)
    freq = np.bincount(idx, minlength=1 << table_bits).astype(np.int64)

    num_segments = max(1, dict_size // k)
    if n // num_segments < k:  # corpus too small for that many epochs
        num_segments = max(1, n // k)
    epoch = n // num_segments
    w = k - d + 1  # d-mers per segment

    chosen: list[tuple[int, bytes]] = []
    # a segment is only worth storing if its d-mers still repeat: below
    # ~2 remaining occurrences per d-mer the stored-dictionary stream
    # costs more than the matches it enables (measured, MEASUREMENTS.md)
    min_score = 2 * w
    for s in range(num_segments):
        lo = s * epoch
        hi = n if s == num_segments - 1 else (s + 1) * epoch
        if hi - lo < k:
            continue
        eidx = idx[lo : hi - d + 1]
        f = freq[eidx]
        c = np.cumsum(f)
        # sliding-window sum of length w -> score of segment starting at p
        scores = c[w - 1 :].copy()
        scores[1:] -= c[: len(scores) - 1]
        p = lo + int(np.argmax(scores))
        if scores[p - lo] < min_score:
            continue
        chosen.append((int(scores[p - lo]), buf[p : p + k]))
        # already-covered d-mers stop scoring (the greedy "cover" step)
        freq[idx[p : p + w]] = 0

    if not chosen:
        # nothing clears the score floor: the corpus has no cross-block
        # redundancy a stored dictionary could capture.  Returning b""
        # (no dictionary -> v1 container) is the honest answer; the old
        # buf[:dict_size] prefix fallback made select_dictionary's block
        # sample "win" on block 0 matching its own prefix.
        return b""
    # best segments last = closest to the coded data = cheapest distances
    chosen.sort(key=lambda t: t[0])
    cat = b"".join(seg for _, seg in chosen)
    return cat[-dict_size:]


def select_dictionary(
    data,
    params=None,
    block_size: int = 1 << 20,
    max_size: int = 1 << 16,
    sample_blocks: int = 8,
    **train_kw,
) -> bytes:
    """Train a dictionary and auto-size it against its storage cost.

    A stored dictionary (LZTB v3) is paid for in the container, so the
    right size depends on the data, and on low-redundancy data NO
    dictionary is best.  This trains once at `max_size`, then (the
    trainer lays segments worst to best, so every suffix is itself a
    well-ordered dictionary) scores the suffix lengths max, max/2, ...
    down to 256, and 0, by compressed cost on a spread sample of blocks
    (the payload extrapolated to the full block count, the dictionary's
    own stream included) and returns the cheapest, possibly ``b""``.
    """
    if isinstance(data, (bytes, bytearray, memoryview)):
        buf = bytes(data)
    else:
        buf = b"".join(bytes(s) for s in data)
    params = (params or LzmaParams()).validated_for_encode()
    native.require("select_dictionary")

    def enc(b, pre=b""):
        return native.encode_stream(b, params, preset=pre)

    n_blocks = max(1, (len(buf) + block_size - 1) // block_size)
    k = max(1, min(sample_blocks, n_blocks))
    # evenly spread indices INCLUDING the last block (a stepped slice
    # front-biases the sample whenever n_blocks % k != 0)
    if k == 1:
        idxs = [0]
    else:
        idxs = sorted({round(i * (n_blocks - 1) / (k - 1)) for i in range(k)})
    sample = [buf[i * block_size : (i + 1) * block_size] for i in idxs]
    scale = n_blocks / len(sample)

    trained = train_dictionary(buf, max_size, **train_kw)
    length = len(trained)
    candidates = []
    while length >= 256:
        candidates.append(length)
        length //= 2
    candidates.append(0)
    costs = {}
    for cand in candidates:
        dct = trained[len(trained) - cand :] if cand else b""
        dict_cost = len(enc(dct)) + 8 if dct else 0
        payload = sum(len(enc(b, dct)) for b in sample)
        costs[cand] = dict_cost + payload * scale
    # sampling extrapolation is noisy (blocks containing a segment's own
    # source match it once, which scales misleadingly): take the SMALLEST
    # candidate within 0.2% of the best, so noise-level "wins" collapse
    # to a smaller, or no, dictionary
    floor = min(costs.values()) * 1.002
    cand = min(c for c, cost in costs.items() if cost <= floor)
    return trained[len(trained) - cand :] if cand else b""
