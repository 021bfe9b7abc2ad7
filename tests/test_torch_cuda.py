"""The CUDA kernels against their plain versions, on the card.

Every test takes the `card` fixture, which skips when PyTorch sees no
CUDA device (the decision is made at run time, never at import).  Run on
a machine with an NVIDIA H100 and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -q
"""

import json
import pathlib
import re

import numpy as np
import pytest
import torch

from lzma_tpu.codec.encoder import encode_stream
# the scalar oracle takes lzma_tpu's parameter class; the port reads the
# same fields from either
from lzma_tpu.format.properties import LzmaParams
from lzma_tpu_torch.bench.datagen import generate_bench_data
from lzma_tpu_torch.core.layout import ProbLayout
from lzma_tpu_torch.core.rangecoder import CorruptStreamError
from lzma_tpu_torch.ops import (api, cuda_classify, cuda_decoder, cuda_lower,
                                cuda_parser, cuda_ring, cuda_serializer)
from lzma_tpu_torch.ops.device_decoder import _decode_fsm, pad_rows
from lzma_tpu_torch.ops.device_encoder import (EOS_DIST, K_MATCH,
                                               _append_eos_tokens,
                                               _classify_carry, _classify_rows,
                                               _lower_counts_plain,
                                               _lower_lanes,
                                               _lower_tokens_plain,
                                               classify_tokens, lower_tokens,
                                               serialize, tokenize)
from lzma_tpu_torch.ops.device_decoder import CapExceededError
from lzma_tpu_torch.ops.device_parser import (_lists_and_seed, _round_inputs,
                                              dp_parse_band)
from lzma_tpu_torch.runtime.card import smem_limit

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _blocks(n, size, seed):
    rng = np.random.default_rng(seed)
    bench = generate_bench_data(n * size)
    out = [bench[i * size:(i + 1) * size] for i in range(n)]
    out[-1] = out[-1][: size // 2] + rng.integers(0, 256, size // 4,
                                                  dtype=np.uint8).tobytes()
    return out


def _lowered(blocks, params, dev):
    d, n = pad_rows(blocks, dev)
    return _lower_lanes(d, n, min(params.dict_size, d.shape[1]), params.lc,
                        params.lp, params.pb, params.fast_bytes, 4)


# (8, 4, 2): the largest arena, 3,147,574 probabilities a lane
@pytest.mark.parametrize("lc,lp,pb", [(3, 0, 2), (0, 0, 0), (1, 2, 1), (8, 4, 2)])
def test_serializer_kernel_matches_plain(card, lc, lp, pb):
    params = LzmaParams(lc=lc, lp=lp, pb=pb, dict_size=1 << 12)
    arena = ProbLayout(lc, lp, pb, pos_bits=pb).size
    ctx, bits, totals, max_out = _lowered(_blocks(4, 1024, lc), params, card)
    out, lens, consumed = cuda_serializer.serialize_cuda(ctx, bits, totals,
                                                         arena, int(max_out))
    p_out, p_lens = serialize(ctx, bits, totals, arena, int(max_out))
    torch.cuda.synchronize()
    assert torch.equal(consumed, totals)
    assert torch.equal(lens, p_lens)
    assert torch.equal(out, p_out)


def test_decoder_kernel_matches_plain_with_and_without_preset(card):
    params = LzmaParams(dict_size=1 << 12)
    blocks = _blocks(4, 1024, 7)
    streams = [encode_stream(b, params, mode="greedy") for b in blocks]
    comp, lens = pad_rows(streams, card)
    sizes = torch.tensor([len(b) for b in blocks], dtype=torch.int32, device=card)
    args = (comp, lens, sizes, params.dict_size, 3, 0, 2, 1024)
    k, p = cuda_ring.decode_cuda(*args), _decode_fsm(*args)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert bool(k[1].all())

    preset = blocks[0][:512]
    streams = [encode_stream(b, params, preset=preset, mode="greedy")
               for b in blocks[1:]]
    comp, lens = pad_rows(streams, card)
    sizes = torch.tensor([len(b) + 512 for b in blocks[1:]], dtype=torch.int32,
                         device=card)
    pre = torch.frombuffer(bytearray(preset), dtype=torch.uint8).to(card)
    args = (comp, lens, sizes, params.dict_size, 3, 0, 2, 2048)
    k = cuda_ring.decode_cuda(*args, preset=pre)
    p = _decode_fsm(*args, preset=pre)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    for i, b in enumerate(blocks[1:]):
        assert k[0][i, 512:512 + len(b)].cpu().numpy().tobytes() == b


def test_decoder_kernel_matches_plain_at_the_largest_arena(card):
    params = LzmaParams(lc=8, lp=4, pb=2, dict_size=1 << 12)
    blocks = _blocks(2, 1024, 8)
    streams = [encode_stream(b, params, mode="greedy") for b in blocks]
    comp, lens = pad_rows(streams, card)
    sizes = torch.tensor([len(b) for b in blocks], dtype=torch.int32, device=card)
    args = (comp, lens, sizes, params.dict_size, 8, 4, 2, 1024)
    k, p = cuda_ring.decode_cuda(*args), _decode_fsm(*args)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert bool(k[1].all())
    for i, b in enumerate(blocks):
        assert k[0][i, :len(b)].cpu().numpy().tobytes() == b


def test_decoder_kernel_fails_corrupt_lanes_like_plain(card):
    params = LzmaParams(dict_size=1 << 12)
    payload = generate_bench_data(700)
    good = encode_stream(payload, params, mode="greedy")
    bad = bytearray(good)
    bad[len(good) // 2] ^= 0x5A
    # truncations at many points: some lanes overrun on a literal's last
    # bit, where the FSM still emits the byte before failing
    cuts = [good[:k] for k in range(40, len(good) - 20, (len(good) - 60) // 24)]
    streams = [bytes(bad)] + cuts + [good, good]
    sizes = [700] * (1 + len(cuts)) + [750, 650]
    comp, lens = pad_rows(streams, card)
    for dict_size in (1 << 12, 16):
        args = (comp, lens, torch.tensor(sizes, dtype=torch.int32, device=card),
                dict_size, 3, 0, 2, 1024)
        k_out, k_ok, k_pos = cuda_ring.decode_cuda(*args)
        p_out, p_ok, p_pos = _decode_fsm(*args)
        assert torch.equal(k_ok, p_ok) and torch.equal(k_pos, p_pos)
        assert torch.equal(k_out, p_out)
        assert not bool(k_ok[:1 + len(cuts)].any())
    with pytest.raises(CorruptStreamError):
        cuda_ring.decode_batch_cuda([bytes(bad)], params, [700], device=card)


def test_eos_lane_on_the_card(card):
    params = LzmaParams(dict_size=1 << 12, write_eos=True)
    payload = generate_bench_data(900)
    stream = encode_stream(payload, params, mode="greedy")
    assert cuda_ring.decode_batch_cuda([stream], params, [-4096],
                                       device=card) == [payload]
    with pytest.raises(CorruptStreamError):
        cuda_ring.decode_batch_cuda([stream], params, [-600], device=card)


def test_block_codec_runs_both_kernels(card):
    data = generate_bench_data(20000)
    params = LzmaParams(dict_size=1 << 14)
    enc0, dec0 = cuda_serializer.LAUNCHES, cuda_ring.LAUNCHES
    blob = api.encode_blocks(data, params, block_size=4096, device=card)
    assert blob == api.encode_blocks(data, params, block_size=4096, device="cpu")
    assert api.decode_blocks(blob, device=card) == data
    assert cuda_serializer.LAUNCHES > enc0 and cuda_ring.LAUNCHES > dec0


def test_wrappers_reject_bad_dtype_and_device(card):
    ctx = torch.zeros((2, 8), dtype=torch.int32, device=card)
    totals = torch.zeros((2,), dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        cuda_serializer.serialize_cuda(ctx.long(), ctx, totals, 16, 32)
    with pytest.raises(ValueError):
        cuda_serializer.serialize_cuda(ctx, ctx, totals.cpu(), 16, 32)
    comp = torch.zeros((2, 16), dtype=torch.uint8, device=card)
    lens = torch.full((2,), 16, dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        cuda_ring.decode_cuda(comp.int(), lens, lens, 1 << 12, 3, 0, 2, 64)
    with pytest.raises(ValueError):
        cuda_ring.decode_cuda(comp, lens.cpu(), lens, 1 << 12, 3, 0, 2, 64)


def _dp_inputs(blocks, fb, pb, dev, lc=3, lp=0):
    """The first round's DP inputs for `blocks`, built on `dev`."""
    data, lens = pad_rows(blocks, dev)
    ld, dd, tokens, suffix = _lists_and_seed(data, lens, data.shape[1], fb)
    packed, tables = _round_inputs(data, lens, tokens, ld, dd, suffix, lc, lp,
                                   pb, fb)
    return packed, tables, lens


@pytest.mark.parametrize("fb", [5, 32, 273])
@pytest.mark.parametrize("pb", [0, 4])
def test_dp_parse_kernel_matches_plain(card, fb, pb):
    blocks = _blocks(4, 512, fb + pb)
    blocks[1] = blocks[1][:300]           # ragged lanes
    packed, tables, lens = _dp_inputs(blocks, fb, pb, card)
    before = cuda_parser.LAUNCHES
    k_from, k_choice = cuda_parser.dp_parse_cuda(packed, tables, lens, fb, pb)
    p_from, p_choice = dp_parse_band(packed, tables, lens, fb, pb)
    torch.cuda.synchronize()
    assert cuda_parser.LAUNCHES == before + 1
    assert torch.equal(k_from, p_from)
    assert torch.equal(k_choice, p_choice)


@pytest.mark.parametrize("fb", [5, 32, 273])
@pytest.mark.parametrize("pb", [0, 4])
def test_dp_parse2_kernel_matches_plain_and_k3(card, fb, pb):
    blocks = _blocks(4, 512, fb + pb + 1)
    blocks[2] = blocks[2][:200]           # ragged lanes
    packed, tables, lens = _dp_inputs(blocks, fb, pb, card)
    before, k3_before = cuda_parser.LAUNCHES2, cuda_parser.LAUNCHES
    k_from, k_choice = cuda_parser.dp_parse2_cuda(packed, tables, lens, fb, pb)
    p_from, p_choice = dp_parse_band(packed, tables, lens, fb, pb)
    torch.cuda.synchronize()
    assert cuda_parser.LAUNCHES2 == before + 1
    assert cuda_parser.LAUNCHES == k3_before
    assert torch.equal(k_from, p_from)
    assert torch.equal(k_choice, p_choice)
    assert all(torch.equal(a, b) for a, b in zip(
        cuda_parser.dp_parse_cuda(packed, tables, lens, fb, pb), (k_from, k_choice)))


@pytest.mark.parametrize("scan_fn", ["dp_parse_cuda", "dp_parse2_cuda"])
def test_dp_parse_wrapper_rejects_bad_dtype_and_device(card, scan_fn):
    fn = getattr(cuda_parser, scan_fn)
    packed, tables, lens = _dp_inputs(_blocks(2, 256, 1), 32, 2, card)
    with pytest.raises(TypeError):
        fn(packed.long(), tables, lens, 32, 2)
    with pytest.raises(ValueError):
        fn(packed, tables, lens.cpu(), 32, 2)
    with pytest.raises(ValueError):
        fn(packed, tables, lens, 32, 3)  # table size
    with pytest.raises(ValueError):      # over MAX_PAIRS pairs a row
        fn(_with_pairs(packed, cuda_parser.MAX_PAIRS + 1), tables, lens, 32, 2)


# K3 and K4 at their tile edges: n_pos under one tile (64 rows), a whole
# tile, not a multiple of it, and 1,041 rows (a lane's base, lane * 1041
# * 116 B, is not 16-byte aligned); lane 1 has len 0, lane 2 is ragged;
# fb 8 relaxes a length on 4 lanes, a lane a pair, fb 100 on one thread a
# length
_SCANS = {"dp_parse_cuda": "LAUNCHES", "dp_parse2_cuda": "LAUNCHES2"}


@pytest.mark.parametrize("scan_fn", list(_SCANS))
@pytest.mark.parametrize("n_pos", [37, 64, 200, 1041])
@pytest.mark.parametrize("fb", [8, 100])
def test_dp_parse_kernel_at_tile_edges_and_unaligned_lanes(card, n_pos, fb,
                                                           scan_fn):
    blocks = _blocks(3, 1100, n_pos + fb)
    packed, tables, lens = _dp_inputs(blocks, fb, 2, card)
    packed = packed[:, :n_pos].contiguous()
    lens = torch.clamp(lens, max=n_pos)
    lens[1] = 0
    lens[2] = n_pos * 2 // 3
    assert (packed.shape[1] * packed.shape[2] * 4) % 16 or n_pos != 1041
    before = getattr(cuda_parser, _SCANS[scan_fn])
    k = getattr(cuda_parser, scan_fn)(packed, tables, lens, fb, 2)
    p = dp_parse_band(packed, tables, lens, fb, 2)
    torch.cuda.synchronize()
    assert getattr(cuda_parser, _SCANS[scan_fn]) == before + 1
    for a, b in zip(k, p):
        assert torch.equal(a, b)


def _with_pairs(packed, M):
    """The route's rows (M_DP = 4 pairs) cut to or widened to M pairs
    (the extra pairs repeat the first ones): ld, dd, dcost, the tail."""
    idx = [k % 4 for k in range(M)]
    ld, dd = packed[..., :4], packed[..., 4:8]
    dc = packed[..., 8:24].reshape(*packed.shape[:2], 4, 4)
    return torch.cat([ld[..., idx], dd[..., idx],
                      dc[..., idx, :].reshape(*packed.shape[:2], 4 * M),
                      packed[..., 24:]], dim=2).contiguous()


# K3 and K4 with other pair counts than the route's 4: fewer (lanes of a
# length left idle) and more (one thread a length, up to 16 pairs)
@pytest.mark.parametrize("scan_fn", list(_SCANS))
@pytest.mark.parametrize("M", [2, 6])
def test_dp_parse_kernel_with_other_pair_counts(card, M, scan_fn):
    packed, tables, lens = _dp_inputs(_blocks(3, 512, M), 32, 2, card)
    packed = _with_pairs(packed, M)
    assert packed.shape[2] == 6 * M + 5
    k = getattr(cuda_parser, scan_fn)(packed, tables, lens, 32, 2)
    p = dp_parse_band(packed, tables, lens, 32, 2)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert torch.equal(a, b)


def _pair_streams(n_lanes, n_bits, arena, seed):
    """Synthetic (ctx, bit) rows: adaptive slots over the arena with runs
    of one slot, direct bits (-1) and a run of padding (-3) in each lane."""
    rng = np.random.default_rng(seed)
    ctx = rng.integers(0, arena, (n_lanes, n_bits))
    ctx[:, 1::7] = ctx[:, 0::7][:, :ctx[:, 1::7].shape[1]]   # repeated slots
    ctx[rng.random((n_lanes, n_bits)) < 0.1] = -1
    for k in range(n_lanes):
        at = int(rng.integers(0, n_bits - 40))
        ctx[k, at:at + 37] = -3
    bits = (rng.random((n_lanes, n_bits)) < 0.3).astype(np.int64)
    return ctx, bits


# K2 at its tile edges (1,024 pairs a tile), in both arena placements
# (lc3 lp0's arena in shared memory; the same streams with lc8 lp4's
# arena size, over the card's shared memory, in device memory): totals
# 0, one under / at / over a tile, over n_bits (the last pair repeats),
# n_bits = 4,097 (rows not 16-byte aligned); max_out 300 makes the long
# lanes overflow in their third tile
@pytest.mark.parametrize("placement", ["shared", "device"])
@pytest.mark.parametrize("max_out", [1 << 13, 300])
def test_serializer_kernel_at_tile_edges_in_both_placements(card, placement,
                                                            max_out):
    slots = ProbLayout(3, 0, 2, pos_bits=2).size
    arena = slots if placement == "shared" else ProbLayout(8, 4, 2, pos_bits=2).size
    assert cuda_serializer.arena_placement(arena, smem_limit(card.index or 0)) == placement
    n_bits = 4097
    ctx, bits = _pair_streams(7, n_bits, slots, max_out)
    totals = [0, 1023, 1024, 1025, 2049, n_bits, n_bits + 9]
    ctx, bits, totals = (torch.tensor(x, dtype=torch.int32, device=card)
                         for x in (ctx, bits, totals))
    before = cuda_serializer.LAUNCHES
    out, lens, consumed = cuda_serializer.serialize_cuda(ctx, bits, totals,
                                                         arena, max_out)
    p_out, p_lens = serialize(ctx, bits, totals, arena, max_out)
    torch.cuda.synchronize()
    assert cuda_serializer.LAUNCHES == before + 1
    assert torch.equal(lens, p_lens) and torch.equal(out, p_out)
    assert torch.equal(consumed, torch.where(p_lens > max_out, -1, totals))
    if max_out == 300:
        assert torch.equal(consumed[:4], totals[:4])
        assert (consumed[5:] == -1).all()


def test_serializer_placement_is_chosen_and_never_switched(card):
    limit = smem_limit(card.index or 0)
    for lc, lp in ((0, 0), (3, 0), (4, 3), (8, 0), (8, 4)):
        arena = ProbLayout(lc, lp, 2, pos_bits=2).size
        placement = cuda_serializer.arena_placement(arena, limit)
        assert placement == ("shared" if lc + lp <= 7 else "device")
        assert cuda_serializer.smem_bytes(placement, arena) <= limit


def test_optimal_encode_on_the_card_equals_the_cpu(card):
    data = generate_bench_data(20000)
    params = LzmaParams(dict_size=1 << 14)
    dp0, enc0 = cuda_parser.LAUNCHES, cuda_serializer.LAUNCHES
    blob = api.encode_blocks(data, params, block_size=4096, parse="optimal",
                             device=card)
    assert cuda_parser.LAUNCHES >= dp0 + 2 and cuda_serializer.LAUNCHES > enc0
    assert blob == api.encode_blocks(data, params, block_size=4096,
                                     parse="optimal", device="cpu")
    assert api.decode_blocks(blob, device=card) == data


# ---------------------------------------------- K6: the classify carry
def _token_rows(T, N, seed, gaps):
    """Random token rows (T, N): literals, fresh matches, rep hits, EOS
    markers and short reps; each lane valid up to its own end, with
    invalid tokens inside where `gaps`."""
    rng = np.random.default_rng(seed)
    kind = rng.random((T, N))
    dist = np.where(kind < 0.4, -1, np.where(kind < 0.7, rng.integers(0, 6, (T, N)),
                                             rng.integers(0, 1 << 20, (T, N))))
    dist = np.where(rng.random((T, N)) < 0.02, EOS_DIST, dist)
    ln = rng.integers(1, 274, (T, N))
    valid = np.arange(T)[:, None] < rng.integers(0, T + 1, N)[None, :]
    if gaps:
        valid &= rng.random((T, N)) > 0.1
    return (torch.from_numpy(dist.astype(np.int32)),
            torch.from_numpy(ln.astype(np.int32)), torch.from_numpy(valid))


def _carry_on_card(rows, dev):
    before = cuda_classify.LAUNCHES
    got = cuda_classify.classify_carry_cuda(*(r.to(dev) for r in rows))
    torch.cuda.synchronize()
    assert cuda_classify.LAUNCHES == before + (rows[0].numel() > 0)
    return [g.cpu() for g in got]


# lanes of 0, 1 and 2 tokens; a lane per thread of one warp, of 33 (a
# second block), of 65; all-valid prefixes and invalid gaps
@pytest.mark.parametrize("T,N", [(0, 3), (1, 1), (2, 2), (3, 1), (37, 33),
                                 (300, 64), (129, 65)])
@pytest.mark.parametrize("gaps", [False, True])
def test_classify_kernel_matches_plain(card, T, N, gaps):
    rows = _token_rows(T, N, T * 7 + N, gaps)
    for g, w in zip(_carry_on_card(rows, card), _classify_carry(*rows)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dist", [-1, 0, 5, EOS_DIST])
def test_classify_kernel_on_one_kind_lanes(card, dist):
    """All literals, all rep0 (dist 0 at the start), all rep hits of a
    fresh distance, all EOS markers; lens 1 and 2 (short and long reps)."""
    T, N = 64, 4
    d = torch.full((T, N), dist, dtype=torch.int32)
    ln = torch.tensor([1, 2, 1, 2], dtype=torch.int32).expand(T, N).contiguous()
    v = torch.ones((T, N), dtype=torch.bool)
    v[:, 3] = torch.arange(T) < 17
    for g, w in zip(_carry_on_card((d, ln, v), card), _classify_carry(d, ln, v)):
        assert torch.equal(g, w)


def _classify_constant(name):
    """A ``constexpr int`` of csrc/classify.cu, read from the source."""
    src = (pathlib.Path(cuda_classify.__file__).parent.parent / "csrc"
           / "classify.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


# K6 at its chunk and tile edges: T around a chunk (kChunk rows of a lane
# a thread) and around a tile (kThreads / W chunks of W lanes, W
# = N up to 32 rounded up to a power of two: 4,096 rows at N = 1, 1,024
# at N = 3, 128 at N = 32 and 33); N = 33 adds a second, one-lane-wide
# column of tiles.  T = k K + r R + c: 1, K-1, K, K+1, 8K+3, R-1, R, R+1
# and 3R+5
@pytest.mark.parametrize("N", [1, 3, 32, 33])
@pytest.mark.parametrize("k,r,c", [(0, 0, 1), (1, 0, -1), (1, 0, 0),
                                   (1, 0, 1), (8, 0, 3), (0, 1, -1),
                                   (0, 1, 0), (0, 1, 1), (0, 3, 5)])
def test_classify_kernel_at_chunk_and_tile_edges(card, N, k, r, c):
    K = _classify_constant("kChunk")
    W = min(32, 1 << (N - 1).bit_length())
    T = k * K + r * (_classify_constant("kThreads") // W * K) + c
    rows = _token_rows(T, N, T * 5 + N, True)
    for g, w in zip(_carry_on_card(rows, card), _classify_carry(*rows)):
        assert torch.equal(g, w)


def test_classify_kernel_on_lanes_with_no_valid_row(card):
    """Every lane invalid; then every other lane invalid: the reps stay
    (0, 0, 0, 0) and the state 0 over the whole lane, and each row's
    case is its dist's against those."""
    rows = _token_rows(600, 9, 17, True)
    none = (rows[0], rows[1], torch.zeros_like(rows[2]))
    some = (rows[0], rows[1], rows[2] & (torch.arange(9) % 2 == 0))
    for r in (none, some):
        for g, w in zip(_carry_on_card(r, card), _classify_carry(*r)):
            assert torch.equal(g, w)


def test_classify_kernel_on_one_lane_of_2_20_rows(card):
    """One lane of 2^20 random rows (256 tiles of 4,096 rows) against the
    scalar carry."""
    T = 1 << 20
    rows = _token_rows(T, 1, 20, True)
    rows[2][: T - 5, 0] = rows[2][: T - 5, 0] | (torch.arange(T - 5) % 7 == 0)
    got = _carry_on_card(rows, card)
    want = _carry_scalar(rows[0][:, 0], rows[1][:, 0], rows[2][:, 0])
    for g, w in zip(got, want):
        assert torch.equal(g[:, 0], w)


@pytest.mark.parametrize("parse", ["lazy", "optimal"])
def test_classify_on_the_card_equals_the_cpu_with_eos_tokens(card, parse):
    blocks = _blocks(4, 2048, 3)
    data, lens = pad_rows(blocks, "cpu")
    if parse == "lazy":
        tok = tokenize(data, lens, 2048, 32, 4)
    else:
        from lzma_tpu_torch.ops.device_parser import tokenize_optimal

        tok = tokenize_optimal(data, lens, 2048, lc=3, lp=0, pb=2, fb=32)
    toks = _append_eos_tokens(*tok[:4], tok[4], lens)
    want = classify_tokens(data, *toks)
    before = cuda_classify.LAUNCHES, cuda_classify.TOKEN_LAUNCHES
    got = classify_tokens(data.to(card), *(t.to(card) for t in toks))
    assert (cuda_classify.LAUNCHES, cuda_classify.TOKEN_LAUNCHES) == \
        (before[0], before[1] + 1)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _carry_scalar(dist_r, len_r, valid_r):
    """A scalar restatement of the carry (one lane): the reference's
    is_r0..is_r3 chain and Base.java's state updates."""
    state, reps = 0, [0, 0, 0, 0]
    out = []
    for d, ln, v in zip(dist_r.tolist(), len_r.tolist(), valid_r.tolist()):
        lit = d < 0 and d != EOS_DIST
        hit = next((k for k in range(4) if reps[k] == d), None)
        case = 5 if lit else 0 if hit is None else hit + 1
        out.append((case, state, reps[0]))
        if not v:
            continue
        if lit:
            state = 0 if state < 4 else state - 3 if state < 10 else state - 6
            continue
        reps = [d] + [r for k, r in enumerate(reps) if k != (hit if hit is not
                                                              None else 3)]
        if case == 0:
            state = 7 if state < 7 else 10
        else:
            state = (9 if ln < 2 else 8) if state < 7 else 11
    return [torch.tensor([o[k] for o in out], dtype=torch.int32)
            for k in range(3)]


def test_classify_kernel_on_a_one_lane_mib_stream(card):
    """One lane of 1 MiB (the lazy parse's ~390K tokens and the EOS
    marker): the kernel equals a scalar restatement of the carry, and the
    `.lzma` file it helps encode reads back through the stdlib."""
    import lzma

    data = generate_bench_data(1 << 20)
    d, n = pad_rows([data], card)
    tok = tokenize(d, n, 1 << 20, 32, 4)
    toks = _append_eos_tokens(*tok[:4], tok[4], n)
    rows = [r.cpu() for r in _classify_rows(toks[1], toks[2], toks[3])]
    got = _carry_on_card(rows, card)
    want = _carry_scalar(rows[0][:, 0], rows[1][:, 0], rows[2][:, 0])
    for g, w in zip(got, want):
        assert torch.equal(g[:, 0], w)
    params = LzmaParams(write_eos=True)
    blob = api.encode_alone(data, params, device=card)
    assert lzma.decompress(blob, format=lzma.FORMAT_ALONE) == data
    assert api.decode_alone(blob, device=card) == data


def test_classify_wrapper_rejects_bad_dtype_and_device(card):
    d = torch.zeros((4, 2), dtype=torch.int32, device=card)
    v = torch.ones((4, 2), dtype=torch.bool, device=card)
    with pytest.raises(TypeError):
        cuda_classify.classify_carry_cuda(d.long(), d, v)
    with pytest.raises(TypeError):
        cuda_classify.classify_carry_cuda(d, d, v.int())
    with pytest.raises(ValueError):
        cuda_classify.classify_carry_cuda(d, d.cpu(), v)
    with pytest.raises(ValueError):
        cuda_classify.classify_carry_cuda(d, d[:2], v)
    with pytest.raises(ValueError):
        cuda_classify.classify_carry_cuda(d.T, d.T, v.T)


# ------------------------------------------------ K7: the bit lowering
def _lower_inputs(counts, seed, dev, lc=3, lp=0, pb=2, pos_base=0,
                  max_bits=None):
    """lower_tokens_cuda's arguments on `dev` for lanes of `counts` valid
    tokens each (literals, fresh matches over every slot band, reps of the
    lane's last distances, short reps, the EOS marker at each lane's end),
    in T = 2 max(counts) + 8 slots (a parse's long tokens fit T // 2 + 2),
    classified by the port's classify_tokens on `dev`."""
    rng = np.random.default_rng(seed)
    N, T = len(counts), 2 * max(counts, default=0) + 8
    t_pos = np.zeros((N, T), np.int64)
    t_len = np.ones((N, T), np.int64)
    t_dist = np.full((N, T), -1, np.int64)
    end = 0
    for i, c in enumerate(counts):
        u = rng.random(c)
        band = rng.integers(0, 5, c)
        fresh = np.select([band == 0, band == 1, band == 2, band == 3],
                          [rng.integers(0, 4, c), rng.integers(4, 128, c),
                           rng.integers(128, 1 << 20, c),
                           rng.integers(1 << 20, 1 << 27, c)],
                          rng.integers(1 << 27, 1 << 31, c))
        ln = np.where(rng.random(c) < 0.5, rng.choice([2, 9, 17, 273], c),
                      rng.integers(2, 274, c))
        lit = u < 0.4
        rep = (u >= 0.4) & (u < 0.65) & (np.arange(c) >= 4)
        back = rng.integers(1, 5, c)
        d = np.where(lit, -1, fresh)
        for j in np.nonzero(rep)[0]:
            d[j] = d[j - back[j]] if d[j - back[j]] >= 0 else d[j]
        ln = np.where(lit, 1, np.where(rep & (rng.random(c) < 0.2), 1, ln))
        if not c:
            continue
        d[-1], ln[-1] = EOS_DIST, 2
        pos = pos_base + np.concatenate([[0], np.cumsum(ln)[:-1]])
        t_pos[i, :c], t_len[i, :c], t_dist[i, :c] = pos, ln, d
        end = max(end, int(pos[-1]) + 2)
    t_valid = np.arange(T)[None, :] < np.array(counts)[:, None]
    data = torch.from_numpy(rng.integers(0, 256, (N, max(end, pos_base + 1)),
                                         dtype=np.uint8)).to(dev)
    tok = [torch.from_numpy(a).to(dev) for a in (t_pos, t_len, t_dist, t_valid)]
    meta = tuple(m.long() for m in classify_tokens(data, *tok))
    if max_bits is None:
        max_bits = 50 * T + 128
    return (meta, *tok, lc, lp, pb, max_bits, pos_base)


def _lower_on_card(args):
    """K7 on the card against the plain version on the same card tensors;
    one launch."""
    before = cuda_lower.LAUNCHES
    got = cuda_lower.lower_tokens_cuda(*args)
    torch.cuda.synchronize()
    assert cuda_lower.LAUNCHES == before + 1
    want = _lower_tokens_plain(*args)
    for name, g, w in zip(("ctx", "bits", "total"), got, want):
        assert g.dtype == w.dtype == torch.int32, name
        assert torch.equal(g, w), name
    return got


def _lower_constant(name):
    """A ``constexpr int`` of csrc/lower.cu, read from the source."""
    src = (pathlib.Path(cuda_lower.__file__).parent.parent / "csrc"
           / "lower.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


# K7 at its tile edges: lanes of a tile (kTile tokens) - 1, + 0, + 1, two
# and three tiles and some, of 0 and 1 token; N = 1, 3 and 33 (blocks run
# lanes fastest)
@pytest.mark.parametrize("N", [1, 3, 33])
def test_lower_kernel_at_tile_edges(card, N):
    K = _lower_constant("kThreads") * _lower_constant("kRounds")
    sizes = [0, 1, K - 1, K, K + 1, 2 * K + 1, 3 * K + 5]
    counts = [sizes[(i * 5 + N) % len(sizes)] for i in range(N)]
    counts[-1] = K + 1 if N > 1 else K - 1
    _lower_on_card(_lower_inputs(counts, N, card))


def test_lower_kernel_on_one_lane_of_2_20_tokens(card):
    """One lane of 2^20 + 3 tokens spread over 1,025 tiles."""
    _, _, total = _lower_on_card(_lower_inputs([(1 << 20) + 3], 7, card))
    assert int(total[0]) > 1 << 20


@pytest.mark.parametrize("parse", ["lazy", "optimal"])
def test_lower_kernel_on_both_parses_with_eos_tokens(card, parse):
    """The lazy and the optimal parse's tokens of 4 lanes, the EOS marker
    appended, classified on the card: K7 = the plain version, and the
    lowering on the card = on the CPU."""
    blocks = _blocks(4, 4096, 5)
    data, lens = pad_rows(blocks, card)
    if parse == "lazy":
        tok = tokenize(data, lens, 4096, 32, 4)
    else:
        from lzma_tpu_torch.ops.device_parser import tokenize_optimal

        tok = tokenize_optimal(data, lens, 4096, lc=3, lp=0, pb=2, fb=32)
    toks = _append_eos_tokens(*tok[:4], tok[4], lens)
    meta = tuple(m.long() for m in classify_tokens(data, *toks))
    args = (meta, *toks, 3, 0, 2, 10 * data.shape[1] + 128, 0)
    got = _lower_on_card(args)
    cpu = lower_tokens(None, tuple(m.cpu() for m in meta),
                       *(t.cpu() for t in toks), 3, 0, 2, args[8])
    for g, w in zip(got, cpu):
        assert torch.equal(g.cpu(), w)


def test_lower_kernel_at_lc8_lp4_pb4_with_a_preset(card):
    """The port's encoder's own lowering of a preset-primed batch at lc8
    lp4 pb4 (coded positions from pos_base), and synthetic lanes at an
    odd pos_base."""
    from lzma_tpu_torch.ops.device_encoder import encode_batch, probing

    blocks = _blocks(3, 2048, 11)
    with probing() as probe:
        encode_batch(blocks, LzmaParams(lc=8, lp=4, pb=4),
                     preset=blocks[0][:700], device=card)
    assert probe["lower_args"][-1] == 700
    _lower_on_card(probe["lower_args"])
    _lower_on_card(_lower_inputs([300, 1500, 0], 3, card, lc=8, lp=4, pb=4,
                                 pos_base=1001))


def test_lower_kernel_raises_where_the_plain_version_raises(card):
    """max_bits one below the longest lane's total, then below a middle
    lane's only; more long tokens than T // 2 + 2: the plain version's
    ValueError, after one launch; a total equal to max_bits passes."""
    args = list(_lower_inputs([700, 1300, 40], 13, card))
    total = _lower_on_card(tuple(args))[2]
    for cap, lane in ((int(total.max()), None), (int(total[1]), 1)):
        args[8] = cap
        if lane is None:
            _lower_on_card(tuple(args))              # exactly full: fits
        args[8] = cap - 1
        for fn in (cuda_lower.lower_tokens_cuda, _lower_tokens_plain):
            with pytest.raises(ValueError, match="exceed"):
                fn(*args)
    args = list(_lower_inputs([600], 17, card))
    T = args[1].shape[1]
    args[0] = tuple(torch.full_like(m, K_MATCH) if k == 0 else m
                    for k, m in enumerate(args[0]))
    args[2] = torch.full_like(args[2], 3)           # every token a match
    args[4] = torch.arange(T, device=card)[None] < T // 2 + 3
    for fn in (cuda_lower.lower_tokens_cuda, _lower_tokens_plain):
        with pytest.raises(ValueError, match="long tokens"):
            fn(*args)


def test_lower_kernel_reads_strided_planes(card):
    """Planes transposed (the classify finish's layout), sliced out of
    wider rows (the compaction's) and expanded along a lane give the
    contiguous planes' result."""
    args = _lower_inputs([500, 900, 20, 1100], 19, card)
    want = _lower_on_card(args)
    meta, t_pos, t_len, t_dist, t_valid = args[:5]
    strided = []
    for k, x in enumerate((*meta, t_pos, t_len, t_dist)):
        if k % 2:
            x = x.T.contiguous().T                   # stride (1, N)
        else:
            x = torch.cat([x, x[:, :5]], dim=1)[:, :x.shape[1]]
        strided.append(x)
    assert not strided[1].is_contiguous() and not strided[0].is_contiguous()
    got = _lower_on_card((tuple(strided[:7]), *strided[7:], t_valid.T
                          .contiguous().T, *args[5:]))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # one lane's planes expanded to 3 lanes (stride 0) = that lane thrice
    one = [x[2:3] for x in (*meta, t_pos, t_len, t_dist, t_valid)]
    wide = [x.expand(3, -1) for x in one]
    got = _lower_on_card((tuple(wide[:7]), *wide[7:], *args[5:]))
    assert torch.equal(got[0], want[0][2:3].expand(3, -1))


def test_lower_kernel_on_empty_shapes(card):
    """No token slots, or no lanes: every slot fill, every total 0, and
    no launch."""
    for N, T in ((3, 0), (0, 7)):
        z = torch.zeros((N, T), dtype=torch.int64, device=card)
        args = (tuple(z for _ in range(7)), z, z + 1, z - 1, z.bool(), 3, 0,
                2, 64, 0)
        before = cuda_lower.LAUNCHES
        got = cuda_lower.lower_tokens_cuda(*args)
        assert cuda_lower.LAUNCHES == before
        for g, w in zip(got, _lower_tokens_plain(*args)):
            assert torch.equal(g, w)


def test_lower_wrapper_rejects_bad_dtype_device_and_layout(card):
    args = list(_lower_inputs([10, 20], 23, card))
    bad = [
        (TypeError, 1, args[1].int()),                      # t_pos int32
        (TypeError, 4, args[4].int()),                      # t_valid int32
        (ValueError, 3, args[3].cpu()),                     # another device
        (ValueError, 2, args[2][:1]),                       # another shape
        (ValueError, 1, args[1].to_sparse()),               # not strided
    ]
    for err, k, x in bad:
        a = list(args)
        a[k] = x
        with pytest.raises(err):
            cuda_lower.lower_tokens_cuda(*a)
    with pytest.raises(TypeError):
        cuda_lower.lower_tokens_cuda(tuple(m.int() for m in args[0]), *args[1:])
    with pytest.raises(ValueError):
        cuda_lower.lower_tokens_cuda(args[0][:6], *args[1:])


# ------------------------------------- K8: the lowering's slot counts
def _counts_on_card(args):
    """K8 on the card against the plain version on the same card tensors;
    one launch, no launch of K7."""
    before = cuda_lower.COUNT_LAUNCHES, cuda_lower.LAUNCHES
    got = cuda_lower.lower_counts_cuda(*args)
    torch.cuda.synchronize()
    assert (cuda_lower.COUNT_LAUNCHES, cuda_lower.LAUNCHES) == (
        before[0] + 1, before[1])
    want = _lower_counts_plain(*args)
    for name, g, w in zip(("n", "n1", "total"), got, want):
        assert g.dtype == w.dtype == torch.int32, name
        assert torch.equal(g, w), name
    return got


# K8 at its round and lane edges: lanes of a round (kThreads tokens) - 1,
# + 0, + 1, four and nine rounds and some, of 0 and 1 token, and one lane
# far longer than the rest; N = 1, 3 and 33 (blocks run lanes fastest);
# the histogram in shared memory (lc3 lp0 pb2) and in device memory (lc8
# lp4 pb4)
@pytest.mark.parametrize("lc, lp, pb", [(3, 0, 2), (8, 4, 4)],
                         ids=["shared", "device"])
@pytest.mark.parametrize("N", [1, 3, 33])
def test_lower_counts_kernel_at_round_and_lane_edges(card, N, lc, lp, pb):
    R = _lower_constant("kThreads")
    sizes = [0, 1, R - 1, R, R + 1, 4 * R + 3, 9 * R + 5]
    counts = [sizes[(i * 3 + N) % len(sizes)] for i in range(N)]
    counts[-1] = 100 * R + 7 if N > 1 else R - 1
    S = ProbLayout(lc, lp, pb, pos_bits=pb).size
    assert cuda_lower.count_placement(S, smem_limit(0)) == (
        "shared" if lc == 3 else "device")
    _counts_on_card(_lower_inputs(counts, 40 + N, card, lc=lc, lp=lp, pb=pb))


@pytest.mark.parametrize("lc, lp, pb", [(3, 0, 2), (8, 4, 4)],
                         ids=["shared", "device"])
def test_lower_counts_kernel_stages_a_round_in_parts(card, lc, lp, pb):
    """Lanes of long matches at spec_pos distances: every round of kThreads
    tokens has more counted pairs than the kStage-word stage holds, so
    each round is staged and counted in parts."""
    R, K = _lower_constant("kThreads"), _lower_constant("kStage")
    rng = np.random.default_rng(12)
    N, n_tok = 3, 3 * R + 7
    T = 2 * n_tok + 8         # the long tokens fit T // 2 + 2
    t_len = np.full((N, T), 273, np.int64)
    t_pos = np.cumsum(t_len, axis=1) - t_len
    t_dist = rng.integers(4, 128, (N, T))
    t_valid = np.arange(T)[None, :].repeat(N, 0) < n_tok
    data = torch.from_numpy(rng.integers(0, 256, (N, int(t_pos[0, -1]) + 300),
                                         dtype=np.uint8)).to(card)
    tok = [torch.from_numpy(a).to(card) for a in
           (t_pos, t_len, t_dist, t_valid)]
    meta = tuple(m.long() for m in classify_tokens(data, *tok))
    n, _, _ = _counts_on_card((meta, *tok, lc, lp, pb, 50 * T, 0))
    assert int(n.sum()) // N // n_tok * R > K


def test_lower_counts_kernel_in_both_placements(card):
    """lc3 lp0 pb2's slots in shared memory, lc8 lp4 pb4's (3,147,574 a
    lane) in device memory, on the same tokens; and the port's encoder's
    own preset-primed lc8 lp4 pb4 lowering (pos_base)."""
    from lzma_tpu_torch.ops.device_encoder import encode_batch, probing

    limit = smem_limit(0)
    for (lc, lp, pb), where in (((3, 0, 2), "shared"), ((8, 4, 4), "device")):
        S = ProbLayout(lc, lp, pb, pos_bits=pb).size
        assert cuda_lower.count_placement(S, limit) == where
        n, _, _ = _counts_on_card(_lower_inputs([900, 40, 2500], 29, card,
                                                lc=lc, lp=lp, pb=pb,
                                                pos_base=333))
        assert n.shape == (3, S)
    blocks = _blocks(3, 2048, 31)
    with probing() as probe:
        encode_batch(blocks, LzmaParams(lc=8, lp=4, pb=4),
                     preset=blocks[0][:500], device=card)
    _counts_on_card(probe["lower_args"])


def test_lower_counts_kernel_on_a_lane_of_literals(card):
    """Every pair on is_match and the literal trees (the hot slots): 64
    KiB of text as literals, and a lane of one repeated byte."""
    from lzma_tpu_torch.bench.corpus import text_part

    n = 1 << 16
    rows = [text_part()[:n], b"a" * n]
    data, _ = pad_rows(rows, card)
    t_pos = torch.arange(n, device=card).expand(2, n).contiguous()
    tok = (t_pos, torch.ones_like(t_pos), torch.full_like(t_pos, -1),
           torch.ones_like(t_pos, dtype=torch.bool))
    meta = tuple(m.long() for m in classify_tokens(data, *tok))
    n_slot, _, total = _counts_on_card((meta, *tok, 3, 0, 2, 10 * n + 128, 0))
    assert total.tolist() == [9 * n] * 2
    # the literal tree's nodes of "a" after "a", n - 1 times each
    assert int(n_slot[1].max()) == n - 1


@pytest.mark.parametrize("parse", ["lazy", "optimal"])
def test_lower_counts_kernel_on_both_parses_with_eos_tokens(card, parse):
    """Both parses' tokens of 4 lanes, the EOS marker appended: K8 = the
    plain version = pair_counts of K7's planes, and = the CPU's counts."""
    from lzma_tpu_torch.ops.device_encoder import pair_counts

    blocks = _blocks(4, 4096, 6)
    data, lens = pad_rows(blocks, card)
    if parse == "lazy":
        tok = tokenize(data, lens, 4096, 32, 4)
    else:
        from lzma_tpu_torch.ops.device_parser import tokenize_optimal

        tok = tokenize_optimal(data, lens, 4096, lc=3, lp=0, pb=2, fb=32)
    toks = _append_eos_tokens(*tok[:4], tok[4], lens)
    meta = tuple(m.long() for m in classify_tokens(data, *toks))
    args = (meta, *toks, 3, 0, 2, 10 * data.shape[1] + 128, 0)
    got = _counts_on_card(args)
    S = ProbLayout(3, 0, 2, pos_bits=2).size
    ctx, bits, total = cuda_lower.lower_tokens_cuda(*args)
    for g, w in zip(got, (*pair_counts(ctx, bits, total, S), total)):
        assert torch.equal(g, w)
    cpu = cuda_lower.lower_counts_cuda(tuple(m.cpu() for m in meta),
                                       *(t.cpu() for t in toks), *args[5:])
    for g, w in zip(got, cpu):
        assert torch.equal(g.cpu(), w)


def test_lower_counts_kernel_raises_where_the_plain_version_raises(card):
    """max_bits one below the longest lane's total, then below a middle
    lane's only; more long tokens than T // 2 + 2: the plain version's
    ValueError, after one launch; a total equal to max_bits passes."""
    args = list(_lower_inputs([700, 1300, 40], 14, card))
    total = _counts_on_card(tuple(args))[2]
    for cap, lane in ((int(total.max()), None), (int(total[1]), 1)):
        args[8] = cap
        if lane is None:
            _counts_on_card(tuple(args))             # exactly full: fits
        args[8] = cap - 1
        before = cuda_lower.COUNT_LAUNCHES
        for fn in (cuda_lower.lower_counts_cuda, _lower_counts_plain):
            with pytest.raises(ValueError, match="exceed"):
                fn(*args)
        assert cuda_lower.COUNT_LAUNCHES == before + 1
    args = list(_lower_inputs([600], 18, card))
    T = args[1].shape[1]
    args[0] = tuple(torch.full_like(m, K_MATCH) if k == 0 else m
                    for k, m in enumerate(args[0]))
    args[2] = torch.full_like(args[2], 3)           # every token a match
    args[4] = torch.arange(T, device=card)[None] < T // 2 + 3
    for fn in (cuda_lower.lower_counts_cuda, _lower_counts_plain):
        with pytest.raises(ValueError, match="long tokens"):
            fn(*args)


def test_lower_counts_kernel_reads_strided_planes_and_empty_shapes(card):
    """Planes transposed and sliced out of wider rows give the contiguous
    planes' counts; no token slots or no lanes: zero counts, no launch."""
    args = _lower_inputs([500, 900, 20, 1100], 20, card)
    want = _counts_on_card(args)
    meta, t_pos, t_len, t_dist, t_valid = args[:5]
    strided = [x.T.contiguous().T if k % 2 else
               torch.cat([x, x[:, :5]], dim=1)[:, :x.shape[1]]
               for k, x in enumerate((*meta, t_pos, t_len, t_dist))]
    got = _counts_on_card((tuple(strided[:7]), *strided[7:],
                           t_valid.T.contiguous().T, *args[5:]))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for N, T in ((3, 0), (0, 7)):
        z = torch.zeros((N, T), dtype=torch.int64, device=card)
        e_args = (tuple(z for _ in range(7)), z, z + 1, z - 1, z.bool(), 3, 0,
                  2, 64, 0)
        before = cuda_lower.COUNT_LAUNCHES
        got = cuda_lower.lower_counts_cuda(*e_args)
        assert cuda_lower.COUNT_LAUNCHES == before
        for g, w in zip(got, _lower_counts_plain(*e_args)):
            assert torch.equal(g, w)


def test_tokenize_optimal_rounds_launch_k8_not_k7(card):
    """The optimal parse's two rounds launch K8 once each and K7 not at
    all; its tokens are the CPU's."""
    from lzma_tpu_torch.ops.device_parser import tokenize_optimal

    blocks = _blocks(3, 2048, 8)
    data, lens = pad_rows(blocks, card)
    before = cuda_lower.COUNT_LAUNCHES, cuda_lower.LAUNCHES
    got = tokenize_optimal(data, lens, 2048, lc=3, lp=0, pb=2, fb=32)
    assert (cuda_lower.COUNT_LAUNCHES, cuda_lower.LAUNCHES) == (
        before[0] + 2, before[1])
    want = tokenize_optimal(data.cpu(), lens.cpu(), 2048, lc=3, lp=0, pb=2,
                            fb=32)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_eos_cap_grows_on_the_card(card, monkeypatch):
    """decode_alone of an EOS stream 68x smaller than its output: the cap
    starts at 16 bytes a coded byte, grows x4 twice, and the last decodes;
    K1 runs each attempt."""
    import lzma

    from lzma_tpu_torch.bench.corpus import text_part

    data = text_part()[:20000] * 20
    blob = lzma.compress(data, format=lzma.FORMAT_ALONE)
    caps = []
    real = api.decode_batch_cuda

    def spy(streams, params, sizes, device="cuda"):
        caps.append(-sizes[0])
        return real(streams, params, sizes, device=device)

    monkeypatch.setattr(api, "decode_batch_cuda", spy)
    before = cuda_ring.LAUNCHES
    assert api.decode_alone(blob, device=card) == data
    floor = 16 * (len(blob) - 13)
    assert caps == [floor, 4 * floor, 16 * floor]
    assert cuda_ring.LAUNCHES == before + 3


# ------------------------------------- K1 and K5: the two-speed decode body
def _k1_k5_plain(comp, lens, sizes, dict_size, lc, lp, pb, max_out,
                 preset=None, resident=True):
    """K1 (and K5 where `resident`) on the card against _decode_fsm on
    the CPU: equal (out, ok, out_pos), each kernel launched once.
    Returns K1's result on the CPU."""
    dev = torch.device("cuda", 0)
    args = [torch.as_tensor(np.asarray(x), dtype=t) for x, t in
            ((comp, torch.uint8), (lens, torch.int32), (sizes, torch.int32))]
    pre = (None if preset is None else
           torch.frombuffer(bytearray(preset), dtype=torch.uint8))
    want = _decode_fsm(*args, dict_size, lc, lp, pb, max_out, preset=pre)
    card_args = [a.to(dev) for a in args]
    card_pre = None if pre is None else pre.to(dev)
    fns = [cuda_ring.decode_cuda] + ([cuda_decoder.decode_resident]
                                     if resident else [])
    for fn in fns:
        mod = cuda_ring if fn is cuda_ring.decode_cuda else cuda_decoder
        before = mod.LAUNCHES
        got = fn(*card_args, dict_size, lc, lp, pb, max_out, preset=card_pre)
        assert mod.LAUNCHES == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), fn.__name__
    return [w for w in want]


def _rows(streams, width=None):
    width = width or 1 << max(4, (max(len(x) for x in streams) - 1).bit_length())
    comp = np.zeros((len(streams), width), np.uint8)
    for i, x in enumerate(streams):
        comp[i, :len(x)] = np.frombuffer(x, np.uint8)
    return comp, [len(x) for x in streams]


# K1's arena in both placements: lc3 lp0's in shared memory, lc8 lp4's
# (3,146,902 probabilities) in device memory, chosen by its size alone
@pytest.mark.parametrize("lc,lp,placement", [(3, 0, "shared"), (0, 0, "shared"),
                                             (4, 3, "shared"), (8, 4, "device")])
def test_ring_decoder_in_both_placements(card, lc, lp, placement):
    arena = ProbLayout(lc, lp, 2, pos_bits=2).size
    assert cuda_ring.arena_placement(arena, smem_limit(card.index or 0)) == placement
    params = LzmaParams(lc=lc, lp=lp, pb=2, dict_size=1 << 12)
    blocks = _blocks(4, 2048, 11 + lc)
    comp, lens = _rows([encode_stream(b, params, mode="greedy") for b in blocks])
    out = _k1_k5_plain(comp, lens, [len(b) for b in blocks], 1 << 12, lc, lp,
                       2, 2048, resident=placement == "shared")
    assert bool(out[1].all())
    for i, b in enumerate(blocks):
        assert out[0][i, :len(b)].numpy().tobytes() == b


def _exact_stream(target, seed):
    """(payload, its stream of exactly `target` bytes): incompressible
    bytes, a length searched for."""
    params = LzmaParams(dict_size=1 << 12)
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, target + 256, dtype=np.uint8).tobytes()
    n, tried = target - 16, set()
    for _ in range(200):
        stream = encode_stream(data[:n], params, mode="greedy")
        if len(stream) == target:
            return data[:n], stream
        tried.add(n)
        step = n + target - len(stream)
        n = step if step not in tried else max(tried) + 1
    raise AssertionError(f"no stream of {target} bytes")


# K1 stages its input by tiles of IN_TILE bytes: valid streams of tile - 1,
# tile, tile + 1 and 2 x tile bytes, rows of 8,195 bytes (the lanes' bases
# 0, 3, 2 and 1 past a 4-byte boundary), decode to their payloads in K1
# and K5; the same streams cut at the tile edges fail in K1 exactly as in
# K5, whose input is resident (their plain version's loop would take
# ~40,000 steps a lane); lanes of 0 input bytes at each base, and of 1-3
# bytes, stage no tile or a part of one and fail as in the plain version
def test_ring_decoder_at_input_tile_edges_and_unaligned_rows(card):
    T = cuda_ring.IN_TILE
    pairs = [_exact_stream(n, n) for n in (T - 1, T, T + 1, 2 * T)]
    payloads, streams = zip(*pairs)
    cuts = [streams[3][:n] for n in (T - 1, T, T + 1, 2 * T - 1)]
    short = [streams[0][:n] for n in (0, 0, 0, 0, 1, 2, 3, 3)]
    comp, lens = _rows(list(streams) + cuts + short, width=2 * T + 3)
    comp, lens = (torch.tensor(x, device=card) for x in (comp, lens))
    lens = lens.to(torch.int32)
    sizes = torch.tensor([len(x) for x in payloads] + [len(payloads[3])] * 4
                         + [100] * 8, dtype=torch.int32, device=card)
    args = (comp, lens, sizes, 1 << 12, 3, 0, 2, 2 * T)
    k1, k5 = cuda_ring.decode_cuda(*args), cuda_decoder.decode_resident(*args)
    for a, b in zip(k1, k5):
        assert torch.equal(a, b)
    # cut at the tile edges the lanes fail; cut by its last byte one may
    # still decode (up to 40 bytes past a stream's end read as 0)
    assert k1[1][:7].tolist() == [True] * 4 + [False] * 3
    for i, x in enumerate(payloads):
        assert k1[0][i, :len(x)].cpu().numpy().tobytes() == x
    # a lane of three and more tiles, with the plain version, cut short
    _k1_k5_plain(comp[:4].cpu(), lens[:4].cpu(), [700] * 4, 1 << 12, 3, 0, 2,
                 2 * T)
    # the short lanes, at the same bases, with the plain version
    _k1_k5_plain(comp[8:].cpu(), lens[8:].cpu(), [100] * 8, 1 << 12, 3, 0, 2,
                 2 * T)


# the restated body's cases (tests/test_torch_kernel_plans.py) on the card
@pytest.mark.parametrize("group", range(2))
def test_decoders_on_truncations_like_plain(card, group):
    params = LzmaParams(dict_size=1 << 12)
    good = encode_stream(generate_bench_data(1024), params, mode="greedy")
    cuts = [good[:len(good) - k] for k in range(1 + 32 * group, 33 + 32 * group)]
    comp, lens = _rows(cuts)
    _k1_k5_plain(comp, lens, [1024] * 32, 1 << 12, 3, 0, 2, 1024)


def test_decoders_at_the_output_margin_like_plain(card):
    params = LzmaParams(dict_size=1 << 12)
    block = generate_bench_data(1024)
    comp, lens = _rows([encode_stream(block, params, mode="greedy")] * 8)
    n = len(block)
    sizes = [n - 274, n - 273, n - 272, n, n - 1, 272, 273, 1]
    _k1_k5_plain(comp, lens, sizes, 1 << 12, 3, 0, 2, 1024)
    for max_out in (n - 100, n + 272, n + 273):
        _k1_k5_plain(comp[:1], lens[:1], [n], 1 << 12, 3, 0, 2, max_out)


def test_decoders_on_rep0_runs_of_273(card):
    # one literal, then copies at distance 1 of kMatchMaxLen bytes each
    params = LzmaParams(dict_size=1 << 12)
    payloads = [b"a" * 4000, b"ab" * 1500 + b"c" * 1000]
    comp, lens = _rows([encode_stream(x, params, mode="greedy") for x in payloads])
    out = _k1_k5_plain(comp, lens, [len(x) for x in payloads], 1 << 12, 3, 0, 2,
                       4096)
    for i, x in enumerate(payloads):
        assert out[0][i, :len(x)].numpy().tobytes() == x


def test_decoders_on_eos_lanes_with_caps_like_plain(card):
    params = LzmaParams(dict_size=1 << 12, write_eos=True)
    payload = generate_bench_data(1500)
    comp, lens = _rows([encode_stream(payload, params, mode="greedy")] * 4)
    n = len(payload)
    out = _k1_k5_plain(comp, lens, [-n, -(n - 1), -4096, -(n // 2)], 1 << 12,
                       3, 0, 2, 4096)
    assert out[1].tolist() == [True, False, True, False]


# ------------------------------------------------- K5, the resident decoder
def test_resident_decoder_matches_plain_with_and_without_preset(card):
    params = LzmaParams(dict_size=1 << 12)
    blocks = _blocks(4, 1024, 9)
    streams = [encode_stream(b, params, mode="greedy") for b in blocks]
    comp, lens = pad_rows(streams, card)
    sizes = torch.tensor([len(b) for b in blocks], dtype=torch.int32, device=card)
    args = (comp, lens, sizes, params.dict_size, 3, 0, 2, 1024)
    before = cuda_decoder.LAUNCHES
    k = cuda_decoder.decode_resident(*args)
    assert cuda_decoder.LAUNCHES == before + 1
    for a, b, c in zip(k, _decode_fsm(*args), cuda_ring.decode_cuda(*args)):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert bool(k[1].all())

    preset = blocks[0][:512]
    streams = [encode_stream(b, params, preset=preset, mode="greedy")
               for b in blocks[1:]]
    comp, lens = pad_rows(streams, card)
    sizes = torch.tensor([len(b) + 512 for b in blocks[1:]], dtype=torch.int32,
                         device=card)
    pre = torch.frombuffer(bytearray(preset), dtype=torch.uint8).to(card)
    args = (comp, lens, sizes, params.dict_size, 3, 0, 2, 2048)
    k = cuda_decoder.decode_resident(*args, preset=pre)
    for a, b in zip(k, _decode_fsm(*args, preset=pre)):
        assert torch.equal(a, b)
    assert cuda_decoder.decode_batch_resident(
        streams, params, [len(b) for b in blocks[1:]], preset=preset,
        device=card) == blocks[1:]


def test_resident_decoder_fails_corrupt_lanes_like_plain(card):
    params = LzmaParams(dict_size=1 << 12)
    payload = generate_bench_data(700)
    good = encode_stream(payload, params, mode="greedy")
    bad = bytearray(good)
    bad[len(good) // 2] ^= 0x5A
    cuts = [good[:k] for k in range(40, len(good) - 20, (len(good) - 60) // 24)]
    streams = [bytes(bad)] + cuts + [good, good]
    sizes = [700] * (1 + len(cuts)) + [750, 650]
    comp, lens = pad_rows(streams, card)
    for dict_size in (1 << 12, 16):
        args = (comp, lens, torch.tensor(sizes, dtype=torch.int32, device=card),
                dict_size, 3, 0, 2, 1024)
        k = cuda_decoder.decode_resident(*args)
        for a, b in zip(k, _decode_fsm(*args)):
            assert torch.equal(a, b)
        assert not bool(k[1][:1 + len(cuts)].any())
    with pytest.raises(CorruptStreamError):
        cuda_decoder.decode_batch_resident([bytes(bad)], params, [700],
                                           device=card)


def test_resident_decoder_eos_lanes_and_cap(card):
    params = LzmaParams(dict_size=1 << 12, write_eos=True)
    payload = generate_bench_data(900)
    stream = encode_stream(payload, params, mode="greedy")
    comp, lens = pad_rows([stream, stream], card)
    sizes = torch.tensor([-4096, -600], dtype=torch.int32, device=card)
    args = (comp, lens, sizes, params.dict_size, 3, 0, 2, 4096)
    k = cuda_decoder.decode_resident(*args)
    for a, b in zip(k, _decode_fsm(*args)):
        assert torch.equal(a, b)
    assert k[1].tolist() == [True, False]
    assert cuda_decoder.decode_batch_resident([stream], params, [-4096],
                                              device=card) == [payload]
    with pytest.raises(CapExceededError):
        cuda_decoder.decode_batch_resident([stream], params, [-600],
                                           device=card)


def test_resident_decoder_raises_over_its_envelope(card):
    params = LzmaParams(dict_size=1 << 12)
    stream = encode_stream(b"x" * 1000, params, mode="greedy")
    before = cuda_decoder.LAUNCHES
    with pytest.raises(ValueError, match="shared memory"):
        cuda_decoder.decode_batch_resident([stream], params, [1000],
                                           max_out=1 << 18, device=card)
    big = LzmaParams(lc=8, lp=4, pb=2, dict_size=1 << 12)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_decoder.decode_batch_resident([stream], big, [1000], device=card)
    assert cuda_decoder.LAUNCHES == before


def test_resident_wrapper_rejects_bad_dtype_and_device(card):
    comp = torch.zeros((2, 16), dtype=torch.uint8, device=card)
    lens = torch.full((2,), 16, dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        cuda_decoder.decode_resident(comp.int(), lens, lens, 1 << 12, 3, 0, 2, 64)
    with pytest.raises(ValueError):
        cuda_decoder.decode_resident(comp, lens.cpu(), lens, 1 << 12, 3, 0, 2, 64)


# ------------------------------------------ the Hopper probes (tools/probe_*.py)
from lzma_tpu_torch.probes import (probe_dma, probe_dma2, probe_fsm_cost,  # noqa: E402
                                   probe_fsm_cost2, probe_gather, probe_gather2,
                                   probe_packed_ablate, probe_ring_ablate)


def _same(kernel_res, plain_res):
    for a, b in zip(kernel_res, plain_res):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("placement", ["shared", "device"])
@pytest.mark.parametrize("name", ["v1", "v2", "v_i16"])
def test_fsm_probe_kernel_matches_plain(card, name, placement):
    fn = getattr(probe_fsm_cost, name)
    before = probe_fsm_cost.LAUNCHES[name]
    # 21 lanes: the last block of 8 is part empty
    k = fn(probe_fsm_cost.seeds(21, card), 300, placement, digest=True)
    _same(k, fn(probe_fsm_cost.seeds(21, "cpu"), 300, digest=True))
    assert probe_fsm_cost.LAUNCHES[name] == before + 1


@pytest.mark.parametrize("placement", ["shared", "device"])
@pytest.mark.parametrize("kw", [dict(loop="fori"), dict(loop="while"),
                                dict(loop="fori", selects=150),
                                dict(loop="while", nregs=24, selects=120)],
                         ids=["fixed", "while", "selects", "registers"])
def test_fsm_cost2_make_kernel_matches_plain(card, kw, placement):
    k = probe_fsm_cost2.make(probe_fsm_cost.seeds(13, card), 64,
                             placement=placement, digest=True, **kw)
    _same(k, probe_fsm_cost2.make(probe_fsm_cost.seeds(13, "cpu"), 64,
                                  digest=True, **kw))


@pytest.mark.parametrize("width", [128, 4096])
def test_gather_probe_kernels_match_plain(card, width):
    arr, idx = probe_gather.inputs(width, 40, card)
    idx[::3] -= 5 * width + 7        # a negative index is taken as a floor modulo
    want = probe_gather.probe_native(arr.cpu(), idx.cpu(), 300)
    for placement in ("shared", "device"):
        assert torch.equal(probe_gather.probe_native(arr, idx, 300, placement).cpu(),
                           want)
    assert torch.equal(probe_gather.probe_onehot(arr, idx, 300).cpu(), want)
    zeros, idx = probe_gather.scatter_inputs(width, 40, card)
    assert torch.equal(probe_gather.probe_scatter(zeros, idx, 300).cpu(),
                       probe_gather.probe_scatter(zeros.cpu(), idx.cpu(), 300))


@pytest.mark.parametrize("g", [1, 2, 4])
def test_chain_probe_kernel_matches_plain(card, g):
    arr, idx = probe_gather2.chain_inputs(9, 2688, card)
    idx[1] = -100
    want = probe_gather2.probe_chain(arr.cpu(), idx.cpu(), g, 200)
    for placement in ("shared", "device"):
        before = arr.clone()
        assert torch.equal(probe_gather2.probe_chain(arr, idx, g, 200,
                                                     placement).cpu(), want)
        assert torch.equal(arr, before)
    arr, idx = probe_gather2.taa_inputs(16, 512, card)
    idx[3], idx[5] = 512, -1         # outside the row: 0
    got = probe_gather2.probe_taa(arr, idx).cpu()
    assert torch.equal(got, probe_gather2.probe_taa(arr.cpu(), idx.cpu()))
    assert got[3] == 0 and got[5] == 0


@pytest.mark.parametrize("form", list(probe_dma.FORMS))
def test_copy_probe_kernels_match_plain(card, form):
    for name, offs in (("probe1", probe_dma.OFFS1), ("probe2", probe_dma.OFFS2)):
        fn = getattr(probe_dma, name)
        k_out, k_ref = fn(probe_dma.source(card), probe_dma.offsets(offs, card), form)
        p_out, p_ref = fn(probe_dma.source("cpu"), probe_dma.offsets(offs, "cpu"),
                          form)
        assert k_ref == p_ref and torch.equal(k_out.cpu(), p_out)
    x = probe_dma.tile(card)
    assert torch.equal(probe_dma.probe3(x).cpu(), probe_dma.probe3(x.cpu()))
    for kernel in probe_dma2.KERNELS:
        src, offs = probe_dma.source(card), probe_dma.offsets(probe_dma.OFFS1, card)
        k_out, k_ref = probe_dma2.run(kernel, src, offs)
        p_out, p_ref = probe_dma2.run(kernel, src.cpu(), offs.cpu())
        assert k_ref == p_ref and torch.equal(k_out.cpu(), p_out)


def test_unaligned_bulk_copies_are_refused_without_a_launch(card):
    """A source 4 B past a 16 B boundary: no row may go to a bulk copy or
    cp.async of 16 B, so nothing launches and every row is -1."""
    src = torch.arange(8 * 1024 + 1, dtype=torch.int32, device=card)[1:].view(8, 1024)
    offs = probe_dma.offsets((0,) * 8, card)
    before = (sum(probe_dma.LAUNCHES.values()), probe_dma2.LAUNCHES["run"])
    for form in probe_dma.ALIGNED:
        out, refused = probe_dma.probe1(src, offs, form)
        assert refused == list(range(8)) and bool((out == -1).all())
    out, refused = probe_dma2.run("kA", src, offs)
    assert refused == list(range(8)) and bool((out == -1).all())
    assert (sum(probe_dma.LAUNCHES.values()), probe_dma2.LAUNCHES["run"]) == before
    # the 4-byte forms take the same rows
    out, refused = probe_dma.probe1(src, offs, "async4")
    assert refused == [] and torch.equal(out.cpu(), src.cpu()[:, :128])


def test_ablation_full_and_realrow_equal_k1_and_plain(card):
    params = LzmaParams(lc=0, dict_size=1 << 12, fast_bytes=8)
    blocks = _blocks(4, 1024, 5)
    streams = [encode_stream(b, params, mode="greedy") for b in blocks]
    comp, lens = pad_rows(streams, card)
    sizes = torch.tensor([len(b) for b in blocks], dtype=torch.int32, device=card)
    args = (comp, lens, sizes, params.dict_size, 0, 0, 2, 1024)
    k1 = cuda_ring.decode_cuda(*args)
    plain = _decode_fsm(*(a.cpu() if torch.is_tensor(a) else a for a in args))
    counts = []
    for variant in ("full", "realrow", "ldgin"):
        out, ok, out_pos, bits = probe_ring_ablate.ablate(*args, variant)
        _same((out, ok, out_pos), plain)
        assert all(torch.equal(a, b) for a, b in zip((out, ok, out_pos), k1))
        counts.append(bits[:, :2])
    assert all(torch.equal(counts[0], c) for c in counts[1:])   # bits, copies
    assert bool((counts[0] > 0).all())
    for i, b in enumerate(blocks):
        assert k1[0][i, :len(b)].cpu().numpy().tobytes() == b


def test_ablation_knockouts_run_to_their_bound_twice_alike(card):
    comp = probe_packed_ablate.random_input(8, device=card)
    for variant in probe_packed_ablate.VARIANTS:
        first = probe_packed_ablate.ablate(comp, 1 << 12, 0, 4096, variant)
        again = probe_packed_ablate.ablate(comp, 1 << 12, 0, 4096, variant)
        assert probe_ring_ablate.same(first, again)   # all but the clock
        assert bool((first[2] == 4096).all()) and bool((first[3][:, 0] > 0).all())
    n = torch.full((8,), comp.shape[1], dtype=torch.int32, device=card)
    size = torch.full((8,), 4096, dtype=torch.int32, device=card)
    for variant in ("noctx", "barebit"):
        res = probe_ring_ablate.ablate(comp, n, size, 1 << 12, 0, 0, 2, 4096, variant)
        assert bool((res[2] == 4096).all())


# ------------------------------------------------ the hybrid, profiling
@pytest.mark.parametrize("tiers,fb", [(None, 32), (dict(k4=(1, 3), k8=1), 128)])
def test_hybrid_search_on_the_card_matches_the_cpu(card, tiers, fb):
    """The hybrid's list search (K9, K10 and K11 around torch.sort) and
    its packing (plain PyTorch on the card) give the CPU's lists, pair
    buffers and counts, the clamped ones at a small cap included."""
    from lzma_tpu_torch.ops import device_matcher as dm
    from lzma_tpu_torch.ops.hybrid import DEFAULT_TIERS

    tiers = DEFAULT_TIERS if tiers is None else tiers
    d, n = pad_rows(_blocks(4, 4096, 5), "cpu")
    n[1] = 3000
    want = dm.find_match_lists_rmq(d, n, 4096, fb, **tiers)
    got = dm.find_match_lists_rmq(d.to(card), n.to(card), 4096, fb, **tiers)
    assert all(torch.equal(w, g.cpu()) for w, g in zip(want, got))
    for cap in (3 * 4096, 1024):
        packed = dm.pack_match_lists(*got, cap)
        assert all(torch.equal(w, g.cpu()) for w, g in
                   zip(dm.pack_match_lists(*want, cap), packed))


def test_hybrid_encodes_on_the_card_equal_the_cpu(card):
    from lzma_tpu_torch.format.properties import LzmaParams as TParams
    from lzma_tpu_torch.ops import hybrid

    data = b"".join(_blocks(5, 4000, 9))
    p = TParams(dict_size=1 << 13, fast_bytes=16)
    for fn in (hybrid.encode_blocks_hybrid, hybrid.encode_blocks_hybrid_optimal):
        for kw in (dict(), dict(preset_len=500), dict(dictionary=data[-700:])):
            blob = fn(data, p, block_size=4096, device=card, **kw)
            assert blob == fn(data, p, block_size=4096, device="cpu", **kw)
            assert api.decode_blocks(blob, device=card) == data


def test_compress_auto_on_the_card_equals_the_cpu(card):
    """params="auto" and train_dict="auto" choose on the host and encode
    on the card the container the CPU's plain versions write."""
    import lzma_tpu_torch
    from lzma_tpu_torch.format.properties import LzmaParams as TParams

    data = b"".join(_blocks(3, 2000, 5))
    for kw in (dict(params="auto", dict_size=1 << 12),
               dict(train_dict="auto", params=TParams(dict_size=1 << 12))):
        blob = lzma_tpu_torch.compress(data, block_size=2048, device=card, **kw)
        assert blob == lzma_tpu_torch.compress(data, block_size=2048,
                                               device="cpu", **kw)
        assert lzma_tpu_torch.decompress(blob, device=card) == data


@pytest.mark.parametrize("parse", ["lazy", "optimal"])
def test_encode_file_on_the_card_equals_encode_blocks(card, parse, tmp_path,
                                                      monkeypatch):
    """The file codec on the card, in batches of 2 blocks (the last the
    lone tail) and in the sizer's own batches, writes api.encode_blocks'
    container (v1 and v2) and decode_file reads it back; K3 launches under
    the optimal parse, K6 and K2 in every batch."""
    from lzma_tpu_torch.format.properties import LzmaParams as TParams
    from lzma_tpu_torch.parallel import filestream as fs

    data = b"".join(_blocks(5, 4096, 12)) + b"tail" * 100
    p = TParams(dict_size=1 << 13, fast_bytes=16)
    src, dst, out = tmp_path / "in", tmp_path / "c.lztb", tmp_path / "out"
    src.write_bytes(data)
    log = tmp_path / "batches.jsonl"
    monkeypatch.setenv(fs.BATCH_LOG_ENV, str(log))
    for kw in (dict(), dict(preset_len=1000)):
        want = api.encode_blocks(data, p, block_size=4096, parse=parse,
                                 device=card, **kw)
        for batch in (2 * 4096, fs.DEFAULT_BATCH_BYTES):
            log.unlink(missing_ok=True)
            fs.encode_file(src, dst, p, block_size=4096, parse=parse,
                           batch_bytes=batch, device=card, **kw)
            assert dst.read_bytes() == want
            lines = [json.loads(ln) for ln in log.read_text().splitlines()]
            assert len(lines) == (3 if batch < 4 * 4096 else 1)
            for ln in lines:
                assert ln["peak"] <= 1.1 * ln["estimate"]
                assert ln["launches"]["rc_serialize"] >= 1
            # primed lanes parse lazy: K3 runs where block 0 or no preset is
            assert lines[0]["launches"]["dp_parse"] >= (parse == "optimal")
        assert fs.decode_file(dst, out, batch_bytes=2 * 4096,
                              device=card) == len(data)
        assert out.read_bytes() == data


def test_cli_benchmark_runs_on_the_card(card, capsys):
    """`b 1 -d18`: one pass of 2.25 MiB, K19 (classify_tokens, no K6)
    and K2 once, K1 twice (the harness CRC-checks both decodes)."""
    from lzma_tpu_torch import cli

    for mod in (cuda_classify, cuda_serializer, cuda_ring):
        mod.LAUNCHES = 0
    cuda_classify.TOKEN_LAUNCHES = 0
    assert cli.main(["b", "1", "-d18"]) == 0
    assert capsys.readouterr().out.count(" KB/s ") == 4
    assert (cuda_classify.LAUNCHES, cuda_classify.TOKEN_LAUNCHES,
            cuda_serializer.LAUNCHES, cuda_ring.LAUNCHES) == (0, 1, 1, 2)


def test_phase_timer_covers_an_async_kernel(card):
    """torch.cuda._sleep spins the card for a number of cycles and returns
    at once; a phase that names its tensor waits for it."""
    from lzma_tpu_torch.utils.profiling import PhaseTimer

    x = torch.ones(1, device=card)
    torch.cuda.synchronize()
    t = PhaseTimer()
    with t.phase("enqueue"):
        torch.cuda._sleep(1 << 30)
    torch.cuda.synchronize()
    with t.phase("synced", sync_arrays=[x]):
        torch.cuda._sleep(1 << 30)
    # 2**30 cycles at the H100's top clock (1.98 GHz) is 0.54 s
    assert t.totals["synced"] > 0.4 > t.totals["enqueue"]


def test_profiler_trace_sees_the_card(card, tmp_path):
    from lzma_tpu_torch.utils.profiling import device_busy, profiler_trace

    a = torch.randn(2048, 2048, device=card)
    with profiler_trace(str(tmp_path), device=card) as prof:
        for _ in range(5):
            a = a @ a
            a = a / a.norm()
    busy = device_busy(prof.trace_path, top=3)
    assert busy["device_events"] >= 10 and 0 < busy["busy_share"] <= 1
    assert len(busy["top"]) == 3


@pytest.fixture
def nccl_mesh(card, tmp_path):
    """An NCCL group of one rank in this process (file:// store), its mesh
    on the card; destroyed after the test."""
    import torch.distributed as dist
    from lzma_tpu_torch.parallel import mesh, multihost

    multihost.initialize("file://" + str(tmp_path / "store"), 1, 0, "nccl",
                         "cuda")
    try:
        yield mesh.make_mesh("cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("gather", [False, True])
def test_nccl_mesh_world1_equals_the_lane_encoder(card, nccl_mesh, gather):
    """8 x 16 KiB through the mesh at world size 1 over NCCL: the container
    is api.encode_blocks', K2 launches in the encode and K1 in the decode
    (gather=True runs the all_gather on the card)."""
    from lzma_tpu_torch.format.properties import LzmaParams as TParams
    from lzma_tpu_torch.parallel import mesh

    assert (nccl_mesh.world, nccl_mesh.backend, nccl_mesh.comm_device.type) \
        == (1, "nccl", "cuda")
    data = b"".join(_blocks(8, 1 << 14, 21))
    p = TParams(dict_size=1 << 16)
    cuda_serializer.LAUNCHES = 0
    blob = mesh.encode_blocks_mesh(data, p, block_size=1 << 14, mesh=nccl_mesh,
                                   gather=gather)
    assert cuda_serializer.LAUNCHES > 0
    assert blob == api.encode_blocks(data, p, block_size=1 << 14, device=card)
    cuda_ring.LAUNCHES = 0
    assert mesh.decode_blocks_mesh(blob, mesh=nccl_mesh, gather=gather) == data
    assert cuda_ring.LAUNCHES > 0


def test_nccl_takes_one_card_a_rank_on_the_card(card, tmp_path):
    import torch.distributed as dist
    from lzma_tpu_torch import entry
    from lzma_tpu_torch.parallel import multihost

    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="NCCL takes one card a rank"):
        multihost.initialize("file://" + str(tmp_path / "store"), n, 0, "nccl",
                             "cuda")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="NCCL takes one card a rank"):
        entry.dryrun_multichip(n, device="cuda")


# ---------------------------------------------- K9-K11, the list search
def _search_lanes(widths, seed):
    """Lanes of bench data padded to the widest, with lengths of 0, 3, the
    width and the width less a few; one lane all zeros (one hash group)."""
    rng = np.random.default_rng(seed)
    max_n = max(widths)
    data = np.frombuffer(generate_bench_data(len(widths) * max_n),
                         np.uint8).reshape(len(widths), max_n).copy()
    data[0] = 0
    lens = np.array([w if i % 3 == 0 else max(0, w - int(rng.integers(0, 9)))
                     for i, w in enumerate(widths)], np.int64)
    lens[-1] = min(lens[-1], 3)
    if len(widths) > 2:
        lens[1] = 0
    return torch.from_numpy(data), torch.from_numpy(lens)


def _search_launches():
    from lzma_tpu_torch.ops import cuda_search

    return (cuda_search.KEYS_LAUNCHES, cuda_search.TABLE_LAUNCHES,
            cuda_search.LIST_LAUNCHES)


# widths at K9's and K10's tile edges (256 positions a K9 block; 2,048 a
# K10 tile with 11 levels in it, past 4,096 a level a pass)
@pytest.mark.parametrize("widths", [[1, 1], [3, 2, 3], [255, 256, 257],
                                    [2047, 2048, 2049, 100], [8193, 5000, 7]],
                         ids=lambda w: f"max_n{max(w)}")
@pytest.mark.parametrize("depth", [5, 13, 32, 273])
def test_search_keys_and_suffix_table_kernels_match_plain(card, widths, depth):
    from lzma_tpu_torch.ops import cuda_search
    from lzma_tpu_torch.ops import device_matcher as dm

    data, n = _search_lanes(widths, depth)
    d, k = data.to(card), n.to(card)
    spans = list(dm.TIER_SPANS) if depth != 13 else [3, 6, 16]
    got = cuda_search.search_keys_cuda(d, k, depth, spans)
    want = dm._search_keys_plain(d, k, depth, spans)
    assert len(got[0]) == len(want[0]) and len(got[1]) == len(want[1])
    assert all(torch.equal(a, b) for a, b in zip(got[0] + got[1],
                                                  want[0] + want[1]))
    if depth <= 32:
        order = dm._sort_packed(got[0])
        rank, T = cuda_search.suffix_table_cuda(d, k, order, depth)
        w_rank, w_T = dm._suffix_table_plain(d, k, order, depth)
    else:
        rank, T = dm._suffix_rank_lcp(
            d, k, depth, cuda_search.search_keys_cuda(d, k, 32, [])[0])
        w_rank, w_T = dm._suffix_rank_lcp(
            data, n, depth, cuda_search.search_keys_cuda(data, n, 32, [])[0])
    torch.cuda.synchronize()
    assert torch.equal(rank.cpu(), w_rank.cpu())
    assert torch.equal(T.cpu(), w_T.cpu())


# K10's two routes past its tiles: column stripes (max_n a multiple of
# 2,048: rows 3, 8 and 128; 32, 16 and 8 columns, forced by a smaller
# STRIPE_BYTES) and a pass a level (8,193, 6,000), with the LCP computed
# (depth 32) and given (the lazy search's, depth 273)
@pytest.mark.parametrize("max_n,stripe_bytes,route", [
    (6144, None, ("stripes", 32)), (16384, None, ("stripes", 32)),
    (16384, 512, ("stripes", 8)), (1 << 18, 64 * 1024, ("stripes", 32)),
    (1 << 18, 16 * 1024, ("stripes", 16)), (8193, None, ("levels", 0)),
    (6000, None, ("levels", 0))], ids=lambda v: str(v))
def test_suffix_table_routes_match_plain(card, monkeypatch, max_n,
                                         stripe_bytes, route):
    from lzma_tpu_torch.ops import cuda_search
    from lzma_tpu_torch.ops import device_matcher as dm

    if stripe_bytes is not None:
        monkeypatch.setattr(cuda_search, "STRIPE_BYTES", stripe_bytes)
    assert cuda_search.upper_route(max_n, smem_limit(card.index or 0)) == route
    data, n = _search_lanes([max_n, max_n - 5, max_n // 2], 5)
    d, k = data.to(card), n.to(card)
    order = dm._sort_packed(cuda_search.search_keys_cuda(d, k, 32, [])[0])
    rng = np.random.default_rng(max_n)
    cl = torch.from_numpy(rng.integers(0, 274, (3, max_n))).to(card)
    for depth, given in ((32, None), (273, cl)):
        before = cuda_search.TABLE_LAUNCHES
        rank, T = cuda_search.suffix_table_cuda(d, k, order, depth, given)
        w_rank, w_T = dm._suffix_table_plain(d, k, order, depth, given)
        torch.cuda.synchronize()
        assert cuda_search.TABLE_LAUNCHES == before + 1
        assert torch.equal(rank, w_rank) and torch.equal(T, w_T), depth


#: (tier ks, m_cap, m_cap_order): the optimal route's (rr 12), the
#: hybrid's (near, uncapped, 29), near cut at 12, tuple ranks, past 32
#: candidates (the list in the dists row) cut and uncut, DP_TIERS' 29
#: columns cut to 5 (the candidate row past the block's staged rows), and
#: a rank too far for the inverse words to pack their runs (keys compared)
LIST_CASES = {
    "dp-rr12": (None, 12, "rr"),
    "hybrid-near": (dict(k4=12, k6=4, k8=6, k16=3, k32=2), 0, "near"),
    "dp-near12": (None, 12, "near"),
    "tuples-rr5": (dict(k2=2, k3=0, k4=(1, 2, 4, 8), k8=(1, 3), k16=(2,),
                        k32=1), 5, "rr"),
    "wide-near": (dict(k4=20, k8=10, k16=5), 0, "near"),
    "wide-rr34": (dict(k4=20, k8=10, k16=5), 34, "rr"),
    "wide-near17": (dict(k4=20, k8=10, k16=5), 17, "near"),
    "dp-rr5-own-row": (None, 5, "rr"),
    "far-rank-keys": (dict(k4=(1, 2, 1 << 26), k8=2), 12, "rr"),
}


@pytest.mark.parametrize("name", list(LIST_CASES))
@pytest.mark.parametrize("fb", [5, 32, 273])
def test_match_lists_kernel_matches_plain(card, name, fb):
    """_rmq_search on the card (K9, K10 and K11, each launched once) gives
    the CPU's lists, rank and table, and K11 on the card's sorted tiers
    gives its plain version's lists on the same tensors."""
    from lzma_tpu_torch.ops import cuda_search
    from lzma_tpu_torch.ops import device_matcher as dm

    tiers, m_cap, order = LIST_CASES[name]
    data, n = _search_lanes([2048, 2048, 1500, 2048, 2040, 2048, 2048, 5],
                            fb)
    want = dm._rmq_search(data, n, 1800, fb, tiers, m_cap, order)
    before = _search_launches()
    got = dm._rmq_search(data.to(card), n.to(card), 1800, fb, tiers, m_cap,
                         order)
    torch.cuda.synchronize()
    after = _search_launches()
    assert [b - a for a, b in zip(before, after)] == [1, 1, 1]
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and torch.equal(w, g.cpu())
    # K11 alone against its plain version on the card's own tensors
    ranks = dm.tier_ranks(dm.DP_TIER_KS if tiers is None else tiers)
    d, k = data.to(card), n.to(card)
    keys = cuda_search.search_keys_cuda(d, k, 32, [s for s, r in ranks if r])[1]
    sorts = [torch.sort(x, dim=1, stable=True) for x in keys]
    args = ([s.values for s in sorts], [s.indices for s in sorts])
    rank, T = got[3], got[4]
    k11 = cuda_search.match_lists_cuda(list(args[0]), list(args[1]), ranks,
                                       rank, T, k, 1800, m_cap, order)
    plain = dm._match_lists_plain(list(args[0]), list(args[1]), ranks, rank,
                                  T, k, 1800, m_cap, order)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(k11, plain))


# K11 at its edges: lanes of 1, 2 and 3 places, and lanes one place either
# side of its 128-position list blocks and 256-place inverse tiles (lane 0
# all zeros: one run of equal keys)
@pytest.mark.parametrize("widths", [[1], [2, 1], [3, 2, 3],
                                    [2049, 1023, 1025, 1024]],
                         ids=lambda w: f"max_n{max(w)}")
@pytest.mark.parametrize("name", ["dp-rr12", "hybrid-near", "wide-rr34",
                                  "wide-near17", "dp-rr5-own-row",
                                  "far-rank-keys"])
def test_match_lists_kernel_at_its_edges(card, widths, name):
    from lzma_tpu_torch.ops import cuda_search
    from lzma_tpu_torch.ops import device_matcher as dm

    tiers, m_cap, order = LIST_CASES[name]
    data, n = _search_lanes(widths, 3)
    d, k = data.to(card), n.to(card)
    ranks = dm.tier_ranks(dm.DP_TIER_KS if tiers is None else tiers)
    skeys, tkeys = cuda_search.search_keys_cuda(d, k, 32,
                                                [s for s, r in ranks if r])
    rank, T = cuda_search.suffix_table_cuda(d, k, dm._sort_packed(skeys), 32)
    sorts = [torch.sort(x, dim=1, stable=True) for x in tkeys]
    args = ([s.values for s in sorts], [s.indices for s in sorts])
    before = cuda_search.LIST_LAUNCHES
    got = cuda_search.match_lists_cuda(list(args[0]), list(args[1]), ranks,
                                       rank, T, k, 1800, m_cap, order)
    torch.cuda.synchronize()
    assert cuda_search.LIST_LAUNCHES == before + 1
    want = dm._match_lists_plain(list(args[0]), list(args[1]), ranks, rank, T,
                                 k, 1800, m_cap, order)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.int64 and torch.equal(g, w)


def test_search_kernels_launch_on_every_route(card):
    """An optimal encode launches K9, K10 and K11 once a lane group; a
    lazy encode K9 (its 32-byte suffix keys and hash key) and K10 (its
    273-deep table); the hybrid's search each once."""
    from lzma_tpu_torch.format.properties import LzmaParams as TParams
    from lzma_tpu_torch.ops import hybrid

    data = b"".join(_blocks(4, 4096, 3))
    p = TParams(dict_size=1 << 13, fast_bytes=32)
    for parse, want in (("optimal", [1, 1, 1]), ("lazy", [1, 1, 0])):
        before = _search_launches()
        api.encode_blocks(data, p, block_size=4096, parse=parse, device=card)
        after = _search_launches()
        assert [b - a for a, b in zip(before, after)] == want, parse
    before = _search_launches()
    hybrid.encode_blocks_hybrid_optimal(data, p, block_size=4096, device=card)
    after = _search_launches()
    assert [b - a for a, b in zip(before, after)] == [1, 1, 1]


def test_search_wrappers_check_their_inputs(card):
    from lzma_tpu_torch.ops import cuda_search

    data, n = _search_lanes([64, 64], 1)
    d, k = data.to(card), n.to(card)
    with pytest.raises(ValueError):
        cuda_search.search_keys_cuda(d, k, 32, [8, 4])
    with pytest.raises(ValueError):
        cuda_search.search_keys_cuda(d, k, 32, [5])
    with pytest.raises(ValueError):
        cuda_search.search_keys_cuda(d.long(), k, 32, [4])
    order = torch.argsort(d.long(), dim=1, stable=True)
    with pytest.raises(ValueError):
        cuda_search.suffix_table_cuda(d, k, order, 64)
    empty = cuda_search.search_keys_cuda(d[:0], k[:0], 32, [4])
    assert [tuple(x.shape) for x in empty[0] + empty[1]] == [(0, 64)] * 5


# --------------------------------------------------- K12, K13, K14
def _row_args(widths, lc, lp, pb, fb, seed, dev):
    """dp_inputs_cuda's arguments for lanes of max(widths) positions, lane
    i of length widths[i] (the last one 0 where there are three or more):
    random bytes, pairs (invalid, near and far), a rep0 trace with sources
    before the block, a random rank permutation and table, probabilities
    in the coder's band."""
    from lzma_tpu_torch.ops import device_parser as tp

    rng = np.random.default_rng(seed)
    L, N = len(widths), max(widths)
    lens = np.array(widths, np.int64)
    if L > 2:
        lens[-1] = 0
    data = rng.integers(0, 4, (L, N)).astype(np.uint8)
    ld = rng.integers(0, fb + 1, (L, N, 4))
    dd = np.where(rng.random((L, N, 4)) < 0.5, rng.integers(-1, 128, (L, N, 4)),
                  rng.integers(128, 1 << 30, (L, N, 4)))
    r0pos = rng.integers(0, N + 50, (L, N))
    rank = np.stack([rng.permutation(N) for _ in range(L)])
    levels = max(1, (N - 1).bit_length())
    T = rng.integers(0, fb + 1, (L, levels, N)).astype(np.int32)
    S = ProbLayout(lc, lp, pb, pos_bits=pb).size
    probs = torch.from_numpy(rng.integers(32, 2017, (L, S))).to(dev)
    planes = tp._price_planes(probs)
    tables = tp.price_tables(*planes, lc, lp, pb)

    def t(a):
        return torch.from_numpy(a).to(dev)

    return (t(data), t(ld), t(dd), t(r0pos), (t(rank), t(T)), t(lens), planes,
            (tables["ps_price"], tables["dfull"], tables["align_price"]), lc,
            lp, pb, fb)


# max_n at K12's tile (256 positions) and block (8,192) edges
@pytest.mark.parametrize("widths", [[1, 1], [255, 3, 0], [256, 255, 1],
                                    [257, 256, 9], [8191, 100, 0],
                                    [8193, 8192, 7]],
                         ids=lambda w: f"max_n{max(w)}")
@pytest.mark.parametrize("lc,lp,pb,fb", [(3, 0, 2, 32), (0, 2, 0, 5),
                                         (8, 4, 4, 273)])
def test_dp_inputs_kernel_matches_plain(card, widths, lc, lp, pb, fb):
    from lzma_tpu_torch.ops import cuda_inputs
    from lzma_tpu_torch.ops import device_parser as tp

    args = _row_args(widths, lc, lp, pb, fb, sum(widths) + lc, card)
    before = cuda_inputs.LAUNCHES
    got = cuda_inputs.dp_inputs_cuda(*args)
    want = tp._dp_inputs_plain(*args)
    torch.cuda.synchronize()
    assert cuda_inputs.LAUNCHES == before + 1
    assert got.dtype == want.dtype == torch.int32 and torch.equal(got, want)


def test_dp_inputs_placements_and_shared_bytes(card):
    """K12 reads the literal slots from device memory at every lc and lp,
    so a block's shared bytes (the row stage and the distance tables) do
    not depend on them; the wrapper's count is the C entry's, and the
    grid's four blocks an SM run at M 1 to 6 (three at 8)."""
    from lzma_tpu_torch.ops import cuda_inputs

    for m, blocks in ((1, 4), (4, 4), (6, 4), (8, 3)):
        assert cuda_inputs._lib().lzt_dp_inputs_smem(m) == \
            cuda_inputs.smem_bytes(m)
        assert cuda_inputs.occupancy(m) == blocks, m


# K12 at lc3 lp0, lc4 lp0 and lc0 lp2 on lanes across its chunk and tile
# edges (8,193, 8,192 and 257 positions)
@pytest.mark.parametrize("lc,lp", [(3, 0), (4, 0), (0, 2)])
def test_dp_inputs_literal_settings_match_plain(card, lc, lp):
    from lzma_tpu_torch.ops import cuda_inputs
    from lzma_tpu_torch.ops import device_parser as tp

    args = _row_args([8193, 8192, 257], lc, lp, 2, 32, 7 + lc, card)
    got = cuda_inputs.dp_inputs_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, tp._dp_inputs_plain(*args))


def test_dp_inputs_prices_past_16_bits_match_plain(card):
    """A literal slot's price of 2^16 in lane 1 and a distance table's
    price of 70,000 in lane 2: K12 reads both as int32 and prices them as
    the plain version does."""
    from lzma_tpu_torch.ops import cuda_inputs
    from lzma_tpu_torch.ops import device_parser as tp

    args = list(_row_args([600, 600, 600], 3, 0, 2, 32, 3, card))
    ep1 = args[6][1].clone()
    ep1[1, ProbLayout(3, 0, 2, pos_bits=2).literal + 300] = 1 << 16
    args[6] = (args[6][0], ep1)
    assert torch.equal(cuda_inputs.dp_inputs_cuda(*args),
                       tp._dp_inputs_plain(*args))
    dfull = args[7][1].clone()
    dfull[2, 1, 5] = 70_000
    args[7] = (args[7][0], dfull, args[7][2])
    assert torch.equal(cuda_inputs.dp_inputs_cuda(*args),
                       tp._dp_inputs_plain(*args))


def _path_graph(max_n, seed, dev):
    """A DP's (from, choice) over max_n + 1 nodes in four lanes (hops of
    1..273, one all-literal lane; lens max_n, max_n // 2, 0, max_n) and a
    lazy parse's best (len, dist) over max_n positions with n max_n,
    max_n // 3, 0, max_n."""
    rng = np.random.default_rng(seed)
    NP = max_n + 1
    node = np.arange(NP)
    frm = np.maximum(node - rng.integers(1, 274, (4, NP)), 0)
    frm[1] = np.maximum(node - 1, 0)
    frm[:, 0] = 0
    half = max_n // 2
    frm[1, half + 1:] = node[half + 1:]
    lens = np.array([max_n, half, 0, max_n])
    choice = rng.integers(-1, 1 << 20, (4, NP))
    bl = np.where(rng.random((4, max_n)) < 0.5, rng.integers(0, 4, (4, max_n)),
                  rng.integers(2, 274, (4, max_n)))
    bd = rng.integers(0, 1 << 17, (4, max_n))
    n = np.array([max_n, max_n // 3, 0, max_n])

    def t(a, dtype):
        return torch.from_numpy(a).to(device=dev, dtype=dtype)

    return (t(frm, torch.int32), t(choice, torch.int32), t(lens, torch.int64),
            t(bl, torch.int64), t(bd, torch.int64), t(n, torch.int32))


def _path_launches():
    from lzma_tpu_torch.ops import cuda_path

    return cuda_path.MARK_LAUNCHES, cuda_path.COMPACT_LAUNCHES


# max_n at K13's and K14's tile edges (4,096 nodes a tile)
@pytest.mark.parametrize("max_n", [1, 2, 4095, 4096, 4097, 8193, 20000])
def test_path_kernels_match_plain(card, max_n):
    from lzma_tpu_torch.ops import cuda_path
    from lzma_tpu_torch.ops import device_matcher as dm
    from lzma_tpu_torch.ops import device_parser as tp

    frm, choice, lens, bl, bd, n = _path_graph(max_n, max_n, card)
    before = _path_launches()
    mark = cuda_path.extract_mark_cuda(frm, lens)
    assert torch.equal(mark, tp._extract_mark(frm, lens))
    got = cuda_path.extract_compact_cuda(frm, choice, mark)
    want = tp._extract_compact(frm, choice, mark)
    assert all(g.dtype == w.dtype and torch.equal(g, w)
               for g, w in zip(got, want))
    for lazy in (True, False):
        take, adv = dm._decide(bl, bd, lazy)
        for start in sorted({0, min(5, max_n), max_n}):
            on = cuda_path.greedy_mark_cuda(adv, n, start)
            assert torch.equal(on, dm._greedy_mark(adv, n, start)), start
            got = cuda_path.greedy_compact_cuda(bl, bd, take, on)
            want = dm._compact_taken(bl, bd, take, on)
            assert all(g.dtype == w.dtype and torch.equal(g, w)
                       for g, w in zip(got, want))
    after = _path_launches()
    k = 1 + 2 * len({0, min(5, max_n), max_n})
    assert [b - a for a, b in zip(before, after)] == [k, k]


@pytest.mark.parametrize("lane", [0, 1])
def test_path_kernels_on_a_lane_of_2049_tiles(card, lane):
    """K13 and K14 on one lane of 2,048 x 4,096 + 1 nodes (the `.lzma`
    stream's shape: 2,049 tiles, the door maps composed in groups of 128
    tiles), DP hops of 1..273 (lane 0) and all literals (lane 1), the
    lazy path from 0 and from 5, against the plain versions."""
    from lzma_tpu_torch.ops import cuda_path
    from lzma_tpu_torch.ops import device_matcher as dm
    from lzma_tpu_torch.ops import device_parser as tp

    max_n = 2048 * 4096
    frm, choice, lens, bl, bd, n = (t[lane:lane + 1]
                                    for t in _path_graph(max_n, 5, card))
    mark = cuda_path.extract_mark_cuda(frm, lens)
    assert torch.equal(mark, tp._extract_mark(frm, lens))
    got = cuda_path.extract_compact_cuda(frm, choice, mark)
    want = tp._extract_compact(frm, choice, mark)
    assert all(g.dtype == w.dtype and torch.equal(g, w)
               for g, w in zip(got, want))
    del frm, choice, mark, got, want
    take, adv = dm._decide(bl, bd, True)
    n = torch.full_like(n, max_n)
    for start in (0, 5):
        on = cuda_path.greedy_mark_cuda(adv, n, start)
        assert torch.equal(on, dm._greedy_mark(adv, n, start)), start
        got = cuda_path.greedy_compact_cuda(bl, bd, take, on)
        want = dm._compact_taken(bl, bd, take, on)
        assert all(g.dtype == w.dtype and torch.equal(g, w)
                   for g, w in zip(got, want))


def test_path_names_launch_the_kernels_on_the_card(card):
    """extract_tokens, greedy_path and _compact go through K13 and K14 on
    CUDA tensors: one launch each, the plain halves' tokens."""
    from lzma_tpu_torch.ops import device_matcher as dm
    from lzma_tpu_torch.ops import device_parser as tp

    frm, choice, lens, bl, bd, n = _path_graph(8193, 3, card)
    before = _path_launches()
    got = tp.extract_tokens(frm, choice, lens)
    assert [b - a for a, b in zip(before, _path_launches())] == [1, 1]
    want = tp._extract_compact(frm, choice, tp._extract_mark(frm, lens))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    before = _path_launches()
    on = dm.greedy_path(bl, bd, n, 8193, 5, True)
    got = dm._compact(bl, bd, on, n, True)
    assert [b - a for a, b in zip(before, _path_launches())] == [1, 1]
    take, adv = dm._decide(bl, bd, True)
    assert torch.equal(on, dm._greedy_mark(adv, n, 5))
    want = dm._compact_taken(bl, bd, take, on)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_path_mark_raises_where_the_kernel_cannot_follow(card):
    """A walk back into a tile it has left, a pointer or an end node
    outside the lane: ValueError after the launch."""
    from lzma_tpu_torch.ops import cuda_path

    frm = torch.arange(9000, dtype=torch.int32)
    frm[8500], frm[100] = 100, 8800            # tile 2 -> 0 -> 2
    frm[8800] = 8500
    with pytest.raises(ValueError, match="back into a tile"):
        cuda_path.extract_mark_cuda(frm[None].to(card),
                                    torch.tensor([8800], device=card))
    with pytest.raises(ValueError, match="outside the lane"):
        cuda_path.extract_mark_cuda(frm[None].to(card),
                                    torch.tensor([9000], device=card))
    frm[5] = 9005
    with pytest.raises(ValueError, match="outside the lane"):
        cuda_path.extract_mark_cuda(frm[None].to(card),
                                    torch.tensor([3], device=card))


def test_row_and_path_kernels_launch_on_every_route(card):
    """An optimal encode of one lane group launches K12 twice (a round
    each), K13 and K14 three times (the seed's lazy path, then each
    round's DP path); a lazy encode K13 and K14 once and K12 never."""
    from lzma_tpu_torch.format.properties import LzmaParams as TParams
    from lzma_tpu_torch.ops import cuda_inputs

    data = b"".join(_blocks(4, 4096, 3))
    p = TParams(dict_size=1 << 13, fast_bytes=32)
    for parse, want in (("optimal", [2, 3, 3]), ("lazy", [0, 1, 1])):
        before = [cuda_inputs.LAUNCHES, *_path_launches()]
        blob = api.encode_blocks(data, p, block_size=4096, parse=parse,
                                 device=card)
        after = [cuda_inputs.LAUNCHES, *_path_launches()]
        assert [b - a for a, b in zip(before, after)] == want, parse
        assert blob == api.encode_blocks(data, p, block_size=4096,
                                         parse=parse, device="cpu")


def test_row_and_path_wrappers_check_their_inputs(card):
    from lzma_tpu_torch.ops import cuda_inputs, cuda_path

    args = list(_row_args([64, 64], 3, 0, 2, 32, 1, card))
    bad = list(args)
    bad[0] = args[0].long()
    with pytest.raises(ValueError):
        cuda_inputs.dp_inputs_cuda(*bad)
    bad = list(args)
    bad[3] = args[3][:, :10]
    with pytest.raises(ValueError):
        cuda_inputs.dp_inputs_cuda(*bad)
    bad = list(args)
    bad[4] = (args[4][0], args[4][1].long())
    with pytest.raises(ValueError):
        cuda_inputs.dp_inputs_cuda(*bad)
    bad = list(args)
    bad[5] = args[5].cpu()
    with pytest.raises(ValueError):
        cuda_inputs.dp_inputs_cuda(*bad)
    frm, choice, lens, bl, bd, n = _path_graph(64, 1, card)
    with pytest.raises(TypeError):
        cuda_path.extract_mark_cuda(frm.float(), lens)
    with pytest.raises(ValueError):
        cuda_path.extract_mark_cuda(frm, lens[:2])
    mark = cuda_path.extract_mark_cuda(frm, lens)
    with pytest.raises(TypeError):
        cuda_path.extract_compact_cuda(frm, choice, mark.int())
    with pytest.raises(ValueError):
        cuda_path.greedy_mark_cuda(bl, n, 65)
    with pytest.raises(ValueError):
        cuda_path.greedy_compact_cuda(bl, bd, mark[:, :64].cpu(), mark[:, :64])
    empty = cuda_path.extract_compact_cuda(frm[:0], choice[:0], mark[:0])
    assert [tuple(x.shape) for x in empty] == [(0, 65)] * 4 + [(0,)]


# --------------------------------------------------- K15, K16, K17
def _lazy_lanes(widths, seed):
    """Lanes of max(widths) bytes, lane i of length widths[i]: bench data,
    runs of one byte past 273, a period-20 pattern, and a data word equal
    to the mark of position n (80 00 00 n) followed by the bytes after
    n + 4, so that a data suffix and a marked one share their 32-byte
    key."""
    rng = np.random.default_rng(seed)
    L, max_n = len(widths), max(widths)
    data = np.frombuffer(generate_bench_data(L * max_n), np.uint8).reshape(
        L, max_n).copy()
    lens = np.array(widths, np.int64)
    for i in range(L):
        kind = i % 4
        if kind == 1:
            data[i, : max_n // 2] = 97
        elif kind == 2:
            data[i] = np.tile(rng.integers(0, 256, 20), max_n // 20 + 1)[:max_n]
        elif kind == 3 and 8 <= lens[i] < 256 and lens[i] + 36 <= max_n:
            m = int(lens[i])
            data[i, :4] = (0x80, 0, 0, m)
            data[i, 4:32] = data[i, m + 4:m + 32]
    return torch.from_numpy(data), torch.from_numpy(lens)


def _lazy_launches():
    from lzma_tpu_torch.ops import cuda_lazy

    return (cuda_lazy.GROUP_LAUNCHES, cuda_lazy.DESCENT_LAUNCHES,
            cuda_lazy.BEST_LAUNCHES)


# max_n 1-3 and 33 (the descent's indices wrap and clamp), K15's tile
# edges (512 places a tile) and K17's (256 places, a halo of up to 16),
# where runs of one byte make hash groups that straddle them, lanes of
# many tiles (3,073 K15 tiles a look-back reads 32 at a time), lanes of n
# below max_n and of 0
@pytest.mark.parametrize("widths", [[1, 1], [2, 1, 0], [3, 3, 2, 1],
                                    [33, 20, 33, 0], [255, 256, 257, 100],
                                    [511, 512, 513, 300],
                                    [1023, 1024, 1025, 300],
                                    [4096, 4000, 4096, 100, 0],
                                    [20000, 19000, 20000, 40],
                                    [(3 << 19) + 1, 5000]],
                         ids=lambda w: f"max_n{max(w)}x{len(w)}")
def test_lazy_kernels_match_plain(card, widths):
    """K15 at every doubling level (a doubling level flagged by its sort's
    values), K16 and K17 (fb 5, 32 and 273; 1, 4 and 16 candidates)
    against their plain versions on the same card tensors, through the
    route's own chain of sorts."""
    from lzma_tpu_torch.ops import cuda_lazy, cuda_search
    from lzma_tpu_torch.ops import device_matcher as dm

    data, n = _lazy_lanes(widths, sum(widths))
    d, k = data.to(card), n.to(card)
    max_n = d.shape[1]
    keys, (h,) = cuda_search.search_keys_cuda(d, k, 32, [4])
    order = dm._sort_packed(keys)
    got = cuda_lazy.doubling_groups_cuda(order, d, k, next_span=32)
    want = dm._doubling_groups_plain(order, d, k, next_span=32)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    grps, span = [got[0]], 32
    while span < 273:
        srt = torch.sort(got[1], dim=1, stable=True)
        order = srt.indices
        nxt = 2 * span if 2 * span < 273 else 0
        got = cuda_lazy.doubling_groups_cuda(order, d, k, grps[-1], span, nxt,
                                             sorted_key=srt.values)
        want = dm._doubling_groups_plain(order, d, k, grps[-1], span, nxt)
        assert torch.equal(got[0], want[0]), span
        assert (got[1] is None) == (want[1] is None) == (nxt == 0)
        assert nxt == 0 or torch.equal(got[1], want[1])
        grps.append(got[0])
        span *= 2
    cl = cuda_lazy.descent_lcp_cuda(order, grps, d, k, 273)
    assert torch.equal(cl, dm._descent_lcp_plain(order, grps, d, k, 273))
    rank, T = cuda_search.suffix_table_cuda(d, k, order, 273, cl)
    s = torch.sort(h, dim=1, stable=True)
    for fb, cands in ((5, 4), (32, 4), (273, 1), (273, 16)):
        args = (s.values, s.indices, rank, T, k, min(1800, max_n), fb, cands)
        got = cuda_lazy.best_matches_cuda(*args)
        want = dm._best_matches_plain(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (fb, cands)
    # and the whole search, JAX's semantics on the CPU
    w_rank, w_T = dm._suffix_rank_lcp(
        data, n, 273, cuda_search.search_keys_cuda(data, n, 32, [])[0])
    assert torch.equal(rank.cpu(), w_rank) and torch.equal(T.cpu(), w_T)


def test_lazy_kernels_launch_on_every_route(card):
    """A lazy encode launches K9 once, K15 five times (the 32-byte level
    and each doubling), K16 and K17 once; the optimal encode at fb 32
    none of K15-K17, at fb 273 K15 five times and K16 once (its suffix
    table); the tokens equal the CPU's."""
    from lzma_tpu_torch.format.properties import LzmaParams as TParams
    from lzma_tpu_torch.ops import cuda_search

    data = b"".join(_blocks(4, 4096, 3))
    for parse, fb, want in (("lazy", 32, [1, 5, 1, 1]),
                            ("optimal", 32, [1, 0, 0, 0]),
                            ("optimal", 273, [1, 5, 1, 0])):
        p = TParams(dict_size=1 << 13, fast_bytes=fb)
        before = [cuda_search.KEYS_LAUNCHES, *_lazy_launches()]
        blob = api.encode_blocks(data, p, block_size=4096, parse=parse,
                                 device=card)
        after = [cuda_search.KEYS_LAUNCHES, *_lazy_launches()]
        assert [b - a for a, b in zip(before, after)] == want, (parse, fb)
        assert blob == api.encode_blocks(data, p, block_size=4096,
                                         parse=parse, device="cpu")


def test_lazy_wrappers_check_their_inputs(card):
    from lzma_tpu_torch.ops import cuda_lazy, cuda_search

    data, n = _lazy_lanes([64, 64], 1)
    d, k = data.to(card), n.to(card)
    keys, (h,) = cuda_search.search_keys_cuda(d, k, 32, [4])
    order = torch.sort(keys[0], dim=1, stable=True).indices
    with pytest.raises(ValueError):
        cuda_lazy.doubling_groups_cuda(order, d.long(), k)
    with pytest.raises(ValueError):
        cuda_lazy.doubling_groups_cuda(order[:, :10], d, k)
    g, key = cuda_lazy.doubling_groups_cuda(order, d, k, next_span=32)
    with pytest.raises(ValueError):
        cuda_lazy.doubling_groups_cuda(order, d, k, g, 0)
    # a doubling level flags by its sort's values: none given raises, on
    # the card there is no route by the ids' gathers
    with pytest.raises(ValueError, match="sorted_key"):
        cuda_lazy.doubling_groups_cuda(order, d, k, g, 32, 64)
    with pytest.raises(ValueError):
        cuda_lazy.doubling_groups_cuda(order, d, k, g, 32, 64,
                                       sorted_key=key[:, :10])
    with pytest.raises(ValueError):
        cuda_lazy.descent_lcp_cuda(order, [g] * 10, d, k, 273)
    cl = cuda_lazy.descent_lcp_cuda(order, [g, g], d, k, 273)
    rank, T = cuda_search.suffix_table_cuda(d, k, order, 273, cl)
    s = torch.sort(h, dim=1, stable=True)
    with pytest.raises(ValueError):
        cuda_lazy.best_matches_cuda(s.values, s.indices, rank, T.long(), k, 64,
                                    32, 4)
    with pytest.raises(ValueError):
        cuda_lazy.best_matches_cuda(s.values, s.indices, rank, T, k, 64, 32, 17)
    with pytest.raises(ValueError):
        cuda_lazy.best_matches_cuda(s.values, s.indices, rank, T, k.cpu(), 64,
                                    32, 4)
    empty = cuda_lazy.doubling_groups_cuda(order[:0], d[:0], k[:0],
                                           next_span=32)
    assert [tuple(x.shape) for x in empty] == [(0, 64)] * 2


# ------------------------------------------------------ K16 word windows
def _doubling_levels(data, n, depth=273):
    """The plain doubling's levels of CPU lanes (_suffix_rank_lcp's)."""
    from lzma_tpu_torch.ops import device_matcher as dm

    keys = dm._search_keys_plain(data, n, 32, [])[0]
    order = dm._sort_packed(keys)
    g, key = dm._doubling_groups_plain(order, data, n, next_span=32)
    grps, span = [g], 32
    while span < depth:
        order = torch.sort(key, dim=1, stable=True).indices
        g, key = dm._doubling_groups_plain(order, data, n, g, span,
                                           2 * span if 2 * span < depth else 0)
        grps.append(g)
        span *= 2
    return grps


@pytest.mark.parametrize("max_n", [17, 33, 508, 509, 600, 4099])
def test_descent_words_match_plain(card, max_n):
    """K16 on random orders: at most 508 places on random group levels
    (equal ids common: descents to 480; a + l past 2 max_n clamps), wider
    lanes on the doubling's own levels (where the first 32-byte keys
    differ K16 reads no id); lanes of n = max_n, below it and 0; depths
    5, 32 and 273."""
    from lzma_tpu_torch.ops import cuda_lazy
    from lzma_tpu_torch.ops import device_matcher as dm

    rng = np.random.default_rng(max_n)
    data = torch.from_numpy(np.stack([
        rng.integers(0, 2, max_n), np.zeros(max_n, np.int64),
        np.tile(rng.integers(0, 256, 7), max_n // 7 + 1)[:max_n],
        rng.integers(0, 256, max_n)]).astype(np.uint8))
    n = torch.tensor([max_n, max_n - max_n // 3, 0, max_n])
    real = _doubling_levels(data, n) if max_n > 508 else None
    order = torch.from_numpy(np.stack([rng.permutation(max_n)
                                       for _ in range(4)])).to(card)
    d, k = data.to(card), n.to(card)
    for depth, levels in ((5, 0), (32, 0), (273, 4)):
        grps = ([g.to(card) for g in real[:levels + 1]] if real else
                [torch.from_numpy(rng.integers(0, 2 + t % 2, (4, max_n))).to(card)
                 for t in range(levels + 1)])
        got = cuda_lazy.descent_lcp_cuda(order, grps, d, k, depth)
        want = dm._descent_lcp_plain(order, grps, d, k, depth)
        torch.cuda.synchronize()
        assert torch.equal(got, want), depth


# ------------------------------------------------------- K18 price model
def _model_counts(lc, lp, pb, lanes, seed, dev, wrap=False):
    """Slot counts (n, n1) int32 of `lanes` lanes: most pairs on the slots
    before the literal coders; with `wrap`, lane 0's slots 3 and 4 counted
    past the int32 numerator's range (600,000 and 1,100,000 zeros)."""
    rng = np.random.default_rng(seed)
    layout = ProbLayout(lc, lp, pb, pos_bits=pb)
    S = layout.size
    n = np.zeros((lanes, S), np.int64)
    n1 = np.zeros((lanes, S), np.int64)
    for i in range(lanes):
        ctx = np.where(rng.random(20000) < 0.7,
                       rng.integers(0, layout.literal, 20000),
                       rng.integers(0, S, 20000))
        bits = rng.random(20000) < rng.random(S)[ctx]
        np.add.at(n[i], ctx, 1)
        np.add.at(n1[i], ctx, bits)
    if wrap:
        n[0, 3], n1[0, 3] = 600_000, 0
        n[0, 4], n1[0, 4] = 1_100_000, 100
    return (torch.from_numpy(n).int().to(dev), torch.from_numpy(n1).int().to(dev))


@pytest.mark.parametrize("fb", [5, 32, 273])
@pytest.mark.parametrize("lc,lp,pb", [(3, 0, 2), (0, 2, 0), (8, 4, 4),
                                      (4, 0, 4)])
def test_price_model_matches_plain(card, lc, lp, pb, fb):
    """K18 = _price_model_plain on the same card tensors: the planes (the
    16-byte path), the distance tables and the row, int32, exactly; a
    lane whose numerator wraps; one lane and 33."""
    from lzma_tpu_torch.ops import cuda_model
    from lzma_tpu_torch.ops.device_parser import _price_model_plain

    for lanes, wrap in ((3, True), (1, False), (33, False)):
        if lc == 8 and lanes == 33:
            continue
        n, n1 = _model_counts(lc, lp, pb, lanes, lc + pb + fb + lanes, card,
                              wrap)
        before = cuda_model.LAUNCHES
        got = cuda_model.price_model_cuda(n, n1, lc, lp, pb, fb)
        want = _price_model_plain(n, n1, lc, lp, pb, fb)
        torch.cuda.synchronize()
        assert cuda_model.LAUNCHES == before + 1
        assert [(t.dtype, t.shape) for t in got] == \
            [(t.dtype, t.shape) for t in want]
        assert all(torch.equal(a, b) for a, b in zip(got, want)), lanes


def test_price_model_unaligned_and_strided_counts(card):
    """Counts that are views (a column slice, an odd offset: no 16-byte
    path) give the plain version's outputs."""
    from lzma_tpu_torch.ops import cuda_model
    from lzma_tpu_torch.ops.device_parser import _price_model_plain

    S = ProbLayout(0, 0, 1, pos_bits=1).size
    n, n1 = _model_counts(0, 0, 1, 5, 9, card)
    wide = torch.zeros((5, S + 3), dtype=torch.int32, device=card)
    wide[:, 1:S + 1] = n
    wide1 = torch.zeros_like(wide)
    wide1[:, 1:S + 1] = n1
    flat = torch.zeros(5 * S + 1, dtype=torch.int32, device=card)
    flat[1:] = n.reshape(-1)
    flat1 = torch.zeros_like(flat)
    flat1[1:] = n1.reshape(-1)
    want = _price_model_plain(n, n1, 0, 0, 1, 32)
    for a, b in ((wide[:, 1:S + 1], wide1[:, 1:S + 1]),
                 (flat[1:].view(5, S), flat1[1:].view(5, S))):
        got = cuda_model.price_model_cuda(a, b, 0, 0, 1, 32)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_price_model_launches_in_each_round_and_checks_inputs(card):
    """An optimal encode launches K18 once a round (two), a lazy one never;
    the wrapper refuses other shapes, dtypes and parameters; no lanes
    launch nothing."""
    from lzma_tpu_torch.format.properties import LzmaParams as TParams
    from lzma_tpu_torch.ops import cuda_model

    data = b"".join(_blocks(4, 4096, 5))
    for parse, want in (("optimal", 2), ("lazy", 0)):
        before = cuda_model.LAUNCHES
        blob = api.encode_blocks(data, TParams(dict_size=1 << 13),
                                 block_size=4096, parse=parse, device=card)
        assert cuda_model.LAUNCHES - before == want, parse
        assert blob == api.encode_blocks(data, TParams(dict_size=1 << 13),
                                         block_size=4096, parse=parse,
                                         device="cpu")
    n, n1 = _model_counts(3, 0, 2, 2, 1, card)
    with pytest.raises(ValueError):
        cuda_model.price_model_cuda(n[:, :-1], n1[:, :-1], 3, 0, 2, 32)
    with pytest.raises(ValueError):
        cuda_model.price_model_cuda(n, n1, 3, 1, 2, 32)
    with pytest.raises(ValueError):
        cuda_model.price_model_cuda(n, n1, 3, 0, 2, 274)
    with pytest.raises(TypeError):
        cuda_model.price_model_cuda(n.long(), n1.long(), 3, 0, 2, 32)
    with pytest.raises(ValueError):
        cuda_model.price_model_cuda(n, n1.cpu(), 3, 0, 2, 32)
    before = cuda_model.LAUNCHES
    out = cuda_model.price_model_cuda(n[:0], n1[:0], 3, 0, 2, 32)
    assert cuda_model.LAUNCHES == before and [t.shape[0] for t in out] == [0] * 6


# -------------------------------- K19: classify_tokens whole on the card
def _token_planes(T, N, seed, gaps, max_n=300):
    """classify_tokens' arguments on the CPU: data (N, max_n) and the
    (N, T) planes of ``_token_rows`` (t_pos drawn over [0, max_n])."""
    rng = np.random.default_rng(seed + 1)
    dist_r, len_r, valid_r = _token_rows(T, N, seed, gaps)
    data = torch.from_numpy(rng.integers(0, 256, (N, max_n)).astype(np.uint8))
    t_pos = torch.from_numpy(rng.integers(0, max_n + 1, (N, T)))
    return data, t_pos, len_r.T.long(), dist_r.T.long(), valid_r.T.contiguous()


def _classify_on_card(args, dev):
    from lzma_tpu_torch.ops.device_encoder import _classify_tokens_plain

    before = cuda_classify.TOKEN_LAUNCHES
    got = cuda_classify.classify_tokens_cuda(*(a.to(dev) for a in args))
    torch.cuda.synchronize()
    assert cuda_classify.TOKEN_LAUNCHES == before + (args[1].numel() > 0)
    want = _classify_tokens_plain(*args)
    assert [(g.dtype, g.shape) for g in got] == [(w.dtype, w.shape) for w in want]
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g.cpu(), w), k


# K6's chunk and tile edges, in the (N, T) layout
@pytest.mark.parametrize("T,N", [(0, 3), (1, 1), (2, 2), (37, 33), (300, 64),
                                 (129, 65), (4097, 1), (1025, 3), (129, 32)])
@pytest.mark.parametrize("gaps", [False, True])
def test_classify_tokens_kernel_matches_plain(card, T, N, gaps):
    _classify_on_card(_token_planes(T, N, T * 3 + N, gaps), card)


def test_classify_tokens_kernel_on_strided_planes_and_both_parses(card):
    """The rounds' sliced planes (a row stride past T), int32 lengths, and
    both parses' tokens of 8 x 2 KiB with the EOS marker, t_pos at
    max_n."""
    from lzma_tpu_torch.ops.device_parser import tokenize_optimal

    data, t_pos, t_len, t_dist, t_valid = _token_planes(700, 8, 5, True)
    wide = [torch.cat([a, a[:, :9]], dim=1) for a in (t_pos, t_len, t_dist,
                                                    t_valid)]
    _classify_on_card((data, wide[0][:, :700], wide[1][:, :700].int(),
                       wide[2][:, :700], wide[3][:, :700]), card)
    d, n = pad_rows(_blocks(8, 2048, 3), "cpu")
    for tok in (tokenize(d, n, d.shape[1], 32),
                tokenize_optimal(d, n, d.shape[1], lc=3, lp=0, pb=2, fb=32)):
        eos = _append_eos_tokens(*tok[:4], tok[4], n)
        _classify_on_card((d, *eos), card)


def test_classify_tokens_wrapper_checks_its_inputs(card):
    data, *planes = (a.to(card) for a in _token_planes(40, 4, 1, False))
    with pytest.raises(ValueError):
        cuda_classify.classify_tokens_cuda(data, planes[0][:, :5], *planes[1:])
    with pytest.raises(ValueError):
        cuda_classify.classify_tokens_cuda(data, planes[0].cpu(), *planes[1:])
    with pytest.raises(TypeError):
        cuda_classify.classify_tokens_cuda(data, planes[0].float(), *planes[1:])
    with pytest.raises(ValueError):
        cuda_classify.classify_tokens_cuda(data[:, :0], *planes)


# ---------------------------------------- K20: the rounds' rep0 trace
def _rep0_lanes(T, N, L, seed, gaps=True):
    """(t_pos, t_dist, t_valid) (L, T) on the CPU: each lane's valid tokens
    at strictly ascending positions from a drawn start (some past N - 1),
    literals and matches, invalid slots among them where `gaps`, drawn
    garbage past each lane's last token."""
    rng = np.random.default_rng(seed)
    steps = rng.integers(1, 8, (L, T))
    pos = np.cumsum(steps, axis=1) + rng.integers(0, 5, (L, 1))
    dist = np.where(rng.random((L, T)) < 0.4, -1, rng.integers(0, 1 << 20, (L, T)))
    valid = np.arange(T)[None, :] < rng.integers(0, T + 1, (L, 1))
    if gaps:
        valid &= rng.random((L, T)) > 0.1
    pos = np.where(valid, pos, rng.integers(-3, N + 9, (L, T)))
    return (torch.from_numpy(pos), torch.from_numpy(dist),
            torch.from_numpy(valid))


@pytest.mark.parametrize("T,N,L", [(1, 7, 2), (2047, 4096, 3), (2048, 9000, 2),
                                   (2049, 16000, 2), (3 * 2048 + 5, 30000, 4),
                                   (600, 700, 33), (50, 10, 3)])
def test_rep0_trace_kernel_matches_plain(card, T, N, L):
    from lzma_tpu_torch.ops import cuda_inputs
    from lzma_tpu_torch.ops.device_parser import rep0_trace

    for gaps in (False, True):
        args = _rep0_lanes(T, N, L, T + N + L, gaps)
        before = cuda_inputs.REP0_LAUNCHES
        got = cuda_inputs.rep0_trace_cuda(*(a.to(card) for a in args), N)
        torch.cuda.synchronize()
        assert cuda_inputs.REP0_LAUNCHES == before + 1
        assert got.dtype == torch.int64 and got.shape == (L, N)
        assert torch.equal(got.cpu(), rep0_trace(*args, N))


def test_rep0_trace_kernel_raises_where_the_order_breaks(card):
    """K20 raises the plain precondition's ValueError on equal, descending
    and negative valid positions; an invalid token out of order does not
    count; no tokens give zeros; the sliced planes of a round go through
    their strides."""
    from lzma_tpu_torch.ops import cuda_inputs
    from lzma_tpu_torch.ops.device_parser import check_rep0_order, rep0_trace

    rng = np.random.default_rng(9)
    t_pos = torch.from_numpy(np.cumsum(rng.integers(1, 8, (3, 3000)), axis=1))
    t_dist = torch.from_numpy(rng.integers(-1, 1000, (3, 3000)))
    t_valid = torch.arange(3000).expand(3, 3000) < 2500
    for at, p, v in ((2100, None, True), (2100, 0, True), (5, -1, True),
                     (2100, 0, False)):
        pos, valid = t_pos.clone(), t_valid.clone()
        pos[1, at] = pos[1, at - 1] if p is None else p
        valid[1, at] = v
        args = (pos.to(card), t_dist.to(card), valid.to(card))
        if v:
            with pytest.raises(ValueError, match="strictly ascending"):
                check_rep0_order(pos, valid)
            with pytest.raises(ValueError, match="strictly ascending"):
                cuda_inputs.rep0_trace_cuda(*args, 20000)
        else:
            got = cuda_inputs.rep0_trace_cuda(*args, 20000)
            assert torch.equal(got.cpu(), rep0_trace(pos, t_dist, valid, 20000))
    got = cuda_inputs.rep0_trace_cuda(*(a[:, :0].to(card) for a in
                                        (t_pos, t_dist, t_valid)), 100)
    assert got.shape == (3, 100) and not bool(got.any())
    wide = [torch.cat([a, a[:, :7]], dim=1).to(card) for a in
            (t_pos, t_dist, t_valid)]
    got = cuda_inputs.rep0_trace_cuda(*(w[:, :3000] for w in wide), 20000)
    assert torch.equal(got.cpu(), rep0_trace(t_pos, t_dist, t_valid, 20000))


# ------------------------- K21: the DP pairs and the seed's longest pair
def _lists_drawn(L, N, W, seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, W + 1, (L, N))
    counts[:, :4] = [0, 1, 4, 5][:N]
    cl = np.sort(rng.integers(0, 274, (L, N, W)), axis=2)
    cl = np.where(np.arange(W)[None, None, :] < counts[:, :, None], cl, 0)
    cd = np.where(cl > 0, rng.integers(0, 1 << 22, (L, N, W)), 0)
    return (torch.from_numpy(cl), torch.from_numpy(cd),
            torch.from_numpy(counts))


@pytest.mark.parametrize("L,N,W", [(1, 1, 5), (3, 255, 12), (4, 257, 12),
                                   (2, 5000, 29), (32, 300, 12)])
def test_list_pairs_kernel_matches_plain(card, L, N, W):
    from lzma_tpu_torch.ops import cuda_search
    from lzma_tpu_torch.ops.device_parser import _list_pairs_plain

    args = _lists_drawn(L, N, W, L * N + W)
    before = cuda_search.PAIR_LAUNCHES
    got = cuda_search.list_pairs_cuda(*(a.to(card) for a in args))
    torch.cuda.synchronize()
    assert cuda_search.PAIR_LAUNCHES == before + 1
    want = _list_pairs_plain(*args)
    assert [(g.dtype, g.shape) for g in got] == [(w.dtype, w.shape) for w in want]
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_list_pairs_wrapper_checks_its_inputs(card):
    from lzma_tpu_torch.ops import cuda_search

    cl, cd, counts = (a.to(card) for a in _lists_drawn(2, 30, 12, 1))
    with pytest.raises(ValueError):
        cuda_search.list_pairs_cuda(cl[:, :, :4], cd[:, :, :4], counts)
    with pytest.raises(TypeError):
        cuda_search.list_pairs_cuda(cl.int(), cd, counts)
    with pytest.raises(ValueError):
        cuda_search.list_pairs_cuda(cl, cd[:1], counts)
    before = cuda_search.PAIR_LAUNCHES
    out = cuda_search.list_pairs_cuda(cl[:0], cd[:0], counts[:0])
    assert cuda_search.PAIR_LAUNCHES == before and out[0].shape == (0, 30, 4)


def test_round_kernels_launch_on_each_encode(card):
    """An optimal encode launches K19 3 times (2 rounds and the final
    tokens), K20 twice and K21 once; a lazy one K19 once; the containers
    equal the CPU's."""
    from lzma_tpu_torch.format.properties import LzmaParams as TParams
    from lzma_tpu_torch.ops import cuda_inputs, cuda_search

    data = b"".join(_blocks(4, 4096, 7))
    for parse, want in (("optimal", (3, 2, 1)), ("lazy", (1, 0, 0))):
        before = (cuda_classify.TOKEN_LAUNCHES, cuda_inputs.REP0_LAUNCHES,
                  cuda_search.PAIR_LAUNCHES)
        blob = api.encode_blocks(data, TParams(dict_size=1 << 13),
                                 block_size=4096, parse=parse, device=card)
        after = (cuda_classify.TOKEN_LAUNCHES, cuda_inputs.REP0_LAUNCHES,
                 cuda_search.PAIR_LAUNCHES)
        assert tuple(a - b for a, b in zip(after, before)) == want, parse
        assert blob == api.encode_blocks(data, TParams(dict_size=1 << 13),
                                         block_size=4096, parse=parse,
                                         device="cpu")
