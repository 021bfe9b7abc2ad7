"""The CUDA kernels against their plain versions, on the card.

Every test takes the `card` fixture, which skips when PyTorch sees no
CUDA device (the decision is made at run time, never at import).  Run on
a machine with an NVIDIA H100 and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -q
"""

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
from lzma_tpu_torch.ops import (api, cuda_classify, cuda_decoder, cuda_parser,
                                cuda_ring, cuda_serializer)
from lzma_tpu_torch.ops.device_decoder import _decode_fsm, pad_rows
from lzma_tpu_torch.ops.device_encoder import (EOS_DIST, _append_eos_tokens,
                                               _classify_carry, _classify_rows,
                                               _lower_lanes, classify_tokens,
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
    before = cuda_classify.LAUNCHES
    got = classify_tokens(data.to(card), *(t.to(card) for t in toks))
    assert cuda_classify.LAUNCHES == before + 1
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
    """The hybrid's list search and its packing (no kernel of its own:
    plain PyTorch on the card) give the CPU's lists, pair buffers and
    counts, the clamped ones at a small cap included."""
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


def test_cli_benchmark_runs_on_the_card(card, capsys):
    """`b 1 -d18`: one pass of 2.25 MiB, K6 and K2 once, K1 twice (the
    harness CRC-checks both decodes)."""
    from lzma_tpu_torch import cli

    for mod in (cuda_classify, cuda_serializer, cuda_ring):
        mod.LAUNCHES = 0
    assert cli.main(["b", "1", "-d18"]) == 0
    assert capsys.readouterr().out.count(" KB/s ") == 4
    assert (cuda_classify.LAUNCHES, cuda_serializer.LAUNCHES,
            cuda_ring.LAUNCHES) == (1, 1, 2)


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
