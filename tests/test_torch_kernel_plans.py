"""What the redesigned K2 and K3 decide on the host, and K3's step order.

These run on the CPU.  The CUDA kernels themselves are held against their
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py); here:

- K2's arena placement (``cuda_serializer.arena_placement``) over the
  lc/lp grid against a given shared-memory limit, and its footprint;
- K3's block plan (``cuda_parser.dp_parse_plan``): its shared memory at
  fb 5..273 x pb 0..4 fits the H100's opt-in 232,448 B a block, its
  rings are powers of two wide enough for the step;
- a numpy restatement of K3's new step order (step i finalizes node i+1
  from slot i+1 and the literal/shortRep edge held from node i, while
  node i relaxes from the terms handed over a step earlier; power-of-two
  rings indexed by masks, slot i retired at step i), equal to
  ``dp_parse_band``'s planes on the bench config's first-round inputs
  (its first 4 lanes).
"""

import numpy as np
import pytest
import torch

from lzma_tpu_torch.bench.datagen import generate_bench_data
from lzma_tpu_torch.core.layout import ProbLayout
from lzma_tpu_torch.ops import cuda_serializer
from lzma_tpu_torch.ops.cuda_parser import (NODE_VALS, SPLIT_FB, TILE_ROWS,
                                            dp_parse_plan)
from lzma_tpu_torch.ops.cuda_serializer import (PLACEMENTS, TILE,
                                                arena_placement, smem_bytes)
from lzma_tpu_torch.ops.device_decoder import pad_rows
from lzma_tpu_torch.ops.device_parser import (INF, M_DP, RK_LIT, RK_MATCH,
                                              RK_SHORTREP, _lists_and_seed,
                                              _round_inputs, dp_parse_band,
                                              table_size)

#: the opt-in shared memory a block may use on an H100 (the card reports
#: it as cudaDevAttrMaxSharedMemoryPerBlockOptin)
H100_SMEM = 232_448

#: bench.py's device round trip (chip_smoke BENCH_INPUT): 32 lanes of
#: 16 KiB, dict 16 KiB, fb 32, LzmaParams() lc3 lp0 pb2
BENCH_SIZE, BENCH_BLOCK, BENCH_DICT, BENCH_FB = 1 << 19, 1 << 14, 1 << 14, 32
#: its lanes the step order is held on (lanes are independent, and the
#: scan's time is its 16,384 steps, not its lanes)
BENCH_LANES = 4


@pytest.mark.parametrize("lp", range(5))
@pytest.mark.parametrize("lc", range(9))
def test_arena_placement_over_the_lc_lp_grid(lc, lp):
    arena = ProbLayout(lc, lp, 2, pos_bits=2).size
    tiles = 2 * 2 * TILE * 4
    shared = tiles + (2 * arena + 15) // 16 * 16
    assert smem_bytes("shared", arena) == shared
    assert smem_bytes("device", arena) == tiles
    want = "shared" if shared <= H100_SMEM else "device"
    assert arena_placement(arena, H100_SMEM) == want
    # the limit decides, not lc/lp: one byte short of the footprint moves it
    assert arena_placement(arena, shared) == "shared"
    assert arena_placement(arena, shared - 1) == "device"
    # lc + lp <= 7 fits the H100; 8 does not (768 << (lc + lp) literal slots)
    assert (want == "shared") == (lc + lp <= 7)


def test_arena_placement_names_are_checked():
    assert PLACEMENTS == ("shared", "device")
    with pytest.raises(ValueError):
        smem_bytes("global", 7318)


def test_serializer_cpu_path_ignores_the_placement():
    # an arena that a card would hold in shared memory and one it would
    # put in device memory code the same streams to the same bytes, and
    # the CPU path launches nothing
    ctx = torch.tensor([[0, 1, -1, -3, 0]], dtype=torch.int32)
    bits = torch.tensor([[1, 0, 1, 0, 1]], dtype=torch.int32)
    totals = torch.tensor([5], dtype=torch.int32)
    sizes = (16, ProbLayout(8, 4, 2, pos_bits=2).size)
    assert [arena_placement(a, H100_SMEM) for a in sizes] == list(PLACEMENTS)
    before = cuda_serializer.LAUNCHES
    runs = [cuda_serializer.serialize_cuda(ctx, bits, totals, a, 64)
            for a in sizes]
    assert cuda_serializer.LAUNCHES == before
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("pb", range(5))
def test_dp_parse_plan_fits_the_card(pb):
    C = 6 * M_DP + 5
    for fb in range(5, 274):
        threads, B, H, smem = dp_parse_plan(fb, pb, C)
        assert smem <= H100_SMEM
        assert smem == 4 * (table_size(pb, fb) + 4 * B + 5 * H
                            + 2 * NODE_VALS + 2 * TILE_ROWS * C)
        # relax warps for the lengths 2..fb, 4 lanes a length at fb <= 65
        # (4 pairs a row), and the finalize warp
        relax, split = threads - 32, 4 if fb <= SPLIT_FB else 1
        assert relax % 32 == 0 and relax - 32 < split * (fb - 1) <= relax
        assert threads <= 1024
        if fb == 32:                     # the main path: 4 relax warps
            assert threads == 160
        for ring, least in ((B, fb + 2), (H, fb + 1)):
            assert ring & (ring - 1) == 0 and least <= ring < 2 * least


def _split(tables, n_ps, W):
    sizes = [n_ps * W] * 2 + [n_ps * 12] * 4 + [12, 12, 48]
    parts = np.split(tables, np.cumsum(sizes)[:-1], axis=1)
    L = tables.shape[0]
    shapes = [(n_ps, W)] * 2 + [(n_ps, 12)] * 4 + [(12,), (12,), (4, 12)]
    return [p.reshape((L,) + s) for p, s in zip(parts, shapes)]


def k3_step_order(packed, tables, lens, fb, pb):
    """csrc/dp_parse.cu's schedule in numpy, all lanes at once: returns
    (from, choice), each (L, N + 1)."""
    L, N, C = packed.shape
    M = (C - 5) // 6
    W, n_ps = fb - 1, 1 << pb
    _, B, H, _ = dp_parse_plan(fb, pb, C)
    bm, hm = B - 1, H - 1
    ltm, ltr, im0, im1, r0l0, r0l1, ir0, ir1, sel = _split(tables, n_ps, W)
    lanes = np.arange(L)
    lvec = np.arange(2, fb + 1)
    lps = np.minimum(lvec - 2, 3)

    def full(shape, v):
        return np.full(shape, v, dtype=np.int64)

    bp, bf, bc, bk = full((L, B), INF), full((L, B), 0), full((L, B), -1), \
        full((L, B), RK_LIT)
    bp[:, 0] = 0
    hst, hrp = full((L, H), 0), full((L, H, 4), 0)
    out_from, out_choice = full((L, N + 1), 0), full((L, N + 1), 0)
    # the finalize warp: node j-1 and the edge held out of it into node j
    fin = dict(st1=full(L, 0), q=full((L, 4), 0), lit_p=full(L, INF),
               lit_c=full(L, -1), lit_k=full(L, RK_LIT))
    nv = [None, None]                    # node i's relax terms, by parity

    def finalize(j):
        s = j & bm
        pp, pd, pc, pk = bp[:, s], bf[:, s], bc[:, s], bk[:, s]
        lw = fin["lit_p"] < pp
        p_j = np.where(lw, fin["lit_p"], pp)
        d_j = np.where(lw, 1, pd)
        c_j = np.where(lw, fin["lit_c"], pc)
        k_j = np.where(lw, fin["lit_k"], pk)
        near = lw | (pd < 2)
        hs = (j - np.maximum(pd, 2)) & hm
        sp = np.where(near, fin["st1"], hst[lanes, hs])
        a = np.where(near[:, None], fin["q"], hrp[lanes, hs])
        is_rep = (k_j >= 0) & (k_j < 4)
        is_m = k_j == RK_MATCH
        st = np.where(k_j == RK_LIT, np.where(sp < 4, 0, np.where(sp < 10, sp - 3, sp - 6)),
                      np.where(k_j == RK_SHORTREP, np.where(sp < 7, 9, 11),
                               np.where(is_rep, np.where(sp < 7, 8, 11),
                                        np.where(sp < 7, 7, 10))))
        kk = np.clip(k_j, 0, 3)
        r = np.stack([
            np.where(is_rep, a[lanes, kk], np.where(is_m, c_j, a[:, 0])),
            np.where((is_rep & (kk >= 1)) | is_m, a[:, 0], a[:, 1]),
            np.where((is_rep & (kk >= 2)) | is_m, a[:, 1], a[:, 2]),
            np.where((is_rep & (kk >= 3)) | is_m, a[:, 2], a[:, 3])], axis=1)
        if j == 0:
            st, r = np.zeros_like(st), np.zeros_like(r)
        ps = j & (n_ps - 1)
        f_im1, f_ir1, sel_s = im1[lanes, ps, st], ir1[lanes, st], sel[lanes, :, st]
        rep_head = p_j + f_im1 + f_ir1
        rb = rep_head[:, None] + sel_s
        rb[:, 0] += r0l1[lanes, ps, st]
        nv[j & 1] = (p_j + f_im1 + ir0[lanes, st], rb, r)
        out_from[:, j], out_choice[:, j] = j - d_j, c_j
        hst[:, j & hm], hrp[:, j & hm] = st, r
        if j > 0:
            sr = (j - 1) & bm
            bp[:, sr], bf[:, sr], bc[:, sr], bk[:, sr] = INF, 0, -1, RK_LIT
        # the literal / shortRep edge -> node j+1, held until node j+1
        live = j < lens
        row = packed[:, min(j, N - 1)]
        cand_l = p_j + im0[lanes, ps, st] + np.where(st >= 7, row[:, 6 * M + 1],
                                                     row[:, 6 * M])
        sr_ok = (row[:, 6 * M + 4] > 0) & (r[:, 0] == row[:, 6 * M + 2])
        cand_sr = np.where(sr_ok, rep_head + sel_s[:, 0] + r0l0[lanes, ps, st], INF)
        use_sr = cand_sr < cand_l
        fin.update(st1=st, q=r,
                   lit_p=np.where(live, np.where(use_sr, cand_sr, cand_l), INF),
                   lit_c=np.where(live & use_sr, r[:, 0], -1),
                   lit_k=np.where(live & use_sr, RK_SHORTREP, RK_LIT))

    def relax(i):
        row = packed[:, i]
        mbase, rb, r = nv[i & 1]
        sl = (i + lvec) & bm
        cur = bp[:, sl].copy()
        rem = lens - i
        live = i < lens
        ps = i & (n_ps - 1)
        lt_m, lt_r = ltm[:, ps], ltr[:, ps]
        best, bdist, bkind = full((L, W), INF), full((L, W), 0), full((L, W), RK_MATCH)
        for m in range(M):
            ldc = np.minimum(row[:, m], rem)
            dd = row[:, M + m]
            ok = ((ldc >= 2) & (dd >= 0) & live)[:, None] & (lvec <= ldc[:, None])
            eq = dd[:, None] == r
            rix = np.where(eq[:, 0], 0, np.where(eq[:, 1], 1, np.where(eq[:, 2], 2, 3)))
            is_r = eq.any(axis=1)
            cost = np.where(is_r[:, None], rb[lanes, rix][:, None] + lt_r,
                            mbase[:, None] + row[:, 2 * M + 4 * m + lps] + lt_m)
            better = ok & (cost < best)
            best = np.where(better, cost, best)
            bdist = np.where(better, dd[:, None], bdist)
            bkind = np.where(better, np.where(is_r, rix, RK_MATCH)[:, None], bkind)
        r0p = row[:, 6 * M + 2]
        rlc = np.minimum(row[:, 6 * M + 3], rem)
        ok0 = ((r[:, 0] == r0p) & (rlc >= 2) & live)[:, None] & (lvec <= rlc[:, None])
        better = ok0 & (rb[:, :1] + lt_r < best)
        best = np.where(better, rb[:, :1] + lt_r, best)
        bdist = np.where(better, r0p[:, None], bdist)
        bkind = np.where(better, 0, bkind)
        imp = best < cur
        bp[:, sl] = np.where(imp, best, bp[:, sl])
        bf[:, sl] = np.where(imp, lvec, bf[:, sl])
        bc[:, sl] = np.where(imp, np.maximum(bdist, 0), bc[:, sl])
        bk[:, sl] = np.where(imp, bkind, bk[:, sl])

    finalize(0)
    for i in range(N):
        # the two halves of a step touch different slots (i+1 is read,
        # i retired; i+2..i+fb relaxed), so their order here is free
        finalize(i + 1)
        relax(i)
    return out_from, out_choice


def test_k3_step_order_equals_dp_parse_band_on_the_bench_config():
    data = generate_bench_data(BENCH_SIZE)
    blocks = [data[i:i + BENCH_BLOCK]
              for i in range(0, BENCH_SIZE, BENCH_BLOCK)][:BENCH_LANES]
    d, lens = pad_rows(blocks, "cpu")
    ld, dd, tokens, suffix = _lists_and_seed(d, lens, BENCH_DICT, BENCH_FB)
    packed, tables = _round_inputs(d, lens, tokens, ld, dd, suffix, 3, 0, 2,
                                   BENCH_FB)
    lens = lens.to(torch.int32)
    got = k3_step_order(packed.numpy().astype(np.int64),
                        tables.numpy().astype(np.int64),
                        lens.numpy().astype(np.int64), BENCH_FB, 2)
    want = dp_parse_band(packed, tables, lens, BENCH_FB, 2)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())


@pytest.mark.parametrize("fb,pb", [(5, 0), (8, 4), (40, 1), (273, 2)])
def test_k3_step_order_equals_dp_parse_band_at_other_widths(fb, pb):
    rng = np.random.default_rng(fb)
    bench = generate_bench_data(3 * 700)
    blocks = [bench[:700], bench[700:1000],
              bench[1400:1700] + rng.integers(0, 256, 200, dtype=np.uint8).tobytes()]
    d, lens = pad_rows(blocks, "cpu")
    ld, dd, tokens, suffix = _lists_and_seed(d, lens, d.shape[1], fb)
    packed, tables = _round_inputs(d, lens, tokens, ld, dd, suffix, 3, 0, pb, fb)
    lens = lens.to(torch.int32)
    got = k3_step_order(packed.numpy().astype(np.int64),
                        tables.numpy().astype(np.int64),
                        lens.numpy().astype(np.int64), fb, pb)
    want = dp_parse_band(packed, tables, lens, fb, pb)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
