"""What the redesigned K1-K4 decide on the host, K3's step order and the
decoders' two-speed body.

These run on the CPU.  The CUDA kernels themselves are held against their
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py); here:

- K2's arena placement (``cuda_serializer.arena_placement``) over the
  lc/lp grid against a given shared-memory limit, and its footprint;
- K3's block plan (``cuda_parser.dp_parse_plan``): its shared memory at
  fb 5..273 x pb 0..4 fits the H100's opt-in 232,448 B a block, its
  rings are powers of two wide enough for the step; K4's
  (``dp_parse2_plan``) likewise at M 1..16 pairs a row, and the
  constants the wrappers share with K3, K4 and K6's sources;
- a numpy restatement of K3's new step order (step i finalizes node i+1
  from slot i+1 and the literal/shortRep edge held from node i, while
  node i relaxes from the terms handed over a step earlier; power-of-two
  rings indexed by masks, slot i retired at step i), equal to
  ``dp_parse_band``'s planes on the bench config's first-round inputs
  (its first 4 lanes);
- K1's arena placement (``cuda_ring.arena_placement``) over the lc/lp
  grid, as K2's;
- a scalar restatement of the decode body of K1 and K5
  (``csrc/lzma_decode.cuh``): the fast symbol while the input and output
  margins hold, the checked symbol after, and the per-symbol checks the
  fast one keeps, equal to ``_decode_fsm`` on valid lanes, truncations
  at each of a stream's last 64 bytes, corrupt bytes, bounds and rows at
  the output margin, EOS lanes and caps, a preset and lc8 lp4 (2 KiB
  lanes at most, 8 a call).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from lzma_tpu.codec.encoder import encode_stream
# the scalar encoder takes lzma_tpu's parameter class
from lzma_tpu.format.properties import LzmaParams
from lzma_tpu_torch.bench.datagen import generate_bench_data
from lzma_tpu_torch.core.layout import ProbLayout
from lzma_tpu_torch.ops import cuda_ring, cuda_serializer
from lzma_tpu_torch.ops.cuda_ring import CTRL_BYTES, IN_TILE
from lzma_tpu_torch.ops.cuda_parser import (MAX_PAIRS, NODE_VALS, SPLIT_FB,
                                            TILE_ROWS, dp_parse2_plan,
                                            dp_parse_plan)
from lzma_tpu_torch.ops.cuda_serializer import (PLACEMENTS, TILE,
                                                arena_placement, smem_bytes)
from lzma_tpu_torch.ops.device_decoder import _decode_fsm, pad_rows
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


@pytest.mark.parametrize("pb", range(5))
def test_dp_parse2_plan_fits_the_card(pb):
    for M in range(1, MAX_PAIRS + 1):
        C = 6 * M + 5
        for fb in range(5, 274):
            threads, B, smem = dp_parse2_plan(fb, pb, C)
            assert smem <= H100_SMEM
            assert smem == 4 * (table_size(pb, fb) + 8 * B + 2 * TILE_ROWS * C)
            # the relax warps as K3's, then the literal/shortRep warp
            assert threads == dp_parse_plan(fb, pb, C)[0] <= 1024
            relax, split = threads - 32, 4 if fb <= SPLIT_FB and M <= 4 else 1
            assert relax % 32 == 0 and relax - 32 < split * (fb - 1) <= relax
            assert B & (B - 1) == 0 and fb + 1 <= B < 2 * (fb + 1)


def _source_constant(name, file):
    src = (pathlib.Path(cuda_ring.__file__).parent.parent / "csrc"
           / file).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_scan_constants_are_the_kernels():
    assert 1 << _source_constant("kTileLog", "dp_rows.cuh") == TILE_ROWS
    for file in ("dp_parse.cu", "dp_parse2.cu"):
        assert _source_constant("kMaxPairs", file) == MAX_PAIRS
        assert _source_constant("kSplitFb", file) == SPLIT_FB


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


# ------------------------------------------------- K1 and K5: the decode body
# K1's arena placement (cuda_ring.arena_placement): the arena in shared
# memory when it fits beside the control words and the two input tiles
@pytest.mark.parametrize("lp", range(5))
@pytest.mark.parametrize("lc", range(9))
def test_ring_arena_placement_over_the_lc_lp_grid(lc, lp):
    arena = ProbLayout(lc, lp, 2, pos_bits=2).size
    ring = CTRL_BYTES + 2 * IN_TILE
    shared = ring + (2 * arena + 15) // 16 * 16
    assert cuda_ring.smem_bytes(arena) == shared
    want = "shared" if shared <= H100_SMEM else "device"
    assert cuda_ring.arena_placement(arena, H100_SMEM) == want
    assert cuda_ring.arena_placement(arena, shared) == "shared"
    assert cuda_ring.arena_placement(arena, shared - 1) == "device"
    assert (want == "shared") == (lc + lp <= 7)


def _header_constant(name):
    src = (pathlib.Path(cuda_ring.__file__).parent.parent / "csrc"
           / "lzma_decode.cuh").read_text()
    expr = re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
    return eval(expr, {"kSymbolMaxBits": SYMBOL_MAX_BITS, "kInTileLog": 12})


# A scalar restatement of csrc/lzma_decode.cuh's two-speed body: the fast
# symbol (no per-bit or per-byte check: it asserts instead that the
# margins make each check needless; branch-free bits; both children of a
# tree level read before the level's bit; the matched literal's offs/bit
# walk; a copy's batches of 8 loads before their 8 stores) while in_pos <
# lim - IN_MARGIN + 1 and out_pos < min(bound, max_out) - MATCH_MAX + 1,
# the checked symbol (the first version's, every check on) after.  The
# input ring is a residency matter and is not restated.
TOP = 1 << 24
MATCH_MAX = 273
SYMBOL_MAX_BITS = 1 + 1 + 2 + 8 + 6 + 26 + 4
IN_MARGIN = SYMBOL_MAX_BITS
GO_ON, END, FAIL = 0, 1, 2


class _Fail(Exception):
    pass


class TwoSpeed:
    def __init__(self, row, in_len, size, dict_size, lc, lp, pb, max_out,
                 preset=b""):
        self.row, self.in_len = bytes(row), in_len
        self.lim = min(in_len, len(row))
        self.last = row[-1] if len(row) else 0
        self.L = ProbLayout(lc, lp, pb, pos_bits=pb)
        self.p = [1024] * self.L.size
        self.P, self.max_out = len(preset), max_out
        self.o = bytearray(max_out)
        self.o[:self.P] = preset
        self.eos = size < 0
        self.bound = -size if self.eos else size
        self.dict_check = max(dict_size, 1)
        self.lc, self.pb_mask, self.lp_mask = lc, (1 << pb) - 1, (1 << lp) - 1
        self.range, self.code, self.in_pos, self.overrun = 0xFFFFFFFF, 0, 5, 0
        self.out_pos, self.state = self.P, 0
        self.rep = [0, 0, 0, 0]
        self.prev = preset[-1] if preset else 0
        self.symbols = {"fast": 0, "checked": 0}
        for i in range(5):
            self.code = (self.code << 8) | (self.in_byte(i) if i < in_len else 0)

    def in_byte(self, i):
        return self.row[i] if i < self.lim else self.last

    # ---- the fast bits: no check
    def fbit(self, pr, i):
        assert self.in_pos < self.lim             # the input margin holds
        nb = self.row[self.in_pos]                # read every bit
        bnd = (self.range >> 11) * pr
        one = self.code >= bnd
        self.range = self.range - bnd if one else bnd
        self.code = self.code - bnd if one else self.code
        self.p[i] = pr - (pr >> 5) if one else pr + ((2048 - pr) >> 5)
        need = self.range < TOP
        self.range = (self.range << 8) & 0xFFFFFFFF if need else self.range
        self.code = ((self.code << 8) | nb) & 0xFFFFFFFF if need else self.code
        self.in_pos += need
        return int(one)

    def fdirect(self):
        assert self.in_pos < self.lim
        nb = self.row[self.in_pos]
        self.range >>= 1
        t = (self.code - self.range) & 0xFFFFFFFF
        b = 1 - (t >> 31)
        self.code = t if b else self.code
        need = self.range < TOP
        self.range = (self.range << 8) & 0xFFFFFFFF if need else self.range
        self.code = ((self.code << 8) | nb) & 0xFFFFFFFF if need else self.code
        self.in_pos += need
        return b

    def ftree(self, t, depth, rev=False):
        m, pr, val = 1, self.p[t + 1], 0
        for k in range(depth):
            p0, p1 = self.p[t + 2 * m], self.p[t + 2 * m + 1]   # loaded ahead
            b = self.fbit(pr, t + m)
            m = 2 * m + b
            val |= b << k
            pr = p1 if b else p0
        return val if rev else m - (1 << depth)

    def fmatched(self, lit, mb):
        offs, mm = 0x100, mb << 1
        bitv, offs = offs, offs & mm
        sym, idx = 1, offs + bitv + 1
        pr = self.p[lit + idx]
        for k in range(8):
            mn = mm << 1
            o0, o1 = offs ^ bitv, offs
            i0, i1 = (o0 & mn) + o0 + 2 * sym, (o1 & mn) + o1 + 2 * sym + 1
            if k < 7:
                p0, p1 = self.p[lit + i0], self.p[lit + i1]   # loaded ahead
            b = self.fbit(pr, lit + idx)
            sym = 2 * sym + b
            on = o1 if b else o0
            bitv, offs, mm = on, on & mn, mn
            idx = i1 if b else i0
            if k < 7:
                pr = p1 if b else p0
        return sym

    def fast_symbol(self):
        L, s = self.L, self.state
        coded = self.out_pos - self.P
        ps = coded & self.pb_mask
        im = L.is_match + (s << L.pos_bits) + ps
        lit = L.literal + (((coded & self.lp_mask) << self.lc)
                           + (self.prev >> (8 - self.lc))) * 0x300
        matched = s >= 7
        mb = self.o[self.out_pos - self.rep[0] - 1] if matched else 0
        if self.fbit(self.p[im], im) == 0:
            if not matched:                           # a plain 8-level tree
                sym = self.ftree(lit, 8) + 256
            else:                                     # the offs/bit walk
                sym = self.fmatched(lit, mb)
            self.prev = sym & 0xFF
            self.o[self.out_pos] = self.prev      # the output margin holds
            self.out_pos += 1
            self.state = 0 if s < 4 else (s - 3 if s < 10 else s - 6)
            return GO_ON
        length, rep = 0, self.rep
        if self.fbit(self.p[L.is_rep + s], L.is_rep + s) == 0:
            rep[1:] = rep[:3]
            len_base = L.len_coder
        else:
            if self.fbit(self.p[L.is_rep_g0 + s], L.is_rep_g0 + s) == 0:
                r0l = L.is_rep0_long + (s << L.pos_bits) + ps
                if self.fbit(self.p[r0l], r0l) == 0:
                    self.state, length = (9 if s < 7 else 11), 1
            elif self.fbit(self.p[L.is_rep_g1 + s], L.is_rep_g1 + s) == 0:
                rep[0], rep[1] = rep[1], rep[0]
            else:
                k = 2 + self.fbit(self.p[L.is_rep_g2 + s], L.is_rep_g2 + s)
                rep[:k + 1] = [rep[k]] + rep[:k]
            len_base = L.rep_len_coder
        if length == 0:
            ch, ch2 = len_base + L.len_choice, len_base + L.len_choice2
            if self.fbit(self.p[ch], ch) == 0:
                length = self.ftree(len_base + L.len_low + (ps << 3), 3) + 2
            elif self.fbit(self.p[ch2], ch2) == 0:
                length = self.ftree(len_base + L.len_mid + (ps << 3), 3) + 10
            else:
                length = self.ftree(len_base + L.len_high, 8) + 18
            if len_base == L.len_coder:
                self.state = 7 if s < 7 else 10
                slot = self.ftree(L.pos_slot + min(length - 2, 3) * 64, 6)
                if slot < 4:
                    rep[0] = slot
                else:
                    nd = (slot >> 1) - 1
                    base = (2 | (slot & 1)) << nd
                    if slot < 14:
                        rep[0] = base + self.ftree(L.spec_pos + base - slot - 1,
                                                   nd, rev=True)
                    else:
                        acc = 0
                        for _ in range(nd - 4):
                            acc = (acc << 1) | self.fdirect()
                        dist = base + (acc << 4) + self.ftree(L.align, 4, rev=True)
                        dist = ((dist + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
                        if dist == -1 and self.eos:      # the end marker
                            return END
                        if dist < 0:
                            return FAIL
                        rep[0] = dist
            else:
                self.state = 8 if s < 7 else 11
        # the distance check, once a symbol
        if rep[0] >= self.out_pos or rep[0] >= self.dict_check:
            return FAIL
        d = rep[0] + 1
        src, j = self.out_pos - d, 0
        assert self.out_pos + length <= min(self.bound, self.max_out)
        for k in range(0, length, 8):        # every source byte < out_pos
            batch = []
            for _ in range(min(8, length - k)):  # a batch's loads, then stores
                batch.append(self.o[src + j])
                j = 0 if j + 1 == d else j + 1
            for u, v in enumerate(batch):
                self.o[self.out_pos + k + u] = v
            self.prev = batch[-1]
        self.out_pos += length
        return GO_ON

    # ---- the checked body: every bit checks the overrun, every window
    # index is clamped, every copied byte the bound
    def cbit(self, i):
        pr = self.p[i]
        bnd = (self.range >> 11) * pr
        if self.code < bnd:
            self.range, b = bnd, 0
            self.p[i] = pr + ((2048 - pr) >> 5)
        else:
            self.range, self.code, b = self.range - bnd, self.code - bnd, 1
            self.p[i] = pr - (pr >> 5)
        self.cnorm()
        return b

    def cnorm(self):
        if self.range < TOP:
            byte = 0
            if self.in_pos < self.in_len:
                byte = self.in_byte(self.in_pos)
            else:
                self.overrun += 1
            self.in_pos += 1
            self.range = (self.range << 8) & 0xFFFFFFFF
            self.code = ((self.code << 8) | byte) & 0xFFFFFFFF

    def cdirect(self):
        rd = self.range >> 1
        b = 1 - (((self.code - rd) & 0xFFFFFFFF) >> 31)
        if b:
            self.code -= rd
        self.range = rd
        self.cnorm()
        return b

    def bit(self, i):
        b = self.cbit(i)
        if self.overrun > 40:
            raise _Fail
        return b

    def back(self, dist):
        return self.o[min(max(self.out_pos - dist - 1, 0), self.max_out - 1)]

    def emit(self, byte):
        self.o[min(self.out_pos, self.max_out - 1)] = byte
        self.out_pos += 1

    def checked_symbol(self):
        try:
            return self._checked()
        except _Fail:
            return FAIL

    def _checked(self):
        L, s, rep = self.L, self.state, self.rep
        coded = self.out_pos - self.P
        ps = coded & self.pb_mask
        if self.bit(L.is_match + (s << L.pos_bits) + ps) == 0:
            lit = L.literal + (((coded & self.lp_mask) << self.lc)
                               + (self.prev >> (8 - self.lc))) * 0x300
            sym, walk = 1, []
            if s >= 7:
                mb = self.back(rep[0])
                while sym < 0x100:
                    mbit = (mb >> 7) & 1
                    mb <<= 1
                    b = self.lit_bit(lit + ((1 + mbit) << 8) + sym, sym)
                    sym = (sym << 1) | b
                    if mbit != b:
                        break
            while sym < 0x100:
                sym = (sym << 1) | self.lit_bit(lit + sym, sym)
            self.prev = sym & 0xFF
            self.emit(self.prev)
            if self.out_pos > self.bound:
                return FAIL
            self.state = 0 if s < 4 else (s - 3 if s < 10 else s - 6)
            return GO_ON
        length = 0
        if self.bit(L.is_rep + s) == 0:
            rep[1:] = rep[:3]
            len_base = L.len_coder
        else:
            if self.bit(L.is_rep_g0 + s) == 0:
                if self.bit(L.is_rep0_long + (s << L.pos_bits) + ps) == 0:
                    self.state, length = (9 if s < 7 else 11), 1
            elif self.bit(L.is_rep_g1 + s) == 0:
                rep[0], rep[1] = rep[1], rep[0]
            else:
                k = 2 + self.bit(L.is_rep_g2 + s)
                rep[:k + 1] = [rep[k]] + rep[:k]
            len_base = L.rep_len_coder
        if length == 0:
            if self.bit(len_base + L.len_choice) == 0:
                tree, top, base_len = len_base + L.len_low + (ps << 3), 8, 0
            elif self.bit(len_base + L.len_choice2) == 0:
                tree, top, base_len = len_base + L.len_mid + (ps << 3), 8, 8
            else:
                tree, top, base_len = len_base + L.len_high, 256, 16
            m = 1
            while m < top:
                m = (m << 1) | self.bit(tree + m)
            length = base_len + m - top + 2
            if len_base == L.len_coder:
                self.state = 7 if s < 7 else 10
                t, m = L.pos_slot + min(length - 2, 3) * 64, 1
                while m < 64:
                    m = (m << 1) | self.bit(t + m)
                slot = m - 64
                if slot < 4:
                    rep[0] = slot
                else:
                    nd = (slot >> 1) - 1
                    base, rev = (2 | (slot & 1)) << nd, 0
                    if slot < 14:
                        t, m = L.spec_pos + base - slot - 1, 1
                        for i in range(nd):
                            b = self.bit(t + m)
                            m, rev = (m << 1) | b, rev | (b << i)
                        rep[0] = base + rev
                    else:
                        acc = 0
                        for _ in range(nd - 4):
                            acc = (acc << 1) | self.cdirect()
                            if self.overrun > 40:
                                raise _Fail
                        m = 1
                        for i in range(4):
                            b = self.bit(L.align + m)
                            m, rev = (m << 1) | b, rev | (b << i)
                        dist = base + (acc << 4) + rev
                        dist = ((dist + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
                        if dist == -1 and self.eos:
                            return END
                        if dist < 0:
                            return FAIL
                        rep[0] = dist
            else:
                self.state = 8 if s < 7 else 11
        if rep[0] >= self.out_pos or rep[0] >= self.dict_check:
            return FAIL
        for _ in range(length):
            self.prev = self.back(rep[0])
            self.emit(self.prev)
            if self.out_pos > self.bound:
                return FAIL
        return GO_ON

    def lit_bit(self, i, sym):
        # the FSM completes a literal's last bit before it fails the lane
        b = self.cbit(i)
        if self.overrun > 40:
            if (sym << 1 | b) >= 0x100:
                self.emit(((sym << 1) | b) & 0xFF)
            raise _Fail
        return b

    def run(self):
        """Symbols to the lane's end: (out, ok, out_pos)."""
        out_fast = min(self.bound, self.max_out) - MATCH_MAX + 1
        in_fast = self.lim - IN_MARGIN + 1
        while True:
            fast = self.in_pos < in_fast and self.out_pos < out_fast
            self.symbols["fast" if fast else "checked"] += 1
            r = self.fast_symbol() if fast else self.checked_symbol()
            if r != GO_ON:
                return bytes(self.o), r == END, self.out_pos
            if not self.eos and self.out_pos >= self.bound:
                return bytes(self.o), True, self.out_pos


def _two_speed_vs_plain(streams, sizes, dict_size, lc, lp, pb, max_out,
                        preset=b"", width=None):
    """Every lane through TwoSpeed and _decode_fsm: equal (out, ok,
    out_pos).  Returns the TwoSpeed lanes."""
    assert len(streams) <= 8
    width = width or 1 << max(4, (max(len(s) for s in streams) - 1).bit_length())
    comp = np.zeros((len(streams), width), np.uint8)
    for i, s in enumerate(streams):
        comp[i, :len(s)] = np.frombuffer(s, np.uint8)
    lens = [len(s) for s in streams]
    pre = torch.frombuffer(bytearray(preset), dtype=torch.uint8) if preset else None
    want = _decode_fsm(torch.from_numpy(comp), torch.tensor(lens, dtype=torch.int32),
                       torch.tensor(sizes, dtype=torch.int32), dict_size, lc, lp,
                       pb, max_out, preset=pre)
    lanes = []
    for i in range(len(streams)):
        lane = TwoSpeed(comp[i], lens[i], sizes[i], dict_size, lc, lp, pb,
                        max_out, preset)
        out, ok, pos = lane.run()
        assert (out, ok, pos) == (want[0][i].numpy().tobytes(), bool(want[1][i]),
                                  int(want[2][i])), f"lane {i}"
        lanes.append(lane)
    return lanes


_PARAMS = LzmaParams(dict_size=1 << 12)


def _lane_blocks(n, size, seed):
    rng = np.random.default_rng(seed)
    bench = generate_bench_data(n * size)
    out = [bench[i * size:(i + 1) * size] for i in range(n)]
    out[-1] = out[-1][:size // 2] + rng.integers(0, 256, size // 2,
                                                 dtype=np.uint8).tobytes()
    return out


def test_two_speed_constants_are_the_kernels():
    assert _header_constant("kMatchMaxLen") == MATCH_MAX
    assert _header_constant("kSymbolMaxBits") == SYMBOL_MAX_BITS == 48
    assert _header_constant("kInMargin") == IN_MARGIN
    assert 1 << _header_constant("kInTileLog") == IN_TILE
    assert _header_constant("kCtrlBytes") == CTRL_BYTES


def test_two_speed_body_equals_plain_on_valid_lanes():
    blocks = _lane_blocks(8, 2048, 1)
    streams = [encode_stream(b, _PARAMS, mode="greedy") for b in blocks]
    lanes = _two_speed_vs_plain(streams, [2048] * 8, 1 << 12, 3, 0, 2, 2048)
    # each lane runs fast to its margins, then hands over to the checked body
    assert all(x.symbols["fast"] > 0 and x.symbols["checked"] > 0 for x in lanes)


def _trunc_stream():
    return encode_stream(generate_bench_data(1024), _PARAMS, mode="greedy")


# the stream cut at every one of its last 64 bytes, 8 lanes a call
@pytest.mark.parametrize("group", range(8))
def test_two_speed_body_equals_plain_on_truncations(group):
    good = _trunc_stream()
    cuts = [good[:len(good) - k] for k in range(1 + 8 * group, 9 + 8 * group)]
    lanes = _two_speed_vs_plain(cuts, [1024] * 8, 1 << 12, 3, 0, 2, 1024)
    assert all(x.symbols["fast"] > 0 for x in lanes)


def test_two_speed_body_equals_plain_on_corrupt_lanes():
    blocks = _lane_blocks(2, 2048, 3)
    good = encode_stream(blocks[0], _PARAMS, mode="greedy")
    streams = []
    for at in (len(good) // 4, len(good) // 2, 3 * len(good) // 4, 60):
        for flip in (0x5A, 0x01):
            bad = bytearray(good)
            bad[at] ^= flip
            streams.append(bytes(bad))
    _two_speed_vs_plain(streams, [2048] * 8, 1 << 12, 3, 0, 2, 2048)
    # a dictionary of 16 bytes fails the first far copy, in the fast body
    lanes = _two_speed_vs_plain([good], [2048], 16, 3, 0, 2, 2048)
    assert lanes[0].symbols["checked"] == 0


def test_two_speed_body_equals_plain_at_the_output_margin():
    # sizes (the bound) at n - 274, n - 273 and n - 272 for a lane of n =
    # 1024 bytes, then rows (max_out) beside the bound
    block = generate_bench_data(1024)
    s = encode_stream(block, _PARAMS, mode="greedy")
    n = len(block)
    sizes = [n - MATCH_MAX - 1, n - MATCH_MAX, n - MATCH_MAX + 1, n, n - 1,
             MATCH_MAX - 1, MATCH_MAX, 1]
    lanes = _two_speed_vs_plain([s] * 8, sizes, 1 << 12, 3, 0, 2, 1024)
    # a bound of 273 lets the first symbol run fast, one of 272 none
    assert [x.symbols["fast"] > 0 for x in lanes] == [True] * 5 + [False, True,
                                                                   False]
    for max_out in (n - 100, n + MATCH_MAX - 1, n + MATCH_MAX):
        _two_speed_vs_plain([s], [n], 1 << 12, 3, 0, 2, max_out)


def test_two_speed_body_equals_plain_on_eos_lanes_and_caps():
    params = LzmaParams(dict_size=1 << 12, write_eos=True)
    payload = generate_bench_data(2000)
    s = encode_stream(payload, params, mode="greedy")
    n = len(payload)
    lanes = _two_speed_vs_plain([s] * 4, [-n, -(n - 1), -4096, -(n // 2)],
                                1 << 12, 3, 0, 2, 4096)
    assert [x.symbols["fast"] > 0 for x in lanes] == [True] * 4


def test_two_speed_body_equals_plain_with_a_preset():
    bench = generate_bench_data(5 * 1024)
    preset = bench[:512]
    blocks = [bench[1024 * (i + 1):1024 * (i + 2)] for i in range(4)]
    streams = [encode_stream(b, _PARAMS, preset=preset, mode="greedy")
               for b in blocks]
    lanes = _two_speed_vs_plain(streams, [1024 + 512] * 4, 1 << 12, 3, 0, 2,
                                2048, preset=preset)
    assert all(x.symbols["fast"] > 0 for x in lanes)


def test_two_speed_body_equals_plain_at_lc8_lp4():
    params = LzmaParams(lc=8, lp=4, pb=2, dict_size=1 << 12)
    blocks = _lane_blocks(2, 1024, 8)
    streams = [encode_stream(b, params, mode="greedy") for b in blocks]
    _two_speed_vs_plain(streams, [1024] * 2, 1 << 12, 8, 4, 2, 1024)

