#!/usr/bin/env python3
"""Drive lzma_tpu_torch's device block codec on one NVIDIA GPU and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is caught and skipped):
  1. the card's name and power limit (nvidia-smi); no CUDA device fails
  2. build the CUDA kernels from lzma_tpu_torch/csrc (nvcc), timed
  3. each kernel against its plain PyTorch version on the card, 8 lanes
     x 2 KB: range encoder bytes and lengths, decoder out/ok/out_pos on
     the encoder's streams and on one preset-primed batch
  4. the card against the JAX reference: the 8-lane container of
     generate_bench_data(64 KiB) must hash to PIN_SHA256 (pinned from
     lzma_tpu.ops.api.encode_blocks by tests/test_torch_api.py)
  5. the main path at 8 MiB (text corpus + bench data, LzmaParams()
     defaults, 256 KiB blocks = 32 lanes): encode_blocks, decode_blocks,
     round trip, every block decoded by the stdlib lzma module, both
     kernels' launch counts > 0; MB/s, ratio, peak device memory
  6. each kernel against its plain version at the main path's shapes
     (its own 32 x 256 KiB tensors, the work cut so that the per-bit
     plain versions finish: K2 codes the first CMP_BITS pairs of each
     lane, K1 decodes each lane up to the first token boundary at or past
     CMP_OUT bytes), both timed on those same inputs
  7. no module of jax, and none of lzma_tpu's JAX modules, was loaded
The last two lines are the kernels' JSON record and the result JSON.
"""

from __future__ import annotations

import hashlib
import json
import lzma
import subprocess
import sys
import time

#: SHA-256 of lzma_tpu.ops.api.encode_blocks(generate_bench_data(1 << 16),
#: LzmaParams(dict_size=1 << 16), block_size=1 << 13, parse="lazy")
PIN_SHA256 = "22e991f02066cf506d4759d0e7e574af4996ebccc0e4c0685c0be76e657db644"
PIN_INPUT = dict(size=1 << 16, dict_size=1 << 16, block_size=1 << 13)

MAIN_BLOCK = 1 << 18
CMP_LANES, CMP_BYTES = 8, 2048       # kernel vs plain comparison shape
CMP_BITS = 1 << 15                   # K2's work per lane at the main shapes
CMP_OUT = 4096                       # K1's work per lane at the main shapes


def log(msg):
    print(msg, flush=True)


def pin_input():
    from lzma_tpu.bench.datagen import generate_bench_data
    from lzma_tpu.format.properties import LzmaParams

    return (generate_bench_data(PIN_INPUT["size"]),
            LzmaParams(dict_size=PIN_INPUT["dict_size"]), PIN_INPUT["block_size"])


def lane_blocks(n_lanes, size, seed):
    """Mixed lanes: bench data, text, and a short incompressible tail."""
    import numpy as np
    from lzma_tpu.bench.corpus import text_part
    from lzma_tpu.bench.datagen import generate_bench_data

    rng = np.random.default_rng(seed)
    bench = generate_bench_data(n_lanes * size)
    text = text_part()
    out = []
    for i in range(n_lanes):
        if i % 4 == 3:
            b = text[i * size:(i + 1) * size]
        else:
            b = bench[i * size:(i + 1) * size]
        if i % 4 == 1:
            b = b[: size // 2] + rng.integers(0, 256, size // 8, dtype=np.uint8).tobytes()
        out.append(b)
    return out


def lowered(blocks, params, device):
    """Phases A-C of the encoder on `device`: (ctx, bits, totals, max_out)."""
    from lzma_tpu_torch.ops.device_decoder import pad_rows
    from lzma_tpu_torch.ops.device_encoder import DEFAULT_NUM_CANDIDATES, _lower_lanes

    data, lens = pad_rows(blocks, device)
    return _lower_lanes(data, lens, min(params.dict_size, data.shape[1]),
                        params.lc, params.lp, params.pb, params.fast_bytes,
                        DEFAULT_NUM_CANDIDATES)


def event_ms(fn, reps):
    """Mean device time of fn over `reps` launches (CUDA events, warm)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def check_serializer(ctx, bits, totals, arena, max_out):
    """K2 against serialize on the same card tensors (tolerance zero).
    Returns (max |diff|, kernel out, kernel lens, plain version's ms)."""
    import torch
    from lzma_tpu_torch.ops.cuda_serializer import serialize_cuda
    from lzma_tpu_torch.ops.device_encoder import serialize

    k_out, k_lens, consumed = serialize_cuda(ctx, bits, totals, arena, max_out)
    box = {}
    plain_ms = wall_ms(lambda: box.update(
        p=serialize(ctx, bits, totals, arena, max_out)))
    p_out, p_lens = box["p"]
    if not torch.equal(consumed, totals):
        raise AssertionError("range coder kernel left bits unconsumed")
    if not torch.equal(k_lens, p_lens):
        raise AssertionError(f"range coder lens differ: {k_lens} vs {p_lens}")
    err = int((k_out.int() - p_out.int()).abs().max())
    if err:
        raise AssertionError("range coder bytes differ from the plain version")
    return err, k_out, k_lens, plain_ms


def check_decoder(comp, comp_lens, sizes, params, max_out, preset=None):
    """K1 against _decode_fsm on the same card tensors (tolerance zero);
    every lane must decode.  Returns (max |diff|, kernel out, plain
    version's ms)."""
    import torch
    from lzma_tpu_torch.ops.cuda_ring import decode_cuda
    from lzma_tpu_torch.ops.device_decoder import _decode_fsm

    args = (comp, comp_lens, sizes, params.dict_size, params.lc, params.lp,
            params.pb, max_out)
    k_out, k_ok, k_pos = decode_cuda(*args, preset=preset)
    box = {}
    plain_ms = wall_ms(lambda: box.update(p=_decode_fsm(*args, preset=preset)))
    p_out, p_ok, p_pos = box["p"]
    if not bool(k_ok.all()) or not torch.equal(k_ok, p_ok):
        raise AssertionError(f"decoder ok flags: kernel {k_ok}, plain {p_ok}")
    if not torch.equal(k_pos, p_pos):
        raise AssertionError(f"decoder out_pos: kernel {k_pos}, plain {p_pos}")
    err = int((k_out.int() - p_out.int()).abs().max())
    if err:
        raise AssertionError("decoder bytes differ from the plain version")
    return err, k_out, plain_ms


def main():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} x{torch.cuda.device_count()}  torch {torch.__version__}"
        f"  cuda {torch.version.cuda}")

    from lzma_tpu.core.layout import ProbLayout
    from lzma_tpu.format.properties import LzmaParams
    from lzma_tpu.parallel import blocks as blk
    from lzma_tpu_torch.ops import api, cuda_ring, cuda_serializer
    from lzma_tpu_torch.ops.device_decoder import pad_rows
    from lzma_tpu_torch.runtime import build

    # ---- 2. build ----
    t = time.perf_counter()
    lib = build.build(verbose=True)
    build.load()
    log(f"[build] {lib} in {time.perf_counter() - t:.1f} s")

    # ---- 3. kernels vs plain versions, 8 lanes x 2 KB ----
    params = LzmaParams()
    arena = ProbLayout(params.lc, params.lp, params.pb, pos_bits=params.pb).size
    blocks = lane_blocks(CMP_LANES, CMP_BYTES, seed=1)
    ctx, bits, totals, max_out = lowered(blocks, params, dev)
    k2_err, k_out, k_lens, _ = check_serializer(ctx, bits, totals, arena,
                                                int(max_out))
    log(f"[K2 vs plain] {CMP_LANES}x{CMP_BYTES}: bytes and lens equal")
    lens_h = k_lens.cpu().tolist()
    streams = [k_out[i, :lens_h[i]].cpu().numpy().tobytes() for i in range(len(blocks))]
    comp, comp_lens = pad_rows(streams, dev)
    sizes = torch.tensor([len(b) for b in blocks], dtype=torch.int32, device=dev)
    mo = 1 << (max(len(b) for b in blocks) - 1).bit_length()
    k1_err, d_out, _ = check_decoder(comp, comp_lens, sizes, params, mo)
    for i, b in enumerate(blocks):
        if d_out[i, :len(b)].cpu().numpy().tobytes() != b:
            raise AssertionError(f"lane {i} does not round-trip")
    log(f"[K1 vs plain] {CMP_LANES}x{CMP_BYTES}: out/ok/out_pos equal, round trip")

    from lzma_tpu.codec.encoder import encode_stream

    preset = blocks[3][:1024]
    p_blocks = [b[:1024] for b in blocks[:4]]
    p_streams = [encode_stream(b, params, optimal=False, preset=preset)
                 for b in p_blocks]
    comp, comp_lens = pad_rows(p_streams, dev)
    plen = len(preset)
    sizes = torch.tensor([len(b) + plen for b in p_blocks], dtype=torch.int32,
                         device=dev)
    preset_t = torch.frombuffer(bytearray(preset), dtype=torch.uint8).to(dev)
    err, d_out, _ = check_decoder(comp, comp_lens, sizes, params, 4096,
                                  preset=preset_t)
    k1_err = max(k1_err, err)
    for i, b in enumerate(p_blocks):
        if d_out[i, plen:plen + len(b)].cpu().numpy().tobytes() != b:
            raise AssertionError(f"preset lane {i} does not round-trip")
    log("[K1 vs plain] preset-primed batch: equal, round trip")

    # ---- 4. the pinned container (card vs the JAX reference) ----
    data, pparams, pblock = pin_input()
    blob = api.encode_blocks(data, pparams, block_size=pblock, device=dev)
    digest = hashlib.sha256(blob).hexdigest()
    if digest != PIN_SHA256:
        raise AssertionError(f"pinned container hash {digest} != {PIN_SHA256}")
    if api.decode_blocks(blob, device=dev) != data:
        raise AssertionError("pinned container does not round-trip")
    log(f"[pin] {len(data) // pblock} lanes: sha256 {digest} matches the JAX "
        "reference; round trip ok")

    # ---- 5. the main path at 8 MiB ----
    from lzma_tpu.bench.corpus import text_part
    from lzma_tpu.bench.datagen import generate_bench_data

    data = text_part() + generate_bench_data(5 << 20)
    params = LzmaParams()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_serializer.LAUNCHES = 0
    cuda_ring.LAUNCHES = 0
    t = time.perf_counter()
    blob = api.encode_blocks(data, params, block_size=MAIN_BLOCK, device=dev)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t
    t = time.perf_counter()
    back = api.decode_blocks(blob, device=dev)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t
    launches = {"rc_serialize": cuda_serializer.LAUNCHES,
                "ring_decode": cuda_ring.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    if back != data:
        raise AssertionError("8 MiB round trip differs")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel did not run on the main path: {launches}")
    frame = blk.parse_container(blob)
    offsets, bsizes = frame.stream_extents(len(blob))
    for i in range(len(bsizes)):
        alone = (params.encode_props() + bsizes[i].to_bytes(8, "little")
                 + blob[offsets[i]:offsets[i + 1]])
        part = data[i * MAIN_BLOCK:i * MAIN_BLOCK + bsizes[i]]
        if lzma.decompress(alone, format=lzma.FORMAT_ALONE) != part:
            raise AssertionError(f"stdlib lzma disagrees on block {i}")
    mb = len(data) / 1e6
    log(f"[main] {len(data)} B in {len(bsizes)} lanes of {MAIN_BLOCK} B on "
        f"{card}: encode {t_enc:.3f} s = {mb / t_enc:.3f} MB/s, decode "
        f"{t_dec:.3f} s = {mb / t_dec:.3f} MB/s, round trip "
        f"{mb / (t_enc + t_dec):.3f} MB/s, ratio {len(blob) / len(data):.4f}, "
        f"peak device memory {peak / 2**20:.1f} MiB, launches {launches}; "
        "every block decodes with the stdlib lzma module")

    # encode stage breakdown at the main path's shape (one more pass)
    from lzma_tpu_torch.ops.device_encoder import (DEFAULT_NUM_CANDIDATES,
                                                   classify_tokens, lower_tokens)
    from lzma_tpu_torch.ops.device_matcher import tokenize

    mblocks = blk.split_blocks(data, MAIN_BLOCK)
    d_t, l_t = pad_rows(mblocks, dev)
    stage = {}
    box = {}
    stage["tokenize"] = wall_ms(lambda: box.update(
        tok=tokenize(d_t, l_t, min(params.dict_size, MAIN_BLOCK),
                     params.fast_bytes, DEFAULT_NUM_CANDIDATES)))
    tp, tl, td, tv, ntok = box["tok"]
    stage["classify"] = wall_ms(lambda: box.update(
        meta=classify_tokens(d_t, tp, tl, td, tv)))
    stage["lower"] = wall_ms(lambda: box.update(low=lower_tokens(
        d_t, box["meta"], tp, tl, td, tv, params.lc, params.lp, params.pb,
        10 * MAIN_BLOCK + 128)))
    ctx, bits, totals = box["low"]
    arena = ProbLayout(params.lc, params.lp, params.pb, pos_bits=params.pb).size
    mo_main = MAIN_BLOCK + MAIN_BLOCK // 4 + 128
    stage["rc_serialize kernel"] = event_ms(
        lambda: cuda_serializer.serialize_cuda(ctx, bits, totals, arena, mo_main), 3)
    streams = [blob[offsets[i]:offsets[i + 1]] for i in range(len(bsizes))]
    comp, comp_lens = pad_rows(streams, dev)
    msizes = torch.tensor(bsizes, dtype=torch.int32, device=dev)
    stage["ring_decode kernel"] = event_ms(
        lambda: cuda_ring.decode_cuda(comp, comp_lens, msizes, params.dict_size,
                                      params.lc, params.lp, params.pb,
                                      MAIN_BLOCK), 3)
    log(f"[stages] {len(mblocks)}x{MAIN_BLOCK}, max tokens/lane "
        f"{int(ntok.max())}, max coded bits/lane {int(totals.max())}: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in stage.items()))

    # ---- 6. kernels vs plain versions at the main path's shapes ----
    # K2: the main path's own (ctx, bit) tensors, each lane cut to its
    # first CMP_BITS pairs
    cut_totals = torch.clamp(totals, max=CMP_BITS)
    k2_ms = event_ms(lambda: cuda_serializer.serialize_cuda(
        ctx, bits, cut_totals, arena, mo_main), 20)
    err, _, _, k2_plain = check_serializer(ctx, bits, cut_totals, arena, mo_main)
    k2_err = max(k2_err, err)
    # K1: the main container's streams, each lane decoded up to the end of
    # its first token that reaches CMP_OUT bytes, a size the stream stops
    # at cleanly
    ends = tp + tl
    past = tv & (ends >= CMP_OUT)
    first = past.int().argmax(dim=1, keepdim=True)
    cut_sizes = torch.where(past.any(dim=1), ends.gather(1, first)[:, 0],
                            l_t.long()).to(torch.int32)
    dargs = (comp, comp_lens, cut_sizes, params.dict_size, params.lc,
             params.lp, params.pb, MAIN_BLOCK)
    k1_ms = event_ms(lambda: cuda_ring.decode_cuda(*dargs), 20)
    err, d_out, k1_plain = check_decoder(*dargs[:3], params, MAIN_BLOCK)
    k1_err = max(k1_err, err)
    cuts = cut_sizes.tolist()
    for i, n in enumerate(cuts):
        if d_out[i, :n].cpu().numpy().tobytes() != mblocks[i][:n]:
            raise AssertionError(f"lane {i} decodes wrong up to byte {n}")
    log(f"[times] main path's shapes ({len(mblocks)} lanes x {MAIN_BLOCK} B) on "
        f"{card}: rc_serialize kernel {k2_ms:.3f} ms vs plain {k2_plain:.1f} ms "
        f"({CMP_BITS} pairs a lane); ring_decode kernel {k1_ms:.3f} ms vs plain "
        f"{k1_plain:.1f} ms ({min(cuts)}..{max(cuts)} B a lane); equal")

    # ---- 7. nothing of JAX was loaded ----
    jax_mods = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib")
                      or m.startswith("lzma_tpu.ops"))
    if jax_mods:
        raise AssertionError(f"JAX modules loaded: {jax_mods[:8]}")
    log("[imports] no jax module and no lzma_tpu.ops module loaded")

    kernels = [
        {"name": "rc_serialize", "route": "cuda",
         "source": "lzma_tpu_torch/csrc/rc_serializer.cu",
         "replaces": "lzma_tpu/ops/pallas_serializer.py:58",
         "launches": launches["rc_serialize"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain},
        {"name": "ring_decode", "route": "cuda",
         "source": "lzma_tpu_torch/csrc/ring_decoder.cu",
         "replaces": "lzma_tpu/ops/pallas_ring.py:89",
         "launches": launches["ring_decode"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
