"""K1's decode body with one part knocked out at a time, on the H100:
the counterpart of ``tools/probe_ring_ablate.py`` (``ablate``).

The TPU probe ran the genuine ``decode_pallas_ring`` body with parts
stubbed, to find what a decode step costs.  Here the genuine body is
``csrc/lzma_decode.cuh`` ``decode_lane``, which K1 and K5 call;
``csrc/probe_ablate.cu`` is K1's block (a lane a block, the input staged
in shared memory, the arena where ``cuda_ring.arena_placement`` puts it,
the window in device memory) instantiated with its knock-out flags.  The
variants (``VARIANTS``):

    realrow   the exact body, error rules on (K1's outcome)
    full      the body with the lane kept alive: no error ends it
    noctx     every bit at a made-up index, (out_pos*7 + bits) mod the
              arena's size, stepped without a division; trees and
              state run
    noarena   every probability 1024, never stored
    noinput   renormalisation shifts in 0
    nowin     back() gives 0, no byte stored
    noring    no byte stored (back() still reads)
    notrans   one is_match bit a byte, no trees, no state change
    barebit   one bit a byte at the index 8 * out_pos mod the arena's
              size, stepped without a division
    barereg   barebit with the byte before kept in a register, not
              read back from the row it was just stored to
    barefast  barereg with the fast body's bit (branch-free, its
              probability loaded a bit ahead)
    barechain barefast storing no byte: the bit's chain alone
    smemwin   full with the window in shared memory: the same path and
              bytes as full, so full - smemwin is what K1's window in
              device memory costs (rows that fit beside K1's shared
              arena)
    spans     realrow with clock64 spans by kind of symbol (SPANS); the
              clock reads lengthen it
    ldgin     realrow reading the row straight from device memory
              (``__ldg``) instead of K1's staged ring: the same path
              and bytes, so ldgin - realrow is what the ring buys

Every variant but realrow, spans and ldgin keeps its lanes alive, so each lane decodes to
|size| bytes whatever it reads, as the TPU probe's did; a knock-out's
output is garbage, for timing only, and has no plain version.  Each
variant counts a lane's decoded bits, the bytes its matches copy and the
SM cycles its decode took: a knock-out decodes another path than full,
and a launch lasts as long as its slowest lane, so times compare lane by
lane, a step (a bit or a copied byte, the TPU decoder's FSM step).  On a valid stream
with positive sizes no error rule fires, so realrow, ldgin and full give K1's
bytes, ok flags and output positions; their plain version is the exact
decoder, ``device_decoder._decode_fsm``, which a CPU tensor takes.  The TPU
variants with no counterpart here: ``noflush`` (K1 writes its output row
directly), ``rowaux`` and ``realrow_gocur`` (the TPU's aux layout and
go-mask experiments).

    python -m lzma_tpu_torch.probes.probe_ring_ablate    # the table, on the card
"""

from __future__ import annotations

import functools
from collections import Counter

import torch

from ..bench.datagen import generate_bench_data
from ..core.layout import ProbLayout
from ..format.properties import LzmaParams
from ..ops.cuda_ring import _LAYOUT_FIELDS, _Layout, _check, launch_args
from ..ops.device_decoder import _decode_fsm, pad_rows
from ..ops.device_encoder import encode_batch
from . import _cuda

#: the variant ids of csrc/probe_ablate.cu
VARIANTS = {"realrow": 0, "full": 1, "noctx": 2, "noarena": 3, "noinput": 4,
            "nowin": 5, "noring": 6, "notrans": 7, "barebit": 8, "barereg": 9,
            "barefast": 10, "barechain": 11, "smemwin": 12, "spans": 13,
            "ldgin": 14}
#: the variants a plain version exists for (on valid streams)
PLAIN = ("realrow", "full", "smemwin", "spans", "ldgin")
#: the spans variant's kinds of symbol (csrc/lzma_decode.cuh kSpan*):
#: counts[:, 3:8], SM cycles
SPANS = ("plain literal", "matched literal", "match or rep", "copy",
         "checked symbol")
#: the TPU probe's variants, then realrow on its real rows
TABLE = ("full", "noctx", "noarena", "noinput", "nowin", "noring", "notrans",
         "barebit", "barereg", "barefast", "barechain", "smemwin", "ldgin")
#: the TPU probe's real rows (main_real): 32 lanes of 16 KiB of bench
#: data, lc0, dict 4 KiB, fb 8
REAL_LANES, REAL_BLOCK, REAL_DICT = 32, 1 << 14, 1 << 12

#: kernel launches by function since the counts were last cleared
LAUNCHES = Counter()


@functools.cache
def _kernel():
    P, I = _cuda.P, _cuda.I
    return _cuda.kernel("lzt_probe_ablate",
                        [I] + [P] * 8 + [I] * 8 + [_Layout, P])


def run_kernel(variant, comp, comp_lens, out_sizes, dict_size, lc, lp, pb,
               max_out):
    """One launch of csrc/probe_ablate.cu: (out (N, max_out) uint8, ok (N,)
    bool, out_pos (N,) int32, counts (N, 8) int32: bits decoded, bytes
    copied, SM cycles of the decode, then the SPANS (spans only, else
    0)).  The wrappers count it."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {tuple(VARIANTS)}, got {variant!r}")
    _check(comp, comp_lens, out_sizes, None, max_out)
    layout = ProbLayout(lc, lp, pb, pos_bits=pb)
    n, max_in = comp.shape
    dev = comp.device
    shared, probs = launch_args(comp, layout)
    if variant == "smemwin" and not shared:
        raise ValueError("smemwin needs K1's arena in shared memory")
    out = torch.zeros((n, max_out), dtype=torch.uint8, device=dev)
    ok = torch.empty((n,), dtype=torch.bool, device=dev)
    out_pos = torch.empty((n,), dtype=torch.int32, device=dev)
    counts = torch.zeros((n, 3 + len(SPANS)), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _kernel()(VARIANTS[variant], comp.data_ptr(), comp_lens.data_ptr(),
                        out_sizes.data_ptr(),
                        None if probs is None else probs.data_ptr(),
                        out.data_ptr(), ok.data_ptr(), out_pos.data_ptr(),
                        counts.data_ptr(), n, max_in, int(dict_size), lc, lp,
                        pb, max_out, shared,
                        _Layout(*(getattr(layout, f) for f in _LAYOUT_FIELDS)),
                        _cuda.stream(comp))
    _cuda.raise_on(err, f"probe_ablate {variant}")
    return out, ok, out_pos, counts


def plain(comp, comp_lens, out_sizes, dict_size, lc, lp, pb, max_out, variant):
    """The plain version of realrow and full: the exact decoder, (out,
    ok, out_pos, None); it counts nothing.  A knock-out has none."""
    if variant not in PLAIN:
        raise ValueError(f"{variant!r} is timing only: no plain version "
                         f"(plain versions exist for {PLAIN})")
    return (*_decode_fsm(comp, comp_lens, out_sizes, dict_size, lc, lp, pb,
                         max_out), None)


def ablate(comp, comp_lens, out_sizes, dict_size: int, lc: int, lp: int,
           pb: int, max_out: int, variant: str = "full"):
    """Decode N padded raw streams with `variant` of K1's body: (out (N,
    max_out) uint8, ok (N,) bool, out_pos (N,) int32, counts (N, 8) int32
    of bits decoded, bytes copied, the decode's SM cycles and the SPANS,
    None from the plain version).  comp (N, max_in) uint8, comp_lens and out_sizes
    (N,) int32."""
    if not _cuda.on_device(comp, "ablate"):
        return plain(comp, comp_lens, out_sizes, dict_size, lc, lp, pb,
                     max_out, variant)
    res = run_kernel(variant, comp, comp_lens, out_sizes, dict_size, lc, lp,
                     pb, max_out)
    LAUNCHES["ablate"] += 1
    return res


def real_rows(device, lanes=REAL_LANES):
    """The TPU probe's real rows, encoded by the port's lazy encoder:
    (comp, comp_lens, out_sizes, the input (lanes, 16 KiB) uint8)."""
    data = generate_bench_data(lanes * REAL_BLOCK)
    blocks = [data[i:i + REAL_BLOCK] for i in range(0, len(data), REAL_BLOCK)]
    params = LzmaParams(lc=0, dict_size=REAL_DICT, fast_bytes=8)
    comp, comp_lens = pad_rows(encode_batch(blocks, params, device=device), device)
    sizes = torch.full((lanes,), REAL_BLOCK, dtype=torch.int32, device=device)
    want = torch.frombuffer(bytearray(data), dtype=torch.uint8).reshape(
        lanes, REAL_BLOCK).to(device)
    return comp, comp_lens, sizes, want


def same(a, b) -> bool:
    """Two results alike but for the clock."""
    return all(torch.equal(x, y) for x, y in zip(a[:3], b[:3])) \
        and torch.equal(a[3][:, :2], b[3][:, :2])


def checksum(res) -> int:
    """One integer over a result's bytes, output positions and counts:
    printed beside a knock-out's time, it shows the work was done."""
    out, _, out_pos, counts = res
    w = torch.arange(1, out.shape[1] + 1, device=out.device, dtype=torch.int64)
    return int(((out.long() * w).sum() + out_pos.long().sum() * 7919
                + counts[:, 0].long().sum() * 104729
                + counts[:, 1].long().sum() * 15485863) % (1 << 61))


def per_lane(res):
    """A result's lanes timed by their own clocks: the means over the
    lanes of (ns a byte, ns a step, ns a bit, bits, copied bytes, ms of
    the decode), and the slowest lane's ms; a step is a bit or a copied
    byte."""
    bits, copies, cycles = res[3][:, :3].double().unbind(dim=1)
    ns = cycles * 1e6 / _cuda.clock_khz(res[3].device.index or 0)
    mean = lambda x: float(x.mean())
    return (mean(ns / res[2].double()), mean(ns / (bits + copies)),
            mean(ns / bits), mean(bits), mean(copies), mean(ns) / 1e6,
            float(ns.max()) / 1e6)


def breakdown(counts, lane=None):
    """The spans variant's SPANS as shares of their sum, over all lanes
    or for one lane."""
    spans = counts[:, 3:].double()
    spans = spans.sum(0) if lane is None else spans[lane]
    return tuple(float(x) for x in spans / spans.sum())


def sweep(device, comp, comp_lens, sizes, variants=TABLE + ("realrow",)):
    """The probe's table on the card over the given streams (dict 4 KiB,
    lc0, pb2): (variant, ms a launch by CUDA events, then per_lane's
    seven numbers, checksum).  Each variant runs twice with equal
    results before it is timed."""
    args = (comp, comp_lens, sizes, REAL_DICT, 0, 0, 2, int(sizes.max()))
    rows = []
    for variant in variants:
        first, again = ablate(*args, variant), ablate(*args, variant)
        if not same(first, again):
            raise AssertionError(f"ablate {variant} gave two results")
        ms = _cuda.event_ms(lambda: ablate(*args, variant))
        rows.append((variant, ms, *per_lane(first), checksum(first)))
    return rows


def spans_line(device, comp, comp_lens, sizes) -> str:
    """The spans variant's shares over the streams (dict 4 KiB, lc0,
    pb2), as one line."""
    res = ablate(comp, comp_lens, sizes, REAL_DICT, 0, 0, 2, int(sizes.max()),
                 "spans")
    return ", ".join(f"{k} {100 * v:.1f}%" for k, v in zip(SPANS, breakdown(res[3])))


def main():
    dev = _cuda.cuda_device()
    comp, comp_lens, sizes, want = real_rows(dev)
    k = ablate(comp, comp_lens, sizes, REAL_DICT, 0, 0, 2, REAL_BLOCK, "realrow")
    decoded = bool(k[1].all()) and torch.equal(k[0], want)
    _cuda.print_table(
        f"probe_ring_ablate: {REAL_LANES} real rows of {REAL_BLOCK} B (lc0, "
        f"dict {REAL_DICT}), realrow decodes them: {decoded}",
        [(f"{v:8s}", f"{ms:8.3f} ms ({lane_ms:.3f} a lane, {slow:.3f} the "
          f"slowest), a lane {nb:7.1f} ns/byte, {nst:6.1f} ns/step, "
          f"{nbit:6.1f} ns/bit, {bits:7.0f} bits and {cp:6.0f} copied bytes, "
          f"checksum {cs}")
         for v, ms, nb, nst, nbit, bits, cp, lane_ms, slow, cs
         in sweep(dev, comp, comp_lens, sizes)]
        + [("spans", "the decode's cycles: "
            + spans_line(dev, comp, comp_lens, sizes))])


if __name__ == "__main__":
    main()
