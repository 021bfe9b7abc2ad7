#!/usr/bin/env python3
"""Drive lzma_tpu_torch's device block codec, its hybrid encode, its
block mesh, its automatic parameters, its benchmark and its file codec
on one NVIDIA GPU and check them.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is caught and skipped; each
prints its seconds):
  1. no CUDA device fails; the card's name and power limit (nvidia-smi)
  2. build the CUDA kernels from lzma_tpu_torch/csrc (one nvcc a source,
     all started together; K3 and K4 share dp_rows.cuh, their row tiles)
  3. each kernel against its plain PyTorch version on the card at small
     shapes: the range encoder (K2) with its arena in shared and in device
     memory (the same streams with lc8 lp4's arena size, which is over the
     card's shared memory), both decoders (K1, K5), the classify carry
     (K6, a scan over each lane's token rows in five grids), the bit
     lowering (K7, tile sums, a lane scan, a fill, each round's pairs
     staged in shared memory and written out) and its slot counts
     (K8, a histogram a block), K6, K19 (classify_tokens whole: K6's
     grids on the (N, T) planes and a finish grid), K7 and K8 on the lazy
     and the optimal parse's tokens with the EOS marker appended, on 8
     lanes x 2 KiB, K7
     and K8 also on a preset-primed lc8 lp4 pb4 batch (pos_base; K8's
     3,147,574 slots a lane in device memory, lc3 lp0 pb2's in shared
     memory), K8 on one 256 KiB lane of literals only (the hot slots); K2
     on lc8 lp4's own streams, in device
     memory, and K1
     on them
     with its arena in device memory (K1's placement, as K2's, by the
     arena's size alone; lc3 lp0's is in shared memory); K1 and K5 on a
     preset-primed batch made by the port's own encoder; both DP scans
     (K3, K4: K4 the carried band on K3's row tiles, a literal warp beside
     its relax warps) on the first round's inputs of 8 lanes x 2 KiB at fb
     8, 32 (both relax a length on 4 lanes) and 273 (on one thread a
     length); the search's kernels (K9 keys, K10 suffix table, K11 match
     lists, ops/cuda_search.py) through device_matcher._rmq_search on the
     same 8 lanes (one all zeros, two of 0 and 3 bytes) at fb 5, 32 and
     273 (K10 given the prefix doubling's LCP), DP_TIERS cut to 12 "rr"
     and "near" and DEFAULT_TIERS uncapped: each against its plain version
     on the arguments the route gave it; the rounds' price model (K18,
     ops/cuda_model.py: the price planes, the distance tables and the DP
     tables' row from the slot counts), the DP rows (K12,
     ops/cuda_inputs.py), the path's marking and compaction (K13, K14,
     ops/cuda_path.py), classify_tokens (K19), the rep0 trace (K20,
     ops/cuda_inputs.py) and the DP and seed pairs (K21,
     ops/cuda_search.py) through tokenize_optimal on the same lanes at fb
     5, 32 and 273 and at lc8 lp4 pb4 (K12's literal slots in device
     memory, as at every lc and lp), K13 and K14 also through the
     lazy tokenize from position 0 and from 256: each against its plain
     version on the arguments the route gave it; the lazy search's
     kernels (K15 a prefix-doubling level's group ids and the next sort's
     key, K16 the descent's consecutive LCP, K17 the best matches,
     ops/cuda_lazy.py) through the same lazy tokenizes, K15 and K16 also
     through _rmq_search at fb 273: each call against its plain version
  4. the card against the JAX reference: the 8-lane containers of
     generate_bench_data(64 KiB) must hash to PIN_SHA256 (lazy) and
     PIN_OPT_SHA256 (optimal), which tests/test_torch_api.py pins to the
     JAX package's ops.api.encode_blocks; both round-trip
  5. the bench's device round trip (bench.py:297-328): 512 KiB of bench
     data, 16 KiB blocks, dict 16 KiB, fb 32, parse="optimal": ratio
     2.256, 232,363 bytes hashing to PIN_BENCH_SHA256, round trip, every
     block decoded by the stdlib lzma module
  6. the lazy path at 8 MiB (text corpus + bench data, LzmaParams()
     defaults, 256 KiB blocks = 32 lanes): encode, decode, round trip,
     stdlib lzma, K19, K7, K9 (the 32-byte suffix keys and the hash key),
     K10 (the 273-deep suffix table), K13, K14, K16 and K17 launched
     once, K15 five times (the 32-byte level and each doubling), K6, K8,
     K11, K12, K20 and K21 not at all, K1 and K2; the same encode again inside
     probing(): its tokenize split by device_matcher.LAZY_STAGES (summed
     as "tokenize"), and K15-K17's calls (spied, whole lanes) timed by
     CUDA events beside lazy_work's bounds
  7. the main path: the same 8 MiB with parse="optimal": encode, decode,
     round trip, stdlib lzma, smaller than the lazy container; K3
     launched at least twice, K19 three times (K6 not at all), K20 twice,
     K21 once, K8 twice (the two rounds
     count their pairs), K7 once (the final tokens), K9, K10 and K11 once
     (one lane group's search), K18 and K12 twice (a round each), K13 and K14
     three times (the seed's lazy path and each round's DP path), K2 and
     K1 at least once; MB/s, ratio, peak
     device memory; then the same encode again inside probing(), which
     must give the same container: its stage breakdown (the device
     synchronized around each stage; the price model's five stages also
     summed as "model", the search's five as "search"), its whole-lane
     kernel stages
     beside their bounds (K3's by bytes and operations), K2 on the whole
     lanes' (ctx, bit) streams, K1 on the whole container's streams and
     K6 on the final tokens' rows timed by CUDA events (K6 beside its
     bound and a model of the bytes its design moves), K7 on the final
     lowering's arguments (equal to the encode's streams) beside its
     bound, K8 on the last round's lower_counts arguments beside its
     bound and beside the route it replaced (K7's planes of the same
     tokens, then pair_counts, whose counts K8's equal), K9, K10 and K11
     on the main path's whole lanes through _rmq_search (each call timed
     alone by CUDA events beside its bound; K8's and these lines are
     printed after phase 18 with each call's grids, torch.profiler over
     three calls after a warm one, the arguments kept in host memory
     till then, so that phase 18's traces are the process's first; K10's
     levels past its tiles by their route at these lanes, column
     stripes, and again with a pass a level forced, timed and equal);
     K18, K12, K13, K14, K19, K20 and K21 on the
     probed encode's last calls (spied: the last round's counts, rows
     and DP path, the seed's lazy path, the final classify, the last
     round's rep0 trace, the lists' pairs; each call timed alone by CUDA
     events beside its bound; K18's, K12's, K13's and K14's grids traced
     after phase 18, K13's and K14's blocks an SM), and the inputs
     phases 8 and 9 take
  8. the K4 path: tokenize_optimal(scan="band2") on phase 5's 32 x 16 KiB
     gives the tokens of the default scan, K4 launched (its count); K4 on
     the main path's whole last DP round (32 x 262,144 positions) gives
     K3's planes; both timed there, K4 with dp_parse2_plan's block
  9. each kernel against its plain version at the main path's shapes
     (its own 32 x 256 KiB tensors, the work cut so that the plain
     versions finish: K3 and K4 scan the first CMP_POS positions, K2
     codes the first CMP_BITS pairs, K1 decodes each lane up to the first
     token boundary at or past CMP_OUT bytes), all timed on those inputs;
     K6 (the scan) against its plain carry on the whole final tokens,
     uncut, K19 against the plain finish on that plain carry (the carry
     runs once), K7 against its plain lowering on the whole final
     lowering's arguments, uncut, K8 against its plain counts on the
     whole last round's arguments, uncut, K9, K10 and K11 against
     their plain versions on phase 7's whole-lane search, uncut, K18,
     K12, K13, K14, K20 and K21 against theirs on phase 7's last calls,
     uncut, and
     K15, K16 and K17 against theirs on phase 6's whole-lane calls, uncut
 10. the K5 path: phase 5's 32 streams through decode_batch_resident
     equal the input and K1 (K5 launched, its count); K1's champion shape
     (128 x 16 KiB, lc0, dict 4 KiB, fb 8) through K5 and K1, both timed,
     and K5 against its plain version on those streams cut at
     CMP_OUT_K5 bytes; a 256 KiB main-path lane raises ValueError
 11. the codec matrix (tools/chip_check.py:59-111): five shapes and
     lc/lp/pb, preset and dictionary cases through encode_blocks /
     decode_blocks, lazy and optimal, the stdlib reading each block it
     can (lc + lp <= 4, no preset)
 12. the decoder matrix: K5 and K1 on 16 x 16 KiB at dict 4 KiB, on a
     preset-primed batch and on EOS lanes from the stdlib's FORMAT_ALONE
     (caps past the end decode, caps at half raise)
 13. the probes (lzma_tpu_torch/probes, the TPU probes P1-P15 of
     tools/probe_*.py): each probe kernel against its plain version on
     the card at a cut (PROBE_CUT_* steps or bytes; exact), the copies
     also against the TPU probes' reference arrays, unaligned rows
     refused before a launch; the ablation's exact variants (realrow,
     full, smemwin, spans) on the first 32 champion streams equal to the
     plain decoder, full on the whole rows to K1 and the input; then
     every probe's table (the TPU probe's sweep, CUDA
     events, one line a table), the probes' launch counts set to 0 just
     before and read just after
 14. the `.lzma` path at full size: the 8 MiB of phase 6 as ONE stream
     through ops.api.encode_alone, with a known size and with the EOS
     marker, and decode_alone: the stdlib and the port read both back,
     K19, K7, K9, K10, K13, K14, K16, K17, K2 and K1 launched once a
     stream, K15 five times, and K3, K6, K8, K11, K12, K18, K20 and K21
     not at all (counts
     set to 0 just before each), MB/s and peak memory, the EOS encode
     again inside probing() for its stages (LAZY_STAGES summed as
     "tokenize") and K6's time on its rows, K19's and K7's on its
     tokens (one lane: the scan spreads its 8,388,609 rows over 2,049
     tiles, K7 its tokens over 8,193); K6, K19, K7, K2 and K1 against
     their plain versions on that stream's tensors, cut as in phase 9
     (K6, K19 and K7 on the first CMP_POS token rows, K7's doubled by
     invalid ones,
     and on the rows from CMP_POS before the EOS token to the end, the
     whole tail), and K15, K16 and K17 (spied in the probed encode)
     against theirs on that stream's own calls, uncut, each kernel's
     calls also timed by CUDA events beside lazy_work's bounds, and K10 likewise
     (its one lane of places no multiple of its tile: the levels past
     the tile a pass a level), and K13 and K14 (spied there too: one lane
     of 8,388,609 nodes, 2,049 tiles, the door maps composed in groups of
     128), timed by CUDA events beside row_work's bounds; the `.lzma` pins
     (PIN_ALONE_SHA256, PIN_ALONE_EOS_SHA256 = the JAX package's
     encode_alone of 64 KiB of bench data); the front door
     (lzma_tpu_torch.compress -> decompress on 2 MiB); the command line
     (`python -m lzma_tpu_torch e -eos` and `d` on 1 MiB in a temporary
     directory under lzma_tpu_torch/_build, the stdlib reading the file);
     lzma_tpu_torch.entry's fn(*args) hashing to PIN_ENTRY_SHA256 (the
     JAX package's __graft_entry__.entry())
 15. the hybrid's pins: ops.hybrid.encode_blocks_hybrid_optimal and
     encode_blocks_hybrid of generate_bench_data(HYBRID_PIN_SIZE) (16 KiB
     blocks, dict 16 KiB, fb 16) hash to PIN_HYBRID_OPT_SHA256 and
     PIN_HYBRID_LAZY_SHA256 (tests/test_torch_api.py: the JAX package's
     containers); both round-trip
 16. hybrid8M-opt: phase 6's 8 MiB, LzmaParams() defaults, 32 blocks of
     256 KiB, DEFAULT_TIERS, all host threads: the candidate lists on the
     card, the optimal parse on the host; wall time and MB/s split by a
     PhaseTimer (search on the card, transfer, flatten, host parse), the
     host's CPU count, ratio beside main8M-opt's, peak device memory; K9,
     K10 and K11 launched once a lane group, K11's lists 29 wide, "near";
     K9, K10 and K11 on its whole lanes against their plain versions
     (tolerance zero); the container round-trips through K1 (counted from
     0) and the stdlib reads every block
 17. hybrid8M-lazy: the same input through the lazy hybrid; its container
     equals phase 6's main8M-lazy container byte for byte; its time
 18. the profile: phase 7's encode and decode again under
     utils.profiling.profiler_trace (torch.profiler, CPU and CUDA): the
     card's busy share of each traced window and the ten heaviest device
     operations; the probed encode's peak memory by stage (the peak within
     the stage above what was allocated as it began)
 19. the trace dump: encode_batch(trace=) on TRACE_LANES x TRACE_BYTES of
     that input, lazy and optimal, on the card (K19 launched) gives the
     lines of the same call on the CPU
 20. the block mesh (parallel.mesh, multihost) over an NCCL group of one
     rank in this process, phase 6's 8 MiB in 32 lanes of 256 KiB,
     LzmaParams() defaults: encode_blocks_mesh lazy and optimal equal
     phases 6 and 7's containers, gather=True (an all_gather on the card)
     the same bytes, v2 (preset_len=MESH_PRESET) and v3 (a MESH_DICT-byte
     dictionary from utils.dicttrain.train_dictionary) api.encode_blocks'
     with the same arguments, encode_blocks_mesh_hybrid phase 16's
     container; every one round-trips through decode_blocks_mesh; K2, K3,
     K19-K21 and the rest launch in the mesh's encodes and K1 in its
     decodes (counted
     from 0 around each call); wall times and MB/s beside
     api.encode_blocks' in the same phase
 21. MESH_RANKS spawned Gloo ranks whose kernels share the card (the
     collectives on host tensors), 8 of the 32 lanes a rank: rank 0's
     lazy and optimal containers equal phases 6 and 7's; each rank's
     encode time split into its shard's kernels and the gather;
     decode_blocks_mesh of the optimal container gives the input on every
     rank (K1 on each); rank 0's v2 and v3 containers (the heads
     broadcast from rank 0) equal phase 20's, its encode_blocks_mesh_hybrid
     container phase 16's (the lane groups sized from a 1/MESH_RANKS share
     of the card's free memory); each rank's seconds and launches
 22. auto: select_params and select_dictionary on the first AUTO_SIZE
     bytes of phase 6's input (text) in AUTO_BLOCK blocks choose
     PIN_AUTO_PARAMS and the PIN_AUTO_DICT_SHA256 dictionary (the JAX
     package's choices, pinned by tests/test_torch_autotune.py), each
     timed on the host beside os.cpu_count(); lzma_tpu_torch.compress with
     params="auto" (K3 launched), and with train_dict="auto" too (LZTB
     v3), equals the optimal api.encode_blocks with those choices; both
     round-trip
 23. cli auto: `python -m lzma_tpu_torch e -tune -tdauto -bs{AUTO_BLOCK}
     -d22 -fb32` and `d` on those bytes (a temporary directory under
     lzma_tpu_torch/_build): the "tuned:" line, the file equal to
     api.encode_blocks (the lazy parse) with phase 22's choices, read back
 24. the benchmark `b` in this process through cli.main: `b 2`
     (-backendtpu: dict 2 MiB, 4 MiB a pass, one lane; K19, K7, K10, K13,
     K14 and K2 launch once a pass, K1 twice) and `b 1 -backendhybrid`
     (K9, K10 and K11 once a pass, K1 twice, no K19, K7, K13, K14 or K2);
     the harness CRC-checks
     every decode; the
     report lines (KB/s, MIPS) and the wall time
 25. dp ratio: bench.py:556-563's device_dp_ratio, text_part()[:256 KiB]
     in 64 KiB blocks, dict 64 KiB, fb 32, optimal: 61,535 B, ratio 4.260
     (BENCH_r05), PIN_DP_RATIO_SHA256 (lzma_tpu.ops.api.encode_blocks'
     container, pinned by a slow test in tests/test_torch_bench.py);
     round trip; the stdlib reads every block
 26. the LZTB file codec on files past one-shot capacity (a temporary
     directory under lzma_tpu_torch/_build; filestream's batch log on):
     file128M-opt, phase 6's 8 MiB tiled 16 times through
     lzma_tpu_torch.compress_file(parse="optimal") and decompress_file in
     this process; file256M-lazy, tiled 32 times through `python -m
     lzma_tpu_torch e -bs262144 -d22 -fb32` and `d`, each a process.
     Each container is phase 7's (6's) streams repeated under the tiled
     header and size table, the stdlib reads blocks 0, n/2 and n-1, and
     the round trip hashes to the input's SHA-256; each batch's peak
     device memory (reset before it) is at or below the sizer's model plus
     10% and, with what was allocated before it, at or below 80% of the
     card; K1, K2, K19, K7, K10, K13 and K14 (and K3, K8, K9, K11, K12,
     K18, K20 and K21 under the optimal parse) launch;
     batches, blocks a batch, peaks beside the model, seconds and MB/s
     are printed.
     Then an open("wb") writer fed 1 MiB writes over the first 16 MiB
     writes compress_file's container of those bytes, and open("rb")
     reads it back in 1 MiB reads
 27. no module of jax, jaxlib or lzma_tpu was loaded
The last three lines are the card, the kernels' JSON record (K1-K21 and
P1-P15, 36 records; K6's launches are the main path's, 0: no path calls
it since K19 classifies the tokens, and its record holds it to the plain
carry on the main path's final tokens' rows; K19-K21's `ms` is main8M-opt's last
call by CUDA events and `stage_ms` its stage's probed seconds a call
(classify, rep0_trace, select_pairs), K19's `stream_ms` the stream's call
and `trace_launches` phase 19's; K18's `ms` is the last round's call of main8M-opt by
CUDA events and `stages_ms` the probed encode's empirical_probs and
build_price_model stages, a call each; K15-K17's launches are main8M-lazy's, their `ms`
the sum of their calls in its search and `calls_ms` each call's, beside
main8M-opt's, the stream's, hybrid8M-lazy's, the mesh's, `b`'s and the
file configurations' launches; K9-K18's `jax_ref` names the jitted JAX code each
restates, their `ms` is the whole-lane call's and `plain_ms` the plain
version's on the same arguments, uncut, their launches are main8M-opt's
and beside them main8M-lazy's, hybrid8M-opt's (K9-K11), the NCCL
mesh's, `b`'s and the file configurations'; K13's and K14's `ms` is the
last round's DP path's call and `seed_ms` the seed's lazy path's, their
`stream_ms` the `.lzma` stream's call (phase 14, beside its bound and
plain version), `grids` each main-path call's device operations (after
phase 18) and `blocks_per_sm` their grids'; K1's
carries its launches in phase 16's decode, K1, K2, K3, K7 and K8 theirs
in phase 20's mesh calls, K1, K2, K7 and K8 theirs in phase 24's `b
-backendtpu` and K1 in `b -backendhybrid`, and K1, K2, K3, K7 and K8
theirs in phase
26's file configurations, `file_launches`; K7's and K8's their lazy
launches too, K7's its stream launches, K8's the route it replaced,
`route_ms`) and the result JSON.
"""

from __future__ import annotations

import gc
import hashlib
import json
import lzma
import subprocess
import sys
import time

#: SHA-256 of lzma_tpu.ops.api.encode_blocks(generate_bench_data(1 << 16),
#: LzmaParams(dict_size=1 << 16), block_size=1 << 13, parse=...)
PIN_SHA256 = "22e991f02066cf506d4759d0e7e574af4996ebccc0e4c0685c0be76e657db644"
PIN_OPT_SHA256 = "268f63d4212d1f38797f28c09adf4c3d108896be71ac3d551ed240de317cc956"
PIN_INPUT = dict(size=1 << 16, dict_size=1 << 16, block_size=1 << 13)

#: the bench's device round trip (bench.py:297-328) and what the JAX
#: reference gives there: BENCH_r05.json device_ratio, container bytes,
#: and the container's SHA-256 (pinned by tests/test_torch_api.py)
BENCH_INPUT = dict(size=1 << 19, dict_size=1 << 14, fast_bytes=32,
                   block_size=1 << 14)
BENCH_RATIO = 2.256
BENCH_BYTES = 232_363
PIN_BENCH_SHA256 = "d1d072795dfa96bfe5cdd3c8d71c4d7fadf1557a05b07a9f1f8166e659f3644c"

#: SHA-256 of lzma_tpu.ops.api.encode_alone(generate_bench_data(1 << 16),
#: LzmaParams(write_eos=False / True)): the `.lzma` path's pins
ALONE_PIN_SIZE = 1 << 16
PIN_ALONE_SHA256 = "654f73da0aea6ab637a249b03248459ac26f07c9e9f7431cbe432ef6ead8e8e0"
PIN_ALONE_EOS_SHA256 = "75a2179f5254419a7b6c9e881e8466870b76a7ad599074afe039f560c9bfb79e"
#: entry_digest of __graft_entry__.entry()'s fn(*example_args)
PIN_ENTRY_SHA256 = "1892b58191d0211dfb8bef90a0e16b341da5a11fb17edd2a55d79bd86fbfbb6c"

#: SHA-256 of lzma_tpu.ops.hybrid.encode_blocks_hybrid_optimal and
#: encode_blocks_hybrid of generate_bench_data(HYBRID_PIN_SIZE),
#: LzmaParams(dict_size=1 << 14, fast_bytes=16), block_size=1 << 14
#: (pinned by tests/test_torch_api.py)
HYBRID_PIN_SIZE = (1 << 16) + 1234
PIN_HYBRID_OPT_SHA256 = "651eef81b7317ea7717c2b68b561e6759de3a8f932719cbf5392bd54e2674d0f"
PIN_HYBRID_LAZY_SHA256 = "818ecdaccc636d8a19d711b6ca4e280057953a91111a9ffb9fc95b7f0db469dd"

MAIN_BLOCK = 1 << 18
#: the auto phase: the first AUTO_SIZE bytes of the main input (all text)
#: in AUTO_BLOCK blocks, and what lzma_tpu's select_params and
#: select_dictionary choose there with LzmaParams() defaults (pinned by
#: tests/test_torch_autotune.py)
AUTO_SIZE, AUTO_BLOCK = 1 << 21, 1 << 18
PIN_AUTO_PARAMS = (3, 0, 2)
AUTO_DICT_LEN = 16384
PIN_AUTO_DICT_SHA256 = "a36c6f3a006e52c356ccfec7ac59bff8cf04c553d5e5db2b0da8a172280d24d3"
#: bench.py:556-563's device_dp_ratio: text_part()[:DP_RATIO_SIZE], dict
#: 64 KiB, fb 32, 64 KiB blocks, the optimal parse; BENCH_r05's ratio,
#: and the size and SHA-256 of lzma_tpu.ops.api.encode_blocks' container
#: (pinned by tests/test_torch_bench.py, a slow test)
DP_RATIO_SIZE, DP_RATIO_BLOCK = 1 << 18, 1 << 16
DP_RATIO = 4.260
DP_RATIO_BYTES = 61_535
PIN_DP_RATIO_SHA256 = "255eece96f72fa5520a6d8cf83a772bcaaa39216b4abacb517ad1e8d76836c04"
#: the `b` phase's passes on -backendtpu and on -backendhybrid
BENCH_PASSES_TPU, BENCH_PASSES_HYBRID = 2, 1
#: phase 21: the v2 preset and the v3 dictionary on the mesh, and the
#: ranks of the Gloo group that share the one card
MESH_PRESET, MESH_DICT, MESH_RANKS = 1 << 16, 1 << 16, 4
#: phase 26: the file codec's inputs, phase 6's 8 MiB tiled (128 MiB
#: optimal, 256 MiB lazy), and the file objects' writes over the first
#: FILE_WRITER_TILES tiles
FILE_OPT_TILES, FILE_LAZY_TILES, FILE_WRITER_TILES = 16, 32, 2
FILE_WRITE = 1 << 20
#: the trace dump's lanes (phase 19): TRACE_LANES x TRACE_BYTES
TRACE_LANES, TRACE_BYTES = 2, 2048
CMP_LANES, CMP_BYTES = 8, 2048       # kernel vs plain comparison shape
CMP_POS = 2048                       # K3's positions per lane at the main shapes
CMP_BITS = 1 << 15                   # K2's work per lane at the main shapes
CMP_OUT = 2048                       # K1's work per lane at the main shapes

CMP_OUT_K5 = 512                     # K5's work per lane against plain
#: K1's champion shape (bench.py:344-390), which K5 serves too
CH_LANES, CH_BLOCK, CH_DICT = 128, 1 << 14, 1 << 12
#: tools/chip_check.py:61-67: (total, block, lc, lp, pb, preset_len,
#: dictionary length)
MATRIX = [
    (3 * 4096 + 123, 4096, 3, 0, 2, 0, 0),
    (5 * 8192, 8192, 0, 2, 0, 2048, 0),
    (7 * 2048, 2048, 4, 1, 1, 0, 512),
    (1 * 1024 + 17, 1024, 3, 0, 2, 0, 0),
    (12 * 4096, 4096, 3, 0, 2, 0, 1024),
]

#: phase 13's cuts: the probes' plain versions run this many steps (the
#: make cases fewer: their steps are hundreds of selects), and the
#: ablation's plain decoder each lane to its first token boundary at or
#: past PROBE_CUT_OUT bytes, on the first PROBE_LANES champion streams
#: (tools/probe_ring_ablate.py main_real: 32 x 16 KiB, lc0, dict 4 KiB)
PROBE_CUT_ITERS, PROBE_CUT_MAKE, PROBE_CUT_OUT, PROBE_LANES = 256, 64, 128, 32

#: the card's peaks (NVIDIA H100 SXM data sheet, 700 W): HBM bytes/s, and
#: the float32 rate outside the tensor cores, used for the int32
#: compares, adds and selects these kernels do
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


def log(msg):
    print(msg, flush=True)


def pin_input():
    from lzma_tpu_torch.bench.datagen import generate_bench_data
    from lzma_tpu_torch.format.properties import LzmaParams

    return (generate_bench_data(PIN_INPUT["size"]),
            LzmaParams(dict_size=PIN_INPUT["dict_size"]), PIN_INPUT["block_size"])


def bench_input():
    """bench.py takes generate_bench_data(8 << 20)[: 1 << 19]; the
    generator is sequential, so that prefix is generate_bench_data(1 << 19)."""
    from lzma_tpu_torch.bench.datagen import generate_bench_data
    from lzma_tpu_torch.format.properties import LzmaParams

    b = BENCH_INPUT
    return (generate_bench_data(b["size"]),
            LzmaParams(dict_size=b["dict_size"], fast_bytes=b["fast_bytes"]),
            b["block_size"])


def entry_digest(out, lens):
    """SHA-256 of a lane encode's result (numpy arrays): the comp rows'
    bytes, then the lens as little-endian int32."""
    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(out, dtype=np.uint8).tobytes()
                          + np.asarray(lens, dtype="<i4").tobytes()).hexdigest()


def lane_blocks(n_lanes, size, seed):
    """Mixed lanes: bench data, text, and a short incompressible tail."""
    import numpy as np
    from lzma_tpu_torch.bench.corpus import text_part
    from lzma_tpu_torch.bench.datagen import generate_bench_data

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
    """Phases A-C of the lazy encoder on `device`: (ctx, bits, totals, max_out)."""
    from lzma_tpu_torch.ops.device_decoder import pad_rows
    from lzma_tpu_torch.ops.device_encoder import DEFAULT_NUM_CANDIDATES, _lower_lanes

    data, lens = pad_rows(blocks, device)
    return _lower_lanes(data, lens, min(params.dict_size, data.shape[1]),
                        params.lc, params.lp, params.pb, params.fast_bytes,
                        DEFAULT_NUM_CANDIDATES)


def dp_round_inputs(blocks, params, device):
    """The first DP round's inputs of the optimal parse for `blocks`
    (search, seed, classify, lower, model on `device`): (packed, tables,
    lens)."""
    from lzma_tpu_torch.ops.device_decoder import pad_rows
    from lzma_tpu_torch.ops.device_parser import _lists_and_seed, _round_inputs

    data, lens = pad_rows(blocks, device)
    fb = params.fast_bytes
    ld, dd, tokens, suffix = _lists_and_seed(
        data, lens, min(params.dict_size, data.shape[1]), fb)
    packed, tables = _round_inputs(data, lens, tokens, ld, dd, suffix,
                                   params.lc, params.lp, params.pb, fb)
    return packed, tables, lens


def wall_ms(fn):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the operations over the scalar rate."""
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    o_ms = n_ops / SCALAR_OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def grid_split(fn):
    """fn's device operations over three traced calls after a warm one
    (torch.profiler): [(name, microseconds a launch, launches a call)],
    heaviest first (bench/kernel_ab.py's split)."""
    from lzma_tpu_torch.bench.kernel_ab import grid_split as split

    return [[name, us, n] for name, us, n in split(fn)]


def grid_text(grids):
    """The split's operations as "name us xN", names cut to the kernel's."""
    def short(name):
        name = name.replace("(anonymous namespace)::", "")
        return name.removeprefix("void ").split("(")[0]
    return ", ".join(f"{short(name)} {us:.1f} us x{n:g}" for name, us, n in grids)


def record(name, source, replaces, n, err, ms, plain, bnd, library=None,
           **extra):
    base = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    if base & set(extra):
        raise AssertionError(f"{name}'s extra keys {sorted(base & set(extra))} "
                             "would replace the record's own")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n, "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": library, **extra}


def check_serializer(ctx, bits, totals, arena, max_out, arenas=()):
    """K2 against serialize on the same card tensors (tolerance zero),
    with an arena of `arena` probabilities and of each size in `arenas`
    (larger ones, which code the same bytes: the card may place them
    elsewhere).  Returns (max |diff|, kernel out, kernel lens, plain
    version's ms)."""
    import torch
    from lzma_tpu_torch.ops.cuda_serializer import serialize_cuda
    from lzma_tpu_torch.ops.device_encoder import serialize

    box = {}
    plain_ms = wall_ms(lambda: box.update(
        p=serialize(ctx, bits, totals, arena, max_out)))
    p_out, p_lens = box["p"]
    for size in (*arenas, arena):
        k_out, k_lens, consumed = serialize_cuda(ctx, bits, totals, size,
                                                 max_out)
        if not torch.equal(consumed, totals):
            raise AssertionError("range coder kernel left bits unconsumed")
        if not torch.equal(k_lens, p_lens):
            raise AssertionError(f"range coder lens differ (arena {size}): "
                                 f"{k_lens} vs {p_lens}")
        err = int((k_out.int() - p_out.int()).abs().max())
        if err:
            raise AssertionError(f"range coder bytes differ from the plain "
                                 f"version (arena {size})")
    return err, k_out, k_lens, plain_ms


def check_decoder(comp, comp_lens, sizes, params, max_out, preset=None,
                  resident=True):
    """K1 and, where `resident`, K5 against _decode_fsm on the same card
    tensors (tolerance zero); every lane must decode.  Returns (max
    |diff|, K1's out, plain version's ms)."""
    import torch
    from lzma_tpu_torch.ops.cuda_decoder import decode_resident
    from lzma_tpu_torch.ops.cuda_ring import decode_cuda
    from lzma_tpu_torch.ops.device_decoder import _decode_fsm

    args = (comp, comp_lens, sizes, params.dict_size, params.lc, params.lp,
            params.pb, max_out)
    box = {}
    plain_ms = wall_ms(lambda: box.update(p=_decode_fsm(*args, preset=preset)))
    p_out, p_ok, p_pos = box["p"]
    kernels = [("ring_decode", decode_cuda)]
    if resident:
        kernels.append(("block_decode", decode_resident))
    outs = []
    for name, fn in kernels:
        k_out, k_ok, k_pos = fn(*args, preset=preset)
        if not bool(k_ok.all()) or not torch.equal(k_ok, p_ok):
            raise AssertionError(f"{name} ok flags: kernel {k_ok}, plain {p_ok}")
        if not torch.equal(k_pos, p_pos):
            raise AssertionError(f"{name} out_pos: kernel {k_pos}, plain {p_pos}")
        if int((k_out.int() - p_out.int()).abs().max()):
            raise AssertionError(f"{name} bytes differ from the plain version")
        outs.append(k_out)
    return 0, outs[0], plain_ms


def check_scans(packed, tables, lens, fb, pb):
    """K3 and K4 against dp_parse_band on the same card tensors (tolerance
    zero).  Returns (max |diff| over from and choice, plain version's ms)."""
    from lzma_tpu_torch.ops.cuda_parser import dp_parse2_cuda, dp_parse_cuda
    from lzma_tpu_torch.ops.device_parser import dp_parse_band

    box = {}
    plain_ms = wall_ms(lambda: box.update(
        p=dp_parse_band(packed, tables, lens, fb, pb)))
    for name, fn in (("dp_parse", dp_parse_cuda), ("dp_parse2", dp_parse2_cuda)):
        err = max(int((k - p).abs().max()) for k, p in
                  zip(fn(packed, tables, lens, fb, pb), box["p"]))
        if err:
            raise AssertionError(f"{name} differs from the plain version by {err}")
    return 0, plain_ms


def dp_work(packed, lens):
    """(bytes, operations) the scan needs on these inputs: every packed row
    read once and (from, choice) written once; per live position ~60
    operations to finalize the node and ~6 per relaxed edge, the edges
    being the lengths 2..min(ld, lens - i) of each valid pair and
    2..min(replen, lens - i) of the rep0 source."""
    import torch

    L, N, C = packed.shape
    M = (C - 5) // 6
    pos = torch.arange(N, device=packed.device)
    rem = torch.clamp(lens.long()[:, None] - pos, min=0)
    ld = torch.minimum(packed[:, :, :M].long(), rem[:, :, None])
    pairs = torch.where((ld >= 2) & (packed[:, :, M:2 * M] >= 0), ld - 1, 0)
    rl = torch.minimum(packed[:, :, 6 * M + 3].long(), rem)
    edges = int(pairs.sum()) + int(torch.where(rl >= 2, rl - 1, 0).sum())
    live = int((rem > 0).sum())
    n_bytes = packed.numel() * 4 + lens.numel() * 4 + 2 * L * (N + 1) * 4
    return n_bytes, 60 * live + 6 * edges


def token_cut(t_pos, t_len, t_valid, at, sizes):
    """Each lane's end of its first token that reaches `at` bytes (the
    whole block where none does): sizes a stream stops at cleanly.
    Returns (L,) int32 on the tokens' device."""
    import torch

    ends = t_pos + t_len
    past = t_valid & (ends >= at)
    first = past.int().argmax(dim=1, keepdim=True)
    full = torch.tensor(sizes, device=t_pos.device)
    return torch.where(past.any(dim=1), ends.gather(1, first)[:, 0],
                       full).to(torch.int32)


def classify_work(rows):
    """(bytes, operations) of the classify carry on these token rows (T,
    N): dist and valid read once over every row, len once over each
    lane's steps up to its last valid token (the only rows the carry
    reads it on), and case, state and r0 written once over every row.
    No operations are counted: the bound is the bytes'."""
    dist, _, valid = rows
    T, N = dist.shape
    steps = int(lane_steps(valid).sum()) if T else 0
    return T * N * (4 + 1 + 3 * 4) + 4 * steps, 0


def classify_moved(rows):
    """A model of the bytes K6's design moves on these rows, not a
    measurement: its three passes over the rows read dist and valid, then
    dist, len and valid, then dist, len and valid again and write case,
    state and r0 (35 B a row), and its scratch (the tiles' and chunks'
    lists and maps) counts as written once and read once, which leaves out
    the lane scans' rewrite of the tiles' lists and maps and the later
    grids' second reads of them.  Logged only, beside the bound."""
    from lzma_tpu_torch.ops.cuda_classify import scratch_bytes

    T, N = rows[0].shape
    return T * N * 35 + 2 * scratch_bytes(T, N)


def lane_steps(valid):
    """Each lane's 1 + index of its last valid token row (0 where none):
    (N,) int64 on valid's device."""
    import torch

    pos = torch.arange(1, valid.shape[0] + 1, device=valid.device)[:, None]
    return (valid * pos).amax(dim=0)


def check_classify(rows, kept=None):
    """K6 against _classify_carry on the same card rows (tolerance zero).
    Returns (max |diff| over case, state and r0, plain version's ms); the
    plain carry goes into `kept` (a dict, under "carry") where one is
    given, for K19's check on the same tokens."""
    from lzma_tpu_torch.ops.cuda_classify import classify_carry_cuda
    from lzma_tpu_torch.ops.device_encoder import _classify_carry

    box = {}
    plain_ms = wall_ms(lambda: box.update(p=_classify_carry(*rows)))
    err = max(int((k.long() - p.long()).abs().max()) if k.numel() else 0
              for k, p in zip(classify_carry_cuda(*rows), box["p"]))
    if err:
        raise AssertionError(f"classify carry differs from the plain version "
                             f"by {err}")
    if kept is not None:
        kept["carry"] = box["p"]
    return err, plain_ms


def check_classify_tokens(args, got=None, carry=None):
    """K19 against its plain version on the same card tensors (tolerance
    zero; dtypes and shapes equal): classify_tokens_cuda(*args), or `got`
    where its output is given, against _classify_tokens_plain(*args) or,
    where `carry` (the plain carry of these tokens' rows, check_classify's)
    is given, against _classify_finish on it, so that the plain carry runs
    once.  Returns (max |diff| over the seven planes, the plain version's
    ms: the finish's alone where the carry was given)."""
    from lzma_tpu_torch.ops.cuda_classify import classify_tokens_cuda
    from lzma_tpu_torch.ops.device_encoder import (_classify_finish,
                                                   _classify_tokens_plain)

    box = {}
    if carry is None:
        plain_ms = wall_ms(lambda: box.update(p=_classify_tokens_plain(*args)))
    else:
        plain_ms = wall_ms(lambda: box.update(p=_classify_finish(
            args[0], args[1], args[3], carry)))
    got = classify_tokens_cuda(*args) if got is None else got
    if [(g.dtype, g.shape) for g in got] != [(p.dtype, p.shape)
                                             for p in box["p"]]:
        raise AssertionError("classify_tokens: the kernel's planes' dtypes or "
                             "shapes differ from the plain version's")
    err = max(int((g - p).abs().max()) if g.numel() else 0
              for g, p in zip(got, box["p"]))
    if err:
        raise AssertionError(f"classify_tokens differs from the plain version "
                             f"by {err}")
    return err, plain_ms


def lower_work(args, totals):
    """(bytes, operations) of the lowering on these arguments
    (lower_tokens_cuda's) with these totals: t_valid read over every
    token slot and the ten int64 planes (the meta, t_pos, t_len, t_dist)
    over each valid token, the only ones read there; ctx and bits written
    over every slot of every lane and total once.  Operations: 60 integer
    operations a valid token for its geometry and 10 a (ctx, bit) pair,
    a count of the closed forms' arithmetic (the scans are not counted)."""
    meta, t_pos, t_len, t_dist, t_valid = args[:5]
    N, T = t_pos.shape
    n_valid = int(t_valid.sum())
    planes = (*meta, t_pos, t_len, t_dist)
    n_read = N * T * t_valid.element_size() + n_valid * sum(
        p.element_size() for p in planes)
    n_write = 2 * 4 * N * args[8] + 4 * N
    return n_read + n_write, 60 * n_valid + 10 * int(totals.sum())


def lower_cut(args, at, pad=False):
    """The lowering's arguments cut to the token columns `at` (a slice);
    `pad` doubles the width with invalid columns, so that the long
    tokens of a cut of valid ones fit the compacted buffer (T // 2 + 2)
    as they fit a whole lane's.  max_bits is the whole call's or, where
    smaller, MAXB bits a token slot (every token fits)."""
    import torch
    from lzma_tpu_torch.ops.device_encoder import MAXB

    meta, t_pos, t_len, t_dist, t_valid, lc, lp, pb, max_bits, base = args
    planes = [x[:, at] for x in (*meta, t_pos, t_len, t_dist, t_valid)]
    if pad:
        planes = [torch.cat([x, torch.zeros_like(x)], dim=1) for x in planes]
    width = planes[0].shape[1]
    return (tuple(planes[:7]), *planes[7:], lc, lp, pb,
            min(max_bits, MAXB * width + 128), base)


def check_lower(args):
    """K7 against _lower_tokens_plain on the same card tensors (tolerance
    zero).  Returns (max |diff| over ctx, bits and total, plain version's
    ms)."""
    from lzma_tpu_torch.ops.cuda_lower import lower_tokens_cuda
    from lzma_tpu_torch.ops.device_encoder import _lower_tokens_plain

    box = {}
    plain_ms = wall_ms(lambda: box.update(p=_lower_tokens_plain(*args)))
    err = max(int((k.long() - p.long()).abs().max()) if k.numel() else 0
              for k, p in zip(lower_tokens_cuda(*args), box["p"]))
    if err:
        raise AssertionError(f"lower differs from the plain version by {err}")
    return err, plain_ms


def count_work(args, totals):
    """(bytes, operations) of the slot counts on these arguments
    (lower_counts_cuda's) with these totals: t_valid read over every
    token slot and the ten int64 planes over each valid token, n and n1
    written once over every slot of every lane and total once.
    Operations: 60 integer operations a valid token for its geometry and
    10 a pair, as lower_work counts them (the histogram's adds are not
    counted)."""
    from lzma_tpu_torch.core.layout import ProbLayout

    meta, t_pos, t_len, t_dist, t_valid, lc, lp, pb = args[:8]
    N, T = t_pos.shape
    n_valid = int(t_valid.sum())
    planes = (*meta, t_pos, t_len, t_dist)
    n_read = N * T * t_valid.element_size() + n_valid * sum(
        p.element_size() for p in planes)
    n_write = 2 * 4 * N * ProbLayout(lc, lp, pb, pos_bits=pb).size + 4 * N
    return n_read + n_write, 60 * n_valid + 10 * int(totals.sum())


def check_counts(args):
    """K8 against _lower_counts_plain on the same card tensors (tolerance
    zero).  Returns (max |diff| over n, n1 and total, plain version's
    ms)."""
    from lzma_tpu_torch.ops.cuda_lower import lower_counts_cuda
    from lzma_tpu_torch.ops.device_encoder import _lower_counts_plain

    box = {}
    plain_ms = wall_ms(lambda: box.update(p=_lower_counts_plain(*args)))
    err = max(int((k.long() - p.long()).abs().max()) if k.numel() else 0
              for k, p in zip(lower_counts_cuda(*args), box["p"]))
    if err:
        raise AssertionError(f"lower_counts differs from the plain version "
                             f"by {err}")
    return err, plain_ms


def literal_args(data, lc, lp, pb):
    """lower_counts_cuda's arguments for lanes of literals only, a token a
    byte of `data` ((N, n) uint8 on the card), classified by the port's
    classify_tokens: every pair lands on is_match and the literal trees,
    the hot slots."""
    import torch
    from lzma_tpu_torch.ops.device_encoder import classify_tokens

    N, n = data.shape
    t_pos = torch.arange(n, device=data.device).expand(N, n).contiguous()
    t_len = torch.ones_like(t_pos)
    t_dist = torch.full_like(t_pos, -1)
    t_valid = torch.ones_like(t_pos, dtype=torch.bool)
    meta = classify_tokens(data, t_pos, t_len, t_dist, t_valid)
    return (tuple(m.long() for m in meta), t_pos, t_len, t_dist, t_valid, lc,
            lp, pb, 10 * n + 128, 0)


#: the search's kernels: name -> (cuda_search wrapper, device_matcher plain
#: version)
SEARCH_KERNELS = {"search_keys": ("search_keys_cuda", "_search_keys_plain"),
                  "suffix_table": ("suffix_table_cuda", "_suffix_table_plain"),
                  "match_lists": ("match_lists_cuda", "_match_lists_plain")}
#: each search kernel's TPU-side counterpart (file:line), the jitted JAX
#: code it restates, and its design
_JIT = ("under jax.jit at lzma_tpu/ops/device_parser.py:1595 "
        "(tokenize_optimal) and lzma_tpu/ops/device_matcher.py:550 "
        "(find_match_lists_rmq)")
SEARCH_REPLACES = {
    "search_keys": (
        "lzma_tpu/ops/device_matcher.py:309",
        "lzma_tpu/ops/device_matcher.py:309-342 (_tier_candidates' hashes) "
        "and :436-448 (_suffix_rank_lcp's prefix words), " + _JIT,
        "a thread a position, the block's bytes staged in shared memory"),
    "suffix_table": (
        "lzma_tpu/ops/device_matcher.py:420",
        "lzma_tpu/ops/device_matcher.py:420-525 (_suffix_rank_lcp after its "
        "lexsort), " + _JIT,
        "rank and T[0] a thread a place, its window staged as 32-bit words "
        "(16-byte aligned loads and a funnel shift); levels 1-11 in 2,048-place "
        "tiles of shared memory; the wider levels by column stripes in "
        "shared memory where max_n is a multiple of 2,048 (each written "
        "once), else a pass a level (cuda_search.upper_route)"),
    "match_lists": (
        "lzma_tpu/ops/device_matcher.py:578",
        "lzma_tpu/ops/device_matcher.py:286-306 (_neighbor_candidates), "
        ":578-681 (_rmq_search's dedup, cap and merge), :528-547 "
        "(_lcp_query), " + _JIT,
        "each tier's inverse words (a place, and packed above it the run "
        "of equal keys before it); then a thread a position: its "
        "candidate row in shared memory, tier by tier, the dedup and cap "
        "in registers (a dists row past 32), two table reads a candidate, "
        "the merge into the block's lens and dists rows staged in shared "
        "memory, copied out coalesced"),
}
#: the search's cases at the small shapes: (fb, tier ks or None for
#: DP_TIERS, m_cap, m_cap_order)
SEARCH_CASES = [(5, None, 12, "rr"), (32, None, 12, "rr"),
                (273, None, 12, "rr"), (32, "hybrid", 0, "near"),
                (32, None, 12, "near")]


def _fresh(args):
    """`args` with each list copied (K11 empties the lists it is given)."""
    return tuple(list(a) if isinstance(a, list) else a for a in args)


def spied_search(fn):
    """fn() (a call that reaches device_matcher._rmq_search or
    _suffix_rank_lcp) with the search kernels' wrappers spied.  Returns
    (fn's result, {kernel: (its arguments, its result)}), the last call
    of each."""
    from lzma_tpu_torch.ops import cuda_search

    seen = {}
    kept = {k: getattr(cuda_search, w) for k, (w, _) in SEARCH_KERNELS.items()}

    def spy(name, wrapper):
        def call(*args):
            copied = _fresh(args)
            out = wrapper(*args)
            seen[name] = (copied, _fresh(out))   # the route empties lists
            return out
        return call

    for k, (w, _) in SEARCH_KERNELS.items():
        setattr(cuda_search, w, spy(k, kept[k]))
    try:
        out = fn()
    finally:
        for k, (w, _) in SEARCH_KERNELS.items():
            setattr(cuda_search, w, kept[k])
    return out, seen


def _flat(out):
    return [t for x in out for t in (x if isinstance(x, list) else [x])]


def check_search(seen):
    """Each spied search kernel against its plain version on the same card
    tensors (tolerance zero; dtypes and shapes equal).  Returns ({kernel:
    max |diff|}, {kernel: plain version's ms})."""
    from lzma_tpu_torch.ops import device_matcher

    errs, plain_ms = {}, {}
    for name, (args, got) in seen.items():
        plain = getattr(device_matcher, SEARCH_KERNELS[name][1])
        box = {}
        plain_ms[name] = wall_ms(lambda: box.update(p=plain(*_fresh(args))))
        g, w = _flat(got), _flat(box["p"])
        if [(t.dtype, t.shape) for t in g] != [(t.dtype, t.shape) for t in w]:
            raise AssertionError(f"{name}: outputs {[(t.dtype, t.shape) for t in g]}"
                                 f" against the plain {[(t.dtype, t.shape) for t in w]}")
        errs[name] = max([int((a.long() - b.long()).abs().max()) if a.numel()
                          else 0 for a, b in zip(g, w)] + [0])
        if errs[name]:
            raise AssertionError(f"{name} differs from its plain version by "
                                 f"{errs[name]}")
        del box
    return errs, plain_ms


def search_work(seen):
    """(bytes, operations) a search kernel's call must move and do, by
    kernel, from its spied arguments and results.  K9: each lane byte read
    and each key written; 8 operations a byte of the suffix words, 3 a
    hashed byte of the widest span, 2 a key.  K10: the order read, each
    lane byte read where the LCP is compared (else the given LCP), rank
    and every table level written; an operation a level and 8 a prefix
    word a place.  K11: each used tier's sort values and indices and rank
    read, two table entries a kept pair (what the lists need of the
    table), lens, dists and counts written; 12 operations a candidate
    column, 2 a list slot a column, 20 a kept pair."""
    out = {}
    if "search_keys" in seen:
        (data, n, depth, spans), (suffix, tiers) = seen["search_keys"]
        P = data.numel()
        keys = sum(t.numel() * t.element_size() for t in suffix + tiers)
        nw = -(-depth // 4) if depth <= 32 else 0
        out["search_keys"] = (P + n.numel() * 8 + keys,
                              P * (8 * 4 * nw + 3 * max([0, *spans])
                                   + 2 * (len(suffix) + len(tiers))))
    if "suffix_table" in seen:
        (data, n, order, depth, *given), (rank, T) = seen["suffix_table"]
        cl = given[0] if given else None
        P = order.numel()
        lcp_in = P * 8 if cl is not None else data.numel()
        nw = 0 if cl is not None else -(-min(depth, 32) // 4)
        out["suffix_table"] = (P * 8 + lcp_in + rank.numel() * 8
                               + T.numel() * 4,
                               T.numel() + 8 * nw * P)
    if "match_lists" in seen:
        (sk, so, ranks, rank, T, n, *_), (lens, dists, counts) = \
            seen["match_lists"]
        P = rank.numel()
        pairs = int(counts.sum())
        M = sum(len(r) for _, r in ranks)
        read = sum(t.numel() * t.element_size() for t in sk + so) + P * 8
        out["match_lists"] = (read + 8 * pairs + lens.numel() * 16 + P * 8,
                              P * M * (12 + 2 * lens.shape[2]) + 20 * pairs)
    return out


#: the price model's, the DP rows' and the path's kernels (ops/cuda_model.py,
#: ops/cuda_inputs.py, ops/cuda_path.py): K18 price_model, K12 dp_inputs, K13
#: path_mark, K14 path_compact; and the optimal round's last op chains:
#: K19 classify_tokens (ops/cuda_classify.py), K20 rep0_trace
#: (ops/cuda_inputs.py), K21 list_pairs (ops/cuda_search.py); each
#: kernel's wrappers -> (the wrapper's module, its plain version's module
#: and name)
ROW_KERNELS = {
    "price_model": {"price_model_cuda": ("cuda_model", "device_parser",
                                         "_price_model_plain")},
    "dp_inputs": {"dp_inputs_cuda": ("cuda_inputs", "device_parser",
                                     "_dp_inputs_plain")},
    "path_mark": {"extract_mark_cuda": ("cuda_path", "device_parser",
                                        "_extract_mark"),
                  "greedy_mark_cuda": ("cuda_path", "device_matcher",
                                       "_greedy_mark")},
    "path_compact": {"extract_compact_cuda": ("cuda_path", "device_parser",
                                              "_extract_compact"),
                     "greedy_compact_cuda": ("cuda_path", "device_matcher",
                                             "_compact_taken")},
    "classify_tokens": {"classify_tokens_cuda": ("cuda_classify",
                                                 "device_encoder",
                                                 "_classify_tokens_plain")},
    "rep0_trace": {"rep0_trace_cuda": ("cuda_inputs", "device_parser",
                                       "rep0_trace")},
    "list_pairs": {"list_pairs_cuda": ("cuda_search", "device_parser",
                                       "_list_pairs_plain")},
}
#: each of them: its source under lzma_tpu_torch/csrc, without ".cu"
ROW_SOURCES = {"price_model": "price_model", "dp_inputs": "dp_inputs",
               "path_mark": "path", "path_compact": "path",
               "classify_tokens": "classify", "rep0_trace": "rep0",
               "list_pairs": "search"}
#: K19-K21: each kernel's wrapper, the call its record's ms times and the
#: main8M-opt stage it runs in
ROUND_WRAPPERS = {"classify_tokens": "classify_tokens_cuda",
                  "rep0_trace": "rep0_trace_cuda",
                  "list_pairs": "list_pairs_cuda"}
ROUND_MS_OF = {
    "classify_tokens": "main8M-opt's last call (the final tokens)",
    "rep0_trace": "main8M-opt's last round",
    "list_pairs": "main8M-opt's one call (the search's lists)"}
ROUND_STAGES = {"classify_tokens": "classify", "rep0_trace": "rep0_trace",
                "list_pairs": "select_pairs"}
#: K13's and K14's wrappers: the DP path's, then the lazy path's
PATH_WRAPPERS = ("extract_mark_cuda", "greedy_mark_cuda",
                 "extract_compact_cuda", "greedy_compact_cuda")
#: each of them: its TPU-side counterpart (file:line), the jitted JAX code
#: it restates, its design
_JIT_OPT = "under jax.jit at lzma_tpu/ops/device_parser.py:1595 (tokenize_optimal)"
ROW_REPLACES = {
    "price_model": (
        "lzma_tpu/ops/device_parser.py:154",
        "no pallas_call: jitted empirical_probs/build_price_model, "
        "lzma_tpu/ops/device_parser.py:88-108 (empirical_probs' arithmetic "
        "after its scatter-adds), :154-269 (build_price_model: EP0, EP1, the "
        "length tables, pos_slot, dfull, align, the flag tables, rep_sel), "
        "called at :1671 and :1676, " + _JIT_OPT,
        "one launch of two block ranges: a block a lane prices the slots "
        "before its literal coders from n and n1 into shared memory, then a "
        "thread a table entry walks its bit tree there (the fb - 1 length "
        "columns the row keeps), the distance tables and the DP row written "
        "coalesced; the other blocks walk the planes, four slots a thread "
        "from 16-byte loads of n, n1 and 16-byte stores of EP0, EP1; each "
        "block builds the 512-entry price table in shared memory"),
    "dp_inputs": (
        "lzma_tpu/ops/device_parser.py:774",
        "lzma_tpu/ops/device_parser.py:154 (build_price_model's lit_cost), "
        ":1500 (matched_lit_cost), :272 (_pair_dist_cost), :774 "
        "(_pack_inputs); lzma_tpu/ops/device_matcher.py:684 "
        "(rep_match_lens_rmq, _lcp_query :528), " + _JIT_OPT,
        "a grid of two blocks an SM walking chunks of 2,048 positions, "
        "the SM's shared memory carved to what they need (the rest L1); "
        "the distance tables staged, the literal slots read through L1; a "
        "thread a position, its rep0 reads issued before its prices, its "
        "int32 row staged in shared memory, the tile's rows written as "
        "16-byte words"),
    "path_mark": (
        "lzma_tpu/ops/device_parser.py:1417",
        "lzma_tpu/ops/device_parser.py:1417 (extract_tokens' pointer "
        "doubling), lzma_tpu/ops/device_matcher.py:217 (greedy_path), "
        + _JIT_OPT + " and in device_matcher.tokenize",
        "tiles of 4,096 nodes, a warp a segment of 512 going up it in "
        "windows of 32 (a pointer into its own window by shuffle jumps): "
        "each tile's door map, where the walk leaves it from each of the "
        "288 nodes it can enter by, 288 ints in device memory, and each "
        "segment's door exits; the maps "
        "composed along the lane in shared memory (in groups of 128 tiles "
        "past 128) to each tile's entry; each entered tile finds its "
        "segments' entries from the segment door exits kept by the first "
        "grid and a lane walks each segment; status flags in mapped pinned "
        "host memory, read after the stream's synchronise"),
    "path_compact": (
        "lzma_tpu/ops/device_parser.py:1417",
        "lzma_tpu/ops/device_parser.py:1417 (extract_tokens' compaction), "
        "lzma_tpu/ops/device_matcher.py:269 (_compact), " + _JIT_OPT
        + " and in device_matcher.tokenize",
        "one grid: tiles of 4,096 slots take tickets in lane-major order, "
        "count their marks from 16-byte chunks, find their first slot by "
        "decoupled look-back (a warp reads 32 predecessors), stage their "
        "tokens in shared memory a plane at a time and write each plane's "
        "run as 16-byte stores; each block then fills the previous lane's "
        "slots of its range (t_valid, and (0, 1, -1) past that lane's "
        "count) as 16-byte stores, extra blocks the last lane's"),
    "classify_tokens": (
        "lzma_tpu/ops/device_encoder.py:85",
        "no pallas_call: jitted classify_tokens (its lax.scan and the "
        "gathers around it), lzma_tpu/ops/device_encoder.py:85 (@jax.jit "
        "at :84), called under jax.jit at lzma_tpu/ops/device_parser.py:1595 "
        "(tokenize_optimal's rounds) and at device_encoder.py:684",
        "K6's five grids in one call, the scans reading the (N, T) token "
        "planes through their strides (a lane's run of rows staged "
        "coalesced), the last grid's rescan writing the seven int64 planes "
        "from shared memory, a thread a token, consecutive rows a warp"),
    "rep0_trace": (
        "lzma_tpu/ops/device_parser.py:1458",
        "no pallas_call: jitted rep0_trace, lzma_tpu/ops/device_parser.py:"
        "1458, called at :1672, " + _JIT_OPT,
        "a fill from the token side, three grids: each tile of 2,048 token "
        "slots summed (rep0.cuh's Agg: first and last valid place, last "
        "match), a lane scan of the tiles, then each tile's slots' places "
        "and rep0s in shared memory and the positions between the prefix's "
        "place and the tile's filled by a binary search, 8-byte coalesced "
        "stores; a status word for valid tokens out of order"),
    "list_pairs": (
        "lzma_tpu/ops/device_parser.py:1529",
        "no pallas_call: jitted _select_dp_pairs, lzma_tpu/ops/"
        "device_parser.py:1529 (called at :1639), and the head of "
        "_seed_from_lists, :1551 (called at :1658), " + _JIT_OPT,
        "a thread a position: its count, its lists' first M_DP entries and "
        "their last read once, the DP pairs written as 16-byte words and "
        "the seed's pair as 8-byte ones"),
}


def _row_module(name):
    import importlib

    return importlib.import_module(f"lzma_tpu_torch.ops.{name}")


def spied_rows(fn):
    """fn() with the wrappers of K18, K12, K13 and K14 spied.  Returns (fn's
    result, {wrapper: (its arguments, its result)}), the last call of
    each."""
    seen = {}
    kept = {}
    for wrappers in ROW_KERNELS.values():
        for w, (mod, _, _) in wrappers.items():
            kept[w] = (_row_module(mod), getattr(_row_module(mod), w))

    def spy(name, wrapper):
        def call(*args, **kw):
            out = wrapper(*args, **kw)
            seen[name] = ((*args, *kw.values()), out)
            return out
        return call

    for w, (mod, wrapper) in kept.items():
        setattr(mod, w, spy(w, wrapper))
    try:
        out = fn()
    finally:
        for w, (mod, wrapper) in kept.items():
            setattr(mod, w, wrapper)
    return out, seen


def row_kernel(wrapper):
    """The kernel (a ROW_KERNELS key) a wrapper launches."""
    return next(k for k, ws in ROW_KERNELS.items() if wrapper in ws)


def check_rows(seen):
    """Each spied wrapper's call against its plain version on the same card
    tensors (tolerance zero; dtypes and shapes equal).  Returns ({kernel:
    max |diff|}, {wrapper: plain version's ms})."""
    errs, plain_ms = {}, {}
    for w, (args, got) in seen.items():
        _, mod, name = ROW_KERNELS[row_kernel(w)][w]
        plain = getattr(_row_module(mod), name)
        box = {}
        plain_ms[w] = wall_ms(lambda: box.update(p=plain(*args)))
        g = got if isinstance(got, tuple) else (got,)
        p = box["p"] if isinstance(box["p"], tuple) else (box["p"],)
        if [(t.dtype, t.shape) for t in g] != [(t.dtype, t.shape) for t in p]:
            raise AssertionError(f"{w}: outputs {[(t.dtype, t.shape) for t in g]}"
                                 f" against the plain {[(t.dtype, t.shape) for t in p]}")
        err = max([int((a.long() - b.long()).abs().max()) if a.numel() else 0
                   for a, b in zip(g, p)] + [0])
        if err:
            raise AssertionError(f"{w} differs from its plain version by {err}")
        k = row_kernel(w)
        errs[k] = max(errs.get(k, 0), err)
        del box
    return errs, plain_ms


def row_work(wrapper, args, out):
    """(bytes, operations) a K12-K14 or K18-K21 call must move and do, from
    its arguments and result.  K19: t_pos, t_dist and t_valid read over
    every slot (17 B; an invalid token has its case and bytes too), t_len
    over each valid token (the only ones whose state it moves), a
    token's three bytes of data (at most the data's size) and the seven
    int64 planes written (56 B a slot); K20: t_valid read over every slot,
    t_pos and t_dist over each valid token (16 B; an invalid one moves
    nothing), r0pos written (8 B a position); K21: a position's count and its lists' first M_DP entries
    read (8 + 64 B), the last entries past them where the list is deeper
    (16 B), the DP pairs and the seed's pair written (80 B).  No
    operations are counted for K19-K21: their bytes bound them.  K18: n and n1 read and the planes written once
    (16 B a slot), the distance tables and the row written once (4 B an
    entry); 12 operations a slot (the probability and its two prices),
    24 a table entry (a walk of up to 8 levels at 3).  K12: each row written (4C B), data, ld, dd,
    r0pos and rank read once a position, two table entries and the
    source's rank a position whose rep0 source is in the block, both
    planes' literal slots and the distance tables once a lane; 16 steps
    of the literal walks at 4 operations, 4M distance prices at 8 and 20
    for the rest, a position.  K13: the pointers read once (int32 from,
    or int64 adv) and the marks written once; 2 operations a node.
    K14: the marks read once, the two values a marked node's token is
    made of (from and choice, or best_len, best_dist and take) read once,
    the three token planes, t_valid and ntok written once; 4 operations
    a node."""
    import torch
    from lzma_tpu_torch.core.layout import ProbLayout
    from lzma_tpu_torch.ops.cuda_inputs import lit_slots

    if wrapper == "classify_tokens_cuda":
        data, t_pos, t_valid = args[0], args[1], args[4]
        slots = t_pos.numel()
        return (17 * slots + 8 * int(t_valid.sum())
                + min(3 * slots, data.numel()) + 56 * slots, 0)
    if wrapper == "rep0_trace_cuda":
        t_pos, _, t_valid, n_pos = args
        return (t_pos.numel() + 16 * int(t_valid.sum())
                + 8 * t_pos.shape[0] * n_pos, 0)
    if wrapper == "list_pairs_cuda":
        counts = args[2]
        deeper = int((counts > out[0].shape[2]).sum())
        return 152 * counts.numel() + 16 * deeper, 0
    if wrapper == "price_model_cuda":
        slots = args[0].numel()
        entries = sum(t.numel() for t in out[2:])
        return 16 * slots + 4 * entries, 12 * slots + 24 * entries
    if wrapper == "dp_inputs_cuda":
        data, ld, dd, r0pos, suffix, lens, planes, tables, lc, lp, pb, _ = args
        L, N, M = ld.shape
        pos = torch.arange(N, device=data.device)
        inside = int(((pos - r0pos.long() - 1) >= 0).sum())
        read = (L * N * (1 + 16 * M + 8 + 8) + 16 * inside
                + L * (2 * 4 * lit_slots(lc, lp) + 4 * 784 + 8))
        return out.numel() * 4 + read, L * N * (64 + 32 * M + 20)
    if wrapper.endswith("_mark_cuda"):
        ptr = args[0]
        return ptr.numel() * ptr.element_size() + out.numel(), 2 * ptr.numel()
    mark = args[2] if wrapper == "extract_compact_cuda" else args[3]
    marked = int(mark.sum())
    per = 8 if wrapper == "extract_compact_cuda" else 17
    return (mark.numel() + per * marked + 25 * mark.numel()
            + 8 * mark.shape[0], 4 * mark.numel())


#: the lazy search's kernels (ops/cuda_lazy.py): name -> (wrapper, plain
#: version in device_matcher)
LAZY_KERNELS = {"doubling_groups": ("doubling_groups_cuda",
                                    "_doubling_groups_plain"),
                "descent_lcp": ("descent_lcp_cuda", "_descent_lcp_plain"),
                "best_matches": ("best_matches_cuda", "_best_matches_plain")}
#: each lazy kernel's TPU-side counterpart (file:line), the jitted JAX code
#: it restates, and its design
_JIT_LAZY = ("under jax.jit at lzma_tpu/ops/device_matcher.py:151 "
             "(find_best_matches_rmq, under jax.vmap in device_encoder) and "
             "inside _rmq_search past fb 32")
LAZY_REPLACES = {
    "doubling_groups": (
        "lzma_tpu/ops/device_matcher.py:465",
        "lzma_tpu/ops/device_matcher.py:465-490 (_suffix_rank_lcp's prefix "
        "doubling: newg, cumsum, the scatter to order, the next lexsort's "
        "keys), " + _JIT_LAZY,
        "two grids a level: grid A a block a tile of 512 places (tickets in "
        "lane-major order), each thread's flag against the place before "
        "(the 32-byte level's marked words from 16-byte loads, shuffled "
        "from the lane below; a doubling level's sorted key, read "
        "coalesced, no read of the previous ids), the block's scan, a "
        "decoupled look-back along the lane for the tile's first id, the "
        "ids scattered to their positions; grid B the next key a thread a "
        "place; 32-bit places, every wrap a conditional subtract"),
    "descent_lcp": (
        "lzma_tpu/ops/device_matcher.py:491",
        "lzma_tpu/ops/device_matcher.py:491-518 (the binary descent and the "
        "<=32-byte refinement), " + _JIT_LAZY,
        "a thread a sorted place: in a lane past 508 places the two "
        "suffixes' first 32-byte windows as words (16-byte loads and a "
        "funnel shift) and, where they differ, their LCP with no id read; "
        "else two ids a level, then the two windows at the descent's "
        "length as words (byte by byte, each index wrapped once and "
        "clamped, only where a word's index reaches 2 max_n); 32-bit "
        "indices"),
    "best_matches": (
        "lzma_tpu/ops/device_matcher.py:171",
        "lzma_tpu/ops/device_matcher.py:171-213 (find_best_matches_rmq after "
        "its lexsort), :528 (_lcp_query), " + _JIT_LAZY,
        "a block a tile of 256 places of the hash key's sort and the k "
        "before it, their keys, positions and the positions' ranks staged "
        "in shared memory (a rank read once a place), then a thread a "
        "place: its run of equal keys up to k back, two table entries a "
        "candidate in the window, one pass of the selection, the pair "
        "written at its position"),
}


def _to(dev, obj):
    """obj with every tensor in it (dicts, tuples, lists) moved to
    `dev`."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, dict):
        return {k: _to(dev, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to(dev, x) for x in obj)
    return obj


def spied_lazy(fn):
    """fn() (a call that reaches device_matcher._suffix_rank_lcp past
    depth 32 or find_best_matches_rmq) with the lazy kernels' wrappers
    spied.  Returns (fn's result, {kernel: [(its arguments, its result)
    a call]}); the arguments are every parameter of the wrapper by
    position, defaults filled in (K15's sorted_key, which the route
    passes by name, last)."""
    import inspect

    from lzma_tpu_torch.ops import cuda_lazy

    seen = {}
    kept = {k: getattr(cuda_lazy, w) for k, (w, _) in LAZY_KERNELS.items()}

    def spy(name, wrapper):
        sig = inspect.signature(wrapper)

        def call(*args, **kw):
            out = wrapper(*args, **kw)
            bound = sig.bind(*args, **kw)
            bound.apply_defaults()
            seen.setdefault(name, []).append((bound.args, out))
            return out
        return call

    for k, (w, _) in LAZY_KERNELS.items():
        setattr(cuda_lazy, w, spy(k, kept[k]))
    try:
        out = fn()
    finally:
        for k, (w, _) in LAZY_KERNELS.items():
            setattr(cuda_lazy, w, kept[k])
    return out, seen


def check_lazy(seen):
    """Every spied lazy kernel call against its plain version on the same
    card tensors (tolerance zero; dtypes and shapes equal).  Returns
    ({kernel: max |diff|}, {kernel: the plain versions' ms, summed over
    its calls})."""
    from lzma_tpu_torch.ops import device_matcher

    errs, plain_ms = {}, {}
    for name, calls in seen.items():
        plain = getattr(device_matcher, LAZY_KERNELS[name][1])
        errs[name], plain_ms[name] = 0, 0.0
        for args, got in calls:
            box = {}
            plain_ms[name] += wall_ms(lambda: box.update(p=plain(*args)))
            g = [t for t in (got if isinstance(got, tuple) else (got,))
                 if t is not None]
            w = [t for t in (box["p"] if isinstance(box["p"], tuple)
                             else (box["p"],)) if t is not None]
            if [(t.dtype, t.shape) for t in g] != [(t.dtype, t.shape) for t in w]:
                raise AssertionError(
                    f"{name}: outputs {[(t.dtype, t.shape) for t in g]} against "
                    f"the plain {[(t.dtype, t.shape) for t in w]}")
            err = max([int((a - b).abs().max()) if a.numel() else 0
                       for a, b in zip(g, w)] + [0])
            if err:
                raise AssertionError(f"{name} differs from its plain version "
                                     f"by {err}")
            del box
    return errs, plain_ms


def lazy_work(name, args, out):
    """(bytes, operations) a lazy kernel's call must move and do, from its
    arguments and result.  K15: the order read, the lane's bytes at the
    32-byte level (else the previous level's ids) read once, the ids and
    the next key written; 8 operations a word compare (8 words) or 12 a
    pair of ids, and 8 for the scan and the scatter, a place.  K16: the
    order and the lane's bytes read once, the LCP written, and of the
    levels it descends the two ids a level only of the places whose
    consecutive LCP is 32 or more (elsewhere the first 32-byte keys
    differ, and with them every level's ids; lanes of at most 508 places
    descend at every place), at most each level once; 80 operations a
    place (its refinement's words) and 6 a level descended.
    K17: the sort's values and indices and rank read once, two table
    entries a candidate in the window, the pair written; 6 operations a
    candidate looked at and 20 a candidate in the window."""
    import torch
    from lzma_tpu_torch.ops import cuda_lazy, device_matcher

    if name == "doubling_groups":
        order, data, n, g = args[:4]
        P = order.numel()
        src = data.numel() if g is None else g.numel() * 8
        written = sum(t.numel() * 8 for t in out if t is not None)
        return (P * 8 + src + n.numel() * 8 + written,
                P * ((64 if g is None else 12) + 8))
    if name == "descent_lcp":
        order, grps, data, n, _ = args
        P = order.numel()
        levels = len(grps) - 1
        need = (P if data.shape[1] <= cuda_lazy.WIDE_LANE
                else int((out >= 32).sum()))
        return (P * 8 + min(P, 2 * need) * 8 * levels + data.numel()
                + n.numel() * 8 + out.numel() * 8,
                P * 80 + need * 6 * levels)
    sorted_key, order, rank, T, n, dict_size, _, k = args
    P = order.numel()
    cand = torch.stack(device_matcher._neighbor_step(
        sorted_key, order, device_matcher._ranks(k)), dim=2)
    pos = torch.arange(order.shape[1], device=order.device)[None, :, None]
    inside = int(((cand >= 0) & (pos - cand <= dict_size)
                  & (cand < pos)).sum())
    del cand
    return (P * (4 + 8 + 8) + n.numel() * 8 + 8 * inside
            + sum(t.numel() * 8 for t in out), P * 6 * k + 20 * inside)


def lazy_times(seen):
    """Each spied lazy kernel call (spied_lazy's) timed alone by CUDA
    events, and each kernel's calls' work summed with its bound.  Returns
    ({kernel: [ms a call]}, {kernel: ((bytes, operations), bound)})."""
    from lzma_tpu_torch.ops import cuda_lazy
    from lzma_tpu_torch.probes._cuda import event_ms

    times, bounds = {}, {}
    for name, calls in seen.items():
        wrapper = getattr(cuda_lazy, LAZY_KERNELS[name][0])
        times[name] = [event_ms(lambda a=a: wrapper(*a), 3) for a, _ in calls]
        work = [lazy_work(name, a, o) for a, o in calls]
        work = (sum(w[0] for w in work), sum(w[1] for w in work))
        bounds[name] = (work, bound(*work))
    return times, bounds


def counters():
    """The kernels whose launches a main-path run counts, by name: K3
    dp_parse, K6 classify, K7 lower, K8 lower_counts, K2 rc_serialize, K1
    ring_decode, K9 search_keys, K10 suffix_table, K11 match_lists, K12
    dp_inputs, K13 path_mark, K14 path_compact, K15 doubling_groups, K16
    descent_lcp, K17 best_matches, K18 price_model, K19 classify_tokens,
    K20 rep0_trace, K21 list_pairs; each the (module, attribute) of its
    wrapper's count."""
    from lzma_tpu_torch.ops import (cuda_classify, cuda_inputs, cuda_lazy,
                                    cuda_lower, cuda_model, cuda_parser,
                                    cuda_path, cuda_ring, cuda_search,
                                    cuda_serializer)

    return {"dp_parse": (cuda_parser, "LAUNCHES"),
            "classify": (cuda_classify, "LAUNCHES"),
            "lower": (cuda_lower, "LAUNCHES"),
            "lower_counts": (cuda_lower, "COUNT_LAUNCHES"),
            "rc_serialize": (cuda_serializer, "LAUNCHES"),
            "ring_decode": (cuda_ring, "LAUNCHES"),
            "search_keys": (cuda_search, "KEYS_LAUNCHES"),
            "suffix_table": (cuda_search, "TABLE_LAUNCHES"),
            "match_lists": (cuda_search, "LIST_LAUNCHES"),
            "dp_inputs": (cuda_inputs, "LAUNCHES"),
            "path_mark": (cuda_path, "MARK_LAUNCHES"),
            "path_compact": (cuda_path, "COMPACT_LAUNCHES"),
            "doubling_groups": (cuda_lazy, "GROUP_LAUNCHES"),
            "descent_lcp": (cuda_lazy, "DESCENT_LAUNCHES"),
            "best_matches": (cuda_lazy, "BEST_LAUNCHES"),
            "price_model": (cuda_model, "LAUNCHES"),
            "classify_tokens": (cuda_classify, "TOKEN_LAUNCHES"),
            "rep0_trace": (cuda_inputs, "REP0_LAUNCHES"),
            "list_pairs": (cuda_search, "PAIR_LAUNCHES")}


def zero_counts():
    """Every count of counters() set to 0."""
    for mod, attr in counters().values():
        setattr(mod, attr, 0)


def read_counts():
    """Every count of counters(), by name."""
    return {k: getattr(mod, attr) for k, (mod, attr) in counters().items()}


def decode_bytes(streams, cuts, sizes):
    """Bytes a decode to `cuts` must move: the output written and each
    lane's stream in proportion to the share of its block decoded (the
    decoded decisions are not counted)."""
    return sum(cuts) + sum(len(s) * n / sz for s, n, sz in
                           zip(streams, cuts, sizes))


def corpus(n, seed=11):
    """tools/chip_check.py's corpus: n bytes of 40 random words."""
    import random

    rng = random.Random(seed)
    words = [bytes(rng.randrange(256) for _ in range(rng.randrange(5, 25)))
             for _ in range(40)]
    b = bytearray()
    while len(b) < n:
        b += words[rng.randrange(40)]
    return bytes(b[:n])


def stdlib_reads_every_block(blob, data, params):
    from lzma_tpu_torch.parallel import blocks as blk

    frame = blk.parse_container(blob)
    offsets, bsizes = frame.stream_extents(len(blob))
    for i in range(len(bsizes)):
        alone = (params.encode_props() + bsizes[i].to_bytes(8, "little")
                 + blob[offsets[i]:offsets[i + 1]])
        part = data[i * frame.block_size:i * frame.block_size + bsizes[i]]
        if lzma.decompress(alone, format=lzma.FORMAT_ALONE) != part:
            raise AssertionError(f"stdlib lzma disagrees on block {i}")
    return offsets, bsizes


def probe_phase(dev, card, comp, comp_lens, cuts, want):
    """Phase 13: the Hopper probes.  `comp`, `comp_lens` are PROBE_LANES
    real streams of CH_BLOCK bytes (lc0, dict CH_DICT), `want` their
    input (lanes, CH_BLOCK) uint8 and `cuts` each lane's first token end
    at or past PROBE_CUT_OUT.  Holds each probe kernel against its plain
    version on the card, then runs every probe's table with the launch
    counts set to 0 just before.  Returns the records of P1-P15."""
    import torch
    from lzma_tpu_torch.ops import cuda_ring
    from lzma_tpu_torch.probes import (_cuda, probe_dma, probe_dma2,
                                       probe_fsm_cost, probe_fsm_cost2,
                                       probe_gather, probe_gather2,
                                       probe_packed_ablate, probe_ring_ablate)

    F, F2, G, G2 = probe_fsm_cost, probe_fsm_cost2, probe_gather, probe_gather2
    D, D2, RA, PA = probe_dma, probe_dma2, probe_ring_ablate, probe_packed_ablate
    held = {}   # site: (max |diff|, the plain version's ms at its main cut)

    def hold(site, kernel_res, plain_res, plain_ms=None):
        err = max(int((k.long() - p.long()).abs().max())
                  for k, p in zip(kernel_res, plain_res))
        if err:
            raise AssertionError(f"{site}: kernel differs from its plain "
                                 f"version by {err}")
        worst, ms = held.get(site, (0, None))
        held[site] = (max(worst, err), ms if plain_ms is None else plain_ms)

    def timed(fn):
        box = {}
        ms = wall_ms(lambda: box.update(r=fn()))
        return box["r"], ms

    # -- each kernel against its plain version on the card, at a cut --
    it, n = PROBE_CUT_ITERS, 128
    seed = F.seeds(n, dev)
    for site, name in (("P10", "v1"), ("P11", "v2"), ("P12", "v_i16")):
        plain, ms = timed(lambda: getattr(F, f"{name}_plain")(seed, it))
        for placement in F.PLACEMENTS:
            hold(site, getattr(F, name)(seed, it, placement, digest=True), plain, ms)
    for label, kw in F2.CASES:
        plain, ms = timed(lambda: F2.make_plain(
            seed, PROBE_CUT_MAKE, kw["loop"], kw.get("selects", 0),
            kw.get("nregs", 0)))
        for placement in F2.PLACEMENTS:
            hold("P13", F2.make(seed, PROBE_CUT_MAKE, placement=placement,
                                digest=True, **kw), plain,
                 ms if label == "while +24regs+120sel" else None)
    for width in (128, 4096, 8192):
        arr, idx = G.inputs(width, device=dev)
        main = width == 4096
        plain, ms = timed(lambda: G.probe_native_plain(arr, idx, it))
        for placement in G.PLACEMENTS:
            hold("P5", [G.probe_native(arr, idx, it, placement)], [plain],
                 ms if main else None)
        plain, ms = timed(lambda: G.probe_onehot_plain(arr, idx, it))
        hold("P6", [G.probe_onehot(arr, idx, it)], [plain], ms if main else None)
        zeros, idx = G.scatter_inputs(width, device=dev)
        plain, ms = timed(lambda: G.probe_scatter_plain(zeros, idx, it))
        hold("P7", [G.probe_scatter(zeros, idx, it)], [plain], ms if main else None)
    for lanes, width, g in G2.CHAINS:
        arr, idx = G2.chain_inputs(lanes, width, dev)
        plain, ms = timed(lambda: G2.probe_chain_plain(arr, idx, g, it))
        for placement in G2.PLACEMENTS:
            hold("P8", [G2.probe_chain(arr, idx, g, it, placement)], [plain],
                 ms if (lanes, width, g) == (64, 4096, 1) else None)
    for width in G2.TAA_WIDTHS:
        arr, idx = G2.taa_inputs(16, width, dev)
        plain, ms = timed(lambda: G2.probe_taa_plain(arr, idx))
        hold("P9", [G2.probe_taa(arr, idx)], [plain], ms)
    # the copies: the TPU probes' reference arrays (arange windows, as the
    # JAX probes assert them) and the refused rows, decided on the host
    src, copied = D.source(dev), []
    for site, name, offs in (("P1", "probe1", D.OFFS1), ("P2", "probe2", D.OFFS2)):
        offs_t, rounds = D.offsets(offs, dev), D.ROUNDS[name]
        for form in D.FORMS:
            out, refused = getattr(D, name)(src, offs_t, form)
            want_refused = ([i for i, o in enumerate(offs) if o % 4]
                            if form in D.ALIGNED else [])
            if refused != want_refused:
                raise AssertionError(f"{name} {form} refused {refused}, not "
                                     f"{want_refused}")
            keep = [i for i in range(D.N) if i not in refused]
            if not torch.equal(out.cpu()[keep], D.reference(offs, rounds)[keep]):
                raise AssertionError(f"{name} {form} differs from the TPU "
                                     "probe's reference")
            plain, ms = timed(lambda: D.copy_plain(src, list(offs), rounds, refused))
            hold(site, [out], [plain], ms if form == "bulk" else None)
            copied.append(f"{name} {form}: " + D.describe(refused, offs))
    x = D.tile(dev)
    plain, ms = timed(lambda: D.probe3_plain(x))
    if not torch.equal(plain.cpu(), D.tile("cpu") + 3 * D.C + 5):
        raise AssertionError("probe3's plain version misses the TPU reference")
    hold("P3", [D.probe3(x)], [plain], ms)
    offs_t = D.offsets(D.OFFS1, dev)
    for kernel in D2.KERNELS:
        out, refused = D2.run(kernel, src, offs_t)
        if refused != ([4, 6] if kernel in D2.DYNAMIC else []):
            raise AssertionError(f"probe_dma2 {kernel} refused {refused}")
        keep = [i for i in range(D.N) if i not in refused]
        if not torch.equal(out.cpu()[keep], D2.expected(kernel)[keep]):
            raise AssertionError(f"probe_dma2 {kernel} differs from the TPU "
                                 "probe's check")
        plain, ms = timed(lambda: D2.run_plain(src, D2.starts(kernel, D.OFFS1),
                                                refused))
        hold("P4", [out], [plain], ms if kernel == "kC" else None)
    # K1's body: full and realrow (P15) and the packed probe's full (P14,
    # each row read to its end) on real streams cut at token boundaries,
    # then full on the whole rows against K1 and the input
    dargs = (CH_DICT, 0, 0, 2, CH_BLOCK)
    plain, ms = timed(lambda: RA.plain(comp, comp_lens, cuts, *dargs, "full"))
    if not bool(plain[1].all()):
        raise AssertionError("the plain decoder failed a cut lane")
    for variant in RA.PLAIN:
        hold("P15", RA.ablate(comp, comp_lens, cuts, *dargs, variant)[:3],
             plain[:3], ms)
    whole = torch.full_like(comp_lens, comp.shape[1])
    plain, ms = timed(lambda: RA.plain(comp, whole, cuts, *dargs, "full"))
    hold("P14", PA.ablate(comp, CH_DICT, 0, CH_BLOCK, "full", out_sizes=cuts)[:3],
         plain[:3], ms)
    sizes = torch.full_like(comp_lens, CH_BLOCK)
    k1 = cuda_ring.decode_cuda(comp, comp_lens, sizes, *dargs)
    full = RA.ablate(comp, comp_lens, sizes, *dargs, "full")
    if not (all(torch.equal(a, b) for a, b in zip(full[:3], k1))
            and torch.equal(full[0], want) and bool(full[1].all())):
        raise AssertionError("the ablation's full differs from K1 or the input")
    log(f"[probes vs plain] P1-P15 equal to their plain versions on the card "
        f"({PROBE_CUT_ITERS} steps, make {PROBE_CUT_MAKE}; P14/P15 "
        f"{PROBE_LANES} champion streams cut at {int(cuts.min())}.."
        f"{int(cuts.max())} B); the copies equal the TPU probes' references "
        f"({'; '.join(copied)}); full on whole rows = K1 = the input")

    # -- every probe's table, its launches counted from 0 --
    for m in (F, F2, G, G2, RA, PA, D, D2):
        m.LAUNCHES.clear()
    fsm, fsm2, gat = F.sweep(dev), F2.sweep(dev), G.sweep(dev)
    taa, chains = G2.sweep(dev)
    ring = RA.sweep(dev, comp, comp_lens, sizes)
    packed, dma, dma2 = PA.sweep(dev), D.sweep(dev), D2.sweep(dev)
    launches = {"P1": D.LAUNCHES["probe1"], "P2": D.LAUNCHES["probe2"],
                "P3": D.LAUNCHES["probe3"], "P4": D2.LAUNCHES["run"],
                "P5": G.LAUNCHES["probe_native"], "P6": G.LAUNCHES["probe_onehot"],
                "P7": G.LAUNCHES["probe_scatter"], "P8": G2.LAUNCHES["probe_chain"],
                "P9": G2.LAUNCHES["probe_taa"], "P10": F.LAUNCHES["v1"],
                "P11": F.LAUNCHES["v2"], "P12": F.LAUNCHES["v_i16"],
                "P13": F2.LAUNCHES["make"], "P14": PA.LAUNCHES["ablate"],
                "P15": RA.LAUNCHES["ablate"]}
    if min(launches.values()) < 1:
        raise AssertionError(f"a probe kernel did not run in its table: {launches}")
    if not all(r[3] for r in dma) or not all(r[2] for r in dma2) \
            or not all(ok for _, ok, _ in taa):
        raise AssertionError("a probe's table disagrees with the TPU reference")
    log(f"[P10-P12 probe_fsm_cost] ms a launch of {F.ITERS} steps and ns a "
        f"step (the slope from {F.ITERS // 2} steps), {F.lanes_per_block()} lanes "
        f"a block (v1 {F.lane_bytes('v1')} B a lane) on {card}: "
        + "; ".join(f"{f} {pl} n={k} {ms:.3f} ms {ns:.1f} ns"
                    for f, pl, k, ms, ns in fsm))
    log(f"[P13 probe_fsm_cost2] ms a launch of {F2.ITERS} steps and ns a step "
        f"on {card}: " + "; ".join(f"{lb} {pl} n={k} {ms:.3f} ms {ns:.1f} ns"
                                   for lb, pl, k, ms, ns in fsm2))
    log(f"[P5-P7 probe_gather] ms a launch of {G.ITERS} steps and ns a step, "
        f"{G.N} lanes on {card}: " + "; ".join(
            f"{f} w={w} {ms:.3f} ms {ns:.1f} ns" for f, w, ms, ns in gat))
    log(f"[P8-P9 probe_gather2] {G2.ITERS} steps on {card}: "
        + "; ".join(f"taa w={w} {us:.2f} us a launch" for w, _, us in taa) + "; "
        + "; ".join(f"n={k} w={w} g={g} {pl} {ms:.3f} ms {ns:.1f} ns/step "
                    f"{pair:.1f} ns/pair" for k, w, g, pl, ms, ns, pair in chains))
    log(f"[P15 probe_ring_ablate] {PROBE_LANES} real rows x {CH_BLOCK} B on "
        f"{card}; a launch's ms, then a lane's own clock: " + "; ".join(
            f"{v} {ms:.3f} ms (lane {lms:.3f}, slowest {slow:.3f}) {nb:.1f} ns/B "
            f"{nst:.1f} ns/step {nbit:.1f} ns/bit {bits:.0f} bits {cp:.0f} copied "
            f"cs {cs}" for v, ms, nb, nst, nbit, bits, cp, lms, slow, cs in ring)
        + "; spans: " + RA.spans_line(dev, comp, comp_lens, sizes))
    log(f"[P14 probe_packed_ablate] random input, {PA.MAX_OUT} B a lane on "
        f"{card}; a launch's ms, then a lane's own clock: " + "; ".join(
            f"{v} n={k} {ms:.3f} ms (lane {lms:.3f}, slowest {slow:.3f}) "
            f"{nb:.1f} ns/B {nst:.1f} ns/step {nbit:.1f} ns/bit {bits:.0f} bits "
            f"{cp:.0f} copied cs {cs}"
            for v, k, ms, nb, nst, nbit, bits, cp, lms, slow, cs in packed))
    log(f"[P1-P4 probe_dma, probe_dma2] one block on {card}, µs a launch (CUDA "
        f"events) and ns in the kernel (clock64 at "
        f"{_cuda.clock_khz(torch.device(dev).index or 0)} kHz): "
        + "; ".join(f"{nm} {f} {us:.2f} us {ns:.1f} ns" for nm, f, _, _, us, ns in dma)
        + "; " + "; ".join(f"{k} {us:.2f} us {ns:.1f} ns" for k, _, _, us, ns in dma2))
    log(f"[probe launches] {launches}")

    # -- the records: ms at the TPU probe's main shape, bounds from it --
    def pick(rows, *key):
        return next(r for r in rows if r[:len(key)] == key)

    # the copies' ms is a launch's (CUDA events), as every record's and
    # the library's; a launch of one block is bound by the host's
    # submission, so clock_ms beside it is the staging alone (clock64)
    ring_full, packed_full = pick(ring, "full"), pick(packed, "full", 128)
    copy_ms = {"P1": pick(dma, "probe1", "bulk")[4:6],
               "P2": pick(dma, "probe2", "bulk")[4:6],
               "P3": pick(dma, "probe3")[4:6], "P4": pick(dma2, "kC")[3:5]}
    steps = 128 * F.ITERS      # lanes x steps of P10-P13's main shape
    tile_io = 8 * 128 * 4 * 2  # the (8, 128) int32 tile read and written
    site = {
        "P1": ("probe_dma.probe1", "probe_copy.cu", "tools/probe_dma.py:53",
               copy_ms["P1"][0] / 1e3, (tile_io + 32, 0)),
        "P2": ("probe_dma.probe2", "probe_copy.cu", "tools/probe_dma.py:92",
               copy_ms["P2"][0] / 1e3, (tile_io * 3 // 2 + 32, 0)),
        "P3": ("probe_dma.probe3", "probe_copy.cu", "tools/probe_dma.py:116",
               copy_ms["P3"][0] / 1e3, (tile_io, 8 * 128)),
        "P4": ("probe_dma2.run", "probe_copy.cu", "tools/probe_dma2.py:38",
               copy_ms["P4"][0] / 1e3, (tile_io + 32, 0)),
        "P5": ("probe_gather.probe_native", "probe_gather.cu",
               "tools/probe_gather.py:32", pick(gat, "native shared", 4096)[2],
               (G.N * 4096 * 4 + G.N * 8, G.N * G.ITERS * 2)),
        "P6": ("probe_gather.probe_onehot", "probe_gather.cu",
               "tools/probe_gather.py:66", pick(gat, "one-hot gather", 4096)[2],
               (G.N * 4096 * 4 + G.N * 8, G.N * G.ITERS * 2)),
        "P7": ("probe_gather.probe_scatter", "probe_gather.cu",
               "tools/probe_gather.py:95", pick(gat, "one-hot scatter", 4096)[2],
               (G.N * 4096 * 4 + G.N * 8, G.N * (G.ITERS + 4096))),
        "P8": ("probe_gather2.probe_chain", "probe_gather.cu",
               "tools/probe_gather2.py:43", pick(chains, 64, 4096, 1, "shared")[4],
               (64 * 4096 * 4 + 64 * 8, 64 * G2.ITERS * 6)),
        "P9": ("probe_gather2.probe_taa", "probe_gather.cu",
               "tools/probe_gather2.py:72", pick(taa, 512)[2] / 1e3,
               (16 * 4 * 3, 16)),
        "P10": ("probe_fsm_cost.v1", "probe_fsm.cu", "tools/probe_fsm_cost.py:75",
                pick(fsm, "v1", "shared", 128)[3], (1024, steps * 20)),
        "P11": ("probe_fsm_cost.v2", "probe_fsm.cu", "tools/probe_fsm_cost.py:135",
                pick(fsm, "v2", "shared", 128)[3], (1024, steps * 30)),
        "P12": ("probe_fsm_cost.v_i16", "probe_fsm.cu", "tools/probe_fsm_cost.py:165",
                pick(fsm, "v_i16", "shared", 128)[3], (1024, steps * 10)),
        "P13": ("probe_fsm_cost2.make", "probe_fsm.cu", "tools/probe_fsm_cost2.py:89",
                pick(fsm2, "while +24regs+120sel", "shared", 128)[3],
                (1024, steps * (14 + 24 * 4 + 120 * 3))),
        # K1's body: ~10 operations a bit, 3 a copied byte, each lane's
        # input read and output written once, counted from this run
        "P14": ("probe_packed_ablate.ablate", "probe_ablate.cu",
                "tools/probe_packed_ablate.py:165", packed_full[2],
                (128 * (PA.MAX_IN + PA.MAX_OUT),
                 int(128 * (10 * packed_full[6] + 3 * packed_full[7])))),
        "P15": ("probe_ring_ablate.ablate", "probe_ablate.cu",
                "tools/probe_ring_ablate.py:177", ring_full[1],
                (int(comp_lens.sum()) + PROBE_LANES * CH_BLOCK,
                 int(PROBE_LANES * (10 * ring_full[5] + 3 * ring_full[6])))),
    }
    # one PyTorch call that computes the same function, its index built
    # outside the timing: torch.gather of each row at its offsets (P1 and
    # kC read OFFS1; the refused rows are gathered too), x + x[3, 5], and
    # take_along_axis; P2's sum of two rounds is not one call
    arr, idx = G2.taa_inputs(16, 512, dev)
    col = idx.long()[:, None]
    rows = D.offsets(D.OFFS1, dev).long()[:, None] + torch.arange(D.C, device=dev)
    x = D.tile(dev)
    gather_ms = _cuda.event_ms(lambda: src.gather(1, rows), 20)
    library = {"P1": gather_ms, "P4": gather_ms,
               "P3": _cuda.event_ms(lambda: torch.add(x, x[3, 5]), 20),
               "P9": _cuda.event_ms(lambda: arr.gather(1, col), 20)}
    records = []
    for key, (name, src_file, replaces, ms, work) in site.items():
        err, plain_ms = held[key]
        extra = {"clock_ms": copy_ms[key][1] / 1e6} if key in copy_ms else {}
        records.append(record(name, f"lzma_tpu_torch/csrc/{src_file}", replaces,
                              launches[key], err, ms, plain_ms, bound(*work),
                              library.get(key), **extra))
    return records


def drive(api, data, params, parse, dev):
    """One encode and decode of `data` in MAIN_BLOCK lanes through the
    entry points, every kernel's launch count set to 0 just before; it
    must round-trip and the stdlib lzma module must read every block.
    Returns (container, encode s, decode s, launches, peak device bytes,
    the container's (offsets, block sizes))."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t = time.perf_counter()
    blob = api.encode_blocks(data, params, block_size=MAIN_BLOCK, parse=parse,
                             device=dev)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t
    t = time.perf_counter()
    back = api.decode_blocks(blob, device=dev)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    if back != data:
        raise AssertionError(f"8 MiB {parse} round trip differs")
    extents = stdlib_reads_every_block(blob, data, params)
    return blob, t_enc, t_dec, launches, peak, extents


def run_cli(args):
    """`python -m lzma_tpu_torch *args` from the repository root, on the
    card; raises unless it exits 0.  Returns its standard output."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    run = subprocess.run([sys.executable, "-m", "lzma_tpu_torch", *args],
                         cwd=root, capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        raise AssertionError(f"python -m lzma_tpu_torch {args[0]}: rc "
                             f"{run.returncode}\n{run.stdout}{run.stderr}")
    return run.stdout


def alone_phase(dev, card, data):
    """Phase 14: `data` as one `.lzma` stream, known size and EOS, through
    ops.api.encode_alone/decode_alone with the counts of K6, K7, K2 and K1
    set to 0 before each; the stage breakdown of the EOS encode; the
    `.lzma` pins; the front door; the command line; the lane entry.
    Returns K6's ms on the stream's token rows and K19's and K7's on its
    tokens ({"classify": ms, "classify_tokens": ms, "lower": ms}), their
    bounds (likewise), the max |diff| of K6, K19, K7, K2 and K1 against
    their plain versions on the
    stream's tensors, cut, and of K15, K16 and K17 on its calls, uncut
    (by kernel name), the EOS encode's launches by kernel, K10 on the
    stream's call ({"places", "route", "ms", "bound", "err",
    "plain_ms"}) and K13 and K14 on theirs ({kernel: {"nodes", "bytes",
    "bound", "ms", "err", "plain_ms"}})."""
    import os
    import tempfile

    import torch
    import lzma_tpu_torch
    from lzma_tpu_torch.bench.datagen import generate_bench_data
    from lzma_tpu_torch.entry import entry
    from lzma_tpu_torch.core.layout import ProbLayout
    from lzma_tpu_torch.format.properties import LzmaParams
    from lzma_tpu_torch.ops import (api, cuda_classify, cuda_lazy, cuda_lower,
                                    cuda_search)
    from lzma_tpu_torch.ops.device_decoder import _pow2_at_least, pad_rows
    from lzma_tpu_torch.ops.device_encoder import _classify_rows, probing
    from lzma_tpu_torch.ops.device_matcher import LAZY_STAGES
    from lzma_tpu_torch.probes._cuda import event_ms
    from lzma_tpu_torch.runtime.card import smem_limit

    mb = len(data) / 1e6
    blobs = {}
    for eos in (False, True):
        params = LzmaParams(write_eos=eos)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t = time.perf_counter()
        blob = api.encode_alone(data, params, device=dev)
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t
        t = time.perf_counter()
        back = api.decode_alone(blob, device=dev)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        size = 2**64 - 1 if eos else len(data)
        if back != data or blob[5:13] != size.to_bytes(8, "little"):
            raise AssertionError(f".lzma stream (eos {eos}) does not round-trip")
        if lzma.decompress(blob, format=lzma.FORMAT_ALONE) != data:
            raise AssertionError(f"stdlib lzma disagrees on the .lzma stream "
                                 f"(eos {eos})")
        # the lazy stream's search: K9, K15 a doubling level, K16, K10,
        # K17
        if launches != {"dp_parse": 0, "classify": 0, "lower": 1,
                        "lower_counts": 0, "rc_serialize": 1,
                        "ring_decode": 1, "search_keys": 1,
                        "suffix_table": 1, "match_lists": 0,
                        "dp_inputs": 0, "path_mark": 1, "path_compact": 1,
                        "doubling_groups": 5, "descent_lcp": 1,
                        "best_matches": 1, "price_model": 0,
                        "classify_tokens": 1, "rep0_trace": 0,
                        "list_pairs": 0}:
            raise AssertionError(f"the .lzma path's launches: {launches}")
        blobs[eos] = blob
        log(f"[lzma stream] {len(data)} B as one stream, "
            f"{'EOS marker' if eos else 'known size'}, lazy, on {card}: "
            f"{len(blob)} B (ratio {len(blob) / len(data):.4f}), encode "
            f"{t_enc:.3f} s = {mb / t_enc:.3f} MB/s, decode {t_dec:.3f} s = "
            f"{mb / t_dec:.3f} MB/s, peak device memory {peak / 2**20:.1f} "
            f"MiB, launches {launches}; the stdlib and decode_alone read it")
    # the probed rerun spies K15-K17 too: their calls on the stream's one
    # lane of 8,388,608 places (K15 over 16,384 tiles, each looking back
    # along the lane) wait in host memory for the check below
    with probing() as probe:
        t = time.perf_counter()
        ((again, seen_search), seen_lazy), seen_path = spied_rows(
            lambda: spied_lazy(lambda: spied_search(
                lambda: api.encode_alone(data, LzmaParams(write_eos=True),
                                         device=dev))))
        torch.cuda.synchronize()
        t_probed = time.perf_counter() - t
    if again != blobs[True]:
        raise AssertionError("the probed .lzma encode wrote another stream")
    if {k: len(v) for k, v in seen_lazy.items()} != dict(
            doubling_groups=5, descent_lcp=1, best_matches=1):
        raise AssertionError(f"the probed .lzma encode ran the lazy kernels "
                             f"{ {k: len(v) for k, v in seen_lazy.items()} }")
    lazy_stash = _to("cpu", seen_lazy)
    del seen_lazy
    # K10 on the stream's one lane (the LCP given past depth 32; a width
    # that is no multiple of its tile: a pass a level past the tile),
    # timed by CUDA events and held to its plain version, uncut
    k10_args, _ = seen_search.pop("suffix_table")
    del seen_search
    k10 = {"places": k10_args[0].shape[1], "route": cuda_search.upper_route(
        k10_args[0].shape[1], smem_limit(dev.index or 0))[0]}
    k10["ms"] = event_ms(lambda: cuda_search.suffix_table_cuda(*k10_args), 3)
    k10_out = cuda_search.suffix_table_cuda(*k10_args)
    k10["bound"] = bound(*search_work({"suffix_table": (k10_args, k10_out)})[
        "suffix_table"])
    k10_errs, k10_plain = check_search({"suffix_table": (k10_args, k10_out)})
    k10["err"], k10["plain_ms"] = k10_errs["suffix_table"], k10_plain["suffix_table"]
    del k10_args, k10_out
    # K19's call on the stream (its one lane's tokens), timed below beside
    # K6 on the same tokens' rows
    k19_args, _ = seen_path.pop("classify_tokens_cuda")
    # K13 and K14 on the stream's one lane (2,049 tiles of 4,096 nodes:
    # the door maps composed in groups of 128 tiles), each call timed
    # alone by CUDA events beside row_work's bounds and held to its plain
    # version, uncut
    if sorted(seen_path) != ["greedy_compact_cuda", "greedy_mark_cuda"]:
        raise AssertionError(f"the probed .lzma encode's path calls: "
                             f"{sorted(seen_path)}")
    path = {}
    for w, (p_args, p_out) in seen_path.items():
        work = row_work(w, p_args, p_out)
        path[row_kernel(w)] = {
            "nodes": p_args[0].shape[1] + 1, "bytes": work[0],
            "bound": bound(*work),
            "ms": event_ms(lambda f=getattr(_row_module("cuda_path"), w),
                           a=p_args: f(*a), 3)}
    p_errs, p_plain = check_rows(seen_path)
    for w in seen_path:
        path[row_kernel(w)].update(err=p_errs[row_kernel(w)],
                                   plain_ms=p_plain[w])
    del seen_path
    log(f"[lzma stream K13, K14] on {card}: the stream's one lane of "
        f"{path['path_mark']['nodes']} nodes, tolerance 0: " + "; ".join(
            f"{k} {v['ms']:.3f} ms (CUDA events, the wrapper"
            f"{' with its status readback' if k == 'path_mark' else ''}), "
            f"{v['bytes']} B read and written, bound {v['bound'][0]:.4f} ms "
            f"by {v['bound'][1]} ({v['ms'] / v['bound'][0]:.1f}x), max |diff| "
            f"{v['err']} against the plain version ({v['plain_ms']:.1f} ms)"
            for k, v in path.items()))
    torch.cuda.empty_cache()
    log(f"[lzma stream K10] on {card}: the stream's one lane of "
        f"{k10['places']} places, depth 273 (the LCP given), levels past the "
        f"tile by {k10['route']}: {k10['ms']:.3f} ms (CUDA events, the "
        f"wrapper), bound {k10['bound'][0]:.4f} ms by {k10['bound'][1]} "
        f"({k10['ms'] / k10['bound'][0]:.1f}x); rank and T equal to the plain "
        f"version's, uncut (plain {k10['plain_ms']:.1f} ms)")
    rows = _classify_rows(*k19_args[2:])
    l_args = probe["lower_args"]
    ms = {"classify": event_ms(
        lambda: cuda_classify.classify_carry_cuda(*rows), 3),
          "classify_tokens": event_ms(
        lambda: cuda_classify.classify_tokens_cuda(*k19_args), 3),
          "lower": event_ms(lambda: cuda_lower.lower_tokens_cuda(*l_args), 3)}
    bounds = {"classify": bound(*classify_work(rows)),
              "classify_tokens": bound(*row_work(
                  "classify_tokens_cuda", k19_args, None)),
              "lower": bound(*lower_work(l_args, probe["lowered"][5]))}
    moved = classify_moved(rows)
    n_tok = int(probe["lowered"][2].sum())
    log(f"[lzma stream stages] probed EOS encode {t_probed:.3f} s, "
        f"{n_tok} tokens, {int(probe['lowered'][5].sum())} coded pairs: "
        + ", ".join(f"{k} {sum(v) * 1e3:.1f} ms" for k, v in probe["seconds"].items())
        + f"; tokenize (the sum of {', '.join(LAZY_STAGES)}) "
        f"{sum(sum(probe['seconds'][k]) for k in LAZY_STAGES) * 1e3:.1f} ms"
        + f"; K6 on its rows {ms['classify']:.3f} ms (CUDA events, "
        f"{ms['classify'] * 1e6 / n_tok:.1f} ns a token), bound "
        f"{bounds['classify'][0]:.4f} ms by {bounds['classify'][1]}; the "
        f"design moves about {moved} B by classify_moved's model ("
        f"{moved / HBM_BYTES_PER_S * 1e3:.4f} ms at the HBM rate); K19 on "
        f"its tokens {ms['classify_tokens']:.3f} ms (CUDA events, "
        f"{ms['classify_tokens'] * 1e6 / n_tok:.1f} ns a token), bound "
        f"{bounds['classify_tokens'][0]:.4f} ms by "
        f"{bounds['classify_tokens'][1]}; K7 on its "
        f"tokens {ms['lower']:.3f} ms (CUDA events, "
        f"{ms['lower'] * 1e6 / n_tok:.2f} ns a token), bound "
        f"{bounds['lower'][0]:.4f} ms by {bounds['lower'][1]}")
    # each kernel against its plain version on the stream's own card
    # tensors, cut as phase 9 cuts the main path's (tolerance zero): K6 on
    # the first CMP_POS token rows and on the rows from CMP_POS before the
    # EOS token to the end (the whole tail past it), K2 on the lane's first
    # CMP_BITS pairs, K1 on the EOS stream up to its first token boundary
    # at or past CMP_OUT bytes in the first EOS decode's output bucket
    t_pos, t_len, t_valid, ctx, bits, totals = probe["lowered"]
    last = int(lane_steps(rows[2])[0])
    errs = {}
    for cut, at in (("head", slice(0, CMP_POS)),
                    ("edge", slice(max(0, last - CMP_POS), None))):
        err, _ = check_classify(tuple(r[at].contiguous() for r in rows))
        errs["classify"] = max(errs.get("classify", 0), err)
        # K19 on the same token columns of the lane
        err, _ = check_classify_tokens((k19_args[0], *(a[:, at] for a in
                                                       k19_args[1:])))
        errs["classify_tokens"] = max(errs.get("classify_tokens", 0), err)
        # K7 on the same token columns (the head's width doubled by
        # invalid ones: its tokens are all valid)
        err, _ = check_lower(lower_cut(l_args, at, pad=cut == "head"))
        errs["lower"] = max(errs.get("lower", 0), err)
    max_n = (ctx.shape[1] - 128) // 10     # _lower_lanes' max_bits
    arena = ProbLayout(params.lc, params.lp, params.pb, pos_bits=params.pb).size
    errs["rc_serialize"], _, _, _ = check_serializer(
        ctx, bits, torch.clamp(totals, max=CMP_BITS), arena,
        max_n + max_n // 4 + 128)
    comp_len = len(blobs[True]) - 13
    cap = min(max(16 * comp_len, 1 << 16), 273 * comp_len + 512, 1 << 25)
    comp, comp_lens = pad_rows([blobs[True][13:]], dev)
    cuts = token_cut(t_pos, t_len, t_valid, CMP_OUT, [len(data)])
    errs["ring_decode"], d_out, _ = check_decoder(
        comp, comp_lens, cuts, params, _pow2_at_least(cap, 16), resident=False)
    n_cut = int(cuts[0])
    if d_out[0, :n_cut].cpu().numpy().tobytes() != data[:n_cut]:
        raise AssertionError(f"the .lzma stream decodes wrong up to byte {n_cut}")
    log(f"[lzma stream vs plain] on {card}, tolerance 0: classify carry on "
        f"token rows [0, {CMP_POS}) and [{max(0, last - CMP_POS)}, "
        f"{rows[0].shape[0]}) (the EOS token is row {last - 1}) max |diff| "
        f"{errs['classify']}; classify_tokens on the same token columns "
        f"max |diff| {errs['classify_tokens']}; lower on the same token "
        f"columns max |diff| "
        f"{errs['lower']}; rc_serialize on the first "
        f"{int(torch.clamp(totals, max=CMP_BITS)[0])} of {int(totals[0])} "
        f"pairs max |diff| {errs['rc_serialize']}; ring_decode to byte {n_cut} "
        f"in a {_pow2_at_least(cap, 16)}-byte bucket max |diff| "
        f"{errs['ring_decode']}")
    del probe, rows, l_args, t_pos, t_len, t_valid, ctx, bits, totals, d_out
    del k19_args
    # K15, K16 and K17 on the stream's own calls, uncut: each call timed
    # by CUDA events beside lazy_work's bounds, then against its plain
    # version (one plain call a kernel call)
    width = lazy_stash["doubling_groups"][0][0][0].shape[1]
    on_card = _to(dev, lazy_stash)
    del lazy_stash
    s_calls, s_bounds = lazy_times(on_card)
    lazy_errs, lazy_plain = check_lazy(on_card)
    errs.update(lazy_errs)
    del on_card
    log(f"[lzma stream K15, K16, K17 vs plain] on {card}, tolerance 0: the "
        f"stream's one lane of {width} places "
        f"({-(-width // cuda_lazy.TILE)} K15 tiles), uncut (the doubling's "
        "five levels, the descent, the best matches): ids, keys, LCPs and "
        "matches equal; kernels (CUDA events, the wrapper) " + "; ".join(
            f"{k} {sum(s_calls[k]):.3f} ms in {len(s_calls[k])} call"
            + (f"s ({', '.join(f'{x:.3f}' for x in s_calls[k])})"
               if len(s_calls[k]) > 1 else "")
            + f", {b[0][0]} B read and written, bound {b[1][0]:.4f} ms by "
            f"{b[1][1]} ({sum(s_calls[k]) / b[1][0]:.1f}x)"
            for k, b in s_bounds.items())
        + "; plain " + ", ".join(f"{k} {v:.1f} ms"
                                 for k, v in lazy_plain.items()))

    small = generate_bench_data(ALONE_PIN_SIZE)
    for eos, pin in ((False, PIN_ALONE_SHA256), (True, PIN_ALONE_EOS_SHA256)):
        blob = api.encode_alone(small, LzmaParams(write_eos=eos), device=dev)
        digest = hashlib.sha256(blob).hexdigest()
        if digest != pin or api.decode_alone(blob, device=dev) != small:
            raise AssertionError(f".lzma pin (eos {eos}): {digest} != {pin}")
    log(f"[lzma pins] encode_alone of {ALONE_PIN_SIZE} B of bench data, known "
        "size and EOS: sha256 = the JAX reference's; both read back")

    part = data[:2 << 20]
    t = time.perf_counter()
    blob = lzma_tpu_torch.compress(part, device=dev)
    if lzma_tpu_torch.decompress(blob, device=dev) != part \
            or lzma_tpu_torch.decompress(blobs[True], device=dev) != data:
        raise AssertionError("the front door does not round-trip")
    log(f"[front door] compress -> decompress of {len(part)} B (LZTB, 1 MiB "
        f"blocks, optimal): {len(blob)} B; decompress reads the .lzma "
        f"stream; {time.perf_counter() - t:.3f} s")

    root = os.path.dirname(os.path.abspath(__file__))
    work_dir = os.path.join(root, "lzma_tpu_torch", "_build")
    os.makedirs(work_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work_dir) as tmp:
        src, enc, dec = (os.path.join(tmp, x) for x in ("in", "in.lzma", "out"))
        with open(src, "wb") as f:
            f.write(data[:1 << 20])
        t = time.perf_counter()
        for args in (["e", "-eos", "-q", src, enc], ["d", "-q", enc, dec]):
            run_cli(args)
        with open(enc, "rb") as f:
            cli_blob = f.read()
        with open(dec, "rb") as f:
            cli_back = f.read()
        if cli_back != data[:1 << 20] or lzma.decompress(
                cli_blob, format=lzma.FORMAT_ALONE) != cli_back:
            raise AssertionError("the command line does not round-trip")
    log(f"[cli] python -m lzma_tpu_torch e -eos / d on {len(cli_back)} B: "
        f"{len(cli_blob)} B, round trip, the stdlib reads it; "
        f"{time.perf_counter() - t:.3f} s for both processes")

    fn, args = entry()
    out, lens = fn(*args)
    digest = entry_digest(out.cpu().numpy(), lens.cpu().numpy())
    if digest != PIN_ENTRY_SHA256:
        raise AssertionError(f"entry() output {digest} != {PIN_ENTRY_SHA256}")
    log(f"[entry] lzma_tpu_torch.entry: fn(*args) on {args[0].device}, "
        f"{tuple(out.shape)}, lens {lens.tolist()}: sha256 = the JAX "
        "reference's __graft_entry__.entry()")
    return ms, bounds, errs, launches, k10, path


def hybrid_pin_input():
    from lzma_tpu_torch.bench.datagen import generate_bench_data
    from lzma_tpu_torch.format.properties import LzmaParams

    return (generate_bench_data(HYBRID_PIN_SIZE),
            LzmaParams(dict_size=1 << 14, fast_bytes=16), 1 << 14)


def hybrid_phase(dev, card, data, params, opt_blob, lazy_blob):
    """Phases 15-17: the hybrid's pins, then main8M's input through the
    hybrid-optimal encode (the search split from the host's parse by a
    PhaseTimer; K1 decodes the container, counted from 0; the stdlib reads
    every block) and through the lazy hybrid, whose container must be
    main8M-lazy's.  Returns K1's launches in the hybrid-optimal decode, the
    search kernels' (K9-K11) in its encode, hybrid8M-opt's container, and
    the lazy search kernels' (K15-K17) in the lazy hybrid's encode."""
    import os

    import torch
    from lzma_tpu_torch.ops import (api, cuda_ring, cuda_search,
                                    device_matcher, hybrid)
    from lzma_tpu_torch.ops.device_decoder import pad_rows
    from lzma_tpu_torch.utils.profiling import PhaseTimer

    cpus = os.cpu_count()
    h_data, h_params, h_block = hybrid_pin_input()
    for name, fn, pin in (
            ("optimal", hybrid.encode_blocks_hybrid_optimal, PIN_HYBRID_OPT_SHA256),
            ("lazy", hybrid.encode_blocks_hybrid, PIN_HYBRID_LAZY_SHA256)):
        blob = fn(h_data, h_params, block_size=h_block, device=dev)
        digest = hashlib.sha256(blob).hexdigest()
        if digest != pin:
            raise AssertionError(f"hybrid {name} container hash {digest} != {pin}")
        if api.decode_blocks(blob, device=dev) != h_data:
            raise AssertionError(f"hybrid {name} pinned container does not "
                                 "round-trip")
        log(f"[hybrid pin] {name}, {len(h_data)} B in {h_block} B blocks: "
            f"{len(blob)} B, sha256 {digest} = the JAX reference's; round trip")

    mb = len(data) / 1e6
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    group = hybrid._group_lanes(len(data) // MAIN_BLOCK, MAIN_BLOCK, 29, dev)
    torch.cuda.reset_peak_memory_stats()
    timer = PhaseTimer()
    zero_counts()
    t = time.perf_counter()
    blob = opt8 = hybrid.encode_blocks_hybrid_optimal(
        data, params, block_size=MAIN_BLOCK, num_threads=0, device=dev,
        timer=timer)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    # the search's kernels once a lane group, K11 with DEFAULT_TIERS' 29
    # candidates a position, uncapped, "near"
    searched = {k: v for k, v in read_counts().items() if k in SEARCH_KERNELS}
    groups = -(-(len(data) // MAIN_BLOCK) // group)
    width = cuda_search.list_columns(
        device_matcher.tier_ranks(hybrid.DEFAULT_TIERS), 0, "near")[2]
    if set(searched.values()) != {groups} or width != 29:
        raise AssertionError(f"the hybrid's search launched {searched} in "
                             f"{groups} lane groups, lists of {width}")
    # K9, K10 and K11 on its whole lanes at DEFAULT_TIERS (29 wide, "near",
    # uncapped) against their plain versions on the same card tensors
    h_lanes, h_lens = pad_rows([data[i:i + MAIN_BLOCK]
                                for i in range(0, len(data), MAIN_BLOCK)], dev)
    _, h_seen = spied_search(lambda: device_matcher._rmq_search(
        h_lanes, h_lens, min(params.dict_size, h_lanes.shape[1]),
        params.fast_bytes, hybrid.DEFAULT_TIERS, 0, "near"))
    h_err, h_plain = check_search(h_seen)
    del h_seen, h_lanes, h_lens
    torch.cuda.empty_cache()
    cuda_ring.LAUNCHES = 0
    t = time.perf_counter()
    back = api.decode_blocks(blob, device=dev)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t
    k1 = cuda_ring.LAUNCHES
    if back != data:
        raise AssertionError("hybrid8M-opt does not round-trip through K1")
    if k1 < 1:
        raise AssertionError("K1 did not run on the hybrid container's decode")
    stdlib_reads_every_block(blob, data, params)
    split = ", ".join(f"{k} {v:.3f} s" for k, v in timer.totals.items())
    log(f"[hybrid8M-opt] {len(data)} B in {len(data) // MAIN_BLOCK} lanes of "
        f"{MAIN_BLOCK} B, DEFAULT_TIERS (29 candidates a position, "
        f"{group} lanes a search group), on {card} with {cpus} host CPUs "
        f"(os.cpu_count): encode {t_enc:.3f} s = {mb / t_enc:.3f} MB/s ({split}), "
        f"ratio {len(blob) / len(data):.4f} (main8M-opt "
        f"{len(opt_blob) / len(data):.4f}, {len(blob)} against "
        f"{len(opt_blob)} B), peak device memory {peak / 2**20:.1f} MiB; "
        f"decode {t_dec:.3f} s = {mb / t_dec:.3f} MB/s, K1 launched {k1}; "
        "round trip, every block decodes with the stdlib lzma module; the "
        f"search's launches {searched} (K11's lists {width} wide, 'near'); "
        f"on its whole lanes K9-K11 equal their plain versions (max |diff| "
        f"{h_err}; plain K11 {h_plain['match_lists']:.1f} ms)")

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timer = PhaseTimer()
    zero_counts()
    t = time.perf_counter()
    lazy = hybrid.encode_blocks_hybrid(data, params, block_size=MAIN_BLOCK,
                                       num_threads=0, device=dev, timer=timer)
    torch.cuda.synchronize()
    t_lazy = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    # the lazy tokenizer's search on the card: K15-K17 once a lane group
    lazy_searched = {k: v for k, v in read_counts().items()
                     if k in LAZY_KERNELS}
    if lazy != lazy_blob:
        raise AssertionError("hybrid8M-lazy's container differs from main8M-lazy's")
    if min(lazy_searched.values()) < 1:
        raise AssertionError(f"hybrid8M-lazy's search launched {lazy_searched}")
    split = ", ".join(f"{k} {v:.3f} s" for k, v in timer.totals.items())
    log(f"[hybrid8M-lazy] the same input and params on {card} with {cpus} host "
        f"CPUs: encode {t_lazy:.3f} s = {mb / t_lazy:.3f} MB/s ({split}), "
        f"{len(lazy)} B = "
        f"main8M-lazy's container byte for byte (the same tokens, the host's "
        f"serializer), peak device memory {peak / 2**20:.1f} MiB; the lazy "
        f"search's launches {lazy_searched}")
    return k1, searched, opt8, lazy_searched


def profile_phase(dev, card, data, params, blob, stage_peaks):
    """Phase 18: one main8M-opt encode and one decode under profiler_trace:
    the card's busy share of each traced window and its ten heaviest
    operations; then the probed encode's peak memory by stage."""
    import shutil
    import tempfile

    import torch
    from lzma_tpu_torch.ops import api
    from lzma_tpu_torch.runtime import build
    from lzma_tpu_torch.utils.profiling import device_busy, profiler_trace

    tmp = tempfile.mkdtemp(dir=build.BUILD_DIR)
    try:
        with profiler_trace(tmp, device=dev) as enc:
            again = api.encode_blocks(data, params, block_size=MAIN_BLOCK,
                                      parse="optimal", device=dev)
        with profiler_trace(tmp, device=dev) as dec:
            back = api.decode_blocks(again, device=dev)
        if again != blob or back != data:
            raise AssertionError("the traced encode or decode differs")
        for what, prof in (("encode", enc), ("decode", dec)):
            busy = device_busy(prof.trace_path, top=10)
            if busy["device_events"] == 0:
                raise AssertionError(f"the {what} trace holds no device activity")
            log(f"[profile] main8M-opt {what} on {card}, torch.profiler: window "
                f"{busy['window_us'] / 1e3:.1f} ms, the card busy "
                f"{busy['busy_us'] / 1e3:.1f} ms = {busy['busy_share']:.4f} of it "
                f"(idle {1 - busy['busy_share']:.4f}), {busy['device_events']} "
                "device events; heaviest: " + "; ".join(
                    f"{name[:60]} {t / 1e3:.2f} ms x{c}"
                    for name, t, c in busy["top"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("[profile] main8M-opt probed encode, peak device memory a stage above "
        "what was allocated as it began, MiB: " + ", ".join(
            f"{k} " + "/".join(f"{b / 2**20:.1f}" for b in v)
            for k, v in stage_peaks.items()))
    torch.cuda.empty_cache()


def trace_phase(dev, card, data, params):
    """Phase 19: encode_batch(trace=) on TRACE_LANES x TRACE_BYTES, lazy and
    optimal: the card's lines (K19 classifies the dump's tokens) equal the
    same call's on the CPU.  Returns K19's launches in the card's calls."""
    import io
    import logging

    from lzma_tpu_torch.ops import cuda_classify
    from lzma_tpu_torch.ops.device_encoder import encode_batch
    from lzma_tpu_torch.utils.trace import CodecTrace

    blocks = [data[i * TRACE_BYTES:(i + 1) * TRACE_BYTES]
              for i in range(TRACE_LANES)]

    def lines(parse, device):
        log_ = logging.getLogger(f"chip_smoke.trace.{parse}.{device}")
        log_.setLevel(logging.DEBUG)
        log_.propagate = False
        stream = io.StringIO()
        h = logging.StreamHandler(stream)
        h.setFormatter(logging.Formatter("%(message)s"))
        log_.addHandler(h)
        try:
            encode_batch(blocks, params, parse=parse, trace=CodecTrace(log_),
                         device=device)
        finally:
            log_.removeHandler(h)
        return stream.getvalue().splitlines()

    cuda_classify.TOKEN_LAUNCHES = 0
    got = {parse: lines(parse, dev) for parse in ("lazy", "optimal")}
    k19 = cuda_classify.TOKEN_LAUNCHES
    for parse, card_lines in got.items():
        cpu_lines = lines(parse, "cpu")
        n_match = sum("matches=" in ln for ln in card_lines)
        if card_lines != cpu_lines or not n_match:
            raise AssertionError(f"the {parse} trace dump differs on the card")
        log(f"[trace dump] {parse}, {TRACE_LANES} x {TRACE_BYTES} B on {card}: "
            f"{len(card_lines)} lines ({n_match} candidate lists) = the CPU's")
    if k19 < 4:
        raise AssertionError(f"K19 ran {k19} times in the card's trace dumps")
    return k19



def counted_call(fn):
    """fn() with the launch counts of K1, K2, K3, K6, K7 and K8 set to 0
    just before it and read just after, the card synchronised around it.
    Returns (its result, seconds, launches)."""
    import torch

    torch.cuda.synchronize()
    zero_counts()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    return out, secs, read_counts()


def mesh_rank(rank, init_method, data_path, out_dir):
    """Phase 21, one rank of MESH_RANKS in a Gloo group, its kernels on
    cuda:0 beside the other ranks': a warm-up, then the 8 MiB through
    encode_blocks_mesh (every rank encodes its MAIN_BLOCK lanes of the
    32), lazy and optimal, with the shard's kernels and the gather timed
    apart; decode_blocks_mesh of the optimal container (every rank decodes
    its lanes and receives the whole input); the v2 (MESH_PRESET) and v3
    (the dictionary in dict.bin) encodes, their heads broadcast from rank
    0; encode_blocks_mesh_hybrid.  Rank 0 writes the containers, every
    rank its record."""
    import os

    import torch
    from lzma_tpu_torch.format.properties import LzmaParams
    from lzma_tpu_torch.parallel import mesh, multihost
    from lzma_tpu_torch.utils.profiling import PhaseTimer

    multihost.initialize(init_method, MESH_RANKS, rank, "gloo", "cuda")
    try:
        m = multihost.global_mesh("cuda")
        with open(data_path, "rb") as f:
            data = f.read()
        with open(os.path.join(out_dir, "dict.bin"), "rb") as f:
            dictionary = f.read()
        params = LzmaParams()
        # the CUDA context and the kernels' library, on every rank
        mesh.encode_blocks_mesh(data[: MESH_RANKS * MAIN_BLOCK], params,
                                block_size=MAIN_BLOCK, mesh=m)
        rec = {"device": str(m.device), "per_card": m.per_card}

        def keep(name, blob):
            if rank == 0:
                with open(os.path.join(out_dir, f"{name}.bin"), "wb") as f:
                    f.write(blob)

        for parse in ("lazy", "optimal"):
            timer = PhaseTimer()
            blob, secs, launches = counted_call(lambda: mesh.encode_blocks_mesh(
                data, params, block_size=MAIN_BLOCK, mesh=m, parse=parse,
                timer=timer))
            rec[parse] = dict(seconds=secs, launches=launches, **timer.totals)
            keep(parse, blob)
        back, secs, launches = counted_call(
            lambda: mesh.decode_blocks_mesh(blob, mesh=m))
        rec["decode"] = dict(seconds=secs, launches=launches,
                             equal=back == data)
        for name, kw in (("v2", dict(preset_len=MESH_PRESET)),
                         ("v3", dict(dictionary=dictionary))):
            blob, secs, launches = counted_call(lambda: mesh.encode_blocks_mesh(
                data, params, block_size=MAIN_BLOCK, mesh=m, **kw))
            rec[name] = dict(seconds=secs, launches=launches)
            keep(name, blob)
        blob, secs, launches = counted_call(
            lambda: mesh.encode_blocks_mesh_hybrid(data, params,
                                                   block_size=MAIN_BLOCK,
                                                   mesh=m))
        rec["hybrid"] = dict(seconds=secs, launches=launches)
        keep("hybrid", blob)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        torch.distributed.destroy_process_group()


def mesh_nccl_phase(dev, card, data, params, lazy_blob, opt_blob, hybrid_blob):
    """Phase 20: the block mesh over an NCCL group of one rank in this
    process.  Its lazy and optimal containers are phases 6 and 7's,
    gather=True writes the same, v2 and v3 equal api.encode_blocks with
    the same arguments, the mesh hybrid is phase 16's container, and each
    round-trips through decode_blocks_mesh; K2, K3 and K6 launch in its
    encodes and K1 in its decodes.  Returns those launches (encodes,
    decodes), each summed over the mesh's calls, and the v2 and v3
    containers and the v3 dictionary ({"v2", "v3", "dictionary"})."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist
    from lzma_tpu_torch.ops import api
    from lzma_tpu_torch.parallel import mesh, multihost
    from lzma_tpu_torch.utils.dicttrain import train_dictionary

    mb = len(data) / 1e6
    enc = {k: 0 for k in counters()}
    dec = dict(enc)
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "lzma_tpu_torch", "_build")

    def check(name, got, want):
        if got != want:
            raise AssertionError(f"[mesh] {name} differs")

    def add(total, launches):
        for k, v in launches.items():
            total[k] += v

    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        multihost.initialize("file://" + os.path.join(tmp, "store"), 1, 0,
                             "nccl", "cuda")
        try:
            m = multihost.global_mesh("cuda")
            if (m.world, m.backend, m.device) != (1, "nccl", dev):
                raise AssertionError(f"[mesh] {m}")
            # NCCL builds its communicator at the group's first collective
            _, t_first, _ = counted_call(lambda: dist.all_gather(
                [torch.empty(1, device=dev)], torch.zeros(1, device=dev)))
            lines = [f"the group's first all_gather (NCCL's communicator) "
                     f"{t_first:.3f} s"]
            cases = [("lazy", dict(parse="lazy"), lazy_blob),
                     ("optimal", dict(parse="optimal"), opt_blob),
                     ("lazy, gather=True", dict(gather=True), lazy_blob),
                     (f"v2 preset_len={MESH_PRESET}",
                      dict(preset_len=MESH_PRESET), None)]
            t = time.perf_counter()
            dictionary = train_dictionary(data, MESH_DICT)
            lines.append(f"train_dictionary {time.perf_counter() - t:.3f} s "
                         f"for a {len(dictionary)} B dictionary")
            cases.append((f"v3 dictionary of {len(dictionary)} B",
                          dict(dictionary=dictionary), None))
            kept = {"dictionary": dictionary}
            for name, kw, want in cases:
                gather = kw.get("gather", False)
                api_kw = {k: v for k, v in kw.items() if k != "gather"}
                blob, t_mesh, launches = counted_call(
                    lambda: mesh.encode_blocks_mesh(
                        data, params, block_size=MAIN_BLOCK, mesh=m, **kw))
                add(enc, launches)
                want_blob, t_api, _ = counted_call(
                    lambda: api.encode_blocks(data, params,
                                              block_size=MAIN_BLOCK, device=dev,
                                              **api_kw))
                check(f"{name} container (against api.encode_blocks)", blob,
                      want_blob)
                if want is not None:
                    check(f"{name} container (against phase 6/7's)", blob, want)
                back, t_dec, launches = counted_call(
                    lambda: mesh.decode_blocks_mesh(blob, mesh=m, gather=gather))
                add(dec, launches)
                check(f"{name} round trip", back, data)
                if name[:2] in ("v2", "v3"):
                    kept[name[:2]] = blob
                lines.append(
                    f"{name}: encode {t_mesh:.3f} s = {mb / t_mesh:.3f} MB/s "
                    f"(api.encode_blocks {t_api:.3f} s = {mb / t_api:.3f} MB/s), "
                    f"decode {t_dec:.3f} s = {mb / t_dec:.3f} MB/s, {len(blob)} B")
            blob, t_h, _ = counted_call(lambda: mesh.encode_blocks_mesh_hybrid(
                data, params, block_size=MAIN_BLOCK, mesh=m))
            check("hybrid container (against phase 16's)", blob, hybrid_blob)
            lines.append(f"hybrid: encode {t_h:.3f} s = {mb / t_h:.3f} MB/s, "
                         "= phase 16's container")
        finally:
            dist.destroy_process_group()
    if min(enc["rc_serialize"], enc["dp_parse"], enc["classify_tokens"],
           enc["lower"], enc["lower_counts"], enc["search_keys"],
           enc["suffix_table"], enc["match_lists"], enc["dp_inputs"],
           enc["path_mark"], enc["path_compact"], enc["doubling_groups"],
           enc["descent_lcp"], enc["best_matches"], enc["price_model"],
           enc["rep0_trace"], enc["list_pairs"], dec["ring_decode"]) < 1:
        raise AssertionError(f"[mesh] a kernel did not run: encodes {enc}, "
                             f"decodes {dec}")
    log(f"[mesh NCCL world 1] {len(data)} B in {len(data) // MAIN_BLOCK} lanes "
        f"of {MAIN_BLOCK} B on {card}: " + "; ".join(lines)
        + f"; launches in the mesh encodes {enc}, decodes {dec}")
    return enc, dec, kept


def mesh_gloo_phase(card, data, lazy_blob, opt_blob, hybrid_blob, kept):
    """Phase 21: MESH_RANKS Gloo ranks (spawned, mesh_rank) whose kernels
    share the one card, the collectives on host tensors: rank 0's lazy
    and optimal containers are phases 6 and 7's, its v2 and v3 containers
    phase 20's (`kept`, with the v3 dictionary), its mesh-hybrid container
    phase 16's; every rank's decode gives the input; K2 and K6 (K3 in the
    optimal encode) launch on every rank, and K1 in every rank's
    decode."""
    import os
    import tempfile

    import torch

    torch.cuda.empty_cache()
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "lzma_tpu_torch", "_build")
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        path = os.path.join(tmp, "data.bin")
        with open(path, "wb") as f:
            f.write(data)
        with open(os.path.join(tmp, "dict.bin"), "wb") as f:
            f.write(kept["dictionary"])
        t = time.perf_counter()
        torch.multiprocessing.start_processes(
            mesh_rank, args=("file://" + os.path.join(tmp, "store"), path, tmp),
            nprocs=MESH_RANKS, start_method="spawn")
        t_all = time.perf_counter() - t
        recs = []
        for r in range(MESH_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                recs.append(json.load(f))
        for name, want in (("lazy", lazy_blob), ("optimal", opt_blob),
                           ("v2", kept["v2"]), ("v3", kept["v3"]),
                           ("hybrid", hybrid_blob)):
            with open(os.path.join(tmp, f"{name}.bin"), "rb") as f:
                if f.read() != want:
                    raise AssertionError(
                        f"[mesh] {MESH_RANKS}-rank Gloo {name} container "
                        "differs from world 1's (phases 6, 7, 16, 20)")
        for r, rec in enumerate(recs):
            for parse in ("lazy", "optimal"):
                got = rec[parse]["launches"]
                if min(got["rc_serialize"], got["classify_tokens"],
                       got["search_keys"], got["suffix_table"],
                       got["path_mark"], got["path_compact"]) < 1 or (
                        parse == "optimal" and min(
                            got["dp_parse"], got["lower_counts"],
                            got["match_lists"], got["dp_inputs"],
                            got["price_model"], got["rep0_trace"],
                            got["list_pairs"]) < 1) or (
                        parse == "lazy" and min(
                            got["doubling_groups"], got["descent_lcp"],
                            got["best_matches"]) < 1):
                    raise AssertionError(f"[mesh] rank {r} {parse}: {got}")
            if not rec["decode"]["equal"] or \
                    rec["decode"]["launches"]["ring_decode"] < 1:
                raise AssertionError(f"[mesh] rank {r} decode: {rec['decode']}")
    log(f"[mesh Gloo {MESH_RANKS} ranks] on {card}, every rank's kernels on "
        f"{recs[0]['device']} ({recs[0]['per_card']} ranks a card), "
        f"{len(data) // MAIN_BLOCK // MESH_RANKS} lanes a rank; the ranks' "
        f"run {t_all:.3f} s (spawn, the CUDA contexts, a warm-up); "
        + "; ".join(
            f"{parse}: " + ", ".join(
                f"rank {r} encode {rec[parse]['seconds']:.3f} s (shard "
                f"{rec[parse]['shard']:.3f} s, gather {rec[parse]['gather']:.3f} s)"
                for r, rec in enumerate(recs))
            for parse in ("lazy", "optimal"))
        + "; " + "; ".join(
            f"{name}: " + ", ".join(
                f"rank {r} {rec[name]['seconds']:.3f} s "
                f"{rec[name]['launches']}" for r, rec in enumerate(recs))
            for name in ("decode", "v2", "v3", "hybrid"))
        + "; rank 0's containers (lazy, optimal, v2, v3, hybrid) = world 1's, "
        "every rank's decode = the input")


def auto_phase(dev, card, data):
    """Phase 22: select_params and select_dictionary on the first AUTO_SIZE
    bytes in AUTO_BLOCK blocks (LzmaParams() defaults) choose
    PIN_AUTO_PARAMS and the PIN_AUTO_DICT_SHA256 dictionary (the JAX
    package's choices); compress(params="auto") equals the optimal
    api.encode_blocks with the chosen params, and compress(params="auto",
    train_dict="auto") the same with the chosen dictionary (LZTB v3);
    both round-trip.  Returns the chosen params and dictionary."""
    import os

    import lzma_tpu_torch
    from lzma_tpu_torch.format.properties import LzmaParams
    from lzma_tpu_torch.ops import api
    from lzma_tpu_torch.utils.autotune import select_params
    from lzma_tpu_torch.utils.dicttrain import select_dictionary

    part = data[:AUTO_SIZE]
    t = time.perf_counter()
    chosen = select_params(part, LzmaParams(), block_size=AUTO_BLOCK)
    t_params = time.perf_counter() - t
    if (chosen.lc, chosen.lp, chosen.pb) != PIN_AUTO_PARAMS:
        raise AssertionError(f"[auto] select_params chose {chosen}")
    t = time.perf_counter()
    dictionary = select_dictionary(part, LzmaParams(), block_size=AUTO_BLOCK)
    t_dict = time.perf_counter() - t
    digest = hashlib.sha256(dictionary).hexdigest()
    if (len(dictionary), digest) != (AUTO_DICT_LEN, PIN_AUTO_DICT_SHA256):
        raise AssertionError(f"[auto] select_dictionary chose {len(dictionary)} "
                             f"B, sha256 {digest}")
    lines = []
    for what, kw, want_kw in (
            ('params="auto"', dict(params="auto"), {}),
            ('params="auto", train_dict="auto"',
             dict(params="auto", train_dict="auto"),
             dict(dictionary=dictionary))):
        blob, t_auto, auto_launches = counted_call(
            lambda: lzma_tpu_torch.compress(part, block_size=AUTO_BLOCK,
                                            device=dev, **kw))
        want, t_enc, _ = counted_call(
            lambda: api.encode_blocks(part, chosen, block_size=AUTO_BLOCK,
                                      parse="optimal", device=dev, **want_kw))
        if blob != want:
            raise AssertionError(f"[auto] compress({what}) differs from "
                                 "api.encode_blocks with its choices")
        back, t_dec, dec_launches = counted_call(
            lambda: lzma_tpu_torch.decompress(blob, device=dev))
        if back != part:
            raise AssertionError(f"[auto] compress({what}) does not round-trip")
        if min(auto_launches["rc_serialize"], auto_launches["classify_tokens"],
               auto_launches["suffix_table"], auto_launches["path_mark"],
               auto_launches["path_compact"],
               dec_launches["ring_decode"]) < 1 or (
                   not want_kw and min(auto_launches["dp_parse"],
                                       auto_launches["search_keys"],
                                       auto_launches["match_lists"],
                                       auto_launches["dp_inputs"],
                                       auto_launches["price_model"],
                                       auto_launches["rep0_trace"],
                                       auto_launches["list_pairs"]) < 1):
            raise AssertionError(f"[auto] a kernel did not run: {auto_launches}, "
                                 f"decode {dec_launches}")
        lines.append(
            f"compress({what}) {t_auto:.3f} s (the selections on the host "
            f"and the encode), {len(blob)} B = api.encode_blocks with the "
            f"choices, whose encode on the card took {t_enc:.3f} s; launches "
            f"{auto_launches}; decompress {t_dec:.3f} s, K1 "
            f"{dec_launches['ring_decode']}")
    log(f"[auto] {len(part)} B in {AUTO_BLOCK} B blocks on {card} with "
        f"{os.cpu_count()} host CPUs (os.cpu_count): select_params "
        f"{t_params:.3f} s -> lc{chosen.lc} lp{chosen.lp} pb{chosen.pb}; "
        f"select_dictionary {t_dict:.3f} s -> {len(dictionary)} B, sha256 = "
        "the JAX package's choices; " + "; ".join(lines))
    return chosen, dictionary


def cli_auto_phase(dev, card, data, chosen, dictionary):
    """Phase 23: `python -m lzma_tpu_torch e -tune -tdauto -bs{AUTO_BLOCK}
    -d22 -fb32` (LzmaParams()'s dict and fast bytes; the command line's
    own defaults are LzmaAlone's) and `d` on the first AUTO_SIZE bytes, in
    a temporary directory under lzma_tpu_torch/_build: the file is
    api.encode_blocks with the auto phase's choices on the command line's
    -bs route (the lazy parse, as lzma_tpu's -backendtpu; the front door's
    optimal parse codes the v3 dictionary's own stream otherwise) and
    reads back."""
    import os
    import tempfile

    from lzma_tpu_torch.ops import api

    part = data[:AUTO_SIZE]
    root = os.path.dirname(os.path.abspath(__file__))
    work_dir = os.path.join(root, "lzma_tpu_torch", "_build")
    os.makedirs(work_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work_dir) as tmp:
        src, enc, dec = (os.path.join(tmp, x) for x in ("in", "in.lztb", "out"))
        with open(src, "wb") as f:
            f.write(part)
        t = time.perf_counter()
        out = run_cli(["e", "-tune", "-tdauto", f"-bs{AUTO_BLOCK}", "-d22",
                       "-fb32", src, enc])
        secs = [time.perf_counter() - t]
        tuned = "".join(ln for ln in out.splitlines() if ln.startswith("tuned:"))
        t = time.perf_counter()
        run_cli(["d", "-q", enc, dec])
        secs.append(time.perf_counter() - t)
        with open(enc, "rb") as f:
            cli_blob = f.read()
        with open(dec, "rb") as f:
            cli_back = f.read()
    want = api.encode_blocks(part, chosen, block_size=AUTO_BLOCK,
                             dictionary=dictionary, device=dev)
    want_tuned = "tuned: -lc{} -lp{} -pb{}".format(*PIN_AUTO_PARAMS)
    if tuned != want_tuned or cli_blob != want or cli_back != part:
        raise AssertionError(f"[cli auto] {tuned!r}; the file equals "
                             f"api.encode_blocks': {cli_blob == want}; reads "
                             f"back: {cli_back == part}")
    log(f"[cli auto] python -m lzma_tpu_torch e -tune -tdauto -bs{AUTO_BLOCK} "
        f"-d22 -fb32 / d on {len(part)} B on {card}: '{tuned}', {len(cli_blob)} "
        f"B = api.encode_blocks (lazy) with the auto phase's choices, round "
        f"trip; e {secs[0]:.3f} s, d {secs[1]:.3f} s (each a process)")


def file_phase(dev, card, data, lazy_blob, opt_blob):
    """Phase 26: the LZTB file codec on files past one-shot capacity, in a
    temporary directory under lzma_tpu_torch/_build.  file128M-opt: phase
    6's input tiled FILE_OPT_TILES times through compress_file
    (parse="optimal") and decompress_file; file256M-lazy: tiled
    FILE_LAZY_TILES times through `python -m lzma_tpu_torch e -bs{N}` and
    `d`, each a process.  Each container is phase 7's (6's) header for
    the tiled size and its streams repeated, with the stdlib reading a
    sample of the blocks; each round trip hashes to the input's SHA-256.
    Every batch (filestream's batch log) peaks at or below its modelled
    bytes plus 10% and, with what was allocated before it, at or below
    80% of the card; K1, K2, K6, K7 (and K3 under the optimal parse) launch.
    Then an open("wb") writer fed FILE_WRITE-byte writes over the first
    FILE_WRITER_TILES tiles equals compress_file's container of those
    bytes, and open("rb") reads it back in FILE_WRITE-byte reads.
    Returns {config: launches}."""
    import os
    import shutil
    import tempfile

    import torch
    import lzma_tpu_torch
    from lzma_tpu_torch.format.properties import LzmaParams
    from lzma_tpu_torch.parallel import blocks as blk
    from lzma_tpu_torch.parallel import filestream

    if len(data) % MAIN_BLOCK:
        raise AssertionError("the tiled input must keep whole blocks")
    params = LzmaParams()
    total_mem = torch.cuda.get_device_properties(dev).total_memory

    def tiled(path, tiles):
        digest = hashlib.sha256()
        with open(path, "wb") as f:
            for _ in range(tiles):
                f.write(data)
                digest.update(data)
        return digest.hexdigest()

    def sha(path):
        digest = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 24), b""):
                digest.update(chunk)
        return digest.hexdigest()

    def container(blob, tiles):
        """`blob` (phase 6 or 7's container) as the container of its input
        tiled `tiles` times: the header, the sizes and the streams
        repeated."""
        frame = blk.parse_container(blob)
        n = len(frame.comp_sizes)
        head = blk.pack_header(params, MAIN_BLOCK, len(data) * tiles, n * tiles)
        return (head + blob[frame.payload_offset - 4 * n:frame.payload_offset]
                * tiles, blob[frame.payload_offset:])

    def check_file(path, blob, tiles):
        want_head, payload = container(blob, tiles)
        with open(path, "rb") as f:
            got_head = f.read(len(want_head))
            chunks = [f.read(len(payload)) for _ in range(tiles)]
            tail = f.read(1)
        if got_head != want_head or tail or any(c != payload for c in chunks):
            raise AssertionError(f"{path}: not the {tiles}-fold container")
        # the stdlib reads a sample of the blocks: the first, one in the
        # middle, the last
        with open(path, "rb") as f:
            params_f, bs, total, n, *_ = blk.read_header(f)
        frame = blk.parse_container(blob)
        offs, sizes = frame.stream_extents(len(blob))
        per = len(sizes)
        for i in (0, n // 2, n - 1):
            j = i % per
            alone = (params_f.encode_props() + sizes[j].to_bytes(8, "little")
                     + blob[offs[j]:offs[j + 1]])
            if lzma.decompress(alone, format=lzma.FORMAT_ALONE) != \
                    data[j * bs:j * bs + sizes[j]]:
                raise AssertionError(f"stdlib lzma disagrees on block {i}")
        return n

    def batches(log_path, kind):
        with open(log_path) as f:
            lines = [json.loads(ln) for ln in f if ln.strip()]
        lines = [ln for ln in lines if ln["kind"] == kind]
        for ln in lines:
            if ln["peak"] > 1.1 * ln["estimate"] or \
                    ln["base"] + ln["peak"] > 0.8 * total_mem:
                raise AssertionError(f"a {kind} batch outgrew its model: {ln}")
        return lines

    def report(name, lines, secs, size):
        launches = {}
        for ln in lines:
            for k, v in ln["launches"].items():
                launches[k] = launches.get(k, 0) + v
        log(f"[{name} {lines[0]['kind']}] {len(lines)} batches of "
            f"{[ln['blocks'] for ln in lines]} blocks on {card}: "
            f"{secs:.3f} s = {size / 1e6 / secs:.3f} MB/s; peak / model MiB "
            + ", ".join(f"{ln['peak'] / 2**20:.1f}/{ln['estimate'] / 2**20:.1f}"
                        for ln in lines)
            + f" (allocated before the first {lines[0]['base'] / 2**20:.1f} "
            f"MiB; card {total_mem / 2**20:.0f} MiB); batch seconds "
            + ", ".join(f"{ln['seconds']:.3f}" for ln in lines)
            + f"; launches {launches}")
        return launches

    root = os.path.dirname(os.path.abspath(__file__))
    work_dir = os.path.join(root, "lzma_tpu_torch", "_build")
    os.makedirs(work_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=work_dir)
    log_path = os.path.join(tmp, "batches.jsonl")
    os.environ[filestream.BATCH_LOG_ENV] = log_path
    found = {}
    try:
        # file128M-opt: the front door in this process
        src, enc, back = (os.path.join(tmp, x) for x in ("o.in", "o.lztb",
                                                          "o.out"))
        want = tiled(src, FILE_OPT_TILES)
        size = len(data) * FILE_OPT_TILES
        torch.cuda.synchronize()
        t = time.perf_counter()
        n_out = lzma_tpu_torch.compress_file(src, enc, params,
                                             block_size=MAIN_BLOCK,
                                             parse="optimal", device=dev)
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t
        t = time.perf_counter()
        n_back = lzma_tpu_torch.decompress_file(enc, back, device=dev)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t
        n = check_file(enc, opt_blob, FILE_OPT_TILES)
        if n_back != size or n_out != os.path.getsize(enc) or sha(back) != want:
            raise AssertionError("file128M-opt does not round-trip")
        log(f"[file128M-opt] {size} B in {n} blocks of {MAIN_BLOCK} B: "
            f"{n_out} B (ratio {n_out / size:.4f}) = phase 7's container "
            f"{FILE_OPT_TILES}-fold; decompress_file's SHA-256 = the input's; "
            "the stdlib reads blocks 0, n/2, n-1")
        launches = report("file128M-opt", batches(log_path, "encode"), t_enc,
                          size)
        dec_launches = report("file128M-opt", batches(log_path, "decode"),
                              t_dec, size)
        launches["ring_decode"] += dec_launches["ring_decode"]
        # the optimal parse at fb 32 runs no prefix doubling (K15-K17);
        # no path calls K6 since K19 classifies the tokens
        if min(v for k, v in launches.items()
               if k not in LAZY_KERNELS and k != "classify") < 1:
            raise AssertionError(f"a kernel did not run: {launches}")
        found["file128M-opt"] = launches
        for x in (src, enc, back, log_path):
            os.remove(x)

        # file256M-lazy: the command line, each command a process
        src, enc, back = (os.path.join(tmp, x) for x in ("l.in", "l.lztb",
                                                          "l.out"))
        want = tiled(src, FILE_LAZY_TILES)
        size = len(data) * FILE_LAZY_TILES
        # the processes size their batches from the card's free memory:
        # hand back what this process's cache holds unallocated
        torch.cuda.empty_cache()
        t = time.perf_counter()
        run_cli(["e", f"-bs{MAIN_BLOCK}", "-d22", "-fb32", "-q", src, enc])
        t_enc = time.perf_counter() - t
        t = time.perf_counter()
        run_cli(["d", "-q", enc, back])
        t_dec = time.perf_counter() - t
        n = check_file(enc, lazy_blob, FILE_LAZY_TILES)
        if sha(back) != want:
            raise AssertionError("file256M-lazy does not round-trip")
        log(f"[file256M-lazy] {size} B in {n} blocks of {MAIN_BLOCK} B: "
            f"{os.path.getsize(enc)} B = phase 6's container "
            f"{FILE_LAZY_TILES}-fold; d's SHA-256 = the input's; the stdlib "
            "reads blocks 0, n/2, n-1; seconds are each a process's")
        launches = report("file256M-lazy", batches(log_path, "encode"), t_enc,
                          size)
        dec_launches = report("file256M-lazy", batches(log_path, "decode"),
                              t_dec, size)
        launches["ring_decode"] += dec_launches["ring_decode"]
        if min(v for k, v in launches.items()
               if k not in ("dp_parse", "lower_counts", "search_keys",
                            "match_lists", "dp_inputs", "price_model",
                            "classify", "rep0_trace", "list_pairs")) < 1:
            raise AssertionError(f"a kernel did not run: {launches}")
        found["file256M-lazy"] = launches
        for x in (src, enc, back):
            os.remove(x)

        # the file objects: FILE_WRITE-byte writes, then reads
        part = data * FILE_WRITER_TILES
        path = os.path.join(tmp, "w.lztb")
        t = time.perf_counter()
        with lzma_tpu_torch.open(path, "wb", params=params,
                                 block_size=MAIN_BLOCK, device=dev) as w:
            for i in range(0, len(part), FILE_WRITE):
                w.write(part[i:i + FILE_WRITE])
        t_w = time.perf_counter() - t
        check_file(path, opt_blob, FILE_WRITER_TILES)
        t = time.perf_counter()
        got = bytearray()
        with lzma_tpu_torch.open(path, "rb", device=dev) as r:
            for chunk in iter(lambda: r.read(FILE_WRITE), b""):
                got += chunk
        t_r = time.perf_counter() - t
        if got != part:
            raise AssertionError("open('rb') does not read the writer's file back")
        log(f"[file objects] open('wb') fed {len(part) // FILE_WRITE} writes of "
            f"{FILE_WRITE} B: compress_file's container of those "
            f"{len(part)} B ({t_w:.3f} s); open('rb') read it back in "
            f"{FILE_WRITE}-byte reads ({t_r:.3f} s) on {card}")
    finally:
        del os.environ[filestream.BATCH_LOG_ENV]
        shutil.rmtree(tmp, ignore_errors=True)
    return found


def bench_phase(card):
    """Phase 24: the benchmark `b` in this process through cli.main, so
    that the launch counts can be read: `b {BENCH_PASSES_TPU}`
    (-backendtpu: ops.api.encode_stream and decode_stream, one lane, dict
    2 MiB, 4 MiB a pass) launches K6, K7, K10 and K2 once a pass and K1
    twice; `b {BENCH_PASSES_HYBRID} -backendhybrid` (the hybrid's stream,
    decoded on the card) K9, K10 and K11 once a pass, K1 twice and none of
    K6, K7 and K2.  The harness
    CRC-checks every decode.  Returns the launches {backend: {kernel: n}}."""
    import contextlib
    import io

    from lzma_tpu_torch import cli

    got = {}
    for backend, passes in (("tpu", BENCH_PASSES_TPU),
                            ("hybrid", BENCH_PASSES_HYBRID)):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc, secs, launches = counted_call(
                lambda: cli.main(["b", str(passes), f"-backend{backend}"]))
        report = [ln.strip() for ln in out.getvalue().splitlines()
                  if "KB/s" in ln]
        tpu = backend == "tpu"
        # the lazy stream's search K9, K15 five times, K16, K10 and K17 a
        # pass; the hybrid's list search (fb 32) K9, K10 and K11 once a
        # pass
        want = dict(ring_decode=2 * passes, dp_parse=0, classify=0,
                    classify_tokens=passes if tpu else 0, rep0_trace=0,
                    list_pairs=0,
                    lower=passes if tpu else 0, lower_counts=0,
                    rc_serialize=passes if tpu else 0,
                    search_keys=passes, suffix_table=passes,
                    match_lists=0 if tpu else passes, dp_inputs=0,
                    path_mark=passes if tpu else 0,
                    path_compact=passes if tpu else 0,
                    doubling_groups=5 * passes if tpu else 0,
                    descent_lcp=passes if tpu else 0,
                    best_matches=passes if tpu else 0, price_model=0)
        if rc != 0 or launches != want or len(report) != passes + 1:
            raise AssertionError(f"[b -backend{backend}] rc {rc}, launches "
                                 f"{launches} (want {want})\n{out.getvalue()}")
        got[backend] = launches
        log(f"[b -backend{backend}] {passes} passes of {1 << 22} B (dict 2 MiB) "
            f"on {card}, CRC-checked: " + " | ".join(report)
            + f"; wall {secs:.3f} s; launches {launches}")
    return got


def dp_ratio_phase(dev, card):
    """Phase 25: bench.py:556-563's device_dp_ratio on the card: the first
    DP_RATIO_SIZE bytes of the text corpus, dict 64 KiB, fb 32, 64 KiB
    blocks, the optimal parse: DP_RATIO_BYTES bytes, ratio DP_RATIO
    (BENCH_r05), PIN_DP_RATIO_SHA256 (lzma_tpu.ops.api.encode_blocks'
    container); round trip; the stdlib reads every block."""
    from lzma_tpu_torch.bench.corpus import text_part
    from lzma_tpu_torch.format.properties import LzmaParams
    from lzma_tpu_torch.ops import api

    part = text_part()[:DP_RATIO_SIZE]
    params = LzmaParams(dict_size=1 << 16, fast_bytes=32)
    blob, t_enc, launches = counted_call(lambda: api.encode_blocks(
        part, params, block_size=DP_RATIO_BLOCK, parse="optimal", device=dev))
    digest = hashlib.sha256(blob).hexdigest()
    ratio = round(len(part) / len(blob), 3)
    if (len(blob), ratio, digest) != (DP_RATIO_BYTES, DP_RATIO,
                                      PIN_DP_RATIO_SHA256):
        raise AssertionError(f"[dp ratio] {len(blob)} B, ratio {ratio}, "
                             f"sha256 {digest}")
    back, t_dec, dec_launches = counted_call(
        lambda: api.decode_blocks(blob, device=dev))
    if back != part:
        raise AssertionError("[dp ratio] the container does not round-trip")
    stdlib_reads_every_block(blob, part, params)
    log(f"[dp ratio] {len(part)} B of text in {DP_RATIO_BLOCK} B blocks, dict "
        f"64 KiB, fb 32, optimal, on {card}: {len(blob)} B, ratio {ratio} "
        f"(BENCH_r05 device_dp_ratio {DP_RATIO}), sha256 = the JAX package's; "
        f"encode {t_enc:.3f} s {launches}, decode {t_dec:.3f} s "
        f"{dec_launches}; every block decodes with the stdlib lzma module")


def main():
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} x{torch.cuda.device_count()}  torch {torch.__version__}"
        f"  cuda {torch.version.cuda}")

    from lzma_tpu_torch.bench.corpus import text_part
    from lzma_tpu_torch.bench.datagen import generate_bench_data
    from lzma_tpu_torch.core.layout import ProbLayout
    from lzma_tpu_torch.format.properties import LzmaParams, decode_props
    from lzma_tpu_torch.ops import (api, cuda_classify, cuda_decoder,
                                    cuda_lower, cuda_parser, cuda_ring,
                                    cuda_serializer)
    from lzma_tpu_torch.ops.device_decoder import CapExceededError, pad_rows
    from lzma_tpu_torch.ops.device_encoder import (_append_eos_tokens,
                                                   _classify_rows,
                                                   classify_tokens,
                                                   encode_batch,
                                                   pair_counts, probing,
                                                   tokenize)
    from lzma_tpu_torch.ops import (cuda_inputs, cuda_lazy, cuda_path,
                                    cuda_search, device_matcher,
                                    device_parser)
    from lzma_tpu_torch.ops.device_matcher import LAZY_STAGES
    from lzma_tpu_torch.ops.device_parser import (MODEL_STAGES, SEARCH_STAGES,
                                                  tokenize_optimal)
    from lzma_tpu_torch.ops.hybrid import DEFAULT_TIERS
    from lzma_tpu_torch.parallel import blocks as blk
    from lzma_tpu_torch.probes._cuda import event_ms
    from lzma_tpu_torch.runtime import build
    from lzma_tpu_torch.runtime.card import smem_limit

    phase_t = [time.perf_counter()]

    def done(name):
        now = time.perf_counter()
        log(f"[{name}] phase {now - phase_t[0]:.1f} s")
        phase_t[0] = now

    # ---- 2. build ----
    lib = build.build(verbose=True)
    build.load()
    log(f"[build] {lib}")
    done("build")

    # ---- 3. kernels vs plain versions, small shapes ----
    params = LzmaParams()
    arena = ProbLayout(params.lc, params.lp, params.pb, pos_bits=params.pb).size
    blocks = lane_blocks(CMP_LANES, CMP_BYTES, seed=1)
    ctx, bits, totals, max_out = lowered(blocks, params, dev)
    # an arena over the card's shared memory goes to device memory: lc8
    # lp4's size, on these streams and on lc8 lp4's own
    big = LzmaParams(lc=8, lp=4)
    big_arena = ProbLayout(big.lc, big.lp, big.pb, pos_bits=big.pb).size
    limit = smem_limit(dev.index or 0)
    placed = (cuda_serializer.arena_placement(arena, limit),
              cuda_serializer.arena_placement(big_arena, limit))
    if placed != ("shared", "device"):
        raise AssertionError(f"K2 placements {placed} for arenas {arena}, "
                             f"{big_arena} under {limit} B")
    k2_err, k_out, k_lens, _ = check_serializer(ctx, bits, totals, arena,
                                                int(max_out), (big_arena,))
    b_ctx, b_bits, b_totals, b_max = lowered(blocks, big, dev)
    err, b_out, b_lens, _ = check_serializer(b_ctx, b_bits, b_totals,
                                             big_arena, int(b_max))
    k2_err = max(k2_err, err)
    del b_ctx, b_bits, b_totals
    log(f"[K2 vs plain] {CMP_LANES}x{CMP_BYTES}: bytes and lens equal with the "
        f"arena ({arena} probabilities) in shared memory and, at lc8 lp4's "
        f"size ({big_arena}), in device memory ({limit} B a block); lc8 lp4's "
        f"own streams in device memory and equal")
    # K1 in both placements: lc3 lp0's arena in shared memory (below), lc8
    # lp4's in device memory, on lc8 lp4's streams that K2 just coded
    placed = (cuda_ring.arena_placement(arena, limit),
              cuda_ring.arena_placement(big_arena, limit))
    if placed != ("shared", "device"):
        raise AssertionError(f"K1 placements {placed} for arenas {arena}, "
                             f"{big_arena} under {limit} B")
    b_lens = b_lens.cpu().tolist()
    comp, comp_lens = pad_rows([b_out[i, :b_lens[i]].cpu().numpy().tobytes()
                                for i in range(len(blocks))], dev)
    sizes = torch.tensor([len(b) for b in blocks], dtype=torch.int32, device=dev)
    mo = 1 << (max(len(b) for b in blocks) - 1).bit_length()
    k1_err, d_out, _ = check_decoder(comp, comp_lens, sizes, big, mo,
                                     resident=False)
    for i, b in enumerate(blocks):
        if d_out[i, :len(b)].cpu().numpy().tobytes() != b:
            raise AssertionError(f"lc8 lp4 lane {i} does not round-trip in K1")
    del b_out
    log(f"[K1 vs plain] {CMP_LANES}x{CMP_BYTES}, lc8 lp4's streams with K1's "
        "arena in device memory: out/ok/out_pos equal, round trip")
    lens_h = k_lens.cpu().tolist()
    streams = [k_out[i, :lens_h[i]].cpu().numpy().tobytes() for i in range(len(blocks))]
    comp, comp_lens = pad_rows(streams, dev)
    sizes = torch.tensor([len(b) for b in blocks], dtype=torch.int32, device=dev)
    mo = 1 << (max(len(b) for b in blocks) - 1).bit_length()
    err, d_out, _ = check_decoder(comp, comp_lens, sizes, params, mo)
    k1_err = max(k1_err, err)
    for i, b in enumerate(blocks):
        if d_out[i, :len(b)].cpu().numpy().tobytes() != b:
            raise AssertionError(f"lane {i} does not round-trip")
    log(f"[K1, K5 vs plain] {CMP_LANES}x{CMP_BYTES}: out/ok/out_pos equal, "
        "round trip")

    # a preset-primed batch, encoded by the port's own encoder on the card
    preset = blocks[3][:1024]
    p_blocks = [b[:1024] for b in blocks[:4]]
    p_streams = encode_batch(p_blocks, params, preset=preset, device=dev)
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
    log("[K1, K5 vs plain] preset-primed batch from the port's encoder: "
        "equal, round trip")

    k3_err = 0
    for fb_s in (8, params.fast_bytes, 273):
        s_params = LzmaParams(fast_bytes=fb_s)
        packed, tables, lens = dp_round_inputs(blocks, s_params, dev)
        err, _ = check_scans(packed, tables, lens.to(torch.int32), fb_s,
                             s_params.pb)
        k3_err = max(k3_err, err)
        C = packed.shape[2]
        k4_plan = cuda_parser.dp_parse2_plan(fb_s, s_params.pb, C)
        log(f"[K3, K4 vs plain] {CMP_LANES}x{CMP_BYTES}, fb {fb_s} (K3 "
            f"{cuda_parser.dp_parse_plan(fb_s, s_params.pb, C)[0]} threads, "
            f"K4 {k4_plan[0]} threads, band {k4_plan[1]}): from and choice "
            "equal")

    # K6, K19, K7 and K8 on both parses' tokens of the same lanes, the EOS
    # marker appended
    k6_err = k7_err = k8_err = 0
    row_err = dict.fromkeys(ROW_KERNELS, 0)
    c_data, c_lens = pad_rows(blocks, dev)
    for parse in ("lazy", "optimal"):
        if parse == "lazy":
            tok = tokenize(c_data, c_lens, c_data.shape[1], params.fast_bytes)
        else:
            tok = tokenize_optimal(c_data, c_lens, c_data.shape[1], lc=params.lc,
                                   lp=params.lp, pb=params.pb,
                                   fb=params.fast_bytes)
        eos_tok = _append_eos_tokens(*tok[:4], tok[4], c_lens)
        err, _ = check_classify(_classify_rows(*eos_tok[1:]))
        k6_err = max(k6_err, err)
        err, _ = check_classify_tokens((c_data, *eos_tok))
        row_err["classify_tokens"] = max(row_err["classify_tokens"], err)
        meta = classify_tokens(c_data, *eos_tok)
        c_args = (tuple(m.long() for m in meta), *eos_tok, params.lc,
                  params.lp, params.pb, 10 * c_data.shape[1] + 128, 0)
        err, _ = check_lower(c_args)
        k7_err = max(k7_err, err)
        err, _ = check_counts(c_args)
        k8_err = max(k8_err, err)
        log(f"[K6, K19, K7, K8 vs plain] {CMP_LANES}x{CMP_BYTES}, {parse} "
            f"parse with the EOS marker ({eos_tok[0].shape[1]} token rows, "
            f"{int(eos_tok[3].sum(1).max())} valid in the longest lane): case, "
            "state and r0 equal; the seven classify planes equal; ctx, bits "
            "and total equal; n, n1 and total equal")
    # K7 and K8 at lc8 lp4 pb4 on a preset-primed batch (coded positions
    # from pos_base), as the port's own encoder lowers it: K8 counts its
    # 3,147,574 slots a lane in device memory, lc3 lp0's in shared memory
    big_slots = ProbLayout(8, 4, 4, pos_bits=4).size
    placed = (cuda_lower.count_placement(arena, limit),
              cuda_lower.count_placement(big_slots, limit))
    if placed != ("shared", "device"):
        raise AssertionError(f"K8 placements {placed} for {arena} and "
                             f"{big_slots} slots under {limit} B")
    with probing() as l_probe:
        encode_batch(p_blocks, LzmaParams(lc=8, lp=4, pb=4), preset=preset,
                     device=dev)
    err, _ = check_lower(l_probe["lower_args"])
    k7_err = max(k7_err, err)
    err, _ = check_counts(l_probe["lower_args"])
    k8_err = max(k8_err, err)
    log(f"[K7, K8 vs plain] lc8 lp4 pb4, {len(p_blocks)} lanes primed with a "
        f"{len(preset)} B preset (pos_base {l_probe['lower_args'][-1]}): ctx, "
        f"bits and total equal; n, n1 and total equal ({big_slots} slots a "
        "lane in device memory)")
    del l_probe
    # K8 on one MAIN_BLOCK lane of literals only (the hot slots)
    lit_args = literal_args(pad_rows([text_part()[:MAIN_BLOCK]], dev)[0],
                            params.lc, params.lp, params.pb)
    err, _ = check_counts(lit_args)
    k8_err = max(k8_err, err)
    log(f"[K8 vs plain] one lane of {MAIN_BLOCK} literals (text): n, n1 and "
        f"total equal ({arena} slots a lane in shared memory)")
    del lit_args
    # K9, K10 and K11 through _rmq_search on the same 8 lanes, lane 0 all
    # zeros (one hash group), lanes 1 and 2 of 0 and 3 bytes
    s_data, s_lens = pad_rows(blocks, dev)
    s_data[0] = 0
    s_lens[1], s_lens[2] = 0, 3
    search_err = dict.fromkeys(SEARCH_KERNELS, 0)
    lazy_err = dict.fromkeys(LAZY_KERNELS, 0)
    for fb_s, tiers, cap, order in SEARCH_CASES:
        tiers = DEFAULT_TIERS if tiers == "hybrid" else tiers
        (_, seen), seen_l = spied_lazy(lambda: spied_search(
            lambda: device_matcher._rmq_search(
                s_data, s_lens, s_data.shape[1], fb_s, tiers, cap, order)))
        if set(seen) != set(SEARCH_KERNELS):
            raise AssertionError(f"the search at fb {fb_s} ran {sorted(seen)}")
        errs, _ = check_search(seen)
        for k, v in errs.items():
            search_err[k] = max(search_err[k], v)
        # past fb 32 the prefix doubling: K15 five times, K16 once
        want = {"doubling_groups": 5, "descent_lcp": 1} if fb_s > 32 else {}
        if {k: len(v) for k, v in seen_l.items()} != want:
            raise AssertionError(f"the search at fb {fb_s} ran the lazy "
                                 f"kernels {sorted(seen_l)}")
        for k, v in check_lazy(seen_l)[0].items():
            lazy_err[k] = max(lazy_err[k], v)
        width = seen["match_lists"][1][0].shape[2]
        log(f"[K9, K10, K11 vs plain] {CMP_LANES}x{CMP_BYTES} (an all-zero "
            f"lane, lanes of 0 and 3 bytes), fb {fb_s}, "
            f"{'DEFAULT_TIERS' if tiers else 'DP_TIERS'}, cap {cap} {order!r} "
            f"({width} a list; K10 {'given' if fb_s > 32 else 'computing'} "
            "the consecutive LCP): keys, rank, T, lens, dists and counts equal")
    del seen
    # K12, K13 and K14 through tokenize_optimal (and K13 and K14 through
    # the lazy tokenize, from position 0 and from a preset's end) on the
    # same lanes at fb 5, 32 and 273 and at lc8 lp4 pb4, K12's literal
    # slots read from device memory (as at every lc and lp)
    row_cases = [(fb_s, params) for fb_s in (5, 32, 273)] + [
        (32, LzmaParams(lc=8, lp=4, pb=4))]
    for fb_s, r_params in row_cases:
        _, seen = spied_rows(lambda: tokenize_optimal(
            s_data, s_lens, s_data.shape[1], lc=r_params.lc,
            lp=r_params.lp, pb=r_params.pb, fb=fb_s))
        if set(seen) != {w for ws in ROW_KERNELS.values() for w in ws}:
            raise AssertionError(f"tokenize_optimal at fb {fb_s} ran "
                                 f"{sorted(seen)}")
        errs, _ = check_rows(seen)
        for k, v in errs.items():
            row_err[k] = max(row_err[k], v)
        log(f"[K18, K12, K13, K14, K19, K20, K21 vs plain] "
            f"{CMP_LANES}x{CMP_BYTES} (an all-zero lane, lanes of 0 and 3 "
            f"bytes), fb {fb_s}, lc{r_params.lc} lp{r_params.lp} "
            f"pb{r_params.pb}: the price planes, distance tables and DP "
            "tables' row, the DP rows, the seed's and the last round's marks "
            "and tokens, the last round's classify planes and rep0 trace, "
            "the DP pairs and the seed's pairs equal")
    for start in (0, CMP_BYTES // 8):
        (_, seen), seen_l = spied_lazy(lambda: spied_rows(
            lambda: device_matcher.tokenize(
                s_data, s_lens, s_data.shape[1], params.fast_bytes,
                start=start)))
        errs, _ = check_rows(seen)
        for k, v in errs.items():
            row_err[k] = max(row_err[k], v)
        if {k: len(v) for k, v in seen_l.items()} != dict(
                doubling_groups=5, descent_lcp=1, best_matches=1):
            raise AssertionError(f"the lazy tokenize ran {sorted(seen_l)}")
        for k, v in check_lazy(seen_l)[0].items():
            lazy_err[k] = max(lazy_err[k], v)
    log(f"[K13, K14, K15, K16, K17 vs plain] the lazy tokenize of the same "
        f"lanes from position 0 and {CMP_BYTES // 8}: the doubling's five "
        "levels (ids and keys), the descent's LCP, the best matches, marks "
        "and tokens equal; K15 and K16 in the search at fb 273 too")
    del seen, seen_l, s_data, s_lens
    done("small shapes")

    # ---- 4. the pinned containers (card vs the JAX reference) ----
    data, pparams, pblock = pin_input()
    for parse, pin in (("lazy", PIN_SHA256), ("optimal", PIN_OPT_SHA256)):
        blob = api.encode_blocks(data, pparams, block_size=pblock, parse=parse,
                                 device=dev)
        digest = hashlib.sha256(blob).hexdigest()
        if digest != pin:
            raise AssertionError(f"{parse} container hash {digest} != {pin}")
        if api.decode_blocks(blob, device=dev) != data:
            raise AssertionError(f"{parse} pinned container does not round-trip")
        log(f"[pin] {parse}, {len(data) // pblock} lanes: sha256 {digest} "
            "matches the JAX reference; round trip ok")
    done("pins")

    # ---- 5. the bench's device round trip ----
    data, bparams, bblock = bench_input()
    t = time.perf_counter()
    blob = api.encode_blocks(data, bparams, block_size=bblock, parse="optimal",
                             device=dev)
    t_enc = time.perf_counter() - t
    t = time.perf_counter()
    back = api.decode_blocks(blob, device=dev)
    t_dec = time.perf_counter() - t
    ratio = len(data) / len(blob)
    digest = hashlib.sha256(blob).hexdigest()
    if back != data:
        raise AssertionError("bench config does not round-trip")
    if len(blob) != BENCH_BYTES or round(ratio, 3) != BENCH_RATIO:
        raise AssertionError(f"bench config: {len(blob)} B, ratio {ratio:.4f}; "
                             f"the reference gives {BENCH_BYTES} B, {BENCH_RATIO}")
    if digest != PIN_BENCH_SHA256:
        raise AssertionError(f"bench container hash {digest} != {PIN_BENCH_SHA256}")
    stdlib_reads_every_block(blob, data, bparams)
    log(f"[bench] {len(data)} B in {len(data) // bblock} lanes of {bblock} B, "
        f"optimal: {len(blob)} B, ratio {ratio:.3f} (JAX reference "
        f"{BENCH_RATIO}), sha256 matches; encode {t_enc:.3f} s, decode "
        f"{t_dec:.3f} s on {card}; every block decodes with the stdlib lzma module")
    bench = (data, bparams, bblock, blob)
    done("bench config")

    # ---- 6. the lazy path at 8 MiB ----
    data = text_part() + generate_bench_data(5 << 20)
    params = LzmaParams()
    mb = len(data) / 1e6
    lazy_blob, t_enc, t_dec, launches, peak, _ = drive(api, data, params,
                                                       "lazy", dev)
    lazy_launches = launches
    # the lazy search: K9 its keys, K15 its five doubling levels, K16 the
    # descent, K10 the table, K17 the best matches; its path K13, K14
    if launches["rc_serialize"] < 1 or launches["ring_decode"] < 1 \
            or launches["classify_tokens"] != 1 or launches["classify"] \
            or launches["rep0_trace"] or launches["list_pairs"] \
            or launches["lower"] != 1 \
            or launches["lower_counts"] != 0 or launches["search_keys"] != 1 \
            or launches["suffix_table"] != 1 or launches["match_lists"] != 0 \
            or launches["dp_inputs"] != 0 or launches["path_mark"] != 1 \
            or launches["path_compact"] != 1 \
            or launches["doubling_groups"] != 5 \
            or launches["descent_lcp"] != 1 or launches["best_matches"] != 1 \
            or launches["price_model"] != 0:
        raise AssertionError(f"a kernel did not run on the lazy path: {launches}")
    log(f"[lazy] {len(data)} B in {len(data) // MAIN_BLOCK} lanes of {MAIN_BLOCK} B "
        f"on {card}: encode {t_enc:.3f} s = {mb / t_enc:.3f} MB/s, decode "
        f"{t_dec:.3f} s = {mb / t_dec:.3f} MB/s, ratio "
        f"{len(lazy_blob) / len(data):.4f}, peak device memory "
        f"{peak / 2**20:.1f} MiB, launches {launches}; every block decodes "
        "with the stdlib lzma module")
    # the same encode inside probing(): the lazy tokenize's stages, and
    # K15-K17's calls (spied: their whole-lane arguments), each timed
    # alone by CUDA events beside its bound
    with probing() as probe:
        t = time.perf_counter()
        again, seen_lazy = spied_lazy(lambda: api.encode_blocks(
            data, params, block_size=MAIN_BLOCK, parse="lazy", device=dev))
        torch.cuda.synchronize()
        t_probed = time.perf_counter() - t
    if again != lazy_blob:
        raise AssertionError("the probed lazy encode wrote another container")
    secs, l_peaks = probe["seconds"], probe["peak_bytes"]
    lazy_tok_ms = sum(sum(secs[k]) for k in LAZY_STAGES) * 1e3
    log(f"[lazy stages] probed lazy encode {t_probed:.3f} s (unprobed "
        f"{t_enc:.3f} s), ms / peak MiB above the stage's start: "
        + ", ".join(f"{k} {sum(v) * 1e3:.1f}"
                    + (f" ({len(v)} calls)" if len(v) > 1 else "")
                    + f" / {max(l_peaks[k]) / 2**20:.1f}"
                    for k, v in secs.items())
        + f"; tokenize (the sum of {', '.join(LAZY_STAGES)}) "
        f"{lazy_tok_ms:.1f} ms")
    lazy_calls, lazy_bounds = lazy_times(seen_lazy)
    lazy_whole = {k: sum(v) for k, v in lazy_calls.items()}
    log(f"[K15, K16, K17 whole lanes] main8M-lazy's {len(data) // MAIN_BLOCK} "
        f"lanes x {MAIN_BLOCK} positions on {card}, each kernel's calls of "
        "one search summed: " + "; ".join(
            f"{k} {lazy_whole[k]:.3f} ms in {len(seen_lazy[k])} call"
            + (f"s ({', '.join(f'{x:.3f}' for x in lazy_calls[k])})"
               if len(seen_lazy[k]) > 1 else "")
            + " (CUDA events, the "
            f"wrapper), {b[0][0]} B read and written, {b[0][1]} operations, "
            f"bound {b[1][0]:.4f} ms by {b[1][1]} "
            f"({lazy_whole[k] / b[1][0]:.1f}x)"
            for k, b in lazy_bounds.items()))
    # phase 9 holds them to their plain versions; the arguments wait in
    # host memory so that they take no room from phase 7's peak
    lazy_stash = _to("cpu", seen_lazy)
    del seen_lazy, probe, again
    gc.collect()
    done("lazy 8 MiB")

    # ---- 7. the main path: 8 MiB, optimal parse ----
    held = torch.cuda.memory_allocated(dev)
    blob, t_enc, t_dec, launches, peak, (offsets, bsizes) = drive(
        api, data, params, "optimal", dev)
    # the two rounds count their pairs (K8), the final tokens are lowered
    # (K7)
    # the search (K9, K10, K11) once: one lane group
    if launches["dp_parse"] < 2 or launches["rc_serialize"] < 1 \
            or launches["ring_decode"] < 1 or launches["classify_tokens"] != 3 \
            or launches["classify"] or launches["rep0_trace"] != 2 \
            or launches["list_pairs"] != 1 \
            or launches["lower"] != 1 or launches["lower_counts"] != 2 \
            or any(launches[k] != 1 for k in SEARCH_KERNELS) \
            or launches["dp_inputs"] != 2 or launches["path_mark"] != 3 \
            or launches["path_compact"] != 3 or launches["price_model"] != 2 \
            or any(launches[k] for k in LAZY_KERNELS):
        raise AssertionError(f"a kernel did not run on the main path: {launches}")
    if len(blob) >= len(lazy_blob):
        raise AssertionError(f"optimal container {len(blob)} B is not smaller "
                             f"than the lazy one, {len(lazy_blob)} B")
    log(f"[main] optimal, {len(data)} B in {len(bsizes)} lanes of {MAIN_BLOCK} B "
        f"on {card}: encode {t_enc:.3f} s = {mb / t_enc:.3f} MB/s, decode "
        f"{t_dec:.3f} s = {mb / t_dec:.3f} MB/s, round trip "
        f"{mb / (t_enc + t_dec):.3f} MB/s, ratio {len(blob) / len(data):.4f} "
        f"(lazy {len(lazy_blob) / len(data):.4f}), peak device memory "
        f"{peak / 2**20:.1f} MiB ({held / 2**20:.1f} MiB allocated before it "
        f"began), launches {launches}; every block decodes with the stdlib "
        "lzma module")
    # the same encode inside probing(): the stage breakdown and the
    # tensors phase 8 cuts (its launches are not the main path's)
    # (and K18's and K12-K14's last calls, spied: their whole-lane
    # arguments)
    with probing() as probe:
        t = time.perf_counter()
        again, seen_rows = spied_rows(lambda: api.encode_blocks(
            data, params, block_size=MAIN_BLOCK, parse="optimal", device=dev))
        torch.cuda.synchronize()
        t_probed = time.perf_counter() - t
    if again != blob:
        raise AssertionError("the probed optimal encode wrote another container")
    secs = probe["seconds"]
    stage_peaks = probe["peak_bytes"]
    round_stage_ms = {k: [x * 1e3 for x in secs[v]]
                      for k, v in ROUND_STAGES.items()}
    t_pos, t_len, t_valid, ctx, bits, totals = probe["lowered"]
    model_s = [sum(x) for x in zip(*(secs[k] for k in MODEL_STAGES))]
    # the stages K18 replaced, ms a call (empirical_probs stays, empty)
    model_stage_ms = {k: [x * 1e3 for x in secs[k]]
                      for k in ("empirical_probs", "build_price_model")}
    search_s = sum(sum(secs[k]) for k in SEARCH_STAGES)
    log(f"[stages] probed optimal encode {t_probed:.3f} s (unprobed "
        f"{t_enc:.3f} s), max tokens/lane {int(t_valid.sum(1).max())}, "
        f"max coded bits/lane {int(totals.max())}: "
        + ", ".join(f"{k} {sum(v) * 1e3:.1f} ms"
                    + (f" ({len(v)} calls: "
                       + " + ".join(f"{x * 1e3:.1f}" for x in v) + ")"
                       if len(v) > 1 else "")
                    for k, v in secs.items())
        + f"; model (the sum of {', '.join(MODEL_STAGES)}) "
        f"{sum(model_s) * 1e3:.1f} ms ({len(model_s)} calls: "
        + " + ".join(f"{x * 1e3:.1f}" for x in model_s)
        + f"); search (the sum of {', '.join(SEARCH_STAGES)}) "
        f"{search_s * 1e3:.1f} ms; decode {t_dec * 1e3:.1f} ms")
    # the whole-lane kernel stages beside their bounds at the main path's
    # full shapes (K3's work counted on the last round's inputs)
    L, N = t_pos.shape
    dp_whole = dp_work(probe["dp_inputs"][0], probe["dp_inputs"][2])
    log(f"[K3 work] whole lanes, {L} x {N} positions, C = "
        f"{probe['dp_inputs'][0].shape[2]}: {dp_whole[0]} B read and written, "
        f"{dp_whole[1]} operations")
    n_bits = int(totals.sum())
    n_comp = offsets[-1] - offsets[0]
    k2_whole_bound = bound(8 * n_bits + n_comp, 10 * n_bits)
    k1_whole_bound = bound(sum(bsizes) + n_comp, 0)
    whole = {
        "dp_parse": (secs["dp_parse"][-1], bound(*dp_whole)),
        "rc_serialize": (secs["rc_serialize"][-1], k2_whole_bound),
        "decode (K1 and its host work)": (t_dec, k1_whole_bound),
    }
    log(f"[whole lanes] {L} x {N} on {card}: " + "; ".join(
        f"{k} {s * 1e3:.1f} ms a call, bound {b[0]:.4f} ms by {b[1]}"
        for k, (s, b) in whole.items()))
    # K2 on the whole lanes' final (ctx, bit) streams and K1 on the whole
    # container's streams, each timed alone by CUDA events
    mo_main = MAIN_BLOCK + MAIN_BLOCK // 4 + 128
    k2_res = cuda_serializer.serialize_cuda(ctx, bits, totals, arena, mo_main)
    streams = [blob[offsets[i]:offsets[i + 1]] for i in range(len(bsizes))]
    k2_rows = k2_res[0].cpu().numpy()
    if not torch.equal(k2_res[2], totals) or k2_res[1].tolist() != [
            len(x) for x in streams] or any(
            k2_rows[i, :len(x)].tobytes() != x for i, x in enumerate(streams)):
        raise AssertionError("K2 on the whole lanes differs from the container")
    del k2_res, k2_rows
    k2_whole = event_ms(lambda: cuda_serializer.serialize_cuda(
        ctx, bits, totals, arena, mo_main), 3)
    comp, comp_lens = pad_rows(streams, dev)
    w_sizes = torch.tensor(bsizes, dtype=torch.int32, device=dev)
    wargs = (comp, comp_lens, w_sizes, params.dict_size, params.lc, params.lp,
             params.pb, MAIN_BLOCK)
    k1_out = cuda_ring.decode_cuda(*wargs)
    k1_rows = k1_out[0].cpu().numpy()
    if not bool(k1_out[1].all()) or any(
            k1_rows[i, :n].tobytes() != data[i * MAIN_BLOCK:i * MAIN_BLOCK + n]
            for i, n in enumerate(bsizes)):
        raise AssertionError("K1 on the whole container differs from the input")
    del k1_out, k1_rows
    k1_whole = event_ms(lambda: cuda_ring.decode_cuda(*wargs), 3)
    # K6 on the final tokens' rows (the last classify call's, K19's
    # arguments)
    c_rows = _classify_rows(*probe.pop("classify_args")[2:])
    k6_whole = event_ms(lambda: cuda_classify.classify_carry_cuda(*c_rows), 3)
    k6_work = classify_work(c_rows)
    k6_whole_bound = bound(*k6_work)
    k6_moved = classify_moved(c_rows)
    log(f"[K6 whole lanes] {c_rows[0].shape[1]} lanes x {c_rows[0].shape[0]} "
        f"token rows on {card}: classify carry {k6_whole:.3f} ms a call (CUDA "
        f"events), {k6_work[0]} B read and written, bound "
        f"{k6_whole_bound[0]:.4f} ms by {k6_whole_bound[1]}; the design moves "
        f"about {k6_moved} B by classify_moved's model ("
        f"{k6_moved / HBM_BYTES_PER_S * 1e3:.4f} ms at the HBM rate); "
        f"{k6_whole * 1e6 / int(t_valid.sum(1).max()):.1f} ns a token of the "
        "longest lane")
    # K7 on the final tokens (the last lowering's arguments)
    l_args = probe.pop("lower_args")
    k7_out = cuda_lower.lower_tokens_cuda(*l_args)
    if not all(torch.equal(a, b) for a, b in zip(k7_out, (ctx, bits, totals))):
        raise AssertionError("K7 on the final tokens differs from the encode's "
                             "(ctx, bit) streams")
    del k7_out
    k7_whole = event_ms(lambda: cuda_lower.lower_tokens_cuda(*l_args), 3)
    k7_work = lower_work(l_args, totals)
    k7_whole_bound = bound(*k7_work)
    n_tok_valid = int(l_args[4].sum())
    log(f"[K7 whole lanes] {L} lanes x {l_args[1].shape[1]} token slots "
        f"({n_tok_valid} valid tokens, {n_bits} pairs, max_bits {l_args[8]}) on "
        f"{card}: lower {k7_whole:.3f} ms a call (CUDA events, the wrapper with "
        f"its status readback), {k7_work[0]} B read and written, {k7_work[1]} "
        f"operations, bound {k7_whole_bound[0]:.4f} ms by {k7_whole_bound[1]} "
        f"({k7_whole / k7_whole_bound[0]:.1f}x); "
        f"{k7_whole * 1e6 / n_tok_valid:.2f} ns a token")
    # K8 on the last round's tokens (its lower_counts arguments), and the
    # route it replaced there, by CUDA events a call each: K7's planes of
    # the same tokens, then pair_counts' scatter-adds of them
    c_args = probe.pop("count_args")
    k8_out = cuda_lower.lower_counts_cuda(*c_args)
    r_planes = cuda_lower.lower_tokens_cuda(*c_args)
    if not (all(torch.equal(a, b) for a, b in zip(
            k8_out[:2], pair_counts(*r_planes, arena)))
            and torch.equal(k8_out[2], r_planes[2])):
        raise AssertionError("K8 on the round's tokens differs from "
                             "pair_counts of K7's planes")
    k8_whole = event_ms(lambda: cuda_lower.lower_counts_cuda(*c_args), 5)
    k8_planes = event_ms(lambda: cuda_lower.lower_tokens_cuda(*c_args), 3)
    k8_scatter = event_ms(lambda: pair_counts(*r_planes, arena), 3)
    k8_work = count_work(c_args, k8_out[2])
    k8_whole_bound = bound(*k8_work)
    n_round = int(c_args[4].sum())
    # printed after phase 18 with the call's grids: torch.profiler runs
    # there first, so that its traces are the first of the process
    k8_line = (
        f"[K8 whole lanes] the last round's {L} lanes x "
        f"{c_args[1].shape[1]} token slots ({n_round} valid tokens, "
        f"{int(k8_out[2].sum())} pairs, {arena} slots a lane, "
        f"{cuda_lower.count_placement(arena, limit)} memory) on {card}: "
        f"lower_counts {k8_whole:.3f} ms a call (CUDA events, the wrapper "
        f"with its status readback), {k8_work[0]} B read and written, "
        f"{k8_work[1]} operations, bound {k8_whole_bound[0]:.4f} ms by "
        f"{k8_whole_bound[1]} ({k8_whole / k8_whole_bound[0]:.1f}x); the "
        f"route it replaced: K7's planes {k8_planes:.3f} ms + pair_counts "
        f"{k8_scatter:.3f} ms = {k8_planes + k8_scatter:.3f} ms; n, n1 and "
        f"total equal to it; its device operations (torch.profiler, us a "
        f"launch x launches a call): ")
    del k8_out, r_planes
    # K9, K10 and K11 on the main path's whole lanes: the probed encode's
    # lanes through _rmq_search at the optimal route's statics, each
    # kernel's call timed alone by CUDA events
    m_data, m_lens = pad_rows([data[i:i + MAIN_BLOCK]
                               for i in range(0, len(data), MAIN_BLOCK)], dev)
    m_out, seen_main = spied_search(lambda: device_matcher._rmq_search(
        m_data, m_lens, min(params.dict_size, m_data.shape[1]),
        params.fast_bytes))
    del m_out
    search_whole = {}
    for name, (s_args, _) in seen_main.items():
        s_fn = getattr(cuda_search, SEARCH_KERNELS[name][0])
        search_whole[name] = event_ms(
            lambda f=s_fn, a=s_args: f(*_fresh(a)), 3)
    search_w = search_work(seen_main)
    search_bounds = {k: bound(*w) for k, w in search_w.items()}
    # K10's levels past its tiles: the route the wrapper takes at these
    # lanes (column stripes), and the same call with the other route (a
    # pass a level) forced, timed beside it and equal to it
    t_args, t_out = seen_main["suffix_table"]
    k10_route = cuda_search.upper_route(N, limit)[0]
    kept_route = cuda_search.upper_route
    cuda_search.upper_route = lambda max_n, lim: ("levels", 0)
    try:
        k10_levels_ms = event_ms(
            lambda: cuda_search.suffix_table_cuda(*t_args), 3)
        k10_levels_out = cuda_search.suffix_table_cuda(*t_args)
    finally:
        cuda_search.upper_route = kept_route
    if not all(torch.equal(a, b) for a, b in zip(k10_levels_out, t_out)):
        raise AssertionError("K10's per-level route differs from its "
                             "column stripes on the main path's lanes")
    del t_args, t_out, k10_levels_out
    search_lines = {
        k: f"{k} {search_whole[k]:.3f} ms a call (CUDA events, the wrapper), "
           f"{search_w[k][0]} B read and written, {search_w[k][1]} "
           f"operations, bound {search_bounds[k][0]:.4f} ms by "
           f"{search_bounds[k][1]} ({search_whole[k] / search_bounds[k][0]:.1f}x), "
           f"its device operations (torch.profiler, us a launch x launches "
           f"a call): " for k in SEARCH_KERNELS}
    search_head = (f"[K9, K10, K11 whole lanes] {L} lanes x {N} positions, "
                   f"DP_TIERS cut to 12 'rr', fb {params.fast_bytes}, on "
                   f"{card}: ")
    search_tail = (f"; {int(seen_main['match_lists'][1][2].sum())} pairs "
                   f"kept; K10's levels past its tiles by {k10_route} "
                   f"(the per-level passes forced: {k10_levels_ms:.3f} ms, "
                   "the same rank and T)")
    # the calls' arguments wait in host memory for their grids' traces
    grid_stash = _to("cpu", {"lower_counts": c_args, **{
        name: s_args for name, (s_args, _) in seen_main.items()},
        "dp_inputs": seen_rows["dp_inputs_cuda"][0],
        "price_model": seen_rows["price_model_cuda"][0], **{
            w: seen_rows[w][0] for w in PATH_WRAPPERS}})
    # K18 on the last round's counts, K12 on its rows, K13 and K14 on the
    # last round's DP path and the seed's lazy path, each call timed alone
    # by CUDA events
    row_whole, row_bounds = {}, {}
    for w, (r_args, r_out) in seen_rows.items():
        mod = _row_module(ROW_KERNELS[row_kernel(w)][w][0])
        row_whole[w] = event_ms(lambda f=getattr(mod, w), a=r_args: f(*a), 3)
        row_bounds[w] = (row_work(w, r_args, r_out),
                         bound(*row_work(w, r_args, r_out)))
    path_blocks = cuda_path.occupancy()
    k12_blocks = cuda_inputs.occupancy(
        seen_rows["dp_inputs_cuda"][0][1].shape[2])
    log(f"[K18, K12, K13, K14, K19, K20, K21 whole lanes] {L} lanes x {N} "
        f"positions on {card}: "
        + "; ".join(f"{w} {row_whole[w]:.3f} ms a call (CUDA events, the "
                    f"wrapper{' with its status readback' if 'mark' in w or 'rep0' in w else ''}"
                    f"), {b[0][0]} B read and written, {b[0][1]} operations, "
                    f"bound {b[1][0]:.4f} ms by {b[1][1]} "
                    f"({row_whole[w] / b[1][0]:.1f}x)"
                    for w, b in row_bounds.items())
        + f"; {int(seen_rows['extract_compact_cuda'][1][4].sum())} DP tokens, "
        f"{int(seen_rows['greedy_compact_cuda'][1][4].sum())} seed tokens; "
        f"K12 {k12_blocks} blocks an SM")
    log(f"[K2, K1 whole lanes] {L} lanes on {card}, CUDA events: rc_serialize "
        f"{k2_whole:.3f} ms a call ({n_bits} pairs, "
        f"{k2_whole * 1e6 / int(totals.max()):.1f} ns a pair of the longest "
        f"lane), bound {k2_whole_bound[0]:.4f} ms by {k2_whole_bound[1]}; "
        f"ring_decode {k1_whole:.3f} ms a call ({k1_whole * 1e6 / int(totals.max()):.1f} "
        f"ns a decoded bit of the longest lane, its bits = its coded pairs), "
        f"bound {k1_whole_bound[0]:.4f} ms by {k1_whole_bound[1]}")
    done("main path")

    # ---- 8. the K4 path at full width ----
    b_data, b_params, b_block, b_blob = bench
    b_blocks = [b_data[i:i + b_block] for i in range(0, len(b_data), b_block)]
    bd, bl = pad_rows(b_blocks, dev)
    tok_kw = dict(lc=b_params.lc, lp=b_params.lp, pb=b_params.pb,
                  fb=b_params.fast_bytes)
    dict_b = min(b_params.dict_size, bd.shape[1])   # as encode_batch passes it
    t = time.perf_counter()
    want = tokenize_optimal(bd, bl, dict_b, **tok_kw)
    torch.cuda.synchronize()
    t_band = time.perf_counter() - t
    cuda_parser.LAUNCHES2 = 0
    t = time.perf_counter()
    got = tokenize_optimal(bd, bl, dict_b, scan="band2", **tok_kw)
    torch.cuda.synchronize()
    t_band2 = time.perf_counter() - t
    k4_launches = cuda_parser.LAUNCHES2
    if k4_launches < 2:
        raise AssertionError(f"K4 ran {k4_launches} times in tokenize_optimal")
    for name, g, w in zip(("t_pos", "t_len", "t_dist", "t_valid", "ntok"),
                          got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"scan='band2' {name} differs from scan='band'")
    log(f"[K4 path] bench config, {len(b_blocks)} lanes of {b_block} B: "
        f"tokenize_optimal(scan='band2') = scan='band' token for token "
        f"(max {int(want[4].max())} tokens a lane); {t_band2:.3f} s against "
        f"{t_band:.3f} s; K4 launched {k4_launches} times")
    # K4 on the main path's own whole-lane DP inputs, against K3
    packed, tables, lens = probe["dp_inputs"]
    fb, pb = params.fast_bytes, params.pb
    k3_planes = cuda_parser.dp_parse_cuda(packed, tables, lens, fb, pb)
    k4_planes = cuda_parser.dp_parse2_cuda(packed, tables, lens, fb, pb)
    if not all(torch.equal(a, b) for a, b in zip(k3_planes, k4_planes)):
        raise AssertionError("K4's whole-lane planes differ from K3's")
    del k3_planes, k4_planes
    k3_whole = event_ms(lambda: cuda_parser.dp_parse_cuda(
        packed, tables, lens, fb, pb), 2)
    k4_whole = event_ms(lambda: cuda_parser.dp_parse2_cuda(
        packed, tables, lens, fb, pb), 2)
    whole_bound = bound(*dp_whole)
    log(f"[K4 whole lanes] main path's last DP round, {L} x {N} on {card}: "
        f"K4 planes = K3 planes; K4 {k4_whole:.3f} ms, K3 {k3_whole:.3f} ms a "
        f"call (CUDA events), bound {whole_bound[0]:.4f} ms by {whole_bound[1]}")
    done("K4 path")

    # ---- 9. kernels vs plain versions at the main path's shapes ----
    # K3 and K4: the last DP round's own inputs, each lane cut to CMP_POS
    # positions
    packed = probe.pop("dp_inputs")[0][:, :CMP_POS].contiguous()
    lens = torch.clamp(lens, max=CMP_POS).contiguous()
    k3_ms = event_ms(lambda: cuda_parser.dp_parse_cuda(
        packed, tables, lens, fb, pb), 5)
    k4_ms = event_ms(lambda: cuda_parser.dp_parse2_cuda(
        packed, tables, lens, fb, pb), 5)
    err, k3_plain = check_scans(packed, tables, lens, fb, pb)
    k3_err = max(k3_err, err)
    k3_bound = bound(*dp_work(packed, lens))
    # K2: the final lowering's (ctx, bit) streams, each lane cut to its
    # first CMP_BITS pairs
    cut_totals = torch.clamp(totals, max=CMP_BITS)
    k2_ms = event_ms(lambda: cuda_serializer.serialize_cuda(
        ctx, bits, cut_totals, arena, mo_main), 20)
    err, _, k2_lens, k2_plain = check_serializer(ctx, bits, cut_totals, arena,
                                                 mo_main)
    k2_err = max(k2_err, err)
    n_bits = int(cut_totals.sum())
    k2_bound = bound(8 * n_bits + int(k2_lens.sum()), 10 * n_bits)
    # K1: the main container's streams, each lane decoded up to the end of
    # its first token that reaches CMP_OUT bytes, a size the stream stops
    # at cleanly (K5's window cannot hold these lanes: phase 10)
    cuts = token_cut(t_pos, t_len, t_valid, CMP_OUT, bsizes)
    dargs = (comp, comp_lens, cuts, params.dict_size, params.lc,
             params.lp, params.pb, MAIN_BLOCK)
    k1_ms = event_ms(lambda: cuda_ring.decode_cuda(*dargs), 20)
    err, d_out, k1_plain = check_decoder(*dargs[:3], params, MAIN_BLOCK,
                                         resident=False)
    k1_err = max(k1_err, err)
    cuts = cuts.tolist()
    for i, n in enumerate(cuts):
        if d_out[i, :n].cpu().numpy().tobytes() != data[i * MAIN_BLOCK:i * MAIN_BLOCK + n]:
            raise AssertionError(f"lane {i} decodes wrong up to byte {n}")
    k1_bound = bound(decode_bytes(streams, cuts, bsizes), 0)
    # K6: the final tokens' whole rows, uncut (one plain call); K19 on the
    # same tokens, its plain version the finish on that plain carry (the
    # carry runs once)
    kept = {}
    err, k6_plain = check_classify(c_rows, kept)
    k6_err = max(k6_err, err)
    del c_rows
    k19_args, k19_out = seen_rows.pop("classify_tokens_cuda")
    err, k19_finish = check_classify_tokens(k19_args, k19_out, kept.pop("carry"))
    row_err["classify_tokens"] = max(row_err["classify_tokens"], err)
    row_plain_k19 = k6_plain + k19_finish
    del k19_args, k19_out, kept
    log(f"[K6, K19 vs plain] main path's final tokens, whole: case, state and "
        f"r0 equal, the seven classify planes equal; K6 kernel "
        f"{k6_whole:.3f} ms vs plain {k6_plain:.1f} ms, K19 kernel "
        f"{row_whole['classify_tokens_cuda']:.3f} ms vs plain "
        f"{row_plain_k19:.1f} ms (the carry's, then the finish's "
        f"{k19_finish:.1f} ms) on {card}")
    # K7: the final lowering's whole arguments, uncut (one plain call)
    err, k7_plain = check_lower(l_args)
    k7_err = max(k7_err, err)
    del l_args
    log(f"[K7 vs plain] main path's final tokens, whole: ctx, bits and total "
        f"equal; kernel {k7_whole:.3f} ms vs plain {k7_plain:.1f} ms on {card}")
    # K8: the last round's whole arguments, uncut (one plain call)
    err, k8_plain = check_counts(c_args)
    k8_err = max(k8_err, err)
    del c_args
    log(f"[K8 vs plain] main path's last round's tokens, whole: n, n1 and "
        f"total equal; kernel {k8_whole:.3f} ms vs plain {k8_plain:.1f} ms on "
        f"{card}")
    # K9, K10 and K11: the main path's whole lanes, uncut (one plain call
    # each)
    errs, search_plain = check_search(seen_main)
    for k, v in errs.items():
        search_err[k] = max(search_err[k], v)
    del seen_main
    log(f"[K9, K10, K11 vs plain] main path's whole lanes: keys, rank, T, "
        f"lens, dists and counts equal; " + ", ".join(
            f"{k} kernel {search_whole[k]:.3f} ms vs plain "
            f"{search_plain[k]:.1f} ms" for k in SEARCH_KERNELS)
        + f" on {card}")
    # K15, K16 and K17: main8M-lazy's whole-lane calls (phase 6), uncut
    # (one plain call a kernel call)
    errs, lazy_plain = check_lazy(_to(dev, lazy_stash))
    for k, v in errs.items():
        lazy_err[k] = max(lazy_err[k], v)
    del lazy_stash
    log(f"[K15, K16, K17 vs plain] main8M-lazy's whole lanes (the doubling's "
        f"five levels, the descent, the best matches): ids, keys, LCPs and "
        f"matches equal; " + ", ".join(
            f"{k} kernel {lazy_whole[k]:.3f} ms vs plain {lazy_plain[k]:.1f} ms"
            for k in LAZY_KERNELS) + f" on {card}")
    # K18, K12, K13 and K14: the main path's last calls, uncut (one plain
    # call each)
    errs, row_plain = check_rows(seen_rows)
    for k, v in errs.items():
        row_err[k] = max(row_err[k], v)
    row_plain["classify_tokens_cuda"] = row_plain_k19
    del seen_rows
    log(f"[K18, K12, K13, K14, K20, K21 vs plain] main path's whole lanes (the "
        f"last round's counts, rows and rep0 trace, its DP path, the seed's "
        f"lazy path, the lists' pairs): planes, tables, rows, marks, tokens, "
        f"traces and pairs equal; " + ", ".join(
            f"{w} kernel {row_whole[w]:.3f} ms vs plain {row_plain[w]:.1f} ms"
            for w in row_whole) + f" on {card}")
    log(f"[times] main path's shapes ({len(bsizes)} lanes x {MAIN_BLOCK} B) on "
        f"{card}: dp_parse kernel {k3_ms:.3f} ms, dp_parse2 kernel "
        f"{k4_ms:.3f} ms vs plain {k3_plain:.1f} ms ({CMP_POS} positions a "
        f"lane), bound {k3_bound[0]:.4f} ms by {k3_bound[1]}; rc_serialize "
        f"kernel {k2_ms:.3f} ms vs plain {k2_plain:.1f} ms ({CMP_BITS} pairs a "
        f"lane), bound {k2_bound[0]:.4f} ms by {k2_bound[1]}; ring_decode "
        f"kernel {k1_ms:.3f} ms vs plain {k1_plain:.1f} ms "
        f"({min(cuts)}..{max(cuts)} B a lane), bound {k1_bound[0]:.4f} ms by "
        f"{k1_bound[1]}; all equal")
    done("main shapes")

    # ---- 10. the K5 path at the widest shapes it serves ----
    frame = blk.parse_container(b_blob)
    b_offs, b_sizes = frame.stream_extents(len(b_blob))
    b_streams = [b_blob[b_offs[i]:b_offs[i + 1]] for i in range(len(b_sizes))]
    cuda_decoder.LAUNCHES = 0
    t = time.perf_counter()
    res = cuda_decoder.decode_batch_resident(b_streams, frame.params, b_sizes,
                                             device=dev)
    t_res = time.perf_counter() - t
    k5_launches = cuda_decoder.LAUNCHES
    ring = cuda_ring.decode_batch_cuda(b_streams, frame.params, b_sizes,
                                       device=dev)
    if k5_launches < 1 or res != b_blocks or ring != res:
        raise AssertionError("the bench config's streams through K5 differ "
                             f"from the input or from K1 ({k5_launches} launches)")
    log(f"[K5 path] bench config's {len(b_streams)} streams through "
        f"decode_batch_resident: equal to the input blocks and to K1; "
        f"{t_res:.3f} s, K5 launched {k5_launches} times")
    # K1's champion shape (bench.py:344-390): 128 lanes x 16 KiB, lc0,
    # dict 4 KiB, fb 8
    ch_params = LzmaParams(lc=0, dict_size=CH_DICT, fast_bytes=8)
    ch_data = generate_bench_data(CH_LANES * CH_BLOCK)
    ch_blocks = [ch_data[i:i + CH_BLOCK] for i in range(0, len(ch_data), CH_BLOCK)]
    with probing() as ch_probe:
        ch_streams = encode_batch(ch_blocks, ch_params, device=dev)
    comp, comp_lens = pad_rows(ch_streams, dev)
    full = torch.full((CH_LANES,), CH_BLOCK, dtype=torch.int32, device=dev)
    chargs = (comp, comp_lens, full, CH_DICT, 0, 0, ch_params.pb, CH_BLOCK)
    k5_res, k1_res = cuda_decoder.decode_resident(*chargs), cuda_ring.decode_cuda(*chargs)
    want_out = torch.frombuffer(bytearray(ch_data), dtype=torch.uint8).to(dev)
    if not (bool(k5_res[1].all()) and all(torch.equal(a, b) for a, b in zip(k5_res, k1_res))
            and torch.equal(k5_res[0].reshape(-1), want_out)):
        raise AssertionError("the champion shape through K5 differs from K1 "
                             "or from the input")
    k5_whole = event_ms(lambda: cuda_decoder.decode_resident(*chargs), 3)
    k1_champ = event_ms(lambda: cuda_ring.decode_cuda(*chargs), 3)
    ch_bound = bound(decode_bytes(ch_streams, [CH_BLOCK] * CH_LANES,
                                  [CH_BLOCK] * CH_LANES), 0)
    # K5 against its plain version on the same streams, each lane cut at
    # its first token boundary at or past CMP_OUT_K5 bytes
    ct_pos, ct_len, ct_valid = ch_probe["lowered"][:3]
    ch_cuts = token_cut(ct_pos, ct_len, ct_valid, CMP_OUT_K5,
                        [CH_BLOCK] * CH_LANES)
    cargs = (comp, comp_lens, ch_cuts, CH_DICT, 0, 0, ch_params.pb, CH_BLOCK)
    k5_ms = event_ms(lambda: cuda_decoder.decode_resident(*cargs), 20)
    k5_err, _, k5_plain = check_decoder(*cargs[:3], ch_params, CH_BLOCK)
    ch_cuts = ch_cuts.tolist()
    k5_bound = bound(decode_bytes(ch_streams, ch_cuts, [CH_BLOCK] * CH_LANES), 0)
    # one lane of the main path (256 KiB) is over the envelope
    before = cuda_decoder.LAUNCHES
    try:
        cuda_decoder.decode_batch_resident(streams[:1], params, bsizes[:1],
                                           device=dev)
    except ValueError as e:
        if type(e) is not ValueError or cuda_decoder.LAUNCHES != before:
            raise
        over = str(e)
    else:
        raise AssertionError("a 256 KiB lane did not raise in K5's wrapper")
    log(f"[K5 champion] {CH_LANES} x {CH_BLOCK} B, lc0, dict {CH_DICT}, fb 8 on "
        f"{card}: K5 = K1 = input; whole lanes K5 {k5_whole:.3f} ms, K1 "
        f"{k1_champ:.3f} ms (CUDA events), bound {ch_bound[0]:.4f} ms by "
        f"{ch_bound[1]} for both; cut to {min(ch_cuts)}..{max(ch_cuts)} B a lane: "
        f"K5 {k5_ms:.3f} ms vs plain {k5_plain:.1f} ms, bound "
        f"{k5_bound[0]:.5f} ms by {k5_bound[1]}, K1 and K5 equal to plain; "
        f"a main-path lane raises: {over}")
    done("K5 path")

    # ---- 11. the codec matrix (tools/chip_check.py:59-111 on the card) ----
    for total, bs, lc, lp, pb_, ps, dl in MATRIX:
        m_data = corpus(total)
        m_params = LzmaParams(lc=lc, lp=lp, pb=pb_, dict_size=1 << 14,
                              fast_bytes=16)
        kw = {}
        if ps:
            kw["preset_len"] = ps
        if dl:
            kw["dictionary"] = corpus(dl, seed=dl)
        for parse in ("lazy", "optimal"):
            m_blob = api.encode_blocks(m_data, m_params, block_size=bs,
                                       parse=parse, device=dev, **kw)
            if api.decode_blocks(m_blob, device=dev) != m_data:
                raise AssertionError(f"matrix {total} {bs} lc{lc}lp{lp}pb{pb_} "
                                     f"{parse} does not round-trip")
            stdlib = lc + lp <= 4 and not ps and not dl
            if stdlib:
                stdlib_reads_every_block(m_blob, m_data, m_params)
        log(f"[matrix] {total} B in {bs} B blocks, lc{lc} lp{lp} pb{pb_}, "
            f"preset {ps}, dictionary {dl}: lazy and optimal round-trip"
            + ("; the stdlib reads every block" if stdlib else ""))
    done("codec matrix")

    # ---- 12. the decoder matrix: K5 and K1 ----
    decoders = (("K5", cuda_decoder.decode_batch_resident),
                ("K1", cuda_ring.decode_batch_cuda))
    pr = LzmaParams(dict_size=1 << 12, fast_bytes=16)
    payloads = [corpus(16000 + 13 * i, seed=50 + i) for i in range(16)]
    sizes = [len(x) for x in payloads]
    pre = corpus(2048, seed=99)
    filt = [{"id": lzma.FILTER_LZMA1, "preset": 6, "dict_size": 1 << 16}]
    alone = [lzma.compress(x, format=lzma.FORMAT_ALONE, filters=filt)
             for x in payloads[:8]]
    eparams = decode_props(alone[0][:5])
    batches = [
        ("16 x 16 KiB, dict 4 KiB", encode_batch(payloads, pr, device=dev), pr,
         sizes, b"", payloads),
        ("preset-primed 8 x 16 KiB", encode_batch(payloads[:8], pr, preset=pre,
                                                 device=dev), pr, sizes[:8],
         pre, payloads[:8]),
        ("EOS lanes from the stdlib, caps past the end", [a[13:] for a in alone],
         eparams, [-(n + 4096) for n in sizes[:8]], b"", payloads[:8]),
    ]
    for what, m_streams, m_params, m_sizes, m_pre, m_want in batches:
        for name, fn in decoders:
            if fn(m_streams, m_params, m_sizes, preset=m_pre, device=dev) != m_want:
                raise AssertionError(f"matrix: {name} on {what} differs")
        log(f"[matrix] {what}: K5 and K1 give the input")
    for name, fn in decoders:
        try:
            fn(batches[2][1], eparams, [-(n // 2) for n in sizes[:8]], device=dev)
        except CapExceededError:
            continue
        raise AssertionError(f"matrix: {name} let an EOS lane past its cap")
    log("[matrix] EOS lanes with caps at half their size: K5 and K1 raise "
        "CapExceededError")
    done("decoder matrix")

    # ---- 13. the probes (tools/probe_*.py, P1-P15) ----
    p_cuts = token_cut(ct_pos[:PROBE_LANES], ct_len[:PROBE_LANES],
                       ct_valid[:PROBE_LANES], PROBE_CUT_OUT,
                       [CH_BLOCK] * PROBE_LANES)
    probe_records = probe_phase(
        dev, card, comp[:PROBE_LANES].contiguous(),
        comp_lens[:PROBE_LANES].contiguous(), p_cuts,
        want_out[:PROBE_LANES * CH_BLOCK].reshape(PROBE_LANES, CH_BLOCK))
    done("probes")

    # ---- 14. the .lzma path at full size, front door, CLI, entry ----
    stream_ms, stream_bounds, stream_errs, stream_launches, stream_k10, \
        stream_path = alone_phase(dev, card, data)
    for k, v in stream_path.items():
        row_err[k] = max(row_err[k], v["err"])
    search_err["suffix_table"] = max(search_err["suffix_table"],
                                     stream_k10["err"])
    k6_err = max(k6_err, stream_errs["classify"])
    row_err["classify_tokens"] = max(row_err["classify_tokens"],
                                     stream_errs["classify_tokens"])
    k7_err = max(k7_err, stream_errs["lower"])
    k2_err = max(k2_err, stream_errs["rc_serialize"])
    k1_err = max(k1_err, stream_errs["ring_decode"])
    for k in LAZY_KERNELS:
        lazy_err[k] = max(lazy_err[k], stream_errs[k])
    done("lzma stream")

    # ---- 15-17. the hybrid: pins, hybrid8M-opt, hybrid8M-lazy ----
    hybrid_k1, hybrid_search, hybrid_blob, hybrid_lazy = hybrid_phase(
        dev, card, data, params, blob, lazy_blob)
    done("hybrid")

    # ---- 18. main8M-opt under the profiler; peak memory by stage ----
    profile_phase(dev, card, data, params, blob, stage_peaks)
    # phase 7's K8 and K9-K11 lines, with each call's grids
    grids = {}
    for name, g_args in _to(dev, grid_stash).items():
        fn = (cuda_lower.lower_counts_cuda if name == "lower_counts"
              else cuda_inputs.dp_inputs_cuda if name == "dp_inputs"
              else _row_module("cuda_model").price_model_cuda
              if name == "price_model"
              else getattr(_row_module("cuda_path"), name)
              if name in PATH_WRAPPERS
              else getattr(cuda_search, SEARCH_KERNELS[name][0]))
        grids[name] = grid_split(lambda f=fn, a=g_args: f(*_fresh(a)))
    del grid_stash
    k8_grids = grids.pop("lower_counts")
    k12_grids = grids.pop("dp_inputs")
    k18_grids = grids.pop("price_model")
    path_grids = {w: grids.pop(w) for w in PATH_WRAPPERS}
    search_grids = grids
    log(k8_line + grid_text(k8_grids))
    log(f"[K12 grids] the last round's rows on {card}, its device operations "
        f"(torch.profiler, us a launch x launches a call): "
        + grid_text(k12_grids))
    log(f"[K18 grids] the last round's price model on {card}, its device "
        f"operations (torch.profiler, us a launch x launches a call): "
        + grid_text(k18_grids))
    log(search_head + "; ".join(search_lines[k] + grid_text(search_grids[k])
                                for k in SEARCH_KERNELS) + search_tail)
    log(f"[K13, K14 grids] the last round's DP path and the seed's lazy path "
        f"on {card}, each call's device operations (torch.profiler, us a "
        f"launch x launches a call; blocks an SM by csrc/path.cu's "
        f"lzt_path_occupancy: {path_blocks}): "
        + "; ".join(f"{w} " + grid_text(g) for w, g in path_grids.items()))
    torch.cuda.empty_cache()
    done("profile")

    # ---- 19. the trace dump on the card ----
    trace_k19 = trace_phase(dev, card, data, params)
    done("trace dump")

    # ---- 20-21. the block mesh: NCCL at world size 1, Gloo ranks on the card ----
    mesh_enc, mesh_dec, mesh_kept = mesh_nccl_phase(
        dev, card, data, params, lazy_blob, blob, hybrid_blob)
    done("mesh NCCL")
    mesh_gloo_phase(card, data, lazy_blob, blob, hybrid_blob, mesh_kept)
    done("mesh Gloo")

    # ---- 22-23. params="auto", train_dict="auto"; -tune -tdauto ----
    chosen, dictionary = auto_phase(dev, card, data)
    done("auto")
    cli_auto_phase(dev, card, data, chosen, dictionary)
    done("cli auto")

    # ---- 24. the benchmark b on both backends ----
    bench_launches = bench_phase(card)
    done("b")

    # ---- 25. device_dp_ratio ----
    dp_ratio_phase(dev, card)
    done("dp ratio")

    # ---- 26. the LZTB file codec: file128M-opt, file256M-lazy ----
    file_launches = file_phase(dev, card, data, lazy_blob, blob)
    done("files")

    # ---- 27. nothing of JAX or of the JAX package was loaded ----
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib")
                 or m == "lzma_tpu" or m.startswith("lzma_tpu."))
    if bad:
        raise AssertionError(f"JAX or lzma_tpu modules loaded: {bad[:8]}")
    log("[imports] no jax, jaxlib, lzma_tpu or lzma_tpu.* module loaded")
    log(f"[total] {time.perf_counter() - t_start:.1f} s")

    # beside the cut's numbers, each codec kernel's time over whole lanes
    # (CUDA events: the main path's for K1-K4 and K6, the champion's for
    # K5) and that work's bound; K6's ms is the whole main path's (its
    # plain version ran uncut there) and stream_ms the single stream's
    kernels = [
        record("dp_parse", "lzma_tpu_torch/csrc/dp_parse.cu",
               "lzma_tpu/ops/device_parser.py:804", launches["dp_parse"],
               k3_err, k3_ms, k3_plain, k3_bound, whole_ms=k3_whole,
               whole_bound_ms=whole_bound[0],
               mesh_launches=mesh_enc["dp_parse"],
               file_launches=file_launches["file128M-opt"]["dp_parse"]),
        record("dp_parse2", "lzma_tpu_torch/csrc/dp_parse2.cu",
               "lzma_tpu/ops/device_parser.py:1128", k4_launches, k3_err,
               k4_ms, k3_plain, k3_bound, whole_ms=k4_whole,
               whole_bound_ms=whole_bound[0], whole_k3_ms=k3_whole,
               design="carried band on K3's row tiles, a literal warp, "
                      "4 lanes a length"),
        record("rc_serialize", "lzma_tpu_torch/csrc/rc_serializer.cu",
               "lzma_tpu/ops/pallas_serializer.py:58", launches["rc_serialize"],
               k2_err, k2_ms, k2_plain, k2_bound, whole_ms=k2_whole,
               whole_bound_ms=k2_whole_bound[0],
               mesh_launches=mesh_enc["rc_serialize"],
               bench_launches=bench_launches["tpu"]["rc_serialize"],
               file_launches={k: v["rc_serialize"]
                              for k, v in file_launches.items()}),
        record("ring_decode", "lzma_tpu_torch/csrc/ring_decoder.cu",
               "lzma_tpu/ops/pallas_ring.py:89", launches["ring_decode"],
               k1_err, k1_ms, k1_plain, k1_bound, whole_ms=k1_whole,
               whole_bound_ms=k1_whole_bound[0], hybrid_launches=hybrid_k1,
               mesh_launches=mesh_dec["ring_decode"],
               bench_launches=bench_launches["tpu"]["ring_decode"],
               bench_hybrid_launches=bench_launches["hybrid"]["ring_decode"],
               file_launches={k: v["ring_decode"]
                              for k, v in file_launches.items()}),
        record("block_decode", "lzma_tpu_torch/csrc/block_decoder.cu",
               "lzma_tpu/ops/pallas_decoder.py:80", k5_launches, k5_err, k5_ms,
               k5_plain, k5_bound, whole_ms=k5_whole,
               whole_bound_ms=ch_bound[0]),
        record("classify_carry", "lzma_tpu_torch/csrc/classify.cu",
               "lzma_tpu/ops/device_encoder.py:85", launches["classify"],
               k6_err, k6_whole, k6_plain, k6_whole_bound, whole_ms=k6_whole,
               whole_bound_ms=k6_whole_bound[0], stream_ms=stream_ms["classify"],
               stream_bound_ms=stream_bounds["classify"][0],
               launches_of="the main path's: no path calls K6 since K19 "
                           "classifies the tokens around K6's scan grids; "
                           "this record holds K6's wrapper to the plain carry",
               ms_of="the main path's final tokens' rows",
               design="scan over each lane's token rows, five grids"),
        record("lower", "lzma_tpu_torch/csrc/lower.cu",
               "lzma_tpu/ops/device_encoder.py:163", launches["lower"],
               k7_err, k7_whole, k7_plain, k7_whole_bound, whole_ms=k7_whole,
               whole_bound_ms=k7_whole_bound[0], stream_ms=stream_ms["lower"],
               stream_bound_ms=stream_bounds["lower"][0],
               lazy_launches=lazy_launches["lower"],
               stream_launches=stream_launches["lower"],
               mesh_launches=mesh_enc["lower"],
               bench_launches=bench_launches["tpu"]["lower"],
               file_launches={k: v["lower"]
                              for k, v in file_launches.items()},
               design="tile sums, a lane scan, a fill of 16-byte words, "
                      "each round's pairs staged in shared memory and "
                      "written as 16-byte words"),
        record("lower_counts", "lzma_tpu_torch/csrc/lower.cu",
               "lzma_tpu/ops/device_parser.py:1669", launches["lower_counts"],
               k8_err, k8_whole, k8_plain, k8_whole_bound, whole_ms=k8_whole,
               whole_bound_ms=k8_whole_bound[0],
               route_ms=k8_planes + k8_scatter, route_planes_ms=k8_planes,
               route_pair_counts_ms=k8_scatter,
               lazy_launches=lazy_launches["lower_counts"],
               mesh_launches=mesh_enc["lower_counts"],
               bench_launches=bench_launches["tpu"]["lower_counts"],
               file_launches={k: v["lower_counts"]
                              for k, v in file_launches.items()},
               grids=k8_grids,
               design="a block a tile of 1,024 tokens (empty tiles end at "
                      "once), each round's counted pairs scanned and staged "
                      "in shared memory, the block walking the stage "
                      "converged into a shared-memory histogram of 32-bit "
                      "words, (count << 16) | ones, an add a pair (device "
                      "memory past the opt-in limit)"),
    ] + [
        record(name, "lzma_tpu_torch/csrc/search.cu", SEARCH_REPLACES[name][0],
               launches[name], search_err[name], search_whole[name],
               search_plain[name], search_bounds[name],
               jax_ref=SEARCH_REPLACES[name][1], whole_ms=search_whole[name],
               whole_bound_ms=search_bounds[name][0],
               lazy_launches=lazy_launches[name],
               hybrid_launches=hybrid_search[name],
               mesh_launches=mesh_enc[name],
               bench_launches=bench_launches["tpu"][name],
               bench_hybrid_launches=bench_launches["hybrid"][name],
               file_launches={k: v[name] for k, v in file_launches.items()},
               grids=search_grids[name], design=SEARCH_REPLACES[name][2],
               **({} if name != "suffix_table" else {
                   "upper_route": k10_route,
                   "levels_route_ms": k10_levels_ms,
                   "stream_places": stream_k10["places"],
                   "stream_upper_route": stream_k10["route"],
                   "stream_ms": stream_k10["ms"],
                   "stream_bound_ms": stream_k10["bound"][0],
                   "stream_plain_ms": stream_k10["plain_ms"],
                   "stream_max_abs_err": stream_k10["err"]}))
        for name in SEARCH_KERNELS] + [
        record(name, f"lzma_tpu_torch/csrc/{ROW_SOURCES[name]}.cu",
               ROW_REPLACES[name][0], launches[name], row_err[name],
               row_whole[main_w], row_plain[main_w], row_bounds[main_w][1],
               jax_ref=ROW_REPLACES[name][1], whole_ms=row_whole[main_w],
               whole_bound_ms=row_bounds[main_w][1][0],
               lazy_launches=lazy_launches[name],
               stream_launches=stream_launches[name],
               mesh_launches=mesh_enc[name],
               bench_launches=bench_launches["tpu"][name],
               file_launches={k: v[name] for k, v in file_launches.items()},
               design=ROW_REPLACES[name][2],
               **({"blocks_per_sm": k12_blocks, "grids": k12_grids}
                  if name == "dp_inputs" else {
                   "grids": k18_grids,
                   "stages_ms": model_stage_ms,
                   "ms_of": "the last round's counts (main8M-opt)"}
                  if name == "price_model" else {
                   "ms_of": ROUND_MS_OF[name],
                   "stage_ms": round_stage_ms[name],
                   **({"stream_ms": stream_ms[name],
                       "stream_bound_ms": stream_bounds[name][0],
                       "trace_launches": trace_k19}
                      if name == "classify_tokens" else {})}
                  if name in ROUND_WRAPPERS else {
                   "ms_of": f"{main_w} (the last round's DP path)",
                   "seed_ms": row_whole[seed_w],
                   "seed_plain_ms": row_plain[seed_w],
                   "seed_bound_ms": row_bounds[seed_w][1][0],
                   "grids": {"dp": path_grids[main_w],
                             "seed": path_grids[seed_w]},
                   "blocks_per_sm": path_blocks,
                   "stream_nodes": stream_path[name]["nodes"],
                   "stream_ms": stream_path[name]["ms"],
                   "stream_bound_ms": stream_path[name]["bound"][0],
                   "stream_plain_ms": stream_path[name]["plain_ms"],
                   "stream_max_abs_err": stream_path[name]["err"]}))
        for name, main_w, seed_w in (
            ("price_model", "price_model_cuda", None),
            ("dp_inputs", "dp_inputs_cuda", None),
            ("path_mark", "extract_mark_cuda", "greedy_mark_cuda"),
            ("path_compact", "extract_compact_cuda", "greedy_compact_cuda"),
            *((k, w, None) for k, w in ROUND_WRAPPERS.items()))
    ] + [
        record(name, "lzma_tpu_torch/csrc/lazy_search.cu",
               LAZY_REPLACES[name][0], lazy_launches[name], lazy_err[name],
               lazy_whole[name], lazy_plain[name], lazy_bounds[name][1],
               jax_ref=LAZY_REPLACES[name][1], whole_ms=lazy_whole[name],
               whole_bound_ms=lazy_bounds[name][1][0],
               ms_of="main8M-lazy's search, its calls summed",
               calls=len(lazy_calls[name]), calls_ms=lazy_calls[name],
               main_launches=launches[name],
               stream_launches=stream_launches[name],
               hybrid_launches=hybrid_lazy[name],
               mesh_launches=mesh_enc[name],
               bench_launches=bench_launches["tpu"][name],
               file_launches={k: v[name] for k, v in file_launches.items()},
               design=LAZY_REPLACES[name][2])
        for name in LAZY_KERNELS
    ] + probe_records
    if len(kernels) != 36:
        raise AssertionError(f"{len(kernels)} kernel records, not 36")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
