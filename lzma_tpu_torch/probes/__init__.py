"""The TPU probes of ``tools/probe_*.py`` asked again of the H100.

Each module keeps the name of the probe script it answers and the names
of its functions.  Every function takes its inputs as tensors: a CUDA
tensor launches its kernel (``csrc/probe_fsm.cu``, ``probe_gather.cu``,
``probe_copy.cu``, ``probe_ablate.cu``) or the wrapper raises; a CPU
tensor takes the plain PyTorch version beside it.  Each module counts
its launches by function in ``LAUNCHES`` and prints the probe's table on
the card from ``python -m lzma_tpu_torch.probes.<module>``.

- ``probe_fsm_cost``, ``probe_fsm_cost2``  a synthetic decode step's
  cost, its arena, window and input in shared or device memory
- ``probe_gather``, ``probe_gather2``  direct, one-hot and chained
  gathers and scatters
- ``probe_ring_ablate``, ``probe_packed_ablate``  K1's decode body with
  one part knocked out at a time
- ``probe_dma``, ``probe_dma2``  per-lane copies into shared memory:
  loads, ``cp.async`` and TMA bulk copies
"""
