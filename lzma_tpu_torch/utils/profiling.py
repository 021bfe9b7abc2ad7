"""Device-path profiling: phase timers that synchronise CUDA, and
torch.profiler traces with a reader of their device time.

Port of ``lzma_tpu/utils/profiling.py``: ``PhaseTimer`` keeps its
surface, synchronising the card where the JAX one blocks on arrays;
``profiler_trace`` takes the place of ``xla_trace`` and writes a Chrome
trace (Perfetto, chrome://tracing); ``device_busy`` reads one back.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

import torch

#: the Chrome trace categories of work on the card: what keeps it busy
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class PhaseTimer:
    """Accumulates wall-clock seconds per named phase.  Before a phase's
    clock stops, every CUDA device that holds a tensor of `sync_arrays` is
    synchronised, so the phase covers the work it queued there; the
    sequence is read when the phase ends, so a list the block fills
    works.  CPU tensors and other values need no wait."""

    def __init__(self):
        self.totals: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync_arrays=()):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            devices = {a.device for a in sync_arrays
                       if isinstance(a, torch.Tensor) and a.is_cuda}
            for d in devices:
                torch.cuda.synchronize(d)
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = [
            f"  {name:<24s} {t:8.3f}s  {100 * t / total:5.1f}%"
            for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def profiler_trace(logdir: str, device="cuda"):
    """Trace the block with torch.profiler (CPU and, for a CUDA `device`,
    CUDA activities) and write its Chrome trace into `logdir`.  Yields the
    profiler; its ``trace_path`` names the file, written when the block
    ends (the card synchronised first).  A CUDA `device` on a build whose
    profiler cannot trace CUDA raises: there is no CPU-only stand-in."""
    from torch.profiler import ProfilerActivity, profile, supported_activities

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        if not torch.cuda.is_available() or \
                ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError("profiler_trace: this torch build cannot trace "
                               "CUDA activity")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    fd, path = tempfile.mkstemp(prefix="trace_", suffix=".json", dir=logdir)
    os.close(fd)
    with profile(activities=activities) as prof:
        prof.trace_path = path
        yield prof
        if cuda:
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(path)


def device_busy(trace_path: str, top: int = 10) -> dict:
    """Read a Chrome trace (``profiler_trace``'s): the traced window (from
    the first event's start to the last one's end, microseconds), the
    card's busy time in it (the union of its kernel, memcpy and memset
    intervals), their share of the window, and the `top` device
    operations by total time as (name, total us, count)."""
    with open(trace_path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events]
    if not spans:
        return {"window_us": 0.0, "busy_us": 0.0, "busy_share": 0.0,
                "device_events": 0, "top": []}
    window = max(b for _, b in spans) - min(a for a, _ in spans)
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in device):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict[str, list] = {}
    for e in device:
        acc = by_name.setdefault(e.get("name", "?"), [0.0, 0])
        acc[0] += float(e["dur"])
        acc[1] += 1
    heaviest = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"window_us": window, "busy_us": busy,
            "busy_share": busy / window if window > 0 else 0.0,
            "device_events": len(device),
            "top": [(name, t, c) for name, (t, c) in heaviest]}
