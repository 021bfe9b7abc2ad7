"""What the probe wrappers share: binding a kernel, raising on a failed
launch, CUDA-event timing and the card's name for the tables."""

from __future__ import annotations

import ctypes
import functools
import subprocess

import torch

from ..runtime import build

P, I = ctypes.c_void_p, ctypes.c_int


def kernel(name: str, argtypes):
    """The C entry `name` of the kernel library (built at first use)."""
    fn = getattr(build.load(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def on_device(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for another."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what} takes CPU or CUDA tensors, got {t.device}")


def check(what: str, *tensors, dtype=torch.int32) -> None:
    """Raise unless every tensor is contiguous, of `dtype` and on the
    first one's device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: a tensor is on {t.device}, another on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{what} takes {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors")


def cuda_device() -> torch.device:
    """The card a probe's table runs on; raises where there is none."""
    if not torch.cuda.is_available():
        raise SystemExit("the probes' tables need a CUDA device")
    return torch.device("cuda", 0)


def event_ms(fn, reps: int = 3) -> float:
    """Mean device time of fn over `reps` launches (CUDA events, after
    one warm launch)."""
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


@functools.cache
def clock_khz(device_index: int) -> int:
    """The SM clock's rate the card reports (cudaDevAttrClockRate), kHz."""
    v = kernel("lzt_probe_clock_khz", [I])(device_index)
    if v <= 0:
        raise RuntimeError(f"clock rate query failed: CUDA error {-v}")
    return v


def cycles_ns(cycles, device) -> float:
    """SM cycles a kernel counted (clock64), as ns at the reported rate."""
    return int(cycles) * 1e6 / clock_khz(device.index or 0)


def per_step(run, iters: int, reps: int = 3, slope_iters=None):
    """(ms of run(iters), ns a step): the step's cost is the slope
    between run(k) and run(k // 2), k = slope_iters (default iters), so
    what a launch pays once (its start, staging rows, setting a lane's
    memory) cancels.  A step that costs a few ns needs a k whose launch
    outlasts the host's submission of it."""
    full = event_ms(lambda: run(iters), reps)
    k = slope_iters or iters
    long = full if k == iters else event_ms(lambda: run(k), reps)
    half = event_ms(lambda: run(k // 2), reps)
    return full, (long - half) * 1e6 / (k - k // 2)


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def print_table(title: str, rows) -> None:
    """A probe's table: its title with the card, then one row a line."""
    print(f"{title} on {card()}")
    for label, value in rows:
        print(f"  {label}: {value}")
