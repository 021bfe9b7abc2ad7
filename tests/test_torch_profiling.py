"""The port's profiling on the CPU: PhaseTimer, a CPU-only
profiler_trace, the trace reader on a hand-made trace, and the probed
stages.  (On the card: tests/test_torch_cuda.py.)"""

import json
import time

import pytest
import torch

from lzma_tpu_torch.bench.datagen import generate_bench_data
from lzma_tpu_torch.format.properties import LzmaParams
from lzma_tpu_torch.ops import device_encoder
from lzma_tpu_torch.ops.device_matcher import LAZY_STAGES
from lzma_tpu_torch.utils.profiling import PhaseTimer, device_busy, profiler_trace


def test_phase_timer_accumulates_and_reports():
    t = PhaseTimer()
    with t.phase("a"):
        time.sleep(0.01)
    with t.phase("a", sync_arrays=[torch.ones(3), "not a tensor"]):
        pass
    out = []
    with t.phase("b", sync_arrays=out):
        out.append(torch.zeros(2))          # filled inside the block
    assert set(t.totals) == {"a", "b"} and t.totals["a"] >= 0.01
    lines = t.report().splitlines()
    assert lines[0].split()[0] == "a" and "%" in lines[0]


def test_phase_timer_counts_a_failing_phase():
    t = PhaseTimer()
    with pytest.raises(KeyError):
        with t.phase("x"):
            raise KeyError
    assert "x" in t.totals


def test_cpu_profiler_trace_is_readable(tmp_path):
    with profiler_trace(str(tmp_path), device="cpu") as prof:
        x = torch.arange(4096.0)
        for _ in range(3):
            x = (x * 1.5).sin()
    path = prof.trace_path
    assert path.startswith(str(tmp_path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::sin") for e in events)
    busy = device_busy(path)
    assert busy["window_us"] > 0
    assert busy["device_events"] == 0 and busy["busy_share"] == 0.0
    assert busy["top"] == []


def test_cuda_profiler_trace_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        with profiler_trace(str(tmp_path), device="cuda"):
            pass


def test_device_busy_on_a_hand_made_trace(tmp_path):
    """Busy time is the union of the card's intervals; the window spans
    every event; the heaviest device operations come first."""
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 20, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 50,
         "dur": 10},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 55, "dur": 2},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 70, "dur": 5},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 95, "dur": 5},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 200},
        {"ph": "X", "cat": "kernel", "name": "k_c", "ts": 80, "dur": 0},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    busy = device_busy(str(path), top=2)
    assert busy["window_us"] == 100
    assert busy["busy_us"] == 30 + 10 + 5      # [10, 40), [50, 60), [70, 75)
    assert busy["busy_share"] == pytest.approx(0.45)
    assert busy["device_events"] == 6
    assert busy["top"] == [("k_a", 25.0, 2), ("k_b", 20.0, 1)]


def test_probed_stages_on_the_cpu_record_seconds_only():
    data = generate_bench_data(1500)
    with device_encoder.probing() as probe:
        device_encoder.encode_batch([data], LzmaParams(dict_size=1 << 12),
                                    device="cpu")
    assert {*LAZY_STAGES, "classify", "lower", "rc_serialize"} <= \
        set(probe["seconds"])
    assert "peak_bytes" not in probe
