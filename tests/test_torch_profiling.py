"""The port's profiling module (dcsexplorer_tpu_torch/utils/profiling.py) on
the CPU: StageTimer's report against the JAX package's, a device_trace
written under a given directory, force_result's checksum fetch,
trace_summary's arithmetic on a synthetic Chrome trace, and that the
module and the cold sweeps import with no card and without touching
CUDA."""

import json
import os
import subprocess
import sys

import pytest
import torch
from torch.profiler import record_function

from dcsexplorer_tpu.utils import profiling as jprof
from dcsexplorer_tpu_torch.utils import profiling as tprof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_stage_timer_report_matches_jax():
    totals = {"pack": 0.0123, "upload": 0.5, "fetch": 0.000401}
    counts = {"pack": 3, "upload": 1, "fetch": 12}
    timers = [jprof.StageTimer(), tprof.StageTimer()]
    for t in timers:
        t.totals.update(totals)
        t.counts.update(counts)
    assert timers[1].report() == timers[0].report()
    assert timers[1].report().splitlines()[1].startswith("upload")


def test_stage_timer_records_stages():
    t = tprof.StageTimer()
    for _ in range(2):
        with t.stage("a"):
            pass
    with pytest.raises(KeyError):
        with t.stage("b"):
            raise KeyError("b")
    assert t.counts == {"a": 2, "b": 1}
    assert all(v >= 0 for v in t.totals.values())


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    with tprof.device_trace(str(tmp_path / "tr")) as prof:
        with record_function("pack"):
            x = torch.arange(1000).sum()
    path = prof.trace_file
    assert os.path.dirname(path) == str(tmp_path / "tr")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "pack" and e.get("cat") == "user_annotation"
               for e in events)
    assert int(x) == 499500
    # a trace with no kernel event is no trace of the device
    with pytest.raises(ValueError, match="no CUDA kernel event"):
        tprof.trace_summary(path)


def test_force_result_fetches_a_checksum(monkeypatch):
    fetched = []
    item = torch.Tensor.item

    def spy(self):
        fetched.append(item(self))
        return fetched[-1]

    monkeypatch.setattr(torch.Tensor, "item", spy)
    x = torch.tensor([[0x1FF, -1], [3, 0x100]], dtype=torch.int32)
    value = {"pcm": x, "n": 4}
    out, seconds = tprof.force_result(value)
    assert out is value and seconds >= 0
    # (x.int() & 0xFF).sum() of the first tensor, fetched once
    assert fetched == [0xFF + 0xFF + 3 + 0]
    assert tprof.force_result([3, "a"])[0] == [3, "a"]
    assert fetched == [0x201]


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_summary_on_a_synthetic_trace(tmp_path):
    # window 0..100 us; device busy 10..30 (two overlapping kernels), 40..45
    # (a copy), 70..80 (a kernel): 35 us busy
    events = [_x("Trace", "profile", 0, 100),
              _x("user_annotation", "pack", 0, 12),
              _x("user_annotation", "upload", 30, 12),
              _x("user_annotation", "fetch", 44, 56),
              _x("kernel", "decode", 10, 15),
              _x("kernel", "transform", 20, 10),
              _x("gpu_memcpy", "Memcpy HtoD", 40, 5),
              _x("kernel", "decode", 70, 10),
              _x("cuda_runtime", "cudaLaunchKernel", 9, 1),
              {"ph": "i", "cat": "kernel", "name": "marker", "ts": 50}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = tprof.trace_summary(str(path), top=1, n_gaps=3)
    assert s["kernels"] == [("decode", 2, 0.025)]
    assert s["window_ms"] == 0.1
    assert s["busy_ms"] == pytest.approx(0.035)
    assert s["idle_share"] == pytest.approx(0.65)
    # idle: 0..10 (pack), 30..40 (upload), 45..70 and 80..100 (fetch)
    assert s["gaps"] == [(0.025, "fetch"), (0.02, "fetch"), (0.01, "pack")]
    assert s["spans"] == {"pack": 0.012, "upload": 0.012, "fetch": 0.056}
    assert s["lead_ms"] == 0.0          # no kernel names its launch


def test_trace_summary_reads_the_device_clock_lead(tmp_path):
    # a kernel is matched to its launch by args.correlation: the first runs
    # 4 us after its launch, the second 250 us before its own (a device
    # clock mapped wrongly onto the host's), the third has no launch event
    def corr(e, c):
        return dict(e, args={"correlation": c})

    events = [_x("Trace", "profile", 0, 1000),
              corr(_x("cuda_runtime", "cudaLaunchKernel", 100, 5), 7),
              corr(_x("cuda_runtime", "cudaLaunchKernel", 500, 5), 8),
              corr(_x("cuda_runtime", "cudaMemcpyAsync", 600, 5), 9),
              corr(_x("kernel", "a", 104, 10), 7),
              corr(_x("kernel", "b", 250, 10), 8),
              corr(_x("kernel", "c", 5, 10), 11)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert tprof.trace_summary(str(path))["lead_ms"] == pytest.approx(0.25)
    # the kernels on time: no lead
    path.write_text(json.dumps({"traceEvents": events[:5]}))
    assert tprof.trace_summary(str(path))["lead_ms"] == 0.0
    # launches on the host, no kernel record: no trace of the device
    path.write_text(json.dumps({"traceEvents": events[:4]}))
    with pytest.raises(ValueError,
                       match=r"no CUDA kernel event \(2 launch calls"):
        tprof.trace_summary(str(path))


_IMPORT_WITHOUT_CUDA = r"""
import torch

def boom(*a, **k):
    raise AssertionError("CUDA touched at import")

for name in ("is_available", "init", "_lazy_init", "device_count",
             "current_stream", "Stream", "Event"):
    setattr(torch.cuda, name, boom)
from dcsexplorer_tpu_torch.utils import profiling
from dcsexplorer_tpu_torch.models import catalogsweep, coldsweep
print("ok")
"""


def test_modules_import_without_touching_cuda():
    r = subprocess.run([sys.executable, "-c", _IMPORT_WITHOUT_CUDA],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[-1] == "ok"
