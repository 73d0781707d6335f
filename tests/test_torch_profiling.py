"""The port's profiling module (dcsexplorer_tpu_torch/utils/profiling.py) on
the CPU: ``span``'s shared null context with no profiler running, the
program's spans in a CPU trace (``dcs.flat94``; ``dcs.session`` and its
three children), one ``dcs.kernel.*`` span around each counted launch of
``ops/kernels.py``, no ``record_function`` outside the helper, a
device_trace written under a given directory, trace_summary's arithmetic
on a synthetic Chrome trace, and that the module and the cold sweeps
import with no card and without touching CUDA."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest
import torch

from dcsexplorer_tpu_torch.models import flatsweep as fs
from dcsexplorer_tpu_torch.models import romplay
from dcsexplorer_tpu_torch.ops import kernels
from dcsexplorer_tpu_torch.rom import zipload
from dcsexplorer_tpu_torch.utils import profiling as tprof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "dcsexplorer_tpu_torch")
SESSION93A_ZIP = os.path.join(PORT, "data", "session93a.zip")


def _user_spans(prof, tmp_path):
    """[(start, end, name)] of the user_annotation events of a finished
    profiler's Chrome trace, by start."""
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") == "user_annotation")


def test_span_with_no_profiler_is_one_shared_null_context(monkeypatch):
    calls = []
    enter = torch.ops.profiler._record_function_enter_new

    def spy(*args):
        calls.append(args[0])
        return enter(*args)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", spy)
    a, b = tprof.span("dcs.a"), tprof.span("dcs.b")
    assert a is b
    with a:
        with b:
            pass
    assert calls == []
    # under a profiler the same call opens a record_function range
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with tprof.span("dcs.c"):
            pass
    assert calls == ["dcs.c"]
    assert tprof.span("dcs.d") is a


def test_flat_pipeline_opens_its_span(tmp_path):
    with open(os.path.join(REPO, "assets", "streams", "tone_low.dcs94"),
              "rb") as f:
        stream = f.read()
    args = fs.packed_to_device(fs.FlatSweep([stream]).pack()
                               .compact_host_arrays(), "cpu")
    pipe = fs.FlatPipeline("cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pcm = pipe(**args)
    assert pcm.shape[1] == 240
    assert [n for _, _, n in _user_spans(prof, tmp_path)] == ["dcs.flat94"]


def test_decode_wire_opens_the_session_spans(tmp_path):
    rs, _ = zipload.load_zip_file(SESSION93A_ZIP)
    assert rs.check() == 1                  # sets its os_version
    S, T = 2, 12
    events = [{1: [0x00, 1 + b], 0: [0x55, 0xAA, 0x60, 0x9F]}
              for b in range(S)]
    with romplay.SessionServer(rs, S, T, n_ch=6, device="cpu") as srv:
        wire, E = srv.prepare(events)
        want = srv.decode_wire(torch.from_numpy(wire), E)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            got = srv.decode_wire(torch.from_numpy(wire), E)
    assert torch.equal(got, want) and got.shape == (S, T * 240)
    spans = _user_spans(prof, tmp_path)
    assert [n for _, _, n in spans] == [
        "dcs.session", "dcs.session.expand", "dcs.session.decode",
        "dcs.session.reduce"]
    (a, b, _), children = spans[0], spans[1:]
    for (c0, c1, _), (n0, _, _) in zip(children, children[1:] + [(b, 0, 0)]):
        assert a <= c0 <= c1 <= n0 <= b


def _launch_spans():
    """{LAUNCHES key: [span name of each wrapper that launches it]} read
    from ops/kernels.py: each function that calls ``_launch`` is, after its
    docstring (and the choice of its key), one ``with span(...)`` block
    around the rest of its body."""
    with open(kernels.__file__) as f:
        tree = ast.parse(f.read())
    out = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef) or not any(
                isinstance(n, ast.Call) and getattr(n.func, "id", "")
                == "_launch" for n in ast.walk(fn)):
            continue
        body = fn.body[1:]                  # after the docstring
        keys = None
        if isinstance(body[0], ast.Assign):     # kernel = "x" if ... else
            assert body[0].targets[0].id == "kernel", fn.name
            keys = [n.value for n in ast.walk(body[0].value)
                    if isinstance(n, ast.Constant) and isinstance(n.value,
                                                                  str)]
            body = body[1:]
        assert len(body) == 1 and isinstance(body[0], ast.With), fn.name
        call = body[0].items[0].context_expr
        assert call.func.id == "span", fn.name
        launch = [n for n in ast.walk(body[0]) if isinstance(n, ast.Call)
                  and getattr(n.func, "id", "") == "_launch"]
        assert len(launch) == 1, fn.name
        arg = launch[0].args[0]
        if keys is None:
            keys = [arg.value]
            names = [call.args[0].value]
        else:
            assert arg.id == "kernel", fn.name
            fmt = call.args[0]
            assert [type(v) for v in fmt.values] == [ast.Constant,
                                                     ast.FormattedValue]
            assert fmt.values[1].value.id == "kernel", fn.name
            names = [fmt.values[0].value + k for k in keys]
        for k, name in zip(keys, names):
            out.setdefault(k, []).append(name)
    return out


# keys that two wrappers count: decode93_pcm's columns' instance
# (kernels.decode93_pcm, the flat sweep's) and its session instance
# (decode93_pcm_bank, which alone counts decode93_pcm_carry)
SHARED_KEYS = {"decode93_pcm": 2}


@pytest.mark.parametrize("key", sorted(kernels.LAUNCHES))
def test_each_counted_launch_has_its_kernel_span(key):
    spans = _launch_spans()
    assert set(spans) == set(kernels.LAUNCHES)
    assert spans[key] == [f"dcs.kernel.{key}"] * SHARED_KEYS.get(key, 1)


def test_no_record_function_outside_the_span_helper():
    helper = os.path.join(PORT, "utils", "profiling.py")
    found = []
    for path in glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True):
        if path == helper:
            continue
        with open(path) as f:
            if "record_function" in f.read():
                found.append(os.path.relpath(path, REPO))
    assert found == []
    assert not hasattr(tprof, "StageTimer")
    assert not hasattr(tprof, "force_result")


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    with tprof.device_trace(str(tmp_path / "tr")) as prof:
        with tprof.span("pack"):
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
