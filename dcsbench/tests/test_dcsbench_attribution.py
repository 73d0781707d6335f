"""The attribution of device and idle time to the program's spans
(``metrics/_attribution.py``, the readers ``entry_ms``, ``torch_ops_ms``
and ``program_idle_ms``, ``attribute.py``'s report) on synthetic Chrome
traces, and that the program's spans nested inside the harness's leave
every other key of the trace's summary and the accepted readers as they
read without them."""

import importlib.util
import json
import os

import pytest

from dcsbench import harness
from dcsbench.harness import trace as trace_mod
from dcsbench.metrics import _attribution as att

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 7, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr, tid=1):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 1, tid, corr)


# one job of a flat sweep on thread 1, a long span on thread 2, and the
# harness's digest after the job's entry span
TRACE = [
    _x("user_annotation", "dcsbench.enqueue", 0, 100),
    _x("user_annotation", "dcs.flat94", 5, 85),
    _x("user_annotation", "dcs.kernel.decode94_fb", 10, 10),
    _x("user_annotation", "dcs.kernel.transform94_pcm", 40, 10),
    _x("user_annotation", "dcs.session", 110, 30),
    _x("user_annotation", "dcs.session.reduce", 120, 15),
    _x("user_annotation", "dcs.kernel.other", 0, 400, tid=2),
    _launch(12, 1), _launch(30, 2), _launch(45, 3), _launch(95, 4),
    _launch(125, 5), _launch(150, 6),
    _x("kernel", "void decode94_fb_kernel<8>(int const*)", 200, 40,
       corr=1),
    _x("kernel", "void at::native::elementwise_kernel<128, 2>(int)", 240,
       5, corr=2),
    _x("kernel", "transform94_pcm_kernel(int*)", 250, 30, corr=3),
    _x("gpu_memcpy", "Memcpy HtoD", 290, 4, corr=4),
    _x("kernel", "Kernel2", 300, 10, corr=5),
    _x("kernel", "reduce_kernel", 320, 6, corr=6),
    _x("gpu_memset", "Memset", 330, 2),
]


def _summary(events):
    return dict(spans={}, **att.collect(events))


class _Ctx:
    def __init__(self, summary, jobs=1, inputs=None):
        self.summary, self.jobs, self.inputs = summary, jobs, inputs

    def kernel_seconds(self, names):
        return trace_mod.kernel_seconds(self.summary, names)


def test_a_device_op_goes_to_the_innermost_span_of_its_launch():
    by = att.device_by_span(_summary(TRACE))
    assert by == pytest.approx({
        ("dcs.kernel.decode94_fb", "decode94_fb_kernel"): 40e-6,
        ("dcs.flat94", "elementwise_kernel"): 5e-6,
        ("dcs.kernel.transform94_pcm", "transform94_pcm_kernel"): 30e-6,
        ("dcsbench.enqueue", "Memcpy HtoD"): 4e-6,
        ("dcs.session.reduce", "Kernel2"): 10e-6,
        # launched at 150 on thread 1, inside no span there (thread 2's
        # span is another thread's)
        (None, "reduce_kernel"): 6e-6,
        (None, "Memset"): 2e-6})          # no correlation id
    split = att.device_split(_summary(TRACE))
    assert split == pytest.approx({"kernels": 70e-6, "torch_ops": 5e-6,
                                   "reduce": 10e-6, "outside": 12e-6})
    ops = sum(e["dur"] for e in TRACE if e["cat"] in trace_mod.DEVICE_CATS)
    assert sum(split.values()) == pytest.approx(ops / 1e6)
    assert harness.load_metric("torch_ops_ms").read(
        _Ctx(_summary(TRACE), jobs=5)) == pytest.approx(1e3 * 5e-6 / 5)


def test_program_idle_leaves_out_the_leading_and_trailing_stretches():
    # busy 100..110, 130..140, 200..210 of a window 0..300: leading and
    # trailing stretches inside program spans; 110..130 three quarters in
    # dcs.flat94 (counted), 140..200 held by no span for its larger part
    events = [
        _x("Trace", "profile", 0, 300),
        _x("user_annotation", "dcs.session", 0, 100),
        _x("user_annotation", "dcs.flat94", 115, 20),
        _x("user_annotation", "dcsbench.enqueue", 175, 25),
        _x("user_annotation", "dcs.flat93", 175, 24),
        _x("user_annotation", "dcs.flat93", 210, 90),
        _launch(1, 1), _launch(116, 2), _launch(176, 3),
        _x("kernel", "a", 100, 10, corr=1),
        _x("kernel", "b", 130, 10, corr=2),
        _x("kernel", "c", 200, 10, corr=3)]
    s = _summary(events)
    assert att.idle_stretches(s) == [
        (0, 100, "leading", "dcs.session"),
        (110, 130, "interior", "dcs.flat94"),
        (140, 200, "interior", None),
        (210, 300, "trailing", "dcs.flat93")]
    assert att.program_idle_seconds(s) == pytest.approx(20e-6)
    assert harness.load_metric("program_idle_ms").read(
        _Ctx(s, jobs=2)) == pytest.approx(1e3 * 20e-6 / 2)
    # the stretch held by a program span for the larger part counts whole
    events[2] = _x("user_annotation", "dcs.flat94", 119, 20)
    assert att.program_idle_seconds(_summary(events)) == pytest.approx(
        20e-6)
    events[2] = _x("user_annotation", "dcs.flat94", 121, 20)
    assert att.program_idle_seconds(_summary(events)) == 0.0


def test_readers_read_nothing_without_the_program_or_the_intervals():
    bare = [e for e in TRACE if not e["name"].startswith("dcs.")]
    for name in ("torch_ops_ms", "program_idle_ms"):
        reader = harness.load_metric(name)
        assert reader.read(_Ctx({"spans": {}})) is None
        assert reader.read(_Ctx(_summary(bare))) is None
    assert harness.load_metric("torch_ops_ms").read(_Ctx(_summary(
        [e for e in TRACE if e["name"] != "dcs.flat94"]))) == 0.0
    entry = harness.load_metric("entry_ms")
    assert entry.read(_Ctx({"spans": {"dcsbench.enqueue": (4, 1.0)}})) \
        is None
    assert entry.read(_Ctx({"spans": {
        "dcs.flat93": (8, 2e-3), "dcs.flat94": (4, 1e-3),
        "dcs.kernel.decode93_pcm": (8, 1.0)}}, jobs=4)) == \
        pytest.approx(0.75)


def test_timeline_holds_the_innermost_span():
    line = att.Timeline([(0, 10, "a"), (2, 5, "b"), (3, 4, "c"),
                         (5, 12, "d"), (20, 30, "e")])
    assert [line.at(t) for t in (-1, 1, 2.5, 3.5, 4.5, 5, 9, 15, 25,
                                 30)] == \
        [None, "a", "b", "c", "b", "d", "d", None, "e", None]
    # d ends after a, the span around it: cut at a's end
    assert line.cover(0, 40) == pytest.approx(
        {"a": 2 + 0, "b": 1 + 1, "c": 1, "d": 5, None: 10 + 10,
         "e": 10})


def test_self_seconds_take_out_the_nested_spans():
    got = att.self_seconds(_summary(TRACE))
    assert got["dcsbench.enqueue"] == pytest.approx((1, 15e-6))
    assert got["dcs.flat94"] == pytest.approx((1, 65e-6))
    assert got["dcs.session"] == pytest.approx((1, 15e-6))
    assert got["dcs.kernel.other"] == pytest.approx((1, 400e-6))


def test_attribute_report_closes_the_device_time():
    spec = importlib.util.spec_from_file_location(
        "dcsbench_attribute", os.path.join(HERE, "attribute.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    s = _summary([e for e in TRACE if e["tid"] == 1])
    s["device_ops"] = {"all": 97e-6}
    s["spans"] = {"dcsbench.enqueue": (1, 100e-6), "dcs.flat94": (1, 85e-6),
                  "dcs.session": (1, 30e-6)}
    r = mod.report(s, 1)
    assert r["closure"] == pytest.approx(1.0)
    assert r["metrics"] == pytest.approx({
        "enqueue_ms": 0.1, "entry_ms": 0.115, "torch_ops_ms": 0.005,
        "program_idle_ms": 0.0})
    assert r["device_total_ms_a_job"] == pytest.approx(0.097)
    # 0..200 before the first op: 65 us in dcs.flat94, 70 in no span
    assert r["longest_idle"][0] == ["leading", 0.2, None]


def test_program_spans_leave_the_accepted_summary_and_readers(tmp_path):
    inputs = {"flat94": [dict(frames=1000, streams=2, stream_bytes=5000,
                              symbols=20000)]}
    values = []
    one = [e for e in TRACE if e["tid"] == 1]
    for events in (one, [e for e in one
                         if not e["name"].startswith("dcs.")]):
        path = tmp_path / "t.json"
        path.write_text(json.dumps({"traceEvents": events}))
        s = trace_mod.summarize(str(path))
        ctx = _Ctx(s, jobs=1, inputs=inputs)
        values.append((
            {k: v for k, v in s.items() if k not in ("spans", "gaps")},
            {k: v for k, v in s["spans"].items()
             if not k.startswith("dcs.")},
            [seconds for _, seconds in s["gaps"]],
            [harness.load_metric(m).read(ctx)
             for m in ("enqueue_ms", "device_idle", "decode94_fb.roofline",
                       "transform94_pcm.roofline")]))
    assert values[0] == values[1]
    assert values[0][3][0] == pytest.approx(0.1)
