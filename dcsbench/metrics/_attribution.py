"""Where the program's spans put a traced window's device time and idle
time: the arithmetic of ``torch_ops_ms`` and ``program_idle_ms``.

``collect(events)`` keeps, of a Chrome trace's complete events
(``"ph": "X"``), the intervals they read, in the trace's microseconds:

- ``span_intervals``: the host spans (``user_annotation``) as (start, end,
  name, pid, tid);
- ``launch_calls``: the host's CUDA runtime and driver calls by
  correlation id, as (start, pid, tid);
- ``op_intervals``: the kernels, copies and memsets on the card as (start,
  end, correlation id or None, base name);
- ``window_us``: (first start, last end) over every event, the traced
  window as ``harness/trace.py`` takes it.

A device op belongs to the innermost span open around its launch call on
the launch's thread (the spans of one thread nest, as ``record_function``
ranges do).  The program names its spans ``dcs.*``: each hand-written
kernel's wrapper opens ``dcs.kernel.<kernel>``, and a session batch's
``reduce_fn`` (the benchmark's digest) runs inside ``dcs.session.reduce``.

``harness/trace.py``'s summary does not carry these keys: a run of
``run.py`` gives these readers nothing to read, and ``dcsbench/attribute.py``
adds the keys to a traced run of a cell.
"""

import math
from bisect import bisect_right
from collections import defaultdict

from dcsbench.harness.trace import DEVICE_CATS, base_name

PROGRAM, KERNEL, REDUCE = "dcs.", "dcs.kernel.", "dcs.session.reduce"
KEYS = ("span_intervals", "launch_calls", "op_intervals", "window_us")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def collect(events):
    """The intervals above from a trace's complete events."""
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"], e.get("pid"),
              e.get("tid")) for e in events
             if e.get("cat") == "user_annotation"]
    calls = {e["args"]["correlation"]: (e["ts"], e.get("pid"), e.get("tid"))
             for e in events if e.get("cat") in LAUNCH_CATS
             and "correlation" in e.get("args", {})}
    ops = [(e["ts"], e["ts"] + e["dur"], e.get("args", {}).get("correlation"),
            base_name(e["name"]) if e["cat"] == "kernel" else e["name"])
           for e in events if e.get("cat") in DEVICE_CATS]
    window = (min(e["ts"] for e in events),
              max(e["ts"] + e["dur"] for e in events))
    return dict(span_intervals=spans, launch_calls=calls, op_intervals=ops,
                window_us=window)


class Timeline:
    """The innermost span of one thread at each moment: ``names[i]`` holds
    from ``times[i]`` to ``times[i + 1]`` (None: no span).  A span that
    ends after the span around it is cut at that span's end."""

    def __init__(self, spans):
        self.times, self.names = [], []
        stack = []                      # (end, name), innermost last

        def close(t):
            while stack and stack[-1][0] <= t:
                end, _ = stack.pop()
                self.times.append(end)
                self.names.append(stack[-1][1] if stack else None)

        for start, end, name in sorted(spans, key=lambda s: (s[0], -s[1])):
            close(start)
            if stack:
                end = min(end, stack[-1][0])
            stack.append((end, name))
            self.times.append(start)
            self.names.append(name)
        close(math.inf)

    def at(self, t):
        i = bisect_right(self.times, t)
        return self.names[i - 1] if i else None

    def cover(self, a, b):
        """{span name or None: microseconds of [a, b] in which it is the
        innermost span}."""
        out = defaultdict(float)
        i = bisect_right(self.times, a)
        name = self.names[i - 1] if i else None
        t = a
        while t < b:
            end = min(self.times[i], b) if i < len(self.times) else b
            out[name] += end - t
            t = end
            if i < len(self.times):
                name = self.names[i]
            i += 1
        return out


def _threads(summary):
    """{(pid, tid): [(start, end, name)]} of the summary's spans."""
    out = defaultdict(list)
    for start, end, name, pid, tid in summary["span_intervals"]:
        out[(pid, tid)].append((start, end, name))
    return out


def _timelines(summary):
    return {k: Timeline(v) for k, v in _threads(summary).items()}


def _has_program(summary):
    return all(k in summary for k in KEYS) and any(
        s[2].startswith(PROGRAM) for s in summary["span_intervals"])


def device_by_span(summary):
    """{(innermost span around the launch or None, op base name): device
    seconds}, or None where the summary holds no program span."""
    if not _has_program(summary):
        return None
    lines = _timelines(summary)
    calls = summary["launch_calls"]
    out = defaultdict(float)
    for start, end, corr, op in summary["op_intervals"]:
        call = calls.get(corr)
        line = lines.get(call[1:]) if call is not None else None
        out[(line.at(call[0]) if line else None, op)] += (end - start) / 1e6
    return dict(out)


def part(span):
    """The share of a job's device time a span's ops count in: ``kernels``
    (a ``dcs.kernel.*`` span), ``reduce`` (``dcs.session.reduce``),
    ``torch_ops`` (any other program span) or ``outside`` (no program
    span innermost)."""
    if span is None or not span.startswith(PROGRAM):
        return "outside"
    if span.startswith(KERNEL):
        return "kernels"
    return "reduce" if span == REDUCE else "torch_ops"


def device_split(summary):
    """{part: device seconds} over the trace (see ``part``), or None where
    the summary holds no program span."""
    by_span = device_by_span(summary)
    if by_span is None:
        return None
    out = dict.fromkeys(("kernels", "torch_ops", "reduce", "outside"), 0.0)
    for (span, _), seconds in by_span.items():
        out[part(span)] += seconds
    return out


def idle_stretches(summary):
    """[(start, end, where, span)] of every stretch of the traced window in
    which no device op runs: ``where`` is ``leading``, ``interior`` or
    ``trailing``, ``span`` the innermost span (over all threads) that holds
    the larger part of it, or None.  None where the summary holds no
    program span."""
    if not _has_program(summary):
        return None
    busy = []
    for a, b in sorted((s, e) for s, e, _, _ in summary["op_intervals"]):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    if not busy:
        return []
    lo, hi = summary["window_us"]
    lines = _timelines(summary).values()
    out = []
    stretches = [(lo, busy[0][0], "leading")] + [
        (x[1], y[0], "interior") for x, y in zip(busy, busy[1:])] + [
        (busy[-1][1], hi, "trailing")]
    for a, b, where in stretches:
        if b <= a:
            continue
        held = defaultdict(float)
        for line in lines:
            for name, us in line.cover(a, b).items():
                held[name] += us
        out.append((a, b, where, max(held.items(), key=lambda kv: kv[1])[0]
                    if held else None))
    return out


def program_idle_seconds(summary):
    """The card's idle seconds between the window's first and last device
    op in stretches that a program span (``dcs.*``) holds the larger part
    of; None where the summary holds no program span."""
    stretches = idle_stretches(summary)
    if stretches is None:
        return None
    return sum(b - a for a, b, where, span in stretches
               if where == "interior" and span is not None
               and span.startswith(PROGRAM)) / 1e6


def self_seconds(summary):
    """{span name: (count, host seconds inside it and outside the spans
    nested in it)} over every thread."""
    out = defaultdict(lambda: [0, 0.0])
    for spans in _threads(summary).values():
        stack = []                      # [end, name] innermost last
        for start, end, name in sorted(spans, key=lambda s: (s[0], -s[1])):
            while stack and stack[-1][0] <= start:
                stack.pop()
            if stack:
                end = min(end, stack[-1][0])
                out[stack[-1][1]][1] -= (end - start) / 1e6
            stack.append([end, name])
            out[name][0] += 1
            out[name][1] += (end - start) / 1e6
    return {k: tuple(v) for k, v in out.items()}
