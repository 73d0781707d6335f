"""Profiling helpers of the PyTorch + CUDA port.

- ``span``: the port's one way to open a host span: a
  ``torch.profiler.record_function`` range while a profiler runs, a shared
  null context otherwise;
- ``device_trace``: a context manager around ``torch.profiler.profile``
  (CPU activity, and CUDA activity where a card is present) that writes a
  Chrome trace into ``log_dir``;
- ``trace_summary``: reads such a trace: the kernels with the most device
  time, the device's busy time (the union of kernel and copy intervals)
  and idle share of the traced window, and the longest idle gaps with the
  host span that covers each.

Nothing here touches CUDA when the module is imported.
"""

import contextlib
import json
import os
import time
from collections import defaultdict

import torch

_NO_SPAN = contextlib.nullcontext()


def span(name):
    """A host span named ``name`` around a ``with`` block.

    With no profiler running it is one shared ``nullcontext`` and calls
    nothing in ``torch.ops.profiler``: the cost is one read of the
    profiler's flag, where a ``record_function`` enters and leaves the
    profiler's ops whether or not one runs.  Under
    ``torch.profiler`` it is a ``record_function`` range, so the span lands
    in the profiler's Chrome trace beside the card's kernels, on the same
    clock.  A span's parent is the innermost span open around it on its
    thread.  The port names its spans ``dcs.<layer>[.<stage>]``."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def device_trace(log_dir="build/torch_trace"):
    """Profile the body with ``torch.profiler`` and write its Chrome trace to
    ``log_dir/trace_<pid>_<ns>.json``; yields the profiler, whose
    ``trace_file`` names that file once the block has ended.  Host spans
    of every thread are kept (a server's prep thread included)."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=activities,
        experimental_config=_ExperimentalConfig(profile_all_threads=True))
    with prof:
        yield prof
    prof.trace_file = os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_file)


# the Chrome trace's categories of device work
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals):
    """Sorted, merged [start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def trace_summary(trace_file, top=5, n_gaps=3):
    """What a Chrome trace of ``device_trace`` says of the device, in ms:

    - ``kernels``: the ``top`` kernels by total device time, as (name,
      calls, total ms);
    - ``window_ms``: the traced window, from the first event of any kind
      to the end of the last;
    - ``busy_ms``: the union of the kernel, copy and memset intervals;
      ``idle_share``: 1 - busy / window;
    - ``gaps``: the ``n_gaps`` longest idle stretches of the window, as
      (ms, the host span that overlaps it most or None);
    - ``spans``: the host spans' total ms by name;
    - ``lead_ms``: the most that a kernel starts before the host call that
      launched it (matched by ``args.correlation``), else 0.  A kernel
      cannot run before its launch: a lead beyond the clocks' jitter (tens
      of microseconds) means the profiler mapped the device's timestamps
      onto the host's clock wrongly, and the device times are not to be
      read.

    Raises ValueError if the trace holds no kernel event: it is then no
    trace of the device."""
    with open(trace_file) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    kern = [e for e in events if e.get("cat") == "kernel"]
    calls = {e["args"]["correlation"]: e["ts"] for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})}
    if not kern:
        n = sum("Launch" in e["name"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver"))
        raise ValueError(f"{trace_file}: no CUDA kernel event ({n} launch "
                         f"calls on the host)")
    lead = max((calls[c] - e["ts"] for e in kern
                if (c := e.get("args", {}).get("correlation")) in calls),
               default=0.0)
    per = defaultdict(lambda: [0, 0.0])
    for e in kern:
        per[e["name"]][0] += 1
        per[e["name"]][1] += e["dur"] / 1e3
    kernels = sorted(((n, c, ms) for n, (c, ms) in per.items()),
                     key=lambda k: -k[2])[:top]
    lo = min(e["ts"] for e in events)
    hi = max(e["ts"] + e["dur"] for e in events)
    busy = _union((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") in _DEVICE_CATS)
    busy_us = sum(b - a for a, b in busy)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "user_annotation"]

    def cover(a, b):
        best = max(spans, key=lambda s: min(b, s[1]) - max(a, s[0]),
                   default=None)
        if best is None or min(b, best[1]) <= max(a, best[0]):
            return None
        return best[2]

    gaps = [((b - a) / 1e3, cover(a, b))
            for a, b in sorted(idle, key=lambda g: g[0] - g[1])[:n_gaps]]
    totals = defaultdict(float)
    for a, b, name in spans:
        totals[name] += (b - a) / 1e3
    window = (hi - lo) / 1e3
    return dict(kernels=kernels, window_ms=window, busy_ms=busy_us / 1e3,
                idle_share=1 - busy_us / 1e3 / window, gaps=gaps,
                spans=dict(totals), lead_ms=max(lead, 0.0) / 1e3)
