"""What a ``torch.profiler`` Chrome trace says of the card: the benchmark's
copy of the port's ``utils/profiling.trace_summary`` arithmetic, widened to
every kernel and span.

- ``kernels``: {kernel name: (calls, device seconds)};
- ``window_s``: from the first event of any kind to the end of the last;
- ``busy_s``: the union of the kernel, copy and memset intervals;
- ``gaps``: the longest idle stretches of the window, as (host span that
  overlaps each most, or "none", seconds);
- ``spans``: {host span name: (count, seconds)};
- ``lead_s``: the most that a kernel starts before the host call that
  launched it (matched by correlation id).  A kernel cannot start before
  its launch: a lead beyond the clocks' jitter means the profiler mapped the
  card's clock onto the host's wrongly, and nothing in the trace is read.
  The cells' traces lead by 0 to 0.56 ms; the broken ones of a long process
  (PERF.md, Open questions) placed kernels milliseconds early, so
  ``LEAD_LIMIT_S`` is 1 ms, the limit ``chip_smoke.py`` phase 22 holds a
  trace to.
"""

import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LEAD_LIMIT_S = 1e-3


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(trace_file, n_gaps=10):
    with open(trace_file) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    kern = [e for e in events if e.get("cat") == "kernel"]
    if not kern:
        n = sum("Launch" in e["name"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver"))
        raise ValueError(f"the trace holds no kernel event ({n} launch "
                         f"calls on the host)")
    calls = {e["args"]["correlation"]: e["ts"] for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})}
    lead = max((calls[c] - e["ts"] for e in kern
                if (c := e.get("args", {}).get("correlation")) in calls),
               default=0.0)
    per = defaultdict(lambda: [0, 0.0])
    for e in kern:
        per[e["name"]][0] += 1
        per[e["name"]][1] += e["dur"] / 1e6
    lo = min(e["ts"] for e in events)
    hi = max(e["ts"] + e["dur"] for e in events)
    busy = _union((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") in DEVICE_CATS)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "user_annotation"]

    def cover(a, b):
        best = max(spans, key=lambda s: min(b, s[1]) - max(a, s[0]),
                   default=None)
        if best is None or min(b, best[1]) <= max(a, best[0]):
            return "none"
        return best[2]

    gaps = [(cover(a, b), (b - a) / 1e6)
            for a, b in sorted(idle, key=lambda g: g[0] - g[1])[:n_gaps]]
    totals = defaultdict(lambda: [0, 0.0])
    for a, b, name in spans:
        totals[name][0] += 1
        totals[name][1] += (b - a) / 1e6
    device_ops = defaultdict(float)
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            name = base_name(e["name"]) if e["cat"] == "kernel" \
                else e["name"]
            device_ops[name] += e["dur"] / 1e6
    return dict(kernels={k: tuple(v) for k, v in per.items()},
                device_ops=dict(device_ops),
                window_s=(hi - lo) / 1e6,
                busy_s=sum(b - a for a, b in busy) / 1e6,
                gaps=gaps, spans={k: tuple(v) for k, v in totals.items()},
                lead_s=max(lead, 0.0) / 1e6)


def base_name(kernel):
    """A kernel's function name without return type, namespaces, template
    arguments and parameters: ``void (anonymous namespace)::f<false>(int)``
    is ``f``."""
    name = kernel.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    name = name.split("<")[0].split("(")[0]
    return name.split("::")[-1].strip()


def kernel_seconds(summary, names):
    """Device seconds of the kernels with these function names, or None if
    none of them ran in the trace."""
    hits = [s for k, (_, s) in summary["kernels"].items()
            if base_name(k) in names]
    return sum(hits) if hits else None
