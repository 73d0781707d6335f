"""Where one traced run of a cell spends the card's time and the host's, by
the program's spans:

    python3 dcsbench/attribute.py --workload <name> --seed <n> \
        [--seconds <s>]

from the root of the repository, on the card.  It runs the cell as
``run.py --trace 1`` does, with the trace's summary widened by
``metrics/_attribution.py``'s intervals, and prints run.py's log and
result line, then one JSON line: the readers ``entry_ms``,
``torch_ops_ms`` and ``program_idle_ms`` beside ``enqueue_ms``; a job's
device milliseconds by part (``kernels``, ``torch_ops``, ``reduce``,
``outside``), by innermost span and device op, and the parts' sum over
the device-op total of ``harness/trace.py``'s summary; the host's self
milliseconds a job per span; and the longest idle stretches with where
they lie and the innermost span that holds each.  Exits 2 without a CUDA
device.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from dcsbench import harness  # noqa: E402
from dcsbench.metrics import _attribution  # noqa: E402

READERS = ("enqueue_ms", "entry_ms", "torch_ops_ms", "program_idle_ms")


def _widen(summarize):
    def widened(trace_file, n_gaps=10):
        with open(trace_file) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X" and "dur" in e]
        return dict(summarize(trace_file, n_gaps), **_attribution.collect(
            events))
    return widened


def report(summary, n_jobs, n_gaps=10):
    """The JSON object this script prints after the result line."""
    ctx = harness.Context(summary, n_jobs, None)
    per_job = 1e3 / n_jobs
    by_span = _attribution.device_by_span(summary) or {}
    split = _attribution.device_split(summary) or {}
    total = sum(summary["device_ops"].values())
    stretches = _attribution.idle_stretches(summary) or []
    return dict(
        jobs=n_jobs,
        metrics={m: harness.load_metric(m).read(ctx) for m in READERS},
        device_ms_a_job={k: v * per_job for k, v in split.items()},
        device_total_ms_a_job=total * per_job,
        closure=sum(split.values()) / total if total else None,
        device_ms_by_span=sorted(
            ([span, op, s * per_job] for (span, op), s in by_span.items()),
            key=lambda r: -r[2]),
        self_ms_a_job=sorted(
            ([name, count / n_jobs, s * per_job] for name, (count, s)
             in _attribution.self_seconds(summary).items()),
            key=lambda r: -r[2]),
        longest_idle=[[where, (b - a) / 1e3, span] for a, b, where, span
                      in sorted(stretches, key=lambda g: g[0] - g[1])
                      [:n_gaps]])


def main(argv):
    p = argparse.ArgumentParser(prog="dcsbench/attribute.py",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 2
    harness.trace_mod.summarize = _widen(harness.trace_mod.summarize)
    traced, seen = harness._traced, {}

    def keep(*a, **k):
        seen["summary"], seen["jobs"] = traced(*a, **k)
        return seen["summary"], seen["jobs"]

    harness._traced = keep
    log = []
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, 1,
                                  "cuda", t_start=T_START, log=log)
    finally:
        for line in log:
            print(line)
    print(json.dumps(result))
    print(json.dumps(report(seen["summary"], seen["jobs"])))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
