"""The benchmark's harness: one run of one cell.

``main`` is ``dcsbench/run.py``'s body: it reads ``BENCHMARK.json``, the
cell's configuration (``configs/``) and traffic (``traffic/``), refuses to
run without the cards the cell asks for, and prints the run's result as the
last line of standard output.  ``run_cell`` is the run itself, on any
device, for the tests to drive on the CPU at small sizes.

A run: set-up (data checked against each data directory's
``MANIFEST.json``, the program's set-up, every job shape warmed up), then
with ``--trace 1`` a short traced sub-window read by the per-layer metrics
of ``metrics/``, then the timed window: a closed loop that keeps ``depth``
jobs in flight for ``--seconds`` seconds, each job ending in digests
fetched into pinned host memory.  Then the program's state is freed and
every compared number is worked out again by the plain reference.
"""

import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import deque

import torch

from ..reference.cache import IndexCache
from . import jobs as jobs_mod
from . import trace as trace_mod

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "dcsexplorer_tpu")
KINDS = {"catalog": jobs_mod.CatalogJobs, "sessions": jobs_mod.SessionJobs}
# the one compared number: digests and traced or packed controls that differ
# from the reference.  Exact: bit-exact decode is the configurations'
# guarantee, sound runs read 0 and the control reads more (PERF.md).
MISMATCH_LIMIT = 0


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_spec(workload, overrides=None, config_overrides=None):
    """(benchmark, cell, configuration, traffic) of a cell by its name;
    ``overrides`` and ``config_overrides`` update the traffic's parameters
    and the configuration's keys (the tests' small sizes)."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r}: {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(os.path.join(ROOT, cfg_entry["file"]))
    traffic = load_json(os.path.join(HERE, "traffic",
                                     f"{cell['traffic']}.json"))
    traffic.update(overrides or {})
    config.update(config_overrides or {})
    return bench, cell, config, traffic


def data_dirs(data_dir=os.path.join(HERE, "data")):
    """``data/`` and every directory under it, as paths relative to it
    (``""`` for ``data/`` itself): each holds a ``MANIFEST.json`` of its
    own files."""
    out = []
    for dirpath, dirs, _ in os.walk(data_dir):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        rel = os.path.relpath(dirpath, data_dir)
        out.append("" if rel == "." else rel)
    return out


def check_data(data_dir=os.path.join(HERE, "data")):
    """Raise unless every file of each directory's manifest has its size
    and SHA-256: ``data/MANIFEST.json`` first, then the ``MANIFEST.json``
    of each directory under ``data/``, which covers the files of its own
    directory (a configuration names them ``<dir>/<file>``)."""
    import hashlib
    for sub in data_dirs(data_dir):
        man = load_json(os.path.join(data_dir, sub, "MANIFEST.json"))
        for name, want in man.items():
            rel = os.path.join(sub, name)
            with open(os.path.join(data_dir, rel), "rb") as f:
                data = f.read()
            if len(data) != want["bytes"] or \
                    hashlib.sha256(data).hexdigest() != want["sha256"]:
                raise RuntimeError(f"dcsbench/data/{rel} differs from "
                                   f"{os.path.join(sub, 'MANIFEST.json')}")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is one the benchmark must never
    load (compared whole: ``dcsexplorer_tpu_torch`` is not
    ``dcsexplorer_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_metric(name):
    """The reader module of a per-layer metric, ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"dcsbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Loop:
    """The closed loop: ``depth`` jobs in flight; a job's digests are
    copied into pinned host memory behind it and an event marks their
    arrival."""

    def __init__(self, jobs, depth, device):
        self.jobs, self.depth, self.device = jobs, depth, device
        cuda = device.type == "cuda"
        self.bufs = [torch.empty((jobs.n_out, 2), dtype=torch.int64,
                                 pin_memory=cuda) for _ in range(depth)]
        self.events = [torch.cuda.Event() if cuda else None
                       for _ in range(depth)]
        self.n = 0
        self.waited_s = 0.0     # the host's time blocked on arrivals
        self.latency_s = []     # a window's jobs, dispatch to arrival

    def run(self, seconds, history):
        """Dispatch jobs for ``seconds`` seconds, keeping ``depth`` in
        flight, then drain.  Appends (job, digests) to history; returns
        (jobs dispatched, jobs that arrived in the window)."""
        cuda = self.device.type == "cuda"
        inflight = deque()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        n0, in_window = self.n, 0
        self.waited_s, self.latency_s = 0.0, []
        while True:
            while len(inflight) < self.depth and \
                    time.perf_counter() < deadline:
                t_sent = time.perf_counter()
                out = self.jobs.dispatch(self.n)
                buf = self.bufs[self.n % self.depth]
                buf.copy_(out, non_blocking=cuda)
                ev = self.events[self.n % self.depth]
                if cuda:
                    ev.record()
                inflight.append((self.n, buf, ev, t_sent))
                self.n += 1
            if not inflight:
                break
            n, buf, ev, t_sent = inflight.popleft()
            if ev is not None:
                t = time.perf_counter()
                ev.synchronize()
                self.waited_s += time.perf_counter() - t
            t = time.perf_counter()
            if t <= deadline:
                in_window += 1
                self.latency_s.append(t - t_sent)
            history.append((n, buf.numpy().copy()))
        return self.n - n0, in_window


def _smi():
    """The card's clocks, power and temperature by nvidia-smi, one line."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.mem,"
             "power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return (r.stdout.strip() or r.stderr.strip()).replace("\n", " | ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def _traced(loop, seconds, history, log, attempts=3):
    """Run the loop for ``seconds`` under torch.profiler; the trace's
    summary and the jobs it holds.  A trace whose clocks disagree (a
    kernel before its launch by more than ``trace.LEAD_LIMIT_S``) is
    thrown away and taken again, at most ``attempts`` times in all."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if loop.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    leads = []
    for _ in range(attempts):
        tmp = tempfile.mkdtemp(prefix="dcsbench_trace_")
        try:
            with profile(activities=acts) as prof:
                n_jobs, _ = loop.run(seconds, history)
                if loop.device.type == "cuda":
                    torch.cuda.synchronize()
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            summary = trace_mod.summarize(path)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        leads.append(summary["lead_s"] * 1e3)
        if summary["lead_s"] <= trace_mod.LEAD_LIMIT_S:
            log.append(f"trace: {n_jobs} jobs, kernels lead their launches "
                       f"by at most {leads} ms (limit "
                       f"{trace_mod.LEAD_LIMIT_S * 1e3} ms)")
            return summary, n_jobs
    raise RuntimeError(f"every trace has a kernel before its launch by more "
                       f"than {trace_mod.LEAD_LIMIT_S * 1e3} ms ({leads} "
                       f"ms): the profiler mapped the card's clock wrongly")


class Context:
    """What a per-layer metric's reader sees of a traced run: the trace's
    summary, the jobs it holds and one job's inputs (``jobs.*.inputs``)."""

    def __init__(self, summary, n_jobs, inputs):
        self.summary, self.jobs, self.inputs = summary, n_jobs, inputs

    def kernel_seconds(self, names):
        return trace_mod.kernel_seconds(self.summary, names)


def run_cell(workload, seed, seconds, trace, device="cuda", t_start=None,
             overrides=None, config_overrides=None, log=None):
    """One run of a cell; returns the result dict (the printed line's
    object).  ``log`` receives the lines printed before the result."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log if log is not None else []
    bench, cell, config, traffic = load_spec(workload, overrides,
                                             config_overrides)
    device = torch.device(device)
    check_data()
    from dcsexplorer_tpu_torch.ops import kernels
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.init()
    t_imported = time.perf_counter()
    jobs = KINDS[traffic["kind"]](config, traffic, seed, device,
                                  os.path.join(HERE, "data"))
    t_built = time.perf_counter()
    loop = Loop(jobs, traffic["depth"], device)
    history = []
    # warm-up: every job shape, twice, then the loop itself
    for n in range(2 * jobs.n_distinct()):
        jobs.dispatch(n)
    for _ in range(2 * loop.depth):
        out = jobs.dispatch(loop.n)
        loop.bufs[loop.n % loop.depth].copy_(out)
        loop.n += 1
    if cuda:
        torch.cuda.synchronize()
    t_warm = time.perf_counter()
    log.append(f"set-up: imports {t_imported - t_start:.3f} s, the "
               f"program's set-up {t_built - t_imported:.3f} s, warm-up "
               f"{t_warm - t_built:.3f} s")
    summary = None
    if trace:
        summary, n_traced = _traced(loop, traffic["trace_seconds"], history,
                                    log)
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    log.append(f"nvidia-smi before the window: {_smi()}")
    setup_s = time.perf_counter() - t_start
    n_jobs, in_window = loop.run(seconds, history)
    waited_s = loop.waited_s
    lat_ms = [1e3 * t for t in loop.latency_s]
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device)
        kind = torch.cuda.get_device_name(device)
    else:
        peak, kind = 0, "cpu"
    log.append(f"nvidia-smi after the window: {_smi()}")
    loop_depth = loop.depth
    launches = {k: kernels.LAUNCHES[k] for k in config["kernels"][
        traffic["kind"]]}
    jobs.release()
    del loop
    if cuda:
        torch.cuda.empty_cache()
    if cuda and any(c < n_jobs for c in launches.values()):
        raise RuntimeError(f"a kernel of the cell did not launch for every "
                           f"job: {launches} over {n_jobs} jobs")
    index_cache = IndexCache()
    mismatches, failed, checked = jobs.check(history, device, index_cache)
    correct = mismatches <= MISMATCH_LIMIT
    audio_xrt = in_window * jobs.audio_s / seconds
    result = dict(correct=correct, attempted=len(history), failed=failed)
    if trace:
        ctx = Context(summary, n_traced, jobs.inputs(device, index_cache))
        metrics = {}
        for m in bench["per_layer"]:
            if cell["name"] not in m.get("workloads", [cell["name"]]):
                continue
            value = load_metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        result["metrics"] = metrics
    else:
        e2e = dict(audio_xrt=audio_xrt, setup_s=setup_s)
        result["metrics"] = {
            m["name"]: dict(value=e2e[m["name"]], unit=m["unit"])
            for m in bench["end_to_end"]
            if cell["name"] in m.get("workloads", [cell["name"]])}
    result["device"] = dict(platform="gpu" if cuda else "cpu", kind=kind,
                            count=cell["chips"], memory_peak_bytes=peak)
    if trace:
        result["device"].update(busy_s=summary["busy_s"],
                                window_s=summary["window_s"])
        result["breakdown"] = dict(
            device_ops=sorted(summary["device_ops"].items(),
                              key=lambda kv: -kv[1])[:10],
            idle_gaps=[[n, s] for n, s in summary["gaps"][:10]])
    log.append(f"window {seconds} s: {n_jobs} jobs dispatched, {in_window} "
               f"arrived inside it, the host blocked on arrivals "
               f"{waited_s:.3f} s, {jobs.audio_s:.3f} s of audio a job; "
               f"launches {launches}; {checked} checked against the "
               f"reference")
    if lat_ms:
        q = statistics.quantiles(lat_ms, n=20) if len(lat_ms) > 1 \
            else [lat_ms[0]] * 19
        log.append(f"job latency (dispatch to digests on the host, "
                   f"{len(lat_ms)} jobs of the window): p50 {q[9]:.4f} ms, "
                   f"p95 {q[18]:.4f} ms, max {max(lat_ms):.4f} ms; depth "
                   f"x window / jobs "
                   f"{1e3 * seconds * loop_depth / max(in_window, 1):.4f} ms")
    result["checks"] = {"mismatches": dict(value=mismatches,
                                           limit=MISMATCH_LIMIT)}
    # last: nothing loaded after the window (the reference, the metrics'
    # readers) may have brought in JAX or the JAX package
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules the benchmark must not load are "
                           f"loaded: {found}")
    return result


def parse_args(argv):
    import argparse
    p = argparse.ArgumentParser(prog="dcsbench/run.py",
                                description="One run of one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start):
    args = parse_args(argv)
    _, cell, _, _ = load_spec(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"{have} available", file=sys.stderr)
        return 2
    log = []
    try:
        result = run_cell(args.workload, args.seed, args.seconds, args.trace,
                          "cuda", t_start=t_start, log=log)
    finally:
        for line in log:
            print(line)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
