"""The cells on the card: each runs as ``dcsbench/run.py`` runs it, with
``correct`` true and every metric it owes, traced and not.  Marked
``gpu``: they skip without a CUDA device.

    python -m pytest dcsbench/tests -q -m gpu
"""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _run(cell, seed, trace):
    out = subprocess.run(
        [sys.executable, "dcsbench/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_correct(card, cell, trace):
    r = _run(cell, 2 ** 31 + 17, trace)
    assert r["correct"] and r["failed"] == 0
    owed = BENCH["per_layer"] if trace else BENCH["end_to_end"]
    want = {m["name"] for m in owed if cell in m.get("workloads", [cell])}
    got = set(r["metrics"])
    assert got <= want
    if trace:
        assert r["device"]["busy_s"] > 0
        assert "enqueue_ms" in got and "device_idle" in got
    else:
        assert got == want
    for name, m in r["metrics"].items():
        if name.endswith(".roofline"):
            assert 0 < m["value"] <= 105
