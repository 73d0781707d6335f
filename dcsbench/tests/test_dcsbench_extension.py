"""A configuration joins the benchmark as new files only: its data in a
directory of its own under its own manifest, the session wire's reader its
configuration names (``rom.wire``), and new entries in ``BENCHMARK.json``;
the CPU checks take its cell from there.  No file the benchmark already has
is edited."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from dcsbench.harness import jobs
from dcsbench.reference import wire
from test_dcsbench_manifest import write_manifest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def test_the_wire_reader_is_the_one_the_configuration_names(tmp_path):
    assert jobs.load_wire(None) is wire
    shutil.copy(os.path.join(HERE, "reference", "wire.py"),
                tmp_path / "wire_u16copy.py")
    mod = jobs.load_wire("u16copy", str(tmp_path))
    assert mod.__file__ == str(tmp_path / "wire_u16copy.py")
    assert mod.expand is not wire.expand
    with pytest.raises(RuntimeError, match="wire_absent.py"):
        jobs.load_wire("absent", str(tmp_path))
    with pytest.raises(RuntimeError, match="wire_absent.py"):
        jobs.load_wire("absent")
    with pytest.raises(RuntimeError, match="needs the file"):
        jobs.load_wire("../wire", str(tmp_path))
    (tmp_path / "wire_empty.py").write_text("")
    with pytest.raises(RuntimeError, match="defines no expand"):
        jobs.load_wire("empty", str(tmp_path))


def test_the_cpu_checks_keep_the_four_cells_at_their_sizes():
    from dcsbench_sizes import CELLS, FAMILY_KIND, SESSIONS
    four = ("os94.catalog", "os93.catalog", "os94.sessions", "os93.sessions")
    assert {c: FAMILY_KIND[c] for c in four} == {
        "os94.catalog": ("os94", "catalog"),
        "os93.catalog": ("os93", "catalog"),
        "os94.sessions": ("os94", "sessions"),
        "os93.sessions": ("os93", "sessions")}
    assert CELLS["os94.catalog"] == dict(
        overrides={"variants": 2}, config_overrides={"catalog": [
            {"streams": [["music_a.dcs94", 1], ["music_b.dcs94", 1]]}]})
    assert CELLS["os93.catalog"] == dict(
        overrides={"variants": 2}, config_overrides={"catalog": [
            {"t1": False, "streams": [["music_a.dcs93b", 1],
                                      ["music_b.dcs93a", 1]]},
            {"t1": True, "streams": [["dense_t1.dcs93a1", 1],
                                     ["dense_t1b.dcs93a1", 1]]}]})
    assert CELLS["os94.sessions"] == CELLS["os93.sessions"] == SESSIONS == \
        dict(overrides={"sessions": 4, "frames": 300, "batches": 2,
                        "check_sessions": 3})


def _tree(root):
    """{path under root: SHA-256} of BENCHMARK.json and dcsbench/."""
    out = {}
    paths = [os.path.join(root, "BENCHMARK.json")]
    for dirpath, dirs, files in os.walk(os.path.join(root, "dcsbench")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        paths += [os.path.join(dirpath, f) for f in files]
    for path in paths:
        with open(path, "rb") as f:
            out[os.path.relpath(path, root)] = hashlib.sha256(
                f.read()).hexdigest()
    return out


# the copy's run: its own dcsbench first on the path, the program after
# it; a sound run and one broken path of the new cell, as the fault tests
# run them, with the cell and its sizes taken from the copy's
# BENCHMARK.json
RUN = """
import json, sys
sys.path[:0] = [{copy!r}, {copy!r} + "/dcsbench/tests"]
sys.path.append({root!r})
import pytest, torch
import test_dcsbench_faults as tf
from dcsbench import harness
from dcsbench.harness import jobs
from dcsbench_sizes import CELLS
assert harness.__file__.startswith({copy!r}), harness.__file__
readers, load_wire = [], jobs.load_wire
def recorded(name):
    mod = load_wire(name)
    readers.append(mod.__file__)
    return mod
jobs.load_wire = recorded
cell = "title95.sessions"
sound = tf._run(cell)
with pytest.MonkeyPatch.context() as mp:
    broken = tf._run(cell, mp, tf.altered)
print(json.dumps(dict(cells=sorted(CELLS), readers=readers, sound=sound,
                      broken=broken)))
"""


def test_a_configuration_added_as_new_files_runs_and_is_checked(tmp_path):
    copy = tmp_path / "bench"
    copy.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy)
    shutil.copytree(HERE, copy / "dcsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _tree(copy)

    # the new files: data, manifest, wire reader, configuration
    title = copy / "dcsbench" / "data" / "title95"
    title.mkdir()
    shutil.copy(copy / "dcsbench" / "data" / "rom94.zip", title / "rom.zip")
    write_manifest(title)
    shutil.copy(copy / "dcsbench" / "reference" / "wire.py",
                copy / "dcsbench" / "reference" / "wire_u16copy.py")
    config = json.loads((copy / "dcsbench" / "configs" / "os94.json")
                        .read_text())
    config["name"] = "title95"
    config["rom"] = dict(config["rom"], file="title95/rom.zip",
                         wire="u16copy")
    (copy / "dcsbench" / "configs" / "title95.json").write_text(
        json.dumps(config, indent=1))

    # the new entries of BENCHMARK.json
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    os94 = next(c for c in bench["configs"] if c["name"] == "os94")
    bench["configs"].append(dict(os94, name="title95",
                                 file="dcsbench/configs/title95.json"))
    bench["workloads"].append(dict(name="title95.sessions", config="title95",
                                   traffic="sessions", chips=1,
                                   why="a configuration of new files only"))
    for m in bench["per_layer"]:
        if "os94.sessions" in m["workloads"]:
            m["workloads"].append("title95.sessions")
    (copy / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))

    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(copy=str(copy), root=ROOT)],
        cwd=copy, capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert "title95.sessions" in r["cells"]
    assert r["readers"] == 2 * [str(copy / "dcsbench" / "reference" /
                                    "wire_u16copy.py")]
    assert r["sound"]["correct"] and r["sound"]["failed"] == 0
    assert r["sound"]["checks"]["mismatches"] == {"value": 0, "limit": 0}
    assert not r["broken"]["correct"]
    assert r["broken"]["checks"]["mismatches"]["value"] > 0

    after = _tree(copy)
    changed = sorted(p for p in before if after.get(p) != before[p])
    assert changed == ["BENCHMARK.json"]
    assert sorted(set(after) - set(before)) == [
        os.path.join("dcsbench", p) for p in (
            "configs/title95.json", "data/title95/MANIFEST.json",
            "data/title95/rom.zip", "reference/wire_u16copy.py")]
