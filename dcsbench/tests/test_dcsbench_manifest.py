"""BENCHMARK.json and the files it names: the names, units,
keys and limits, every metric's reader, configuration and traffic file,
and the data against its checksum manifest."""

import hashlib
import json
import os
import re
import shutil

import pytest

from dcsbench import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "dcsbench/run.py"]
    assert BENCH["paths"] == ["dcsbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    assert not any(p.endswith("_torch") for p in BENCH["paths"])


def test_names_units_and_texts():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            for k in ("why", "layer", "source"):
                if k in e:
                    assert TEXT.match(e[k]), (e["name"], k)
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))


def test_entries_have_exactly_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("dcsbench/")
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"]
        assert all(NAME.match(k) for k in c["reduced"])
        assert set(c["reduced"]) <= set(cfg["assumed"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert os.path.exists(os.path.join(HERE, "traffic",
                                           f"{w['traffic']}.json"))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        assert hasattr(harness.load_metric(m["name"]), "read")
    for cell in cells:
        reported = [m for m in BENCH["end_to_end"]
                    if cell in m.get("workloads", [cell])]
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


def test_roofline_metrics_are_named_for_their_kernel():
    for m in BENCH["per_layer"]:
        if m["name"].endswith(".roofline"):
            assert m["unit"] == "%" and m["better"] == "higher"
            mod = harness.load_metric(m["name"])
            assert mod.KERNELS == (m["name"][:-len(".roofline")] + "_kernel",)


def test_files_under_paths_have_names_of_name_characters():
    for dirpath, dirs, files in os.walk(HERE):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def write_manifest(directory):
    """Write the ``MANIFEST.json`` of the data files of one directory."""
    man = {}
    for f in sorted(os.listdir(directory)):
        path = os.path.join(directory, f)
        if os.path.isfile(path) and not f.endswith((".py", ".json")):
            with open(path, "rb") as fh:
                data = fh.read()
            man[f] = {"bytes": len(data),
                      "sha256": hashlib.sha256(data).hexdigest()}
    with open(os.path.join(directory, "MANIFEST.json"), "w") as out:
        json.dump(man, out, indent=1)


def check_listing(data_dir):
    """Fail unless each data directory's files (but its ``.py`` and
    ``.json`` ones) are the files its ``MANIFEST.json`` lists."""
    for sub in harness.data_dirs(data_dir):
        d = os.path.join(data_dir, sub)
        man = harness.load_json(os.path.join(d, "MANIFEST.json"))
        data = {f for f in os.listdir(d)
                if os.path.isfile(os.path.join(d, f))
                and not f.endswith((".py", ".json"))}
        assert data == set(man), \
            f"unlisted or missing in data/{sub}: {sorted(data ^ set(man))}"


def _data_copy(tmp_path):
    """A copy of ``data/`` with a directory ``title/`` of its own data
    (a copy of a stream) under its own manifest."""
    data = tmp_path / "data"
    shutil.copytree(os.path.join(HERE, "data"), data)
    (data / "title").mkdir()
    shutil.copy(data / "music_a.dcs94", data / "title" / "stream.dcs94")
    write_manifest(data / "title")
    harness.check_data(str(data))
    check_listing(str(data))
    return data


def test_data_matches_its_manifest():
    harness.check_data()
    check_listing(os.path.join(HERE, "data"))


def test_a_changed_byte_fails_the_manifest(tmp_path):
    data = tmp_path / "data"
    shutil.copytree(os.path.join(HERE, "data"), data)
    blob = bytearray((data / "music_a.dcs94").read_bytes())
    blob[100] ^= 1
    (data / "music_a.dcs94").write_bytes(bytes(blob))
    with pytest.raises(RuntimeError, match="music_a.dcs94"):
        harness.check_data(str(data))


def test_a_changed_byte_in_a_data_directory_fails_its_manifest(tmp_path):
    data = _data_copy(tmp_path)
    path = data / "title" / "stream.dcs94"
    blob = bytearray(path.read_bytes())
    blob[100] ^= 1
    path.write_bytes(bytes(blob))
    with pytest.raises(RuntimeError, match="data/title/stream.dcs94 "
                       "differs from title/MANIFEST.json"):
        harness.check_data(str(data))


def test_a_data_file_outside_its_manifest_fails(tmp_path):
    data = _data_copy(tmp_path)
    shutil.copy(data / "music_b.dcs94", data / "title" / "stray.dcs94")
    harness.check_data(str(data))
    with pytest.raises(AssertionError, match="stray.dcs94"):
        check_listing(str(data))
    # a data directory with no manifest of its own is refused too
    (data / "title" / "MANIFEST.json").unlink()
    with pytest.raises(FileNotFoundError, match="title/MANIFEST.json"):
        harness.check_data(str(data))
