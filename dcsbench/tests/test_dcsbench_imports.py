"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program under test.  Top-level module names
are compared whole: the port, ``dcsexplorer_tpu_torch``, begins with the
JAX package's name, ``dcsexplorer_tpu``."""

import ast
import json
import os
import subprocess
import sys

from dcsbench import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub, here=HERE):
    for dirpath, _, files in os.walk(os.path.join(here, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _program_imports(here):
    """{reference source: names it imports of the program or of JAX}."""
    bad = {}
    for path in _sources("reference", here):
        names = set(_imports(path))
        hit = {n for n in names if n.startswith("dcsexplorer")
               or n in harness.FORBIDDEN}
        if hit:
            bad[os.path.relpath(path, here)] = sorted(hit)
    return bad


def test_names_are_compared_whole():
    assert harness.forbidden_modules(["dcsexplorer_tpu_torch",
                                      "dcsexplorer_tpu_torch.ops"]) == []
    assert harness.forbidden_modules(["dcsexplorer_tpu.ops", "numpy"]) == \
        ["dcsexplorer_tpu"]
    assert harness.forbidden_modules(["jaxlib.xla", "jax", "flax.linen"]) \
        == ["flax", "jax", "jaxlib"]


def test_reference_imports_nothing_of_the_program(tmp_path):
    assert _program_imports(HERE) == {}
    # a configuration's wire reader (reference/wire_<name>.py) is held to
    # it as the rest of the reference is
    ref = tmp_path / "reference"
    ref.mkdir()
    (ref / "wire_wide.py").write_text(
        "from dcsexplorer_tpu_torch.models import romplay\n")
    assert _program_imports(str(tmp_path)) == {
        "reference/wire_wide.py": ["dcsexplorer_tpu_torch"]}


def test_no_source_of_the_benchmark_imports_jax():
    bad = {}
    for path in (p for sub in ("", "tests") for p in _sources(sub)):
        hit = set(_imports(path)) & set(harness.FORBIDDEN)
        if hit:
            bad[os.path.relpath(path, ROOT)] = sorted(hit)
    assert bad == {}


def test_a_run_loads_no_forbidden_module():
    """A whole small run in a fresh interpreter, the control and every
    metric reader with it, then the modules it loaded."""
    code = f"""
import json, sys
sys.path.insert(0, {ROOT!r}); sys.path.insert(0, {HERE + '/tests'!r})
import torch
torch.set_num_threads(1)
from dcsbench import control, harness
from dcsbench_sizes import CELLS
for m in json.load(open({ROOT + '/BENCHMARK.json'!r}))["per_layer"]:
    harness.load_metric(m["name"])
r = harness.run_cell("os93.sessions", 3, 0.2, 0, device="cpu",
                     **CELLS["os93.sessions"])
control.control_readings("os94.catalog", [4], "cpu",
                         **CELLS["os94.catalog"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "dcsexplorer_tpu_torch" in loaded
    assert harness.forbidden_modules(loaded) == []


def test_a_module_loaded_after_the_window_refuses_the_result(monkeypatch):
    """The look at ``sys.modules`` is a run's last step: a JAX module that
    the check or a metric's reader brings in after the window still stops
    the run before any result."""
    import types

    import pytest
    import torch

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from dcsbench_sizes import CELLS
    torch.set_num_threads(1)
    cls = harness.KINDS["sessions"]
    check = cls.check

    def check_loading_jax(self, *a, **k):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return check(self, *a, **k)
    monkeypatch.setattr(cls, "check", check_loading_jax)
    with pytest.raises(RuntimeError, match="jax"):
        harness.run_cell("os93.sessions", 5, 0.2, 0, device="cpu",
                         **CELLS["os93.sessions"])
