"""Port parity for the whole flat 1994+ sweep: the port's FlatSweep packs
the same wire columns as the JAX one, and FlatPipeline on the CPU (the
plain versions of the kernels) equals jax.jit(flat_pipeline_packed) bit for
bit over the six .dcs94 assets.  Also: no kernel launches on the CPU, the
port never imports jax or the JAX package (at run time and in its sources),
its entry points default to the card and raise without one, and
chip_smoke.py refuses to run without a CUDA device."""

import glob
import inspect
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcsexplorer_tpu.models import flatsweep as jfs
from dcsexplorer_tpu_torch.models import flatsweep as tfs
from dcsexplorer_tpu_torch.ops import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets", "streams")


def _streams():
    paths = sorted(glob.glob(os.path.join(ASSETS, "*.dcs94")))
    assert len(paths) == 6
    return paths, [open(p, "rb").read() for p in paths]


@pytest.fixture(scope="module")
def sweeps():
    _, streams = _streams()
    return jfs.FlatSweep(streams).pack(), tfs.FlatSweep(streams).pack()


@pytest.fixture(scope="module")
def jax_pcm(sweeps):
    """The JAX slice over the six assets (one ~25 s CPU compile)."""
    ca = dict(sweeps[0].compact_host_arrays())
    n_steps = ca.pop("n_steps")
    fn = jax.jit(jfs.flat_pipeline_packed, static_argnums=(9,))
    return np.asarray(fn(*[jnp.asarray(v) for v in ca.values()], n_steps))


def test_compact_host_arrays_match_jax(sweeps):
    want = sweeps[0].compact_host_arrays()
    got = sweeps[1].compact_host_arrays()
    assert list(got) == list(want)
    for k in want:
        if k == "n_steps":
            assert got[k] == want[k]
            continue
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def test_wide_args_match_jax(sweeps):
    want = sweeps[0].args()
    got = sweeps[1].args()
    assert len(got) == len(want) == 11
    for w, g in zip(want[:10], got[:10]):
        assert isinstance(g, np.ndarray)
        assert np.array_equal(np.asarray(w), g)
    assert got[10] == want[10]


def test_slice_on_cpu_matches_jax(sweeps, jax_pcm):
    before = dict(kernels.LAUNCHES)
    args = tfs.packed_to_device(sweeps[1].compact_host_arrays(), "cpu")
    pcm = tfs.FlatPipeline("cpu")(**args)
    assert pcm.shape == jax_pcm.shape == (sweeps[1].n_frames_total, 240)
    assert pcm.dtype == torch.int32
    assert np.array_equal(jax_pcm & 0xFFFF, pcm.numpy())
    # on CPU tensors the plain versions ran: no kernel launched
    assert kernels.LAUNCHES == before
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_wide_run_flat_matches_jax(sweeps, jax_pcm):
    got = tfs.run_flat(sweeps[1], "cpu")
    want = (((jax_pcm & 0xFFFF) ^ 0x8000) - 0x8000).astype(np.int16)
    assert np.array_equal(want.reshape(-1), got)


def test_wide_flat_pipeline_matches_jax(sweeps, jax_pcm):
    # the wide columns run the plain path, and only on the CPU
    a = sweeps[1].args()
    t = [torch.tensor(np.asarray(x)) for x in a[:10]]
    tabs = tfs.codec_tables()
    pcm = tfs.flat_pipeline(*t, a[10], tabs)
    assert np.array_equal(jax_pcm & 0xFFFF, pcm.numpy())
    with pytest.raises(ValueError, match="no CUDA kernel"):
        tfs.flat_pipeline(t[0].to("meta"), *t[1:], a[10], tabs)


def test_smallest_stream_matches_reference_decoder(sweeps):
    # the scalar ReferenceDecoder is the ground truth chip_smoke.py checks
    # all six assets against on the card; here the shortest one on CPU
    paths, streams = _streams()
    pcm = tfs.run_flat(sweeps[1], "cpu")
    nfs = [(s[0] << 8) | s[1] for s in streams]
    k = int(np.argmin(nfs))
    off = sum(nfs[:k]) * 240
    want = tfs.reference_pcm(streams[k], nfs[k])
    assert np.array_equal(want, pcm[off:off + nfs[k] * 240]), paths[k]


def test_flat_pipeline_module_carries_codec_tables():
    pipe = tfs.FlatPipeline(device="cpu")
    bufs = dict(pipe.named_buffers())
    assert bufs["cb_flat"].shape == (940,)
    assert all(b.dtype == torch.int32 for b in bufs.values())
    assert list(pipe.parameters()) == []        # tables, no weights


_NO_JAX = r"""
import importlib, pkgutil, sys
import dcsexplorer_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dcsexplorer_tpu_torch.__path__,
                                               "dcsexplorer_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
import numpy as np
import torch
torch.set_num_threads(1)    # beside other test workers, one thread is faster
from dcsexplorer_tpu_torch.models import flatsweep as fs
sw = fs.FlatSweep([open(sys.argv[1], "rb").read()]).pack()
pcm = fs.FlatPipeline("cpu")(**fs.packed_to_device(sw.compact_host_arrays(),
                                                   "cpu"))
assert pcm.shape == (sw.n_frames_total, 240)
assert fs.reference_pcm(open(sys.argv[1], "rb").read(), 2).shape == (480,)
from dcsexplorer_tpu_torch.models import romplay
from dcsexplorer_tpu_torch.rom import zipload
rs, _ = zipload.load_zip_file("dcsexplorer_tpu_torch/data/session6.zip")
with romplay.SessionServer(rs, 2, 8, n_ch=6, device="cpu") as srv:
    assert srv.serve_one([{0: [0, 1]}, {1: [0, 2]}]).shape == (2, 1920)
from dcsexplorer_tpu_torch.tools import explorer
assert explorer.main(["dcsexplorer_tpu_torch/data/session6.zip", "--validate",
                      "--platform", "cpu", "--max-track-frames", "20"]) == 0
from dcsexplorer_tpu_torch import graft_entry
from dcsexplorer_tpu_torch.models import batched
from dcsexplorer_tpu_torch.parallel import sweep
assert {"dcsexplorer_tpu_torch.graft_entry", "dcsexplorer_tpu_torch.models.batched",
        "dcsexplorer_tpu_torch.parallel.sweep"} <= set(names)
assert len(graft_entry.dryrun_multichip(2, "cpu")) == 2
dense, scale, fb_idx, valid, nf = batched.hybrid_host_stage(
    [open(sys.argv[1], "rb").read()])
z = np.zeros((1, nf[0]), np.int32)
assert batched.hybrid_batch_device(dense, scale, fb_idx, valid, z, z,
                                   device="cpu").shape == (1, nf[0], 240)
import os, tempfile, zipfile
from dcsexplorer_tpu_torch.tools import encoder_cli
out = os.path.join(tempfile.mkdtemp(), "rom.zip")
assert encoder_cli.main(["--script", "assets/example.dcss", "-o", out,
                         "--device", "cpu", "-q"]) == 0
assert "sound_u2.rom" in zipfile.ZipFile(out).namelist()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "dcsexplorer_tpu"))
assert not bad, bad
print(len(names))
"""


def test_port_never_imports_jax():
    # a fresh interpreter: this test process has jax and the JAX package
    # loaded.  After the port, chip_smoke, a CPU sweep, a served CPU
    # session batch, the explorer's --validate on the CPU, the sharded
    # paths (dryrun_multichip on a mesh of two CPU entries), the
    # host-decode hybrid and a script compiled through the encoder CLI on
    # the CPU, neither jax nor any module of dcsexplorer_tpu may be loaded.
    paths, _ = _streams()
    r = subprocess.run([sys.executable, "-c", _NO_JAX, paths[0]], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 62      # every port module imported


# the JAX package named as a module: "dcsexplorer_tpu." or an import of it,
# but not "dcsexplorer_tpu_torch" and not a path ("dcsexplorer_tpu/...")
_NAMES_JAX_PACKAGE = re.compile(
    r"\bdcsexplorer_tpu\.|\bfrom\s+dcsexplorer_tpu\s+import\b"
    r"|\bimport\s+dcsexplorer_tpu\b(?!_)")


def test_port_sources_never_name_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "dcsexplorer_tpu_torch")):
        files += [os.path.join(root, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh", ".cpp", ".h"))]
    assert len(files) >= 20
    hits = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            for k, line in enumerate(f, 1):
                if _NAMES_JAX_PACKAGE.search(line):
                    hits.append(f"{os.path.relpath(path, REPO)}:{k}: {line}")
    assert not hits, "".join(hits)
    # the pattern itself catches what it must
    for bad in ("from dcsexplorer_tpu.ops import prescan",
                "from dcsexplorer_tpu import native", "import dcsexplorer_tpu",
                "dcsexplorer_tpu.format.tables"):
        assert _NAMES_JAX_PACKAGE.search(bad), bad
    for fine in ("from dcsexplorer_tpu_torch.ops import kernels",
                 "import dcsexplorer_tpu_torch", "dcsexplorer_tpu/ops/x.py"):
        assert not _NAMES_JAX_PACKAGE.search(fine), fine


def test_entry_points_default_to_the_card(sweeps):
    # the defaults name the card; here, where there is none, they raise
    # instead of falling back to the CPU
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert inspect.signature(tfs.packed_to_device).parameters[
        "device"].default == "cuda"
    assert inspect.signature(tfs.run_flat).parameters[
        "device"].default == "cuda"
    assert inspect.signature(tfs.FlatPipeline).parameters[
        "device"].default is None
    arrays = sweeps[1].compact_host_arrays()
    for call in (tfs.FlatPipeline, lambda: tfs.packed_to_device(arrays),
                 lambda: tfs.run_flat(sweeps[1])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_chip_smoke_refuses_without_cuda(tmp_path):
    # no CUDA device here: non-zero exit and no result line, from the repo
    # and from a directory that holds chip_smoke.py alone
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lone = tmp_path / "chip_smoke.py"
    lone.write_bytes(open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
    for script, cwd in ((os.path.join(REPO, "chip_smoke.py"), REPO),
                        (str(lone), str(tmp_path))):
        r = subprocess.run([sys.executable, script], cwd=cwd,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
