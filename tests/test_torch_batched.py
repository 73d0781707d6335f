"""Port parity for the padded [streams, frames] model
(dcsexplorer_tpu_torch/models/batched.py) and the port's entry points
(dcsexplorer_tpu_torch/graft_entry.py) on the CPU, where the plain PyTorch
versions of decode94_fb and transform94_pcm run.  Each is held against the
JAX package bit for bit on & $FFFF:

- SweepInputs's padded arrays against the JAX SweepInputs's, for the six
  .dcs94 assets grouped by format family (test_batched.py's grouping);
- batch_decode against jax.jit(batch_decode) on every row of each group,
  pad rows included (each group has streams shorter than its longest);
- stream_decode on a chunk from the middle of a stream (so its first row's
  band_type_prev is not zero) with a nonzero carried overlap, and its final
  overlap;
- entry() against the JAX entry(), and dryrun_multichip(8, "cpu");
- band types past uint8 and mixed format families refused; the entry
  points default to the card and raise without one; no kernel launches on
  the CPU."""

import glob
import inspect
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as jge
from dcsexplorer_tpu.models import batched as jb
from dcsexplorer_tpu_torch import graft_entry as tge
from dcsexplorer_tpu_torch.models import batched as tb
from dcsexplorer_tpu_torch.ops import kernels
from dcsexplorer_tpu_torch.parallel import sweep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets", "streams")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # the plain versions run many small ops; beside other test workers, a
    # thread pool per op costs more than it gives
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _groups():
    """The .dcs94 assets by (fmt, sub) family, as test_batched.py groups
    them."""
    groups = {}
    for p in sorted(glob.glob(os.path.join(ASSETS, "*.dcs94"))):
        with open(p, "rb") as f:
            s = f.read()
        hdr = s[2:18]
        fam = ((hdr[0] & 0x80) >> 7,
               ((hdr[1] & 0x80) >> 6) | ((hdr[2] & 0x80) >> 7))
        groups.setdefault(fam, []).append(s)
    return groups


GROUPS = _groups()


def test_the_assets_make_two_families_with_pad_rows():
    assert sorted(GROUPS) == [(0, 0), (1, 3)]
    assert [len(g) for _, g in sorted(GROUPS.items())] == [2, 4]
    legacy = tb.SweepInputs(GROUPS[1, 3])
    # the legacy streams differ in length: the shorter ones carry pad rows
    assert len(set(legacy.n_frames.tolist())) == 4


@pytest.mark.parametrize("family", sorted(GROUPS), ids=str)
def test_sweep_inputs_match_jax(family):
    want = jb.SweepInputs(GROUPS[family])
    got = tb.SweepInputs(GROUPS[family])
    for k in ("stream_bytes", "rel_start", "headers", "band_type",
              "band_type_prev", "mix", "vol_shift", "n_frames"):
        w, g = getattr(want, k), getattr(got, k)
        assert g.dtype == w.dtype, k
        assert np.array_equal(w, g), k
    assert (got.fmt_type, got.sub_type, got.n_steps) == (
        want.fmt_type, want.sub_type, want.n_steps)


@pytest.mark.parametrize("family", sorted(GROUPS), ids=str)
def test_batch_decode_matches_jax_on_every_row(family):
    before = dict(kernels.LAUNCHES)
    inputs = tb.SweepInputs(GROUPS[family])
    got = tb.batch_decode(*inputs.args("cpu"))
    want = np.asarray(jax.jit(jb.batch_decode, static_argnums=(3, 4, 9))(
        *jb.SweepInputs(GROUPS[family]).args()))
    S, F = inputs.rel_start.shape
    assert got.shape == want.shape == (S, F, 240)
    assert got.dtype == torch.int32
    assert np.array_equal(want & 0xFFFF, got.numpy())
    # pad rows included, and they are not silent copies of nothing
    short = np.nonzero(inputs.n_frames < F)[0]
    if family == (1, 3):
        assert short.size == 3
    for k in short:
        n = int(inputs.n_frames[k])
        assert np.array_equal(want[k, n:] & 0xFFFF, got[k, n:].numpy())
    # on the CPU no kernel launched
    assert kernels.LAUNCHES == before


def test_stream_decode_matches_jax_mid_stream_with_a_carried_overlap():
    inputs = tb.SweepInputs(GROUPS[1, 3][3:])           # tone_low
    sb, rs, hd, fmt, sub, bt, btp, mix, vol, n_steps = inputs.args("cpu")
    j0, j1 = 40, 97
    chunk = (sb[0], rs[0, j0:j1], hd[0], fmt, sub, bt[0, j0:j1],
             btp[0, j0:j1], mix[0, j0:j1], vol[0, j0:j1])
    # the chunk's first band_type_prev is not zero: the halo row matters
    assert int(btp[0, j0].abs().sum()) > 0
    ov0 = np.random.default_rng(3).integers(0, 1 << 16, 16).astype(np.int32)
    got, last = tb.stream_decode(*chunk, torch.tensor(ov0), n_steps)
    fn = jax.jit(jb.stream_decode, static_argnums=(3, 4, 10))
    want, want_last = fn(*[jnp.asarray(a.numpy()) if isinstance(
        a, torch.Tensor) else a for a in chunk], jnp.asarray(ov0), n_steps)
    assert got.shape == (j1 - j0, 240) and last.shape == (16,)
    assert np.array_equal(np.asarray(want) & 0xFFFF, got.numpy())
    assert np.array_equal(np.asarray(want_last) & 0xFFFF, last.numpy())
    # the same frames inside the whole stream's decode, from the true carry
    whole = tb.batch_decode(*inputs.args("cpu"))[0]
    _, carry = tb.stream_decode(sb[0], rs[0, :j0], hd[0], fmt, sub,
                                bt[0, :j0], btp[0, :j0], mix[0, :j0],
                                vol[0, :j0], torch.zeros(16), n_steps)
    again, _ = tb.stream_decode(*chunk, carry, n_steps)
    assert torch.equal(again, whole[j0:j1])


def test_entry_matches_jax_entry():
    step, args = tge.entry("cpu")
    got = step(*args)
    jstep, jargs = jge.entry()
    want = np.asarray(jax.jit(jstep)(*jargs))
    assert got.shape == want.shape == (1, 261, 240)
    assert np.array_equal(want & 0xFFFF, got.numpy())
    assert all(a.device.type == "cpu" for a in args)


def test_dryrun_multichip_on_the_cpu():
    before = dict(kernels.LAUNCHES)
    mesh = tge.dryrun_multichip(8, "cpu")
    assert mesh == [torch.device("cpu")] * 8
    assert kernels.LAUNCHES == before


def test_band_types_past_uint8_are_refused():
    inputs = tb.SweepInputs(GROUPS[1, 3][3:])
    args = list(inputs.args("cpu"))
    args[5] = args[5].clone()
    args[5][0, 3, 2] = 256
    with pytest.raises(ValueError, match="band types exceed uint8"):
        tb.batch_decode(*args)
    inputs.band_type_prev[0, 5, 0] = -1
    with pytest.raises(ValueError, match="band types exceed uint8"):
        sweep.sharded_sweep(sweep.make_mesh(["cpu"] * 2), inputs)


def test_sweep_inputs_refuse_mixed_families():
    with pytest.raises(ValueError, match="one format family"):
        tb.SweepInputs(GROUPS[0, 0][:1] + GROUPS[1, 3][:1])


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    inputs = tb.SweepInputs(GROUPS[1, 3][3:])
    for fn in (inputs.args, tge.entry, tge.dryrun_multichip):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert inspect.signature(sweep.make_flat_mesh).parameters[
        "devices"].default is None
    for call in (inputs.args, tge.entry, lambda: tge.dryrun_multichip(2),
                 sweep.make_flat_mesh, sweep.make_mesh,
                 lambda: sweep.make_flat_mesh(["cuda:0"] * 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
