"""Multi-device sharding of the port (dcsexplorer_tpu_torch/parallel/
sweep.py) on the CPU: every sharded result must equal the port's
single-device result and the JAX package's, bit for bit (& $FFFF), as
tests/test_parallel.py holds the JAX sharding.  Meshes repeat the CPU
device (["cpu"] * 8): the split, the halo and the gather run as on
["cuda:0"] * 4, the shards one after another.

- the 2-D sweep of the padded model at frame_shards 1, 2 and 4 against the
  port's batch_decode and the JAX batch_decode;
- the flat sweep over the six .dcs94 assets x 3 (8,331 frames: not a
  multiple of 8) against the port's FlatPipeline on the CPU and the JAX
  run_flat; a 3-shard uneven split and a mesh longer than the frame axis;
- the halo, with teeth: on that input, a flat shard boundary falls where a
  one-row halo and a zero-row one both give another PCM (and a frame shard
  of the padded model without its row), so a halo cut short fails here;
- sessions at B = 6 on 8 devices (two empty shards) on the synthetic ROM
  of test_parallel.py against the JAX sharded_sessions on the 8-device
  virtual mesh; a 3-shard uneven split, a mesh longer than B, and the 1993
  bank of data/session93a.zip;
- sessions over a bank that grew between two calls, for both families
  (the session decoder cached for a bank must not outlive its rows)."""

import glob
import os

import numpy as np
import pytest
import torch

import jax

from dcsexplorer_tpu.compiler import romgen as g
from dcsexplorer_tpu.models import batched as jb
from dcsexplorer_tpu.models import flatsweep as jfs
from dcsexplorer_tpu.models import pipeline as jpl
from dcsexplorer_tpu.models import romplay as jrp
from dcsexplorer_tpu.parallel import sweep as jsweep
from dcsexplorer_tpu.refdec import decoder as jrd
from dcsexplorer_tpu.rom import zipload as jzip
from dcsexplorer_tpu_torch.models import batched as tb
from dcsexplorer_tpu_torch.models import flatsweep as tfs
from dcsexplorer_tpu_torch.models import pipeline as tpl
from dcsexplorer_tpu_torch.models import romplay as trp
from dcsexplorer_tpu_torch.ops import kernels
from dcsexplorer_tpu_torch.parallel import sweep
from dcsexplorer_tpu_torch.refdec import decoder as trd
from dcsexplorer_tpu_torch.rom import zipload as tzip

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets", "streams")
SESSION93A_ZIP = os.path.join(REPO, "dcsexplorer_tpu_torch", "data",
                              "session93a.zip")
LEGACY = ("chirpy", "noise_sweep", "sine_mix_1s", "tone_low")
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # the plain versions run many small ops; beside other test workers, a
    # thread pool per op costs more than it gives
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _legacy():
    return [_read(os.path.join(ASSETS, f"{n}.dcs94")) for n in LEGACY]


# -- the padded model over (tracks, frames) ----------------------------------

@pytest.fixture(scope="module")
def padded():
    """(port SweepInputs, port batch_decode, JAX batch_decode) of the
    legacy streams x 2, as test_parallel.py's 2-D sweep."""
    inputs = tb.SweepInputs(_legacy() * 2)
    single = tb.batch_decode(*inputs.args("cpu"))
    want = np.asarray(jax.jit(jb.batch_decode, static_argnums=(3, 4, 9))(
        *jb.SweepInputs(_legacy() * 2).args()))
    return inputs, single, want


@pytest.mark.parametrize("frame_shards", [1, 2, 4])
def test_sharded_sweep_matches_single_and_jax(padded, frame_shards):
    inputs, single, want = padded
    before = dict(kernels.LAUNCHES)
    mesh = sweep.make_mesh(CPU8, frame_shards=frame_shards)
    assert [len(row) for row in mesh] == [frame_shards] * (8 // frame_shards)
    got = sweep.sharded_sweep(mesh, inputs)
    assert got.shape == single.shape == want.shape == (8, 261, 240)
    assert torch.equal(got, single)
    assert np.array_equal(want & 0xFFFF, got.numpy())
    # 261 frames do not split evenly in 2 or 4, and the shorter streams'
    # pad rows fall in the later frame shards
    assert kernels.LAUNCHES == before


# -- the flat sweep ----------------------------------------------------------

@pytest.fixture(scope="module")
def flat():
    """(compact arrays, port single-device PCM, JAX run_flat PCM) of the six
    .dcs94 assets x 3."""
    streams = [_read(p) for p in sorted(glob.glob(os.path.join(ASSETS,
                                                               "*.dcs94")))]
    arrays = tfs.FlatSweep(streams * 3).pack().compact_host_arrays()
    single = tfs.FlatPipeline("cpu")(
        **tfs.packed_to_device(arrays, "cpu"))
    want = jfs.run_flat(jfs.FlatSweep(streams * 3).pack())
    return arrays, single, want


def test_sharded_flat_sweep_matches_single_and_jax(flat):
    arrays, single, want = flat
    N = single.shape[0]
    assert N == 8331 and N % 8
    got = sweep.sharded_flat_sweep(sweep.make_flat_mesh(CPU8), arrays)
    assert got.shape == (N, 240) and got.dtype == torch.int32
    assert torch.equal(got, single)
    assert np.array_equal(want, tfs.to_int16(got))


@pytest.mark.parametrize("n_shards", [3, 5])
def test_sharded_flat_sweep_on_uneven_splits(n_shards):
    # the six assets once: 2,777 frames split unevenly in 3 and in 5
    streams = [_read(p) for p in sorted(glob.glob(os.path.join(ASSETS,
                                                               "*.dcs94")))]
    arrays = tfs.FlatSweep(streams).pack().compact_host_arrays()
    single = tfs.FlatPipeline("cpu")(**tfs.packed_to_device(arrays, "cpu"))
    bounds = sweep.split(single.shape[0], n_shards)
    assert len({e - s for s, e in bounds}) == 2
    got = sweep.sharded_flat_sweep(["cpu"] * n_shards, arrays)
    assert torch.equal(got, single)


def test_sharded_flat_sweep_on_a_mesh_longer_than_the_frames():
    # a stream cut to 4 frames over 7 entries: three shards are empty and
    # every halo reaches back over a shard of one row
    s = _legacy()[0]
    arrays = tfs.FlatSweep([(4).to_bytes(2, "big") + s[2:]] * 2).pack() \
        .compact_host_arrays()
    single = tfs.FlatPipeline("cpu")(**tfs.packed_to_device(arrays, "cpu"))
    assert single.shape == (8, 240)
    for n in (7, 8, 11):
        got = sweep.sharded_flat_sweep(["cpu"] * n, arrays)
        assert torch.equal(got, single), n


def test_the_halo_has_teeth(flat, padded, monkeypatch):
    # the full halo equals the single device; each shorter one breaks a
    # shard boundary of this input: the row before a shard needs the band
    # types of the row before it (band_type_prev), and its tail (the carry)
    arrays, single, _ = flat
    assert sweep.FLAT_HALO == 2 and sweep.FRAME_HALO == 1
    wrong = {}
    for halo in (0, 1):
        monkeypatch.setattr(sweep, "FLAT_HALO", halo)
        got = sweep.sharded_flat_sweep(CPU8, arrays)
        wrong[halo] = (got != single).any(1).nonzero().flatten().tolist()
    # (the full halo's equality on this input and mesh:
    # test_sharded_flat_sweep_matches_single_and_jax)
    starts = [s for s, _ in sweep.split(single.shape[0], 8)]
    assert wrong[1] and set(wrong[1]) <= set(starts)
    assert set(wrong[1]) < set(wrong[0])

    inputs, single2, _ = padded
    monkeypatch.setattr(sweep, "FRAME_HALO", 0)
    got = sweep.sharded_sweep(sweep.make_mesh(CPU8, frame_shards=4), inputs)
    assert not torch.equal(got, single2)


# -- sessions ----------------------------------------------------------------

def _session_spec():
    """test_parallel.py's synthetic ROM: three legacy streams, each played
    forever by its own track on its own channel."""
    spec = g.RomSpec(os_version=jrd.OS94, num_channels=6)
    spec.streams = {f"s{i}": d for i, d in enumerate(_legacy()[:3])}
    spec.tracks = [g.TrackSpec(0, steps=[g.op_end()])]
    for i in range(3):
        spec.tracks.append(g.TrackSpec(i + 1, channel=i, steps=[
            g.op_mix(0, i, 0x40 + 4 * i),
            g.op_play(i, f"s{i}", repeat=0),
            g.op_wait_forever(),
        ]))
    return spec


def _trace(pl, rs, bank, B, T):
    """B sessions of T frames (test_parallel.py's schedule) through the
    pipeline module pl's tracer: session b starts tracks 1-3 at frame
    b % 5."""
    rows, mixes, vols = [], [], []
    for b in range(B):
        tr = pl.ControlTracer()
        tr.load_rom_set(rs)
        tr.soft_boot()

        def start(dec):
            for t in range(1, 4):
                dec.write_data_port(0x00)
                dec.write_data_port(t)
        tr.trace_frames(T, events={b % 5: start})
        r, m, v = pl.assemble_controls(tr, bank)
        rows.append(r)
        mixes.append(m)
        vols.append(v)
    return np.stack(rows), np.stack(mixes), np.stack(vols)


@pytest.fixture(scope="module")
def sessions():
    """(port bank, rows, mix, vol, the JAX sharded_sessions PCM) for
    B = 6 sessions of 40 frames on the 8-device virtual mesh."""
    data = g.RomBuilder(_session_spec()).build_zip()
    rs_j, _ = jzip.load_zip_data(data)
    rs_t, _ = tzip.load_zip_data(data)
    assert rs_j.check() == rs_t.check() == 1
    jbank = jrp.build_rom_bank(rs_j)
    bank = trp.build_rom_bank(rs_t, "cpu")
    B, T = 6, 40
    ctl = _trace(tpl, rs_t, bank, B, T)
    jctl = _trace(jpl, rs_j, jbank, B, T)
    assert all(np.array_equal(a, b) for a, b in zip(ctl, jctl))
    assert len(jax.devices()) >= 8
    want = np.asarray(jsweep.sharded_sessions(
        jsweep.make_flat_mesh(jax.devices()[:8]), jbank, *jctl))
    return (bank,) + ctl + (want,)


def test_sharded_sessions_match_jax_with_empty_shards(sessions):
    bank, rows, mix, vol, want = sessions
    before = dict(kernels.LAUNCHES)
    got = sweep.sharded_sessions(sweep.make_flat_mesh(CPU8), bank, rows,
                                 mix, vol)
    assert got.shape == want.shape == (6, 40, 240)
    assert np.array_equal(want & 0xFFFF, got.numpy())
    assert np.abs(want).max() > 0
    assert kernels.LAUNCHES == before


def _one_by_one(bank, rows, mix, vol):
    dec = tpl.session_decoder(bank)
    return torch.stack([tpl.device_decode(dec, r, m, v)[0]
                        for r, m, v in zip(rows, mix, vol)])


@pytest.mark.parametrize("n", [3, 4, 11])
def test_sharded_sessions_on_uneven_and_long_meshes(sessions, n):
    # the first 5 sessions: 3 and 4 shards split them unevenly, 11 leave
    # six shards empty
    bank = sessions[0]
    rows, mix, vol, want = (a[:5] for a in sessions[1:])
    one = _one_by_one(bank, rows, mix, vol)
    assert np.array_equal(want & 0xFFFF, one.numpy())
    # tensors as well as numpy arrays
    got = sweep.sharded_sessions(["cpu"] * n, bank, torch.tensor(rows),
                                 torch.tensor(mix), torch.tensor(vol))
    assert torch.equal(got, one)


def test_sharded_sessions_on_a_1993_bank():
    rs, _ = tzip.load_zip_file(SESSION93A_ZIP)
    assert rs.check() == 1
    bank = trp.build_rom_bank(rs, "cpu")
    assert bank.family93
    B, T = 5, 30
    rows, mix, vol = [], [], []
    for b in range(B):
        tr = tpl.ControlTracer()
        tr.load_rom_set(rs)
        tr.soft_boot()

        def start(dec, b=b):
            for t in range(1, 7):
                dec.write_data_port(0x00)
                dec.write_data_port(t)
        tr.trace_frames(T, events={b: start})
        for acc, a in zip((rows, mix, vol), tpl.assemble_controls(tr, bank)):
            acc.append(a)
    rows, mix, vol = (np.stack(a) for a in (rows, mix, vol))
    one = _one_by_one(bank, rows, mix, vol)
    assert np.abs(one.numpy().astype(np.int64)).max() > 0
    for n in (3, 8):
        got = sweep.sharded_sessions(["cpu"] * n, bank, rows, mix, vol)
        assert torch.equal(got, one), n


# the bank a family grows by: (os_version name, first stream, added stream)
GROWN_BANKS = {"1994": ("OS94", "sine_mix_1s.dcs94", "chirpy.dcs94"),
               "1993": ("OS93B", "music_a.dcs93b", "music_b.dcs93a")}


@pytest.mark.parametrize("family", sorted(GROWN_BANKS))
def test_sharded_sessions_follow_a_bank_that_grew(family):
    # a bank grows between two calls (add, then decode_all anew): the
    # second call's rows name the new stream's frames.  Each call equals
    # the JAX sharded_sessions over 2 virtual devices and a session
    # decoder built afresh, bit for bit; a decoder cached from the first
    # call's bank would decode against its old rows.  The JAX bank holds
    # both streams from the start (one compile of its build): a bank only
    # appends, so the first call's rows are the same rows in it
    os_name, first, added = GROWN_BANKS[family]
    mems = [_read(os.path.join(ASSETS, n)) for n in (first, added)]
    jbank = jpl.StreamBank(getattr(jrd, os_name))
    for mem in mems:
        jbank.add(mem)
    jbank.decode_all()
    mesh = jsweep.make_flat_mesh(jax.devices()[:2])
    tbank = tpl.StreamBank(getattr(trd, os_name))
    rng = np.random.default_rng(len(family))
    B, T, C = 2, 24, 2
    for k, mem in enumerate(mems):
        tbank.add(mem)
        tbank.decode_all("cpu")
        n_rows = tbank.total_rows()
        assert n_rows == 1 + sum((m[0] << 8) | m[1] for m in mems[:k + 1])
        lo = 1 if k == 0 else n_rows - ((mem[0] << 8) | mem[1])
        rows = rng.integers(lo, n_rows, size=(B, T, C)).astype(np.int32)
        rows[:, ::5, 1] = 0                          # silent voices too
        mix = rng.integers(0, 1 << 16, size=(B, T, C)).astype(np.int32)
        vol = rng.integers(0, 4, size=(B, T)).astype(np.int32)
        got = sweep.sharded_sessions(["cpu"] * 2, tbank, rows, mix, vol)
        want = np.asarray(jsweep.sharded_sessions(mesh, jbank, rows, mix,
                                                  vol))
        assert np.array_equal(want & 0xFFFF, got.numpy()), k
        assert torch.equal(got, _one_by_one(tbank, rows, mix, vol)), k
        assert np.abs(want).max() > 0


def test_meshes():
    assert sweep.make_flat_mesh(["cpu", torch.device("cpu")]) == [
        torch.device("cpu")] * 2
    assert sweep.make_mesh(CPU8, 4) == [[torch.device("cpu")] * 4] * 2
    with pytest.raises(ValueError, match="do not divide"):
        sweep.make_mesh(CPU8, 3)
    with pytest.raises(ValueError, match="no device"):
        sweep.make_flat_mesh([])
    assert sweep.split(5, 3) == [(0, 1), (1, 3), (3, 5)]
    assert sweep.split(2, 4) == [(0, 0), (0, 1), (1, 1), (1, 2)]
