"""Port parity for the 1994+ ROM session path (models/pipeline.py,
models/romplay.py) on the CPU, where every kernel's plain PyTorch version
runs.  Each device piece is held against the JAX function bit for bit on
& $FFFF, and each whole path against the port's scalar ReferenceDecoder:

- the bank (decode94_bank_plain rows) against JAX StreamBank.decode_all's
  dense/scale/total, directly and through the multi-voice mix:
  session_mix94_plain over the rows equals the chain of JAX
  dequant_mix(..., active=row > 0) the JAX device_decode runs;
- device_decode with a non-zero carried overlap0, and its last_ov;
  overlap_resolve_planar_state; transform94_pcm_plain with per-session
  carries;
- the control wire (segments94_plain) against compress_controls and the
  JAX unpack_controls_wire + reconstruct_from_segments; the native segment
  trace and stream_row_table against the JAX package's;
- play_session, autoplay and decode_standalone against the scalar decoder;
- SessionServer: five batches at depth 2 against play_session (every batch
  is served, in order), a finished batch handed over while the next trace
  runs, the segment-table overflow retry, reduce_fn.
The ROM is test_romgen._make_spec's synthetic one, as in test_romplay.py."""

import inspect
import os
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dcsexplorer_tpu.compiler import romgen
from dcsexplorer_tpu.models import romplay as jrp
from dcsexplorer_tpu.ops import band_decode as jbd
from dcsexplorer_tpu.ops import transform as jtf
from dcsexplorer_tpu.rom import zipload as jzip
from dcsexplorer_tpu.vm import native_tracer as jnt
from dcsexplorer_tpu_torch.models import flatsweep as tfs
from dcsexplorer_tpu_torch.models import pipeline as tpl
from dcsexplorer_tpu_torch.models import romplay as trp
from dcsexplorer_tpu_torch.ops import band_decode as tbd
from dcsexplorer_tpu_torch.ops import kernels
from dcsexplorer_tpu_torch.ops import transform as ttf
from dcsexplorer_tpu_torch.refdec import decoder as trd
from dcsexplorer_tpu_torch.rom import zipload as tzip
from dcsexplorer_tpu_torch.vm import native_tracer as tnt

from .test_romgen import _make_spec
from .torch_native_guard import reference_native_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets", "streams")
NAMES = sorted(n for n in os.listdir(ASSETS) if n.endswith(".dcs94"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # the plain versions run many small ops; beside other test workers, a
    # thread pool per op costs more than it gives
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def roms():
    """(JAX RomSet, port RomSet) of the synthetic ROM."""
    data = romgen.RomBuilder(_make_spec()).build_zip()
    rs_j, _ = jzip.load_zip_data(data, zip_name="synth.zip")
    rs_t, _ = tzip.load_zip_data(data, zip_name="synth.zip")
    return rs_j, rs_t


@pytest.fixture(scope="module")
def jax_bank(roms):
    return jrp.build_rom_bank(roms[0])          # one ~20 s CPU compile


@pytest.fixture(scope="module")
def bank(roms):
    return trp.build_rom_bank(roms[1], "cpu")


@pytest.fixture(scope="module")
def tabs():
    return tfs.codec_tables()


def _byte_events(b):
    """Session b's port-byte schedule: staggered track starts and a master
    volume command (the JAX test_session_server schedule)."""
    ev = {}
    for t in (1, 2, 3):
        ev.setdefault((b * 11 + t * 7) % 40, []).extend([0x00, t])
    vol = 0x50 + 8 * b
    ev.setdefault(0, []).extend([0x55, 0xAA, vol & 0xFF, (vol & 0xFF) ^ 0xFF])
    return ev


def _callable_events(byte_ev):
    out = {}
    for f, bs in byte_ev.items():
        def ev(dec, bs=tuple(bs)):
            for b in bs:
                dec.write_data_port(b)
        out[f] = ev
    return out


def _scalar_session(rs, events, n_frames, default_volume=0x67):
    dec = trd.ReferenceDecoder()
    dec.default_volume = default_volume
    dec.load_rom_set(rs)
    dec.soft_boot()
    out = []
    for f in range(n_frames):
        if f in events:
            events[f](dec)
        out.extend(dec.next_samples(240))
    return np.array(out, dtype=np.int16)


def _random_controls(R, F, C, seed):
    """Bank rows (a quarter silent) and mixes over the whole u16 range."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(1, R, size=(F, C))
    rows[rng.random((F, C)) < 0.25] = 0
    mix = rng.integers(0, 1 << 16, size=(F, C))
    mix[:4, 0] = [0, 0xFFFF, 0x8000, 0x7FFF]
    return rows.astype(np.int32), mix.astype(np.int32)


# -- the bank --------------------------------------------------------------

def test_bank_layout_matches_jax(bank, jax_bank):
    assert bank.total_rows() == jax_bank.total_rows() == bank.scaled.shape[0]
    assert list(bank.offsets.values()) == list(jax_bank.offsets.values())
    assert bank.scaled.dtype == torch.int16 and bank.scaled.shape[1] == 256


def test_bank_rows_are_jax_dense_times_scale(bank, jax_bank):
    dense, scale, total = (np.asarray(a).astype(np.int64) for a in
                           (jax_bank.dense, jax_bank.scale, jax_bank.total))
    s16 = ((dense & 0xFFFF) ^ 0x8000) - 0x8000
    want = (s16 * (scale & 0xFFFF)) & 0xFFFF
    want[np.arange(256)[None, :] >= total[:, None]] = 0
    assert np.array_equal(want, bank.scaled.numpy().astype(np.int64) & 0xFFFF)
    assert (total[1:] < 256).any() and want[1:].any()
    assert not want[0].any()


@pytest.mark.parametrize("C", [1, 6, 8])
def test_session_mix_matches_jax_active_dequant_chain(bank, jax_bank, C):
    R = bank.total_rows()
    rows, mix = _random_controls(R, 300, C, C)
    got = tbd.session_mix94_plain(bank.scaled, torch.from_numpy(rows),
                                  torch.from_numpy(mix))
    dense, scale, total = jax_bank.dense, jax_bank.scale, jax_bank.total
    fb = jnp.zeros((rows.shape[0], 512), jnp.int32)
    for c in range(C):
        r = jnp.asarray(rows[:, c])
        fb = jbd.dequant_mix(dense[r], (scale[r], total[r]),
                             jnp.asarray(mix[:, c]), fb_prev=fb,
                             active=r > 0)
    assert got.dtype == torch.int32
    assert np.array_equal(np.asarray(fb) & 0xFFFF, got.numpy())


def test_dequant_mix_plain_active_matches_jax(jax_bank):
    rng = np.random.default_rng(3)
    F = 200
    r = rng.integers(0, jax_bank.total_rows(), size=F)
    r[::3] = 0
    mix = rng.integers(0, 1 << 16, size=F).astype(np.int32)
    prev = rng.integers(0, 1 << 16, size=(F, 512)).astype(np.int32)
    active = rng.random(F) < 0.7
    dense, scale, total = (np.asarray(a)[r] for a in
                           (jax_bank.dense, jax_bank.scale, jax_bank.total))
    want = jbd.dequant_mix(jnp.asarray(dense), (jnp.asarray(scale),
                                                jnp.asarray(total)),
                           jnp.asarray(mix), fb_prev=jnp.asarray(prev),
                           active=jnp.asarray(active))
    got = tbd.dequant_mix_plain(
        torch.from_numpy(dense), (torch.from_numpy(scale),
                                  torch.from_numpy(total)),
        torch.from_numpy(mix), torch.from_numpy(prev),
        torch.from_numpy(active))
    assert np.array_equal(np.asarray(want) & 0xFFFF, got.numpy() & 0xFFFF)


@pytest.mark.parametrize("os_v,name", [(trd.OS93B, "music_b.dcs93a"),
                                        (trd.OS93A, "dense_t1.dcs93a1")])
def test_stream_bank_builds_and_decodes_the_1993_family(os_v, name):
    # a 1993 bank keeps the bitstream and its index as columns (no decoded
    # rows) and decodes through SessionDecoder93; tests/
    # test_torch_sessions93.py holds the family against the JAX package
    s = open(os.path.join(ASSETS, name), "rb").read()
    bank = tpl.StreamBank(os_v)
    bank.add(s)
    bank.decode_all("cpu")
    assert bank.family93 and not hasattr(bank, "scaled")
    assert bank.total_rows() == 1 + ((s[0] << 8) | s[1])
    assert bank.cols["kind_u8"].shape == (bank.total_rows(),)
    dec = tpl.session_decoder(bank)
    assert isinstance(dec, tpl.SessionDecoder93)
    n = 12
    got = tpl.decode_standalone([(s, 0, 0x64)], os_version=os_v, n_frames=n,
                                device="cpu")
    ref = trd.ReferenceDecoder()
    ref.default_volume = 0x67
    ref.init_standalone(os_v)
    ref.soft_boot()
    ref.load_audio_stream(0, s, mixing_level=0x64)
    want = np.array(ref.next_samples(n * 240), dtype=np.int16)
    assert np.array_equal(want, got) and np.abs(want).max() > 0


# -- device_decode and the carried overlap ---------------------------------

def test_device_decode_with_carried_state_matches_jax(bank, jax_bank):
    R = bank.total_rows()
    rows, mix = _random_controls(R, 96, 8, 11)
    vol = np.random.default_rng(12).integers(0, 12, size=96).astype(np.int32)
    ov0 = np.random.default_rng(13).integers(0, 1 << 16, 16).astype(np.int32)
    want_pcm, want_ov = jax_bank.jitted()(rows, mix, vol, jnp.asarray(ov0))
    dec = tpl.SessionDecoder(bank)
    got_pcm, got_ov = tpl.device_decode(dec, rows, mix, vol, ov0)
    assert np.array_equal(np.asarray(want_pcm) & 0xFFFF, got_pcm.numpy())
    assert np.array_equal(np.asarray(want_ov) & 0xFFFF, got_ov.numpy())
    # overlap0 changed the first frame's head, and nothing else
    zero_pcm, zero_ov = tpl.device_decode(dec, rows, mix, vol)
    assert not torch.equal(zero_pcm[0], got_pcm[0])
    assert torch.equal(zero_pcm[1:], got_pcm[1:])
    assert torch.equal(zero_ov, got_ov)


def test_overlap_resolve_planar_state_matches_jax(tabs):
    rng = np.random.default_rng(21)
    re, im = (rng.integers(0, 1 << 16, size=(40, 128)).astype(np.int32)
              for _ in range(2))
    ov0 = rng.integers(0, 1 << 16, size=16).astype(np.int32)
    want = jtf.overlap_resolve_planar_state(jnp.asarray(re), jnp.asarray(im),
                                            jnp.asarray(ov0))
    got = ttf.overlap_resolve_planar_state(torch.from_numpy(re),
                                           torch.from_numpy(im),
                                           torch.from_numpy(ov0), tabs)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w) & 0xFFFF, g.numpy())


@pytest.mark.parametrize("runs", [[70], [1, 63, 2, 64, 1], [30, 0, 45, 5]])
def test_transform94_pcm_plain_carries_each_session(tabs, runs):
    # sessions of the given lengths in one batch (an empty one keeps its
    # carry), each against JAX transform94_planar +
    # overlap_resolve_planar_state from its own overlap0
    rng = np.random.default_rng(sum(runs))
    N, G = sum(runs), len(runs)
    fb = rng.integers(0, 1 << 16, size=(N, 512)).astype(np.int32)
    vol = rng.integers(0, 12, size=N).astype(np.int32)
    ov0 = rng.integers(0, 1 << 16, size=(G, 16)).astype(np.int32)
    sid = np.repeat(np.arange(G), runs).astype(np.int32)
    pcm, last = ttf.transform94_pcm_plain(
        torch.from_numpy(fb), torch.from_numpy(vol), torch.from_numpy(sid),
        tabs, torch.from_numpy(ov0))
    pos = 0
    for g, n in enumerate(runs):
        if n == 0:
            assert np.array_equal(last[g].numpy(), ov0[g])
            continue
        re, im = jtf.transform94_planar(jnp.asarray(fb[pos:pos + n]),
                                        jnp.asarray(vol[pos:pos + n]))
        w_pcm, w_ov = jtf.overlap_resolve_planar_state(re, im,
                                                       jnp.asarray(ov0[g]))
        assert np.array_equal(np.asarray(w_pcm) & 0xFFFF,
                              pcm[pos:pos + n].numpy())
        assert np.array_equal(np.asarray(w_ov) & 0xFFFF, last[g].numpy())
        pos += n


def test_transform94_pcm_without_carry_is_unchanged(tabs):
    # overlap0 None: the flat sweep's contract, one result
    rng = np.random.default_rng(5)
    fb = torch.from_numpy(rng.integers(0, 1 << 16, size=(20, 512))
                          .astype(np.int32))
    vol = torch.zeros(20, dtype=torch.int32)
    sid = torch.tensor([0] * 7 + [1] * 13, dtype=torch.int32)
    flat = ttf.transform94_pcm(fb, vol, sid, tabs)
    assert isinstance(flat, torch.Tensor) and flat.shape == (20, 240)
    pcm, _ = ttf.transform94_pcm(fb, vol, sid, tabs,
                                 torch.zeros((2, 16), dtype=torch.int32))
    assert torch.equal(flat, pcm)


# -- the control wire --------------------------------------------------------

def _traced_controls(rs_t, bank, S, T):
    """Dense rows/mix/vol [S, T, 8] of S port-traced sessions."""
    out = []
    for b in range(S):
        tr = tpl.ControlTracer()
        tr.default_volume = 0x67
        tr.load_rom_set(rs_t)
        tr.soft_boot()
        tr.trace_frames(T, events=_callable_events(_byte_events(b)))
        out.append(tpl.assemble_controls(tr, bank))
    return [np.stack(a) for a in zip(*out)]


def test_segments_plain_inverts_compress_controls(roms, bank):
    S, T = 4, 90
    rows, mix, vol = _traced_controls(roms[1], bank, S, T)
    comp = trp.compress_controls(rows, mix)
    want = jrp.compress_controls(rows, mix)
    assert comp.keys() == want.keys()
    for k in comp:
        assert comp[k].dtype == want[k].dtype
        assert np.array_equal(comp[k], want[k]), k
    E = comp["f0"].shape[-1]
    assert 1 < E < 255
    wire = trp.pack_controls_wire(comp, vol)
    assert np.array_equal(wire, jrp.pack_controls_wire(want, vol))
    r, m, v = trp.segments94(torch.from_numpy(wire), S, T, 8, E)
    assert r.dtype == m.dtype == v.dtype == torch.int32
    assert np.array_equal(r.numpy(), rows.reshape(S * T, 8))
    assert np.array_equal(m.numpy(), mix.reshape(S * T, 8))
    assert np.array_equal(v.numpy(), vol.reshape(S * T))
    # and the JAX device-side inverse on the same wire
    parts = jrp.unpack_controls_wire(jnp.asarray(wire), S, T, 8, E)
    jr, jm = jrp.reconstruct_from_segments(*parts[:4], T)
    assert np.array_equal(np.asarray(jr).reshape(S * T, 8), r.numpy())
    assert np.array_equal(np.asarray(jm).reshape(S * T, 8), m.numpy())
    assert trp.compress_controls(rows, mix, max_segments=E - 1) is None


def test_native_segment_trace_matches_jax(roms, bank, jax_bank):
    reference_native_lib()
    rs_j, rs_t = roms
    tab_t = tnt.stream_row_table(rs_t, bank)
    tab_j = jnt.stream_row_table(rs_j, jax_bank)
    for w, g in zip(tab_j, tab_t):
        assert g.dtype == w.dtype and np.array_equal(w, g)
    S, C, E, T = 3, 8, 128, 100
    events = [_byte_events(b) for b in range(S)]
    outs = []
    for mod, rs in ((jnt, rs_j), (tnt, rs_t)):
        tr = mod.NativeControlTracer(rs)
        arrs = [np.zeros((S, C, E), np.uint16), np.zeros((S, C, E), np.uint16),
                np.zeros((S, C, E), np.uint8), np.zeros((S, C, E), np.uint16),
                np.zeros((S, T), np.uint8)]
        assert tr.trace_segs_batch(T, *tab_t, *arrs, events)
        one = [a[0].copy() for a in arrs[:4]] + [np.zeros(T, np.uint8)]
        tr.full_reset()
        assert tr.trace_segs(T, *tab_t, *one, events=events[0])
        tr.close()
        outs.append(arrs + one)
    for w, g in zip(*outs):
        assert np.array_equal(w, g)
    # the batch's segments are compress_controls of the Python trace
    rows, mix, vol = _traced_controls(rs_t, bank, S, T)
    comp = trp.compress_controls(rows, mix, max_segments=E)
    got = outs[1]
    n = comp["f0"].shape[-1]
    for k, a in zip(("f0", "base", "slope", "mixv"), got[:4]):
        assert np.array_equal(a[:, :, :n], comp[k]), k
    assert (got[0][:, :, n:] == 0xFFFF).all()
    assert np.array_equal(got[4], vol)


# -- whole paths against the scalar decoder ----------------------------------

def test_play_session_matches_scalar(roms, bank):
    rs = roms[1]

    def cmd(track):
        def ev(dec):
            dec.write_data_port((track >> 8) & 0xFF)
            dec.write_data_port(track & 0xFF)
        return ev

    events = {0: cmd(1), 30: cmd(2), 90: cmd(3), 95: cmd(4)}
    n = 160
    golden = _scalar_session(rs, events, n)
    got, tracer = trp.play_session(rs, events, n, bank=bank)
    assert got.dtype == np.int16 and np.array_equal(golden, got)
    assert np.abs(golden).max() > 0
    assert len(tracer.trace_vol_shift) == n


def test_autoplay_matches_scalar(roms):
    rs = roms[1]
    pcm, schedule = trp.autoplay(rs, tracks=[1, 2], pad_frames=3,
                                 max_frames_per_track=80, device="cpu")
    assert len(schedule) == 2
    events = {}
    for (t, frame, _) in schedule:
        def make_event(track):
            def ev(dec):
                dec.clear_tracks()
                dec.write_data_port((track >> 8) & 0xFF)
                dec.write_data_port(track & 0xFF)
            return ev
        events[frame] = make_event(t)
    golden = _scalar_session(rs, events, pcm.size // 240)
    assert np.array_equal(golden, pcm)


@pytest.mark.parametrize("name", NAMES)
def test_decode_standalone_matches_reference(name):
    s = open(os.path.join(ASSETS, name), "rb").read()
    n = 40
    got = tpl.decode_standalone([(s, 0, tfs.MIXING_LEVEL)], n_frames=n,
                                device="cpu")
    assert np.array_equal(tfs.reference_pcm(s, n), got)


def test_decode_standalone_mixes_two_voices():
    a, b = (open(os.path.join(ASSETS, n), "rb").read()
            for n in ("music_a.dcs94", "chirpy.dcs94"))
    n = 30
    got = tpl.decode_standalone([(a, 0, 0x64), (b, 3, 0x50)], n_frames=n,
                                default_volume=0x60, device="cpu")
    dec = trd.ReferenceDecoder()
    dec.default_volume = 0x60
    dec.init_standalone(trd.OS94)
    dec.soft_boot()
    dec.load_audio_stream(0, a, mixing_level=0x64)
    dec.load_audio_stream(3, b, mixing_level=0x50)
    want = np.array(dec.next_samples(n * 240), dtype=np.int16)
    assert np.array_equal(want, got)


# -- SessionServer -------------------------------------------------------------

def test_session_server_serves_every_batch_in_order(roms, bank):
    # five batches at depth 2: every batch comes back, in order, and equals
    # play_session; the server never holds more than depth batches
    rs = roms[1]
    S, T, n_batches, depth = 3, 120, 5, 2
    batches = [[_byte_events(k * S + b) for b in range(S)]
               for k in range(n_batches)]
    pulled = []

    def feed():
        for k, batch in enumerate(batches):
            pulled.append(k)
            yield batch

    outs = []
    with trp.SessionServer(rs, n_sessions=S, n_frames=T, depth=depth,
                           bank=bank, device="cpu") as srv:
        for out in srv.serve(feed()):
            outs.append(out)
            assert len(pulled) - len(outs) <= depth     # still in flight
    assert len(outs) == n_batches
    assert all(o.shape == (S, T * 240) and o.dtype == np.int16 for o in outs)
    some_signal = False
    for k, batch in enumerate(batches):
        for b, byte_ev in enumerate(batch):
            golden, _ = trp.play_session(rs, _callable_events(byte_ev), T,
                                         bank=bank)
            assert np.array_equal(outs[k][b], golden), (k, b)
            some_signal |= bool(np.abs(golden).max() > 0)
    assert some_signal


def test_session_server_yields_a_ready_batch_before_the_next_trace(roms,
                                                                  bank):
    # batch 1's trace cannot end before batch 0 has been yielded, so serve()
    # must hand batch 0 over while the trace behind it still runs
    rs = roms[1]
    S, T = 2, 40
    batches = [[_byte_events(k * S + b) for b in range(S)] for k in range(3)]
    yielded = threading.Event()
    waited = []
    outs = []
    with trp.SessionServer(rs, n_sessions=S, n_frames=T, depth=3, bank=bank,
                           device="cpu") as srv:
        prepare = srv.prepare

        def gated(events_list):
            if events_list is batches[1]:
                waited.append(yielded.wait(timeout=10))
            return prepare(events_list)

        srv.prepare = gated
        for out in srv.serve(batches):
            outs.append(out)
            yielded.set()
        srv.prepare = prepare
        want = [srv.serve_one(batch) for batch in batches]
    assert waited == [True]
    assert len(outs) == 3
    assert all(np.array_equal(w, g) for w, g in zip(want, outs))


def test_session_server_segment_overflow_retry(roms, bank):
    rs = roms[1]
    S, T = 2, 120
    # every other frame restarts a track: the lanes break into many
    # segments, past the 4-entry table
    busy = {f: [0x00, 1 + (f // 2) % 3] for f in range(0, T - 1, 2)}
    with trp.SessionServer(rs, n_sessions=S, n_frames=T, seg_e=4, bank=bank,
                           device="cpu") as srv:
        out = srv.serve_one([busy, _byte_events(0)])
        assert srv.seg_e > 4
    for b, ev in enumerate((busy, _byte_events(0))):
        golden, _ = trp.play_session(rs, _callable_events(ev), T, bank=bank)
        assert np.array_equal(out[b], golden), b


def test_session_server_reduce_fn(roms, bank):
    rs = roms[1]
    S, T = 2, 80
    batch = [_byte_events(0), _byte_events(1)]
    with trp.SessionServer(
            rs, n_sessions=S, n_frames=T, bank=bank, device="cpu",
            reduce_fn=lambda w: (w & 0xFF).sum(1, dtype=torch.int64)) as srv:
        red = srv.serve_one(batch)
    with trp.SessionServer(rs, n_sessions=S, n_frames=T, bank=bank,
                           device="cpu") as srv:
        pcm = srv.serve_one(batch)
    assert red.shape == (S,)
    assert np.array_equal(red, np.sum(pcm.astype(np.int64) & 0xFF, axis=1))


# -- devices, dispatch, kernels ------------------------------------------------

def test_session_path_runs_no_kernel_on_the_cpu(roms, bank):
    before = dict(kernels.LAUNCHES)
    with trp.SessionServer(roms[1], n_sessions=2, n_frames=16, bank=bank,
                           device="cpu") as srv:
        srv.serve_one([_byte_events(0), _byte_events(1)])
    assert kernels.LAUNCHES == before
    wire = torch.zeros(7 * 2 * 8 * 4 + 2 * 16, dtype=torch.uint8)
    rows = torch.zeros((4, 6), dtype=torch.int32)
    for call in (lambda: kernels.segments94(wire, 2, 16, 8, 4),
                 lambda: kernels.session_mix94(bank.scaled, rows, rows)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    cols = bank.columns()
    n_steps = cols.pop("n_steps")
    args = {k: torch.tensor(v) for k, v in cols.items()}
    with pytest.raises(ValueError, match="CUDA"):
        kernels.decode94_bank(**args, n_steps=n_steps, tabs=tfs.codec_tables())


def test_session_entry_points_default_to_the_card(roms):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rs = roms[1]
    for fn in (trp.build_rom_bank, trp.play_session, trp.autoplay,
               trp.SessionServer, tpl.decode_standalone):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    s = open(os.path.join(ASSETS, NAMES[0]), "rb").read()
    for call in (lambda: trp.build_rom_bank(rs),
                 lambda: trp.play_session(rs, {}, 4),
                 lambda: trp.autoplay(rs, tracks=[1]),
                 lambda: trp.SessionServer(rs, 2, 8),
                 lambda: tpl.decode_standalone([(s, 0, 0x64)], n_frames=4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
