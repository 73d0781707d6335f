"""The wide session wire (a bank of 64Ki rows or more), on the CPU.

A bank under 64Ki rows travels on the u16 wire, byte for byte the wire it
always had; from 64Ki rows to 2^24 - 1 a segment's first row travels as a
u32 (``romplay.wide_wire``).  Held here: dense rows round-trip through the
wide wire's packing and its plain expansion, as the benchmark's frozen
reader (``dcsbench/reference/wire_rows32.py``) reads them; the native trace
writes the wide segments ``compress_controls`` makes; a small batch on the
u16 wire is the JAX package's trace and packing, byte for byte, and keeps
the bytes it had before the wide wire; the packing and the readers take
the layout from the data; the session decoder mixes rows past 64Ki as the
benchmark's reference does; and a session of the full eight-chip title
(``dcsbench/data/os94full/rom94full.zip``) that plays each voice's last
track matches the reference.
"""

import hashlib
import os
import types

import numpy as np
import pytest
import torch

from dcsbench.reference import codec, wire_rows32
from dcsbench.reference import zipload as ref_zipload
from dcsexplorer_tpu.models import romplay as jrp
from dcsexplorer_tpu.rom import zipload as jzip
from dcsexplorer_tpu.vm import native_tracer as jnt
from dcsexplorer_tpu_torch.models import pipeline as pl
from dcsexplorer_tpu_torch.models import romplay
from dcsexplorer_tpu_torch.ops import kernels
from dcsexplorer_tpu_torch.rom import zipload
from dcsexplorer_tpu_torch.vm import native_tracer as nt

from .torch_native_guard import reference_native_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "dcsbench", "data")
ROM94_ZIP = os.path.join(DATA, "rom94.zip")
ROM94FULL_ZIP = os.path.join(DATA, "os94full", "rom94full.zip")
SESSION6_ZIP = os.path.join(REPO, "dcsexplorer_tpu_torch", "data",
                            "session6.zip")
# the u16 wire of rom94_batch() on rom94.zip, taken on the code before the
# wide wire existed
ROM94_WIRE_SHA256 = ("4b7af0e4a13234af2080c0f1f5236008"
                     "080351c7d6c33c24c8071d0992e477f3")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # the plain versions run many small ops; beside other test workers, a
    # thread pool per op costs more than it gives
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dense(S, T, C, limit, seed):
    """Dense controls of S sessions x T frames x C channels: each lane a
    run of idle stretches (row 0), held rows and rows that advance by one a
    frame, the largest row limit - 1; mixes over the u16 range."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((S, T, C), np.int64)
    mix = np.zeros((S, T, C), np.int64)
    for s in range(S):
        for c in range(C):
            t = 0
            while t < T:
                n = int(rng.integers(1, 90))
                kind = int(rng.integers(3))
                m = int(rng.integers(1 << 16))
                if kind == 0:
                    m = 0
                elif kind == 1:
                    rows[s, t:t + n, c] = int(rng.integers(1, limit))
                else:
                    b = int(rng.integers(1, limit - n))
                    rows[s, t:t + n, c] = b + np.arange(min(n, T - t))
                mix[s, t:t + n, c] = m
                t += n
    rows[0, T // 2, 0] = limit - 1          # the largest row, held a frame
    mix[0, T // 2, 0] = 7
    return rows, mix


@pytest.mark.parametrize("limit", [1 << 17, (1 << 24)])
def test_dense_rows_round_trip_through_the_wide_wire(limit):
    S, T, C = 3, 400, 6
    rows, mix = _dense(S, T, C, limit, limit % 97)
    vol = np.random.default_rng(1).integers(0, 256, (S, T))
    comp = romplay.compress_controls(rows, mix, wide=True)
    E = comp["f0"].shape[-1]
    assert comp["base"].dtype == np.uint32 and rows.max() == limit - 1
    wire = romplay.pack_controls_wire(comp, vol)
    assert wire.size == 9 * S * C * E + S * T
    got = romplay.segments94_plain(torch.tensor(wire), S, T, C, E)
    assert torch.equal(got[0], torch.tensor(rows.reshape(S * T, C),
                                            dtype=torch.int32))
    assert torch.equal(got[1], torch.tensor(mix.reshape(S * T, C),
                                            dtype=torch.int32))
    assert torch.equal(got[2], torch.tensor(vol.reshape(-1),
                                            dtype=torch.int32))
    ref = wire_rows32.expand(torch.tensor(wire), S, T, C, E)
    assert all(torch.equal(g.long(), r.reshape(g.shape))
               for g, r in zip(got, ref))
    # the u16 wire cannot name these rows
    with pytest.raises(AssertionError):
        romplay.compress_controls(rows, mix)


def test_the_wire_is_chosen_by_the_bank_rows():
    assert [romplay.wide_wire(n) for n in (1, 65535, 65536, (1 << 24) - 1)] \
        == [False, False, True, True]
    with pytest.raises(ValueError, match="2\\^24"):
        romplay.wide_wire(1 << 24)
    rs, _ = zipload.load_zip_file(SESSION6_ZIP)
    rs.check()
    huge = types.SimpleNamespace(total_rows=lambda: 1 << 24)
    with pytest.raises(ValueError, match="2\\^24"):
        romplay.SessionServer(rs, 2, 8, n_ch=6, bank=huge, device="cpu")


def _session6_events(S):
    events = []
    for b in range(S):
        ev = {}
        for t in range(1, 7):
            ev.setdefault((b * 7 + t * 3) % 40, []).extend([0x00, t])
            ev.setdefault(150 + b, []).extend([0x00, 7 - t])
        ev.setdefault(0, []).extend([0x55, 0xAA, 0x40 + b, (0x40 + b) ^ 0xFF])
        events.append(ev)
    return events


@pytest.mark.parametrize("shift", [70_000, "top"])
def test_native_wide_trace_equals_compress_controls(shift):
    # session6's streams placed at bank rows past 64Ki, or at the top of
    # the wide wire's range: the trace adds a stream's first row to its
    # frame index, as it does in a larger bank
    rs, _ = zipload.load_zip_file(SESSION6_ZIP)
    rs.check()
    bank = romplay.build_rom_bank(rs, "cpu")
    if shift == "top":
        shift = (1 << 24) - bank.total_rows()
    addr, off = nt.stream_row_table(rs, bank)
    off = off + np.int32(shift)
    S, T, C, E = 4, 300, 6, 32
    events = _session6_events(S)
    tr = nt.NativeControlTracer(rs)
    try:
        f0 = np.full((S, C, E), 0xFFFF, np.uint16)
        base = np.zeros((S, C, E), np.uint32)
        slope = np.zeros((S, C, E), np.uint8)
        mixv = np.zeros((S, C, E), np.uint16)
        vol = np.zeros((S, T), np.uint8)
        assert tr.trace_segs_batch(T, addr, off, f0, base, slope, mixv, vol,
                                   events)
        rows = np.zeros((S, T, C), np.int64)
        mix = np.zeros((S, T, C), np.int64)
        vol_d = np.zeros((S, T), np.int64)
        for s in range(S):
            tr.full_reset()
            out_s, out_f, out_m, out_v = tr.trace_frames(T, events[s])
            live = out_s[:, :C] >= 0
            at = np.searchsorted(addr, np.where(live, out_s[:, :C], addr[0]))
            rows[s] = np.where(live, off[at] + out_f[:, :C], 0)
            mix[s] = np.where(live, out_m[:, :C], 0)
            vol_d[s] = out_v
    finally:
        tr.close()
    assert rows.max() >= shift
    comp = romplay.compress_controls(rows, mix, wide=True)
    k = comp["f0"].shape[-1]
    assert 1 < k <= E
    got = dict(f0=f0, base=base, slope=slope, mixv=mixv)
    for name, a in comp.items():
        assert got[name].dtype == a.dtype
        assert np.array_equal(got[name][..., :k], a), name
    assert (f0[..., k:] == 0xFFFF).all() and not base[..., k:].any()
    assert np.array_equal(vol, vol_d)
    # the traced wire expands to the dense rows
    wire = romplay.pack_controls_wire(got, vol)
    r, m, v = romplay.segments94_plain(torch.tensor(wire), S, T, C, E)
    assert np.array_equal(r.numpy().reshape(S, T, C), rows)
    assert np.array_equal(m.numpy().reshape(S, T, C), mix)


def test_trace_rows_refuses_row_ids_past_u16():
    # the dense trace narrows rows to u16: past 64Ki it raises, it does not
    # wrap
    rs, _ = zipload.load_zip_file(SESSION6_ZIP)
    rs.check()
    bank = romplay.build_rom_bank(rs, "cpu")
    addr, off = nt.stream_row_table(rs, bank)
    T = 60
    events = _session6_events(1)[0]
    tr = nt.NativeControlTracer(rs)
    try:
        rows = np.zeros((T, 8), np.uint16)
        mix = np.zeros((T, 8), np.uint16)
        vol = np.zeros(T, np.uint8)
        tr.full_reset()
        tr.trace_rows(T, addr, off, rows, mix, vol, events=events)
        assert rows.max() > 0
        tr.full_reset()
        with pytest.raises(ValueError, match="u16"):
            tr.trace_rows(T, addr, off + np.int32(70_000), rows, mix, vol,
                          events=events)
    finally:
        tr.close()


def rom94_batch(S=4, T=300, C=6):
    """Four sessions on rom94.zip: each voice starts a track of its channel
    every 131 frames, the session's master volume at frame 0."""
    events = []
    for s in range(S):
        vol = 0x50 + 9 * s
        ev = {0: [0x55, 0xAA, vol, vol ^ 0xFF]}
        for v in range(C):
            for k, f in enumerate(range((s * 7 + v * 3) % 40, T, 131)):
                track = 1 + v + 6 * ((11 * s + 7 * k + v) % 40)
                ev.setdefault(f, []).extend([track >> 8, track & 0xFF])
        events.append(ev)
    return events


def test_a_bank_under_64ki_rows_keeps_the_u16_wire_bytes():
    # the server's wire of a bank under 64Ki rows is the JAX package's: its
    # native segment trace and its packing on the same events and table
    reference_native_lib()
    rs, _ = zipload.load_zip_file(ROM94_ZIP)
    rs.check()
    S, T, C = 4, 300, 6
    events = rom94_batch(S, T, C)
    with romplay.SessionServer(rs, S, T, n_ch=C, device="cpu") as srv:
        assert srv.bank.total_rows() == 62641 and not srv.wide
        wire, E = srv.prepare(events)
        table = (srv._addr_tab, srv._off_tab)
    assert (wire.size, E) == (7 * S * C * E + S * T, 32)
    rs_j, _ = jzip.load_zip_file(ROM94_ZIP)
    rs_j.check()
    tr = jnt.NativeControlTracer(rs_j)
    try:
        f0 = np.zeros((S, C, E), np.uint16)
        base = np.zeros((S, C, E), np.uint16)
        slope = np.zeros((S, C, E), np.uint8)
        mixv = np.zeros((S, C, E), np.uint16)
        vol = np.zeros((S, T), np.uint8)
        assert tr.trace_segs_batch(T, *table, f0, base, slope, mixv, vol,
                                   events)
    finally:
        tr.close()
    want = jrp.pack_controls_wire(
        dict(f0=f0, base=base, slope=slope, mixv=mixv), vol)
    assert want.dtype == wire.dtype and np.array_equal(want, wire)
    # and the bytes taken on the code before the wide wire existed
    assert hashlib.sha256(wire.tobytes()).hexdigest() == ROM94_WIRE_SHA256


def test_the_wire_layout_is_read_from_the_data():
    # the base column's dtype picks the packing, the wire's length the
    # reading; the same segments expand alike on either wire
    S, T, C, E = 2, 9, 3, 4
    rng = np.random.default_rng(5)
    comp = dict(f0=np.sort(rng.integers(0, T, (S, C, E)), -1)
                .astype(np.uint16),
                base=rng.integers(0, 1 << 16, (S, C, E)).astype(np.uint16),
                slope=rng.integers(0, 2, (S, C, E)).astype(np.uint8),
                mixv=rng.integers(0, 1 << 16, (S, C, E)).astype(np.uint16))
    comp["f0"][:, :, 0] = 0
    vol = rng.integers(0, 256, (S, T))
    narrow = romplay.pack_controls_wire(comp, vol)
    wide = romplay.pack_controls_wire(
        dict(comp, base=comp["base"].astype(np.uint32)), vol)
    assert (narrow.size, wide.size) == (7 * S * C * E + S * T,
                                        9 * S * C * E + S * T)
    assert [kernels.wire_base_bytes(w.size, S, T, C, E)
            for w in (narrow, wide, narrow[:-1])] == [2, 4, None]
    a = romplay.segments94(torch.tensor(narrow), S, T, C, E)
    b = romplay.segments94(torch.tensor(wide), S, T, C, E)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="uint16 or uint32"):
        romplay.pack_controls_wire(
            dict(comp, base=comp["base"].astype(np.int64)), vol)
    for bad in (narrow[:-1], np.concatenate([wide, wide[:1]])):
        with pytest.raises(ValueError, match="shape"):
            romplay.segments94_plain(torch.tensor(bad), S, T, C, E)
        with pytest.raises(ValueError, match="shape"):
            romplay.segments94(torch.tensor(bad), S, T, C, E)


def test_session_decoder_over_70000_rows_equals_the_reference():
    g = torch.Generator().manual_seed(70000)
    R, F, C = 70_000, 2 * 300, 6
    scaled = torch.randint(-(1 << 15), 1 << 15, (R, 256), generator=g,
                           dtype=torch.int32).to(torch.int16)
    scaled[0] = 0
    rows = torch.randint(0, R, (F, C), generator=g, dtype=torch.int32)
    rows[F // 2:] = torch.randint(1 << 16, R, (F - F // 2, C), generator=g,
                                  dtype=torch.int32)
    rows[torch.rand((F, C), generator=g) < 0.2] = 0
    rows[:C, :] = torch.arange(R - C, R, dtype=torch.int32)[:, None]
    mix = torch.randint(0, 1 << 16, (F, C), generator=g, dtype=torch.int32)
    vol = torch.randint(0, 40, (F,), generator=g, dtype=torch.int32)
    sid = torch.arange(2, dtype=torch.int32).repeat_interleave(F // 2)
    bank = types.SimpleNamespace(scaled=scaled, device=torch.device("cpu"),
                                 family93=False)
    dec = pl.session_decoder(bank, "cpu")
    got = dec(rows, mix, vol, sid)
    want = codec.pcm94(scaled, rows, mix, vol, sid, "cpu")
    assert (rows >= 1 << 16).sum() > F * C // 3
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def full_title():
    rs, _ = zipload.load_zip_file(ROM94FULL_ZIP)
    assert rs.check() == 1
    return rs, romplay.build_rom_bank(rs, "cpu")


def test_a_full_title_session_of_last_tracks_equals_the_reference(
        full_title):
    rs, bank = full_title
    n = rs.n_tracks - 1                 # tracks 1..n; track 0 is silence
    T, C = 300, 6
    # track k + 1 plays on channel k mod 6: the last six are one a voice
    last = [n - 5 + v for v in range(C)]
    events = {0: [0x55, 0xAA, 0x70, 0x70 ^ 0xFF]}
    for v, track in enumerate(last):
        events.setdefault(3 * v, []).extend([track >> 8, track & 0xFF])
    with romplay.SessionServer(rs, 1, T, n_ch=C, bank=bank, device="cpu") as srv:
        assert bank.total_rows() >= 1 << 16 and srv.wide
        wire, E = srv.prepare([events])
        rows, mix, vol = romplay.segments94_plain(
            torch.tensor(wire), 1, T, C, E)
        pcm = srv.serve_one([events])
    # frames 15..260: every voice plays its last track, at rows past 64Ki
    assert (rows[15:261] >= 1 << 16).all()

    ref_rs, _ = ref_zipload.load_zip_file(ROM94FULL_ZIP)
    ref_rs.check()
    plays, ref_mix, ref_vol = codec.session_controls(ref_rs, events, T, C,
                                                     0x67)
    images = codec.chip_images(ref_rs)
    ref_bank = codec.Bank94()
    for row in plays:
        for p in row:
            if p is not None:
                ref_bank.add(p[0], images[p[0][0]], p[0][1])
    ref_rows = ref_bank.rows(plays, C)
    want = codec.pcm94(ref_bank.decode("cpu"), ref_rows, ref_mix, ref_vol,
                       np.zeros(T), "cpu")
    assert np.array_equal((rows.numpy() != 0), ref_rows != 0)
    assert np.array_equal(mix.numpy(), ref_mix)
    assert np.array_equal(vol.numpy(), ref_vol)
    assert np.array_equal(pcm.reshape(-1).view(np.uint16),
                          want.numpy().reshape(-1).astype(np.uint16))
