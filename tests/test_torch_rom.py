"""The port's host copies on the ROM session path against the JAX package's:
RomSet (fields, checksums, check(), version), the track tables
(get_track_info, list_streams), the Python ControlTracer, and the ROM half
of the native tracer (trace_frames with port events, full_reset;
trace_rows, read_host_bytes and assemble_controls_native).  Two
ROMs: the synthetic one of test_romgen._make_spec, and the committed
dcsexplorer_tpu_torch/data/session6.zip, whose chip images must equal a
fresh romgen build of the same spec (and likewise data/session93a.zip, the
1993 sessions' ROM).  No jax computation runs here."""

import os

import numpy as np
import pytest

from dcsexplorer_tpu.compiler import romgen
from dcsexplorer_tpu.refdec import decoder as jrd
from dcsexplorer_tpu.rom import image as jimage
from dcsexplorer_tpu.rom import opsearch as jops
from dcsexplorer_tpu.rom import tracks as jtracks
from dcsexplorer_tpu.rom import zipload as jzip
from dcsexplorer_tpu.vm import native_tracer as jnt
from dcsexplorer_tpu.vm import tracer as jtracer
from dcsexplorer_tpu_torch.refdec import decoder as trd
from dcsexplorer_tpu_torch.rom import image as timage
from dcsexplorer_tpu_torch.rom import opsearch as tops
from dcsexplorer_tpu_torch.rom import tracks as ttracks
from dcsexplorer_tpu_torch.rom import zipload as tzip
from dcsexplorer_tpu_torch.vm import native_tracer as tnt
from dcsexplorer_tpu_torch.vm import tracer as ttracer

from .test_native_tracer import _fuzz_events
from .test_romgen import _make_spec
from .torch_native_guard import reference_native_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets", "streams")
SESSION6_ZIP = os.path.join(REPO, "dcsexplorer_tpu_torch", "data",
                            "session6.zip")
SESSION93A_ZIP = os.path.join(REPO, "dcsexplorer_tpu_torch", "data",
                              "session93a.zip")
ROM_FIELDS = ("chip_sizes", "is_dummy", "catalog_ofs", "n_tracks",
              "_track_index", "_indirect_index", "hw_version", "os_version",
              "nominal_version", "game_id")


def session6_spec(g=romgen):
    """bench.py's session6 ROM (bench_session6): music_a, music_b and the
    four legacy .dcs94 streams; track 0 ends, tracks 1-6 each set a level
    and play one stream forever on its own channel.  g: the romgen module
    that builds it (the JAX package's, or the port's)."""
    names = ["music_a", "music_b", "sine_mix_1s", "noise_sweep", "tone_low",
             "chirpy"]
    spec = g.RomSpec(os_version=jrd.OS94, num_channels=6)
    spec.streams = {f"s{i}": open(os.path.join(ASSETS, f"{n}.dcs94"),
                                  "rb").read()
                    for i, n in enumerate(names)}
    spec.tracks = [g.TrackSpec(0, steps=[g.op_end()])]
    for i in range(6):
        spec.tracks.append(g.TrackSpec(i + 1, channel=i, steps=[
            g.op_mix(0, i, 0x40 + 4 * i),
            g.op_play(i, f"s{i}", repeat=0),
            g.op_wait_forever(),
        ]))
    return spec


def session93a_spec():
    """The 1993 sessions' ROM (chip_smoke.py phase 11): an OS93a ROM of six
    channels whose streams are music_b.dcs93a (93a Type-0) and the two
    OS93a Type-1 streams dense_t1 and dense_t1b, each twice under distinct
    names; track 0 ends, tracks 1-6 each set a level and play one stream
    forever on its own channel, as session6_spec does, so both row kinds
    sound in every frame."""
    g = romgen
    names = ["music_b.dcs93a", "dense_t1.dcs93a1", "dense_t1b.dcs93a1"] * 2
    spec = g.RomSpec(os_version=jrd.OS93A, num_channels=6)
    spec.streams = {f"s{i}": open(os.path.join(ASSETS, n), "rb").read()
                    for i, n in enumerate(names)}
    spec.tracks = [g.TrackSpec(0, steps=[g.op_end()])]
    for i in range(6):
        spec.tracks.append(g.TrackSpec(i + 1, channel=i, steps=[
            g.op_mix(0, i, 0x40 + 4 * i),
            g.op_play(i, f"s{i}", repeat=0),
            g.op_wait_forever(),
        ]))
    return spec


def _zip(which):
    if which == "synth":
        return romgen.RomBuilder(_make_spec()).build_zip(), "synth.zip"
    return open(SESSION6_ZIP, "rb").read(), "session6.zip"


@pytest.fixture(scope="module", params=["synth", "session6"])
def roms(request):
    """(JAX RomSet, port RomSet) loaded from the same zip bytes."""
    data, name = _zip(request.param)
    rs_j, files_j = jzip.load_zip_data(data, zip_name=name)
    rs_t, files_t = tzip.load_zip_data(data, zip_name=name)
    assert files_t == files_j
    return rs_j, rs_t


def _chip_bytes(rs):
    return [None if c is None else bytes(c.mem if hasattr(c, "mem") else c)
            for c in rs.chips]


def test_rom_set_matches_jax(roms):
    rs_j, rs_t = roms
    assert rs_t.check() == rs_j.check() == 1
    for k in ROM_FIELDS:
        assert getattr(rs_t, k) == getattr(rs_j, k), k
    assert _chip_bytes(rs_t) == _chip_bytes(rs_j)
    assert rs_t.num_channels() == rs_j.num_channels() == 6
    assert rs_t.signature() == rs_j.signature()
    assert rs_t.version_info() == rs_j.version_info()
    assert rs_t.soft_boot_offset() == rs_j.soft_boot_offset()
    for c in _chip_bytes(rs_t):
        if c is not None:
            assert timage.checksum(c) == jimage.checksum(c)
            assert timage.find_catalog(c) == jimage.find_catalog(c)
            for pat in ("18*** 0C****", "3C**** nn****"):
                assert tops.search_opcodes(pat, c) == \
                    jops.search_opcodes(pat, c)


def test_tracks_match_jax(roms):
    rs_j, rs_t = roms
    streams = ttracks.list_streams(rs_t, rs_t.os_version)
    assert streams == jtracks.list_streams(rs_j, rs_j.os_version)
    assert len(streams) >= 2
    for t in range(rs_t.n_tracks + 2):
        got = ttracks.get_track_info(rs_t, rs_t.os_version, t)
        want = jtracks.get_track_info(rs_j, rs_j.os_version, t)
        assert (got is None) == (want is None), t
        if got is not None:
            assert vars(got) == vars(want), t


def _port_events(rs):
    """Data-port commands: track starts, a master volume, a stop."""
    n = rs.n_tracks
    return {0: [0x00, 1 % n], 3: [0x55, 0xAA, 0x58, 0x58 ^ 0xFF],
            9: [0x00, 2 % n], 20: [0x00, 4 % n], 41: [0x00, 0x00],
            50: [0x00, (n - 1)]}


def _callable_events(byte_ev):
    out = {}
    for f, bs in byte_ev.items():
        def ev(dec, bs=tuple(bs)):
            for b in bs:
                dec.write_data_port(b)
        out[f] = ev
    return out


def test_control_tracer_matches_jax(roms):
    n = 70
    traces = []
    for rs, mod in zip(roms, (jtracer, ttracer)):
        tr = mod.ControlTracer()
        tr.default_volume = 0x67
        tr.load_rom_set(rs)
        tr.soft_boot()
        tr.trace_frames(n, events=_callable_events(_port_events(rs)))
        # a stream key is (id(chip), header offset): name the chip by index
        chip = {id(c.mem if hasattr(c, "mem") else c): i
                for i, c in enumerate(rs.chips) if c is not None}
        entries = [[(c, chip[k[0]], k[1], f, m) for (c, k, f, m) in e]
                   for e in tr.trace_entries]
        traces.append((tr.trace_vol_shift, entries))
    assert traces[1] == traces[0]
    assert sum(len(e) for e in traces[1][1]) > n


def test_native_rom_trace_matches_jax(roms):
    outs = []
    for rs, mod in zip(roms, (jnt, tnt)):
        tr = mod.NativeControlTracer(rs, default_volume=0x61)
        tr.soft_boot()
        first = tr.trace_frames(60, events=_port_events(rs))
        tr.full_reset()
        tr.write_data_port(0x00)
        tr.write_data_port(0x01)
        second = tr.trace_frames(30)
        tr.close()
        outs.append(first + second)
    for w, g in zip(*outs):
        assert g.dtype == w.dtype and np.array_equal(w, g)
    assert (outs[1][0] >= 0).any()


def test_native_rom_trace_matches_python_tracer():
    # the native VM and the port's Python ControlTracer trace a session
    # alike (stream address -> header offset, frame index, mix, volume)
    data, name = _zip("synth")
    rs, _ = tzip.load_zip_data(data, zip_name=name)
    ev = _port_events(rs)
    n = 70
    tr = tnt.NativeControlTracer(rs)
    tr.soft_boot()
    addr, fidx, mix, vol = tr.trace_frames(n, events=ev)
    tr.close()
    py = ttracer.ControlTracer()
    py.default_volume = 0x67
    py.load_rom_set(rs)
    py.soft_boot()
    py.trace_frames(n, events=_callable_events(ev))
    assert list(vol) == py.trace_vol_shift
    for t, entries in enumerate(py.trace_entries):
        live = {c: (rs.make_pointer(int(addr[t, c])).pos, int(fidx[t, c]),
                    int(mix[t, c])) for c in range(8) if addr[t, c] >= 0}
        assert live == {c: (k[1], f, m) for (c, k, f, m) in entries}, t


@pytest.mark.parametrize("seed", [21, 22])
def test_native_rows_and_host_bytes(seed):
    """tests/test_native_tracer.py's parity on the port: trace_frames +
    assemble_controls_native equal the Python tracer's assemble_controls
    (over the port's bank), trace_rows (trace, row assembly and narrowing
    in one C pass) equals those two, and read_host_bytes equals the Python
    tracer's host.rx and the JAX native tracer's bytes."""
    from dcsexplorer_tpu_torch.models import pipeline as tpl
    from dcsexplorer_tpu_torch.models import romplay as trp
    data, name = _zip("synth")
    rs, _ = tzip.load_zip_data(data, zip_name=name)
    assert rs.check() == 1
    bank = trp.build_rom_bank(rs, "cpu")
    n = 400
    events = _fuzz_events(np.random.default_rng(seed), n, [1, 2, 4, 5, 7])

    py = ttracer.ControlTracer()
    py.default_volume = 0x80
    py.load_rom_set(rs)
    py.soft_boot()
    py.trace_frames(n, events=_callable_events(events))
    rows_p, mix_p, vol_p = tpl.assemble_controls(py, bank)

    t1 = tnt.NativeControlTracer(rs, default_volume=0x80)
    t1.soft_boot()
    out_s, out_f, out_m, vol = t1.trace_frames(n, events=events)
    rows, mix = tnt.assemble_controls_native(rs, bank, out_s, out_f, out_m)
    assert np.array_equal(vol, vol_p)
    assert np.array_equal(rows, rows_p) and np.array_equal(mix, mix_p)
    assert rows.dtype == mix.dtype == np.int32 and (rows > 0).any()

    addr_tab, off_tab = tnt.stream_row_table(rs, bank)
    rows_f = np.zeros((n, 8), np.uint16)
    mix_f = np.zeros((n, 8), np.uint16)
    vol_f = np.zeros(n, np.uint8)
    t2 = tnt.NativeControlTracer(rs, default_volume=0x80)
    t2.soft_boot()
    t2.trace_rows(n, addr_tab, off_tab, rows_f, mix_f, vol_f, events=events)
    assert np.array_equal(rows_f, rows.astype(np.uint16))
    assert np.array_equal(mix_f, mix.astype(np.uint16))
    assert np.array_equal(vol_f, vol.astype(np.uint8))

    host = t1.read_host_bytes()
    assert host and host == bytes(py.host.rx) == t2.read_host_bytes()
    reference_native_lib()
    jrs, _ = jzip.load_zip_data(data, zip_name=name)
    jrs.check()
    jt = jnt.NativeControlTracer(jrs, default_volume=0x80)
    jt.soft_boot()
    jt.trace_frames(n, events=events)
    assert jt.read_host_bytes() == host
    for tr in (t1, t2, jt):
        tr.close()


def test_session6_zip_is_the_romgen_build():
    # the committed ROM equals a fresh build of bench.py's spec, compared
    # as loaded chip images (the zip's bytes carry a time stamp)
    fresh, _ = jzip.load_zip_data(
        romgen.RomBuilder(session6_spec()).build_zip(), zip_name="s6.zip")
    committed, _ = tzip.load_zip_file(SESSION6_ZIP)
    assert committed.check() == fresh.check() == 1
    assert _chip_bytes(committed) == _chip_bytes(fresh)
    assert committed.n_tracks == fresh.n_tracks == 7
    assert len(ttracks.list_streams(committed, trd.OS94)) == 6


def test_session93a_zip_is_the_romgen_build():
    # the same for the 1993 sessions' ROM: an OS93a ROM of six channels
    fresh, _ = jzip.load_zip_data(
        romgen.RomBuilder(session93a_spec()).build_zip(), zip_name="s93.zip")
    committed, _ = tzip.load_zip_file(SESSION93A_ZIP)
    assert committed.check() == fresh.check() == 1
    assert committed.os_version == trd.OS93A
    assert _chip_bytes(committed) == _chip_bytes(fresh)
    assert committed.n_tracks == 7 and committed.num_channels() == 6
    assert len(ttracks.list_streams(committed, trd.OS93A)) == 6
