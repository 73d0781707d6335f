"""The port's checkpoints (dcsexplorer_tpu_torch/utils/state.py) and player
(utils/player.py) against the JAX package's, on the CPU.

tests/test_state.py's four cases on the port (a ROM session on the
synthetic RomBuilder(_make_spec()) zip, a standalone .dcs94, the emulator,
and the Python <-> native core crossing both ways); snapshots that cross
the packages both ways (a snapshot holds only plain Python values), each
continuation bit-exact with the uninterrupted JAX run; and the player's
HiResTimer, WavSink and Player."""

import glob
import math
import os
import pickle
import pickletools
import time

import numpy as np
import pytest
import torch

from dcsexplorer_tpu.compiler import romgen
from dcsexplorer_tpu.emu.board import EmulatedDecoder as JEmu
from dcsexplorer_tpu.refdec import decoder as jrd
from dcsexplorer_tpu.rom import zipload as jzipload
from dcsexplorer_tpu.rom.image import RomSet as JRomSet
from dcsexplorer_tpu.utils import player as jplayer
from dcsexplorer_tpu.utils import state as jstate
from dcsexplorer_tpu_torch.emu import board as tboard
from dcsexplorer_tpu_torch.emu.board import EmulatedDecoder as TEmu
from dcsexplorer_tpu_torch.format.tables import SAMPLE_RATE
from dcsexplorer_tpu_torch.refdec import decoder as rd
from dcsexplorer_tpu_torch.rom import zipload
from dcsexplorer_tpu_torch.rom.image import RomSet
from dcsexplorer_tpu_torch.utils import audioio
from dcsexplorer_tpu_torch.utils import player
from dcsexplorer_tpu_torch.utils import state

from .test_emu_board import build_firmware, build_u2
from .test_romgen import _make_spec

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "streams")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def zip_bytes():
    return romgen.RomBuilder(_make_spec()).build_zip()


def _rom_set(zl, data):
    rs, _ = zl.load_zip_data(data, zip_name="synth.zip")
    assert rs.check() == 1
    return rs


def _to_mid_fade(rdm, rs):
    """A scalar decoder of the module rdm on rs, driven to a mid-frame,
    mid-fade point: track 1, then track 2 (a 40-frame fade) from frame
    10, stopped 77 samples into frame 15."""
    dec = rdm.ReferenceDecoder()
    dec.default_volume = 255
    dec.load_rom_set(rs)
    dec.soft_boot()
    for b in (0x00, 0x01):
        dec.write_data_port(b)
    dec.next_samples(240 * 10)
    for b in (0x00, 0x02):
        dec.write_data_port(b)
    dec.next_samples(240 * 5 + 77)
    return dec


def _plain_values(snap):
    """True when the pickled snapshot names no class or function."""
    return not any(op.name in ("GLOBAL", "STACK_GLOBAL", "INST", "OBJ")
                   for op, _, _ in pickletools.genops(pickle.dumps(snap)))


def test_snapshot_resume_rom_session(tmp_path, zip_bytes):
    rs = _rom_set(zipload, zip_bytes)
    dec = _to_mid_fade(rd, rs)
    path = tmp_path / "ckpt.pkl"
    state.save(dec, str(path))
    expected = np.array(dec.next_samples(240 * 40), dtype=np.int16)

    dec2 = rd.ReferenceDecoder()
    dec2.load_rom_set(rs)
    state.load(dec2, str(path))
    got = np.array(dec2.next_samples(240 * 40), dtype=np.int16)
    assert np.array_equal(expected, got)
    assert np.abs(expected).max() > 0


def test_snapshot_resume_standalone():
    stream = open(sorted(glob.glob(os.path.join(ASSETS, "*.dcs94")))[0],
                  "rb").read()
    dec = rd.ReferenceDecoder()
    dec.default_volume = 255
    dec.init_standalone(rd.OS94)
    dec.soft_boot()
    dec.load_audio_stream(0, stream, mixing_level=0x64)
    dec.next_samples(240 * 7 + 13)

    snap = state.snapshot(dec)
    assert _plain_values(snap)
    expected = np.array(dec.next_samples(240 * 20), dtype=np.int16)

    dec2 = rd.ReferenceDecoder()
    dec2.init_standalone(rd.OS94)
    dec2.soft_boot()
    state.restore(dec2, snap, stream_mems={0: stream})
    got = np.array(dec2.next_samples(240 * 20), dtype=np.int16)
    assert np.array_equal(expected, got)
    assert np.abs(expected).max() > 0


def _emu_rom_set(cls=RomSet):
    """tests/test_emu_board.make_decoder's synthetic firmware as a RomSet
    of cls (the port's, or the JAX package's)."""
    rs = cls()
    rs.add_rom(2, build_u2(build_firmware()))
    rs.hw_version = tboard.HW_DCS95
    rs.os_version = rd.OS95
    rs.nominal_version = 0x0105
    return rs


def _emulator(rs, use_native):
    dec = TEmu(use_native=use_native)
    dec.default_volume = 200
    dec.load_rom_set(rs)
    return dec


def test_emulated_snapshot_resume():
    rs = _emu_rom_set()
    dec = _emulator(rs, True)
    dec.soft_boot()
    dec.next_samples(300)            # mid-frame suspension point
    dec.write_data_port(0x21)        # pending queue content survives too
    snap = state.snapshot_emulated(dec)
    assert _plain_values(snap)
    cont = dec.next_samples(480)

    dec2 = _emulator(rs, True)
    state.restore_emulated(dec2, snap)
    cont2 = dec2.next_samples(480)
    assert cont == cont2 and any(cont)
    assert dec2.cpu.dm[0x0810] == dec.cpu.dm[0x0810]


@pytest.mark.parametrize("src_native,dst_native", [(True, False),
                                                   (False, True)])
def test_emulated_snapshot_cross_core(src_native, dst_native):
    rs = _emu_rom_set()
    dec = _emulator(rs, src_native)
    assert dec.native_cpu == src_native
    dec.soft_boot()
    dec.next_samples(300)
    snap = state.snapshot_emulated(dec)
    cont = dec.next_samples(480)

    dec2 = _emulator(rs, dst_native)
    state.restore_emulated(dec2, snap)
    cont2 = dec2.next_samples(480)
    assert cont == cont2 and any(cont)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_crosses_the_packages(tmp_path, zip_bytes, direction):
    """A checkpoint saved by one package's save loads into the other's
    decoder, which goes on to play the uninterrupted JAX run's next 40
    frames bit for bit."""
    jrs = _rom_set(jzipload, zip_bytes)
    trs = _rom_set(zipload, zip_bytes)
    jdec = _to_mid_fade(jrd, jrs)
    path = str(tmp_path / "ckpt.pkl")
    if direction == "jax_to_port":
        jstate.save(jdec, path)
        dst = rd.ReferenceDecoder()
        dst.load_rom_set(trs)
        state.load(dst, path)
    else:
        tdec = _to_mid_fade(rd, trs)
        assert state.snapshot(tdec) == jstate.snapshot(jdec)
        state.save(tdec, path)
        dst = jrd.ReferenceDecoder()
        dst.load_rom_set(jrs)
        jstate.load(dst, path)
    expected = np.array(jdec.next_samples(240 * 40), dtype=np.int16)
    got = np.array(dst.next_samples(240 * 40), dtype=np.int16)
    assert np.array_equal(expected, got)
    assert np.abs(expected).max() > 0


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_emulated_snapshot_crosses_the_packages(direction):
    """The emulator's snapshot (CPU state, memories, board) crosses too:
    each package's Python core resumes the other's suspended session."""
    trs, jrs = _emu_rom_set(), _emu_rom_set(JRomSet)

    def boot(cls, rs):
        dec = cls(use_native=False)
        dec.default_volume = 200
        dec.load_rom_set(rs)
        return dec

    src_cls, src_rs, src_state, dst_cls, dst_rs, dst_state = (
        (JEmu, jrs, jstate, TEmu, trs, state) if direction == "jax_to_port"
        else (TEmu, trs, state, JEmu, jrs, jstate))
    src = boot(src_cls, src_rs)
    src.soft_boot()
    src.next_samples(300)
    src.write_data_port(0x21)
    snap = src_state.snapshot_emulated(src)
    cont = src.next_samples(480)
    dst = boot(dst_cls, dst_rs)
    dst_state.restore_emulated(dst, snap)
    assert dst.next_samples(480) == cont and any(cont)


def test_player_unpaced_equals_the_source():
    stream = open(os.path.join(ASSETS, "music_b.dcs94"), "rb").read()

    def decoder():
        dec = rd.ReferenceDecoder()
        dec.default_volume = 255
        dec.init_standalone(rd.OS94)
        dec.soft_boot()
        dec.load_audio_stream(0, stream, mixing_level=0x64)
        return dec

    n = 240 * 6 + 100
    want = np.array(decoder().next_samples(n), dtype=np.int16)
    sink = player.MemorySink()
    p = player.Player(decoder().next_samples, sink, pace=None)
    assert p.run(n) == n and p.slept == 0.0
    assert np.array_equal(sink.data(), want) and np.abs(want).max() > 0
    jsink = jplayer.MemorySink()
    jplayer.Player(decoder().next_samples, jsink, pace=None).run(n)
    assert np.array_equal(jsink.data(), sink.data())
    assert player.MemorySink().data().dtype == np.int16


def test_wav_sink_round_trips(tmp_path):
    rng = np.random.default_rng(3)
    pcm = rng.integers(-32768, 32768, 1000).astype(np.int16)
    path = str(tmp_path / "out.wav")
    sink = player.WavSink(path)
    for k in range(0, pcm.size, 240):
        sink.write(pcm[k:k + 240])
    sink.close()
    audio, rate = audioio.read_audio(path)
    assert rate == SAMPLE_RATE
    assert np.array_equal(np.round(audio * 32768.0).astype(np.int16), pcm)
    jpath = str(tmp_path / "jax.wav")
    jsink = jplayer.WavSink(jpath)
    jsink.write(pcm)
    jsink.close()
    assert open(path, "rb").read() == open(jpath, "rb").read()


def test_paced_player_keeps_real_time_and_runs_the_idle_task():
    n = math.ceil(0.05 * SAMPLE_RATE)
    calls = []
    sink = player.MemorySink()
    p = player.Player(lambda k: np.zeros(k, np.int16), sink, chunk=240,
                      idle_task=lambda: calls.append(1))
    t0 = player.HiResTimer.now()
    assert p.run(n) == n
    elapsed = player.HiResTimer.now() - t0
    assert elapsed >= 0.05
    assert calls and p.slept > 0
    assert sink.data().size == n
    t1 = time.perf_counter()
    player.HiResTimer.sleep_until(t1 + 0.01)
    assert time.perf_counter() - t1 >= 0.01
    player.HiResTimer.sleep_for(-1.0)      # a deadline passed: no sleep
