"""The port's explorer CLI (dcsexplorer_tpu_torch/tools/explorer.py) against
the JAX CLI, on the CPU (--platform cpu: the device pipeline's plain PyTorch
versions), in process through each CLI's main(argv):

- listings (--info, --tracks, --programs, --streams, --ditables, --dasm)
  identical line for line;
- the host copies it stands on (rom/tracks, rom/disasm, rom/dasmtrace,
  utils/audioio) against the JAX originals;
- the files of --extract-tracks, --autoplay and --extract-streams byte for
  byte: against the JAX CLI's on the synthetic ROM and session6.zip; on
  session93a.zip (OS93a, where the JAX autoplay is known wrong for Type-1
  band widths 7..9) the decodes against the port's scalar decoder;
- --validate, its diagnostics (test_cli.py's, with the device side labelled
  "cuda  "), exit codes, backend selection (the emulator backends'
  extraction: tests/test_torch_emu.py), and the card requirement.

ROMs: the synthetic RomBuilder(_make_spec()) zip of test_cli.py, and the
committed data/session6.zip and data/session93a.zip."""

import dataclasses
import io
import os
import zipfile

import numpy as np
import pytest
import torch

from dcsexplorer_tpu.compiler import romgen
from dcsexplorer_tpu.rom import dasmtrace as jdasmtrace
from dcsexplorer_tpu.rom import disasm as jdisasm
from dcsexplorer_tpu.rom import tracks as jtracks
from dcsexplorer_tpu.tools import explorer as jx
from dcsexplorer_tpu.utils import audioio as jaudioio
from dcsexplorer_tpu_torch.models import romplay as trp
from dcsexplorer_tpu_torch.refdec import decoder as trd
from dcsexplorer_tpu_torch.refdec import registry as treg
from dcsexplorer_tpu_torch.rom import dasmtrace as tdasmtrace
from dcsexplorer_tpu_torch.rom import disasm as tdisasm
from dcsexplorer_tpu_torch.rom import tracks as ttracks
from dcsexplorer_tpu_torch.tools import explorer as tx
from dcsexplorer_tpu_torch.utils import audioio as taudioio

from .test_romgen import _make_spec

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "dcsexplorer_tpu_torch", "data")
ROMS = ("synth", "session6", "session93a")
CAP = ["--max-track-frames", "60"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # the plain versions run many small ops; beside other test workers, a
    # thread pool per op costs more than it gives
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def roms(tmp_path_factory):
    path = tmp_path_factory.mktemp("rom") / "synth.zip"
    path.write_bytes(romgen.RomBuilder(_make_spec()).build_zip())
    return {"synth": str(path),
            "session6": os.path.join(DATA, "session6.zip"),
            "session93a": os.path.join(DATA, "session93a.zip")}


def _main(cli, argv, capsys):
    rc = cli.main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


def _files(d):
    return {n: (d / n).read_bytes() for n in sorted(os.listdir(d))}


@pytest.mark.parametrize("rom", ROMS)
@pytest.mark.parametrize("opts", [
    ["--info"], ["--tracks"], ["--programs"], ["--streams"], ["--ditables"],
    ["--dasm", "0:0x200"], ["--dasm", "boot"], ["--dasm", "main"],
    ["--tracks", "--streams", "--ditables", "--info"]],
    ids=lambda o: " ".join(o))
def test_listings_equal_the_jax_cli(roms, rom, opts, capsys):
    argv = [roms[rom], *opts, "--platform", "cpu"]
    want = _main(jx, argv, capsys)
    got = _main(tx, argv, capsys)
    assert got[0] == want[0] == 0
    assert got[1].splitlines() == want[1].splitlines()
    assert got[1] or (opts == ["--ditables"] and rom != "synth")  # no tables


@pytest.mark.parametrize("rom", ROMS)
def test_track_tools_equal_the_jax_copies(roms, rom):
    rs, _, _ = tx.load_rom(roms[rom])
    jrs, _, _ = jx.load_rom(roms[rom])
    osv = rs.os_version
    assert osv == jrs.os_version and rs.n_tracks == jrs.n_tracks
    n_ops = 0
    for t in range(rs.n_tracks + 1):          # one past the end: None / []
        got = [dataclasses.asdict(o)
               for o in ttracks.decompile_track(rs, osv, t)]
        want = [dataclasses.asdict(o)
                for o in jtracks.decompile_track(jrs, osv, t)]
        assert got == want, t
        n_ops += len(got)
        for prefix in ("", "    "):
            assert (ttracks.explain_track(rs, osv, t, prefix)
                    == jtracks.explain_track(jrs, osv, t, prefix))
    assert n_ops > rs.n_tracks
    assert (dataclasses.asdict(ttracks.get_deferred_indirect_tables(rs, osv))
            == dataclasses.asdict(jtracks.get_deferred_indirect_tables(
                jrs, osv)))
    streams = ttracks.list_streams(rs, osv)
    assert streams and streams == jtracks.list_streams(jrs, osv)


@pytest.mark.parametrize("rom", ROMS)
def test_disassemblers_equal_the_jax_copies(roms, rom):
    rs, _, _ = tx.load_rom(roms[rom])
    u2 = rs.chips[0]
    data = bytes(u2[:0x800 * 4])
    got = tdisasm.disassemble_rom(data, start_addr=0)
    assert got == jdisasm.disassemble_rom(data, start_addr=0)
    assert len(got) > 10
    for ofs in (0, rs.soft_boot_offset()):
        got = list(tdasmtrace.disassemble_program(u2, ofs))
        assert got == list(jdasmtrace.disassemble_program(u2, ofs))
        assert len(got) > 10


def test_audioio_equals_the_jax_copy(tmp_path):
    rng = np.random.default_rng(14)
    pcm = rng.integers(-32768, 32768, 4801).astype(np.int16)
    raw = rng.integers(0, 256, 777).astype(np.uint8).tobytes()
    for os_v in (trd.OS93A, trd.OS93B, trd.OS94, trd.OS95):
        taudioio.write_wav(tmp_path / "t.wav", pcm)
        jaudioio.write_wav(tmp_path / "j.wav", pcm)
        taudioio.write_dcs_raw(tmp_path / "t.dcs", raw, os_v)
        jaudioio.write_dcs_raw(tmp_path / "j.dcs", raw, os_v)
        for a, b in (("t.wav", "j.wav"), ("t.dcs", "j.dcs")):
            assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes()
        a, rate = taudioio.read_wav(tmp_path / "t.wav")
        assert rate == 31250 and np.array_equal(
            a, jaudioio.read_wav(tmp_path / "t.wav")[0])
        assert np.array_equal(np.round(a * 32768).astype(np.int16), pcm)
        assert (taudioio.read_dcs_raw(tmp_path / "t.dcs")
                == jaudioio.read_dcs_raw(tmp_path / "t.dcs")
                == (raw, trd.OS94 if os_v == trd.OS95 else os_v))
        assert taudioio.is_dcs_raw(tmp_path / "t.dcs")
        assert not taudioio.is_dcs_raw(tmp_path / "t.wav")
        assert not taudioio.is_dcs_raw(tmp_path / "missing")


def _decodes(cli, rom, d, capsys, fmt, *extra):
    d.mkdir()
    rc, out, err = _main(cli, [rom, "--platform", "cpu", *CAP,
                               "--extract-tracks", str(d / "t"),
                               "--autoplay", str(d / "auto.wav"),
                               "--extract-streams", str(d / "s"),
                               "--extract-format", fmt, *extra], capsys)
    assert rc == 0, err
    return _files(d), out.replace(str(d), "D")


@pytest.mark.parametrize("rom", ("synth", "session6"))
def test_decoded_files_equal_the_jax_cli(roms, rom, tmp_path, capsys):
    # the streams' WAVs (the scalar decoder over whole streams, ~5 ms a
    # frame in both CLIs) only from the synthetic ROM's two streams
    fmt = "both" if rom == "synth" else "raw"
    want, want_out = _decodes(jx, roms[rom], tmp_path / "jax", capsys, fmt)
    got, got_out = _decodes(tx, roms[rom], tmp_path / "port", capsys, fmt)
    assert got_out.splitlines() == want_out.splitlines()
    assert sorted(got) == sorted(want)
    assert sum(n.endswith(".wav") for n in got) >= 4
    for name in want:
        assert got[name] == want[name], name


def _scalar_autoplay(rs, cap, vol=0x67):
    """romplay.autoplay's schedule rendered by the port's scalar decoder."""
    dec = trd.ReferenceDecoder()
    dec.default_volume = vol
    dec.load_rom_set(rs)
    dec.soft_boot()
    starts, frame = {}, 0
    for t in range(rs.n_tracks):
        ti = ttracks.get_track_info(rs, rs.os_version, t)
        if ti is not None and ti.type == 1 and ti.time > 0:
            starts[frame] = t
            frame += min(ti.time + 4, cap)
    out = []
    for f in range(frame + 4):
        if f in starts:
            dec.clear_tracks()
            dec.write_data_port((starts[f] >> 8) & 0xFF)
            dec.write_data_port(starts[f] & 0xFF)
        out.extend(dec.next_samples(240))
    return np.array(out, dtype=np.int16)


def test_decoded_files_of_session93a_equal_the_scalar_decoder(roms, tmp_path,
                                                              capsys):
    # OS93a: the tracks against the port's --backend native, the autoplay
    # against the scalar decoder on its schedule, the raw streams against
    # the JAX CLI's
    rom = roms["session93a"]
    got, _ = _decodes(tx, rom, tmp_path / "port", capsys, "raw")
    native, _ = _decodes(tx, rom, tmp_path / "native", capsys, "raw",
                         "--backend", "native")
    d = tmp_path / "jax"
    d.mkdir()
    assert _main(jx, [rom, "--extract-streams", str(d / "s"),
                      "--extract-format", "raw"], capsys)[0] == 0
    tracks = [n for n in got if n.startswith("t")]
    assert len(tracks) == 6
    for name in tracks:
        assert got[name] == native[name], name
    rs, _, _ = tx.load_rom(rom)
    taudioio.write_wav(tmp_path / "golden.wav", _scalar_autoplay(rs, 60))
    assert got["auto.wav"] == (tmp_path / "golden.wav").read_bytes()
    streams = _files(d)
    assert len(streams) == 6
    for name in streams:
        assert got[name] == streams[name], name


@pytest.mark.parametrize("rom", ROMS)
def test_validate_passes(roms, rom, tmp_path, capsys):
    log = tmp_path / "v.log"
    rc, out, _ = _main(tx, [roms[rom], "--validate", str(log),
                            "--platform", "cpu", *CAP], capsys)
    assert rc == 0
    assert "Sample mismatches: 0 in 0 frames (0 diff runs)" in out
    assert "Validation Succeeded" in out
    assert log.read_text().splitlines()[-1] == "Validation Succeeded"


def test_bad_rom_and_missing_file_exit_2(tmp_path, capsys):
    bad = tmp_path / "bad.zip"
    bad.write_bytes(b"PK\x05\x06" + b"\x00" * 18)   # empty zip
    rc, _, err = _main(tx, [str(bad)], capsys)
    assert rc == 2 and "error" in err
    rc, _, err = _main(tx, [str(tmp_path / "missing.zip")], capsys)
    assert rc == 2 and "not found" in err


def test_failed_post_check_exits_1(roms, tmp_path, capsys):
    # one flipped byte in U2 fails its checksum: decoding exits 1 unless
    # --ignore-checksum-errors, listings still run
    with zipfile.ZipFile(roms["synth"]) as z:
        (name,) = z.namelist()
        u2 = bytearray(z.read(name))
    u2[-5] ^= 0x5A
    bad = tmp_path / "bad.zip"
    with zipfile.ZipFile(bad, "w") as z:
        z.writestr(name, bytes(u2))
    argv = [str(bad), "--platform", "cpu", "--max-track-frames", "10"]
    for cli in (jx, tx):
        rc, out, _ = _main(cli, argv + ["--info"], capsys)
        assert rc == 0 and "ROM check:   FAILED" in out
        rc, _, err = _main(cli, argv + ["--validate"], capsys)
        assert rc == 1 and "POST checks" in err
    rc, _, _ = _main(tx, argv + ["--autoplay", str(tmp_path / "a.wav"),
                                 "--ignore-checksum-errors"], capsys)
    assert rc == 0 and (tmp_path / "a.wav").exists()


def _force(monkeypatch, corrupt):
    real = trp.autoplay

    def corrupted(*a, **kw):
        pcm, schedule, tracer = real(*a, **kw)
        return corrupt(pcm.copy(), tracer), schedule, tracer

    monkeypatch.setattr(trp, "autoplay", corrupted)


def test_validate_diagnostics_on_forced_mismatch(roms, tmp_path, monkeypatch,
                                                 capsys):
    def corrupt(pcm, tracer):
        pcm[240 * 3 + 17] ^= 0x55       # frame 3
        pcm[240 * 4: 240 * 6] ^= 0x2A   # frames 4-5 (one run with frame 3)
        pcm[240 * 9 + 1] ^= 0x01        # frame 9 (separate run)
        return pcm

    _force(monkeypatch, corrupt)
    rs, _, _ = tx.load_rom(roms["synth"])
    log = tmp_path / "validate.log"
    rc = tx.cmd_validate(rs, 0x67, 60, log_path=str(log), device="cpu")
    assert rc == 1
    text = log.read_text()
    assert "Validation FAILED" in text
    assert "2 diff runs" in text
    assert "frames 3..5" in text and "frames 9..9" in text
    assert "Frame 3:" in text
    assert "scalar[  0]" in text and "cuda  [  0]" in text
    assert "tpu" not in text
    assert "recent data-port commands" in text
    assert "play track $" in text
    # without a log the details go to stdout
    capsys.readouterr()
    rc, out, _ = _main(tx, [roms["synth"], "--validate", "--platform", "cpu",
                            *CAP], capsys)
    assert rc == 1 and "cuda  [  0]" in out and "Validation FAILED" in out


def test_validate_diagnostics_on_port_mismatch(roms, tmp_path, monkeypatch):
    def corrupt(pcm, tracer):
        tracer.host.rx.append(0xEE)     # phantom extra DCS->host byte
        return pcm

    _force(monkeypatch, corrupt)
    rs, _, _ = tx.load_rom(roms["synth"])
    log = tmp_path / "validate.log"
    rc = tx.cmd_validate(rs, 0x67, 60, log_path=str(log), device="cpu")
    assert rc == 1
    text = log.read_text()
    assert "Data port diverges at byte" in text
    assert "  cuda  : " in text and "EE" in text


def test_backend_list_and_prefix(roms, tmp_path, capsys):
    # '?', an ambiguous prefix ("emu") and an unknown name ("tpu") list the
    # card's pipeline and the three registered decoders, as the JAX CLI
    # lists its own
    for name in ("?", "emu", "tpu"):
        rc, out, _ = _main(tx, [roms["synth"], "--backend", name], capsys)
        assert rc == 0
        assert out.splitlines() == [
            "Available decoders:",
            f"    {'cuda':<16} batched CUDA device pipeline (default)",
            f"    {'emulator-fast':<16} ADSP-2105 interpreter with native "
            "transform speedup",
            f"    {'emulator-strict':<16} ADSP-2105 interpreter running "
            "original ROM firmware",
            f"    {'native':<16} bit-exact scalar decoder (runtime "
            "reference)"]
    assert [r.name for r in treg.registrations()] == [
        "emulator-fast", "emulator-strict", "native"]
    assert treg.resolve("NAT").name == "native"
    assert treg.resolve("emulator-s").name == "emulator-strict"
    assert isinstance(treg.create("n"), trd.ReferenceDecoder)
    files = {}
    for name in ("nat", "native", "scalar"):
        d = tmp_path / name
        d.mkdir()
        rc, out, _ = _main(tx, [roms["synth"], "--backend", name, *CAP,
                                "--extract-tracks", str(d / "t")], capsys)
        assert rc == 0 and "track $0001" in out
        files[name] = _files(d)
    assert files["nat"] == files["native"] == files["scalar"]
    assert len(files["nat"]) == 3


def test_interactive_equals_the_jax_cli(roms, tmp_path, monkeypatch, capsys):
    outs = []
    for cli, name in ((jx, "j.wav"), (tx, "t.wav")):
        monkeypatch.setattr("sys.stdin", io.StringIO(
            "0001\nv80\nzz\n\n0002\nquit\n0003\n"))
        rc, out, _ = _main(cli, [roms["synth"], "--interactive",
                                 str(tmp_path / name),
                                 "--seconds-per-command", "0.2"], capsys)
        assert rc == 0
        outs.append(out.replace(name, "X"))
    assert outs[0].splitlines() == outs[1].splitlines()
    assert "track $0002" in outs[1] and "track $0003" not in outs[1]
    got = (tmp_path / "t.wav").read_bytes()
    assert got == (tmp_path / "j.wav").read_bytes()
    assert len(got) == 44 + 2 * 3 * 6250


def test_version(capsys):
    with pytest.raises(SystemExit) as e:
        tx.main(["--version"])
    assert e.value.code == 0
    assert capsys.readouterr().out.strip() == "dcsexplorer-tpu 0.1.0"


@pytest.mark.parametrize("cmd", ["--validate", "--autoplay", "--extract-tracks"])
def test_default_platform_needs_the_card(roms, cmd, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = [roms["synth"], cmd] + ([] if cmd == "--validate"
                                   else [str(tmp_path / "out")])
    rc, out, err = _main(tx, argv, capsys)
    assert rc == 2
    assert "no CUDA device" in err and out == ""
    assert os.listdir(tmp_path) == []
    # the host's commands need no card
    rc, out, _ = _main(tx, [roms["synth"], "--tracks", "--extract-streams",
                            str(tmp_path / "s"), "--extract-format", "raw"],
                       capsys)
    assert rc == 0 and "Track $0001" in out and os.listdir(tmp_path)
