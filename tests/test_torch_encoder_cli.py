"""Port parity of the encoder CLI (tools/encoder_cli.py) against the JAX
package's, on the CPU (``--device cpu``: the device encoder's plain
versions): the output files of every ``--format-version``, a 44,100 Hz
WAV among several inputs of one call, a raw .dcs94 transcoded to 93b,
``--check``, ``--script`` and ``--script --patch`` (the patched set's
untouched tracks still play the prototype's streams); and the CLI's
refusals (no card, a malformed FLAC input)."""

import os
import zipfile

import numpy as np
import pytest
import torch

from dcsexplorer_tpu.tools import encoder_cli as jcli
from dcsexplorer_tpu_torch.encoder import encoder as tenc
from dcsexplorer_tpu_torch.rom import tracks as rtracks
from dcsexplorer_tpu_torch.rom import zipload
from dcsexplorer_tpu_torch.tools import encoder_cli as tcli
from dcsexplorer_tpu_torch.utils import audioio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SESSION6_ZIP = os.path.join(REPO, "dcsexplorer_tpu_torch", "data",
                            "session6.zip")
STREAMS = os.path.join(REPO, "assets", "streams")
TONE_LOW = os.path.join(STREAMS, "tone_low.dcs94")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # the plain versions run many small ops; beside other test workers, a
    # thread pool per op costs more than it gives
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wav(path, n, freq, rate=31250, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    x = 7000 * np.sin(2 * np.pi * freq * t) + rng.normal(0, 200, n)
    audioio.write_wav(path, x.astype(np.int16), sample_rate=rate)
    return str(path)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_in")
    return {"a": _wav(d / "a.wav", 8000, 440, seed=1),
            "b": _wav(d / "b.wav", 5000, 880, seed=2),
            "c44": _wav(d / "c44.wav", 12000, 330, rate=44100, seed=3)}


def _run_both(argv, tmp_path, capsys):
    """Run both CLIs with -o in their own directory; returns
    {name: (JAX bytes, port bytes)} of the outputs, and the port's stdout
    lines with its directory named as the JAX run's."""
    outs = {}
    lines = {}
    for key, cli, extra in (("jax", jcli, []),
                            ("port", tcli, ["--device", "cpu"])):
        d = tmp_path / key
        d.mkdir()
        assert cli.main(argv + ["-o", str(d)] + extra) == 0
        lines[key] = capsys.readouterr().out.replace(str(d), "OUT")
        outs[key] = {n: (d / n).read_bytes() for n in os.listdir(d)}
    assert lines["port"] == lines["jax"]
    assert sorted(outs["port"]) == sorted(outs["jax"])
    return {n: (outs["jax"][n], outs["port"][n]) for n in outs["jax"]}


@pytest.mark.parametrize("fv", ["93a", "93b", "94", "95"])
def test_cli_format_versions_match_jax(fv, inputs, tmp_path, capsys):
    argv = [inputs["a"], "--format-version", fv, "--bitrate", "96000"]
    for name, (want, got) in _run_both(argv, tmp_path, capsys).items():
        assert got == want and len(want) > 100, name


def test_cli_batch_with_a_44k_input_and_check(inputs, tmp_path, capsys,
                                              monkeypatch):
    # the three PCM inputs of a 1994+ target go through one device encode
    calls = []
    real = tenc.encode_files_device

    def counted(jobs, params=None, device="cuda", stats=None):
        calls.append(len(jobs))
        return real(jobs, params, device=device, stats=stats)

    monkeypatch.setattr(tenc, "encode_files_device", counted)
    argv = [inputs["a"], inputs["c44"], inputs["b"], "--check"]
    got = _run_both(argv, tmp_path, capsys)
    assert calls == [3]
    assert sorted(got) == ["a.dcs", "b.dcs", "c44.dcs"]
    for name, (want, have) in got.items():
        assert have == want, name


def test_cli_transcodes_raw_dcs94_to_93b(tmp_path, capsys):
    src = tmp_path / "tone_low.dcs"
    with open(TONE_LOW, "rb") as f:
        audioio.write_dcs_raw(src, f.read(), 3)
    got = _run_both([str(src), "--format-version", "93b"], tmp_path,
                    capsys)
    (want, have), = got.values()
    assert have == want
    assert audioio.read_dcs_raw(have)[1] == 2


def _images(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def test_cli_script_and_patch_match_jax(inputs, tmp_path, capsys):
    d = os.path.dirname(inputs["a"])
    script = tmp_path / "s.dcss"
    script.write_text(
        'Default encoding parameters (BitRate=128000);\n'
        'Stream A "a.wav";\nStream B "b.wav" (BitRate=96000);\n'
        'Stream C "c44.wav";\n'
        'Track $0001 channel 0 { Play(A); Wait(stream); Play(C); '
        'Wait(stream); };\n'
        'Track $0002 channel 1 { SetMixingLevel($50); Play(B); '
        'Wait(stream); };\n')
    patch = tmp_path / "p.dcss"
    # session6.zip's third stream (sine_mix_1s) replaced; track 9 plays B
    patch.write_text(
        'Stream N replaces $0349BE "a.wav";\nStream B "b.wav";\n'
        'Track $0009 channel 3 { Play(B); Wait(stream); };\n')
    for argv in (["--script", str(script), "--rom-size", "1M"],
                 ["--script", str(patch), "--patch", SESSION6_ZIP]):
        argv += ["--stream-dir", d]
        res = {}
        for key, cli, extra in (("jax", jcli, []),
                                ("port", tcli, ["--device", "cpu"])):
            out = tmp_path / f"{key}.zip"
            assert cli.main(argv + ["-o", str(out)] + extra) == 0
            lines = capsys.readouterr().out.replace(str(out), "OUT")
            res[key] = (lines, _images(out))
        assert res["port"] == res["jax"]
        assert "U2:" in res["port"][0]
    # the patched set: track 3 plays the new stream, tracks 1-2 and 4-6
    # their prototype streams (session6's assets), byte for byte
    rs, _ = zipload.load_zip_file(str(tmp_path / "port.zip"))
    assert rs.check() == 1 and rs.n_tracks == 10
    names = ["music_a", "music_b", "sine_mix_1s", "noise_sweep", "tone_low",
             "chirpy"]
    for t, name in enumerate(names, 1):
        with open(os.path.join(STREAMS, f"{name}.dcs94"), "rb") as f:
            want = f.read()
        if t == 3:
            audio, rate = audioio.read_audio(inputs["a"])
            want = tenc.encode_pcm(audio * 32768.0, sample_rate=rate)[0]
        assert _track_bytes(rs, t, len(want)) == want, t


def _track_bytes(rs, t, n):
    """The n bytes at the stream that track t plays."""
    (op,) = [op for op in rtracks.decompile_track(rs, rs.os_version, t)
             if op.opcode == 0x01]
    o = op.operands
    p = rs.make_pointer((o[1] << 16) | (o[2] << 8) | o[3])
    return bytes(p.mem[p.pos:p.pos + n])


def test_cli_without_a_card_exits_2(inputs, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert tcli.main([inputs["a"], "-o", str(tmp_path / "x.dcs")]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "x.dcs").exists()


def test_cli_refuses_flac(tmp_path, capsys):
    # FLAC is read now; a malformed one is refused with the reader's error
    src = tmp_path / "in.flac"
    src.write_bytes(b"fLaC" + bytes(64))
    assert tcli.main([str(src), "-o", str(tmp_path / "o.dcs"),
                      "--device", "cpu"]) == 1
    assert "FLAC" in capsys.readouterr().err
