"""The port's encoder tools against the JAX package's, on the CPU
(``--device cpu``: the device encoder's plain versions): the audition tool
(tools/encoder_tester.py) writes the JAX tester's WAV bytes, in one shot
and through its REPL; the corpus tool's clips and SNR (tools/
encoder_corpus.py) equal the JAX ones, its one-call batch encode equals a
per-clip encode_pcm, and ``compare`` raises without a card or the oracle;
and FLAC, MP3 and Ogg inputs through the encoder CLI and the script
compiler give the JAX CLI's and compiler's stream bytes and ROM images."""

import io
import os
import zipfile

import numpy as np
import pytest
import torch

from dcsexplorer_tpu.tools import encoder_cli as jcli
from dcsexplorer_tpu.tools import encoder_corpus as jcorpus
from dcsexplorer_tpu.tools import encoder_tester as jtester
from dcsexplorer_tpu_torch.encoder import encoder as tenc
from dcsexplorer_tpu_torch.tools import encoder_cli as tcli
from dcsexplorer_tpu_torch.tools import encoder_corpus as tcorpus
from dcsexplorer_tpu_torch.tools import encoder_tester as ttester
from dcsexplorer_tpu_torch.utils import audioio

from .test_audioio import _flac_bytes, _sig
from .test_mp3 import _spectrum, encode_frame
from .test_vorbis import _build_floor0_stream
from .torch_native_guard import reference_native_lib


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # the plain versions run many small ops; beside other test workers, a
    # thread pool per op costs more than it gives
    reference_native_lib()
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
    """Short inputs of every format: a WAV at 44,100 Hz, a FLAC at 31,250
    Hz, a stereo MP3 at 44,100 Hz and the floor-0 Ogg at 8,000 Hz."""
    d = tmp_path_factory.mktemp("tools_in")
    rng = np.random.default_rng(4)
    files = {
        "w.wav": None,
        "f.flac": _flac_bytes([_sig(9000, 1), _sig(9000, 2, amp=5000)],
                              kinds=("fixed2", "lpc2"), ch_asgn=8),
        "m.mp3": b"".join(encode_frame([_spectrum(rng), _spectrum(rng)],
                                       mode=1, mode_ext=2, global_gain=170)
                          for _ in range(8)),
        "o.ogg": _build_floor0_stream(n_packets=30, seed=7)[0],
    }
    paths = {"w.wav": _wav(d / "w.wav", 14000, 330, rate=44100, seed=3)}
    for name, data in files.items():
        if data is not None:
            (d / name).write_bytes(data)
            paths[name] = str(d / name)
    return paths


def test_tester_writes_the_jax_testers_wav(inputs, tmp_path, capsys):
    outs = {}
    for key, main, extra in (("jax", jtester.main, []),
                             ("port", ttester.main, ["--device", "cpu"])):
        out = tmp_path / f"{key}.wav"
        assert main([inputs["w.wav"], "-o", str(out), "--bitrate", "96000"]
                    + extra) == 0
        outs[key] = (capsys.readouterr().out.replace(str(out), "OUT"),
                     out.read_bytes())
    assert outs["port"] == outs["jax"]
    pcm, rate = audioio.read_wav(outs["port"][1])
    assert rate == 31250 and np.abs(pcm).max() > 0.01


def test_tester_repl_equals_the_jax_repl(inputs, tmp_path, monkeypatch,
                                         capsys):
    outs = {}
    for key, main, extra in (("jax", jtester.main, []),
                             ("port", ttester.main, ["--device", "cpu"])):
        src = tmp_path / f"{key}.wav"
        src.write_bytes(open(inputs["w.wav"], "rb").read())
        monkeypatch.setattr("sys.stdin", io.StringIO(
            f"play x\n\nencode {src}\nencode {tmp_path}/missing.wav\nquit\n"
            "encode never\n"))
        assert main(["--interactive"] + extra) == 0
        text = capsys.readouterr().out.replace(str(tmp_path), "D")
        outs[key] = (text.replace(key, "K"),
                     (tmp_path / f"{key}.wav.dcs.wav").read_bytes())
    assert outs["port"] == outs["jax"]
    assert "error: " in outs["port"][0] and "kbps -> " in outs["port"][0]


def test_tester_without_a_card_exits_2(inputs, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert ttester.main([inputs["w.wav"], "-o", str(tmp_path / "x.wav")]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "x.wav").exists()


@pytest.mark.parametrize("n,seconds,seed", [(20, 2.0, 3), (7, 0.5, 11)])
def test_corpus_equals_the_jax_corpus(n, seconds, seed):
    got = tcorpus.corpus(n, seconds=seconds, seed=seed)
    want = jcorpus.corpus(n, seconds=seconds, seed=seed)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int16 and np.array_equal(g, w)


def test_snr_equals_the_jax_snr():
    clips = tcorpus.corpus(6, seconds=0.5)
    rng = np.random.default_rng(5)
    for k, ref in enumerate(clips):
        dec = np.roll(ref, 8 * k).astype(np.float64) * (0.4 + 0.1 * k)
        dec += rng.normal(0, 50 * k + 1, dec.size)
        dec = dec.astype(np.int16)
        assert tcorpus._snr(ref, dec) == jcorpus._snr(ref, dec)
    silent = np.zeros_like(clips[0])
    assert tcorpus._snr(clips[0], silent) == jcorpus._snr(clips[0], silent)


def test_corpus_batch_encode_equals_encode_pcm():
    clips = tcorpus.corpus(5, seconds=0.5)
    got = tcorpus.encode_corpus(clips, device="cpu")
    assert len(got) == 5
    for pcm, (stream, nf) in zip(clips, got):
        assert (stream, nf) == tenc.encode_pcm(pcm)


def test_compare_raises_without_the_oracle_or_a_card(monkeypatch):
    from tests import oracle
    monkeypatch.setattr(oracle, "get_lib", lambda: None)
    with pytest.raises(RuntimeError, match="oracle unavailable"):
        tcorpus.compare(n=2, verbose=False, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcorpus.compare(n=2, verbose=False)


def _images(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def test_cli_reads_flac_mp3_and_ogg_as_the_jax_cli(inputs, tmp_path,
                                                   capsys):
    argv = [inputs[n] for n in ("f.flac", "m.mp3", "o.ogg", "w.wav")]
    outs, lines = {}, {}
    for key, cli, extra in (("jax", jcli, []),
                            ("port", tcli, ["--device", "cpu"])):
        d = tmp_path / key
        d.mkdir()
        assert cli.main(argv + ["-o", str(d), "--check"] + extra) == 0
        lines[key] = capsys.readouterr().out.replace(str(d), "OUT")
        outs[key] = {n: (d / n).read_bytes() for n in sorted(os.listdir(d))}
    assert lines["port"] == lines["jax"]
    assert outs["port"] == outs["jax"]
    assert sorted(outs["port"]) == ["f.dcs", "m.dcs", "o.dcs", "w.dcs"]
    # each the host encode_pcm of the reader's PCM
    for name in ("f.flac", "m.mp3", "o.ogg"):
        audio, rate = audioio.read_audio(inputs[name])
        want = tenc.encode_pcm(audio * 32768.0, sample_rate=rate)[0]
        got = audioio.read_dcs_raw(outs["port"][name[0] + ".dcs"])[0]
        assert got == want, name


def test_script_with_flac_mp3_and_ogg_as_the_jax_compiler(inputs, tmp_path,
                                                          capsys):
    script = tmp_path / "s.dcss"
    script.write_text(
        'Default encoding parameters (BitRate=128000);\n'
        'Stream F "f.flac";\nStream M "m.mp3" (BitRate=96000);\n'
        'Stream O "o.ogg";\nStream W "w.wav";\n'
        'Track $0001 channel 0 { Play(F); Wait(stream); Play(W); '
        'Wait(stream); };\n'
        'Track $0002 channel 1 { SetMixingLevel($50); Play(M); '
        'Wait(stream); };\n'
        'Track $0003 channel 2 { Play(O); Wait(stream); };\n')
    res = {}
    for key, cli, extra in (("jax", jcli, []),
                            ("port", tcli, ["--device", "cpu"])):
        out = tmp_path / f"{key}.zip"
        assert cli.main(["--script", str(script), "--stream-dir",
                         os.path.dirname(inputs["f.flac"]), "-o", str(out)]
                        + extra) == 0
        res[key] = (capsys.readouterr().out.replace(str(out), "OUT"),
                    _images(out))
    assert res["port"] == res["jax"]
    assert "U2:" in res["port"][0]
