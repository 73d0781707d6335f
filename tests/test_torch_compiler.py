"""Port parity of the ROM compiler (compiler/), the host encoder copies
(encoder/encoder.py, analysis.py, encoder93.py, native encode93_stream)
and utils/audioio.read_audio against the JAX package, on the CPU.

- the tokenizer's tokens, the RomSpec a script parses into and the chip
  images it compiles to, for assets/example.dcss, tests/test_script.py's
  SCRIPT and a script over a 44,100 Hz WAV: the port encodes the 1994+
  streams in one encode_files_device call per parameter set (its plain
  versions here), the JAX package one stream at a time on the host;
- the synthesized firmware words of OS93a, OS93b, OS94 and OS95;
- romgen rebuilding data/session6.zip and patch.load_prototype of it
  (a patch script over it: tests/test_torch_encoder_cli.py);
- a port-compiled ROM played by play_session against ReferenceDecoder;
- the host encoder: analysis transforms, encode_pcm of every family,
  encode_files, transcode_stream, BitWriter, the decode gain.

Importing this module also recovers the JAX package's native library in a
pytest-xdist worker that lost its collection-time build race
(tests/torch_native_guard.py).
"""

import datetime
import io
import os
import types
import zipfile

import numpy as np
import pytest
import torch

from dcsexplorer_tpu import native as jnative
from dcsexplorer_tpu.compiler import firmware as jfw
from dcsexplorer_tpu.compiler import firmware93 as jfw93
from dcsexplorer_tpu.compiler import firmware94 as jfw94
from dcsexplorer_tpu.compiler import patch as jpatch
from dcsexplorer_tpu.compiler import romgen as jromgen
from dcsexplorer_tpu.compiler import script as jscript
from dcsexplorer_tpu.compiler import tokenizer as jtok
from dcsexplorer_tpu.encoder import analysis as jan
from dcsexplorer_tpu.encoder import encoder as jenc
from dcsexplorer_tpu.encoder import encoder93 as jenc93
from dcsexplorer_tpu.rom import zipload as jzip
from dcsexplorer_tpu.utils import audioio as jaudio
from dcsexplorer_tpu_torch import native
from dcsexplorer_tpu_torch.compiler import firmware as tfw
from dcsexplorer_tpu_torch.compiler import firmware93 as tfw93
from dcsexplorer_tpu_torch.compiler import firmware94 as tfw94
from dcsexplorer_tpu_torch.compiler import patch as tpatch
from dcsexplorer_tpu_torch.compiler import romgen as tromgen
from dcsexplorer_tpu_torch.compiler import script as tscript
from dcsexplorer_tpu_torch.compiler import tokenizer as ttok
from dcsexplorer_tpu_torch.encoder import analysis as tan
from dcsexplorer_tpu_torch.encoder import encoder as tenc
from dcsexplorer_tpu_torch.encoder import encoder93 as tenc93
from dcsexplorer_tpu_torch.models import romplay as trp
from dcsexplorer_tpu_torch.ops import kernels
from dcsexplorer_tpu_torch.refdec import decoder as trd
from dcsexplorer_tpu_torch.rom import zipload as tzip
from dcsexplorer_tpu_torch.utils import audioio as taudio

from .test_script import SCRIPT
from .test_torch_rom import _chip_bytes, session6_spec
from .torch_native_guard import reference_native_lib

reference_native_lib()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "assets", "example.dcss")
SESSION6_ZIP = os.path.join(REPO, "dcsexplorer_tpu_torch", "data",
                            "session6.zip")
STREAMS = os.path.join(REPO, "assets", "streams")
# a script over a 44,100 Hz input: the recorded frame count of Wait(stream)
# is taken after resampling
RESAMPLED = """
Signature "resampled <date>";
Default encoding parameters (Type=*, Subtype=*, BitRate=128000);
Stream Fast "fast.wav";
Stream Slow "slow.wav" (BitRate=96000);
Track $0001 channel 0 { SetMixingLevel($64); Play(Fast); Wait(stream); };
Track $0002 channel 1 { Play(Slow); Wait(stream - 2); Play(Fast);
                        Wait(stream); };
"""
# per script: the files it names, and its parameter sets
SCRIPTS = {"example": (EXAMPLE, 2), "script": ("build.dcss", 2),
           "resampled": ("resampled.dcss", 2)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # the plain versions run many small ops; beside other test workers, a
    # thread pool per op costs more than it gives
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Today:
    @staticmethod
    def today():
        return datetime.date(2026, 1, 2)


@pytest.fixture(scope="module")
def pinned_date():
    """``<date>`` in a Signature takes the day of the compile: pin it in
    both compilers."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jscript, tscript):
            mp.setattr(mod, "datetime", types.SimpleNamespace(date=_Today))
        yield


def _tone(n, freq, amp, rate=31250):
    t = np.arange(n) / rate
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.int16)


@pytest.fixture(scope="module")
def script_dir(tmp_path_factory):
    """The inputs of SCRIPT (as tests/test_script.py writes them) and of
    RESAMPLED."""
    d = tmp_path_factory.mktemp("torch_script")
    taudio.write_wav(d / "theme.wav", _tone(9000, 300, 6000))
    taudio.write_wav(d / "hit.wav", _tone(4000, 900, 8000))
    (d / "build.dcss").write_text(SCRIPT)
    rng = np.random.default_rng(17)
    fast = _tone(11025, 440, 7000, 44100) + rng.integers(
        -500, 500, 11025).astype(np.int16)
    taudio.write_wav(d / "fast.wav", fast, sample_rate=44100)
    taudio.write_wav(d / "slow.wav", _tone(7000, 660, 5000))
    (d / "resampled.dcss").write_text(RESAMPLED)
    return d


def _images(zip_bytes):
    with zipfile.ZipFile(io.BytesIO(zip_bytes)) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


@pytest.fixture(scope="module")
def compiled(script_dir, pinned_date):
    """name -> ((JAX spec, zip), (port spec, zip), the port's device
    encodes: the number of streams of each call).  Each package's
    ScriptCompiler parses, its RomBuilder lays out, as compile_script does
    (the entry itself is driven through the CLI,
    tests/test_torch_encoder_cli.py)."""
    out = {}
    calls = []
    real = tenc.encode_files_device

    def counted(jobs, params=None, device="cuda", stats=None):
        calls.append(len(jobs))
        assert device == "cpu"
        return real(jobs, params, device=device, stats=stats)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tenc, "encode_files_device", counted)
        for name, (path, _) in SCRIPTS.items():
            path = os.path.join(script_dir, path)
            text = open(path).read()
            sdir = os.path.dirname(path)
            js = jscript.ScriptCompiler(text, stream_dir=sdir).parse()
            del calls[:]
            sc = tscript.ScriptCompiler(text, stream_dir=sdir, device="cpu")
            ts = sc.parse()
            out[name] = ((js, jromgen.RomBuilder(js).build_zip()),
                         (ts, tromgen.RomBuilder(ts).build_zip()),
                         list(calls), sc.stats)
    return out


def _track_fields(t):
    return (t.number, t.type, t.channel, t.defer_code, list(t.steps))


def _spec_fields(spec):
    return dict(os_version=spec.os_version, signature=spec.signature,
                chip_size=spec.chip_size, max_chips=spec.max_chips,
                num_channels=spec.num_channels,
                tracks=[_track_fields(t) for t in spec.tracks],
                streams=list(spec.streams.items()),
                di_tables=dict(spec.di_tables))


def test_reference_native_lib_recovers_a_failed_load(monkeypatch):
    # the state a worker keeps after meeting a half-written library
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)
    assert jnative.get_lib() is None
    lib = reference_native_lib()
    assert lib is not None and jnative._lib is lib
    assert jnative.get_lib() is lib


@pytest.mark.parametrize("name", ["example", "script"])
def test_tokens_match_jax(name, script_dir):
    path = SCRIPTS[name][0]
    text = open(os.path.join(script_dir, path)).read()
    jlog, tlog = jtok.ErrorLogger("s"), ttok.ErrorLogger("s")
    want = [vars(t) for t in jtok.tokenize(text, jlog)]
    got = [vars(t) for t in ttok.tokenize(text, tlog)]
    assert got == want and len(got) > 50
    assert tlog.messages == jlog.messages


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_script_compiles_as_jax(name, compiled):
    (js, jz), (ts, tz), n_calls, stats = compiled[name]
    assert _spec_fields(ts) == _spec_fields(js)
    assert all(isinstance(s, bytes) for s in ts.streams.values())
    # one device encode a parameter set, every stream of the set in it
    assert len(n_calls) == SCRIPTS[name][1]
    assert sum(n_calls) == len(ts.streams)
    want, got = _images(jz), _images(tz)
    assert sorted(got) == sorted(want) and len(got) >= 1
    for member in want:
        assert got[member] == want[member], member
    assert set(stats) == {"parse_s", "prep_s", "emit_s", "chunk_ms"}


def test_wait_stream_counts_resampled_frames(compiled, script_dir):
    # fast.wav: 11,025 samples at 44,100 Hz -> 7,813 at 31,250 -> 33
    # frames; the track's Wait(stream) delay is that count
    ts = compiled["resampled"][1][0]
    fast = ts.streams["fast"]
    nf = (fast[0] << 8) | fast[1]
    assert nf == 33
    steps = [t for t in ts.tracks if t.number == 1][0].steps
    assert steps[-1][0] == nf


@pytest.mark.parametrize("os_name", ["OS93A", "OS93B", "OS94", "OS95"])
def test_firmware_words_match_jax(os_name):
    if os_name in ("OS94", "OS95"):
        kw = dict(catalog_ofs=0x6000 if os_name == "OS95" else 0x4000,
                  hw_version=3 if os_name == "OS95" else 2)
        want = jfw94.build_decoder_firmware(**kw)
        got = tfw94.build_decoder_firmware(**kw)
        blobs = [(f.overlay_blob(w[1]), f.table_blob())
                 for f, w in ((jfw94, want), (tfw94, got))]
    else:
        a = os_name == "OS93A"
        kw = dict(catalog_ofs=0x4000 if a else 0x3000, os93a=a)
        want = jfw93.build_decoder_firmware(**kw)
        got = tfw93.build_decoder_firmware(**kw)
        blobs = [(f.overlay_blob(w[1]),
                  f.table_blob_93a() if a else f.table_blob())
                 for f, w in ((jfw93, want), (tfw93, got))]
    assert list(got[0]) == list(want[0]) and len(want[0]) > 100
    assert list(got[1]) == list(want[1]) and len(want[1]) > 100
    assert got[2] == want[2]
    assert blobs[1] == blobs[0]
    assert (tfw.encode_boot_block(got[0])
            == jfw.encode_boot_block(want[0]))
    hw = 3 if os_name == "OS95" else 2
    assert tfw.build_firmware(hw) == jfw.build_firmware(hw)


def test_romgen_rebuilds_session6_zip():
    fresh, _ = tzip.load_zip_data(
        tromgen.RomBuilder(session6_spec(tromgen)).build_zip(),
        zip_name="s6.zip")
    committed, _ = tzip.load_zip_file(SESSION6_ZIP)
    assert committed.check() == fresh.check() == 1
    assert _chip_bytes(fresh) == _chip_bytes(committed)


@pytest.fixture(scope="module")
def session6_sets():
    rs_j, _ = jzip.load_zip_file(SESSION6_ZIP)
    rs_t, _ = tzip.load_zip_file(SESSION6_ZIP)
    assert rs_j.check() == rs_t.check() == 1
    return rs_j, rs_t


def test_load_prototype_matches_jax(session6_sets):
    rs_j, rs_t = session6_sets
    want = jpatch.load_prototype(rs_j)
    got = tpatch.load_prototype(rs_t)
    assert _spec_fields(got) == _spec_fields(want)
    assert len(got.streams) == 6 and len(got.tracks) == 7


def test_compiled_rom_plays_as_the_reference_decoder(compiled):
    tz = compiled["script"][1][1]
    rs, _ = tzip.load_zip_data(tz, zip_name="script.zip")
    assert rs.check() == 1
    n = 100
    byte_ev = {0: [0x00, 0x01], 30: [0x00, 0x02], 60: [0x00, 0x05]}

    def events():
        out = {}
        for f, bs in byte_ev.items():
            def ev(dec, bs=tuple(bs)):
                for b in bs:
                    dec.write_data_port(b)
            out[f] = ev
        return out

    before = dict(kernels.LAUNCHES)
    got, _ = trp.play_session(rs, events(), n, default_volume=0xFF,
                              device="cpu")
    assert kernels.LAUNCHES == before
    dec = trd.ReferenceDecoder()
    dec.default_volume = 0xFF
    dec.load_rom_set(rs)
    dec.soft_boot()
    want = []
    ev = events()
    for f in range(n):
        if f in ev:
            ev[f](dec)
        want.extend(dec.next_samples(240))
    want = np.array(want, dtype=np.int16)
    assert np.array_equal(got, want)
    assert np.abs(want.astype(np.int32)).max() > 500


def test_compile_defaults_to_the_card(script_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tscript.compile_script_file(str(script_dir / "build.dcss"))


# ----------------------------------------------------------------------
# the host encoder copies

def _pcm(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 31250.0
    x = 6000 * np.sin(2 * np.pi * 370 * t) * (1 + 0.5 * np.sin(7 * t))
    return (x + rng.normal(0, 300, n)).astype(np.float32)


def test_analysis_matches_jax():
    frames = tenc.frames_from_pcm(_pcm(2400, 1))
    assert np.array_equal(frames, jenc.frames_from_pcm(_pcm(2400, 1)))
    for alg in ("pinv", "butterfly", "dual"):
        assert np.array_equal(tan.analyze_frames(frames, alg),
                              jan.analyze_frames(frames, alg)), alg
    assert np.array_equal(tan.forward_matrix93(), jan.forward_matrix93())
    assert np.array_equal(tan.decoder_matrix93(), jan.decoder_matrix93())
    assert np.array_equal(tan.analyze_frames93(frames),
                          jan.analyze_frames93(frames))
    with pytest.raises(ValueError):
        tan.analyze_frames(frames, "fft")


@pytest.mark.parametrize("case", ["93a", "93b", "93b_type1", "94",
                                  "95_butterfly", "94_dual_44k"])
def test_encode_pcm_matches_jax(case):
    os_v = {"93a": trd.OS93A, "93b": trd.OS93B, "94": trd.OS94,
            "95": trd.OS95}[case.split("_")[0]]
    params = dict(target_bit_rate=96000)
    if case == "93b_type1":
        params["stream_format_type"] = 1
    if "butterfly" in case or "dual" in case:
        params["analysis_transform"] = case.split("_")[1]
    rate = 44100 if case.endswith("44k") else 31250
    pcm = _pcm(9000, 2)
    want = jenc.encode_pcm(pcm, jenc.CompressionParams(**params), rate, os_v)
    got = tenc.encode_pcm(pcm, tenc.CompressionParams(**params), rate, os_v)
    assert got == want and len(got[0]) > 18


def test_native_encode93_matches_jax():
    rng = np.random.default_rng(5)
    tx = rng.normal(0, 2000, (12, 256))
    args = (np.full(16, 16, np.int32),
            np.arange(16, dtype=np.int32) * 16,
            rng.uniform(1, 64, 16), 10.0, tenc93._HUFF93_CW,
            tenc93._HUFF93_NB)
    for fmt_type in (0, 1):
        want = jnative.encode93_stream(tx, fmt_type, 12, *args)
        got = native.encode93_stream(tx, fmt_type, 12, *args)
        assert got == want and len(got) > 100
    assert np.array_equal(tenc93._HUFF93_CW, jenc93._HUFF93_CW)
    assert np.array_equal(tenc93._HUFF93_NB, jenc93._HUFF93_NB)


def test_encode_files_matches_jax():
    jobs = [(_pcm(3000 + 700 * k, 10 + k), 31250) for k in range(2)]
    p = dict(target_bit_rate=112000)
    want = jenc.encode_files(jobs, jenc.CompressionParams(**p), workers=1)
    assert tenc.encode_files(jobs, tenc.CompressionParams(**p),
                             device="cpu") == want
    want = jenc.encode_files(jobs, jenc.CompressionParams(**p),
                             os_version=trd.OS93B, workers=1)
    # the 1993 family in the process pool (spawn)
    assert tenc.encode_files(jobs, tenc.CompressionParams(**p),
                             os_version=trd.OS93B, workers=2) == want


def test_transcode_matches_jax():
    with open(os.path.join(STREAMS, "tone_low.dcs94"), "rb") as f:
        s94 = f.read()
    want = jenc.transcode_stream(s94, trd.OS94, trd.OS93B)
    got = tenc.transcode_stream(s94, trd.OS94, trd.OS93B)
    assert got == want and got[1] == (s94[0] << 8) | s94[1]
    assert tenc._playback_gain(trd.OS94) == jenc._playback_gain(trd.OS94)
    assert tenc._decode_gain() == jenc._decode_gain()


def test_bitwriter_matches_jax():
    rng = np.random.default_rng(9)
    widths = rng.integers(1, 31, 400)
    vals = [int(rng.integers(0, 1 << int(n))) for n in widths]
    tw, jw = tenc.BitWriter(), jenc.BitWriter()
    for v, n in zip(vals, widths):
        tw.write(np.int32(v) if n < 31 else v, n)
        jw.write(v, n)
    assert tw.bytes() == jw.bytes()


def test_read_audio_matches_jax(script_dir):
    path = script_dir / "fast.wav"
    got, want = taudio.read_audio(str(path)), jaudio.read_audio(str(path))
    assert got[1] == want[1] == 44100 and np.array_equal(got[0], want[0])
    data = path.read_bytes()
    assert np.array_equal(taudio.read_audio(data)[0], want[0])
    # FLAC, MP3 and Ogg heads go to the native readers, as in the JAX
    # package: the same ValueError, or the same (here empty) decode
    for magic, name in ((b"fLaC", "FLAC"), (b"ID3\x03", "MP3"),
                        (b"OggS", "Ogg")):
        with pytest.raises(ValueError, match=name) as err:
            taudio.read_audio(magic + bytes(60))
        with pytest.raises(ValueError, match=name) as jerr:
            jaudio.read_audio(magic + bytes(60))
        assert str(err.value) == str(jerr.value)
    got = taudio.read_audio(b"\xff\xfb\x90\x00" + bytes(60))
    want = jaudio.read_audio(b"\xff\xfb\x90\x00" + bytes(60))
    assert got[1] == want[1] and np.array_equal(got[0], want[0])
    with pytest.raises(ValueError, match="unrecognized"):
        taudio.read_audio(b"DCSa" + bytes(60))
