"""The port's audio readers (utils/audioio.py read_flac, read_mp3, read_ogg,
read_audio over native/src/flac.cpp, mp3.cpp and vorbis.cpp) against the
JAX package's, on the CPU, sample for sample: the same C++ on both sides,
so no oracle is needed.

Inputs come from the JAX suite's builders: the FLAC writer of
tests/test_audioio.py (every subframe type, wasted bits, the channel
assignments 1, 8, 9 and 10), the MPEG-1 Layer III frame encoder of
tests/test_mp3.py (mono long blocks, stereo, M/S stereo, block types 1-3,
the Huffman tables, linbits) and the hand-built floor-0 Vorbis stream of
tests/test_vorbis.py (mono at 8,000 Hz: floor 0 and one residue setup
only; stereo coupling, floor 1 and the other residue types are held only
by the sources being identical, which a test here checks).  Also: the same
ValueError on malformed input, the committed data files the card's smoke
run reads (dcsexplorer_tpu_torch/data/reader_input.*: the builder's bytes,
decoded alike by both packages, to the PCM pinned in reader_inputs.json),
and a failed native build raising in the readers.

Rebuild the data files:
  python -c "from tests.test_torch_audio_readers import write_reader_inputs;
  write_reader_inputs()"
"""

import hashlib
import json
import os

import numpy as np
import pytest

from dcsexplorer_tpu import native as jnative
from dcsexplorer_tpu.utils import audioio as jaudio
from dcsexplorer_tpu_torch import native as tnative
from dcsexplorer_tpu_torch.utils import audioio as taudio

from .test_audioio import _flac_bytes, _sig
from .test_mp3 import _spectrum, encode_frame
from .test_vorbis import _build_floor0_stream
from .torch_native_guard import reference_native_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "dcsexplorer_tpu_torch", "data")
JSRC = os.path.join(REPO, "dcsexplorer_tpu", "native", "src")
TSRC = os.path.join(REPO, "dcsexplorer_tpu_torch", "native", "src")
READER_FILES = ("reader_input.flac", "reader_input.mp3", "reader_input.ogg")


@pytest.fixture(scope="module", autouse=True)
def reference_lib():
    return reference_native_lib()


def reader_inputs():
    """The card's reader inputs, {file name: bytes}: a 2-s stereo FLAC at
    22,050 Hz (mid/side, fixed and LPC subframes), a 2-s M/S stereo MP3 at
    44,100 Hz, 160 kbps, and the floor-0 Ogg Vorbis stream of 240 packets
    (3.8 s at 8,000 Hz)."""
    rate = 22050
    t = np.arange(2 * rate) / rate

    def chord(freqs, amps, seed):
        rng = np.random.default_rng(seed)
        x = sum(a * np.sin(2 * np.pi * f * t) for f, a in zip(freqs, amps))
        x = x * (0.6 + 0.4 * np.sin(2 * np.pi * 1.5 * t))
        return np.round(x + rng.normal(0, 2, t.size)).astype(np.int64)

    left = chord((220, 330, 550), (6000, 3000, 1500), 1)
    right = chord((247, 370, 620), (5000, 2500, 1200), 2)
    flac = _flac_bytes([left, right], rate=rate, blocksize=1152,
                       kinds=("fixed2", "lpc2", "fixed3"), ch_asgn=10)
    rng = np.random.default_rng(18)
    frames = []
    for k in range(77):
        mid = np.zeros(120, dtype=np.int64)
        side = np.zeros(120, dtype=np.int64)
        for b, a in ((10 + k % 5, 9), (24, 6), (40 + (k // 7) % 6, 4)):
            mid[b] = a if k % 2 else -a
        mid += _spectrum(rng, n=120, maxv=2, run0=0.8)
        side[12] = 3
        side += _spectrum(rng, n=120, maxv=1, run0=0.9)
        frames.append(encode_frame([mid, side], mode=1, mode_ext=2,
                                   global_gain=185, bitrate_idx=10))
    ogg, _ = _build_floor0_stream(n_packets=240, seed=18)
    return dict(zip(READER_FILES, (flac, b"".join(frames), ogg)))


def pcm_digest(audio):
    """The pin of a reader's result: its sample count and the SHA-256 of
    its float32 samples."""
    a = np.ascontiguousarray(audio, dtype=np.float32)
    return {"samples": int(a.size),
            "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def write_reader_inputs():
    """Write the reader inputs and reader_inputs.json (each file's rate and
    the pin of the JAX package's read_audio of it)."""
    pins = {}
    for name, data in reader_inputs().items():
        with open(os.path.join(DATA, name), "wb") as f:
            f.write(data)
        audio, rate = jaudio.read_audio(data)
        pins[name] = {"rate": int(rate), **pcm_digest(audio)}
    with open(os.path.join(DATA, "reader_inputs.json"), "w") as f:
        json.dump(pins, f, indent=1, sort_keys=True)
        f.write("\n")


def _same(got, want):
    """Two readers' results, equal in every field and sample."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert np.array_equal(g, w, equal_nan=True)
        else:
            assert g == w


def _same_outcome(fn_t, fn_j, data):
    """fn_t(data) and fn_j(data) return equal results, or raise the same
    ValueError."""
    try:
        want = fn_j(data)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            fn_t(data)
        assert str(err.value) == str(e)
        return False
    _same(fn_t(data), want)
    return True


@pytest.mark.parametrize("name", ["flac.cpp", "mp3.cpp", "mp3_tables.h",
                                  "vorbis.cpp", "vorbis_tables.h",
                                  "adsp2105.cpp"])
def test_sources_are_the_jax_packages(name):
    with open(os.path.join(TSRC, name), "rb") as f:
        got = f.read()
    with open(os.path.join(JSRC, name), "rb") as f:
        assert got == f.read()
    assert name in tnative.SOURCES + tnative.HEADERS


# -- FLAC -----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["verbatim", "fixed0", "fixed1", "fixed2",
                                  "fixed3", "fixed4", "lpc2", "lpc3",
                                  "constant"])
def test_flac_subframe_types(kind):
    x = (np.full(384, -1234, dtype=np.int64) if kind == "constant"
         else _sig(1000, 1))
    data = _flac_bytes([x], kinds=(kind,))
    got = tnative.flac_decode(data)
    _same(got, jnative.flac_decode(data))
    assert np.array_equal(got[0][:, 0], x)
    _same(taudio.read_flac(data), jaudio.read_flac(data))


def test_flac_wasted_bits():
    x4 = (_sig(384, 7) // 4) * 4
    data = _flac_bytes([x4], kinds=("verbatim",), wasted=2)
    _same(tnative.flac_decode(data), jnative.flac_decode(data))
    _same(taudio.read_flac(data), jaudio.read_flac(data))


@pytest.mark.parametrize("asgn", [1, 8, 9, 10])
def test_flac_channel_assignments(asgn):
    left, right = _sig(600, 2), _sig(600, 3, amp=7000)
    data = _flac_bytes([left, right], kinds=("fixed2", "lpc2"),
                       ch_asgn=asgn)
    got = tnative.flac_decode(data)
    _same(got, jnative.flac_decode(data))
    assert np.array_equal(got[0], np.stack([left, right], axis=1))
    # the channel mean of read_flac
    _same(taudio.read_flac(data), jaudio.read_flac(data))
    _same(taudio.read_audio(data), jaudio.read_audio(data))


# -- MP3 ------------------------------------------------------------------

def _mp3_cases():
    rng = np.random.default_rng(0)
    cases = {}
    for seed in range(3):
        r = np.random.default_rng(seed)
        cases[f"mono long {seed}"] = [
            encode_frame([_spectrum(r)], global_gain=160 + 10 * seed)
            for _ in range(5)]
    r = np.random.default_rng(11)
    cases["stereo"] = [encode_frame([_spectrum(r), _spectrum(r)], mode=0,
                                    global_gain=165) for _ in range(4)]
    r = np.random.default_rng(12)
    cases["ms stereo"] = [encode_frame([_spectrum(r), _spectrum(r, maxv=3)],
                                       mode=1, mode_ext=2, global_gain=165)
                          for _ in range(4)]
    for btype in (1, 2, 3):
        r = np.random.default_rng(20 + btype)
        cases[f"block type {btype}"] = [
            encode_frame([_spectrum(r)], block_type=0),
            encode_frame([_spectrum(r)], block_type=btype),
            encode_frame([_spectrum(r)], block_type=0)]
    maxv = {1: 1, 2: 2, 3: 2, 5: 3, 6: 3, 7: 5, 8: 5, 9: 5, 10: 7, 11: 7,
            12: 7, 13: 15, 15: 15}
    r = np.random.default_rng(31)
    cases["table sweep"] = [encode_frame([_spectrum(r, maxv=mv)], table=t)
                            for t, mv in maxv.items()]
    v = _spectrum(rng, maxv=14)
    v[::17] = 15
    cases["linbits"] = [encode_frame([v], table=16)]
    return {k: b"".join(f) for k, f in cases.items()}


MP3 = _mp3_cases()


@pytest.mark.parametrize("case", sorted(MP3))
def test_mp3_streams(case):
    data = MP3[case]
    got = tnative.mp3_decode(data)
    _same(got, jnative.mp3_decode(data))
    assert np.abs(got[0].astype(np.int32)).max() > 0
    _same(taudio.read_mp3(data), jaudio.read_mp3(data))
    _same(taudio.read_audio(b"ID3\x03\x00\x00\x00\x00\x00\x00" + data),
          jaudio.read_audio(b"ID3\x03\x00\x00\x00\x00\x00\x00" + data))


# -- Ogg Vorbis -----------------------------------------------------------

@pytest.mark.parametrize("seed,n_packets", [(3, 24), (5, 7), (9, 60)])
def test_ogg_floor0_streams(seed, n_packets):
    ogg, granule = _build_floor0_stream(n_packets=n_packets, seed=seed)
    got = tnative.vorbis_decode(ogg)
    _same(got, jnative.vorbis_decode(ogg))
    assert got[1] == 8000 and got[0].shape == (granule, 1)
    assert np.isfinite(got[0]).all() and np.abs(got[0]).max() > 0
    _same(taudio.read_ogg(ogg), jaudio.read_ogg(ogg))
    _same(taudio.read_audio(ogg), jaudio.read_audio(ogg))


@pytest.mark.parametrize("n", [64, 256, 2048])
def test_vorbis_imdct_selftest(n):
    x = np.random.default_rng(n).standard_normal(n // 2).astype(np.float32)
    outs = []
    for lib in (tnative.get_lib(), jnative.get_lib()):
        fast = np.zeros(n, dtype=np.float32)
        direct = np.zeros(n, dtype=np.float32)
        err = lib.vorbis_imdct_selftest(
            n, x.ctypes.data, fast.ctypes.data, direct.ctypes.data)
        outs.append((err, fast, direct))
    assert outs[0][0] == outs[1][0]
    assert outs[0][0] <= 1e-4 * max(float(np.abs(outs[0][2]).max()), 1.0)
    assert np.array_equal(outs[0][1], outs[1][1])
    assert np.array_equal(outs[0][2], outs[1][2])


# -- malformed input ------------------------------------------------------

def test_malformed_inputs_raise_as_in_the_jax_package():
    ogg, _ = _build_floor0_stream(n_packets=24, seed=3)
    flac = _flac_bytes([_sig(500, 5)], kinds=("fixed2",))
    mp3 = MP3["stereo"]
    pairs = [(taudio.read_audio, jaudio.read_audio),
             (tnative.flac_decode, jnative.flac_decode),
             (tnative.mp3_decode, jnative.mp3_decode),
             (tnative.vorbis_decode, jnative.vorbis_decode)]
    cases = [b"fLaC\x00\x00", b"fLaC" + b"\xff" * 64,
             b"ID3\x04" + b"\x00" * 64, b"OggS" + b"\x00" * 64,
             b"not an ogg stream at all", b"\x01\x02\x03\x04junk",
             flac[:len(flac) // 2], mp3[:len(mp3) // 3]]
    cases += [ogg[:cut] for cut in (len(ogg) // 3, len(ogg) // 2)]
    rng = np.random.default_rng(0)
    raw = np.frombuffer(ogg, dtype=np.uint8)
    for _ in range(30):
        mut = raw.copy()
        for _ in range(rng.integers(1, 8)):
            mut[rng.integers(0, len(mut))] ^= 1 << rng.integers(0, 8)
        cases.append(mut.tobytes())
    cases += [b"OggS" + np.random.default_rng(s).integers(
        0, 256, 4096, dtype=np.uint8).tobytes() for s in range(5)]
    raised = 0
    for data in cases:
        for fn_t, fn_j in pairs:
            raised += not _same_outcome(fn_t, fn_j, data)
    assert raised > len(cases)
    with pytest.raises(ValueError, match="unrecognized"):
        taudio.read_audio(b"\x01\x02\x03\x04junk")
    with pytest.raises(ValueError, match="FLAC"):
        taudio.read_flac(b"fLaC" + b"\xff" * 64)


def test_a_failed_native_build_raises_in_the_readers(monkeypatch):
    def broken():
        raise RuntimeError("g++ failed (1):\nsimulated")

    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "build", broken)
    data = reader_inputs()
    for name, reader in (("reader_input.flac", taudio.read_flac),
                         ("reader_input.mp3", taudio.read_mp3),
                         ("reader_input.ogg", taudio.read_ogg)):
        for fn in (reader, taudio.read_audio):
            with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
                fn(data[name])


# -- the committed data files ---------------------------------------------

def test_committed_reader_inputs(tmp_path):
    built = reader_inputs()
    with open(os.path.join(DATA, "reader_inputs.json")) as f:
        pins = json.load(f)
    assert sorted(pins) == sorted(built) == sorted(READER_FILES)
    for name, data in built.items():
        path = os.path.join(DATA, name)
        with open(path, "rb") as f:
            assert f.read() == data, f"{name} is not the builder's"
        assert len(data) <= 100_000
        got, want = taudio.read_audio(path), jaudio.read_audio(path)
        _same(got, want)
        assert {"rate": got[1], **pcm_digest(got[0])} == pins[name]
        assert got[0].size >= 2 * got[1] and np.abs(got[0]).max() > 0.01
