"""Port parity for the 1993-family frame decode and transform on the CPU,
where the plain PyTorch versions of decode93_fb and transform93_pcm run.
Each piece is held against the JAX function bit for bit on & $FFFF:

- the host copies: prescan93 / prescan93a (native, and the Python walkers
  called by name) and index_arrays on all four .dcs93* assets and on
  synthetic streams of every format type;
- decode93_frames_plain and decode93a_frames_plain against the JAX
  decode93_frames / decode93a_frames, from silence and from random frame
  buffers, with random mixes;
- _taylor_sqrt93 on its edge inputs, transform93_raw_plain, the overlap
  resolves, and transform93_pcm_plain with random carried states and
  stream starts;
- the device pipeline of test_format93.py (_device_decode93,
  _device_decode93a) through the port's flat path, against the scalar
  decoder; and the OS93a Type-1 widths 7..9, where the port looks the pair
  table up as the reference decoder does."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dcsexplorer_tpu.ops import band_decode as jbd
from dcsexplorer_tpu.ops import decode93 as jd93
from dcsexplorer_tpu.ops import decode93a as jd93a
from dcsexplorer_tpu.ops import transform as jtf
from dcsexplorer_tpu.encoder.encoder import BitWriter
from dcsexplorer_tpu.format import tables as JT
from dcsexplorer_tpu_torch.models import catalogsweep as tcs
from dcsexplorer_tpu_torch.ops import decode93 as td93
from dcsexplorer_tpu_torch.ops import decode93a as td93a
from dcsexplorer_tpu_torch.ops import kernels
from dcsexplorer_tpu_torch.ops import transform as ttf
from dcsexplorer_tpu_torch.refdec import decoder as trd

from .test_format93 import (build_stream93_fmt0, build_stream93_fmt1,
                            build_stream93a_type1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets", "streams")
A93 = ["music_a.dcs93b", "music_b.dcs93a"]
A93A = ["dense_t1.dcs93a1", "dense_t1b.dcs93a1"]


def _asset(name):
    with open(os.path.join(ASSETS, name), "rb") as f:
        return f.read()


def _stream(name):
    """An asset by name, or a synthetic stream ("fmt0:seed", "fmt1:seed",
    "t1:selector")."""
    if ":" not in name:
        return _asset(name)
    kind, k = name.split(":")
    k = int(k)
    if kind == "t1":
        return build_stream93a_type1(n_frames=12, n_bands=12, selector=k,
                                     seed=k + 20)
    build = build_stream93_fmt0 if kind == "fmt0" else build_stream93_fmt1
    return build(n_frames=12, n_bands=16, seed=k)


@pytest.fixture(scope="module")
def tabs():
    return tcs.codec_tables93()


def _same(want, got, fields):
    for k in fields:
        w, g = np.asarray(getattr(want, k)), np.asarray(getattr(got, k))
        assert g.dtype == w.dtype and np.array_equal(w, g), k


FIELDS93 = ("kind", "width", "n_samp", "bit_start", "out_start", "out_inc",
            "scale", "prv_in", "prv_dl", "end_bit")
FIELDS93A = ("bits", "bit_start", "scale32", "end_bit")


# -- the host copies -----------------------------------------------------------

@pytest.mark.parametrize("name", A93 + ["fmt0:3", "fmt1:4"])
@pytest.mark.parametrize("walker", ["native", "python"])
def test_prescan93_matches_jax(name, walker):
    s = _stream(name)
    want = jd93.prescan93(s, 0, prefer_native=walker == "native")
    got = (td93.prescan93 if walker == "native"
           else td93.prescan93_python)(s, 0)
    assert (got.n_frames, got.fmt_type) == (want.n_frames, want.fmt_type)
    _same(want, got, FIELDS93)
    if walker == "native":
        jarr = jd93.index_arrays(want, 4096)
        tarr = td93.index_arrays(got, 4096)
        assert jarr.keys() == tarr.keys()
        for k in jarr:
            assert np.array_equal(np.asarray(jarr[k]), tarr[k]), k


@pytest.mark.parametrize("name", A93A + ["t1:1", "t1:3"])
@pytest.mark.parametrize("walker", ["native", "python"])
def test_prescan93a_matches_jax(name, walker):
    s = _stream(name)
    want = jd93a.prescan93a(s, 0, prefer_native=walker == "native")
    got = (td93a.prescan93a if walker == "native"
           else td93a.prescan93a_python)(s, 0)
    assert (got.n_frames, got.selector) == (want.n_frames, want.selector)
    _same(want, got, FIELDS93A)
    if walker == "native":
        jarr = jd93a.index_arrays(want, 96)
        tarr = td93a.index_arrays(got, 96)
        for k in jarr:
            assert np.array_equal(np.asarray(jarr[k]), tarr[k]), k


def test_asset_widths():
    # widths the kernels must handle on the real assets
    w93 = max(int(td93.prescan93(_asset(n)).width.max()) for n in A93)
    w93a = max(int(td93a.prescan93a(_asset(n)).bits.max()) for n in A93A)
    assert 8 <= w93 <= 24 and 1 <= w93a <= td93a.MAX_BITS


# -- the decode of one voice ----------------------------------------------------

def _voice_inputs(s, idx, mod, n, seed, with_prev):
    """The first n frames of a stream: the JAX window rows and index
    arrays, the port's pool and index tensors, a random mix and prior
    frame buffers (or None)."""
    pool = np.frombuffer(bytes(s) + b"\xff" * 8, dtype=np.uint8)
    arrs = {k: np.asarray(v)[:n] for k, v in mod.index_arrays(idx).items()}
    rows = jbd.window_rows(jnp.asarray(pool.astype(np.int32)),
                           mod.window_words_needed(idx))
    rng = np.random.default_rng(seed)
    n = len(arrs["frame_word"])
    mix = rng.integers(0, 1 << 16, size=n).astype(np.int32)
    mix[:3] = [0, 0xFFFF, 0x8000]
    prev = (rng.integers(0, 1 << 16, size=(n, 512)).astype(np.int32)
            if with_prev else None)
    return pool, arrs, rows, mix, prev


@pytest.mark.parametrize("name", A93 + ["fmt0:7", "fmt1:8"])
@pytest.mark.parametrize("with_prev", [False, True])
def test_decode93_frames_plain_matches_jax(name, with_prev):
    s = _stream(name)
    idx = jd93.prescan93(s, 0)
    pool, arrs, rows, mix, prev = _voice_inputs(s, idx, jd93, 96,
                                                len(name), with_prev)
    want = jd93.decode93_frames(
        rows, {k: jnp.asarray(v) for k, v in arrs.items()}, jnp.asarray(mix),
        None if prev is None else jnp.asarray(prev))
    got = td93.decode93_frames_plain(
        torch.from_numpy(pool), {k: torch.from_numpy(v)
                                 for k, v in arrs.items()},
        torch.from_numpy(mix), None if prev is None else torch.from_numpy(prev))
    assert got.dtype == torch.int32
    assert np.array_equal(np.asarray(want) & 0xFFFF, got.numpy() & 0xFFFF)
    assert (got.numpy() != 0).any()


@pytest.mark.parametrize("name", A93A + ["t1:0", "t1:2"])
@pytest.mark.parametrize("with_prev", [False, True])
def test_decode93a_frames_plain_matches_jax(name, with_prev, tabs):
    s = _stream(name)
    idx = jd93a.prescan93a(s, 0)
    pool, arrs, rows, mix, prev = _voice_inputs(s, idx, jd93a, 96,
                                                len(name), with_prev)
    want = jd93a.decode93a_frames(
        rows, {k: jnp.asarray(v) for k, v in arrs.items()},
        jnp.asarray(mix), None if prev is None else jnp.asarray(prev))
    got = td93a.decode93a_frames_plain(
        torch.from_numpy(pool), {k: torch.from_numpy(v)
                                 for k, v in arrs.items()},
        torch.from_numpy(mix), tabs["pair"],
        None if prev is None else torch.from_numpy(prev))
    assert np.array_equal(np.asarray(want) & 0xFFFF, got.numpy() & 0xFFFF)
    assert (got.numpy()[:, :td93a.TOTAL_OUT] != 0).any()


def test_pool_bits_reads_past_the_end_as_ff():
    pool = torch.tensor([0x12, 0x34, 0x56], dtype=torch.uint8)
    bit = torch.tensor([0, 4, 12, 20, 24, 80])
    got = td93a.pool_bits(pool, bit, torch.tensor(12))
    assert got.tolist() == [0x123, 0x234, 0x456, 0x6FF, 0xFFF, 0xFFF]


# -- the 1993 transform ------------------------------------------------------------

def test_taylor_sqrt93_matches_jax():
    rng = np.random.default_rng(0)
    edge = np.array([0, 1, 0x7FFF, 0x8000, 0x8001, 0xFFFF, 0x4000, 0xC000,
                     0x0100, 0xFF00, 0x2D41, 0x5A82])
    fb0 = np.concatenate([np.repeat(edge, edge.size),
                          rng.integers(0, 1 << 16, 4000)])
    fb1 = np.concatenate([np.tile(edge, edge.size),
                          rng.integers(0, 1 << 16, 4000)])
    want = jtf._taylor_sqrt93(jnp.asarray(fb0, jnp.int32),
                              jnp.asarray(fb1, jnp.int32))
    got = ttf._taylor_sqrt93(torch.from_numpy(fb0), torch.from_numpy(fb1))
    assert np.array_equal(np.asarray(want) & 0xFFFF, got.numpy())
    assert len(set(got.tolist())) > 100


def _frames(n, seed):
    """Random frame buffers with saturating and small rows, volume shifts
    up to 40."""
    rng = np.random.default_rng(seed)
    fb = rng.integers(0, 1 << 16, size=(n, 512)).astype(np.int32)
    fb[0:n:7, :256] = 0x8000
    fb[1:n:7, :256] = 0x7FFF
    fb[2:n:7] = rng.integers(0, 8, size=(len(range(2, n, 7)), 512))
    fb[3:n:7, :2] = 0
    vol = rng.integers(0, 41, size=n).astype(np.int32)
    return fb, vol


def test_transform93_raw_plain_matches_jax(tabs):
    fb, vol = _frames(150, 1)
    want = jtf.transform93_raw(jnp.asarray(fb), jnp.asarray(vol))
    got = ttf.transform93_raw_plain(torch.from_numpy(fb),
                                    torch.from_numpy(vol), tabs)
    assert np.array_equal(np.asarray(want) & 0xFFFF, got.numpy())


@pytest.mark.parametrize("seed", [2, 3])
def test_overlap_resolves93_match_jax(tabs, seed):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 1 << 16, size=(60, 256)).astype(np.int64)
    starts = rng.random(60) < 0.2
    starts[0] = True
    want = jtf.overlap_resolve93_flat(jnp.asarray(raw, jnp.int32),
                                      jnp.asarray(starts))
    got = ttf.overlap_resolve93_flat_plain(torch.from_numpy(raw),
                                           torch.from_numpy(starts), tabs)
    assert np.array_equal(np.asarray(want) & 0xFFFF, got.numpy())
    ov0 = rng.integers(0, 1 << 16, size=16)
    w_pcm, w_ov = jtf.overlap_resolve93(jnp.asarray(raw, jnp.int32),
                                        jnp.asarray(ov0, jnp.int32))
    g_pcm, g_ov = ttf.overlap_resolve93_plain(torch.from_numpy(raw),
                                              torch.from_numpy(ov0), tabs)
    assert np.array_equal(np.asarray(w_pcm) & 0xFFFF, g_pcm.numpy())
    assert np.array_equal(np.asarray(w_ov) & 0xFFFF, g_ov.numpy())


@pytest.mark.parametrize("runs", [[70], [1, 63, 2, 64, 1], [30, 0, 45, 5]])
def test_transform93_pcm_plain_matches_jax(tabs, runs):
    # runs of frames per stream id (an empty one keeps its carry): the flat
    # form against transform93_raw + overlap_resolve93_flat, the carried
    # form per run against overlap_resolve93 from its own overlap0
    N, G = sum(runs), len(runs)
    fb, vol = _frames(N, N)
    ov0 = np.random.default_rng(G).integers(0, 1 << 16, size=(G, 16))
    sid = np.repeat(np.arange(G), runs).astype(np.int32)
    args = (torch.from_numpy(fb), torch.from_numpy(vol),
            torch.from_numpy(sid), tabs)
    raw = jtf.transform93_raw(jnp.asarray(fb), jnp.asarray(vol))
    starts = np.concatenate([[True], sid[1:] != sid[:-1]])
    want = jtf.overlap_resolve93_flat(raw, jnp.asarray(starts))
    assert np.array_equal(np.asarray(want) & 0xFFFF,
                          ttf.transform93_pcm_plain(*args).numpy())
    pcm, last = ttf.transform93_pcm_plain(
        *args, torch.from_numpy(ov0.astype(np.int32)))
    pos = 0
    for g, n in enumerate(runs):
        if n == 0:
            assert np.array_equal(last[g].numpy(), ov0[g])
            continue
        w_pcm, w_ov = jtf.overlap_resolve93(raw[pos:pos + n],
                                            jnp.asarray(ov0[g], jnp.int32))
        assert np.array_equal(np.asarray(w_pcm) & 0xFFFF,
                              pcm[pos:pos + n].numpy())
        assert np.array_equal(np.asarray(w_ov) & 0xFFFF, last[g].numpy())
        pos += n


def test_1993_cpu_dispatch_and_cuda_only_kernels(tabs):
    fb, vol = _frames(8, 9)
    args = (torch.from_numpy(fb), torch.from_numpy(vol),
            torch.zeros(8, dtype=torch.int32), tabs)
    before = dict(kernels.LAUNCHES)
    assert torch.equal(ttf.transform93_pcm(*args),
                       ttf.transform93_pcm_plain(*args))
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        kernels.transform93_pcm(*args)
    cols = tcs.packed93_to_device(
        tcs.Flat93Sweep([_stream("fmt0:1")], False).compact_host_arrays(),
        "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.decode93_fb(*(cols[k] for k in td93.COLUMNS), None,
                            cols["mix"], tabs["pair"], tabs["inputs"])


# -- the device pipeline of test_format93.py, through the port ---------------------

def _scalar(s, os_version, n):
    dec = trd.ReferenceDecoder()
    dec.default_volume = 255
    dec.init_standalone(os_version)
    dec.soft_boot()
    dec.load_audio_stream(0, bytes(s), mixing_level=0x64)
    return np.array(dec.next_samples(n * 240), dtype=np.int16)


@pytest.mark.parametrize("builder,seed", [
    (build_stream93_fmt0, 7), (build_stream93_fmt0, 8),
    (build_stream93_fmt1, 7), (build_stream93_fmt1, 8)])
def test_93_device_pipeline_parity(builder, seed):
    s = builder(seed=seed)
    got = tcs.run_flat93(tcs.Flat93Sweep([s], False), "cpu")
    assert np.array_equal(_scalar(s, trd.OS93B, 12), got)


@pytest.mark.parametrize("seed,selector", [(11, 0), (12, 1), (13, 2),
                                           (14, 3)])
def test_93a_type1_device_pipeline_parity(seed, selector):
    s = build_stream93a_type1(n_frames=10, n_bands=10, selector=selector,
                              seed=seed)
    got = tcs.run_flat93(tcs.Flat93Sweep([s], True), "cpu")
    assert np.array_equal(_scalar(s, trd.OS93A, 10), got)


def stream93a_wide(n_frames=10, n_bands=14, seed=3):
    """An OS93a Type-1 stream (selector 3) whose bands take the widest
    widths of the band-bits codebooks, 7..9, among narrower ones."""
    rng = np.random.default_rng(seed)
    selector = 3
    books = np.asarray(JT.OS93A_BAND_BITS_CODEBOOKS)
    base = (selector << 5) >> 1
    prefix = {}
    for i in range(16):
        bb, nb = int(books[base + i][0]) & 0xFFFF, int(books[base + i][1])
        prefix.setdefault(bb, (i >> (4 - nb), nb))
    inputs = np.asarray(JT.OS93A_INPUTS_PER_BAND)
    w = BitWriter()
    for f in range(n_frames):
        for b in range(n_bands):
            bits = int(rng.choice([7, 8, 9, 9, 3, 0])) if b != f % 3 else 9
            cw, nb = prefix[bits]
            w.write(cw, nb)
            if bits == 0:
                continue
            w.write(0, 2)        # scale codeword: delta 0
            for _ in range(int(inputs[b])):
                w.write(int(rng.integers(0, 1 << bits)), bits)
    return (n_frames.to_bytes(2, "big") + bytes([0x80 | (selector << 5)
                                                 | n_bands])
            + w.bytes() + b"\xff" * 8)


def test_93a_type1_widths_7_to_9_match_the_scalar_decoder():
    s = stream93a_wide()
    idx = td93a.prescan93a(s)
    assert set(np.unique(idx.bits)) >= {7, 8, 9}
    got = tcs.run_flat93(tcs.Flat93Sweep([s], True), "cpu")
    want = _scalar(s, trd.OS93A, 10)
    assert np.array_equal(want, got) and np.abs(want).max() > 0
