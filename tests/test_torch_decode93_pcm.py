"""Port parity for decode93_pcm, the stage of every 1993 path (decode,
inverse transform and overlap resolve in one), on the CPU, where
decode93.decode93_pcm takes its plain version.  Inputs are made from a seed
with numpy; every comparison is bit for bit on & $FFFF, against the JAX
chain run on the CPU: decode93_frames / decode93a_frames per channel in
channel order (device_decode93), transform93_raw, then
overlap_resolve93_flat or, with a carried state, overlap_resolve93 per run.

- the flat assets of both wires (93b / 93a Type-0 and OS93a Type-1), each
  frame of a stream once, in order;
- random session rows over session93a.zip's bank at C = 1, 6 and 8 voices
  with frames that hold both row kinds, random mixes and volume shifts, flat
  and with random carried states over runs that cross the kernel's 63-frame
  tile;
- the OS93a Type-1 stream with 7..9-bit bands, against the scalar decoder
  (the JAX package decodes those widths wrong);
- the premise of the kernel's 256-word frame buffer: frame-buffer words
  256..511 change no PCM word, in the JAX transform and in the port's;
- the premise of the kernel's voice bodies: each voice's partial (16-bit
  deltas, and a Type-1 voice's tie bits) reads no word of the frame, and
  the partials folded in channel order (the tie rule on the running word,
  the 93 fix-up of words 0 and 1) give the serial chain's words, on random
  words and at $7FFF, $8000 and $FFFF, with ties forced and fix-ups that
  saturate at both ends, in every order of a 3-voice frame and at 2..8
  voices;
- the collection map is the 8-bit bit reversal, which the kernel's stores
  rely on;
- Flat93Pipeline and SessionDecoder93 with plain=True still equal the
  composition they ran before (decode93_fb_plain, then
  transform93_pcm_plain)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dcsexplorer_tpu.models import pipeline as jpl
from dcsexplorer_tpu.models import romplay as jrp
from dcsexplorer_tpu.ops import transform as jtf
from dcsexplorer_tpu_torch.models import catalogsweep as tcs
from dcsexplorer_tpu_torch.models import pipeline as tpl
from dcsexplorer_tpu_torch.models import romplay as trp
from dcsexplorer_tpu_torch.ops import decode93 as td93
from dcsexplorer_tpu_torch.ops import kernels
from dcsexplorer_tpu_torch.ops import transform as ttf
from dcsexplorer_tpu_torch.refdec import decoder as trd

from .test_torch_decode93 import _scalar, stream93a_wide
from .test_torch_sessions93 import SESSION93A_ZIP, _jax_chain, _load

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets", "streams")
TILE = kernels.DECODE93_PCM_TILE
N_FRAMES = 2 * TILE + 3          # one frame count for all: shared compiles


@pytest.fixture(scope="module")
def tabs():
    return tcs.codec_tables93()


@pytest.fixture(scope="module")
def session93a():
    """(JAX bank, port bank on the CPU) of session93a.zip."""
    with open(SESSION93A_ZIP, "rb") as f:
        rj, rt = _load(f.read())
    return jrp.build_rom_bank(rj), trp.build_rom_bank(rt, "cpu")


def _jax_pcm(fb, vol, sid, ov0=None):
    """JAX transform93_raw and the overlap resolve of frame buffers fb
    [F, 512] (numpy): overlap_resolve93_flat with the carry reset where sid
    changes, or per run of sid overlap_resolve93 from ov0[sid] (the run's
    last tail into last_ov[sid])."""
    raw = jtf.transform93_raw(jnp.asarray(fb, jnp.int32),
                              jnp.asarray(vol, jnp.int32))
    starts = np.concatenate([[True], sid[1:] != sid[:-1]])
    if ov0 is None:
        return np.asarray(jtf.overlap_resolve93_flat(raw, jnp.asarray(
            starts))) & 0xFFFF, None
    pcm = np.zeros((fb.shape[0], 240), np.int64)
    last = ov0.astype(np.int64).copy()
    edges = list(np.nonzero(starts)[0]) + [fb.shape[0]]
    for a, b in zip(edges, edges[1:]):
        p, ov = jtf.overlap_resolve93(raw[a:b], jnp.asarray(ov0[sid[a]],
                                                            jnp.int32))
        pcm[a:b] = np.asarray(p) & 0xFFFF
        last[sid[a]] = np.asarray(ov) & 0xFFFF
    return pcm, last


def _port_pcm(cols, rows, mix, vol, sid, tabs, ov0=None):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))
    before = dict(kernels.LAUNCHES)
    got = td93.decode93_pcm(cols, None if rows is None else t(rows), t(mix),
                            t(vol), t(sid), tabs,
                            None if ov0 is None else t(ov0))
    assert kernels.LAUNCHES == before            # CPU tensors: no kernel
    if ov0 is None:
        return got.numpy(), None
    return got[0].numpy(), got[1].numpy()


def _same(want, got):
    w_pcm, w_last = want
    g_pcm, g_last = got
    assert g_pcm.dtype == np.int32 and g_pcm.shape == w_pcm.shape
    assert np.array_equal(w_pcm, g_pcm)
    assert (w_last is None) == (g_last is None)
    if w_last is not None:
        assert np.array_equal(w_last, g_last)


# -- the flat assets -------------------------------------------------------------

@pytest.mark.parametrize("name,os_v", [
    ("music_a.dcs93b", trd.OS93B), ("music_b.dcs93a", trd.OS93B),
    ("dense_t1.dcs93a1", trd.OS93A), ("dense_t1b.dcs93a1", trd.OS93A)])
def test_decode93_pcm_on_a_flat_asset_matches_the_jax_chain(tabs, name,
                                                            os_v):
    # a bank of the one stream: row 1 + f is its frame f, one voice a frame
    with open(os.path.join(ASSETS, name), "rb") as f:
        s = f.read()
    jb, tb = jpl.StreamBank(os_v), tpl.StreamBank(os_v)
    for bank in (jb, tb):
        bank.add(s)
    jb.decode_all()
    tb.decode_all("cpu")
    rng = np.random.default_rng(len(name))
    F = N_FRAMES
    rows = np.arange(1, F + 1, dtype=np.int32)[:, None]
    mix = rng.integers(0, 1 << 16, size=(F, 1)).astype(np.int32)
    vol = rng.integers(0, 12, size=F).astype(np.int32)
    sid = np.zeros(F, np.int32)
    fb = _jax_chain(jb, rows, mix)
    got = _port_pcm(tb.cols, rows, mix, vol, sid, tabs)
    _same(_jax_pcm(fb, vol, sid), got)
    assert (got[0] != 0).any()


# -- random session rows -----------------------------------------------------------

def _session_inputs(tb, C, F, seed):
    """Rows over the bank (a fifth silent), mixes over the u16 range,
    volume shifts up to 40."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(1, tb.total_rows(), size=(F, C))
    rows[rng.random((F, C)) < 0.2] = 0
    mix = rng.integers(0, 1 << 16, size=(F, C))
    mix[:4, 0] = [0, 0xFFFF, 0x8000, 0x7FFF]
    vol = rng.integers(0, 41, size=F)
    return (rows.astype(np.int32), mix.astype(np.int32),
            vol.astype(np.int32), rng)


@pytest.mark.parametrize("C", [1, 6, 8])
@pytest.mark.parametrize("carry", [False, True])
def test_decode93_pcm_on_random_session_rows_matches_the_jax_chain(
        session93a, tabs, C, carry):
    jb, tb = session93a
    F = N_FRAMES
    rows, mix, vol, rng = _session_inputs(tb, C, F, 10 * C + carry)
    kinds = tb.cols["kind_u8"].numpy()[rows]
    both = (kinds == td93.ROW_93).any(1) & (kinds == td93.ROW_93A).any(1)
    assert C == 1 or both.sum() > 20            # frames that hold both kinds
    # sessions of one frame, and runs that cross the tile edges
    sid = np.repeat(np.arange(F), rng.integers(1, 2 * TILE, size=F))[:F]
    G = int(sid.max()) + 2
    ov0 = rng.integers(0, 1 << 16, size=(G, 16)) if carry else None
    fb = _jax_chain(jb, rows, mix)
    _same(_jax_pcm(fb, vol, sid, ov0),
          _port_pcm(tb.cols, rows, mix, vol, sid, tabs, ov0))


@pytest.mark.parametrize("runs", [[TILE - 1, 2, TILE + 2],
                                  [1, TILE, 0, TILE + 2], [N_FRAMES]])
def test_decode93_pcm_carries_state_across_the_tile(session93a, tabs, runs):
    # runs of frames per session id (an empty one keeps its state), starts
    # at and around the kernel's 63-frame tile's edges, six voices
    jb, tb = session93a
    F = sum(runs)
    rows, mix, vol, rng = _session_inputs(tb, 6, F, F)
    sid = np.repeat(np.arange(len(runs)), runs).astype(np.int32)
    ov0 = rng.integers(0, 1 << 16, size=(len(runs), 16))
    fb = _jax_chain(jb, rows, mix)
    want = _jax_pcm(fb, vol, sid, ov0)
    got = _port_pcm(tb.cols, rows, mix, vol, sid, tabs, ov0)
    _same(want, got)
    for g, n in enumerate(runs):
        if n == 0:
            assert np.array_equal(got[1][g], ov0[g])


# -- the 7..9-bit Type-1 stream ------------------------------------------------------

def test_decode93_pcm_on_type1_widths_7_to_9_matches_the_scalar_decoder(tabs):
    s = stream93a_wide()
    cols = tcs.packed93_to_device(
        tcs.Flat93Sweep([s], True).compact_host_arrays(), "cpu")
    pcm = td93.decode93_pcm(cols, None, cols["mix"], cols["vol"],
                            cols["sid"], tabs)
    got = tpl.to_int16(pcm).reshape(-1).numpy()
    want = _scalar(s, trd.OS93A, 10)
    assert np.array_equal(want, got) and np.abs(want).max() > 0


# -- the premises of the kernel's design ---------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_frame_buffer_words_past_255_change_no_pcm(tabs, seed):
    # transform93_raw reads words 0..255 only, so the kernel keeps 256
    # words a frame and drops decode targets at 256 and above
    rng = np.random.default_rng(seed)
    F = 70
    fb = rng.integers(0, 1 << 16, size=(F, 512)).astype(np.int32)
    fb[::5, :256] = 0x8000
    fb[1::5, :256] = 0x7FFF
    vol = rng.integers(0, 41, size=F).astype(np.int32)
    sid = np.repeat(np.arange(3), [20, 1, 49]).astype(np.int32)
    zeroed = fb.copy()
    zeroed[:, 256:] = 0
    want = _jax_pcm(zeroed, vol, sid)[0]
    assert np.array_equal(_jax_pcm(fb, vol, sid)[0], want)
    t = torch.from_numpy
    for a in (fb, zeroed):
        got = ttf.transform93_pcm_plain(t(a), t(vol), t(sid), tabs)
        assert np.array_equal(got.numpy(), want)


def _sx16(x):
    return ((np.asarray(x, np.int64) & 0xFFFF) ^ 0x8000) - 0x8000


def _sat16(x):
    return np.clip(x, -32768, 32767) & 0xFFFF


def _voice(rng, kind, edges):
    """One voice's writes over 256 words: a 93 body's (targets >= 1 and
    distinct; per target the low word lo and the mix product X that
    ((sx16(old) << 16 | lo) + X) >> 16 folds in), or a Type-1 body's (per
    word the doubled pair product, prod; None where its band is silent).
    edges: most Type-1 products tie ($8000 low) and the 93 body's word-1
    delta is +1 or -1, so that the fix-up saturates."""
    if kind == "93":
        hit = rng.random(256) < rng.uniform(0.1, 1.0)
        hit[0] = False
        hit[1] = hit[1] or edges or rng.random() < 0.5
        lo = rng.integers(0, 1 << 16, 256)
        scaled = rng.integers(0, 1 << 16, 256)
        x = _sx16(scaled) * rng.integers(0, 1 << 16)
        if edges:                      # (lo + X) >> 16 = +1 or -1 at word 1
            lo[1], x[1] = (0xFFFF, 1) if rng.random() < 0.5 else (0, -1)
        return kind, np.where(hit, lo, -1), x
    live = rng.random(256) < 0.9
    live[254:] = False
    prod = (_sx16(rng.integers(0, 1 << 16, 256))
            * 2 * _sx16(rng.integers(0, 1 << 16, 256))) & 0xFFFFFFFF
    tie = rng.random(256) < (0.7 if edges else 0.05)
    prod = np.where(tie, (prod & ~0xFFFF) | 0x8000, prod)
    return kind, np.where(live, prod, -1), None


def _serial(fb, voices):
    """The serial chain, a voice at a time on the words as they stand."""
    fb = fb.copy()
    for kind, a, x in voices:
        w1 = fb[1]
        for t in np.nonzero(a >= 0)[0]:
            old = _sx16(fb[t]) << 16
            if kind == "93":
                fb[t] = (((old | a[t]) + x[t]) & 0xFFFFFFFF) >> 16
            else:
                res = (old + a[t] + 0x8000) & 0xFFFFFFFF
                if a[t] & 0xFFFF == 0x8000:
                    res &= ~0x10000
                fb[t] = res >> 16
        if kind == "93":               # after every 93 voice, hit or not
            delta = _sat16(_sx16(fb[1]) - _sx16(w1))
            fb[0] = _sat16(_sx16(delta) + _sx16(fb[0]))
            fb[1] = w1
    return fb


def _fold(fb, voices):
    """The partials, then the fold, as decode93_pcm.cu's voice bodies
    make them: per voice its deltas d (16 bits a word) and, for a Type-1
    voice, its tie bits, read no word of the frame; they are added in
    channel order to words held as 32-bit ints whose bits above the low 16
    are never read, the tie bits clearing bit 0 of the running word, and
    after a 93 voice word 0 takes the fix-up of words 0 and 1 in place of
    word 1's delta.  Returns the low 16 bits of each word."""
    w = fb.astype(np.int64) & 0xFFFFFFFF
    for kind, a, x in voices:
        live = a >= 0
        if kind == "93":
            d = np.where(live, ((a + x) >> 16) & 0xFFFF, 0)
            tie = np.zeros(256, bool)
        else:
            p8 = (a + 0x8000) & 0xFFFFFFFF
            d = np.where(live, p8 >> 16, 0)
            tie = live & (p8 & 0xFFFF == 0)
        w0, w1 = w[0], w[1]
        w = (w + d) & 0xFFFFFFFF
        w[tie] &= ~1
        if kind == "93":
            w[0] = _sat16(_sx16(_sat16(_sx16(w1 + d[1]) - _sx16(w1)))
                          + _sx16(w0))
            w[1] = w1
    return w & 0xFFFF


@pytest.mark.parametrize("kinds", [
    (a, b, c) for a in ("93", "t1") for b in ("93", "t1")
    for c in ("93", "t1")])
@pytest.mark.parametrize("edges", [False, True])
def test_voice_partials_folded_in_channel_order_equal_the_serial_chain(
        kinds, edges):
    # decode93_pcm.cu's voice bodies: a 93 voice's write
    # ((sx16(old) << 16 | lo) + X) >> 16 is old + ((lo + X) >> 16), a
    # Type-1 voice's is old + ((prod + $8000) >> 16) with bit 0 cleared on
    # a tie, so each voice's partial is independent of the words before
    # it; folding the partials in channel order, with the fix-up of words
    # 0 and 1 after each 93 voice, gives the serial chain's words, whatever
    # the bits above each word's low 16.  Frames start from silence, from
    # random words and from words at $7FFF, $8000 and $FFFF; each order of
    # 93 and Type-1 voices in a 3-voice frame
    rng = np.random.default_rng(sum(len(k) * 3 ** i
                                    for i, k in enumerate(kinds)) + edges)
    starts = [np.zeros(256, np.int64), rng.integers(0, 1 << 16, 256),
              rng.choice([0x7FFF, 0x8000, 0xFFFF], 256)]
    if edges:                      # the fix-up saturating at both ends
        starts += [np.full(256, 0x7FFF), np.full(256, 0x8000)]
    for start in starts:
        for _ in range(20):
            voices = [_voice(rng, k, edges) for k in kinds]
            high = rng.integers(0, 1 << 16, 256) << 16
            assert np.array_equal(_serial(start, voices),
                                  _fold(start | high, voices))


@pytest.mark.parametrize("seed", range(4))
def test_voice_partials_fold_at_two_to_eight_voices(seed):
    # the same identity over random frames of 2..8 voices of random kinds
    rng = np.random.default_rng(100 + seed)
    for C in range(2, 9):
        for _ in range(10):
            kinds = rng.choice(["93", "t1"], C)
            voices = [_voice(rng, k, rng.random() < 0.3) for k in kinds]
            start = rng.integers(0, 1 << 16, 256)
            assert np.array_equal(_serial(start, voices),
                                  _fold(start, voices))


def test_collection_map_is_the_8_bit_bit_reversal(tabs):
    j = np.arange(256)
    rev = np.zeros(256, np.int64)
    for b in range(8):
        rev |= ((j >> b) & 1) << (7 - b)
    assert np.array_equal(tabs["br93_half"].numpy(), rev)


# -- the plain paths are the composition they were ----------------------------------

def test_flat93_pipeline_plain_is_decode_then_transform(tabs):
    streams = [open(os.path.join(ASSETS, n), "rb").read()
               for n in ("music_b.dcs93a", "music_a.dcs93b")]
    cols = tcs.packed93_to_device(
        tcs.Flat93Sweep(streams, False).compact_host_arrays(), "cpu")
    got = tcs.Flat93Pipeline("cpu", plain=True)(**cols)
    fb = td93.decode93_fb_plain(cols, None, cols["mix"], tabs)
    want = ttf.transform93_pcm_plain(fb, cols["vol"], cols["sid"], tabs)
    assert torch.equal(want, got)
    assert torch.equal(want, tcs.Flat93Pipeline("cpu")(**cols))


def test_session_decoder93_plain_is_decode_then_transform(session93a, tabs):
    tb = session93a[1]
    F = N_FRAMES
    rows, mix, vol, rng = _session_inputs(tb, 6, F, 3)
    t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int32))
    sid = t(np.repeat([0, 1], [40, F - 40]))
    ov0 = t(rng.integers(0, 1 << 16, size=(2, 16)))
    dec = tpl.SessionDecoder93(tb, "cpu", plain=True)
    pcm, last = dec(t(rows), t(mix), t(vol), sid, ov0)
    fb = td93.decode93_fb_plain(tb.cols, t(rows), t(mix), tabs)
    w_pcm, w_last = ttf.transform93_pcm_plain(fb, t(vol), sid, tabs, ov0)
    assert torch.equal(w_pcm, pcm) and torch.equal(w_last, last)
    g_pcm, g_last = tpl.SessionDecoder93(tb, "cpu")(t(rows), t(mix), t(vol),
                                                   sid, ov0)
    assert torch.equal(w_pcm, g_pcm) and torch.equal(w_last, g_last)
