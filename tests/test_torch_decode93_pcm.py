"""Port parity for decode93_pcm, the stage of every 1993 path (decode,
inverse transform and overlap resolve in one), on the CPU: its plain
version decode93_pcm_plain, which both instances of the kernel are held
against (decode93.decode93_pcm, the flat sweeps' stage, takes it on CPU
tensors).  Inputs are made from a seed
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
- the premise of the session instance: a row's session-bank words
  (decode93_bank_plain), mixed with m of every class (0, 1, $7FFF, $8000,
  $FFFF, random), give the serial chain's step of that voice on any words
  before it; the bank's edges (repeat indices up to a band's last sample,
  Type-1 ties, targets at word 255 and past it, silent bands and rows, a
  short pool) against the serial chain at 1 and 6 voices; the session
  path's plain version from the bank equals decode93_pcm_plain at C = 1,
  2, 3, 6 and 8, flat and with carried states;
- Flat93Pipeline and SessionDecoder93 on the CPU still equal the
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


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # the plain versions run many small ops; beside other test workers, a
    # thread pool per op costs more than it gives (the session bank's tests
    # took 0.3 s each alone and 33-42 s beside busy workers)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    got = td93.decode93_pcm_plain(cols, t(rows), t(mix), t(vol), t(sid),
                                  tabs, None if ov0 is None else t(ov0))
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
    pcm = td93.decode93_pcm(cols, cols["mix"], cols["vol"], cols["sid"],
                            tabs)
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
    got = tcs.Flat93Pipeline("cpu")(**cols)
    fb = td93.decode93_fb_plain(cols, None, cols["mix"], tabs)
    want = ttf.transform93_pcm_plain(fb, cols["vol"], cols["sid"], tabs)
    assert torch.equal(want, got)


def test_session_decoder93_plain_is_decode_then_transform(session93a, tabs):
    tb = session93a[1]
    F = N_FRAMES
    rows, mix, vol, rng = _session_inputs(tb, 6, F, 3)
    t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int32))
    sid = t(np.repeat([0, 1], [40, F - 40]))
    ov0 = t(rng.integers(0, 1 << 16, size=(2, 16)))
    dec = tpl.SessionDecoder93(tb, "cpu")
    pcm, last = dec(t(rows), t(mix), t(vol), sid, ov0)
    fb = td93.decode93_fb_plain(tb.cols, t(rows), t(mix), tabs)
    w_pcm, w_last = ttf.transform93_pcm_plain(fb, t(vol), sid, tabs, ov0)
    assert torch.equal(w_pcm, pcm) and torch.equal(w_last, last)


# -- the session bank ------------------------------------------------------------------

def _np_cols(cols):
    return {k: v.numpy().copy() for k, v in cols.items()}


def _t_cols(cols):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in cols.items()}


def _random_chains(cols, rng):
    """The bank's columns with random chain states and, on Type-1 rows'
    bands with samples, random scale codes."""
    c = _np_cols(cols)
    c["prv"] = rng.integers(-(1 << 31), 1 << 31, c["prv"].shape).astype(
        np.int32)
    c["code_u8"] = np.where(c["code_u8"] == 0xFF, 0xFF, rng.integers(
        0, 60, c["code_u8"].shape)).astype(np.uint8)
    return c


def _random_bands(c, rng, silent=0.0, kinds=range(6)):
    """Every 93 band kind of ``kinds`` and width 1..24 at random on the 93
    rows, and K_NONE on a further share ``silent`` of the bands."""
    c = dict(c)
    R = c["kw_u8"].shape[0]
    kind = rng.choice(list(kinds), (R, 16))
    kind[rng.random((R, 16)) < silent] = td93.K_NONE
    kw = c["kw_u8"].astype(np.int64)
    is93 = (c["kind_u8"] == td93.ROW_93)[:, None]
    kw[:, :16] = np.where(is93, kind << 5 | rng.integers(1, 25, (R, 16)),
                          kw[:, :16])
    c["kw_u8"] = kw.astype(np.uint8)
    return c


def _edge_columns(cols, case, rng):
    """The bank's columns (random chain states and scale codes) at one of
    the bank's edges: "repeat" (most 93 bands repeat bands, so that the
    repeat index runs to each band's last sample), "ties" (Type-1 scale
    code 56: with mixes of $8000 eff is $2000, and every product of a
    pair-table value = 2 mod 4 ties), "past255" (each 93 stream's bands
    pre-incremented by 0..15 words, so that targets land on word 255 and
    past it), "silent" (most 93 bands without samples, and whole rows
    silent) and "short" (the pool cut inside the last rows' fields, whose
    bits past it read as $FF)."""
    c = _random_chains(cols, rng)
    if case == "repeat":
        c = _random_bands(c, rng, kinds=[td93.K_REPEAT] * 4 + [td93.K_DATA1])
    elif case == "ties":
        c["code_u8"] = np.where(c["code_u8"] == 0xFF, 0xFF, 56).astype(
            np.uint8)
    elif case == "past255":
        tab = c["band_tab"].copy()
        tab[:, :, 3] += rng.integers(0, 16, tab.shape[:2])
        c["band_tab"] = tab
        c = _random_bands(c, rng)
    elif case == "silent":
        c = _random_bands(c, rng, silent=0.7)
        c["kw_u8"][::5, :16] = 0
    else:
        fw = c["frame_word"]
        c["pool_u8"] = c["pool_u8"][:int(fw[-3]) * 4 + 37].copy()
    return _t_cols(c)


def _bank_and_rows(tb, cols, tabs, rng, F, C, mix_class=None):
    """The session bank of the columns, and F x C rows of both kinds over
    the bank (a fifth silent) with mixes of the class given (None: $8000
    on Type-1 rows and $FFFF or $8001 on 93 rows, the folds' edges; else
    0, 1, $7FFF, $8000, $FFFF or "random")."""
    bank = td93.decode93_bank_plain(cols, tabs)
    R = tb.total_rows()
    rows = rng.integers(0, R, (F, C))
    rows[rng.random((F, C)) < 0.2] = 0
    kinds = cols["kind_u8"].numpy()[rows]
    if mix_class is None:
        mix = np.where(kinds == td93.ROW_93A, 0x8000,
                       rng.choice([0xFFFF, 0x8001], (F, C)))
    elif mix_class == "random":
        mix = rng.integers(0, 1 << 16, (F, C))
    else:
        mix = np.full((F, C), mix_class)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))
    return bank, t(rows), t(mix)


def _one_voice(cols, tabs, rows, mix, fb_prev):
    """One voice of the serial chain (decode93_fb_plain's step): the 93
    body, then the Type-1 body, of each frame's row on the words as they
    stand."""
    a93, a93a = td93.unpack_columns93(cols)
    r = rows.long()
    fb = td93.decode93_frames_plain(cols["pool_u8"],
                                    {k: v[r] for k, v in a93.items()}, mix,
                                    fb_prev)
    return td93.decode93a.decode93a_frames_plain(
        cols["pool_u8"], {k: v[r] for k, v in a93a.items()}, mix,
        tabs["pair"], fb)


@pytest.mark.parametrize("mix_class", [0, 1, 0x7FFF, 0x8000, 0xFFFF,
                                       "random"])
def test_session_bank_mixed_is_one_voice_of_the_serial_chain(
        session93a, tabs, mix_class):
    # the premise of the session instance: a row's words that do not
    # depend on the mix (decode93_bank_plain), mixed with m, give the
    # serial chain's step of that voice on any words before it (random
    # words and words at $7FFF, $8000 and $FFFF), over words 0..255; on
    # the bank's columns and on random chain states and band kinds
    tb = session93a[1]
    rng = np.random.default_rng(7 + (mix_class if mix_class != "random"
                                     else 99))
    F = 700
    for cols in (tb.cols, _t_cols(_random_chains(tb.cols, rng)),
                 _t_cols(_random_bands(_random_chains(tb.cols, rng), rng))):
        bank, rows, mix = _bank_and_rows(tb, cols, tabs, rng, F, 1,
                                         mix_class)
        prev = rng.integers(0, 1 << 16, (F, 512))
        prev[::3] = rng.choice([0x7FFF, 0x8000, 0xFFFF], (len(prev[::3]),
                                                          512))
        prev = torch.from_numpy(prev.astype(np.int32))
        want = _one_voice(cols, tabs, rows[:, 0], mix[:, 0], prev)
        got = td93.session93_fb_plain(bank, rows, mix, prev)
        assert torch.equal(want[:, :256] & 0xFFFF, got[:, :256])
        assert not got[:, 256:].any()


@pytest.mark.parametrize("case", ["repeat", "ties", "past255", "silent",
                                  "short"])
def test_session_bank_on_its_edges_equals_the_serial_chain(session93a, tabs,
                                                           case):
    # the bank's edges (_edge_columns), folded at 1 and 6 voices with the
    # folds' edge mixes, against the serial chain over words 0..255; the
    # edge each case is for shows in the bank
    tb = session93a[1]
    rng = np.random.default_rng(len(case))
    cols = _edge_columns(tb.cols, case, rng)
    for C in (1, 6):
        bank, rows, mix = _bank_and_rows(tb, cols, tabs, rng, 600, C)
        want = td93.decode93_fb_plain(cols, rows, mix, tabs)
        got = td93.session93_fb_plain(bank, rows, mix)
        assert torch.equal(want[:, :256], got[:, :256])
    words = bank["words93"].numpy().astype(np.int64) & 0xFFFFFFFF
    lo = np.stack([words[:, :128] & 0xFFFF, words[:, :128] >> 16],
                  -1).reshape(-1, 256)
    kind = bank["kind93"].numpy()
    if case == "repeat":
        nib = (words[:, 128:, None] >> (4 * np.arange(8))) & 15
        assert nib[kind == td93.BANK_93R].max() == 15
    elif case == "ties":
        pk = td93.s16(torch.from_numpy(lo[kind == td93.BANK_93A])).numpy()
        assert ((pk * 2 * 0x2000) & 0xFFFF == 0x8000).any()
    elif case == "past255":
        assert (lo[np.isin(kind, [td93.BANK_93, td93.BANK_93R]), 255]
                != 0).any()
        a93, _ = td93.unpack_columns93(cols)
        last = a93["out_start"] + (a93["n_samp"] - 1) * a93["out_inc"]
        assert bool((last > 255).any())
    elif case == "silent":
        assert (lo[kind == td93.BANK_93] == 0).all(1).any()
    else:
        assert (td93.decode93_bank_plain(tb.cols, tabs)["words93"]
                != bank["words93"]).any()


@pytest.mark.parametrize("C", [1, 2, 3, 6, 8])
@pytest.mark.parametrize("carry", [False, True])
def test_session93_pcm_from_the_bank_equals_decode93_pcm(session93a, tabs, C,
                                                         carry):
    # the session path's plain version from session93a.zip's bank (built
    # by StreamBank) against the columns' decode93_pcm_plain, flat and
    # with random carried states over runs that cross the kernel's tile
    tb = session93a[1]
    F = N_FRAMES
    rows, mix, vol, rng = _session_inputs(tb, C, F, 300 + 10 * C + carry)
    sid = np.repeat(np.arange(F), rng.integers(1, 2 * TILE, size=F))[:F]
    G = int(sid.max()) + 2
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))
    ov0 = t(rng.integers(0, 1 << 16, size=(G, 16))) if carry else None
    args = (t(rows), t(mix), t(vol), t(sid))
    want = td93.decode93_pcm_plain(tb.cols, *args, tabs, ov0)
    before = dict(kernels.LAUNCHES)
    got = td93.session93_pcm(tb.bank93, *args, tabs, ov0)
    assert kernels.LAUNCHES == before            # CPU tensors: no kernel
    for w, g in ((want, got),) if ov0 is None else zip(want, got):
        assert torch.equal(w, g)


def test_session_decoder93_holds_the_session_bank_alone(session93a, tabs):
    # every row is banked: the session decoder holds StreamBank's session
    # bank and the codec tables, and no bitstream or column of the bank
    # (the session instance takes none), so what it decodes comes from
    # the bank built once per ROM
    tb = session93a[1]
    dec = tpl.SessionDecoder93(tb, "cpu")
    assert {n for n, _ in dec.named_buffers()} == \
        {"words93", "kind93"} | set(tabs)
    assert dec.words93.shape == (tb.total_rows(), td93.BANK_WORDS)
    for k in ("words93", "kind93"):
        assert torch.equal(getattr(dec, k), tb.bank93[k])
    rows, mix, vol, _ = _session_inputs(tb, 6, 40, 5)
    t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int32))
    sid = torch.zeros(40, dtype=torch.int32)
    assert torch.equal(dec(t(rows), t(mix), t(vol), sid),
                       td93.decode93_pcm_plain(tb.cols, t(rows), t(mix),
                                               t(vol), sid, tabs))
