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
