"""Port parity for the 1993-family ROM session path (models/pipeline.py,
models/romplay.py) on the CPU, where the plain PyTorch versions of
decode93_fb and transform93_pcm run.  Each device piece is held against the
JAX package bit for bit on & $FFFF, and each whole path against the port's
scalar ReferenceDecoder:

- the bank carried across: JAX StreamBank._build93's per-row index
  (idx93, idx93a) against the port's bank columns after unpack_columns93,
  field by field, on an OS93b ROM, a mixed OS93a ROM and session93a.zip;
- decode93_fb_plain against the JAX per-channel chain of device_decode93
  (decode93_frames then decode93a_frames per channel) at C = 1, 3 and 8,
  with random mixes and frames that hold both row kinds; the whole session
  decoder with a random carried overlap state against JAX's;
- autoplay of an OS93b ROM and of an OS93a ROM mixing Type-0 and Type-1
  streams against the scalar decoder (test_romplay.py's lockstep tests);
- decode_standalone on the four .dcs93* assets, and an OS93a Type-1 stream
  with 7..9-bit bands through the session path;
- SessionServer on the 1993 sessions' ROM: five batches at depth 2 against
  play_session, and sessions against the scalar decoder."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dcsexplorer_tpu.compiler import romgen
from dcsexplorer_tpu.encoder import encoder as enc
from dcsexplorer_tpu.models import pipeline as jpl
from dcsexplorer_tpu.models import romplay as jrp
from dcsexplorer_tpu.ops import decode93 as jd93
from dcsexplorer_tpu.ops import decode93a as jd93a
from dcsexplorer_tpu.refdec import decoder as jrd
from dcsexplorer_tpu.rom import zipload as jzip
from dcsexplorer_tpu_torch.models import catalogsweep as tcs
from dcsexplorer_tpu_torch.models import pipeline as tpl
from dcsexplorer_tpu_torch.models import romplay as trp
from dcsexplorer_tpu_torch.ops import decode93 as td93
from dcsexplorer_tpu_torch.ops import kernels
from dcsexplorer_tpu_torch.refdec import decoder as trd
from dcsexplorer_tpu_torch.rom import zipload as tzip

from .test_format93 import build_stream93_fmt0, build_stream93a_type1
from .test_romgen import _make_spec
from .test_torch_decode93 import stream93a_wide

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets", "streams")
SESSION93A_ZIP = os.path.join(REPO, "dcsexplorer_tpu_torch", "data",
                              "session93a.zip")


def _spec93b():
    """test_romplay's OS93b ROM: the synthetic spec's streams re-encoded
    by the 93 encoder."""
    spec = _make_spec()
    spec.os_version = jrd.OS93B
    t = np.arange(31250) / 31250.0
    for k, name in enumerate(list(spec.streams)):
        sig = (5000 * np.sin(2 * np.pi * (400 + 150 * k) * t)) \
            .astype(np.float32)
        spec.streams[name], _ = enc.encode_pcm(sig, os_version=jrd.OS93B)
    return spec


def _spec93a_mixed():
    """test_romplay's OS93a ROM: a Type-0 stream and a Type-1 stream."""
    spec = _make_spec()
    spec.os_version = jrd.OS93A
    t = np.arange(31250 // 2) / 31250.0
    names = list(spec.streams)
    sig = (5000 * np.sin(2 * np.pi * 500 * t)).astype(np.float32)
    spec.streams[names[0]], _ = enc.encode_pcm(
        sig, enc.CompressionParams(stream_format_type=0),
        os_version=jrd.OS93A)
    spec.streams[names[1]] = build_stream93a_type1(
        n_frames=20, n_bands=10, selector=1, seed=5)
    return spec


def _load(data):
    rs_j, _ = jzip.load_zip_data(data, zip_name="r.zip")
    rs_t, _ = tzip.load_zip_data(data, zip_name="r.zip")
    assert rs_j.check() == rs_t.check() == 1       # check() sets os_version
    assert rs_j.os_version == rs_t.os_version
    return rs_j, rs_t


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # the plain versions run many small ops; beside other test workers, a
    # thread pool per op costs more than it gives (the session server's
    # test took 3 s alone and 90-260 s beside busy workers)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def roms():
    """name -> (JAX RomSet, port RomSet) of the three 1993 ROMs."""
    with open(SESSION93A_ZIP, "rb") as f:
        s93a = f.read()
    return {"93b": _load(romgen.RomBuilder(_spec93b()).build_zip()),
            "93a_mixed": _load(romgen.RomBuilder(_spec93a_mixed())
                               .build_zip()),
            "session93a": _load(s93a)}


@pytest.fixture(scope="module")
def banks(roms):
    """name -> (JAX bank, port bank on the CPU)."""
    return {k: (jrp.build_rom_bank(rj), trp.build_rom_bank(rt, "cpu"))
            for k, (rj, rt) in roms.items()}


@pytest.fixture(scope="module")
def tabs():
    return tcs.codec_tables93()


def session_events(b):
    """Session b's port bytes (chip_smoke.session_events): tracks 1-6
    start at staggered frames, then a master-volume command."""
    events = {}
    for t in range(1, 7):
        events.setdefault((b * 7 + t * 3) % 40, []).extend([0x00, t])
    vol = 0x40 + (b % 64)
    events.setdefault(0, []).extend([0x55, 0xAA, vol, vol ^ 0xFF])
    return events


def _callable_events(byte_ev):
    out = {}
    for f, bs in byte_ev.items():
        def ev(dec, bs=tuple(bs)):
            for b in bs:
                dec.write_data_port(b)
        out[f] = ev
    return out


def _scalar_session(rs, events, n_frames, default_volume=0x67):
    dec = trd.ReferenceDecoder()
    dec.default_volume = default_volume
    dec.load_rom_set(rs)
    dec.soft_boot()
    out = []
    for f in range(n_frames):
        if f in events:
            events[f](dec)
        out.extend(dec.next_samples(240))
    return np.array(out, dtype=np.int16)


def _track_events(schedule):
    events = {}
    for (tno, frame, _) in schedule:
        def ev(d, track=tno):
            d.clear_tracks()
            d.write_data_port((track >> 8) & 0xFF)
            d.write_data_port(track & 0xFF)
        events[frame] = ev
    return events


def _random_controls(R, F, C, seed):
    """Bank rows (a fifth silent) and mixes over the whole u16 range."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(1, R, size=(F, C))
    rows[rng.random((F, C)) < 0.2] = 0
    mix = rng.integers(0, 1 << 16, size=(F, C))
    mix[:4, 0] = [0, 0xFFFF, 0x8000, 0x7FFF]
    return rows.astype(np.int32), mix.astype(np.int32)


# -- the bank carried across ---------------------------------------------------

FIELDS93 = ("frame_word", "kind", "width", "n_samp", "bit_start",
            "out_start", "out_inc", "scale", "prv_in", "prv_dl")
FIELDS93A = ("frame_word", "bits", "bit_start", "scale32")


@pytest.mark.parametrize("name", ["93b", "93a_mixed", "session93a"])
def test_bank_matches_jax_build93(banks, name):
    jb, tb = banks[name]
    assert tb.family93 and jb.family93
    assert tb.total_rows() == jb.total_rows()
    assert list(tb.offsets.values()) == list(jb.offsets.values())
    arrs93, arrs93a = td93.unpack_columns93(tb.cols)
    kind = np.asarray(jb.idx93["kind"])
    # where the reference leaves a field unread, the two may differ: bands
    # past a stream's $7F header terminator have no layout (the prescan
    # leaves out_inc 0, the band tables 1), and a band that reads no bit
    # carries the stream's bit base there (bit_start 0 before the shift)
    # and 0 in the port
    live = tb.cols["band_tab"].numpy()[tb.cols["sid"].numpy(), :, 1] > 0
    data = (kind >= td93.K_DATA0) & (kind <= td93.K_DATA2)
    read = np.asarray(jb.idx93a["bits"]) > 0
    masks = {"out_inc": live, "bit_start": data}
    for k in FIELDS93:
        want = np.asarray(jb.idx93[k]).astype(np.int64)
        got = arrs93[k].numpy()
        mask = masks.get(k, np.ones(want.shape, bool))
        assert np.array_equal(want[mask], got[mask]), k
    assert not arrs93["bit_start"].numpy()[~data].any()
    for k in FIELDS93A:
        want = np.asarray(jb.idx93a[k]).astype(np.int64)
        got = arrs93a[k].numpy()
        if k == "scale32":
            want &= 0xFFFFFFFF
        mask = read if k == "bit_start" else np.ones(want.shape, bool)
        assert np.array_equal(want[mask], got[mask]), k
    assert not arrs93a["bit_start"].numpy()[~read].any()
    row_kind = tb.cols["kind_u8"].numpy()
    assert row_kind[0] == td93.ROW_SILENT
    assert (row_kind[1:] == td93.ROW_93).any() == jb.has93
    assert (row_kind[1:] == td93.ROW_93A).any() == jb.has93a
    assert ((kind > 0).any(axis=1) <= (row_kind == td93.ROW_93)).all()


# -- the device half -------------------------------------------------------------

def _jax_chain(jb, rows, mix, idx93=None, idx93a=None):
    """JAX device_decode93's per-channel chain, before the transform, on
    the bank's index (or the given one)."""
    idx93 = jb.idx93 if idx93 is None else idx93
    idx93a = jb.idx93a if idx93a is None else idx93a
    fb = jnp.zeros((rows.shape[0], 512), jnp.int32)
    for c in range(rows.shape[1]):
        r = jnp.asarray(rows[:, c])
        fb = jd93.decode93_frames(jb.pool_quads,
                                  {k: v[r] for k, v in idx93.items()},
                                  jnp.asarray(mix[:, c]), fb_prev=fb)
        fb = jd93a.decode93a_frames(jb.pool_quads,
                                    {k: v[r] for k, v in idx93a.items()},
                                    jnp.asarray(mix[:, c]), fb_prev=fb)
    return np.asarray(fb) & 0xFFFF


@pytest.mark.parametrize("C", [1, 3, 8])
def test_decode93_fb_plain_matches_the_jax_channel_chain(banks, tabs, C):
    jb, tb = banks["session93a"]
    rows, mix = _random_controls(tb.total_rows(), 160, C, C)
    kinds = tb.cols["kind_u8"].numpy()[rows]
    both = ((kinds == td93.ROW_93).any(1) & (kinds == td93.ROW_93A).any(1))
    assert C == 1 or both.sum() > 20          # frames that hold both kinds
    got = td93.decode93_fb_plain(tb.cols, torch.from_numpy(rows),
                                 torch.from_numpy(mix), tabs)
    assert got.dtype == torch.int32 and got.shape == (160, 512)
    assert np.array_equal(_jax_chain(jb, rows, mix), got.numpy())


def test_decode93_fb_plain_keeps_channel_order(tabs):
    # a 93 voice's saturating first-sample fix-up and a 93a voice's words
    # 0..253 do not commute once the sums leave the s16 range.  An OS93a
    # bank of a format-0 stream and a Type-1 stream, with random chain
    # states (the 93 rows' ramps and chains over the whole u16 range) and
    # random 93a scale codes (up to $D745 << 14): reversing the channels
    # changes some frame buffers, and each order matches the JAX chain on
    # the same index
    s93 = build_stream93_fmt0(n_frames=60, n_bands=16, seed=3)
    s93a = build_stream93a_type1(n_frames=60, n_bands=12, selector=2,
                                 seed=4)
    jb, tb = jpl.StreamBank(jrd.OS93A), tpl.StreamBank(trd.OS93A)
    for bank in (jb, tb):
        bank.add(s93)
        bank.add(s93a)
    jb.decode_all()
    tb.decode_all("cpu")
    rng = np.random.default_rng(7)
    cols = dict(tb.cols)
    cols["prv"] = torch.from_numpy(
        rng.integers(-(1 << 31), 1 << 31, size=tuple(cols["prv"].shape))
        .astype(np.int32))
    cols["code_u8"] = torch.from_numpy(
        rng.integers(0, 60, size=tuple(cols["code_u8"].shape))
        .astype(np.uint8))
    as_j = lambda d: {k: jnp.asarray(v.numpy().astype(np.int32))
                      for k, v in d.items()}
    idx93, idx93a = (as_j(d) for d in td93.unpack_columns93(cols))
    f = np.arange(60, dtype=np.int32)[:, None]
    rows = np.concatenate([61 + f, 61 + f, 61 + f, 1 + f], axis=1)
    mix = np.full(rows.shape, 0xFFFF, np.int32)
    got = [td93.decode93_fb_plain(cols, torch.from_numpy(r.copy()),
                                  torch.from_numpy(mix), tabs).numpy()
           for r in (rows, rows[:, ::-1])]
    assert (got[0] != got[1]).any(axis=1).sum() > 0
    for r, g in zip((rows, rows[:, ::-1]), got):
        assert np.array_equal(_jax_chain(jb, r, mix, idx93, idx93a), g)


@pytest.mark.parametrize("name", ["93b", "session93a"])
def test_session_decoder93_with_carried_state_matches_jax(banks, name):
    jb, tb = banks[name]
    rows, mix = _random_controls(tb.total_rows(), 96, 8, 11)
    vol = np.random.default_rng(12).integers(0, 12, size=96).astype(np.int32)
    ov0 = np.random.default_rng(13).integers(0, 1 << 16, 16).astype(np.int32)
    want_pcm, want_ov = jb.jitted()(rows, mix, vol, jnp.asarray(ov0))
    dec = tpl.session_decoder(tb)
    assert isinstance(dec, tpl.SessionDecoder93)
    got_pcm, got_ov = tpl.device_decode(dec, rows, mix, vol, ov0)
    assert np.array_equal(np.asarray(want_pcm) & 0xFFFF, got_pcm.numpy())
    assert np.array_equal(np.asarray(want_ov) & 0xFFFF, got_ov.numpy())
    zero_pcm, _ = tpl.device_decode(dec, rows, mix, vol)
    assert not torch.equal(zero_pcm[0], got_pcm[0])
    assert torch.equal(zero_pcm[1:], got_pcm[1:])


# -- whole paths against the scalar decoder --------------------------------------

@pytest.mark.parametrize("name", ["93b", "93a_mixed"])
def test_1993_rom_autoplay_lockstep(roms, name):
    rs = roms[name][1]
    pcm, sched = trp.autoplay(rs, max_frames_per_track=60, device="cpu")
    assert len(sched) >= 2
    golden = _scalar_session(rs, _track_events(sched), pcm.size // 240)
    assert np.abs(pcm).max() > 0
    assert np.array_equal(golden, pcm)


@pytest.mark.parametrize("name,os_v", [
    ("music_a.dcs93b", trd.OS93B), ("music_b.dcs93a", trd.OS93B),
    ("dense_t1.dcs93a1", trd.OS93A), ("dense_t1b.dcs93a1", trd.OS93A)])
def test_decode_standalone_1993_assets(name, os_v):
    with open(os.path.join(ASSETS, name), "rb") as f:
        s = f.read()
    n = 40
    got = tpl.decode_standalone([(s, 0, 0x64)], os_version=os_v,
                                default_volume=255, n_frames=n, device="cpu")
    dec = trd.ReferenceDecoder()
    dec.default_volume = 255
    dec.init_standalone(os_v)
    dec.soft_boot()
    dec.load_audio_stream(0, s, mixing_level=0x64)
    want = np.array(dec.next_samples(n * 240), dtype=np.int16)
    assert np.array_equal(want, got) and np.abs(want).max() > 0


def test_type1_widths_7_to_9_through_the_session_path():
    # the whole stream (n_frames from prescan93a) through StreamBank and
    # SessionDecoder93, with bands of the codebooks' widest widths
    s = stream93a_wide()
    got = tpl.decode_standalone([(s, 0, 0x64)], os_version=trd.OS93A,
                                default_volume=255, device="cpu")
    dec = trd.ReferenceDecoder()
    dec.default_volume = 255
    dec.init_standalone(trd.OS93A)
    dec.soft_boot()
    dec.load_audio_stream(0, s, mixing_level=0x64)
    want = np.array(dec.next_samples(got.size), dtype=np.int16)
    assert got.size == (10 + 4) * 240
    assert np.array_equal(want, got) and np.abs(want).max() > 0


# -- SessionServer on the 1993 sessions' ROM ----------------------------------------

def test_session_server_on_a_1993_rom(roms, banks):
    # five batches at depth 2: every batch comes back, in order, equals
    # play_session, and its first session equals the scalar decoder
    rs = roms["session93a"][1]
    bank = banks["session93a"][1]
    S, T, n_batches = 3, 100, 5
    batches = [[session_events(k * S + b) for b in range(S)]
               for k in range(n_batches)]
    before = dict(kernels.LAUNCHES)
    with trp.SessionServer(rs, n_sessions=S, n_frames=T, n_ch=6, depth=2,
                           bank=bank, device="cpu") as srv:
        assert isinstance(srv.decoder, tpl.SessionDecoder93)
        outs = list(srv.serve(batches))
    assert kernels.LAUNCHES == before
    assert len(outs) == n_batches
    for k, batch in enumerate(batches):
        for b, byte_ev in enumerate(batch):
            golden, _ = trp.play_session(rs, _callable_events(byte_ev), T,
                                         bank=bank)
            assert np.array_equal(outs[k][b], golden), (k, b)
            assert np.abs(golden).max() > 0
    events = _callable_events(batches[0][0])
    assert np.array_equal(_scalar_session(rs, events, T), outs[0][0])
