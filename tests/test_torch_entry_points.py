"""One switch: the device of the tensors alone picks each stage's kernel or
its plain version.  On CPU tensors every entry point of the models launches
no kernel and equals the composition of its stages' plain versions on the
same inputs, bit for bit: FlatPipeline, Flat93Pipeline, SessionDecoder
(with a carried state), SessionDecoder93 (both row kinds, with a carried
state), SessionServer, batch_decode and hybrid_batch_device.

And one column format a family: StreamBank.columns() equals FlatSweep's
compact columns and flatsweep.decode_columns94 on the same streams (each
at an origin inside a larger buffer), and a 1993 StreamBank's columns equal
Flat93Sweep's wire laid out as bank columns (the same pool, bit bases and
band tables) on both walkers."""

import os

import numpy as np
import pytest
import torch

from dcsexplorer_tpu_torch.models import batched
from dcsexplorer_tpu_torch.models import catalogsweep as cs
from dcsexplorer_tpu_torch.models import flatsweep as fs
from dcsexplorer_tpu_torch.models import pipeline as pl
from dcsexplorer_tpu_torch.models import romplay
from dcsexplorer_tpu_torch.ops import band_decode as bd
from dcsexplorer_tpu_torch.ops import decode93 as d93
from dcsexplorer_tpu_torch.ops import kernels, prescan
from dcsexplorer_tpu_torch.ops import transform as tf
from dcsexplorer_tpu_torch.refdec import decoder as rd
from dcsexplorer_tpu_torch.rom import zipload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets", "streams")
SESSION6_ZIP = os.path.join(REPO, "dcsexplorer_tpu_torch", "data",
                            "session6.zip")
WIRES93 = {False: ["music_a.dcs93b", "music_b.dcs93a"],
           True: ["dense_t1.dcs93a1", "dense_t1b.dcs93a1"]}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # the plain versions run many small ops; beside other test workers, a
    # thread pool per op costs more than it gives
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(name, n_frames=None):
    """An asset stream, cut to its first n_frames frames where given (the
    frame count is the header's first two bytes)."""
    s = open(os.path.join(ASSETS, name), "rb").read()
    return s if n_frames is None else n_frames.to_bytes(2, "big") + s[2:]


def _session_inputs(R, F, C, seed):
    """Random rows of a bank of R rows (row 0 among them), mixes over the
    whole u16 range, volume shifts, two sessions and their carried
    states, as CPU tensors."""
    g = torch.Generator().manual_seed(seed)
    rows = torch.randint(0, R, (F, C), generator=g, dtype=torch.int32)
    rows[torch.rand((F, C), generator=g) < 0.3] = 0
    mix = torch.randint(0, 1 << 16, (F, C), generator=g, dtype=torch.int32)
    vol = torch.randint(0, 40, (F,), generator=g, dtype=torch.int32)
    sid = torch.arange(2, dtype=torch.int32).repeat_interleave(F // 2)
    ov0 = torch.randint(0, 1 << 16, (2, 16), generator=g, dtype=torch.int32)
    return rows, mix, vol, sid, ov0


def _flat_args(streams):
    """The flat sweep's tensors of streams on the CPU, and the composition
    of its stages' plain versions on them."""
    a = fs.packed_to_device(fs.FlatSweep(streams).pack()
                            .compact_host_arrays(), "cpu")
    tabs = fs.codec_tables()

    def plain():
        fb = bd.decode94_fb_plain(a["pool_u8"], a["sid"], a["start_bit"],
                                  a["bt_u8"], a["mix_u16"], a["hdr_tab"],
                                  a["fmt_tab"], a["sub_tab"], a["n_steps"],
                                  tabs)
        return tf.transform94_pcm_plain(fb, a["vol_u8"].int(), a["sid"],
                                        tabs)
    return a, plain


def _flat_pipeline():
    a, plain = _flat_args([_read("tone_low.dcs94"),
                           _read("sine_mix_1s.dcs94")])
    return lambda: fs.FlatPipeline("cpu")(**a), plain


def _flat93_pipeline():
    # the OS93a Type-1 wire: its walker's columns and rows
    sw = cs.Flat93Sweep([_read(n, 40) for n in WIRES93[True]], True)
    cols = cs.packed93_to_device(sw.compact_host_arrays(), "cpu")
    pipe = cs.Flat93Pipeline("cpu")
    tabs = dict(pipe.named_buffers())

    def plain():
        c = {k: v for k, v in cols.items() if k not in ("mix", "vol")}
        return d93.decode93_pcm_plain(c, None, cols["mix"], cols["vol"],
                                      cols["sid"], tabs)
    return lambda: pipe(**cols), plain


def _session_decoder():
    bank = pl.StreamBank(rd.OS94)
    for n in ("tone_low.dcs94", "sine_mix_1s.dcs94"):
        bank.add(_read(n))
    bank.decode_all("cpu")
    rows, mix, vol, sid, ov0 = _session_inputs(bank.total_rows(), 130, 6, 1)
    dec = pl.session_decoder(bank)
    bufs = dict(dec.named_buffers())

    def plain():
        fb = bd.session_mix94_plain(bufs["scaled"], rows, mix)
        return tf.transform94_pcm_plain(fb, vol, sid, bufs, ov0)
    return lambda: dec(rows, mix, vol, sid, ov0), plain


def _session_decoder93():
    # an OS93a bank: Type-0 and Type-1 rows
    bank = pl.StreamBank(rd.OS93A)
    for n in ("music_b.dcs93a", "dense_t1.dcs93a1"):
        bank.add(_read(n, 30))
    bank.decode_all("cpu")
    rows, mix, vol, sid, ov0 = _session_inputs(bank.total_rows(), 90, 6, 2)
    dec = pl.session_decoder(bank)
    bufs = dict(dec.named_buffers())
    return (lambda: dec(rows, mix, vol, sid, ov0),
            lambda: d93.session93_pcm_plain(bufs, rows, mix, vol, sid, bufs,
                                            ov0))


def _session_server():
    rs, _ = zipload.load_zip_file(SESSION6_ZIP)
    S, T, C = 2, 40, 6
    srv = romplay.SessionServer(rs, S, T, n_ch=C, device="cpu")
    events = [{0: [0x55, 0xAA, 0x50, 0xAF, 0, 1]}, {3: [0, 2], 9: [0, 3]}]

    def plain():
        wire, E = srv.prepare(events)
        rows, mix, vol = romplay.segments94_plain(torch.from_numpy(wire),
                                                  S, T, C, E)
        bufs = dict(srv.decoder.named_buffers())
        fb = bd.session_mix94_plain(bufs["scaled"], rows, mix)
        words = tf.transform94_pcm_plain(fb, vol, srv._sid, bufs)
        srv.close()
        return pl.to_int16(words.reshape(S, T * 240)).numpy()
    return lambda: srv.serve_one(events), plain


def _batch_decode():
    # streams of one length: no pad rows, so the padded model's frames are
    # the flat sweep's
    streams = [_read("tone_low.dcs94", 100), _read("sine_mix_1s.dcs94", 100)]
    args = batched.SweepInputs(streams).args("cpu")
    _, flat = _flat_args(streams)
    return (lambda: batched.batch_decode(*args),
            lambda: flat().reshape(2, 100, 240))


def _hybrid_batch_device():
    host = batched.hybrid_host_stage([_read("tone_low.dcs94"),
                                      _read("sine_mix_1s.dcs94")])
    S, F = host[0].shape[:2]
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        *host[:4], rng.integers(0, 1 << 16, (S, F)).astype(np.int32),
        rng.integers(0, 4, (S, F)).astype(np.int32))]

    def plain():
        d, sc, ix, va, mix, vol = (a.reshape(S * F, -1) for a in args)
        fb = bd.dequant_mix_dense_plain(d, (sc, ix, va), mix.reshape(-1))
        sid = torch.arange(S, dtype=torch.int32).repeat_interleave(F)
        return tf.transform94_pcm_plain(
            fb, vol.reshape(-1), sid, fs.codec_tables()).reshape(S, F, 240)
    return lambda: batched.hybrid_batch_device(*args), plain


ENTRY_POINTS = {"FlatPipeline": _flat_pipeline,
                "Flat93Pipeline": _flat93_pipeline,
                "SessionDecoder": _session_decoder,
                "SessionDecoder93": _session_decoder93,
                "SessionServer": _session_server,
                "batch_decode": _batch_decode,
                "hybrid_batch_device": _hybrid_batch_device}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_an_entry_point_on_cpu_tensors_is_its_plain_composition(name):
    run, plain = ENTRY_POINTS[name]()
    before = dict(kernels.LAUNCHES)
    got = run()
    assert kernels.LAUNCHES == before
    want = plain()
    for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (got, want))):
        g, w = (torch.as_tensor(v) for v in (g, w))
        assert g.shape == w.shape and torch.equal(g, w), name
        assert g.abs().max() > 0, name


def test_the_bank_lays_out_the_flat_sweeps_columns():
    # each stream at byte 5 of a buffer that runs 16 bytes past it
    streams = [_read(f"{n}.dcs94") + b"\xff" * 16
               for n in ("tone_low", "chirpy", "sine_mix_1s")]
    bank = pl.StreamBank(rd.OS94)
    for s in streams:
        bank.add(bytes(5) + s, 5)
    got = bank.columns()
    want = fs.decode_columns94(streams,
                               [prescan.prescan94(s, 0) for s in streams])
    sweep = fs.FlatSweep(streams).pack().compact_host_arrays()
    assert set(got) == set(want) - {"bt"} | {"bt_u8"}
    assert got["n_steps"] == want["n_steps"] == sweep["n_steps"]
    assert np.array_equal(got["bt_u8"], fs.narrow_band_types(want["bt"]))
    for k in ("pool_u8", "sid", "start_bit", "bt_u8", "hdr_tab", "fmt_tab",
              "sub_tab"):
        assert np.array_equal(got[k], sweep[k]), k
        if k != "bt_u8":
            assert np.array_equal(got[k], want[k]), k
    assert got["sid"].dtype == np.int32
    assert list(bank.offsets.values()) == list(
        1 + np.cumsum([0] + [int(c) for c in np.bincount(got["sid"])[:-1]]))


@pytest.mark.parametrize("t1", [False, True])
def test_the_1993_bank_lays_out_the_flat_sweeps_columns(t1):
    # standalone streams: the bank's body of each is the whole stream, so
    # one builder gives both the same pool, bit bases and band tables
    streams = [_read(n) for n in WIRES93[t1]]
    bank = pl.StreamBank(rd.OS93A if t1 else rd.OS93B)
    for s in streams:
        bank.add(s)
    got = bank.columns93()
    want = cs.columns93(cs.Flat93Sweep(streams, t1).compact_host_arrays())
    assert np.array_equal(got["pool_u8"], want["pool_u8"])
    assert np.array_equal(got["band_tab"], want["band_tab"])
    assert got["kind_u8"][0] == d93.ROW_SILENT
    assert (got["kind_u8"][1:] == (d93.ROW_93A if t1 else d93.ROW_93)).all()
    for k in ("frame_word", "kw_u8", "bit_rel", "prv", "code_u8", "sid"):
        assert np.array_equal(got[k][1:], want[k]), k
    if not t1:
        assert np.abs(got["band_tab"]).max() > 0
