"""The CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA device and nvcc, so they skip elsewhere.  On a machine
with a GPU (no jax needed there):

    DCS_TEST_PLATFORM=gpu python -m pytest tests/test_torch_kernels_gpu.py -q

They cover inputs that real catalogs rarely or never produce: random
headers and band types over the whole uint8 range (decimated bands, $7F
terminators, raw fields, codes whose high bits alias into the width field),
streams that cross block boundaries so a frame's previous band types sit in
another block, bit cursors running past the end of a pool whose length is
not a multiple of 4, random prior frame buffers, saturating frame buffers
and volume shifts past 31, stream starts at the transform-to-PCM kernel's
tile edges, warps whose frames' band lists all end early, frames laid
out in order in the pool (the walk's shared-memory copy of it) beside
frames far apart, a pool of 2^28 bytes (refused); for the session path,
bank rows over the whole u16 range, segment tables of 1 to 255 entries
with equal and unused entries in 1 to 8 channels, frame counts that are
not a multiple of 4 and over a thousand sessions, the session6 bank,
carried overlap states with sessions crossing tiles, and a served batch
on the card against the CPU; the wide wire's expansion with rows near
2^24 in 1, 6 and 8 channels, and a batch of the full eight-chip title's
sessions (past 64Ki bank rows) against its plain path; for the
1993 family, bank rows of both kinds over random chain states and scale
codes in C = 1, 6 and 8 voices, row 0 and all-silent frames, a pool that
ends inside a frame, the transform-to-PCM kernel at its tile edges with and
without a carried state, the fused decode93_pcm kernel (its columns'
instance on the flat assets and on pools that end inside a frame; its
session instance, against the columns' plain decode, on the session bank
of the same random inputs plus every band kind and width at random, frame
counts around its tile and streams that cross it (so the halo frame is
decoded) at C = 1, 2, 3, 6 and 8, and of its folds on Type-1 ties and 93
fix-ups that saturate at both ends at C = 2..8 with fields that cross the
pool's end), the closed-form normalize of its square root on all 2^32
inputs, the flat sweep and a served batch on the card against the CPU;
the session bank (decode93_bank) against its plain version on
session93a's bank, whose columns stay on the host, and on those random
columns; for the 1994+ encoder, the
three encoder kernels on random PCM and the adversarial full-scale set at
frame counts around the 16-frame bucket and the kernels' tiles (the
analysis at 63, 64, 65, 129 and 272 frames, one stream and 64, two calls
on reused memory, and a PCM view 2 bytes off its alignment), random
header scale codes over 0..255 with every bands_keep from 1 to 16, one and
three format slots with every wanted pattern, a band that wants code 15
right after a silent frame, and a batch of 64 streams against the CPU and
the native host search; and for the select kernels alone, random
decisions under shipped and random pip/dep tables, frame counts 1..Fmax,
Fmax from 16 to 528 (two rounds of the scan), B 1 and 64, decision bytes
past 15, and two calls in a row on scratch memory left dirty; the cold
sweeps (chunked uploads from pinned buffers on a copy stream, one
ColdDevice over repeated calls) and catalog_pipeline against the CPU,
a torch.profiler trace of the flat sweep that holds its kernels, a
trace of a flat sweep and a served batch in which each kernel launches
inside its wrapper's dcs.kernel.* span, the
sharded paths over four side streams of one card (["cuda:0"] * 4, inputs
made on the current stream just before the call): the flat sweep, the
1994+ and 1993 sessions and the padded model's 2-D sweep against one
device, the plain path and the CPU, with four launches of each kernel,
and sessions over a bank that grew between two calls; the host-decode
hybrid's dense dequant/mix on random slots (duplicate indices, indices
outside 0..511, prior buffers and active flags given and absent) and on
the assets' native decode, and the hybrid against its plain path and the
CPU with one launch of each kernel; a script compiled, and three WAVs
encoded through the encoder CLI, on the card against the CPU, with one
launch of each encoder kernel a parameter set.  Every
comparison is bit for bit.  chip_smoke.py covers
the real catalogs and the full-width session6 and session93a batches.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from dcsexplorer_tpu_torch import graft_entry
from dcsexplorer_tpu_torch.encoder import core94 as c94
from dcsexplorer_tpu_torch.encoder import device94 as d94
from dcsexplorer_tpu_torch.encoder import encoder as enc
from dcsexplorer_tpu_torch.models import batched
from dcsexplorer_tpu_torch.models import catalogsweep as cs
from dcsexplorer_tpu_torch.models import coldsweep as cold
from dcsexplorer_tpu_torch.models import flatsweep as fs
from dcsexplorer_tpu_torch.models import pipeline, romplay
from dcsexplorer_tpu_torch.ops import band_decode as bd
from dcsexplorer_tpu_torch.ops import decode93 as d93
from dcsexplorer_tpu_torch.ops import kernels
from dcsexplorer_tpu_torch.ops import transform as tf
from dcsexplorer_tpu_torch.parallel import sweep
from dcsexplorer_tpu_torch.refdec import decoder as rd
from dcsexplorer_tpu_torch.rom import zipload
from dcsexplorer_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets", "streams")
SESSION6_ZIP = os.path.join(REPO, "dcsexplorer_tpu_torch", "data",
                            "session6.zip")
SESSION93A_ZIP = os.path.join(REPO, "dcsexplorer_tpu_torch", "data",
                              "session93a.zip")
WIRES93 = {False: ["music_a.dcs93b", "music_b.dcs93a"],
           True: ["dense_t1.dcs93a1", "dense_t1b.dcs93a1"]}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def tabs(dev):
    return {k: v.to(dev) for k, v in fs.codec_tables().items()}


def _launch_counts(**counts):
    """The launches a test expects of every LAUNCHES key: ``counts`` for
    those named, 0 for the others."""
    assert set(counts) <= set(kernels.LAUNCHES)
    return {k: counts.get(k, 0) for k in kernels.LAUNCHES}


def _plain_serve_one(srv, events):
    """One batch of a SessionServer through the plain versions of its
    stages on the server's device: int16 PCM [S, T * 240] (numpy)."""
    S, T, C = srv.n_sessions, srv.n_frames, srv.n_ch
    wire, E = srv.prepare(events)
    rows, mix, vol = romplay.segments94_plain(
        torch.from_numpy(wire).to(srv.device), S, T, C, E)
    bufs = dict(srv.decoder.named_buffers())
    if srv.bank.family93:
        words = d93.session93_pcm_plain(bufs, rows, mix, vol, srv._sid, bufs)
    else:
        words = tf.transform94_pcm_plain(
            bd.session_mix94_plain(bufs["scaled"], rows, mix), vol,
            srv._sid, bufs)
    return pipeline.to_int16(words.reshape(S, T * 240)).cpu().numpy()


def _random_catalog(n, seed, dev, pool_len=20_001, bt_max=256):
    """Random compact columns: sorted stream ids in runs of 1 to ~300
    frames (so streams cross the kernel's 128-frame blocks), random
    headers of both format types and every subtype, random band types, and
    the last frames starting near the end of the pool."""
    rng = np.random.default_rng(seed)
    runs = rng.integers(1, 300, size=n)
    sid = np.repeat(np.arange(n), runs)[:n]
    S = int(sid[-1]) + 1
    hdr = rng.integers(0, 0x100, size=(S, 16))
    hdr[rng.random((S, 16)) < 0.05] = 0x7F
    hdr[0, 0] = 0x7F
    bt = rng.integers(0, bt_max, size=(n, 16))
    bt[rng.random((n, 16)) < 0.2] = 0
    start = rng.integers(0, pool_len * 8, size=n)
    start[-64:] = pool_len * 8 - rng.integers(0, 200, size=64)
    cols = dict(pool_u8=rng.integers(0, 256, size=pool_len, dtype=np.uint8),
                sid=sid.astype(np.int32), start_bit=start.astype(np.int32),
                bt_u8=bt.astype(np.uint8),
                mix=rng.integers(0, 1 << 16, size=n).astype(np.int32),
                hdr_tab=hdr.astype(np.uint8),
                fmt_tab=(hdr[:, 0] >> 7).astype(np.uint8),
                sub_tab=(((hdr[:, 1] >> 6) & 2) | (hdr[:, 2] >> 7))
                .astype(np.uint8))
    return {k: torch.tensor(v, device=dev) for k, v in cols.items()}


@pytest.mark.parametrize("n_steps", [256, 192, 40, 0])
def test_decode94_fb_kernel_on_random_streams(dev, tabs, n_steps):
    cols = _random_catalog(4099, n_steps, dev)
    sid = cols["sid"].cpu().numpy()
    # some streams continue across a block boundary
    edge = np.arange(128, sid.size, 128)
    assert (sid[edge - 1] == sid[edge]).any()
    want = bd.decode94_fb_plain(**cols, n_steps=n_steps, tabs=tabs)
    got = kernels.decode94_fb(**cols, n_steps=n_steps, tabs=tabs)
    torch.cuda.synchronize()
    assert torch.equal(want, got)


def test_decode94_fb_kernel_on_a_pool_ending_mid_window(dev, tabs):
    # 4k + 3 pool bytes: the last refills cross the pool's end
    cols = _random_catalog(1024, 5, dev, pool_len=403, bt_max=20)
    cols["start_bit"] = torch.clamp(cols["start_bit"], min=403 * 8 - 300)
    want = bd.decode94_fb_plain(**cols, n_steps=256, tabs=tabs)
    got = kernels.decode94_fb(**cols, n_steps=256, tabs=tabs)
    torch.cuda.synchronize()
    assert torch.equal(want, got)


def test_decode94_fb_kernel_on_the_assets(dev, tabs):
    streams = [open(p, "rb").read()
               for p in sorted(glob.glob(os.path.join(ASSETS, "*.dcs94")))]
    args = fs.packed_to_device(fs.FlatSweep(streams).pack()
                               .compact_host_arrays(), dev)
    cols = dict(pool_u8=args["pool_u8"], sid=args["sid"],
                start_bit=args["start_bit"], bt_u8=args["bt_u8"],
                mix=args["mix_u16"], hdr_tab=args["hdr_tab"],
                fmt_tab=args["fmt_tab"], sub_tab=args["sub_tab"],
                n_steps=args["n_steps"], tabs=tabs)
    want = bd.decode94_fb_plain(**cols)
    got = kernels.decode94_fb(**cols)
    torch.cuda.synchronize()
    assert torch.equal(want, got)


@pytest.mark.parametrize("n_slots", [256, 100])
@pytest.mark.parametrize("with_prev", [False, True])
def test_dequant_mix_kernel_on_random_inputs(dev, n_slots, with_prev):
    g = torch.Generator(device=dev).manual_seed(n_slots + with_prev)
    n = 3000

    def rand(hi, *shape):
        return torch.randint(0, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    vals, scale = rand(1 << 16, n, n_slots), rand(1 << 16, n, n_slots)
    total, mix = rand(n_slots + 2, n), rand(1 << 16, n)
    prev = rand(1 << 16, n, 512) if with_prev else None
    want = bd.dequant_mix_plain(vals, (scale, total), mix, prev)
    got = kernels.dequant_mix(vals, scale, total, mix, prev)
    torch.cuda.synchronize()
    assert torch.equal(want & 0xFFFF, got & 0xFFFF)


def _random_dense_slots(seed, F, dev):
    """Random dense slots at the native widths on the card, as
    tests/test_torch_hybrid.py makes them: values and scales over more
    than 16 bits, indices from -40 to 559 and, in a quarter of the slots,
    0..7 (duplicates), one frame whose every slot names word 5, prior
    words over all 32 bits, about 70% of the frames active."""
    rng = np.random.default_rng(seed)
    ix = rng.integers(-40, 560, (F, 256)).astype(np.int16)
    ix[:, :64] = rng.integers(0, 8, (F, 64))
    ix[3] = 5
    va = (rng.random((F, 256)) < 0.6).astype(np.uint8)
    va[3] = 1
    arrays = (rng.integers(-70000, 70000, (F, 256)).astype(np.int32),
              rng.integers(-70000, 70000, (F, 256)).astype(np.int32), ix, va,
              rng.integers(0, 1 << 16, F).astype(np.int32),
              rng.integers(-(1 << 31), 1 << 31, (F, 512),
                           dtype=np.int64).astype(np.int32),
              rng.random(F) < 0.7)
    return [torch.tensor(a, device=dev) for a in arrays]


@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("with_active", [False, True])
def test_dequant_mix_dense_kernel_on_random_inputs(dev, with_prev,
                                                   with_active):
    d, sc, ix, va, mx, prev, active = _random_dense_slots(
        2 * with_prev + with_active, 3001, dev)
    prev = prev if with_prev else None
    active = active if with_active else None
    want = bd.dequant_mix_dense_plain(d, (sc, ix, va), mx, prev, active)
    before = kernels.LAUNCHES["dequant_mix_dense"]
    got = bd.dequant_mix_dense(d, (sc, ix, va), mx, prev, active)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dequant_mix_dense"] == before + 1
    assert torch.equal(want, got)
    assert int(want.max()) > 0xFFFF          # sums of duplicates
    # valid and active as bool: the same bytes
    got_b = kernels.dequant_mix_dense(
        d, sc, ix, va.bool(), mx, prev,
        None if active is None else active.bool())
    assert torch.equal(want, got_b)
    with pytest.raises(TypeError, match="int16"):
        kernels.dequant_mix_dense(d, sc, ix.int(), va, mx)


def test_dequant_mix_dense_kernel_on_the_assets(dev):
    streams = [open(p, "rb").read()
               for p in sorted(glob.glob(os.path.join(ASSETS, "*.dcs94")))]
    dense, scale, fb_idx, valid, _ = batched.hybrid_host_stage(streams)
    rng = np.random.default_rng(44)
    S, F = dense.shape[:2]
    t = lambda a: torch.tensor(a, device=dev).reshape(S * F, -1)
    args = [t(a) for a in (dense, scale, fb_idx, valid)]
    mix = torch.tensor(rng.integers(0, 1 << 16, S * F).astype(np.int32),
                       device=dev)
    prev = torch.tensor(rng.integers(0, 1 << 16, (S * F, 512))
                        .astype(np.int32), device=dev)
    for fb_prev in (None, prev):
        want = bd.dequant_mix_dense_plain(args[0], args[1:], mix, fb_prev)
        got = kernels.dequant_mix_dense(*args, mix, fb_prev)
        torch.cuda.synchronize()
        assert torch.equal(want, got)


def test_hybrid_on_the_card_equals_the_plain_path_and_the_cpu(dev, tabs):
    streams = [open(p, "rb").read()
               for p in sorted(glob.glob(os.path.join(ASSETS, "*.dcs94")))]
    host = batched.hybrid_host_stage(streams)
    S, F = host[0].shape[:2]
    rng = np.random.default_rng(45)
    mix = rng.integers(0, 1 << 16, (S, F)).astype(np.int32)
    vol = rng.integers(0, 4, (S, F)).astype(np.int32)
    cpu = batched.hybrid_batch_device(*host[:4], mix, vol, device="cpu")
    before = dict(kernels.LAUNCHES)
    got = batched.hybrid_batch_device(*host[:4], mix, vol)   # to the card
    torch.cuda.synchronize()
    assert _launched(before) == {"dequant_mix_dense": 1,
                                 "transform94_pcm": 1}
    assert got.device == dev
    on_card = [torch.tensor(a, device=dev) for a in (*host[:4], mix, vol)]
    d, sc, ix, va, m, v = (a.reshape(S * F, -1) for a in on_card)
    fb = bd.dequant_mix_dense_plain(d, (sc, ix, va), m.reshape(-1))
    sid = torch.arange(S, dtype=torch.int32, device=dev).repeat_interleave(F)
    plain = tf.transform94_pcm_plain(fb, v.reshape(-1), sid, tabs)
    assert torch.equal(got, plain.reshape(S, F, 240))
    assert torch.equal(got.cpu(), cpu)
    # one stream alone, tensors already on the card
    one = batched.hybrid_stage_device(*(a[2] for a in on_card))
    assert torch.equal(one, got[2])


def test_transform94_kernel_on_edge_frames(dev, tabs):
    rng = np.random.default_rng(31)
    fb = rng.integers(0, 0x10000, size=(2048, 512)).astype(np.int32)
    fb[0, :256] = 0x8000
    fb[1, :256] = 0x7FFF
    fb[2, :258] = 0x8000
    fb[3:64] = rng.choice([0x8000, 0x7FFF, 0, 1, 0xFFFF, 0x4000],
                          size=(61, 512))
    vs = rng.integers(0, 41, size=2048).astype(np.int32)
    fb_t, vs_t = torch.tensor(fb, device=dev), torch.tensor(vs, device=dev)
    want = tf.transform94_planar_plain(fb_t, vs_t, tabs)
    got = kernels.transform94_planar(fb_t, vs_t, tabs["p2_c0"], tabs["p2_c1"],
                                     tabs["cos"], tabs["sin"])
    torch.cuda.synchronize()
    assert all(torch.equal(w, k) for w, k in zip(want, got))


T = kernels.TRANSFORM94_PCM_TILE


@pytest.mark.parametrize("n", [1, T - 1, T, T + 1, 3 * T + 5])
def test_transform94_pcm_kernel_on_edge_frames(dev, tabs, n):
    # saturating and random frames, volume shifts up to 40, and stream ids
    # in runs of one frame, runs that cross tiles, and starts at T-1, T, T+1
    rng = np.random.default_rng(n)
    fb = rng.integers(0, 0x10000, size=(n, 512)).astype(np.int32)
    fb[0:n:5, :256] = 0x8000
    fb[1:n:5, :256] = 0x7FFF
    fb[2:n:5, :258] = 0x8000
    fb[3:n:5] = rng.choice([0x8000, 0x7FFF, 0, 1, 0xFFFF, 0x4000],
                           size=(len(range(3, n, 5)), 512))
    vs = rng.integers(0, 41, size=n).astype(np.int32)
    fb_t, vs_t = torch.tensor(fb, device=dev), torch.tensor(vs, device=dev)
    runs = np.repeat(np.arange(n), rng.integers(1, 2 * T, size=n))[:n]
    layouts = (np.zeros(n), np.arange(n), runs,
               np.searchsorted([T - 1, T, T + 1], np.arange(n), "right"))
    for sid in layouts:
        sid_t = torch.tensor(sid.astype(np.int32), device=dev)
        want = tf.transform94_pcm_plain(fb_t, vs_t, sid_t, tabs)
        got = kernels.transform94_pcm(fb_t, vs_t, sid_t, tabs)
        torch.cuda.synchronize()
        assert torch.equal(want, got)


def test_wrappers_refuse_bad_tensors(dev, tabs):
    fb = torch.zeros((4, 512), dtype=torch.int32, device=dev)
    vs = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        kernels.transform94_planar(fb.long(), vs, tabs["p2_c0"],
                                   tabs["p2_c1"], tabs["cos"], tabs["sin"])
    with pytest.raises(ValueError, match="contiguous"):
        kernels.transform94_planar(fb.t().contiguous().t(), vs,
                                   tabs["p2_c0"], tabs["p2_c1"], tabs["cos"],
                                   tabs["sin"])
    with pytest.raises(ValueError, match="CUDA"):
        kernels.transform94_planar(fb, vs.cpu(), tabs["p2_c0"], tabs["p2_c1"],
                                   tabs["cos"], tabs["sin"])
    sid = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        kernels.transform94_pcm(fb, vs, sid.long(), tabs)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.transform94_pcm(fb.t().contiguous().t(), vs, sid, tabs)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.transform94_pcm(fb, vs, sid.cpu(), tabs)
    with pytest.raises(ValueError, match="shape"):
        kernels.transform94_pcm(fb, vs, sid[:3], tabs)
    skewed = torch.zeros(4 * 512 + 1, dtype=torch.int32, device=dev)[1:]
    with pytest.raises(ValueError, match="aligned"):
        kernels.transform94_pcm(skewed.view(4, 512), vs, sid, tabs)
    cols = _random_catalog(64, 0, dev)
    cols["pool_u8"] = torch.zeros(41, dtype=torch.uint8, device=dev)[1:]
    with pytest.raises(ValueError, match="aligned"):
        kernels.decode94_fb(**cols, n_steps=8, tabs=tabs)


def test_sweep_on_the_card_equals_the_cpu_sweep(dev):
    streams = [open(p, "rb").read()
               for p in sorted(glob.glob(os.path.join(ASSETS, "*.dcs94")))]
    arrays = fs.FlatSweep(streams).pack().compact_host_arrays()
    before = dict(kernels.LAUNCHES)
    got = fs.FlatPipeline()(**fs.packed_to_device(arrays))
    torch.cuda.synchronize()
    launched = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    want = fs.FlatPipeline("cpu")(**fs.packed_to_device(arrays, "cpu"))
    assert torch.equal(want, got.cpu())
    assert launched == _launch_counts(decode94_fb=1, transform94_pcm=1)


# -- the session path --------------------------------------------------------


@pytest.mark.parametrize("C", [1, 6, 8])
def test_session_mix94_kernel_on_random_rows(dev, C):
    # random bank rows over the whole u16 range (row 0 silent), rows that
    # include 0, mixes over the whole u16 range, frames past a block's end
    g = torch.Generator(device=dev).manual_seed(C)
    R, F = 3000, 2 * 8 * 97 + 3
    bank = torch.randint(-(1 << 15), 1 << 15, (R, 256), generator=g,
                         device=dev, dtype=torch.int32).to(torch.int16)
    bank[0] = 0
    bank[1] = -(1 << 15)
    bank[2] = (1 << 15) - 1
    rows = torch.randint(0, R, (F, C), generator=g, device=dev,
                         dtype=torch.int32)
    rows[torch.rand((F, C), generator=g, device=dev) < 0.3] = 0
    rows[:8] = torch.arange(8, device=dev, dtype=torch.int32)[:, None] % 3
    mix = torch.randint(0, 1 << 16, (F, C), generator=g, device=dev,
                        dtype=torch.int32)
    mix[:4, 0] = torch.tensor([0, 0xFFFF, 0x8000, 0x7FFF], device=dev,
                              dtype=torch.int32)
    want = bd.session_mix94_plain(bank, rows, mix)
    got = kernels.session_mix94(bank, rows, mix)
    torch.cuda.synchronize()
    assert torch.equal(want, got)


def _segment_wire(S, T, C, E, seed):
    """A random control wire: per lane up to E segments with sorted starts
    from frame 0, random bases, slopes 0/1 and mixes over the u16 range."""
    rng = np.random.default_rng(seed)
    f0 = np.full((S, C, E), 0xFFFF, np.int64)
    for s in range(S):
        for c in range(C):
            n = int(rng.integers(1, min(E, T) + 1))
            f0[s, c, :n] = np.sort(np.concatenate(
                [[0], rng.choice(np.arange(1, T), n - 1, replace=False)]))
    comp = dict(f0=f0.astype(np.uint16),
                base=rng.integers(0, 60000, (S, C, E)).astype(np.uint16),
                slope=rng.integers(0, 2, (S, C, E)).astype(np.uint8),
                mixv=rng.integers(0, 1 << 16, (S, C, E)).astype(np.uint16))
    vol = rng.integers(0, 256, (S, T)).astype(np.uint8)
    return romplay.pack_controls_wire(comp, vol)


@pytest.mark.parametrize("E", [1, 4, 255])
def test_segments94_kernel_on_random_tables(dev, E):
    for S, T, C in ((5, 300, 6), (3, 1000, 8), (2, 7, 1)):
        wire = torch.tensor(_segment_wire(S, T, C, E, E + C), device=dev)
        want = romplay.segments94_plain(wire, S, T, C, E)
        got = kernels.segments94(wire, S, T, C, E)
        torch.cuda.synchronize()
        assert all(torch.equal(w, k) for w, k in zip(want, got)), (S, T, C)


def _tied_wire(S, T, C, E, seed):
    """A control wire with the entries segments94's design turns on: equal
    f0 entries (the last of them counts), lanes of one segment with $FFFF
    after it, lanes whose first segment starts after frame 0 (segment 0
    stands in before it), slopes over the u8 range, bases over u16."""
    rng = np.random.default_rng(seed)
    f0 = np.full((S, C, E), 0xFFFF, np.int64)
    n = rng.integers(1, E + 1, size=(S, C))
    n[rng.random((S, C)) < 0.2] = 1
    for s in range(S):
        for c in range(C):
            k = int(n[s, c])
            f0[s, c, :k] = np.sort(rng.integers(0, T, size=k))
            if rng.random() < 0.7:
                f0[s, c, 0] = 0
    comp = dict(f0=f0.astype(np.uint16),
                base=rng.integers(0, 1 << 16, (S, C, E)).astype(np.uint16),
                slope=rng.integers(0, 256, (S, C, E)).astype(np.uint8),
                mixv=rng.integers(0, 1 << 16, (S, C, E)).astype(np.uint16))
    vol = rng.integers(0, 256, (S, T)).astype(np.uint8)
    return romplay.pack_controls_wire(comp, vol)


@pytest.mark.parametrize("C", range(1, 9))
@pytest.mark.parametrize("E", [1, 32, 255])
def test_segments94_kernel_on_tied_and_unused_entries(dev, C, E):
    # frame counts that are not a multiple of 4 (a thread's frames cross
    # sessions) or are under 4, one session, and over a thousand sessions
    for S, T in ((1, 1), (1, 1003), (3, 7), (2, 2), (1001, 13), (4, 256)):
        wire = torch.tensor(_tied_wire(S, T, C, E, 1000 * E + 10 * C + S),
                            device=dev)
        want = romplay.segments94_plain(wire, S, T, C, E)
        got = kernels.segments94(wire, S, T, C, E)
        torch.cuda.synchronize()
        assert all(torch.equal(w, k) for w, k in zip(want, got)), (S, T)


def _wide_tied_wire(S, T, C, E, seed):
    """A wide control wire (u32 bases) with _tied_wire's entries, its bases
    over the whole 24-bit range and most near 2^24 (the largest, 2^24 - 1,
    in every lane's first entry of session 0)."""
    rng = np.random.default_rng(seed)
    f0 = np.full((S, C, E), 0xFFFF, np.int64)
    n = rng.integers(1, E + 1, size=(S, C))
    n[rng.random((S, C)) < 0.2] = 1
    for s in range(S):
        for c in range(C):
            k = int(n[s, c])
            f0[s, c, :k] = np.sort(rng.integers(0, T, size=k))
            if rng.random() < 0.7:
                f0[s, c, 0] = 0
    base = rng.integers((1 << 24) - (1 << 17), 1 << 24, (S, C, E))
    low = rng.random((S, C, E)) < 0.3
    base[low] = rng.integers(0, 1 << 24, int(low.sum()))
    base[0, :, 0] = (1 << 24) - 1
    comp = dict(f0=f0.astype(np.uint16), base=base.astype(np.uint32),
                slope=rng.integers(0, 256, (S, C, E)).astype(np.uint8),
                mixv=rng.integers(0, 1 << 16, (S, C, E)).astype(np.uint16))
    vol = rng.integers(0, 256, (S, T)).astype(np.uint8)
    return romplay.pack_controls_wire(comp, vol)


@pytest.mark.parametrize("C", [1, 6, 8])
@pytest.mark.parametrize("E", [1, 32, 255])
def test_segments94_rows32_kernel_on_rows_near_2_24(dev, C, E):
    for S, T in ((1, 1), (1, 1003), (3, 7), (1001, 13), (4, 256)):
        wire = torch.tensor(_wide_tied_wire(S, T, C, E, 7 * E + C + S),
                            device=dev)
        before = kernels.LAUNCHES["segments94_rows32"]
        want = romplay.segments94_plain(wire, S, T, C, E)
        got = kernels.segments94(wire, S, T, C, E)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["segments94_rows32"] == before + 1
        assert all(torch.equal(w, k) for w, k in zip(want, got)), (S, T)
    with pytest.raises(ValueError, match="shape"):
        kernels.segments94(wire[:-1], S, T, C, E)


def _title_batch(n_tracks, S, T):
    """S sessions of a title whose tracks 1..n_tracks play on channel
    (track - 1) mod 6: each voice starts a track of its channel at two
    frames, the title's last tracks among them, at a master volume of its
    own."""
    per = n_tracks // 6
    events = []
    for s in range(S):
        ev = {0: [0x55, 0xAA, 0x48 + s, (0x48 + s) ^ 0xFF]}
        for v in range(6):
            for k, f in enumerate(((s * 7 + v * 3) % 40, 150 + s)):
                j = per - 1 - (5 * s + 3 * k + v) % per
                track = 1 + v + 6 * j
                ev.setdefault(f, []).extend([track >> 8, track & 0xFF])
        events.append(ev)
    return events


def test_session_server_on_a_full_title_equals_its_plain_path(dev):
    # the eight-chip title's bank is past 64Ki rows: the wide wire, one
    # segments94_rows32 launch a batch; rom94.zip's stays on the u16 wire
    for name, wide in (("os94full/rom94full.zip", True), ("rom94.zip", False)):
        rs, _ = zipload.load_zip_file(os.path.join(REPO, "dcsbench", "data",
                                                   name))
        assert rs.check() == 1
        S, T = 8, 300
        events = _title_batch(rs.n_tracks - 1, S, T)
        bank = romplay.build_rom_bank(rs)
        before = dict(kernels.LAUNCHES)
        with romplay.SessionServer(rs, S, T, n_ch=6, bank=bank) as srv:
            assert srv.wide == wide
            got = srv.serve_one(events)
        launched = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        with romplay.SessionServer(rs, S, T, n_ch=6, bank=bank) as srv:
            want = _plain_serve_one(srv, events)
        assert np.array_equal(want, got) and np.abs(got).max() > 0
        assert {k: v for k, v in launched.items() if v} == {
            ("segments94_rows32" if wide else "segments94"): 1,
            "session_mix94": 1, "transform94_pcm": 1}


@pytest.mark.parametrize("n", [1, T - 1, T + 1, 5 * T + 3])
def test_transform94_pcm_kernel_carries_overlap(dev, tabs, n):
    # random carried states; sessions of 1 frame, sessions crossing tiles,
    # session starts at tile edges, ids with no frames (they keep theirs)
    rng = np.random.default_rng(n + 7)
    fb = torch.tensor(rng.integers(0, 0x10000, size=(n, 512))
                      .astype(np.int32), device=dev)
    vs = torch.tensor(rng.integers(0, 41, size=n).astype(np.int32),
                      device=dev)
    runs = np.repeat(np.arange(n), rng.integers(1, 2 * T, size=n))[:n]
    edges = np.searchsorted([T - 1, T, T + 1, 2 * T], np.arange(n), "right")
    for sid in (np.zeros(n), np.arange(n), 2 * runs, 3 * edges + 1):
        G = int(sid.max()) + 3
        ov0 = torch.tensor(rng.integers(0, 0x10000, size=(G, 16))
                           .astype(np.int32), device=dev)
        sid_t = torch.tensor(sid.astype(np.int32), device=dev)
        want = tf.transform94_pcm_plain(fb, vs, sid_t, tabs, ov0)
        got = kernels.transform94_pcm(fb, vs, sid_t, tabs, ov0)
        torch.cuda.synchronize()
        assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
        assert torch.equal(got[1][-1], ov0[-1])
    # no carry: the flat sweep's result, unchanged
    assert torch.equal(kernels.transform94_pcm(fb, vs, sid_t, tabs),
                       tf.transform94_pcm_plain(fb, vs, sid_t, tabs))


def _bank_columns(dev):
    bank = pipeline.StreamBank(rd.OS94)
    for p in sorted(glob.glob(os.path.join(ASSETS, "*.dcs94"))):
        bank.add(open(p, "rb").read())
    cols = bank.columns()
    n_steps = cols.pop("n_steps")
    return {k: torch.tensor(v, device=dev) for k, v in cols.items()}, n_steps


def test_decode94_bank_kernel_on_the_assets(dev, tabs):
    cols, n_steps = _bank_columns(dev)
    want = bd.decode94_bank_plain(**cols, n_steps=n_steps, tabs=tabs)
    got = kernels.decode94_bank(**cols, n_steps=n_steps, tabs=tabs)
    torch.cuda.synchronize()
    assert got.shape == (cols["sid"].shape[0] + 1, 256)
    assert torch.equal(want, got)


@pytest.mark.parametrize("n_steps", [256, 100, 0])
def test_decode94_bank_kernel_on_random_streams(dev, tabs, n_steps):
    cols = _random_catalog(2051, n_steps + 1, dev)
    del cols["mix"]
    want = bd.decode94_bank_plain(**cols, n_steps=n_steps, tabs=tabs)
    got = kernels.decode94_bank(**cols, n_steps=n_steps, tabs=tabs)
    torch.cuda.synchronize()
    assert torch.equal(want, got)


def test_decode94_bank_kernel_on_the_session6_bank(dev, tabs):
    rs, _ = zipload.load_zip_file(SESSION6_ZIP)
    rs.check()
    bank = romplay.build_rom_bank(rs, dev)
    cols = bank.columns()
    n_steps = cols.pop("n_steps")
    cols = {k: torch.tensor(v, device=dev) for k, v in cols.items()}
    want = bd.decode94_bank_plain(**cols, n_steps=n_steps, tabs=tabs)
    torch.cuda.synchronize()
    assert bank.scaled.shape == (2778, 256)
    assert torch.equal(want, bank.scaled)


@pytest.mark.parametrize("n_steps", [256, 100, 0])
def test_decode94_bank_kernel_at_the_session6_size(dev, tabs, n_steps):
    # random streams in as many frames as session6's bank (22 blocks)
    cols = _random_catalog(2777, 10 + n_steps, dev)
    del cols["mix"]
    want = bd.decode94_bank_plain(**cols, n_steps=n_steps, tabs=tabs)
    got = kernels.decode94_bank(**cols, n_steps=n_steps, tabs=tabs)
    torch.cuda.synchronize()
    assert torch.equal(want, got)


def test_decode94_bank_kernel_on_a_pool_ending_mid_window(dev, tabs):
    # 4k + 3 pool bytes: the last frames read past the pool's end
    cols = _random_catalog(1024, 6, dev, pool_len=403, bt_max=20)
    del cols["mix"]
    cols["start_bit"] = torch.clamp(cols["start_bit"], min=403 * 8 - 300)
    want = bd.decode94_bank_plain(**cols, n_steps=256, tabs=tabs)
    got = kernels.decode94_bank(**cols, n_steps=256, tabs=tabs)
    torch.cuda.synchronize()
    assert torch.equal(want, got)


@pytest.mark.parametrize("kernel", ["decode94_fb", "decode94_bank"])
def test_decode94_kernels_on_warps_that_end_early(dev, tabs, kernel):
    # most streams' band lists end at band 0..3 (a $7F terminator), so
    # whole warps stop their walk long before n_steps, beside warps that
    # run to it
    cols = _random_catalog(4099, 77, dev)
    rng = np.random.default_rng(78)
    S = cols["hdr_tab"].shape[0]
    cut = torch.tensor(rng.integers(0, 4, S), device=dev)
    short = torch.tensor(rng.random(S) < 0.6, device=dev)
    band = torch.arange(16, device=dev)
    cols["hdr_tab"][short[:, None] & (band[None, :] == cut[:, None])] = 0x7F
    if kernel == "decode94_bank":
        del cols["mix"]
    want = getattr(bd, kernel + "_plain")(**cols, n_steps=256, tabs=tabs)
    got = getattr(kernels, kernel)(**cols, n_steps=256, tabs=tabs)
    torch.cuda.synchronize()
    assert torch.equal(want, got)


@pytest.mark.parametrize("kernel", ["decode94_fb", "decode94_bank"])
def test_decode94_kernels_on_frames_laid_out_in_order(dev, tabs, kernel):
    # random frames that follow each other in the pool, as a catalog's do,
    # so a block's stretch of the pool fits in shared memory; a few frames
    # jump far ahead, so some blocks in the same launch read it from
    # global memory; the last frames run past the pool's end
    cols = _random_catalog(4099, 91, dev, pool_len=300_003)
    rng = np.random.default_rng(92)
    gaps = rng.integers(0, 900, size=4099)
    gaps[rng.random(4099) < 0.002] = 200_000
    start = np.minimum(np.cumsum(gaps), 300_003 * 8 - 100)
    cols["start_bit"] = torch.tensor(start.astype(np.int32), device=dev)
    if kernel == "decode94_bank":
        del cols["mix"]
    want = getattr(bd, kernel + "_plain")(**cols, n_steps=256, tabs=tabs)
    got = getattr(kernels, kernel)(**cols, n_steps=256, tabs=tabs)
    torch.cuda.synchronize()
    assert torch.equal(want, got)


def test_decode94_wrappers_refuse_a_pool_of_2_28_bytes(dev, tabs):
    # the walk's bit cursor is 32-bit
    cols = _random_catalog(64, 0, dev)
    cols["pool_u8"] = torch.zeros(1 << 28, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="2\\^28"):
        kernels.decode94_fb(**cols, n_steps=8, tabs=tabs)
    del cols["mix"]
    with pytest.raises(ValueError, match="2\\^28"):
        kernels.decode94_bank(**cols, n_steps=8, tabs=tabs)


def test_session_wrappers_refuse_bad_tensors(dev, tabs):
    bank = torch.zeros((5, 256), dtype=torch.int16, device=dev)
    rows = torch.zeros((4, 6), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        kernels.session_mix94(bank.int(), rows, rows)
    nine = torch.zeros((4, 9), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="channels"):
        kernels.session_mix94(bank, nine, nine)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.session_mix94(bank, rows.cpu(), rows)
    wire = torch.zeros(7 * 2 * 6 * 4 + 2 * 16, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="shape"):
        kernels.segments94(wire[1:], 2, 16, 6, 4)
    with pytest.raises(ValueError, match="segments"):
        kernels.segments94(wire, 2, 16, 6, 256)
    fb = torch.zeros((4, 512), dtype=torch.int32, device=dev)
    vs = sid = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shape"):
        kernels.transform94_pcm(fb, vs, sid, tabs,
                                torch.zeros((2, 8), dtype=torch.int32,
                                            device=dev))
    cols = _random_catalog(64, 0, dev)
    del cols["mix"]
    cols["bt_u8"] = cols["bt_u8"].int()
    with pytest.raises(TypeError):
        kernels.decode94_bank(**cols, n_steps=8, tabs=tabs)


def test_session_server_on_the_card_equals_the_cpu_server(dev):
    rs, _ = zipload.load_zip_file(SESSION6_ZIP)
    S, T = 5, 150
    batches = [[{(b * 7 + t * 3) % 40: [0x00, t] for t in range(1, 7)}
                | {0: [0x55, 0xAA, 0x40 + b, (0x40 + b) ^ 0xFF]}
                for b in range(k * S, k * S + S)] for k in range(3)]
    before = dict(kernels.LAUNCHES)
    with romplay.SessionServer(rs, S, T, n_ch=6, depth=2) as srv:
        got = list(srv.serve(batches))
    launched = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    with romplay.SessionServer(rs, S, T, n_ch=6, device="cpu") as srv:
        want = list(srv.serve(batches))
    assert len(got) == len(want) == 3
    assert all(np.array_equal(w, g) for w, g in zip(want, got))
    # a served batch starts each session from a zero state: no carry
    assert launched == _launch_counts(decode94_bank=1, segments94=3,
                                      session_mix94=3, transform94_pcm=3)


# -- the 1993 family -----------------------------------------------------------

@pytest.fixture(scope="module")
def tabs93(dev):
    return {k: v.to(dev) for k, v in cs.codec_tables93().items()}


@pytest.fixture(scope="module")
def rom93(dev):
    rs, _ = zipload.load_zip_file(SESSION93A_ZIP)
    assert rs.check() == 1
    return rs, romplay.build_rom_bank(rs, dev)


@pytest.fixture(scope="module")
def cols93(dev, rom93):
    """session93a.zip's bank columns on the card (the bank keeps them on
    the host)."""
    return {k: v.to(dev) for k, v in rom93[1].cols.items()}


def _flat93_columns(t1, dev):
    streams = [open(os.path.join(ASSETS, n), "rb").read()
               for n in WIRES93[t1]]
    return cs.packed93_to_device(cs.Flat93Sweep(streams, t1)
                                 .compact_host_arrays(), dev)


def _decode93_both(cols, rows, mix, tabs93):
    want = d93.decode93_fb_plain(cols, rows, mix, tabs93)
    got = kernels.decode93_fb(*(cols[k] for k in d93.COLUMNS), rows, mix,
                              tabs93["pair"], tabs93["inputs"])
    torch.cuda.synchronize()
    return want, got


@pytest.mark.parametrize("t1", [False, True])
def test_decode93_fb_kernel_on_the_flat_assets(dev, tabs93, t1):
    cols = _flat93_columns(t1, dev)
    want, got = _decode93_both(cols, None, cols["mix"], tabs93)
    assert got.shape == (cols["frame_word"].shape[0], 512)
    assert torch.equal(want, got)


def _random_columns(bank_cols, seed):
    """The bank's columns with random chain states on every row and random
    93a scale codes (the chains and ramps over the whole u16 range, scale
    words up to $D745 << 14)."""
    g = torch.Generator(device=bank_cols["prv"].device).manual_seed(seed)
    cols = dict(bank_cols)
    dev = cols["prv"].device
    cols["prv"] = torch.randint(-(1 << 31), (1 << 31) - 1,
                                tuple(cols["prv"].shape), generator=g,
                                device=dev, dtype=torch.int32)
    code = torch.randint(0, 60, tuple(cols["code_u8"].shape), generator=g,
                         device=dev, dtype=torch.int32)
    cols["code_u8"] = torch.where(cols["code_u8"] == 0xFF, 0xFF,
                                  code).to(torch.uint8)
    return cols


@pytest.mark.parametrize("C", [1, 6, 8])
def test_decode93_fb_kernel_on_random_rows(dev, tabs93, rom93, cols93, C):
    # rows of both kinds and row 0 in every voice, mixes over the u16
    # range, frames past a block's end; the bank's own columns and random
    # chain states and scale codes
    bank = rom93[1]
    g = torch.Generator(device=dev).manual_seed(C)
    F, R = 2 * 8 * 97 + 3, bank.total_rows()
    rows = torch.randint(0, R, (F, C), generator=g, device=dev,
                         dtype=torch.int32)
    rows[torch.rand((F, C), generator=g, device=dev) < 0.2] = 0
    rows[:16] = 0                                   # all-silent frames
    mix = torch.randint(0, 1 << 16, (F, C), generator=g, device=dev,
                        dtype=torch.int32)
    mix[16:20, 0] = torch.tensor([0, 0xFFFF, 0x8000, 0x7FFF], device=dev,
                                 dtype=torch.int32)
    for cols in (cols93, _random_columns(cols93, C)):
        want, got = _decode93_both(cols, rows, mix, tabs93)
        assert torch.equal(want, got)
        assert not got[:16].any()


def test_decode93_fb_kernel_on_silent_bands_and_a_short_pool(dev, tabs93):
    # every 93 band K_NONE on some frames, and a pool that ends inside the
    # last frames (bits past it read as $FF)
    cols = dict(_flat93_columns(False, dev))
    kw = cols["kw_u8"].clone()
    kw[::7] = 0
    cols["kw_u8"] = kw
    F = cols["frame_word"].shape[0]
    cut = int(cols["frame_word"][F - 3]) * 4 + 37
    cols["pool_u8"] = cols["pool_u8"][:cut].clone()
    want, got = _decode93_both(cols, None, cols["mix"], tabs93)
    assert torch.equal(want, got)
    t1 = dict(_flat93_columns(True, dev))
    F = t1["frame_word"].shape[0]
    t1["pool_u8"] = t1["pool_u8"][:int(t1["frame_word"][F - 2]) * 4 + 5] \
        .clone()
    want, got = _decode93_both(t1, None, t1["mix"], tabs93)
    assert torch.equal(want, got)


T93 = kernels.TRANSFORM93_PCM_TILE


@pytest.mark.parametrize("n", [1, T93 - 1, T93 + 1, 3 * T93 + 5])
def test_transform93_pcm_kernel_on_edge_frames(dev, tabs93, n):
    # saturating and random frames, volume shifts up to 40, stream ids in
    # runs of one frame, runs across tiles and starts at the tile edges;
    # flat, and with random carried states (ids with no frames keep theirs)
    rng = np.random.default_rng(n)
    fb = rng.integers(0, 0x10000, size=(n, 512)).astype(np.int32)
    fb[0:n:5, :256] = 0x8000
    fb[1:n:5, :256] = 0x7FFF
    fb[2:n:5, :2] = 0
    fb[3:n:5] = rng.choice([0x8000, 0x7FFF, 0, 1, 0xFFFF, 0x4000],
                           size=(len(range(3, n, 5)), 512))
    vs = rng.integers(0, 41, size=n).astype(np.int32)
    fb_t, vs_t = torch.tensor(fb, device=dev), torch.tensor(vs, device=dev)
    runs = np.repeat(np.arange(n), rng.integers(1, 2 * T93, size=n))[:n]
    edges = np.searchsorted([T93 - 1, T93, T93 + 1], np.arange(n), "right")
    for sid in (np.zeros(n), np.arange(n), runs, 2 * edges + 1):
        sid_t = torch.tensor(sid.astype(np.int32), device=dev)
        want = tf.transform93_pcm_plain(fb_t, vs_t, sid_t, tabs93)
        got = kernels.transform93_pcm(fb_t, vs_t, sid_t, tabs93)
        torch.cuda.synchronize()
        assert torch.equal(want, got)
        G = int(sid.max()) + 3
        ov0 = torch.tensor(rng.integers(0, 0x10000, size=(G, 16))
                           .astype(np.int32), device=dev)
        want = tf.transform93_pcm_plain(fb_t, vs_t, sid_t, tabs93, ov0)
        got = kernels.transform93_pcm(fb_t, vs_t, sid_t, tabs93, ov0)
        torch.cuda.synchronize()
        assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
        assert torch.equal(got[1][-1], ov0[-1])


def test_1993_wrappers_refuse_bad_tensors(dev, tabs93):
    fb = torch.zeros((4, 512), dtype=torch.int32, device=dev)
    vs = sid = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        kernels.transform93_pcm(fb.long(), vs, sid, tabs93)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.transform93_pcm(fb.t().contiguous().t(), vs, sid, tabs93)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.transform93_pcm(fb, vs, sid.cpu(), tabs93)
    with pytest.raises(ValueError, match="shape"):
        kernels.transform93_pcm(fb, vs, sid[:3], tabs93)
    with pytest.raises(ValueError, match="shape"):
        kernels.transform93_pcm(fb, vs, sid, tabs93,
                                torch.zeros((2, 8), dtype=torch.int32,
                                            device=dev))
    skewed = torch.zeros(4 * 512 + 1, dtype=torch.int32, device=dev)[1:]
    with pytest.raises(ValueError, match="aligned"):
        kernels.transform93_pcm(skewed.view(4, 512), vs, sid, tabs93)
    cols = _flat93_columns(False, dev)
    args = [cols[k] for k in d93.COLUMNS]

    def decode(args, rows=None, mix=cols["mix"]):
        return kernels.decode93_fb(*args, rows, mix, tabs93["pair"],
                                   tabs93["inputs"])

    bad = list(args)
    bad[0] = cols["pool_u8"][1:]
    with pytest.raises(ValueError, match="aligned"):
        decode(bad)
    bad = list(args)
    bad[4] = cols["kind_u8"].int()
    with pytest.raises(TypeError):
        decode(bad)
    with pytest.raises(ValueError, match="shape"):
        decode(args, mix=cols["mix"][1:])
    nine = torch.zeros((4, 9), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="channels"):
        decode(args, nine, nine)
    with pytest.raises(ValueError, match="CUDA"):
        decode(args, mix=cols["mix"].cpu())


def test_flat93_sweep_on_the_card_equals_the_cpu_sweep(dev):
    for t1 in (False, True):
        streams = [open(os.path.join(ASSETS, n), "rb").read()
                   for n in WIRES93[t1]]
        arrays = cs.Flat93Sweep(streams, t1).compact_host_arrays()
        before = dict(kernels.LAUNCHES)
        got = cs.Flat93Pipeline()(**cs.packed93_to_device(arrays))
        torch.cuda.synchronize()
        launched = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        want = cs.Flat93Pipeline("cpu")(**cs.packed93_to_device(arrays,
                                                                "cpu"))
        assert torch.equal(want, got.cpu())
        assert {k: v for k, v in launched.items() if v} == {
            "decode93_pcm": 1}


def test_1993_session_server_on_the_card_equals_the_cpu_server(dev, rom93):
    rs, bank = rom93
    S, T = 5, 150
    batches = [[{(b * 7 + t * 3) % 40: [0x00, t] for t in range(1, 7)}
                | {0: [0x55, 0xAA, 0x40 + b, (0x40 + b) ^ 0xFF]}
                for b in range(k * S, k * S + S)] for k in range(3)]
    before = dict(kernels.LAUNCHES)
    with romplay.SessionServer(rs, S, T, n_ch=6, depth=2, bank=bank) as srv:
        got = list(srv.serve(batches))
    launched = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    cpu_bank = romplay.build_rom_bank(rs, "cpu")
    with romplay.SessionServer(rs, S, T, n_ch=6, bank=cpu_bank,
                               device="cpu") as srv:
        want = list(srv.serve(batches))
    assert len(got) == len(want) == 3
    assert all(np.array_equal(w, g) for w, g in zip(want, got))
    assert all(np.abs(g).max() > 0 for g in got)
    assert {k: v for k, v in launched.items() if v} == {
        "segments94": 3, "decode93_pcm": 3}
    # a single session carries its overlap state: the carry instance
    before = kernels.LAUNCHES["decode93_pcm_carry"]
    one, _ = romplay.play_session(
        rs, {f: (lambda d, bs=tuple(bs): [d.write_data_port(x) for x in bs])
             for f, bs in batches[0][0].items()}, T, bank=bank)
    assert kernels.LAUNCHES["decode93_pcm_carry"] == before + 1
    assert np.array_equal(one, got[0][0])


# -- the fused 1993 kernel (decode93_pcm) ------------------------------------

def _session_bank(cols, tabs93):
    """The session bank of the columns on the card, held against its plain
    version; one decode93_bank launch."""
    before = kernels.LAUNCHES["decode93_bank"]
    bank = d93.decode93_bank(cols, tabs93)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["decode93_bank"] == before + 1
    want = d93.decode93_bank_plain(cols, tabs93)
    assert torch.equal(want["words93"], bank["words93"])
    assert torch.equal(want["kind93"], bank["kind93"])
    return bank


def _decode93_pcm_both(cols, rows, mix, vol, sid, tabs93, ov0=None):
    """(plain, kernel) pairs of decode93_pcm against decode93_pcm_plain on
    the columns: rows None, the columns' instance (the flat sweep); rows
    given, the session instance on the columns' session bank (the bank
    built first, outside the launches counted: one decode93_pcm launch, or
    decode93_pcm_carry with ov0, and none of decode93_bank a batch)."""
    want = d93.decode93_pcm_plain(cols, rows, mix, vol, sid, tabs93, ov0)
    if rows is None:
        assert ov0 is None
        got = kernels.decode93_pcm(*(cols[k] for k in d93.COLUMNS), mix, vol,
                                   sid, tabs93)
    else:
        bank = _session_bank(cols, tabs93)
        before = dict(kernels.LAUNCHES)
        got = d93.session93_pcm(bank, rows, mix, vol, sid, tabs93, ov0)
        key = "decode93_pcm" if ov0 is None else "decode93_pcm_carry"
        assert _launched(before) == {key: 1}
    torch.cuda.synchronize()
    if ov0 is None:
        return [(want, got)]
    assert torch.equal(got[1][-1], ov0[-1])          # an id with no frames
    return list(zip(want, got))


@pytest.mark.parametrize("t1", [False, True])
def test_decode93_pcm_kernel_on_the_flat_assets(dev, tabs93, t1):
    cols = _flat93_columns(t1, dev)
    for want, got in _decode93_pcm_both(cols, None, cols["mix"], cols["vol"],
                                        cols["sid"], tabs93):
        assert got.shape == (cols["frame_word"].shape[0], 240)
        assert torch.equal(want, got)


def _random_kinds(cols, seed, silent=0.0):
    """Every 93 band kind and width 1..24 at random on the 93 rows, and
    K_NONE on a further share ``silent`` of the bands (0.6: most rows have
    at most 8 bands with samples, the kernel's 4-lanes-a-band layout)."""
    g = torch.Generator(device=cols["kw_u8"].device).manual_seed(seed)
    dev = cols["kw_u8"].device
    R = cols["kw_u8"].shape[0]
    kw = cols["kw_u8"].long()
    kind = torch.randint(0, 6, (R, 16), generator=g, device=dev)
    kind[torch.rand((R, 16), generator=g, device=dev) < silent] = 0
    w = torch.randint(1, 25, (R, 16), generator=g, device=dev)
    is93 = (cols["kind_u8"] == d93.ROW_93)[:, None]
    kw[:, :16] = torch.where(is93, kind << 5 | w, kw[:, :16])
    return dict(cols, kw_u8=kw.to(torch.uint8))


T93P = kernels.DECODE93_PCM_TILE


@pytest.mark.parametrize("C", [1, 2, 3, 6, 8])
@pytest.mark.parametrize("n", [1, T93P - 1, T93P, T93P + 1, 65, 197])
def test_decode93_pcm_kernel_on_random_rows(dev, tabs93, rom93, cols93, C,
                                           n):
    # rows of both kinds and row 0 in every voice, mixes over the u16 range;
    # the bank's columns, random chain states and scale codes, and random
    # band kinds, most of them silent or not; sessions of one frame, runs
    # that cross the kernel's tile (the halo frame is decoded again) and
    # starts at its edges; flat and with random carried states
    bank = rom93[1]
    g = torch.Generator(device=dev).manual_seed(C * 1000 + n)
    R = bank.total_rows()
    rows = torch.randint(0, R, (n, C), generator=g, device=dev,
                         dtype=torch.int32)
    rows[torch.rand((n, C), generator=g, device=dev) < 0.2] = 0
    rows[:1] = 0                                     # an all-silent frame
    mix = torch.randint(0, 1 << 16, (n, C), generator=g, device=dev,
                        dtype=torch.int32)
    vol = torch.randint(0, 41, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    rng = np.random.default_rng(C * 1000 + n)
    runs = np.repeat(np.arange(n), rng.integers(1, 2 * T93P, size=n))[:n]
    edges = np.searchsorted([T93P - 1, T93P, T93P + 1], np.arange(n),
                            "right")
    rand = _random_columns(cols93, C)
    for cols in (cols93, rand, _random_kinds(rand, C),
                 _random_kinds(rand, C, 0.6)):
        for sid in (np.zeros(n), np.arange(n), runs, 2 * edges + 1):
            sid_t = torch.tensor(sid.astype(np.int32), device=dev)
            G = int(sid.max()) + 3
            ov0 = torch.tensor(rng.integers(0, 0x10000, size=(G, 16))
                               .astype(np.int32), device=dev)
            for o in (None, ov0):
                for want, got in _decode93_pcm_both(cols, rows, mix, vol,
                                                    sid_t, tabs93, o):
                    assert torch.equal(want, got)


def _far_fields(cols, seed):
    """The columns with half the rows' fields moved to the pool's end: such
    a row's first band starts 0..127 bits before its last whole word ends,
    so that its fields cross the end (bits past it read as $FF)."""
    g = torch.Generator(device=cols["bit_rel"].device).manual_seed(seed)
    dev = cols["bit_rel"].device
    R = cols["bit_rel"].shape[0]
    end = cols["pool_u8"].numel() // 4 * 32
    rel = cols["bit_rel"].long()
    far = end - 32 * cols["frame_word"].long() - rel[:, 0] - torch.randint(
        0, 128, (R,), generator=g, device=dev)
    far[torch.rand(R, generator=g, device=dev) < 0.5] = 0
    return dict(cols, bit_rel=(rel + far.clamp(min=0)[:, None])
                .to(torch.int32))


def _order_rule_inputs(cols, C, dev):
    """Rows, mixes and columns whose voices hit the order rules of the
    kernel's fold of their partials, made with numpy from C: random rows of
    both kinds; every 93 band kind and width at random over random chain
    states, mixes at $FFFF or $8001, so that word 1 wraps and the
    first-sample fix-up saturates; Type-1 scale code 56 and mixes of $8000,
    so that eff is $2000 and every product of a pair-table value = 2 mod 4
    ties."""
    rng = np.random.default_rng(200 + C)
    F, R = 16 * T93P + 7, cols["kind_u8"].shape[0]
    t = lambda a, dt=torch.int32: torch.tensor(a, dtype=dt, device=dev)
    kind_row = cols["kind_u8"].cpu().numpy()
    kw = cols["kw_u8"].cpu().numpy().astype(np.int64)
    kw[:, :16] = np.where(kind_row[:, None] == d93.ROW_93,
                          rng.integers(0, 6, (R, 16)) << 5
                          | rng.integers(1, 25, (R, 16)), kw[:, :16])
    code = cols["code_u8"].cpu().numpy()
    out = dict(cols, kw_u8=t(kw, torch.uint8),
               code_u8=t(np.where(code == 0xFF, 0xFF, 56), torch.uint8),
               prv=t(rng.integers(-(1 << 31), 1 << 31, (R, 16))))
    rows = rng.integers(1, R, (F, C))
    mix = np.where(kind_row[rows] == d93.ROW_93A, 0x8000,
                   rng.choice([0xFFFF, 0x8001], (F, C)))
    return out, t(rows), t(mix), t(rng.integers(0, 41, F)), rng


@pytest.mark.parametrize("C", range(2, 9))
def test_decode93_pcm_folds_on_ties_and_saturating_fixups(
        dev, tabs93, cols93, monkeypatch, C):
    # the folds' order rules (_order_rule_inputs): Type-1 ties on the
    # running word and 93 fix-ups that saturate at both ends (the plain
    # version's clamps counted), voices of both kinds in every order,
    # fields that cross the pool's end; flat and with a carried state
    cols, rows, mix, vol, rng = _order_rule_inputs(cols93, C, dev)
    kind = cols["kind_u8"][rows.long()]
    assert bool((kind == d93.ROW_93).any()) and bool(
        (kind == d93.ROW_93A).any())
    assert bool(((tabs93["pair"] & 3) == 2).any())
    clamps = {"hi": 0, "lo": 0}
    sat16 = d93.sat16

    def counted(x):
        clamps["hi"] += int((x > 32767).sum())
        clamps["lo"] += int((x < -32768).sum())
        return sat16(x)

    monkeypatch.setattr(d93, "sat16", counted)
    d93.decode93_fb_plain(cols, rows, mix, tabs93)
    monkeypatch.setattr(d93, "sat16", sat16)
    assert clamps["hi"] > 0 and clamps["lo"] > 0
    n = rows.shape[0]
    runs = np.repeat(np.arange(n), rng.integers(1, 2 * T93P, size=n))[:n]
    sid = torch.tensor(runs.astype(np.int32), device=dev)
    ov0 = torch.tensor(rng.integers(0, 0x10000, size=(int(runs.max()) + 3,
                                                      16)).astype(np.int32),
                       device=dev)
    for c in (cols, _far_fields(cols, C)):
        for o in (None, ov0):
            for want, got in _decode93_pcm_both(c, rows, mix, vol, sid,
                                                tabs93, o):
                assert torch.equal(want, got)


def test_decode93_pcm_kernel_on_silent_bands_and_a_short_pool(dev, tabs93):
    # every 93 band K_NONE on some frames, and pools that end inside the
    # last frames (bits past the end read as $FF)
    cols = dict(_flat93_columns(False, dev))
    kw = cols["kw_u8"].clone()
    kw[::7] = 0
    cols["kw_u8"] = kw
    F = cols["frame_word"].shape[0]
    cols["pool_u8"] = cols["pool_u8"][:int(cols["frame_word"][F - 3]) * 4
                                      + 37].clone()
    t1 = dict(_flat93_columns(True, dev))
    F1 = t1["frame_word"].shape[0]
    t1["pool_u8"] = t1["pool_u8"][:int(t1["frame_word"][F1 - 2]) * 4 + 5] \
        .clone()
    for c in (cols, t1):
        for want, got in _decode93_pcm_both(c, None, c["mix"], c["vol"],
                                            c["sid"], tabs93):
            assert torch.equal(want, got)


def test_normalize93_closed_form_on_every_input(dev):
    # decode93_pcm.cu's __clz normalize against the reference's 31-step
    # loop, on all 2^32 inputs
    assert kernels.normalize93_check(dev) == 0


def test_decode93_pcm_wrapper_refuses_bad_tensors(dev, tabs93):
    cols = _flat93_columns(False, dev)
    args = [cols[k] for k in d93.COLUMNS]
    F = cols["frame_word"].shape[0]

    def run(args=args, mix=cols["mix"], vol=cols["vol"], sid=cols["sid"]):
        return kernels.decode93_pcm(*args, mix, vol, sid, tabs93)

    bad = list(args)
    bad[0] = cols["pool_u8"][1:]
    with pytest.raises(ValueError, match="aligned"):
        run(bad)
    bad = list(args)
    bad[4] = cols["kind_u8"].int()
    with pytest.raises(TypeError):
        run(bad)
    with pytest.raises(TypeError):
        run(vol=cols["vol"].long())
    with pytest.raises(ValueError, match="shape"):
        run(sid=cols["sid"][1:])
    with pytest.raises(ValueError, match="contiguous"):
        run(vol=torch.zeros((F, 2), dtype=torch.int32, device=dev)[:, 0])
    with pytest.raises(ValueError, match="CUDA"):
        run(vol=cols["vol"].cpu())
    with pytest.raises(ValueError, match="shape"):        # one mix a row
        run(mix=cols["mix"][1:])


def test_decode93_bank_kernel_on_the_session93a_bank(dev, tabs93, rom93,
                                                    cols93):
    # the session bank of session93a.zip on the card against its plain
    # version, one decode93_bank launch a build, the columns left on the
    # host; then on random chain states and scale codes, every 93 band kind
    # and width at random (most bands silent or not), and fields moved to
    # the pool's end
    rs, _ = rom93
    before = dict(kernels.LAUNCHES)
    built = romplay.build_rom_bank(rs, dev)
    torch.cuda.synchronize()
    assert _launched(before) == {"decode93_bank": 1}
    assert {v.device.type for v in built.cols.values()} == {"cpu"}
    assert {v.device.type for v in built.bank93.values()} == {"cuda"}
    want = d93.decode93_bank_plain(cols93, tabs93)
    for k in ("words93", "kind93"):
        assert torch.equal(want[k], built.bank93[k])
    kinds = torch.bincount(built.bank93["kind93"].long(), minlength=4)
    assert kinds[d93.BANK_93] > 0 and kinds[d93.BANK_93A] > 0
    assert kinds[d93.BANK_93R] > 0
    rand = _random_columns(cols93, 7)
    for cols in (rand, _random_kinds(rand, 7), _random_kinds(rand, 7, 0.6),
                 _far_fields(rand, 7)):
        assert bool((_session_bank(cols, tabs93)["kind93"]
                     == d93.BANK_93R).any())


def test_decode93_pcm_bank_wrapper_refuses_bad_tensors(dev, tabs93, rom93):
    bank = rom93[1].bank93
    R = bank["kind93"].shape[0]
    rows = torch.ones((4, 2), dtype=torch.int32, device=dev)
    vs = torch.zeros(4, dtype=torch.int32, device=dev)

    def run(words=bank["words93"], kind=bank["kind93"], rows=rows,
            mix=rows, ov0=None):
        return kernels.decode93_pcm_bank(words, kind, rows, mix, vs, vs,
                                         tabs93, ov0)

    assert run().shape == (4, 240)
    with pytest.raises(ValueError, match="rows"):
        run(rows=None)
    with pytest.raises(ValueError, match="shape"):
        run(words=bank["words93"][:, :128].contiguous())
    with pytest.raises(TypeError):
        run(kind=bank["kind93"].int())
    skewed = torch.zeros(R * 160 + 1, dtype=torch.int32, device=dev)[1:]
    with pytest.raises(ValueError, match="aligned"):
        run(words=skewed.view(R, 160))
    nine = torch.zeros((4, 9), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="channels"):
        run(rows=nine, mix=nine)
    with pytest.raises(ValueError, match="CUDA"):
        run(mix=rows.cpu())
    with pytest.raises(ValueError, match="shape"):
        run(ov0=torch.zeros((2, 8), dtype=torch.int32, device=dev))
    skewed = torch.zeros(2 * 16 + 1, dtype=torch.int32, device=dev)[1:]
    with pytest.raises(ValueError, match="aligned"):
        run(ov0=skewed.view(2, 16))


# ----------------------------------------------------------------------
# the 1994+ encoder

ENC_SLOTS = {1: ((1, 3),), 2: ((1, 0), (1, 3)), 3: ((0, 0), (1, 0), (1, 3))}


def _adversarial_pcm(n):
    """int16 rows that break plane decompositions of the analysis:
    full-scale DC, alternating extremes, impulses, byte edges, random."""
    rng = np.random.default_rng(11)
    rows = [np.full(n, 32767), np.full(n, -32768), np.full(n, -1),
            np.where(np.arange(n) % 2 == 0, 32767, -32768)]
    imp = np.zeros(n, np.int64)
    imp[::97] = 32767
    imp[1::193] = -32768
    rows.append(imp)
    rows.append(rng.choice(np.asarray([-32768, -32767, -256, -255, -1, 0, 1,
                                       255, 256, 32766, 32767]), size=n))
    rows.append(rng.integers(-32768, 32768, size=n))
    return np.stack(rows).astype(np.int16)


@pytest.fixture(scope="module")
def encoders(dev):
    return {K: d94.DeviceEncoder94.for_slots(list(s), dev)
            for K, s in ENC_SLOTS.items()}


@pytest.mark.parametrize("fmax", [1, 15, 16, 17, 33, 272])
def test_encode94_analyze_kernel_on_random_and_adversarial_pcm(dev, fmax):
    fq = torch.tensor(enc.forward_matrix_q(), device=dev)
    L = fmax * 240 + 240
    rng = np.random.default_rng(fmax)
    pcm = np.concatenate([_adversarial_pcm(L),
                          rng.integers(-32768, 32768, size=(9, L)),
                          rng.integers(-300, 300, size=(3, L))])
    pcm = torch.tensor(pcm.astype(np.int16), device=dev)
    got = kernels.encode94_analyze(pcm, fq)
    torch.cuda.synchronize()
    assert torch.equal(got, d94.analyze94_plain(pcm, fq))
    # and the host's float64 evaluation of each row's frames
    host = pcm.cpu().numpy()
    for i in (0, 3, 6, 11):
        frames = enc.frames_from_pcm_raw(host[i, :fmax * 240])
        frames[-1, 240:] = host[i, fmax * 240:fmax * 240 + 16]
        np.testing.assert_array_equal(got[i].cpu().numpy(),
                                      enc.analyze_frames_canonical(frames))


@pytest.mark.parametrize("matrix", ["min", "max", "random"])
def test_encode94_analyze_kernel_on_extreme_matrices(dev, matrix):
    """Any int16 matrix, -32768 entries included: a pair of products then
    reaches 2^31, which the kernel's pair sums must carry exactly."""
    rng = np.random.default_rng(12)
    fq = {"min": np.full((256, 255), -32768),
          "max": np.full((256, 255), 32767),
          "random": rng.integers(-32768, 32768, size=(256, 255))}[matrix]
    fq = torch.tensor(fq.astype(np.int16), device=dev)
    fmax = 17
    L = fmax * 240 + 240
    pcm = np.concatenate([_adversarial_pcm(L),
                          rng.integers(-32768, 32768, size=(4, L))])
    pcm = torch.tensor(pcm.astype(np.int16), device=dev)
    got = kernels.encode94_analyze(pcm, fq)
    torch.cuda.synchronize()
    assert torch.equal(got, d94.analyze94_plain(pcm, fq))


def _analyze_rows(B, L, seed):
    """B int16 PCM rows of L samples: one random, the adversarial set, then
    random rows (the first B of them)."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(-32768, 32768, size=(1, L)),
                           _adversarial_pcm(L),
                           rng.integers(-32768, 32768, size=(B, L))])[
        :B].astype(np.int16)


@pytest.mark.parametrize("B", [1, 64])
@pytest.mark.parametrize("fmax", [63, 64, 65, 129, 272])
def test_encode94_analyze_kernel_on_ragged_tiles(dev, fmax, B):
    """Frame counts around the kernel's 64-frame tile (a last tile of 63,
    64, 1 or 16 frames) and the encoder's Fmax, one stream and 64."""
    fq = torch.tensor(enc.forward_matrix_q(), device=dev)
    pcm = torch.tensor(_analyze_rows(B, fmax * 240 + 240, fmax + B),
                       device=dev)
    got = kernels.encode94_analyze(pcm, fq)
    torch.cuda.synchronize()
    assert torch.equal(got, d94.analyze94_plain(pcm, fq))


def test_encode94_analyze_kernel_twice_on_reused_memory(dev):
    """Two calls in a row, the second on the allocations the first left
    (its coefficients and its PCM's block, holding other values)."""
    fmax, B = 129, 16
    fq = torch.tensor(enc.forward_matrix_q(), device=dev)
    rows = _analyze_rows(B, fmax * 240 + 240, 5)
    first = torch.tensor(rows[::-1].copy(), device=dev)
    want_first = d94.analyze94_plain(first, fq)
    got = kernels.encode94_analyze(first, fq)
    torch.cuda.synchronize()
    assert torch.equal(got, want_first)
    second = torch.tensor(rows, device=dev)
    ptr = got.data_ptr()
    del got
    first.copy_(second)                               # same block, new PCM
    got = kernels.encode94_analyze(first, fq)
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr                      # the same block
    assert torch.equal(got, d94.analyze94_plain(first, fq))


def test_encode94_analyze_refuses_unaligned_pcm(dev):
    """The kernel copies 16-byte chunks of each row: a contiguous view 2
    bytes off raises, and nothing falls back."""
    fmax, B = 17, 2
    L = fmax * 240 + 240
    fq = torch.tensor(enc.forward_matrix_q(), device=dev)
    flat = torch.zeros(B * L + 8, dtype=torch.int16, device=dev)
    pcm = flat[1:1 + B * L].view(B, L)
    assert pcm.is_contiguous() and pcm.data_ptr() % 16 == 2
    before = kernels.LAUNCHES["encode94_analyze"]
    with pytest.raises(ValueError, match="aligned"):
        kernels.encode94_analyze(pcm, fq)
    assert kernels.LAUNCHES["encode94_analyze"] == before


def _encoder_inputs(dev, K, fmax, seed, maxerr, codes=256, keep_all=False,
                    all_pass=False):
    """One stream per bands_keep 1..16 (or every band kept), coefficients
    from random PCM of three amplitudes with silent stretches, random
    header scale codes over 0..codes-1, thresholds from a maximum
    quantization error of maxerr/32768; with all_pass, thresholds every
    candidate passes on the odd bands (band 15 too) and -1 (none passes)
    on the even ones."""
    rng = np.random.default_rng(seed)
    B = 16
    amp = np.asarray([30000, 3000, 100] * 6)[:B, None]
    pcm = (rng.standard_normal((B, fmax * 240 + 240)) * amp).clip(
        -32768, 32767).astype(np.int16)
    for i in range(0, B, 3):
        pcm[i, : 240 * (fmax // 2)] = 5               # silent frames
    fq = torch.tensor(enc.forward_matrix_q(), device=dev)
    ci = kernels.encode94_analyze(torch.tensor(pcm, device=dev), fq)
    params = enc.CompressionParams(
        maximum_quantization_error=maxerr / 32768,
        minimum_dynamic_range=maxerr / 32768)
    _, arrs = d94.setup_compact([np.zeros((1, 255), np.int32)], params,
                                ENC_SLOTS[K])
    hdr = rng.integers(0, codes, size=(B, K, 16)).astype(np.uint8)
    hdr[::2] %= 48                                    # realistic codes too
    keep = np.arange(16)[None] < np.arange(1, B + 1)[:, None]
    keep |= keep_all
    thr, dlim, cape = (np.array(arrs[k]) for k in ("thr", "dlim", "cape"))
    if all_pass:
        thr[1::2], dlim[1::2], cape[1::2] = 1 << 30, 2 ** 31 - 1, 1 << 25
        thr[0::2] = -1
    t = lambda a, dt=None: torch.tensor(np.asarray(a), device=dev, dtype=dt)
    return dict(ci=ci, sil_max=arrs["sil_max"], keep=t(keep),
                thr=t(thr), dlim=t(dlim), cape=t(cape), hdr_scale=t(hdr))


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("fmax", [16, 32, 48])
@pytest.mark.parametrize("maxerr", [10, 40, 200])
def test_encode94_decide_and_select_kernels(dev, encoders, K, fmax, maxerr):
    tabs = dict(encoders[K].named_buffers())
    x = _encoder_inputs(dev, K, fmax, seed=fmax * 7 + K + maxerr, maxerr=maxerr)
    args = (x["ci"], x["sil_max"], x["keep"], x["thr"], x["dlim"],
            x["cape"], x["hdr_scale"])
    got = kernels.encode94_decide(*args, tabs)
    torch.cuda.synchronize()
    want = d94.decide94_plain(*args, tabs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    B = x["ci"].shape[0]
    rng = np.random.default_rng(fmax + K)
    # frame counts around the bucket and every wanted pattern
    nf = torch.tensor(np.clip(fmax - rng.integers(0, 17, size=B), 1, fmax)
                      .astype(np.int32), device=dev)
    for pattern in range(1 << K):
        wanted = torch.tensor([[bool(pattern >> k & 1) for k in range(K)]]
                              * B, device=dev)
        sel = (x["ci"], *want, nf, x["keep"], x["hdr_scale"], wanted, tabs)
        packed = kernels.encode94_select(*sel)
        torch.cuda.synchronize()
        assert torch.equal(packed, d94.select94_plain(*sel)), pattern


def _decide_equal(x, tabs):
    args = (x["ci"], x["sil_max"], x["keep"], x["thr"], x["dlim"],
            x["cape"], x["hdr_scale"])
    got = kernels.encode94_decide(*args, tabs)
    torch.cuda.synchronize()
    want = d94.decide94_plain(*args, tabs)
    for g, w, name in zip(got, want, ("out15", "out14", "silent")):
        assert torch.equal(g, w), name
    assert int(got[1].max()) <= 14
    return got


def test_encode94_rdiv_check_on_every_input(dev, encoders):
    tabs = dict(encoders[3].named_buffers())
    assert kernels.encode94_rdiv_check(tabs["scale_mant"]) == 0


@pytest.mark.parametrize("K", [1, 2, 3])
@pytest.mark.parametrize("fmax", [1, 13, 17, 272])
def test_encode94_decide_kernel_shapes(dev, encoders, K, fmax):
    """Every slot count, one frame, tiles cut short (13, 17: not multiples
    of the kernel's 8-frame tile) and the chunk's 272 frames."""
    tabs = dict(encoders[K].named_buffers())
    _decide_equal(_encoder_inputs(dev, K, fmax, fmax + K, 40), tabs)
    _decide_equal(_encoder_inputs(dev, K, fmax, fmax + K + 1, 40, codes=24,
                                  keep_all=True, all_pass=True), tabs)


@pytest.mark.parametrize("K", [1, 3])
def test_encode94_decide_kernel_on_every_scale_code(dev, encoders, K):
    """Each of the 64 values of sc & 63 on some band of every slot (and
    with the adjustments of the type-1 slots on top), every band kept."""
    tabs = dict(encoders[K].named_buffers())
    x = _encoder_inputs(dev, K, 24, 40 + K, 40, keep_all=True)
    codes = (np.arange(16 * 16).reshape(16, 1, 16) + 5 * np.arange(K)
             [None, :, None]) % 64
    x["hdr_scale"] = torch.tensor(codes.astype(np.uint8), device=dev)
    _decide_equal(x, tabs)


def test_encode94_decide_kernel_at_rounding_ties_and_the_range_ends(
        dev, encoders):
    """Coefficients on rdiv's ties (2|a| = (2q+1) sf) of each band's scale
    factor in the type-0 slot, and at +-2^20, with all-pass and no-pass
    thresholds."""
    tabs = dict(encoders[3].named_buffers())
    x = _encoder_inputs(dev, 3, 16, 50, 40, codes=40, keep_all=True,
                        all_pass=True)
    w, sf, _, _ = d94.derive_luts(x["hdr_scale"], x["keep"], tabs)
    sf0 = sf[:, 0, :, 1, 0].long().cpu().numpy()          # [B,16]
    rng = np.random.default_rng(51)
    ci = x["ci"].cpu().numpy()
    for band in range(16):
        lo, n = int(c94.BAND_START[band]), int(c94.BAND_SIZES[band])
        s = sf0[:, band][:, None, None]
        q = rng.integers(0, 1 << 6, size=(ci.shape[0], ci.shape[1], n))
        tie = (2 * q + 1) * s // 2 * rng.choice([-1, 1], size=q.shape)
        ci[:, :, lo:lo + n] = np.where(s % 2 == 0, tie, ci[:, :, lo:lo + n])
    ci[:, ::3, 200] = 1 << 20
    ci[:, 1::3, 120] = -(1 << 20)
    x["ci"] = torch.tensor(np.clip(ci, -(1 << 20), 1 << 20).astype(np.int32),
                           device=dev)
    got = _decide_equal(x, tabs)
    # on the all-pass bands of the type-0 slot (keys rise with the code)
    # candidate 1 wins wherever the first fit was above it
    assert (got[0][:, 0, :, 1::2] == 1).any()


def test_encode94_decide_kernel_with_no_band_kept(dev, encoders):
    tabs = dict(encoders[3].named_buffers())
    x = _encoder_inputs(dev, 3, 17, 60, 40)
    x["keep"] = torch.zeros_like(x["keep"])
    _decide_equal(x, tabs)


@pytest.mark.parametrize("kind", ["dips", "rising"])
def test_encode94_decide_kernel_on_synthetic_width_tables(dev, encoders,
                                                          kind):
    """Widths of codes 1..6 rewritten: with dips (a later candidate can
    have the smaller key) or sorted with ties; the kernel's minimum over
    every passing candidate must give the plain answer on both."""
    tabs = dict(encoders[3].named_buffers())
    rng = np.random.default_rng(70)
    w = tabs["w_tab"].cpu().numpy().copy()
    if kind == "dips":
        w[:, :, 1:7] = np.clip(np.arange(1, 7)
                               + rng.integers(-2, 3, (3, 16, 6)), 1, 15)
    else:
        w[:, :, 1:7] = np.sort(rng.integers(1, 9, (3, 16, 6)), axis=2)
    tabs["w_tab"] = torch.tensor(w, device=dev)
    for seed in range(3):
        _decide_equal(_encoder_inputs(dev, 3, 19, 71 + seed, 40, codes=24,
                                      keep_all=True, all_pass=True), tabs)
        _decide_equal(_encoder_inputs(dev, 3, 19, 75 + seed, 200), tabs)


def test_encode94_code_15_after_a_silent_frame_on_the_card(dev):
    params = enc.CompressionParams(stream_format_type=0,
                                   power_band_cutoff=1.0,
                                   target_bit_rate=10_000_000)
    rng = np.random.default_rng(1)
    ci = rng.integers(-300, 300, size=(4, 255)).astype(np.int32)
    s0 = int(c94.BAND_START[5])
    ci[0, s0:s0 + 16] = 7
    ci[1:3, s0:s0 + 16] = np.where(np.arange(16) % 2, 1 << 20, -(1 << 20))
    (got,) = d94.encode_batch([ci], params, device=dev)
    assert got == c94.encode_stream94(ci, params)
    assert got == d94.encode_batch([ci], params, device="cpu")[0]


def test_encode_batch_of_64_streams_on_the_card(dev):
    rng = np.random.default_rng(9)
    cis = [rng.integers(-(1 << 12), 1 << 12, size=(int(nf), 255))
           .astype(np.int32) for nf in rng.integers(1, 80, size=64)]
    for params in (enc.CompressionParams(),
                   enc.CompressionParams(target_bit_rate=48000,
                                         maximum_quantization_error=40 / 32768,
                                         minimum_dynamic_range=60 / 32768)):
        got = d94.encode_batch(cis, params, device=dev)
        assert got == [c94.encode_stream94(ci, params) for ci in cis]
        assert got == d94.encode_batch(cis, params, device="cpu")


def test_encode_files_device_on_the_card(dev):
    rng = np.random.default_rng(5)
    t = np.arange(240 * 40) / 31250.0
    music = np.clip(8000 * np.sin(2 * np.pi * 440 * t)
                    + 200 * rng.standard_normal(t.size), -32768,
                    32767).astype(np.int16)
    jobs = [(music, 31250), (music[:240 * 7 + 3], 31250),
            (_adversarial_pcm(240 * 9 + 17)[3], 31250)] * 7
    got = d94.encode_jobs_pcm(jobs, enc.CompressionParams(), device=dev,
                              chunk=8)
    assert got == d94.encode_jobs_pcm(jobs, enc.CompressionParams(),
                                      device="cpu", chunk=8)
    assert got == enc.encode_files_device(jobs)


def test_encoder_wrappers_refuse_bad_tensors(dev, encoders):
    tabs = dict(encoders[3].named_buffers())
    x = _encoder_inputs(dev, 3, 16, seed=1, maxerr=10)
    args = [x["ci"], x["sil_max"], x["keep"], x["thr"], x["dlim"], x["cape"],
            x["hdr_scale"]]
    with pytest.raises(ValueError, match="CUDA"):
        kernels.encode94_decide(x["ci"].cpu(), *args[1:], tabs)
    with pytest.raises(TypeError):
        kernels.encode94_decide(x["ci"].long(), *args[1:], tabs)
    with pytest.raises(ValueError, match="slots"):
        kernels.encode94_decide(*args[:-1], torch.zeros(
            (16, 4, 16), dtype=torch.uint8, device=dev), tabs)
    with pytest.raises(TypeError):
        kernels.encode94_analyze(torch.zeros((2, 480), dtype=torch.int32,
                                             device=dev), tabs["fq"])
    out = kernels.encode94_decide(*args, tabs)
    nf = torch.full((16,), 16, dtype=torch.int32, device=dev)
    wanted = torch.ones((16, 3), dtype=torch.bool, device=dev)
    ci17 = torch.zeros((16, 17, 255), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiples of 16"):
        kernels.encode94_select(ci17, *out, nf, x["keep"], x["hdr_scale"],
                                wanted, tabs)
    with pytest.raises(ValueError, match="shape"):
        kernels.encode94_select(x["ci"], *out, nf[1:], x["keep"],
                                x["hdr_scale"], wanted, tabs)


def _select_inputs(dev, K, B, fmax, seed, tabs, tables="shipped",
                   decisions="codes"):
    """Random select94 inputs: coefficients of several magnitudes (zero
    runs among them) up to +-2^20, decisions 0..15 (out14 <= 14; or any
    byte), runs of silent frames, random kept bands, header codes and
    frame counts 1..fmax (1 and fmax among them); with tables="random",
    pip and dep of the slots drawn at random (not the shipped ones)."""
    rng = np.random.default_rng(seed)
    mag = rng.choice([3, 8, 14, 20], size=(B, 1, 1))
    ci = rng.integers(-(1 << 20), (1 << 20) + 1, size=(B, fmax, 255))
    ci = ci >> (20 - mag)
    ci[:, :, rng.integers(0, 255, size=40)] = 0
    ci[0, :2, :8] = [[1 << 20, -(1 << 20)] * 4] * 2
    hi = 256 if decisions == "bytes" else 16
    out15 = rng.integers(0, hi, size=(B, K, fmax, 16, 5))
    out14 = rng.integers(0, 256 if decisions == "bytes" else 15,
                         size=out15.shape)
    silent = rng.random((B, fmax, 16)) < 0.15
    silent[:, fmax // 3: fmax // 3 + 5] = True
    keep = rng.random((B, 16)) < 0.8
    keep[0] = np.arange(16) < 9
    hdr = rng.integers(0, 64, size=(B, K, 16))
    nf = rng.integers(1, fmax + 1, size=B)
    nf[0], nf[-1] = 1, fmax
    if tables == "random":
        tabs = dict(tabs)
        tabs["pip"] = torch.tensor(rng.integers(0, 5, size=(K, 16)),
                                   dtype=torch.int32, device=dev)
        tabs["dep"] = torch.tensor(rng.random((K, 16)) < 0.5, device=dev)
    t = lambda a, dt: torch.tensor(np.asarray(a), dtype=dt, device=dev)
    return (t(ci, torch.int32), t(out15, torch.uint8), t(out14, torch.uint8),
            t(silent, torch.bool), t(nf, torch.int32), t(keep, torch.bool),
            t(hdr, torch.uint8)), tabs


def _select_equal(x, wanted, tabs):
    got = kernels.encode94_select(*x[:6], x[6], wanted, tabs)
    torch.cuda.synchronize()
    want = d94.select94_plain(*x[:6], x[6], wanted, tabs)
    assert torch.equal(got, want)


@pytest.mark.parametrize("tables", ["shipped", "random"])
@pytest.mark.parametrize("K", [1, 2, 3])
@pytest.mark.parametrize("fmax", [16, 48, 272, 528])
def test_encode94_select_kernel_on_random_decisions(dev, encoders, tables, K,
                                                    fmax):
    """Random decisions (every code after every code), shipped and random
    pip/dep tables, frame counts 1..Fmax, every wanted pattern; 528
    frames take two rounds of the scan."""
    x, tabs = _select_inputs(dev, K, 16, fmax, fmax + 10 * K,
                             dict(encoders[K].named_buffers()), tables)
    for pattern in range(1 << K):
        wanted = torch.tensor([[bool(pattern >> k & 1) for k in range(K)]]
                              * 16, device=dev)
        _select_equal(x, wanted, tabs)


@pytest.mark.parametrize("B", [1, 64])
def test_encode94_select_kernel_batch_sizes(dev, encoders, B):
    tabs = dict(encoders[3].named_buffers())
    x, tabs = _select_inputs(dev, 3, B, 272, B, tabs, "random")
    _select_equal(x, torch.ones((B, 3), dtype=torch.bool, device=dev), tabs)


def test_encode94_select_kernel_on_any_decision_byte(dev, encoders):
    """Decision bytes past 15 (outside decide's range) are carried as
    state 15 and written as they are, as the plain version does."""
    x, tabs = _select_inputs(dev, 3, 16, 48, 5,
                             dict(encoders[3].named_buffers()), "random",
                             decisions="bytes")
    _select_equal(x, torch.ones((16, 3), dtype=torch.bool, device=dev), tabs)


def test_encode94_select_kernel_on_dirty_scratch(dev, encoders):
    """Two calls in a row, each after its scratch's memory was filled with
    garbage and freed (the caching allocator hands it out again)."""
    tabs = dict(encoders[3].named_buffers())
    wanted = torch.ones((16, 3), dtype=torch.bool, device=dev)
    for seed in (1, 2):
        x, tb = _select_inputs(dev, 3, 16, 272, 90 + seed, tabs)
        junk = [torch.full((16 * 3 * 272 * 16,), 0x5A, dtype=torch.uint8,
                           device=dev) for _ in range(2)]
        junk.append(torch.full((16 * 3 * 5 + 16,), 12345, dtype=torch.int32,
                               device=dev))
        del junk
        _select_equal(x, wanted, tb)


def test_encode94_select_parts_and_geometry(dev, encoders):
    """The two launches apart (the timing aid) leave the same row; the
    geometry of both kernels."""
    tabs = dict(encoders[3].named_buffers())
    x, tabs = _select_inputs(dev, 3, 16, 272, 7, tabs)
    wanted = torch.ones((16, 3), dtype=torch.bool, device=dev)
    before = dict(kernels.LAUNCHES)
    scan, size, packed = kernels.encode94_select_parts(*x, wanted, tabs)
    scan()
    size()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == before
    assert torch.equal(packed, d94.select94_plain(*x, wanted, tabs))
    geo = kernels.encode94_select_geometry(dev)
    assert geo["scan_blocks"] == 4 and geo["size_tile_frames"] == 32
    assert geo["scan_blocks_per_sm"] >= 1 and geo["size_blocks_per_sm"] >= 1


COLD94 = ["tone_low.dcs94", "noise_sweep.dcs94"]


def _assets(names):
    return [open(os.path.join(ASSETS, n), "rb").read() for n in names]


@pytest.mark.parametrize("n_chunks", [1, 3])
def test_cold_flat94_on_the_card_equals_the_cpu(dev, n_chunks):
    """Chunk pools of 30,774 bytes (not a multiple of 4), two calls on one
    ColdDevice (pinned buffers and device memory handed out again)."""
    streams = _assets(COLD94)
    want = cold.cold_flat94(streams, 3, n_chunks, device="cpu")
    cdev = cold.ColdDevice(dev)
    for _ in range(2):
        got = cold.cold_flat94(streams, 3, n_chunks, cdev)
        assert torch.equal(got["pcm"].cpu(), want["pcm"])
        assert got["checksum"] == want["checksum"]
        assert all(c["upload_ms"] > 0 for c in got["chunks"])
        assert got["device_ms"] > 0


def test_cold_catalog_on_the_card_equals_the_cpu(dev):
    cats = (_assets(COLD94) * 2, _assets(WIRES93[False]),
            _assets(WIRES93[True]))
    want = cold.cold_catalog(*cats, device="cpu")
    before = kernels.LAUNCHES["decode93_pcm"]
    got = cold.cold_catalog(*cats, device=dev)
    assert kernels.LAUNCHES["decode93_pcm"] == before + 2
    assert got["checksums"] == want["checksums"]
    assert got["checksum"] == want["checksum"]
    assert got["families"].keys() == want["families"].keys()
    args = (fs.packed_to_device(fs.FlatSweep(cats[0]).pack()
                                .compact_host_arrays(), dev),
            cs.packed93_to_device(cs.Flat93Sweep(cats[1], False)
                                  .compact_host_arrays(), dev),
            cs.packed93_to_device(cs.Flat93Sweep(cats[2], True)
                                  .compact_host_arrays(), dev))
    assert int(cs.catalog_pipeline(fs.FlatPipeline(dev), cs.Flat93Pipeline(dev),
                                   *args)) == want["checksum"]


def test_device_trace_holds_the_kernels(dev, tmp_path):
    sweep = fs.FlatSweep(_assets(COLD94)).pack()
    args = fs.packed_to_device(sweep.compact_host_arrays(), dev)
    pipe = fs.FlatPipeline(dev)
    pipe(**args)
    with profiling.device_trace(str(tmp_path)) as prof:
        pipe(**args)
        torch.cuda.synchronize()
    s = profiling.trace_summary(prof.trace_file)
    names = " ".join(n for n, _, _ in s["kernels"])
    assert "decode94_fb" in names and "transform94_pcm" in names
    assert 0 < s["busy_ms"] <= s["window_ms"]
    assert 0 <= s["idle_share"] < 1



def _launching_spans(trace_file):
    """{kernel event name: {the innermost host span around its launch}} of
    a Chrome trace: a kernel finds its launch call by correlation id, and
    the launch the spans open around it on its own thread."""
    with open(trace_file) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"], e["pid"], e["tid"])
             for e in events if e.get("cat") == "user_annotation"]
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})}
    out = {}
    for e in events:
        call = calls.get(e.get("args", {}).get("correlation"))
        if e.get("cat") != "kernel" or call is None:
            continue
        inside = [s for s in spans if s[3] == call["pid"]
                  and s[4] == call["tid"] and s[0] <= call["ts"] <= s[1]]
        name = max(inside)[2] if inside else None
        out.setdefault(e["name"], set()).add(name)
    return out


def test_kernels_launch_inside_their_kernel_spans(dev, tmp_path):
    # a flat sweep and a served batch under the profiler: each hand-written
    # kernel's launch has its wrapper's dcs.kernel.* span innermost
    args = fs.packed_to_device(fs.FlatSweep(_assets(COLD94)).pack()
                               .compact_host_arrays(), dev)
    pipe = fs.FlatPipeline(dev)
    rs, _ = zipload.load_zip_file(SESSION6_ZIP)
    S, T = 5, 150
    events = [{(b * 7 + t * 3) % 40: [0x00, t] for t in range(1, 7)}
              | {0: [0x55, 0xAA, 0x40 + b, (0x40 + b) ^ 0xFF]}
              for b in range(S)]
    with romplay.SessionServer(rs, S, T, n_ch=6) as srv:
        wire, E = srv.prepare(events)
        wire = torch.from_numpy(wire).to(dev)
        pipe(**args)
        srv.decode_wire(wire, E)
        torch.cuda.synchronize()
        with profiling.device_trace(str(tmp_path)) as prof:
            pipe(**args)
            srv.decode_wire(wire, E)
            torch.cuda.synchronize()
    got = _launching_spans(prof.trace_file)
    for kernel in ("decode94_fb", "transform94_pcm", "segments94",
                   "session_mix94"):
        names = [k for k in got if f"{kernel}_kernel" in k]
        assert names, (kernel, sorted(got))
        assert set().union(*(got[k] for k in names)) == \
            {f"dcs.kernel.{kernel}"}, (kernel, got)

# -- the sharded paths (parallel/sweep.py) on one card -------------------------

CARD4 = ["cuda:0"] * 4


def _launched(before):
    return {k: v - before[k] for k, v in kernels.LAUNCHES.items()
            if v != before[k]}


def test_sharded_flat_sweep_on_the_card_equals_the_cpu(dev):
    # four side streams of one card; an input made on the current stream
    # just before the call (the shards' streams must wait for it)
    streams = [open(p, "rb").read()
               for p in sorted(glob.glob(os.path.join(ASSETS, "*.dcs94")))]
    arrays = fs.FlatSweep(streams * 3).pack().compact_host_arrays()
    want = fs.FlatPipeline("cpu")(**fs.packed_to_device(arrays, "cpu"))
    single = fs.FlatPipeline(dev)(**fs.packed_to_device(arrays, dev))
    before = dict(kernels.LAUNCHES)
    got = sweep.sharded_flat_sweep(sweep.make_flat_mesh(CARD4), arrays)
    torch.cuda.synchronize()
    assert _launched(before) == {"decode94_fb": 4, "transform94_pcm": 4}
    assert got.device == dev
    assert torch.equal(got, single)
    assert torch.equal(got.cpu(), want)
    # repeated calls reuse the cached pipeline and stay exact
    for _ in range(3):
        assert torch.equal(sweep.sharded_flat_sweep(CARD4, arrays), single)


def test_sharded_sessions_on_the_card_equal_one_decoder(dev, rom93):
    rs, _ = zipload.load_zip_file(SESSION6_ZIP)
    rs.check()
    for rs_k, bank, key in ((rs, romplay.build_rom_bank(rs, dev),
                             "session_mix94"), (*rom93, "decode93_pcm")):
        S, T, C = 7, 120, 6
        with romplay.SessionServer(rs_k, S, T, n_ch=C, bank=bank) as srv:
            wire, E = srv.prepare(
                [{(b * 7 + t * 3) % 40: [0x00, t] for t in range(1, 7)}
                 for b in range(S)])
            want = srv.serve_one([{(b * 7 + t * 3) % 40: [0x00, t]
                                   for t in range(1, 7)} for b in range(S)])
        # the controls made on the card's current stream just before
        rows, mix, vol = romplay.segments94(torch.tensor(wire, device=dev),
                                            S, T, C, E)
        before = dict(kernels.LAUNCHES)
        got = sweep.sharded_sessions(CARD4, bank, rows.reshape(S, T, C),
                                     mix.reshape(S, T, C),
                                     vol.reshape(S, T))
        torch.cuda.synchronize()
        assert _launched(before)[key] == 4
        assert np.array_equal(pipeline.to_int16(got).reshape(S, -1).cpu()
                              .numpy(), want)
        assert np.abs(want).max() > 0


@pytest.mark.parametrize("family", ["1994", "1993"])
def test_sharded_sessions_on_the_card_follow_a_bank_that_grew(dev, family):
    # the bank grows between two calls over ["cuda:0"] * 2: the second
    # call's rows name the new stream's frames (a stale decoder would trap
    # in session_mix94 or decode93_pcm on a row past its bank)
    os_v, names = {"1994": (rd.OS94, ("sine_mix_1s.dcs94", "chirpy.dcs94")),
                   "1993": (rd.OS93B, ("music_a.dcs93b", "music_b.dcs93a"))
                   }[family]
    bank, cpu_bank = pipeline.StreamBank(os_v), pipeline.StreamBank(os_v)
    rng = np.random.default_rng(46)
    for k, name in enumerate(names):
        mem = open(os.path.join(ASSETS, name), "rb").read()
        for b, where in ((bank, dev), (cpu_bank, "cpu")):
            b.add(mem)
            b.decode_all(where)
        n_rows = bank.total_rows()
        lo = 1 if k == 0 else n_rows - ((mem[0] << 8) | mem[1])
        rows = rng.integers(lo, n_rows, size=(3, 50, 2)).astype(np.int32)
        mix = rng.integers(0, 1 << 16, size=(3, 50, 2)).astype(np.int32)
        vol = rng.integers(0, 4, size=(3, 50)).astype(np.int32)
        got = sweep.sharded_sessions(["cuda:0"] * 2, bank, rows, mix, vol)
        fresh = pipeline.session_decoder(bank)
        one = torch.stack([pipeline.device_decode(fresh, r, m, v)[0]
                           for r, m, v in zip(rows, mix, vol)])
        torch.cuda.synchronize()
        assert torch.equal(got, one), k
        assert torch.equal(got.cpu(), sweep.sharded_sessions(
            ["cpu"] * 2, cpu_bank, rows, mix, vol)), k


def test_sharded_sweep_on_the_card_equals_the_plain_path(dev):
    legacy = [open(os.path.join(ASSETS, f"{n}.dcs94"), "rb").read()
              for n in ("chirpy", "noise_sweep", "sine_mix_1s", "tone_low")]
    inputs = batched.SweepInputs(legacy * 3)
    args = inputs.args(dev)
    single = batched.batch_decode(*args)
    cpu = batched.batch_decode(*inputs.args("cpu"))       # the plain path
    before = dict(kernels.LAUNCHES)
    got = sweep.sharded_sweep(sweep.make_mesh(CARD4, frame_shards=2), inputs)
    torch.cuda.synchronize()
    assert _launched(before) == {"decode94_fb": 4, "transform94_pcm": 4}
    assert torch.equal(single.cpu(), cpu)
    assert torch.equal(got, single)
    # a chunk with a carried overlap, on the card
    sb, rs, hd, fmt, sub, bt, btp, mix, vol, n_steps = args
    ov0 = torch.randint(0, 1 << 16, (16,), dtype=torch.int32, device=dev)
    chunk = (sb[3], rs[3, 40:97], hd[3], fmt, sub, bt[3, 40:97],
             btp[3, 40:97], mix[3, 40:97], vol[3, 40:97], ov0, n_steps)
    pcm, last = batched.stream_decode(*chunk)
    want, want_last = batched.stream_decode(
        *(a.cpu() if isinstance(a, torch.Tensor) else a for a in chunk))
    assert torch.equal(pcm.cpu(), want) and torch.equal(last.cpu(), want_last)


def test_graft_entry_on_the_card(dev):
    step, args = graft_entry.entry()
    assert all(a.device == dev for a in args)
    pcm = step(*args)
    cpu_step, cpu_args = graft_entry.entry("cpu")
    assert torch.equal(pcm.cpu(), cpu_step(*cpu_args))
    assert graft_entry.dryrun_multichip(4) == [dev] * 4


def _script_inputs(d):
    """Three WAVs (one at 44,100 Hz) and a script over two parameter
    sets."""
    from dcsexplorer_tpu_torch.utils import audioio
    rng = np.random.default_rng(21)
    for name, n, rate in (("a", 9000, 31250), ("b", 5000, 31250),
                          ("c", 13000, 44100)):
        t = np.arange(n) / rate
        x = 7000 * np.sin(2 * np.pi * 400 * t) + rng.normal(0, 300, n)
        audioio.write_wav(d / f"{name}.wav", x.astype(np.int16), rate)
    (d / "s.dcss").write_text(
        'Default encoding parameters (BitRate=128000);\n'
        'Stream A "a.wav";\nStream B "b.wav" (BitRate=96000);\n'
        'Stream C "c.wav";\n'
        'Track $0001 channel 0 { Play(A); Wait(stream); Play(C); '
        'Wait(stream); };\n'
        'Track $0002 channel 1 { Play(B); Wait(stream); };\n')
    return str(d / "s.dcss")


def test_script_compile_on_the_card_equals_the_cpu(dev, tmp_path):
    import io
    import zipfile
    from dcsexplorer_tpu_torch.compiler import script
    path = _script_inputs(tmp_path)
    before = dict(kernels.LAUNCHES)
    stats = {}
    card, report = script.compile_script_file(path, stats=stats)
    torch.cuda.synchronize()
    # two parameter sets: one chunk each
    assert _launched(before) == {"encode94_analyze": 2, "encode94_decide": 2,
                                 "encode94_select": 2}
    assert len(stats["chunk_ms"]) == 2
    cpu, cpu_report = script.compile_script_file(path, device="cpu")
    images = [{n: z.read(n) for n in z.namelist()}
              for z in (zipfile.ZipFile(io.BytesIO(b)) for b in (card, cpu))]
    assert images[0] == images[1] and report == cpu_report


def test_encoder_cli_on_the_card_equals_the_cpu(dev, tmp_path):
    from dcsexplorer_tpu_torch.tools import encoder_cli
    _script_inputs(tmp_path)
    wavs = [str(tmp_path / f"{n}.wav") for n in "abc"]
    outs = {}
    for key, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        d = tmp_path / key
        d.mkdir()
        before = dict(kernels.LAUNCHES)
        assert encoder_cli.main(wavs + ["-o", str(d)] + extra) == 0
        torch.cuda.synchronize()
        assert _launched(before) == ({} if key == "cpu" else {
            "encode94_analyze": 1, "encode94_decide": 1,
            "encode94_select": 1})
        outs[key] = {n: (d / n).read_bytes() for n in os.listdir(d)}
    assert outs["card"] == outs["cpu"] and len(outs["cpu"]) == 3
