"""Port parity: band/slot controls, the plain symbol decode and the plain
dequant/mix of dcsexplorer_tpu_torch equal the JAX reference bit for bit
on the .dcs94 assets (both format families), and the dequant/mix also
equals the Pallas kernel run in interpret mode.  The plain decode94_fb
(compact columns to frame buffers) equals JAX decode_flat followed by the
Pallas dequant_mix, on the assets and on random headers and band types."""

import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcsexplorer_tpu.models import flatsweep as jfs
from dcsexplorer_tpu.ops import band_decode as jbd
from dcsexplorer_tpu.ops import pallas_kernels as pk
from dcsexplorer_tpu_torch.models import flatsweep as tfs
from dcsexplorer_tpu_torch.ops import band_decode as tbd
from dcsexplorer_tpu_torch.ops import kernels

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "assets", "streams")


def _t(x):
    return torch.tensor(np.asarray(x))


_decode_flat = jax.jit(jfs.decode_flat, static_argnums=(7,))


@pytest.fixture(scope="module")
def catalog():
    """The six .dcs94 assets packed by the JAX FlatSweep: its wide args
    (numpy), the port's codec tables and the compact columns."""
    streams = [open(p, "rb").read()
               for p in sorted(glob.glob(os.path.join(ASSETS, "*.dcs94")))]
    assert len(streams) == 6
    sweep = jfs.FlatSweep(streams).pack()
    args = [np.asarray(a) if not isinstance(a, int) else a
            for a in sweep.args()]
    return args, tfs.codec_tables(), sweep.compact_host_arrays()


def _jax_decode_flat(pool, sb, hdr, fmt, sub, bt, btp, n_steps):
    rows = jbd.window_rows_for(jnp.asarray(pool), sb.shape[0])
    dense, (scale, total) = _decode_flat(
        rows, jnp.asarray(sb), jnp.asarray(hdr), jnp.asarray(fmt),
        jnp.asarray(sub), jnp.asarray(bt), jnp.asarray(btp), n_steps)
    return np.asarray(dense), np.asarray(scale), np.asarray(total)


@pytest.fixture(scope="module")
def jax_decode(catalog):
    """JAX decode_flat over the catalog (one jit compile for the module)."""
    pool, sb, hdr, fmt, sub, bt, btp, _, _, _, n_steps = catalog[0]
    return _jax_decode_flat(pool, sb, hdr, fmt, sub, bt, btp, n_steps)


def _port_slots(catalog):
    (pool, sb, hdr, fmt, sub, bt, btp, _, _, _, n_steps), tabs = catalog[:2]
    ctl = tbd.band_controls_dyn(_t(hdr), _t(fmt), _t(sub), _t(bt), _t(btp),
                                tabs)
    return ctl, tbd.slot_controls(ctl, tabs)


def test_band_controls_dyn_matches_jax(catalog):
    _, _, hdr, fmt, sub, bt, btp = catalog[0][:7]
    want = jfs.band_controls_dyn(jnp.asarray(hdr), jnp.asarray(fmt),
                                 jnp.asarray(sub), jnp.asarray(bt),
                                 jnp.asarray(btp))
    got, _ = _port_slots(catalog)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(np.asarray(want[k]), got[k].numpy()), k


def test_slot_controls_matches_jax(catalog):
    _, _, hdr, fmt, sub, bt, btp = catalog[0][:7]
    ctl = jfs.band_controls_dyn(jnp.asarray(hdr), jnp.asarray(fmt),
                                jnp.asarray(sub), jnp.asarray(bt),
                                jnp.asarray(btp))
    want = jbd.slot_controls(ctl)
    _, got = _port_slots(catalog)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        assert np.array_equal(np.asarray(w), g.numpy())


def test_controls_match_jax_on_random_headers():
    # random headers reach what the assets do not: $7F terminators,
    # decimated ($40) bands, band types past 15, mixed fmt/sub per frame
    rng = np.random.default_rng(11)
    N = 512
    hdr = rng.integers(0, 0x80, size=(N, 16))
    hdr[rng.random((N, 16)) < 0.05] = 0x7F
    hdr[rng.random((N, 16)) < 0.3] |= 0x40
    fmt = rng.integers(0, 2, size=N)
    sub = rng.integers(0, 4, size=N)
    bt = rng.integers(0, 20, size=(N, 16))
    btp = rng.integers(0, 20, size=(N, 16))
    cols = [a.astype(np.int32) for a in (hdr, fmt, sub, bt, btp)]
    want_ctl = jfs.band_controls_dyn(*[jnp.asarray(a) for a in cols])
    want = jbd.slot_controls(want_ctl)
    tabs = tfs.codec_tables()
    got_ctl = tbd.band_controls_dyn(*[torch.tensor(a) for a in cols], tabs)
    got = tbd.slot_controls(got_ctl, tabs)
    for k in want_ctl:
        assert np.array_equal(np.asarray(want_ctl[k]), got_ctl[k].numpy()), k
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    assert ((got[0] >> 27) & 1).any()           # decimated bands present


def test_expand_matches_jax_on_random_bands():
    rng = np.random.default_rng(7)
    adv = rng.integers(0, 40, size=(64, 16))
    adv[:, 3] = 0                              # zero-width bands telescope
    starts = np.cumsum(adv, axis=1) - adv
    values = rng.integers(-2 ** 28, 2 ** 28, size=(64, 16))
    want = jbd._expand(jnp.asarray(starts, jnp.int32),
                       jnp.asarray(values, jnp.int32), 256)
    got = tbd._expand(torch.tensor(starts), torch.tensor(values), 256)
    assert np.array_equal(np.asarray(want), got.numpy())


def test_symbol_decode_plain_matches_decode_flat(catalog, jax_decode):
    pool, sb, *_ = catalog[0]
    n_steps = catalog[0][10]
    _, (packed, scale, total) = _port_slots(catalog)
    got = tbd.decode94_symbols_plain(torch.tensor(pool.astype(np.uint8)),
                                     _t(sb), packed, n_steps,
                                     catalog[1]["cb_flat"])
    dense, _, _ = jax_decode
    assert got.shape == dense.shape == (sb.shape[0], 256)
    assert np.array_equal(dense & 0xFFFF, got.numpy())
    assert (got != 0).sum() > 100_000          # real payload, not fillers


def _compact_torch(ca):
    """Compact host columns (numpy) -> the decode94_fb arguments on the
    CPU, as packed_to_device gives them."""
    return dict(pool_u8=torch.tensor(ca["pool_u8"]),
                sid=torch.tensor(ca["sid"].astype(np.int32)),
                start_bit=torch.tensor(ca["start_bit"]),
                bt_u8=torch.tensor(ca["bt_u8"]),
                mix=torch.tensor(ca["mix_u16"].astype(np.int32)),
                hdr_tab=torch.tensor(ca["hdr_tab"]),
                fmt_tab=torch.tensor(ca["fmt_tab"]),
                sub_tab=torch.tensor(ca["sub_tab"]),
                n_steps=ca["n_steps"])


def test_symbol_decode_cpu_dispatch_and_cuda_only_kernel(catalog):
    # decode94_fb takes its plain version for CPU tensors, launches nothing
    # there, and its kernel wrapper refuses CPU tensors
    tabs = catalog[1]
    args = _compact_torch(catalog[2])
    before = dict(kernels.LAUNCHES)
    plain = tbd.decode94_fb_plain(**args, tabs=tabs)
    via = tbd.decode94_fb(**args, tabs=tabs)
    assert torch.equal(plain, via)
    assert plain.shape == (args["sid"].shape[0], 512)
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        kernels.decode94_fb(**args, tabs=tabs)


def _random_catalog(seed, like):
    """Random compact columns at the asset catalog's shapes (frames, pool
    bytes, n_steps), so the JAX decode reuses its compiled scan: random
    pool bytes, sorted stream ids, random headers with $7F terminators at
    band 0 and mid-list and $40 halved bands, both format types, every
    subtype, and band types 0..19."""
    rng = np.random.default_rng(seed)
    N, L, S = like["sid"].shape[0], like["pool_u8"].size, 24
    sid = np.sort(rng.integers(0, S, size=N)).astype(np.uint16)
    hdr = rng.integers(0, 0x80, size=(S, 16))
    hdr[rng.random((S, 16)) < 0.3] |= 0x40
    hdr[1, 0] = 0x7F                         # no bands at all
    hdr[2, 7] = 0x7F                         # the list ends mid-way
    hdr[rng.random((S, 16)) < 0.03] = 0x7F
    hdr[:, 0] |= rng.integers(0, 2, size=S) << 7           # format type
    hdr[:, 1:3] |= rng.integers(0, 2, size=(S, 2)) << 7    # subtype bits
    bt = rng.integers(0, 20, size=(N, 16))
    bt[rng.random((N, 16)) < 0.2] = 0
    return dict(pool_u8=rng.integers(0, 256, size=L, dtype=np.uint8),
                sid=sid,
                start_bit=rng.integers(0, L * 8, size=N).astype(np.int32),
                bt_u8=bt.astype(np.uint8),
                mix_u16=rng.integers(0, 1 << 16, size=N).astype(np.uint16),
                hdr_tab=hdr.astype(np.uint8),
                fmt_tab=(hdr[:, 0] >> 7).astype(np.uint8),
                sub_tab=(((hdr[:, 1] >> 6) & 2) | (hdr[:, 2] >> 7))
                .astype(np.uint8),
                n_steps=like["n_steps"])


def _wide(ca):
    """The wide per-frame columns of compact ones, as the JAX pack makes
    them: per-frame header/fmt/sub, and the previous frame's band types
    within a stream."""
    sid = ca["sid"].astype(np.int64)
    start = np.concatenate([[True], sid[1:] != sid[:-1]])
    bt = ca["bt_u8"].astype(np.int32)
    btp = np.where(start[:, None], 0, np.concatenate([bt[:1], bt[:-1]]))
    return (ca["hdr_tab"].astype(np.int32)[sid],
            ca["fmt_tab"].astype(np.int32)[sid],
            ca["sub_tab"].astype(np.int32)[sid], bt, btp.astype(np.int32))


@pytest.mark.parametrize("case", ["assets", "random0", "random1"])
def test_decode94_fb_plain_matches_jax_pallas(catalog, jax_decode, case):
    tabs, ca = catalog[1], catalog[2]
    if case == "assets":
        dense, scale, total = jax_decode
    else:
        ca = _random_catalog(int(case[-1]), ca)
        hdr, fmt, sub, bt, btp = _wide(ca)
        assert set(fmt) == {0, 1} and set(sub) == {0, 1, 2, 3}
        assert (ca["hdr_tab"][:, :3] & 0x40).any()          # halved bands
        assert ca["hdr_tab"][1, 0] & 0x7F == ca["hdr_tab"][2, 7] & 0x7F == 0x7F
        assert (ca["sid"][1:] != ca["sid"][:-1]).sum() >= 16
        dense, scale, total = _jax_decode_flat(
            ca["pool_u8"], ca["start_bit"], hdr, fmt, sub, bt, btp,
            ca["n_steps"])
        assert (total == 0).any() and (total > ca["n_steps"]).any()
    mix = ca["mix_u16"].astype(np.int32)
    want = pk.dequant_mix_pallas(jnp.asarray(dense),
                                 (jnp.asarray(scale), jnp.asarray(total)),
                                 jnp.asarray(mix), block=512, interpret=True)
    got = tbd.decode94_fb_plain(**_compact_torch(ca), tabs=tabs)
    assert got.shape == (ca["sid"].shape[0], 512) and got.dtype == torch.int32
    assert np.array_equal(np.asarray(want) & 0xFFFF, got.numpy())
    assert (got[:, 2:] != 0).sum() > 10_000


@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("with_prev", [False, True])
def test_dequant_mix_plain_matches_jax(jax_decode, reference, with_prev):
    dense, scale, total = jax_decode
    F = dense.shape[0]
    rng = np.random.default_rng(0)
    mix = rng.integers(0, 1 << 16, size=F).astype(np.int32)
    prev = (rng.integers(0, 1 << 16, size=(F, 512)).astype(np.int32)
            if with_prev else None)
    ctl = (jnp.asarray(scale), jnp.asarray(total))
    jprev = None if prev is None else jnp.asarray(prev)
    if reference == "xla":
        want = jbd.dequant_mix(jnp.asarray(dense), ctl, jnp.asarray(mix),
                               fb_prev=jprev)
    else:
        want = pk.dequant_mix_pallas(jnp.asarray(dense), ctl,
                                     jnp.asarray(mix), fb_prev=jprev,
                                     block=512, interpret=True)
    got = tbd.dequant_mix(_t(dense), (_t(scale), _t(total)), _t(mix),
                          None if prev is None else _t(prev))
    assert got.shape == (F, 512) and got.dtype == torch.int32
    assert np.array_equal(np.asarray(want) & 0xFFFF, got.numpy() & 0xFFFF)
