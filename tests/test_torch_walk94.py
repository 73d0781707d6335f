"""The premises of the 1994+ walk (csrc/decode94_walk.cuh, shared by the
decode94_fb and decode94_bank kernels) and of segments94's kernel, held on
the CPU:

- the band list the walk builds before it runs (the bands that take
  positions, each with its pre-shifted fields, end and scale, then an end
  marker) reproduces slot_controls' per-position control words, scales and
  position counts, on the assets and on random headers;
- the codec tables keep a look-up within 23 bits and a step's consumption
  within 32, so a two-word window moves by at most one word a step;
- segments94_plain (and the JAX reference) on equal f0 entries, $FFFF
  entries and a lane whose first segment starts after frame 0, pinned;
- the native tracer's f0 rows do not descend and end in $FFFF entries, on
  a session6 batch: the kernel advances a segment index that only grows.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcsexplorer_tpu.models import romplay as jrp
from dcsexplorer_tpu_torch.models import flatsweep as fs
from dcsexplorer_tpu_torch.models import romplay
from dcsexplorer_tpu_torch.ops import band_decode as bd
from dcsexplorer_tpu_torch.refdec import decoder as rd
from dcsexplorer_tpu_torch.rom import zipload

from .test_torch_kernels_gpu import SESSION6_ZIP, _random_catalog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets", "streams")


@pytest.fixture(scope="module")
def tabs():
    return fs.codec_tables()


def band_list(ctl, tabs):
    """Plain model of the band list decode94_walk.cuh builds from a frame's
    per-band controls (band_controls_dyn): the bands of non-zero advance in
    order, then the end marker (not live, end $FFFF), padded to 17.
    Returns ({field: [N, 17]}, last [N]): fields live, mw, is_cb, bias, cb,
    inc2, par, scale, end; last is the end of the last live band."""
    code = ctl["code"]
    adv = ctl["advance"]
    book = code.clamp(0, 6)
    is_book = (code >= 1) & (code <= 6)
    maxw = torch.where(is_book, tabs["maxw"].long()[book], code.clamp(max=17))
    c = code & 0x1F
    sc6 = torch.where(code != 0, ctl["scale_code"] & 0x3F, 0)
    ends = torch.cumsum(adv, 1)
    fields = dict(
        live=(code != 0).long(), mw=((code >> 5) | maxw) & 0x1F,
        is_cb=(c <= 6).long(),
        bias=torch.where(c <= 6, 1 << (c - 1).clamp(min=0), 0),
        cb=tabs["cb_base"].long()[book] & 0x3FF,
        inc2=(ctl["out_inc"] == 2).long(), par=(ends - adv) & 1,
        scale=tabs["scale_mant"].long()[sc6 & 3] >> (15 - ((sc6 >> 2) & 15)),
        end=ends)
    keep = adv > 0
    last = torch.where(keep & (code != 0), ends, 0).amax(1)
    # the kept bands first, in order; slot j >= count holds the marker
    order = torch.argsort((~keep).long(), dim=1, stable=True)
    slot = torch.arange(17)[None, :]
    count = keep.sum(1, keepdim=True)
    at = order.gather(1, slot[:, :16].expand(order.shape[0], 16))
    out = {}
    for name, v in fields.items():
        pad = torch.cat([v.gather(1, at), torch.zeros_like(v[:, :1])], 1)
        out[name] = torch.where(slot < count, pad,
                                0xFFFF if name == "end" else 0)
    return out, last


def walk_controls(lst, n_pos=256):
    """What the walk's step reads at each position t from the band list:
    (emits [N, n_pos], {field: [N, n_pos]}), taking the next entry where t
    reaches the current band's end (the first entry at t = 0)."""
    N = lst["end"].shape[0]
    ptr = torch.full((N,), -1, dtype=torch.long)
    end = torch.zeros(N, dtype=torch.long)
    emits, seen = [], {k: [] for k in lst}
    for t in range(n_pos):
        ptr = ptr + (end == t).long()
        cur = {k: v.gather(1, ptr[:, None])[:, 0] for k, v in lst.items()}
        end = cur["end"]
        filler = (cur["inc2"] == 1) & (((t ^ cur["par"]) & 1) == 1)
        emits.append((cur["live"] == 1) & ~filler)
        for k in lst:
            seen[k].append(cur[k])
    return torch.stack(emits, 1), {k: torch.stack(v, 1)
                                   for k, v in seen.items()}


def _columns(case):
    if case == "assets":
        streams = [open(p, "rb").read()
                   for p in sorted(glob.glob(os.path.join(ASSETS, "*.dcs94")))]
        a = fs.FlatSweep(streams).pack().compact_host_arrays()
        return {k: torch.tensor(a[k]) for k in
                ("sid", "bt_u8", "hdr_tab", "fmt_tab", "sub_tab")}
    return _random_catalog(3001, int(case[-1]), torch.device("cpu"))


@pytest.mark.parametrize("case", ["assets", "random0", "random1"])
def test_band_list_reproduces_slot_controls(tabs, case):
    c = _columns(case)
    hdr, fmt, sub, bt, btp, _ = bd.unpack_columns(
        c["sid"], c["bt_u8"], c["hdr_tab"], c["fmt_tab"], c["sub_tab"])
    ctl = bd.band_controls_dyn(hdr, fmt, sub, bt, btp, tabs)
    packed, scale, total = bd.slot_controls(ctl, tabs)
    packed, scale = packed.long(), scale.long()
    lst, last = band_list(ctl, tabs)
    # at most 16 bands and the marker; the ends ascend strictly
    assert (lst["end"][:, 16] == 0xFFFF).all()
    e = torch.where(lst["end"] == 0xFFFF, (1 << 20) + torch.arange(17),
                    lst["end"])
    assert (e[:, 1:] > e[:, :-1]).all()
    emits, seen = walk_controls(lst)
    # the walk emits exactly where slot_controls has a control word, with
    # that word's fields and scale
    assert torch.equal(emits, packed != 0)
    p = packed[emits]
    s = {k: v[emits] for k, v in seen.items()}
    cw = p & 0x1F
    assert torch.equal(s["mw"], (p >> 5) & 0x1F)
    assert torch.equal(s["cb"], (p >> 10) & 0x3FF)
    assert torch.equal(s["is_cb"], (cw <= 6).long())
    assert torch.equal(torch.where(cw <= 6, s["bias"], 0),
                       torch.where(cw <= 6, 1 << (cw - 1).clamp(0, 14), 0))
    assert torch.equal(s["inc2"], (p >> 27) & 1)
    assert torch.equal(s["scale"], scale[emits])
    # nothing emits from `last` on, and last never passes the count
    pos = torch.arange(256)[None, :]
    assert not (emits & (pos >= last[:, None])).any()
    assert (last <= total.long()).all()
    if case == "assets":
        assert emits.any(1).float().mean() > 0.99


def test_codec_tables_keep_the_window_within_two_words(tabs):
    # a look-up reads at most 17 | 7 = 23 bits, so bits past
    # 32 - (cursor & 7) are never read; a step consumes at most 23 bits,
    # so the window moves by at most one word a step; the fields fit the
    # band list entry (cb_base in 10 bits, scale and ends in 16)
    assert int(tabs["maxw"].max()) <= 17
    assert int((tabs["cb_flat"] >> 8).max()) <= 23
    assert int(tabs["cb_base"].max()) < 1 << 10
    assert int(tabs["scale_mant"].max()) < 1 << 16
    assert 2 * int(tabs["out_count"].sum()) < 1 << 16


def test_segments94_plain_on_tied_and_unused_entries():
    # lane 0: f0 = 0, 2, 2 (the second 2 counts), then $FFFF; lane 1: one
    # segment starting at frame 3 (segment 0 stands in before it)
    S, T, C, E = 1, 6, 2, 4
    comp = dict(
        f0=np.array([[[0, 2, 2, 0xFFFF], [3, 0xFFFF, 0xFFFF, 0xFFFF]]],
                    np.uint16),
        base=np.array([[[10, 20, 30, 99], [100, 0, 0, 0]]], np.uint16),
        slope=np.array([[[1, 0, 1, 7], [2, 0, 0, 0]]], np.uint8),
        mixv=np.array([[[5, 6, 7, 8], [9, 0, 0, 0]]], np.uint16))
    vol = np.array([[1, 2, 3, 4, 5, 255]], np.uint8)
    wire = romplay.pack_controls_wire(comp, vol)
    rows, mix, vols = romplay.segments94_plain(torch.tensor(wire), S, T, C, E)
    want_rows = [[10, 94], [11, 96], [30, 98], [31, 100], [32, 102],
                 [33, 104]]
    want_mix = [[5, 9], [5, 9], [7, 9], [7, 9], [7, 9], [7, 9]]
    assert rows.tolist() == want_rows
    assert mix.tolist() == want_mix
    assert vols.tolist() == [1, 2, 3, 4, 5, 255]
    # the JAX reference reads lane 0 the same way; it assumes segment 0
    # starts at frame 0 (a count of 0 indexes entry -1, which wraps to the
    # last), as every producer of the wire makes it (the test below)
    f0, base, slope, mixv, _ = jrp.unpack_controls_wire(
        jnp.asarray(wire), S, T, C, E)
    jrows, jmix = jrp.reconstruct_from_segments(f0, base, slope, mixv, T)
    assert np.asarray(jrows)[0, :, 0].tolist() == [r[0] for r in want_rows]
    assert np.asarray(jmix)[0, :, 0].tolist() == [m[0] for m in want_mix]


def test_native_trace_f0_rows_ascend_with_an_unused_tail():
    rs, _ = zipload.load_zip_file(SESSION6_ZIP)
    assert rs.check() == 1 and rs.os_version == rd.OS94
    S, T, C = 8, 300, 6
    events = []
    for b in range(S):
        ev = {}
        for t in range(1, 7):
            ev.setdefault((b * 7 + t * 3) % 40, []).extend([0x00, t])
        ev.setdefault(0, []).extend([0x55, 0xAA, 0x40 + b, (0x40 + b) ^ 0xFF])
        events.append(ev)
    with romplay.SessionServer(rs, S, T, n_ch=C, device="cpu") as srv:
        wire, E = srv.prepare(events)
    f0 = romplay.unpack_controls_wire(torch.tensor(wire), S, T, C, E)[0]
    f0 = f0.reshape(S * C, E)
    unused = f0 == 0xFFFF
    # segment 0 starts at frame 0; the used entries ascend; once an entry
    # is unused, every later one is
    assert (f0[:, 0] == 0).all()
    assert ((f0[:, 1:] >= f0[:, :-1]) | unused[:, 1:]).all()
    assert not (unused[:, :-1] & ~unused[:, 1:]).any()
    assert (f0[~unused] < T).all()
    # some lanes need more than one segment, and some leave entries unused
    assert (~unused).sum(1).max() > 1 and unused.any()
