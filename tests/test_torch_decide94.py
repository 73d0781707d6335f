"""The premises of csrc/encode94_decide.cu, on the CPU, through plain
numpy/PyTorch models of what the kernel does (the kernel itself runs only
on the card: tests/test_torch_kernels_gpu.py):

- its division by a reciprocal, (2|a| + sf) * m >> (32 + s), equals
  device94.rdiv_int for every |a| <= 2^20 and every scale factor the
  65-entry table holds, and the JAX package's float32 _rdiv on a sample;
- its 65-entry scale table, indexed by sc & 63, equals derive_luts' sf for
  every header code and every adjustment of the shipped slots;
- its pass list (distinct pre-adjustment columns), its first fit from the
  per-(pass, code) table and its minimum over every live candidate give
  decide94_plain's tables, on the shipped slots and on synthetic width
  tables;
- the kernel takes that full minimum; an exit at the first passing
  candidate (in increasing code) would be exact only where the
  per-(slot, band) monotone flag holds, and is wrong on a table without
  it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcsexplorer_tpu.encoder import device94 as j_d94
from dcsexplorer_tpu_torch.encoder import core94 as c94
from dcsexplorer_tpu_torch.encoder import device94 as d94
from dcsexplorer_tpu_torch.encoder import encoder as enc

SLOTS = ((0, 0), (1, 0), (1, 3))
DEAD = 64                           # the table's sf = 1 entry


def scale_table(mant):
    """The kernel's 65 entries (sf, m, s): sf of the scale code i & 63, or
    1 (entry 64); d = 2 sf, s = floor(log2(d - 1)), m = ceil(2^(32+s) / d)."""
    mant = np.asarray(mant, np.int64)
    i = np.arange(64)
    sf = np.maximum(1, mant[i & 3] >> (15 - ((i >> 2) & 15)))
    sf = np.append(sf, 1)
    s = np.asarray([int(2 * v - 1).bit_length() - 1 for v in sf])
    m = np.asarray([-(-(1 << (32 + int(e))) // int(2 * v))
                    for v, e in zip(sf, s)], np.int64)
    return sf, m, s


def rdiv_model(a, sf, m, s):
    """The kernel's rdiv: sign(a) * (__umulhi(2|a| + sf, m) >> s), on int64
    tensors."""
    n = 2 * a.abs() + sf
    q = ((n * m) >> 32) >> s
    return torch.where(a < 0, -q, q)


def test_reciprocal_division_is_exact_for_every_input():
    sf, m, s = scale_table(c94.T.SCALE_MANTISSA)
    assert len(set(sf[:64].tolist())) == 58 and sf.max() < 1 << 16
    d = 2 * sf
    assert (m < 1 << 32).all()
    assert ((1 << s) < d).all() and (d <= 1 << (s + 1)).all()
    a = torch.arange(-(1 << 20), (1 << 20) + 1, dtype=torch.int64)
    for v in sorted(set(sf.tolist())):          # one pass a distinct sf
        i = int(np.flatnonzero(sf == v)[0])
        got = rdiv_model(a, int(sf[i]), int(m[i]), int(s[i]))
        assert torch.equal(got, d94.rdiv_int(a, torch.tensor(v))), v


def test_reciprocal_division_equals_the_jax_rdiv():
    sf, m, s = scale_table(c94.T.SCALE_MANTISSA)
    rng = np.random.default_rng(10)
    idx = rng.integers(0, 65, size=200_000)
    a = rng.integers(-(1 << 20), (1 << 20) + 1, size=idx.size)
    a[:130] = np.repeat([-(1 << 20), 1 << 20], 65)       # the ends
    idx[:130] = np.tile(np.arange(65), 2)
    ties = sf[idx] % 2 == 0                               # 2|a| = (2q+1) sf
    a[ties] = np.sign(a[ties]) * (2 * (np.abs(a[ties]) // (2 * sf[idx][ties]))
                                  + 1) * (sf[idx][ties] // 2)
    over = np.abs(a) > 1 << 20                            # back inside
    a[over] -= np.sign(a[over]) * sf[idx][over]
    assert np.abs(a).max() <= 1 << 20
    want = np.asarray(j_d94._rdiv(jnp.asarray(a, jnp.int32),
                                  jnp.asarray(sf[idx], jnp.int32)))
    got = rdiv_model(*(torch.from_numpy(x) for x in (a, sf[idx], m[idx],
                                                      s[idx])))
    np.testing.assert_array_equal(got.numpy(), want)


def _tabs(slots, w_tab=None):
    tabs = dict(d94.DeviceEncoder94.for_slots(list(slots), "cpu")
                .named_buffers())
    if w_tab is not None:
        tabs["w_tab"] = torch.as_tensor(w_tab, dtype=torch.int32)
    return tabs


def test_scale_table_equals_derive_luts_for_every_header_code():
    tabs = _tabs(SLOTS)
    sf_t, _, _ = scale_table(tabs["scale_mant"].numpy())
    K = len(SLOTS)
    hdr = np.arange(256, dtype=np.uint8).reshape(16, 1, 16).repeat(K, 1)
    keep = torch.ones((16, 16), dtype=torch.bool)
    keep[3, 5:] = False                                   # dead bands too
    _, sf, _, _ = d94.derive_luts(torch.from_numpy(hdr), keep, tabs)
    is1 = tabs["is1"].numpy()[None, :, None, None, None]
    adj = (tabs["xa_tab"].numpy()[:, :, :, None]
           + tabs["peff_tab"].numpy()[:, :, None, :])[None]
    sc = hdr.astype(np.int64)[:, :, :, None, None] + np.where(is1, adj, 0)
    live = keep.numpy()[:, None, :, None, None] \
        & (np.arange(16) >= 1)[:, None]
    want = sf_t[np.where(live, sc & 63, DEAD)]
    np.testing.assert_array_equal(sf.numpy(), want)


def pass_list(tabs):
    """The kernel's passes: (k, band, p, columns it covers), the distinct
    pre-adjustment columns in (k, band, p) order."""
    is1, peff = tabs["is1"].numpy(), tabs["peff_tab"].numpy()
    out = []
    for k in range(len(is1)):
        for band in range(16):
            cols = [p for p in range(5) if p == 0 or (
                is1[k] and peff[k, band, p] != peff[k, band, p - 1])]
            for j, p in enumerate(cols):
                nxt = cols[j + 1] if j + 1 < len(cols) else 5
                out.append((k, band, p, nxt - p))
    return out


def monotone(w_tab):
    """The per-(slot, band) flag: widths of codes 1..6 never decrease."""
    w = np.asarray(w_tab)[:, :, 1:7]
    return (np.diff(w, axis=2) >= 0).all(axis=2)


def decide_model(ci, sil_max, keep, thr, dlim, cape, hdr, tabs,
                 exit_rule="never"):
    """The kernel's algorithm in PyTorch: per pass, min/max, the first fit
    from the code table, the capped error sum of every live candidate and
    the least passing key ("never": the kernel's rule); or the first
    passing candidate in increasing code where the monotone flag is set
    ("flag"), or everywhere ("always")."""
    B, F, _ = ci.shape
    K = hdr.shape[1]
    sf_t, m_t, s_t = (torch.from_numpy(x) for x in
                      scale_table(tabs["scale_mant"].numpy()))
    w_tab = tabs["w_tab"].long()
    mono = torch.from_numpy(monotone(w_tab.numpy()))
    cpad, mask = d94._pad_grid(ci)
    a = cpad.long()
    mn = torch.where(mask, cpad, d94.BIG).amin(-1).long()      # [B,F,16]
    mx = torch.where(mask, cpad, -d94.BIG).amax(-1).long()
    silent = (mx - mn) <= sil_max
    out15 = torch.full((B, K, F, 16, 5), 99, dtype=torch.uint8)
    out14 = out15.clone()
    codes = torch.arange(16)
    for k, band, p, ncols in pass_list(tabs):
        live = keep[:, band, None] & (codes >= 1)                  # [B,16]
        sc = hdr[:, k, band, None].long()
        if tabs["is1"][k]:
            sc = sc + tabs["xa_tab"][k, band].long() \
                + tabs["peff_tab"][k, band, p]
        idx = torch.where(live, sc & 63, DEAD)
        w = torch.where(live, w_tab[k, band], 0)                   # [B,16]
        sf = sf_t[idx]
        hprod = sf << (w - 1).clamp(min=0)
        amin = -(hprod + ((sf - 1) >> 1))
        amax = hprod - ((sf + 2) >> 1)
        fit = ((mn[:, :, band, None] >= amin[:, None, 1:])
               & (mx[:, :, band, None] <= amax[:, None, 1:]))       # [B,F,15]
        o15 = torch.where(fit.any(-1), fit.int().argmax(-1) + 1, 15)
        valid = (live & (w >= 1) & ((sf << w) - sf // 2
                                    <= int(dlim[band]) - 1))[:, 1:7]
        cand = torch.arange(1, 7)
        lv = valid[:, None] & (cand < o15[..., None])              # [B,F,6]
        ab = a[:, :, band, :, None]                                # [B,F,32,1]
        sfc, mc, s_c = (t[idx[:, 1:7]][:, None, None] for t in (sf_t, m_t,
                                                                s_t))
        wc = w[:, 1:7][:, None, None]
        n = 2 * ab.abs() + sfc
        q = ((n * mc) >> 32) >> s_c
        q = torch.where(ab < 0, -q, q)
        ref = 1 << (wc - 1).clamp(min=0)
        diff = (((q + ref) & ((1 << wc.clamp(min=1)) - 1)) - ref) * sfc - ab
        e = torch.minimum(diff.abs().clamp(max=d94.D_CLAMP) ** 2,
                          torch.tensor(int(cape[band])))
        es = torch.where(mask[band][:, None], e, 0).sum(2)         # [B,F,6]
        ok = lv & (es <= int(thr[band]))
        first = torch.where(ok, cand, 99).amin(-1, keepdim=True)
        stop = {"flag": bool(mono[k, band]), "always": True,
                "never": False}[exit_rule]
        take = ok & (cand == first) if stop else ok
        key = torch.where(take, wc[:, 0] * 16 + cand, d94.CAND_BIG)
        candmin = key.amin(-1)
        key15 = torch.gather(w, 1, o15.reshape(B, -1)).reshape(B, F) * 16 \
            + o15
        new15 = torch.minimum(candmin, key15) & 15
        key14 = w[:, 14, None] * 16 + 14
        new14 = torch.where(o15 == 15, torch.minimum(candmin, key14) & 15,
                            new15)
        out15[:, k, :, band, p:p + ncols] = new15[..., None].to(torch.uint8)
        out14[:, k, :, band, p:p + ncols] = new14[..., None].to(torch.uint8)
    assert int(out15.max()) < 16 and int(out14.max()) <= 14
    return out15, out14, silent


def _inputs(seed, B=6, F=12, small_codes=False, all_pass=False):
    """Coefficients from PCM of three amplitudes; header codes over 0..255
    (or the small codes that leave wide fit windows, so that many
    candidates are live); every band kept but in stream 0 (none) and 1
    (eight); the default params' thresholds, or on every odd band
    thresholds every candidate passes and on every even band -1, which
    none does."""
    rng = np.random.default_rng(seed)
    amp = np.asarray([20000, 2000, 150, 20000, 2000, 150])[:B, None]
    pcm = (rng.standard_normal((B, F * 240 + 240)) * amp).clip(
        -32768, 32767).astype(np.int16)
    ci = d94.analyze94_plain(torch.from_numpy(pcm),
                             torch.from_numpy(enc.forward_matrix_q()))
    hdr = rng.integers(0, 24 if small_codes else 256, size=(B, 3, 16))
    keep = np.ones((B, 16), bool)
    keep[0] = False
    keep[1, 8:] = False
    _, arrs = d94.setup_compact([np.zeros((1, 255), np.int32)],
                                enc.CompressionParams(), SLOTS)
    thr, dlim, cape = (np.array(arrs[k]) for k in ("thr", "dlim", "cape"))
    if all_pass:
        thr[1::2], dlim[1::2], cape[1::2] = 1 << 30, 2 ** 31 - 1, 1 << 25
        thr[0::2] = -1
    t = lambda x, dt: torch.tensor(np.asarray(x), dtype=dt)
    return (ci, int(arrs["sil_max"]), t(keep, torch.bool),
            t(thr, torch.int32), t(dlim, torch.int32), t(cape, torch.int32),
            t(hdr, torch.uint8))


def _w_tab(kind, seed=4):
    """The shipped widths, or codes 1..6 rewritten: "dips" (c + a step in
    -2..2: some fall, so the flag is off) or "rising" (sorted, ties kept:
    the flag is on)."""
    w = _tabs(SLOTS)["w_tab"].numpy().copy()
    rng = np.random.default_rng(seed)
    if kind == "dips":
        step = rng.integers(-2, 3, (3, 16, 6))
        w[:, :, 1:7] = np.clip(np.arange(1, 7) + step, 1, 15)
        assert not monotone(w).all()
    elif kind == "rising":
        w[:, :, 1:7] = np.sort(rng.integers(1, 9, (3, 16, 6)), axis=2)
        assert monotone(w).all()
    return w


@pytest.mark.parametrize("kind", ["shipped", "dips", "rising"])
def test_full_minimum_and_flagged_exit_equal_the_plain_minimum(kind):
    tabs = _tabs(SLOTS, _w_tab(kind))
    if kind == "shipped":
        assert monotone(tabs["w_tab"].numpy()).all()
    for seed, small, all_pass in ((1, False, False), (2, True, False),
                                  (3, True, True)):
        args = _inputs(seed, small_codes=small, all_pass=all_pass)
        want = d94.decide94_plain(*args, tabs)
        for rule in ("flag", "never"):
            got = decide_model(*args, tabs, exit_rule=rule)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (kind, seed, rule)
        if kind == "dips" and all_pass:
            # an exit that ignores the flag misses a later candidate's
            # smaller key
            got = decide_model(*args, tabs, exit_rule="always")
            assert not torch.equal(got[0], want[0])


@pytest.mark.parametrize("slots, per_frame", [
    (SLOTS, 63), (((1, 3),), 28), (((0, 0),), 16), (((1, 0), (1, 3)), 47)])
def test_pass_list_counts_the_distinct_columns(slots, per_frame):
    tabs = _tabs(slots)
    passes = pass_list(tabs)
    assert len(passes) == per_frame
    # the count the bound charges: a column whose adjustment differs from
    # the previous column's, on a type-1 slot
    peff = tabs["peff_tab"]
    distinct = torch.ones_like(peff, dtype=torch.bool)
    distinct[:, :, 1:] = tabs["is1"][:, None, None] & (
        peff[:, :, 1:] != peff[:, :, :-1])
    assert int(distinct.sum()) == per_frame
    assert sum(n for *_, n in passes) == 5 * 16 * len(slots)
