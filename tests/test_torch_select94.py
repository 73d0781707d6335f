"""The premises of csrc/encode94_select.cu, on the CPU, through plain
PyTorch models of what the kernel does (the kernel itself runs only on the
card: tests/test_torch_kernels_gpu.py):

- its scan: each frame's step as a map of the previous code's classes (0,
  or 1 + its column pip[code] on a band with dep, else 1: at most 6),
  a nibble each in a 32-bit word, built from the decisions; each lane's
  segment of ceil(Fmax/32) frames (at most 9 a round) composed into one
  map as a tree; a 32-lane Kogge-Stone prefix of the maps; the replay of
  each segment from its entry class, stepping the class by the frames'
  maps.  Its codes and columns equal select94_plain's (every slot)
  and the JAX package's core94.scan_codes_np, on shipped and random
  pip/dep tables, runs of silent frames, bands not kept, a code 15 right
  after a silent frame, and decision bytes past 15;
- its size pass's table: the scale table index and width of every
  (stream, slot, band, code, column) give derive_luts' sf and width;
- its size pass's lane layout: position + 1 on a frame's 256 lanes puts
  every band inside one warp, and the pairing of zero runs within each
  warp's 32 lanes (a band's first lane a run start) gives select94_plain's
  exact sizes.
"""

import types

import numpy as np
import pytest
import torch

from dcsexplorer_tpu.encoder import core94 as j_c94
from dcsexplorer_tpu_torch.encoder import core94 as c94
from dcsexplorer_tpu_torch.encoder import device94 as d94
from tests.test_torch_decide94 import DEAD, rdiv_model, scale_table

SLOTS = ((0, 0), (1, 0), (1, 3))
MAX_SEG = 9                          # the kernel's kMaxSeg
IDENTITY = 0x543210                  # the map of 6 classes that moves none


# ----------------------------------------------------------------------
# the scan

CLASSES = 6                          # 0, then 1 + each column


def image(m, x):
    """Nibble x of the map m: the image of class x."""
    return (m >> (4 * x)) & 15


def then(a, b):
    """The map b after a, class by class as the kernel composes."""
    c = torch.zeros_like(a)
    for x in range(CLASSES):
        c = c | (image(b, image(a, x)) << (4 * x))
    return c


def shift_lanes(m, d, fill):
    """Lane i gets lane i - d's value (a shuffle up by d)."""
    return torch.cat([torch.full_like(m[..., :d], fill), m[..., :-d]], -1)


def kernel_scan(out15, out14, silent, keep, pip, dep):
    """The kernel's scan in PyTorch: (codes, pidx) [B, K, F, 16].  The
    step of a frame depends on the previous code c only through its class,
    0 for c = 0, else 1 + pi(min(c, 15)) with pi(c) = pip[c] on a band
    with dep, else 0; a frame's map of the (at most 6) classes is packed
    a nibble each."""
    B, K, F = out15.shape[:3]
    o15 = out15.long().permute(0, 1, 3, 2, 4).reshape(B, K, 16, F * 5)
    o14 = out14.long().permute(0, 1, 3, 2, 4).reshape(B, K, 16, F * 5)
    dead = (silent.permute(0, 2, 1)[:, None]
            | ~keep[:, None, :, None]).expand(B, K, 16, F)
    pi_of = torch.where(dep[:, :, None],
                        pip.long().clamp(0, 4)[:, None, :], 0)  # [K,16,16]
    cls_of = torch.where(torch.arange(16) == 0, 0, 1 + pi_of)
    pi0 = pi_of[:, :, 0][None, :, :, None]
    n_cols = torch.where(dep, 5, 1)[None, :, :, None]

    def cls(c):
        return torch.gather(cls_of[None].expand(B, K, 16, 16), 3,
                            c.clamp(max=15))

    seg = min(-(-F // 32), MAX_SEG)
    lane = torch.arange(32)
    codes = torch.zeros((B, K, 16, F), dtype=torch.long)
    pidx = torch.zeros_like(codes)
    state = torch.zeros((B, K, 16, 1), dtype=torch.long)
    for r0 in range(0, F, 32 * seg):
        n = min(32 * seg, F - r0)
        maps = []                            # each segment frame's map
        for j in range(MAX_SEG):
            i = lane * seg + j
            f = (r0 + i).clamp(max=F - 1).expand(B, K, 16, 32)
            mf = cls(torch.gather(o14, 3, f * 5 + pi0))
            for jj in range(5):
                c = cls(torch.gather(o15, 3, f * 5 + jj))
                mf = mf | torch.where(jj < n_cols, c << (4 * (jj + 1)), 0)
            mf = torch.where(torch.gather(dead, 3, f), 0, mf)
            maps.append(torch.where((j < seg) & (i < n), mf, IDENTITY))
        t = list(maps)                       # composed as a tree
        d = 1
        while d < MAX_SEG:
            for j in range(0, MAX_SEG - d, 2 * d):
                t[j] = then(t[j], t[j + d])
            d *= 2
        m = t[0]
        for dd in (1, 2, 4, 8, 16):
            m = torch.where(lane >= dd, then(shift_lanes(m, dd, IDENTITY), m),
                            m)
        x = torch.where(lane == 0, state,
                        image(shift_lanes(m, 1, IDENTITY), state))
        rc, rp = [], []                      # [B, K, 16, 32] a segment frame
        for j in range(seg):
            f = (r0 + lane * seg + j).clamp(max=F - 1).expand(B, K, 16, 32)
            pi = torch.where(x == 0, pi0, x - 1)
            c = torch.where(x == 0, torch.gather(o14, 3, f * 5 + pi),
                            torch.gather(o15, 3, f * 5 + pi))
            c = torch.where(torch.gather(dead, 3, f), 0, c)
            rc.append(c)
            rp.append(pi)
            nxt = image(maps[j], x)          # the class by the frame's map
            assert torch.equal(nxt, torch.where(lane * seg + j < n, cls(c),
                                                x))
            x = nxt
        # lane-major: frame r0 + lane * seg + j
        codes[..., r0:r0 + n] = torch.stack(rc, -1).flatten(-2)[..., :n]
        pidx[..., r0:r0 + n] = torch.stack(rp, -1).flatten(-2)[..., :n]
        state = cls(codes[..., r0 + n - 1:r0 + n])
    return codes.permute(0, 1, 3, 2), pidx.permute(0, 1, 3, 2)


def _tabs(K, tables, rng):
    tabs = dict(d94.DeviceEncoder94.for_slots(list(SLOTS[3 - K:]), "cpu")
                .named_buffers())
    if tables == "random":
        tabs["pip"] = torch.tensor(rng.integers(0, 5, size=(K, 16)),
                                   dtype=torch.int32)
        tabs["dep"] = torch.tensor(rng.random((K, 16)) < 0.5)
    return tabs


def _scan_inputs(B, K, F, rng, keep_prefix, decisions):
    """Random decisions (out14 <= 14 unless "bytes"), silent flags with a
    run of silent frames, kept bands (a prefix or any mask), and a band
    that wants code 15 in the frame after a silent one."""
    hi = 256 if decisions == "bytes" else 16
    out15 = rng.integers(0, hi, size=(B, K, F, 16, 5))
    out14 = rng.integers(0, hi - 1, size=out15.shape)
    silent = rng.random((B, F, 16)) < 0.2
    silent[:, F // 4:F // 4 + 3] = True
    if keep_prefix:
        keep = np.arange(16)[None] < rng.integers(6, 17, size=(B, 1))
    else:
        keep = rng.random((B, 16)) < 0.75
    keep[0, 5] = True
    silent[0, 1, 5], silent[0, 2:4, 5] = True, False
    out15[0, :, 2:4, 5] = 15
    out14[0, :, 2, 5] = 14
    t = torch.from_numpy
    return (t(out15.astype(np.uint8)), t(out14.astype(np.uint8)),
            t(silent), t(keep))


def _plain_codes(out15, out14, silent, keep, tabs):
    """select94_plain's codes and columns of every slot: [B, K, F, 16]."""
    B, K, F = out15.shape[:3]
    ci = torch.zeros((B, F, 255), dtype=torch.int32)
    nf = torch.full((B,), F, dtype=torch.int32)
    hdr = torch.zeros((B, K, 16), dtype=torch.uint8)
    codes, pidx = [], []
    for k in range(K):
        wanted = torch.zeros((B, K), dtype=torch.bool)
        wanted[:, k] = True
        row = d94.select94_plain(ci, out15, out14, silent, nf, keep, hdr,
                                 wanted, tabs)
        assert (row[:, 4 * K] == k).all()
        body = row[:, 4 * K + 1:].long().reshape(B, 2, F, 16)
        codes.append(body[:, 0])
        pidx.append(body[:, 1])
    return torch.stack(codes, 1), torch.stack(pidx, 1)


SCAN_CASES = [
    # (K, Fmax, tables, decisions): segments of 1, 2 and 9 frames (two
    # rounds at 528)
    (1, 16, "shipped", "codes"),
    (3, 16, "random", "codes"),
    (3, 48, "shipped", "codes"),
    (1, 48, "random", "codes"),
    (3, 272, "shipped", "codes"),
    (1, 272, "random", "codes"),
    (3, 272, "random", "codes"),
    (2, 528, "random", "codes"),
    (3, 48, "random", "bytes"),
]


@pytest.mark.parametrize("K,F,tables,decisions", SCAN_CASES)
def test_parallel_prefix_scan_equals_the_serial_scans(K, F, tables,
                                                      decisions):
    rng = np.random.default_rng(F * 7 + K)
    B = 3
    tabs = _tabs(K, tables, rng)
    shipped = tables == "shipped"
    out15, out14, silent, keep = _scan_inputs(B, K, F, rng, shipped,
                                              decisions)
    codes, pidx = kernel_scan(out15, out14, silent, keep, tabs["pip"],
                              tabs["dep"])
    want = _plain_codes(out15, out14, silent, keep, tabs)
    assert torch.equal(codes, want[0]) and torch.equal(pidx, want[1])
    assert codes[0, :, 1:4, 5].tolist() == [[0, 14, 15]] * K
    if not shipped or decisions != "codes":
        return
    # the JAX package's serial numpy scan (its pip of the slot, dep on the
    # type-1 slots' bands 0-2, a prefix of kept bands)
    for b in range(B):
        for k, (typ, _) in enumerate(SLOTS[3 - K:]):
            st = types.SimpleNamespace(bands_keep=int(keep[b].sum()))
            fs = types.SimpleNamespace(pidx_of_prev=tabs["pip"][k].numpy(),
                                       fmt_type=typ)
            jc, jp = j_c94.scan_codes_np(out15[b, k].numpy(),
                                         out14[b, k].numpy(),
                                         silent[b].numpy(), st, fs)
            np.testing.assert_array_equal(codes[b, k].numpy(), jc)
            np.testing.assert_array_equal(pidx[b, k].numpy(), jp)


# ----------------------------------------------------------------------
# the size pass

def size_table(hdr, keep, tabs):
    """The kernel's (stream, slot, band, code, column) -> (width, scale
    table index): index sc & 63 of a live code, else the sf = 1 entry."""
    is1 = tabs["is1"][None, :, None, None, None]
    adj = (tabs["xa_tab"].long()[:, :, :, None]
           + tabs["peff_tab"].long()[:, :, None, :])[None]
    sc = hdr.long()[:, :, :, None, None] + torch.where(is1, adj, 0)
    live = keep[:, None, :, None, None] & (torch.arange(16) >= 1)[:, None]
    w = torch.where(live, tabs["w_tab"].long()[None, :, :, :, None], 0)
    return w.expand(sc.shape), torch.where(live, sc & 63, DEAD)


def test_size_table_equals_derive_luts():
    rng = np.random.default_rng(3)
    tabs = _tabs(3, "shipped", rng)
    hdr = torch.from_numpy(rng.integers(0, 256, size=(16, 3, 16))
                           .astype(np.uint8))
    keep = torch.from_numpy(rng.random((16, 16)) < 0.7)
    w, idx = size_table(hdr, keep, tabs)
    sf_t, _, _ = scale_table(tabs["scale_mant"].numpy())
    w_l, sf_l, _, _ = d94.derive_luts(hdr, keep, tabs)
    assert torch.equal(torch.from_numpy(sf_t)[idx], sf_l.long())
    assert torch.equal(w, w_l.long())
    assert int(w.min()) >= -128 and int(w.max()) <= 127   # an int8 each


# lane v = position + 1 of a frame's 256 lanes (8 warps)
V = torch.arange(256)
BAND_OF_V = torch.where(V < 8, 0, torch.where(V < 16, 1,
                                              ((V >> 4) + 1).clamp(max=15)))
FIRST_LANES = [0x00010102] + [0x00010001] * 6 + [1]


def test_size_lanes_put_every_band_in_one_warp():
    pos = V - 1
    want = torch.as_tensor(c94.BAND_OF)[pos[1:]]
    assert torch.equal(BAND_OF_V[1:], want)
    for band in range(16):
        warps = set((V[1:][want == band] >> 5).tolist())
        assert len(warps) == 1
    first = torch.tensor([(FIRST_LANES[v >> 5] >> (v & 31)) & 1
                          for v in range(256)], dtype=torch.bool)
    starts = torch.as_tensor(c94.BAND_START) + 1
    assert first.nonzero()[:, 0].tolist() == starts.tolist()


def kernel_sizes(ci, codes, pidx, nf, keep, hdr, tabs):
    """The size pass on the kernel's lanes: bits [B, K] of every
    (stream, slot) from the codes, without the delta codes."""
    B, K, F, _ = codes.shape
    w_t, idx_t = size_table(hdr, keep, tabs)
    sf_t, m_t, s_t = (torch.from_numpy(x)
                      for x in scale_table(tabs["scale_mant"].numpy()))
    band = BAND_OF_V.expand(B, K, F, 256)
    code = torch.gather(codes, 3, band)
    pi = torch.gather(pidx, 3, band)
    bb = torch.arange(B)[:, None, None, None]
    kk = torch.arange(K)[None, :, None, None]
    w = w_t[bb, kk, band, code.clamp(max=15), pi.clamp(max=4)]
    idx = idx_t[bb, kk, band, code.clamp(max=15), pi.clamp(max=4)]
    a = torch.cat([torch.zeros_like(ci[:, :, :1]), ci], 2).long()[:, None]
    q = rdiv_model(a, sf_t[idx], m_t[idx], s_t[idx])
    valid = V >= 1
    live = valid & (code != 0) & (w != 0)
    is_cb = (w >= 1) & (w <= 6)
    bwc = w.clamp(0, 6)
    tz = tabs["tz_bits"].long()[bwc]
    zero = live & is_cb & (q == 0) & (tz > 0)
    first = torch.tensor([(FIRST_LANES[v >> 5] >> (v & 31)) & 1
                          for v in range(256)], dtype=torch.bool)
    lane = V & 31
    zw = zero.reshape(B, K, F, 8, 32)
    prev_z = torch.cat([torch.zeros_like(zw[..., :1]), zw[..., :-1]], -1)
    next_z = torch.cat([zw[..., 1:], torch.zeros_like(zw[..., :1])], -1)
    fw = first.reshape(8, 32)
    seg_last = torch.cat([fw[:, 1:], torch.ones_like(fw[:, :1])], -1)
    starts = zw & (~prev_z | fw)
    run_start = torch.cummax(torch.where(starts, lane.reshape(8, 32), -1),
                             -1).values
    head = zw & ~seg_last & next_z & ((lane.reshape(8, 32) - run_start) % 2
                                      == 0)
    shadow = torch.cat([torch.zeros_like(head[..., :1]), head[..., :-1]], -1)
    head, shadow = head.reshape(zero.shape), shadow.reshape(zero.shape)
    ref = 1 << (w - 1).clamp(min=0)
    stored = (q + ref) & ((1 << w.clamp(min=1)) - 1)
    cb = tabs["cb_bits"].long()[bwc, stored.clamp(0, 63)]
    bits = torch.where(head, tz, torch.where(is_cb, cb, w))
    f_live = torch.arange(F)[None, None, :, None] < nf.long()[:, None, None,
                                                              None]
    return torch.where(live & ~shadow & f_live, bits, 0).sum((2, 3))


def test_size_lanes_give_the_plain_sizes():
    """Sizes on the kernel's lanes, plus the delta codes of its replay,
    equal select94_plain's nbytes of every slot; zero runs are common
    (small coefficients against the scale factors)."""
    rng = np.random.default_rng(11)
    B, K, F = 4, 3, 48
    tabs = _tabs(K, "shipped", rng)
    out15, out14, silent, keep = _scan_inputs(B, K, F, rng, False, "codes")
    ci = torch.from_numpy(rng.integers(-300, 300, size=(B, F, 255))
                          .astype(np.int32))
    ci[1] >>= 6
    ci[2, :, ::3] = 0
    ci[3, :4, :] = torch.where(torch.arange(255) % 2 == 1, 1 << 20,
                               -(1 << 20))
    hdr = torch.from_numpy(rng.integers(0, 48, size=(B, K, 16))
                           .astype(np.uint8))
    nf = torch.tensor([F, 1, 30, 47], dtype=torch.int32)
    codes, pidx = kernel_scan(out15, out14, silent, keep, tabs["pip"],
                              tabs["dep"])
    bits = kernel_sizes(ci, codes, pidx, nf, keep, hdr, tabs)
    prev = torch.cat([torch.zeros_like(codes[:, :, :1]), codes[:, :, :-1]],
                     2)
    dbits = tabs["delta_bits"].long()
    di = (codes - prev - c94.DELTA_LO).clamp(0, dbits.numel() - 1)
    f_live = torch.arange(F)[None, :, None] < nf.long()[:, None, None]
    bits = bits + torch.where(keep[:, None, None, :] & f_live[:, None],
                              dbits[di], 0).sum((2, 3))
    wanted = torch.ones((B, K), dtype=torch.bool)
    row = d94.select94_plain(ci, out15, out14, silent, nf, keep, hdr, wanted,
                             tabs)
    nbytes = (row[:, :4 * K].long().reshape(B, K, 4)
              << torch.tensor([0, 8, 16, 24])).sum(-1)
    assert torch.equal(18 + (bits + 7) // 8, nbytes)
