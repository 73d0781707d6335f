"""The 1994+ encoder's format search on the device: PyTorch + CUDA.

Counterpart of the JAX package's ``encoder/device94.py``.  Per chunk of
streams the host canonicalizes PCM to int16, computes its own coefficients
(for the emission) and each stream's setup (``setup_compact``: only the 16
header scale codes per format slot, the kept bands and the wanted slots
travel).  The device runs three stages, each a hand-written kernel beside
its plain PyTorch version:

- ``analyze94``: raw int16 PCM -> the canonical int32 coefficients
  (``csrc/encode94_analyze.cu``), equal to the host's float64 evaluation
  for every input;
- ``decide94``: per (stream, slot, frame, band) the first fitting code
  and the wrap refinement, both variants (previous code nonzero / zero),
  and the silent flags (``csrc/encode94_decide.cu``; the per-slot tables
  come from the header scale codes, ``derive_luts``);
- ``select94``: the sequential band-type scan over frames, the exact size
  of every candidate, the winner, and one packed uint8 row per stream
  (``csrc/encode94_select.cu``):

      [ nbytes[K] as 4 LE bytes each | winner | codes[F,16] | pidx[F,16] ]

The host re-derives the winner's emission from its own coefficients (the
native ``dcs94_emit_with_codes``) and prepends the frame count and the
16-byte header.  Every decision is integer, so the streams are
byte-identical to the host encoder's.

Each dispatcher (``analyze94``, ``decide94``, ``select94``) runs the plain
version for CPU tensors and the kernel for CUDA tensors; nothing falls
back.  Contract of the coefficients everywhere: |ci| <= 2^20 (the analysis
clips to it; ``encode_batch`` and ``DeviceEncoder94.forward`` refuse a
caller's coefficients outside it, where the kernels' reciprocal division
would not be exact).
"""

import functools
import math
import time

import numpy as np
import torch
from torch import nn

from ..format import tables as T
from ..models.flatsweep import _device
from ..ops import kernels
from ..utils.profiling import span
from . import core94 as c94
from . import encoder as enc_mod

FRAME = c94.FRAME
PMAX = c94.PMAX
NBANDS = 16
NPAD = 32
WRAP_CMAX = c94.WRAP_CMAX
D_CLAMP = c94.D_CLAMP
BIG = 1 << 30                 # the min/max pad of a band's unused lanes
CAND_BIG = 1 << 14            # "no candidate" key of the wrap refinement

# the band layout the kernels assume (7, 8, 16 x 13, 32 positions)
assert c94.BAND_SIZES.tolist() == [7, 8] + [16] * 13 + [32]

# padded [16, 32] grid (bands x lanes) over the flat 255 positions
_PAD_SRC = np.zeros((NBANDS, NPAD), dtype=np.int64)
_PAD_MASK = np.zeros((NBANDS, NPAD), dtype=bool)
for _b in range(NBANDS):
    _n = int(c94.BAND_SIZES[_b])
    _PAD_SRC[_b, :_n] = c94.BAND_START[_b] + np.arange(_n)
    _PAD_MASK[_b, :_n] = True


# ----------------------------------------------------------------------
# host half

def _static_format_tables(slots):
    """Per-format-slot static tables (numpy; they depend only on the (type,
    subtype) slot list): w_tab/xa_tab [K,16,16], peff_tab [K,16,PMAX],
    pip [K,16], dep [K,16], is1 [K].  core94._format_setup's structure with
    hdr_scale factored out: the only per-stream input the device needs is
    the 16 header scale codes per slot.  peff_tab is zero past band 2 (the
    pre-adjustment applies to bands 0-2 only)."""
    K = len(slots)
    w_tab = np.zeros((K, 16, 16), dtype=np.int32)
    xa_tab = np.zeros((K, 16, 16), dtype=np.int32)
    peff_tab = np.zeros((K, 16, PMAX), dtype=np.int32)
    pip = np.zeros((K, 16), dtype=np.int32)
    dep = np.zeros((K, 16), dtype=bool)
    for k, (t, sub) in enumerate(slots):
        if t == 0:
            w_tab[k] = np.arange(16)[None, :]
        else:
            preadj_map = np.asarray(T.PREADJ0 if sub == 0 else T.PREADJ3)
            pvals = sorted(set(int(x) for x in preadj_map))
            n_p = len(pvals)
            pip[k] = [pvals.index(int(preadj_map[c])) for c in range(16)]
            dep[k, :3] = True
            for b in range(16):
                xl = c94._xlat_for(b)
                w_tab[k, b] = xl[:, 0]
                xa_tab[k, b] = xl[:, 1]
            peff_tab[k, :3, :] = [pvals[min(pi, n_p - 1)]
                                  for pi in range(PMAX)]
    is1 = np.asarray([t != 0 for (t, _) in slots])
    return w_tab, xa_tab, peff_tab, pip, dep, is1


def _select_formats(params):
    """The format-candidate slot list (params only; shared by every
    stream).  (0,3) is dropped when (0,0) is present: its body is
    identical (core94.skip_dup_format)."""
    sel = [f for f in c94.FORMATS
           if (params.stream_format_type < 0
               or params.stream_format_type == f[0])
           and (params.stream_format_subtype < 0
                or params.stream_format_subtype == f[1])]
    if not sel:
        raise ValueError(
            "No available stream format types match the requested "
            "encoding parameters")
    if (0, 0) in sel and (0, 3) in sel:
        sel.remove((0, 3))
    return tuple(sel)


def _bucket(f):
    """Frame-count bucket of a batch: 16-frame granularity."""
    return max(16, -(-f // 16) * 16)


def setup_compact(ci_list, params, slots):
    """Host setup for a batch: per-stream StreamSetup (kept for emission)
    plus the compact device arrays: hdr_scale [B,K,16] u8, the kept-band
    mask, the wanted slots, and the shared thresholds (thr, dlim, cape,
    sil_max depend on params only; taken from the first stream)."""
    B = len(ci_list)
    K = len(slots)
    setups = []
    hdr_scale = np.zeros((B, K, 16), dtype=np.uint8)
    keep = np.zeros((B, 16), dtype=bool)
    wanted = np.ones((B, K), dtype=bool)
    for i, ci in enumerate(ci_list):
        st = c94.setup94(ci, params, wanted=list(slots))
        setups.append(st)
        for k, fs in enumerate(st.formats):
            # the int64 host build carries the < 2^31 range assert that
            # also guards the device's int32 table derivation
            assert (np.abs(fs.amax_lut) < (1 << 31)).all()
            assert (np.abs(fs.amin_lut) < (1 << 31)).all()
            assert fs.hdr_scale.max() < 256 and fs.hdr_scale.min() >= 0
            hdr_scale[i, k] = fs.hdr_scale
        keep[i, :st.bands_keep] = True
    thr = setups[0].thr.astype(np.int32) if setups else \
        np.zeros(16, np.int32)
    dlim = np.asarray([math.isqrt(max(int(t), 0)) + 1 for t in thr],
                      np.int32)
    cape = np.minimum(thr.astype(np.int64) + 1, 1 << 25).astype(np.int32)
    sil_max = int(setups[0].sil_max) if setups else 0
    return setups, dict(hdr_scale=hdr_scale, keep=keep, wanted=wanted,
                        thr=thr, dlim=dlim, cape=cape, sil_max=sil_max)


def _emit_from_packed(buf_row, ci, st, slots):
    """Host emission of one stream from its packed device row; the stream's
    length must equal the device's exact size of the winner."""
    from .. import native
    K = len(slots)
    F = st.n_frames
    nbytes = (buf_row[:4 * K].reshape(K, 4).astype(np.int64)
              * (1 << np.arange(4) * 8)[None, :]).sum(axis=1)
    winner = int(buf_row[4 * K])
    fmax16 = (buf_row.size - 4 * K - 1) // 32
    codes = buf_row[4 * K + 1: 4 * K + 1 + fmax16 * 16] \
        .reshape(fmax16, 16)[:F].astype(np.int8)
    pidx = buf_row[4 * K + 1 + fmax16 * 16:] \
        .reshape(fmax16, 16)[:F].astype(np.int8)
    fs = st.formats[winner]
    body = native.emit94_with_codes(ci, fs, codes, pidx, st.bands_keep)
    stream = st.n_frames.to_bytes(2, "big") + fs.header + body
    if len(stream) != int(nbytes[winner]):
        raise AssertionError(f"emitted {len(stream)} bytes, the device "
                             f"counted {int(nbytes[winner])}")
    return bytes(stream)


# ----------------------------------------------------------------------
# plain PyTorch versions of the three device stages, and their dispatchers

def rdiv_int(a, s):
    """Round-half-away-from-zero division, the canonical quantizer:
    sign(a) * floor((2|a| + s) / 2s), in int64 (s >= 1).  Equals
    core94.rdiv's exact-floor float32 form for |a| <= 2^20, s < 2^16."""
    a = a.long()
    s = s.long()
    q = torch.div(2 * a.abs() + s, 2 * s, rounding_mode="floor")
    return torch.where(a < 0, -q, q)


def analyze94_plain(pcm, fq):
    """int16 PCM [B, Fmax*240 + 240] (zero padded) and the int16 analysis
    matrix [256, 255] -> ci int32 [B, Fmax, 255]: frame f is samples
    f*240 .. f*240+255, ci = clip(floor((frame @ fq + 2^20) / 2^21),
    +-2^20).  The product runs in float64, exact for every int16 input
    (each term < 2^30, each sum < 2^38 < 2^53)."""
    B, L = pcm.shape
    F = (L - FRAME) // FRAME
    head = pcm[:, :F * FRAME].reshape(B, F, FRAME)
    tail = pcm[:, FRAME:FRAME + F * FRAME].reshape(B, F, FRAME)[:, :, :16]
    frames = torch.cat([head, tail], dim=2).double()
    p = torch.matmul(frames, fq.double()).long()
    ci = (p + (1 << (enc_mod.FQ_SHIFT - 1))) >> enc_mod.FQ_SHIFT
    return ci.clamp(-(1 << 20), 1 << 20).int()


def analyze94(pcm, fq):
    """PCM -> coefficients (see analyze94_plain): plain version for CPU
    tensors, csrc/encode94_analyze.cu for CUDA tensors."""
    if pcm.device.type == "cpu":
        return analyze94_plain(pcm, fq)
    return kernels.encode94_analyze(pcm, fq)


def derive_luts(hdr_scale, keep, tabs):
    """Per (stream, slot, band, code, pre-adjustment column) width, scale
    factor and coefficient-domain fit window from the header scale codes
    hdr_scale [B,K,16] and the kept-band mask keep [B,16]:
    (w, sf, amin, amax), each int32 [B,K,16,16,PMAX].  The device half of
    core94._format_setup, equal to its LUTs (setup_compact asserts that
    their int64 build stays under 2^31)."""
    hs = hdr_scale.long()[:, :, :, None, None]
    is1 = tabs["is1"][None, :, None, None, None]
    adj = tabs["xa_tab"].long()[:, :, :, None] \
        + tabs["peff_tab"].long()[:, :, None, :]
    sc = hs + torch.where(is1, adj[None], 0)
    codes = torch.arange(16, device=hs.device)
    live = keep[:, None, :, None, None] & (codes >= 1)[:, None]
    w = torch.where(live, tabs["w_tab"].long()[None, :, :, :, None], 0)
    w = w.expand(sc.shape)
    mant = tabs["scale_mant"].long()[sc & 3]
    sf = torch.where(live, mant >> (15 - ((sc >> 2) & 0xF)), 1).clamp(min=1)
    half = 1 << (w - 1).clamp(min=0)
    hprod = sf * half
    amax = hprod - ((sf + 2) >> 1)
    amin = -(hprod + ((sf - 1) >> 1))
    return tuple(t.int() for t in (w, sf, amin, amax))


def check_ci_range(lo, hi):
    """Refuse coefficients outside +-2^20 (the encoder kernels' range):
    lo and hi are the least and the greatest coefficient."""
    lim = kernels.ENCODE94_CI_LIMIT
    if lo < -lim or hi > lim:
        raise ValueError(f"coefficients in [{lo}, {hi}]: the encoder takes "
                         f"|ci| <= 2^20")


def _pad_grid(ci):
    """ci [B,F,255] -> the padded [B,F,16,32] grid (zeros past each band)
    and the lane mask [16,32]."""
    src = torch.as_tensor(_PAD_SRC, device=ci.device)
    mask = torch.as_tensor(_PAD_MASK, device=ci.device)
    cpad = ci[:, :, src.reshape(-1)].reshape(*ci.shape[:2], NBANDS, NPAD)
    return torch.where(mask, cpad, 0), mask


def decide94_plain(ci, sil_max, keep, thr, dlim, cape, hdr_scale, tabs):
    """The decision tables of every (stream, slot, frame, band, column).

    ci [B,F,255] int32; sil_max int; keep [B,16] bool; thr, dlim, cape [16]
    int32; hdr_scale [B,K,16] uint8.  Returns out15, out14 uint8
    [B,K,F,16,PMAX] and silent bool [B,F,16]:
    - out15: the first code 1..15 whose fit window holds the band's
      min/max (15 if none), then the wrap refinement: the least
      (width*16 + code) among that code and the codes c <= WRAP_CMAX below
      it whose exact capped error sum stays within thr (the candidate's
      range floor (2^w*sf - sf/2) must be under dlim);
    - out14: the same where the previous code is 0 (which excludes code 15:
      a first fit of 15 falls back to 14), so out14 <= 14 always;
    - silent: max - min <= sil_max.
    Every column is evaluated (past band 2 they repeat column 0: equal
    tables).  Equal to the numpy core's decision_tables_np on its live
    columns, and to the JAX program on every column its scan reads."""
    B, F, _ = ci.shape
    K = hdr_scale.shape[1]
    dev = ci.device
    cpad, mask = _pad_grid(ci)
    mn = torch.where(mask, cpad, BIG).amin(-1)                 # [B,F,16]
    mx = torch.where(mask, cpad, -BIG).amax(-1)
    silent = (mx - mn) <= sil_max
    w_lut, sf_lut, amin, amax = derive_luts(hdr_scale, keep, tabs)
    codes15 = torch.arange(1, 16, device=dev)[:, None]         # [15,1]
    cands = torch.arange(1, WRAP_CMAX + 1, device=dev)         # [C]
    a = cpad.long()[..., None]                                 # [B,F,16,32,1]
    lane = mask[..., None]                                     # [16,32,1]
    thr_l, dlim_l, cape_l = (t.long() for t in (thr, dlim, cape))
    out15 = torch.empty((B, K, F, 16, PMAX), dtype=torch.uint8, device=dev)
    out14 = torch.empty_like(out15)
    for k in range(K):
        # first fitting code per (stream, frame, band, column)
        fit = ((mn[:, :, :, None, None] >= amin[:, k, None, :, 1:])
               & (mx[:, :, :, None, None] <= amax[:, k, None, :, 1:]))
        best = torch.where(fit, codes15, 99).amin(3)           # [B,F,16,P]
        o15 = torch.where(best < 99, best, 15)
        wk = w_lut[:, k].long()                                # [B,16,16,P]
        for p in range(PMAX):
            # exact capped error sums of the candidates 1..WRAP_CMAX
            w_c = wk[:, :, 1:WRAP_CMAX + 1, p]                 # [B,16,C]
            sf_c = sf_lut[:, k, :, 1:WRAP_CMAX + 1, p].long()
            w = w_c[:, None, :, None, :]                       # [B,1,16,1,C]
            sf = sf_c[:, None, :, None, :]
            q = rdiv_int(a, sf)
            ref = 1 << (w - 1).clamp(min=0)
            msk = (1 << w.clamp(min=1)) - 1
            diff = (((q + ref) & msk) - ref) * sf - a
            dc = diff.abs().clamp(max=D_CLAMP)
            e = torch.minimum(dc * dc, cape_l[:, None, None])
            es = torch.where(lane, e, 0).sum(3)                # [B,F,16,C]
            valid = (w_c >= 1) & ((1 << w_c.clamp(min=1)) * sf_c - sf_c // 2
                                  <= dlim_l[:, None] - 1)      # [B,16,C]
            ok = (es <= thr_l[:, None]) & valid[:, None]
            cok = (ok & (cands < o15[..., p, None])
                   & keep[:, None, :, None])
            candmin = torch.where(cok, w_c[:, None] * 16 + cands,
                                  CAND_BIG).amin(3)            # [B,F,16]
            c15 = o15[..., p]
            w_orig = torch.gather(wk[..., p], 2, c15.permute(0, 2, 1))
            new15 = torch.minimum(candmin, w_orig.permute(0, 2, 1) * 16
                                  + c15) & 15
            key14 = wk[:, None, :, 14, p] * 16 + 14
            new14 = torch.where(c15 == 15,
                                torch.minimum(candmin, key14) & 15, new15)
            out15[:, k, :, :, p] = new15.to(torch.uint8)
            out14[:, k, :, :, p] = new14.to(torch.uint8)
    return out15, out14, silent


def decide94(ci, sil_max, keep, thr, dlim, cape, hdr_scale, tabs):
    """The decision tables (see decide94_plain): plain version for CPU
    tensors, csrc/encode94_decide.cu for CUDA tensors."""
    if ci.device.type == "cpu":
        return decide94_plain(ci, sil_max, keep, thr, dlim, cape, hdr_scale,
                              tabs)
    return kernels.encode94_decide(ci, sil_max, keep, thr, dlim, cape,
                                   hdr_scale, tabs)


def _code_lut(lut, codes, pidx):
    """lut [B,K,16,16,PMAX] at (band, codes, pidx) [B,K,F,16] -> [B,K,F,16]
    (codes clamped to 0..15, as a JAX gather clamps)."""
    B, K, F, _ = codes.shape
    idx = (codes.clamp(0, 15) * PMAX + pidx).permute(0, 1, 3, 2)
    flat = lut.reshape(B, K, 16, 16 * PMAX).long()
    return torch.gather(flat, 3, idx).permute(0, 1, 3, 2)


def select94_plain(ci, out15, out14, silent, nf, keep, hdr_scale, wanted,
                   tabs):
    """The band-type scan, the exact sizes, the winner and the packed rows.

    ci [B,F,255] int32; out15/out14 [B,K,F,16,PMAX] uint8 and silent
    [B,F,16] bool (decide94's); nf [B] int32 (frames past nf are padding:
    scanned, but no bits); keep [B,16] bool; hdr_scale [B,K,16] uint8;
    wanted [B,K] bool.  Per (stream, slot, band) the scan runs over the
    frames: pi = pip[prev] on type-1 bands 0-2 (else 0), the code is
    out14[pi] after a 0 (else out15[pi]), and 0 where silent or not kept.
    The size counts each kept band's delta code and each sample's codeword
    (zero pairs within a band as one symbol), nbytes = 18 + ceil(bits/8);
    the winner is the least nbytes*K + k among the wanted slots.  Returns
    uint8 [B, 4K + 1 + 32F]: nbytes[K] (4 LE bytes each), winner, the
    winner's codes [F,16], its pidx [F,16]."""
    B, F, _ = ci.shape
    K = hdr_scale.shape[1]
    dev = ci.device
    w_lut, sf_lut, _, _ = derive_luts(hdr_scale, keep, tabs)
    pip = tabs["pip"].long()[None].expand(B, K, 16)
    dep = tabs["dep"][None]
    dead = silent[:, None] | ~keep[:, None, None, :]          # [B,1,F,16]
    o15, o14 = out15.long(), out14.long()
    codes = torch.empty((B, K, F, 16), dtype=torch.long, device=dev)
    pidx = torch.empty_like(codes)
    prev = torch.zeros((B, K, 16), dtype=torch.long, device=dev)
    for f in range(F):
        pi = torch.where(dep, torch.gather(pip, 2, prev.clamp(0, 15)), 0)
        row = torch.where((prev == 0)[..., None], o14[:, :, f], o15[:, :, f])
        c = torch.gather(row, 3, pi[..., None])[..., 0]
        c = torch.where(dead[:, :, f], 0, c)
        codes[:, :, f] = c
        pidx[:, :, f] = pi
        prev = c

    # delta codes of the kept bands, in the live frames
    mask_f = (torch.arange(F, device=dev)[None] < nf[:, None].long())
    prev_rows = torch.cat([torch.zeros_like(codes[:, :, :1]),
                           codes[:, :, :-1]], dim=2)
    dbits = tabs["delta_bits"].long()
    di = (codes - prev_rows - c94.DELTA_LO).clamp(0, dbits.numel() - 1)
    db = torch.where(keep[:, None, None, :] & mask_f[:, None, :, None],
                     dbits[di], 0)

    # each sample's codeword length
    bw_b = _code_lut(w_lut, codes, pidx)                      # [B,K,F,16]
    sf_b = _code_lut(sf_lut, codes, pidx)
    band_of = torch.as_tensor(c94.BAND_OF, device=dev)
    live = ((codes != 0) & (bw_b != 0))[..., band_of]         # [B,K,F,255]
    bw = bw_b[..., band_of]
    q = rdiv_int(ci[:, None], sf_b[..., band_of])
    is_cb = (bw >= 1) & (bw <= 6)
    ref = torch.where(is_cb, 1 << (bw - 1).clamp(min=0), 0)
    stored = (q + ref) & ((1 << bw.clamp(min=1)) - 1)
    bwc = bw.clamp(0, 6)
    tz_bits = tabs["tz_bits"].long()
    zero = (q == 0) & is_cb & live & (tz_bits[bwc] > 0)

    # zero pairs: runs never cross a band; a run pairs from its start
    pos_in_band = torch.as_tensor(c94.POS_IN_BAND, device=dev)
    not_last = torch.as_tensor(c94.NOT_BAND_LAST, device=dev)
    no = torch.zeros_like(zero[..., :1])
    in_run = torch.cat([no, zero[..., :-1]], -1) & (pos_in_band != 0)
    gcol = torch.arange(255, device=dev)
    run_start = torch.cummax(torch.where(zero & ~in_run, gcol, -1),
                             dim=-1).values
    next_zero = torch.cat([zero[..., 1:], no], -1) & not_last
    pair_head = zero & ((gcol - run_start) % 2 == 0) & next_zero
    shadow = torch.cat([no, pair_head[..., :-1]], -1)

    # codebook lengths as step functions of the stored value
    cb_bits = tabs["bits_b0"].long()[bwc]
    for j in range(tabs["bits_t"].shape[1]):
        cb_bits += torch.where(stored >= tabs["bits_t"].long()[bwc, j],
                               tabs["bits_d"].long()[bwc, j], 0)
    sbits = torch.where(is_cb, cb_bits, bw)
    sbits = torch.where(pair_head, tz_bits[bwc], sbits)
    sbits = torch.where(live & ~shadow & mask_f[:, None, :, None], sbits, 0)

    nbits = db.sum((2, 3)) + sbits.sum((2, 3))               # [B,K]
    nbytes = 18 + (nbits + 7) // 8
    ks = torch.arange(K, device=dev)
    winner = torch.where(wanted, nbytes * K + ks, BIG).argmin(1)
    sel = winner[:, None, None, None].expand(B, 1, F, 16)
    nb = (nbytes[:, :, None] >> torch.tensor([0, 8, 16, 24], device=dev)) \
        & 0xFF
    return torch.cat([nb.reshape(B, 4 * K), winner[:, None],
                      torch.gather(codes, 1, sel).reshape(B, F * 16),
                      torch.gather(pidx, 1, sel).reshape(B, F * 16)],
                     dim=1).to(torch.uint8)


def select94(ci, out15, out14, silent, nf, keep, hdr_scale, wanted, tabs):
    """Scan, sizes, winner and packed rows (see select94_plain): plain
    version for CPU tensors, csrc/encode94_select.cu for CUDA tensors."""
    if ci.device.type == "cpu":
        return select94_plain(ci, out15, out14, silent, nf, keep, hdr_scale,
                              wanted, tabs)
    return kernels.encode94_select(ci, out15, out14, silent, nf, keep,
                                   hdr_scale, wanted, tabs)


# ----------------------------------------------------------------------
# the device program and the entry points

class DeviceEncoder94(nn.Module):
    """The device half of the format search for one slot list: (analyze ->)
    decide -> select, one packed uint8 row per stream.  Holds the int16
    analysis matrix, the slots' static tables and the codec's code tables
    as buffers on ``device``."""

    def __init__(self, fq, tabs, device="cuda"):
        """fq [256, 255] int16 (numpy); tabs: _static_format_tables'
        (w_tab, xa_tab, peff_tab, pip, dep, is1), numpy."""
        super().__init__()
        dev = torch.device(device)
        fq = np.asarray(fq)
        assert fq.shape == (256, 255)
        w_tab, xa_tab, peff_tab, pip, dep, is1 = tabs
        if not 1 <= len(is1) <= kernels.ENCODE94_MAX_SLOTS:
            raise ValueError(f"{len(is1)} format slots; expected 1..3")
        bufs = dict(
            fq=(fq, torch.int16), w_tab=(w_tab, torch.int32),
            xa_tab=(xa_tab, torch.int32), peff_tab=(peff_tab, torch.int32),
            pip=(pip, torch.int32), dep=(dep, torch.bool),
            is1=(is1, torch.bool), scale_mant=(T.SCALE_MANTISSA, torch.int32),
            cb_bits=(c94.CB_BITS, torch.int32),
            tz_bits=(c94.TZ_BITS, torch.int32),
            delta_bits=(c94.DELTA_BITS, torch.int32),
            bits_b0=(c94.BITS_B0, torch.int32),
            bits_t=(c94.BITS_T, torch.int32), bits_d=(c94.BITS_D, torch.int32))
        for name, (arr, dtype) in bufs.items():
            self.register_buffer(name, torch.tensor(
                np.ascontiguousarray(arr), dtype=dtype, device=dev))

    @classmethod
    def for_slots(cls, slots, device="cuda"):
        """Built from the port's own matrix and tables."""
        return cls(enc_mod.forward_matrix_q(), _static_format_tables(slots),
                   device)

    @classmethod
    def from_reference(cls, fq, tabs, device="cuda"):
        """Built from the JAX package's numpy arrays (its
        ``forward_matrix_q()`` and ``_static_format_tables(slots)``)."""
        return cls(fq, tabs, device)

    def forward(self, x, nf, sil_max, keep, thr, dlim, cape, hdr_scale,
                wanted):
        """x: int16 PCM [B, Fmax*240 + 240] (analyzed here) or int32
        coefficients [B, Fmax, 255]; nf [B] int32; sil_max int; keep [B,16]
        bool; thr, dlim, cape [16] int32; hdr_scale [B,K,16] uint8; wanted
        [B,K] bool.  Returns the packed rows, uint8 [B, 4K + 1 + 32 Fmax].
        Raises ValueError on int32 coefficients outside +-2^20 (one
        reduction; the analysis of int16 PCM clips to that range)."""
        tabs = dict(self.named_buffers())
        if x.dtype == torch.int16:
            ci = analyze94(x, self.fq)
        else:
            ci = x
            check_ci_range(*torch.stack(torch.aminmax(ci)).tolist())
        out15, out14, silent = decide94(ci, sil_max, keep, thr, dlim, cape,
                                        hdr_scale, tabs)
        return select94(ci, out15, out14, silent, nf, keep, hdr_scale,
                        wanted, tabs)


@functools.lru_cache(maxsize=None)
def _encoder(slots, device):
    return DeviceEncoder94.for_slots(list(slots), device)


def _to_device(arrays, dev):
    """numpy arrays -> tensors on dev: staged by numpy into pinned buffers
    from the caching host allocator, copied asynchronously to a card.
    (chip_smoke.py phase 13 read 6.7-19.1 ms a chunk through
    Tensor.pin_memory() on an H100's host, 0.8-0.9 this way.)"""
    out = {}
    for k, v in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if dev.type == "cuda":
            staged = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            staged.numpy()[...] = v
            t = staged.to(dev, non_blocking=True)
        out[k] = t
    return out


def _run(enc, x, nf, arrs, dev, spans=None):
    """Launch the device program on a chunk's arrays; returns the packed
    rows on the host (a pinned buffer filled asynchronously, with the event
    that marks its arrival, on a card).  On a card, spans (a list) receives
    the pair of CUDA events around the program's launches."""
    with span("dcs.encode.upload"):
        d = _to_device(dict(x=x, nf=nf, keep=arrs["keep"], thr=arrs["thr"],
                            dlim=arrs["dlim"], cape=arrs["cape"],
                            hdr_scale=arrs["hdr_scale"],
                            wanted=arrs["wanted"]), dev)
    with span("dcs.encode.dispatch"):
        if dev.type == "cuda" and spans is not None:
            spans.append((torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True)))
            spans[-1][0].record()
        packed = enc(d["x"], d["nf"], arrs["sil_max"], d["keep"], d["thr"],
                     d["dlim"], d["cape"], d["hdr_scale"], d["wanted"])
        if dev.type != "cuda":
            return packed, None
        if spans is not None:
            spans[-1][1].record()
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
    return host, done


def _fetch(host, done):
    with span("dcs.encode.fetch"):
        if done is not None:
            done.synchronize()
        return host.numpy()


def encode_batch(ci_list, params, device="cuda"):
    """Encode a batch of coefficient arrays ([F_i, 255] int32) in one
    device program.  Returns the stream bytes of each, byte-identical to
    core94.encode_stream94.  Raises ValueError on coefficients outside
    +-2^20."""
    for c in ci_list:
        check_ci_range(int(c.min()), int(c.max()))
    dev = _device(device)
    fmax = _bucket(max(ci.shape[0] for ci in ci_list))
    ci = np.zeros((len(ci_list), fmax, 255), dtype=np.int32)
    for i, c in enumerate(ci_list):
        ci[i, :c.shape[0]] = c
    nf = np.asarray([c.shape[0] for c in ci_list], np.int32)
    slots = _select_formats(params)
    setups, arrs = setup_compact(ci_list, params, slots)
    buf = _fetch(*_run(_encoder(slots, dev), ci, nf, arrs, dev))
    return [_emit_from_packed(buf[i], ci_list[i], st, slots)
            for i, st in enumerate(setups)]


def prepare_chunk(jobs, params, slots):
    """Host half of a chunk of (pcm, rate) jobs: int16 PCM, the host's own
    coefficients (for the emission) and setups, and the device inputs:
    (cis, setups, pcm [B, Fmax*240 + 240] int16, nf [B] int32, arrs)."""
    with span("dcs.encode.pack"):
        cis, pcms = [], []
        for pcm, rate in jobs:
            p16 = enc_mod.pcm_to_int16(pcm, rate)
            cis.append(enc_mod.analyze_frames_canonical(
                enc_mod.frames_from_pcm_raw(p16)))
            pcms.append(p16)
        nf = np.asarray([c.shape[0] for c in cis], np.int32)
        fmax = _bucket(int(nf.max()))
        pcm_pad = np.zeros((len(jobs), fmax * FRAME + FRAME), np.int16)
        for i, p16 in enumerate(pcms):
            pcm_pad[i, :p16.size] = p16
        setups, arrs = setup_compact(cis, params, slots)
        return cis, setups, pcm_pad, nf, arrs


def emit_chunk(buf, cis, setups, slots):
    """The streams of a chunk from its packed rows: [(stream, n_frames)]."""
    with span("dcs.encode.emit"):
        return [(_emit_from_packed(buf[i], cis[i], st, slots), st.n_frames)
                for i, st in enumerate(setups)]


def encode_jobs_pcm(jobs, params, device="cuda", chunk=None, stats=None):
    """Batched device encode from PCM, chunk by chunk (default 16 files a
    chunk): the host prepares chunk i+1 while the card searches chunk i,
    and emits chunk i while the card searches chunk i+1 (pinned buffers,
    asynchronous copies, one host thread).

    jobs: list of (pcm, sample_rate).  Returns list of (stream, n_frames),
    byte-identical to the host encoder for every input.  stats: a dict that
    accumulates the host's wall seconds of preparation ("prep_s") and of
    emission ("emit_s", the wait for the chunk's rows included) and
    receives, on a card, each chunk's device ms ("chunk_ms": CUDA events
    around its launches, after its upload)."""
    dev = _device(device)
    slots = _select_formats(params)
    n = len(jobs)
    if n == 0:
        return []
    chunk = chunk or min(16, n)
    enc = _encoder(slots, dev)
    ranges = [(i, min(i + chunk, n)) for i in range(0, n, chunk)]
    spans = [] if stats is not None else None
    secs = {"prep_s": 0.0, "emit_s": 0.0}

    def submit(lo, hi):
        t0 = time.perf_counter()
        cis, setups, pcm, nf, arrs = prepare_chunk(jobs[lo:hi], params,
                                                   slots)
        secs["prep_s"] += time.perf_counter() - t0
        return cis, setups, _run(enc, pcm, nf, arrs, dev, spans)

    out = []
    cur = submit(*ranges[0])
    for nxt_range in ranges[1:] + [None]:
        nxt = submit(*nxt_range) if nxt_range else None
        cis, setups, pending = cur
        t0 = time.perf_counter()
        out += emit_chunk(_fetch(*pending), cis, setups, slots)
        secs["emit_s"] += time.perf_counter() - t0
        cur = nxt
    if stats is not None:
        for k, v in secs.items():
            stats[k] = stats.get(k, 0.0) + v
        stats.setdefault("chunk_ms", []).extend(
            a.elapsed_time(b) for a, b in spans)
    return out
