"""Inverse transforms and overlap resolve of both families, plain PyTorch.

The benchmark's frozen copy of the port's plain transforms (its
``ops/transform.py`` without the kernel dispatchers): the 1994+ planar
transform (center fix-ups, three fold/twiddle pre-passes and a six-stage
radix-2 integer IFFT in 1.15 fixed point with saturation and the MAC's
convergent-rounding quirk) with its overlap resolve and extraction, and the
1993 family's transform (``transform93_raw_plain``) with its overlap
resolve.  Tables arrive as tensors (``reference.tables_torch``).
"""

import torch

from . import decode94 as band_decode
from .fixmath import M16, mac_round, mulss, overlap_mix, rotate_round, s16
from .fixmath import sat16, volume_shift


def _round_sub(p_a, p_b):
    """round(p_a - p_b) of two pre-shift products (MulSS + round-sub)."""
    return mac_round(p_a - p_b, p_b)


def _round_add(p_a, p_b):
    return mac_round(p_a + p_b, p_b)


def transform94_planar_plain(fb, vol_shift, tabs):
    """Plain version of the transform kernel.

    fb [B, 512] int32 u16 storage (words 0..$101 are read); vol_shift [B].
    Returns (re [B, 128], im [B, 128]) int32 u16 storage.
    """
    B = fb.shape[0]
    dev = fb.device
    fb = fb.long()

    # center fix-ups: words $80/$81 are read only by pre-pass 3
    fb128 = mulss(fb[:, 0x80], 0x8000)
    fb129 = mulss((-s16(fb[:, 0x81])) & M16, 0x8000)

    desc = 0x100 - 2 * torch.arange(64, device=dev)     # $100, $FE, ...
    x0 = s16(fb[:, 0:128:2])
    x1 = s16(fb[:, 1:128:2])
    y0 = s16(fb[:, desc])
    y1 = s16(fb[:, desc + 1])

    # pre-pass 1: fold the ends through +/- sums, then negate via x$8000
    n_x0 = s16(mulss(sat16(x0 + y0), 0x8000))
    n_y0 = s16(mulss(sat16(x0 - y0), 0x8000))
    n_x1 = s16(mulss(sat16(x1 - y1), 0x8000))
    n_y1 = s16(mulss(sat16(x1 + y1), 0x8000))

    # pre-pass 2: complex twiddle fold with rounding
    c0 = s16(tabs["p2_c0"]).reshape(1, 64)
    c1 = s16(tabs["p2_c1"]).reshape(1, 64)
    prod0 = _round_sub(n_y1 * c1, n_y0 * c0)
    prod1 = _round_add(n_y1 * c0, n_y0 * c1)
    fx0 = s16(sat16(prod1 + n_x0))
    fx1 = s16(sat16(prod0 + n_x1))
    fy0 = sat16(n_x0 - prod1)          # descending order, like y0
    fy1 = sat16(prod0 - n_x1)

    # pre-pass 3: x[q] +/- y[128+q]; y[128], y[129] are the center
    # fix-ups, y[130..255] the folded y planes in ascending order
    yA = s16(torch.cat([fb128[:, None], torch.flip(fy0, [1])[:, :63]], 1))
    yB = s16(torch.cat([fb129[:, None], torch.flip(fy1, [1])[:, :63]], 1))
    re = torch.cat([sat16(fx0 + yA), sat16(fx0 - yA)], 1)
    im = torch.cat([sat16(fx1 + yB), sat16(fx1 - yB)], 1)

    # six radix-2 stages; each group's halves are contiguous in the planes
    n_part, part = 2, 0x40
    for _ in range(6):
        r = re.reshape(B, n_part, part)
        i_ = im.reshape(B, n_part, part)
        h = part // 2
        c_cos = tabs["cos"][:n_part].reshape(1, n_part, 1)
        c_sin = tabs["sin"][:n_part].reshape(1, n_part, 1)
        t_re, t_im = rotate_round(r[:, :, h:], i_[:, :, h:], c_cos, c_sin)
        ur, ui = s16(r[:, :, :h]), s16(i_[:, :, :h])
        re = torch.cat([sat16(ur - t_re), sat16(ur + t_re)], 2).reshape(B, 128)
        im = torch.cat([sat16(ui - t_im), sat16(ui + t_im)], 2).reshape(B, 128)
        n_part *= 2
        part //= 2

    vs = vol_shift.reshape(B, 1)
    return volume_shift(re, vs).int(), volume_shift(im, vs).int()


def overlap_resolve_planar(re, im, stream_start, tabs):
    """Flat-axis overlap resolve + bit-reversed extraction.

    re/im [F, 128]: transform94_planar output for F flat frames;
    stream_start [F] bool (the carried overlap resets to zeros there).
    Each frame's 16 head words blend with the previous frame's 16 tail
    words.  Returns pcm [F, 240] int32 u16 storage.
    """
    F = re.shape[0]
    re, im = re.long(), im.long()
    ovl, save, ext = (tabs[k].long()
                      for k in ("ovl_half", "save_half", "ext_half"))
    cn, co = tabs["ovl_new"], tabs["ovl_old"]
    out = []
    for plane, k in ((re, 0), (im, 1)):
        tails = plane[:, save]
        carried = torch.cat([torch.zeros_like(tails[:1]), tails[:-1]], 0)
        carried = torch.where(stream_start[:, None], 0, carried)
        ext_plane = plane[:, ext]
        ext_plane[:, :8] = overlap_mix(plane[:, ovl], carried,
                                       cn[k::2].reshape(1, 8),
                                       co[k::2].reshape(1, 8))
        out.append(ext_plane)
    return torch.stack(out, dim=-1).reshape(F, 240).int()


def transform94_pcm_plain(fb, vol_shift, sid, tabs):
    """The inverse transform, then the overlap resolve with the carry reset
    where the stream id changes (and at frame 0).  fb [N, 512] int32 u16
    storage; vol_shift [N]; sid [N].  Returns pcm [N, 240] int32 u16
    storage."""
    re, im = transform94_planar_plain(fb, vol_shift, tabs)
    return overlap_resolve_planar(re, im, band_decode.stream_starts(sid),
                                  tabs)


# ----------------------------------------------------------------------
# 1993 family: transform93_raw, overlap_resolve93(_flat), transform93_pcm

def _i32(x):
    """The int32 value of the low 32 bits (the reference's wrap-around)."""
    return ((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def _mul_round93(a, b):
    """MR1 of round((s16(a) * s16(b)) << 1) with the MAC's tie rule."""
    prod = (s16(a) * s16(b)) << 1
    res = prod + 0x8000
    res = torch.where((prod & M16) == 0x8000, res & ~0x10000, res)
    return (res >> 16) & M16, res


def _taylor_sqrt93(fb0, fb1):
    """The magnitude fix-up of slot 0 (reference :633-704): fb0, fb1 [B]
    u16 storage -> the replacement value of slot 0, u16 storage.  The
    normalize loop runs its 31 steps on the int32 value; an even exponent
    halves exactly (floor); AR == 0 skips the series."""
    ar = s16(fb0)
    as_flag = ar < 0
    ar = torch.where(as_flag, -ar, ar) & M16
    v = _i32((s16(fb1) * s16(fb1) + s16(ar) * s16(ar)) << 1)

    exp = torch.zeros_like(v)
    xx = v
    for _ in range(31):
        more = torch.where(xx < 0, (xx & 0x40000000) != 0,
                           (exp > -31) & ((xx & 0x40000000) == 0))
        exp = torch.where(more, exp - 1, exp)
        xx = torch.where(more, _i32(xx << 1), xx)
    mant = torch.where(exp < 0, _i32(v << -exp), v)          # exp >= -31
    ar2 = (mant >> 16) & M16

    # 5-term Taylor series in the accumulator
    mr = 0x0D490000 + ((0x5D1D * s16(ar2)) << 1)
    mf = ar2
    for coef in (-22035, 0x46D6, -8790, 0x072D):
        mf, _ = _mul_round93(ar2, mf)
        mr = mr + ((coef * s16(mf)) << 1)

    # MultiplyAndRound(MR1(mr), 0x5A82) replaces mr where exponent is odd
    odd = (exp & 1) != 0
    _, res = _mul_round93((mr >> 16) & M16, 0x5A82)
    mr = torch.where(odd, res, mr)
    exponent = torch.div(torch.where(odd, exp + 1, exp), 2,
                         rounding_mode="floor") + 1
    # BitShiftSigned32 of the low 32 bits of mr
    low = _i32(mr)
    shifted = torch.where(exponent >= 0,
                          _i32(low << exponent.clamp(0, 31)),
                          low >> (-exponent).clamp(0, 31))
    arf = (shifted >> 16) & M16
    arf = torch.where(as_flag, (-s16(arf)) & M16, arf)
    return torch.where(ar2 == 0, ar2, arf)


def transform93_raw_plain(fb, vol_shift, tabs):
    """The 1993 inverse transform: fb [B, 512] u16 storage (words 0..255
    are read), vol_shift [B].  Returns raw [B, 256] int64 time words in
    natural order, volume-shifted: outputs 0..239, then the 16-word overlap
    tail before its blend.

    Planes re[k] = fb[2k], im[k] = fb[2k+1]: the slot-0 fix-up, the
    256 -> 512 expansion (the later write wins at the two colliding slots:
    re[192] takes yr - xr, im[64] takes yi - xi), seven radix-2 stages with
    wrapping (unsaturated) arithmetic, then the volume shift and the
    bit-reversed collection from the re plane (tabs["br93_half"])."""
    B = fb.shape[0]
    fb = fb.long()
    ar = _taylor_sqrt93(fb[:, 0], fb[:, 1])
    re0, im0 = fb[:, 0::2], fb[:, 1::2]
    xr, xi = s16(re0[:, 1:65]), s16(im0[:, 1:65])
    yr = s16(torch.flip(re0[:, 64:128], [1]))
    yi = s16(torch.flip(im0[:, 64:128], [1]))
    add_r, sub_r, bus_r = (xr + yr) & M16, (xr - yr) & M16, (yr - xr) & M16
    add_i, sub_i, bus_i = (xi + yi) & M16, (xi - yi) & M16, (yi - xi) & M16
    arc = ar[:, None]
    z1 = torch.zeros_like(arc)
    re = torch.cat([arc, add_r, torch.flip(add_r, [1])[:, 1:],
                    arc, sub_r[:, :63], torch.flip(bus_r, [1])], 1)
    im = torch.cat([z1, sub_i[:, :63], torch.flip(bus_i, [1]),
                    z1, add_i, torch.flip(add_i, [1])[:, 1:]], 1)

    n_part, part = 2, 0x80
    for _ in range(7):
        r = re.reshape(B, n_part, part)
        i_ = im.reshape(B, n_part, part)
        h = part // 2
        c_cos = tabs["cos"][:n_part].reshape(1, n_part, 1)
        c_sin = tabs["sin"][:n_part].reshape(1, n_part, 1)
        t_re, t_im = rotate_round(r[:, :, h:], i_[:, :, h:], c_cos, c_sin)
        ur, ui = s16(r[:, :, :h]), s16(i_[:, :, :h])
        re = torch.cat([(ur - t_re) & M16, (ur + t_re) & M16], 2).reshape(B,
                                                                          256)
        im = torch.cat([(ui - t_im) & M16, (ui + t_im) & M16], 2).reshape(B,
                                                                          256)
        n_part *= 2
        part //= 2
    return volume_shift(re[:, tabs["br93_half"].long()],
                        vol_shift.reshape(B, 1))


def _resolve93(raw, stream_start, tabs):
    """Blend each frame's 16 head words with the previous frame's 16 tail
    words (natural order; ovl_new on the new word, ovl_old, the reversed
    window, on the carried one).  Where stream_start holds, the carried
    words are zeros.  Returns pcm [F, 240] int32."""
    heads, tails = raw[:, :16], raw[:, 240:]
    carried = torch.cat([torch.zeros_like(tails[:1]), tails[:-1]], 0)
    carried = torch.where(stream_start[:, None], 0, carried)
    blended = overlap_mix(heads, carried, tabs["ovl_new"].reshape(1, 16),
                          tabs["ovl_old"].reshape(1, 16))
    return torch.cat([blended, raw[:, 16:240]], 1).int()


def overlap_resolve93_flat_plain(raw, stream_start, tabs):
    """Flat-axis overlap resolve of transform93_raw_plain's output: the
    carried tail zeroes at each stream's first frame.  raw [F, 256],
    stream_start [F] bool.  Returns pcm [F, 240] int32 (u16 storage)."""
    return _resolve93(raw, stream_start, tabs)


def transform93_pcm_plain(fb, vol_shift, sid, tabs):
    """transform93_raw, then the overlap resolve with the carry reset where
    the stream id changes (and at frame 0).  fb [N, 512]; vol_shift [N];
    sid [N].  Returns pcm [N, 240] int32 (u16 storage)."""
    raw = transform93_raw_plain(fb, vol_shift, tabs)
    return overlap_resolve93_flat_plain(raw, band_decode.stream_starts(sid),
                                        tabs)
