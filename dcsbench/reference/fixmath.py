"""ADSP-2105 fixed-point primitives in PyTorch (plain versions).

The benchmark's frozen copy of the port's plain primitives (the twins of
``fixed.py``'s scalar ones).  The ADSP computes in
int32 and relies on two's-complement wrap-around; every quantity it keeps is
a bit window below bit 32, so computing the same chains EXACTLY in int64 and
masking gives identical bits without any overflow.  Every function here
widens its tensor arguments to int64 and returns int64 tensors holding the
reference's values (u16 storage or s16 as documented).
"""

import torch

M16 = 0xFFFF


def _wide(x):
    return x.long() if isinstance(x, torch.Tensor) else x


def s16(x):
    """Reinterpret the low 16 bits as signed int16."""
    return ((_wide(x) & M16) ^ 0x8000) - 0x8000


def u16(x):
    return _wide(x) & M16


def sat16(v):
    """Saturate a signed value to the int16 range; returns u16 storage."""
    return torch.clamp(_wide(v), -32768, 32767) & M16


def mulss(a, b):
    """1.15 signed x signed multiply -> MR1 word (u16 storage)."""
    return ((s16(a) * s16(b)) >> 15) & M16


def mulsu(a, b):
    """1.15 signed x unsigned multiply -> MR1 word (u16 storage)."""
    return ((s16(a) * u16(b)) >> 15) & M16


def mac_round(acc, p_b):
    """s16 of bits 16..31 of round((acc) << 1), where acc is a sum of two
    products and p_b the SECOND one: the MAC's convergent-rounding quirk
    clears bit 16 when the low word of (p_b << 1) is exactly $8000."""
    mr = (acc << 1) + 0x8000
    mr = torch.where(((p_b << 1) & M16) == 0x8000, mr & ~0x10000, mr)
    return s16(mr >> 16)


def rotate_round(a_re, a_im, c_cos, c_sin):
    """The transform's complex rotate with MAC rounding:
    t_re = round(a_re*c_cos - a_im*c_sin), t_im = round(a_im*c_cos +
    a_re*c_sin).  Inputs u16 storage; outputs signed, in int16 range."""
    are, aim = s16(a_re), s16(a_im)
    cc, cs = s16(c_cos), s16(c_sin)
    p_b = aim * cs
    t_re = mac_round(are * cc - p_b, p_b)
    p_b2 = are * cs
    t_im = mac_round(aim * cc + p_b2, p_b2)
    return t_re, t_im


def overlap_mix(new_val, old_val, c_new, c_old):
    """Overlap-add blend round(new*c_new + old*c_old); u16 storage out."""
    a = (s16(new_val) * u16(c_new)) << 1
    b = (s16(old_val) * u16(c_old)) << 1
    return ((a + b + 0x8000) >> 16) & M16


def accum_mix(out_old, sample, scale, mix):
    """Scale-and-mix a band sample into a frame-buffer word (u16 storage):
    bits 16..31 of ((s16(out_old) << 16) | scaled) + s16(scaled)*u16(mix),
    scaled = low16(s16(sample) * u16(scale))."""
    scaled = (s16(sample) * u16(scale)) & M16
    prod = ((s16(out_old) << 16) | scaled) + s16(scaled) * u16(mix)
    return (prod >> 16) & M16


def volume_shift(x, vs):
    """Volume normalization s16(x) >> vs, u16 storage out.  The reference's
    int32 shift fills with the sign bit for vs >= 32; clamping the count to
    31 gives the same result and keeps the shift defined."""
    return (s16(x) >> torch.clamp(_wide(vs), 0, 31)) & M16
