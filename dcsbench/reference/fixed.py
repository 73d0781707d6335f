"""ADSP-2105 fixed-point arithmetic — the DCS numerics contract.

The original DCS firmware ran on an ADSP-2105, whose MAC/shifter semantics
(1.15 fractional multiplies, 40-bit accumulator rounding with a convergent-
rounding quirk, saturation, EXP/NORM normalization) define the bit-exact
behavior every decoder stage must reproduce.  These helpers implement that
contract on plain Python ints (scalar oracle) and are mirrored 1:1 by the
frame-parallel PyTorch versions in ``fixmath.py``.  The benchmark's frozen
copy of the port's scalar decoder.

Reference anchors: DCSDecoder/DCSDecoderNative.h:809-906 and
DCSDecoderNative.cpp:3446-3580.

Conventions: uint16 values are ints in [0, 0xFFFF]; the MAC accumulator ``mr``
is an unsigned 64-bit value (int in [0, 2^64)).  Functions that update ``mr``
return ``(mr1, mr)`` tuples.
"""

M16 = 0xFFFF
M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1


def s16(v):
    """Interpret the low 16 bits of v as a signed int16."""
    v &= M16
    return v - 0x10000 if v & 0x8000 else v


def s32(v):
    """Interpret the low 32 bits of v as a signed int32."""
    v &= M32
    return v - (1 << 32) if v & 0x80000000 else v


def u16(v):
    return v & M16


def sat16(v):
    """Saturate a signed value to int16 range, returned as uint16."""
    if v < -32768:
        v = -32768
    elif v > 32767:
        v = 32767
    return v & M16


def mr1(mr):
    """High word (bits 16..31) of the accumulator."""
    return (mr >> 16) & M16


def bitshift32(val, by):
    """Logical shift of a 32-bit value; by>0 left, by<0 right."""
    val &= M32
    return (val << by) & M32 if by >= 0 else val >> -by


def bitshift_signed32(val, by):
    """Arithmetic shift of a signed 32-bit value; by>0 left, by<0 right.

    Returns the low 32 bits (unsigned representation), matching the
    reference's uint32 return.
    """
    v = s32(val)
    if v >= 0 or by >= 0:
        return bitshift32(val, by)
    by = -by
    if by < 32:
        return (v >> by) & M32  # Python >> is arithmetic: sign-fills
    return M32


def calc_exp32(xop):
    """ADSP EXP: redundant-sign-bit count of a 32-bit value, as 0 or negative."""
    xop &= M32
    res = 0
    if xop & 0x80000000:
        while xop & 0x40000000:
            res -= 1
            xop = (xop << 1) & M32
    else:
        while res > -31 and not (xop & 0x40000000):
            res -= 1
            xop = (xop << 1) & M32
    return res


def normalize32(mantissa):
    """ADSP EXP+NORM pair: returns (exponent as uint16, normalized mantissa)."""
    exp = calc_exp32(mantissa)
    if exp <= -32:
        mantissa = 0
    elif exp < 0:
        mantissa = (mantissa << -exp) & M32
    return exp & M16, mantissa & M32


def round_mr(mr, prod):
    """MAC rounding: mr += $8000, with the chip's convergent-rounding quirk
    (clear bit 16 when the just-added product's low word is exactly $8000).

    ``prod`` is the (signed) last product added/subtracted.  Returns (mr1, mr).
    """
    res = (mr + 0x8000) & M64
    if (prod & M16) == 0x8000:
        res &= ~0x10000
    return (res >> 16) & M16, res


def mulss(a, b):
    """1.15 signed×signed multiply; returns the MR1 word (uint16)."""
    prod = (s16(a) * s16(b)) << 1
    return (prod >> 16) & M16


def mulss_mr(a, b):
    """Like mulss, but also returns the full accumulator: (mr1, mr)."""
    prod = (s16(a) * s16(b)) << 1
    return (prod >> 16) & M16, prod & M64


def mulsu(a, b):
    """1.15 signed×unsigned multiply; returns the MR1 word (uint16)."""
    prod = (s16(a) * (b & M16)) << 1
    return (prod >> 16) & M16


def mulsu_mr(a, b):
    prod = (s16(a) * (b & M16)) << 1
    return (prod >> 16) & M16, prod & M64


def multiply_and_round(a, b):
    """MR = (a*b)<<1, rounded; returns (mr1, mr)."""
    prod = (s16(a) * s16(b)) << 1
    return round_mr(prod & M64, prod)


def multiply_round_add(mr, a, b):
    """MR += (a*b)<<1, rounded; returns (mr1, mr)."""
    prod = (s16(a) * s16(b)) << 1
    mr = (mr + prod) & M64
    return round_mr(mr, prod)


def multiply_round_sub(mr, a, b):
    """MR -= (a*b)<<1, rounded; returns (mr1, mr)."""
    prod = (s16(a) * s16(b)) << 1
    mr = (mr - prod) & M64
    return round_mr(mr, prod)
