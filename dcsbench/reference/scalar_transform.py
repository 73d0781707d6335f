"""Scalar inverse frequency transforms (RDFT⁻¹) for the two algorithm families.

Both compute the same mathematical transform; they differ in intermediate
fixed-point sequencing and therefore in accumulated rounding, so both must be
implemented for bit-exactness (reference rationale: DCSDecoderNative.h:717-749).

Anchors: 1994+ algorithm DCSDecoderNative.cpp:397-576; 1993 algorithm :614-813.

The frame buffer is a 512-entry list of uint16 ints; outputs are 240 uint16
PCM words written to ``out``; ``overlap`` is the carried 16-entry buffer.
"""

from . import tables as T
from .fixed import (M16, M32, M64, bitshift_signed32, mr1, mulss, mulsu_mr,
                    multiply_and_round, multiply_round_add, multiply_round_sub,
                    mulss_mr, normalize32, round_mr, s16, sat16)

_SIN = T.IFFT_COEFF[:128]
_COS = T.IFFT_COEFF[128:]
_BR = T.BITREV9
_OVL = T.OVERLAP_COEFF


def transform_frame_94x(fb, overlap, out, vol_shift):
    """1994+ inverse transform: twiddle pre-passes + 6-iteration IFFT over 256
    entries + volume shift + overlap-add + bit-reversed extraction."""
    # pre-pass 1: center elements and fold ends (reference :402-418)
    fb[0x80] = mulss(fb[0x80], 0x8000)
    fb[0x81] = mulss((-s16(fb[0x81])) & M16, 0x8000)
    p0, p1 = 0, 0x100
    for _ in range(0x40):
        x0, y0 = s16(fb[p0]), s16(fb[p1])
        x1, y1 = s16(fb[p0 + 1]), s16(fb[p1 + 1])
        fb[p0] = mulss(sat16(x0 + y0), 0x8000)
        fb[p1] = mulss(sat16(x0 - y0), 0x8000)
        fb[p0 + 1] = mulss(sat16(x1 - y1), 0x8000)
        fb[p1 + 1] = mulss(sat16(x1 + y1), 0x8000)
        p0 += 2
        p1 -= 2

    # pre-pass 2: complex twiddle fold (reference :420-456)
    i0, i1 = 2, 0
    p4, p5 = 0, 0x100
    for _ in range(0x40):
        c0 = int(T.IFFT_COEFF[_BR[i0]])
        c1 = int(T.IFFT_COEFF[_BR[i1]])
        x0, x1 = s16(fb[p4]), s16(fb[p4 + 1])
        xn0, xn1 = fb[p5], fb[p5 + 1]

        _, mr = mulss_mr(xn1, c1)
        v, mr = multiply_round_sub(mr, xn0, c0)
        prod0 = s16(v)
        _, mr = mulss_mr(xn1, c0)
        v, mr = multiply_round_add(mr, xn0, c1)
        prod1 = s16(v)

        fb[p4] = sat16(prod1 + x0)
        fb[p4 + 1] = sat16(prod0 + x1)
        fb[p5] = sat16(x0 - prod1)
        fb[p5 + 1] = sat16(prod0 - x1)
        p4 += 2
        p5 -= 2
        i0 += 4
        i1 += 4

    # pre-pass 3: butterfly halves (reference :458-471)
    p0, p1 = 0, 0x80
    for _ in range(0x40):
        x0, y0 = s16(fb[p0]), s16(fb[p1])
        x1, y1 = s16(fb[p0 + 1]), s16(fb[p1 + 1])
        fb[p0] = sat16(x0 + y0)
        fb[p1] = sat16(x0 - y0)
        fb[p0 + 1] = sat16(x1 + y1)
        fb[p1 + 1] = sat16(x1 - y1)
        p0 += 2
        p1 += 2

    # 6-iteration in-place Cooley-Tukey IFFT (reference :480-524)
    n_partitions, partition_size = 2, 0x40
    for _ in range(6):
        p0, p1 = 0, partition_size
        for part in range(n_partitions):
            c_sin = int(_SIN[part])
            c_cos = int(_COS[part])
            for _ in range(partition_size // 2):
                a_re, a_im = fb[p1], fb[p1 + 1]
                _, mr = mulss_mr(a_re, c_cos)
                v, mr = multiply_round_sub(mr, a_im, c_sin)
                t_re = s16(v)
                _, mr = mulss_mr(a_im, c_cos)
                v, mr = multiply_round_add(mr, a_re, c_sin)
                t_im = s16(v)
                u_re, u_im = s16(fb[p0]), s16(fb[p0 + 1])
                fb[p0] = sat16(u_re - t_re)
                fb[p0 + 1] = sat16(u_im - t_im)
                fb[p1] = sat16(u_re + t_re)
                fb[p1 + 1] = sat16(u_im + t_im)
                p0 += 2
                p1 += 2
            p0 += partition_size
            p1 += partition_size
        n_partitions *= 2
        partition_size //= 2

    # volume normalization (reference :532-534)
    for i in range(0x100):
        fb[i] = (s16(fb[i]) >> vol_shift) & M16

    # overlap-add into the first 16 outputs (reference :538-555)
    co0, co_n = 0, 0x0F
    ovp = 0
    for i in range(0, 16, 2):
        bi = int(_BR[i])
        for _ in range(2):
            _, a = mulsu_mr(fb[bi], int(_OVL[co0]))
            _, b = mulsu_mr(overlap[ovp], int(_OVL[co_n]))
            a = (a + b) & M64
            v, _ = round_mr(a, 0)
            fb[bi] = v
            bi += 1
            co0 += 1
            co_n -= 1
            ovp += 1

    # extract 240 outputs in bit-reversed order (reference :559-565)
    o = 0
    for i in range(0, 240, 2):
        bi = int(_BR[i])
        out[o] = fb[bi]
        out[o + 1] = fb[bi + 1]
        o += 2

    # save the last 16 into the overlap buffer (reference :569-575)
    ovp = 0
    for i in range(240, 256, 2):
        bi = int(_BR[i])
        overlap[ovp] = fb[bi]
        overlap[ovp + 1] = fb[bi + 1]
        ovp += 2


def transform_frame_93(fb, overlap, out, vol_shift):
    """1993 inverse transform: sqrt magnitude fixup, 256→512 expansion,
    7-iteration IFFT, overlap-add."""
    # magnitude fixup of element 0 via 5-term Taylor sqrt (reference :633-704)
    ar = fb[0]
    as_flag = s16(ar) < 0
    if as_flag:
        ar = (-s16(ar)) & M16

    _, mr = mulss_mr(fb[1], fb[1])
    _, prod2 = mulss_mr(ar, ar)
    mr = (mr + prod2) & M64

    sr = mr & M32
    exp_u, sr = normalize32(sr)
    exponent = s16(exp_u)
    ar = mr1(sr)

    if ar != 0:
        mr = 0x0D490000
        mr = (mr + ((0x5D1D * s16(ar)) << 1)) & M64
        mf, _ = multiply_and_round(ar, ar)
        mr = (mr + ((-22035 * s16(mf)) << 1)) & M64
        mf, _ = multiply_and_round(ar, mf)
        mr = (mr + ((0x46D6 * s16(mf)) << 1)) & M64
        mf, _ = multiply_and_round(ar, mf)
        mr = (mr + ((-8790 * s16(mf)) << 1)) & M64
        mf, _ = multiply_and_round(ar, mf)
        mr = (mr + ((0x072D * s16(mf)) << 1)) & M64

        if exponent & 1:
            v, mr = multiply_and_round(mr1(mr), 0x5A82)
            exponent += 1

        # exponent is even here (odd case adjusted above); C trunc-division
        # and Python floor-division agree on even values
        exponent = exponent // 2 + 1
        sr = bitshift_signed32(mr & M32, exponent)
        ar = mr1(sr)
        if as_flag:
            ar = (-s16(ar)) & M16

    fb[0x0000] = fb[0x0100] = ar
    fb[0x0001] = fb[0x0101] = 0

    # expand 256 → 512 samples (reference :713-732)
    i0, i1, i2, i3 = 2, 0xFE, 0x102, 0x1FE
    for _ in range(0x40):
        xr, xi = s16(fb[i0]), s16(fb[i0 + 1])
        yr, yi = s16(fb[i1]), s16(fb[i1 + 1])
        fb[i0] = fb[i1] = (xr + yr) & M16
        fb[i2] = (xr - yr) & M16
        fb[i3] = (yr - xr) & M16
        fb[i2 + 1] = fb[i3 + 1] = (xi + yi) & M16
        fb[i0 + 1] = (xi - yi) & M16
        fb[i1 + 1] = (yi - xi) & M16
        i0 += 2
        i1 -= 2
        i2 += 2
        i3 -= 2

    # 7-iteration IFFT over 512 entries, unsaturated (reference :742-778)
    n_partitions, partition_size = 2, 0x80
    for _ in range(7):
        i0, i1 = 0, partition_size
        for part in range(n_partitions):
            c_sin = int(_SIN[part])
            c_cos = int(_COS[part])
            for _ in range(partition_size // 2):
                a0, a1 = fb[i1], fb[i1 + 1]
                y0, y1 = s16(fb[i0]), s16(fb[i0 + 1])
                _, mr = mulss_mr(a0, c_cos)
                v, mr = multiply_round_sub(mr, a1, c_sin)
                x0 = s16(v)
                _, mr = mulss_mr(a1, c_cos)
                v, mr = multiply_round_add(mr, a0, c_sin)
                x1 = s16(v)
                fb[i0] = (y0 - x0) & M16
                fb[i0 + 1] = (y1 - x1) & M16
                fb[i1] = (x0 + y0) & M16
                fb[i1 + 1] = (x1 + y1) & M16
                i0 += 2
                i1 += 2
            i1 += partition_size
            i0 += partition_size
        n_partitions *= 2
        partition_size //= 2

    # volume shift + bit-reversed extraction into odd slots (reference :782-785)
    i4 = 1
    for i in range(0x100):
        fb[i4] = (s16(fb[int(_BR[i])]) >> vol_shift) & M16
        i4 += 2

    # overlap-add into the first 16 outputs (reference :789-802)
    i3 = 1
    for i in range(0x10):
        _, a = mulsu_mr(overlap[i], int(_OVL[0xF - i]))
        _, b = mulsu_mr(fb[i3], int(_OVL[i]))
        a = (a + b) & M64
        v, _ = round_mr(a, 0)
        out[i] = v
        i3 += 2

    # next 224 outputs come directly from the frame (reference :805-806)
    for i in range(0xE0):
        out[16 + i] = fb[i3]
        i3 += 2

    # last 16 go to the overlap buffer (reference :810-812)
    for i in range(0x10):
        overlap[i] = fb[i3]
        i3 += 2
