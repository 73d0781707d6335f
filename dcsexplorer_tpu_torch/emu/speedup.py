"""Emulator fast mode: native execution of the firmware's transform region.

The framework counterpart of the reference's PinMame "speedup" patches
(reference: DCSDecoderEmu.cpp:289-325 for detection/installation and
:644-889 for the replaced regions): the decode loop's dominant cost — the
inverse frequency transform — is intercepted at a known program point and
executed natively, with the firmware handling everything around it.

Differences from the reference's scheme, by design:

- Detection uses wildcard opcode signatures WITH OPERAND CAPTURE
  (rom/opsearch.py), so the region geometry (frame-buffer base, volume
  variable, coefficient/bit-reversal table bases) is read out of the
  matched code itself rather than hardcoded per firmware layout.
- Signatures exist for this framework's own synthesized firmware
  (compiler/firmware94.py, compiler/firmware93.py) — making the fast mode
  fully verifiable in-repo against strict mode — AND for the original ROM
  programs, using the reference's two documented prologue signatures.
- The native replacement reuses the framework's bit-exact transform
  semantics (refdec/transform.py, refdec/fixed.py).  The C++ core runs the
  region in native/src/adsp2105.cpp (accelSynth94/...); the pure-Python
  handlers here serve the Python CPU core and double as the differential
  oracle for the C++ ones (tests/test_emu_speedup.py).

Regions by kind:

- SYNTH94/SYNTH93: from the synthesized firmware's ``transform`` entry
  through the volume normalization — everything before the overlap-add —
  exiting into the firmware's own overlap/extraction code.
- ORIG94: butterfly halves + 6-iteration IFFT + volume multiply
  (reference: DCSDecoderEmu.cpp:644-757).
- ORIG93: 256→512 expansion + 7-iteration IFFT (PM twiddles) +
  bit-reversed volume-multiplied extraction (reference: :759-889).

The port's copy of ``dcsexplorer_tpu/emu/speedup.py``.
"""

from ..refdec.fixed import (M16, M32, M64, bitshift_signed32, mr1,
                            multiply_and_round, normalize32, s16, sat16)
from ..rom.opsearch import search_opcodes_words

KIND_SYNTH94 = 1
KIND_SYNTH93 = 2
KIND_ORIG94 = 3
KIND_ORIG93 = 4

# mstat bit cleared by the synth94 region's trailing DIS AR_SAT
_M_SATURATE = 0x08


class SpeedupInfo:
    def __init__(self, kind, entry, exit_pc, geom):
        self.kind = kind
        self.entry = entry
        self.exit = exit_pc
        self.geom = geom    # list of uint16 parameters (kind-specific)

    def __repr__(self):
        return (f"SpeedupInfo(kind={self.kind}, entry={self.entry:#06x}, "
                f"exit={self.exit:#06x}, geom={[hex(g) for g in self.geom]})")


def _imm14(hi_nibble, low12):
    """Reassemble a 14-bit direct address split across the captured
    nibble-1 (top two bits) and the 3-nibble low field."""
    return ((hi_nibble & 3) << 12) | low12


# ----------------------------------------------------------------------
# detection
#
# Synthesized-firmware signatures: opcode sequences emitted by
# compiler/firmware94.py::_emit_transform and
# compiler/firmware93.py::_emit_transform93, with every absolute operand
# wildcarded.  tests/test_emu_speedup.py re-derives them from the
# assembler to keep them honest.

# c16(MY0,$8000); ld(MX0,FB+$80); MR=MX0*MY0(SS); st(FB+$80,MR1)
_S94_ENTRY = "480006 8gxxx2 20800F 9hyyyC"
# pre-pass 2 head: imm(I0,FB) imm(I4,FB+$100) imm(M7,-3) imm(I2,TBR+2)
# imm(I3,TBR) imm(M3,4)
_S94_PP2 = "3gxxx0 3hyyy0 3BFFD7 3izzz2 3jwww3 340047"
# IFFT level head tail: imm(I2,TSIN) imm(I6,TCOS) lds(AR,NPART) mov(CNTR,AR)
_S94_TCOS = "3gxxx2 3hyyy2 8****A 0D0C5A"
# DIS AR_SAT; lds(AY0,VSHIFT); AR=-AY0; SE=AR; imm(I0,FB); CNTR=$100;
# DO; SI=DM(I0,M0); SR=ASHIFT SI; DM(I0,M1)=SR1   → exit = match + 10
_S94_VSITE = "0C0800 8vyyy4 22A00F 0D009A 3wzzz0 3C1005 1****E 600080 0E200F 6800F1"

# ld(AX0,FB); c16(AR,0); st(TMP1,AR); c16(AY0,0); AF=AX0-AY0
_S93_ENTRY = "8gxxx0 40000A 9hyyyA 400004 26E00F"
# imm(I2,TSIN) imm(I4,TCOS) lds(AR,NPART) mov(CNTR,AR)
_S93_TCOS = "3gxxx2 3hyyy0 8****A 0D0C5A"
# lds(AY0,VSHIFT); AR=-AY0; SE=AR; imm(I1,TBR); imm(I2,FB+1); imm(M3,2)
_S93_VSITE = "8vyyy4 22A00F 0D009A 3gxxx1 3hzzz2 340027"
# overlap-add head: imm(I0,FB+1) imm(I2,OVLC) imm(I3,OVLC+15) imm(I4,OVLB)
# lds(AR,WPTR)   → exit = match address
_S93_EXIT = "3gxxx0 3hyyy2 3izzz3 3jwww0 8k***A"

# Original-ROM prologue signatures, properties of the DCS ROM programs
# (reference: DCSDecoderEmu.cpp:296-312).
_O94_SIG = "000000 0C0080 0C2000"
_O93_SIG = "378FE1 379002 379FE3"


def detect(pm):
    """Locate the transform region in PM (a 0x4000-word opcode list).

    Returns a SpeedupInfo or None.  Synthesized-firmware signatures are
    tried first (they cannot occur in original ROMs), then the reference's
    original-ROM prologues.
    """
    entry, v = search_opcodes_words(_S94_ENTRY, pm)
    if entry >= 0:
        fb = _imm14(v["g"], v["x"]) - 0x80
        if _imm14(v["h"], v["y"]) - 0x80 != fb:
            return None
        at, v = search_opcodes_words(_S94_PP2, pm, entry)
        if at < 0 or _imm14(v["g"], v["x"]) != fb:
            return None
        t_br = _imm14(v["j"], v["w"])
        at, v = search_opcodes_words(_S94_TCOS, pm, at)
        if at < 0:
            return None
        t_sin = _imm14(v["g"], v["x"])
        t_cos = _imm14(v["h"], v["y"])
        site, v = search_opcodes_words(_S94_VSITE, pm, at)
        if site < 0 or _imm14(v["w"], v["z"]) != fb:
            return None
        vshift = _imm14(v["v"], v["y"])
        return SpeedupInfo(KIND_SYNTH94, entry, site + 10,
                           [fb, vshift, t_sin, t_cos, t_br])

    entry, v = search_opcodes_words(_S93_ENTRY, pm)
    if entry >= 0:
        fb = _imm14(v["g"], v["x"])
        at, v = search_opcodes_words(_S93_TCOS, pm, entry)
        if at < 0:
            return None
        t_sin = _imm14(v["g"], v["x"])
        t_cos = _imm14(v["h"], v["y"])
        site, v = search_opcodes_words(_S93_VSITE, pm, at)
        if site < 0 or _imm14(v["h"], v["z"]) != fb + 1:
            return None
        vshift = _imm14(v["v"], v["y"])
        t_br = _imm14(v["g"], v["x"])
        exit_pc, v = search_opcodes_words(_S93_EXIT, pm, site)
        if exit_pc < 0 or _imm14(v["g"], v["x"]) != fb + 1:
            return None
        if _imm14(v["i"], v["z"]) != _imm14(v["h"], v["y"]) + 15:
            return None
        return SpeedupInfo(KIND_SYNTH93, entry, exit_pc,
                           [fb, vshift, t_sin, t_cos, t_br])

    # original 1994+ firmware (reference: DCSDecoderEmu.cpp:306-321;
    # handler pc arithmetic :649, :757)
    sig, _ = search_opcodes_words(_O94_SIG, pm)
    if sig >= 0:
        vol_op = pm[sig + 0x43]
        vol_addr = (vol_op >> 4) & 0x3FFF
        if sig + 4 > 0x2000:
            ram1, ram2 = 0x1000, 0x2000
        else:
            ram1, ram2 = 0x0700, 0x3800
        return SpeedupInfo(KIND_ORIG94, sig + 3, sig + 0x49,
                           [ram1, ram2, vol_addr])

    # original 1993 firmware (reference: DCSDecoderEmu.cpp:296-302;
    # handler pc arithmetic :780, :888)
    sig, _ = search_opcodes_words(_O93_SIG, pm)
    if sig >= 0:
        vol_op = pm[sig + 0x4C]
        vol_addr = (vol_op >> 4) & 0x3FFF
        return SpeedupInfo(KIND_ORIG93, sig + 3, sig + 0x52,
                           [0x3800, vol_addr, 0x1700, 0x1780])

    return None


# ----------------------------------------------------------------------
# pure-Python region handlers (the Python CPU core's fast path, and the
# differential oracle for the C++ handlers)

def _mulss(a, b):
    return (((s16(a) * s16(b)) << 1) >> 16) & M16


def _mul_round(mr, a, b, sub):
    """mr ∓ (a*b)<<1, rounded with the convergent-rounding quirk; returns
    the high word as a signed int (refdec/fixed multiply_round_*)."""
    prod = (s16(a) * s16(b)) << 1
    mr = (mr - prod if sub else mr + prod) & M64
    res = (mr + 0x8000) & M64
    if (prod & M16) == 0x8000:
        res &= ~0x10000
    return s16(res >> 16)


def _ifft(dm, buf, iters, psz, csin, ccos, saturate):
    n_part = 2
    for _ in range(iters):
        p0, p1 = buf, buf + psz
        for part in range(n_part):
            cs, cc = csin[part], ccos[part]
            for _ in range(psz // 2):
                a_re, a_im = s16(dm[p1]), s16(dm[p1 + 1])
                t_re = _mul_round((a_re * cc) << 1, a_im, cs, True)
                t_im = _mul_round((a_im * cc) << 1, a_re, cs, False)
                u_re, u_im = s16(dm[p0]), s16(dm[p0 + 1])
                if saturate:
                    dm[p0] = sat16(u_re - t_re)
                    dm[p0 + 1] = sat16(u_im - t_im)
                    dm[p1] = sat16(u_re + t_re)
                    dm[p1 + 1] = sat16(u_im + t_im)
                else:
                    dm[p0] = (u_re - t_re) & M16
                    dm[p0 + 1] = (u_im - t_im) & M16
                    dm[p1] = (u_re + t_re) & M16
                    dm[p1 + 1] = (u_im + t_im) & M16
                p0 += 2
                p1 += 2
            p0 += psz
            p1 += psz
        n_part *= 2
        psz //= 2


def apply_synth94(dm, geom):
    """Region semantics of refdec/transform.py::transform_frame_94x:27-107
    over DM, tables read from DM per the captured geometry."""
    fb, vsa, ts, tc, tb = geom
    dm[fb + 0x80] = _mulss(dm[fb + 0x80], 0x8000)
    dm[fb + 0x81] = _mulss((-s16(dm[fb + 0x81])) & M16, 0x8000)
    p0, p1 = fb, fb + 0x100
    for _ in range(0x40):
        x0, x1 = s16(dm[p0]), s16(dm[p0 + 1])
        y0, y1 = s16(dm[p1]), s16(dm[p1 + 1])
        dm[p0] = _mulss(sat16(x0 + y0), 0x8000)
        dm[p1] = _mulss(sat16(x0 - y0), 0x8000)
        dm[p0 + 1] = _mulss(sat16(x1 - y1), 0x8000)
        dm[p1 + 1] = _mulss(sat16(x1 + y1), 0x8000)
        p0 += 2
        p1 -= 2
    i0, i1 = 2, 0
    p4, p5 = fb, fb + 0x100
    for _ in range(0x40):
        c0 = dm[ts + dm[tb + i0]]
        c1 = dm[ts + dm[tb + i1]]
        x0, x1 = s16(dm[p4]), s16(dm[p4 + 1])
        xn0, xn1 = dm[p5], dm[p5 + 1]
        prod0 = _mul_round((s16(xn1) * s16(c1)) << 1, xn0, c0, True)
        prod1 = _mul_round((s16(xn1) * s16(c0)) << 1, xn0, c1, False)
        dm[p4] = sat16(prod1 + x0)
        dm[p4 + 1] = sat16(prod0 + x1)
        dm[p5] = sat16(x0 - prod1)
        dm[p5 + 1] = sat16(prod0 - x1)
        p4 += 2
        p5 -= 2
        i0 += 4
        i1 += 4
    p0, p1 = fb, fb + 0x80
    for _ in range(0x40):
        x0, x1 = s16(dm[p0]), s16(dm[p0 + 1])
        y0, y1 = s16(dm[p1]), s16(dm[p1 + 1])
        dm[p0] = sat16(x0 + y0)
        dm[p0 + 1] = sat16(x1 + y1)
        dm[p1] = sat16(x0 - y0)
        dm[p1 + 1] = sat16(x1 - y1)
        p0 += 2
        p1 += 2
    csin = [s16(dm[ts + k]) for k in range(64)]
    ccos = [s16(dm[tc + k]) for k in range(64)]
    _ifft(dm, fb, 6, 0x40, csin, ccos, True)
    vs = s16(dm[vsa])
    for k in range(0x100):
        dm[fb + k] = (s16(dm[fb + k]) >> vs) & M16


def apply_synth93(dm, geom):
    """Region semantics of refdec/transform.py::transform_frame_93:145-234
    over DM (sqrt fixup, expansion, 7-iteration IFFT, aliased bit-reversed
    volume-shift extraction)."""
    fb, vsa, ts, tc, tb = geom
    ar = dm[fb]
    as_flag = s16(ar) < 0
    if as_flag:
        ar = (-s16(ar)) & M16
    f1 = s16(dm[fb + 1])
    mr = (((f1 * f1) << 1) + ((s16(ar) * s16(ar)) << 1)) & M64
    exp_u, sr = normalize32(mr & M32)
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
            _, mr = multiply_and_round(mr1(mr), 0x5A82)
            exponent += 1
        exponent = exponent // 2 + 1
        ar = mr1(bitshift_signed32(mr & M32, exponent))
        if as_flag:
            ar = (-s16(ar)) & M16
    dm[fb] = dm[fb + 0x100] = ar
    dm[fb + 1] = dm[fb + 0x101] = 0
    i0, i1, i2, i3 = fb + 2, fb + 0xFE, fb + 0x102, fb + 0x1FE
    for _ in range(0x40):
        xr, xi = s16(dm[i0]), s16(dm[i0 + 1])
        yr, yi = s16(dm[i1]), s16(dm[i1 + 1])
        dm[i0] = dm[i1] = (xr + yr) & M16
        dm[i2] = (xr - yr) & M16
        dm[i3] = (yr - xr) & M16
        dm[i2 + 1] = dm[i3 + 1] = (xi + yi) & M16
        dm[i0 + 1] = (xi - yi) & M16
        dm[i1 + 1] = (yi - xi) & M16
        i0 += 2
        i1 -= 2
        i2 += 2
        i3 -= 2
    csin = [s16(dm[ts + k]) for k in range(128)]
    ccos = [s16(dm[tc + k]) for k in range(128)]
    _ifft(dm, fb, 7, 0x80, csin, ccos, False)
    vs = s16(dm[vsa])
    i4 = fb + 1
    for k in range(0x100):
        dm[i4] = (s16(dm[fb + dm[tb + k]]) >> vs) & M16
        i4 += 2


def apply_orig94(dm, geom):
    """Region semantics of the reference's DCSSpeedup1994
    (DCSDecoderEmu.cpp:644-757): wrapping butterfly halves, 6-iteration
    IFFT, volume multiply over the 256-word work buffer."""
    ram1, ram2, vol_addr = geom
    p0, p1 = ram2, ram2 + 0x80
    for _ in range(0x40):
        x0, x1 = s16(dm[p0]), s16(dm[p0 + 1])
        y0, y1 = s16(dm[p1]), s16(dm[p1 + 1])
        dm[p0] = (x0 + y0) & M16
        dm[p0 + 1] = (x1 + y1) & M16
        dm[p1] = (x0 - y0) & M16
        dm[p1 + 1] = (x1 - y1) & M16
        p0 += 2
        p1 += 2
    csin = [s16(dm[ram1 + k]) for k in range(64)]
    ccos = [s16(dm[ram1 + 0x80 + k]) for k in range(64)]
    _ifft(dm, ram2, 6, 0x40, csin, ccos, False)
    vol = min(dm[vol_addr], 0x8000)
    for k in range(0x100):
        dm[ram2 + k] = ((s16(dm[ram2 + k]) * vol) >> 15) & M16


def apply_orig93(dm, pm, geom, set_mstat=None):
    """Region semantics of the reference's DCSSpeedup1993
    (DCSDecoderEmu.cpp:759-889): expansion, 7-iteration IFFT with PM
    twiddles, bit-reversed volume-multiplied extraction."""
    fb, vol_addr, ps, pcs = geom
    dm[fb + 0x100] = dm[fb]
    dm[fb + 1] = 0
    dm[fb + 0x101] = 0
    i0, i1, i2, i3 = fb + 2, fb + 0xFE, fb + 0x102, fb + 0x1FE
    for _ in range(0x40):
        xr, xi = s16(dm[i0]), s16(dm[i0 + 1])
        yr, yi = s16(dm[i1]), s16(dm[i1 + 1])
        dm[i0] = dm[i1] = (xr + yr) & M16
        dm[i2] = (xr - yr) & M16
        dm[i3] = (yr - xr) & M16
        dm[i2 + 1] = dm[i3 + 1] = (xi + yi) & M16
        dm[i0 + 1] = (xi - yi) & M16
        dm[i1 + 1] = (yi - xi) & M16
        i0 += 2
        i1 -= 2
        i2 += 2
        i3 -= 2
    if set_mstat is not None:
        set_mstat(0)
    csin = [s16(pm[ps + k] >> 8) for k in range(128)]
    ccos = [s16(pm[pcs + k] >> 8) for k in range(128)]
    _ifft(dm, fb, 7, 0x80, csin, ccos, False)
    vol = min(dm[vol_addr], 0x8000)

    def rev9(k):
        r = 0
        for b in range(9):
            if k & (1 << b):
                r |= 1 << (8 - b)
        return r

    i4 = fb + 1
    for k in range(0x100):
        dm[i4] = ((s16(dm[fb + rev9(k)]) * vol) >> 15) & M16
        i4 += 2


def make_python_handler(info):
    """Handler closure for the Python CPU core's run-loop hook."""
    kind, geom = info.kind, info.geom

    def handler(cpu):
        if kind == KIND_SYNTH94:
            apply_synth94(cpu.dm, geom)
            # register exit contract (see the C++ accelSynth94)
            cpu.m[3] = 2
            cpu.m[7] = -3
            cpu.core.se = (-s16(cpu.dm[geom[1]])) & M16
            cpu.set_mstat(cpu.mstat & ~_M_SATURATE)
        elif kind == KIND_SYNTH93:
            apply_synth93(cpu.dm, geom)
            # the overlap-add that follows walks odd fb slots with M3 = 2
            cpu.m[3] = 2
            cpu.core.se = (-s16(cpu.dm[geom[1]])) & M16
        elif kind == KIND_ORIG94:
            apply_orig94(cpu.dm, geom)
        elif kind == KIND_ORIG93:
            apply_orig93(cpu.dm, cpu.pm, geom, cpu.set_mstat)

    return handler


def install(decoder):
    """Detect the transform region in the decoder's live PM and arm the
    fast path on its CPU core.  Returns the SpeedupInfo, or None if no
    signature matched (the caller reports the incompatible-ROM error, as
    the reference does, DCSDecoderEmu.cpp:320-325)."""
    cpu = decoder.cpu
    info = detect(list(cpu.pm))
    if info is None:
        return None
    if decoder.native_cpu:
        cpu.set_speedup(info.kind, info.entry, info.exit, info.geom)
    else:
        cpu.speedup = (info.entry, info.exit, make_python_handler(info))
    return info
