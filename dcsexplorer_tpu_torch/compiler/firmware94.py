"""Synthesized OS94 *decoding* firmware for generated ROM sets.

Unlike the minimal boot firmware (compiler/firmware.py), this program is a
complete ADSP-2105 implementation of the 1994-format DCS decoder runtime:
data-port protocol, track byte-code VM, mixing matrix with fades, master
volume, the 94x frame decompressor (Huffman band-type deltas, all six
sample codebooks, fixed-width bands, type-1 band translation), and the
94x inverse transform with overlap-add.  A generated ROM carrying this
firmware decodes audio through the emulator backend (emu/board.py) and
produces PCM that bit-matches the native scalar decoder (refdec/) frame
for frame — closing the reference's two-backend validation loop
(reference: DCSDecoder/DCSDecoderEmu.cpp:359-395, DCSDecoderNative.cpp)
for compiler-built ROM sets.

Semantics are the refdec modules, themselves anchored to the reference:
- frame decode:  refdec/frames.py::decompress_frame_94x
  (reference: DCSDecoderNative.cpp:1679-2261)
- transform:     refdec/transform.py::transform_frame_94x  (:397-576)
- runtime/VM:    refdec/decoder.py::main_loop/_exec_track  (:89-306, 848-1228)
- data port:     refdec/decoder.py::irq2_handler           (:3297-3437)

The fixed-point contract is free here: the MAC/shifter ops *are* the
ADSP-2105 ops the numerics contract models (refdec/fixed.py), so bit-
exactness follows from sequencing the same operations.

Known, deliberate divergences from refdec (all unreachable on well-formed
streams): the mid-band error paths of garbage input (refdec zeroes the
whole band after the fact; the firmware stops at the error), band-type
indexes >15 (masked), and OS93a host-event timers / the v1.05 channel-5
override (never armed by OS94 ROMs).

Board contract honored for emu/board.py patch points:
- main-loop entry signature  3C1025 3xxxx0 1xxxxE
- autobuffer sync loop       0D02A3 4xxxx4 26E20F 1yyyy4 / 4xxxxA 9zzzzA ×2
- master volume signature    8xxxxF 2E7FEF 1yyyy0

The port's copy of ``dcsexplorer_tpu/compiler/firmware94.py``.
"""

import struct

import numpy as np

from ..format import tables as T
from .asm import (ABS, AC, ADD, ADD_C, AF, AND, AR, ASHIFT_HI, ASHIFT_LO,
                  AX0, AX1, AY0, AY1, CE, CNTR, EQ, EXP_HI, EXP_LO, GE, GT,
                  I0, I1, I2, I3, I4, I5, I6, I7, ICNTL, IMASK, L0, L1, L2,
                  L3, L4, L5, L6, L7, LE, LSHIFT_HI, LSHIFT_HI_OR, LSHIFT_LO,
                  LSHIFT_LO_OR, LT, M0, M1, M2, M3, M4, M5, M6, M7, MAC_RND,
                  MAC_SS, MAC_SU, MAC_UU, MF, MR, MR0, MR1, MR2, MSUB_RND,
                  MUL_RND, MUL_SS, MUL_SU, MUL_UU, MX0, MX1, MY0, MY1, NE,
                  NEG_Y, NOT_AC, NOT_AV, NOT_CE, NOT_X, NOT_Y, OR, PASS,
                  POS, NEG, PX, RSUB, SE, SI, SR0, SR1, SUB, TRUE, XOR,
                  Y_DEC, Y_INC, ZERO, Asm)

# ----------------------------------------------------------------------
# DM memory map.  On the original DCS board (hw 2) firmware data starts at
# DM $0000; on DCS-95 (hw 3) DM $0000-$07FF is the banked ROM window
# (emu/board.py::_read_dm; reference: DCSDecoderEmu.cpp:397-591), so the
# whole map shifts up by $0800 (set by _configure below).

DM_BASE = 0            # 0 (DCS board) or 0x0800 (DCS-95)
FB = 0x0000            # 512-entry frequency-domain frame buffer
BUF = 0x0200           # SPORT1 autobuffer (480 = 2 × 240 PCM)
NBUF = 480
BUF_MID = BUF + 240
OVLB = 0x03E0          # 16-entry overlap buffer
TAB = 0x0400           # decoder tables (copied from ROM at init)

CH = 0x0E00            # 8 channel blocks, stride 64
ST = 0x1000            # 8 stream blocks, stride 64
MIXA = 0x1200          # 8×8 mixing matrix, 4 words each [cur, tgt, delta, steps]
VARS = 0x1300          # 256 track-program variables
CMDQ = 0x1400          # 64-entry command ring
SC = 0x1480            # scalars (see _SCALARS)

# channel block fields
C_TRKHI, C_TRKLO, C_TCTR, C_NXTT, C_NXTL, C_STOP, C_SRC, C_MMULT, \
    C_CVOL, C_MOVR = range(10)
# OS93a host-event timer (refdec HostEventTimer: data, interval, counter)
C_HETD, C_HETI, C_HETC = 10, 11, 12
C_LSP = 13             # loop stack pointer (entries)
C_LSTK = 16            # 16 × [count, hi, lo]

# stream block fields
S_PLAY, S_HDRHI, S_HDRLO, S_SRTHI, S_SRTLO, S_CURHI, S_CURLO, S_WHI, \
    S_WLO, S_NB, S_FCTR, S_NFRM, S_LCTR, S_NEEDI = range(14)
S_HDR = 16             # header copy (16)
S_BT = 32              # band-type accumulators (16)

_SCALARS = """VOL_NOM VOL_MULT VSHIFT NDP DPW DPE DPTMO CQH CQT
TIX_HI TIX_LO DIX_HI DIX_LO NTRK DONE XCH DCH CURBANK BSEL
P_HI P_LO SV_HI SV_LO B_CHI B_CLO B_WHI B_WLO B_NB
CHB STB OUTB1 FMT PRE0 PRE1 PRE2
OUTIDX OUTINC OUTCNT BANDNO BTYPE SCODE CURHDR MW CBB REFV ICNT ERRF
NPART PSIZE HALF LVLC SUM0LO SUM0HI SUM1LO SUM1HI
WPTR Q_HI Q_LO TMP0 TMP1 TMP2 TMP3 TMP4 R16 R24
PRV_IN PRV_DL BSUB REUSE OUTFIX OSTR FBAND""".split()

SYM = {name: SC + k for k, name in enumerate(_SCALARS)}


def _configure(hw_version):
    """Point the DM map (and the table layout, which embeds absolute DM
    addresses) at the target board.  SYM is mutated in place so emit-time
    lookups and importers of the dict both see the configured map."""
    global DM_BASE, FB, BUF, BUF_MID, OVLB, TAB, CH, ST, MIXA, VARS, CMDQ, SC
    global TABLE_WORDS, TLAY
    DM_BASE = 0x0800 if hw_version == 3 else 0
    FB = DM_BASE + 0x0000
    BUF = DM_BASE + 0x0200
    BUF_MID = BUF + 240
    OVLB = DM_BASE + 0x03E0
    TAB = DM_BASE + 0x0400
    CH = DM_BASE + 0x0E00
    ST = DM_BASE + 0x1000
    MIXA = DM_BASE + 0x1200
    VARS = DM_BASE + 0x1300
    CMDQ = DM_BASE + 0x1400
    SC = DM_BASE + 0x1480
    SYM.clear()
    SYM.update({name: SC + k for k, name in enumerate(_SCALARS)})
    TABLE_WORDS, TLAY = _table_words()


# ----------------------------------------------------------------------
# table blob: everything the 94x decoder needs, packed as big-endian
# 16-bit words for the init-time ROM→DM copy.

def _table_words():
    cb_sizes = [len(T.CODEBOOKS[i]) for i in range(1, 7)]
    words = []
    layout = {}

    def put(name, vals):
        layout[name] = TAB + len(words)
        words.extend(int(v) & 0xFFFF for v in vals)

    put("T_SIN", T.IFFT_COEFF[:128])
    put("T_COS", T.IFFT_COEFF[128:256])
    put("T_BR", T.BITREV9[:256])
    put("T_OVLC", T.OVERLAP_COEFF)
    put("T_HUFF", T.HUFFTREE94)
    put("T_BANDCNT", T.BAND_OUTPUT_COUNT)
    put("T_MANT", T.SCALE_MANTISSA)
    put("T_MAXW", T.MAX_BIT_WIDTH)
    put("T_PRE0", T.PREADJ0)
    put("T_PRE3", T.PREADJ3)
    put("T_XL02", np.asarray(T.XLAT02).reshape(-1))
    put("T_XL35", np.asarray(T.XLAT35).reshape(-1))
    put("T_XL6F", np.asarray(T.XLAT6F).reshape(-1))
    for i in range(1, 7):
        put(f"T_CB{i}", T.CODEBOOKS[i])
    # per-band-type codebook base addresses (absolute DM), index 0 unused
    put("T_CBBASE", [0] + [layout[f"T_CB{i}"] for i in range(1, 7)])
    assert TAB + len(words) < CH, f"table blob too large: {len(words)}"
    return words, layout


TABLE_WORDS, TLAY = _table_words()


def table_blob():
    """The ROM byte image of the decoder tables (big-endian words)."""
    return b"".join(struct.pack(">H", w) for w in TABLE_WORDS)


# ----------------------------------------------------------------------

class _Fw(Asm):
    """Asm with firmware-specific helper idioms.

    ``hw`` selects the board I/O contract: 2 = original DCS board (sound
    data port at PM($3000) via I5/M5, 4KB ROM window at DM($2000), bank at
    DM($3000)); 3 = DCS-95 (port at DM($3300), 2KB window at DM($0000),
    bank split across DM($3000)/DM($3100)) — emu/board.py, reference:
    DCSDecoderEmu.cpp:397-591."""

    hw = 2
    os93 = False        # 1993-software VM grammar (op $06 has no operands)
    os93a = False       # OS93a runtime: 1-byte Type-1 stream headers,
    #                     op $04 host-event timers, fixed $7FFF volume base

    def c16(self, reg, val):
        return self.imm(reg, val & 0xFFFF)

    def port_out(self, reg):
        """Write reg to the sound data port."""
        if self.hw == 3:
            self.st(0x3300, reg)
        else:
            self.st_pm(I5, M5, reg)

    def port_in(self, reg):
        """Read the sound data port into reg."""
        if self.hw == 3:
            self.ld(reg, 0x3300)
        else:
            self.ld_pm(reg, I5, M5)

    def lds(self, reg, sym):
        return self.ld(reg, SYM[sym])

    def sts(self, sym, reg):
        return self.st(SYM[sym], reg)

    def cmp_imm(self, xreg, val):
        """AF = xreg - val (sets flags; clobbers AY0)."""
        self.c16(AY0, val)
        self.alu(AF, SUB, xreg, AY0)

    def add_imm(self, xreg, val):
        """AR = xreg + val (clobbers AY0)."""
        self.c16(AY0, val)
        self.alu(AR, ADD, xreg, AY0)

    def and_imm(self, xreg, val):
        self.c16(AY0, val)
        self.alu(AR, AND, xreg, AY0)

    def set_se(self, val):
        """SE = immediate (via AR)."""
        self.c16(AR, val & 0xFFFF)
        self.mov(SE, AR)


# fixed U2 locations of the second-stage program overlay and the tables
# (reserved by the ROM generator when this firmware is embedded)
OVERLAY_ROM_ADDR = 0x8000
TABLES_ROM_ADDR = 0xA800
OVERLAY_PM = 0x0800                 # overlay load address in program memory
FW_RESERVE = (0x8000, TABLES_ROM_ADDR + 2 * len(TABLE_WORDS))


def build_decoder_firmware(catalog_ofs=0x4000, hw_version=2,
                           reported_version=0x0106, default_volume=0x67,
                           _variant=None):
    """Assemble the OS94 decoding firmware.

    Returns (boot_words, overlay_words, symbols).  boot_words is the
    soft-boot block image (vectors, init + second-stage loader, the main
    loop with its patch-point signatures); overlay_words is the program
    body, stored in ROM at OVERLAY_ROM_ADDR (3 bytes/word, big-endian)
    and copied to PM $0800 by the loader — the same two-stage shape real
    DCS ROM programs use.  symbols maps routine labels and DM names to
    addresses (used by the tests/test_firmware94.py harnesses).
    """
    assert hw_version in (2, 3), hw_version
    _configure(hw_version)
    a = _Fw()
    a.hw = hw_version
    if _variant is not None:
        a.os93 = _variant.get("os93", False)
        a.os93a = _variant.get("os93a", False)
    table_words = (TABLE_WORDS if _variant is None
                   else _variant["table_words"])

    # ------------------------------------------------------------------
    # vectors
    a.jump("init")                      # 0x00 RESET
    a.nop(); a.nop(); a.nop()
    a.jump("irq2")                      # 0x04 IRQ2
    a.nop(); a.nop(); a.nop()
    while a.pc < 0x18:
        a.nop()

    # ==================================================================
    # init
    a.label("init")
    # DAG invariants: M0=0 M1=+1 M2=-1 (M3 scratch); M4=0 M5=0(port)
    # M6=+1 (M7 scratch); all L = 0
    for m, v in ((M0, 0), (M1, 1), (M2, -1), (M3, 0),
                 (M4, 0), (M5, 0), (M6, 1), (M7, 0)):
        a.imm(m, v)
    for l in (L0, L1, L2, L3, L4, L5, L6, L7):
        a.imm(l, 0)
    a.imm(I5, 0x3000)                   # sound data port (PM, via DAG2)

    # ------------------------------------------------------------------
    # second-stage loader: copy the overlay from ROM into PM $0800.
    # Inline byte reader (the shared one lives in the not-yet-loaded
    # overlay): I1 walks the DM ROM window, with explicit bank bumps.
    # hw2: 4KB window at DM($2000), bank = addr>>12 at DM($3000);
    # hw3: 2KB window at DM($0000), bank = addr>>11 split across
    #      DM($3000) low 8 / DM($3100) bits {0, 4:2}.
    if hw_version == 3:
        win_base, win_end, bank_shift = 0x0000, 0x0800, 11
    else:
        win_base, win_end, bank_shift = 0x2000, 0x3000, 12
    bank0 = OVERLAY_ROM_ADDR >> bank_shift
    a.c16(AX0, bank0)                   # current bank
    a.sts("CURBANK", AX0)
    if hw_version == 3:
        a.call("set_bank95")
    else:
        a.st(0x3000, AX0)
    a.imm(I1, win_base | (OVERLAY_ROM_ADDR & (win_end - win_base - 1)))
    a.imm(I6, OVERLAY_PM)
    ld_n = a.imm(CNTR, 0x1FFF)          # real count patched by the builder
    with a.loop_ce():
        for k in range(3):              # three bytes → hi16 in AX1, lo in PX
            a.call("ld_byte")
            if k == 0:
                a.mov(SI, AR)
                a.shift_imm(LSHIFT_LO, SI, 8)
            elif k == 1:
                a.mov(AY0, SR0)
                a.alu(AR, OR, AR, AY0)
                a.mov(AX1, AR)
            else:
                a.mov(PX, AR)
        a.st_pm(I6, M6, AX1)
    a.jump("init2")

    a.label("ld_byte")                  # loader-local window read + bank bump
    a.ld_i(AR, I1, M1)                  # the byte (valid even when last
    a.mov(AX0, I1)                      # in the window: wrap is post-read)
    a.cmp_imm(AX0, win_end)
    a.rts(NE)
    a.mov(MX1, AR)
    a.lds(AY0, "CURBANK")
    a.alu(AR, Y_INC, None, AY0)
    a.sts("CURBANK", AR)
    if hw_version == 3:
        a.call("set_bank95")
    else:
        a.st(0x3000, AR)
    a.imm(I1, win_base)
    a.mov(AR, MX1)
    a.rts()

    if hw_version == 3:
        # bank13 in CURBANK → DCS-95 bank registers (board recomputes the
        # window from both on each write; clobbers SI, SR, AR, AY0)
        a.label("set_bank95")
        a.lds(SI, "CURBANK")
        a.shift_imm(LSHIFT_LO, SI, -8)
        a.mov(AR, SR0)
        a.and_imm(AR, 1)                # offset bit 19
        a.sts("BSEL", AR)
        a.lds(SI, "CURBANK")
        a.shift_imm(LSHIFT_LO, SI, -8)
        a.mov(AR, SR0)
        a.and_imm(AR, 0x1C)             # chip select = linear[23:21]
        # (bank13 = linear>>11, so chip lives in bank13[12:10] — bits 2:4
        # of bank13>>8.  The board pieces linear back together as
        # (chip<<21)|offset, reference DCSDecoderEmu.cpp:517-519; a -7
        # shift here would select on linear[22:20] and hit the wrong chip
        # for any content past U2.)
        a.lds(AY0, "BSEL")
        a.alu(AR, OR, AR, AY0)
        a.st(0x3100, AR)
        a.lds(AR, "CURBANK")
        a.and_imm(AR, 0xFF)
        a.st(0x3000, AR)
        a.rts()

    a.label("init2")
    # clear FB..scalars
    a.imm(I0, FB)
    with a.loop_ce(n=0x1600):
        a.st_i_imm(I0, M1, 0)

    # per-channel defaults
    a.imm(I0, CH)
    a.imm(M3, 64)
    with a.loop_ce(n=8):
        a.c16(AR, 0xFFFF)
        a.st_i(I0, M0, AR)              # track ptr null (C_TRKHI)
        a.mov(AX0, I0)
        a.add_imm(AX0, C_SRC)
        a.mov(I2, AR)
        a.c16(AR, 0xFFFF)
        a.st_i(I2, M1, AR)              # C_SRC = -1
        a.c16(AR, 0x7FFF)
        a.st_i(I2, M1, AR)              # C_MMULT
        a.c16(AR, 0x00FF)
        a.st_i(I2, M1, AR)              # C_CVOL
        a.modify(I0, M3)
    a.imm(M3, 0)

    a.c16(AR, default_volume)
    a.sts("VOL_NOM", AR)
    a.c16(AR, 0xFFFF)
    a.sts("CURBANK", AR)

    # copy the decoder tables from ROM into DM
    a.c16(AR, (TABLES_ROM_ADDR >> 16) & 0xFF)
    a.sts("P_HI", AR)
    a.c16(AR, TABLES_ROM_ADDR & 0xFFFF)
    a.sts("P_LO", AR)
    a.imm(I1, TAB)
    with a.loop_ce(n=len(table_words)):
        a.call("rd16")
        a.st_i(I1, M1, AR)

    # catalog pointers: track index u24 @ +0x40, DI index u24 @ +0x43,
    # track count u16 @ +0x46  (all within U2 = chip 0)
    a.c16(AR, 0)
    a.sts("P_HI", AR)
    a.c16(AR, catalog_ofs + 0x40)
    a.sts("P_LO", AR)
    a.call("rd24")                      # AX1=hi8, AR=lo16
    a.sts("TIX_HI", AX1)
    a.sts("TIX_LO", AR)
    a.call("rd24")
    a.sts("DIX_HI", AX1)
    a.sts("DIX_LO", AR)
    a.call("rd16")
    a.sts("NTRK", AR)

    # autobuffer: I3/L3/M3 name the geometry in the $3FEF control word
    a.imm(I3, BUF)
    a.imm(L3, NBUF)
    a.imm(M3, 1)
    a.c16(AX0, 0x0002 | (3 << 9) | (3 << 7))
    a.st(0x3FEF, AX0)
    a.imm(L3, 0)
    a.imm(M3, 0)
    a.c16(AR, BUF)
    a.sts("WPTR", AR)

    a.imm(ICNTL, 0)
    a.imm(IMASK, 0x20)                  # IRQ2 only
    a.jump("top")

    # ==================================================================
    # main loop — entry signature must be exactly 3C1025 3xxxx0 1xxxxE
    a.label("top")
    a.imm(CNTR, 0x102)                  # 3C1025
    a.imm(I0, FB)                       # 340000 (3xxxx0)
    with a.loop_ce():                   # 1xxxxE
        a.st_i_imm(I0, M1, 0)
    with a.loop_ce(n=512 - 0x102):
        a.st_i_imm(I0, M1, 0)

    a.call("stop_sweep")
    a.call("cmd_drain")
    a.call("vm_run")
    a.call("vol_fold")
    a.call("decode_all")
    a.call("transform")
    a.call("mix_update")

    # data-port timeout tick, clamped at 13
    a.lds(AY0, "DPTMO")
    a.alu(AR, Y_INC, None, AY0)
    a.cmp_imm(AR, 13)                   # AF = AR - 13 (leaves AY0 = 13)
    a.alu(AR, PASS, None, AY0, GT)      # if > 13 → 13
    a.sts("DPTMO", AR)

    # autobuffer sync wait loop (patched by the board at init):
    # 0D02A3 4xxxx4 26E20F 1yyyy4 / 4xxxxA 9zzzzA ×2 / JUMP top
    a.label("sync")
    a.mov(AR, I7)                       # 0D02A3
    a.imm(AY0, BUF_MID)                 # 4xxxx4
    a.alu(AF, SUB, AR, AY0)             # 26E20F
    a.jump("sync", LT)                  # 1yyyy4
    a.c16(AR, BUF)                      # 4xxxxA
    a.sts("WPTR", AR)                   # 9zzzzA
    a.c16(AR, BUF_MID)                  # 4yyyyA
    a.sts("WPTR", AR)                   # 9zzzzA
    a.jump("top")                       # trapped by the board

    # ------------------------------------------------------------------
    # program body: loaded from ROM to PM $0800 by the init loader
    boot_len = (len(a.words) + 7) // 8 * 8
    assert boot_len <= OVERLAY_PM, f"boot section too large: {boot_len}"
    while a.pc < OVERLAY_PM:
        a.nop()

    _emit_byte_readers(a)
    _emit_irq2(a, reported_version)
    _emit_sweep_and_drain(a)
    _emit_vm(a)
    _emit_volume(a)
    if _variant is None:
        _emit_decode(a)
        _emit_transform(a)
    else:
        _variant["emit_decode"](a)
        _variant["emit_transform"](a)
    _emit_mix_update(a)

    words = a.assemble()
    overlay = words[OVERLAY_PM:]
    assert OVERLAY_PM + len(overlay) < 0x3000, \
        f"overlay overruns the PM data port: {len(overlay)}"
    # patch the loader's word count
    words[ld_n] = (words[ld_n] & ~0x3FFF0) | ((len(overlay) & 0x3FFF) << 4)
    boot = words[:boot_len]
    syms = dict(SYM)
    syms.update(TLAY if _variant is None else _variant["tlay"])
    syms.update(a.labels)
    return boot, overlay, syms


def overlay_blob(overlay_words):
    """ROM byte image of the PM overlay (3 bytes per 24-bit word)."""
    out = bytearray()
    for w in overlay_words:
        out += bytes(((w >> 16) & 0xFF, (w >> 8) & 0xFF, w & 0xFF))
    return bytes(out)


# ----------------------------------------------------------------------
# ROM byte access.  Pointers are (hi, lo) = (linear>>16, linear&0xFFFF);
# the DCS-93 board maps ROM through DM($2000-$2FFF) with the 4KB bank
# number at DM($3000) (reference: DCSDecoderEmu.cpp:459-505).

def _emit_byte_reader(a, hi, lo, label):
    """Emit a routine reading one byte at the (hi, lo) pointer scalars,
    post-incrementing.  Returns byte in AR.  Clobbers AY0, SI, SR, I2 (on
    DCS-95 also the BSEL scalar); preserves AX0, AX1, AY1, MX*, MY*, MR,
    I0, I1, SE."""
    a.label(label)
    if a.hw == 3:
        a.ld(SI, lo)
        a.shift_imm(LSHIFT_LO, SI, -11)  # SR0 = lo>>11
        a.ld(SI, hi)
        a.shift_imm(LSHIFT_LO_OR, SI, 5)  # SR0 |= hi<<5 → bank13
        a.lds(AY0, "CURBANK")
        a.alu(AF, SUB, SR0, AY0)
        a.jump(label + "_b", EQ)
        a.sts("CURBANK", SR0)
        a.call("set_bank95")            # split bank regs (boot block)
        a.label(label + "_b")
        a.ld(AR, lo)
        a.and_imm(AR, 0x07FF)           # 2KB window at DM($0000)
        a.mov(I2, AR)
    else:
        a.ld(SI, lo)
        a.shift_imm(LSHIFT_LO, SI, -12)  # SR0 = lo>>12
        a.ld(SI, hi)
        a.shift_imm(LSHIFT_LO_OR, SI, 4)  # SR0 |= hi<<4  → bank number
        a.lds(AY0, "CURBANK")
        a.alu(AF, SUB, SR0, AY0)
        a.jump(label + "_b", EQ)
        a.st(0x3000, SR0)               # bank select
        a.sts("CURBANK", SR0)
        a.label(label + "_b")
        a.ld(AR, lo)
        a.and_imm(AR, 0x0FFF)
        a.add_imm(AR, 0x2000)
        a.mov(I2, AR)
    # post-increment the pointer (16-bit lo with carry into hi)
    a.c16(AR, 1)
    a.ld(AY0, lo)
    a.alu(AR, ADD, AR, AY0)
    a.st(lo, AR)
    a.jump(label + "_c", NOT_AC)
    a.ld(AY0, hi)
    a.alu(AR, Y_INC, None, AY0)
    a.st(hi, AR)
    a.label(label + "_c")
    a.ld_i(AR, I2, M0)                  # the byte
    a.rts()


def _emit_byte_readers(a):
    # general-purpose cursor (track VM, tables, headers, DI lookups)
    _emit_byte_reader(a, SYM["P_HI"], SYM["P_LO"], "rd8")
    # the active stream's bit cursor
    _emit_byte_reader(a, SYM["B_CHI"], SYM["B_CLO"], "bytecur")

    # rd16: big-endian word at the P cursor → AR.  Clobbers exactly rd8's
    # clobber set (AY0, SI, SR, I2) — the first byte is parked in a scalar
    # across the second rd8 call, NOT in AX1: callers keep live values
    # there (the command dispatcher holds ch*64 in AX1 across the
    # next-track-link read, and rd24 holds the pointer high byte).
    a.label("rd16")
    a.call("rd8")
    a.sts("R16", AR)
    a.call("rd8")
    a.lds(SI, "R16")
    a.shift_imm(LSHIFT_LO, SI, 8)
    a.mov(AY0, SR0)
    a.alu(AR, OR, AR, AY0)
    a.rts()

    # rd24: AX1 = high byte, AR = low word.  The high byte is parked in a
    # scalar across the rd16 call — rd16 itself clobbers AX1 (it builds
    # the word there), so holding it in AX1 would alias pointers ≥ 64KB
    # down to (mid<<8 | lo); DM/bank masking made that accidentally
    # correct below 64KB, which is exactly why only large ROMs broke.
    a.label("rd24")
    a.call("rd8")
    a.sts("R24", AR)
    a.call("rd16")
    a.lds(AX1, "R24")
    a.rts()

    # ------------------------------------------------------------------
    # bit reader over the active stream.  32-bit window in B_WHI:B_WLO
    # (next bit = bit 31), B_NB valid bits.  Counterpart of refdec's
    # ROMBitPointer model (reference: DCSDecoderNative.h:229-289).

    # ensure: AX0 = n; refill while B_NB < n.  Preserves AX0, AX1, AY1.
    a.label("ensure")
    a.lds(AY0, "B_NB")
    a.alu(AF, RSUB, AX0, AY0)           # NB - n
    a.rts(GE)
    a.call("bytecur")                   # AR = next stream byte
    a.mov(SI, AR)
    a.lds(AY0, "B_NB")
    a.c16(AR, 24)
    a.alu(AR, SUB, AR, AY0)             # 24 - NB
    a.mov(SE, AR)
    a.shift_se(LSHIFT_LO, SI)           # byte << (24-NB), 32-bit
    a.lds(AY0, "B_WHI")
    a.alu(AR, OR, SR1, AY0)
    a.sts("B_WHI", AR)
    a.lds(AY0, "B_WLO")
    a.alu(AR, OR, SR0, AY0)
    a.sts("B_WLO", AR)
    a.lds(AY0, "B_NB")
    a.c16(AR, 8)
    a.alu(AR, ADD, AR, AY0)
    a.sts("B_NB", AR)
    a.jump("ensure")

    # consume: AX0 = k (1..17); window <<= k, B_NB -= k.  Preserves AX1, AY1.
    a.label("consume")
    a.mov(SE, AX0)
    a.lds(SI, "B_WHI")
    a.shift_se(LSHIFT_HI, SI)           # (WHI<<16) << k
    a.lds(SI, "B_WLO")
    a.shift_se(LSHIFT_LO_OR, SI)        # | WLO << k
    a.sts("B_WHI", SR1)
    a.sts("B_WLO", SR0)
    a.lds(AY0, "B_NB")
    a.alu(AR, RSUB, AX0, AY0)           # NB - k
    a.sts("B_NB", AR)
    a.rts()

    # peek: AX0 = n (1..16) → AR = top n bits, unsigned, not consumed
    a.label("peek")
    a.call("ensure")
    a.c16(AY0, 16)
    a.alu(AR, SUB, AX0, AY0)            # n - 16
    a.mov(SE, AR)
    a.lds(SI, "B_WHI")
    a.shift_se(LSHIFT_LO, SI)           # WHI >> (16-n)
    a.mov(AR, SR0)
    a.rts()

    # get1: one bit → AR (0/1), consumed
    a.label("get1")
    a.c16(AX0, 1)
    a.call("ensure")
    a.lds(SI, "B_WHI")
    a.shift_imm(LSHIFT_LO, SI, -15)
    a.mov(MX1, SR0)
    a.c16(AX0, 1)
    a.call("consume")
    a.mov(AR, MX1)
    a.rts()

    # getu: AX0 = n → AR = n bits unsigned, consumed (n ≤ 16)
    a.label("getu")
    a.call("peek")
    a.mov(MX1, AR)
    a.call("consume")
    a.mov(AR, MX1)
    a.rts()

    # gets: AX0 = w (1..17) → AR = w-bit field, sign-extended, low 16
    a.label("gets")
    a.call("ensure")
    a.c16(AY0, 32)
    a.alu(AR, SUB, AX0, AY0)            # w - 32
    a.mov(SE, AR)
    a.lds(SI, "B_WHI")
    a.shift_se(ASHIFT_HI, SI)           # (window hi) >> (32-w), arithmetic
    a.lds(SI, "B_WLO")
    a.shift_se(LSHIFT_LO_OR, SI)        # | WLO >> (32-w)
    a.mov(MX1, SR0)
    a.call("consume")
    a.mov(AR, MX1)
    a.rts()


# ----------------------------------------------------------------------

def _emit_irq2(a, reported_version):
    """Data-port protocol (refdec/decoder.py::irq2_handler; reference:
    DCSDecoderNative.cpp:3297-3437).  Uses the secondary register bank;
    RTI restores MSTAT (and with it the primary bank)."""
    a.label("irq2")
    a.ena_sec_reg()
    a.port_in(AX1)                      # AX1 = port byte
    a.lds(AX0, "DPTMO")
    a.cmp_imm(AX0, 13)
    a.jump("i2_a", LT)
    a.c16(AR, 0)
    a.sts("NDP", AR)
    a.label("i2_a")
    a.lds(AX0, "NDP")
    a.cmp_imm(AX0, 1)
    a.jump("i2_n1", EQ)
    a.cmp_imm(AX0, 2)
    a.jump("i2_n2", EQ)
    a.cmp_imm(AX0, 3)
    a.jump("i2_n3", EQ)
    # n == 0: word = byte << 8
    a.mov(SI, AX1)
    a.shift_imm(LSHIFT_LO, SI, 8)
    a.sts("DPW", SR0)
    a.c16(AR, 1)
    a.sts("NDP", AR)
    a.jump("i2_out")

    a.label("i2_n1")                    # second byte completes the word
    a.lds(AY0, "DPW")
    a.alu(AR, OR, AX1, AY0)
    a.sts("DPW", AR)
    a.mov(AX0, AR)                      # w
    # (0x55AA <= w <= 0x55B2) or (0x55BA <= w <= 0x55C1) → extended
    a.cmp_imm(AX0, 0x55AA)
    a.jump("i2_ne1", LT)
    a.cmp_imm(AX0, 0x55B3)
    a.jump("i2_ext", LT)
    a.cmp_imm(AX0, 0x55BA)
    a.jump("i2_drop", LT)               # 0x55B3..0x55B9
    a.cmp_imm(AX0, 0x55C2)
    a.jump("i2_ext", LT)
    a.jump("i2_vhi", EQ)
    a.cmp_imm(AX0, 0x55C3)
    a.jump("i2_vlo", EQ)
    a.jump("i2_ne1")
    a.label("i2_ext")
    a.sts("DPE", AX0)
    a.c16(AR, 2)
    a.sts("NDP", AR)
    a.jump("i2_out")
    a.label("i2_vhi")
    a.c16(AR, (reported_version >> 8) & 0xFF)
    a.port_out(AR)
    a.jump("i2_drop")
    a.label("i2_vlo")
    a.c16(AR, reported_version & 0xFF)
    a.port_out(AR)
    a.jump("i2_drop")
    a.label("i2_ne1")                   # not in the 55xx special ranges
    a.cmp_imm(AX0, 0x8000)
    a.jump("i2_drop", AC)               # w & 0x8000 → discard
    a.mov(AR, AX0)
    a.call("enqueue")
    a.label("i2_drop")
    a.c16(AR, 0)
    a.sts("NDP", AR)
    a.jump("i2_out")

    a.label("i2_n2")                    # value byte
    a.sts("DPW", AX1)
    a.c16(AR, 3)
    a.sts("NDP", AR)
    a.jump("i2_out")

    a.label("i2_n3")                    # ~complement check byte
    a.c16(AY0, 0x00FF)
    a.alu(AR, XOR, AX1, AY0)
    a.lds(AY0, "DPW")
    a.alu(AF, SUB, AR, AY0)
    a.jump("i2_drop", NE)               # bad check → discard
    a.lds(AX0, "DPE")
    a.cmp_imm(AX0, 0x55AA)
    a.jump("i2_vol", EQ)
    a.cmp_imm(AX0, 0x55B3)
    a.jump("i2_drop", GE)               # 55BA..C1 mystery params: ignored
    # channel volume 55AB..55B2
    a.c16(AY0, 0x55AB)
    a.alu(AR, SUB, AX0, AY0)            # channel number
    a.mov(SI, AR)
    a.shift_imm(LSHIFT_LO, SI, 6)       # ch * 64
    a.mov(AR, SR0)
    a.add_imm(AR, CH + C_CVOL)
    a.mov(I2, AR)
    a.lds(AR, "DPW")
    a.st_i(I2, M0, AR)
    a.jump("i2_drop")
    a.label("i2_vol")
    a.lds(AR, "DPW")
    a.sts("VOL_NOM", AR)
    a.jump("i2_drop")

    a.label("i2_out")
    a.c16(AR, 0)
    a.sts("DPTMO", AR)
    a.rti()

    # enqueue: AR = command word → ring (clobbers AY0, SI, SR, I2)
    a.label("enqueue")
    a.mov(MX1, AR)
    a.lds(AX0, "CQT")
    a.and_imm(AX0, 63)
    a.add_imm(AR, CMDQ)
    a.mov(I2, AR)
    a.st_i(I2, M0, MX1)
    a.lds(AY0, "CQT")
    a.alu(AR, Y_INC, None, AY0)
    a.sts("CQT", AR)
    a.rts()


# ----------------------------------------------------------------------

def _emit_sweep_and_drain(a):
    # stop_sweep: forced-stop flags (refdec main_loop prologue)
    a.label("stop_sweep")
    a.c16(AR, 0)
    a.sts("XCH", AR)
    a.label("ss_loop")
    a.lds(AX0, "XCH")
    a.mov(SI, AX0)
    a.shift_imm(LSHIFT_LO, SI, 6)
    a.mov(AX1, SR0)                     # ch*64
    a.mov(AR, AX1)
    a.add_imm(AR, CH + C_STOP)
    a.mov(I1, AR)
    a.ld_i(AR, I1, M0)
    a.cmp_imm(AR, 0)
    a.jump("ss_next", EQ)
    a.st_i_imm(I1, M0, 0)               # stop = False
    a.mov(AR, AX1)
    a.add_imm(AR, ST + S_PLAY)
    a.mov(I1, AR)
    a.ld_i(AR, I1, M0)
    a.cmp_imm(AR, 0)
    a.jump("ss_trk", EQ)
    a.st_i_imm(I1, M0, 0)               # stream stops
    a.lds(AR, "XCH")
    a.call("rs_mixcol")
    a.label("ss_trk")
    a.mov(AR, AX1)
    a.add_imm(AR, CH + C_TRKHI)
    a.mov(I1, AR)
    a.st_i_imm(I1, M0, 0xFFFF)          # track ptr = null
    a.label("ss_next")
    a.lds(AY0, "XCH")
    a.alu(AR, Y_INC, None, AY0)
    a.sts("XCH", AR)
    a.cmp_imm(AR, 8)
    a.jump("ss_loop", NE)
    a.rts()

    # rs_mixcol: AR = source channel → reset mixer[*][src] columns
    # (cur = target = steps = 0; delta preserved), refdec _reset_mixing_levels
    a.label("rs_mixcol")
    a.mov(SI, AR)
    a.shift_imm(LSHIFT_LO, SI, 2)       # src*4
    a.mov(AR, SR0)
    a.add_imm(AR, MIXA)
    a.mov(I1, AR)
    a.imm(M3, 29)                       # stride 32, minus the 3 walked
    with a.loop_ce(n=8):
        a.st_i_imm(I1, M1, 0)           # cur
        a.st_i_imm(I1, M1, 0)           # target
        a.modify(I1, M1)                # skip delta
        a.st_i_imm(I1, M3, 0)           # steps; advance to next row
    a.imm(M3, 0)
    a.rts()

    # cmd_drain: pending commands → track loads (refdec main_loop)
    a.label("cmd_drain")
    a.lds(AX0, "CQH")
    a.lds(AY0, "CQT")
    a.alu(AF, SUB, AX0, AY0)
    a.rts(EQ)
    a.and_imm(AX0, 63)
    a.add_imm(AR, CMDQ)
    a.mov(I1, AR)
    a.lds(AY0, "CQH")
    a.alu(AR, Y_INC, None, AY0)
    a.sts("CQH", AR)
    a.ld_i(AX0, I1, M0)                 # the command
    a.lds(AY0, "NTRK")
    a.alu(AF, SUB, AX0, AY0)            # cmd - n_tracks
    a.jump("cmd_drain", AC)             # cmd >= n_tracks → skip
    # P = track index + cmd*3
    a.mov(AY1, AX0)
    a.mov(AR, AX0)
    a.alu(AR, ADD, AR, AY1)
    a.alu(AR, ADD, AR, AY1)             # cmd*3
    a.lds(AY0, "TIX_LO")
    a.alu(AR, ADD, AR, AY0)
    a.sts("P_LO", AR)
    a.c16(AX0, 0)
    a.lds(AY0, "TIX_HI")
    a.alu(AR, ADD_C, AX0, AY0)          # 0 + hi + carry
    a.sts("P_HI", AR)
    a.call("rd24")                      # AX1 = addr hi, AR = addr lo
    a.mov(AY1, AR)
    a.cmp_imm(AX1, 0x00FF)
    a.jump("cmd_drain", EQ)             # unpopulated ($FFxxxx)
    a.sts("P_HI", AX1)
    a.sts("P_LO", AY1)
    a.call("rd8")
    a.mov(MR1, AR)                      # track type (MR survives rd8/rd16)
    a.call("rd8")
    a.mov(SI, AR)                       # channel number
    a.shift_imm(LSHIFT_LO, SI, 6)
    a.mov(AX1, SR0)                     # ch*64
    a.cmp_imm(MR1, 1)
    a.jump("cmd_t1", EQ)
    a.cmp_imm(MR1, 3)
    a.jump("cmd_reset", GT)
    # types 0/2/3: latch as next-track link
    a.call("rd16")
    a.mov(MX1, AR)
    a.mov(AR, AX1)
    a.add_imm(AR, CH + C_NXTT)
    a.mov(I1, AR)
    a.st_i(I1, M1, MR1)
    a.st_i(I1, M0, MX1)
    a.jump("cmd_drain")
    a.label("cmd_t1")
    a.call("load_track")                # AX1 = ch*64; P = program start
    a.jump("cmd_drain")
    a.label("cmd_reset")
    a.c16(AR, 0x0200)
    a.st(0x3FFF, AR)                    # board raises ResetError
    a.jump("cmd_reset")

    # load_track: AX1 = ch*64 (refdec _load_track)
    a.label("load_track")
    a.mov(AR, AX1)
    a.add_imm(AR, CH)
    a.mov(I1, AR)
    a.lds(AR, "P_HI")
    a.st_i(I1, M1, AR)                  # track ptr
    a.lds(AR, "P_LO")
    a.st_i(I1, M1, AR)
    a.st_i_imm(I1, M0, 0)               # track counter = 0
    a.mov(AR, AX1)
    a.add_imm(AR, ST + S_PLAY)
    a.mov(I1, AR)
    a.st_i_imm(I1, M0, 0)               # stream stops
    a.mov(AR, AX1)
    a.add_imm(AR, CH + C_LSP)
    a.mov(I1, AR)
    a.st_i_imm(I1, M0, 0)               # loop stack empty
    if a.os93a:
        a.mov(AR, AX1)
        a.add_imm(AR, CH + C_HETI)
        a.mov(I1, AR)
        a.st_i_imm(I1, M1, 0)           # host-event timer cleared
        a.st_i_imm(I1, M0, 0)
    # done-mask bit clear: DONE &= ~(1<<ch)
    a.mov(SI, AX1)
    a.shift_imm(LSHIFT_LO, SI, -6)
    a.c16(SI, 1)
    a.mov(SE, SR0)
    a.shift_se(LSHIFT_LO, SI)
    a.c16(AY0, 0xFFFF)
    a.alu(AR, XOR, SR0, AY0)
    a.lds(AY0, "DONE")
    a.alu(AR, AND, AR, AY0)
    a.sts("DONE", AR)
    a.mov(SI, AX1)
    a.shift_imm(LSHIFT_LO, SI, -6)
    a.mov(AR, SR0)
    a.call("rs_mixcol")
    a.rts()


# ----------------------------------------------------------------------

def _emit_vm(a):
    """Track byte-code VM (refdec/decoder.py::_exec_track; reference:
    DCSDecoderNative.cpp:848-1228), run to quiescence over all channels."""
    a.label("vm_run")
    a.c16(AR, 0)
    a.sts("DONE", AR)
    a.sts("XCH", AR)
    a.label("vm_loop")
    a.lds(AX0, "DONE")
    a.cmp_imm(AX0, 0xFF)
    a.rts(EQ)
    # bit = 1 << XCH
    a.lds(AR, "XCH")
    a.mov(SE, AR)
    a.c16(SI, 1)
    a.shift_se(LSHIFT_LO, SI)
    a.lds(AY0, "DONE")
    a.alu(AF, AND, SR0, AY0)
    a.jump("vm_next", NE)
    a.call("exec_track")
    a.lds(AR, "XCH")
    a.mov(SE, AR)
    a.c16(SI, 1)
    a.shift_se(LSHIFT_LO, SI)
    a.lds(AY0, "DONE")
    a.alu(AR, OR, SR0, AY0)
    a.sts("DONE", AR)
    a.label("vm_next")
    a.lds(AY0, "XCH")
    a.alu(AR, Y_INC, None, AY0)
    a.and_imm(AR, 7)
    a.sts("XCH", AR)
    a.jump("vm_loop")

    # ------------------------------------------------------------------
    a.label("exec_track")
    a.lds(SI, "XCH")
    a.shift_imm(LSHIFT_LO, SI, 6)       # ch*64
    a.mov(AR, SR0)
    a.add_imm(AR, CH)
    a.sts("CHB", AR)
    a.mov(AR, SR0)
    a.add_imm(AR, ST)
    a.sts("STB", AR)
    a.lds(AR, "CHB")
    a.mov(I1, AR)
    a.ld_i(AX0, I1, M1)                 # track ptr hi
    a.ld_i(AX1, I1, M0)                 # track ptr lo
    a.cmp_imm(AX0, 0xFFFF)
    a.rts(EQ)                           # no program on this channel
    a.sts("P_HI", AX0)
    a.sts("P_LO", AX1)

    a.label("xt_step")
    a.lds(AR, "P_HI")
    a.sts("SV_HI", AR)
    a.lds(AR, "P_LO")
    a.sts("SV_LO", AR)
    a.call("rd16")                      # count prefix
    a.mov(AX0, AR)
    a.cmp_imm(AX0, 0xFFFF)
    a.jump("xt_park", EQ)
    a.lds(AR, "CHB")
    a.add_imm(AR, C_TCTR)
    a.mov(I1, AR)
    a.ld_i(AY1, I1, M0)
    a.alu(AF, SUB, AX0, AY1)            # count != track counter → wait
    a.jump("xt_park", NE)
    a.st_i_imm(I1, M0, 0)               # counter = 0
    a.call("rd8")
    a.mov(MR1, AR)                      # opcode
    a.cmp_imm(MR1, 0x00)
    a.jump("xt_op00", EQ)
    a.cmp_imm(MR1, 0x01)
    a.jump("xt_op01", EQ)
    a.cmp_imm(MR1, 0x02)
    a.jump("xt_op02", EQ)
    a.cmp_imm(MR1, 0x03)
    a.jump("xt_op03", EQ)
    a.cmp_imm(MR1, 0x04)
    a.jump("xt_op04", EQ)
    a.cmp_imm(MR1, 0x05)
    a.jump("xt_op05", EQ)
    a.cmp_imm(MR1, 0x06)
    a.jump("xt_op06", EQ)
    a.cmp_imm(MR1, 0x0D)
    a.jump("xt_step", EQ)               # NOP
    a.cmp_imm(MR1, 0x0E)
    a.jump("xt_op0e", EQ)
    a.cmp_imm(MR1, 0x0F)
    a.jump("xt_op0f", EQ)
    a.cmp_imm(MR1, 0x10)
    a.jump("xt_op10", EQ)
    a.cmp_imm(MR1, 0x11)
    a.jump("xt_op11", EQ)
    a.cmp_imm(MR1, 0x12)
    a.jump("xt_op11", EQ)
    a.cmp_imm(MR1, 0x07)
    a.jump("cmd_reset", LT)             # invalid opcode → hardware reset
    a.cmp_imm(MR1, 0x0C)
    a.jump("cmd_reset", GT)
    a.jump("xt_mix")                    # 0x07..0x0C mixing-level ops

    a.label("xt_park")                  # wait here: roll back the cursor
    a.lds(AR, "CHB")
    a.mov(I1, AR)
    a.lds(AR, "SV_HI")
    a.st_i(I1, M1, AR)
    a.lds(AR, "SV_LO")
    a.st_i(I1, M0, AR)
    a.rts()

    # --- $00: end of track --------------------------------------------
    a.label("xt_op00")
    a.lds(AR, "CHB")
    a.mov(I1, AR)
    a.st_i_imm(I1, M0, 0xFFFF)          # track ptr = null
    a.lds(AR, "STB")
    a.mov(I1, AR)
    a.st_i_imm(I1, M0, 0)               # stream stops
    a.lds(AR, "CHB")
    a.add_imm(AR, C_LSP)
    a.mov(I1, AR)
    a.st_i_imm(I1, M0, 0)
    if a.os93a:
        a.lds(AR, "CHB")
        a.add_imm(AR, C_HETI)
        a.mov(I1, AR)
        a.st_i_imm(I1, M1, 0)           # host-event timer cleared
        a.st_i_imm(I1, M0, 0)
    a.lds(AR, "XCH")
    a.call("rs_mixcol")
    a.rts()

    # --- $01: play stream ---------------------------------------------
    a.label("xt_op01")
    a.call("rd8")                       # stream channel
    a.sts("TMP0", AR)
    a.cmp_imm(AR, 5)
    a.jump("o1_a", NE)
    a.c16(AX0, 0)
    a.st(CH + 5 * 64 + C_MOVR, AX0)     # clear channel-5 max override
    a.label("o1_a")
    a.call("rd8")                       # stream address: hi byte
    a.sts("TMP1", AR)
    a.call("rd16")                      # low word
    a.sts("TMP2", AR)
    a.call("rd8")                       # loop count
    a.sts("TMP3", AR)
    a.call("load_stream")
    a.jump("xt_step")

    # load_stream: TMP0=stream ch, TMP1:TMP2=linear addr, TMP3=loop count,
    # XCH=source channel (refdec _load_audio_stream/_init_channel_stream)
    a.label("load_stream")
    a.lds(SI, "TMP0")
    a.shift_imm(LSHIFT_LO, SI, 6)
    a.mov(AR, SR0)
    a.add_imm(AR, ST)
    a.sts("TMP4", AR)                   # stream block base
    a.lds(AR, "P_HI")                   # preserve the track cursor
    a.sts("Q_HI", AR)
    a.lds(AR, "P_LO")
    a.sts("Q_LO", AR)
    a.lds(AR, "TMP1")
    a.sts("P_HI", AR)
    a.lds(AR, "TMP2")
    a.sts("P_LO", AR)
    a.call("rd16")                      # frame count
    a.mov(MX0, AR)
    a.lds(AX0, "TMP4")
    a.add_imm(AX0, S_FCTR)
    a.mov(I1, AR)
    a.st_i(I1, M1, MX0)                 # frame counter (S_FCTR)
    a.st_i(I1, M0, MX0)                 # total frames (S_NFRM)
    # header pointer = cursor (past the count), start = header + 16
    a.lds(AX0, "TMP4")
    a.add_imm(AX0, S_HDRHI)
    a.mov(I1, AR)
    a.lds(AR, "P_HI")
    a.st_i(I1, M1, AR)
    a.lds(AR, "P_LO")
    a.st_i(I1, M1, AR)                  # I1 now at S_SRTHI
    if a.os93a:
        # OS93a: Type-1 streams (hdr[0] bit 7) carry a 1-byte header
        # (refdec _init_channel_stream header_len)
        a.call("rd8")                   # hdr[0]; P → header+1
        a.mov(AX1, AR)
        a.and_imm(AX1, 0x80)
        a.cmp_imm(AR, 0)
        a.jump("ls_h1", NE)
        a.lds(AX0, "P_LO")              # 16-byte header: start = P + 15
        a.add_imm(AX0, 15)
        a.mov(MX0, AR)
        a.c16(AX0, 0)
        a.lds(AY0, "P_HI")
        a.alu(AR, ADD_C, AX0, AY0)
        a.jump("ls_hd")
        a.label("ls_h1")                # 1-byte header: start = P
        a.lds(MX0, "P_LO")
        a.lds(AR, "P_HI")
        a.label("ls_hd")
    else:
        a.lds(AX0, "P_LO")
        a.add_imm(AX0, 16)
        a.mov(MX0, AR)                  # start lo
        a.c16(AX0, 0)
        a.lds(AY0, "P_HI")
        a.alu(AR, ADD_C, AX0, AY0)      # start hi
    a.st_i(I1, M1, AR)                  # S_SRTHI
    a.st_i(I1, M1, MX0)                 # S_SRTLO
    a.st_i(I1, M1, AR)                  # S_CURHI
    a.st_i(I1, M1, MX0)                 # S_CURLO
    a.st_i_imm(I1, M1, 0)               # window hi
    a.st_i_imm(I1, M1, 0)               # window lo
    a.st_i_imm(I1, M0, 0)               # bit count
    a.lds(AX0, "TMP4")
    a.add_imm(AX0, S_PLAY)
    a.mov(I1, AR)
    a.st_i_imm(I1, M0, 1)               # playing
    a.lds(AX0, "TMP4")
    a.add_imm(AX0, S_NEEDI)
    a.mov(I1, AR)
    a.st_i_imm(I1, M0, 1)               # init on first decode
    # restore the track cursor
    a.lds(AR, "Q_HI")
    a.sts("P_HI", AR)
    a.lds(AR, "Q_LO")
    a.sts("P_LO", AR)
    # zero-length stream: no loop/source bookkeeping (refdec returns early)
    a.lds(AX0, "TMP4")
    a.add_imm(AX0, S_NFRM)
    a.mov(I1, AR)
    a.ld_i(AX0, I1, M0)
    a.cmp_imm(AX0, 0)
    a.rts(EQ)
    a.lds(AX0, "TMP4")
    a.add_imm(AX0, S_LCTR)
    a.mov(I1, AR)
    a.lds(AR, "TMP3")
    a.st_i(I1, M0, AR)                  # loop counter
    # source-channel switch: reset mixer[stch][old] if changing owners
    a.lds(AX0, "TMP4")
    a.add_imm(AX0, (CH + C_SRC - ST) & 0xFFFF)
    a.mov(I1, AR)
    a.ld_i(AX0, I1, M0)                 # old source
    a.cmp_imm(AX0, 0xFFFF)
    a.jump("ls_set", EQ)
    a.lds(AY0, "XCH")
    a.alu(AF, SUB, AX0, AY0)
    a.jump("ls_set", EQ)
    a.lds(SI, "TMP0")
    a.shift_imm(LSHIFT_LO, SI, 5)       # stch*32
    a.mov(AY1, SR0)
    a.mov(SI, AX0)
    a.shift_imm(LSHIFT_LO, SI, 2)       # old*4
    a.alu(AR, ADD, SR0, AY1)
    a.add_imm(AR, MIXA)
    a.mov(I2, AR)
    a.st_i_imm(I2, M1, 0)               # cur
    a.st_i_imm(I2, M1, 0)               # target
    a.modify(I2, M1)
    a.st_i_imm(I2, M0, 0)               # steps
    a.label("ls_set")
    a.lds(AR, "XCH")
    a.st_i(I1, M0, AR)                  # source channel = executing channel
    a.rts()

    # --- $02: stop channel --------------------------------------------
    a.label("xt_op02")
    a.call("rd8")
    a.mov(SI, AR)
    a.shift_imm(LSHIFT_LO, SI, 6)
    a.mov(AX1, SR0)                     # target*64
    a.mov(AR, AX1)
    a.add_imm(AR, ST + S_PLAY)
    a.mov(I1, AR)
    a.ld_i(AR, I1, M0)
    a.cmp_imm(AR, 0)
    a.jump("o2_a", EQ)
    a.st_i_imm(I1, M0, 0)               # stream stops
    a.mov(SI, AX1)
    a.shift_imm(LSHIFT_LO, SI, -6)
    a.mov(AR, SR0)
    a.call("rs_mixcol")
    a.label("o2_a")
    a.mov(AR, AX1)
    a.add_imm(AR, CH + C_TRKHI)
    a.mov(I1, AR)
    a.st_i_imm(I1, M0, 0xFFFF)          # target's track ptr = null
    if a.os93a:
        a.mov(AR, AX1)
        a.add_imm(AR, CH + C_HETI)
        a.mov(I1, AR)
        a.st_i_imm(I1, M1, 0)           # target's host-event timer cleared
        a.st_i_imm(I1, M0, 0)
    a.lds(AR, "CHB")
    a.mov(I1, AR)
    a.ld_i(AR, I1, M0)
    a.cmp_imm(AR, 0xFFFF)
    a.rts(EQ)                           # stopped ourselves
    a.jump("xt_step")

    # --- $03: queue command -------------------------------------------
    a.label("xt_op03")
    a.call("rd16")
    a.call("enqueue")
    a.jump("xt_step")

    # --- $04: write data port -----------------------------------------
    a.label("xt_op04")
    if a.os93a:
        # 1993a grammar: cmd byte + repeat counter driving the channel's
        # host-event timer (refdec _exec_track op $04, OS93A branch)
        a.call("rd8")
        a.sts("TMP0", AR)               # cmd byte
        a.call("rd16")
        a.sts("TMP1", AR)               # repeat counter
        a.lds(AX0, "CHB")
        a.add_imm(AX0, C_HETD)
        a.mov(I1, AR)
        a.lds(AX0, "TMP0")
        a.cmp_imm(AX0, 0)
        a.jump("o4_clr", EQ)            # cmd 0: clear the timer
        a.port_out(AX0)
        a.lds(AX1, "TMP1")
        a.cmp_imm(AX1, 0)
        a.jump("o4_clr", EQ)            # no counter: one-shot
        a.st_i(I1, M1, AX0)             # data = cmd
        a.st_i(I1, M1, AX1)             # interval = counter
        a.st_i(I1, M0, AX1)             # counter = interval
        a.jump("xt_step")
        a.label("o4_clr")
        a.modify(I1, M1)                # skip data
        a.st_i_imm(I1, M1, 0)           # interval = 0
        a.st_i_imm(I1, M0, 0)           # counter = 0
        a.jump("xt_step")
    else:
        a.call("rd8")
        a.port_out(AR)
        a.jump("xt_step")

    # --- $05: start deferred track ------------------------------------
    a.label("xt_op05")
    a.call("rd8")
    a.mov(SI, AR)
    a.shift_imm(LSHIFT_LO, SI, 6)
    a.mov(AR, SR0)
    a.add_imm(AR, CH + C_NXTT)
    a.mov(I1, AR)
    a.ld_i(AX0, I1, M0)                 # deferred type
    a.cmp_imm(AX0, 0)
    a.jump("xt_step", EQ)
    a.st_i_imm(I1, M1, 0)               # consume it; I1 → link
    a.ld_i(AR, I1, M0)                  # link word
    a.cmp_imm(AX0, 2)
    a.jump("o5_t2", EQ)
    # type 3: Catalog[DI index][link.lo][variables[link.hi]]
    a.mov(AX0, AR)
    a.and_imm(AX0, 0xFF)
    a.sts("TMP0", AR)                   # table id
    a.mov(SI, AX0)
    a.shift_imm(LSHIFT_LO, SI, -8)
    a.mov(AR, SR0)
    a.add_imm(AR, VARS)
    a.mov(I1, AR)
    a.ld_i(AR, I1, M0)
    a.sts("TMP1", AR)                   # variable value
    a.lds(AR, "TMP0")
    a.mov(AY1, AR)
    a.alu(AR, ADD, AR, AY1)
    a.alu(AR, ADD, AR, AY1)             # id*3
    a.lds(AY0, "DIX_LO")
    a.alu(AR, ADD, AR, AY0)
    a.sts("P_LO", AR)
    a.c16(AX0, 0)
    a.lds(AY0, "DIX_HI")
    a.alu(AR, ADD_C, AX0, AY0)
    a.sts("P_HI", AR)
    a.call("rd24")                      # AX1:AR = table address
    a.mov(AY1, AR)
    a.ld(SI, SYM["TMP1"])
    a.shift_imm(LSHIFT_LO, SI, 1)       # var*2
    a.alu(AR, ADD, SR0, AY1)
    a.sts("P_LO", AR)
    a.c16(AX0, 0)
    a.mov(AY0, AX1)
    a.alu(AR, ADD_C, AX0, AY0)
    a.sts("P_HI", AR)
    a.call("rd16")
    a.call("enqueue")
    a.jump("xt_step")
    a.label("o5_t2")
    a.call("enqueue")                   # AR = link
    a.jump("xt_step")

    # --- $06: set variable (1993 software: a no-op with no operands,
    # refdec _exec_track) -----------------------------------------------
    a.label("xt_op06")
    if a.os93:
        a.jump("xt_step")
    else:
        a.call("rd8")
        a.add_imm(AR, VARS)
        a.mov(I1, AR)
        a.call("rd8")
        a.st_i(I1, M0, AR)
        a.jump("xt_step")

    # --- $07-$0C: mixing level ops ------------------------------------
    a.label("xt_mix")
    a.cmp_imm(MR1, 0x0A)
    a.jump("mx_fade", GE)
    a.c16(AY0, 0x07)
    a.alu(AR, SUB, MR1, AY0)
    a.sts("TMP2", AR)                   # mode
    a.c16(AR, 0)
    a.sts("TMP3", AR)                   # fade = no
    a.jump("mx_go")
    a.label("mx_fade")
    a.c16(AY0, 0x0A)
    a.alu(AR, SUB, MR1, AY0)
    a.sts("TMP2", AR)
    a.c16(AR, 1)
    a.sts("TMP3", AR)
    a.label("mx_go")
    a.call("rd8")                       # target channel
    a.mov(SI, AR)
    a.shift_imm(LSHIFT_LO, SI, 5)       # target*32
    a.mov(AY1, SR0)
    a.lds(SI, "XCH")
    a.shift_imm(LSHIFT_LO, SI, 2)       # source*4
    a.alu(AR, ADD, SR0, AY1)
    a.add_imm(AR, MIXA)
    a.sts("TMP4", AR)                   # mixer entry base
    a.call("rd8")                       # raw level byte
    a.mov(SI, AR)
    a.shift_imm(LSHIFT_LO, SI, 8)
    a.mov(SI, SR0)
    a.shift_imm(ASHIFT_LO, SI, -2)      # sign-extended << 6
    a.sts("TMP0", SR0)                  # param
    a.c16(AR, 0)
    a.lds(AX0, "TMP3")
    a.cmp_imm(AX0, 0)
    a.jump("mx_s0", EQ)
    a.call("rd16")                      # fade step count
    a.label("mx_s0")
    a.sts("TMP1", AR)                   # steps
    a.lds(AX0, "TMP4")
    a.add_imm(AX0, 3)
    a.mov(I1, AR)
    a.lds(AR, "TMP1")
    a.st_i(I1, M0, AR)                  # fade_steps = steps
    a.lds(AR, "TMP4")
    a.mov(I1, AR)
    a.ld_i(AX1, I1, M0)                 # old = cur_level
    a.lds(AX0, "TMP2")
    a.lds(AY1, "TMP0")                  # param
    a.cmp_imm(AX0, 0)
    a.jump("mx_m0", EQ)
    a.cmp_imm(AX0, 1)
    a.jump("mx_m1", EQ)
    a.alu(AR, SUB, AX1, AY1)            # mode 2: old - param
    a.jump("mx_nw")
    a.label("mx_m0")
    a.alu(AR, PASS, None, AY1)          # mode 0: param
    a.jump("mx_nw")
    a.label("mx_m1")
    a.alu(AR, ADD, AX1, AY1)            # mode 1: old + param
    a.label("mx_nw")
    a.mov(MR1, AR)                      # new (pre-clamp)
    a.mov(AY1, AX1)
    a.alu(AR, SUB, MR1, AY1)            # delta = new - old
    a.sts("TMP2", AR)
    a.mov(AR, MR1)
    a.cmp_imm(AR, 8191)
    a.alu(AR, PASS, None, AY0, GT)      # clamp high
    a.cmp_imm(AR, -8191 & 0xFFFF)
    a.c16(AY0, -8191 & 0xFFFF)
    a.alu(AR, PASS, None, AY0, LT)      # clamp low
    a.mov(MR1, AR)                      # new (clamped)
    a.lds(AX0, "TMP4")
    a.add_imm(AX0, 1)
    a.mov(I1, AR)
    a.st_i(I1, M0, MR1)                 # fade_target = new
    a.lds(AX0, "TMP1")
    a.cmp_imm(AX0, 0)
    a.jump("mx_div", NE)
    a.lds(AR, "TMP4")
    a.mov(I1, AR)
    a.st_i(I1, M0, MR1)                 # no fade: cur_level = new
    a.jump("xt_step")
    a.label("mx_div")
    # fade_delta = trunc(|delta| / steps) with the sign of delta
    a.lds(AX0, "TMP2")
    a.cmp_imm(AX0, 0)
    a.c16(AR, 0)
    a.sts("TMP3", AR)                   # sign flag
    a.jump("mx_dp", GE)
    a.c16(AR, 1)
    a.sts("TMP3", AR)
    a.label("mx_dp")
    a.alu(AR, ABS, AX0)                 # |delta| (< 2^15)
    a.lds(AX0, "TMP1")                  # steps
    a.cmp_imm(AX0, 0x8000)
    a.jump("mx_q", AC)                  # steps ≥ 2^15 > |delta| → q = 0
    # ADSP non-restoring divide: AF:AY0 = |delta|<<1, X = steps;
    # q = (|delta|<<1) / (2·steps) = |delta|/steps (truncated)
    a.mov(SI, AR)
    a.shift_imm(LSHIFT_LO, SI, 1)
    a.mov(AY0, SR0)                     # dividend lo = |delta|<<1
    a.alu(AF, PASS, None, None)         # dividend hi = 0
    a.divs(AF, AX0)
    for _ in range(15):
        a.divq(AX0)
    a.jump("mx_sgn")
    a.label("mx_q")
    a.c16(AR, 0)
    a.mov(AY0, AR)
    a.label("mx_sgn")
    a.mov(AY1, AY0)                     # quotient (cmp_imm clobbers AY0)
    a.lds(AX1, "TMP3")
    a.cmp_imm(AX1, 0)
    a.jump("mx_pos", EQ)
    a.alu(AR, NEG_Y, None, AY1)         # negative delta → -q
    a.jump("mx_st")
    a.label("mx_pos")
    a.alu(AR, PASS, None, AY1)          # q
    a.label("mx_st")
    a.mov(MX0, AR)
    a.lds(AX0, "TMP4")
    a.add_imm(AX0, 2)
    a.mov(I1, AR)
    a.st_i(I1, M0, MX0)                 # fade_delta
    a.jump("xt_step")

    # --- $0E/$0F: loop push / loop end --------------------------------
    a.label("xt_op0e")
    a.call("rd8")
    a.sts("TMP0", AR)                   # loop count
    a.lds(AX0, "CHB")
    a.add_imm(AX0, C_LSP)
    a.mov(I1, AR)
    a.ld_i(AX0, I1, M0)                 # stack pointer
    a.cmp_imm(AX0, 16)
    a.jump("xt_step", GE)               # overflow guard: drop
    a.mov(AY1, AX0)
    a.alu(AR, Y_INC, None, AY1)
    a.st_i(I1, M0, AR)                  # sp + 1
    a.mov(AR, AX0)
    a.mov(AY1, AX0)
    a.alu(AR, ADD, AR, AY1)
    a.alu(AR, ADD, AR, AY1)             # sp*3
    a.lds(AY0, "CHB")
    a.alu(AR, ADD, AR, AY0)
    a.add_imm(AR, C_LSTK)
    a.mov(I2, AR)
    a.lds(AR, "TMP0")
    a.st_i(I2, M1, AR)                  # [count,
    a.lds(AR, "P_HI")
    a.st_i(I2, M1, AR)                  #  ptr hi,
    a.lds(AR, "P_LO")
    a.st_i(I2, M0, AR)                  #  ptr lo]
    a.jump("xt_step")

    a.label("xt_op0f")
    a.lds(AX0, "CHB")
    a.add_imm(AX0, C_LSP)
    a.mov(I1, AR)
    a.ld_i(AX0, I1, M0)
    a.cmp_imm(AX0, 0)
    a.jump("xt_step", EQ)               # empty stack: no-op
    a.mov(AY1, AX0)
    a.alu(AR, Y_DEC, None, AY1)
    a.mov(AX1, AR)                      # sp-1
    a.mov(AY1, AR)
    a.alu(AR, ADD, AR, AY1)
    a.alu(AR, ADD, AR, AY1)             # (sp-1)*3
    a.lds(AY0, "CHB")
    a.alu(AR, ADD, AR, AY0)
    a.add_imm(AR, C_LSTK)
    a.mov(I2, AR)
    a.ld_i(AX0, I2, M0)                 # counter (cursor stays)
    a.cmp_imm(AX0, 0)
    a.jump("of_inf", EQ)
    a.cmp_imm(AX0, 1)
    a.jump("of_pop", EQ)
    a.mov(AY1, AX0)
    a.alu(AR, Y_DEC, None, AY1)
    a.st_i(I2, M1, AR)                  # counter--
    a.label("of_load")
    a.ld_i(AR, I2, M1)
    a.sts("P_HI", AR)
    a.ld_i(AR, I2, M0)
    a.sts("P_LO", AR)
    a.jump("xt_step")
    a.label("of_inf")
    a.modify(I2, M1)
    a.jump("of_load")
    a.label("of_pop")
    a.st_i(I1, M0, AX1)                 # sp = sp-1
    a.jump("xt_step")

    # --- $10/$11/$12: unused ops (skip operands) ----------------------
    a.label("xt_op10")
    a.call("rd8")
    a.call("rd8")
    a.jump("xt_step")
    a.label("xt_op11")
    a.call("rd8")
    a.call("rd8")
    a.call("rd16")
    a.jump("xt_step")


# ----------------------------------------------------------------------

def _emit_volume(a):
    """Per-frame master-volume multiplier, the uint64-exact volShift
    headroom sum, and the mixing-multiplier fold (refdec main_loop;
    reference: DCSDecoderNative.cpp:227-269, 3250-3282)."""
    a.label("vol_fold")
    # master-volume signature (board finds VOL_NOM through it):
    a.ld(SR1, SYM["VOL_NOM"])           # 8xxxxF
    a.emit(0x2E7FEF)                    # AF = SR1 + 0, SR0 = SR1
    a.jump("vz", EQ)                    # 1yyyy0
    # multiplier = 2 · (0x3FFF · 0.981201^(255-vol)) via square-multiply
    a.c16(AR, 0x3FFF)
    a.c16(MX1, 0x7D98)
    a.c16(MY0, 0x7D98)
    a.call("sqmul")                     # SR0 already = vol
    a.mov(SI, AR)
    a.shift_imm(LSHIFT_LO, SI, 1)
    a.sts("VOL_MULT", SR0)
    a.jump("vf_sum")
    a.label("vz")
    a.c16(AR, 0)
    a.sts("VOL_MULT", AR)

    a.label("vf_sum")
    # mixingSum = Σ playing mm·volMult — uint64-exact (reference uses
    # uint64).  MAC UU products ≥ 2^31 wrap in the 2105's int32 product
    # path, so split volMult into bytes: two wrap-free passes, composed
    # as a 48-bit value afterwards.
    a.ena_int()
    for pas, (sym_lo, sym_hi, shift) in enumerate(
            (("SUM0LO", "SUM0HI", 0), ("SUM1LO", "SUM1HI", -8))):
        a.lds(SI, "VOL_MULT")
        if shift:
            a.shift_imm(LSHIFT_LO, SI, shift)
            a.mov(AX0, SR0)
        else:
            a.mov(AX0, SI)
            a.and_imm(AX0, 0xFF)
            a.mov(SR0, AR)
        if shift:
            a.mov(MY0, SR0)             # v_hi
        else:
            a.mov(MY0, SR0)             # v_lo
        a.imm(MR0, 0)
        a.imm(MR1, 0)                   # also clears MR2
        a.imm(I1, CH + C_MMULT)
        a.imm(I3, ST + S_PLAY)
        a.imm(M3, 64)
        with a.loop_ce(n=8):
            a.ld_i(AX0, I3, M3)         # playing?
            a.ld_i(MX0, I1, M3)         # mixing multiplier
            a.cmp_imm(AX0, 0)
            a.mac(MR, MAC_UU, MX0, MY0, NE)
        a.imm(M3, 0)
        a.sts(sym_lo, MR0)
        a.sts(sym_hi, MR1)
    # W = ((sumHi·256 + sumLo) >> 2) as uint32  (4.28 window of the 5.30 sum)
    a.lds(SI, "SUM1LO")
    a.shift_imm(LSHIFT_LO, SI, 8)
    a.sts("TMP0", SR0)                  # (B0<<8) & 0xFFFF
    a.mov(AX1, SR1)                     # B0 >> 8
    a.lds(SI, "SUM1HI")
    a.shift_imm(LSHIFT_LO, SI, 8)
    a.mov(AY1, SR0)
    a.alu(AR, OR, AX1, AY1)
    a.sts("TMP1", AR)                   # (B0>>8) | (B1<<8)
    a.sts("TMP2", SR1)                  # B1 >> 8
    a.ld(AX0, SYM["TMP0"])
    a.lds(AY0, "SUM0LO")
    a.alu(AR, ADD, AX0, AY0)            # T0 (sets carry)
    a.sts("TMP0", AR)
    a.ld(AX0, SYM["TMP1"])
    a.lds(AY0, "SUM0HI")
    a.alu(AR, ADD_C, AX0, AY0)          # T1 (carry chained)
    a.sts("TMP1", AR)
    a.ld(AX0, SYM["TMP2"])
    a.alu(AR, ADD_C, AX0, None)         # T2 = B1>>8 + carry
    a.sts("TMP2", AR)
    a.lds(SI, "TMP0")
    a.shift_imm(LSHIFT_LO, SI, -2)
    a.lds(SI, "TMP1")
    a.shift_imm(LSHIFT_LO_OR, SI, 14)
    a.lds(SI, "TMP2")
    a.shift_imm(LSHIFT_LO_OR, SI, 30)   # W in SR1:SR0
    # volShift = clamp(-(CalcExp32(W) + 3), 0, 8)
    # (EXP exists only in the SE-form encoding, not the immediate form)
    a.shift_se(EXP_HI, SR1)
    a.shift_se(EXP_LO, SR0)
    a.mov(AY0, SE)
    a.alu(AR, NEG_Y, None, AY0)
    a.c16(AY0, 3)
    a.alu(AR, SUB, AR, AY0)
    a.cmp_imm(AR, 0)
    a.alu(AR, PASS, None, None, LT)     # < 0 → 0
    a.cmp_imm(AR, 8)
    a.alu(AR, PASS, None, AY0, GT)      # > 8 → 8
    a.sts("VSHIFT", AR)
    # fold: mm = ((mm · volMult) << 1 << volShift) >> 16  per channel
    a.c16(AY0, 1)
    a.alu(AR, ADD, AR, AY0)
    a.mov(SE, AR)                       # SE = volShift + 1
    a.lds(MY0, "VOL_MULT")
    a.imm(I1, CH + C_MMULT)
    a.imm(M3, 64)
    with a.loop_ce(n=8):
        a.ld_i(MX0, I1, M0)
        a.mac(MR, MUL_UU, MX0, MY0)     # exact 32-bit product in MR1:MR0
        a.shift_se(LSHIFT_HI, MR1)
        a.shift_se(LSHIFT_LO_OR, MR0)
        a.st_i(I1, M3, SR1)
    a.imm(M3, 0)
    a.ena_int(False)
    a.rts()

    # sqmul: square-and-multiply attenuation curve.  In: AR = x,
    # MX1 = MY0 = y, SR0 = s.  Out: AR = x'.  (1.15 fractional.)
    a.label("sqmul")
    a.mov(AX1, SR0)
    with a.loop_ce(n=8):
        a.mac(MR, MUL_SS, AR, MY0)      # x·y
        a.mov(AY1, MR1)
        a.c16(AY0, 1)
        a.alu(AF, AND, AX1, AY0)
        a.alu(AR, PASS, None, AY1, EQ)  # even bit → x = x·y
        a.mac(MR, MUL_SS, MX1, MY0)     # y·y
        a.mov(MY0, MR1)
        a.mov(MX1, MR1)
        a.mov(SI, AX1)
        a.shift_imm(LSHIFT_LO, SI, -1)
        a.mov(AX1, SR0)
    a.rts()


# ----------------------------------------------------------------------

def _emit_decode(a):
    """94x frame decode for every playing channel (refdec/frames.py::
    decompress_frame_94x; reference: DCSDecoderNative.cpp:1679-2261)."""
    _emit_decode_driver(a)
    _emit_dec_frame94(a)


def _emit_decode_driver(a):
    """Per-channel decode driver: playback gating, header copy on first
    decode, bit-cursor save/restore, frame/loop counters (refdec
    _decode_stream; shared by the 93 firmware, compiler/firmware93.py)."""
    a.label("decode_all")
    a.c16(AR, 0)
    a.sts("DCH", AR)
    a.label("da_loop")
    a.lds(AX0, "DCH")
    a.cmp_imm(AX0, 8)
    a.rts(EQ)
    a.call("decode_one")
    a.lds(AY0, "DCH")
    a.alu(AR, Y_INC, None, AY0)
    a.sts("DCH", AR)
    a.jump("da_loop")

    # ------------------------------------------------------------------
    a.label("decode_one")
    a.lds(SI, "DCH")
    a.shift_imm(LSHIFT_LO, SI, 6)
    a.mov(AR, SR0)
    a.add_imm(AR, ST)
    a.sts("STB", AR)
    a.mov(AR, SR0)
    a.add_imm(AR, CH)
    a.sts("CHB", AR)
    a.lds(AR, "STB")
    a.mov(I1, AR)
    a.ld_i(AR, I1, M0)
    a.cmp_imm(AR, 0)
    a.rts(EQ)                           # not playing
    a.lds(AX0, "CHB")
    a.add_imm(AX0, C_MMULT)
    a.mov(I1, AR)
    a.ld_i(MY1, I1, M0)                 # mix multiplier (invariant MY1)
    # first decode of a playback: copy header, zero band types
    a.lds(AX0, "STB")
    a.add_imm(AX0, S_NEEDI)
    a.mov(I1, AR)
    a.ld_i(AR, I1, M0)
    a.cmp_imm(AR, 0)
    a.jump("d1_bit", EQ)
    a.st_i_imm(I1, M0, 0)
    a.lds(AX0, "STB")
    a.add_imm(AX0, S_HDRHI)
    a.mov(I1, AR)
    a.ld_i(AR, I1, M1)
    a.sts("P_HI", AR)
    a.ld_i(AR, I1, M0)
    a.sts("P_LO", AR)
    a.lds(AX0, "STB")
    a.add_imm(AX0, S_HDR)
    a.mov(I3, AR)
    if a.os93a:
        # 1-byte Type-1 headers: copy hdr[0], zero the rest (refdec
        # _init_stream_playback: header[i] = 0 beyond header_len)
        a.call("rd8")
        a.st_i(I3, M1, AR)
        a.mov(AX1, AR)
        a.and_imm(AX1, 0x80)
        a.cmp_imm(AR, 0)
        a.jump("hc_t1", NE)
        with a.loop_ce(n=15):
            a.call("rd8")
            a.st_i(I3, M1, AR)
        a.jump("hc_done")
        a.label("hc_t1")
        with a.loop_ce(n=15):
            a.st_i_imm(I3, M1, 0)
        a.label("hc_done")
    else:
        with a.loop_ce(n=16):
            a.call("rd8")
            a.st_i(I3, M1, AR)
    a.lds(AX0, "STB")
    a.add_imm(AX0, S_BT)
    a.mov(I3, AR)
    with a.loop_ce(n=16):
        a.st_i_imm(I3, M1, 0)
    a.label("d1_bit")
    # bit-reader state → scalars
    a.lds(AX0, "STB")
    a.add_imm(AX0, S_CURHI)
    a.mov(I1, AR)
    for sym in ("B_CHI", "B_CLO", "B_WHI", "B_WLO", "B_NB"):
        a.ld_i(AR, I1, M1)
        a.sts(sym, AR)
    a.call("dec_frame")
    a.lds(AX0, "STB")
    a.add_imm(AX0, S_CURHI)
    a.mov(I1, AR)
    for sym in ("B_CHI", "B_CLO", "B_WHI", "B_WLO", "B_NB"):
        a.lds(AR, sym)
        a.st_i(I1, M1, AR)
    # decode error → channel stop flag (refdec: ch.stop = True)
    a.lds(AX0, "ERRF")
    a.cmp_imm(AX0, 0)
    a.jump("d1_ctr", EQ)
    a.lds(AX0, "CHB")
    a.add_imm(AX0, C_STOP)
    a.mov(I1, AR)
    a.st_i_imm(I1, M0, 1)
    a.label("d1_ctr")
    # frame counter / loop handling (refdec _decode_stream tail)
    a.lds(AX0, "STB")
    a.add_imm(AX0, S_FCTR)
    a.mov(I1, AR)
    a.ld_i(AY0, I1, M0)
    a.alu(AR, Y_DEC, None, AY0)
    a.st_i(I1, M0, AR)
    a.cmp_imm(AR, 0)
    a.rts(NE)
    a.modify(I1, M1)                    # → S_NFRM
    a.ld_i(AR, I1, M2)                  # total frames; back to S_FCTR
    a.st_i(I1, M0, AR)                  # frame counter restarts
    a.lds(AX0, "STB")
    a.add_imm(AX0, S_SRTHI)
    a.mov(I1, AR)
    a.ld_i(AX1, I1, M1)                 # start hi
    a.ld_i(MX0, I1, M1)                 # start lo; I1 → S_CURHI
    a.st_i(I1, M1, AX1)
    a.st_i(I1, M1, MX0)
    a.st_i_imm(I1, M1, 0)               # window hi
    a.st_i_imm(I1, M1, 0)               # window lo
    a.st_i_imm(I1, M0, 0)               # bit count
    a.lds(AX0, "STB")
    a.add_imm(AX0, S_NEEDI)
    a.mov(I1, AR)
    a.st_i_imm(I1, M0, 1)               # re-init (band types reset)
    a.lds(AX0, "STB")
    a.add_imm(AX0, S_LCTR)
    a.mov(I1, AR)
    a.ld_i(AX0, I1, M0)
    a.cmp_imm(AX0, 0)
    a.rts(EQ)                           # loop forever
    a.mov(AY1, AX0)
    a.alu(AR, Y_DEC, None, AY1)
    a.st_i(I1, M0, AR)
    a.cmp_imm(AR, 0)
    a.rts(NE)
    a.lds(AR, "STB")
    a.mov(I1, AR)
    a.st_i_imm(I1, M0, 0)               # playback ends
    a.lds(AX0, "CHB")
    a.add_imm(AX0, C_SRC)
    a.mov(I1, AR)
    a.st_i_imm(I1, M0, 0xFFFF)
    a.rts()


def _emit_dec_frame94(a):
    a.label("dec_frame")
    a.ena_int()
    a.c16(AR, 0)
    a.sts("ERRF", AR)
    a.ld(AX0, FB + 1)
    a.sts("OUTB1", AX0)
    # stream format/subtype from the header copy
    a.lds(AX0, "STB")
    a.add_imm(AX0, S_HDR)
    a.mov(I1, AR)
    a.ld_i(SI, I1, M1)                  # hdr[0]
    a.shift_imm(LSHIFT_LO, SI, -7)
    a.sts("FMT", SR0)
    a.ld_i(SI, I1, M1)                  # hdr[1]
    a.shift_imm(LSHIFT_LO, SI, -6)
    a.mov(AX0, SR0)
    a.and_imm(AX0, 2)
    a.mov(AX1, AR)
    a.ld_i(SI, I1, M0)                  # hdr[2]
    a.shift_imm(LSHIFT_LO, SI, -7)
    a.mov(AY1, SR0)
    a.alu(AR, OR, AX1, AY1)
    a.sts("TMP3", AR)                   # sub_type
    # pre-adjustments for bands 0..2 from the previous band types
    a.cmp_imm(AR, 0)
    a.jump("dp0", EQ)
    a.c16(AX1, TLAY["T_PRE3"])
    a.jump("dp1")
    a.label("dp0")
    a.c16(AX1, TLAY["T_PRE0"])
    a.label("dp1")
    for i in range(3):
        a.lds(AX0, "STB")
        a.add_imm(AX0, S_BT + i)
        a.mov(I1, AR)
        a.ld_i(AX0, I1, M0)
        a.and_imm(AX0, 0xF)
        a.mov(AY1, AX1)
        a.alu(AR, ADD, AR, AY1)
        a.mov(I1, AR)
        a.ld_i(AR, I1, M0)
        a.sts(("PRE0", "PRE1", "PRE2")[i], AR)
    # frame header: Huffman-coded band-type deltas
    a.c16(AR, 0)
    a.sts("TMP4", AR)                   # band index i
    a.label("hw_loop")
    a.lds(AX0, "TMP4")
    a.cmp_imm(AX0, 16)
    a.jump("hw_done", EQ)
    a.lds(AX0, "STB")
    a.add_imm(AX0, S_HDR)
    a.ld(AY1, SYM["TMP4"])
    a.alu(AR, ADD, AR, AY1)
    a.mov(I1, AR)
    a.ld_i(AX0, I1, M0)
    a.and_imm(AX0, 0x7F)
    a.cmp_imm(AR, 0x7F)
    a.jump("hw_done", EQ)
    a.c16(AX1, TLAY["T_HUFF"])          # node cursor
    a.label("hw_bit")
    a.call("get1")
    a.cmp_imm(AR, 0)
    a.jump("hw_b0", EQ)
    a.mov(I1, AX1)
    a.ld_i(AY1, I1, M0)
    a.alu(AR, ADD, AX1, AY1)            # node += tree[node]
    a.mov(AX1, AR)
    a.jump("hw_t")
    a.label("hw_b0")
    a.c16(AY0, 1)
    a.alu(AR, ADD, AX1, AY0)            # node += 1
    a.mov(AX1, AR)
    a.label("hw_t")
    a.mov(I1, AX1)
    a.ld_i(AR, I1, M0)
    a.cmp_imm(AR, 0x8000)
    a.jump("hw_bit", NOT_AC)            # not terminal
    a.and_imm(AR, 0xFF)
    a.c16(AY0, 0x2E)
    a.alu(AR, SUB, AR, AY0)             # excess-$2E delta
    a.mov(MR1, AR)
    a.lds(AX0, "STB")
    a.add_imm(AX0, S_BT)
    a.ld(AY1, SYM["TMP4"])
    a.alu(AR, ADD, AR, AY1)
    a.mov(I1, AR)
    a.ld_i(AY1, I1, M0)
    a.alu(AR, ADD, MR1, AY1)
    a.st_i(I1, M0, AR)                  # band_type[i] += delta
    a.lds(AY0, "TMP4")
    a.alu(AR, Y_INC, None, AY0)
    a.sts("TMP4", AR)
    a.jump("hw_loop")
    a.label("hw_done")

    # band loop
    a.c16(AR, FB + 1)
    a.sts("OUTIDX", AR)
    a.c16(AR, 0)
    a.sts("BANDNO", AR)
    a.label("bl_loop")
    a.lds(AX0, "BANDNO")
    a.cmp_imm(AX0, 16)
    a.jump("bl_done", EQ)
    a.lds(AX0, "STB")
    a.add_imm(AX0, S_HDR)
    a.ld(AY1, SYM["BANDNO"])
    a.alu(AR, ADD, AR, AY1)
    a.mov(I1, AR)
    a.ld_i(AX0, I1, M0)
    a.and_imm(AX0, 0x7F)
    a.sts("CURHDR", AR)
    a.cmp_imm(AR, 0x7F)
    a.jump("bl_done", EQ)
    a.c16(AR, TLAY["T_BANDCNT"])
    a.ld(AY1, SYM["BANDNO"])
    a.alu(AR, ADD, AR, AY1)
    a.mov(I1, AR)
    a.ld_i(AR, I1, M0)
    a.sts("OUTCNT", AR)
    a.c16(AR, 1)
    a.sts("OUTINC", AR)
    a.lds(AX0, "CURHDR")
    a.c16(AY0, 0x40)
    a.alu(AF, AND, AX0, AY0)
    a.jump("bl_i1", EQ)
    a.c16(AR, 2)
    a.sts("OUTINC", AR)
    a.lds(SI, "OUTCNT")
    a.shift_imm(LSHIFT_LO, SI, -1)
    a.sts("OUTCNT", SR0)
    a.label("bl_i1")
    a.lds(AX0, "STB")
    a.add_imm(AX0, S_BT)
    a.ld(AY1, SYM["BANDNO"])
    a.alu(AR, ADD, AR, AY1)
    a.mov(I1, AR)
    a.ld_i(AR, I1, M0)
    a.sts("BTYPE", AR)
    a.cmp_imm(AR, 0)
    a.jump("bl_band", NE)
    a.lds(AX0, "OUTIDX")                # band off: skip outputs
    a.ld(AY1, SYM["OUTCNT"])
    a.alu(AR, ADD, AX0, AY1)
    a.sts("OUTIDX", AR)
    a.jump("bl_next")
    a.label("bl_band")
    a.lds(AR, "CURHDR")
    a.sts("SCODE", AR)
    a.lds(AX0, "FMT")
    a.cmp_imm(AX0, 0)
    a.jump("bl_scale", EQ)
    # type 1: band-translation tables + scale pre-adjustment
    a.lds(AX0, "BANDNO")
    a.cmp_imm(AX0, 3)
    a.jump("bf_ge3", GE)
    a.c16(AR, SYM["PRE0"])
    a.ld(AY1, SYM["BANDNO"])
    a.alu(AR, ADD, AR, AY1)
    a.mov(I1, AR)
    a.ld_i(AY1, I1, M0)
    a.lds(AX0, "CURHDR")
    a.alu(AR, ADD, AX0, AY1)
    a.sts("CURHDR", AR)
    a.c16(AR, TLAY["T_XL02"])
    a.sts("CBB", AR)
    a.jump("bf_x")
    a.label("bf_ge3")
    a.cmp_imm(AX0, 6)
    a.jump("bf_hi", GE)
    a.c16(AR, TLAY["T_XL35"])
    a.sts("CBB", AR)
    a.jump("bf_x")
    a.label("bf_hi")
    a.c16(AR, TLAY["T_XL6F"])
    a.sts("CBB", AR)
    a.label("bf_x")
    a.lds(AX0, "BTYPE")
    a.and_imm(AX0, 0xF)
    a.mov(SI, AR)
    a.shift_imm(LSHIFT_LO, SI, 1)
    a.mov(AR, SR0)
    a.ld(AY1, SYM["CBB"])
    a.alu(AR, ADD, AR, AY1)
    a.mov(I1, AR)
    a.ld_i(AR, I1, M1)
    a.sts("BTYPE", AR)                  # translated type
    a.ld_i(AY1, I1, M0)                 # scale adjustment
    a.lds(AX0, "CURHDR")
    a.alu(AR, ADD, AX0, AY1)
    a.sts("SCODE", AR)
    a.label("bl_scale")
    # scale = mantissa[code&3] >> (15 - ((code>>2) & 0xF))
    a.lds(SI, "SCODE")
    a.shift_imm(LSHIFT_LO, SI, -2)
    a.mov(AX0, SR0)
    a.and_imm(AX0, 0xF)
    a.c16(AY0, 15)
    a.alu(AR, SUB, AR, AY0)
    a.mov(SE, AR)
    a.lds(AX0, "SCODE")
    a.and_imm(AX0, 3)
    a.add_imm(AR, TLAY["T_MANT"])
    a.mov(I1, AR)
    a.ld_i(SI, I1, M0)
    a.shift_se(LSHIFT_LO, SI)
    a.mov(MY0, SR0)                     # scale (MY0 invariant per band)
    a.lds(AX0, "BTYPE")
    a.cmp_imm(AX0, 6)
    a.jump("bl_fix", GT)
    # --- Huffman codebook band ---------------------------------------
    a.c16(AY0, 1)
    a.alu(AR, SUB, AX0, AY0)
    a.mov(SE, AR)
    a.c16(SI, 1)
    a.shift_se(LSHIFT_LO, SI)
    a.sts("REFV", SR0)                  # 1 << (type-1)
    a.lds(AX0, "BTYPE")
    a.add_imm(AX0, TLAY["T_MAXW"])
    a.mov(I1, AR)
    a.ld_i(AR, I1, M0)
    a.sts("MW", AR)
    a.lds(AX0, "BTYPE")
    a.add_imm(AX0, TLAY["T_CBBASE"])
    a.mov(I1, AR)
    a.ld_i(AR, I1, M0)
    a.sts("CBB", AR)
    a.lds(AR, "OUTIDX")
    a.mov(I0, AR)
    a.lds(AR, "OUTINC")
    a.mov(M3, AR)
    a.lds(AR, "OUTCNT")
    a.sts("ICNT", AR)
    a.label("cb_loop")
    a.lds(AX0, "ICNT")
    a.cmp_imm(AX0, 0)
    a.jump("cb_done", EQ)
    a.lds(AX0, "MW")
    a.call("peek")
    a.ld(AY1, SYM["CBB"])
    a.alu(AR, ADD, AR, AY1)
    a.mov(I1, AR)
    a.ld_i(AX1, I1, M0)                 # table entry (nbits<<8 | value)
    a.mov(SI, AX1)
    a.shift_imm(LSHIFT_LO, SI, -8)
    a.mov(AX0, SR0)
    a.call("consume")
    a.c16(AY0, 0xFF)
    a.alu(AR, AND, AX1, AY0)
    a.c16(AY0, 0x80)
    a.alu(AF, AND, AR, AY0)
    a.jump("cb_z", NE)                  # "two zeros" marker
    a.ld(AY1, SYM["REFV"])
    a.alu(AR, SUB, AR, AY1)             # sample = value - refVal
    a.mac(MR, MUL_SU, AR, MY0)          # scaled = low16(sample·scale)
    a.ld_i(AY1, I0, M0)
    a.mov(MR1, AY1)                     # frame-buffer word into MR1
    a.mac(MR, MAC_SU, MR0, MY1)         # += scaled·mix
    a.st_i(I0, M3, MR1)
    a.ld(AY0, SYM["ICNT"])
    a.alu(AR, Y_DEC, None, AY0)
    a.sts("ICNT", AR)
    a.jump("cb_loop")
    a.label("cb_z")
    a.lds(AX0, "ICNT")
    a.cmp_imm(AX0, 2)
    a.jump("cb_err", LT)
    a.modify(I0, M3)                    # zeros leave the buffer unchanged
    a.modify(I0, M3)
    a.lds(AX0, "ICNT")
    a.c16(AY0, 2)
    a.alu(AR, SUB, AX0, AY0)
    a.sts("ICNT", AR)
    a.jump("cb_loop")
    a.label("cb_err")
    a.c16(AR, 1)
    a.sts("ERRF", AR)
    a.c16(AR, 0)
    a.sts("ICNT", AR)
    a.jump("cb_done")
    a.label("cb_done")
    a.mov(AR, I0)
    a.sts("OUTIDX", AR)
    a.jump("bl_next")
    # --- fixed-width band --------------------------------------------
    a.label("bl_fix")
    a.cmp_imm(AX0, 18)
    a.jump("bfx_ok", LT)
    a.c16(AR, 1)
    a.sts("ERRF", AR)
    a.c16(AR, 17)
    a.sts("MW", AR)
    a.jump("bfx_go")
    a.label("bfx_ok")
    a.sts("MW", AX0)
    a.label("bfx_go")
    a.lds(AR, "OUTIDX")
    a.mov(I0, AR)
    a.lds(AR, "OUTINC")
    a.mov(M3, AR)
    a.lds(AR, "OUTCNT")
    a.mov(CNTR, AR)
    with a.loop_ce():
        a.lds(AX0, "MW")
        a.call("gets")
        a.mac(MR, MUL_SU, AR, MY0)
        a.ld_i(AY1, I0, M0)
        a.mov(MR1, AY1)
        a.mac(MR, MAC_SU, MR0, MY1)
        a.st_i(I0, M3, MR1)
    a.mov(AR, I0)
    a.sts("OUTIDX", AR)
    a.label("bl_next")
    a.lds(AY0, "BANDNO")
    a.alu(AR, Y_INC, None, AY0)
    a.sts("BANDNO", AR)
    a.jump("bl_loop")
    a.label("bl_done")
    # first-sample delta fixup (saturating)
    a.ena_ar_sat()
    a.ld(AX0, FB + 1)
    a.lds(AY0, "OUTB1")
    a.alu(AR, SUB, AX0, AY0)
    a.ld(AY1, FB)
    a.alu(AR, ADD, AR, AY1)
    a.st(FB, AR)
    a.lds(AR, "OUTB1")
    a.st(FB + 1, AR)
    a.ena_ar_sat(False)
    a.ena_int(False)
    a.rts()


# ----------------------------------------------------------------------

def _emit_transform(a):
    """94x inverse transform: twiddle pre-passes, 6-iteration IFFT,
    volume shift, overlap-add, bit-reversed PCM extraction into the
    autobuffer (refdec/transform.py::transform_frame_94x; reference:
    DCSDecoderNative.cpp:397-576)."""
    a.label("transform")
    # fb[$80] and fb[$81] fold (unsaturated negate; ×(-1) via $8000)
    a.c16(MY0, 0x8000)
    a.ld(MX0, FB + 0x80)
    a.mac(MR, MUL_SS, MX0, MY0)
    a.st(FB + 0x80, MR1)
    a.ld(AY0, FB + 0x81)
    a.alu(AR, NEG_Y, None, AY0)
    a.mac(MR, MUL_SS, AR, MY0)
    a.st(FB + 0x81, MR1)
    a.ena_ar_sat()
    # pre-pass 1: center/ends fold, scaled by $8000
    a.imm(I0, FB)                       # p0
    a.imm(I1, FB + 0x100)               # p1
    a.imm(M3, -3)
    with a.loop_ce(n=0x40):
        a.ld_i(AX0, I0, M1)             # x0
        a.ld_i(AX1, I0, M2)             # x1 (I0 back at p0)
        a.ld_i(AY0, I1, M1)             # y0
        a.ld_i(AY1, I1, M2)             # y1 (I1 back at p1)
        a.alu(AR, ADD, AX0, AY0)
        a.mac(MR, MUL_SS, AR, MY0)
        a.st_i(I0, M1, MR1)             # fb[p0]
        a.alu(AR, SUB, AX1, AY1)
        a.mac(MR, MUL_SS, AR, MY0)
        a.st_i(I0, M1, MR1)             # fb[p0+1]; p0 += 2
        a.alu(AR, SUB, AX0, AY0)
        a.mac(MR, MUL_SS, AR, MY0)
        a.st_i(I1, M1, MR1)             # fb[p1]
        a.alu(AR, ADD, AX1, AY1)
        a.mac(MR, MUL_SS, AR, MY0)
        a.st_i(I1, M3, MR1)             # fb[p1+1]; p1 -= 2
    # pre-pass 2: complex twiddle fold with bit-reversed coefficients
    a.imm(I0, FB)                       # p4
    a.imm(I4, FB + 0x100)               # p5 (DAG2: M6=+1, M7=-3)
    a.imm(M7, -3)
    a.imm(I2, TLAY["T_BR"] + 2)         # BITREV walk for i0 (step 4)
    a.imm(I3, TLAY["T_BR"])             # BITREV walk for i1 (step 4)
    a.imm(M3, 4)
    with a.loop_ce(n=0x40):
        a.ld_i(AR, I2, M3)              # BITREV[i0]
        a.add_imm(AR, TLAY["T_SIN"])    # IFFT_COEFF base
        a.mov(I6, AR)
        a.ld_i(MY0, I6, M4)             # c0
        a.ld_i(AR, I3, M3)              # BITREV[i1]
        a.add_imm(AR, TLAY["T_SIN"])
        a.mov(I6, AR)
        a.ld_i(MY1, I6, M4)             # c1
        a.ld_i(AY0, I0, M1)             # x0
        a.ld_i(AY1, I0, M2)             # x1 (back at p4)
        a.ld_i(MX0, I4, M6)             # xn0
        a.ld_i(MX1, I4, M7)             # xn1... (I4 back at p5: +1-3=-2? no)
        a.modify(I4, M6)                # undo: net 0 (read +1, -3, +1 → -1)
        a.modify(I4, M6)                # back to p5
        a.mac(MR, MUL_SS, MX1, MY1)     # xn1·c1
        a.mac(MR, MSUB_RND, MX0, MY0)   # − xn0·c0, rounded → prod0
        a.mov(AX0, MR1)
        a.mac(MR, MUL_SS, MX1, MY0)     # xn1·c0
        a.mac(MR, MAC_RND, MX0, MY1)    # + xn0·c1 → prod1
        a.alu(AR, ADD, MR1, AY0)        # prod1 + x0
        a.st_i(I0, M1, AR)              # fb[p4]
        a.alu(AR, ADD, AX0, AY1)        # prod0 + x1
        a.st_i(I0, M1, AR)              # fb[p4+1]; p4 += 2
        a.alu(AR, RSUB, MR1, AY0)       # x0 − prod1
        a.st_i(I4, M6, AR)              # fb[p5]
        a.alu(AR, SUB, AX0, AY1)        # prod0 − x1
        a.st_i(I4, M7, AR)              # fb[p5+1]; p5 -= 2
    # pre-pass 3: butterfly halves
    a.imm(I0, FB)
    a.imm(I1, FB + 0x80)
    with a.loop_ce(n=0x40):
        a.ld_i(AY0, I0, M1)             # x0
        a.ld_i(AY1, I0, M2)             # x1
        a.ld_i(AX0, I1, M1)             # y0
        a.ld_i(AX1, I1, M2)             # y1
        a.alu(AR, ADD, AX0, AY0)
        a.st_i(I0, M1, AR)
        a.alu(AR, ADD, AX1, AY1)
        a.st_i(I0, M1, AR)              # p0 += 2
        a.alu(AR, RSUB, AX0, AY0)       # x0 − y0
        a.st_i(I1, M1, AR)
        a.alu(AR, RSUB, AX1, AY1)
        a.st_i(I1, M1, AR)              # p1 += 2
    # 6-iteration in-place IFFT
    a.c16(AR, 2)
    a.sts("NPART", AR)
    a.c16(AR, 0x40)
    a.sts("PSIZE", AR)
    a.c16(AR, 6)
    a.sts("LVLC", AR)
    a.label("tf_level")
    a.imm(I0, FB)                       # p0
    a.lds(AR, "PSIZE")
    a.mov(M3, AR)                       # partition skip
    a.add_imm(AR, FB)
    a.mov(I1, AR)                       # p1 = FB + partition size
    a.lds(SI, "PSIZE")
    a.shift_imm(LSHIFT_LO, SI, -1)
    a.sts("HALF", SR0)
    a.imm(I2, TLAY["T_SIN"])
    a.imm(I6, TLAY["T_COS"])
    a.lds(AR, "NPART")
    a.mov(CNTR, AR)
    with a.loop_ce():                   # partitions
        a.ld_i(MY0, I2, M1)             # c_sin
        a.ld_i(MY1, I6, M6)             # c_cos
        a.lds(AR, "HALF")
        a.mov(CNTR, AR)
        with a.loop_ce():               # butterflies
            a.ld_i(MX0, I1, M1)         # a_re
            a.ld_i(MX1, I1, M2)         # a_im (back at p1)
            a.mac(MR, MUL_SS, MX0, MY1)
            a.mac(MR, MSUB_RND, MX1, MY0)   # t_re
            a.mov(AX0, MR1)
            a.mac(MR, MUL_SS, MX1, MY1)
            a.mac(MR, MAC_RND, MX0, MY0)    # t_im
            a.ld_i(AY0, I0, M1)         # u_re
            a.ld_i(AY1, I0, M2)         # u_im (back at p0)
            a.alu(AR, RSUB, AX0, AY0)   # u_re − t_re
            a.st_i(I0, M1, AR)
            a.alu(AR, RSUB, MR1, AY1)   # u_im − t_im
            a.st_i(I0, M1, AR)          # p0 += 2
            a.alu(AR, ADD, AX0, AY0)    # u_re + t_re
            a.st_i(I1, M1, AR)
            a.alu(AR, ADD, MR1, AY1)    # u_im + t_im
            a.st_i(I1, M1, AR)          # p1 += 2
        a.modify(I0, M3)                # skip the partner partition
        a.modify(I1, M3)
    a.lds(SI, "NPART")
    a.shift_imm(LSHIFT_LO, SI, 1)
    a.sts("NPART", SR0)
    a.lds(SI, "PSIZE")
    a.shift_imm(LSHIFT_LO, SI, -1)
    a.sts("PSIZE", SR0)
    a.lds(AY0, "LVLC")
    a.alu(AR, Y_DEC, None, AY0)
    a.sts("LVLC", AR)
    a.cmp_imm(AR, 0)
    a.jump("tf_level", NE)
    a.ena_ar_sat(False)
    # volume normalization: fb[i] >>= volShift (arithmetic)
    a.lds(AY0, "VSHIFT")
    a.alu(AR, NEG_Y, None, AY0)
    a.mov(SE, AR)
    a.imm(I0, FB)
    with a.loop_ce(n=0x100):
        a.ld_i(SI, I0, M0)
        a.shift_se(ASHIFT_HI, SI)
        a.st_i(I0, M1, SR1)
    # overlap-add into the first 16 outputs (rounded MACs, fractional)
    a.imm(I1, TLAY["T_BR"])
    a.imm(M3, 2)
    a.imm(I2, TLAY["T_OVLC"])           # coefficients forward
    a.imm(I3, TLAY["T_OVLC"] + 15)      # coefficients backward
    a.imm(I4, OVLB)                     # overlap buffer (DAG2)
    with a.loop_ce(n=8):
        a.ld_i(AR, I1, M3)              # bi = BITREV[i]
        if FB:
            a.add_imm(AR, FB)
        a.mov(I0, AR)
        for _ in range(2):
            a.ld_i(MX0, I0, M0)         # fb[bi]
            a.ld_i(MY0, I2, M1)         # overlap coeff (fwd)
            a.mac(MR, MUL_SU, MX0, MY0)
            a.ld_i(MX1, I4, M6)         # overlap sample
            a.ld_i(MY0, I3, M2)         # overlap coeff (bwd)
            a.mac(MR, MAC_SU, MX1, MY0)
            a.mac(MR, MAC_RND, MX1, None)   # round (adds 0·0)
            a.st_i(I0, M1, MR1)
    # extract 240 PCM samples in bit-reversed pair order
    a.imm(I1, TLAY["T_BR"])
    a.lds(AR, "WPTR")
    a.mov(I2, AR)
    with a.loop_ce(n=120):
        a.ld_i(AR, I1, M3)
        if FB:
            a.add_imm(AR, FB)
        a.mov(I0, AR)
        a.ld_i(AX0, I0, M1)
        a.st_i(I2, M1, AX0)
        a.ld_i(AX0, I0, M0)
        a.st_i(I2, M1, AX0)
    # save the last 16 into the overlap buffer
    a.imm(I3, OVLB)
    with a.loop_ce(n=8):
        a.ld_i(AR, I1, M3)
        if FB:
            a.add_imm(AR, FB)
        a.mov(I0, AR)
        a.ld_i(AX0, I0, M1)
        a.st_i(I3, M1, AX0)
        a.ld_i(AX0, I0, M0)
        a.st_i(I3, M1, AX0)
    a.imm(M3, 0)
    a.rts()


# ----------------------------------------------------------------------

def _emit_mix_update(a):
    """Per-frame mixing-level update: fades, per-channel multiplier
    attenuation curve, track counters (refdec _update_mixing_levels;
    reference: DCSDecoderNative.cpp:3042-3135)."""
    a.label("mix_update")
    # fades over all 64 mixer entries
    a.imm(I1, MIXA)
    with a.loop_ce(n=64):
        a.mov(AX1, I1)                  # entry base
        a.add_imm(AX1, 3)
        a.mov(I2, AR)
        a.ld_i(AX0, I2, M0)             # fade_steps
        a.cmp_imm(AX0, 1)
        a.jump("fd_one", EQ)
        a.jump("fd_many", GT)
        a.jump("fd_next")
        a.label("fd_one")
        a.st_i_imm(I2, M0, 0)           # steps = 0
        a.modify(I2, M2)
        a.modify(I2, M2)                # base+3 → fade_target (base+1)
        a.ld_i(AX0, I2, M0)
        a.mov(I0, AX1)                  # cur_level (base+0)
        a.st_i(I0, M0, AX0)             # cur = target
        a.jump("fd_next")
        a.label("fd_many")
        a.mov(AY1, AX0)
        a.alu(AR, Y_DEC, None, AY1)
        a.st_i(I2, M0, AR)              # steps -= 1
        a.modify(I2, M2)                # base+3 → fade_delta (base+2)
        a.ld_i(AY1, I2, M0)
        a.mov(I0, AX1)                  # cur_level (base+0)
        a.ld_i(AX0, I0, M0)
        a.alu(AR, ADD, AX0, AY1)        # cur += delta
        a.cmp_imm(AR, 8191)
        a.alu(AR, PASS, None, AY0, GT)
        a.cmp_imm(AR, -8191 & 0xFFFF)
        a.alu(AR, PASS, None, AY0, LT)
        a.st_i(I0, M0, AR)
        a.label("fd_next")
        a.modify(I1, M1)
        a.modify(I1, M1)
        a.modify(I1, M1)
        a.modify(I1, M1)                # next entry
    # per-channel multiplier from the summed mixing level
    a.c16(AR, 0)
    a.sts("XCH", AR)
    a.label("mu_loop")
    a.lds(AX0, "XCH")
    a.cmp_imm(AX0, 8)
    a.jump("mu_done", EQ)
    # mixer_sum = Σ mixer[ch][*].cur_level  (exact, clamped ±8191)
    a.lds(SI, "XCH")
    a.shift_imm(LSHIFT_LO, SI, 5)       # ch*32
    a.mov(AR, SR0)
    a.add_imm(AR, MIXA)
    a.mov(I1, AR)
    a.imm(M3, 4)
    a.ena_int()
    a.imm(MR0, 0)
    a.imm(MR1, 0)
    a.c16(MY0, 1)
    with a.loop_ce(n=8):
        a.ld_i(MX0, I1, M3)
        a.mac(MR, MAC_SS, MX0, MY0)
    a.imm(M3, 0)
    a.ena_int(False)
    a.cmp_imm(MR1, 0)
    a.jump("ms_neg", NE)
    a.mov(AR, MR0)
    a.cmp_imm(AR, 8192)
    a.jump("ms_ok", NOT_AC)
    a.c16(AR, 8191)
    a.jump("ms_ok")
    a.label("ms_neg")
    a.mov(AR, MR0)
    a.cmp_imm(AR, 0xE001)
    a.jump("ms_ok", AC)
    a.c16(AR, -8191 & 0xFFFF)
    a.label("ms_ok")
    # mixer_exp = ((sum >> 6) & 0x3FF) + 0x80
    a.mov(SI, AR)
    a.shift_imm(ASHIFT_LO, SI, -6)
    a.mov(AX0, SR0)
    a.and_imm(AX0, 0x3FF)
    a.add_imm(AR, 0x80)
    a.sts("TMP0", AR)
    # multiplier base, attenuated by 0.9733^(255-exp): channel_volume << 7
    # (1994+), fixed $7FFF in the 1993a software (refdec
    # _update_mixing_levels, OS93A branch)
    if a.os93a:
        a.c16(AR, 0x7FFF)
    else:
        a.lds(SI, "XCH")
        a.shift_imm(LSHIFT_LO, SI, 6)
        a.mov(AR, SR0)
        a.add_imm(AR, CH + C_CVOL)
        a.mov(I1, AR)
        a.ld_i(SI, I1, M0)
        a.shift_imm(LSHIFT_LO, SI, 7)
        a.mov(AR, SR0)                  # x = channel_volume << 7
    a.c16(MX1, 0x7C94)
    a.c16(MY0, 0x7C94)
    a.ld(AX0, SYM["TMP0"])
    a.mov(SR0, AX0)                     # s = mixer_exp
    a.call("sqmul")
    a.mov(SI, AR)
    a.shift_imm(LSHIFT_LO, SI, 1)
    a.mov(MX0, SR0)                     # mixing multiplier = x << 1
    a.lds(SI, "XCH")
    a.shift_imm(LSHIFT_LO, SI, 6)
    a.mov(AR, SR0)
    a.add_imm(AR, CH + C_MMULT)
    a.mov(I1, AR)
    a.st_i(I1, M0, MX0)
    # track counter tick
    a.lds(SI, "XCH")
    a.shift_imm(LSHIFT_LO, SI, 6)
    a.mov(AR, SR0)
    a.add_imm(AR, CH + C_TCTR)
    a.mov(I1, AR)
    a.ld_i(AY0, I1, M0)
    a.alu(AR, Y_INC, None, AY0)
    a.st_i(I1, M0, AR)
    if a.os93a:
        # host-event timer tick (refdec HostEventTimer.update: when armed,
        # decrement; at zero, reload and re-send the data byte)
        a.lds(SI, "XCH")
        a.shift_imm(LSHIFT_LO, SI, 6)
        a.mov(AR, SR0)
        a.add_imm(AR, CH + C_HETI)
        a.mov(I1, AR)
        a.ld_i(AX1, I1, M1)             # interval; I1 → C_HETC
        a.cmp_imm(AX1, 0)
        a.jump("mu_het_done", EQ)
        a.ld_i(AY0, I1, M0)             # counter (I1 stays)
        a.alu(AR, Y_DEC, None, AY0)
        a.st_i(I1, M0, AR)              # counter -= 1
        a.cmp_imm(AR, 0)
        a.jump("mu_het_done", NE)
        a.st_i(I1, M2, AX1)             # counter = interval; I1 → C_HETI
        a.modify(I1, M2)                # I1 → C_HETD
        a.ld_i(AR, I1, M0)
        a.port_out(AR)                  # re-send the data byte
        a.label("mu_het_done")
    a.lds(AY0, "XCH")
    a.alu(AR, Y_INC, None, AY0)
    a.sts("XCH", AR)
    a.jump("mu_loop")
    a.label("mu_done")
    a.rts()
