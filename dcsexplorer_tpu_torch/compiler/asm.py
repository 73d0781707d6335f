"""ADSP-2105 assembler (function-call style).

Builds 24-bit instruction words for the ADSP-2100-family core implemented in
``emu/adsp2105.py`` / ``native/src/adsp2105.cpp``.  Used by the synthesized
ROM firmware (compiler/firmware*.py) — generated ROM sets carry a real,
runnable decoder program, mirroring the role of the original DCS firmware
that the reference's emulator backend runs (reference: DCSDecoder/adsp2100/,
DCSDecoderEmu.cpp:101-351 for the patch-point contract the program must
honor).

Encodings follow the interpreter's ``step()`` dispatch, which is fuzz-
validated per-instruction against the reference interpreter; the instruction
set notation mirrors the ADSP-2100 Family User's Manual mnemonics.

Usage sketch::

    a = Asm()
    a.imm(AX0, 5)
    a.alu(AR, ADD, AX0, AY0)
    with a.loop_ce(n=16):       # CNTR=16; DO ... UNTIL CE
        a.st_i(I0, M0, AR)      # DM(I0,M0) = AR
    a.jump("top")
    words = a.assemble()

The port's copy of ``dcsexplorer_tpu/compiler/asm.py``.
"""


class Reg:
    """A register name: group/index for moves, plus operand codes."""

    __slots__ = ("grp", "idx", "name")

    def __init__(self, grp, idx, name):
        self.grp = grp
        self.idx = idx
        self.name = name

    def __repr__(self):
        return self.name


def _mkregs():
    g0 = "AX0 AX1 MX0 MX1 AY0 AY1 MY0 MY1 SI SE AR MR0 MR1 MR2 SR0 SR1"
    regs = {}
    for i, n in enumerate(g0.split()):
        regs[n] = Reg(0, i, n)
    for k in range(8):
        grp = 1 if k < 4 else 2
        regs[f"I{k}"] = Reg(grp, k % 4, f"I{k}")
        regs[f"M{k}"] = Reg(grp, 4 + k % 4, f"M{k}")
        regs[f"L{k}"] = Reg(grp, 8 + k % 4, f"L{k}")
    for i, n in enumerate("ASTAT MSTAT SSTAT IMASK ICNTL CNTR SB PX".split()):
        regs[n] = Reg(3, i, n)
    regs["IFC"] = Reg(3, 12, "IFC")
    regs["TOPPC"] = Reg(3, 15, "TOPPC")
    return regs


_REGS = _mkregs()
globals().update(_REGS)

# condition codes (``condition()`` in the core)
EQ, NE, GT, LE, LT, GE, AV, NOT_AV, AC, NOT_AC, NEG, POS, MV, NOT_MV, \
    NOT_CE, TRUE = range(16)
CE = 14  # as DO-UNTIL terminator: loop *until* counter expires

# ALU operation selectors (sel field; X = x-op, Y = y-op, C = carry)
PASS, Y_INC, ADD_C, ADD, NOT_Y, NEG_Y, SUB_C, SUB, Y_DEC, RSUB, RSUB_C, \
    NOT_X, AND, OR, XOR, ABS = range(16)

# MAC operation selectors
MNOP = 0
MUL_RND, MAC_RND, MSUB_RND = 1, 2, 3
MUL_SS, MUL_SU, MUL_US, MUL_UU = 4, 5, 6, 7
MAC_SS, MAC_SU, MAC_US, MAC_UU = 8, 9, 10, 11
MSUB_SS, MSUB_SU, MSUB_US, MSUB_UU = 12, 13, 14, 15

# shifter operation selectors
LSHIFT_HI, LSHIFT_HI_OR, LSHIFT_LO, LSHIFT_LO_OR = 0, 1, 2, 3
ASHIFT_HI, ASHIFT_HI_OR, ASHIFT_LO, ASHIFT_LO_OR = 4, 5, 6, 7
NORM_HI, NORM_HI_OR, NORM_LO, NORM_LO_OR = 8, 9, 10, 11
EXP_HI, EXP_HIX, EXP_LO, EXPADJ = 12, 13, 14, 15

_ALU_X = {"AX0": 0, "AX1": 1, "AR": 2, "MR0": 3, "MR1": 4, "MR2": 5,
          "SR0": 6, "SR1": 7}
_ALU_Y = {"AY0": 0, "AY1": 1, "AF": 2, None: 3, 0: 3}
_MAC_X = {"MX0": 0, "MX1": 1, "AR": 2, "MR0": 3, "MR1": 4, "MR2": 5,
          "SR0": 6, "SR1": 7}
_MAC_Y = {"MY0": 0, "MY1": 1, "MF": 2, None: 3, 0: 3}
_SHIFT_X = {"SI": 0, "AR": 2, "MR0": 3, "MR1": 4, "MR2": 5,
            "SR0": 6, "SR1": 7}

# sentinels usable as ALU/MAC operands and destinations
AF = "AF"
MF = "MF"
MR = "MR"
ZERO = None

NOP = 0x000000
TRAP = 0x010000


def _xval(r):
    return r.name if isinstance(r, Reg) else r


class Asm:
    def __init__(self, org=0):
        self.org = org
        self.words = []
        self.labels = {}
        self.fixups = []          # (index, kind, label)
        self.loops = []

    # ------------------------------------------------------------------
    @property
    def pc(self):
        return self.org + len(self.words)

    def emit(self, word):
        self.words.append(word & 0xFFFFFF)
        return self.pc - 1

    def nop(self):
        return self.emit(NOP)

    def label(self, name):
        if name in self.labels:
            raise ValueError(f"duplicate label {name}")
        self.labels[name] = self.pc

    def _addr(self, target, index, kind="addr"):
        if isinstance(target, int):
            return target
        self.fixups.append((index, kind, target))
        return 0

    def assemble(self):
        for index, kind, label in self.fixups:
            addr = self.labels[label]
            self.words[index] |= (addr & 0x3FFF) << 4
        self.fixups.clear()
        return list(self.words)

    # ------------------------------------------------------------------
    # moves and immediates

    def imm(self, reg, val):
        """Load an immediate into any register.

        grp0 registers get the 16-bit form; everything else the 14-bit
        signed form (sufficient for I/M/L/CNTR/IMASK/etc. values).
        """
        if reg.grp == 0:
            return self.emit(0x400000 | ((val & 0xFFFF) << 4) | reg.idx)
        if not (-0x2000 <= val <= 0x3FFF):
            raise ValueError(f"imm14 out of range for {reg}: {val}")
        return self.emit(((0x30 | (reg.grp << 2)) << 16)
                         | ((val & 0x3FFF) << 4) | reg.idx)

    def mov(self, dst, src):
        """Register-to-register move (any groups)."""
        return self.emit(0x0D0000 | (dst.grp << 10) | (src.grp << 8)
                         | (dst.idx << 4) | src.idx)

    def ld(self, reg, addr):
        """reg = DM(addr)  (direct address, any register group)."""
        return self.emit(0x800000 | (reg.grp << 18) | ((addr & 0x3FFF) << 4)
                         | reg.idx)

    def st(self, addr, reg):
        """DM(addr) = reg  (direct address, any register group)."""
        return self.emit(0x900000 | (reg.grp << 18) | ((addr & 0x3FFF) << 4)
                         | reg.idx)

    def _dag(self, i, m):
        dag2 = i.grp == 2
        if (m.grp == 2) != dag2:
            raise ValueError(f"I/M same-DAG required: {i} {m}")
        return dag2, ((i.idx & 3) << 2) | ((m.idx - 4) & 3)

    def ld_i(self, reg, i, m):
        """reg = DM(Ii, Mm) with post-modify (grp0 registers only)."""
        dag2, bits = self._dag(i, m)
        return self.emit((0x700000 if dag2 else 0x600000)
                         | (reg.idx << 4) | bits)

    def st_i(self, i, m, reg):
        """DM(Ii, Mm) = reg with post-modify (grp0 registers only)."""
        dag2, bits = self._dag(i, m)
        return self.emit((0x780000 if dag2 else 0x680000)
                         | (reg.idx << 4) | bits)

    def st_i_imm(self, i, m, val):
        """DM(Ii, Mm) = 16-bit immediate."""
        dag2, bits = self._dag(i, m)
        return self.emit((0xB00000 if dag2 else 0xA00000)
                         | ((val & 0xFFFF) << 4) | bits)

    def ld_pm(self, reg, i, m):
        """reg = PM(Ii, Mm) (DAG2 only); low byte goes to PX."""
        dag2, bits = self._dag(i, m)
        if not dag2:
            raise ValueError("PM access requires DAG2 (I4-I7)")
        return self.emit(0x500000 | (reg.idx << 4) | bits)

    def st_pm(self, i, m, reg):
        """PM(Ii, Mm) = reg:PX (DAG2 only)."""
        dag2, bits = self._dag(i, m)
        if not dag2:
            raise ValueError("PM access requires DAG2 (I4-I7)")
        return self.emit(0x580000 | (reg.idx << 4) | bits)

    def modify(self, i, m):
        """MODIFY(Ii, Mm): post-modify with no memory access."""
        dag2, bits = self._dag(i, m)
        return self.emit(0x090000 | (0x10 if dag2 else 0) | bits)

    # ------------------------------------------------------------------
    # control flow

    def jump(self, target, cond=TRUE):
        return self.emit(0x180000 | (self._addr(target, len(self.words)) << 4)
                         | cond)

    def call(self, target, cond=TRUE):
        return self.emit(0x1C0000 | (self._addr(target, len(self.words)) << 4)
                         | cond)

    def jump_i(self, i, cond=TRUE, call=False):
        """Indirect jump/call through I4..I7."""
        if i.grp != 2:
            raise ValueError("indirect jump requires I4-I7")
        return self.emit(0x0B0000 | (0x10 if call else 0)
                         | ((i.idx & 3) << 6) | cond)

    def rts(self, cond=TRUE):
        return self.emit(0x0A0000 | cond)

    def rti(self, cond=TRUE):
        return self.emit(0x0A0010 | cond)

    def do_until(self, last_addr_or_label, term=CE):
        """DO <addr> UNTIL <term>; target is the LAST instruction of the
        loop body.  Prefer the ``loop_ce()`` context manager."""
        return self.emit(0x140000
                         | (self._addr(last_addr_or_label, len(self.words)) << 4)
                         | term)

    class _Loop:
        def __init__(self, asm, term):
            self.asm = asm
            self.term = term

        def __enter__(self):
            self.at = len(self.asm.words)
            self.asm.emit(0x140000 | self.term)
            return self

        def __exit__(self, *exc):
            if exc[0] is None:
                last = self.asm.org + len(self.asm.words) - 1
                if last <= self.at + self.asm.org:
                    raise ValueError("empty DO UNTIL body")
                self.asm.words[self.at] |= (last & 0x3FFF) << 4

    def loop_ce(self, n=None, reg=None):
        """DO ... UNTIL CE over a with-block.  n sets CNTR first (immediate);
        reg sets CNTR from a register."""
        if n is not None:
            self.imm(CNTR, n)
        elif reg is not None:
            self.mov(CNTR, reg)
        return Asm._Loop(self, CE)

    # ------------------------------------------------------------------
    # ALU / MAC / shifter

    def alu(self, dst, sel, x=None, y=None, cond=TRUE):
        """dst (AR or AF) = <sel>(x, y).  x: AX0/AX1/AR/MR0-2/SR0-1 or None;
        y: AY0/AY1/AF/ZERO."""
        to_af = dst == AF
        if not to_af and not (isinstance(dst, Reg) and dst.name == "AR"):
            raise ValueError("ALU result must go to AR or AF")
        xsel = _ALU_X[_xval(x)] if x is not None else 0
        ysel = _ALU_Y[_xval(y) if isinstance(y, Reg) else y]
        base = 0x260000 if to_af else 0x220000
        return self.emit(base | (sel << 13) | (ysel << 11) | (xsel << 8)
                         | cond)

    def mac(self, dst, sel, x=None, y=None, cond=TRUE):
        """dst (MR or MF) = <sel>(x, y).  x: MX0/MX1/AR/MR0-2/SR0-1;
        y: MY0/MY1/MF/ZERO."""
        to_mf = dst == MF
        if not to_mf and dst != MR:
            raise ValueError("MAC result must go to MR or MF")
        xsel = _MAC_X[_xval(x)] if x is not None else 0
        ysel = _MAC_Y[_xval(y) if isinstance(y, Reg) else y]
        base = 0x240000 if to_mf else 0x200000
        return self.emit(base | (sel << 13) | (ysel << 11) | (xsel << 8)
                         | cond)

    def shift_imm(self, sel, x, sc):
        """SR = <sel>(x) BY sc  (immediate shift code, -128..127)."""
        xsel = _SHIFT_X[_xval(x)]
        return self.emit(0x0F0000 | (sel << 11) | (xsel << 8) | (sc & 0xFF))

    def shift_se(self, sel, x, cond=TRUE):
        """SR = <sel>(x) by SE (or EXP/NORM forms), conditional."""
        xsel = _SHIFT_X[_xval(x)]
        return self.emit(0x0E0000 | (sel << 11) | (xsel << 8) | cond)

    def divs(self, y, x):
        """DIVS: sign step for Y(hi):AY0(lo) / X division."""
        return self.emit(0x060000 | (_ALU_Y[_xval(y)] << 11)
                         | (_ALU_X[_xval(x)] << 8))

    def divq(self, x):
        """DIVQ: one quotient bit into AY0."""
        return self.emit(0x070000 | (_ALU_X[_xval(x)] << 8))

    # ------------------------------------------------------------------
    # mode control / stacks / misc

    def _mode(self, flag_bit, val_bit, on):
        return self.emit(0x0C0000 | flag_bit | (val_bit if on else 0))

    def ena_sec_reg(self, on=True):
        return self._mode(0x20, 0x10, on)

    def ena_bit_rev(self, on=True):
        return self._mode(0x80, 0x40, on)

    def ena_av_latch(self, on=True):
        return self._mode(0x200, 0x100, on)

    def ena_ar_sat(self, on=True):
        return self._mode(0x800, 0x400, on)

    def ena_int(self, on=True):
        """Integer multiplier mode (no product <<1)."""
        return self._mode(0x2000, 0x1000, on)

    def pop_cntr(self):
        return self.emit(0x040004)

    def pop_pc(self):
        return self.emit(0x040010)

    def push_sts(self):
        return self.emit(0x040002)

    def pop_sts(self):
        return self.emit(0x040003)

    def sat_mr(self):
        return self.emit(0x050000)

    def trap(self):
        return self.emit(TRAP)
