"""ADSP-2105 interpreter: the emulator decoder backend's CPU core.

From-scratch Python implementation of the ADSP-2100-family core (ALU, MAC,
shifter, dual DAGs with circular/bit-reversed addressing, loop/PC/status
stacks, interrupts) — the framework's counterpart of the reference's
emulator backend CPU (reference: DCSDecoder/adsp2100/).  Semantics are
validated per-instruction against the reference interpreter compiled into
the test oracle (tests/test_adsp.py): randomized register/memory states and
opcodes must produce identical post-states.

The DCS decoder's "golden reference" role (running original ROM firmware)
additionally needs the board model in emu/board.py; this module is the CPU.

The port's copy of ``dcsexplorer_tpu/emu/adsp2105.py``.
"""

M16 = 0xFFFF
M32 = 0xFFFFFFFF

# ASTAT flags
SS, MV, Q, S, C, V, N, Z = 0x80, 0x40, 0x20, 0x10, 0x08, 0x04, 0x02, 0x01

# MSTAT flags
M_BANK, M_REVERSE, M_STICKYV, M_SATURATE, M_INTEGER, M_TIMER, M_GOMODE = (
    0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40)

# SSTAT flags
PC_EMPTY, PC_OVER, COUNT_EMPTY, COUNT_OVER = 0x01, 0x02, 0x04, 0x08
STATUS_EMPTY, STATUS_OVER, LOOP_EMPTY, LOOP_OVER = 0x10, 0x20, 0x40, 0x80


def _s16(v):
    v &= M16
    return v - 0x10000 if v & 0x8000 else v


def _s8(v):
    v &= 0xFF
    return v - 0x100 if v & 0x80 else v


def _mask_for_l(l):
    """Circular-buffer base mask for an L register value."""
    if l > 0x2000:
        return 0x0000
    m = 0x3FFF
    size = 1
    while size < l:
        size <<= 1
        m = (m << 1) & 0x3FFF
    return m & 0x3FFF


def _bitrev14(i):
    r = 0
    for b in range(14):
        if i & (1 << b):
            r |= 1 << (13 - b)
    return r


_REVERSE = [_bitrev14(i) for i in range(0x4000)]
_MASKS = [_mask_for_l(i) for i in range(0x4000)]


class Core:
    __slots__ = ("ax0", "ax1", "ay0", "ay1", "ar", "af",
                 "mx0", "mx1", "my0", "my1", "mr", "mf",
                 "si", "se", "sb", "sr")

    def __init__(self):
        for f in self.__slots__:
            setattr(self, f, 0)


class ADSP2105:
    def __init__(self, read_dm=None, write_dm=None, read_pm=None,
                 write_pm=None):
        self.core = Core()
        self.alt = Core()
        self.i = [0] * 8
        self.m = [0] * 8        # signed
        self.l = [0] * 8
        self.lmask = [0x3FFF] * 8
        self.base = [0] * 8
        self.px = 0
        self.pc = 0
        self.ppc = 0
        self.loop = 0xFFFF
        self.loop_condition = 0
        self.cntr = 0
        self.astat = 0
        self.sstat = 0x55
        self.mstat = 0
        self.astat_clear = ~(C | V | N | Z) & 0xFF
        self.idle = 0
        self.loop_stack = [0] * 4
        self.cntr_stack = [0] * 4
        self.pc_stack = [0] * 16
        self.stat_stack = [[0, 0, 0] for _ in range(4)]
        self.pc_sp = 0
        self.cntr_sp = 0
        self.stat_sp = 0
        self.loop_sp = 0
        self.flagout = 0
        self.flagin = 0
        self.fl0 = self.fl1 = self.fl2 = 0
        self.imask = 0
        self.icntl = 0
        self.ifc = 0
        self.irq_latch = [0] * 5
        self.irq_state = [0] * 5
        self.speedup = None     # (entry_pc, exit_pc, handler) — emu/speedup.py
        self.stopped = False    # TRAP/IDLE encountered (host turn)

        self.pm = [0] * 0x4000  # 24-bit program words
        self.dm = [0] * 0x4000  # 16-bit data words
        self._read_dm = read_dm or (lambda a: self.dm[a & 0x3FFF])
        self._write_dm = write_dm or self._wdm_default
        self._read_pm_port = read_pm    # PM($3000) data-port hook
        self._write_pm_port = write_pm

    def _wdm_default(self, a, v):
        self.dm[a & 0x3FFF] = v & M16

    # ------------------------------------------------------------------
    # memory

    def rword_data(self, addr):
        return self._read_dm(addr) & M16

    def wword_data(self, addr, val):
        self._write_dm(addr, val & M16)

    def rword_pgm(self, addr):
        if addr == 0x3000 and self._read_pm_port is not None:
            return (self._read_pm_port(addr) << 8) & 0xFFFFFF
        return self.pm[addr & 0x3FFF]

    def wword_pgm(self, addr, val):
        if addr == 0x3000 and self._write_pm_port is not None:
            self._write_pm_port(addr, (val >> 8) & M16)
        self.pm[addr & 0x3FFF] = val & 0xFFFFFF

    # ------------------------------------------------------------------
    # status helpers

    def set_mstat(self, new):
        if (new ^ self.mstat) & M_BANK:
            self.core, self.alt = self.alt, self.core
        if new & M_STICKYV:
            self.astat_clear = ~(C | N | Z) & 0xFF
        else:
            self.astat_clear = ~(C | V | N | Z) & 0xFF
        self.mstat = new

    def condition(self, c):
        a = self.astat
        az = bool(a & Z)
        an = bool(a & N)
        av = bool(a & V)
        ac = bool(a & C)
        mv = bool(a & MV)
        as_ = bool(a & S)
        if c == 0:
            return az
        if c == 1:
            return not az
        if c == 2:
            return not ((an ^ av) or az)
        if c == 3:
            return (an ^ av) or az
        if c == 4:
            return an ^ av
        if c == 5:
            return not (an ^ av)
        if c == 6:
            return av
        if c == 7:
            return not av
        if c == 8:
            return ac
        if c == 9:
            return not ac
        if c == 10:
            return as_
        if c == 11:
            return not as_
        if c == 12:
            return mv
        if c == 13:
            return not mv
        if c == 14:
            # counter-expired: (int32_t)--cntr > 0 keeps looping
            self.cntr = (self.cntr - 1) & M32
            v = self.cntr - (1 << 32) if self.cntr & 0x80000000 else self.cntr
            if v > 0:
                return True
            self.cntr_stack_pop()
            return False
        return True

    # ------------------------------------------------------------------
    # stacks

    def pc_stack_top(self):
        return self.pc_stack[self.pc_sp - 1 if self.pc_sp > 0 else 0]

    def pc_stack_push(self, val=None):
        if self.pc_sp < 16:
            self.pc_stack[self.pc_sp] = self.pc if val is None else val
            self.pc_sp += 1
            self.sstat &= ~PC_EMPTY
        else:
            self.sstat |= PC_OVER

    def pc_stack_pop(self):
        if self.pc_sp > 0:
            self.pc_sp -= 1
            if self.pc_sp == 0:
                self.sstat |= PC_EMPTY
        self.pc = self.pc_stack[self.pc_sp]

    def pc_stack_pop_val(self):
        if self.pc_sp > 0:
            self.pc_sp -= 1
            if self.pc_sp == 0:
                self.sstat |= PC_EMPTY
        return self.pc_stack[self.pc_sp]

    def cntr_stack_push(self):
        if self.cntr_sp < 4:
            self.cntr_stack[self.cntr_sp] = self.cntr
            self.cntr_sp += 1
            self.sstat &= ~COUNT_EMPTY
        else:
            self.sstat |= COUNT_OVER

    def cntr_stack_pop(self):
        if self.cntr_sp > 0:
            self.cntr_sp -= 1
            if self.cntr_sp == 0:
                self.sstat |= COUNT_EMPTY
        self.cntr = self.cntr_stack[self.cntr_sp]

    def loop_stack_push(self, value):
        if self.loop_sp < 4:
            self.loop_stack[self.loop_sp] = value
            self.loop_sp += 1
            self.loop = value >> 4
            self.loop_condition = value & 15
            self.sstat &= ~LOOP_EMPTY
        else:
            self.sstat |= LOOP_OVER

    def loop_stack_pop(self):
        if self.loop_sp > 0:
            self.loop_sp -= 1
            if self.loop_sp == 0:
                self.loop = 0xFFFF
                self.loop_condition = 0
                self.sstat |= LOOP_EMPTY
            else:
                self.loop = self.loop_stack[self.loop_sp - 1] >> 4
                self.loop_condition = self.loop_stack[self.loop_sp - 1] & 15

    def stat_stack_push(self):
        if self.stat_sp < 4:
            self.stat_stack[self.stat_sp][0] = self.mstat
            self.stat_stack[self.stat_sp][1] = self.imask
            self.stat_stack[self.stat_sp][2] = self.astat
            self.stat_sp += 1
            self.sstat &= ~STATUS_EMPTY
        else:
            self.sstat |= STATUS_OVER

    def stat_stack_pop(self):
        if self.stat_sp > 0:
            self.stat_sp -= 1
            if self.stat_sp == 0:
                self.sstat |= STATUS_EMPTY
        self.set_mstat(self.stat_stack[self.stat_sp][0])
        self.imask = self.stat_stack[self.stat_sp][1]
        self.astat = self.stat_stack[self.stat_sp][2]
        self.check_irqs()

    # ------------------------------------------------------------------
    # interrupts (ADSP-2101-family path; reference: adsp2100.cpp:293-377)
    # irq indices: 0=IRQ0 1=IRQ1 2=IRQ2 3=SPORT0_RX 4=SPORT0_TX

    def _generate_irq(self, which, indx):
        if not (self.imask & (0x20 >> indx)):
            return False
        self.irq_latch[which] = 0
        self.pc_stack_push()
        self.stat_stack_push()
        self.pc = 0x04 + indx * 4
        self.idle = 0
        if self.icntl & 0x10:
            self.imask &= ~(0x3F >> indx) & 0xFF
        else:
            self.imask &= ~0x3F & 0xFF
        return True

    def check_irqs(self):
        check = self.irq_latch[2] if (self.icntl & 4) else self.irq_state[2]
        if check and self._generate_irq(2, 0):
            return
        if self.irq_latch[4] and self._generate_irq(4, 1):
            return
        if self.irq_latch[3] and self._generate_irq(3, 2):
            return
        check = self.irq_latch[1] if (self.icntl & 2) else self.irq_state[1]
        if check and self._generate_irq(1, 3):
            return
        check = self.irq_latch[0] if (self.icntl & 1) else self.irq_state[0]
        if check and self._generate_irq(0, 4):
            return

    def invoke_irq(self, which=2, indx=0, max_steps=4_000_000):
        """Host-driven IRQ: vector in, run until the RTI returns to the host
        (reference: adsp2100_host_invoke_irq, adsp2100.cpp:371-377)."""
        self.pc = 0xFFFF
        self._generate_irq(which, indx)
        self.check_irqs()
        return self.run(max_steps)

    # ------------------------------------------------------------------
    # register file access (grp, reg)

    def read_reg(self, grp, reg):
        c = self.core
        if grp == 0:
            return _s16((c.ax0, c.ax1, c.mx0, c.mx1, c.ay0, c.ay1, c.my0,
                         c.my1, c.si, c.se, c.ar,
                         c.mr & M16, (c.mr >> 16) & M16, (c.mr >> 32) & M16,
                         c.sr & M16, (c.sr >> 16) & M16)[reg])
        if grp in (1, 2):
            b = 0 if grp == 1 else 4
            if reg < 4:
                return self.i[b + reg]
            if reg < 8:
                return self.m[b + reg - 4]
            if reg < 12:
                return self.l[b + reg - 8]
            return 0
        # grp 3
        if reg == 0:
            return self.astat
        if reg == 1:
            return self.mstat
        if reg == 2:
            return self.sstat
        if reg == 3:
            return self.imask
        if reg == 4:
            return self.icntl
        if reg == 5:
            return self.cntr
        if reg == 6:
            return _s16(((self.core.sb & 0x1F) ^ 0x10) - 0x10)
        if reg == 7:
            return self.px
        if reg in (8, 10):
            return 0            # RX0/RX1 (no serial callback)
        if reg == 15:
            return self.pc_stack_pop_val()
        return 0

    def write_reg(self, grp, reg, val):
        c = self.core
        if grp == 0:
            v = val & M16
            if reg == 0:
                c.ax0 = v
            elif reg == 1:
                c.ax1 = v
            elif reg == 2:
                c.mx0 = v
            elif reg == 3:
                c.mx1 = v
            elif reg == 4:
                c.ay0 = v
            elif reg == 5:
                c.ay1 = v
            elif reg == 6:
                c.my0 = v
            elif reg == 7:
                c.my1 = v
            elif reg == 8:
                c.si = v
            elif reg == 9:
                c.se = _s8(val) & M16
            elif reg == 10:
                c.ar = v
            elif reg == 11:
                c.mr = (c.mr & ~M16) | v
            elif reg == 12:
                # writing MR1 sign-extends into MR2 (mrzero bits preserved)
                sign = 0xFFFF if v & 0x8000 else 0
                c.mr = (c.mr & ~((1 << 48) - 1)) | (c.mr & M16) \
                    | (v << 16) | (sign << 32)
            elif reg == 13:
                c.mr = (c.mr & ~(M16 << 32)) | ((_s8(val) & M16) << 32)
            elif reg == 14:
                c.sr = (c.sr & ~M16) | v
            elif reg == 15:
                c.sr = (c.sr & M16) | (v << 16)
            return
        if grp in (1, 2):
            b = 0 if grp == 1 else 4
            if reg < 4:
                k = b + reg
                self.i[k] = val & 0x3FFF
                self.base[k] = self.i[k] & self.lmask[k]
            elif reg < 8:
                k = b + reg - 4
                self.m[k] = ((val & 0x3FFF) ^ 0x2000) - 0x2000
            elif reg < 12:
                k = b + reg - 8
                self.l[k] = val & 0x3FFF
                self.lmask[k] = _MASKS[self.l[k]]
                self.base[k] = self.i[k] & self.lmask[k]
            return
        # grp 3
        if reg == 0:
            self.astat = val & 0xFF
        elif reg == 1:
            self.set_mstat(val & 0x7F)
        elif reg == 2:
            pass                # SSTAT is read-only (reference: wr_inval)
        elif reg == 3:
            self.imask = val & 0x3F
            self.check_irqs()
        elif reg == 4:
            self.icntl = val & 0x1F
            self.check_irqs()
        elif reg == 5:
            self.cntr_stack_push()
            self.cntr = val & 0x3FFF
        elif reg == 6:
            self.core.sb = (((val & 0x1F) ^ 0x10) - 0x10) & M16
        elif reg == 7:
            self.px = val & 0xFF
        elif reg == 12:
            self.ifc = val & M16
            for bit, latch, lv in ((0x002, 0, 0), (0x004, 1, 0), (0x008, 3, 0),
                                   (0x010, 4, 0), (0x020, 2, 0), (0x080, 0, 1),
                                   (0x100, 1, 1), (0x200, 3, 1), (0x400, 4, 1),
                                   (0x800, 2, 1)):
                if val & bit:
                    self.irq_latch[latch] = lv
            self.check_irqs()
        elif reg == 13:
            self.cntr = val & 0x3FFF
        elif reg == 15:
            self.pc_stack_push(val & 0x3FFF)
        # regs 9/11 (TX) ignored without serial callbacks

    # ------------------------------------------------------------------
    # DAG addressing

    def _post_modify(self, ireg, mreg):
        base = self.base[ireg]
        i = (self.i[ireg] + self.m[mreg]) & 0x3FFF
        l = self.l[ireg]
        if i < base:
            i += l
        elif i >= base + l:
            i -= l
        self.i[ireg] = i & 0x3FFF

    def data_rw_dag1(self, op, write_val=None):
        ireg = (op >> 2) & 3
        mreg = op & 3
        i = self.i[ireg]
        addr = _REVERSE[i & 0x3FFF] if (self.mstat & M_REVERSE) else i
        res = None
        if write_val is None:
            res = self.rword_data(addr)
        else:
            self.wword_data(addr, write_val)
        self._post_modify(ireg, mreg)
        return res

    def data_rw_dag2(self, op, write_val=None):
        ireg = 4 + ((op >> 2) & 3)
        mreg = 4 + (op & 3)
        res = None
        if write_val is None:
            res = self.rword_data(self.i[ireg])
        else:
            self.wword_data(self.i[ireg], write_val)
        self._post_modify(ireg, mreg)
        return res

    def pgm_rw_dag2(self, op, write_val=None):
        ireg = 4 + ((op >> 2) & 3)
        mreg = 4 + (op & 3)
        res = None
        if write_val is None:
            word = self.rword_pgm(self.i[ireg])
            self.px = word & 0xFF
            res = (word >> 8) & M16
        else:
            self.wword_pgm(self.i[ireg],
                           ((write_val & M16) << 8) | self.px)
        self._post_modify(ireg, mreg)
        return res

    # ------------------------------------------------------------------
    # ALU / MAC / shifter

    def _alu_x(self, sel, signed):
        c = self.core
        v = (c.ax0, c.ax1, c.ar, c.mr & M16, (c.mr >> 16) & M16,
             (c.mr >> 32) & M16, c.sr & M16, (c.sr >> 16) & M16)[sel]
        return _s16(v) if signed else v & M16

    def _alu_y(self, sel, signed):
        c = self.core
        v = (c.ay0, c.ay1, c.af, 0)[sel]
        return _s16(v) if signed else v & M16

    def _mac_x(self, sel, signed):
        c = self.core
        v = (c.mx0, c.mx1, c.ar, c.mr & M16, (c.mr >> 16) & M16,
             (c.mr >> 32) & M16, c.sr & M16, (c.sr >> 16) & M16)[sel]
        return _s16(v) if signed else v & M16

    def _mac_y(self, sel, signed):
        c = self.core
        v = (c.my0, c.my1, c.mf, 0)[sel]
        return _s16(v) if signed else v & M16

    def _shift_x(self, sel, signed):
        c = self.core
        v = (c.si, c.si, c.ar, c.mr & M16, (c.mr >> 16) & M16,
             (c.mr >> 32) & M16, c.sr & M16, (c.sr >> 16) & M16)[sel]
        return _s16(v) if signed else v & M16

    def _clr_flags(self):
        self.astat &= self.astat_clear

    def _calc_nz(self, r):
        self._clr_flags()
        if (r & M16) == 0:
            self.astat |= Z
        self.astat |= (r >> 14) & 0x02

    def _calc_v(self, s, d, r):
        self.astat |= ((s ^ d ^ r ^ (r >> 1)) >> 13) & 0x04

    def _alu_op(self, op, to_af):
        xsel = (op >> 8) & 7
        ysel = (op >> 11) & 3
        sel = (op >> 13) & 15

        if sel == 0x0:
            res = self._alu_y(ysel, False)
            self._calc_nz(res)
        elif sel == 0x1:
            yop = self._alu_y(ysel, False)
            res = yop + 1
            self._calc_nz(res)
            if yop == 0x7FFF:
                self.astat |= V
            elif yop == 0xFFFF:
                self.astat |= C
        elif sel == 0x2:
            xop = self._alu_x(xsel, False)
            yop = self._alu_y(ysel, False) + ((self.astat & C) >> 3)
            res = xop + yop
            self._calc_nz(res)
            self._calc_v(xop, yop, res)
            self.astat |= (res >> 13) & 0x08
        elif sel == 0x3:
            xop = self._alu_x(xsel, False)
            yop = self._alu_y(ysel, False)
            res = xop + yop
            self._calc_nz(res)
            self._calc_v(xop, yop, res)
            self.astat |= (res >> 13) & 0x08
        elif sel == 0x4:
            res = self._alu_y(ysel, False) ^ 0xFFFF
            self._calc_nz(res)
        elif sel == 0x5:
            yop = self._alu_y(ysel, False)
            res = -yop
            self._calc_nz(res)
            if yop == 0x8000:
                self.astat |= V
            if yop == 0x0000:
                self.astat |= C
        elif sel == 0x6:
            xop = self._alu_x(xsel, False)
            yop = self._alu_y(ysel, False)
            res = xop - yop + ((self.astat & C) >> 3) - 1
            self._calc_nz(res)
            self._calc_v(xop, yop, res)
            self.astat |= ((~res) >> 13) & 0x08
        elif sel == 0x7:
            xop = self._alu_x(xsel, False)
            yop = self._alu_y(ysel, False)
            res = xop - yop
            self._calc_nz(res)
            self._calc_v(xop, yop, res)
            self.astat |= ((~res) >> 13) & 0x08
        elif sel == 0x8:
            yop = self._alu_y(ysel, False)
            res = yop - 1
            self._calc_nz(res)
            if yop == 0x8000:
                self.astat |= V
            elif yop == 0x0000:
                self.astat |= C
        elif sel == 0x9:
            xop = self._alu_x(xsel, False)
            yop = self._alu_y(ysel, False)
            res = yop - xop
            self._calc_nz(res)
            self._calc_v(yop, xop, res)
            self.astat |= ((~res) >> 13) & 0x08
        elif sel == 0xA:
            xop = self._alu_x(xsel, False)
            yop = self._alu_y(ysel, False)
            res = yop - xop + ((self.astat & C) >> 3) - 1
            self._calc_nz(res)
            self._calc_v(yop, xop, res)
            self.astat |= ((~res) >> 13) & 0x08
        elif sel == 0xB:
            res = self._alu_x(xsel, False) ^ 0xFFFF
            self._calc_nz(res)
        elif sel == 0xC:
            res = self._alu_x(xsel, False) & self._alu_y(ysel, False)
            self._calc_nz(res)
        elif sel == 0xD:
            res = self._alu_x(xsel, False) | self._alu_y(ysel, False)
            self._calc_nz(res)
        elif sel == 0xE:
            res = self._alu_x(xsel, False) ^ self._alu_y(ysel, False)
            self._calc_nz(res)
        else:
            xop = self._alu_x(xsel, False)
            res = -xop if xop & 0x8000 else xop
            self._clr_flags()
            self.astat &= ~S
            if xop == 0:
                self.astat |= Z
            if xop == 0x8000:
                self.astat |= N | V
            if xop & 0x8000:
                self.astat |= S

        if to_af:
            self.core.af = res & M16
        else:
            if (self.mstat & M_SATURATE) and (self.astat & V):
                res = -32768 if (self.astat & C) else 32767
            self.core.ar = res & M16

    def _mac_op(self, op, to_mf):
        shift = ((self.mstat & M_INTEGER) >> 4) ^ 1
        xsel = (op >> 8) & 7
        ysel = (op >> 11) & 3
        sel = (op >> 13) & 15

        if sel == 0:
            return

        xs = sel in (1, 2, 3, 4, 5, 8, 9, 12, 13)
        ys = sel in (1, 2, 3, 4, 6, 8, 10, 12, 14)
        xop = self._mac_x(xsel, xs)
        yop = self._mac_y(ysel, ys)

        # the reference computes the product in int32 (wraps), then widens
        mr = self.core.mr - (1 << 64) if self.core.mr & (1 << 63) \
            else self.core.mr
        t32 = ((xop * yop) << shift) & M32
        t32 = t32 - (1 << 32) if t32 & 0x80000000 else t32

        if sel in (1, 2, 3):
            if sel == 1:
                res = t32
            elif sel == 2:
                res = mr + t32
            else:
                res = mr - t32
            # convergent rounding quirk: exact-half products leave bit 16
            res += 0x8000
            if (t32 & M16) == 0x8000:
                res &= ~0x10000
        elif sel in (4, 5, 6, 7):
            res = t32
        elif sel in (8, 9, 10, 11):
            res = mr + t32
        else:
            res = mr - t32

        res &= (1 << 64) - 1
        if to_mf:
            self.core.mf = (res >> 16) & M16
        else:
            t = (res >> 31) & 0x1FF
            self.astat &= ~MV
            if t != 0x000 and t != 0x1FF:
                self.astat |= MV
            self.core.mr = res

    def _shift(self, op, sc, imm=False):
        xsel = (op >> 8) & 7
        sel = (op >> 11) & 15
        c = self.core
        if imm and sel >= 0xC:
            return              # shift_op_imm implements only 0x0-0xB

        def lshift32(v, n):
            v &= M32
            if n > 0:
                return (v << n) & M32 if n < 32 else 0
            return v >> -n if n > -32 else 0

        def ashift32(v32s, n):
            if n > 0:
                return (v32s << n) & M32 if n < 32 else 0
            if n > -32:
                return (v32s >> -n) & M32
            return (v32s >> 31) & M32

        if sel == 0x0:
            c.sr = lshift32(self._shift_x(xsel, False) << 16, sc)
        elif sel == 0x1:
            c.sr |= lshift32(self._shift_x(xsel, False) << 16, sc)
        elif sel == 0x2:
            c.sr = lshift32(self._shift_x(xsel, False), sc)
        elif sel == 0x3:
            c.sr |= lshift32(self._shift_x(xsel, False), sc)
        elif sel == 0x4:
            c.sr = ashift32(self._shift_x(xsel, True) << 16, sc)
        elif sel == 0x5:
            c.sr |= ashift32(self._shift_x(xsel, True) << 16, sc)
        elif sel == 0x6:
            c.sr = ashift32(self._shift_x(xsel, True), sc)
        elif sel == 0x7:
            c.sr |= ashift32(self._shift_x(xsel, True), sc)
        elif sel in (0x8, 0x9):
            xop = (self._shift_x(xsel, True) << 16) & M32
            xop_s = xop - (1 << 32) if xop & 0x80000000 else xop
            if sc > 0:
                # carry-in lands on bit 31 of a SIGNED int32 in the
                # reference, so the shift is arithmetic; it also has no
                # sc<32 clamp, and its compiled x86 shift wraps mod 32
                x = ((xop & M32) >> 1) | ((self.astat & C) << 28)
                xs = x - (1 << 32) if x & 0x80000000 else x
                res = (xs >> ((sc - 1) & 31)) & M32
            else:
                res = (xop_s << -sc) & M32 if sc > -32 else 0
            if sel == 0x8:
                c.sr = res & M32
            else:
                c.sr |= res & M32
        elif sel in (0xA, 0xB):
            xop = self._shift_x(xsel, False)
            if sc > 0:
                res = xop >> sc if sc < 32 else 0
            else:
                res = (xop << -sc) & M32 if sc > -32 else 0
            if sel == 0xA:
                c.sr = res & M32
            else:
                c.sr |= res & M32
        elif sel == 0xC:
            self._exp(xsel)
        elif sel == 0xD:
            if self.astat & V:
                xop = self._shift_x(xsel, True)
                c.se = 1
                if xop < 0:
                    self.astat &= ~SS
                else:
                    self.astat |= SS
            else:
                self._exp(xsel)
        elif sel == 0xE:
            if _s16(c.se) == -15:
                xop = self._shift_x(xsel, True) & M16
                res = 15
                if self.astat & SS:
                    while xop & 0x8000:
                        res += 1
                        xop = (xop << 1) & M16
                else:
                    xop = ((xop << 1) | 1) & 0x1FFFF
                    while (xop & 0x10000) == 0:
                        res += 1
                        xop = (xop << 1) & 0x1FFFF
                c.se = (-res) & M16
        else:
            xop = (self._shift_x(xsel, True) << 16) & M32
            res = 0
            if xop & 0x80000000:
                while xop & 0x40000000:
                    res += 1
                    xop = (xop << 1) & M32
            else:
                xop |= 0x8000
                while (xop & 0x40000000) == 0:
                    res += 1
                    xop = (xop << 1) & M32
            if res < -_s16(c.sb):
                c.sb = (-res) & M16

    def _exp(self, xsel):
        c = self.core
        xop = (self._shift_x(xsel, True) << 16) & M32
        res = 0
        if xop & 0x80000000:
            self.astat |= SS
            while xop & 0x40000000:
                res += 1
                xop = (xop << 1) & M32
        else:
            self.astat &= ~SS
            xop |= 0x8000
            while (xop & 0x40000000) == 0:
                res += 1
                xop = (xop << 1) & M32
        c.se = (-res) & M16

    # ------------------------------------------------------------------
    # execution

    def step(self):
        """Execute one instruction.  Returns False on TRAP/IDLE."""
        self.ppc = self.pc
        op = self.rword_pgm(self.pc)

        if self.pc != self.loop:
            self.pc = (self.pc + 1) & M16
        elif self.condition(self.loop_condition):
            self.pc = self.pc_stack_top()
        else:
            self.loop_stack_pop()
            self.pc_stack_pop_val()
            self.pc = (self.pc + 1) & M16

        hi = (op >> 16) & 0xFF
        if hi == 0x00:
            pass
        elif hi == 0x01:
            self.stopped = True
            return False
        elif hi == 0x02:
            if op & 0x008000:
                self.idle = 1
                return False
            if self.condition(op & 15):
                if op & 0x020:
                    self.flagout = 0
                if op & 0x010:
                    self.flagout ^= 1
                if op & 0x080:
                    self.fl0 = 0
                if op & 0x040:
                    self.fl0 ^= 1
                if op & 0x200:
                    self.fl1 = 0
                if op & 0x100:
                    self.fl1 ^= 1
                if op & 0x800:
                    self.fl2 = 0
                if op & 0x400:
                    self.fl2 ^= 1
        elif hi == 0x03:
            go = self.flagin if op & 2 else not self.flagin
            if go:
                if op & 1:
                    self.pc_stack_push()
                self.pc = ((op >> 4) & 0x0FFF) | ((op << 10) & 0x3000)
        elif hi == 0x04:
            if op & 0x10:
                self.pc_stack_pop_val()
            if op & 0x08:
                self.loop_stack_pop()
            if op & 0x04:
                self.cntr_stack_pop()
            if op & 0x02:
                if op & 0x01:
                    self.stat_stack_pop()
                else:
                    self.stat_stack_push()
        elif hi == 0x05:
            if self.astat & MV:
                if self.core.mr & (1 << 39):
                    self.core.mr = (self.core.mr & ~((1 << 48) - 1)) | \
                        (0xFFFF << 32) | (0x8000 << 16) | 0x0000
                else:
                    self.core.mr = (self.core.mr & ~((1 << 48) - 1)) | \
                        (0x0000 << 32) | (0x7FFF << 16) | 0xFFFF
        elif hi == 0x06:
            xop = self._alu_x((op >> 8) & 7, False)
            yop = self._alu_y((op >> 11) & 3, False)
            temp = xop ^ yop
            self.astat = (self.astat & ~Q) | ((temp >> 10) & Q)
            self.core.af = ((yop << 1) | (self.core.ay0 >> 15)) & M16
            self.core.ay0 = ((self.core.ay0 << 1) | (temp >> 15)) & M16
        elif hi == 0x07:
            xop = self._alu_x((op >> 8) & 7, False)
            if self.astat & Q:
                res = (self.core.af + xop) & M32
            else:
                res = (self.core.af - xop) & M32
            temp = res ^ xop
            self.astat = (self.astat & ~Q) | ((temp >> 10) & Q)
            self.core.af = ((res << 1) | (self.core.ay0 >> 15)) & M16
            self.core.ay0 = ((self.core.ay0 << 1)
                             | ((~temp >> 15) & 1)) & M16
        elif hi == 0x08:
            pass
        elif hi == 0x09:
            base = (op >> 2) & 4
            self._post_modify(base + ((op >> 2) & 3), base + (op & 3))
        elif hi == 0x0A:
            if self.condition(op & 15):
                self.pc_stack_pop()
                if op & 0x10:
                    self.stat_stack_pop()
                if self.pc == 0xFFFF:
                    self.stopped = True
                    return False
        elif hi == 0x0B:
            if self.condition(op & 15):
                if op & 0x10:
                    self.pc_stack_push()
                self.pc = self.i[4 + ((op >> 6) & 3)] & 0x3FFF
        elif hi == 0x0C:
            temp = self.mstat
            if op & 0x000008:
                temp = (temp & ~M_GOMODE) | ((op << 5) & M_GOMODE)
            if op & 0x002000:
                temp = (temp & ~M_INTEGER) | ((op >> 8) & M_INTEGER)
            if op & 0x008000:
                temp = (temp & ~M_TIMER) | ((op >> 9) & M_TIMER)
            if op & 0x000020:
                temp = (temp & ~M_BANK) | ((op >> 4) & M_BANK)
            if op & 0x000080:
                temp = (temp & ~M_REVERSE) | ((op >> 5) & M_REVERSE)
            if op & 0x000200:
                temp = (temp & ~M_STICKYV) | ((op >> 6) & M_STICKYV)
            if op & 0x000800:
                temp = (temp & ~M_SATURATE) | ((op >> 7) & M_SATURATE)
            self.set_mstat(temp)
        elif hi == 0x0D:
            self.write_reg((op >> 10) & 3, (op >> 4) & 15,
                           self.read_reg((op >> 8) & 3, op & 15))
        elif hi == 0x0E:
            if self.condition(op & 15):
                self._shift(op, _s8(self.core.se))
        elif hi == 0x0F:
            self._shift(op, _s8(op), imm=True)
        elif hi == 0x10:
            self._shift(op, _s8(self.core.se))
            self.write_reg(0, (op >> 4) & 15, self.read_reg(0, op & 15))
        elif hi == 0x11:
            if op & 0x8000:
                self.pgm_rw_dag2(op, self.read_reg(0, (op >> 4) & 15))
                self._shift(op, _s8(self.core.se))
            else:
                self._shift(op, _s8(self.core.se))
                self.write_reg(0, (op >> 4) & 15, self.pgm_rw_dag2(op))
        elif hi in (0x12, 0x13):
            dag = self.data_rw_dag1 if hi == 0x12 else self.data_rw_dag2
            if op & 0x8000:
                dag(op, self.read_reg(0, (op >> 4) & 15))
                self._shift(op, _s8(self.core.se))
            else:
                self._shift(op, _s8(self.core.se))
                self.write_reg(0, (op >> 4) & 15, dag(op))
        elif 0x14 <= hi <= 0x17:
            self.loop_stack_push(op & 0x3FFFF)
            self.pc_stack_push()
        elif 0x18 <= hi <= 0x1B:
            if self.condition(op & 15):
                self.pc = (op >> 4) & 0x3FFF
                if self.pc == self.ppc:
                    self.stopped = True
                    return False
        elif 0x1C <= hi <= 0x1F:
            if self.condition(op & 15):
                self.pc_stack_push()
                self.pc = (op >> 4) & 0x3FFF
        elif 0x20 <= hi <= 0x27:
            which = (hi >> 1) & 3      # 0=MAC/MR 1=ALU/AR 2=MAC/MF 3=ALU/AF
            if self.condition(op & 15):
                if which == 0:
                    self._mac_op(op, False)
                elif which == 1:
                    self._alu_op(op, False)
                elif which == 2:
                    self._mac_op(op, True)
                else:
                    self._alu_op(op, True)
        elif 0x28 <= hi <= 0x2F:
            which = (hi >> 1) & 3
            temp = self.read_reg(0, op & 15)
            if which == 0:
                self._mac_op(op, False)
            elif which == 1:
                self._alu_op(op, False)
            elif which == 2:
                self._mac_op(op, True)
            else:
                self._alu_op(op, True)
            self.write_reg(0, (op >> 4) & 15, temp)
        elif 0x30 <= hi <= 0x3F:
            grp = (hi >> 2) & 3
            val = (op << 14) & M32
            val = ((val - (1 << 32)) if val & 0x80000000 else val) >> 18
            self.write_reg(grp, op & 15, val)
        elif 0x40 <= hi <= 0x4F:
            self.write_reg(0, op & 15, (op >> 4) & 0xFFFF)
        elif 0x50 <= hi <= 0x5F:
            which = (hi >> 1) & 3
            wr = bool(hi & 0x08)
            if wr:
                self.pgm_rw_dag2(op, self.read_reg(0, (op >> 4) & 15))
            if which == 0:
                self._mac_op(op, False)
            elif which == 1:
                self._alu_op(op, False)
            elif which == 2:
                self._mac_op(op, True)
            else:
                self._alu_op(op, True)
            if not wr:
                self.write_reg(0, (op >> 4) & 15, self.pgm_rw_dag2(op))
        elif 0x60 <= hi <= 0x7F:
            which = (hi >> 1) & 3
            wr = bool(hi & 0x08)
            dag = self.data_rw_dag1 if hi < 0x70 else self.data_rw_dag2
            if wr:
                dag(op, self.read_reg(0, (op >> 4) & 15))
                if which == 0:
                    self._mac_op(op, False)
                elif which == 1:
                    self._alu_op(op, False)
                elif which == 2:
                    self._mac_op(op, True)
                else:
                    self._alu_op(op, True)
            else:
                if which == 0:
                    self._mac_op(op, False)
                elif which == 1:
                    self._alu_op(op, False)
                elif which == 2:
                    self._mac_op(op, True)
                else:
                    self._alu_op(op, True)
                self.write_reg(0, (op >> 4) & 15, dag(op))
        elif 0x80 <= hi <= 0x8F:
            grp = (hi >> 2) & 3
            self.write_reg(grp, op & 15, self.rword_data((op >> 4) & 0x3FFF))
        elif 0x90 <= hi <= 0x9F:
            grp = (hi >> 2) & 3
            self.wword_data((op >> 4) & 0x3FFF, self.read_reg(grp, op & 15))
        elif 0xA0 <= hi <= 0xAF:
            self.data_rw_dag1(op, (op >> 4) & 0xFFFF)
        elif 0xB0 <= hi <= 0xBF:
            self.data_rw_dag2(op, (op >> 4) & 0xFFFF)
        else:
            is_alu = bool(hi & 0x02)
            if is_alu:
                self._alu_op(op, False)
            else:
                self._mac_op(op, False)
            xreg = (op >> 18) & 3
            yreg = (op >> 20) & 3
            dval = self.data_rw_dag1(op)
            pval = self.pgm_rw_dag2(op >> 4)
            c = self.core
            if xreg == 0:
                c.ax0 = dval
            elif xreg == 1:
                c.ax1 = dval
            elif xreg == 2:
                c.mx0 = dval
            else:
                c.mx1 = dval
            if yreg == 0:
                c.ay0 = pval
            elif yreg == 1:
                c.ay1 = pval
            elif yreg == 2:
                c.my0 = pval
            else:
                c.my1 = pval
        return True

    def run(self, max_steps):
        """Run until TRAP/IDLE or the step budget is exhausted.

        When the fast-mode hook is armed (emu/speedup.py), reaching the
        transform-region entry executes the region natively and resumes at
        its exit, mirroring the native core's accelerator."""
        self.stopped = False
        n = 0
        su = self.speedup
        if su is None:
            while n < max_steps and self.step():
                n += 1
            return n
        entry, exit_pc, handler = su
        while n < max_steps:
            if self.pc == entry:
                handler(self)
                self.pc = exit_pc
            if not self.step():
                break
            n += 1
        return n

    def reset(self):
        """Chip reset (reference: adsp2105_reset / adsp2100_reset)."""
        for k in range(8):
            self.lmask[k] = _MASKS[self.l[k]]
            self.base[k] = self.i[k] & self.lmask[k]
        self.pc = 0
        self.ppc = 0xFFFFFFFF
        self.loop = 0xFFFF
        self.loop_condition = 0
        self.astat_clear = ~(C | V | N | Z) & 0xFF
        self.mstat = 0
        self.sstat = 0x55
        self.idle = 0
        self.pc_sp = self.cntr_sp = self.stat_sp = self.loop_sp = 0
        self.flagout = self.flagin = 0
        self.fl0 = self.fl1 = self.fl2 = 0
        self.imask = 0
        self.irq_state = [0] * 5
        self.irq_latch = [0] * 5

    # ------------------------------------------------------------------
    # state marshalling (layout mirrored by tests/oracle/shim.cpp)

    STATE_LEN = 125

    def _core_vec(self, c):
        return [c.ax0, c.ax1, c.ay0, c.ay1, c.ar, c.af, c.mx0, c.mx1,
                c.my0, c.my1, c.mr, c.mf, c.si, c.se, c.sb, c.sr]

    def _core_load(self, c, v):
        (c.ax0, c.ax1, c.ay0, c.ay1, c.ar, c.af, c.mx0, c.mx1,
         c.my0, c.my1, c.mr, c.mf, c.si, c.se, c.sb, c.sr) = [int(x) for x in v]

    def state_vec(self):
        v = self._core_vec(self.core) + self._core_vec(self.alt)
        v += list(self.i)
        v += [m & M32 for m in self.m]
        v += list(self.l)
        v += [self.px, self.pc & M32, self.ppc & M32, self.loop,
              self.loop_condition, self.cntr & M32, self.astat, self.sstat,
              self.mstat, self.astat_clear & 0xFF, self.idle]
        v += list(self.loop_stack) + list(self.cntr_stack) + \
            list(self.pc_stack)
        for row in self.stat_stack:
            v += list(row)
        v += [self.pc_sp, self.cntr_sp, self.stat_sp, self.loop_sp,
              self.flagout, self.flagin, self.fl0, self.fl1, self.fl2,
              self.imask, self.icntl, self.ifc]
        v += list(self.irq_latch) + list(self.irq_state)
        return v

    def load_state_vec(self, v):
        v = [int(x) for x in v]
        self._core_load(self.core, v[0:16])
        self._core_load(self.alt, v[16:32])
        self.i = v[32:40]
        self.m = [x - (1 << 32) if x & 0x80000000 else x for x in v[40:48]]
        self.l = v[48:56]
        for k in range(8):
            self.lmask[k] = _MASKS[self.l[k]]
            self.base[k] = self.i[k] & self.lmask[k]
        (self.px, self.pc, self.ppc, self.loop, self.loop_condition,
         self.cntr, self.astat, self.sstat, self.mstat, ac,
         self.idle) = v[56:67]
        self.astat_clear = ac & 0xFF
        self.loop_stack = v[67:71]
        self.cntr_stack = v[71:75]
        self.pc_stack = v[75:91]
        self.stat_stack = [v[91 + 3 * k:94 + 3 * k] for k in range(4)]
        (self.pc_sp, self.cntr_sp, self.stat_sp, self.loop_sp,
         self.flagout, self.flagin, self.fl0, self.fl1, self.fl2,
         self.imask, self.icntl, self.ifc) = v[103:115]
        self.irq_latch = v[115:120]
        self.irq_state = v[120:125]
