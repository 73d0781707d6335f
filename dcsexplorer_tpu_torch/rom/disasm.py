"""ADSP-21xx disassembler.

The port's copy of ``dcsexplorer_tpu/rom/disasm.py``.

From-scratch table-driven decoder for the ADSP-2100-family 24-bit
instruction set (Analog Devices' public ISA; the reference ships a
disassembler for the same ISA at adsp2100/2100dasm.cpp — used here only to
cross-check encodings).  Emits ADI-style assembly text plus a small
structural record (kind, branch target) that the ROM tooling uses for
vector annotation and flow tracing.
"""

from dataclasses import dataclass

_ALU_X = ("AX0", "AX1", "AR", "MR0", "MR1", "MR2", "SR0", "SR1")
_ALU_Y = ("AY0", "AY1", "AF", "0")
_MAC_X = ("MX0", "MX1", "AR", "MR0", "MR1", "MR2", "SR0", "SR1")
_MAC_Y = ("MY0", "MY1", "MF", "0")
_SHIFT_X = ("SI", "??", "AR", "MR0", "MR1", "MR2", "SR0", "SR1")

_REG = (
    ("AX0", "AX1", "MX0", "MX1", "AY0", "AY1", "MY0", "MY1",
     "SI", "SE", "AR", "MR0", "MR1", "MR2", "SR0", "SR1"),
    ("I0", "I1", "I2", "I3", "M0", "M1", "M2", "M3",
     "L0", "L1", "L2", "L3", "??", "??", "PMOVLAY", "DMOVLAY"),
    ("I4", "I5", "I6", "I7", "M4", "M5", "M6", "M7",
     "L4", "L5", "L6", "L7", "??", "??", "??", "??"),
    ("ASTAT", "MSTAT", "SSTAT", "IMASK", "ICNTL", "CNTR", "SB", "PX",
     "RX0", "TX0", "RX1", "TX1", "IFC", "OWRCNTR", "??", "??"),
)
_DUAL_X = ("AX0", "AX1", "MX0", "MX1")
_DUAL_Y = ("AY0", "AY1", "MY0", "MY1")

_COND = ("IF EQ ", "IF NE ", "IF GT ", "IF LE ", "IF LT ", "IF GE ",
         "IF AV ", "IF NOT AV ", "IF AC ", "IF NOT AC ", "IF NEG ",
         "IF POS ", "IF MV ", "IF NOT MV ", "IF NOT CE ", "")
_DO_COND = ("NE", "EQ", "LE", "GT", "GE", "LT", "NOT AV", "AV", "NOT AC",
            "AC", "POS", "NEG", "NOT MV", "MV", "CE", "FOREVER")

# ALU/MAC operation templates indexed by opcode bits 13-17; the second
# column applies when the Y operand selector is 3 (the zero operand).
# A leading '!' marks templates whose operand order is (dst, Y, X).
_ALUMAC = (
    ("", ""),
    ("{d} = {x} * {y} (RND)", "{d} = {x} * {y} (RND)"),
    ("{d} = MR + {x} * {y} (RND)", "{d} = MR + {x} * {y} (RND)"),
    ("{d} = MR - {x} * {y} (RND)", "{d} = MR - {x} * {y} (RND)"),
    ("{d} = {x} * {y} (SS)", "{d} = 0"),
    ("{d} = {x} * {y} (SU)", "{d} = {x} * {y} (SU)"),
    ("{d} = {x} * {y} (US)", "{d} = {x} * {y} (US)"),
    ("{d} = {x} * {y} (UU)", "{d} = {x} * {y} (UU)"),
    ("{d} = MR + {x} * {y} (SS)", "{d} = MR + {x} * {y} (SS)"),
    ("{d} = MR + {x} * {y} (SU)", "{d} = MR + {x} * {y} (SU)"),
    ("{d} = MR + {x} * {y} (US)", "{d} = MR + {x} * {y} (US)"),
    ("{d} = MR + {x} * {y} (UU)", "{d} = MR + {x} * {y} (UU)"),
    ("{d} = MR - {x} * {y} (SS)", "{d} = MR - {x} * {y} (SS)"),
    ("{d} = MR - {x} * {y} (SS)", "{d} = MR - {x} * {y} (SS)"),
    ("{d} = MR - {x} * {y} (US)", "{d} = MR - {x} * {y} (US)"),
    ("{d} = MR - {x} * {y} (UU)", "{d} = MR - {x} * {y} (UU)"),
    ("!{d} = {y} (ALU)", "{d} = 0 (ALU)"),
    ("!{d} = {y} + 1", "{d} = 1 (ALU)"),
    ("{d} = {x} + {y} + C", "{d} = {x} + {y} + C"),
    ("{d} = {x} + {y}", "{d} = {x} (ALU)"),
    ("!{d} = NOT {y}", "!{d} = NOT {y}"),
    ("!{d} = -{y}", "!{d} = -{y}"),
    ("{d} = {x} - {y} + C - 1", "{d} = {x} + C - 1"),
    ("{d} = {x} - {y}", "{d} = {x} - {y}"),
    ("!{d} = {y} - 1", "{d} = -1 (ALU)"),
    ("!{d} = {y} - {x}", "{d} = -{x}"),
    ("!{d} = {y} - {x} + C - 1", "{d} = -{x} + C - 1"),
    ("{d} = NOT {x}", "{d} = NOT {x}"),
    ("{d} = {x} AND {y}", "{d} = {x} AND {y}"),
    ("{d} = {x} OR {y}", "{d} = {x} OR {y}"),
    ("{d} = {x} XOR {y}", "{d} = {x} XOR {y}"),
    ("{d} = ABS {x}", "{d} = ABS {x}"),
)

_SHIFT = ("SR = LSHIFT {x} (HI)", "SR = SR OR LSHIFT {x} (HI)",
          "SR = LSHIFT {x} (LO)", "SR = SR OR LSHIFT {x} (LO)",
          "SR = ASHIFT {x} (HI)", "SR = SR OR ASHIFT {x} (HI)",
          "SR = ASHIFT {x} (LO)", "SR = SR OR ASHIFT {x} (LO)",
          "SR = NORM {x} (HI)", "SR = SR OR NORM {x} (HI)",
          "SR = NORM {x} (LO)", "SR = SR OR NORM {x} (LO)",
          "SE = EXP {x} (HI)", "SE = EXP {x} (HIX)",
          "SE = EXP {x} (LO)", "SB = EXPADJ {x}")

_SHIFT_BY = ("SR = LSHIFT {x} BY {n} (HI)", "SR = SR OR LSHIFT {x} BY {n} (HI)",
             "SR = LSHIFT {x} BY {n} (LO)", "SR = SR OR LSHIFT {x} BY {n} (LO)",
             "SR = ASHIFT {x} BY {n} (HI)", "SR = SR OR ASHIFT {x} BY {n} (HI)",
             "SR = ASHIFT {x} BY {n} (LO)", "SR = SR OR ASHIFT {x} BY {n} (LO)",
             "???", "???", "???", "???", "???", "???", "???", "???")

_FLAG_CHANGE = ("", "TOGGLE {r} ", "RESET {r} ", "SET {r} ")
_MODE_CHANGE = ("", "", "DIS {r} ", "ENA {r} ")


@dataclass
class Insn:
    text: str
    kind: str = "op"        # op | jump | call | ret | do | trap | nop | invalid
    target: int = -1        # branch target when kind is jump/call/do
    conditional: bool = False


def _alumac(op, dest_bit):
    sel = (op >> 13) & 31
    if sel & 16:
        x, y = _ALU_X[(op >> 8) & 7], _ALU_Y[(op >> 11) & 3]
        d = ("AR", "AF")[dest_bit]
    else:
        x, y = _MAC_X[(op >> 8) & 7], _MAC_Y[(op >> 11) & 3]
        d = ("MR", "MF")[dest_bit]
    tmpl = _ALUMAC[sel][1 if ((op >> 11) & 3) == 3 else 0]
    return tmpl.lstrip("!").format(d=d, x=x, y=y)


def disassemble(op):
    """Decode one 24-bit opcode into an Insn."""
    hi = (op >> 16) & 0xFF
    t = lambda s, **kw: Insn(s, **kw)

    if hi == 0x00:
        return t("NOP", kind="nop")
    if hi == 0x01:
        return t("TRAP", kind="trap")
    if hi == 0x02:
        if (op & 0x00F000) == 0:
            s = _COND[op & 15]
            for shift, reg in ((4, "FLAG_OUT"), (6, "FL0"), (8, "FL1"),
                               (10, "FL2")):
                s += _FLAG_CHANGE[(op >> shift) & 3].format(r=reg)
            return t(s.strip() or "NOP (flags)")
        if (op & 0x00FFF0) == 0x008000:
            return t("IDLE")
        return t(f"??? (${op:06X})", kind="invalid")
    if hi == 0x03:
        cond = "IF FLAG_IN " if op & 2 else "IF NOT FLAG_IN "
        verb = "CALL" if op & 1 else "JUMP"
        target = ((op >> 4) & 0x0FFF) | ((op << 10) & 0x3000)
        return t(f"{cond}{verb} ${target:04X}",
                 kind="call" if op & 1 else "jump", target=target,
                 conditional=True)
    if hi == 0x04:
        if (op & 0x00FFE0) == 0:
            parts = []
            if op & 0x10:
                parts.append("POP PC")
            if op & 0x08:
                parts.append("POP LOOP")
            if op & 0x04:
                parts.append("POP CNTR")
            if (op & 3) == 2:
                parts.append("PUSH STAT")
            elif (op & 3) == 3:
                parts.append("POP STAT")
            return t(" ".join(parts) or "NOP (stack)")
        return t(f"??? (${op:06X})", kind="invalid")
    if hi == 0x05:
        return (t("IF MV SAT MR") if (op & 0xFFFF) == 0
                else t(f"??? (${op:06X})", kind="invalid"))
    if hi == 0x06:
        if (op & 0x00E0FF) == 0:
            return t(f"DIVS {_ALU_Y[(op >> 11) & 3]},{_ALU_X[(op >> 8) & 7]}")
        return t(f"??? (${op:06X})", kind="invalid")
    if hi == 0x07:
        if (op & 0x00F8FF) == 0x001000:
            return t(f"DIVQ {_ALU_X[(op >> 8) & 7]}")
        return t(f"??? (${op:06X})", kind="invalid")
    if hi == 0x09:
        if (op & 0x00FFE0) == 0:
            base = (op >> 2) & 4
            return t(f"MODIFY (I{base + ((op >> 2) & 3)},M{base + (op & 3)})")
        return t(f"??? (${op:06X})", kind="invalid")
    if hi == 0x0A:
        if (op & 0x00FFE0) == 0:
            verb = "RTI" if op & 0x10 else "RTS"
            return t(f"{_COND[op & 15]}{verb}", kind="ret",
                     conditional=(op & 15) != 15)
        return t(f"??? (${op:06X})", kind="invalid")
    if hi == 0x0B:
        if (op & 0x00FF00) == 0:
            verb = "CALL" if op & 0x10 else "JUMP"
            s = f"{_COND[op & 15]}{verb} (I{4 + ((op >> 6) & 3)})"
            return t(s, kind="call" if op & 0x10 else "jump",
                     conditional=(op & 15) != 15)
        return t(f"??? (${op:06X})", kind="invalid")
    if hi == 0x0C:
        s = ""
        for shift, reg in ((4, "SEC_REG"), (6, "BIT_REV"), (8, "AV_LATCH"),
                           (10, "AR_SAT"), (12, "M_MODE"), (14, "TIMER"),
                           (2, "G_MODE")):
            s += _MODE_CHANGE[(op >> shift) & 3].format(r=reg)
        return t(s.strip() or "NOP (mode)")
    if hi == 0x0D:
        if (op & 0x00F000) == 0:
            return t(f"{_REG[(op >> 10) & 3][(op >> 4) & 15]} = "
                     f"{_REG[(op >> 8) & 3][op & 15]}")
        return t(f"??? (${op:06X})", kind="invalid")
    if hi == 0x0E:
        if (op & 0x0080F0) == 0:
            return t(_COND[op & 15]
                     + _SHIFT[(op >> 11) & 15].format(x=_SHIFT_X[(op >> 8) & 7]))
        return t(f"??? (${op:06X})", kind="invalid")
    if hi == 0x0F:
        if (op & 0x008000) == 0:
            n = op & 0xFF
            n = n - 256 if n >= 128 else n
            return t(_SHIFT_BY[(op >> 11) & 15].format(
                x=_SHIFT_X[(op >> 8) & 7], n=n))
        return t(f"??? (${op:06X})", kind="invalid")
    if hi == 0x10:
        if (op & 0x008000) == 0:
            s = _SHIFT[(op >> 11) & 15].format(x=_SHIFT_X[(op >> 8) & 7])
            return t(f"{s}, {_REG[0][(op >> 4) & 15]} = {_REG[0][op & 15]}")
        return t(f"??? (${op:06X})", kind="invalid")
    if hi == 0x11:
        s = _SHIFT[(op >> 11) & 15].format(x=_SHIFT_X[(op >> 8) & 7])
        i, m = 4 + ((op >> 2) & 3), 4 + (op & 3)
        if op & 0x008000:
            return t(f"{s}, PM(I{i},M{m}) = {_REG[0][(op >> 4) & 15]}")
        return t(f"{s}, {_REG[0][(op >> 4) & 15]} = PM(I{i},M{m})")
    if hi in (0x12, 0x13):
        s = _SHIFT[(op >> 11) & 15].format(x=_SHIFT_X[(op >> 8) & 7])
        base = (op >> 14) & 4
        i, m = base + ((op >> 2) & 3), base + (op & 3)
        if op & 0x008000:
            return t(f"{s}, DM(I{i},M{m}) = {_REG[0][(op >> 4) & 15]}")
        return t(f"{s}, {_REG[0][(op >> 4) & 15]} = DM(I{i},M{m})")
    if 0x14 <= hi <= 0x17:
        target = (op >> 4) & 0x3FFF
        return t(f"DO ${target:04X} UNTIL {_DO_COND[op & 15]}",
                 kind="do", target=target)
    if 0x18 <= hi <= 0x1F:
        verb = "CALL" if op & 0x040000 else "JUMP"
        target = (op >> 4) & 0x3FFF
        cond = _COND[op & 15]
        return t(f"{cond}{verb} ${target:04X}",
                 kind="call" if op & 0x040000 else "jump", target=target,
                 conditional=(op & 15) != 15)
    if 0x20 <= hi <= 0x27:
        return t(_COND[op & 15] + _alumac(op, (op >> 18) & 1),
                 conditional=(op & 15) != 15)
    if 0x28 <= hi <= 0x2F:
        s = ""
        if (op & 0x03E000) != 0:
            s = _alumac(op, (op >> 18) & 1) + ", "
        return t(f"{s}{_REG[0][(op >> 4) & 15]} = {_REG[0][op & 15]}")
    if 0x30 <= hi <= 0x3F:
        return t(f"{_REG[(op >> 18) & 3][op & 15]} = ${(op >> 4) & 0x3FFF:04X}")
    if 0x40 <= hi <= 0x4F:
        return t(f"{_REG[0][op & 15]} = ${(op >> 4) & 0xFFFF:04X}")
    if 0x50 <= hi <= 0x5F:
        s = ""
        if (op & 0x03E000) != 0:
            s = _alumac(op, (op >> 18) & 1) + ", "
        i, m = 4 + ((op >> 2) & 3), 4 + (op & 3)
        if op & 0x080000:
            return t(f"{s}PM(I{i},M{m}) = {_REG[0][(op >> 4) & 15]}")
        return t(f"{s}{_REG[0][(op >> 4) & 15]} = PM(I{i},M{m})")
    if 0x60 <= hi <= 0x7F:
        s = ""
        if (op & 0x03E000) != 0:
            s = _alumac(op, (op >> 18) & 1) + ", "
        base = (op >> 18) & 4
        i, m = base + ((op >> 2) & 3), base + (op & 3)
        if op & 0x080000:
            return t(f"{s}DM(I{i},M{m}) = {_REG[0][(op >> 4) & 15]}")
        return t(f"{s}{_REG[0][(op >> 4) & 15]} = DM(I{i},M{m})")
    if 0x80 <= hi <= 0x9F:
        addr = (op >> 4) & 0x3FFF
        reg = _REG[(op >> 18) & 3][op & 15]
        if op & 0x100000:
            return t(f"DM(${addr:04X}) = {reg}")
        return t(f"{reg} = DM(${addr:04X})")
    if 0xA0 <= hi <= 0xBF:
        base = (op >> 18) & 4
        i, m = base + ((op >> 2) & 3), base + (op & 3)
        return t(f"DM(I{i},M{m}) = ${(op >> 4) & 0xFFFF:04X}")
    if hi >= 0xC0:
        s = ""
        if (op & 0x03E000) != 0:
            s = _alumac(op, 0) + ", "
        return t(f"{s}{_DUAL_X[(op >> 18) & 3]} = "
                 f"DM(I{(op >> 2) & 3},M{op & 3}), "
                 f"{_DUAL_Y[(op >> 20) & 3]} = "
                 f"PM(I{4 + ((op >> 6) & 3)},M{4 + ((op >> 4) & 3)})")
    return t(f"??? (${op:06X})", kind="invalid")


# interrupt vector annotations (ADSP-2105 vector table)
VECTORS = {0x0000: "RESET vector", 0x0004: "IRQ2 vector",
           0x0010: "SPORT0 TX vector", 0x0014: "SPORT0 RX vector",
           0x0018: "IRQ0 vector", 0x001C: "IRQ1 vector",
           0x0020: "TIMER vector"}


def disassemble_rom(data, start_addr=0, max_ops=None, collapse_ff=True):
    """Disassemble ROM bytes (24-bit big-endian opcodes at 4-byte strides).

    Yields formatted lines with addresses, hex, vector annotations, and
    $FFxxxx-run collapsing.
    """
    n_ops = len(data) // 4
    if max_ops is not None:
        n_ops = min(n_ops, max_ops)
    lines = []
    i = 0
    while i < n_ops:
        op = (data[i * 4] << 16) | (data[i * 4 + 1] << 8) | data[i * 4 + 2]
        addr = start_addr + i
        if collapse_ff and (op >> 16) == 0xFF:
            j = i
            while j < n_ops and data[j * 4] == 0xFF:
                j += 1
            if j - i >= 4:
                lines.append(f"  ${addr:04X}..${start_addr + j - 1:04X}  "
                             f"[{j - i} words of $FF fill]")
                i = j
                continue
        ins = disassemble(op)
        note = VECTORS.get(addr)
        tag = f"   ; {note}" if note else ""
        lines.append(f"  ${addr:04X}  {op:06X}  {ins.text}{tag}")
        i += 1
    return lines
