"""Static-trace disassembly of DCS ROM programs with overlay reconstruction.

The port's copy of ``dcsexplorer_tpu/rom/dasmtrace.py``.

Counterpart of the reference explorer's --dasm mode (reference:
DCSExplorer/DCSExplorer.cpp:1941-2541).  Produces an annotated listing of
the hard-boot loader or the main (soft-boot) decoder program:

 - loads the ADSP-2105 auto-boot block (8*(b3+1) words);
 - hard boot: re-applies the vector-table patch the loader performs (a run
   of JUMP/RTI words stored after the signature string);
 - soft boot: statically simulates the overlay loader — tracks the
   SI/AX0/I0/I4 immediate loads feeding the first CALL target and copies
   each overlay block from U2 into program memory, for both the transient
   initialization overlay and the resident main overlay;
 - traces reachable code from the interrupt vectors (or a given entry),
   following jumps/calls, with the DCS jump-table heuristic for JUMP (Ix)
   (scan back for the I-register's immediate load; the table is the run of
   consecutive unconditional JUMPs starting there);
 - rescues short unreachable gaps surrounded by reachable code (annotated);
 - lists loaded-but-unreachable regions as data bytes with $FF-run
   collapsing, and annotates the interrupt vectors.

These heuristics are properties of the DCS ROM programs (compiler-generated
switch tables, standard overlay loader template), not of ADSP-2105 code in
general — same caveat as the reference.
"""

from .disasm import disassemble

VECTORS = [(0x0000, "RESET vector"), (0x0004, "IRQ2 vector"),
           (0x0010, "TX1/IRQ1 vector"), (0x0014, "RX1/IRQ0 vector"),
           (0x0018, "Timer vector")]


def _is_jump(op):
    return (op >> 16) & 0xFC == 0x18 and (op & 0x0F) == 0x0F


def _is_rti(op):
    return (op >> 16) & 0xFF == 0x0A and (op & 0x10) != 0


def _word(u2, byte_ofs):
    return (u2[byte_ofs] << 16) | (u2[byte_ofs + 1] << 8) | u2[byte_ofs + 2]


class Overlay:
    def __init__(self):
        self.base = 0
        self.end = 0
        self.rom_offset = 0

    def add(self, base, length, rom_offset):
        if self.base == 0:
            self.base = base
            self.rom_offset = rom_offset
        self.end = max(self.end, base + length)


class Program:
    """Reconstructed PM image + raw source bytes + annotations."""

    def __init__(self):
        self.code = [0] * 0x4000          # 24-bit words
        self.raw = bytearray(0x4000 * 4)  # original 4-byte ROM groups
        self.loaded = [False] * 0x4000    # filled by boot/overlay loads
        self.ann = {}
        self.overlays = [Overlay(), Overlay()]
        self.loader_sub = 0
        self.boot_words = 0

    def annotate(self, addr, text):
        self.ann[addr] = self.ann.get(addr, "") + text

    def load_block(self, u2, rom_ofs, pm_addr, n_words):
        for k in range(n_words):
            a = pm_addr + k
            if a >= 0x4000 or rom_ofs + k * 4 + 3 >= len(u2):
                break
            self.code[a] = _word(u2, rom_ofs + k * 4)
            self.raw[a * 4:a * 4 + 4] = bytes(u2[rom_ofs + k * 4:
                                                 rom_ofs + k * 4 + 4])
            self.loaded[a] = True


def reconstruct(u2, offset):
    """Build the PM image as it stands after boot (and overlay loading,
    for the soft-boot program at offset $1000/$2000)."""
    prog = Program()
    n_words = 8 * (u2[offset + 3] + 1)
    prog.boot_words = n_words
    prog.load_block(u2, offset, 0, n_words)

    if offset == 0:
        # hard boot: the loader patches vectors $0004..$0010 from a run of
        # JUMP/RTI words stored after the signature string
        p = 0x19
        for _ in range(128):
            if _is_jump(_word(u2, p * 4)):
                break
            p += 1
        dst = 0x0004
        for _ in range(4):
            op = _word(u2, p * 4)
            if not (_is_jump(op) or _is_rti(op)):
                break
            prog.code[dst] = op
            prog.raw[dst * 4:dst * 4 + 4] = bytes(u2[p * 4:p * 4 + 4])
            prog.loaded[dst] = True
            prog.annotate(dst, "  ; patched by boot loader")
            p += 1
            dst += 4
        return prog

    # soft boot: simulate the overlay loader statically
    si, ax0, i0, i4 = 0, 0, 0, 0x0800
    init_sub = 0
    cur = 0
    for addr in range(0x4000):
        op = prog.code[addr]
        if (op & 0xF0000F) == 0x400000:           # AX0 = imm
            ax0 = (op >> 4) & 0x3FFF
        elif (op & 0xF0000F) == 0x400008:         # SI = imm
            si = (op >> 4) & 0xFFFF
        elif (op & 0xFC000F) == 0x340000:         # I0 = imm
            i0 = (op >> 4) & 0x3FFF
        elif (op & 0xFC000F) == 0x380000:         # I4 = imm
            i4 = (op >> 4) & 0x3FFF
        elif ((op >> 16) & 0xFC) == 0x1C and (op & 0xF) == 0xF:  # CALL
            target = (op >> 4) & 0x3FFF
            if prog.loader_sub in (0, target):
                prog.loader_sub = target
                if i4 < 0x2800:
                    # original board: 4K ROM window at DM($2000)
                    rom_ofs = (si << 12) + (i0 - 0x2000)
                else:
                    # DCS-95: 2K ROM window at DM($0000)
                    rom_ofs = (si << 11) + i0
                prog.overlays[cur].add(i4, ax0, rom_ofs)
                prog.load_block(u2, rom_ofs, i4, ax0)
                prog.annotate(addr,
                              f"  ; load overlay to PM(${i4:04X}) from "
                              f"U2[${rom_ofs:05X}], {ax0} opcodes")
            elif init_sub == 0:
                init_sub = target
                cur = 1
                prog.annotate(addr, "  ; call initialization overlay")
            else:
                break
    return prog


def trace_reachable(prog, entrypoints):
    """Mark code reachable from the entrypoints (flow-following trace)."""
    reachable = [False] * 0x4000
    queue = list(entrypoints)
    while queue:
        addr = queue.pop()
        while 0 <= addr < 0x4000 and not reachable[addr]:
            if not prog.loaded[addr]:
                break               # fell off the loaded program image
            reachable[addr] = True
            op = prog.code[addr]
            hi = (op >> 16) & 0xFF
            if hi == 0x01:
                break               # TRAP ends the flow
            if hi == 0x03:
                queue.append(((op >> 4) & 0x0FFF) | ((op << 10) & 0x3000))
            elif hi == 0x0A:
                if (op & 0xF) == 0xF:
                    break
            elif hi == 0x0B:
                # JUMP (Ix): DCS jump-table heuristic — find the preceding
                # immediate register load; its value is the table start
                ireg = 4 + ((op >> 6) & 3)
                for back in range(min(16, addr)):
                    lop = prog.code[addr - back]
                    if (lop & 0xF00000) == 0x400000:
                        start = (lop >> 4) & 0xFFFF
                        t = start
                        while t < 0x4000 and _is_jump(prog.code[t]):
                            queue.append(t)
                            t += 1
                        prog.annotate(
                            addr, f"  ; I{ireg} in (${start:04X}..${t - 1:04X})")
                        break
                if (op & 0xF) == 0xF:
                    break
            elif 0x18 <= hi <= 0x1B:
                queue.append((op >> 4) & 0x3FFF)
                if (op & 0xF) == 0xF:
                    break
            elif 0x1C <= hi <= 0x1F:
                queue.append((op >> 4) & 0x3FFF)
            addr += 1

    # rescue short unreachable gaps surrounded by reachable code
    for addr in range(0x001C, 0x4000):
        if not reachable[addr] and reachable[addr - 1]:
            n = 0
            while n < 64 and addr + n < 0x4000 and not reachable[addr + n]:
                n += 1
            if addr + n < 0x4000 and reachable[addr + n]:
                for a in range(addr, addr + n):
                    reachable[a] = True
                    b = prog.raw[a * 4:a * 4 + 4]
                    prog.annotate(
                        a, "  ; unreachable code, bytes "
                        + " ".join(f"${x:02X}" for x in b))
    return reachable


def _printable(b):
    return chr(b) if 32 <= b < 127 else "."


def listing_lines(prog, reachable, data_regions):
    """Render the annotated listing (reachable code as assembly; loaded but
    unreachable regions as data with $FF-run collapsing)."""
    lines = []

    def in_data_region(a):
        return any(lo <= a < hi for (lo, hi) in data_regions)

    addr = 0
    while addr < 0x4000:
        b = prog.raw[addr * 4:addr * 4 + 4]
        if reachable[addr]:
            op = prog.code[addr]
            comment = ""
            for (va, name) in VECTORS:
                if addr == va and (va in (0, 4) or _is_jump(op)
                                   or _is_rti(op)):
                    comment += f"  ; {name}"
            comment += prog.ann.get(addr, "")
            txt = disassemble(op).text
            lines.append(f"{addr:04X} {b[0]:02X} {b[1]:02X} {b[2]:02X} "
                         f"{txt}{comment}")
        elif addr < 0x001C:
            pass  # unused slots between interrupt vectors: noise
        elif in_data_region(addr):
            # collapse $FF fill runs
            if bytes(b) == b"\xff\xff\xff\xff":
                end = addr
                while (end < 0x4000 and in_data_region(end)
                       and bytes(prog.raw[end * 4:end * 4 + 4])
                       == b"\xff\xff\xff\xff"):
                    end += 1
                if end > addr + 4:
                    lines.append(
                        f"{addr:04X} FF FF FF .BYTE $FF REPEAT "
                        f"${(end - addr) * 4:04X}  ; ${addr:04X} through "
                        f"${end - 1:04X}")
                    addr = end
                    continue
            lines.append(
                f"{addr:04X} {b[0]:02X} {b[1]:02X} {b[2]:02X} .BYTE "
                + ", ".join(f"${x:02X}" for x in b)
                + "  ; [" + "".join(_printable(x) for x in b) + "]")
        addr += 1
    return lines


def disassemble_program(u2, offset):
    """Full annotated listing for the program block at the U2 offset
    (0 = hard-boot loader; $1000/$2000 = main decoder program)."""
    prog = reconstruct(u2, offset)
    lines = []
    if offset == 0:
        lines.append("; Hard reset boot loader")
    else:
        lines.append("; Main DCS decoder program")
    lines.append(f"; {prog.boot_words} opcodes loaded from U2[${offset:05X}]")
    ov = prog.overlays
    if ov[1].base:
        lines.append(f"; resident overlay: PM(${ov[1].base:04X}.."
                     f"${ov[1].end - 1:04X}) from U2[${ov[1].rom_offset:05X}]")
    lines.append("")

    vectors = [a for (a, _) in VECTORS]
    data_regions = [(0x001C, prog.boot_words)]
    if ov[1].base:
        data_regions.append((ov[1].base, ov[1].end))
    reachable = trace_reachable(prog, vectors)
    lines += listing_lines(prog, reachable, data_regions)

    if ov[0].base:
        # the transient initialization overlay, traced from its entry
        prog2 = reconstruct(u2, offset)
        prog2.load_block(u2, ov[0].rom_offset, ov[0].base,
                         ov[0].end - ov[0].base)
        lines.append("")
        lines.append("; Initialization overlay (loaded at startup, called "
                     "once, then replaced)")
        reach2 = trace_reachable(prog2, [ov[0].base])
        only_overlay = [(ov[0].base, ov[0].end)]
        body = listing_lines(prog2, reach2, only_overlay)
        # show only the overlay's own span
        lines += [ln for ln in body
                  if ov[0].base <= int(ln[:4], 16) < ov[0].end]
    return lines
