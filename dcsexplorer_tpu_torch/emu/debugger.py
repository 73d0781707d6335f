"""Interactive debugger for the ADSP-2105 interpreter.

Counterpart of the reference's optional assembly-level debugger built into
its CPU core (reference: adsp2100/adsp2100.cpp:581-978, adsp2100.h:63-65):
breakpoints, single-step, step-over (calls and DO UNTIL loops), run-until,
register and memory display, and live disassembly around the program
counter.  Here it's a separate module wrapping the emu.adsp2105 core —
programmatic API first (each command is a method), with a small REPL on
top for terminal use.

The port's copy of ``dcsexplorer_tpu/emu/debugger.py``, over the port's
``rom/disasm.py``.
"""

from ..rom.disasm import disassemble

MAX_BP = 16


class Debugger:
    def __init__(self, cpu):
        self.cpu = cpu
        self.breakpoints = set()

    # ------------------------------------------------------------------
    # control

    def step(self, n=1):
        """Execute n instructions (ignores breakpoints)."""
        done = 0
        while done < n and self.cpu.step():
            done += 1
        return done

    def cont(self, max_steps=10_000_000):
        """Run until a breakpoint, TRAP/IDLE, or the step budget."""
        cpu = self.cpu
        for done in range(max_steps):
            if not cpu.step():
                return done + 1, "trap"
            if cpu.pc in self.breakpoints:
                return done + 1, "breakpoint"
        return max_steps, "budget"

    def step_over(self, max_steps=10_000_000):
        """Step one instruction, running CALLs and DO UNTIL loops to
        completion (reference 'p' / 'pl' commands)."""
        cpu = self.cpu
        op = cpu.rword_pgm(cpu.pc)
        hi = (op >> 16) & 0xFF
        is_call = (0x1C <= hi <= 0x1F) or (hi == 0x0B and op & 0x10) \
            or (hi == 0x03 and op & 1)
        is_do = 0x14 <= hi <= 0x17
        if is_do:
            # run the whole loop: resume just past the loop-end address
            resume = (((op >> 4) & 0x3FFF) + 1) & 0x3FFF
        elif is_call:
            resume = cpu.pc + 1
        else:
            return (1, "step") if cpu.step() else (1, "trap")
        if not cpu.step():
            return 1, "trap"
        for done in range(max_steps):
            if cpu.pc == resume:
                return done + 1, "step-over"
            if cpu.pc in self.breakpoints:
                return done + 1, "breakpoint"
            if not cpu.step():
                return done + 1, "trap"
        return max_steps, "budget"

    def run_to(self, addr, max_steps=10_000_000):
        cpu = self.cpu
        for done in range(max_steps):
            if not cpu.step():
                return done + 1, "trap"
            if cpu.pc == (addr & 0x3FFF):
                return done + 1, "at-address"
        return max_steps, "budget"

    # ------------------------------------------------------------------
    # breakpoints

    def set_bp(self, addr):
        if len(self.breakpoints) >= MAX_BP:
            raise ValueError(f"too many breakpoints (max {MAX_BP})")
        self.breakpoints.add(addr & 0x3FFF)

    def clear_bp(self, addr=None):
        if addr is None:
            self.breakpoints.clear()
        else:
            self.breakpoints.discard(addr & 0x3FFF)

    # ------------------------------------------------------------------
    # inspection

    def regs(self):
        c = self.cpu.core
        cpu = self.cpu
        mr = c.mr & ((1 << 40) - 1)
        lines = [
            f"PC={cpu.pc:04X}  ASTAT={cpu.astat:02X} MSTAT={cpu.mstat:02X} "
            f"SSTAT={cpu.sstat:02X} IMASK={cpu.imask:02X} CNTR={cpu.cntr & 0x3FFF:04X}",
            f"AX0={c.ax0:04X} AX1={c.ax1:04X} AY0={c.ay0:04X} AY1={c.ay1:04X} "
            f"AR={c.ar:04X} AF={c.af:04X}",
            f"MX0={c.mx0:04X} MX1={c.mx1:04X} MY0={c.my0:04X} MY1={c.my1:04X} "
            f"MR={mr:010X} MF={c.mf:04X}",
            f"SI={c.si:04X} SE={c.se:04X} SB={c.sb:04X} SR={c.sr:08X}",
            "I=" + " ".join(f"{v:04X}" for v in cpu.i)
            + "  M=" + " ".join(f"{v & 0x3FFF:04X}" for v in cpu.m),
            "L=" + " ".join(f"{v:04X}" for v in cpu.l),
        ]
        return "\n".join(lines)

    def disasm(self, addr=None, count=8):
        addr = self.cpu.pc if addr is None else addr & 0x3FFF
        out = []
        for k in range(count):
            a = (addr + k) & 0x3FFF
            op = self.cpu.pm[a]
            mark = "*" if a == self.cpu.pc else " "
            bp = "B" if a in self.breakpoints else " "
            out.append(f"{mark}{bp}{a:04X}: {op:06X}  {disassemble(op).text}")
        return "\n".join(out)

    def dump_dm(self, addr, count=16):
        vals = [self.cpu.dm[(addr + k) & 0x3FFF] for k in range(count)]
        rows = []
        for base in range(0, count, 8):
            row = vals[base:base + 8]
            rows.append(f"DM({(addr + base) & 0x3FFF:04X}): "
                        + " ".join(f"{v:04X}" for v in row))
        return "\n".join(rows)

    def dump_pm(self, addr, count=8):
        rows = []
        for k in range(count):
            a = (addr + k) & 0x3FFF
            rows.append(f"PM({a:04X}): {self.cpu.pm[a]:06X}")
        return "\n".join(rows)

    # ------------------------------------------------------------------
    # REPL

    HELP = """\
s [n]       step n instructions (default 1)
p           step over (runs calls/loops to completion)
g [addr]    continue; with addr, run to address
b addr      set breakpoint        bc [addr]  clear breakpoint(s)
bl          list breakpoints
r           show registers
u [addr]    disassemble (default: at PC)
dm addr [n] dump data memory      pm addr [n]  dump program memory
q           quit"""

    def repl(self, input_fn=input, print_fn=print):
        print_fn("ADSP-2105 debugger; 'h' for help")
        print_fn(self.disasm(count=1))
        while True:
            try:
                line = input_fn("dbg> ")
            except EOFError:
                return
            parts = line.split()
            if not parts:
                continue
            cmd, args = parts[0].lower(), parts[1:]
            try:
                if cmd == "q":
                    return
                elif cmd == "h":
                    print_fn(self.HELP)
                elif cmd == "s":
                    self.step(int(args[0]) if args else 1)
                    print_fn(self.disasm(count=1))
                elif cmd == "p":
                    n, why = self.step_over()
                    print_fn(f"[{n} steps, {why}]")
                    print_fn(self.disasm(count=1))
                elif cmd == "g":
                    if args:
                        n, why = self.run_to(int(args[0], 16))
                    else:
                        n, why = self.cont()
                    print_fn(f"[{n} steps, {why}]")
                    print_fn(self.disasm(count=1))
                elif cmd == "b":
                    self.set_bp(int(args[0], 16))
                elif cmd == "bc":
                    self.clear_bp(int(args[0], 16) if args else None)
                elif cmd == "bl":
                    print_fn(" ".join(f"{a:04X}"
                                      for a in sorted(self.breakpoints))
                             or "(none)")
                elif cmd == "r":
                    print_fn(self.regs())
                elif cmd == "u":
                    print_fn(self.disasm(int(args[0], 16) if args else None))
                elif cmd == "dm":
                    print_fn(self.dump_dm(int(args[0], 16),
                                          int(args[1]) if len(args) > 1 else 16))
                elif cmd == "pm":
                    print_fn(self.dump_pm(int(args[0], 16),
                                          int(args[1]) if len(args) > 1 else 8))
                else:
                    print_fn("unknown command; 'h' for help")
            except (ValueError, IndexError) as e:
                print_fn(f"error: {e}")
