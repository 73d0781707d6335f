"""Emulated DCS sound-board decoder: runs original ROM firmware on the
ADSP-2105 interpreter.

The framework counterpart of the reference's emulator backend
(reference: DCSDecoderEmu.cpp/.h): it virtualizes the DCS / DCS-95 board
around the CPU core in emu/adsp2105.py —

 - DM/PM memory maps with banked ROM windows and bank-select registers
   (reference: DCSDecoderEmu.cpp:397-457 for the maps),
 - the sound data port (DM($3300) on DCS-95, PM($3000) on the originals),
 - the SPORT1 autobuffer (register $3FEF) that carries decoded PCM,
 - the soft-boot loader (8*(b3+1)-word program block from U2),
 - the ROM patch points that substitute host traps for the hardware
   autobuffer sync (reference: DCSDecoderEmu.cpp:101-351).

It plugs into the shared runtime state machine (refdec/decoder.py) by
overriding `_initialize`, `main_loop`, `irq2_handler` and
`set_master_volume`, so boot/bong/data-port behavior is identical across
backends, exactly as the reference base class shares those across its
native and emulated subclasses.

The reference's "speedup" fast mode (PinMame-derived native inner loops,
reference: DCSDecoderEmu.cpp:644-890) has a counterpart here too: with
``enable_speedup=True`` the firmware's inverse-transform region is
detected by opcode signature and executed natively (emu/speedup.py;
native/src/adsp2105.cpp accelRun) — verified bit-exact against strict
mode on synthesized-firmware ROMs (tests/test_emu_speedup.py).  Strict
mode remains the validation oracle, exactly as in the reference
(DCSExplorer.cpp:1033-1036).

Original DCS ROMs run their own firmware here.  ROM sets produced by the
framework's compiler carry a synthesized, runnable decoder program
(compiler/firmware94.py for OS94 — a complete 94x decoder whose PCM
bit-matches the native backend; compiler/firmware.py for the other
versions — boot + data-port service), so generated ROMs boot and, on
OS94, fully decode through this backend too.

The port's copy of ``dcsexplorer_tpu/emu/board.py``, without its silent
fallback: ``use_native=True`` (the default) runs the native core
(native/src/adsp2105.cpp) and raises when it cannot be built or loaded;
``use_native=False`` selects the Python core.
"""

from ..refdec import decoder as rd
from ..refdec.fixed import s16
from ..rom.opsearch import search_opcodes_words
from .adsp2105 import ADSP2105

HW_DCS93 = 2
HW_DCS95 = 3

TRAP = 0x010000
INCOMPATIBLE_ROM = (
    "The emulator was unable to find required data in the ROM. The ROM "
    "image might be invalid, or it might contain a version of the DCS "
    "software that's not compatible with this emulator.")
NO_SPEEDUP = (
    "The emulator was unable to find the decoder transform code in this "
    "ROM's program, so the \"speedup\" fast mode can't be used.  The ROM "
    "might still work with the strict-mode emulator backend.")


def load_boot_words(src, ofs=0):
    """Decode the boot block at src[ofs:]: 8*(b3+1) big-endian 24-bit words
    at 4-byte stride (reference: adsp2100.cpp adsp2105_load_boot_data)."""
    size = 8 * (src[ofs + 3] + 1)
    return [(src[ofs + i * 4] << 16) | (src[ofs + i * 4 + 1] << 8)
            | src[ofs + i * 4 + 2] for i in range(size)]


class _Autobuffer:
    def __init__(self):
        self.base = None        # DM index
        self.length = 0
        self.step = 1


class EmulatedDecoder(rd.ReferenceDecoder):
    """DCSDecoder backend running original firmware under interpretation."""

    name = "ADSP-2105 emulator"

    def __init__(self, host=None, max_steps_per_pass=200_000_000,
                 use_native=True, enable_speedup=False):
        super().__init__(host)
        self.max_steps = max_steps_per_pass
        self.enable_speedup = enable_speedup
        self.speedup_info = None
        self.cpu = None
        self.native_cpu = use_native
        if use_native:
            from .native_cpu import make_native_cpu
            self.cpu = make_native_cpu()
        else:
            self.cpu = ADSP2105(read_dm=self._read_dm,
                                write_dm=self._write_dm,
                                read_pm=self._read_pm_port,
                                write_pm=self._write_pm_port)
        self._bank_mem = None
        self._bank_pos = 0
        self.autobuffer = _Autobuffer()
        self.main_loop_entry = -1
        self.master_volume_addr = -1
        self.error_message = None

    # bank state as properties so snapshot restore (utils/state.py assigns
    # bank_mem/bank_pos directly) re-pushes the window to the native core
    @property
    def bank_mem(self):
        return self._bank_mem

    @bank_mem.setter
    def bank_mem(self, mem):
        self._bank_mem = mem
        if self.native_cpu:
            self.cpu.set_bank_window(mem, self._bank_pos)

    @property
    def bank_pos(self):
        return self._bank_pos

    @bank_pos.setter
    def bank_pos(self, pos):
        self._bank_pos = pos
        if self.native_cpu:
            self.cpu.set_bank_window(self._bank_mem, pos)

    # ------------------------------------------------------------------
    # board memory maps (reference: DCSDecoderEmu.cpp:459-591)

    def _rom_byte(self, off):
        if self.bank_mem is None:
            return 0
        return self.bank_mem[self.bank_pos + off]

    def _set_rom_bank(self, linear):
        p = self.make_rom_pointer(linear)
        self.bank_mem, self.bank_pos = p.mem, p.pos

    def _read_dm(self, addr):
        addr &= 0x3FFF
        if self.hw_version == HW_DCS93:
            if 0x2000 <= addr <= 0x2FFF:
                return self._rom_byte(addr - 0x2000)
        else:
            if addr <= 0x07FF:
                return self._rom_byte(addr)
            if addr == 0x3300:
                return self._read_data_port()
        return self.cpu.dm[addr]

    def _write_dm(self, addr, data):
        addr &= 0x3FFF
        data &= 0xFFFF
        self.cpu.dm[addr] = data
        if self.hw_version == HW_DCS93:
            if addr == 0x3000:
                self._set_rom_bank(data << 12)
        else:
            if addr in (0x3000, 0x3100):
                dm = self.cpu.dm
                chip = (dm[0x3100] >> 2) & 0x07
                offset = ((dm[0x3100] & 0x01) << 19) + ((dm[0x3000] & 0xFF) << 11)
                self._set_rom_bank((chip << 21) | offset)
            elif addr == 0x3300:
                self.host.receive_data_port(data & 0xFF)
        if addr == 0x3FEF:
            # SPORT1 autobuffer control: capture the buffer geometry from
            # the DAG registers named in the bit fields
            if data & 0x0002:
                ireg = (data >> 9) & 7
                mreg = ((data >> 7) & 3) | (ireg & 0x04)
                self.autobuffer.base = self.cpu.i[ireg]
                self.autobuffer.length = self.cpu.l[ireg]
                self.autobuffer.step = self.cpu.m[mreg]
        elif addr == 0x3FFF:
            # system control register: bit $0200 soft-boots the decoder
            if data & 0x0200:
                raise rd.ResetError("ROM-initiated reset")

    def _read_pm_port(self, addr):
        # only PM($3000) reaches this hook; it is the data port on the
        # original boards, plain memory on DCS-95
        if self.hw_version == HW_DCS93:
            return self._read_data_port()
        return (self.cpu.pm[addr & 0x3FFF] >> 8) & 0xFFFF

    def _write_pm_port(self, addr, val16):
        if self.hw_version == HW_DCS93:
            self.host.receive_data_port(val16 & 0xFF)

    # ------------------------------------------------------------------
    # patch-point search helpers

    def _search(self, pattern, start=0):
        # snapshot once: the native proxy reads the whole PM in one call
        return search_opcodes_words(pattern, list(self.cpu.pm), start)

    # ------------------------------------------------------------------
    # decoder interface overrides

    def set_master_volume(self, vol):
        vol = 255 if vol > 255 else 0 if vol < 0 else vol
        self.nominal_volume = vol
        if self.master_volume_addr >= 0:
            self.cpu.dm[self.master_volume_addr] = vol

    def irq2_handler(self):
        # vector the firmware's own IRQ2 routine; it reads the data port
        # and runs its command logic (reference: DCSDecoderEmu.cpp:353-357)
        self.cpu.invoke_irq(2, 0, self.max_steps)

    def _initialize(self):
        if self.rom_set is None or self.rom_set.chips[0] is None:
            self.error_message = "no U2 ROM loaded"
            return False
        cpu = self.cpu
        if self.native_cpu:
            cpu.config_board(
                self.hw_version,
                self._read_data_port,
                lambda v: self.host.receive_data_port(v & 0xFF),
                self._set_rom_bank)
            cpu.clear_autobuffer()
            cpu.set_speedup(0)          # disarm any previous install
        else:
            cpu.speedup = None
        self.speedup_info = None
        cpu.reset()
        cpu.pm = [0] * 0x4000
        cpu.dm = [0] * 0x4000
        u2 = self.rom_set.chips[0]
        boot = load_boot_words(u2, self.rom_set.soft_boot_offset())
        cpu.pm[:len(boot)] = boot
        self._set_rom_bank(0)
        self.autobuffer = _Autobuffer()

        # patch the autobuffer hardware-sync wait loop out of the firmware
        # (reference: DCSDecoderEmu.cpp:122-262, including the opcode
        # signatures, which are properties of the DCS ROM programs)
        sync_start, _ = self._search("0D02A3 4xxxx4 26E20F 1yyyy4")
        if sync_start >= 0:
            cpu.pm[sync_start] = TRAP

        entry, _ = self._search("3C1025 3xxxx0 1xxxxE")
        if entry < 0:
            self.error_message = INCOMPATIBLE_ROM
            return False
        self.main_loop_entry = entry

        # run the firmware's initialization up to the main loop trap
        cpu.pm[entry] = TRAP
        cpu.run(self.max_steps)
        cpu.pm[entry] = 0x3C1025

        if sync_start < 0:
            sync_start, _ = self._search("0D02A3 4xxxx4 26E20F 1yyyy4")
        if sync_start < 0:
            self.error_message = INCOMPATIBLE_ROM
            return False

        # locate the end of the sync loop (second write-pointer reset)
        end1, v1 = self._search("4xxxxA 9zzzzA", sync_start + 1)
        if end1 < 0:
            self.error_message = INCOMPATIBLE_ROM
            return False
        sync_end, v2 = self._search("4yyyyA 9zzzzA", end1 + 1)
        if sync_end < 0:
            self.error_message = INCOMPATIBLE_ROM
            return False
        sync_end += 2

        # replace the whole wait loop: reset the write pointer to the
        # lower half and jump past the loop
        x, y, z = v1["x"], v2["y"], v2["z"]
        cpu.pm[sync_start] = 0x40000A | ((min(x, y) & 0x3FFF) << 4)
        cpu.pm[sync_start + 1] = 0x90000A | ((z & 0x3FFF) << 4)
        cpu.pm[sync_start + 2] = 0x18000F | ((sync_end & 0x3FFF) << 4)

        # 1993 firmware puts the sync wait at the TOP of the main loop
        if self.main_loop_entry > sync_start:
            self.main_loop_entry = sync_start - 2

        # trap out at the jump back to the top of the main loop
        loop_jump = 0x18000F | (self.main_loop_entry << 4)
        for a in range(self.main_loop_entry, 0x4000):
            if cpu.pm[a] == loop_jump:
                cpu.pm[a] = TRAP
                break
        else:
            self.error_message = INCOMPATIBLE_ROM
            return False

        # master volume variable, via the multiplier-derivation routine
        addr, vv = self._search("8xxxxF 2E7FEF 1yyyy0")
        if addr > 0:
            self.master_volume_addr = vv["x"]

        self.set_master_volume(self.default_volume)
        self.data_port_queue.clear()
        self.last_data_port_byte = 0

        # fast mode: locate the transform region and arm the native
        # accelerator (reference: DCSDecoderEmu.cpp:289-325)
        if self.enable_speedup:
            from .speedup import install
            self.speedup_info = install(self)
            if self.speedup_info is None:
                self.error_message = NO_SPEEDUP
                return False

        if self.native_cpu:
            nab = self.cpu.autobuffer
            if nab.base is not None:
                self.autobuffer = nab
        return True

    def main_loop(self):
        if self.native_cpu:
            nab = self.cpu.autobuffer
            if nab.base is not None:
                self.autobuffer = nab
        if self.main_loop_entry < 0 or self.autobuffer.base is None:
            return
        cpu = self.cpu
        cpu.pc = self.main_loop_entry
        cpu.run(self.max_steps)
        if not cpu.stopped:
            # runaway firmware: surface as a decoder reset so the shared
            # retry/fatal logic applies
            raise rd.ResetError("emulated main loop did not reach the trap")
        ab = self.autobuffer
        half = ab.length // 2
        n = half // max(ab.step, 1)
        if n != len(self.output_buffer):
            raise rd.ResetError(
                f"unexpected autobuffer geometry: {n} samples/frame")
        base = ab.base
        if self.native_cpu:
            vals = self.cpu.read_dm_strided(base, ab.step, n)
            for k in range(n):
                self.output_buffer[k] = s16(int(vals[k]))
        else:
            for k in range(n):
                self.output_buffer[k] = s16(
                    cpu.dm[(base + k * ab.step) & 0x3FFF])
