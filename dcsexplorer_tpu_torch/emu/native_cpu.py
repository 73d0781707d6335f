"""ctypes wrapper for the native ADSP-2105 core (native/src/adsp2105.cpp).

Drop-in replacement for emu/adsp2105.ADSP2105 with the DCS board map fused
into the C++ side (the framework's counterpart of the reference's compiled
emulator layer, reference: DCSDecoder/adsp2100/ + DCSDecoderEmu.cpp).  The
state-vector layout is shared with the Python core, so sessions snapshot
and restore across the two interchangeably (utils/state.py).

The port's copy of ``dcsexplorer_tpu/emu/native_cpu.py``, over the port's
native library (``native.get_lib``, which builds it or raises, and which
declares the ``adsp_*`` signatures).
"""

import ctypes as C
from types import SimpleNamespace

import numpy as np

from .. import native
from ..refdec import decoder as rd


class _MemProxy:
    """List-like view of the native PM/DM arrays (int and slice access)."""

    def __init__(self, cpu, is_pm):
        self._cpu = cpu
        self._pm = is_pm

    def __len__(self):
        return 0x4000

    def _read_block(self):
        cpu = self._cpu
        if self._pm:
            out = np.zeros(0x4000, dtype=np.uint32)
            cpu.lib.adsp_read_pm_block(cpu.h, 0, 0x4000,
                                       out.ctypes.data_as(C.c_void_p))
        else:
            out = np.zeros(0x4000, dtype=np.uint16)
            cpu.lib.adsp_read_dm_block(cpu.h, 0, 0x4000,
                                       out.ctypes.data_as(C.c_void_p))
        return out

    def __iter__(self):
        return iter(self._read_block().tolist())

    def __getitem__(self, k):
        cpu = self._cpu
        if isinstance(k, slice):
            return self._read_block().tolist()[k]
        if self._pm:
            return int(cpu.lib.adsp_get_pm(cpu.h, int(k)))
        return int(cpu.lib.adsp_get_dm(cpu.h, int(k)))

    def __setitem__(self, k, v):
        cpu = self._cpu
        if isinstance(k, slice):
            start = k.start or 0
            vals = list(v)
            if self._pm:
                arr = np.asarray(vals, dtype=np.uint32)
                cpu.lib.adsp_write_pm_block(cpu.h, start, len(vals),
                                            arr.ctypes.data_as(C.c_void_p))
            else:
                arr = np.asarray(vals, dtype=np.uint16)
                cpu.lib.adsp_write_dm_block(cpu.h, start, len(vals),
                                            arr.ctypes.data_as(C.c_void_p))
            return
        if self._pm:
            cpu.lib.adsp_set_pm(cpu.h, int(k), int(v) & 0xFFFFFF)
        else:
            cpu.lib.adsp_set_dm(cpu.h, int(k), int(v) & 0xFFFF)


class NativeADSP2105:
    STATE_LEN = 125

    def __init__(self, lib):
        self.lib = lib
        self.h = lib.adsp_new()
        self._keep = []         # callbacks + bank buffers kept alive
        self._cbs = []
        self._chip_addr = {}    # id(bytes) -> base address
        self._pm_proxy = _MemProxy(self, True)
        self._dm_proxy = _MemProxy(self, False)

    # pm/dm behave like lists; whole-array assignment bulk-loads (the
    # snapshot/restore path in utils/state.py assigns full lists)
    @property
    def pm(self):
        return self._pm_proxy

    @pm.setter
    def pm(self, vals):
        self._pm_proxy[0:len(vals)] = vals

    @property
    def dm(self):
        return self._dm_proxy

    @dm.setter
    def dm(self, vals):
        self._dm_proxy[0:len(vals)] = vals

    def __del__(self):
        try:
            if self.h:
                self.lib.adsp_free(self.h)
                self.h = None
        except Exception:
            pass

    # -- board -----------------------------------------------------------
    def config_board(self, hw, read_port, write_port, set_bank):
        cb_r = native.READ_PORT(lambda: read_port() & 0xFFFF)
        cb_w = native.WRITE_PORT(lambda v: write_port(v))
        cb_b = native.SET_BANK(lambda linear: set_bank(linear))
        self._cbs = [cb_r, cb_w, cb_b]
        self.lib.adsp_config_board(self.h, int(hw), cb_r, cb_w, cb_b)

    def set_bank_window(self, mem, pos):
        if mem is None:
            self.lib.adsp_set_bank_window(self.h, None, 0)
            return
        key = id(mem)
        addr = self._chip_addr.get(key)
        if addr is None:
            b = bytes(mem)
            self._keep.append(b)
            addr = C.cast(C.c_char_p(b), C.c_void_p).value
            self._chip_addr[key] = addr
        self.lib.adsp_set_bank_window(
            self.h, C.c_void_p(addr + pos), len(mem) - pos)

    @property
    def autobuffer(self):
        out = np.zeros(3, dtype=np.int32)
        self.lib.adsp_get_autobuffer(self.h, out.ctypes.data_as(C.c_void_p))
        base = int(out[0])
        return SimpleNamespace(base=None if base < 0 else base,
                               length=int(out[1]), step=int(out[2]))

    def clear_autobuffer(self):
        self.lib.adsp_set_autobuffer(self.h, -1, 0, 1)

    def set_autobuffer(self, base, length, step):
        self.lib.adsp_set_autobuffer(
            self.h, -1 if base is None else int(base), int(length), int(step))

    def set_speedup(self, kind, entry=0, exit_pc=0, geom=()):
        """Arm (kind > 0) or disarm (kind <= 0) the decoder accelerator
        (emu/speedup.py; native/src/adsp2105.cpp accelRun)."""
        arr = np.asarray(list(geom) + [0] * (8 - len(geom)), dtype=np.uint16)
        self.lib.adsp_set_speedup(self.h, int(kind), int(entry), int(exit_pc),
                                  arr.ctypes.data_as(C.c_void_p), len(geom))

    def accel_run(self, kind, geom):
        """Run one accelerator region directly on the current DM/PM state
        (unit-test entry)."""
        arr = np.asarray(list(geom), dtype=np.uint16)
        self.lib.adsp_accel_run(self.h, int(kind),
                                arr.ctypes.data_as(C.c_void_p), len(geom))

    def read_dm_strided(self, base, step, n):
        out = np.zeros(n, dtype=np.uint16)
        self.lib.adsp_read_dm_strided(self.h, int(base), int(step), int(n),
                                      out.ctypes.data_as(C.c_void_p))
        return out

    # -- execution --------------------------------------------------------
    def _check_reset(self):
        if self.lib.adsp_take_reset_request(self.h):
            raise rd.ResetError("ROM-initiated reset")

    def run(self, max_steps):
        n = self.lib.adsp_run(self.h, int(max_steps))
        self._check_reset()
        return n

    def step(self):
        ok = self.lib.adsp_step(self.h) != 0
        self._check_reset()
        return ok

    def invoke_irq(self, which=2, indx=0, max_steps=4_000_000):
        n = self.lib.adsp_invoke_irq(self.h, which, indx, int(max_steps))
        self._check_reset()
        return n

    def reset(self):
        self.lib.adsp_reset(self.h)

    def rword_pgm(self, addr):
        return int(self.lib.adsp_rword_pgm(self.h, addr & 0xFFFF))

    # -- state ------------------------------------------------------------
    def state_vec(self):
        out = np.zeros(self.STATE_LEN, dtype=np.uint64)
        self.lib.adsp_get_state(self.h, out.ctypes.data_as(C.c_void_p))
        return [int(x) for x in out]

    def load_state_vec(self, v):
        arr = np.asarray([int(x) & ((1 << 64) - 1) for x in v],
                         dtype=np.uint64)
        self.lib.adsp_set_state(self.h, arr.ctypes.data_as(C.c_void_p))

    def _state(self):
        return self.state_vec()

    # -- attribute views (debugger display, board patch logic) ------------
    @property
    def pc(self):
        return int(self.lib.adsp_get_pc(self.h))

    @pc.setter
    def pc(self, v):
        self.lib.adsp_set_pc(self.h, int(v) & 0xFFFF)

    @property
    def stopped(self):
        return self.lib.adsp_stopped(self.h) != 0

    @stopped.setter
    def stopped(self, v):
        self.lib.adsp_set_stopped(self.h, 1 if v else 0)

    @property
    def core(self):
        v = self._state()
        names = ("ax0", "ax1", "ay0", "ay1", "ar", "af", "mx0", "mx1",
                 "my0", "my1", "mr", "mf", "si", "se", "sb", "sr")
        return SimpleNamespace(**dict(zip(names, v[:16])))

    @property
    def i(self):
        return self._state()[32:40]

    @property
    def m(self):
        v = self._state()[40:48]
        return [x - (1 << 32) if x & 0x80000000 else x for x in v]

    @property
    def l(self):
        return self._state()[48:56]

    @property
    def astat(self):
        return self._state()[62]

    @property
    def mstat(self):
        return self._state()[64]

    @property
    def sstat(self):
        return self._state()[63]

    @property
    def imask(self):
        return self._state()[112]

    @property
    def cntr(self):
        return self._state()[61]


def make_native_cpu():
    """Create a native CPU.  Raises when the native library does not build
    or load."""
    return NativeADSP2105(native.get_lib())
