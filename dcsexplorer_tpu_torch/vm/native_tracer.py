"""Native control tracer: the DCS runtime VM in C++ (native/src/tracer.cpp).

The port's copy of the stream-playback part of
``dcsexplorer_tpu/vm/native_tracer.py``.  One C call traces N frames of
standalone stream playback (the track VM, mixing matrix, volume) and
returns the per-frame control vectors the device decode consumes.
"""

import ctypes as C

import numpy as np

from .. import native
from ..refdec import decoder as rd


class NativeControlTracer:
    """Trace standalone playback of raw stream bytes: the bytes become
    chip 0 and a stream loads by its offset through load_audio_stream.
    The caller releases the native tracer with ``close``."""

    def __init__(self, stream, default_volume=0x67, standalone_os=rd.OS94):
        lib = native.get_lib()
        self._lib = lib
        self._buf = bytes(stream)
        self._h = lib.dcstr_create(int(standalone_os), 0, 0, 0x0106,
                                   int(default_volume))
        lib.dcstr_add_chip(self._h, 0, self._buf, len(self._buf))
        lib.dcstr_set_catalog(self._h, 0, 0, 0,
                              21 if standalone_os == rd.OS95 else 20)

    def close(self):
        if self._h:
            self._lib.dcstr_destroy(self._h)
            self._h = None

    def soft_boot(self):
        self._lib.dcstr_soft_boot(self._h)

    def load_audio_stream(self, chno, addr, mixing_level=0x64,
                          loop_count=1):
        """Play the stream whose header starts at byte ``addr``."""
        self._lib.dcstr_load_stream(self._h, int(chno), int(addr),
                                    int(mixing_level), int(loop_count))

    def trace_frames(self, n):
        """Trace n frames.  Returns (stream_addr [n,8] int32 — u24 stream
        header address or -1, frame_idx [n,8], mix [n,8], vol_shift [n])."""
        out_s = np.zeros((n, 8), dtype=np.int32)
        out_f = np.zeros((n, 8), dtype=np.int32)
        out_m = np.zeros((n, 8), dtype=np.int32)
        out_v = np.zeros(n, dtype=np.int32)
        p = lambda a: a.ctypes.data_as(C.c_void_p)
        rc = self._lib.dcstr_trace(self._h, n, None, None, 0,
                                   p(out_s), p(out_f), p(out_m), p(out_v))
        if rc != 0:
            raise rd.ResetError(f"native trace fault ({rc})")
        return out_s, out_f, out_m, out_v
