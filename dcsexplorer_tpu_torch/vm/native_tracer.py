"""Native control tracer: the DCS runtime VM in C++ (native/src/tracer.cpp).

The port's copy of ``dcsexplorer_tpu/vm/native_tracer.py``.  One C call
traces N frames of the track VM, command queue, data-port protocol, fades
and volume, and returns the per-frame control vectors the device decode
consumes: either dense per-frame arrays (``trace_frames``, mapped onto a
bank's rows by ``assemble_controls_native``), rows already narrowed for
the device (``trace_rows``) or, for serving, each channel lane's linear
segments (``trace_segs``, and ``trace_segs_batch`` for a whole batch of
independent sessions); ``read_host_bytes`` returns the data-port bytes
sent to the host.  The C calls release the GIL (ctypes), so a trace
overlaps other Python threads.
"""

import ctypes as C

import numpy as np

from .. import native
from ..refdec import decoder as rd
from ..rom import tracks as rtracks


def _event_arrays(events_list):
    """{frame: [byte, ...]} dicts -> (frames int32, bytes uint8, [S+1]
    int32 prefix offsets of each dict's events), frames ascending within
    each dict."""
    ev_frames, ev_bytes, ev_off = [], [], [0]
    for events in events_list:
        for f in sorted((events or {}).keys()):
            for b in events[f]:
                ev_frames.append(f)
                ev_bytes.append(b & 0xFF)
        ev_off.append(len(ev_frames))
    return (np.asarray(ev_frames, dtype=np.int32),
            np.asarray(ev_bytes, dtype=np.uint8),
            np.asarray(ev_off, dtype=np.int32))


def _p(a):
    return a.ctypes.data_as(C.c_void_p)


# the batched segment trace's C entries by the base column's type: u16 for
# the wire of a bank under 64Ki rows, u32 for the wide wire
# (models/romplay.py)
_SEGS_BATCH = {np.dtype(np.uint16): "dcstr_trace_segs_batch",
               np.dtype(np.uint32): "dcstr_trace_segs32_batch"}


def _segs_rc(rc):
    """True on success, False when a lane overflows its segment table;
    raises on the other codes of dcstr_trace_segs(_batch)."""
    if rc == -4:
        return False
    if rc == -5:
        raise ValueError("a channel >= n_ch went live during the segment "
                         "trace: widen the lane count")
    if rc == -3:
        raise KeyError("traced stream address missing from the bank")
    if rc != 0:
        raise rd.ResetError(f"native trace fault ({rc})")
    return True


class NativeControlTracer:
    """Trace a ROM session natively.  Events are data-port bytes scheduled
    before given frame indices: {frame: [byte, ...]}.

    ``rom_set`` may instead be raw stream bytes for standalone playback
    (pass ``standalone_os``): the bytes become chip 0 and a stream loads by
    its offset through load_audio_stream.  The caller releases the native
    tracer with ``close``."""

    def __init__(self, rom_set, default_volume=0x67, standalone_os=None):
        lib = native.get_lib()
        self._lib = lib
        self._bufs = []
        if standalone_os is not None:
            self.rom_set = None
            self._h = lib.dcstr_create(int(standalone_os), 0, 0, 0x0106,
                                       int(default_volume))
            buf = bytes(rom_set)
            self._bufs.append(buf)
            lib.dcstr_add_chip(self._h, 0, buf, len(buf))
            lib.dcstr_set_catalog(self._h, 0, 0, 0,
                                  21 if standalone_os == rd.OS95 else 20)
            return
        self.rom_set = rom_set
        self._h = lib.dcstr_create(
            int(rom_set.os_version), int(rom_set.game_id == "TOTAN"),
            int(rom_set.nominal_version or 0), 0x0106, int(default_volume))
        for i, chip in enumerate(rom_set.chips):
            if chip is None:
                continue
            mem = chip.mem if isinstance(chip, rd.PaddedView) else chip
            buf = bytes(mem)
            self._bufs.append(buf)
            lib.dcstr_add_chip(self._h, i, buf, len(buf))
        lib.dcstr_set_catalog(
            self._h, int(rom_set._track_index), int(rom_set._indirect_index),
            int(rom_set.n_tracks), 21 if rom_set.hw_version == 3 else 20)

    def close(self):
        if self._h:
            self._lib.dcstr_destroy(self._h)
            self._h = None

    def soft_boot(self):
        self._lib.dcstr_soft_boot(self._h)

    def full_reset(self):
        """Fresh-session reset (a new decoder object's state).  The
        reference's soft_boot is a soft reboot that keeps tracks, streams
        and mixer fades running; independent sessions need this instead."""
        self._lib.dcstr_full_reset(self._h)

    def load_audio_stream(self, chno, addr, mixing_level=0x64,
                          loop_count=1):
        """Play the stream whose header starts at ROM address ``addr``."""
        self._lib.dcstr_load_stream(self._h, int(chno), int(addr),
                                    int(mixing_level), int(loop_count))

    def write_data_port(self, b):
        self._lib.dcstr_write_port(self._h, int(b) & 0xFF)

    def trace_frames(self, n, events=None):
        """Trace n frames.  Returns (stream_addr [n,8] int32 — u24 stream
        header address or -1, frame_idx [n,8], mix [n,8], vol_shift [n])."""
        evf, evb, _ = _event_arrays([events])
        out_s = np.zeros((n, 8), dtype=np.int32)
        out_f = np.zeros((n, 8), dtype=np.int32)
        out_m = np.zeros((n, 8), dtype=np.int32)
        out_v = np.zeros(n, dtype=np.int32)
        rc = self._lib.dcstr_trace(self._h, n, _p(evf), _p(evb), evf.size,
                                   _p(out_s), _p(out_f), _p(out_m),
                                   _p(out_v))
        if rc != 0:
            raise rd.ResetError(f"native trace fault ({rc})")
        return out_s, out_f, out_m, out_v

    def trace_rows(self, n, addr_tab, off_tab, out_rows, out_mix, out_vol,
                   events=None):
        """Trace n frames and write device-ready controls in place: trace,
        row assembly and u16/u8 narrowing in one C pass
        (dcstr_trace_rows in native/src/tracer.cpp).

        addr_tab/off_tab: the sorted stream table from stream_row_table.
        out_rows/out_mix: C-contiguous uint16 [n, 8]; out_vol: uint8 [n].
        Raises ValueError on a row id past u16 (a bank of 64Ki rows or
        more).
        """
        evf, evb, _ = _event_arrays([events])
        rc = self._lib.dcstr_trace_rows(
            self._h, n, _p(evf), _p(evb), evf.size, _p(addr_tab),
            _p(off_tab), len(addr_tab), _p(out_rows), _p(out_mix),
            _p(out_vol))
        if rc == -3:
            raise KeyError("traced stream address missing from the bank")
        if rc == -6:
            raise ValueError("a traced row id does not fit u16: a bank of "
                             "64Ki rows or more needs the segment trace")
        if rc != 0:
            raise rd.ResetError(f"native trace fault ({rc})")

    def trace_segs(self, n, addr_tab, off_tab, out_f0, out_base,
                   out_slope, out_mixv, out_vol, events=None):
        """Trace n frames and write each channel lane's linear segments
        ``row[t] = base + slope*(t-f0)`` (constant mix) in place.

        out_f0/out_base/out_mixv: C-contiguous uint16 [n_ch, E];
        out_slope: uint8 [n_ch, E]; out_vol: uint8 [n].  Unused f0 entries
        are left $FFFF.  Returns True, or False if a lane needs more than E
        segments.  The segmentation is models/romplay.compress_controls'.
        """
        evf, evb, _ = _event_arrays([events])
        n_ch, E = out_f0.shape
        return _segs_rc(self._lib.dcstr_trace_segs(
            self._h, n, _p(evf), _p(evb), evf.size, _p(addr_tab),
            _p(off_tab), len(addr_tab), n_ch, E, _p(out_f0), _p(out_base),
            _p(out_slope), _p(out_mixv), _p(out_vol)))

    def trace_segs_batch(self, n_frames, addr_tab, off_tab, out_f0,
                         out_base, out_slope, out_mixv, out_vol,
                         events_list):
        """Trace a batch of independent sessions in one C call: session b
        is fully reset (a fresh decoder's state) and traced on this handle,
        its segments written into row b of the batch arrays.

        out_f0/out_mixv: C-contiguous uint16 [S, n_ch, E]; out_base: the
        same, uint16 or (the wide wire's) uint32; out_slope: uint8
        [S, n_ch, E]; out_vol: uint8 [S, n_frames].
        events_list: one {frame: [byte, ...]} dict per session.
        Returns True, or False if any lane overflows E segments.
        """
        S, n_ch, E = out_f0.shape
        if len(events_list) != S or out_vol.shape != (S, n_frames):
            raise ValueError(f"{len(events_list)} event dicts and volume "
                             f"{out_vol.shape} for {S} sessions of "
                             f"{n_frames} frames")
        if out_base.dtype not in _SEGS_BATCH:
            raise ValueError(f"out_base is {out_base.dtype}: the segment "
                             "trace writes uint16 or uint32 row ids")
        entry = getattr(self._lib, _SEGS_BATCH[out_base.dtype])
        for a, dt in ((out_f0, np.uint16), (out_base, out_base.dtype),
                      (out_slope, np.uint8), (out_mixv, np.uint16)):
            if a.shape != (S, n_ch, E) or a.dtype != dt \
                    or not a.flags.c_contiguous:
                raise ValueError("segment tables must be C-contiguous "
                                 f"{np.dtype(dt)} [{S}, {n_ch}, {E}]")
        if out_vol.dtype != np.uint8 or not out_vol.flags.c_contiguous:
            raise ValueError("out_vol must be C-contiguous uint8")
        evf, evb, evo = _event_arrays(events_list)
        return _segs_rc(entry(
            self._h, S, n_frames, _p(evo), _p(evf), _p(evb), _p(addr_tab),
            _p(off_tab), len(addr_tab), n_ch, E, _p(out_f0), _p(out_base),
            _p(out_slope), _p(out_mixv), _p(out_vol)))

    def read_host_bytes(self, cap=1 << 16):
        """The data-port bytes the runtime sent to the host so far (at most
        cap): the native counterpart of a Python tracer's ``host.rx``."""
        out = np.zeros(cap, dtype=np.uint8)
        n = self._lib.dcstr_read_host(self._h, _p(out), cap)
        return bytes(out[:n].tobytes())


def stream_row_table(rom_set, bank):
    """Sorted (addr [n] int64, row offset [n] int32) table mapping every
    bank stream's u24 linear address to its first bank row; the segment
    trace binary-searches it in C per traced voice-frame."""
    pairs = {}
    for linear in rtracks.list_streams(rom_set, rom_set.os_version):
        ptr = rom_set.make_pointer(linear)
        mem = ptr.mem.mem if isinstance(ptr.mem, rd.PaddedView) else ptr.mem
        pairs[int(linear)] = int(bank.offsets[(id(mem), ptr.pos)])
    addrs = np.asarray(sorted(pairs), dtype=np.int64)
    offs = np.asarray([pairs[a] for a in addrs.tolist()], dtype=np.int32)
    return addrs, offs


def assemble_controls_native(rom_set, bank, out_s, out_f, out_m):
    """Map a native trace (``trace_frames``) onto a StreamBank's rows.

    Returns (rows [T, 8] int32, mix [T, 8] int32): the arrays
    models/pipeline.assemble_controls derives from the Python tracer."""
    T_ = out_s.shape[0]
    uniq = [int(a) for a in np.unique(out_s) if a >= 0]
    if not uniq:
        return (np.zeros((T_, 8), dtype=np.int32),
                np.where(out_s >= 0, out_m, 0).astype(np.int32))
    offs = []
    for addr in uniq:
        ptr = rom_set.make_pointer(addr)
        mem = ptr.mem.mem if isinstance(ptr.mem, rd.PaddedView) else ptr.mem
        offs.append(bank.offsets[(id(mem), ptr.pos)])
    addrs = np.asarray(uniq, dtype=np.int64)
    offs = np.asarray(offs, dtype=np.int64)
    flat = out_s.reshape(-1).astype(np.int64)
    active = flat >= 0
    idx = np.searchsorted(addrs, np.where(active, flat, addrs[0]))
    rows = (offs[idx] + out_f.reshape(-1)) * active
    rows = rows.reshape(T_, 8).astype(np.int32)
    mix = np.where(out_s >= 0, out_m, 0).astype(np.int32)
    return rows, mix
