"""ROM-driven playback on the card: command sessions, autoplay, and batched
session serving (the 1994+ and the 1993 families).

Counterpart of ``dcsexplorer_tpu/models/romplay.py``.  The host VM control
tracer (the Python ``ControlTracer`` for a single session, the native one
for a served batch) decides which bank row plays on which channel at what
mixing multiplier; the device half (``pipeline.SessionDecoder``) turns those
controls into PCM (``pipeline.SessionDecoder93`` for a 1993 ROM).  A
served batch of S sessions × T frames travels as one
uint8 control wire, per-lane linear segments plus the volume column
(``pack_controls_wire``), which ``segments94`` expands on the card into
dense per-frame rows, mixes and volume shifts.  The wire names a
segment's first bank row in 16 bits for a bank under 64Ki rows (the JAX
package's wire, byte for byte) and in 32 bits for a larger bank, under
2^24 rows (the wide wire, this package's own); ``wide_wire`` picks one
from the bank's row count.

Device stages of one served batch, each a hand-written kernel on CUDA
tensors (``ops/kernels.py``), its plain PyTorch version on CPU tensors:

    segments94 (wire -> rows, mix, vol) -> session_mix94 -> transform94_pcm
    with sid = session index (each session starts from a zero overlap state)

and for a 1993 ROM, segments94 -> decode93_pcm's session instance (the
session bank's rows mixed, transform and overlap resolve in one) likewise
(the wire does not depend on the family).

The entry points (``build_rom_bank``, ``play_session``, ``autoplay``,
``SessionServer``) run on the card unless the caller names another device.
Bit-exact with the JAX reference and the scalar decoder.
"""

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import kernels
from ..refdec import decoder as rd
from ..rom import tracks as rtracks
from ..utils.profiling import span
from ..vm import native_tracer as nt
from . import pipeline as pl
from .flatsweep import _device


def _chip_stream_ref(rom_set, linear):
    p = rom_set.make_pointer(linear)
    mem = p.mem.mem if isinstance(p.mem, rd.PaddedView) else p.mem
    return mem, p.pos


def build_rom_bank(rom_set, device="cuda"):
    """Prescan every stream the ROM's tracks play and decode them into a
    bank on ``device`` (the card unless given)."""
    bank = pl.StreamBank(rom_set.os_version)
    for linear in rtracks.list_streams(rom_set, rom_set.os_version):
        mem, pos = _chip_stream_ref(rom_set, linear)
        bank.add(mem, pos)
    return bank.decode_all(device)


# the bank rows each wire can name: under 64Ki (u16 base), under 2^24 (the
# wide wire's u32 base, which the kernel packs beside the u8 slope in one
# 32-bit word)
ROWS16_LIMIT, ROWS32_LIMIT = 1 << 16, 1 << 24


def wide_wire(n_rows):
    """Whether a bank of n_rows rows travels on the wide wire: False under
    64Ki rows, True from there to 2^24 - 1; raises beyond."""
    if n_rows >= ROWS32_LIMIT:
        raise ValueError(f"a bank of {n_rows} rows: the session wire names "
                         f"rows under 2^24")
    return n_rows >= ROWS16_LIMIT


def compress_controls(rows, mix, max_segments=255, wide=False):
    """Per-lane linear segments of dense controls (host numpy).

    A playing channel's bank row advances by 1 a frame (wrapping at loop
    points), an idle channel holds row 0, and the mix is piecewise
    constant, so each (session, channel) lane is a few segments
    ``row[t] = base + slope * (t - f0)`` with a constant mix.

    rows/mix: [S, T, C] integers, rows under 64Ki (under 2^24 where
    ``wide``).  Returns a dict of numpy arrays (f0 u16, base u16 or, where
    ``wide``, u32, slope u8, mixv u16, all [S, C, E]; unused f0 entries
    hold $FFFF), or None if a lane needs more than ``max_segments``
    segments.  The native trace emits the same segments (trace_segs).
    """
    rows = np.asarray(rows, np.int64)
    mix = np.asarray(mix, np.int64)
    S, T, C = rows.shape
    assert T < 0xFFFF and rows.max(initial=0) < (
        ROWS32_LIMIT if wide else ROWS16_LIMIT) \
        and mix.max(initial=0) < (1 << 16)
    d = rows[:, 1:] - rows[:, :-1]                      # [S, T-1, C]
    ok = (d == 0) | (d == 1)
    same_mix = mix[:, 1:] == mix[:, :-1]
    brk = ~ok | ~same_mix                               # segment starts at t
    brk[:, 1:] |= d[:, 1:] != d[:, :-1]                 # slope change
    seg_id = np.zeros((S, T, C), np.int64)
    np.cumsum(brk, axis=1, out=seg_id[:, 1:])
    n_seg = seg_id[:, -1] + 1                           # [S, C]
    E = int(n_seg.max())
    if E > max_segments:
        return None
    f0 = np.full((S, C, E), 0xFFFF, np.int64)
    is_start = np.ones((S, T, C), bool)
    is_start[:, 1:] = brk
    s_i, t_i, c_i = np.nonzero(is_start)
    e_i = seg_id[s_i, t_i, c_i]
    f0[s_i, c_i, e_i] = t_i
    base = np.zeros((S, C, E), np.int64)
    base[s_i, c_i, e_i] = rows[s_i, t_i, c_i]
    mixv = np.zeros((S, C, E), np.int64)
    mixv[s_i, c_i, e_i] = mix[s_i, t_i, c_i]
    # slope = the first step's delta inside the segment (0 for one-frame
    # segments: no step reads it); later steps are equal by construction
    slope = np.zeros((S, C, E), np.int64)
    in_seg = ~is_start[:, 1:]                           # step t-1 -> t stays
    s_j, t_j, c_j = np.nonzero(in_seg)
    slope[s_j, c_j, seg_id[s_j, t_j + 1, c_j]] = d[s_j, t_j, c_j]
    return dict(f0=f0.astype(np.uint16),
                base=base.astype(np.uint32 if wide else np.uint16),
                slope=slope.astype(np.uint8), mixv=mixv.astype(np.uint16))


# a wire's base column by the dtype of the segments' base: the u16 wire and
# the wide wire
_BASE_LE = {np.dtype(np.uint16): "<u2", np.dtype(np.uint32): "<u4"}


def pack_controls_wire(comp, vol):
    """A compressed control batch and its volume column as one uint8 wire:
    slope [S, C, E], vol [S, T], then f0, base and mixv [S, C, E] as
    little-endian u16, base as little-endian u32 where it is uint32 (the
    wide wire; host numpy)."""
    if comp["base"].dtype not in _BASE_LE:
        raise ValueError(f"base is {comp['base'].dtype}: the wire carries "
                         "uint16 or uint32 rows")
    vol = np.asarray(vol, np.uint8)
    parts = [comp["slope"].reshape(-1), vol.reshape(-1),
             comp["f0"].astype("<u2").view(np.uint8).reshape(-1),
             comp["base"].astype(_BASE_LE[comp["base"].dtype])
             .view(np.uint8).reshape(-1),
             comp["mixv"].astype("<u2").view(np.uint8).reshape(-1)]
    return np.concatenate(parts)


def unpack_controls_wire(buf, S, T, C, E):
    """Inverse of pack_controls_wire on a uint8 tensor, either wire (told by
    its length).  Returns (f0, base, slope, mixv [S, C, E], vol [S, T]),
    int32."""
    bw = kernels.wire_base_bytes(buf.numel(), S, T, C, E)
    if bw is None:
        raise ValueError(f"wire: shape ({buf.numel()},), expected "
                         f"({7 * S * C * E + S * T},) or "
                         f"({9 * S * C * E + S * T},)")
    n_par = S * C * E
    buf = buf.long()
    o = 0
    slope = buf[o:o + n_par].reshape(S, C, E); o += n_par
    vol = buf[o:o + S * T].reshape(S, T); o += S * T

    def le(n, width):
        w = buf[n:n + width * n_par].reshape(-1, width)
        word = w[:, 0]
        for i in range(1, width):
            word = word | (w[:, i] << 8 * i)
        return word.reshape(S, C, E)

    f0, base = le(o, 2), le(o + 2 * n_par, bw)
    mixv = le(o + (2 + bw) * n_par, 2)
    return tuple(a.int() for a in (f0, base, slope, mixv, vol))


def reconstruct_from_segments(f0, base, slope, mixv, n_frames):
    """Exact dense rows and mix from the segment tables: f0 ascends within
    a lane with unused entries at $FFFF, so the segment at frame t is
    ``count(f0 <= t) - 1`` (segment 0 starts at frame 0).

    f0/base/slope/mixv: [S, C, E] integer tensors.  Returns (rows
    [S, T, C], mix [S, T, C]), int32."""
    t = torch.arange(n_frames, device=f0.device)
    le = f0.long()[:, :, None, :] <= t[None, None, :, None]     # [S,C,T,E]
    e = (le.sum(-1) - 1).clamp(min=0)                           # [S,C,T]

    def pick(p):
        return torch.gather(p.long(), 2, e).transpose(1, 2)     # [S,T,C]

    tt = t[None, :, None]
    rows = pick(base) + pick(slope) * (tt - pick(f0))
    return rows.int(), pick(mixv).int()


def segments94_plain(wire, S, T, C, E):
    """Plain version of the segments94 kernel: the control wire (either) of
    S sessions × T frames × C channels with E segments a lane -> (rows
    [S*T, C], mix [S*T, C], vol [S*T]), int32 (unpack_controls_wire, then
    reconstruct_from_segments)."""
    f0, base, slope, mixv, vol = unpack_controls_wire(wire, S, T, C, E)
    rows, mix = reconstruct_from_segments(f0, base, slope, mixv, T)
    return rows.reshape(S * T, C), mix.reshape(S * T, C), vol.reshape(S * T)


def segments94(wire, S, T, C, E):
    """The control wire -> dense controls (see segments94_plain): plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if wire.device.type == "cpu":
        return segments94_plain(wire, S, T, C, E)
    return kernels.segments94(wire, S, T, C, E)


class SessionServer:
    """Batched, pipelined serving of independent ROM sessions: the "many
    cabinets, one chip" shape.

    The server owns a device-resident stream bank, one native runtime-VM
    handle and a prep thread.  The prep thread traces each batch's sessions
    in one GIL-releasing C call (``trace_segs_batch``; each session starts
    from a fresh decoder's state) and packs the control wire, while the card
    works on the batches before it.  The calling thread uploads the wire,
    enqueues the kernels and copies the result into pinned host memory
    without waiting; results come back in order.

    events: one dict per session, {frame_index: [port bytes...]}.  Each
    yielded batch is int16 PCM [n_sessions, n_frames * 240] (numpy), or
    ``reduce_fn``'s result fetched to the host: ``reduce_fn`` receives the
    decoder's words [S, n_frames * 240] (int32, u16 storage) on the device
    and returns a tensor.  A bank of 64Ki rows or more travels on the
    wide wire (``wide``), one of 2^24 or more is refused.

        with SessionServer(rom_set, n_sessions=64, n_frames=500) as srv:
            for pcm in srv.serve(batches_of_event_dicts):
                ...
    """

    def __init__(self, rom_set, n_sessions, n_frames, n_ch=8, seg_e=32,
                 depth=3, default_volume=0x67, bank=None, reduce_fn=None,
                 device="cuda"):
        dev = _device(device)
        if not 1 <= n_ch <= kernels.MAX_CHANNELS:
            raise ValueError(f"n_ch {n_ch}: expected 1..8")
        if not 1 <= seg_e <= kernels.MAX_SEGMENTS:
            raise ValueError(f"seg_e {seg_e}: expected 1..255")
        self.rom_set = rom_set
        self.n_sessions = n_sessions
        self.n_frames = n_frames
        self.n_ch = n_ch
        self.seg_e = seg_e
        self.depth = max(1, depth)
        self.reduce_fn = reduce_fn
        self.device = dev
        self.bank = bank if bank is not None else build_rom_bank(rom_set, dev)
        self.wide = wide_wire(self.bank.total_rows())
        self.decoder = pl.session_decoder(self.bank, dev)
        self._addr_tab, self._off_tab = nt.stream_row_table(rom_set,
                                                            self.bank)
        self._tracer = nt.NativeControlTracer(
            rom_set, default_volume=default_volume)
        self._ex_prep = ThreadPoolExecutor(1)
        S, T = n_sessions, n_frames
        self._sid = torch.arange(S, dtype=torch.int32, device=dev) \
            .repeat_interleave(T)

    # -- pipeline stages ------------------------------------------------
    def prepare(self, events_list):
        """The host half of one batch (the prep thread runs it): the VM
        trace of its sessions in one C call, and the control wire.  Returns
        (wire uint8 numpy, E).  A lane that overflows the segment table
        retries with a doubled one; E is a launch argument, so nothing is
        rebuilt."""
        if len(events_list) != self.n_sessions:
            raise ValueError(f"{len(events_list)} event dicts for "
                             f"{self.n_sessions} sessions")
        with span("dcs.serve.trace"):
            S, C, T = self.n_sessions, self.n_ch, self.n_frames
            while True:
                E = self.seg_e
                f0 = np.full((S, C, E), 0xFFFF, np.uint16)
                base = np.zeros((S, C, E),
                                np.uint32 if self.wide else np.uint16)
                slope = np.zeros((S, C, E), np.uint8)
                mixv = np.zeros((S, C, E), np.uint16)
                vol = np.zeros((S, T), np.uint8)
                ok = self._tracer.trace_segs_batch(
                    T, self._addr_tab, self._off_tab, f0, base, slope, mixv,
                    vol, events_list)
                if ok:
                    return pack_controls_wire(
                        dict(f0=f0, base=base, slope=slope, mixv=mixv),
                        vol), E
                if E >= kernels.MAX_SEGMENTS:
                    raise ValueError("a session lane exceeds 255 segments")
                self.seg_e = min(kernels.MAX_SEGMENTS, 2 * E)

    def decode_wire(self, wire, E):
        """The device half of one batch: the wire (uint8 tensor on the
        server's device) -> the batch's result on the device, int16 PCM
        [S, n_frames * 240] or reduce_fn's; each session starts from
        silence and a zero overlap state.  Spans: ``dcs.session`` around
        ``.expand`` (segments94), ``.decode`` and ``.reduce``."""
        S, C, T = self.n_sessions, self.n_ch, self.n_frames
        with span("dcs.session"):
            with span("dcs.session.expand"):
                rows, mix, vol = segments94(wire, S, T, C, E)
            with span("dcs.session.decode"):
                words = self.decoder(rows, mix, vol, self._sid) \
                    .reshape(S, T * 240)
            with span("dcs.session.reduce"):
                return (self.reduce_fn(words) if self.reduce_fn is not None
                        else pl.to_int16(words))

    def _enqueue(self, wire, E):
        """Upload a wire, enqueue the batch's kernels and the copy of its
        result into pinned host memory; returns (event, host tensor).  The
        wire (under 1 MB) uploads as fast from pageable memory as from
        pinned; the result (150 MB at session6's size) comes back ~20x
        faster into pinned memory (chip_smoke.py phase 9)."""
        buf = torch.from_numpy(wire)
        if self.device.type != "cpu":
            with span("dcs.serve.upload"):
                buf = buf.to(self.device)
        with span("dcs.serve.dispatch"):
            out = self.decode_wire(buf, E)
            if self.device.type == "cpu":
                return None, out
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return done, host

    # -- public surface -------------------------------------------------
    def serve(self, batches):
        """Serve an iterable of batches (each: n_sessions event dicts) and
        yield every batch's result, in order, as soon as it is on the host.
        At most ``depth`` batches are in flight (being traced, or queued on
        the card and not yet yielded).  The prep thread traces them one
        after another; a finished trace goes to the card at once, and a
        finished batch never waits for the traces behind it."""
        it = iter(batches)
        prep, flight = deque(), deque()
        more = True

        def refill():
            nonlocal more
            while more and len(prep) + len(flight) < self.depth:
                try:
                    events_list = next(it)
                except StopIteration:
                    more = False
                    return
                prep.append(self._ex_prep.submit(self.prepare, events_list))

        refill()
        while prep or flight:
            # wait for a trace only when nothing of ours is on the card
            while prep and (prep[0].done() or not flight):
                flight.append(self._enqueue(*prep.popleft().result()))
            done, host = flight.popleft()
            if done is not None:
                with span("dcs.serve.fetch"):
                    done.synchronize()
            refill()
            yield host.numpy()

    def serve_one(self, events_list):
        """One batch, synchronously."""
        return next(self.serve([events_list]))

    def close(self):
        self._ex_prep.shutdown()
        if self._tracer is not None:
            self._tracer.close()
            self._tracer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def play_session(rom_set, events, n_frames, bank=None, default_volume=0x67,
                 device="cuda"):
    """Run a command-driven session on ``device`` (the card unless given;
    a given bank's device otherwise).

    events: {frame_index: callable(decoder)}, e.g. writing data-port bytes.
    Returns (int16 PCM [n_frames * 240] numpy, the tracer)."""
    if bank is None:
        bank = build_rom_bank(rom_set, device)
    tracer = pl.ControlTracer()
    tracer.default_volume = default_volume
    tracer.load_rom_set(rom_set)
    tracer.soft_boot()
    tracer.trace_frames(n_frames, events=events)

    rows, mix, vol = pl.assemble_controls(tracer, bank)
    pcm, _ = pl.device_decode(pl.session_decoder(bank), rows, mix, vol)
    return pl.to_int16(pcm).reshape(-1).cpu().numpy(), tracer


def autoplay(rom_set, tracks=None, pad_frames=4, default_volume=0x67,
             max_frames_per_track=4000, return_tracer=False, device="cuda"):
    """Autoplay sweep on ``device`` (the card unless given): play every
    type-1 track once (one iteration of its outermost loop), one after
    another.  Returns (int16 PCM numpy, schedule) where schedule lists
    (track_no, start_frame, n_frames)."""
    os_v = rom_set.os_version
    if tracks is None:
        tracks = range(rom_set.n_tracks)
    plan = []
    for t in tracks:
        ti = rtracks.get_track_info(rom_set, os_v, t)
        if ti is not None and ti.type == 1 and ti.time > 0:
            plan.append((t, min(ti.time + pad_frames, max_frames_per_track)))

    bank = build_rom_bank(rom_set, device)
    events = {}
    schedule = []
    frame = 0
    for (t, dur) in plan:
        def make_event(track):
            def ev(dec):
                dec.clear_tracks()
                dec.write_data_port((track >> 8) & 0xFF)
                dec.write_data_port(track & 0xFF)
            return ev
        events[frame] = make_event(t)
        schedule.append((t, frame, dur))
        frame += dur
    total = frame + pad_frames

    pcm, tracer = play_session(rom_set, events, total, bank=bank,
                               default_volume=default_volume)
    if return_tracer:
        return pcm, schedule, tracer
    return pcm, schedule
