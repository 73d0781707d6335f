"""ControlTracer: the track byte-code VM run alone, numerics stubbed.

The benchmark's frozen copy of the port's tracer.  The VM itself lives
inside the scalar decoder (``decoder.py`` ``_exec_track``,
``irq2_handler``, the command queue and the boot state machine), because it
shares per-channel state with stream playback, as in the reference
(DCSDecoderNative.cpp:848-1228).

It runs the branchy runtime (commands, track programs, fades, volume,
stream lifecycle) with every per-sample computation skipped, and records
per-frame control vectors (which stream frame plays on which channel at
what mixing multiplier, plus the global volume shift) for the reference's
frame-parallel decode (``codec.py``).
"""

from . import decoder as rd


class ControlTracer(rd.ReferenceDecoder):
    """ReferenceDecoder with the numeric work stubbed out: runs the full VM
    (commands, track programs, fades, volume, stream lifecycle) and records
    per-frame control vectors for the device decode."""

    def __init__(self, host=None):
        super().__init__(host)
        self.trace_vol_shift = []
        self.trace_entries = []   # per frame: list of (ch, stream_key, frame_idx, mix)

    def _stream_key(self, st):
        mem = st.mem.mem if isinstance(st.mem, rd.PaddedView) else st.mem
        return (id(mem), st.header_pos - 2)

    def _decompress_frame(self, ch):
        return True

    def _decode_and_transform(self, vol_shift):
        entries = []
        for i in range(rd.MAX_CHANNELS):
            ch = self.channels[i]
            st = ch.stream
            if st.playing and st.num_frames > 0:
                frame_idx = (st.num_frames - st.frame_counter) % st.num_frames
                entries.append((i, self._stream_key(st), frame_idx,
                                ch.mixing_multiplier))
            self._decode_stream(i)
        self.trace_vol_shift.append(vol_shift)
        self.trace_entries.append(entries)

    def trace_frames(self, n, events=None):
        """Run n frames of the VM.  ``events`` maps frame index -> callable
        invoked before that frame (e.g. to write data-port bytes)."""
        for f in range(n):
            if events and f in events:
                events[f](self)
            while self.data_port_queue:
                self.irq2_handler()
            self.main_loop()
