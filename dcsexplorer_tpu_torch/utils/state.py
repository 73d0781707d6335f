"""Decoder state checkpoint/resume.

The reference has no checkpointing (SURVEY.md §5) — resume means re-boot and
replay.  Here the decoder's state is a small pure snapshot (channel array,
mixer levels, overlap buffer, data-port machine), so sessions can be
suspended, persisted, and resumed exactly — including mid-stream (the bit
cursor is part of the snapshot).

The port's copy of ``dcsexplorer_tpu/utils/state.py``, over the port's
``refdec`` (``ReferenceDecoder``, ``Pointer``, ``PaddedView``,
``BitReader``) and ``emu.board.EmulatedDecoder``.  A snapshot holds only
plain Python values, so one taken by either package restores into the
other's decoder and continues bit-exact.
"""

import pickle

from ..refdec import decoder as rd
from ..refdec.bitreader import BitReader


def _stream_chip(dec, st):
    """Identify which ROM chip a stream's memory belongs to (None if the
    stream is standalone)."""
    if st.mem is None or dec.rom_set is None:
        return None
    raw = st.mem.mem if isinstance(st.mem, rd.PaddedView) else st.mem
    for i, chip in enumerate(dec.rom_set.chips):
        if chip is raw:
            return i
    return None


def snapshot(dec: rd.ReferenceDecoder):
    """Capture the complete decode state (excluding ROM/stream memory,
    captured as references by stream id)."""
    chans = []
    for ch in dec.channels:
        st = ch.stream
        chans.append(dict(
            track=(ch.track_ptr.pos, ch.track_ptr.chip) if ch.track_ptr else None,
            track_counter=ch.track_counter,
            next_track_type=ch.next_track_type,
            next_track_link=ch.next_track_link,
            stop=ch.stop,
            source_channel=ch.source_channel,
            mixer=[(m.cur_level, m.fade_target, m.fade_delta, m.fade_steps)
                   for m in ch.mixer],
            max_override=ch.max_mixing_override,
            mixing_multiplier=ch.mixing_multiplier,
            timer=(ch.host_event_timer.data, ch.host_event_timer.interval,
                   ch.host_event_timer.counter),
            channel_volume=ch.channel_volume,
            loop_stack=[(c, p.pos, p.chip) for (c, p) in ch.loop_stack],
            stream=dict(
                header_pos=st.header_pos, header_len=st.header_len,
                start_pos=st.start_pos, header=list(st.header),
                band_type=list(st.band_type), frame_counter=st.frame_counter,
                num_frames=st.num_frames, loop_counter=st.loop_counter,
                bit=(st.bit.pos, st.bit.buf, st.bit.nbits) if st.bit else None,
                has_mem=st.mem is not None,
                chip=_stream_chip(dec, st),
            ),
        ))
    return dict(
        os_version=dec.os_version, hw_version=dec.hw_version,
        nominal_version=dec.nominal_version, game_id=dec.game_id,
        state=dec.state, mode_sample_counter=dec.mode_sample_counter,
        bong_count=dec.bong_count,
        bong=(dec.bong.cycles, dec.bong.envelope_samples,
              dec.bong.sign_samples, dec.bong.level, dec.bong.sign),
        frame_buffer=list(dec.frame_buffer),
        output_buffer=list(dec.output_buffer),
        overlap=list(dec.overlap),
        nominal_volume=dec.nominal_volume,
        volume_multiplier=dec.volume_multiplier,
        channel_mask=dec.channel_mask,
        variables=list(dec.variables),
        command_queue=list(dec.command_queue),
        data_port_queue=list(dec.data_port_queue),
        last_data_port_byte=dec.last_data_port_byte,
        data_port_word=dec.data_port_word,
        data_port_ext=dec.data_port_ext,
        n_data_port_bytes=dec.n_data_port_bytes,
        data_port_timeout=dec.data_port_timeout,
        default_volume=dec.default_volume,
        reported_version=dec.reported_version,
        channels=chans,
    )


def restore(dec: rd.ReferenceDecoder, snap, stream_mems=None):
    """Restore a snapshot into a decoder that has the same ROM set attached.

    stream_mems: per-channel byte buffers for standalone streams (index →
    mem); for ROM-based playback the buffers come from the attached RomSet.
    """
    dec.os_version = snap["os_version"]
    dec.hw_version = snap["hw_version"]
    dec.nominal_version = snap["nominal_version"]
    dec.game_id = snap["game_id"]
    dec.state = snap["state"]
    dec.mode_sample_counter = snap["mode_sample_counter"]
    dec.bong_count = snap["bong_count"]
    (dec.bong.cycles, dec.bong.envelope_samples, dec.bong.sign_samples,
     dec.bong.level, dec.bong.sign) = snap["bong"]
    dec.frame_buffer = list(snap["frame_buffer"])
    dec.output_buffer = list(snap["output_buffer"])
    dec.overlap = list(snap["overlap"])
    dec.nominal_volume = snap["nominal_volume"]
    dec.volume_multiplier = snap["volume_multiplier"]
    dec.channel_mask = snap["channel_mask"]
    dec.variables = list(snap["variables"])
    dec.command_queue = list(snap["command_queue"])
    dec.data_port_queue = list(snap["data_port_queue"])
    dec.last_data_port_byte = snap["last_data_port_byte"]
    dec.data_port_word = snap["data_port_word"]
    dec.data_port_ext = snap["data_port_ext"]
    dec.n_data_port_bytes = snap["n_data_port_bytes"]
    dec.data_port_timeout = snap["data_port_timeout"]
    dec.default_volume = snap["default_volume"]
    dec.reported_version = snap["reported_version"]

    for i, cs in enumerate(snap["channels"]):
        ch = dec.channels[i]
        if cs["track"] is not None:
            pos, chip = cs["track"]
            ch.track_ptr = rd.Pointer(dec.rom_set.chips[chip], pos, chip)
        else:
            ch.track_ptr = None
        ch.track_counter = cs["track_counter"]
        ch.next_track_type = cs["next_track_type"]
        ch.next_track_link = cs["next_track_link"]
        ch.stop = cs["stop"]
        ch.source_channel = cs["source_channel"]
        for m, mv in zip(ch.mixer, cs["mixer"]):
            (m.cur_level, m.fade_target, m.fade_delta, m.fade_steps) = mv
        ch.max_mixing_override = cs["max_override"]
        ch.mixing_multiplier = cs["mixing_multiplier"]
        (ch.host_event_timer.data, ch.host_event_timer.interval,
         ch.host_event_timer.counter) = cs["timer"]
        ch.channel_volume = cs["channel_volume"]
        ch.loop_stack = [
            [c, rd.Pointer(dec.rom_set.chips[chip], pos, chip)]
            for (c, pos, chip) in cs["loop_stack"]]
        st = ch.stream
        ss = cs["stream"]
        st.header_pos = ss["header_pos"]
        st.header_len = ss["header_len"]
        st.start_pos = ss["start_pos"]
        st.header = list(ss["header"])
        st.band_type = list(ss["band_type"])
        st.frame_counter = ss["frame_counter"]
        st.num_frames = ss["num_frames"]
        st.loop_counter = ss["loop_counter"]
        if ss["has_mem"]:
            if stream_mems is not None and i in stream_mems:
                mem = stream_mems[i]
                if not isinstance(mem, rd.PaddedView):
                    mem = rd.PaddedView(mem)
                st.mem = mem
            elif ss.get("chip") is not None and dec.rom_set is not None:
                st.mem = rd.PaddedView(dec.rom_set.chips[ss["chip"]])
        if ss["bit"] is not None:
            b = BitReader(st.mem, ss["bit"][0])
            b.buf, b.nbits = ss["bit"][1], ss["bit"][2]
            st.bit = b
        else:
            st.bit = None
    return dec


def save(dec, path):
    with open(path, "wb") as f:
        pickle.dump(snapshot(dec), f)


def load(dec, path, stream_mems=None):
    with open(path, "rb") as f:
        return restore(dec, pickle.load(f), stream_mems=stream_mems)


# ----------------------------------------------------------------------
# Emulated-backend checkpointing: the architectural CPU state plus the
# board registers fully determine the firmware's progress, so an emulator
# session snapshots/restores exactly as the native one does.

def snapshot_emulated(dec):
    """Snapshot an emu.board.EmulatedDecoder (CPU + memories + board)."""
    base = snapshot(dec)
    cpu = dec.cpu
    base["emu"] = dict(
        cpu_state=list(cpu.state_vec()),
        pm=list(cpu.pm),
        dm=list(cpu.dm),
        stopped=cpu.stopped,
        bank_pos=dec.bank_pos,
        bank_chip=next((i for i, c in enumerate(dec.rom_set.chips)
                        if c is dec.bank_mem), None)
        if dec.rom_set is not None else None,
        autobuffer=(dec.autobuffer.base, dec.autobuffer.length,
                    dec.autobuffer.step),
        main_loop_entry=dec.main_loop_entry,
        master_volume_addr=dec.master_volume_addr,
    )
    return base


def restore_emulated(dec, snap, stream_mems=None):
    """Restore an emulator snapshot (decoder must have the same ROM set)."""
    restore(dec, snap, stream_mems=stream_mems)
    e = snap["emu"]
    cpu = dec.cpu
    cpu.load_state_vec(e["cpu_state"])
    cpu.pm = list(e["pm"])
    cpu.dm = list(e["dm"])
    cpu.stopped = e["stopped"]
    dec.bank_pos = e["bank_pos"]
    dec.bank_mem = (dec.rom_set.chips[e["bank_chip"]]
                    if e["bank_chip"] is not None and dec.rom_set is not None
                    else None)
    (dec.autobuffer.base, dec.autobuffer.length,
     dec.autobuffer.step) = e["autobuffer"]
    dec.main_loop_entry = e["main_loop_entry"]
    dec.master_volume_addr = e["master_volume_addr"]
    if getattr(dec, "native_cpu", False):
        # re-arm the native board: callbacks, window, captured autobuffer
        dec.cpu.config_board(
            dec.hw_version, dec._read_data_port,
            lambda v: dec.host.receive_data_port(v & 0xFF),
            dec._set_rom_bank)
        dec.cpu.set_bank_window(dec.bank_mem, dec.bank_pos)
        dec.cpu.set_autobuffer(*e["autobuffer"])
