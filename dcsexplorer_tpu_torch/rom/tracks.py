"""Track-program introspection: track info and timing, stream listing.

The port's copy of the part of ``dcsexplorer_tpu/rom/tracks.py`` that the
session path needs: ``TrackInfo``, ``get_track_info`` (loop-aware timing)
and ``list_streams``.  The reference lists streams through its decompiler;
here a walker that knows only each opcode's operand layout (which varies by
OS version for opcode $04) finds the Play opcodes, reading the same bytes
in the same order.  The decompiler and explainer come with the explorer's
port.  Semantics mirror the reference's tooling (DCSDecoder.cpp:671-1293).
"""

from dataclasses import dataclass

from ..refdec.decoder import OS93A


@dataclass
class TrackInfo:
    address: int = 0
    channel: int = 0
    type: int = 0
    defer_code: int = 0xFFFF
    time: int = 0          # frames (7.68 ms each)
    looping: bool = False


def get_track_info(rom_set, os_version, track_no):
    """Track metadata + static playback-time analysis
    (reference: DCSDecoder.cpp:671-883).  Returns TrackInfo or None."""
    if track_no >= rom_set.n_tracks:
        return None
    addr = rom_set.track_index_u24(track_no)
    if (addr & 0xFF0000) == 0xFF0000:
        return None
    p = rom_set.make_pointer(addr)
    ttype = p.u8()
    ch = p.u8()
    if ch > 7:
        return None

    ti = TrackInfo(address=addr, channel=ch, type=ttype)
    done = False
    if ttype in (2, 3):
        ti.defer_code = p.u16()
        done = True
    elif ttype != 1:
        return None

    # loop-aware time accumulation: (program_time, looping_stream_time,
    # n_loops, looping)
    stack = [[0, 0, 1, False]]
    while not done:
        counter = p.u16()
        op = p.u8()
        if counter == 0xFFFF:
            stack[-1][3] = True
            stack[-1][0] += stack[-1][1]
            break
        stack[-1][0] += counter

        if op == 0x00:
            done = True
        elif op == 0x01:
            p.u8()
            stream = rom_set.make_pointer(p.u24())
            repeat = p.u8()
            stream_time = stream.u16()
            stack[-1][1] = stream_time if repeat == 0 else 0
        elif op == 0x0E:
            n = p.u8()
            stack.append([0, 0, n, n == 0])
        elif op == 0x0F:
            if len(stack) > 1:
                t, _, n, looping = stack.pop()
                stack[-1][0] += (1 if looping else n) * t
                if looping:
                    stack[-1][3] = True
                    done = True
        elif op == 0x0D:
            pass
        elif op in (0x02, 0x05):
            p.pos += 1
        elif op in (0x03, 0x06, 0x07, 0x08, 0x09, 0x11, 0x12):
            p.pos += 2
        elif op in (0x0A, 0x0B, 0x0C):
            p.pos += 4
        elif op == 0x04:
            p.pos += 3 if os_version == OS93A else 1

    while len(stack) > 1:
        t, _, n, looping = stack.pop()
        stack[-1][0] += (1 if n == 0 else n) * t
        if looping:
            stack[-1][3] = True

    ti.time = stack[0][0]
    ti.looping = stack[0][3]
    return ti


# operand bytes per opcode (decompile_track's layouts); $04 depends on the
# OS version and $01 (Play) is read field by field
_OPERANDS = {0x00: 0, 0x02: 1, 0x03: 2, 0x05: 1, 0x06: 2, 0x07: 2, 0x08: 2,
             0x09: 2, 0x0A: 4, 0x0B: 4, 0x0C: 4, 0x0D: 0, 0x0E: 1, 0x0F: 0,
             0x10: 2, 0x11: 4, 0x12: 4}


def _played_streams(rom_set, os_version, track_no):
    """Stream addresses of a type-1 track's Play opcodes, in program order
    (the opcodes decompile_track yields, up to the same end)."""
    ti = get_track_info(rom_set, os_version, track_no)
    if ti is None or ti.type != 1:
        return []
    p = rom_set.make_pointer(ti.address)
    p.pos += 2
    out = []
    while True:
        delay = p.u16()
        op = p.u8()
        if op == 0x01:
            p.u8()
            out.append(p.u24())
            p.u8()
        elif op == 0x04:
            for _ in range(3 if os_version == OS93A else 1):
                p.u8()
        elif op in _OPERANDS:
            for _ in range(_OPERANDS[op]):
                p.u8()
        else:
            break                      # an invalid opcode ends the program
        if delay == 0xFFFF or op == 0x00:
            break
    return out


def list_streams(rom_set, os_version):
    """All stream addresses referenced from Play opcodes, ascending
    (reference: DCSDecoder.cpp:1248-1293)."""
    streams = set()
    for i in range(rom_set.n_tracks):
        streams.update(_played_streams(rom_set, os_version, i))
    return sorted(streams)
