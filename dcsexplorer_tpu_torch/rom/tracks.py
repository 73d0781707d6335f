"""Track-program introspection: info/timing, decompiler, explainer, stream
listing, deferred-indirect tables.

The port's copy of ``dcsexplorer_tpu/rom/tracks.py``.

Host-side static analysis of track byte-code programs, mirroring the
reference's tooling semantics (DCSDecoder.cpp:671-1475): nested/infinite loop
timing, the per-opcode operand layouts (which vary by OS version for opcodes
0x04/0x06), and the DI-table reachability inference.
"""

from dataclasses import dataclass, field

from ..refdec.decoder import OS93A


@dataclass
class TrackInfo:
    address: int = 0
    channel: int = 0
    type: int = 0
    defer_code: int = 0xFFFF
    time: int = 0          # frames (7.68 ms each)
    looping: bool = False


@dataclass
class Opcode:
    offset: int = 0
    nesting_level: int = 0
    loop_parent: int = -1
    delay_count: int = 0
    opcode: int = 0
    operands: bytes = b""
    desc: str = ""
    hex_desc: str = ""


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


def decompile_track(rom_set, os_version, track_no):
    """Decompile a type-1 track program into Opcode records
    (reference: DCSDecoder.cpp:885-1135)."""
    ti = get_track_info(rom_set, os_version, track_no)
    if ti is None or ti.type != 1:
        return []
    start = rom_set.make_pointer(ti.address)
    p = start.clone()
    p.pos += 2

    out = []
    loop_stack = []
    done = False
    while not done:
        ele = Opcode()
        ele.nesting_level = len(loop_stack)
        if loop_stack:
            ele.loop_parent = loop_stack[-1]
        ele.offset = p.pos - start.pos
        ele.delay_count = p.u16()
        if ele.delay_count == 0xFFFF:
            done = True
        ele.opcode = op = p.u8()
        opbytes = f"{ele.delay_count:04X} {op:02X}"
        operand_start = p.pos

        instr = ""
        if op == 0x00:
            instr = "End;"
            done = True
        elif op == 0x01:
            ch = p.u8()
            stream = p.u24()
            repeat = p.u8()
            opbytes += f" {ch:02X} {stream:06X} {repeat:02X}"
            tag = "" if ch == ti.channel else f"channel {ch},"
            if repeat == 0:
                instr = f"Play({tag}stream ${stream:06X}, repeat forever);"
            elif repeat == 1:
                instr = f"Play({tag}stream ${stream:06X});"
            else:
                instr = f"Play({tag}stream ${stream:06X}, repeat {repeat});"
        elif op == 0x02:
            ch = p.u8()
            opbytes += f" {ch:02X}"
            instr = f"Stop(channel {ch});"
        elif op == 0x03:
            n = p.u16()
            opbytes += f" {n:04X}"
            instr = f"Queue(track ${n:X});"
        elif op == 0x04:
            if os_version == OS93A:
                b = p.u8()
                cnt = p.u16()
                opbytes += f" {b:02X} {cnt:04X}"
                instr = f"SetChannelTimer(byte ${b:02X}, counter ${cnt:04X});"
            else:
                b = p.u8()
                opbytes += f" {b:02X}"
                instr = f"WriteDataPort(byte ${b:02X});"
        elif op == 0x05:
            ch = p.u8()
            opbytes += f" {ch:02X}"
            instr = f"StartDeferred(channel {ch});"
        elif op == 0x06:
            idx = p.u8()
            val = p.u8()
            opbytes += f" {idx:02X} {val:02X}"
            instr = f"SetVariable(var ${idx:02X}, value ${val:02X});"
        elif op in (0x07, 0x08, 0x09):
            ch = p.u8()
            level = p.u8()
            opbytes += f" {ch:02X} {level:02X}"
            tag = "" if ch == ti.channel else f"channel {ch}, "
            verb = {7: "level", 8: "increase", 9: "decrease"}[op]
            instr = f"SetMixingLevel({tag}{verb} {level});"
        elif op in (0x0A, 0x0B, 0x0C):
            ch = p.u8()
            level = p.u8()
            steps = p.u16()
            opbytes += f" {ch:02X} {level:02X} {steps:04X}"
            tag = "" if ch == ti.channel else f"channel {ch}, "
            verb = {0x0A: "level", 0x0B: "increase", 0x0C: "decrease"}[op]
            instr = f"SetMixingLevel({tag}{verb} {level}, steps {steps});"
        elif op == 0x0D:
            instr = "NOP;"
        elif op == 0x0E:
            cnt = p.u8()
            opbytes += f" {cnt:02X}"
            instr = f"Loop ({cnt}) {{" if cnt else "Loop {"
            loop_stack.append(len(out))
        elif op == 0x0F:
            instr = "}"
            if loop_stack:
                loop_stack.pop()
            else:
                instr = "LoopEnd"
        elif op == 0x10:
            b0, b1 = p.u8(), p.u8()
            opbytes += f" {b0:02X} {b1:02X}"
            instr = f"Opcode$10(${b0:02X},${b1:02X});"
        elif op in (0x11, 0x12):
            b0, b1 = p.u8(), p.u8()
            w2 = p.u16()
            opbytes += f" {b0:02X} {b1:02X} {w2:04X}"
            instr = f"Opcode${op:02x}(${b0:02X},${b1:02X},${w2:04X});"
        else:
            instr = f"InvalidOpcode${op:02X};"
            done = True

        ele.operands = bytes(p.mem[operand_start:p.pos])
        ele.desc = instr
        ele.hex_desc = opbytes
        out.append(ele)
    return out


def explain_track(rom_set, os_version, track_no, line_prefix=""):
    """Human-readable track program listing
    (reference: DCSDecoder.cpp:1137-1231)."""
    ti = get_track_info(rom_set, os_version, track_no)
    if ti is None:
        return "[Invalid track]"
    if ti.type == 2:
        p = rom_set.make_pointer(ti.address)
        p.pos += 2
        return f"{line_prefix}Deferred (${p.u16():04x})"
    if ti.type == 3:
        p = rom_set.make_pointer(ti.address)
        p.pos += 2
        var_no = p.u8()
        table_no = p.u8()
        return f"{line_prefix}Deferred Indirect (${table_no:02x}[${var_no:02x}])"

    lines = []
    indent = ""
    for ele in decompile_track(rom_set, os_version, track_no):
        wait = ""
        if ele.delay_count == 0xFFFF:
            wait = "Wait(Forever) "
        elif ele.delay_count:
            wait = f"Wait({ele.delay_count}) "
        comment = "// " + ele.hex_desc
        if ele.opcode == 0x0F:
            if ele.delay_count and indent:
                lines.append(line_prefix + f"{indent + wait:<60}    {comment}")
                wait = ""
                comment = ""
            if indent:
                indent = indent[2:]
            else:
                comment += " Unmatched loop end opcode (0x0F)"
        lines.append(line_prefix + f"{indent + wait + ele.desc:<60}    {comment}")
        if ele.opcode == 0x0E:
            indent += "  "
    return "\n".join(lines)


def list_streams(rom_set, os_version):
    """All stream addresses referenced from Play opcodes, ascending
    (reference: DCSDecoder.cpp:1248-1293)."""
    streams = set()
    for i in range(rom_set.n_tracks):
        ti = get_track_info(rom_set, os_version, i)
        if ti is not None and ti.type == 1:
            for op in decompile_track(rom_set, os_version, i):
                if op.opcode == 0x01:
                    streams.add((op.operands[1] << 16)
                                | (op.operands[2] << 8) | op.operands[3])
    return sorted(streams)


@dataclass
class DeferredIndirectInfo:
    vars: list = field(default_factory=list)    # (var id, max value)
    tables: list = field(default_factory=list)  # (table id, [tracks], [vars])


def get_deferred_indirect_tables(rom_set, os_version):
    """Reachable DI tables + opcode-0x06 variable ranges
    (reference: DCSDecoder.cpp:1295-1475)."""
    var_range = {}
    table_vars = {}
    for i in range(rom_set.n_tracks):
        ti = get_track_info(rom_set, os_version, i)
        if ti is None:
            continue
        if ti.type == 1:
            for op in decompile_track(rom_set, os_version, i):
                if op.opcode == 0x06:
                    var_id, value = op.operands[0], op.operands[1]
                    var_range[var_id] = max(var_range.get(var_id, 0), value)
        elif ti.type == 3:
            var_id = (ti.defer_code >> 8) & 0xFF
            table_id = ti.defer_code & 0xFF
            table_vars.setdefault(table_id, set()).add(var_id)
            var_range.setdefault(var_id, 0)

    dii = DeferredIndirectInfo()
    if table_vars:
        max_table = max(table_vars)
        for table_id in range(max_table + 1):
            if table_id not in table_vars:
                continue
            size = max(var_range.get(v, 0) + 1 for v in table_vars[table_id])
            ofs = rom_set.indirect_index_u24(table_id)
            if (ofs & 0xFF0000) == 0xFF0000:
                continue
            p = rom_set.make_pointer(ofs)
            tracks = [p.u16() for _ in range(size)]
            dii.tables.append((table_id, tracks, sorted(table_vars[table_id])))
    dii.vars = sorted(var_range.items())
    return dii
