"""Patch mode: import a prototype ROM into an editable RomSpec.

Counterpart of the reference compiler's --patch flow (reference:
DCSCompiler.cpp:63-235): every track program of the prototype is decompiled
into editable steps, streams are imported verbatim by address, and deferred-
indirect tables are carried over — so a script can replace individual
streams/tracks and regenerate a complete ROM set with everything else
byte-compatible.

The port's copy of ``dcsexplorer_tpu/compiler/patch.py``.
"""

from ..refdec import decoder as rd
from ..rom import tracks as rtracks
from . import romgen


def stream_name(addr):
    return f"S{addr:06X}"


def _extract_stream(rom_set, dec, addr):
    """Copy a stream's exact bytes out of the ROM (length via full decode)."""
    p = rom_set.make_pointer(addr)
    info = dec.get_stream_info(p.mem, p.pos)
    return bytes(p.mem[p.pos:p.pos + info["n_bytes"]])


def load_prototype(rom_set) -> romgen.RomSpec:
    """Decompile a loaded RomSet into a RomSpec for regeneration."""
    os_v = rom_set.os_version
    spec = romgen.RomSpec(os_version=os_v)
    spec.signature = rom_set.signature() or spec.signature
    spec.chip_size = rom_set.chip_sizes[0] or spec.chip_size
    spec.num_channels = rom_set.num_channels() or 6

    dec = rd.ReferenceDecoder()
    dec.load_rom_set(rom_set)
    dec.soft_boot()

    streams = {}
    for t in range(rom_set.n_tracks):
        ti = rtracks.get_track_info(rom_set, os_v, t)
        if ti is None:
            continue
        if ti.type in (2, 3):
            spec.tracks.append(romgen.TrackSpec(
                t, type=ti.type, channel=ti.channel, defer_code=ti.defer_code))
            continue
        steps = []
        for op in rtracks.decompile_track(rom_set, os_v, t):
            if op.opcode == 0x01:
                addr = ((op.operands[1] << 16) | (op.operands[2] << 8)
                        | op.operands[3])
                name = stream_name(addr)
                if name not in streams:
                    streams[name] = _extract_stream(rom_set, dec, addr)
                steps.append((op.delay_count, 0x01,
                              ("stream", op.operands[0], name,
                               op.operands[4])))
            else:
                steps.append((op.delay_count, op.opcode, bytes(op.operands)))
        spec.tracks.append(romgen.TrackSpec(t, type=1, channel=ti.channel,
                                            steps=steps))

    dii = rtracks.get_deferred_indirect_tables(rom_set, os_v)
    for (tid, tracks_, _vars) in dii.tables:
        spec.di_tables[tid] = list(tracks_)
    spec.streams = streams
    return spec


def replace_stream(spec: romgen.RomSpec, addr, new_bytes):
    """Replace the imported stream at the given prototype address."""
    name = stream_name(addr)
    if name not in spec.streams:
        raise KeyError(f"no imported stream at ${addr:06X}")
    spec.streams[name] = bytes(new_bytes)
    return name


def replace_track(spec: romgen.RomSpec, track: romgen.TrackSpec):
    """Replace (or add) a track definition by number."""
    spec.tracks = [t for t in spec.tracks if t.number != track.number]
    spec.tracks.append(track)
    spec.tracks.sort(key=lambda t: t.number)
