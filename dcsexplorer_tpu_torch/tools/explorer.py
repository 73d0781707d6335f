"""dcsexplorer-tpu — DCS ROM explorer CLI, on the CUDA card.

The port's copy of ``dcsexplorer_tpu/tools/explorer.py``, the framework's
counterpart to the reference's DCSExplorer program (reference:
DCSExplorer/DCSExplorer.cpp): ROM loading and introspection, track/stream
listings, program decompilation, WAV / raw-.dcs extraction, autoplay
sweeps, and a lockstep validation mode (the device pipeline vs. the scalar
reference decoder).  The same options and output, except:

- ``--backend`` defaults to ``cuda``, the session pipeline's kernels
  (``decode94_bank``, then ``session_mix94`` + ``transform94_pcm``, or
  ``decode93_pcm`` for a 1993 ROM); the registered decoders are, as in
  the JAX package, ``native`` (the scalar decoder), ``emulator-strict``
  and ``emulator-fast`` (the ROM's own firmware on the ADSP-2105
  emulator, ``emu/``), each run on the host;
- ``--platform default`` is the card: a command that decodes on the device
  exits 2 without one, and never falls back to the CPU; ``--platform cpu``
  runs the kernels' plain PyTorch versions on the host;
- the validation dump labels the device side ``cuda  ``.

Usage:
  python -m dcsexplorer_tpu_torch.tools.explorer ROM.zip [options]
"""

import argparse
import os
import sys

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(
        prog="dcsexplorer-tpu",
        description="DCS audio ROM explorer (PyTorch + CUDA port)")
    from .. import __version__
    p.add_argument("--version", action="version",
                   version=f"%(prog)s {__version__}")
    p.add_argument("rom", help="PinMame-style ROM zip")
    p.add_argument("--u2", help="explicit U2 file name inside the zip")
    p.add_argument("--info", action="store_true", help="show ROM info (default)")
    p.add_argument("--tracks", action="store_true", help="list tracks")
    p.add_argument("--programs", action="store_true",
                   help="list tracks with decompiled programs")
    p.add_argument("--streams", action="store_true", help="list audio streams")
    p.add_argument("--ditables", action="store_true",
                   help="list deferred-indirect tables")
    p.add_argument("--extract-tracks", metavar="PREFIX",
                   help="decode every type-1 track to PREFIXnnnn.wav")
    p.add_argument("--extract-streams", metavar="PREFIX",
                   help="extract streams: PREFIXaddr.wav and/or PREFIXaddr.dcs")
    p.add_argument("--extract-format", choices=("wav", "raw", "both"),
                   default="both",
                   help="stream extract format (reference: wav|raw; "
                        "default both)")
    p.add_argument("--autoplay", metavar="OUT.wav",
                   help="autoplay sweep of all tracks to one WAV")
    p.add_argument("--interactive", metavar="OUT.wav", nargs="?",
                   const="session.wav",
                   help="hex-command REPL: type track numbers (e.g. 0001) "
                        "or vNN for volume; renders the session to OUT.wav")
    p.add_argument("--seconds-per-command", type=float, default=2.0,
                   help="audio rendered after each interactive command")
    p.add_argument("--dasm", metavar="RANGE", nargs="?", const="0:0x2000",
                   help="disassemble U2 (RANGE as start:end word addrs, "
                        "default 0:0x2000)")
    p.add_argument("--validate", nargs="?", const=True, metavar="LOG",
                   help="lockstep-validate the CUDA pipeline against the "
                        "scalar reference decoder over an autoplay sweep; "
                        "optionally write the report to LOG")
    p.add_argument("--ignore-checksum-errors", action="store_true",
                   help="decode even when the ROM fails its POST checks")
    p.add_argument("--silent", action="store_true",
                   help="accepted for reference-CLI compatibility (this "
                        "tool always renders to files, never a device)")
    p.add_argument("--backend", default="cuda",
                   help="decode backend for extraction/autoplay: 'cuda' "
                        "(batched device pipeline) or any registered "
                        "decoder by name/prefix — 'native' (scalar), "
                        "'emulator-strict' (runs original ROM firmware on "
                        "the ADSP-2105 interpreter); '?' lists backends")
    p.add_argument("--vol", type=int, default=0x67, help="master volume 0-255")
    p.add_argument("--platform", choices=("default", "cpu"), default="default",
                   help="device override (default = the CUDA card, cpu = "
                        "host execution)")
    p.add_argument("--terse", action="store_true",
                   help="suppress schedule/data-port narration")
    p.add_argument("--max-track-frames", type=int, default=4000,
                   help="cap per-track frames in sweeps")
    return p


def load_rom(path, explicit_u2=None):
    from ..rom import zipload
    rs, assigned = zipload.load_zip_file(path, explicit_u2=explicit_u2)
    status = rs.check()
    return rs, assigned, status


def cmd_info(rs, assigned, status):
    from ..rom.image import game_title
    print(f"Signature:   {rs.signature()}")
    print(f"Game:        {game_title(rs.game_id)}" +
          (f" [{rs.game_id}]" if rs.game_id else ""))
    print(f"Version:     {rs.version_info()}")
    print(f"ROM check:   {'OK' if status == 1 else f'FAILED (code {status})'}")
    print(f"Channels:    {rs.num_channels() or '?'}")
    print(f"Tracks:      {rs.n_tracks}")
    print(f"Catalog:     U2 ${rs.catalog_ofs:05X}")
    print("Chips:")
    for i in range(8):
        if not rs.is_dummy[i]:
            print(f"  U{i+2}: {rs.chip_sizes[i]//1024} KB")
    print("Zip contents:")
    for name, chip in assigned.items():
        tag = f"U{chip}" if chip else "(unused)"
        print(f"  {name:<30} {tag}")


def cmd_tracks(rs, programs=False):
    from ..rom import tracks as rtracks
    for t in range(rs.n_tracks):
        ti = rtracks.get_track_info(rs, rs.os_version, t)
        if ti is None:
            continue
        kind = {1: "program", 2: "deferred", 3: "deferred-indirect"}[ti.type]
        extra = ""
        if ti.type == 1:
            secs = ti.time * 240 / 31250.0
            extra = f" time={secs:.2f}s" + (" (loops)" if ti.looping else "")
        else:
            extra = f" defer=${ti.defer_code:04X}"
        print(f"Track ${t:04X}: ch {ti.channel} {kind} @ ${ti.address:06X}{extra}")
        if programs and ti.type == 1:
            print(rtracks.explain_track(rs, rs.os_version, t, "    "))


def _stream_index(rs, mem, pos):
    """Family-aware stream prescan: (n_frames, end_bit, fmt_desc)."""
    from ..ops import prescan
    from ..refdec import decoder as rd
    if rs.os_version in (rd.OS93A, rd.OS93B):
        if rs.os_version == rd.OS93A and (int(mem[pos + 2]) & 0x80) != 0:
            from ..ops import decode93a
            idx = decode93a.prescan93a(mem, pos)
            return idx.n_frames, int(idx.end_bit[-1]) if idx.n_frames else 0, "93a-T1"
        from ..ops import decode93
        idx = decode93.prescan93(mem, pos)
        return idx.n_frames, int(idx.end_bit[-1]) if idx.n_frames else 0, \
            f"93/{idx.fmt_type}"
    idx = prescan.prescan94(mem, pos)
    return idx.n_frames, int(idx.end_bit[-1]) if idx.n_frames else 0, \
        f"{idx.fmt_type}/{idx.sub_type}"


def cmd_streams(rs):
    from ..rom import tracks as rtracks
    total_bytes = 0
    total_frames = 0
    for addr in rtracks.list_streams(rs, rs.os_version):
        p = rs.make_pointer(addr)
        try:
            n_frames, end_bit, fdesc = _stream_index(rs, p.mem, p.pos)
            n_bytes = (end_bit // 8 - p.pos + 1) if n_frames else 18
            secs = n_frames * 240 / 31250.0
            pcm_bytes = n_frames * 240 * 2
            ratio = pcm_bytes / max(1, n_bytes)
            kbps = n_bytes * 8 / max(secs, 1e-9) / 1000.0
            print(f"${addr:06X}: {n_frames:5d} frames {secs:7.2f}s "
                  f"{n_bytes:7d} bytes  type {fdesc}"
                  f"  {kbps:6.1f} kbps  {ratio:4.1f}:1")
            total_bytes += n_bytes
            total_frames += n_frames
        except Exception as e:
            print(f"${addr:06X}: <error: {e}>")
    secs = total_frames * 240 / 31250.0
    print(f"Total: {total_frames} frames ({secs:.1f}s), {total_bytes} bytes")


def cmd_ditables(rs):
    from ..rom import tracks as rtracks
    dii = rtracks.get_deferred_indirect_tables(rs, rs.os_version)
    for (tid, tracks_, vars_) in dii.tables:
        lst = ", ".join(f"${t:04X}" for t in tracks_)
        vl = ", ".join(f"${v:02X}" for v in vars_)
        print(f"Table ${tid:02X} [vars {vl}]: {lst}")
    for (vid, mx) in dii.vars:
        print(f"Var ${vid:02X}: max value {mx}")


def _decode_track(rs, track, vol, backend, max_frames, bank=None):
    from ..models import romplay
    from ..refdec import decoder as rd
    from ..rom import tracks as rtracks
    ti = rtracks.get_track_info(rs, rs.os_version, track)
    n = min((ti.time or 40) + 4, max_frames)
    events = {0: (lambda dec: (dec.write_data_port((track >> 8) & 0xFF),
                               dec.write_data_port(track & 0xFF)))}
    if backend == "cuda":
        pcm, _ = romplay.play_session(rs, events, n, default_volume=vol,
                                      bank=bank)
        return pcm
    from ..refdec import registry
    if backend == "scalar":
        backend = "native"      # legacy alias
    dec = registry.create(backend)
    dec.default_volume = vol
    dec.load_rom_set(rs)
    dec.soft_boot()
    if dec.state != rd.ST_RUNNING:
        print(f"decoder init failed: {getattr(dec, 'error_message', None)}",
              file=sys.stderr)
    out = []
    for f in range(n):
        if f in events:
            events[f](dec)
        out.extend(dec.next_samples(240))
    return np.array(out, dtype=np.int16)


def cmd_dasm(rs, range_spec):
    from ..rom import disasm
    if range_spec in ("boot", "main"):
        # static-trace disassembly with overlay reconstruction
        # (reference: DCSExplorer.cpp:1941-2541)
        from ..rom import dasmtrace
        u2 = rs.chips[0]
        ofs = 0 if range_spec == "boot" else rs.soft_boot_offset()
        for line in dasmtrace.disassemble_program(u2, ofs):
            print(line)
        return
    try:
        start_s, end_s = range_spec.split(":")
        start, end = int(start_s, 0), int(end_s, 0)
    except ValueError:
        print(f"error: bad --dasm range {range_spec!r} "
              "(use START:END, 'boot', or 'main')", file=sys.stderr)
        return
    data = bytes(rs.chips[0][start * 4:end * 4])
    for line in disasm.disassemble_rom(data, start_addr=start):
        print(line)


def cmd_extract_tracks(rs, prefix, vol, backend, max_frames, device="cuda"):
    from ..models import romplay
    from ..rom import tracks as rtracks
    from ..utils import audioio
    # one bank on the device for every track; each play_session runs on it
    bank = romplay.build_rom_bank(rs, device) if backend == "cuda" else None
    for t in range(rs.n_tracks):
        ti = rtracks.get_track_info(rs, rs.os_version, t)
        if ti is None or ti.type != 1 or ti.time == 0:
            continue
        pcm = _decode_track(rs, t, vol, backend, max_frames, bank=bank)
        path = f"{prefix}{t:04x}.wav"
        audioio.write_wav(path, pcm)
        print(f"track ${t:04X} -> {path} ({pcm.size} samples)")


def cmd_extract_streams(rs, prefix, vol, fmt="both"):
    from ..rom import tracks as rtracks
    from ..refdec import decoder as rd
    from ..utils import audioio
    for addr in rtracks.list_streams(rs, rs.os_version):
        p = rs.make_pointer(addr)
        n_frames, end_bit, _ = _stream_index(rs, p.mem, p.pos)
        n_bytes = (end_bit // 8 - p.pos + 4) if n_frames else 18
        raw = bytes(p.mem[p.pos:p.pos + n_bytes])
        if fmt in ("raw", "both"):
            audioio.write_dcs_raw(f"{prefix}{addr:06x}.dcs", raw, rs.os_version)
        if fmt == "raw":
            print(f"stream ${addr:06X} -> {prefix}{addr:06x}.dcs")
            continue

        dec = rd.ReferenceDecoder()
        dec.default_volume = vol
        dec.init_standalone(rs.os_version)
        dec.soft_boot()
        dec.load_audio_stream(0, raw, mixing_level=0x64)
        pcm = np.array(dec.next_samples((n_frames + 2) * 240), dtype=np.int16)
        audioio.write_wav(f"{prefix}{addr:06x}.wav", pcm)
        print(f"stream ${addr:06X} -> {prefix}{addr:06x}.wav/.dcs "
              f"({n_frames} frames)")


def cmd_autoplay(rs, out_path, vol, max_frames, terse=False, device="cuda"):
    from ..models import romplay
    from ..utils import audioio
    pcm, schedule, tracer = romplay.autoplay(rs, default_volume=vol,
                                             max_frames_per_track=max_frames,
                                             return_tracer=True,
                                             device=device)
    audioio.write_wav(out_path, pcm)
    if not terse:
        for (t, frame, dur) in schedule:
            print(f"  track ${t:04X} at {frame*240/31250.0:7.2f}s "
                  f"({dur*240/31250.0:.2f}s)")
        if tracer.host.rx:
            # narrate DCS->host data-port traffic (reference behavior
            # unless --terse, DCSExplorer.cpp:207-216)
            txt = " ".join(f"${b:02X}" for b in tracer.host.rx[:64])
            more = "" if len(tracer.host.rx) <= 64 else " ..."
            print(f"  data port -> host: {txt}{more}")
    print(f"autoplay -> {out_path} ({pcm.size/31250.0:.1f}s)")


def cmd_interactive(rs, out_path, vol, secs_per_cmd, backend="native"):
    """Hex-command REPL (counterpart of the reference's interactive mode,
    DCSExplorer.cpp:1580-1621): each line is a 16-bit hex track command, or
    'vNN' to set the master volume, or 'quit'.  The session's audio renders
    to a WAV file."""
    from ..refdec import decoder as rd
    from ..refdec import registry
    from ..utils.player import MemorySink
    if backend in ("cuda", "scalar"):
        backend = "native"      # interactive sessions run a live decoder
    dec = registry.create(backend)
    dec.default_volume = vol
    dec.load_rom_set(rs)
    dec.soft_boot()
    sink = MemorySink()
    n = int(secs_per_cmd * 31250)
    print("dcsexplorer-tpu interactive: enter hex track (0001), vNN, quit")
    for line in sys.stdin:
        cmd = line.strip().lower()
        if cmd in ("q", "quit", "exit"):
            break
        if not cmd:
            continue
        try:
            if cmd.startswith("v"):
                lvl = int(cmd[1:], 16)      # vNN takes hex, like tracks
                for b in (0x55, 0xAA, lvl & 0xFF, (lvl & 0xFF) ^ 0xFF):
                    dec.write_data_port(b)
                print(f"volume {lvl}")
            else:
                track = int(cmd, 16)
                dec.write_data_port((track >> 8) & 0xFF)
                dec.write_data_port(track & 0xFF)
                print(f"track ${track:04X}")
        except ValueError:
            print(f"? {cmd!r} (hex track number, vNN, or quit)")
            continue
        pcm = np.array(dec.next_samples(n), dtype=np.int16)
        sink.write(pcm)
        if dec.host.rx:
            print("host bytes:", " ".join(f"{b:02X}" for b in dec.host.rx))
            dec.host.rx.clear()
    from ..utils import audioio
    audioio.write_wav(out_path, sink.data())
    print(f"session audio -> {out_path} ({sink.data().size / 31250.0:.1f}s)")


def _hex_frame(label, samples):
    """One decoder's 240-sample frame as hex rows of 16 (u16 storage)."""
    out = []
    for off in range(0, len(samples), 16):
        row = " ".join(f"{int(s) & 0xFFFF:04X}" for s in samples[off:off + 16])
        out.append(f"  {label}[{off:3d}] {row}")
    return out


def _diff_runs(frames_bad):
    """Collapse sorted differing frame indices into (first, last) runs."""
    runs = []
    for f in frames_bad:
        f = int(f)
        if runs and f == runs[-1][1] + 1:
            runs[-1][1] = f
        else:
            runs.append([f, f])
    return runs


MAX_FRAME_DUMPS = 4        # full two-sided sample dumps for the first N bad frames
HISTORY_DEPTH = 8          # recent data-port commands shown per dump


def cmd_validate(rs, vol, max_frames, log_path=None, device="cuda"):
    """Lockstep: the device pipeline (on ``device``) vs the scalar reference
    over an autoplay sweep.

    Mirrors the reference's --validate diagnostics (DCSExplorer.cpp:
    1338-1481 per-frame compare with both decoders' sample dumps and the
    recent command history for repro; 1513-1566 diff-run aggregation and
    final report): every 16-bit PCM sample and every DCS->host data-port
    byte is compared, mismatching frames are aggregated into consecutive
    runs, and the first few differing frames are dumped from BOTH decoders
    alongside the data-port commands that led up to them.
    """
    from ..models import romplay
    from ..refdec import decoder as rd
    pcm, schedule, tracer = romplay.autoplay(rs, default_volume=vol,
                                             max_frames_per_track=max_frames,
                                             return_tracer=True,
                                             device=device)
    events = {}
    history = []   # (frame, [bytes...], meaning) — the repro command log
    for (t, frame, _) in schedule:
        def make_event(track):
            def ev(dec):
                dec.clear_tracks()
                dec.write_data_port((track >> 8) & 0xFF)
                dec.write_data_port(track & 0xFF)
            return ev
        events[frame] = make_event(t)
        history.append((frame, [(t >> 8) & 0xFF, t & 0xFF],
                        f"play track ${t:04X}"))
    dec = rd.ReferenceDecoder()
    dec.default_volume = vol
    dec.load_rom_set(rs)
    dec.soft_boot()
    golden = []
    n = pcm.size // 240
    for f in range(n):
        if f in events:
            events[f](dec)
        golden.extend(dec.next_samples(240))
    golden = np.array(golden, dtype=np.int16)
    mism = np.nonzero(golden != pcm)[0]
    frames_bad = np.unique(mism // 240)
    runs = _diff_runs(frames_bad)

    # DCS->host data-port history must match as well (reference compares
    # both PCM and the data-port bytes, DCSExplorer.cpp:1440-1481)
    ref_rx, dev_rx = list(dec.host.rx), list(tracer.host.rx)
    port_ok = ref_rx == dev_rx

    summary = [f"Samples compared: {golden.size} ({n} frames)",
               f"Sample mismatches: {mism.size} in {frames_bad.size} frames"
               f" ({len(runs)} diff runs)",
               f"Data port bytes: {len(ref_rx)} "
               f"({'match' if port_ok else 'MISMATCH'})"]
    failed = bool(mism.size) or not port_ok

    detail = []
    if runs:
        detail.append("Diff runs (consecutive mismatching frames):")
        for a, b in runs:
            nbad = int(np.sum((frames_bad >= a) & (frames_bad <= b))) * 240
            detail.append(f"  frames {a}..{b} "
                          f"({b - a + 1} frames, {nbad} samples spanned)")
    for f in frames_bad[:MAX_FRAME_DUMPS]:
        f = int(f)
        s, e = f * 240, (f + 1) * 240
        bad_in_frame = mism[(mism >= s) & (mism < e)]
        detail.append(f"Frame {f}: {bad_in_frame.size} differing samples, "
                      f"first at offset {int(bad_in_frame[0]) - s}")
        recent = [h for h in history if h[0] <= f][-HISTORY_DEPTH:]
        if recent:
            detail.append("  recent data-port commands (repro):")
            for (hf, hb, meaning) in recent:
                detail.append(f"    frame {hf}: "
                              + " ".join(f"{b:02X}" for b in hb)
                              + f"  ; {meaning}")
        detail += _hex_frame("scalar", golden[s:e])
        detail += _hex_frame("cuda  ", pcm[s:e])
    if frames_bad.size > MAX_FRAME_DUMPS:
        detail.append(f"... {frames_bad.size - MAX_FRAME_DUMPS} more "
                      f"differing frames (dumps capped)")
    if not port_ok:
        k = next((i for i, (a, b) in enumerate(zip(ref_rx, dev_rx))
                  if a != b), min(len(ref_rx), len(dev_rx)))
        lo = max(0, k - 8)
        detail.append(f"Data port diverges at byte {k}:")
        detail.append("  scalar: " + " ".join(
            f"{b:02X}" for b in ref_rx[lo:k + 8]))
        detail.append("  cuda  : " + " ".join(
            f"{b:02X}" for b in dev_rx[lo:k + 8]))

    verdict = "Validation FAILED" if failed else "Validation Succeeded"
    lines = summary + detail + [verdict]
    for ln in summary:
        print(ln)
    if failed and not log_path:
        for ln in detail:
            print(ln)
    print(verdict)
    if log_path:
        with open(log_path, "w") as f:
            f.write("\n".join(lines) + "\n")
        if failed:
            print(f"per-frame dumps and command history -> {log_path}")
    return 1 if failed else 0


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.backend != "cuda":
        # validate the backend selection up front (reference behavior:
        # DCSExplorer.cpp:458-537 — '?' or a bad name lists the choices)
        from ..refdec import registry
        try:
            if args.backend not in ("?", "scalar"):
                registry.resolve(args.backend)
        except (KeyError, registry.AmbiguousBackendError):
            args.backend = "?"
        if args.backend == "?":
            print("Available decoders:")
            print(f"    {'cuda':<16} batched CUDA device pipeline (default)")
            for r in registry.registrations():
                print(f"    {r.name:<16} {r.description}")
            return 0
    if not os.path.exists(args.rom):
        print(f"error: ROM file not found: {args.rom}", file=sys.stderr)
        return 2
    try:
        rs, assigned, status = load_rom(args.rom, args.u2)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    decode_requested = bool(args.extract_tracks or args.extract_streams
                            or args.autoplay or args.interactive
                            or args.validate)
    if status != 1 and decode_requested and not args.ignore_checksum_errors:
        print(f"error: ROM failed its POST checks (code {status}); use "
              "--ignore-checksum-errors to decode anyway", file=sys.stderr)
        return 1
    device = "cpu" if args.platform == "cpu" else "cuda"
    on_device = bool(args.autoplay or args.validate or (
        args.extract_tracks and args.backend == "cuda"))
    if on_device and device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("error: no CUDA device (--platform cpu runs the device "
                  "pipeline on the host)", file=sys.stderr)
            return 2

    try:
        return _dispatch(args, rs, assigned, status, device)
    except ValueError as e:
        # corrupt ROM data surfaces as stream/parse errors; report cleanly
        print(f"error: {e}", file=sys.stderr)
        return 1


def _dispatch(args, rs, assigned, status, device):
    did = False
    if args.tracks or args.programs:
        cmd_tracks(rs, programs=args.programs)
        did = True
    if args.streams:
        cmd_streams(rs)
        did = True
    if args.ditables:
        cmd_ditables(rs)
        did = True
    if args.dasm:
        cmd_dasm(rs, args.dasm)
        did = True
    if args.extract_tracks:
        cmd_extract_tracks(rs, args.extract_tracks, args.vol, args.backend,
                           args.max_track_frames, device=device)
        did = True
    if args.extract_streams:
        cmd_extract_streams(rs, args.extract_streams, args.vol,
                            fmt=args.extract_format)
        did = True
    if args.autoplay:
        cmd_autoplay(rs, args.autoplay, args.vol, args.max_track_frames,
                     terse=args.terse, device=device)
        did = True
    if args.interactive:
        cmd_interactive(rs, args.interactive, args.vol,
                        args.seconds_per_command, backend=args.backend)
        did = True
    rc = 0
    if args.validate:
        log = args.validate if isinstance(args.validate, str) else None
        rc = cmd_validate(rs, args.vol, args.max_track_frames,
                          log_path=log, device=device)
        did = True
    if args.info or not did:
        cmd_info(rs, assigned, status)
    return rc


if __name__ == "__main__":
    sys.exit(main())
