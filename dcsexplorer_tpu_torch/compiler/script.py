"""DCS ROM-build script compiler.

Parses the reference's scripting language (grammar documented in the
reference at DCSEncoder/README.md:145-1918; the cheat-sheet constructs are
all supported) and produces a RomSpec for compiler/romgen.py:

  Signature "..." / Default encoding parameters (...) / Stream NAME "file"
  (params) / Var X [: id] / Deferred Indirect table NAME [: id] (...)
  / Track $n channel c Defer($code) | Defer Indirect(Table[Var])
  / Track $n channel c { Wait/Play/Stop/SetMixingLevel/WriteDataPort/
    Queue/SetVariable/StartDeferred/Loop/Nop }

Patch mode: pass a prototype RomSpec (compiler.patch.load_prototype) — the
script's ``Stream X replaces $addr`` re-encodes over an imported stream and
``Track`` definitions supersede imported tracks; everything untouched
regenerates byte-compatibly.

The port's copy of ``dcsexplorer_tpu/compiler/script.py``, with one change
of structure: a 1994+ target's audio streams under the "pinv" analysis are
not encoded where the parse meets them.  The parse records a job (the
canonical int16 PCM, the stream's CompressionParams) and a placeholder,
and counts the stream's frames from its PCM, which is all ``Wait(stream)``
needs.  After the parse, the jobs of each parameter set go through one
``encode_files_device`` call (the three encoder kernels on a card), and the
streams take their places in the order of the parse, which drives romgen's
first-fit layout.  Raw ``.dcs`` inputs, 1993 targets and the comparison
analysis transforms are encoded on the host where the parse meets them, as
in the JAX package.
"""

import datetime
import math
import os
import time

from ..refdec.decoder import OS94, OS95
from . import romgen
from .tokenizer import ErrorLogger, TokenStream, tokenize

FRAME_SEC = 240.0 / 31250.0


class ScriptError(Exception):
    pass


class _Pending:
    """A stream waiting for the batched device encode: its job and, once
    encoded, its bytes."""

    __slots__ = ("pcm", "params", "n_frames", "stream")

    def __init__(self, pcm, params, n_frames):
        self.pcm, self.params, self.n_frames = pcm, params, n_frames
        self.stream = None


def _time_to_frames(ts, allow_stream=False, stream_frames=None):
    """Parse a Wait-style time value: N [sec|ms] | forever | stream [- time]."""
    t = ts.cur
    if t.kind == "sym" and t.value == "forever":
        ts.next()
        return 0xFFFF
    if allow_stream and t.kind == "sym" and t.value == "stream":
        ts.next()
        frames = stream_frames if stream_frames is not None else 0
        if ts.accept("punct", "-"):
            frames -= _time_to_frames(ts)
        elif ts.accept("punct", "+"):
            frames += _time_to_frames(ts)
        return max(0, frames)
    num = ts.expect("int", what="a number") if t.kind == "int" else (
        ts.expect("float", what="a number") if t.kind == "float" else None)
    if num is None:
        ts.next()
        return 0
    val = float(num.value)
    unit = ts.cur
    if unit.kind == "sym" and unit.value in ("sec", "secs", "seconds", "s"):
        ts.next()
        return int(round(val / FRAME_SEC))
    if unit.kind == "sym" and unit.value == "ms":
        ts.next()
        return int(round(val / 1000.0 / FRAME_SEC))
    return int(round(val))


def _parse_enc_params(ts, base):
    """Parse (Name=value, ...) encoding parameter overrides."""
    from ..encoder.encoder import CompressionParams
    p = CompressionParams(**vars(base))
    if not ts.accept("punct", "("):
        return p
    while not ts.accept("punct", ")"):
        name = ts.expect("sym", what="parameter name")
        if name is None:
            ts.resync()
            return p
        ts.expect("punct", "=")
        star = ts.accept("punct", "*")
        tok = None if star else ts.next()

        def num():
            return float(tok.value) if tok and tok.kind in ("int", "float") else 0

        key = name.value
        if key == "type":
            p.stream_format_type = -1 if star else int(num())
        elif key == "subtype":
            p.stream_format_subtype = -1 if star else int(num())
        elif key == "bitrate":
            p.target_bit_rate = int(num())
        elif key == "powercut":
            p.power_band_cutoff = num() / 100.0
        elif key == "maxerror":
            p.maximum_quantization_error = num() / 32768.0 if num() >= 1 else num()
        elif key == "minrange":
            p.minimum_dynamic_range = num() / 32768.0 if num() >= 1 else num()
        else:
            ts.log.warning(name.line, f"unknown encoding parameter '{name.text}'")
        ts.accept("punct", ",")
    return p


class ScriptCompiler:
    def __init__(self, text, filename="<script>", base_params=None,
                 stream_dir=".", prototype=None, device="cuda"):
        from ..encoder.encoder import CompressionParams
        self.log = ErrorLogger(filename)
        self.ts = TokenStream(tokenize(text, self.log), self.log)
        self.base_params = base_params or CompressionParams()
        self.stream_dir = stream_dir
        self.spec = prototype if prototype is not None else romgen.RomSpec(os_version=OS94)
        self.stream_frames = {}       # name -> frame count
        self.vars = {}                # name -> id
        self.di_tables = {}           # name -> id
        self._next_var = 0
        self._next_table = 0
        self._stream_auto = 0
        self.device = device
        self.pending = []             # _Pending, in the order of the parse
        # wall seconds of the parse and of the batched encode's host
        # stages, each device chunk's ms (encoder.encode_files_device)
        self.stats = {}

    # ------------------------------------------------------------------
    def _encode_file(self, path, params):
        """(stream bytes, frames), or a _Pending for the device encode."""
        from ..encoder import encoder as enc
        from ..utils import audioio
        full = path if os.path.isabs(path) else os.path.join(self.stream_dir, path)
        if not os.path.exists(full):
            raise ScriptError(f"audio file not found: {full}")
        if audioio.is_dcs_raw(full):
            stream, osv = audioio.read_dcs_raw(full)
            if osv == self.spec.os_version:
                nf = (stream[0] << 8) | stream[1]
                return bytes(stream), nf
            # format-version mismatch with the target ROM: decode and
            # re-encode (reference DCSEncoder.cpp:358-589 EncodeDCSFile)
            return enc.transcode_stream(stream, osv, self.spec.os_version,
                                        params)
        try:
            audio, rate = audioio.read_audio(full)
        except ValueError as e:
            raise ScriptError(f"{full}: {e}")
        if (self.spec.os_version in (OS94, OS95)
                and enc.on_device(params)):
            pcm = enc.pcm_to_int16(audio * 32768.0, rate)
            job = _Pending(pcm, params, max(1, math.ceil(pcm.size
                                                         / enc.FRAME)))
            self.pending.append(job)
            return job, job.n_frames
        return enc.encode_pcm(audio * 32768.0, params, sample_rate=rate)

    def _add_stream(self, name, path, params):
        stream, nf = self._encode_file(path, params)
        self.spec.streams[name] = stream
        self.stream_frames[name] = nf
        return name

    def _encode_pending(self):
        """Encode the recorded jobs, one encode_files_device call per
        parameter set, and put each stream's bytes in its places (a
        prototype name that a ``replaces`` pointed at the placeholder
        included)."""
        from ..encoder import encoder as enc
        groups = {}
        for job in self.pending:
            groups.setdefault(tuple(sorted(vars(job.params).items())),
                              []).append(job)
        for jobs in groups.values():
            out = enc.encode_files_device(
                [(job.pcm, enc.RATE) for job in jobs], jobs[0].params,
                device=self.device, stats=self.stats)
            for job, (stream, nf) in zip(jobs, out):
                if nf != job.n_frames:
                    raise AssertionError(
                        f"the device encode returned {nf} frames for a "
                        f"stream counted at {job.n_frames}")
                job.stream = stream
        streams = self.spec.streams
        for name, s in streams.items():
            if isinstance(s, _Pending):
                streams[name] = s.stream

    # ------------------------------------------------------------------
    def parse(self):
        t_parse = time.perf_counter()
        ts = self.ts
        while not ts.peek_is("eof"):
            t = ts.next()
            if t.kind != "sym":
                self.log.error(t.line, f"unexpected {t.text!r}")
                ts.resync()
                continue
            kw = t.value
            if kw == "signature":
                s = ts.expect("str", what="signature string")
                if s:
                    date = datetime.date.today().strftime("%m/%d/%y")
                    self.spec.signature = s.value.replace("<date>", date)
                ts.expect("punct", ";")
            elif kw == "default":
                ts.expect("sym", "encoding")
                ts.expect("sym", "parameters")
                self.base_params = _parse_enc_params(ts, self.base_params)
                ts.expect("punct", ";")
            elif kw == "stream":
                self._parse_stream()
            elif kw == "var":
                name = ts.expect("sym", what="variable name")
                vid = self._next_var
                if ts.accept("punct", ":"):
                    vid = int(ts.expect("int", what="variable id").value)
                if name:
                    self.vars[name.value] = vid
                self._next_var = max(self._next_var, vid + 1)
                ts.expect("punct", ";")
            elif kw == "deferred":
                self._parse_di_table()
            elif kw == "track":
                self._parse_track()
            else:
                self.log.error(t.line, f"unknown statement '{t.text}'")
                ts.resync()
        if self.log.n_errors:
            raise ScriptError("\n".join(self.log.messages))
        self.stats["parse_s"] = time.perf_counter() - t_parse
        self._encode_pending()
        return self.spec

    def _parse_stream(self):
        ts = self.ts
        name = ts.expect("sym", what="stream name")
        replaces = None
        if ts.accept("sym", "replaces"):
            addr_tok = ts.expect("int", what="prototype stream address")
            replaces = int(addr_tok.value) if addr_tok else None
        path = ts.expect("str", what="audio file name")
        params = _parse_enc_params(ts, self.base_params)
        if name and path:
            try:
                self._add_stream(name.value, path.value, params)
                if replaces is not None:
                    from .patch import stream_name
                    proto_name = stream_name(replaces)
                    if proto_name in self.spec.streams:
                        # the re-encoded stream supersedes the imported one:
                        # point the imported name at the new bytes so every
                        # prototype track playing it picks up the new audio
                        self.spec.streams[proto_name] = self.spec.streams[name.value]
                        self.stream_frames[proto_name] = self.stream_frames[name.value]
                    else:
                        self.log.error(
                            name.line,
                            f"no prototype stream at ${replaces:06X} to replace")
            except ScriptError as e:
                self.log.error(name.line, str(e))
        ts.expect("punct", ";")

    def _parse_di_table(self):
        ts = self.ts
        ts.expect("sym", "indirect")
        ts.expect("sym", "table")
        name = ts.expect("sym", what="table name")
        tid = self._next_table
        if ts.accept("punct", ":"):
            tid = int(ts.expect("int", what="table id").value)
        self._next_table = max(self._next_table, tid + 1)
        tracks = []
        ts.expect("punct", "(")
        while not ts.accept("punct", ")"):
            v = ts.expect("int", what="track number")
            if v is None:
                ts.resync()
                return
            tracks.append(int(v.value))
            ts.accept("punct", ",")
        if name:
            self.di_tables[name.value] = tid
            self.spec.di_tables[tid] = tracks
        ts.expect("punct", ";")

    # ------------------------------------------------------------------
    def _parse_track(self):
        ts = self.ts
        num = ts.expect("int", what="track number")
        ts.expect("sym", "channel")
        ch = ts.expect("int", what="channel number")
        if num is None or ch is None:
            ts.resync()
            return
        track_no, channel = int(num.value), int(ch.value)
        # a script track definition supersedes any imported prototype track
        self.spec.tracks = [t for t in self.spec.tracks
                            if t.number != track_no]

        if ts.accept("sym", "defer"):
            if ts.accept("sym", "indirect"):
                ts.expect("punct", "(")
                tbl = ts.expect("sym", what="table name")
                ts.expect("punct", "[")
                var = ts.expect("sym", what="variable name")
                ts.expect("punct", "]")
                ts.expect("punct", ")")
                ts.expect("punct", ";")
                tid = self.di_tables.get(tbl.value if tbl else "", 0)
                vid = self.vars.get(var.value if var else "", 0)
                self.spec.tracks.append(romgen.TrackSpec(
                    track_no, type=3, channel=channel,
                    defer_code=(vid << 8) | tid))
            else:
                ts.expect("punct", "(")
                code = ts.expect("int", what="track number")
                ts.expect("punct", ")")
                ts.expect("punct", ";")
                self.spec.tracks.append(romgen.TrackSpec(
                    track_no, type=2, channel=channel,
                    defer_code=int(code.value) if code else 0))
            return

        ts.expect("punct", "{")
        steps = self._parse_block(channel, depth=0)
        self.spec.tracks.append(romgen.TrackSpec(
            track_no, type=1, channel=channel, steps=steps))
        ts.accept("punct", ";")

    def _parse_block(self, channel, depth):
        """Parse statements until '}'.  Returns romgen step tuples."""
        ts = self.ts
        g = romgen
        steps = []
        pending_wait = 0
        last_stream = None
        ended = False

        def emit(step):
            nonlocal pending_wait
            delay, op, operands = step
            steps.append((pending_wait + delay, op, operands))
            pending_wait = 0

        while True:
            if ts.accept("punct", "}"):
                break
            if ts.peek_is("eof"):
                self.log.error(ts.cur.line, "unterminated track block")
                break
            t = ts.next()
            if t.kind != "sym":
                self.log.error(t.line, f"unexpected {t.text!r} in track block")
                ts.resync()
                continue
            kw = t.value
            if kw == "wait":
                ts.expect("punct", "(")
                frames = _time_to_frames(
                    ts, allow_stream=True,
                    stream_frames=self.stream_frames.get(last_stream))
                ts.expect("punct", ")")
                ts.accept("punct", ";")
                if frames == 0xFFFF:
                    emit((0xFFFF, 0x0D, b""))
                    ended = True
                else:
                    pending_wait += frames
            elif kw == "play":
                ts.expect("punct", "(")
                repeat = 1
                tok = ts.cur
                if tok.kind == "str":
                    ts.next()
                    params = _parse_enc_params(ts, self.base_params)
                    name = f"__anon{self._stream_auto}"
                    self._stream_auto += 1
                    try:
                        self._add_stream(name, tok.value, params)
                    except ScriptError as e:
                        self.log.error(tok.line, str(e))
                        name = None
                else:
                    if ts.accept("sym", "stream"):
                        tok = ts.next()
                        if tok.kind == "str":
                            params = _parse_enc_params(ts, self.base_params)
                            name = f"__anon{self._stream_auto}"
                            self._stream_auto += 1
                            try:
                                self._add_stream(name, tok.value, params)
                            except ScriptError as e:
                                self.log.error(tok.line, str(e))
                                name = None
                        else:
                            name = tok.value
                    else:
                        name = ts.expect("sym", what="stream name")
                        name = name.value if name else None
                if ts.accept("punct", ","):
                    if ts.accept("sym", "repeat"):
                        if ts.accept("sym", "forever"):
                            repeat = 0
                        else:
                            repeat = int(ts.expect("int", what="repeat count").value)
                ts.expect("punct", ")")
                ts.accept("punct", ";")
                if name is not None and name in self.spec.streams:
                    emit(g.op_play(channel, name, repeat=repeat))
                    last_stream = name
                elif name is not None:
                    self.log.error(t.line, f"unknown stream '{name}'")
            elif kw == "stop":
                ts.expect("punct", "(")
                if ts.accept("punct", "*"):
                    ts.expect("punct", ")")
                    ts.accept("punct", ";")
                    # stop every OTHER channel, applying the pending wait
                    # before each one (reference cheat-sheet semantics)
                    for c in range(self.spec.num_channels):
                        if c != channel:
                            emit(g.op_stop_channel(c, delay=0))
                else:
                    c = int(ts.expect("int", what="channel").value)
                    ts.expect("punct", ")")
                    ts.accept("punct", ";")
                    emit(g.op_stop_channel(c))
                    if c == channel:
                        ended = True
            elif kw == "setmixinglevel":
                ts.expect("punct", "(")
                target = channel
                mode = 0
                level = 0
                steps_frames = 0
                while True:
                    tok = ts.cur
                    if tok.kind == "sym" and tok.value == "channel":
                        ts.next()
                        target = int(ts.expect("int", what="channel").value)
                    elif tok.kind == "sym" and tok.value in ("increase", "decrease"):
                        ts.next()
                        mode = 1 if tok.value == "increase" else 2
                        level = int(ts.next().value)
                    elif tok.kind == "sym" and tok.value == "steps":
                        ts.next()
                        steps_frames = _time_to_frames(ts)
                    elif tok.kind == "int":
                        ts.next()
                        level = int(tok.value)
                    if not ts.accept("punct", ","):
                        break
                ts.expect("punct", ")")
                ts.accept("punct", ";")
                if steps_frames:
                    emit(g.op_mix_fade(mode, target, level, steps_frames))
                else:
                    emit(g.op_mix(mode, target, level))
            elif kw == "writedataport":
                ts.expect("punct", "(")
                b = int(ts.expect("int", what="byte value").value)
                ts.expect("punct", ")")
                ts.accept("punct", ";")
                emit(g.op_write_port(b & 0xFF))
            elif kw == "queue":
                ts.expect("punct", "(")
                n = int(ts.expect("int", what="track number").value)
                ts.expect("punct", ")")
                ts.accept("punct", ";")
                emit(g.op_queue(n))
            elif kw == "setvariable":
                ts.expect("punct", "(")
                ts.expect("sym", "var")
                v = ts.expect("sym", what="variable name")
                ts.accept("punct", ",")
                ts.expect("sym", "value")
                val = int(ts.expect("int", what="value").value)
                ts.expect("punct", ")")
                ts.accept("punct", ";")
                vid = self.vars.get(v.value if v else "", 0)
                emit(g.op_set_var(vid, val))
            elif kw == "startdeferred":
                ts.expect("punct", "(")
                ts.expect("sym", "channel")
                c = int(ts.expect("int", what="channel").value)
                ts.expect("punct", ")")
                ts.accept("punct", ";")
                emit(g.op_start_deferred(c))
            elif kw == "loop":
                count = 0
                if ts.accept("punct", "("):
                    if not ts.accept("sym", "forever"):
                        count = int(ts.expect("int", what="loop count").value)
                    ts.expect("punct", ")")
                ts.expect("punct", "{")
                emit(g.op_loop_start(count))
                inner = self._parse_block(channel, depth + 1)
                steps.extend(inner)
                steps.append(g.op_loop_end())
                ts.accept("punct", ";")
            elif kw == "nop":
                ts.accept("punct", "(")
                ts.accept("punct", ")")
                ts.accept("punct", ";")
                emit(g.op_nop())
            elif kw == "end":
                ts.accept("punct", "(")
                ts.accept("punct", ")")
                ts.accept("punct", ";")
                emit(g.op_end())
                ended = True
            else:
                self.log.error(t.line, f"unknown track statement '{t.text}'")
                ts.resync()

        if depth == 0 and not ended:
            steps.append((pending_wait, 0x00, b""))
        return steps


def compile_script(text, base_params=None, filename="<script>", stream_dir=".",
                   prototype=None, chip_size=None, rom_prefix="sound_",
                   device="cuda", stats=None):
    """Compile script text → (zip bytes, report string).

    prototype: a RomSpec from compiler.patch.load_prototype for --patch mode.
    chip_size: per-chip ROM size in bytes (512K/1M, reference --rom-size).
    rom_prefix: zip entry prefix (reference --rom-prefix).
    device: where the 1994+ streams are encoded: "cuda" (the default)
    needs a card and raises without one; "cpu" runs the device encoder's
    plain versions.
    stats: a dict to receive the wall seconds of the parse ("parse_s"),
    of the batched encode's host stages ("prep_s", "emit_s") and of the
    layout ("layout_s"), and each device chunk's ms ("chunk_ms").
    """
    from ..models.flatsweep import _device
    _device(device)
    sc = ScriptCompiler(text, filename=filename, base_params=base_params,
                        stream_dir=stream_dir, prototype=prototype,
                        device=device)
    spec = sc.parse()
    if chip_size:
        spec.chip_size = chip_size
    t_layout = time.perf_counter()
    builder = romgen.RomBuilder(spec)
    zip_bytes = builder.build_zip(rom_prefix=rom_prefix)
    sc.stats["layout_s"] = time.perf_counter() - t_layout
    if stats is not None:
        stats.update(sc.stats)
    lines = ["ROM layout:"]
    for ch in builder.chips:
        pct = 100.0 * ch.cursor / ch.size
        lines.append(f"  U{ch.index + 2}: {ch.cursor}/{ch.size} bytes used "
                     f"({pct:.1f}%)")
    lines.append(f"Tracks: {len(spec.tracks)}  Streams: {len(spec.streams)}")
    return zip_bytes, "\n".join(lines)


def compile_script_file(path, base_params=None, prototype_zip=None,
                        stream_dir=None, chip_size=None, rom_prefix="sound_",
                        device="cuda", stats=None):
    with open(path) as f:
        text = f.read()
    prototype = None
    if prototype_zip is not None:
        from ..rom import zipload
        from .patch import load_prototype
        rs, _ = zipload.load_zip_file(prototype_zip)
        if rs.check() != 1:
            raise ScriptError(f"prototype ROM failed its checks: {prototype_zip}")
        prototype = load_prototype(rs)
    return compile_script(text, base_params=base_params, filename=path,
                          stream_dir=stream_dir or
                          os.path.dirname(os.path.abspath(path)),
                          prototype=prototype, chip_size=chip_size,
                          rom_prefix=rom_prefix, device=device, stats=stats)
