"""dcsencoder-tpu — DCS stream/ROM encoder CLI, on the CUDA card.

The port's copy of ``dcsexplorer_tpu/tools/encoder_cli.py``, the
framework's counterpart of the reference's DCSEncoder program (reference:
DCSEncoder/Main.cpp): transcode audio files into DCS streams (raw 'DCSa'
containers) or compile a script into a full ROM zip.  The same options and
output, except:

- ``--device`` defaults to ``cuda``: every 1994+ input of the "pinv"
  analysis (the only one the CLI selects) goes through one batched
  ``encode_files_device`` call, the encoder's three kernels; the script
  compiler does the same for each parameter set of a script's streams.
  Without a card the CLI exits 2 and never falls back to the CPU;
  ``--device cpu`` runs the kernels' plain PyTorch versions on the host;
- the 1993 family and raw ``.dcs`` transcodes are encoded on the host, as
  in the JAX package;
- inputs are WAV, FLAC, MP3, Ogg Vorbis or raw ``.dcs``, as in the JAX
  package: ``utils/audioio.read_audio`` reads the first four through the
  port's native decoders, and their PCM goes, like a WAV's, through the
  resampler and ``encode_files_device``.

Usage:
  python -m dcsexplorer_tpu_torch.tools.encoder_cli input.wav -o out.dcs
  python -m dcsexplorer_tpu_torch.tools.encoder_cli --script build.dcss \
      -o roms.zip
"""

import argparse
import os
import sys

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(
        prog="dcsencoder-tpu",
        description="DCS audio encoder / ROM compiler (PyTorch + CUDA)")
    from .. import __version__
    p.add_argument("--version", action="version",
                   version=f"%(prog)s {__version__}")
    p.add_argument("inputs", nargs="*", help="WAV or raw .dcs input files")
    p.add_argument("-o", "--output", help="output file (.dcs) or directory")
    p.add_argument("--script", help="compile a DCS script into a ROM zip")
    p.add_argument("--patch", metavar="PROTO.zip",
                   help="patch mode: import this prototype ROM, apply the "
                        "script's changes, regenerate")
    p.add_argument("--bitrate", type=int, default=128000,
                   help="target bit rate (bits/s)")
    p.add_argument("--cutoff", type=float, default=0.97,
                   help="power band cutoff fraction (1.0 keeps all bands)")
    p.add_argument("--max-error", type=float, default=10.0 / 32768.0,
                   help="max quantization error (fraction of full scale)")
    p.add_argument("--format-type", type=int, default=-1, choices=(-1, 0, 1),
                   help="stream format major type (-1 = try both, keep "
                        "smallest)")
    p.add_argument("--format-subtype", type=int, default=-1,
                   choices=(-1, 0, 3),
                   help="stream format subtype (-1 = try both)")
    p.add_argument("--format-version", default="94",
                   choices=("93a", "93b", "94", "95"),
                   help="codec family for raw stream output (reference "
                        "formatVersion 0x9301/0x9300/0x9400)")
    p.add_argument("--rom-size", default=None, choices=("512K", "1M"),
                   help="per-chip ROM size for --script output (default: "
                        "the script/prototype's size, 512K)")
    p.add_argument("--rom-prefix", default="sound_",
                   help="zip entry name prefix for generated ROM images")
    p.add_argument("--stream-dir", default=None,
                   help="directory searched for stream files named in the "
                        "script (default: the script's directory)")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="suppress the layout report")
    p.add_argument("--check", action="store_true",
                   help="round-trip decode each stream and report SNR")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where 1994+ streams are encoded: 'cuda' (the "
                        "card, default) or 'cpu' (the encoder kernels' "
                        "plain versions)")
    return p


def _load_audio(path):
    from ..utils import audioio
    if audioio.is_dcs_raw(path):
        stream, osv = audioio.read_dcs_raw(path)
        return ("dcs", stream, osv)
    audio, rate = audioio.read_audio(path)
    return ("pcm", audio * 32768.0, rate)


def _report(path, out_path, stream, nf, data, rate, check, os_version):
    """The line of one encoded PCM input, with --check's round-trip SNR
    through the scalar ReferenceDecoder."""
    secs = nf * 240 / 31250.0
    kbps = len(stream) * 8 / secs / 1000.0
    msg = (f"{path}: {secs:.2f}s -> {out_path} "
           f"({len(stream)} bytes, {kbps:.1f} kbps)")
    if check:
        from ..refdec.decoder import ReferenceDecoder
        dec = ReferenceDecoder()
        dec.default_volume = 255
        dec.init_standalone(os_version)
        dec.soft_boot()
        dec.load_audio_stream(0, stream, mixing_level=0x64)
        out = np.array(dec.next_samples(nf * 240), dtype=np.float64)
        cmp_data = np.asarray(data, dtype=np.float64)
        if int(rate) != 31250:
            from ..encoder.resample import resample
            cmp_data = resample(cmp_data, int(rate), 31250)
        src = np.zeros(nf * 240)
        n = min(src.size, cmp_data.size)
        src[:n] = cmp_data[:n]
        # align for the resampler's group delay (inputs not at 31250 Hz)
        w = min(8192, n)
        lags = np.correlate(out[:w], src[:w], "full")
        lag = int(np.argmax(np.abs(lags))) - (w - 1)
        if lag > 0:
            out_a, src_a = out[lag:], src[:src.size - lag]
        else:
            out_a, src_a = out[:out.size + lag], src[-lag:]
        g = np.dot(out_a, src_a) / max(np.dot(src_a, src_a), 1e-9)
        err = out_a - g * src_a
        snr = 10 * np.log10(max(np.sum((g * src_a) ** 2), 1e-9)
                            / max(np.sum(err ** 2), 1e-9))
        msg += f"  [round-trip SNR {snr:.1f} dB]"
    return msg


def encode_inputs(items, params, check=False, os_version=None,
                  device="cuda"):
    """Encode [(input path, output path)] and write each output.  Raw
    ``.dcs`` inputs pass through (same family) or are transcoded on the
    host; PCM inputs of the 1994+ family under the "pinv" analysis go
    through one encode_files_device call on ``device``, the others through
    the host's encode_pcm.  Prints one line an input, in order."""
    from ..encoder import encoder as enc
    from ..refdec.decoder import OS94
    from ..utils import audioio

    if os_version is None:
        os_version = OS94
    loaded = [_load_audio(path) for path, _ in items]
    batched = [i for i, (kind, _, _) in enumerate(loaded)
               if kind == "pcm" and enc.on_device(params, os_version)]
    encoded = dict(zip(batched, enc.encode_files_device(
        [(loaded[i][1].astype(np.float32), int(loaded[i][2]))
         for i in batched], params, device=device)))
    for i, ((path, out_path), (kind, data, meta)) in enumerate(
            zip(items, loaded)):
        if kind == "dcs":
            if meta == os_version:
                # already a DCS stream of the target family: pass through
                audioio.write_dcs_raw(out_path, data, meta)
                print(f"{path}: raw DCS stream passed through -> "
                      f"{out_path}")
                continue
            # version mismatch: decode + re-encode at the target version
            # (reference DCSEncoder.cpp:358-589 EncodeDCSFile)
            stream, nf = enc.transcode_stream(data, meta, os_version, params)
            audioio.write_dcs_raw(out_path, stream, os_version)
            print(f"{path}: re-encoded (format version {meta} -> "
                  f"{os_version}) -> {out_path} ({len(stream)} bytes)")
            continue
        if i in encoded:
            stream, nf = encoded[i]
        else:
            stream, nf = enc.encode_pcm(data.astype(np.float32), params,
                                        sample_rate=int(meta),
                                        os_version=os_version)
        audioio.write_dcs_raw(out_path, stream, os_version)
        print(_report(path, out_path, stream, nf, data, meta, check,
                      os_version))


def main(argv=None, stats=None):
    """Run the CLI; returns the exit code.  stats: a dict that receives
    the script compiler's timings (compiler.script.compile_script)."""
    args = build_parser().parse_args(argv)
    from ..encoder.encoder import CompressionParams
    params = CompressionParams(
        stream_format_type=args.format_type,
        stream_format_subtype=args.format_subtype,
        target_bit_rate=args.bitrate,
        power_band_cutoff=args.cutoff,
        maximum_quantization_error=args.max_error)

    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("error: no CUDA device (--device cpu runs the encoder's "
                  "plain versions on the host)", file=sys.stderr)
            return 2

    if args.script:
        from ..compiler import script as cscript
        out = args.output or "romset.zip"
        try:
            zip_bytes, report = cscript.compile_script_file(
                args.script, params, prototype_zip=args.patch,
                stream_dir=args.stream_dir,
                chip_size={None: None, "512K": 512 * 1024,
                           "1M": 1024 * 1024}[args.rom_size],
                rom_prefix=args.rom_prefix, device=args.device,
                stats=stats)
        except cscript.ScriptError as e:
            print(f"script error: {e}", file=sys.stderr)
            return 1
        with open(out, "wb") as f:
            f.write(zip_bytes)
        if not args.quiet:
            print(report)
        print(f"ROM set -> {out}")
        return 0

    if not args.inputs:
        print("error: no input files (or use --script)", file=sys.stderr)
        return 2
    items = []
    for path in args.inputs:
        if not os.path.exists(path):
            print(f"error: not found: {path}", file=sys.stderr)
            return 2
        if args.output and len(args.inputs) == 1 and not os.path.isdir(args.output):
            out_path = args.output
        else:
            base = os.path.splitext(os.path.basename(path))[0] + ".dcs"
            out_path = os.path.join(args.output or ".", base)
        items.append((path, out_path))
    osmap = {"93a": 1, "93b": 2, "94": 3, "95": 4}
    try:
        encode_inputs(items, params, check=args.check,
                      os_version=osmap[args.format_version],
                      device=args.device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
