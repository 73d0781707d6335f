"""dcsencoder-tester — encode-then-decode audition tool, encoding on the
CUDA card.

Counterpart of the reference's DCSEncoderTester (reference:
DCSEncoderTester/EncoderTester.cpp): encode an audio file, then play it back
through the standalone decoder.  This environment has no audio device, so
"playback" renders through the real decode path to a WAV file; an
interactive mode reads commands from stdin (encode/play/info/quit),
mirroring the reference tool's REPL.

The port's copy of ``dcsexplorer_tpu/tools/encoder_tester.py``.  The same
options and output, except that ``--device`` defaults to ``cuda``: the
stream is encoded by ``encode_files_device`` (the encoder's three kernels)
and the tool exits 2 without a card; ``--device cpu`` runs the kernels'
plain PyTorch versions on the host.  Both give the bytes of the host's
``encode_pcm``.  Playback is the port's scalar ``ReferenceDecoder``.

Usage:
  python -m dcsexplorer_tpu_torch.tools.encoder_tester in.wav -o out.wav
"""

import argparse
import os
import sys

import numpy as np


def encode_and_decode(path, out_wav, bitrate=128000, cutoff=0.97,
                      mixing_level=0x7F, volume=255, device="cuda"):
    from ..encoder import encoder as enc
    from ..refdec.decoder import OS95, ReferenceDecoder
    from ..utils import audioio

    audio, rate = audioio.read_wav(path)
    params = enc.CompressionParams(target_bit_rate=bitrate,
                                   power_band_cutoff=cutoff)
    (stream, nf), = enc.encode_files_device([(audio * 32768.0, rate)],
                                            params, device=device)

    # play back exactly like the reference tester: standalone OS95 decoder,
    # LoadAudioStream on channel 0 (reference: EncoderTester.cpp:85-138)
    dec = ReferenceDecoder()
    dec.default_volume = volume
    dec.init_standalone(OS95)
    dec.soft_boot()
    dec.load_audio_stream(0, stream, mixing_level=mixing_level)
    pcm = np.array(dec.next_samples((nf + 2) * 240), dtype=np.int16)
    audioio.write_wav(out_wav, pcm)
    secs = nf * 240 / 31250.0
    kbps = len(stream) * 8 / secs / 1000.0
    return dict(stream_bytes=len(stream), frames=nf, seconds=secs, kbps=kbps)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="dcsencoder-tester",
        description="encode a WAV and audition it through the DCS decoder")
    p.add_argument("input", nargs="?", help="WAV file to encode")
    p.add_argument("-o", "--output", help="output WAV (default: <input>.dcs.wav)")
    p.add_argument("--bitrate", type=int, default=128000)
    p.add_argument("--cutoff", type=float, default=0.97)
    p.add_argument("--interactive", action="store_true",
                   help="REPL: encode <file> / play <out.wav> / quit")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the stream is encoded: 'cuda' (the card, "
                        "default) or 'cpu' (the encoder kernels' plain "
                        "versions)")
    args = p.parse_args(argv)

    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("error: no CUDA device (--device cpu runs the encoder's "
                  "plain versions on the host)", file=sys.stderr)
            return 2

    if args.interactive:
        print("dcsencoder-tester — commands: encode <file.wav>, quit")
        for line in sys.stdin:
            parts = line.strip().split()
            if not parts:
                continue
            if parts[0] in ("quit", "q", "exit"):
                break
            if parts[0] == "encode" and len(parts) > 1:
                out = parts[1] + ".dcs.wav"
                try:
                    info = encode_and_decode(parts[1], out,
                                             bitrate=args.bitrate,
                                             cutoff=args.cutoff,
                                             device=args.device)
                    print(f"{parts[1]}: {info['seconds']:.2f}s, "
                          f"{info['kbps']:.1f} kbps -> {out}")
                except Exception as e:
                    print(f"error: {e}")
            else:
                print("commands: encode <file.wav>, quit")
        return 0

    if not args.input:
        p.print_usage()
        return 2
    if not os.path.exists(args.input):
        print(f"error: not found: {args.input}", file=sys.stderr)
        return 2
    out = args.output or args.input + ".dcs.wav"
    info = encode_and_decode(args.input, out, bitrate=args.bitrate,
                             cutoff=args.cutoff, device=args.device)
    print(f"{args.input}: {info['seconds']:.2f}s {info['stream_bytes']} bytes "
          f"({info['kbps']:.1f} kbps) -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
