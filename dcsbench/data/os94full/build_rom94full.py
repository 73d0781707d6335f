"""Build ``rom94full.zip``, the os94full configuration's ROM set, once: a
full DCS-95 board, all eight sound ROMs U2-U9 of 1 MiB.

The recipe is ``../build_rom94.py``'s with more tracks: the port's ROM
compiler on a script of N_FILES one-shot tracks, every WAV at 31,250 Hz so
that the compiler resamples nothing: files of 2.0 s (four-tone chords with
AM and a noise floor, numpy seed 7; file k is ``build_rom94.py``'s file k
for k < 240), every fourth at 96 kbps and the rest at 128 kbps, compiled
into chips of 1 MiB.  Track ``k + 1`` sets a mixing level of
``$50 + k % 32`` and plays stream ``k`` once on channel ``k % 6``.
N_FILES is the largest multiple of 6 whose set fits U2-U9; six more tracks
overflow the eighth chip.  The bank of its streams has more rows than the
session wire's u16 row ids can name.

The benchmark never runs this script: it reads the committed zip and checks
it against ``MANIFEST.json``.  Rebuilding it (and the manifest) is a change
of the yardstick.

    python3 dcsbench/data/os94full/build_rom94full.py [--device cuda|cpu]
        [--out PATH]
"""

import argparse
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
N_FILES = 372
SECONDS = 2.0
RATE = 31250


def wav_jobs():
    """The N_FILES int16 PCM files (``build_rom94.py``'s, continued)."""
    rng = np.random.default_rng(7)
    jobs = []
    for k in range(N_FILES):
        t = np.arange(int(RATE * SECONDS)) / RATE
        x = np.zeros_like(t)
        for f0 in (220.0, 277.2, 329.6, 440.0):
            x += 0.2 * np.sin(2 * np.pi * f0 * (1 + 0.01 * k) * t)
        x *= 0.5 + 0.5 * np.sin(2 * np.pi * (1.3 + 0.1 * k) * t)
        x += 0.01 * rng.standard_normal(t.size)
        pcm = x / np.abs(x).max() * 0.8
        jobs.append((pcm * 32767).astype(np.int16))
    return jobs


def script_lines():
    lines = ["Default encoding parameters (Type=*, Subtype=*, "
             "BitRate=128000);"]
    for k in range(N_FILES):
        lines.append(f'Stream S{k:03d} "f{k:03d}.wav"'
                     + (" (BitRate=96000)" if k % 4 == 3 else "") + ";")
    for k in range(N_FILES):
        lines.append(f"Track ${k + 1:04X} channel {k % 6} {{ "
                     f"SetMixingLevel(${0x50 + k % 32:02X}); Play(S{k:03d}); "
                     f"Wait(stream); }};")
    return lines


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=os.path.join(HERE, "rom94full.zip"))
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from dcsexplorer_tpu_torch.tools import encoder_cli
    from dcsexplorer_tpu_torch.utils import audioio
    with tempfile.TemporaryDirectory() as work:
        for k, pcm in enumerate(wav_jobs()):
            audioio.write_wav(os.path.join(work, f"f{k:03d}.wav"), pcm, RATE)
        script = os.path.join(work, "rom.dcss")
        with open(script, "w") as f:
            f.write("\n".join(script_lines()) + "\n")
        return encoder_cli.main(["--script", script, "-o", args.out,
                                 "--rom-size", "1M", "-q", "--device",
                                 args.device])


if __name__ == "__main__":
    sys.exit(main())
