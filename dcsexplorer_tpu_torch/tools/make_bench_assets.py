"""Generate the committed benchmark assets under assets/streams/.

The round-1 bench corpus was four short test tones (693 frames total);
symbol density of pure tones is far below real music, and the 93-family
kernels had no bench material at all.  This tool synthesizes denser,
music-like audio (chords + melody + percussive transients + noise bed),
encodes it through the framework's own encoder into every encodable
format family, and hand-builds an OS93a Type-1 (Judge Dredd) stream with
the format's own bitstream writer (the encoder declines 93a-T1, as the
reference does: DCSEncoder.cpp:807).

Run:  python -m dcsexplorer_tpu_torch.tools.make_bench_assets
          [--out DIR] [--device cuda|cpu]
Deterministic: fixed seeds, output bytes are stable across runs.

The port's copy of ``dcsexplorer_tpu/tools/make_bench_assets.py``.
``synth_music`` and ``build_stream93a_type1`` are copies (numpy generators,
so the same numbers).  The two 1994+ music streams are encoded in one
``encode_files_device`` call on ``--device`` (``cuda``, the default, is the
encoder's three kernels on the card and exits 2 without one; ``cpu`` runs
their plain PyTorch versions); the two 1993 streams through the host's
``encode_pcm``.  The bytes equal the JAX tool's as it runs today.  Those
differ from four of the committed files (``music_a.dcs94``,
``music_b.dcs94``, ``music_a.dcs93b``, ``music_b.dcs93a``), which predate
later encoder changes: without ``--out`` the tool rewrites
``assets/streams/`` with other bytes than the committed ones.
"""

import argparse
import json
import os
import sys

import numpy as np

from ..encoder.encoder import (BitWriter, CompressionParams, encode_pcm,
                               encode_files_device)
from ..format import tables as T
from ..refdec.decoder import OS93A, OS93B

RATE = 31250
ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), os.pardir, "assets", "streams")


def synth_music(seconds=8.0, seed=11, root=220.0):
    """Dense synthetic music: chord pad + melody + percussion + noise."""
    rng = np.random.default_rng(seed)
    n = int(seconds * RATE)
    t = np.arange(n) / RATE
    out = np.zeros(n)

    # chord pad: root + third + fifth with slow detune/vibrato
    for mult, amp in ((1.0, 4200.0), (1.26, 2600.0), (1.5, 2300.0),
                      (2.0, 1200.0)):
        vib = 1.0 + 0.002 * np.sin(2 * np.pi * (0.9 + mult) * t)
        out += amp * np.sin(2 * np.pi * root * mult * vib * t)

    # melody: eighth-note arpeggio over two octaves with decaying envelopes
    step = int(0.125 * RATE)
    scale = [1, 9 / 8, 5 / 4, 4 / 3, 3 / 2, 5 / 3, 15 / 8, 2]
    for k in range(n // step):
        f = root * 2 * scale[int(rng.integers(0, len(scale)))]
        seg = slice(k * step, min((k + 1) * step, n))
        tt = np.arange(seg.stop - seg.start) / RATE
        env = np.exp(-tt * 9.0)
        out[seg] += 5200 * env * np.sin(2 * np.pi * f * tt)
        # overtone for brightness / high-band energy
        out[seg] += 1700 * env * np.sin(2 * np.pi * 3 * f * tt)

    # percussion: noise bursts every half second
    hit = int(0.5 * RATE)
    for k in range(n // hit):
        seg = slice(k * hit, min(k * hit + 900, n))
        tt = np.arange(seg.stop - seg.start)
        out[seg] += rng.normal(0, 5200, seg.stop - seg.start) * \
            np.exp(-tt / 260.0)

    # low noise bed keeps every band busy
    out += rng.normal(0, 320, n)
    peak = np.abs(out).max()
    return (out * (26000.0 / peak)).astype(np.float32)


def build_stream93a_type1(n_frames=700, n_bands=16, selector=1, seed=5):
    """OS93a Type-1 stream via the format's own bitstream grammar
    (header byte t|pp|bbbbb, band-bits prefix codebooks, scale codewords,
    pair-table samples; reference: DCSDecoderNative.cpp:2831-3032)."""
    rng = np.random.default_rng(seed)
    hdr = bytes([0x80 | (selector << 5) | n_bands])
    books = np.asarray(T.OS93A_BAND_BITS_CODEBOOKS)
    base = (selector << 5) >> 1
    prefix = {}
    for i in range(16):
        bb, nb = int(books[base + i][0]), int(books[base + i][1])
        key = bb & 0xFFFF
        if key not in prefix:
            prefix[key] = (i >> (4 - nb), nb)
    w = BitWriter()
    inputs_per_band = np.asarray(T.OS93A_INPUTS_PER_BAND)
    usable = sorted(k for k in prefix if k != 0xFFFF and 0 < k <= 6)
    for _ in range(n_frames):
        for b in range(n_bands):
            bits = int(rng.choice(usable))
            cw, nb = prefix[bits]
            w.write(cw, nb)
            w.write(0, 2)               # scale codeword: delta 0
            for _ in range(int(inputs_per_band[b])):
                w.write(int(rng.integers(0, 1 << bits)), bits)
    body = w.bytes()
    return n_frames.to_bytes(2, "big") + hdr + body + b"\xff" * 8


def main(argv=None):
    """Write the assets into ``--out`` and update its manifest.json;
    returns the exit code."""
    p = argparse.ArgumentParser(
        prog="dcs-make-bench-assets",
        description="synthesize and encode the benchmark streams")
    p.add_argument("--out", default=os.path.normpath(ASSETS),
                   help="output directory (default: assets/streams of the "
                        "checkout, which holds the committed assets)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the 1994+ streams are encoded (default: the "
                        "CUDA card; cpu = the encoder kernels' plain "
                        "PyTorch versions)")
    args = p.parse_args(argv)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("error: no CUDA device (--device cpu runs the encoder's "
                  "plain versions on the host)", file=sys.stderr)
            return 2

    outdir = args.out
    os.makedirs(outdir, exist_ok=True)
    manifest_path = os.path.join(outdir, "manifest.json")
    manifest = {}
    if os.path.exists(manifest_path):
        manifest = json.load(open(manifest_path))

    music_a = synth_music(8.0, seed=11, root=220.0)
    music_b = synth_music(8.0, seed=23, root=174.6)

    # the 1994+ jobs in one device call (default params, as the JAX tool's
    # encode_pcm(pcm, None)), the 1993 ones on the host
    card = encode_files_device([(music_a, RATE), (music_b, RATE)],
                               CompressionParams(), device=args.device)
    jobs = [
        ("music_a.dcs94", card[0]),
        ("music_b.dcs94", card[1]),
        ("music_a.dcs93b", encode_pcm(music_a, None, os_version=OS93B)),
        ("music_b.dcs93a", encode_pcm(music_b, None, os_version=OS93A)),
    ]
    for name, (stream, n_frames) in jobs:
        with open(os.path.join(outdir, name), "wb") as f:
            f.write(stream)
        manifest[name] = {"frames": n_frames, "bytes": len(stream),
                          "kind": "music"}
        print(f"{name}: {n_frames} frames, {len(stream)} bytes")

    # two DISTINCT Type-1 streams so batched bench elements differ
    # (selector picks a different band-bits codebook family for B)
    for name, sel, seed in (("dense_t1.dcs93a1", 1, 5),
                            ("dense_t1b.dcs93a1", 2, 17)):
        t1 = build_stream93a_type1(selector=sel, seed=seed)
        with open(os.path.join(outdir, name), "wb") as f:
            f.write(t1)
        manifest[name] = {
            "frames": 700, "bytes": len(t1), "kind": "93a-type1"}
        print(f"{name}: 700 frames, {len(t1)} bytes")

    with open(manifest_path, "w") as f:
        json.dump(manifest, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
