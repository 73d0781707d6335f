#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU: the flat catalog sweeps
(warm and cold, and the cold mixed-family catalog) and the ROM session
paths of the 1994+ and the 1993 families, the on-device 1994+ encoder,
the explorer CLI's decode commands, the sharded paths over a mesh of
one card's streams, the host-decode hybrid, the ROM compiler and encoder
CLI with FLAC, MP3 and Ogg inputs, the ADSP-2105 emulator held against
the card's sessions, the bench-asset generator, the corpus validator and
decoder checkpoints (dcsexplorer_tpu_torch) end to end,
through their hand-written kernels, with torch.profiler traces of three of
those paths.

    python3 chip_smoke.py

Phases (one line each or more; any failure raises and the exit code is
non-zero):
  1. the card's name and power limit; build the CUDA kernels from csrc/
     and the port's native host runtime (prescan, VM tracer, encoders,
     the FLAC/MP3/Ogg decoders, the emulator core: one g++ a source, in
     parallel), each build's wall time, the host one alone after nvcc
  2. pack the flat94_music catalog (music_a/b.dcs94 x 144: 288 streams)
  3. each kernel against its plain PyTorch version on the card, at that
     catalog's real intermediates, bit for bit; both timed with CUDA events,
     beside the kernel's bound (the larger of bytes over 3.35 TB/s and
     integer operations over 33.5 TOP/s).  A kernel's time is the card's
     (_device_ms: its launches queue behind a device sleep that outlasts
     the host's enqueue of all of them, or the timer raises); a plain
     version's is the rate at which the host enqueues it (_time_ms)
  4. the whole sweep through FlatPipeline on the card: the launch counters
     of the flat path's kernels (decode94_fb, transform94_pcm) must move,
     PCM must equal the plain-version sweep; timed as x realtime of decoded
     audio, beside the host's enqueue time of one sweep (host clock, no
     synchronise) and the peak device memory of one sweep
  5. all six assets/streams/*.dcs94 through the port on the card against the
     port's scalar ReferenceDecoder, bit for bit
  6. the sweep's stage spans with CUDA events (device time: the stages are
     queued behind a device sleep): unpack, decode94_fb, transform94_pcm
  7. the session path at bench.py's session6 width: load
     dcsexplorer_tpu_torch/data/session6.zip, build the stream bank on the
     card (decode94_bank), serve one batch of 320 distinct sessions x 1,000
     frames x 6 voices through SessionServer, and play session 0 alone
     through play_session (the carried-state transform94_pcm); the launch
     counters of decode94_bank, segments94, session_mix94, transform94_pcm
     and transform94_pcm_carry must move.  The bank, all 2,778 rows, against
     decode94_bank_plain on the same columns on the card, bit for bit, and
     decode94_bank held and timed at that shape as in phase 3
  8. that batch's PCM against the same batch through the plain versions on
     the card, session 0 against play_session's, and the first and last
     sessions against the port's scalar ReferenceDecoder driven by the same
     port bytes (first 250 frames); the session kernels against their plain
     versions at the batch's shapes (as phase 3, with a random carried
     overlap state for transform94_pcm_carry)
  9. session timing: the device time of one batch (x realtime) and its
     stage spans (segments94's kernel time beside its span), serve()
     x realtime over 8 batches (trace -> wire ->
     upload -> kernels -> PCM fetch; all 8 batches' audio over the time from
     the call to the last arrival) with every gap between arrivals and each
     batch's latency from the start of its trace, the native trace and the
     host's enqueue time of one batch, the wire's upload and the PCM fetch
     from and into pinned and pageable memory, and the peak device memory of
     one batch
 10. the flat 1993 sweeps at bench.py's width: pack dec93b (music_a.dcs93b
     + music_b.dcs93a x 72: 144 streams) and dec93a_t1 (dense_t1.dcs93a1 +
     dense_t1b.dcs93a1 x 72) and run both through Flat93Pipeline on the
     card: decode93_pcm must launch once a sweep and decode93_fb and
     transform93_pcm not at all, PCM must equal the plain-version sweep;
     each timed as phase 4
     times the 1994+ sweep, beside the host's pack and its unpack of the
     compact wire + upload; all four assets/streams/*.dcs93* against the
     port's ReferenceDecoder (OS93b for the 93b / 93a Type-0 wire, OS93a
     for Type-1), bit for bit
 11. the 1993 session path at session6's serving width: load
     dcsexplorer_tpu_torch/data/session93a.zip (OS93a, both row kinds),
     build the bank, serve one batch of 320 sessions x 1,000 frames x 6
     voices through SessionServer and play session 0 through play_session;
     the launch counters of decode93_bank, segments94, decode93_pcm and
     decode93_pcm_carry must move and those of decode93_fb, transform93_pcm and
     transform93_pcm_carry must not; the batch equals the plain-version
     server, session 0 play_session's, sessions 0 and 319 the scalar
     decoder over 250 frames, and no session is silent
 12. decode93_pcm.cu's closed-form normalize against the 31-step loop on
     all 2^32 inputs; segments94 on the session93a wire, and the 1993
     kernels, against their plain versions at the paths' shapes, timed
     beside their bounds as in phase 3: decode93_pcm's columns' instance
     on both sweeps; decode93_bank on the bank's columns; decode93_pcm's
     session instance on the session batch (C = 6, both kinds) and on the
     batch with a random carried state (decode93_pcm_carry), its plain
     decode equal to the columns'; each beside the sum of the pair it
     replaced, decode93_fb + transform93_pcm (on no path), held and timed
     at the same shapes; the session instance's time a voice, on the
     batch's first 1, 2, 4 and 6 voices, and on batches of 93 rows alone
     and of Type-1 rows alone at 1 and 6 voices; the stage spans of the
     dec93b sweep and of one session93a batch (segments94's kernel time
     beside its span); the batch's device time,
     serve() x realtime over 8 batches with every gap and latency as in
     phase 9, the native trace, and the peak device memory of one batch
 13. the on-device 1994+ encoder at bench.py's enc94_dev width (64 files
     of 2.0 s, bench.py's _enc_jobs, copied as enc_jobs; 4 chunks of 16,
     Fmax 272, slots (0,0), (1,0), (1,3)): encode_files_device once with
     the counters at 0 (encode94_analyze, encode94_decide and
     encode94_select must move); all 64 streams of encode_files_device and
     of encode_batch equal the port's native host search
     (core94.encode_stream94) on the host's own coefficients, byte for
     byte; the three kernels against their plain versions at the first
     chunk's shapes, under the default params and under params that
     exercise the wrap refinement, timed beside their bounds as in phase 3
     (the decisions' operations counted from this run's candidates over
     distinct pre-adjustment columns; the analysis's as the four int8-plane
     products that int8 tensor cores run at 1,979 TOP/s, exactly; its
     coefficients compared as whole int32 words), and encode94_analyze
     beside a float64 torch.matmul of the same product (the library
     yardstick); encode94_analyze's and encode94_decide's launch geometry
     and nvcc report, and encode94_decide's reciprocal division against
     the integer division on every |a| <= 2^20 and scale table entry;
     encode94_select's two kernels' geometry, nvcc report and times each
     launched alone; x realtime of encode_files_device (128 s of audio
     over the wall time, after one warm-up), with each chunk's host prep,
     upload, device time, fetch and emit, and the peak device memory of
     one chunk
 14. the cold 1994+ sweep at bench.py's flat94_e2e defaults (music_a/b.dcs94
     and the four legacy .dcs94 streams x 24: 144 streams, 66,648 frames,
     in 4 chunks) through coldsweep.cold_flat94: each call packs every
     chunk anew (native index + trace + pack) while the one before uploads
     (pinned buffers, a copy stream), then one FlatPipeline pass and one
     checksum fetch.  One call with the counters at 0 (decode94_fb and
     transform94_pcm must move; its PCM must equal, bit for bit, the plain
     sweep of the same chunks concatenated and one warm FlatPipeline sweep
     of the catalog packed whole, itself equal to the plain sweep), one
     warm-up, 3 timed calls (each checksum the warm sweep's): x realtime
     over the wall time, per chunk the host pack, the staging and enqueue
     of the upload and the upload on the copy stream's clock, the device
     time of the one dispatch and the fetch; the peak device memory of one
     call.  In turn with those calls, the same call with a plain
     synchronous upload (the yardstick of the side-stream upload).  And the
     warm flat94 shape (the four legacy streams x 288) timed as phase 4
 15. the cold mixed catalog at bench.py's catalog_e2e defaults (those 144
     1994+ streams, music_a.dcs93b + music_b.dcs93a x 12, dense_t1(b)
     .dcs93a1 x 12) through coldsweep.cold_catalog, each family's decode
     queued behind its upload while the host packs the next: the counters
     of decode94_fb, transform94_pcm and decode93_pcm must move; the 93b
     and 93a Type-1 warm sweeps must equal their plain sweeps bit for bit;
     the total checksum must equal catalog_pipeline's on the same arrays
     and the three families' warm sweeps' summed on the host, in every
     call; x
     realtime over 3 timed calls, per family the host ms (pack and bank
     columns), frames, audio s, upload and device ms
 16. three torch.profiler traces (utils/profiling.device_trace, written to
     build/torch_trace): a cold flat94_e2e call, a served session6 batch
     (phase 9's SessionServer) and an enc94_dev chunk of 16 files (phase
     13's path).  For each: the five kernels with the most device time,
     the device's busy time (the union of kernel and copy intervals) and
     idle share of the traced window, and the three longest idle gaps with
     the host span (pack, upload, dispatch, fetch, trace, emit) over each,
     and the host spans' totals; a trace with no CUDA kernel event raises
 17. the explorer CLI (tools/explorer.py) on the card, in process through
     main(argv) with the counters at 0, on session6.zip and session93a.zip:
     --validate (session6 at the default --max-track-frames, 2,805 frames;
     session93a at 300) must print Validation Succeeded; --extract-tracks
     and --autoplay at the default cap; --extract-tracks at cap 300 on the
     card and with --backend native (the scalar decoder), every WAV byte
     for byte; each command's wall time beside the card's name and power
     limit; the counters of decode94_bank, session_mix94,
     transform94_pcm_carry and decode93_pcm_carry must move; torch.profiler
     traces of session6 --extract-tracks and session93a --autoplay (as
     phase 16: busy time, idle share, top kernels).  Then
     python -m dcsexplorer_tpu_torch.tools.explorer session6.zip --validate
     --max-track-frames 60 as a subprocess, with no --platform (the card)
 18. the sharded paths (parallel/sweep.py) over a mesh of four entries of
     this card, each shard on a side stream of its own (and over every
     card where there are more), each driven with the counters at 0:
     sharded_flat_sweep on flat94_music (decode94_fb and transform94_pcm 4
     times each; PCM bit-exact with phase 4's), sharded_sessions on the
     session6 batch (session_mix94, transform94_pcm) and on the session93a
     batch (decode93_pcm), each bit-exact with its served batch, and
     sharded_sweep of the padded model (models/batched.py: the four legacy
     streams x 72, 288 streams padded to 261 frames) over (tracks 2 x
     frames 2) against batch_decode on one device and its plain path;
     each beside one shard (device time behind a device sleep, host time,
     peak memory) and the flat sweep's layers (split + halo + upload, the
     shards' kernels, the gather); graft_entry.entry() against the CPU and
     graft_entry.dryrun_multichip(4)
 19. the host-decode hybrid (models/batched.py) at flat94_music (phase 2's
     288 streams x 1,042 frames): the native dense decode on a thread pool
     (native.decode_dense_batch) and the pack into [288, 1042, 256] slot
     arrays at the native widths, each timed on the host (3 calls after a
     warm-up); hybrid_batch_device with the counters at 0 (exactly one
     dequant_mix_dense and one transform94_pcm), its PCM bit-exact with
     phase 4's flat sweep fed the same mix and volume; the upload of the
     slots (pinned staging on the host's clock, the copies on the card's);
     dequant_mix_dense against its plain version on this run's slots and
     on random slots with duplicate and out-of-range indices, with and
     without fb_prev / active, timed beside its bound as in phase 3;
     transform94_pcm's span; the device stage on resident slots (x
     realtime, peak memory); the whole call from the stream bytes to int16
     PCM on the host (x realtime) beside cold_flat94 of the same catalog;
     the six .dcs94 assets through the hybrid (one launch of each kernel)
     against phase 5's ReferenceDecoder PCM
 20. the ROM compiler and encoder CLI (tools/encoder_cli.py, compiler/):
     240 WAVs of 2.0 s from phase 13's generator (seed 7; every third file
     at 44,100 Hz, so the resampler runs; 192 of them, the count first
     asked for, fill only 4 chips of 1 MiB, this content encoding at ~84
     kbps; 240 fill 5 and keep the bank, 62,640 frames, under the session
     wire's 64Ki row ids) and a script that plays each on a track of its own (channel i
     mod 6, a SetMixingLevel; every fourth stream at BitRate=96000: two
     parameter sets), compiled with encoder_cli.main(["--script", ...,
     "--rom-size", "1M"]) on the card with the counters at 0: one launch of
     each encoder kernel a chunk of 16 a parameter set; the set must span
     at least 5 of its 8 chips; every stream in the ROM image, found through
     its track, byte-identical with the port's host encode_pcm of its file;
     the zip loaded, its bank built on the card (decode94_bank) and one
     batch of 64 sessions x 500 frames, each starting other tracks, served
     (SessionServer), sessions 0 and 63 bit-exact with the port's
     ReferenceDecoder over 250 frames; --patch session6.zip with a script
     replacing 4 of its 6 streams: the untouched streams equal the
     prototype's bytes, the replaced ones the host encode.  Printed: the
     streams, seconds of audio, chips and stream bytes; the host parse,
     preparation and emission ms; each chunk's device ms (CUDA events
     around its launches); the layout ms; the compile's wall time and x
     realtime, beside the card's name and power limit
 21. the FLAC, MP3 and Ogg readers and the emulator: the committed
     dcsexplorer_tpu_torch/data/reader_input.{flac,mp3,ogg} read by the
     port's readers (decode ms, 3 reads each), each equal to the PCM
     pinned in reader_inputs.json; encoder_cli.main on the three and a WAV
     at 44,100 Hz with no --device (the card) with the counters at 0: one
     launch of each encoder kernel, every stream byte-identical with the
     host encode_pcm of the reader's PCM; a script naming the three on
     tracks of their own, compiled likewise (one launch each), each
     track's stream the host encode's.  Then 4 tracks of phase 20's set
     (firmware94) and of session93a.zip (firmware93), 250 frames each with
     version queries and a volume command: EmulatedDecoder (the native
     core) strict and fast against play_session on the card (the counters
     of decode94_bank and session_mix94, or decode93_pcm_carry, must
     move), bit-exact in PCM and data-port bytes, the emulator's frames/s
     and x realtime on the host; python -m dcsexplorer_tpu_torch.tools.
     explorer <phase 20's set> --extract-tracks --backend emulator-strict
     --max-track-frames 60 as a subprocess, its 240 WAVs byte-identical
     with --backend cuda's in process.  Each number beside the card's name
     and power limit
 22. the last tools: tools/make_bench_assets.py in process (--out a
     directory holding the committed manifest) with the counters at 0:
     one launch of each encoder kernel for the two 1994+ music streams;
     every stream byte-identical with the port's host encode_pcm of the
     same PCM, dense_t1(b).dcs93a1 with the committed files, the manifest
     the committed one but for the written sizes (the committed music
     predates later encoder changes: its sizes are printed beside); its
     wall time and, from a second run under torch.profiler in a fresh
     interpreter (after an untraced warm-up there), the card's busy time:
     the trace must hold the encoder's kernels, none more than 1 ms before
     its launch (the same run traced in this process is printed beside).  tools/test_all.py in process over session6.zip,
     session93a.zip and phase 20's set at --max-track-frames 30: every ROM
     .success, the counters of decode94_bank, session_mix94,
     transform94_pcm_carry and decode93_pcm_carry must move; then python
     -m dcsexplorer_tpu_torch.tools.test_all DIR --versions as a
     subprocess, rc 0.  Checkpoints (utils/state.py) on phase 20's set:
     ReferenceDecoder and emulator-strict (the native core) driven 20
     frames + 77 samples (two tracks, a volume command), snapshot,
     pickled, loaded into fresh decoders: the next 200 frames equal the
     uninterrupted run and the card's play_session of the same events
 23. the full eight-chip title (dcsbench/data/os94full/rom94full.zip, a
     bank past 64Ki rows): one batch of 640 sessions x 1,000 frames x 6
     voices (os94full.sessions' shape, each voice dealt its channel's
     tracks from the last down) through SessionServer on the wide wire,
     with the counters at 0 just before it: one launch each of
     segments94_rows32, session_mix94 and transform94_pcm and none of
     segments94; the batch equals the plain-version server on the card and
     sessions 0 and 639 the port's ReferenceDecoder (first 250 frames);
     segments94_rows32 against its plain version at that wire, timed
     beside its bound as in phase 3 (phases 7, 11 and 20 require that it
     never launches on their banks, all under 64Ki rows)
Then the script's wall time, one JSON line of per-kernel results
(launches: over all fourteen paths, each path's own printed in phases 4,
7, 10, 11, 13, 14, 15, 17, 18, 19, 20, 21, 22 and 23), and last the
{"ok": true, ...} line.
There is no CPU path: without a CUDA device the script exits 1.
"""

import contextlib
import glob
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import time
import zipfile

HERE = os.path.dirname(os.path.abspath(__file__))

# phase 22's traced make_bench_assets run, in a fresh interpreter: argv is
# the warm-up's output directory, the traced run's and the trace directory;
# prints the run's code, its launches and the trace's path as JSON
TRACED_ASSETS = r"""
import contextlib, io, json, sys
import torch
from dcsexplorer_tpu_torch.ops import kernels
from dcsexplorer_tpu_torch.tools import make_bench_assets
from dcsexplorer_tpu_torch.utils import profiling
warm, out, log_dir = sys.argv[1:4]
with contextlib.redirect_stdout(io.StringIO()):
    assert make_bench_assets.main(["--out", warm]) == 0
for k in kernels.LAUNCHES:
    kernels.LAUNCHES[k] = 0
with profiling.device_trace(log_dir) as prof:
    with contextlib.redirect_stdout(io.StringIO()):
        rc = make_bench_assets.main(["--out", out])
    torch.cuda.synchronize()
print(json.dumps({"rc": rc, "launches": kernels.LAUNCHES,
                  "trace": prof.trace_file}))
"""
STREAMS = os.path.join(HERE, "assets", "streams")
COPIES = 144                   # x (music_a, music_b): bench.py's flat94_music
SESSION6_ZIP = os.path.join(HERE, "dcsexplorer_tpu_torch", "data",
                            "session6.zip")
SESSION93A_ZIP = os.path.join(HERE, "dcsexplorer_tpu_torch", "data",
                              "session93a.zip")
DATA = os.path.join(HERE, "dcsexplorer_tpu_torch", "data")
# the eight-chip DCS-95 title of dcsbench's os94full configuration: a bank
# past 64Ki rows, so its sessions travel on the wide wire
FULL_TITLE_ZIP = os.path.join(HERE, "dcsbench", "data", "os94full",
                              "rom94full.zip")
FULL_SESSIONS, FULL_INTERVAL = 640, 261    # os94full.sessions' batch
SESSIONS, SESSION_FRAMES, VOICES, SEG_E = 320, 1000, 6, 32   # bench.py session6
COPIES93 = 72                  # x 2 streams: bench.py's dec93b and dec93a_t1
REF_FRAMES = 250               # frames held against the scalar decoder
ENC_FILES = 64                 # bench.py's enc94_dev: 64 files of 2.0 s
ROM_FILES = 240                # phase 20's WAVs of 2.0 s (see the docstring)
ROM_SESSIONS, ROM_FRAMES = 64, 500
VALIDATE_FRAMES = 30           # phase 22's test_all --max-track-frames
CKPT_FRAME, CKPT_FRAMES = 20, 200   # phase 22's checkpoint and its frames
LEGACY = ("sine_mix_1s", "noise_sweep", "tone_low", "chirpy")
FLAT94_COPIES = 288            # x LEGACY: bench.py's flat94
E2E_COPIES, E2E_CHUNKS = 24, 4  # bench.py's flat94_e2e and catalog_e2e
CAT93_COPIES = 12              # bench.py's catalog_e2e 93b and 93a Type-1
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT32_OPS_PER_S = 33.5e12      # H100 SXM: 64 INT32 lanes/SM, 132 SMs, 1.98 GHz,
                               # a multiply-add counted as two
INT8_TC_OPS_PER_S = 1.979e15   # H100 SXM int8 tensor cores (dense), likewise


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _time_ms(fn, reps, torch):
    """Mean ms per call, after one warm-up call, between two CUDA events
    around the calls as the host enqueues them: where a call's host side
    outlasts its device side, this is the host's rate (the plain versions'
    timer)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _device_ms(fn, reps, torch, sleep_s=0.05):
    """Mean device ms per call, after one warm-up call: the calls queue
    behind a device sleep of sleep_s, so the card runs them back to back
    whatever the host's cost of a call.  Raises if the sleep had ended
    before the host finished enqueuing them (the window would then hold
    host gaps)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(sleep_s * 1.98e9))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    if start.query():
        raise RuntimeError(f"the host took over {sleep_s} s to enqueue "
                           f"{reps} calls: the device sleep ran out")
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _max_abs_err(a, b, words=False):
    """The largest difference of a and b: of their low 16 bits (the
    decoders' u16 storage), or with words, of their whole values."""
    if words:
        return int((a.long() - b.long()).abs().max())
    return int(((a.long() & 0xFFFF) - (b.long() & 0xFFFF)).abs().max())


def _ptxas_lines(report, kernel):
    """nvcc's -Xptxas -v lines (registers, shared memory, spills) of the
    entry functions whose names contain ``kernel``."""
    out, on = [], False
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            on = kernel in ln
        elif on and ("Used" in ln or "spill" in ln):
            out.append(ln.replace("ptxas info    :", "").strip())
    return out


def _bound(n_bytes, n_ops, ops_per_s=INT32_OPS_PER_S):
    """(bound ms, what bounds it): the least time for these bytes and
    integer operations (at ops_per_s) on the card."""
    by = n_bytes / HBM_BYTES_PER_S * 1e3
    op = n_ops / ops_per_s * 1e3
    return (by, "bytes") if by >= op else (op, "operations")


def session_events(b):
    """Session b of bench.py's session6 (bench_session6.session_events):
    tracks 1-6 start at staggered frames, then a master-volume command."""
    events = {}
    for t in range(1, 7):
        events.setdefault((b * 7 + t * 3) % 40, []).extend([0x00, t])
    vol = 0x40 + (b % 64)
    events.setdefault(0, []).extend([0x55, 0xAA, vol, vol ^ 0xFF])
    return events


def full_title_events(b, n_tracks):
    """Session b of a batch on the full title (tracks 1..n_tracks, track
    k + 1 on channel k mod 6), os94full.sessions' shape: each voice starts
    a track of its channel every FULL_INTERVAL frames from frame
    (b * 7 + v * 3) % 40, dealt from the last track down so that session
    0's voices start on the title's last tracks; then a master volume."""
    per = n_tracks // VOICES
    events = {}
    for v in range(VOICES):
        for i, f in enumerate(range((b * 7 + v * 3) % 40, SESSION_FRAMES,
                                    FULL_INTERVAL)):
            j = per - 1 - (b * 4 + i) % per
            track = 1 + v + VOICES * j
            events.setdefault(f, []).extend([track >> 8, track & 0xFF])
    vol = 0x40 + (b % 64)
    events.setdefault(0, [])[:0] = [0x55, 0xAA, vol, vol ^ 0xFF]
    return events


def enc_jobs(n_files, seconds=2.0, rates=(31250,)):
    """bench.py's encoder jobs (_enc_jobs): n_files of int16 PCM at
    31,250 Hz, chords of four tones with AM and a noise floor, seed 7.
    File k is at rates[k % len(rates)] Hz.  Returns (jobs, seconds of
    audio)."""
    import numpy as np
    rng = np.random.default_rng(7)
    jobs = []
    for k in range(n_files):
        rate = rates[k % len(rates)]
        t = np.arange(int(rate * seconds)) / rate
        x = np.zeros_like(t)
        for f0 in (220.0, 277.2, 329.6, 440.0):
            x += 0.2 * np.sin(2 * np.pi * f0 * (1 + 0.01 * k) * t)
        x *= 0.5 + 0.5 * np.sin(2 * np.pi * (1.3 + 0.1 * k) * t)
        x += 0.01 * rng.standard_normal(t.size)
        pcm = x / np.abs(x).max() * 0.8
        jobs.append(((pcm * 32767).astype(np.int16), rate))
    return jobs, n_files * seconds


def _serve_timing(srv, n_batches, batch_audio_s):
    """serve() over n_batches batches of distinct sessions, after 3 that
    warm the pinned-memory cache: (x realtime, ms from the call to the
    first arrival and then between arrivals, each batch's latency in ms).
    The rate is all the batches' audio over the time from the call to the
    last arrival (the pipeline's fill included); a batch's latency runs
    from the start of its trace to its arrival."""
    S, T = srv.n_sessions, srv.n_frames
    batches = [[session_events(S * k + b) for b in range(S)]
               for k in range(n_batches + 3)]
    for _ in srv.serve(batches[:3]):
        pass
    prepare, starts = srv.prepare, []

    def timed_prepare(events_list):
        starts.append(time.perf_counter())
        return prepare(events_list)

    srv.prepare = timed_prepare
    t_call = time.perf_counter()
    ts = []
    for out_b in srv.serve(batches[3:]):
        ts.append(time.perf_counter())
    srv.prepare = prepare
    if len(ts) != n_batches or out_b.shape != (S, T * 240):
        raise AssertionError(f"serve(): {len(ts)} batches, {out_b.shape}")
    serve_x = n_batches * batch_audio_s / (ts[-1] - t_call)
    gaps = [1e3 * (b - a) for a, b in zip([t_call] + ts, ts)]
    latency = [1e3 * (t - a) for a, t in zip(starts, ts)]
    return serve_x, gaps, latency


def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np
    from dcsexplorer_tpu_torch import graft_entry, native
    from dcsexplorer_tpu_torch.encoder import core94 as c94
    from dcsexplorer_tpu_torch.encoder import device94 as d94
    from dcsexplorer_tpu_torch.encoder import encoder as enc
    from dcsexplorer_tpu_torch.models import batched
    from dcsexplorer_tpu_torch.models import catalogsweep as cs
    from dcsexplorer_tpu_torch.models import coldsweep as cold
    from dcsexplorer_tpu_torch.models import flatsweep as fs
    from dcsexplorer_tpu_torch.models import pipeline, romplay
    from dcsexplorer_tpu_torch.ops import band_decode as bd
    from dcsexplorer_tpu_torch.ops import decode93 as d93
    from dcsexplorer_tpu_torch.ops import kernels
    from dcsexplorer_tpu_torch.ops import transform as tf
    from dcsexplorer_tpu_torch.parallel import sweep as psweep
    from dcsexplorer_tpu_torch.refdec import decoder as rd
    from dcsexplorer_tpu_torch.rom import zipload
    from dcsexplorer_tpu_torch.tools import explorer
    from dcsexplorer_tpu_torch.utils import profiling

    dev = torch.device("cuda", 0)

    def plain_flat94(pipe, a):
        """FlatPipeline's stages through their plain versions on the
        tensors' device."""
        tabs = dict(pipe.named_buffers())
        fb = bd.decode94_fb_plain(a["pool_u8"], a["sid"], a["start_bit"].int(),
                                  a["bt_u8"], a["mix_u16"].int(), a["hdr_tab"],
                                  a["fmt_tab"], a["sub_tab"], a["n_steps"],
                                  tabs)
        return tf.transform94_pcm_plain(fb, a["vol_u8"].int(), a["sid"], tabs)

    def plain_serve_one(srv, events):
        """One batch of a SessionServer through the plain versions of its
        stages on the server's device: int16 PCM [S, T * 240] (numpy)."""
        S, T, C = srv.n_sessions, srv.n_frames, srv.n_ch
        wire, E = srv.prepare(events)
        rows, mix, vol = romplay.segments94_plain(
            torch.from_numpy(wire).to(srv.device), S, T, C, E)
        bufs = dict(srv.decoder.named_buffers())
        if srv.bank.family93:
            words = d93.session93_pcm_plain(bufs, rows, mix, vol, srv._sid,
                                            bufs)
        else:
            words = tf.transform94_pcm_plain(
                bd.session_mix94_plain(bufs["scaled"], rows, mix), vol,
                srv._sid, bufs)
        return pipeline.to_int16(words.reshape(S, T * 240)).cpu().numpy()

    # 1. card and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    t0 = time.perf_counter()
    report = kernels.build()
    kernels.load()
    kernels_s = time.perf_counter() - t0
    used = [ln.strip() for ln in report.splitlines()
            if "Used" in ln or "spill" in ln]
    print(f"phase 1 build: {kernels_s:.3f} s, "
          f"torch {torch.__version__} cuda {torch.version.cuda}; "
          + " | ".join(used))
    # the host runtime's build on its own, after nvcc's
    t0 = time.perf_counter()
    native.get_lib()
    print(f"phase 1 host runtime {native.LIB_PATH} ({len(native.SOURCES)} "
          f"sources, built alone): {time.perf_counter() - t0:.3f} s")

    # 2. the flat94_music catalog
    music = [_read(os.path.join(STREAMS, n))
             for n in ("music_a.dcs94", "music_b.dcs94")]
    t0 = time.perf_counter()
    sweep = fs.FlatSweep(music * COPIES).pack()
    arrays = sweep.compact_host_arrays()
    pack_s = time.perf_counter() - t0
    n_frames = sweep.n_frames_total
    audio_s = sweep.audio_samples / fs.SAMPLE_RATE
    print(f"phase 2 pack: {2 * COPIES} streams, {n_frames} frames, "
          f"{audio_s:.3f} s audio, n_steps {sweep.n_steps}, "
          f"pool {arrays['pool_u8'].size} B, host pack {pack_s:.3f} s")

    # 3. each kernel against its plain version on the real intermediates
    torch.zeros(1, device=dev)              # CUDA context, outside the timer
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    args = fs.packed_to_device(arrays, dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    pipe = fs.FlatPipeline(dev)
    tabs = dict(pipe.named_buffers())
    n_steps = args["n_steps"]
    cols = dict(pool_u8=args["pool_u8"], sid=args["sid"],
                start_bit=args["start_bit"], bt_u8=args["bt_u8"],
                mix=args["mix_u16"], hdr_tab=args["hdr_tab"],
                fmt_tab=args["fmt_tab"], sub_tab=args["sub_tab"],
                n_steps=n_steps, tabs=tabs)
    vol = args["vol_u8"].int()
    N, S = n_frames, len(arrays["fmt_tab"])

    # the plain chain's intermediates, for the dequant_mix checks and for
    # this run's symbol count
    header, fmt, sub, bt, btp, _ = bd.unpack_columns(
        args["sid"], args["bt_u8"], args["hdr_tab"], args["fmt_tab"],
        args["sub_tab"])
    packed, scale, total = bd.slot_controls(
        bd.band_controls_dyn(header, fmt, sub, bt, btp, tabs), tabs)
    vals = bd.decode94_symbols_plain(args["pool_u8"], args["start_bit"],
                                     packed, n_steps, tabs["cb_flat"])
    n_symbols = int((packed[:, :n_steps] != 0).sum())
    del header, fmt, sub, bt, btp, packed

    def walk_symbols(c, steps):
        """The symbols a walk over these compact columns decodes."""
        unpacked = bd.unpack_columns(c["sid"], c["bt_u8"], c["hdr_tab"],
                                     c["fmt_tab"], c["sub_tab"])
        p, _, _ = bd.slot_controls(bd.band_controls_dyn(*unpacked[:5], tabs),
                                   tabs)
        return int((p[:, :steps] != 0).sum())

    results = {}   # name -> dict of the kernels line
    times = {}     # check label -> kernel ms
    where = {      # name -> (source in csrc/, the TPU code it replaces)
        "decode94_fb": ("decode94_fb.cu",
                        "dcsexplorer_tpu/models/flatsweep.py:87"),
        "dequant_mix": ("dequant_mix.cu",
                        "dcsexplorer_tpu/ops/pallas_kernels.py:83"),
        "transform94_planar": ("transform94.cu",
                               "dcsexplorer_tpu/ops/transform.py:255"),
        "transform94_pcm": ("transform94_pcm.cu",
                            "dcsexplorer_tpu/ops/transform.py:255"),
        "decode94_bank": ("decode94_bank.cu",
                          "dcsexplorer_tpu/models/pipeline.py:76"),
        "segments94": ("segments94.cu",
                       "dcsexplorer_tpu/models/romplay.py:115"),
        "segments94_rows32": ("segments94.cu",
                              "dcsexplorer_tpu/models/romplay.py:115"),
        "session_mix94": ("session_mix94.cu",
                          "dcsexplorer_tpu/models/pipeline.py:308"),
        "transform94_pcm_carry": ("transform94_pcm.cu",
                                  "dcsexplorer_tpu/ops/transform.py:352"),
        "dequant_mix_dense": ("dequant_mix_dense.cu",
                              "dcsexplorer_tpu/ops/band_decode.py:445"),
        "encode94_analyze": ("encode94_analyze.cu",
                             "dcsexplorer_tpu/encoder/device94.py:354"),
        "encode94_decide": ("encode94_decide.cu",
                            "dcsexplorer_tpu/encoder/device94.py:114"),
        "encode94_select": ("encode94_select.cu",
                            "dcsexplorer_tpu/encoder/device94.py:155")}

    def check(name, plain_fn, kern_fn, reps_plain, reps_kern, n_bytes, n_ops,
              phase=3, shape=None, ops_per_s=INT32_OPS_PER_S, words=False):
        """Kernel against plain, both timed, beside the bound (n_ops at
        ops_per_s).  A check labelled with a ``shape`` is printed only: the
        kernels line keeps each kernel's check without one.  The outputs
        are compared as u16 storage (the decoders'), or with words as
        whole values of one dtype (torch.equal)."""
        want = plain_fn()
        got = kern_fn()
        torch.cuda.synchronize()
        pairs = list(zip(want, got)) if isinstance(want, tuple) \
            else [(want, got)]
        err = max(_max_abs_err(w, g, words) for w, g in pairs)
        label = name if shape is None else f"{name} ({shape})"
        if err != 0 or any(w.shape != g.shape for w, g in pairs) or (
                words and not all(torch.equal(w, g) for w, g in pairs)):
            raise AssertionError(f"{label}: kernel != plain (max abs err "
                                 f"{err})")
        plain_ms = _time_ms(plain_fn, reps_plain, torch)
        ms = _device_ms(kern_fn, reps_kern, torch)
        bound_ms, bound_by = _bound(n_bytes, n_ops, ops_per_s)
        times[label] = ms
        print(f"phase {phase} {label}: bit-exact, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}; {n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.3f} G "
              f"int ops at {ops_per_s / 1e12:.1f} TOP/s) = "
              f"{100 * bound_ms / ms:.1f}% of the bound")
        if shape is not None:
            return want
        results[name] = dict(
            name=name, route="cuda",
            source=f"dcsexplorer_tpu_torch/csrc/{where[name][0]}",
            replaces=where[name][1], launches=0, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None)
        return want

    # decode94_fb reads sid, start_bit, mix (4 B), 16 band-type bytes per
    # frame, the pool and the per-stream tables once, and writes [N, 512];
    # per decoded symbol ~6 integer operations (extract, look up, re-centre,
    # scale, mix multiply-add, shift)
    fb = check("decode94_fb", lambda: bd.decode94_fb_plain(**cols),
               lambda: kernels.decode94_fb(**cols), 2, 20,
               N * (4 + 4 + 16 + 4) + arrays["pool_u8"].size + S * 18
               + N * 512 * 4, 6 * n_symbols)
    # the same launch with no position to walk: the table copies and the
    # stores of all-zero frame buffers, the floor under the walk
    no_walk = dict(cols, n_steps=0)
    no_walk_ms = _device_ms(lambda: kernels.decode94_fb(**no_walk), 20, torch)
    print(f"phase 3 decode94_fb with n_steps 0 (no walk, stores only): "
          f"{no_walk_ms:.4f} ms")

    # decode94_bank on the same columns without the mix: the walk, and one
    # 512-byte row of scaled samples a frame; ~4 integer operations a
    # decoded symbol (extract, look up, re-centre, scale)
    bank_cols = {k: v for k, v in cols.items() if k != "mix"}
    check("decode94_bank", lambda: bd.decode94_bank_plain(**bank_cols),
          lambda: kernels.decode94_bank(**bank_cols), 2, 20,
          N * (4 + 4 + 16) + arrays["pool_u8"].size + S * 18
          + (N + 1) * 256 * 2, 4 * n_symbols)

    mix = args["mix_u16"]
    check("dequant_mix", lambda: bd.dequant_mix_plain(vals, (scale, total),
                                                      mix),
          lambda: kernels.dequant_mix(vals, scale, total, mix), 3, 20,
          N * (256 * 4 * 2 + 4 + 4 + 512 * 4), 3 * N * 256)
    # the multi-voice form (prior frame buffers) on the same samples
    gen = torch.Generator(device=dev).manual_seed(0)
    prev = torch.randint(0, 1 << 16, (n_frames, 512), generator=gen,
                         device=dev, dtype=torch.int32)
    err_prev = _max_abs_err(
        bd.dequant_mix_plain(vals, (scale, total), mix, prev),
        kernels.dequant_mix(vals, scale, total, mix, prev))
    if err_prev != 0:
        raise AssertionError(f"dequant_mix with fb_prev: max abs err {err_prev}")
    print("phase 3 dequant_mix with random fb_prev: bit-exact")
    del prev, vals, scale, total

    # transform reads words 0..$101 of each frame buffer and the volume
    # shift, writes two [N, 128] planes; ~5,800 integer operations a frame
    # (three pre-passes and six radix-2 stages over 64 complex pairs)
    check("transform94_planar",
          lambda: tf.transform94_planar_plain(fb, vol, tabs),
          lambda: kernels.transform94_planar(fb, vol, tabs["p2_c0"],
                                             tabs["p2_c1"], tabs["cos"],
                                             tabs["sin"]), 3, 20,
          N * (258 * 4 + 4 + 2 * 128 * 4), 5800 * N)
    # transform94_pcm reads the same words, the volume shift and the stream
    # id, and writes [N, 240]; the transform's operations plus 16 blends of
    # ~6 operations a frame
    sid = args["sid"]
    check("transform94_pcm",
          lambda: tf.transform94_pcm_plain(fb, vol, sid, tabs),
          lambda: kernels.transform94_pcm(fb, vol, sid, tabs), 3, 20,
          N * (258 * 4 + 4 + 4 + 240 * 4), 5900 * N)
    del fb

    # 4. the whole sweep through the kernels
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    pcm = pipe(**args)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    on_path = ("decode94_fb", "transform94_pcm")
    if not all(launches[k] > 0 for k in on_path):
        raise AssertionError(f"a kernel of the path did not launch: {launches}")
    for k, r in results.items():
        r["launches"] = launches[k]
    plain_pipe = lambda **a: plain_flat94(pipe, a)
    pcm_plain = plain_pipe(**args)
    err = _max_abs_err(pcm, pcm_plain)
    if err != 0 or pcm.shape != (n_frames, 240):
        raise AssertionError(f"sweep PCM != plain sweep (max abs err {err})")
    if not bool((pcm >= 0).all() & (pcm <= 0xFFFF).all()):
        raise AssertionError("sweep PCM outside u16 storage")
    del pcm_plain
    flat_pcm = pcm                      # phase 18's reference
    sweep_ms = _device_ms(lambda: pipe(**args), 5, torch)
    # the host's side of one sweep: the time to enqueue it, with the card
    # idle at the start and no synchronise inside the timer
    enqueue = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe(**args)
        enqueue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    enqueue_ms = sum(enqueue) / len(enqueue)
    plain_sweep_ms = _time_ms(lambda: plain_pipe(**args), 2, torch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    pipe(**args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"phase 4 sweep: launches {launches}, PCM bit-exact with the "
          f"plain sweep; device {sweep_ms:.3f} ms = "
          f"{audio_s / (sweep_ms / 1e3):.1f}x realtime "
          f"(plain {plain_sweep_ms:.3f} ms = "
          f"{audio_s / (plain_sweep_ms / 1e3):.1f}x); host enqueue of one "
          f"sweep {enqueue_ms:.4f} ms (min {min(enqueue):.4f}, max "
          f"{max(enqueue):.4f}); "
          f"upload {upload_s * 1e3:.3f} ms; peak memory of one sweep "
          f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above "
          f"the resident inputs)")

    # 5. every .dcs94 asset against the scalar reference decoder
    paths = sorted(glob.glob(os.path.join(STREAMS, "*.dcs94")))
    streams = [_read(p) for p in paths]
    sw6 = fs.FlatSweep(streams).pack()
    got = fs.to_int16(pipe(**fs.packed_to_device(sw6.compact_host_arrays(),
                                                 dev)))
    t0 = time.perf_counter()
    pos = 0
    ref94 = {}                          # asset -> the scalar decoder's PCM
    for p, s in zip(paths, streams):
        nf = (s[0] << 8) | s[1]
        want = ref94[p] = fs.reference_pcm(s, nf)
        seg = got[pos:pos + nf * 240]
        if not np.array_equal(want, seg):
            bad = np.nonzero(want != seg)[0]
            raise AssertionError(f"{os.path.basename(p)}: {bad.size} samples "
                                 f"differ from the reference, first {bad[0]}")
        pos += nf * 240
    if pos != got.size:
        raise AssertionError(f"{got.size - pos} samples past the last stream")
    print(f"phase 5 reference: {len(paths)} streams, "
          f"{sw6.n_frames_total} frames bit-exact with the port's "
          f"ReferenceDecoder ({time.perf_counter() - t0:.3f} s scalar)")

    # 6. stage spans of the sweep (FlatPipeline.forward's steps, in order).
    # A 0.1 s device sleep first lets the host enqueue every stage before
    # the card reaches them, so the spans hold device time only.
    names = ("unpack", "decode94_fb", "transform94_pcm")
    spans = {k: [] for k in names}
    for rep in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda._sleep(int(0.1 * 1.98e9))
        ev[0].record()
        sb, mx, vs = (args["start_bit"].int(), args["mix_u16"].int(),
                      args["vol_u8"].int())
        ev[1].record()
        fb = bd.decode94_fb(args["pool_u8"], args["sid"], sb, args["bt_u8"],
                            mx, args["hdr_tab"], args["fmt_tab"],
                            args["sub_tab"], n_steps, tabs)
        ev[2].record()
        out = tf.transform94_pcm(fb, vs, args["sid"], tabs)
        ev[3].record()
        torch.cuda.synchronize()
        if rep:                                   # the first is a warm-up
            for k, a, b in zip(names, ev, ev[1:]):
                spans[k].append(a.elapsed_time(b))
    if _max_abs_err(out, pcm) != 0:
        raise AssertionError("stage-span run != sweep PCM")
    mean = {k: sum(v) / len(v) for k, v in spans.items()}
    print("phase 6 stage spans (ms, mean of 3): "
          + ", ".join(f"{k} {v:.4f} (min {min(spans[k]):.4f}, "
                      f"max {max(spans[k]):.4f})" for k, v in mean.items())
          + f"; sum {sum(mean.values()):.4f}")

    del fb, out, pcm, args, cols, bank_cols
    torch.cuda.empty_cache()

    # 7. the session path, once, through the entry points a user calls
    S, T, C = SESSIONS, SESSION_FRAMES, VOICES
    batch = [session_events(b) for b in range(S)]
    session_audio_s = S * T * 240 / fs.SAMPLE_RATE
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    rs, _ = zipload.load_zip_file(SESSION6_ZIP)
    if rs.check() != 1 or rs.os_version != rd.OS94:
        raise AssertionError("session6.zip does not load as an OS94 ROM")
    bank = romplay.build_rom_bank(rs, dev)
    torch.cuda.synchronize()
    bank_s = time.perf_counter() - t0
    srv = romplay.SessionServer(rs, S, T, n_ch=C, seg_e=SEG_E, bank=bank,
                                device=dev)
    got = srv.serve_one(batch)
    one, _ = romplay.play_session(
        rs, {f: (lambda d, bs=tuple(bs): [d.write_data_port(x) for x in bs])
             for f, bs in batch[0].items()}, T, bank=bank)
    torch.cuda.synchronize()
    s_launches = dict(kernels.LAUNCHES)
    on_session_path = ("decode94_bank", "segments94", "session_mix94",
                       "transform94_pcm", "transform94_pcm_carry")
    if not all(s_launches[k] > 0 for k in on_session_path) \
            or s_launches["segments94_rows32"]:
        raise AssertionError(f"a kernel of the session path did not launch, "
                             f"or the wide wire's did: {s_launches}")
    if got.shape != (S, T * 240) or got.dtype != np.int16:
        raise AssertionError(f"session batch {got.shape} {got.dtype}")
    # the bank the batch ran on, against the plain version on its columns
    bcols = bank.columns()
    b_steps = bcols.pop("n_steps")
    bargs = {k: torch.tensor(v, device=dev) for k, v in bcols.items()}
    want_bank = bd.decode94_bank_plain(**bargs, n_steps=b_steps, tabs=tabs)
    err = _max_abs_err(want_bank, bank.scaled)
    if err != 0 or want_bank.shape != bank.scaled.shape:
        raise AssertionError(f"session6 bank != decode94_bank_plain (max abs "
                             f"err {err})")
    del want_bank
    print(f"phase 7 sessions: session6.zip, bank {bank.total_rows()} rows "
          f"built in {bank_s:.3f} s (load + prescan + decode94_bank), "
          f"bit-exact with decode94_bank_plain (n_steps {b_steps}); one "
          f"batch of {S} sessions x {T} frames x {C} voices "
          f"({session_audio_s:.1f} s audio) through SessionServer and "
          f"session 0 through play_session, launches {s_launches}")
    # decode94_bank at the bank's own shape (phase 3 times it at the flat
    # catalog's): bytes and operations counted as there
    Nb, Sb = bargs["sid"].shape[0], bargs["hdr_tab"].shape[0]
    check("decode94_bank",
          lambda: bd.decode94_bank_plain(**bargs, n_steps=b_steps, tabs=tabs),
          lambda: kernels.decode94_bank(**bargs, n_steps=b_steps, tabs=tabs),
          2, 20, Nb * (4 + 4 + 16) + bargs["pool_u8"].numel() + Sb * 18
          + (Nb + 1) * 256 * 2, 4 * walk_symbols(bargs, b_steps), phase=7,
          shape=f"session6 bank, {Nb + 1} rows, n_steps {b_steps}")
    del bargs

    # 8. the batch against the plain path on the card and the scalar decoder
    with romplay.SessionServer(rs, S, T, n_ch=C, seg_e=SEG_E, bank=bank,
                               device=dev) as plain_srv:
        want = plain_serve_one(plain_srv, batch)
    if not np.array_equal(want, got):
        bad = np.argwhere(want != got)
        raise AssertionError(f"session batch != plain batch at {bad.shape[0]}"
                             f" samples, first (session, sample) {bad[0]}")
    del want
    if not np.array_equal(one, got[0]):
        raise AssertionError("play_session != the served batch's session 0")
    t0 = time.perf_counter()
    for b in (0, S - 1):
        dec = rd.ReferenceDecoder()
        dec.default_volume = 0x67
        dec.load_rom_set(rs)
        dec.soft_boot()
        ref = []
        for f in range(REF_FRAMES):
            for byte in batch[b].get(f, ()):
                dec.write_data_port(byte)
            ref.extend(dec.next_samples(240))
        ref = np.array(ref, dtype=np.int16)
        if not np.array_equal(ref, got[b, :REF_FRAMES * 240]):
            bad = np.nonzero(ref != got[b, :REF_FRAMES * 240])[0]
            raise AssertionError(f"session {b}: {bad.size} samples differ "
                                 f"from the scalar decoder, first {bad[0]}")
        if not np.abs(ref.astype(np.int32)).max() > 0:
            raise AssertionError(f"session {b} is silent")
    print(f"phase 8 sessions: PCM of all {S} sessions bit-exact with the "
          f"plain batch on the card; session 0 with play_session's; "
          f"sessions 0 and {S - 1} bit-exact with "
          f"the port's ReferenceDecoder over {REF_FRAMES} frames "
          f"({time.perf_counter() - t0:.3f} s scalar)")

    # the session kernels at the batch's shapes
    wire_np, E = srv.prepare(batch)
    wire = torch.tensor(wire_np, device=dev)
    tabs = dict(srv.decoder.named_buffers())
    scaled, F, R = srv.decoder.scaled, S * T, bank.total_rows()
    # segments94 reads the wire and writes rows, mix [F, C] and vol [F]; a
    # compare (does the next segment start here?) and a multiply-add an
    # output
    rows, mixes, vols = check(
        "segments94", lambda: romplay.segments94_plain(wire, S, T, C, E),
        lambda: kernels.segments94(wire, S, T, C, E), 2, 20,
        wire.numel() + F * C * 8 + F * 4, F * C * 3, phase=8)
    # session_mix94 reads rows, mix and the bank once and writes [F, 512];
    # ~3 operations per position and voice (multiply-add, shift)
    fbs = check(
        "session_mix94", lambda: bd.session_mix94_plain(scaled, rows, mixes),
        lambda: kernels.session_mix94(scaled, rows, mixes), 1, 20,
        F * C * 8 + R * 256 * 2 + F * 512 * 4, 3 * 256 * C * F, phase=8)
    gen = torch.Generator(device=dev).manual_seed(1)
    ov0 = torch.randint(0, 1 << 16, (S, 16), generator=gen, device=dev,
                        dtype=torch.int32)
    sid = torch.arange(S, dtype=torch.int32, device=dev).repeat_interleave(T)
    check("transform94_pcm_carry",
          lambda: tf.transform94_pcm_plain(fbs, vols, sid, tabs, ov0),
          lambda: kernels.transform94_pcm(fbs, vols, sid, tabs, ov0), 1, 20,
          F * (258 * 4 + 4 + 4 + 240 * 4) + S * 16 * 4 * 2, 5900 * F,
          phase=8)
    del rows, mixes, vols, fbs
    for k, r in results.items():        # phase 4's launches and phase 7's
        r["launches"] += s_launches[k]

    # 9. session timing
    batch_ms = _device_ms(lambda: srv.decode_wire(wire, E), 5, torch)
    names = ("segments94", "session_mix94", "transform94_pcm", "int16")
    spans = {k: [] for k in names}
    for rep in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        torch.cuda._sleep(int(0.1 * 1.98e9))
        ev[0].record()
        rows, mixes, vols = romplay.segments94(wire, S, T, C, E)
        ev[1].record()
        fbs = bd.session_mix94(scaled, rows, mixes)
        ev[2].record()
        words = tf.transform94_pcm(fbs, vols, sid, tabs)
        ev[3].record()
        pcm16 = pipeline.to_int16(words)
        ev[4].record()
        torch.cuda.synchronize()
        if rep:
            for k, a, b in zip(names, ev, ev[1:]):
                spans[k].append(a.elapsed_time(b))
    if not np.array_equal(pcm16.reshape(S, -1).cpu().numpy(), got):
        raise AssertionError("session span run != served batch")
    smean = {k: sum(v) / len(v) for k, v in spans.items()}
    del rows, mixes, vols, fbs, words
    # the host's side of one batch: the native trace + wire, and the
    # enqueue of upload, kernels and the fetch (no synchronise inside)
    trace_ms = []
    for k in range(3):
        t0 = time.perf_counter()
        srv.prepare([session_events(S * (k + 1) + b) for b in range(S)])
        trace_ms.append((time.perf_counter() - t0) * 1e3)
    enq_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done, _ = srv._enqueue(wire_np, E)
        enq_ms.append((time.perf_counter() - t0) * 1e3)
        done.synchronize()
    # the wire's upload from pinned and from pageable memory (the server
    # uploads from pageable), host clock to a synchronise
    wire_host = torch.from_numpy(wire_np)
    up_ms = {}
    for name, up in (("pinned", lambda: wire_host.pin_memory().to(
            dev, non_blocking=True)), ("pageable", lambda: wire_host.to(dev))):
        ts_up = []
        for _ in range(21):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            up()
            torch.cuda.synchronize()
            ts_up.append((time.perf_counter() - t0) * 1e3)
        up_ms[name] = sum(ts_up[1:]) / 20
    # the PCM fetch, into pinned and into pageable host memory
    pinned = torch.empty(pcm16.shape, dtype=pcm16.dtype, pin_memory=True)
    fetch_pinned = _time_ms(lambda: pinned.copy_(pcm16, non_blocking=True),
                            5, torch)
    fetch_pageable = _time_ms(lambda: pcm16.cpu(), 5, torch)
    del pinned
    n_batches = 8
    serve_x, gaps, latency = _serve_timing(srv, n_batches, session_audio_s)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    srv.decode_wire(wire, E)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"phase 9 sessions: device time of one batch {batch_ms:.4f} ms = "
          f"{session_audio_s / (batch_ms / 1e3):.1f}x realtime; spans (ms, "
          f"mean of 3) " + ", ".join(f"{k} {v:.4f}" for k, v in smean.items())
          + f", sum {sum(smean.values()):.4f} (segments94's kernel time "
          f"{times['segments94']:.4f} ms = "
          f"{times['segments94'] / smean['segments94']:.3f} of its span); "
          f"serve() over {n_batches} "
          f"batches {serve_x:.1f}x realtime (ms from the call to the first "
          f"arrival, then between arrivals: "
          + ", ".join(f"{g:.1f}" for g in gaps) + "; latency from the start "
          "of the trace ms: " + ", ".join(f"{a:.1f}" for a in latency)
          + f"); native trace + wire "
          f"of one batch {sum(trace_ms) / 3:.2f} ms (min {min(trace_ms):.2f},"
          f" max {max(trace_ms):.2f}); host enqueue of one batch "
          f"{sum(enq_ms) / 5:.3f} ms (min {min(enq_ms):.3f}, max "
          f"{max(enq_ms):.3f}); wire upload {wire_np.size} B: pinned "
          f"{up_ms['pinned']:.3f} ms, pageable {up_ms['pageable']:.3f} ms; "
          f"PCM fetch {pcm16.numel() * 2 / 1e6:.1f} MB: "
          f"pinned {fetch_pinned:.3f} ms, pageable {fetch_pageable:.3f} ms; "
          f"peak memory of one batch {peak / 2**30:.3f} GiB "
          f"({(peak - base) / 2**30:.3f} GiB above the resident bank and "
          f"inputs); E {E}")

    del wire, scaled
    torch.cuda.empty_cache()

    # 10. the flat 1993 sweeps at bench.py's width (dec93b, dec93a_t1),
    # through the entry points a user calls
    where.update({
        "decode93_fb": ("decode93_fb.cu",
                        "dcsexplorer_tpu/ops/decode93.py:197"),
        "transform93_pcm": ("transform93_pcm.cu",
                            "dcsexplorer_tpu/ops/transform.py:490"),
        "transform93_pcm_carry": ("transform93_pcm.cu",
                                  "dcsexplorer_tpu/ops/transform.py:586"),
        "decode93_pcm": ("decode93_pcm.cu",
                         "dcsexplorer_tpu/ops/decode93.py:197"),
        "decode93_pcm_carry": ("decode93_pcm.cu",
                               "dcsexplorer_tpu/ops/transform.py:586"),
        "decode93_bank": ("decode93_bank.cu",
                          "none: the mix-independent part of "
                          "dcsexplorer_tpu/models/pipeline.py:244 "
                          "(device_decode93), moved to set-up")})
    sweeps93 = {}
    for name, files, t1 in (
            ("dec93b", ("music_a.dcs93b", "music_b.dcs93a"), False),
            ("dec93a_t1", ("dense_t1.dcs93a1", "dense_t1b.dcs93a1"), True)):
        streams = [_read(os.path.join(STREAMS, n)) for n in files]
        t0 = time.perf_counter()
        sw = cs.Flat93Sweep(streams * COPIES93, t1)
        wire93 = sw.compact_host_arrays()
        pack_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cols93 = cs.packed93_to_device(wire93, dev)
        torch.cuda.synchronize()
        sweeps93[name] = dict(t1=t1, streams=streams, sweep=sw, cols=cols93,
                              pack_s=pack_s,
                              unpack_s=time.perf_counter() - t0)
    pipe93 = cs.Flat93Pipeline(dev)
    tabs93 = dict(pipe93.named_buffers())
    plain93 = lambda mix, vol, **c: d93.decode93_pcm_plain(c, None, mix, vol,
                                                           c["sid"], tabs93)
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    for sw93 in sweeps93.values():
        sw93["pcm"] = pipe93(**sw93["cols"])
    torch.cuda.synchronize()
    f93_launches = dict(kernels.LAUNCHES)
    if f93_launches["decode93_pcm"] != len(sweeps93) or any(
            f93_launches[k] for k in ("decode93_fb", "transform93_pcm")):
        raise AssertionError(f"the 1993 sweeps did not run through "
                             f"decode93_pcm alone: {f93_launches}")
    print(f"phase 10 launches of the two sweeps: {f93_launches}")
    for name, sw93 in sweeps93.items():
        cols93, pcm = sw93["cols"], sw93["pcm"]
        n93 = sw93["sweep"].n_frames_total
        err = _max_abs_err(pcm, plain93(**cols93))
        if err != 0 or pcm.shape != (n93, 240):
            raise AssertionError(f"{name}: sweep PCM != plain sweep (max abs "
                                 f"err {err})")
        if not bool((pcm >= 0).all() & (pcm <= 0xFFFF).all()):
            raise AssertionError(f"{name}: sweep PCM outside u16 storage")
        audio93 = sw93["sweep"].audio_samples / fs.SAMPLE_RATE
        ms = _device_ms(lambda: pipe93(**cols93), 5, torch)
        enqueue = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe93(**cols93)
            enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        plain_ms = _time_ms(lambda: plain93(**cols93), 1, torch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        pipe93(**cols93)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"phase 10 {name}: {len(sw93['streams']) * COPIES93} streams, "
              f"{n93} frames, {audio93:.3f} s audio, pool "
              f"{cols93['pool_u8'].numel()} B; host pack {sw93['pack_s']:.3f}"
              f" s, host unpack + upload {sw93['unpack_s'] * 1e3:.3f} ms; "
              f"PCM bit-exact with the plain sweep; "
              f"device {ms:.3f} ms = {audio93 / (ms / 1e3):.1f}x realtime "
              f"(plain {plain_ms:.3f} ms = {audio93 / (plain_ms / 1e3):.1f}x)"
              f"; host enqueue {sum(enqueue) / 5:.4f} ms (min "
              f"{min(enqueue):.4f}, max {max(enqueue):.4f}); peak memory of "
              f"one sweep {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} "
              f"GiB above the resident inputs)")

    # every .dcs93* asset through the sweep against the scalar decoder
    t0 = time.perf_counter()
    n_ref = 0
    for name, sw93 in sweeps93.items():
        one_copy = cs.Flat93Sweep(sw93["streams"], sw93["t1"])
        got = cs.run_flat93(one_copy, dev)
        pos = 0
        for s93 in sw93["streams"]:
            nf = (s93[0] << 8) | s93[1]
            want = fs.reference_pcm(s93, nf,
                                    rd.OS93A if sw93["t1"] else rd.OS93B,
                                    cs.MIXING_LEVEL, cs.MASTER_VOLUME)
            seg = got[pos:pos + nf * 240]
            if not np.array_equal(want, seg) or not np.abs(want).max() > 0:
                bad = np.nonzero(want != seg)[0]
                raise AssertionError(f"{name}: a stream of {nf} frames: "
                                     f"{bad.size} samples differ from the "
                                     f"reference (or it is silent)")
            pos += nf * 240
            n_ref += nf
        if pos != got.size:
            raise AssertionError(f"{name}: {got.size - pos} samples past the "
                                 f"last stream")
    print(f"phase 10 reference: the four .dcs93* assets ({n_ref} frames) "
          f"bit-exact with the port's ReferenceDecoder, OS93b for the 93b / "
          f"93a Type-0 wire and OS93a for Type-1 "
          f"({time.perf_counter() - t0:.3f} s scalar)")

    # 11. the 1993 session path at session6's serving width: session93a.zip
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    rs93, _ = zipload.load_zip_file(SESSION93A_ZIP)
    if rs93.check() != 1 or rs93.os_version != rd.OS93A:
        raise AssertionError("session93a.zip does not load as an OS93a ROM")
    bank93 = romplay.build_rom_bank(rs93, dev)
    torch.cuda.synchronize()
    bank93_s = time.perf_counter() - t0
    srv93 = romplay.SessionServer(rs93, S, T, n_ch=C, seg_e=SEG_E,
                                  bank=bank93, device=dev)
    got93 = srv93.serve_one(batch)
    one93, _ = romplay.play_session(
        rs93, {f: (lambda d, bs=tuple(bs): [d.write_data_port(x) for x in bs])
               for f, bs in batch[0].items()}, T, bank=bank93)
    torch.cuda.synchronize()
    s93_launches = dict(kernels.LAUNCHES)
    if not all(s93_launches[k] > 0 for k in (
            "segments94", "decode93_pcm", "decode93_pcm_carry",
            "decode93_bank")) or any(
            s93_launches[k] for k in ("decode93_fb", "transform93_pcm",
                                      "transform93_pcm_carry",
                                      "segments94_rows32")):
        raise AssertionError(f"the 1993 session path did not run through "
                             f"decode93_bank, segments94 and decode93_pcm: "
                             f"{s93_launches}")
    if got93.shape != (S, T * 240) or got93.dtype != np.int16:
        raise AssertionError(f"session93a batch {got93.shape} {got93.dtype}")
    want = plain_serve_one(srv93, batch)
    if not np.array_equal(want, got93):
        bad = np.argwhere(want != got93)
        raise AssertionError(f"session93a batch != plain batch at "
                             f"{bad.shape[0]} samples, first (session, "
                             f"sample) {bad[0]}")
    del want
    if not np.array_equal(one93, got93[0]):
        raise AssertionError("session93a: play_session != the served "
                             "batch's session 0")
    silent = np.nonzero(np.abs(got93.astype(np.int32)).max(axis=1) == 0)[0]
    if silent.size:
        raise AssertionError(f"session93a: {silent.size} silent sessions, "
                             f"first {silent[0]}")
    t0 = time.perf_counter()
    for b in (0, S - 1):
        dec = rd.ReferenceDecoder()
        dec.default_volume = 0x67
        dec.load_rom_set(rs93)
        dec.soft_boot()
        ref = []
        for f in range(REF_FRAMES):
            for byte in batch[b].get(f, ()):
                dec.write_data_port(byte)
            ref.extend(dec.next_samples(240))
        ref = np.array(ref, dtype=np.int16)
        if not np.array_equal(ref, got93[b, :REF_FRAMES * 240]):
            bad = np.nonzero(ref != got93[b, :REF_FRAMES * 240])[0]
            raise AssertionError(f"session93a {b}: {bad.size} samples differ "
                                 f"from the scalar decoder, first {bad[0]}")
    kinds93 = bank93.cols["kind_u8"].cpu().numpy()
    print(f"phase 11 sessions93: session93a.zip, bank {bank93.total_rows()} "
          f"rows ({int((kinds93 == d93.ROW_93).sum())} of the 93 bands, "
          f"{int((kinds93 == d93.ROW_93A).sum())} OS93a Type-1; pool "
          f"{bank93.cols['pool_u8'].numel()} B) built in {bank93_s:.3f} s "
          f"(load + prescan + decode93_bank); one batch of {S} sessions x {T} "
          f"frames x {C} voices through SessionServer and session 0 through "
          f"play_session, launches {s93_launches}; PCM of all {S} sessions "
          f"bit-exact with the plain batch on the card, none silent; session "
          f"0 with play_session's; sessions 0 and {S - 1} bit-exact with the "
          f"port's ReferenceDecoder over {REF_FRAMES} frames "
          f"({time.perf_counter() - t0:.3f} s scalar)")

    # 12. the 1993 kernels against their plain versions at the paths' shapes:
    # decode93_pcm, and the pair it replaced (decode93_fb, transform93_pcm,
    # on no path) as its yardstick in the same run
    inputs93 = tabs93["inputs"].long()
    t0 = time.perf_counter()
    bad = kernels.normalize93_check(dev)
    if bad:
        raise AssertionError(f"normalize93: the closed form differs from the "
                             f"31-step loop on {bad} inputs")
    print(f"phase 12 normalize93: decode93_pcm.cu's __clz form equals the "
          f"31-step loop on all 2^32 inputs "
          f"({time.perf_counter() - t0:.3f} s)")

    def decode93_work(cols, rows):
        """(93 band cells, 93a inputs) that these rows decode (rows None:
        each row once)."""
        a93, a93a = d93.unpack_columns93(cols)
        cells = torch.where(a93["kind"] != d93.K_NONE, a93["n_samp"],
                            0).sum(1)
        ins = torch.where(a93a["bits"] > 0, inputs93[None, :], 0).sum(1)
        if rows is not None:
            cells, ins = cells[rows.long()], ins[rows.long()]
        return int(cells.sum()), int(ins.sum())

    def decode93_cost(cols, rows, mix):
        """(bytes, operations) of the decode: each bank row's columns once
        (frame_word, sid, kind, kw, bit_rel, prv, code: 181 B), the rows and
        mixes, the pool and the band tables; ~12 integer operations a 93
        band cell (extract, sign-extend, chain, scale, mix multiply-add) and
        ~16 a 93a input (extract, pair look-up, two rounded multiply-adds)"""
        R = cols["frame_word"].shape[0]
        cells, ins = decode93_work(cols, rows)
        return (R * 181 + cols["pool_u8"].numel()
                + cols["band_tab"].numel() * 4 + mix.numel() * 4
                * (1 if rows is None else 2)), 12 * cells + 16 * ins

    def check_decode93(cols, rows, mix, shape=None):
        # the decode's bytes and operations, and [F, 512] written
        n_bytes, n_ops = decode93_cost(cols, rows, mix)
        return check(
            "decode93_fb",
            lambda: d93.decode93_fb_plain(cols, rows, mix, tabs93),
            lambda: kernels.decode93_fb(*(cols[k] for k in d93.COLUMNS),
                                        rows, mix, tabs93["pair"],
                                        tabs93["inputs"]),
            1, 20, n_bytes + mix.shape[0] * 512 * 4, n_ops, phase=12,
            shape=shape)

    # transform93_pcm reads words 0..255 of each frame buffer, the volume
    # shift and the stream id, and writes [N, 240]; ~15,000 integer
    # operations a frame, counted as phase 3 counts the 1994 transform
    # (~15 a butterfly: seven radix-2 stages of 128 butterflies, the
    # expansion, the slot-0 fix-up, the volume shift and 16 blends)
    def check_transform93(fb, vol, fsid, ov0=None, shape=None):
        n = fb.shape[0]
        return check(
            "transform93_pcm" if ov0 is None else "transform93_pcm_carry",
            lambda: tf.transform93_pcm_plain(fb, vol, fsid, tabs93, ov0),
            lambda: kernels.transform93_pcm(fb, vol, fsid, tabs93, ov0),
            1, 20, n * (256 * 4 + 4 + 4 + 240 * 4)
            + (0 if ov0 is None else ov0.numel() * 4 * 2), 15000 * n,
            phase=12, shape=shape)

    # decode93_pcm's columns' instance (the flat sweep): the decode's bytes
    # and operations, the volume shift and the stream id, 960 B of PCM a
    # frame, plus the transform's 15,000 operations a frame
    def check_decode93_pcm(cols, shape=None):
        mix, vol, fsid = cols["mix"], cols["vol"], cols["sid"]
        n_bytes, n_ops = decode93_cost(cols, None, mix)
        n = mix.shape[0]
        return check(
            "decode93_pcm",
            lambda: d93.decode93_pcm_plain(cols, None, mix, vol, fsid,
                                           tabs93),
            lambda: kernels.decode93_pcm(*(cols[k] for k in d93.COLUMNS),
                                         mix, vol, fsid, tabs93),
            1, 20, n_bytes + n * (4 + 4 + 240 * 4), n_ops + 15000 * n,
            phase=12, shape=shape)

    def against_pair(shape, fused, dec, tra):
        print(f"phase 12 {shape}: decode93_pcm {times[fused]:.4f} ms against "
              f"decode93_fb + transform93_pcm {times[dec]:.4f} + "
              f"{times[tra]:.4f} = {times[dec] + times[tra]:.4f} ms "
              f"({(times[dec] + times[tra]) / times[fused]:.2f}x)")

    c93 = sweeps93["dec93b"]["cols"]
    fb93 = check_decode93(c93, None, c93["mix"])
    check_transform93(fb93, c93["vol"], c93["sid"])
    del fb93
    check_decode93_pcm(c93)
    against_pair("dec93b", "decode93_pcm", "decode93_fb", "transform93_pcm")
    ct1 = sweeps93["dec93a_t1"]["cols"]
    shape = "dec93a_t1, OS93a Type-1"
    fb93 = check_decode93(ct1, None, ct1["mix"], shape=shape)
    check_transform93(fb93, ct1["vol"], ct1["sid"], shape=shape)
    del fb93
    check_decode93_pcm(ct1, shape=shape)
    against_pair(shape, f"decode93_pcm ({shape})", f"decode93_fb ({shape})",
                 f"transform93_pcm ({shape})")

    # the session batch's shapes: C = 6 voices of both row kinds, without
    # and with a random carried state.  Its yardstick, the pair decode93_fb
    # + transform93_pcm, reads the bank's columns (kept on the host) on the
    # card
    wire_np93, E93 = srv93.prepare(batch)
    wire93 = torch.tensor(wire_np93, device=dev)
    check("segments94", lambda: romplay.segments94_plain(wire93, S, T, C, E93),
          lambda: kernels.segments94(wire93, S, T, C, E93), 2, 20,
          wire93.numel() + S * T * C * 8 + S * T * 4, S * T * C * 3,
          phase=12, shape="session93a wire")
    rows93, mixes93, vols93 = romplay.segments94(wire93, S, T, C, E93)
    bcols = {k: v.to(dev) for k, v in bank93.cols.items()}
    sbank = bank93.bank93
    bkind = bcols["kind_u8"][rows93.long()]
    mixed = int(((bkind == d93.ROW_93).any(1)
                 & (bkind == d93.ROW_93A).any(1)).sum())
    shape = f"session93a batch, C = {C}, {mixed} frames of both kinds"
    fbs93 = check_decode93(bcols, rows93, mixes93, shape=shape)
    check_transform93(fbs93, vols93, sid, shape=shape)
    gen = torch.Generator(device=dev).manual_seed(2)
    ov93 = torch.randint(0, 1 << 16, (S, 16), generator=gen, device=dev,
                         dtype=torch.int32)
    check_transform93(fbs93, vols93, sid, ov93)
    del fbs93
    # the session bank: decode93_bank on the bank's columns, then the
    # session instance on the batch (the path's), held against the
    # columns' plain decode too.  The bank's bytes: its columns and pool
    # read, 640 B a row written; ~12 integer operations a 93 cell and ~16 a
    # Type-1 input, as the decode's.  The session instance reads each bank
    # row once (640 B), the rows and mixes, and counts ~6 operations a
    # word a voice (sign extension, the mix multiply-add, the shift, the
    # fold, the tie test) and the transform's 15,000 a frame
    R93 = bcols["frame_word"].shape[0]
    cells, ins = decode93_work(bcols, None)
    check("decode93_bank",
          lambda: tuple(d93.decode93_bank_plain(bcols, tabs93).values()),
          lambda: kernels.decode93_bank(*(bcols[k] for k in d93.COLUMNS),
                                        tabs93["pair"], tabs93["inputs"]),
          1, 20, R93 * (181 + d93.BANK_WORDS * 4 + 1)
          + bcols["pool_u8"].numel() + bcols["band_tab"].numel() * 4,
          12 * cells + 16 * ins, phase=12, words=True)

    def check_session93(rows, mix, vol, fsid, ov0=None, shape=None):
        n, c = mix.shape
        return check(
            "decode93_pcm" if ov0 is None else "decode93_pcm_carry",
            lambda: d93.session93_pcm_plain(sbank, rows, mix, vol, fsid,
                                            tabs93, ov0),
            lambda: kernels.decode93_pcm_bank(sbank["words93"],
                                              sbank["kind93"], rows, mix,
                                              vol, fsid, tabs93, ov0),
            1, 20, R93 * (d93.BANK_WORDS * 4 + 1) + mix.numel() * 8
            + n * (4 + 4 + 240 * 4)
            + (0 if ov0 is None else ov0.numel() * 4 * 2),
            6 * 256 * n * c + 15000 * n, phase=12,
            shape=None if shape is None else f"session bank, {shape}")

    want_bank = check_session93(rows93, mixes93, vols93, sid, shape=shape)
    want_cols = d93.decode93_pcm_plain(bcols, rows93, mixes93, vols93, sid,
                                       tabs93)
    if not torch.equal(want_bank, want_cols):
        raise AssertionError("session93a batch: the session bank's plain "
                             "decode != the columns'")
    del want_bank, want_cols
    against_pair(shape, f"decode93_pcm (session bank, {shape})",
                 f"decode93_fb ({shape})", f"transform93_pcm ({shape})")
    # the voice loop's slope in the session instance: the batch cut to its
    # first c voices, and batches whose every voice loops the rows of one
    # stream of one kind (the ROM's first 93 stream, its first Type-1
    # stream), at C = 1 and C
    by_voices = {C: times[f"decode93_pcm (session bank, {shape})"]}
    for c in (1, 2, 4):
        cut = f"session93a batch, C = {c}"
        check_session93(rows93[:, :c].contiguous(),
                        mixes93[:, :c].contiguous(), vols93, sid, shape=cut)
        by_voices[c] = times[f"decode93_pcm (session bank, {cut})"]
    slopes = {"the batch's first C": by_voices}
    kind_row = bank93.cols["kind_u8"].numpy()
    starts = sorted(bank93.offsets.values()) + [len(kind_row)]
    t_idx = torch.arange(S * T, device=dev) - sid.long() * T
    for kind, label in ((d93.ROW_93, "93 rows"),
                        (d93.ROW_93A, "Type-1 rows")):
        a, b = next((a, b) for a, b in zip(starts, starts[1:])
                    if (kind_row[a:b] == kind).all())
        rows_k = torch.stack(
            [a + (t_idx + 97 * sid.long() + 131 * v) % (b - a)
             for v in range(C)], 1).int()
        slopes[label] = {}
        for c in (1, C):
            cut = f"{label} alone, C = {c}"
            check_session93(rows_k[:, :c].contiguous(),
                            mixes93[:, :c].contiguous(), vols93, sid,
                            shape=cut)
            slopes[label][c] = times[f"decode93_pcm (session bank, {cut})"]
    for label, t in slopes.items():
        ns = {c: ms * 1e6 / rows93.shape[0] for c, ms in t.items()}
        print(f"phase 12 decode93_pcm's session instance by voices, {label} "
              f"(ns a frame): "
              + ", ".join(f"C = {c} {ns[c]:.4f}" for c in sorted(ns))
              + f"; a voice, C = 1 to {C}: {(ns[C] - ns[1]) / (C - 1):.4f}")
    # the path's instances, unlabelled: the kernels line's decode93_pcm_carry
    # is the session instance with the carried state, which play_session
    # launches (its decode93_pcm is the dec93b sweep's columns' instance)
    check_session93(rows93, mixes93, vols93, sid, ov93)
    against_pair("session93a batch with a random carried state",
                 "decode93_pcm_carry", f"decode93_fb ({shape})",
                 "transform93_pcm_carry")
    del bcols
    del rows93, mixes93, vols93
    for k, r in results.items():        # phase 10's launches and phase 11's
        r["launches"] += f93_launches[k] + s93_launches[k]

    # stage spans (device time, queued behind a device sleep): the dec93b
    # sweep, and one session93a batch
    def spans_of(stages, reps=4):
        spans = {k: [] for k, _ in stages}
        for rep in range(reps):
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(stages) + 1)]
            torch.cuda._sleep(int(0.1 * 1.98e9))
            ev[0].record()
            out = None
            for i, (_, fn) in enumerate(stages):
                out = fn(out)
                ev[i + 1].record()
            torch.cuda.synchronize()
            if rep:                               # the first is a warm-up
                for (k, _), a, b in zip(stages, ev, ev[1:]):
                    spans[k].append(a.elapsed_time(b))
        return out, {k: sum(v) / len(v) for k, v in spans.items()}

    out, sweep_spans = spans_of([
        ("decode93_pcm", lambda _: d93.decode93_pcm(
            c93, c93["mix"], c93["vol"], c93["sid"], tabs93))])
    if _max_abs_err(out, sweeps93["dec93b"]["pcm"]) != 0:
        raise AssertionError("dec93b stage-span run != sweep PCM")
    ctl = {}

    def expand(_):
        ctl["rows"], ctl["mix"], ctl["vol"] = romplay.segments94(
            wire93, S, T, C, E93)
        return None

    out, batch_spans = spans_of([
        ("segments94", expand),
        ("decode93_pcm", lambda _: d93.session93_pcm(
            sbank, ctl["rows"], ctl["mix"], ctl["vol"], sid, tabs93)),
        ("int16", pipeline.to_int16)])
    if not np.array_equal(out.reshape(S, -1).cpu().numpy(), got93):
        raise AssertionError("session93a span run != served batch")
    del out, ctl
    batch93_ms = _device_ms(lambda: srv93.decode_wire(wire93, E93), 5,
                            torch)
    trace93 = []
    for k in range(3):
        t0 = time.perf_counter()
        srv93.prepare([session_events(S * (k + 1) + b) for b in range(S)])
        trace93.append((time.perf_counter() - t0) * 1e3)
    serve93_x, gaps93, latency93 = _serve_timing(srv93, n_batches,
                                                 session_audio_s)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    srv93.decode_wire(wire93, E93)
    torch.cuda.synchronize()
    peak93 = torch.cuda.max_memory_allocated(dev)
    srv93.close()
    seg93 = times["segments94 (session93a wire)"]
    fmt_spans = lambda sp: ", ".join(f"{k} {v:.4f}" for k, v in sp.items()) \
        + f", sum {sum(sp.values()):.4f}"
    print(f"phase 12 spans (ms, mean of 3): dec93b sweep "
          f"{fmt_spans(sweep_spans)} (the compact wire's unpack runs on the "
          f"host in packed93_to_device, phase 10); session93a batch "
          f"{fmt_spans(batch_spans)} (segments94's kernel time {seg93:.4f} "
          f"ms = {seg93 / batch_spans['segments94']:.3f} of its span)")
    print(f"phase 12 sessions93: device time of one batch {batch93_ms:.4f} "
          f"ms = {session_audio_s / (batch93_ms / 1e3):.1f}x realtime; "
          f"serve() over {n_batches} batches {serve93_x:.1f}x realtime (ms "
          f"from the call to the first arrival, then between arrivals: "
          + ", ".join(f"{g:.1f}" for g in gaps93) + "; latency from the "
          "start of the trace ms: " + ", ".join(f"{a:.1f}" for a in latency93)
          + f"); native trace + wire of one batch {sum(trace93) / 3:.2f} ms "
          f"(min {min(trace93):.2f}, max {max(trace93):.2f}); peak memory of "
          f"one batch {peak93 / 2**30:.3f} GiB ({(peak93 - base) / 2**30:.3f}"
          f" GiB above the resident bank and inputs); E {E93}")

    # 13. the on-device 1994+ encoder at bench.py's enc94_dev width
    jobs, enc_audio_s = enc_jobs(ENC_FILES)
    params = enc.CompressionParams()
    slots = d94._select_formats(params)
    host_ci = [enc.analyze_frames_canonical(enc.frames_from_pcm_raw(
        enc.pcm_to_int16(p, r))) for p, r in jobs]
    t0 = time.perf_counter()
    want_streams = [c94.encode_stream94(ci, params) for ci in host_ci]
    native_s = time.perf_counter() - t0
    # the main path once, from the counters at 0
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    got_files = enc.encode_files_device(jobs, params)
    first_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    e_launches = dict(kernels.LAUNCHES)
    on_enc_path = ("encode94_analyze", "encode94_decide", "encode94_select")
    if not all(e_launches[k] > 0 for k in on_enc_path):
        raise AssertionError(f"a kernel of the encoder did not launch: "
                             f"{e_launches}")
    if [s for s, _ in got_files] != want_streams or \
            [nf for _, nf in got_files] != [c.shape[0] for c in host_ci]:
        bad = [i for i, (s, _) in enumerate(got_files)
               if s != want_streams[i]]
        raise AssertionError(f"encode_files_device != the native host "
                             f"search on streams {bad}")
    got_batch = d94.encode_batch(host_ci, params, device=dev)
    if got_batch != want_streams:
        raise AssertionError("encode_batch != the native host search")
    print(f"phase 13 encoder: {ENC_FILES} files of 2.0 s at 31,250 Hz "
          f"({enc_audio_s:.1f} s audio, {host_ci[0].shape[0]} frames each, "
          f"slots {slots}); all {ENC_FILES} streams of encode_files_device "
          f"and of encode_batch byte-identical with the port's native host "
          f"search ({native_s:.3f} s for {ENC_FILES} on one host thread); "
          f"first call "
          f"{first_s:.3f} s; launches {dict((k, e_launches[k]) for k in on_enc_path)}")

    # each kernel against its plain version at the first chunk's shapes
    encm = d94._encoder(slots, dev)
    etabs = dict(encm.named_buffers())
    fq = etabs["fq"]

    def chunk_inputs(prm):
        cis, _, pcm_np, nf_np, arrs = d94.prepare_chunk(jobs[:16], prm,
                                                        slots)
        t = {k: torch.tensor(np.asarray(v), device=dev)
             for k, v in arrs.items() if k != "sil_max"}
        return (torch.tensor(pcm_np, device=dev),
                torch.tensor(nf_np, device=dev), arrs["sil_max"], t)

    pcm_d, nf_d, sil_max, ta = chunk_inputs(params)
    B, L = pcm_d.shape
    Fm = (L - 240) // 240
    K = len(slots)
    # analysis: each PCM sample and matrix entry read once, ci written once;
    # the product is exact on int8 tensor cores as four int8-plane products
    # (the JAX reference's form), each a multiply-add of 256 x 255 a frame
    # counted as two operations; its int32 coefficients (up to +-2^20) are
    # compared as whole words
    check("encode94_analyze", lambda: d94.analyze94_plain(pcm_d, fq),
          lambda: kernels.encode94_analyze(pcm_d, fq), 3, 20,
          B * L * 2 + fq.numel() * 2 + B * Fm * 255 * 4,
          4 * 2 * B * Fm * 256 * 255, phase=13, ops_per_s=INT8_TC_OPS_PER_S,
          words=True)
    ageo = kernels.encode94_analyze_geometry(dev)
    blocks = (-(-Fm // ageo["tile_frames"]) * -(-255 // ageo["tile_cols"])
              * B)
    wave = ageo["blocks_per_sm"] * ageo["sms"]
    print(f"phase 13 encode94_analyze geometry: {blocks} blocks of "
          f"{ageo['threads']} threads ({ageo['tile_frames']} frames x "
          f"{ageo['tile_cols']} columns each), {ageo['shared_bytes']} B "
          f"dynamic shared memory, {ageo['registers']} registers and "
          f"{ageo['local_bytes']} B local memory a thread, "
          f"{ageo['blocks_per_sm']} blocks an SM: {wave} a wave on "
          f"{ageo['sms']} SMs ({blocks / wave:.2f} waves); nvcc: "
          + (" | ".join(_ptxas_lines(report, "encode94_analyze_kernel"))
             or "not rebuilt in this run"))
    head = pcm_d[:, :Fm * 240].reshape(B, Fm, 240)
    tail = pcm_d[:, 240:240 + Fm * 240].reshape(B, Fm, 240)[:, :, :16]
    frames64 = torch.cat([head, tail], 2).double()
    fq64 = fq.double()

    def library_analyze():
        p = torch.matmul(frames64, fq64)
        return torch.floor((p + 2.0 ** 20) * 2.0 ** -21).clamp(
            -(1 << 20), 1 << 20).int()

    lib_ci = library_analyze()
    ci_d = kernels.encode94_analyze(pcm_d, fq)
    if not torch.equal(lib_ci, ci_d):
        raise AssertionError("float64 torch.matmul analysis != the kernel")
    library_ms = _device_ms(library_analyze, 20, torch)
    results["encode94_analyze"]["library_ms"] = library_ms
    print(f"phase 13 encode94_analyze library yardstick (float64 "
          f"torch.matmul + rounding, equal to the kernel): {library_ms:.4f} "
          f"ms against the kernel's {times['encode94_analyze']:.4f}")

    def decide_work(ci, ta):
        """(operations) the decisions need on these inputs: a min and a
        max a position; two compares a (code, column) fit test; ~16 a
        position for each candidate's error sum (rdiv's five, the wrap's
        six, clamp, square, cap, sum).  Only distinct pre-adjustment
        columns count: a column whose adjustment equals the previous
        column's (a type-0 slot, bands past 2) has the same result."""
        w, sf, amin, amax = d94.derive_luts(ta["hdr_scale"], ta["keep"],
                                            etabs)
        cpad, lane = d94._pad_grid(ci)
        mn = torch.where(lane, cpad, d94.BIG).amin(-1)
        mx = torch.where(lane, cpad, -d94.BIG).amax(-1)
        peff = etabs["peff_tab"]                           # [K,16,P]
        distinct = torch.ones_like(peff, dtype=torch.bool)
        distinct[:, :, 1:] = etabs["is1"][:, None, None] & (
            peff[:, :, 1:] != peff[:, :, :-1])
        n_band = torch.tensor(c94.BAND_SIZES, device=dev)
        fit_ops = 2 * 15 * int(distinct.sum()) * ci.shape[0] * ci.shape[1]
        cand_ops = 0
        for k in range(K):
            fit = ((mn[:, :, :, None, None] >= amin[:, k, None, :, 1:])
                   & (mx[:, :, :, None, None] <= amax[:, k, None, :, 1:]))
            best = torch.where(fit, torch.arange(1, 16, device=dev)[:, None],
                               15).amin(3)                 # [B,F,16,P]
            wc = w[:, k, :, 1:7].long()                    # [B,16,6,P]
            sfc = sf[:, k, :, 1:7].long()
            valid = (wc >= 1) & ((1 << wc.clamp(min=1)) * sfc - sfc // 2
                                 <= ta["dlim"].long()[None, :, None, None]
                                 - 1) & ta["keep"][:, :, None, None]
            c = torch.arange(1, 7, device=dev)[:, None]
            n_c = (valid[:, None] & (c < best[:, :, :, None, :])).sum(3)
            cand_ops += 16 * int((n_c * distinct[k] * n_band[:, None]).sum())
        return 2 * ci.numel() + fit_ops + cand_ops

    def check_encoder(prm_label, ci, nf, sil, ta):
        args = (ci, sil, ta["keep"], ta["thr"], ta["dlim"], ta["cape"],
                ta["hdr_scale"])
        # decide: ci and the header codes read once, two decision bytes a
        # (slot, frame, band, column) and the silent flags written
        dec = check("encode94_decide",
                    lambda: d94.decide94_plain(*args, etabs),
                    lambda: kernels.encode94_decide(*args, etabs), 1, 20,
                    ci.numel() * 4 + B * K * 16 + 2 * B * K * Fm * 80
                    + B * Fm * 16, decide_work(ci, ta), phase=13,
                    shape=prm_label)
        sel = (ci, *dec, nf, ta["keep"], ta["hdr_scale"], ta["wanted"],
               etabs)
        # select: ci, the decisions and the flags read once, the packed
        # rows written; ~22 integer operations a (slot, position) for the
        # codeword length and the pairing, ~10 a (slot, band) for the scan
        # step and the delta code
        check("encode94_select", lambda: d94.select94_plain(*sel),
              lambda: kernels.encode94_select(*sel), 1, 20,
              ci.numel() * 4 + 2 * B * K * Fm * 80 + B * Fm * 16
              + B * (4 * K + 1 + 32 * Fm), B * K * Fm * (255 * 22 + 16 * 10),
              phase=13, shape=prm_label)

    check_encoder(None, ci_d, nf_d, sil_max, ta)
    # the decisions' launch geometry, its nvcc report, and its reciprocal
    # division against the integer one on every input
    geo = kernels.encode94_decide_geometry(dev)
    blocks = -(-Fm // geo["tile_frames"]) * B
    wave = geo["blocks_per_sm"] * geo["sms"]
    rdiv_bad = kernels.encode94_rdiv_check(etabs["scale_mant"])
    if rdiv_bad:
        raise AssertionError(f"encode94_decide's reciprocal rdiv differs "
                             f"on {rdiv_bad} inputs")
    print(f"phase 13 encode94_decide geometry: {blocks} blocks of "
          f"{geo['threads']} threads ({geo['tile_frames']} frames each), "
          f"{geo['shared_bytes']} B static shared memory and "
          f"{geo['registers']} registers a thread, {geo['blocks_per_sm']} "
          f"blocks an SM: {wave} a wave on {geo['sms']} SMs "
          f"({blocks / wave:.2f} waves); nvcc: "
          + (" | ".join(_ptxas_lines(report, "encode94_decide_kernel"))
             or "not rebuilt in this run")
          + "; reciprocal rdiv equals the integer division on all "
          f"|a| <= 2^20 x 65 scale table entries")
    # the select kernels' launch geometry, their nvcc report, and their two
    # launches timed alone on the card's clock (each after a whole run)
    sgeo = kernels.encode94_select_geometry(dev)
    dec_d = kernels.encode94_decide(ci_d, sil_max, ta["keep"], ta["thr"],
                                    ta["dlim"], ta["cape"], ta["hdr_scale"],
                                    etabs)
    scan_fn, size_fn, _ = kernels.encode94_select_parts(
        ci_d, *dec_d, nf_d, ta["keep"], ta["hdr_scale"], ta["wanted"], etabs)
    scan_fn()
    scan_ms = _device_ms(scan_fn, 20, torch)
    size_ms = _device_ms(size_fn, 20, torch)
    waves = []
    for part, blocks in (("scan", sgeo["scan_blocks"] * K * B),
                         ("size", -(-Fm // sgeo["size_tile_frames"]) * K * B)):
        waves.append(f"{part}: {blocks} blocks of {sgeo[part + '_threads']} "
                     f"threads, {sgeo[part + '_shared_bytes']} B static "
                     f"shared memory, {sgeo[part + '_registers']} registers "
                     f"a thread, {sgeo[part + '_blocks_per_sm']} blocks an "
                     f"SM ({blocks / (sgeo[part + '_blocks_per_sm'] * sgeo['sms']):.2f} "
                     f"waves on {sgeo['sms']} SMs)")
    print("phase 13 encode94_select geometry: " + "; ".join(waves)
          + "; nvcc: "
          + (" | ".join(_ptxas_lines(report, "encode94_scan")
                        + _ptxas_lines(report, "encode94_size"))
             or "not rebuilt in this run")
          + f"; on the card's clock, each launch alone: scan {scan_ms:.4f} "
          f"ms, sizes {size_ms:.4f} ms (whole: "
          f"{times['encode94_select']:.4f} ms, the sizes' launch and "
          f"staging overlapping the scan)")
    wrap = enc.CompressionParams(target_bit_rate=48000,
                                 maximum_quantization_error=40 / 32768,
                                 minimum_dynamic_range=60 / 32768)
    pcm_w, nf_w, sil_w, ta_w = chunk_inputs(wrap)
    check_encoder("wrap-refinement params", kernels.encode94_analyze(
        pcm_w, fq), nf_w, sil_w, ta_w)
    got_w = enc.encode_files_device(jobs[:16], wrap)
    if [s for s, _ in got_w] != [c94.encode_stream94(ci, wrap)
                                 for ci in host_ci[:16]]:
        raise AssertionError("wrap-refinement params: streams != native")

    # x realtime end to end (after the warm-up above), and its parts
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        enc.encode_files_device(jobs, params)
        walls.append(time.perf_counter() - t0)
    ranges = [(i, min(i + 16, ENC_FILES)) for i in range(0, ENC_FILES, 16)]
    prep_s, setup_s, up_s, fetch_s, emit_s, dev_ms = [], [], [], [], [], []
    for lo, hi in ranges:
        t0 = time.perf_counter()
        cis, setups, pcm_np, nf_np, arrs = d94.prepare_chunk(jobs[lo:hi],
                                                             params, slots)
        prep_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        d94.setup_compact(cis, params, slots)
        setup_s.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = d94._to_device(dict(x=pcm_np, nf=nf_np, keep=arrs["keep"],
                                thr=arrs["thr"], dlim=arrs["dlim"],
                                cape=arrs["cape"],
                                hdr_scale=arrs["hdr_scale"],
                                wanted=arrs["wanted"]), dev)
        torch.cuda.synchronize()
        up_s.append(time.perf_counter() - t0)

        def forward(d=d, sm=arrs["sil_max"]):
            return encm(d["x"], d["nf"], sm, d["keep"], d["thr"], d["dlim"],
                        d["cape"], d["hdr_scale"], d["wanted"])

        dev_ms.append(_device_ms(forward, 5, torch))
        packed = forward()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed)
        buf = host.numpy()
        fetch_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        d94.emit_chunk(buf, cis, setups, slots)
        emit_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    forward()
    torch.cuda.synchronize()
    peak_enc = torch.cuda.max_memory_allocated(dev)
    ms = lambda v: ", ".join(f"{1e3 * x:.3f}" for x in v)
    mean_wall = sum(walls) / len(walls)
    print(f"phase 13 encode_files_device: {enc_audio_s / mean_wall:.1f}x "
          f"realtime (wall {ms(walls)} ms over 3 runs after one warm-up; "
          f"min {enc_audio_s / min(walls):.1f}x); per chunk of 16, serial: "
          f"host prep {ms(prep_s)} ms (of which the 16 setups, timed "
          f"again alone: {ms(setup_s)} ms), upload {ms(up_s)} ms, device "
          + ", ".join(f"{v:.4f}" for v in dev_ms) + f" ms, fetch "
          f"{ms(fetch_s)} ms, emit {ms(emit_s)} ms; the device share of "
          f"the serial sum {100 * sum(dev_ms) / 1e3 / (sum(prep_s) + sum(up_s) + sum(dev_ms) / 1e3 + sum(fetch_s) + sum(emit_s)):.2f}%; "
          f"peak memory of one chunk {peak_enc / 2**20:.2f} MiB "
          f"({(peak_enc - base) / 2**20:.2f} MiB above its inputs)")
    for k in on_enc_path:
        results[k]["launches"] = e_launches[k]

    # 14. the cold 1994+ sweep at bench.py's flat94_e2e defaults: the
    # catalog packed anew in E2E_CHUNKS chunks each call
    e2e = [_read(os.path.join(STREAMS, n))
           for n in ("music_a.dcs94", "music_b.dcs94")
           + tuple(f"{n}.dcs94" for n in LEGACY)]
    cdev = cold.ColdDevice(dev)
    t0 = time.perf_counter()
    whole = fs.FlatSweep(e2e * E2E_COPIES).pack()
    warm_args = fs.packed_to_device(whole.compact_host_arrays(), dev)
    warm_pack_s = time.perf_counter() - t0
    warm_pcm = pipe(**warm_args)
    warm_chk = int(cs.checksum(warm_pcm))
    e2e_audio_s = whole.audio_samples / fs.SAMPLE_RATE
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    r = cold.cold_flat94(e2e, E2E_COPIES, E2E_CHUNKS, cdev)
    torch.cuda.synchronize()
    c14 = dict(kernels.LAUNCHES)
    if not all(c14[k] > 0 for k in on_path):
        raise AssertionError(f"a kernel of the cold sweep did not launch: "
                             f"{c14}")
    if not torch.equal(r["pcm"], warm_pcm) or r["checksum"] != warm_chk:
        raise AssertionError("the cold sweep's PCM != the warm sweep's")

    def sync_cold():
        """cold_flat94 with each chunk uploaded by a plain synchronous copy
        (torch.tensor from pageable memory, no side stream): the yardstick
        of ColdDevice's pinned side-stream upload.  Returns the checksum,
        the PCM, the chunked FlatPipeline input and each chunk's upload ms
        on the host's clock (the copy included)."""
        chunks, up_ms = [], []
        for cat in cold.split_copies(e2e, E2E_COPIES, E2E_CHUNKS):
            ca = fs.FlatSweep(cat).pack().compact_host_arrays()
            n_steps = ca.pop("n_steps")
            t0 = time.perf_counter()
            cols = {k: torch.tensor(cold._wire(v), device=dev)
                    for k, v in ca.items()}
            up_ms.append((time.perf_counter() - t0) * 1e3)
            chunks.append(cold._widen94(cols, n_steps))
        args = cold.concat_chunks(chunks)
        pcm = cdev.pipe94(**args)
        return int(cs.checksum(pcm)), pcm, args, up_ms

    # the plain sweep on the chunked input itself and on the catalog
    # packed whole: the kernels held at this path's shapes
    sync_chk, sync_pcm, chunked, _ = sync_cold()
    err = max(_max_abs_err(r["pcm"], plain_pipe(**chunked)),
              _max_abs_err(warm_pcm, plain_pipe(**warm_args)))
    if err != 0 or sync_chk != warm_chk or not torch.equal(sync_pcm,
                                                           warm_pcm):
        raise AssertionError(f"flat94_e2e: sweep != plain sweep ({err}), or "
                             f"the synchronous upload's sweep differs")
    del r, sync_pcm, chunked
    cold.cold_flat94(e2e, E2E_COPIES, E2E_CHUNKS, cdev)      # warm-up
    walls, runs, sync_walls, sync_up = [], [], [], []
    for i in range(3):                  # the two uploads in turn, ABBA...
        for kind in (("cold", "sync") if i % 2 == 0 else ("sync", "cold")):
            t0 = time.perf_counter()
            if kind == "sync":
                chk, _, _, up = sync_cold()
                sync_walls.append(time.perf_counter() - t0)
                sync_up.append(up)
                if chk != warm_chk:
                    raise AssertionError(f"synchronous upload's checksum "
                                         f"{chk} != {warm_chk}")
                continue
            r = cold.cold_flat94(e2e, E2E_COPIES, E2E_CHUNKS, cdev)
            walls.append(time.perf_counter() - t0)
            if r["checksum"] != warm_chk:
                raise AssertionError(f"cold checksum {r['checksum']} != "
                                     f"{warm_chk}")
            del r["pcm"]
            runs.append(r)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    cold.cold_flat94(e2e, E2E_COPIES, E2E_CHUNKS, cdev)
    peak = torch.cuda.max_memory_allocated(dev)
    fmt = lambda v: ", ".join(f"{x:.3f}" for x in v)
    print(f"phase 14 cold flat94_e2e: {len(e2e) * E2E_COPIES} streams, "
          f"{whole.n_frames_total} frames, {e2e_audio_s:.3f} s audio in "
          f"{E2E_CHUNKS} chunks; launches "
          f"{dict((k, c14[k]) for k in on_path)}; PCM bit-exact with the "
          f"plain sweep of the chunked input and with one warm FlatPipeline "
          f"sweep of the catalog packed whole (itself bit-exact with the "
          f"plain sweep), checksum "
          f"{warm_chk} in every call; "
          f"{e2e_audio_s / (sum(walls) / 3):.1f}x realtime (wall "
          f"{fmt(1e3 * w for w in walls)} ms over 3 calls after one "
          f"warm-up; min {e2e_audio_s / min(walls):.1f}x); the warm pack "
          f"of the whole catalog {warm_pack_s:.3f} s; peak memory of one "
          f"call {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB "
          f"above what was resident)")
    for i, r in enumerate(runs):
        per = lambda key: fmt(c[key] for c in r["chunks"])
        print(f"phase 14 call {i}: per chunk host pack {per('pack_ms')} ms, "
              f"staging + enqueue of the upload {per('enqueue_ms')} ms, "
              f"upload (copy stream) {per('upload_ms')} ms; one dispatch "
              f"over all chunks: device {r['device_ms']:.3f} ms, fetch "
              f"{r['fetch_ms']:.3f} ms")
    print(f"phase 14 the same calls with a synchronous upload (torch.tensor "
          f"from pageable memory, no side stream; timed in turn with the "
          f"calls above): {e2e_audio_s / (sum(sync_walls) / 3):.1f}x "
          f"realtime (wall {fmt(1e3 * w for w in sync_walls)} ms); upload "
          f"per chunk, host clock: "
          + "; ".join(fmt(u) for u in sync_up) + " ms")
    # the warm flat94 shape (bench.py:699-701), timed as phase 4
    legacy = [_read(os.path.join(STREAMS, f"{n}.dcs94")) for n in LEGACY]
    t0 = time.perf_counter()
    sw94 = fs.FlatSweep(legacy * FLAT94_COPIES).pack()
    a94 = fs.packed_to_device(sw94.compact_host_arrays(), dev)
    f94_pack_s = time.perf_counter() - t0
    err = _max_abs_err(pipe(**a94), plain_pipe(**a94))
    if err != 0:
        raise AssertionError(f"flat94: sweep != plain sweep ({err})")
    f94_audio_s = sw94.audio_samples / fs.SAMPLE_RATE
    f94_ms = _device_ms(lambda: pipe(**a94), 5, torch)
    enqueue = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe(**a94)
        enqueue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    pipe(**a94)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"phase 14 warm flat94: {len(legacy) * FLAT94_COPIES} streams, "
          f"{sw94.n_frames_total} frames, {f94_audio_s:.3f} s audio, "
          f"n_steps {sw94.n_steps}; host pack + upload {f94_pack_s:.3f} s; "
          f"PCM bit-exact with the plain sweep; device {f94_ms:.3f} ms = "
          f"{f94_audio_s / (f94_ms / 1e3):.1f}x realtime; host enqueue "
          f"{sum(enqueue) / 5:.4f} ms (min {min(enqueue):.4f}, max "
          f"{max(enqueue):.4f}); peak memory of one sweep "
          f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above "
          f"the resident inputs)")
    del a94, sw94

    # 15. the cold mixed catalog at bench.py's catalog_e2e defaults
    cat94 = e2e * E2E_COPIES
    cat93 = [_read(os.path.join(STREAMS, n))
             for n in ("music_a.dcs93b", "music_b.dcs93a")] * CAT93_COPIES
    cat93a = [_read(os.path.join(STREAMS, n))
              for n in ("dense_t1.dcs93a1", "dense_t1b.dcs93a1")] \
        * CAT93_COPIES
    a93 = cs.packed93_to_device(
        cs.Flat93Sweep(cat93, False).compact_host_arrays(), dev)
    a93a = cs.packed93_to_device(
        cs.Flat93Sweep(cat93a, True).compact_host_arrays(), dev)
    fused = int(cs.catalog_pipeline(cdev.pipe94, cdev.pipe93, warm_args,
                                    a93, a93a))
    # the three families' warm sweeps, each bit-exact with its plain sweep
    # (the 1994+ one in phase 14), their checksums summed on the host
    warm = {"94": warm_pcm}
    for k, a in (("93b", a93), ("93a1", a93a)):
        warm[k] = pipe93(**a)
        err = _max_abs_err(warm[k], plain93(**a))
        if err != 0:
            raise AssertionError(f"{k} x {CAT93_COPIES}: sweep != plain "
                                 f"sweep ({err})")
    warm = {k: int((v.cpu().numpy().astype(np.int64) & 0xFF).sum())
            for k, v in warm.items()}
    warm_sum = int(cs.wrap_int32(torch.tensor(sum(warm.values()))))
    del a93, a93a, warm_pcm, warm_args
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    r = cold.cold_catalog(cat94, cat93, cat93a, cdev)
    torch.cuda.synchronize()
    c15 = dict(kernels.LAUNCHES)
    on_cat_path = ("decode94_fb", "transform94_pcm", "decode93_pcm")
    if not all(c15[k] > 0 for k in on_cat_path):
        raise AssertionError(f"a kernel of the cold catalog did not launch: "
                             f"{c15}")
    wrapped = {k: int(cs.wrap_int32(torch.tensor(v))) for k, v in warm.items()}
    if not (r["checksum"] == fused == warm_sum
            and r["checksums"] == wrapped):
        raise AssertionError(f"cold catalog checksum {r['checksum']} "
                             f"{r['checksums']}, catalog_pipeline {fused}, "
                             f"warm sweeps {warm_sum} {wrapped}")
    walls, runs = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        r = cold.cold_catalog(cat94, cat93, cat93a, cdev)
        walls.append(time.perf_counter() - t0)
        if r["checksum"] != fused:
            raise AssertionError(f"cold catalog checksum {r['checksum']} != "
                                 f"{fused}")
        runs.append(r)
    cat_audio_s = r["audio_samples"] / fs.SAMPLE_RATE
    fams = ", ".join(f"{k} {f['frames']} frames, {f['audio_s']:.3f} s"
                     for k, f in r["families"].items())
    print(f"phase 15 cold catalog_e2e: 94 x {E2E_COPIES}, 93b x "
          f"{CAT93_COPIES}, 93a Type-1 x {CAT93_COPIES} ({fams}); "
          f"launches {dict((k, c15[k]) for k in on_cat_path)}; checksum "
          f"{fused} equal to catalog_pipeline's and to the three warm "
          f"sweeps' in every call; {cat_audio_s / (sum(walls) / 3):.1f}x "
          f"realtime (wall {fmt(1e3 * w for w in walls)} ms over 3 calls "
          f"after the first; min {cat_audio_s / min(walls):.1f}x)")
    for i, r in enumerate(runs):
        print(f"phase 15 call {i}: " + "; ".join(
            f"{k} host {f['host_ms']:.3f} ms, upload (copy stream) "
            f"{r['upload_ms'][k]:.3f} ms, device {r['device_ms'][k]:.3f} ms"
            for k, f in r["families"].items())
            + f"; fetch of the three checksums {r['fetch_ms']:.3f} ms")
    for k, res in results.items():      # phase 14's launches and phase 15's
        res["launches"] += c14[k] + c15[k]

    # 16. torch.profiler traces (build/torch_trace): one cold flat94_e2e
    # call, one served session6 batch (phase 9's server), one enc94_dev
    # chunk (phase 13's path)
    def summarize(label, run, phase=16):
        with profiling.device_trace() as prof:
            run()
            torch.cuda.synchronize()
        s = profiling.trace_summary(prof.trace_file)
        short = lambda n: n.replace("void ", "").replace(
            "(anonymous namespace)::", "")[:80]
        print(f"phase {phase} trace of {label} ({prof.trace_file}): window "
              f"{s['window_ms']:.3f} ms, device busy {s['busy_ms']:.3f} ms "
              f"(kernels and copies), idle share {s['idle_share']:.4f}; "
              f"kernels by device time: " + "; ".join(
                  f"{short(n)} x{c} {ms:.4f} ms" for n, c, ms in s["kernels"])
              + "; longest idle gaps: " + ", ".join(
                  f"{ms:.3f} ms in {span}" for ms, span in s["gaps"])
              + "; host spans (ms): " + ", ".join(
                  f"{k} {v:.3f}" for k, v in s["spans"].items())
              + f"; kernels at most {s['lead_ms']:.3f} ms before their "
              f"launches")

    summarize("a cold flat94_e2e call", lambda: cold.cold_flat94(
        e2e, E2E_COPIES, E2E_CHUNKS, cdev))
    summarize("a served session6 batch", lambda: srv.serve_one(
        [session_events(SESSIONS * 9 + b) for b in range(SESSIONS)]))
    srv.close()
    summarize("an enc94_dev chunk", lambda: enc.encode_files_device(
        jobs[:16], params))

    # 17. the explorer CLI on the card, in process through main(argv), as a
    # user runs it; its WAVs under build/explorer_smoke
    out_dir = os.path.join(HERE, "build", "explorer_smoke")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)

    def cli(argv, want=None):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = explorer.main(argv)
        wall = time.perf_counter() - t0
        out = buf.getvalue()
        if rc != 0 or (want is not None and want not in out):
            raise AssertionError(f"explorer {' '.join(argv)}: rc {rc}\n{out}")
        return wall, out

    def wavs(prefix):
        d, stem = os.path.split(prefix)
        return {n[len(stem):]: _read(os.path.join(d, n))
                for n in sorted(os.listdir(d))
                if n.startswith(stem) and n.endswith(".wav")}

    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    walls = {}
    for rom, cap in ((SESSION6_ZIP, []),
                     (SESSION93A_ZIP, ["--max-track-frames", "300"])):
        name = os.path.basename(rom)[:-4]
        p = os.path.join(out_dir, name + "_")
        w, out = cli([rom, "--validate", *cap], "Validation Succeeded")
        walls[name, "--validate" + (" " + " ".join(cap) if cap else "")] = w
        compared = out.splitlines()[0]
        walls[name, "--extract-tracks"], _ = cli(
            [rom, "--extract-tracks", p + "t"])
        walls[name, "--autoplay"], _ = cli([rom, "--autoplay", p + "a.wav"])
        cap300 = ["--max-track-frames", "300"]
        walls[name, "--extract-tracks (cap 300)"], _ = cli(
            [rom, "--extract-tracks", p + "c", *cap300])
        walls[name, "--extract-tracks --backend native (cap 300)"], _ = cli(
            [rom, "--extract-tracks", p + "n", *cap300, "--backend", "native"])
        card, scalar = wavs(p + "c"), wavs(p + "n")
        if len(card) < 6 or card != scalar:
            raise AssertionError(f"{name}: the card's WAVs ({sorted(card)}) "
                                 f"!= --backend native's ({sorted(scalar)})")
        print(f"phase 17 explorer {name}: --validate {compared.lower()}, "
              f"Validation Succeeded; --extract-tracks at cap 300: "
              f"{len(card)} WAVs byte-identical with --backend native")
    c17 = dict(kernels.LAUNCHES)
    on_cli_path = ("decode94_bank", "session_mix94", "transform94_pcm_carry",
                   "decode93_pcm_carry")
    if not all(c17[k] > 0 for k in on_cli_path):
        raise AssertionError(f"a kernel of the explorer's path did not "
                             f"launch: {c17}")
    for k, res in results.items():
        res["launches"] += c17[k]
    # the card's share of a command: traces of two (their launches count
    # nowhere), the wall time of each beside the trace's window
    for rom, args in ((SESSION6_ZIP, ["--extract-tracks", "trace_t"]),
                      (SESSION93A_ZIP, ["--autoplay", "trace_a.wav"])):
        label = f"explorer {os.path.basename(rom)} {args[0]}"
        t0 = time.perf_counter()
        summarize(label, lambda: cli(
            [rom, args[0], os.path.join(out_dir, args[1])]), phase=17)
        print(f"phase 17 {label} traced: {time.perf_counter() - t0:.3f} s "
              f"wall")
    print(f"phase 17 explorer wall times ({smi.splitlines()[0]}): " + "; ".join(
        f"{n} {c} {w:.3f} s" for (n, c), w in walls.items())
        + f"; launches {c17}")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "dcsexplorer_tpu_torch.tools.explorer",
         SESSION6_ZIP, "--validate", "--max-track-frames", "60"],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    if r.returncode != 0 or "Validation Succeeded" not in r.stdout:
        raise AssertionError(f"python -m ...explorer --validate: rc "
                             f"{r.returncode}\n{r.stdout}\n{r.stderr}")
    print(f"phase 17 python -m dcsexplorer_tpu_torch.tools.explorer "
          f"session6.zip --validate --max-track-frames 60 (no --platform: "
          f"the card): rc 0, Validation Succeeded, "
          f"{time.perf_counter() - t0:.3f} s with the interpreter's start")

    # 18. the sharded paths (parallel/sweep.py) over a mesh of four entries
    # of this card, each on a side stream of its own (and over every card
    # where there are more), each driven with the counters at 0 just
    # before it and read just after
    mesh4 = psweep.make_flat_mesh([dev] * 4)
    meshes = {"cuda:0 x 4": mesh4}
    if torch.cuda.device_count() > 1:
        meshes[f"{torch.cuda.device_count()} cards"] = psweep.make_flat_mesh()
    print(f"phase 18 {smi.splitlines()[0]}: meshes "
          + "; ".join(f"{k} = {[str(d) for d in m]}"
                      for k, m in meshes.items()))
    c18 = {k: 0 for k in kernels.LAUNCHES}

    def driven(fn, want_launches):
        """fn() with the counters at 0; its launches must include
        want_launches (name -> count); they add to the kernels line."""
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        out = fn()
        torch.cuda.synchronize()
        got = dict(kernels.LAUNCHES)
        for k, n in want_launches.items():
            if got[k] != n:
                raise AssertionError(f"{k} launched {got[k]} times, not {n}:"
                                     f" {got}")
        for k in c18:
            c18[k] += got[k]
        return out, {k: v for k, v in got.items() if v}

    def mesh_timing(fn):
        """(device ms, host ms, host enqueue ms, peak GiB allocated, peak
        GiB reserved) of one call, the peaks above the resident inputs:
        device time queued behind a 1 s device sleep (each call stages its
        columns into pinned memory on the host), host time to a
        synchronise, enqueue time to the call's return.  The allocator
        counts a block freed on a shard's stream as free before that
        stream is done with it; the reserved peak holds it."""
        dev_ms = _device_ms(fn, 3, torch, sleep_s=1.0)
        host, enq = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            enq.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        base_r = torch.cuda.memory_reserved(dev)
        fn()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        peak_r = (torch.cuda.max_memory_reserved(dev) - base_r) / 2**30
        return (dev_ms, sum(host) / len(host), sum(enq) / len(enq), peak,
                peak_r)

    def timing_text(k, t, audio):
        d, h, e, p, pr = t
        return (f"{k}: device {d:.4f} ms = {audio / (d / 1e3):.1f}x "
                f"realtime, host {h:.3f} ms (enqueue {e:.3f}), peak "
                f"{p:.3f} GiB allocated, {pr:.3f} reserved")

    # the flat94_music sweep, against phase 4's PCM
    for name, m in meshes.items():
        n = len(m)
        pcm18, l18 = driven(lambda: psweep.sharded_flat_sweep(m, arrays),
                            {"decode94_fb": n, "transform94_pcm": n})
        err = _max_abs_err(pcm18, flat_pcm)
        if err != 0 or pcm18.shape != flat_pcm.shape:
            raise AssertionError(f"sharded flat sweep over {name} != phase "
                                 f"4's PCM (max abs err {err})")
        print(f"phase 18 sharded_flat_sweep over {name}: {n_frames} frames, "
              f"PCM bit-exact with phase 4's, launches {l18}")
    del pcm18
    t_flat = {k: mesh_timing(lambda m=m: psweep.sharded_flat_sweep(m, arrays))
              for k, m in (("1 shard", [dev]), ("4 shards", mesh4))}
    # the layers of the 4-shard call: the host's split, halo and pinned
    # staging (its enqueue time, above), the four shards' kernels on
    # resident columns one after another, the gather
    bounds = psweep.split(n_frames, 4)
    shard_cols = []
    for s_, e_ in bounds:
        lo = max(0, s_ - psweep.FLAT_HALO)
        part = {k: (v[lo:e_] if k in ("sid", "start_bit", "bt_u8", "mix_u16",
                                      "vol_u8") else v)
                for k, v in arrays.items()}
        shard_cols.append(fs.packed_to_device(part, dev))
    shards_ms = _device_ms(lambda: [pipe(**c) for c in shard_cols], 5, torch)
    gather_out = torch.empty_like(flat_pcm)
    gather_ms = _device_ms(lambda: gather_out.copy_(flat_pcm), 5, torch)
    del shard_cols, gather_out
    print(f"phase 18 sharded_flat_sweep timing ({smi.splitlines()[0]}): "
          + "; ".join(timing_text(k, t, audio_s) for k, t in t_flat.items())
          + f"; device layers of 4 shards: the shards' kernels on resident "
          f"columns one after another {shards_ms:.4f} ms against one sweep's "
          f"{sweep_ms:.4f} ms (phase 4), gather copy {gather_ms:.4f} ms")

    # one session6 batch (phase 9's) and one session93a batch (phase 12's)
    sess_times = {}
    for name, b, wire_b, E_b, key, want_b in (
            ("session6", bank, wire_np, E, "session_mix94",
             pcm16.reshape(S, -1).cpu().numpy()),
            ("session93a", bank93, wire_np93, E93, "decode93_pcm", got93)):
        ctl = romplay.segments94(torch.tensor(wire_b, device=dev), S, T, C,
                                 E_b)
        rows_b, mix_b, vol_b = (ctl[0].reshape(S, T, C),
                                ctl[1].reshape(S, T, C), ctl[2].reshape(S, T))
        for mname, m in meshes.items():
            out18, l18 = driven(
                lambda: psweep.sharded_sessions(m, b, rows_b, mix_b, vol_b),
                {key: len(m)})
            got_b = pipeline.to_int16(out18).reshape(S, -1).cpu().numpy()
            if not np.array_equal(got_b, want_b):
                bad = np.argwhere(got_b != want_b)
                raise AssertionError(f"sharded {name} sessions over {mname} "
                                     f"!= the served batch at {bad.shape[0]} "
                                     f"samples, first {bad[0]}")
            print(f"phase 18 sharded_sessions {name} over {mname}: {S} "
                  f"sessions x {T} frames x {C} voices bit-exact with the "
                  f"served batch, launches {l18}")
        sess_times[name] = {
            k: mesh_timing(lambda m=m: psweep.sharded_sessions(
                m, b, rows_b, mix_b, vol_b))
            for k, m in (("1 group", [dev]), ("4 groups", mesh4))}
        del ctl, rows_b, mix_b, vol_b, out18
    print(f"phase 18 sharded_sessions timing ({smi.splitlines()[0]}): "
          + "; ".join(timing_text(f"{name} {k}", t, session_audio_s)
                      for name, tt in sess_times.items()
                      for k, t in tt.items())
          + f" (phase 9's batch: {batch_ms:.4f} ms, phase 12's "
          f"{batch93_ms:.4f} ms, each with segments94)")

    # the padded model: the four legacy streams x 72 over (tracks 2 x
    # frames 2) of this card, against batch_decode on one device and its
    # plain path
    t0 = time.perf_counter()
    padded = batched.SweepInputs(legacy * 72)
    pad_pack_s = time.perf_counter() - t0
    pargs = padded.args(dev)
    single, l_one = driven(lambda: batched.batch_decode(*pargs),
                           {"decode94_fb": 1, "transform94_pcm": 1})
    mesh22 = psweep.make_mesh([dev] * 4, frame_shards=2)
    got22, l22 = driven(lambda: psweep.sharded_sweep(mesh22, padded),
                        {"decode94_fb": 4, "transform94_pcm": 4})
    # the plain path: the four streams alone on the CPU (a padded stream's
    # rows depend on it alone)
    plain22 = batched.batch_decode(*batched.SweepInputs(legacy).args("cpu"))
    Sp, Fp = padded.rel_start.shape
    plain22 = plain22.repeat(Sp // len(legacy), 1, 1).to(dev)
    for label, a in (("sharded", got22), ("plain", plain22)):
        err = _max_abs_err(a, single)
        if err != 0 or a.shape != (Sp, Fp, 240):
            raise AssertionError(f"padded model: {label} != batch_decode "
                                 f"(max abs err {err})")
    pad_audio_s = float(padded.n_frames.sum()) * 240 / fs.SAMPLE_RATE
    # batch_decode's steps without its band-type check (a host sync)
    one_ms = _device_ms(lambda: batched.padded_pcm(*pargs), 5, torch)
    t22 = {k: mesh_timing(lambda m=m: psweep.sharded_sweep(m, padded))
           for k, m in (("1 shard", [[dev]]), ("2 x 2", mesh22))}
    print(f"phase 18 sharded_sweep ({smi.splitlines()[0]}): {Sp} streams x "
          f"{Fp} frames ({int(padded.n_frames.sum())} real), host pack "
          f"{pad_pack_s:.3f} s; (tracks 2 x frames 2) bit-exact with "
          f"batch_decode on one device and with its plain path; launches "
          f"one device {l_one}, sharded {l22}; batch_decode's steps on "
          f"resident inputs {one_ms:.4f} ms = "
          f"{pad_audio_s / (one_ms / 1e3):.1f}x realtime (real frames); "
          f"sharded_sweep with its upload: "
          + "; ".join(timing_text(k, t, pad_audio_s) for k, t in t22.items()))
    del single, got22, plain22, pargs

    # the entry points of graft_entry.py
    step, ex = graft_entry.entry()
    pcm_e, l_entry = driven(lambda: step(*ex),
                            {"decode94_fb": 1, "transform94_pcm": 1})
    cpu_step, cpu_ex = graft_entry.entry("cpu")
    if not torch.equal(pcm_e.cpu(), cpu_step(*cpu_ex)) or not bool(
            ((pcm_e >= 0) & (pcm_e <= 0xFFFF)).all()):
        raise AssertionError("graft_entry.entry() on the card != on the CPU")
    # the flat sweep (4 shards + one device) and the padded model (2 x 2 +
    # one device) each launch decode94_fb and transform94_pcm 5 times; the
    # sessions build their bank, decode one session with its carry and
    # shard 2 sessions
    mesh_d, l_dry = driven(lambda: graft_entry.dryrun_multichip(4),
                           {"decode94_fb": 10, "transform94_pcm": 12,
                            "decode94_bank": 1, "session_mix94": 3,
                            "transform94_pcm_carry": 1})
    print(f"phase 18 graft_entry: entry() {tuple(pcm_e.shape)} on the card "
          f"bit-exact with the CPU, launches {l_entry}; dryrun_multichip(4) "
          f"over {[str(d) for d in mesh_d]}: three sharded paths bit-exact "
          f"with one device, launches {l_dry}")
    for k, r in results.items():
        r["launches"] += c18[k]

    # 19. the host-decode hybrid (models/batched.py hybrid_*) at
    # flat94_music: the native dense decode on the host, the dense slots
    # uploaded whole, one dequant_mix_dense and one transform94_pcm
    t19 = time.perf_counter()
    catalog = music * COPIES

    def host_ms(fn):
        """(fn()'s result, its host ms in 3 calls after a warm-up)."""
        fn()
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn()
            ms.append((time.perf_counter() - t0) * 1e3)
        return out, ms

    decoded, decode_ms = host_ms(lambda: native.decode_dense_batch(catalog))
    host19, pack_ms = host_ms(lambda: batched.pack_dense(decoded))
    del decoded
    S19, F19 = host19[0].shape[:2]
    if S19 * F19 != n_frames or set(host19[4]) != {F19}:
        raise AssertionError(f"hybrid pack: {S19} x {F19} for {n_frames} "
                             f"frames, frame counts {set(host19[4])}")
    # phase 4's mix and volume columns, one row a stream
    mix19 = torch.tensor(arrays["mix_u16"].astype(np.int32),
                         device=dev).reshape(S19, F19)
    vol19 = torch.tensor(arrays["vol_u8"], device=dev).reshape(S19, F19)
    up_bytes = sum(a.nbytes for a in host19[:4])
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    pcm19 = batched.hybrid_batch_device(*host19[:4], mix19, vol19)
    torch.cuda.synchronize()
    c19 = dict(kernels.LAUNCHES)
    want19 = {"dequant_mix_dense": 1, "transform94_pcm": 1}
    if {k: v for k, v in c19.items() if v} != want19:
        raise AssertionError(f"hybrid batch launches {c19}, not {want19}")
    err = _max_abs_err(pcm19.reshape(-1, 240), flat_pcm, words=True)
    if err != 0 or pcm19.shape != (S19, F19, 240):
        raise AssertionError(f"hybrid flat94_music PCM != phase 4's flat "
                             f"sweep (max abs err {err})")
    del pcm19
    # the upload: staging into pinned memory (host clock), the copies
    # (device clock), 3 after a warm-up
    stage_ms, copy_ms = [], []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pinned = [torch.from_numpy(a).pin_memory() for a in host19[:4]]
        st = (time.perf_counter() - t0) * 1e3
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        on_card = [t.to(dev, non_blocking=True) for t in pinned]
        stop.record()
        torch.cuda.synchronize()
        if i:
            stage_ms.append(st)
            copy_ms.append(start.elapsed_time(stop))
    del pinned
    d19, s19, i19, v19 = (t.reshape(S19 * F19, -1) for t in on_card)
    m19, vs19 = mix19.reshape(-1), vol19.reshape(-1).int()
    n_valid = int(v19.sum())
    # the kernel against its plain version on this run's slots: the
    # function needs 256 valid flags and the mix a frame, 4 + 4 + 2 bytes
    # of each valid slot, and writes 512 words a frame; ~8 integer
    # operations a valid slot (scale, mix multiply-add, shift, the
    # shared-memory add)
    fb19 = check("dequant_mix_dense",
                 lambda: bd.dequant_mix_dense_plain(d19, (s19, i19, v19),
                                                    m19),
                 lambda: kernels.dequant_mix_dense(d19, s19, i19, v19, m19),
                 3, 10, n_frames * (256 + 4 + 512 * 4) + 10 * n_valid,
                 8 * n_valid,
                 phase=19, words=True)
    sid19 = torch.arange(S19, dtype=torch.int32,
                         device=dev).repeat_interleave(F19)
    tabs19 = batched._tables(dev)
    tr19_ms = _device_ms(lambda: kernels.transform94_pcm(fb19, vs19, sid19,
                                                         tabs19), 10, torch)
    del fb19
    # random slots: duplicate indices, indices outside 0..511, prior
    # words over 32 bits, with and without fb_prev and active
    rng = np.random.default_rng(19)
    nr = 50_000
    ix = rng.integers(-40, 560, (nr, 256)).astype(np.int16)
    ix[:, :64] = rng.integers(0, 8, (nr, 64))
    rnd = [torch.tensor(a, device=dev) for a in (
        rng.integers(-70000, 70000, (nr, 256)).astype(np.int32),
        rng.integers(-70000, 70000, (nr, 256)).astype(np.int32), ix,
        (rng.random((nr, 256)) < 0.6).astype(np.uint8),
        rng.integers(0, 1 << 16, nr).astype(np.int32),
        rng.integers(-(1 << 31), 1 << 31, (nr, 512),
                     dtype=np.int64).astype(np.int32),
        rng.random(nr) < 0.7)]
    for prev_r in (None, rnd[5]):
        for act_r in (None, rnd[6]):
            w = bd.dequant_mix_dense_plain(rnd[0], rnd[1:4], rnd[4], prev_r,
                                           act_r)
            g = kernels.dequant_mix_dense(*rnd[:5], prev_r, act_r)
            torch.cuda.synchronize()
            if not torch.equal(w, g):
                raise AssertionError(
                    f"dequant_mix_dense on random slots (fb_prev "
                    f"{prev_r is not None}, active {act_r is not None}): "
                    f"max abs err {_max_abs_err(w, g, words=True)}")
    del rnd, w, g
    # the device stage on resident slots, behind a device sleep, and its
    # peak memory above them
    stage19_ms = _device_ms(lambda: batched.hybrid_batch_device(
        *on_card, mix19, vol19), 3, torch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    batched.hybrid_batch_device(*on_card, mix19, vol19)
    torch.cuda.synchronize()
    peak19 = torch.cuda.max_memory_allocated(dev) - base
    del on_card, d19, s19, i19, v19

    # the whole call from the stream bytes to int16 PCM on the host (the
    # mix and volume columns given: phase 2's trace), beside the cold
    # flat sweep of the same catalog
    def whole():
        h = batched.hybrid_host_stage(catalog)
        return pipeline.to_int16(batched.hybrid_batch_device(
            *h[:4], mix19, vol19)).cpu()

    pcm_host, whole_ms = host_ms(whole)
    want_host = pipeline.to_int16(flat_pcm).cpu().reshape(S19, F19, 240)
    if not torch.equal(pcm_host, want_host):
        raise AssertionError("the hybrid's whole call != phase 4's PCM")
    del pcm_host, want_host
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    whole()
    peak_whole = torch.cuda.max_memory_allocated(dev) - base
    flat_chk = int(cs.checksum(flat_pcm))
    r = cold.cold_flat94(music, COPIES, E2E_CHUNKS, cdev)
    if not torch.equal(r["pcm"], flat_pcm) or r["checksum"] != flat_chk:
        raise AssertionError("cold_flat94 of flat94_music != phase 4's PCM")
    del r
    cold_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        r = cold.cold_flat94(music, COPIES, E2E_CHUNKS, cdev)
        cold_ms.append((time.perf_counter() - t0) * 1e3)
        if r["checksum"] != flat_chk:
            raise AssertionError("cold_flat94 checksum")
        del r
    # the six assets through the hybrid, against phase 5's scalar decoder
    assets = [_read(p) for p in paths]
    h6 = batched.hybrid_host_stage(assets)
    mix6 = np.zeros(h6[0].shape[:2], np.int32)
    vol6 = np.zeros(h6[0].shape[:2], np.int32)
    for k, (a, nf) in enumerate(zip(assets, h6[4])):
        mix6[k, :nf], vol6[k, :nf] = fs.trace_standalone(
            a, nf, rd.OS94, fs.MIXING_LEVEL, fs.MASTER_VOLUME)
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    pcm6 = batched.hybrid_batch_device(*h6[:4], mix6, vol6)
    torch.cuda.synchronize()
    c6 = dict(kernels.LAUNCHES)
    if {k: v for k, v in c6.items() if v} != want19:
        raise AssertionError(f"hybrid asset batch launches {c6}")
    pcm6 = pcm6.cpu().numpy()
    for k, (p, nf) in enumerate(zip(paths, h6[4])):
        got6 = pcm6[k, :nf].astype(np.int16).reshape(-1)
        if not np.array_equal(got6, ref94[p]):
            bad = np.nonzero(got6 != ref94[p])[0]
            raise AssertionError(f"hybrid {os.path.basename(p)}: {bad.size} "
                                 f"samples differ from the reference, first "
                                 f"{bad[0]}")
    for k, r in results.items():
        r["launches"] += c19[k] + c6[k]
    mean = lambda v: sum(v) / len(v)
    fmt3 = lambda v: ", ".join(f"{x:.3f}" for x in v)
    print(f"phase 19 hybrid ({smi.splitlines()[0]}): flat94_music {S19} "
          f"streams x {F19} frames; launches a batch {want19} (flat94_music "
          f"and the six assets); PCM bit-exact with phase 4's flat sweep "
          f"(same mix and volume); dequant_mix_dense bit-exact with its "
          f"plain version on this run's slots ({n_valid} valid) and on "
          f"{nr} random frames with and without fb_prev / active; the six "
          f"assets bit-exact with phase 5's ReferenceDecoder")
    print(f"phase 19 hybrid host: decode_dense_batch {fmt3(decode_ms)} ms "
          f"(mean {mean(decode_ms):.3f}), pack {fmt3(pack_ms)} ms (mean "
          f"{mean(pack_ms):.3f}); upload {up_bytes} B: pinned staging "
          f"{fmt3(stage_ms)} ms (host), copies {fmt3(copy_ms)} ms (device, "
          f"{up_bytes / (mean(copy_ms) / 1e3) / 1e9:.2f} GB/s)")
    print(f"phase 19 hybrid device: dequant_mix_dense "
          f"{times['dequant_mix_dense']:.4f} ms, transform94_pcm "
          f"{tr19_ms:.4f} ms; the stage (both, on resident slots) "
          f"{stage19_ms:.4f} ms = {audio_s / (stage19_ms / 1e3):.1f}x "
          f"realtime, peak {peak19 / 2**30:.3f} GiB above its inputs; "
          f"phase 4's warm sweep {sweep_ms:.4f} ms = "
          f"{audio_s / (sweep_ms / 1e3):.1f}x")
    print(f"phase 19 hybrid whole call (stream bytes -> int16 PCM on the "
          f"host): {fmt3(whole_ms)} ms = "
          f"{audio_s / (mean(whole_ms) / 1e3):.1f}x realtime (min "
          f"{audio_s / (min(whole_ms) / 1e3):.1f}x), peak "
          f"{peak_whole / 2**30:.3f} GiB; cold_flat94 of the same catalog "
          f"({E2E_CHUNKS} chunks, a checksum fetch) {fmt3(cold_ms)} ms = "
          f"{audio_s / (mean(cold_ms) / 1e3):.1f}x; phase wall "
          f"{time.perf_counter() - t19:.1f} s")

    # 20. the ROM compiler and the encoder CLI: a script's streams encoded
    # in batches on the card, the set played back, patch mode
    t20 = time.perf_counter()
    from dcsexplorer_tpu_torch.rom import tracks as rtracks
    from dcsexplorer_tpu_torch.tools import encoder_cli
    from dcsexplorer_tpu_torch.utils import audioio
    work = os.path.join(HERE, "build", "chip_smoke_rom")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rom_jobs, rom_audio_s = enc_jobs(ROM_FILES, rates=(31250, 31250, 44100))
    lines = ["Default encoding parameters (Type=*, Subtype=*, "
             "BitRate=128000);"]
    for k, (pcm, rate) in enumerate(rom_jobs):
        audioio.write_wav(os.path.join(work, f"f{k:03d}.wav"), pcm, rate)
        lines.append(f'Stream S{k:03d} "f{k:03d}.wav"'
                     + (" (BitRate=96000)" if k % 4 == 3 else "") + ";")
    for k in range(ROM_FILES):
        lines.append(f"Track ${k + 1:04X} channel {k % 6} {{ "
                     f"SetMixingLevel(${0x50 + k % 32:02X}); Play(S{k:03d}); "
                     f"Wait(stream); }};")
    with open(os.path.join(work, "rom.dcss"), "w") as f:
        f.write("\n".join(lines) + "\n")
    out_zip = os.path.join(work, "rom.zip")
    groups = (ROM_FILES - ROM_FILES // 4, ROM_FILES // 4)
    chunks = sum(-(-n // 16) for n in groups)
    on_enc_path = ("encode94_analyze", "encode94_decide", "encode94_select")
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    st20 = {}
    t0 = time.perf_counter()
    rc = encoder_cli.main(["--script", os.path.join(work, "rom.dcss"), "-o",
                           out_zip, "--rom-size", "1M", "-q"], stats=st20)
    compile_s = time.perf_counter() - t0
    c20 = dict(kernels.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"encoder_cli --script exited {rc}")
    if any(c20[k] != chunks for k in on_enc_path) or \
            len(st20["chunk_ms"]) != chunks:
        raise AssertionError(f"the compile's encoder launches {c20}, "
                             f"{len(st20['chunk_ms'])} chunk spans; "
                             f"expected {chunks} chunks of 16 over the "
                             f"parameter sets {groups}")
    rs20, _ = zipload.load_zip_file(out_zip)
    if rs20.check() != 1 or rs20.os_version != rd.OS94:
        raise AssertionError("the compiled set does not load as an OS94 ROM")
    with zipfile.ZipFile(out_zip) as zf:   # romgen writes the chips it used
        zip_images = [zf.read(n) for n in zf.namelist()]
    n_chips = len(zip_images)
    used = [len(img.rstrip(b"\xff")) for img in zip_images]
    if not 5 <= n_chips <= 8:
        raise AssertionError(f"the compiled set spans {n_chips} chips of "
                             f"1 MiB; expected 5 to 8")
    fmt3 = lambda v: ", ".join(f"{x:.3f}" for x in v)
    print(f"phase 20 compiler ({smi.splitlines()[0]}): {ROM_FILES} streams "
          f"(not 192: 192 of these fill only 4 chips of 1 MiB; 240 keep the "
          f"bank under the session wire's 64Ki rows), "
          f"{rom_audio_s:.1f} s audio ({ROM_FILES // 3} files at 44,100 Hz), "
          f"{n_chips} chips of 1 MiB (to the last byte written: {used}); "
          f"parameter sets {groups}, {chunks} chunks; "
          f"launches {dict((k, c20[k]) for k in on_enc_path)}")
    print(f"phase 20 compile: parse {st20['parse_s'] * 1e3:.1f} ms (WAV "
          f"read + resample + int16), prep {st20['prep_s'] * 1e3:.1f} ms, "
          f"emission {st20['emit_s'] * 1e3:.1f} ms (the fetch wait "
          f"included), layout {st20['layout_s'] * 1e3:.1f} ms; chunk device "
          f"ms [{fmt3(st20['chunk_ms'])}]; whole compile {compile_s:.3f} s "
          f"wall = {rom_audio_s / compile_s:.1f}x realtime")
    # every stream of the set, found through its track, against the port's
    # host encode of its file as the compiler reads it
    def track_bytes(rs, t, n):
        """The n bytes at the stream that track t plays."""
        ops = [op for op in rtracks.decompile_track(rs, rs.os_version, t)
               if op.opcode == 0x01]
        if len(ops) != 1:
            raise AssertionError(f"track {t}: {len(ops)} play ops")
        o = ops[0].operands
        p = rs.make_pointer((o[1] << 16) | (o[2] << 8) | o[3])
        return bytes(p.mem[p.pos:p.pos + n])

    def host_stream(path, bitrate):
        audio, rate = audioio.read_audio(path)
        return enc.encode_pcm(audio * 32768.0, enc.CompressionParams(
            target_bit_rate=bitrate), sample_rate=rate)[0]

    t0 = time.perf_counter()
    stream_bytes, checked = 0, 0
    step = 1
    for k in range(0, ROM_FILES, step):
        want = host_stream(os.path.join(work, f"f{k:03d}.wav"),
                           96000 if k % 4 == 3 else 128000)
        if track_bytes(rs20, k + 1, len(want)) != want:
            raise AssertionError(f"stream {k} of the compiled set != the "
                                 f"host encode_pcm of f{k:03d}.wav")
        stream_bytes += len(want)
        checked += 1
        if k == 15 and step == 1:
            # over 30 s for all of them: check every step-th
            est = (time.perf_counter() - t0) / 16 * ROM_FILES
            step = max(1, -(-int(est) // 30))
            if step > 1:
                print(f"phase 20: the host encode of all {ROM_FILES} "
                      f"streams would take ~{est:.0f} s: checking every "
                      f"{step}th after the first 16")
    host_check_s = time.perf_counter() - t0
    # play it back: the bank on the card, one batch of sessions
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    bank20 = romplay.build_rom_bank(rs20, dev)
    # session b starts a track of its own at frame 0 and another at 250,
    # spread over all the set's tracks (1..ROM_FILES)
    first20 = [1 + b * (ROM_FILES - 2) // ROM_SESSIONS
               for b in range(ROM_SESSIONS)]
    batch20 = [{0: [t >> 8, t & 0xFF], 250: [(t + 2) >> 8, (t + 2) & 0xFF]}
               for t in first20]
    with romplay.SessionServer(rs20, ROM_SESSIONS, ROM_FRAMES, n_ch=6,
                               seg_e=SEG_E, bank=bank20, device=dev) as srv20:
        got20 = srv20.serve_one(batch20)
    torch.cuda.synchronize()
    p20 = dict(kernels.LAUNCHES)
    on_play = ("decode94_bank", "segments94", "session_mix94",
               "transform94_pcm")
    if not all(p20[k] > 0 for k in on_play) or p20["segments94_rows32"]:
        raise AssertionError(f"a kernel of the playback did not launch, or "
                             f"the wide wire's did: {p20}")
    for b in (0, ROM_SESSIONS - 1):
        dec = rd.ReferenceDecoder()
        dec.default_volume = 0x67
        dec.load_rom_set(rs20)
        dec.soft_boot()
        ref = []
        for f in range(REF_FRAMES):
            for byte in batch20[b].get(f, ()):
                dec.write_data_port(byte)
            ref.extend(dec.next_samples(240))
        ref = np.array(ref, dtype=np.int16)
        if not np.array_equal(ref, got20[b, :REF_FRAMES * 240]):
            bad = np.nonzero(ref != got20[b, :REF_FRAMES * 240])[0]
            raise AssertionError(f"compiled set, session {b}: {bad.size} "
                                 f"samples differ from the scalar decoder, "
                                 f"first {bad[0]}")
        if not np.abs(ref.astype(np.int32)).max() > 0:
            raise AssertionError(f"compiled set, session {b} is silent")
    del bank20
    # patch mode over session6.zip: the streams of its tracks 1-4 replaced
    # (it holds 6; the first four WAVs, one at 44,100 Hz), tracks 5-6 kept
    rs6, _ = zipload.load_zip_file(SESSION6_ZIP)
    rs6.check()
    assets6 = [_read(os.path.join(STREAMS, f"{n}.dcs94")) for n in (
        "music_a", "music_b", "sine_mix_1s", "noise_sweep", "tone_low",
        "chirpy")]
    for t, a in enumerate(assets6, 1):
        if track_bytes(rs6, t, len(a)) != a:
            raise AssertionError(f"session6.zip track {t} does not play "
                                 f"its asset")
    n_rep = 4
    with open(os.path.join(work, "patch.dcss"), "w") as f:
        f.write("Default encoding parameters (Type=*, Subtype=*, "
                "BitRate=128000);\n")
        for t in range(1, n_rep + 1):
            o = [op for op in rtracks.decompile_track(rs6, rd.OS94, t)
                 if op.opcode == 0x01][0].operands
            f.write(f'Stream R{t} replaces ${o[1]:02X}{o[2]:02X}{o[3]:02X} '
                    f'"f{t - 1:03d}.wav";\n')
    patch_zip = os.path.join(work, "patched.zip")
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    rc = encoder_cli.main(["--script", os.path.join(work, "patch.dcss"),
                           "--patch", SESSION6_ZIP, "-o", patch_zip, "-q"])
    patch_s = time.perf_counter() - t0
    pc20 = dict(kernels.LAUNCHES)
    if rc != 0 or any(pc20[k] != 1 for k in on_enc_path):
        raise AssertionError(f"encoder_cli --patch exited {rc}, launches "
                             f"{pc20}")
    rsp, _ = zipload.load_zip_file(patch_zip)
    if rsp.check() != 1:
        raise AssertionError("the patched set fails its checks")
    for t in range(1, 7):
        want = (host_stream(os.path.join(work, f"f{t - 1:03d}.wav"), 128000)
                if t <= n_rep else assets6[t - 1])
        if track_bytes(rsp, t, len(want)) != want:
            raise AssertionError(f"patched set, track {t}: its stream != "
                                 + ("the host encode" if t <= n_rep else
                                    "the prototype's bytes"))
    for k, r in results.items():
        r["launches"] += c20[k] + p20[k] + pc20[k]
    print(f"phase 20 checks: {checked} of {ROM_FILES} streams ({stream_bytes} "
          f"bytes; step {step} past the first 16) byte-identical with the "
          f"host encode_pcm ({host_check_s:.3f} s); {ROM_SESSIONS} sessions x "
          f"{ROM_FRAMES} frames served on the compiled set, launches "
          f"{dict((k, p20[k]) for k in on_play)}, sessions 0 and "
          f"{ROM_SESSIONS - 1} bit-exact with ReferenceDecoder over "
          f"{REF_FRAMES} frames; --patch session6.zip replacing {n_rep} of "
          f"its 6 streams ({patch_s:.3f} s): the other 2 the prototype's "
          f"bytes, the {n_rep} the host encode; phase wall "
          f"{time.perf_counter() - t20:.1f} s")

    # 21. the FLAC, MP3 and Ogg readers into the card's encoder path, and
    # the ADSP-2105 emulator (emu/) against the card's session PCM
    t21 = time.perf_counter()
    from dcsexplorer_tpu_torch.emu.board import EmulatedDecoder
    work21 = os.path.join(HERE, "build", "chip_smoke_readers")
    shutil.rmtree(work21, ignore_errors=True)
    os.makedirs(work21)
    with open(os.path.join(DATA, "reader_inputs.json")) as f:
        pins = json.load(f)
    inputs21, read_ms = [], {}
    for name in sorted(pins):
        ext = name.rsplit(".", 1)[1]
        path = os.path.join(work21, f"in_{ext}.{ext}")
        shutil.copyfile(os.path.join(DATA, name), path)
        read_ms[ext] = []
        for _ in range(3):
            t0 = time.perf_counter()
            audio, rate = audioio.read_audio(path)
            read_ms[ext].append(1e3 * (time.perf_counter() - t0))
        a = np.ascontiguousarray(audio, dtype=np.float32)
        got = {"rate": int(rate), "samples": int(a.size),
               "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
        if got != pins[name]:
            raise AssertionError(f"{name}: the reader's PCM {got} != the "
                                 f"pinned {pins[name]}")
        inputs21.append(path)
    (wav_pcm, wav_rate), = enc_jobs(1, rates=(44100,))[0]
    inputs21.append(os.path.join(work21, "in_wav.wav"))
    audioio.write_wav(inputs21[-1], wav_pcm, wav_rate)
    print(f"phase 21 readers ({smi.splitlines()[0]}): "
          + "; ".join(f"{ext} {pins[n]['samples']} samples at "
                      f"{pins[n]['rate']} Hz, decode ms ["
                      + fmt3(read_ms[ext]) + "]"
                      for n, ext in zip(sorted(pins), read_ms))
          + "; each equal to the PCM pinned in reader_inputs.json")
    # the encoder CLI on the three files and one WAV, on the card (no
    # --device): one chunk, one launch of each encoder kernel
    cli_out = os.path.join(work21, "cli")
    os.makedirs(cli_out)
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = encoder_cli.main([*inputs21, "-o", cli_out])
    cli_s = time.perf_counter() - t0
    c21 = dict(kernels.LAUNCHES)
    if rc != 0 or any(c21[k] != 1 for k in on_enc_path):
        raise AssertionError(f"encoder_cli on the reader inputs exited {rc}, "
                             f"launches {c21}")
    host21 = {}
    for path in inputs21:
        host21[path] = host_stream(path, 128000)
        stem = os.path.splitext(os.path.basename(path))[0]
        got, _ = audioio.read_dcs_raw(os.path.join(cli_out, stem + ".dcs"))
        if got != host21[path]:
            raise AssertionError(f"{stem}: the card's stream != the host "
                                 f"encode_pcm of the reader's PCM")
    # a script naming the three files on tracks of their own
    with open(os.path.join(work21, "readers.dcss"), "w") as f:
        f.write("Default encoding parameters (BitRate=128000);\n")
        for k, path in enumerate(inputs21[:3]):
            f.write(f'Stream R{k} "{os.path.basename(path)}";\n')
        for k in range(3):
            f.write(f"Track ${k + 1:04X} channel {k} {{ Play(R{k}); "
                    f"Wait(stream); }};\n")
    zip21 = os.path.join(work21, "readers.zip")
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = encoder_cli.main(["--script", os.path.join(work21,
                                                        "readers.dcss"),
                               "-o", zip21, "-q"])
    script21_s = time.perf_counter() - t0
    sc21 = dict(kernels.LAUNCHES)
    if rc != 0 or any(sc21[k] != 1 for k in on_enc_path):
        raise AssertionError(f"encoder_cli --script of the reader inputs "
                             f"exited {rc}, launches {sc21}")
    rs21, _ = zipload.load_zip_file(zip21)
    if rs21.check() != 1:
        raise AssertionError("the readers' ROM fails its checks")
    for k, path in enumerate(inputs21[:3]):
        if track_bytes(rs21, k + 1, len(host21[path])) != host21[path]:
            raise AssertionError(f"the readers' ROM, track {k + 1}: its "
                                 f"stream != the host encode_pcm")
    print(f"phase 21 encoder_cli on {len(inputs21)} inputs (flac, mp3, ogg, "
          f"wav at 44,100 Hz) on the card ({smi.splitlines()[0]}): "
          f"{cli_s:.3f} s wall, launches "
          f"{dict((k, c21[k]) for k in on_enc_path)}, every stream "
          f"byte-identical with the host encode_pcm; --script naming the "
          f"three: compile {script21_s:.3f} s wall, launches "
          f"{dict((k, sc21[k]) for k in on_enc_path)}, each track's stream "
          f"the host encode_pcm's")

    # the emulator, strict and fast, against the card's sessions: 4 tracks
    # of phase 20's set (firmware94) and of session93a.zip (firmware93),
    # REF_FRAMES frames each, with version queries and a volume command
    def events21(t):
        return {0: [t >> 8, t & 0xFF], 10: [0x55, 0xC2], 20: [0x55, 0xC3],
                30: [0x55, 0xAA, 0x50, 0xAF]}

    def emulate(rs, t, fast):
        dec = EmulatedDecoder(enable_speedup=fast)
        dec.default_volume = 0x67
        dec.load_rom_set(rs)
        dec.soft_boot()
        if dec.state != rd.ST_RUNNING or not dec.native_cpu or (
                fast and dec.speedup_info is None):
            raise AssertionError(f"the emulator did not start: "
                                 f"{dec.error_message}")
        out = []
        for f in range(REF_FRAMES):
            for byte in events21(t).get(f, ()):
                dec.write_data_port(byte)
            out.extend(dec.next_samples(240))
        return np.array(out, dtype=np.int16), list(dec.host.rx)

    rs93, _ = zipload.load_zip_file(SESSION93A_ZIP)
    rs93.check()
    emu_rate, emu21 = {}, {}
    for label, rs, tracks, want in (
            ("phase 20's set", rs20,
             [1 + k * (ROM_FILES - 1) // 3 for k in range(4)],
             ("decode94_bank", "session_mix94")),
            ("session93a.zip", rs93, [1, 2, 3, 4],
             ("decode93_pcm_carry",))):
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        bank = romplay.build_rom_bank(rs, dev)
        card = []
        for t in tracks:
            ev = {f: (lambda dec, bs=bs: [dec.write_data_port(b)
                                          for b in bs])
                  for f, bs in events21(t).items()}
            pcm, tracer = romplay.play_session(rs, ev, REF_FRAMES, bank=bank)
            card.append((pcm, list(tracer.host.rx)))
        torch.cuda.synchronize()
        e21 = dict(kernels.LAUNCHES)
        emu21[label] = e21
        if not all(e21[k] > 0 for k in want):
            raise AssertionError(f"{label}: a kernel of the card's sessions "
                                 f"did not launch: {e21}")
        del bank
        for fast in (False, True):
            t0 = time.perf_counter()
            got = [emulate(rs, t, fast) for t in tracks]
            wall = time.perf_counter() - t0
            mode = "fast" if fast else "strict"
            emu_rate[label, mode] = len(tracks) * REF_FRAMES / wall
            for t, (pcm, rx), (cpcm, crx) in zip(tracks, got, card):
                if not np.array_equal(pcm, cpcm) or rx != crx:
                    bad = np.nonzero(pcm != cpcm)[0]
                    raise AssertionError(
                        f"{label}, track {t}: emulator-{mode} != the card: "
                        f"{bad.size} samples differ (first "
                        f"{bad[:1].tolist()}), port bytes {rx} vs {crx}")
                if not np.abs(pcm.astype(np.int32)).max() > 0 or not rx:
                    raise AssertionError(f"{label}, track {t}: silent or "
                                         f"no port bytes")
        print(f"phase 21 emulator vs the card on {label}, tracks {tracks}, "
              f"{REF_FRAMES} frames each: emulator-strict, emulator-fast and "
              f"play_session bit-exact in PCM and data-port bytes "
              f"({card[0][1]}); card launches "
              f"{dict((k, v) for k, v in e21.items() if v)}")
    print(f"phase 21 emulator rate on the host ({smi.splitlines()[0]}): "
          + "; ".join(f"{label} {mode} {r:.0f} frames/s = "
                      f"{r * 240 / 31250:.1f}x realtime"
                      for (label, mode), r in emu_rate.items()))
    # the explorer's extraction: --backend emulator-strict as a subprocess
    # against --backend cuda in process, WAV for WAV
    x21 = os.path.join(work21, "x")
    for d in ("emu", "card"):
        os.makedirs(os.path.join(x21, d))
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "dcsexplorer_tpu_torch.tools.explorer",
         out_zip, "--extract-tracks", os.path.join(x21, "emu", "t"),
         "--backend", "emulator-strict", "--max-track-frames", "60"],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    xemu_s = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"explorer --backend emulator-strict: rc "
                             f"{r.returncode}\n{r.stderr}")
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    xcard_s, _ = cli([out_zip, "--extract-tracks", os.path.join(x21, "card",
                                                                "t"),
                      "--max-track-frames", "60"])
    x21c = dict(kernels.LAUNCHES)
    emu_wavs = wavs(os.path.join(x21, "emu", "t"))
    card_wavs = wavs(os.path.join(x21, "card", "t"))
    if len(emu_wavs) != ROM_FILES or emu_wavs != card_wavs:
        raise AssertionError(f"explorer --extract-tracks: {len(emu_wavs)} "
                             f"emulator WAVs, {len(card_wavs)} card WAVs, "
                             f"not byte-identical")
    print(f"phase 21 python -m dcsexplorer_tpu_torch.tools.explorer "
          f"<phase 20's set> --extract-tracks --backend emulator-strict "
          f"--max-track-frames 60: {len(emu_wavs)} WAVs byte-identical with "
          f"--backend cuda's ({smi.splitlines()[0]}: {xemu_s:.3f} s with the "
          f"interpreter's start, against {xcard_s:.3f} s in process on the "
          f"card, launches {dict((k, v) for k, v in x21c.items() if v)}); "
          f"phase "
          f"wall {time.perf_counter() - t21:.1f} s")
    for k, r in results.items():
        r["launches"] += (c21[k] + sc21[k] + x21c[k]
                          + sum(e[k] for e in emu21.values()))
    shutil.rmtree(work21, ignore_errors=True)

    # 22. the last tools on the card: the bench assets, corpus validation
    # and checkpoints of a resumed scalar decoder and emulator
    t22 = time.perf_counter()
    import pickle
    from dcsexplorer_tpu_torch.tools import make_bench_assets, test_all
    from dcsexplorer_tpu_torch.utils import state as dstate
    work22 = os.path.join(HERE, "build", "chip_smoke_tools")
    shutil.rmtree(work22, ignore_errors=True)
    os.makedirs(work22)
    # (a) make_bench_assets into a directory that holds the committed
    # manifest (its merge runs as in place): one encode_files_device call
    # for the two 1994+ music streams; then, for the card's time, a second
    # run under a trace, which must hold the encoder's kernels, each after
    # its launch.  The traced run goes to a fresh interpreter, which warms
    # up untraced first: after phases 1-21 the profiler of this process
    # can map the card's timestamps onto the host's clock wrongly (kernels
    # placed before their launches with their durations shrunk, or dropped
    # as outside the window: PERF.md section 7).  The same run traced here
    # is printed beside it, for comparison only
    music = ("music_a.dcs94", "music_b.dcs94", "music_a.dcs93b",
             "music_b.dcs93a")
    written = music + ("dense_t1.dcs93a1", "dense_t1b.dcs93a1")
    out22 = [os.path.join(work22, d) for d in ("assets", "traced")]
    for d in out22:
        os.makedirs(d)
        shutil.copyfile(os.path.join(STREAMS, "manifest.json"),
                        os.path.join(d, "manifest.json"))
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = make_bench_assets.main(["--out", out22[0]])
    assets_s = time.perf_counter() - t0
    a22 = dict(kernels.LAUNCHES)
    if rc != 0 or any(a22[k] != 1 for k in on_enc_path):
        raise AssertionError(f"make_bench_assets exited {rc}, launches "
                             f"{dict((k, a22[k]) for k in on_enc_path)}: "
                             f"expected one of each encoder kernel")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-c", TRACED_ASSETS, os.path.join(work22, "warm"),
         out22[1], os.path.join(HERE, "build", "torch_trace")],
        cwd=HERE, capture_output=True, text=True, timeout=300)
    traced_s = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"the traced make_bench_assets process exited "
                             f"{r.returncode}\n{r.stdout}\n{r.stderr}")
    child = json.loads(r.stdout.strip().splitlines()[-1])
    at22 = child["launches"]
    got22 = [{n: _read(os.path.join(d, n)) for n in written + (
        "manifest.json",)} for d in out22]
    if child["rc"] != 0 or got22[1] != got22[0] or any(
            at22[k] != 1 for k in on_enc_path):
        raise AssertionError(f"the traced make_bench_assets run exited "
                             f"{child['rc']}, launches {at22}, or wrote "
                             f"other bytes")
    s22 = profiling.trace_summary(child["trace"])
    if s22["lead_ms"] > 1.0:
        raise AssertionError(f"{child['trace']}: a kernel starts "
                             f"{s22['lead_ms']:.3f} ms before its launch: "
                             f"the trace's device clock is off")
    with profiling.device_trace() as prof22:
        with contextlib.redirect_stdout(io.StringIO()):
            make_bench_assets.main(["--out", os.path.join(work22, "here")])
        torch.cuda.synchronize()
    try:
        h = profiling.trace_summary(prof22.trace_file)
        here22 = (f"card busy {h['busy_ms']:.3f} ms, kernels at most "
                  f"{h['lead_ms']:.3f} ms before their launches, "
                  f"{sum(c for _, c, _ in h['kernels'])} kernel events")
    except ValueError as e:
        here22 = str(e)
    got22 = got22[0]
    if sorted(os.listdir(out22[0])) != sorted(written + ("manifest.json",)):
        raise AssertionError(f"make_bench_assets wrote "
                             f"{sorted(os.listdir(out22[0]))}")
    # every stream against the port's host encode of the same PCM; the
    # Type-1 streams and the manifest's other entries are the committed
    synth = {"music_a": make_bench_assets.synth_music(8.0, seed=11,
                                                      root=220.0),
             "music_b": make_bench_assets.synth_music(8.0, seed=23,
                                                      root=174.6)}
    t0 = time.perf_counter()
    for name in music:
        stem, ext = name.split(".")
        os_v = {"dcs94": None, "dcs93b": rd.OS93B, "dcs93a": rd.OS93A}[ext]
        want = enc.encode_pcm(synth[stem], None, os_version=os_v)[0]
        if got22[name] != want:
            raise AssertionError(f"make_bench_assets {name} != the host "
                                 f"encode_pcm of the same PCM")
    host22_s = time.perf_counter() - t0
    for name in written[4:]:
        if got22[name] != _read(os.path.join(STREAMS, name)):
            raise AssertionError(f"make_bench_assets {name} != the "
                                 f"committed file")
    committed = json.loads(_read(os.path.join(STREAMS, "manifest.json")))
    manifest = json.loads(got22["manifest.json"])
    for name in written:
        committed[name]["bytes"] = len(got22[name])
    if manifest != committed:
        raise AssertionError("make_bench_assets' manifest != the committed "
                             "one with the written sizes")
    print(f"phase 22 make_bench_assets --out ({smi.splitlines()[0]}): wall "
          f"{assets_s:.3f} s (synthesis, one encode_files_device call of "
          f"the two 1994+ streams, the two 1993 encodes on the host, the "
          f"writes), encoder launches "
          f"{dict((k, a22[k]) for k in on_enc_path)}; the traced run (a "
          f"fresh process, {traced_s:.3f} s with its start and warm-up): "
          f"card busy {s22['busy_ms']:.3f} ms of a {s22['window_ms']:.3f} "
          f"ms window (idle share {s22['idle_share']:.4f}, kernels at most "
          f"{s22['lead_ms']:.3f} ms before their launches), kernels "
          + "; ".join(f"{n[:40]} x{c} {ms:.4f} ms"
                      for n, c, ms in s22["kernels"])
          + f"; the same run traced in this process: {here22}"
          + f"; every stream the host encode_pcm's ({host22_s:.3f} s), "
          f"dense_t1*.dcs93a1 the committed files, the manifest the "
          f"committed one but for the written sizes; the music against the "
          f"committed files (bytes): "
          + ", ".join(f"{n} {len(got22[n])} vs "
                      f"{len(_read(os.path.join(STREAMS, n)))}"
                      for n in music))
    # (b) test_all over session6.zip, session93a.zip and phase 20's set
    roms22 = os.path.join(work22, "roms")
    os.makedirs(roms22)
    for src in (SESSION6_ZIP, SESSION93A_ZIP):
        shutil.copyfile(src, os.path.join(roms22, os.path.basename(src)))
    shutil.copyfile(out_zip, os.path.join(roms22, "rom_compile.zip"))
    res22 = os.path.join(work22, "results")
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as log22:
        rc = test_all.main([roms22, res22, "--max-track-frames",
                            str(VALIDATE_FRAMES)])
    validate_s = time.perf_counter() - t0
    v22 = dict(kernels.LAUNCHES)
    names22 = ("rom_compile", "session6", "session93a")
    markers = sorted(n for n in os.listdir(res22)
                     if not n.endswith(".log"))
    if rc != 0 or markers != [f"{n}.success" for n in names22]:
        raise AssertionError(f"test_all exited {rc}, markers {markers}:\n"
                             f"{log22.getvalue()}")
    on_val = ("decode94_bank", "session_mix94", "transform94_pcm_carry",
              "decode93_pcm_carry")
    if not all(v22[k] > 0 for k in on_val):
        raise AssertionError(f"a kernel of the validation did not launch: "
                             f"{v22}")
    compared = [ln for n in names22 for ln in _read(os.path.join(
        res22, f"{n}.log")).decode().splitlines()
        if ln.startswith("Samples compared")]
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "dcsexplorer_tpu_torch.tools.test_all",
         roms22, res22, "--versions"],
        cwd=HERE, capture_output=True, text=True, timeout=300)
    versions_s = time.perf_counter() - t0
    if r.returncode != 0 or len(r.stdout.splitlines()) != 3 or \
            "ERROR" in r.stdout or "POST code" in r.stdout:
        raise AssertionError(f"test_all --versions: rc {r.returncode}\n"
                             f"{r.stdout}\n{r.stderr}")
    print(f"phase 22 test_all over {', '.join(names22)} at "
          f"--max-track-frames {VALIDATE_FRAMES} on the card "
          f"({smi.splitlines()[0]}): {validate_s:.3f} s wall, every ROM "
          f".success ({'; '.join(compared)}), launches "
          f"{dict((k, v) for k, v in v22.items() if v)}; python -m "
          f"dcsexplorer_tpu_torch.tools.test_all --versions: rc 0 in "
          f"{versions_s:.3f} s: {' | '.join(r.stdout.splitlines())}")
    # (c) checkpoints on phase 20's set: the scalar decoder and the
    # emulator (native core, strict) snapshot mid-frame, save, load into
    # fresh decoders; the next CKPT_FRAMES frames against the uninterrupted
    # run and the card's play_session
    t_a, t_b = 1 + (ROM_FILES - 1) // 3, 2 + 2 * (ROM_FILES - 1) // 3
    ev22 = {0: [t_a >> 8, t_a & 0xFF], 6: [t_b >> 8, t_b & 0xFF],
            13: [0x55, 0xAA, 0x58, 0x58 ^ 0xFF]}
    at = CKPT_FRAME * 240 + 77          # mid-frame, after every event
    span = slice(at, at + CKPT_FRAMES * 240)
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    card22, _ = romplay.play_session(
        rs20, {f: (lambda dec, bs=bs: [dec.write_data_port(b) for b in bs])
               for f, bs in ev22.items()}, CKPT_FRAME + CKPT_FRAMES + 1,
        device=dev)
    torch.cuda.synchronize()
    c22 = dict(kernels.LAUNCHES)
    if not all(c22[k] > 0 for k in on_val[:3]):
        raise AssertionError(f"a kernel of play_session did not launch: "
                             f"{c22}")
    card22 = card22[span]

    def drive(dec):
        dec.default_volume = 0x67
        dec.load_rom_set(rs20)
        dec.soft_boot()
        for f in range(CKPT_FRAME):
            for b in ev22.get(f, ()):
                dec.write_data_port(b)
            dec.next_samples(240)
        dec.next_samples(77)
        return dec

    ckpt22 = {}
    for label, make, snap, restore in (
            ("ReferenceDecoder", rd.ReferenceDecoder, dstate.snapshot,
             dstate.restore),
            ("emulator-strict", EmulatedDecoder, dstate.snapshot_emulated,
             dstate.restore_emulated)):
        t0 = time.perf_counter()
        dec = drive(make())
        path = os.path.join(work22, f"{label}.pkl")
        with open(path, "wb") as f:
            pickle.dump(snap(dec), f)
        want = np.array(dec.next_samples(CKPT_FRAMES * 240), dtype=np.int16)
        fresh = make()
        fresh.default_volume = 0x67
        fresh.load_rom_set(rs20)
        with open(path, "rb") as f:
            restore(fresh, pickle.load(f))
        got = np.array(fresh.next_samples(CKPT_FRAMES * 240),
                       dtype=np.int16)
        for other, ref in (("the uninterrupted run", want),
                           ("the card's play_session", card22)):
            if not np.array_equal(got, ref):
                bad = np.nonzero(got != ref)[0]
                raise AssertionError(f"{label} resumed from its checkpoint "
                                     f"!= {other}: {bad.size} samples "
                                     f"differ, first {bad[0]}")
        if not np.abs(got.astype(np.int32)).max() > 0:
            raise AssertionError(f"{label}: the resumed frames are silent")
        ckpt22[label] = (os.path.getsize(path), time.perf_counter() - t0)
    print(f"phase 22 checkpoints on phase 20's set, tracks {t_a} and {t_b} "
          f"and a volume command, saved {CKPT_FRAME} frames + 77 samples "
          f"in: "
          + "; ".join(f"{label} ({size} bytes pickled, {s:.3f} s)"
                      for label, (size, s) in ckpt22.items())
          + f": each loaded into a fresh decoder plays the next "
          f"{CKPT_FRAMES} frames bit-exact with the uninterrupted run and "
          f"the card's play_session (launches "
          f"{dict((k, v) for k, v in c22.items() if v)}); phase wall "
          f"{time.perf_counter() - t22:.1f} s")
    for k, r in results.items():
        r["launches"] += a22[k] + at22[k] + v22[k] + c22[k]
    shutil.rmtree(work22, ignore_errors=True)
    shutil.rmtree(work, ignore_errors=True)

    # 23. the full eight-chip title: one batch at os94full.sessions' width
    t23 = time.perf_counter()
    rs23, _ = zipload.load_zip_file(FULL_TITLE_ZIP)
    if rs23.check() != 1 or rs23.os_version != rd.OS94:
        raise AssertionError("rom94full.zip does not load as an OS94 ROM")
    bank23 = romplay.build_rom_bank(rs23, dev)
    S, T, C = FULL_SESSIONS, SESSION_FRAMES, VOICES
    F = S * T
    batch23 = [full_title_events(b, rs23.n_tracks - 1) for b in range(S)]
    with romplay.SessionServer(rs23, S, T, n_ch=C, seg_e=SEG_E, bank=bank23,
                               device=dev) as srv23:
        wire23_np, E23 = srv23.prepare(batch23)
        wire23 = torch.tensor(wire23_np, device=dev)
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        got23 = srv23.decode_wire(wire23, E23).cpu().numpy()
        w23 = dict(kernels.LAUNCHES)
    if not srv23.wide or wire23.numel() != 9 * S * C * E23 + S * T:
        raise AssertionError(f"rom94full.zip ({bank23.total_rows()} rows): "
                             f"the batch is not on the wide wire")
    if {k: v for k, v in w23.items() if v} != {
            "segments94_rows32": 1, "session_mix94": 1, "transform94_pcm": 1}:
        raise AssertionError(f"the full title's batch did not run once "
                             f"through segments94_rows32: {w23}")
    with romplay.SessionServer(rs23, S, T, n_ch=C, seg_e=SEG_E, bank=bank23,
                               device=dev) as plain23:
        want23 = plain_serve_one(plain23, batch23)
    if not np.array_equal(want23, got23):
        bad = np.argwhere(want23 != got23)
        raise AssertionError(f"full-title batch != plain batch at "
                             f"{bad.shape[0]} samples, first {bad[0]}")
    del want23
    for b in (0, S - 1):
        dec = rd.ReferenceDecoder()
        dec.default_volume = 0x67
        dec.load_rom_set(rs23)
        dec.soft_boot()
        ref = []
        for f in range(REF_FRAMES):
            for byte in batch23[b].get(f, ()):
                dec.write_data_port(byte)
            ref.extend(dec.next_samples(240))
        ref = np.array(ref, dtype=np.int16)
        if not np.array_equal(ref, got23[b, :REF_FRAMES * 240]):
            bad = np.nonzero(ref != got23[b, :REF_FRAMES * 240])[0]
            raise AssertionError(f"full-title session {b}: {bad.size} "
                                 f"samples differ from the scalar decoder, "
                                 f"first {bad[0]}")
    # the wide instance against its plain version at the cell's shape; a
    # wire of u32 bases, as phase 8 counts segments94's bytes and operations
    rows23 = check(
        "segments94_rows32",
        lambda: romplay.segments94_plain(wire23, S, T, C, E23),
        lambda: kernels.segments94(wire23, S, T, C, E23), 2, 20,
        wire23.numel() + F * C * 8 + F * 4, F * C * 3, phase=23)[0]
    results["segments94_rows32"]["launches"] = w23["segments94_rows32"]
    base23 = romplay.unpack_controls_wire(wire23, S, T, C, E23)[1]
    print(f"phase 23 full title: rom94full.zip, {sum(c is not None for c in rs23.chips)} chips, "
          f"bank {bank23.total_rows()} rows; one batch of {S} sessions x "
          f"{T} frames x {C} voices on the wide wire ({wire23.numel()} B, "
          f"E {E23}; {int((base23 >= 1 << 16).sum())} segment bases and "
          f"{int((rows23 >= 1 << 16).sum())} of {F * C} voice-frames past "
          f"u16) through SessionServer, bit-exact with the plain batch on "
          f"the card, sessions 0 and {S - 1} with the port's "
          f"ReferenceDecoder over {REF_FRAMES} frames; launches "
          f"{dict((k, v) for k, v in w23.items() if v)}; phase wall "
          f"{time.perf_counter() - t23:.1f} s")
    del wire23, rows23, base23, got23, bank23
    torch.cuda.empty_cache()

    print(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
