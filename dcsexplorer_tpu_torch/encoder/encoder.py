"""DCS stream encoder: PCM in, streams out, with the 1994+ format search
on the device.

The port's copy of the JAX package's ``encoder/encoder.py``.  The device
path (``encode_files_device``): PCM → int16 at 31,250 Hz → raw 256-sample
frames (stride 240, 16-sample overlap) → integer analysis coefficients →
per-stream setup → the device's format search (``device94.py``) → the
host's emission of the winner.  ``encode_files`` sends every 1994+ job of
the "pinv" analysis there.  The host paths stay as in the JAX package:
``encode_pcm`` (one stream: the native 1994+ search, the 1993 encoder of
``encoder93.py``, or a comparison analysis transform), ``transcode_stream``
(a stream into another format family) and ``encode_files``' process pool
for the families that have no device path.
"""

from dataclasses import dataclass

import numpy as np

from ..format import tables as T
from . import analysis

FRAME = 240
WIN = 256
RATE = 31250


@dataclass
class CompressionParams:
    """Quality knobs (reference: DCSEncoder.h:70-181)."""
    stream_format_type: int = -1      # 0/1, or -1 = try both, keep smallest
    stream_format_subtype: int = -1   # 0/3, or -1 = try both, keep smallest
    power_band_cutoff: float = 0.97   # fraction of RMS power to keep
    target_bit_rate: int = 128000
    minimum_dynamic_range: float = 10.0 / 32768.0
    maximum_quantization_error: float = 10.0 / 32768.0
    # forward transform: "pinv" (production: the integer-canonical
    # analysis of forward_matrix_q, on the device for the 1994+ family),
    # "butterfly" (the independent inverse-passes derivation) or "dual"
    # (cross-check both) — counterpart of the reference's
    # DFTAlgorithmOrig/New pair (DCSEncoder.cpp:1019-1035); those two run
    # on the host's float path
    analysis_transform: str = "pinv"


class BitWriter:
    """MSB-first bit packer (counterpart of reference BitWriter,
    DCSEncoder.h:333-389)."""

    def __init__(self):
        self.chunks = []
        self.acc = 0
        self.nbits = 0

    def write(self, val, n):
        # int() guards against numpy scalar poisoning: under NEP 50
        # (numpy >= 2), `python_int | np.int32` stays int32, so a numpy val
        # would silently turn the accumulator into a fixed-width integer
        # that overflows on long (30-bit) Huffman codewords.
        val, n = int(val), int(n)
        acc = (self.acc << n) | (val & ((1 << n) - 1))
        nbits = self.nbits + n
        chunks = self.chunks
        while nbits >= 8:
            nbits -= 8
            chunks.append((acc >> nbits) & 0xFF)
        # keep only the unflushed residue (an unbounded accumulator would
        # make packing O(N^2) in the stream length)
        self.acc = acc & ((1 << nbits) - 1)
        self.nbits = nbits

    def bytes(self):
        out = bytearray(self.chunks)
        if self.nbits:
            out.append((self.acc << (8 - self.nbits)) & 0xFF)
        return bytes(out)


def encode_frames(coefs, params: CompressionParams):
    """Encode analysis coefficients through the native 1994+ search
    (core94.encode_stream94): every requested stream format — {type 0,1}
    × {subtype 0,3}, -1 a wildcard — keeping the smallest (reference:
    DCSEncoder.cpp:784-853).

    coefs: [F, 255] float (±32768 domain) or int32 (already canonical)."""
    from . import core94
    coefs = np.asarray(coefs)
    if coefs.dtype != np.int32:
        ci = np.clip(np.rint(coefs), -(1 << 20), 1 << 20).astype(np.int32)
    else:
        ci = coefs
    return core94.encode_stream94(ci, params)


# ----------------------------------------------------------------------

# level calibration: the decode chain at default settings (mixing level 0x64,
# master volume 255) applies a net gain to the frame-buffer coefficients,
# measured here through the scalar decoder with one known coefficient
_DECODE_GAIN = None


def _decode_gain():
    global _DECODE_GAIN
    if _DECODE_GAIN is None:
        from ..refdec.decoder import OS94, ReferenceDecoder
        # measure through the real decoder: a stream with one known coefficient
        probe = np.zeros((8, 255), dtype=np.float32)
        probe[:, 40] = 8000.0
        params = CompressionParams()
        stream = encode_frames(probe, params)
        dec = ReferenceDecoder()
        dec.default_volume = 255
        dec.init_standalone(OS94)
        dec.soft_boot()
        dec.load_audio_stream(0, stream, mixing_level=0x64)
        pcm = np.array(dec.next_samples(8 * FRAME), dtype=np.float64)
        # reconstruct the expected unit-gain output
        fb = np.zeros((1, 255), dtype=np.float32)
        fb[0, 40] = 8000.0
        ideal = (fb @ analysis.decoder_matrix())[0]
        # skip the 16-sample overlap crossfade at the frame head
        seg = pcm[2 * FRAME + 16:3 * FRAME].astype(np.float64)
        ref = ideal[16:FRAME].astype(np.float64)
        _DECODE_GAIN = float(np.dot(seg, ref) / np.dot(ref, ref))
    return _DECODE_GAIN


def _encoder_window():
    """Complementary pre-window for frame edges.

    The decoder crossfades frame k+1's head with frame k's tail through the
    overlap coefficients w (ops/transform.py), which are NOT complementary by
    themselves.  Perfect reconstruction requires the encoder to pre-window
    each frame's first/last 16 samples with wf satisfying
        wf[j]·w[j] + wf[15-j]·w[15-j] = 1.
    We use the energy-normalized solution wf[j] = w[j] / (w[j]² + w[15-j]²),
    which satisfies the constraint exactly.
    """
    w = np.asarray(T.OVERLAP_COEFF, dtype=np.float64) / 32768.0
    return (w / (w ** 2 + w[::-1] ** 2)).astype(np.float32)


_WF = _encoder_window()

# ----------------------------------------------------------------------
# integer-canonical analysis: the analysis matrix — with the complementary
# edge window folded in as diag(w)·F — is quantized once to int16 at scale
# 2^21, and the coefficients are defined as
#   ci = floor((frames_i16 @ Fq + 2^20) / 2^21)
# over RAW int16 frames.  Every quantity is an exact integer (|x| ≤ 2^15,
# |Fq| < 2^15, 256-term dots < 2^38 < 2^53), so the host (float64 BLAS)
# and the device (csrc/encode94_analyze.cu, int64 sums) compute
# bit-identical ci — which is what lets the device encoder emit
# byte-identical streams from PCM without shipping coefficients to it.

FQ_SHIFT = 21
_FQ = None


def forward_matrix_q():
    """[256, 255] int16 window-folded analysis matrix at scale 2^FQ_SHIFT."""
    global _FQ
    if _FQ is None:
        w = np.ones(256, dtype=np.float64)
        w[:16] = _WF
        w[240:] = _WF[::-1]
        fw = w[:, None] * analysis.forward_matrix().astype(np.float64)
        q = np.rint(fw * (1 << FQ_SHIFT))
        assert np.abs(q).max() < (1 << 15), "analysis matrix overflows int16"
        _FQ = q.astype(np.int16)
    return _FQ


def frames_from_pcm_raw(pcm_i16):
    """Split int16 PCM into RAW [F, 256] int16 overlapped frames (stride
    240, no windowing — the edge window lives inside forward_matrix_q)."""
    pcm_i16 = np.asarray(pcm_i16, dtype=np.int16)
    F = max(1, int(np.ceil(len(pcm_i16) / FRAME)))
    padded = np.zeros(F * FRAME + 16, dtype=np.int16)
    padded[:len(pcm_i16)] = pcm_i16
    idx = np.arange(WIN)[None, :] + FRAME * np.arange(F)[:, None]
    return padded[idx]


def analyze_frames_canonical(frames_i16):
    """Canonical int32 coefficients from raw int16 frames (host half).

    float64 keeps every intermediate exact (see the module comment), and
    division by 2^FQ_SHIFT is an exact scale, so np.floor here equals the
    device's integer evaluation (an arithmetic shift) bit for bit."""
    p = frames_i16.astype(np.float64) @ forward_matrix_q().astype(np.float64)
    ci = np.floor((p + (1 << (FQ_SHIFT - 1))) * (1.0 / (1 << FQ_SHIFT)))
    return np.clip(ci, -(1 << 20), 1 << 20).astype(np.int32)


def pcm_to_int16(pcm, sample_rate=RATE):
    """Canonicalize any PCM input to int16 at the DCS rate (the integer
    contract's entry point: resampler output and float inputs round once
    here)."""
    pcm = np.asarray(pcm)
    if sample_rate != RATE:
        from .resample import resample
        pcm = resample(pcm.astype(np.float32), sample_rate, RATE)
    if pcm.dtype == np.int16:
        return pcm
    return np.clip(np.rint(pcm), -32768, 32767).astype(np.int16)


def encode_files_device(jobs, params: CompressionParams = None,
                        device="cuda", stats=None):
    """Encode many PCM buffers through the batched device encoder: the
    host canonicalizes PCM to int16, computes its own coefficients (for the
    emission) and each stream's setup; the device re-derives the same
    coefficients from the raw PCM and runs the whole format search
    (device94.DeviceEncoder94); the host emits each winner.  Byte-identical
    to the host encoder for every input.

    jobs: list of (pcm, sample_rate).  Returns list of (stream, n_frames).
    device "cuda" (the default) needs a card and raises without one;
    "cpu" runs the plain PyTorch versions.  stats: a dict to receive the
    host's timings (device94.encode_jobs_pcm)."""
    from . import device94
    if params is None:
        params = CompressionParams()
    return device94.encode_jobs_pcm(jobs, params, device=device,
                                    stats=stats)


def frames_from_pcm(pcm):
    """Split PCM (float ±32768 domain) into [F, 256] overlapped frames
    (stride 240, 16-sample carry), edge-windowed, zero-padded at the tail."""
    pcm = np.asarray(pcm, dtype=np.float32)
    F = max(1, int(np.ceil(len(pcm) / FRAME)))
    padded = np.zeros(F * FRAME + 16, dtype=np.float32)
    padded[:len(pcm)] = pcm
    idx = np.arange(WIN)[None, :] + FRAME * np.arange(F)[:, None]
    frames = padded[idx].copy()
    frames[:, :16] *= _WF[None, :]
    frames[:, 240:] *= _WF[None, ::-1]
    return frames


def encode_pcm(pcm, params: CompressionParams = None, sample_rate=RATE,
               os_version=None):
    """Encode int16/float PCM into a DCS stream.  Returns (bytes, n_frames).

    os_version selects the format family (refdec.decoder OS constants):
    OS94/OS95 (default) → the 1994+ codec with the type/subtype search;
    OS93A/OS93B → the 1993 codec (reference: formatVersion 0x9300/0x9301).
    """
    if params is None:
        params = CompressionParams()
    pcm_i16 = pcm_to_int16(pcm, sample_rate)
    # level convention matches the reference encoder: coefficients are the
    # plain analysis output (decoding at master volume 255 / mixing level
    # 0x64 then plays at ≈0.48× the source level, exactly as reference-
    # encoded streams do; see tests/test_encoder.py)
    from ..refdec.decoder import OS93A, OS93B
    if os_version in (OS93A, OS93B):
        from . import encoder93
        frames = frames_from_pcm(pcm_i16.astype(np.float32))
        coefs93 = analysis.analyze_frames93(frames)
        want_t = params.stream_format_type
        types = [0] if os_version == OS93A and want_t < 0 else \
            [t for t in (0, 1) if want_t < 0 or want_t == t]
        best = None
        for t in types:
            s = encoder93.encode_stream93(coefs93.astype(np.float64), t,
                                          params,
                                          os93a=(os_version == OS93A))
            if best is None or len(s) < len(best):
                best = s
        if best is None:
            raise ValueError(
                "No available stream format types match the requested "
                "encoding parameters")
        return best, frames.shape[0]
    if params.analysis_transform == "pinv":
        # production path: integer-canonical analysis (raw frames, window
        # folded into the quantized matrix) — bit-identical on host/device
        frames = frames_from_pcm_raw(pcm_i16)
        ci = analyze_frames_canonical(frames)
        return encode_frames(ci, params), frames.shape[0]
    # comparison transforms (the reference's second DFT algorithm +
    # cross-check, DCSEncoder.cpp:1019-1035) stay on the float path
    frames = frames_from_pcm(pcm_i16.astype(np.float32))
    coefs = analysis.analyze_frames(frames,
                                    algorithm=params.analysis_transform)
    stream = encode_frames(coefs.astype(np.float32), params)
    return stream, frames.shape[0]


def on_device(params: CompressionParams, os_version=None):
    """True where the device encoder serves these jobs: the 1994+ family
    (os_version None, OS94 or OS95) under the "pinv" analysis."""
    from ..refdec.decoder import OS93A, OS93B
    return (os_version not in (OS93A, OS93B)
            and params.analysis_transform == "pinv")


def encode_files(jobs, params: CompressionParams = None, os_version=None,
                 workers=None, device="cuda"):
    """Encode many PCM buffers.  The 1994+ family under the "pinv"
    analysis goes through the batched device encoder
    (``encode_files_device`` on ``device``: "cuda", the default, needs a
    card and raises without one; "cpu" runs its plain versions).  The
    families with no device path (1993, the comparison transforms) run
    ``encode_pcm`` in a process pool (data parallel over files; workers
    defaults to the CPU count).

    jobs: list of (pcm, sample_rate).  Returns list of (stream, n_frames)
    in order.
    """
    import concurrent.futures as cf
    import multiprocessing as _mp
    import os as _os
    if params is None:
        params = CompressionParams()
    if on_device(params, os_version):
        return encode_files_device(jobs, params, device=device)
    workers = workers or min(len(jobs), _os.cpu_count() or 1)
    if workers <= 1 or len(jobs) <= 1:
        return [encode_pcm(p, params, sample_rate=r, os_version=os_version)
                for (p, r) in jobs]
    # spawn, not fork: the parent may hold torch's thread pools, and
    # forking a multithreaded process can deadlock the children
    ctx = _mp.get_context("spawn")
    with cf.ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
        futs = [ex.submit(encode_pcm, p, params, r, os_version)
                for (p, r) in jobs]
        return [f.result() for f in futs]


def _decode_stream_pcm(stream, os_version):
    """Decode a raw stream through the scalar runtime at master volume 255 /
    mixing level 0x64 (the standalone nominal playback level)."""
    from ..refdec.decoder import ReferenceDecoder
    dec = ReferenceDecoder()
    dec.default_volume = 255
    dec.init_standalone(os_version)
    dec.soft_boot()
    dec.load_audio_stream(0, bytes(stream), mixing_level=0x64)
    nf = (stream[0] << 8) | stream[1]
    return np.array(dec.next_samples(nf * 240), dtype=np.float64)


_GAIN_CACHE = {}


def _playback_gain(os_version):
    """End-to-end gain of the scalar runtime at volume 255 / mixing 0x64
    (≈0.48; the encoder itself is level-transparent, so the composite
    encode→decode gain isolates the decode side).  Measured once per format
    family with a short sine and cached."""
    if os_version not in _GAIN_CACHE:
        t = np.arange(240 * 8, dtype=np.float64) / RATE
        src = (8000.0 * np.sin(2 * np.pi * 997.0 * t)).astype(np.float32)
        stream, nf = encode_pcm(src, CompressionParams(),
                                os_version=os_version)
        out = _decode_stream_pcm(stream, os_version)[:src.size]
        _GAIN_CACHE[os_version] = (
            float(np.dot(out, src)) / max(float(np.dot(src, src)), 1e-9))
    return _GAIN_CACHE[os_version]


def transcode_stream(stream, src_os, dst_os, params: CompressionParams = None):
    """Re-encode a raw DCS stream into another format family, keeping the
    playback level (counterpart of the reference's automatic re-encode of
    .dcs inputs whose format version mismatches the target ROM's,
    DCSEncoder.cpp:358-589 EncodeDCSFile).  Returns (stream, n_frames)."""
    if params is None:
        params = CompressionParams()
    pcm = _decode_stream_pcm(stream, src_os)
    g = _playback_gain(src_os)
    return encode_pcm((pcm / max(g, 1e-9)).astype(np.float32), params,
                      os_version=dst_os)
