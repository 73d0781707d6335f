"""DCS stream encoder of the 1994+ format family: PCM in, streams out, with
the format search on the device.

A copy of what the device path needs from the JAX package's
``encoder/encoder.py``: ``CompressionParams``, the complementary edge window,
the integer-canonical analysis matrix and its host evaluation, the PCM
canonicalization, and ``encode_files_device``.  PCM → int16 at 31,250 Hz →
raw 256-sample frames (stride 240, 16-sample overlap) → integer analysis
coefficients → per-stream setup → the device's format search
(``device94.py``) → the host's emission of the winner.
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
    # forward transform of the JAX package's host encoder ("pinv",
    # "butterfly" or "dual"); the device path always runs the integer-
    # canonical analysis of forward_matrix_q
    analysis_transform: str = "pinv"


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
                        device="cuda"):
    """Encode many PCM buffers through the batched device encoder: the
    host canonicalizes PCM to int16, computes its own coefficients (for the
    emission) and each stream's setup; the device re-derives the same
    coefficients from the raw PCM and runs the whole format search
    (device94.DeviceEncoder94); the host emits each winner.  Byte-identical
    to the host encoder for every input.

    jobs: list of (pcm, sample_rate).  Returns list of (stream, n_frames).
    device "cuda" (the default) needs a card and raises without one;
    "cpu" runs the plain PyTorch versions."""
    from . import device94
    if params is None:
        params = CompressionParams()
    return device94.encode_jobs_pcm(jobs, params, device=device)
