"""Windowed-sinc sample-rate conversion to the DCS rate.

Counterpart of the reference's libsamplerate SINC_BEST usage
(DCSEncoder.cpp:165-185): a Kaiser-windowed sinc polyphase resampler,
implemented as a vectorized NumPy convolution-gather (no external deps).
"""

import numpy as np


def resample(x, rate_in, rate_out, taps_per_phase=32, beta=8.6):
    """Resample 1-D float signal from rate_in to rate_out."""
    x = np.asarray(x, dtype=np.float64)
    if rate_in == rate_out or x.size == 0:
        return x.astype(np.float32)
    ratio = rate_out / rate_in
    cutoff = min(1.0, ratio) * 0.97          # anti-alias below Nyquist
    half = taps_per_phase // 2

    n_out = int(np.floor(x.size * ratio))
    # output sample k maps to input position k/ratio
    pos = np.arange(n_out) / ratio
    base = np.floor(pos).astype(np.int64)
    frac = pos - base

    # tap offsets around the center
    k = np.arange(-half + 1, half + 1)       # [T]
    t = k[None, :] - frac[:, None]           # [n_out, T]
    sinc = np.sinc(cutoff * t) * cutoff
    win = np.kaiser(2 * half * 8 + 1, beta)
    # map |t| in [0, half] onto the window
    wi = np.clip(((t + half) / (2 * half) * (win.size - 1)).astype(np.int64),
                 0, win.size - 1)
    kernel = sinc * win[wi]
    kernel /= kernel.sum(axis=1, keepdims=True)

    xp = np.pad(x, (half, half + 2))
    idx = base[:, None] + (k[None, :] + half)
    out = (xp[idx] * kernel).sum(axis=1)
    return out.astype(np.float32)
