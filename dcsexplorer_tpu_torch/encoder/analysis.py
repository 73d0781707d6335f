"""Encoder analysis transform of the 1994+ family: the forward counterpart
of the decoder's inverse transform (a copy of the 1994+ half of the JAX
package's ``encoder/analysis.py``, read from the port's own tables).

The decoder's inverse transform, idealized in float64 without rounding or
saturation, is a linear map D from frame-buffer coefficients to the 256
time-domain samples.  The encoder's analysis is its least-squares inverse,
precomputed once as a 256x255 matrix (``forward_matrix``), so analyzing a
stream's frames is one batched matrix product.

Coefficient-space convention (the decoder's first-sample fixup,
DCSDecoderNative.cpp:2254-2257): slot 1 is forced to zero by the decoder and
the value *transmitted* at slot 1 lands in slot 0, so the transmit vector has
255 live dimensions: [slot0, slot2, slot3, ..., slot255].
"""

import numpy as np

from ..format import tables as T

_BR = np.asarray(T.BITREV9)
_IFFT = np.asarray(T.IFFT_COEFF)


def _s16f(x):
    return np.where(x >= 0x8000, x - 0x10000, x).astype(np.float64)


def _float_transform94(fb):
    """Float-idealized decoder transform: fb [B, 512] (float, 1.15 domain
    ±32768) → time samples [B, 256] in natural order (outputs 0..239 then the
    16 overlap-tail samples).  Mirrors ops/transform.transform94_raw without
    rounding, saturation, or volume shift."""
    fb = fb.astype(np.float64).copy()
    B = fb.shape[0]
    sin = _s16f(_IFFT[:128])
    cos = _s16f(_IFFT[128:])

    fb[:, 0x80] = -fb[:, 0x80]
    fb[:, 0x81] = fb[:, 0x81]      # mulss(-x, 0x8000) = x

    idx_x = np.arange(0, 128)
    idx_y = np.empty(128, dtype=np.int64)
    for i in range(64):
        idx_y[2 * i] = 0x100 - 2 * i
        idx_y[2 * i + 1] = 0x101 - 2 * i

    x = fb[:, idx_x]
    y = fb[:, idx_y]
    x0, x1 = x[:, 0::2], x[:, 1::2]
    y0, y1 = y[:, 0::2], y[:, 1::2]
    n_x0, n_y0 = -(x0 + y0), -(x0 - y0)
    n_x1, n_y1 = -(x1 - y1), -(x1 + y1)
    fb[:, idx_x[0::2]], fb[:, idx_x[1::2]] = n_x0, n_x1
    fb[:, idx_y[0::2]], fb[:, idx_y[1::2]] = n_y0, n_y1

    c0 = _s16f(_IFFT[_BR[2 + 4 * np.arange(64)]]) / 32768.0
    c1 = _s16f(_IFFT[_BR[4 * np.arange(64)]]) / 32768.0
    x = fb[:, idx_x]
    y = fb[:, idx_y]
    x0, x1 = x[:, 0::2], x[:, 1::2]
    yn0, yn1 = y[:, 0::2], y[:, 1::2]
    prod0 = yn1 * c1 - yn0 * c0
    prod1 = yn1 * c0 + yn0 * c1
    fb[:, idx_x[0::2]] = prod1 + x0
    fb[:, idx_x[1::2]] = prod0 + x1
    fb[:, idx_y[0::2]] = x0 - prod1
    fb[:, idx_y[1::2]] = prod0 - x1

    xx = fb[:, 0:128].copy()
    yy = fb[:, 128:256].copy()
    fb[:, 0:128] = xx + yy
    fb[:, 128:256] = xx - yy

    core = fb[:, :256]
    n_part, part = 2, 0x40
    for _ in range(6):
        v = core.reshape(B, n_part, 2, part)
        u, a = v[:, :, 0, :].copy(), v[:, :, 1, :]
        ap = a.reshape(B, n_part, part // 2, 2)
        a_re, a_im = ap[..., 0], ap[..., 1]
        cc = (cos[:n_part] / 32768.0).reshape(1, n_part, 1)
        cs = (sin[:n_part] / 32768.0).reshape(1, n_part, 1)
        t_re = a_re * cc - a_im * cs
        t_im = a_im * cc + a_re * cs
        up = u.reshape(B, n_part, part // 2, 2)
        u_re, u_im = up[..., 0], up[..., 1]
        nu = np.stack([u_re - t_re, u_im - t_im], axis=-1)
        na = np.stack([u_re + t_re, u_im + t_im], axis=-1)
        core = np.stack([nu.reshape(B, n_part, part),
                         na.reshape(B, n_part, part)], axis=2).reshape(B, 256)
        n_part *= 2
        part //= 2

    # natural-order extraction (outputs 0..239, then overlap tail 240..255)
    ext = np.empty(256, dtype=np.int64)
    for i in range(0, 256, 2):
        ext[i] = _BR[i]
        ext[i + 1] = _BR[i] + 1
    return core[:, ext]


# frame-buffer slots that carry transmitted coefficients (slot 1's payload
# lands in slot 0 via the fixup; slot 1 itself is always zero)
LIVE_SLOTS = np.array([0] + list(range(2, 256)), dtype=np.int64)   # 255 dims


def _build_matrices():
    basis = np.zeros((255, 512))
    for k, s in enumerate(LIVE_SLOTS):
        basis[k, s] = 32768.0
    D = _float_transform94(basis) / 32768.0      # [255 coef dims, 256 time]
    F = np.linalg.pinv(D)                        # [256 time, 255 coef]
    return D.astype(np.float32), F.astype(np.float32)


_D, _F = None, None


def decoder_matrix():
    global _D, _F
    if _D is None:
        _D, _F = _build_matrices()
    return _D


def forward_matrix():
    """[256 time, 255 coef] analysis matrix: coef = time @ F."""
    global _D, _F
    if _F is None:
        _D, _F = _build_matrices()
    return _F

