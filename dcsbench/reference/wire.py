"""The session control wire, read back: the benchmark's frozen copy of the
port's ``unpack_controls_wire`` and ``reconstruct_from_segments``, plain
PyTorch.  The reference expands the program's wire with it to hold the
traced mixing multipliers and volume shifts against its own VM trace.

Wire layout: slope [S, C, E] u8, vol [S, T] u8, then f0, base and mixv
[S, C, E] as little-endian u16.  In each (session, channel) lane the
segment at frame t is ``count(f0 <= t) - 1`` and plays row
``base + slope * (t - f0)`` at multiplier ``mixv``.
"""

import torch


def expand(buf, S, T, C, E):
    """A wire (uint8 tensor) -> (rows, mix [S, T, C], vol [S, T]), int64."""
    n_par = S * C * E
    buf = buf.long()
    slope = buf[:n_par].reshape(S, C, E)
    vol = buf[n_par:n_par + S * T].reshape(S, T)
    o = n_par + S * T

    def u16(n):
        w = buf[n:n + 2 * n_par].reshape(-1, 2)
        return (w[:, 0] | (w[:, 1] << 8)).reshape(S, C, E)

    f0, base, mixv = u16(o), u16(o + 2 * n_par), u16(o + 4 * n_par)
    t = torch.arange(T, device=buf.device)
    le = f0[:, :, None, :] <= t[None, None, :, None]            # [S,C,T,E]
    e = (le.sum(-1) - 1).clamp(min=0)                           # [S,C,T]

    def pick(p):
        return torch.gather(p, 2, e).transpose(1, 2)            # [S,T,C]

    rows = pick(base) + pick(slope) * (t[None, :, None] - pick(f0))
    return rows, pick(mixv), vol
