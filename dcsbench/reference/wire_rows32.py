"""The wide session control wire, read back: the benchmark's frozen reader of
the port's wire for a bank of 64Ki rows or more, plain PyTorch.  The
reference expands the program's wire with it to hold the traced mixing
multipliers and volume shifts against its own VM trace.

Wire layout: slope [S, C, E] u8, vol [S, T] u8, then f0 [S, C, E] as
little-endian u16, base [S, C, E] as little-endian u32 and mixv [S, C, E]
as little-endian u16.  In each (session, channel) lane the segment at
frame t is ``count(f0 <= t) - 1`` and plays row ``base + slope * (t - f0)``
at multiplier ``mixv``.
"""

import torch


def expand(buf, S, T, C, E):
    """A wire (uint8 tensor) -> (rows, mix [S, T, C], vol [S, T]), int64."""
    n_par = S * C * E
    buf = buf.long()
    slope = buf[:n_par].reshape(S, C, E)
    vol = buf[n_par:n_par + S * T].reshape(S, T)
    o = n_par + S * T

    def little_endian(n, width):
        w = buf[n:n + width * n_par].reshape(-1, width)
        shifts = 8 * torch.arange(width, device=buf.device)
        return (w << shifts).sum(1).reshape(S, C, E)

    f0 = little_endian(o, 2)
    base = little_endian(o + 2 * n_par, 4)
    mixv = little_endian(o + 6 * n_par, 2)
    t = torch.arange(T, device=buf.device)
    le = f0[:, :, None, :] <= t[None, None, :, None]            # [S,C,T,E]
    e = (le.sum(-1) - 1).clamp(min=0)                           # [S,C,T]

    def pick(p):
        return torch.gather(p, 2, e).transpose(1, 2)            # [S,T,C]

    rows = pick(base) + pick(slope) * (t[None, :, None] - pick(f0))
    return rows, pick(mixv), vol
