"""The digest a job fetches instead of its PCM, and its reference twin.

A frame's 240 words (int32, u16 storage) are read as 960 bytes (int8), and
each byte is weighed by its position in the frame: eight sums, each with
its own odd weight in -127..127 for every byte position (``BYTE_W``), taken
exactly in int32 (at most 960 * 128 * 127 in size).  The frame's hash h is
those eight sums times eight odd 64-bit constants (``COL_M``), added in
int64.  A stream's (or a session's) digest is the pair (sum of h, sum of
h * (f + 1)) over its frames f.  Every int64 product and sum wraps modulo
2**64 (two's complement: the card's and numpy's wrap alike).  So a changed
word, words moved inside a frame (a wrong extraction order), a lost frame
or two frames swapped all show.  On the card the byte sums are one int8
matrix product (``torch._int_mm``), which reads the PCM once: 0.39 ms for
600,192 frames on an H100 80GB HBM3, where a plain sum of the words, blind
to their order inside a frame, took 0.27 ms.
"""

import numpy as np
import torch

FRAME_BYTES = 240 * 4
_G = np.random.default_rng(0xDC5)
BYTE_W = (_G.integers(-64, 64, (FRAME_BYTES, 8)) * 2 + 1).astype(np.int8)
COL_M = (_G.integers(1 << 40, 1 << 62, 8) | 1).astype(np.int64)
_ON = {}


def _weights(device):
    """(BYTE_W column-major, COL_M) on ``device``, made once."""
    key = str(device)
    if key not in _ON:
        w = torch.from_numpy(BYTE_W).to(device)
        _ON[key] = (w.t().contiguous().t(),
                    torch.from_numpy(COL_M).to(device))
    return _ON[key]


def frame_hash(words):
    """[..., 240] int32 words -> [...] int64 hashes."""
    shape = words.shape[:-1]
    b = words.contiguous().view(torch.int8).reshape(-1, FRAME_BYTES)
    w, m = _weights(words.device)
    cols = torch._int_mm(b, w)      # on the card: more than 16 frames
    return (cols.long() * m).sum(-1).reshape(shape)


def weights(pos1):
    """[N, 2] int64 (1, frame number from 1) of frames numbered pos1."""
    pos1 = torch.as_tensor(pos1, dtype=torch.int64)
    return torch.stack([torch.ones_like(pos1), pos1], 1)


def stream_ends(counts):
    """(pos1 [N], lo [2S], hi [2S]) int64 of streams of ``counts`` frames
    laid end to end: each frame's number in its stream, and the prefix-sum
    positions ``stream_digests`` reads for each stream's two sums."""
    counts = np.asarray(counts, np.int64)
    ends = np.cumsum(counts)
    N = int(ends[-1])
    pos1 = np.arange(N) - np.repeat(ends - counts, counts) + 1
    lo = np.concatenate([ends - counts, N + ends - counts])
    hi = np.concatenate([ends, N + ends])
    return tuple(torch.tensor(a) for a in (pos1, lo, hi))


def stream_digests(words, pos1, lo, hi):
    """Per-stream digests [S, 2] int64 of flat frames, each stream's frames
    contiguous: words [N, 240] and ``stream_ends``'s pos1, lo, hi.  One
    prefix sum over (0, h, h * pos1) laid end to end, read at the streams'
    bounds: no atomics (an index_add over 288 streams took as long as the
    sweep's transform) and a one-dimensional scan (a scan down the first
    axis of an [N, 2] tensor took ~50 ms a job)."""
    h = frame_hash(words)
    c = torch.cat([h.new_zeros(1), h, h * pos1]).cumsum(0)
    return (c[hi] - c[lo]).reshape(2, -1).T


def session_digests(words, w):
    """Per-session digests [S, 2] int64 of words [S, T * 240]; w [T, 2]
    (``weights`` of 1..T)."""
    h = frame_hash(words.reshape(words.shape[0], -1, 240))
    return (h[:, :, None] * w).sum(1)


def frame_hash_np(pcm):
    """[F] int64 hashes of PCM words [F, 240] (numpy), as the card's."""
    pcm = np.ascontiguousarray(np.asarray(pcm, np.int32))
    cols = pcm.view(np.int8).reshape(-1, FRAME_BYTES).astype(np.int64) \
        @ BYTE_W.astype(np.int64)
    with np.errstate(over="ignore"):
        return (cols * COL_M).sum(-1)


def digest_np(pcm):
    """The digest (2,) int64 of one stream's or session's PCM words
    [F, 240] (numpy), as the card computes it."""
    h = frame_hash_np(pcm)
    with np.errstate(over="ignore"):
        return np.array([h.sum(), (h * np.arange(1, len(h) + 1)).sum()],
                        np.int64)
