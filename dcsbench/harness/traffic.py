"""The benchmark's one traffic generator: a traffic file's parameters and a
configuration's data, drawn from a seed.

Every seed gives the same work: the same streams, the same session shapes
and the same multiset of tracks, in another order and at other levels.
``numpy.random.default_rng`` takes any seed up to 2**63 and beyond.

Two kinds of traffic (the file's ``kind``):

- ``catalog``: ``variants`` packings of each catalog sweep of the
  configuration.  A variant is the sweep's streams in a seeded order, at a
  mixing level and a master volume drawn from the file's ranges.
- ``sessions``: ``batches`` batches of ``sessions`` sessions of ``frames``
  frames.  In start pattern k, voice v starts a track of the
  configuration's ``voice_tracks[v]`` at frame ``(k * 7 + v * 3) % 40``
  and again every ``interval`` frames; each batch gives its sessions the
  patterns 0..sessions-1 in a seeded order, and deals each voice's tracks
  out in turn (equally often where they divide the starts) in a seeded
  order.  Frame 0 also sets the master volume (``55 AA vol ~vol``), drawn
  from the file's range.
"""

import numpy as np


def rng(seed, *path):
    """A generator for one part of a run, independent of the others."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), *path])


def catalog_variants(sweeps, traffic, seed):
    """[sweep][variant] = dict(order: stream names, mixing_level,
    master_volume) for the configuration's catalog sweeps (each a list of
    [name, copies])."""
    lo_m, hi_m = traffic["mixing_level"]
    lo_v, hi_v = traffic["master_volume"]
    out = []
    for k, sweep in enumerate(sweeps):
        names = [n for n, copies in sweep["streams"] for _ in range(copies)]
        vs = []
        for v in range(traffic["variants"]):
            g = rng(seed, 1, k, v)
            vs.append(dict(order=[names[i] for i in g.permutation(len(names))],
                           mixing_level=int(g.integers(lo_m, hi_m + 1)),
                           master_volume=int(g.integers(lo_v, hi_v + 1))))
        out.append(vs)
    return out


def session_starts(k, v, traffic):
    """The frames at which voice v starts a track in start pattern k."""
    first = (k * 7 + v * 3) % 40
    return list(range(first, traffic["frames"], traffic["interval"]))


def session_batch(voice_tracks, traffic, seed, b):
    """Batch b: one {frame: [port bytes]} dict per session."""
    S = traffic["sessions"]
    lo_v, hi_v = traffic["master_volume"]
    g = rng(seed, 2, b)
    pattern = g.permutation(S)
    events = [dict() for _ in range(S)]
    for v, tracks in enumerate(voice_tracks[:traffic["voices"]]):
        slots = [(s, f) for s in range(S)
                 for f in session_starts(int(pattern[s]), v, traffic)]
        deal = np.resize(np.asarray(tracks), len(slots))
        for (s, f), t in zip(slots, g.permutation(deal)):
            events[s].setdefault(f, []).extend([int(t) >> 8, int(t) & 0xFF])
    for s in range(S):
        vol = int(g.integers(lo_v, hi_v + 1))
        events[s].setdefault(0, [])[:0] = [0x55, 0xAA, vol, vol ^ 0xFF]
    return events


def sample_sessions(traffic, seed):
    """The sessions the reference checks: ``check_sessions`` (batch,
    session) pairs, spread over the batches and drawn from the seed."""
    g = rng(seed, 3)
    B, S = traffic["batches"], traffic["sessions"]
    n = traffic["check_sessions"]
    return sorted({(i % B, int(g.integers(S))) for i in range(n)})
