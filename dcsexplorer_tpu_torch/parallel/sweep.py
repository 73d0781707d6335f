"""Multi-device sharding of the port's device paths: one process drives a
mesh of torch devices, and every sharded result equals the single-device
result bit for bit.

Counterpart of ``dcsexplorer_tpu/parallel/sweep.py``.  There a ``Mesh``
lays the shards over the devices and XLA inserts the collectives; here a
mesh is a list of ``torch.device`` (``make_flat_mesh``), or a list of
rows of them (``make_mesh``: tracks x frames), and this module splits,
adds the halo and gathers itself:

- ``sharded_flat_sweep``: the flat 1994+ sweep (FlatSweep's compact
  columns) in contiguous shards of the frame axis, one FlatPipeline a
  distinct device.  The byte pool and the per-stream tables are
  replicated and sid keeps its global values.  A shard of rows [s, e)
  decodes rows [s - 2, e) and drops the first: the kernel derives a row's
  band_type_prev from the row before it, so row s - 2 gives row s - 1 its
  band types, and row s - 1, decoded exactly, gives row s its overlap
  carry (its tail depends on that frame alone).
- ``sharded_sweep``: the padded [streams, frames] model
  (``models/batched.py``) over tracks x frames.  It passes band_type_prev
  explicitly, so a frame shard [j0, j1) decodes [j0 - 1, j1) for the carry
  alone.
- ``sharded_sessions``: independent sessions against one stream bank, in
  contiguous groups of sessions, each from silence and a zero overlap
  state.

No shard waits on another.  On the card each shard uploads its rows and
runs its kernels on a stream of its own: a side stream for each entry of a
device the mesh names more than once (``["cuda:0"] * 4`` runs the real
split, halo and gather on one card), the device's current stream for a
device it names once.  The shards' streams start after the work enqueued
before the call; the gather, on mesh[0]'s current stream, waits on each
shard's event, and a copy from another device runs on that shard's stream.
The entry points run on the card unless the caller names other devices.
"""

import collections
import functools
import weakref

import numpy as np
import torch

from ..models import batched, pipeline
from ..models.flatsweep import FlatPipeline, _device

FLAT_HALO = 2          # rows a flat shard decodes before its first
FRAME_HALO = 1         # frames a shard of the padded model decodes before

_REPLICATED = ("pool_u8", "hdr_tab", "fmt_tab", "sub_tab")
_ROWS = ("sid", "start_bit", "bt_u8", "mix_u16", "vol_u8")


def make_flat_mesh(devices=None):
    """1-D mesh over the flat frame axis: a list of torch.device.  By
    default every visible card; without one, that raises.  A device may
    repeat: ``["cuda:0"] * 4`` and ``["cpu"] * 8`` are meshes."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices, e.g. "
                               "['cpu'] * 8, to run on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = []
    for d in devices:
        dev = _device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        mesh.append(dev)
    if not mesh:
        raise ValueError("a mesh of no device")
    return mesh


def make_mesh(devices=None, frame_shards=1):
    """Mesh over (tracks, frames): rows of frame_shards devices each;
    frame_shards divides the device count."""
    flat = make_flat_mesh(devices)
    if frame_shards < 1 or len(flat) % frame_shards:
        raise ValueError(f"{frame_shards} frame shards do not divide "
                         f"{len(flat)} devices")
    return [flat[i:i + frame_shards]
            for i in range(0, len(flat), frame_shards)]


def split(n, k):
    """k contiguous, near-equal parts [(start, end)] of range(n); some are
    empty when n < k."""
    return [(n * i // k, n * (i + 1) // k) for i in range(k)]


def _put(a, dev):
    """A numpy column or a tensor -> a tensor on ``dev`` for use on its
    current stream, enqueued without blocking the host (numpy by
    batched.upload).  A tensor already there is marked as used on that
    stream."""
    t = (a.to(dev, non_blocking=True) if isinstance(a, torch.Tensor)
         else batched.upload(a, dev))
    if t.is_cuda:
        t.record_stream(torch.cuda.current_stream(dev))
    return t


@functools.lru_cache(maxsize=None)
def _side_stream(dev, k):
    """The k-th side stream of a device, made once: the caching allocator
    keeps blocks a stream, so a shard's stream is the same call after
    call."""
    return torch.cuda.Stream(dev)


def _streams(mesh):
    """Each mesh entry's stream: a side stream where the mesh repeats the
    device (the first, second, ... of that device), its current stream
    where it names the device once; None on the CPU."""
    count, seen = collections.Counter(mesh), collections.Counter()
    out = []
    for d in mesh:
        if d.type != "cuda":
            out.append(None)
        elif count[d] > 1:
            out.append(_side_stream(d, seen[d]))
            seen[d] += 1
        else:
            out.append(torch.cuda.current_stream(d))
    return out


def _run(mesh, parts, out):
    """Run each part on its mesh entry and gather the results into out.

    parts: [(k, dst, fn)]: fn() computes on mesh[k] with that entry's
    stream current and returns the tensor that out[dst] takes."""
    streams = _streams(mesh)
    done = []
    for k, dst, fn in parts:
        dev, stream = mesh[k], streams[k]
        if stream is None:
            done.append((dev, None, None, dst, fn()))
            continue
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            res = fn()
            ev = torch.cuda.Event()
            ev.record(stream)
        done.append((dev, stream, ev, dst, res))
    gather = torch.cuda.current_stream(out.device) if out.is_cuda else None
    for dev, stream, ev, dst, res in done:
        if stream is None:
            out[dst] = res
            continue
        if gather is not None:
            gather.wait_event(ev)
        if dev == out.device:
            out[dst] = res
            res.record_stream(gather)
        else:
            with torch.cuda.stream(stream):
                out[dst].copy_(res, non_blocking=True)
    return out


@functools.lru_cache(maxsize=None)
def _flat_pipeline(dev):
    return FlatPipeline(dev)


def sharded_flat_sweep(mesh, arrays):
    """The flat sweep sharded over the flat frame axis of a 1-D mesh.

    arrays: FlatSweep.compact_host_arrays() (numpy).  Returns pcm [N, 240]
    int32 (u16 storage) on mesh[0], bit-identical to FlatPipeline on one
    device."""
    mesh = make_flat_mesh(mesh)
    n_steps = int(arrays["n_steps"])
    N = len(arrays["sid"])
    out = torch.empty((N, 240), dtype=torch.int32, device=mesh[0])
    repl = {dev: {k: _put(arrays[k], dev) for k in _REPLICATED}
            for dev in dict.fromkeys(mesh)}
    parts = []
    for k, (s, e) in enumerate(split(N, len(mesh))):
        if s == e:
            continue
        lo = max(0, s - FLAT_HALO)

        def run(dev=mesh[k], s=s, e=e, lo=lo):
            cols = {c: _put(t, dev) for c, t in repl[dev].items()}
            cols.update({c: _put(arrays[c][lo:e], dev) for c in _ROWS})
            return _flat_pipeline(dev)(**cols, n_steps=n_steps)[s - lo:]
        parts.append((k, slice(s, e), run))
    return _run(mesh, parts, out)


def sharded_sweep(mesh, inputs):
    """The padded model over a 2-D mesh (make_mesh): streams shard over
    its rows (tracks), frames over its columns (frames).

    inputs: a models.batched.SweepInputs.  Returns pcm [S, F, 240] int32
    (u16 storage) on mesh[0][0], bit-identical to batch_decode on one
    device."""
    a = inputs
    mesh = [make_flat_mesh(row) for row in mesh]
    batched.check_band_types(a.band_type, a.band_type_prev)
    # bytes and band types travel as uint8, a quarter of SweepInputs's
    # int32: every frame shard of a track uploads its streams' bytes
    sb_u8, bt_u8, btp_u8 = (x.astype(np.uint8) for x in (
        a.stream_bytes, a.band_type, a.band_type_prev))
    S, F = a.rel_start.shape
    flat = [d for row in mesh for d in row]
    out = torch.empty((S, F, 240), dtype=torch.int32, device=flat[0])
    parts = []
    for t, (s0, s1) in enumerate(split(S, len(mesh))):
        for f, (j0, j1) in enumerate(split(F, len(mesh[t]))):
            if s0 == s1 or j0 == j1:
                continue
            lo = max(0, j0 - FRAME_HALO)
            dev = mesh[t][f]

            def run(dev=dev, s0=s0, s1=s1, j0=j0, j1=j1, lo=lo):
                win = lambda x: _put(x[s0:s1, lo:j1], dev)
                pcm = batched.padded_pcm(
                    _put(sb_u8[s0:s1], dev), win(a.rel_start),
                    _put(a.headers[s0:s1], dev), a.fmt_type, a.sub_type,
                    win(bt_u8), win(btp_u8), win(a.mix), win(a.vol_shift),
                    a.n_steps)
                return pcm.reshape(s1 - s0, j1 - lo, 240)[:, j0 - lo:]
            parts.append((t * len(mesh[t]) + f,
                          (slice(s0, s1), slice(j0, j1)), run))
    return _run(flat, parts, out)


# one session decoder a (bank, device), kept while the bank lives, beside
# weak references to the bank tensors it was built from
_DECODERS = weakref.WeakKeyDictionary()


def _session_decoder(bank, dev):
    """The cached session decoder of the bank on dev.  A decoder copies the
    bank's rows (``scaled``, or the 1993 ``bank93``) when it is built, and a
    bank grows (``add``, then ``decode_all`` anew, which replaces them): a
    decoder built from other tensors than the bank's current ones is built
    again.  The cache holds those tensors weakly, so a replaced bank is
    not kept alive by it."""
    now = list(bank.bank93.values()) if bank.family93 else [bank.scaled]
    per_device = _DECODERS.setdefault(bank, {})
    built = per_device.get(dev)
    if built is None or len(built[0]) != len(now) or any(
            ref() is not t for ref, t in zip(built[0], now)):
        built = per_device[dev] = ([weakref.ref(t) for t in now],
                                   pipeline.session_decoder(bank, dev))
    return built[1]


def sharded_sessions(mesh, bank, rows, mix, vol_shift):
    """A batch of sessions, data-parallel over a 1-D mesh: contiguous
    groups of sessions, each group on one device against the bank
    replicated there (one session decoder a distinct device, of the bank's
    family).  rows/mix [B, T, C] and vol_shift [B, T], numpy or tensors.
    Each session starts from silence and a zero overlap state.  Returns pcm
    [B, T, 240] int32 (u16 storage) on mesh[0], bit-identical to each
    session decoded alone."""
    mesh = make_flat_mesh(mesh)
    as_i32 = lambda x: (x.int() if isinstance(x, torch.Tensor)
                        else np.asarray(x, np.int32))
    rows, mix, vol_shift = as_i32(rows), as_i32(mix), as_i32(vol_shift)
    B, T, C = rows.shape
    out = torch.empty((B, T, 240), dtype=torch.int32, device=mesh[0])
    decoders = {dev: _session_decoder(bank, dev)
                for dev in dict.fromkeys(mesh)}
    parts = []
    for k, (b0, b1) in enumerate(split(B, len(mesh))):
        if b0 == b1 or T == 0:
            continue

        def run(dev=mesh[k], b0=b0, b1=b1):
            G = b1 - b0
            sid = torch.arange(G, dtype=torch.int32,
                               device=dev).repeat_interleave(T)
            pcm = decoders[dev](_put(rows[b0:b1], dev).reshape(G * T, C),
                                _put(mix[b0:b1], dev).reshape(G * T, C),
                                _put(vol_shift[b0:b1], dev).reshape(G * T),
                                sid)
            return pcm.reshape(G, T, 240)
        parts.append((k, slice(b0, b1), run))
    return _run(mesh, parts, out)
