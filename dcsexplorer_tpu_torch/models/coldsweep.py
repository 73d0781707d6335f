"""Cold catalog sweeps in PyTorch + CUDA: from stream bytes to one PCM
checksum, with nothing of the host's pack cached between calls.

Counterpart of ``bench.py``'s flat94_e2e and catalog_e2e (bench.py:207-417),
as a library module:

- ``concat_chunks``: several packed 1994+ chunks as one FlatPipeline input
  (bench.py:239-259's in-program concatenation);
- ``cold_flat94``: a 1994+ catalog in chunks; chunk k uploads while the host
  packs chunk k+1, then one FlatPipeline pass over all chunks and one
  checksum fetch;
- ``cold_catalog``: a mixed 94 + 93b + 93a-Type-1 catalog, one family after
  another; each family's decode is queued behind its upload, so it runs
  while the host packs the next family; three checksum fetches at the end.

Per call the host runs the native indexer and VM trace of every stream and
packs the columns (``FlatSweep``, ``Flat93Sweep``); the 1993 families' bank
columns are built on the host too (``columns93``).  What a caller builds
once, as the JAX program is compiled once, is a ``ColdDevice``: the two
pipelines with their codec tables, and on the card the side stream of the
uploads.

Upload on the card: each column is staged into a pinned buffer of
PyTorch's caching host allocator, which hands a buffer out again only once
the event of its last copy has completed, and copied on the side stream.
The device tensors are allocated on that stream and marked for the compute
stream (``record_stream``), and the compute stream waits on the copy's
event before it reads them.  uint16 columns travel as their int16 bit
pattern and widen on the card (``& 0xFFFF``: ``.int()`` alone would
sign-extend them).

Each host stage runs in a span (``utils.profiling.span``):
``dcs.cold.pack``, ``.upload``, ``.dispatch``, ``.fetch``.  The entry
points run on the card unless the caller names another device; on the CPU
the plain versions run and every time is the host's.
"""

import time

import numpy as np
import torch

from ..utils.profiling import span
from . import catalogsweep as cs
from . import flatsweep as fs

# numpy dtypes of the wire -> their torch dtypes (uint16 goes as int16)
_TORCH_DTYPE = {np.dtype(np.uint8): torch.uint8,
                np.dtype(np.int16): torch.int16,
                np.dtype(np.int32): torch.int32}


def _wire(a):
    """A host column as it travels: uint16 as its int16 bit pattern."""
    a = np.asarray(a)
    return np.ascontiguousarray(a.view(np.int16) if a.dtype == np.uint16
                                else a)


class ColdDevice:
    """What the cold sweeps build once, outside their loop: FlatPipeline
    and Flat93Pipeline on ``device`` (the card unless given), and on the
    card the side stream of the uploads."""

    def __init__(self, device="cuda"):
        self.device = fs._device(device)
        self.pipe94 = fs.FlatPipeline(self.device)
        self.pipe93 = cs.Flat93Pipeline(self.device)
        self.copy_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)

    def mark(self):
        """A point in time: an event on the current stream on the card, the
        host's clock on the CPU."""
        if self.copy_stream is None:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    @staticmethod
    def ms(a, b):
        """The ms between two marks (events: once both have completed)."""
        if isinstance(a, float):
            return (b - a) * 1e3
        return a.elapsed_time(b)

    def upload(self, arrays):
        """numpy columns -> (tensors on the device, (start, end) marks of
        the copies).  On the card the copies run on the side stream; wait()
        makes the compute stream wait for them."""
        if self.copy_stream is None:
            t0 = self.mark()
            out = {k: torch.tensor(_wire(v)) for k, v in arrays.items()}
            return out, (t0, self.mark())
        staged = {}
        for k, v in arrays.items():
            v = _wire(v)
            staged[k] = torch.empty(v.shape, dtype=_TORCH_DTYPE[v.dtype],
                                    pin_memory=True)
            staged[k].numpy()[...] = v
        # the copies back to back, so the marks hold them and not the
        # host's staging
        compute = torch.cuda.current_stream(self.device)
        out = {}
        with torch.cuda.stream(self.copy_stream):
            start = self.mark()
            for k, t in staged.items():
                out[k] = t.to(self.device, non_blocking=True)
                out[k].record_stream(compute)
            end = self.mark()
        return out, (start, end)

    def wait(self, marks):
        """Make the compute stream wait for an upload's copies."""
        if self.copy_stream is not None:
            torch.cuda.current_stream(self.device).wait_event(marks[1])


def _widen94(cols, n_steps):
    """An uploaded 1994+ chunk -> FlatPipeline keyword arguments: sid and
    mix widen from their int16 bit pattern to int32."""
    out = dict(cols, n_steps=n_steps)
    for k in ("sid", "mix_u16"):
        out[k] = cols[k].int() & 0xFFFF
    return out


def concat_chunks(chunks):
    """FlatPipeline keyword arguments of several chunks (packed_to_device's
    form, each chunk packed on its own) -> those of the whole catalog: the
    pools concatenate, sid is offset by the streams of the chunks before,
    start_bit by 8 x their pool bytes, the per-stream tables concatenate
    along streams, and n_steps is the largest.  A chunk's pool ends in $FF
    padding, so no walk reads into the next chunk's bytes."""
    sids, bits = [], []
    streams = pool_bytes = 0
    for a in chunks:
        sids.append(a["sid"] + streams)
        bits.append(a["start_bit"] + 8 * pool_bytes)
        streams += a["hdr_tab"].shape[0]
        pool_bytes += a["pool_u8"].shape[0]
    cat = lambda k: torch.cat([a[k] for a in chunks])
    return dict(pool_u8=cat("pool_u8"), sid=torch.cat(sids),
                start_bit=torch.cat(bits), bt_u8=cat("bt_u8"),
                mix_u16=cat("mix_u16"), vol_u8=cat("vol_u8"),
                hdr_tab=cat("hdr_tab"), fmt_tab=cat("fmt_tab"),
                sub_tab=cat("sub_tab"),
                n_steps=max(a["n_steps"] for a in chunks))


def split_copies(streams, copies, n_chunks):
    """bench.py's chunks (:232-237): ``copies`` copies of ``streams`` in
    ``n_chunks`` chunks of ``copies // n_chunks`` copies, the last taking
    the rest."""
    n_chunks = min(n_chunks, copies)
    per = copies // n_chunks
    return ([streams * per] * (n_chunks - 1)
            + [streams * (copies - per * (n_chunks - 1))])


def cold_flat94(streams, copies, n_chunks, device="cuda"):
    """One cold sweep of ``copies`` copies of the 1994+ ``streams`` in
    ``n_chunks`` chunks (split_copies): pack each chunk (native index +
    trace + pack) while the one before uploads, then one FlatPipeline pass
    over the concatenated chunks and one checksum fetch.

    ``device``: a device name (the card unless given), or a ColdDevice
    built once for repeated calls.  Returns a dict: checksum (int, as
    cs.checksum), audio_samples, pcm (the device's [N, 240] words), chunks
    (per chunk: pack_ms, the host's pack; enqueue_ms, the host's staging
    and enqueue of the upload; upload_ms, the copies on the copy stream's
    clock), and, once for all chunks (one dispatch, one fetch, as
    bench.py), device_ms on the compute stream's clock and fetch_ms."""
    cd = device if isinstance(device, ColdDevice) else ColdDevice(device)
    pending, chunks = [], []
    audio = 0
    for cat in split_copies(streams, copies, n_chunks):
        with span("dcs.cold.pack"):
            t0 = time.perf_counter()
            sw = fs.FlatSweep(cat).pack()
            ca = sw.compact_host_arrays()
            n_steps = ca.pop("n_steps")
            t1 = time.perf_counter()
        with span("dcs.cold.upload"):
            cols, marks = cd.upload(ca)
        pending.append((cols, n_steps, marks))
        chunks.append(dict(pack_ms=(t1 - t0) * 1e3,
                           enqueue_ms=(time.perf_counter() - t1) * 1e3))
        audio += sw.audio_samples
    with span("dcs.cold.dispatch"):
        for _, _, marks in pending:
            cd.wait(marks)
        start = cd.mark()
        pcm = cd.pipe94(**concat_chunks([_widen94(c, n)
                                         for c, n, _ in pending]))
        chk = cs.checksum(pcm)
        end = cd.mark()
    with span("dcs.cold.fetch"):
        t0 = time.perf_counter()
        value = int(chk)
        fetch_ms = (time.perf_counter() - t0) * 1e3
    for c, (_, _, marks) in zip(chunks, pending):
        c["upload_ms"] = cd.ms(*marks)
    return dict(checksum=value, audio_samples=audio, pcm=pcm, chunks=chunks,
                device_ms=cd.ms(start, end), fetch_ms=fetch_ms)


def cold_catalog(cat94, cat93b, cat93a, device="cuda"):
    """One cold sweep of a mixed catalog: the 1994+ streams ``cat94``, the
    93b / 93a Type-0 streams ``cat93b`` and the OS93a Type-1 streams
    ``cat93a``, one family after another.  Each family is packed (for the
    1993 families with their bank columns, columns93), its upload queued,
    and its decode and checksum queued behind the upload, so the card
    decodes a family while the host packs the next; three checksum fetches
    come at the end.

    ``device`` as cold_flat94's.  Returns a dict: checksum (the families'
    checksums summed in int32, as catalog_pipeline), checksums and, per
    family ("94", "93b", "93a1"), families (bench.py's: host_ms of the
    pack, frames, audio_s), upload_ms (the copy stream's clock), device_ms
    (the compute stream's: decode and checksum); audio_samples, fetch_ms."""
    cd = device if isinstance(device, ColdDevice) else ColdDevice(device)

    def pack94():
        sw = fs.FlatSweep(cat94).pack()
        ca = sw.compact_host_arrays()
        return sw, ca, ca.pop("n_steps")

    def pack93(cat, t1):
        sw = cs.Flat93Sweep(cat, t1)
        return sw, cs.columns93(sw.compact_host_arrays()), None

    families, upload, pending = {}, {}, []
    audio = 0
    for name, pack in (("94", pack94),
                       ("93b", lambda: pack93(cat93b, False)),
                       ("93a1", lambda: pack93(cat93a, True))):
        with span("dcs.cold.pack"):
            t0 = time.perf_counter()
            sw, cols, n_steps = pack()
            families[name] = dict(host_ms=(time.perf_counter() - t0) * 1e3,
                                  frames=sw.n_frames_total,
                                  audio_s=sw.audio_samples / fs.SAMPLE_RATE)
        audio += sw.audio_samples
        with span("dcs.cold.upload"):
            cols, upload[name] = cd.upload(cols)
        with span("dcs.cold.dispatch"):
            cd.wait(upload[name])
            start = cd.mark()
            pcm = (cd.pipe94(**_widen94(cols, n_steps)) if name == "94"
                   else cd.pipe93(**cols))
            pending.append((name, cs.checksum(pcm), start, cd.mark()))
    with span("dcs.cold.fetch"):
        t0 = time.perf_counter()
        checks = {name: int(chk) for name, chk, _, _ in pending}
        fetch_ms = (time.perf_counter() - t0) * 1e3
    total = int(cs.wrap_int32(torch.tensor(sum(checks.values()))))
    return dict(checksum=total, checksums=checks, families=families,
                upload_ms={k: cd.ms(*m) for k, m in upload.items()},
                device_ms={n: cd.ms(a, b) for n, _, a, b in pending},
                audio_samples=audio, fetch_ms=fetch_ms)
