"""The two kinds of job a cell runs, each with its set-up, its timed entry
and its check against the plain reference.

- ``CatalogJobs`` (traffic kind ``catalog``): set-up packs every variant of
  every catalog sweep with the program's host half (``FlatSweep`` or
  ``Flat93Sweep``) and keeps it on the card; a job runs each sweep of one
  variant through the program's device half (``FlatPipeline.forward`` or
  ``Flat93Pipeline.forward``) and digests each stream's PCM on the card.
- ``SessionJobs`` (traffic kind ``sessions``): set-up builds the ROM's bank
  and a ``SessionServer`` and traces every batch into its control wire
  (``SessionServer.prepare``), kept in pinned memory; a job uploads one wire
  and runs ``SessionServer.decode_wire`` with a digest of each session as
  its ``reduce_fn``.  The check reads the program's wire back with the
  reader the configuration's ``rom.wire`` names (``load_wire``).

A job returns its digests on the device; the loop fetches them.  After the
window ``check`` works every compared quantity out again with the plain
reference (``dcsbench/reference``) from the same inputs and counts what
differs.  ``inputs`` describes one job's work for the per-layer metrics.
"""

import importlib.util
import os
import re

import numpy as np
import torch
from torch.profiler import record_function

from ..reference import codec, digest, wire
from ..reference import decoder as ref_decoder
from ..reference import zipload as ref_zipload
from . import traffic as gen

SAMPLE_RATE, FRAME = 31250, 240
ENQUEUE_SPAN = "dcsbench.enqueue"

_OS = {"os94": ref_decoder.OS94, "os93b": ref_decoder.OS93B,
       "os93a": ref_decoder.OS93A}
REFERENCE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "reference")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load_wire(name, reference_dir=REFERENCE_DIR):
    """The session wire's reader a configuration names (``rom.wire``):
    ``reference/wire.py`` for none, else ``reference/wire_<name>.py``,
    loaded by file.  Its ``expand(buf, S, T, C, E)`` gives (rows, mix
    [S, T, C], vol [S, T]) of a wire, as ``wire.expand`` does."""
    if name is None:
        return wire
    path = os.path.join(reference_dir, f"wire_{name}.py")
    if not NAME.match(name) or not os.path.isfile(path):
        raise RuntimeError(f"the configuration's wire reader {name!r} "
                           f"needs the file {path}")
    spec = importlib.util.spec_from_file_location(
        f"dcsbench_wire_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "expand", None)):
        raise RuntimeError(f"{path} defines no expand(buf, S, T, C, E)")
    return mod


def _read(path):
    with open(path, "rb") as f:
        return f.read()


class CatalogJobs:
    def __init__(self, config, traffic, seed, device, data_dir):
        from dcsexplorer_tpu_torch.models import catalogsweep as cs
        from dcsexplorer_tpu_torch.models import flatsweep as fs
        self.sweeps = config["catalog"]
        self.variants = gen.catalog_variants(self.sweeps, traffic, seed)
        self.streams = {n: _read(os.path.join(data_dir, n))
                        for sw in self.sweeps for n, _ in sw["streams"]}
        self.n_variants = traffic["variants"]
        self.pipes, self.args, self.ids = [], [], []
        for sweep, variants in zip(self.sweeps, self.variants):
            t1 = sweep.get("t1")
            if t1 is None:
                self.pipes.append(fs.FlatPipeline(device))
            else:
                self.pipes.append(cs.Flat93Pipeline(device))
            args, ids = [], []
            for v in variants:
                streams = [self.streams[n] for n in v["order"]]
                if t1 is None:
                    sw = fs.FlatSweep(streams, v["mixing_level"],
                                      v["master_volume"]).pack()
                    a = fs.packed_to_device(sw.compact_host_arrays(), device)
                    counts = np.bincount(sw.sid, minlength=len(streams))
                else:
                    sw = cs.Flat93Sweep(streams, t1, v["mixing_level"],
                                        v["master_volume"])
                    host = sw.compact_host_arrays()
                    a = cs.packed93_to_device(host, device)
                    counts = np.bincount(host["sid"], minlength=len(streams))
                args.append(a)
                ids.append(tuple(t.to(device)
                                 for t in digest.stream_ends(counts)))
            self.args.append(args)
            self.ids.append(ids)
        self.frames = sum(int(ids[0][0].numel()) for ids in self.ids)
        self.audio_s = self.frames * FRAME / SAMPLE_RATE
        self.n_out = sum(int(ids[0][1].numel()) // 2 for ids in self.ids)

    def n_distinct(self):
        return self.n_variants

    def dispatch(self, n):
        """Enqueue job n (variant n mod variants); its digests
        [streams, 2] int64 on the device."""
        v = n % self.n_variants
        with record_function(ENQUEUE_SPAN):
            outs = [pipe(**args[v]) for pipe, args in zip(self.pipes,
                                                         self.args)]
        return torch.cat([digest.stream_digests(out, *ids[v])
                          for out, ids in zip(outs, self.ids)])

    def _columns(self, k, v):
        a = self.args[k][v]
        mix = a["mix_u16"] if "mix_u16" in a else a["mix"]
        vol = a["vol_u8"] if "vol_u8" in a else a["vol"]
        return mix.long().cpu().numpy(), vol.long().cpu().numpy()

    def release(self):
        """Read back what the check compares, then free the card."""
        self._cols = [[self._columns(k, v) for v in range(self.n_variants)]
                      for k in range(len(self.sweeps))]
        self.pipes = self.args = self.ids = None

    # -- the reference ---------------------------------------------------
    def _reference(self, device, index_cache):
        """{(sweep, name, level, volume): (pcm, mix, vol)} for every
        stream the variants play, from the plain reference."""
        out = {}
        for k, (sweep, variants) in enumerate(zip(self.sweeps,
                                                  self.variants)):
            t1 = sweep.get("t1")
            os_v = _OS["os94"] if t1 is None else (
                _OS["os93a"] if t1 else _OS["os93b"])
            banks = {}
            for v in variants:
                for name in sorted(set(v["order"])):
                    key = (k, name, v["mixing_level"], v["master_volume"])
                    if key in out:
                        continue
                    if name not in banks:
                        b = (codec.Bank94(index_cache) if t1 is None
                             else codec.Bank93(index_cache))
                        if t1 is None:
                            b.add(name, self.streams[name])
                        else:
                            b.add(name, self.streams[name], 0, t1)
                        banks[name] = (b, b.decode(device) if t1 is None
                                       else b.arrays(device))
                    b, dev_state = banks[name]
                    F = b.n_rows - 1
                    mix, vol = codec.standalone_controls(
                        self.streams[name], os_v, v["mixing_level"],
                        v["master_volume"], F)
                    rows = np.arange(1, F + 1)[:, None]
                    pcm_fn = codec.pcm94 if t1 is None else codec.pcm93
                    pcm = pcm_fn(dev_state, rows, mix[:, None], vol,
                                 np.zeros(F), device)
                    out[key] = (pcm.cpu().numpy(), mix, vol)
        return out

    def check(self, history, device, index_cache):
        """(mismatches, failed jobs, what was compared): the stream digests
        of every job and the packed mix / volume frames of every variant
        that differ from the reference."""
        ref = self._reference(device, index_cache)
        want, bad_cols = [], 0
        for v in range(self.n_variants):
            rows = []
            for k, variants in enumerate(self.variants):
                var = variants[v]
                keys = [(k, n, var["mixing_level"], var["master_volume"])
                        for n in var["order"]]
                rows += [digest.digest_np(ref[key][0]) for key in keys]
                mix = np.concatenate([ref[key][1] for key in keys])
                vol = np.concatenate([ref[key][2] for key in keys])
                got_mix, got_vol = self._cols[k][v]
                if got_mix.shape != mix.shape:
                    bad_cols += max(got_mix.size, mix.size)
                else:
                    bad_cols += int(((got_mix != mix) | (got_vol != vol))
                                    .sum())
            want.append(np.stack(rows))
        per_job = [int((got != want[n % self.n_variants]).any(1).sum())
                   for n, got in history]
        return (sum(per_job) + bad_cols, sum(b > 0 for b in per_job),
                f"{len(history) * self.n_out} stream digests "
                f"({sum(per_job)} differ), the packed columns of "
                f"{self.n_variants} variants ({bad_cols} frames differ)")

    def control_history(self, device, index_cache):
        """The digests of one job a variant as the reference, put in the
        program's place, computes them (under the caller's control)."""
        ref = self._reference(device, index_cache)
        out = []
        for v in range(self.n_variants):
            rows = []
            for k, variants in enumerate(self.variants):
                var = variants[v]
                rows += [digest.digest_np(ref[(k, n, var["mixing_level"],
                                               var["master_volume"])][0])
                         for n in var["order"]]
            out.append((v, np.stack(rows)))
        return out

    def inputs(self, device, index_cache):
        """One job's work, per sweep, from its streams: frames, streams,
        bytes of stream data, and the symbols (1994+) or band cells and
        Type-1 inputs (1993) that its decode reads."""
        out = {"flat94": [], "flat93": []}
        for sweep in self.sweeps:
            t1 = sweep.get("t1")
            rec = dict(frames=0, streams=0, stream_bytes=0, symbols=0,
                       cells93=0, inputs93a=0)
            for name, copies in sweep["streams"]:
                s = self.streams[name]
                if t1 is None:
                    b = codec.Bank94(index_cache)
                    b.add(name, s)
                    rec["symbols"] += copies * int(
                        b.row_symbols(device).sum())
                else:
                    b = codec.Bank93(index_cache)
                    b.add(name, s, 0, t1)
                    cells, ins = b.row_work(device)
                    rec["cells93"] += copies * int(cells.sum())
                    rec["inputs93a"] += copies * int(ins.sum())
                rec["frames"] += copies * (b.n_rows - 1)
                rec["streams"] += copies
                rec["stream_bytes"] += copies * len(s)
            out["flat94" if t1 is None else "flat93"].append(rec)
        return out


class SessionJobs:
    def __init__(self, config, traffic, seed, device, data_dir):
        from dcsexplorer_tpu_torch.models import romplay
        from dcsexplorer_tpu_torch.rom import zipload
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        rom = config["rom"]
        self.wire = load_wire(rom.get("wire"))
        self.rom_path = os.path.join(data_dir, rom["file"])
        S, T = traffic["sessions"], traffic["frames"]
        self.S, self.T, self.C = S, T, traffic["voices"]
        w_T = digest.weights(np.arange(1, T + 1)).to(device)
        rs, _ = zipload.load_zip_file(self.rom_path)
        if rs.check() != 1:
            raise RuntimeError(f"{rom['file']} fails its checksums")
        bank = romplay.build_rom_bank(rs, device)
        if bank.total_rows() != rom["bank_rows"]:
            raise RuntimeError(f"the program's bank of {rom['file']} has "
                               f"{bank.total_rows()} rows; the ROM's "
                               f"streams have {rom['bank_rows']}")
        self.server = romplay.SessionServer(
            rs, S, T, n_ch=self.C, seg_e=traffic["seg_e"], bank=bank,
            default_volume=rom["default_volume"],
            reduce_fn=lambda words: digest.session_digests(words, w_T),
            device=device)
        self.batches = [gen.session_batch(rom["voice_tracks"], traffic, seed,
                                          b)
                        for b in range(traffic["batches"])]
        self.wires = []
        for events in self.batches:
            w, E = self.server.prepare(events)
            host = torch.from_numpy(w)
            if device.type == "cuda":
                host = host.pin_memory()
            self.wires.append((host, E))
        self.audio_s = S * T * FRAME / SAMPLE_RATE
        self.n_out = S

    def n_distinct(self):
        return len(self.wires)

    def dispatch(self, n):
        """Enqueue job n (batch n mod batches): upload its wire, run the
        batch; its digests [sessions, 2] int64 on the device."""
        host, E = self.wires[n % len(self.wires)]
        with record_function(ENQUEUE_SPAN):
            w = host.to(self.device, non_blocking=True)
            return self.server.decode_wire(w, E)

    def release(self):
        self.server.close()
        self.server = None

    def _reference(self, device, index_cache):
        """[(batch, session, plays, mix, vol, pcm)] for the checked
        sessions, traced and decoded by the plain reference."""
        rs, _ = ref_zipload.load_zip_file(self.rom_path)
        rs.check()
        images = codec.chip_images(rs)
        fam93 = rs.os_version in (ref_decoder.OS93A, ref_decoder.OS93B)
        bank = (codec.Bank93 if fam93 else codec.Bank94)(index_cache)
        traced = []
        for b, s in gen.sample_sessions(self.traffic, self.seed):
            plays, mix, vol = codec.session_controls(
                rs, self.batches[b][s], self.T, self.C,
                self.config["rom"]["default_volume"])
            for row in plays:
                for p in row:
                    if p is not None and p[0] not in bank.first:
                        mem = images[p[0][0]]
                        if fam93:
                            bank.add(p[0], mem, p[0][1], codec.is_type1(
                                rs.os_version, mem, p[0][1]))
                        else:
                            bank.add(p[0], mem, p[0][1])
            traced.append((b, s, plays, mix, vol))
        state = bank.arrays(device) if fam93 else bank.decode(device)
        out = []
        for b, s, plays, mix, vol in traced:
            rows = bank.rows(plays, self.C)
            fn = codec.pcm93 if fam93 else codec.pcm94
            pcm = fn(state, rows, mix, vol, np.zeros(self.T), device)
            out.append((b, s, rows, mix, vol, pcm.cpu().numpy()))
        self._bank, self._fam93 = bank, fam93
        self._ref_rows = [r for _, _, r, _, _, _ in out]
        return out

    def check(self, history, device, index_cache):
        """(mismatches, failed jobs, what was compared): the checked
        sessions' digests that differ from the reference over every job of
        their batch, and their frames whose traced controls (which
        channels play, their mixing multipliers, the volume shift)
        differ."""
        ref = self._reference(device, index_cache)
        bad, bad_ctl, n_cmp = 0, 0, 0
        failed_jobs = set()
        B = len(self.wires)
        expanded = {}
        for b, s, rows, mix, vol, pcm in ref:
            if b not in expanded:          # the program's wire, read back
                host, E = self.wires[b]
                expanded = {b: [t.cpu().numpy() for t in
                                self.wire.expand(host.to(device), self.S,
                                                 self.T, self.C, E)]}
            p_rows, p_mix, p_vol = (a[s] for a in expanded[b])
            plays = rows != 0
            ctl = ((p_rows != 0) != plays) | (plays & (p_mix != mix))
            bad_ctl += int((ctl.any(1) | (p_vol != vol)).sum())
            want = digest.digest_np(pcm)
            for n, got in history:
                if n % B == b:
                    n_cmp += 1
                    if (got[s] != want).any():
                        bad += 1
                        failed_jobs.add(n)
        return (bad + bad_ctl, len(failed_jobs),
                f"{n_cmp} digests of {len(ref)} sessions ({bad} differ), "
                f"their traced controls ({bad_ctl} frames differ)")

    def control_history(self, device, index_cache):
        """One job a batch whose checked sessions' digests are the
        reference's, put in the program's place (under the caller's
        control); the other sessions hold -1."""
        hist = {b: np.full((self.S, 2), -1, np.int64)
                for b in range(len(self.wires))}
        for b, s, _, _, _, pcm in self._reference(device, index_cache):
            hist[b][s] = digest.digest_np(pcm)
        return sorted(hist.items())

    def inputs(self, device, index_cache):
        """One job's work: the batch's shape, its wire's mean bytes, the
        bank's rows, and (1993) the band cells and Type-1 inputs a played
        frame reads, averaged over the checked sessions' traces."""
        rec = dict(sessions=self.S, frames=self.T, channels=self.C,
                   wire_bytes=float(np.mean([w.numel()
                                             for w, _ in self.wires])),
                   bank_rows=self.config["rom"]["bank_rows"])
        if getattr(self, "_fam93", False):
            cells, ins = self._bank.row_work(device)
            rows = torch.as_tensor(np.concatenate(self._ref_rows),
                                   device=device).long()
            F = self.S * self.T
            scale = F / rows.shape[0]
            rec.update(family="os93",
                       cells93=float(cells[rows].sum()) * scale,
                       inputs93a=float(ins[rows].sum()) * scale,
                       pool_bytes=int(self._bank.pool(device).numel()))
        else:
            rec.update(family="os94")
        return {"sessions": rec}
