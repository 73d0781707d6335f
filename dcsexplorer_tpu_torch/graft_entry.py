"""Entry points of the PyTorch port, the counterpart of the repo's
``__graft_entry__.py``.

``entry(device)``            -- a forward step of the padded model: the full
                                device decode of one DCS stream asset
                                (decode94_fb -> transform94_pcm), as
                                (step, example_args).
``dryrun_multichip(n, dev)`` -- the three sharded paths of
                                ``parallel/sweep.py`` on small shapes over a
                                mesh of n devices, each held against its
                                single-device result.

Both run on the card unless the caller names another device.
"""

import glob
import os

import numpy as np
import torch

from .models import batched
from .models import flatsweep as fs
from .models import pipeline as pl
from .parallel import sweep
from .refdec import decoder as rd

_ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "streams")


def _load_streams(max_streams=2):
    paths = sorted(glob.glob(os.path.join(_ASSETS, "*.dcs94")))
    out = []
    for p in paths[:max_streams]:
        with open(p, "rb") as f:
            out.append(f.read())
    return out


def entry(device="cuda"):
    """(step, example_args): step(stream_bytes, rel_start, headers) runs
    batch_decode on the first stream asset, its other inputs bound, on
    ``device`` (the card unless given); example_args are those three
    tensors.  step returns pcm [1, F, 240] int32 (u16 storage)."""
    inputs = batched.SweepInputs(_load_streams(1))
    (sb, rs, hd, fmt, sub, bt, btp, mix, vol, n_steps) = inputs.args(device)

    def step(stream_bytes, rel_start, headers):
        return batched.batch_decode(stream_bytes, rel_start, headers, fmt,
                                    sub, bt, btp, mix, vol, n_steps)

    return step, (sb, rs, hd)


def _require_equal(name, got, want):
    if got.shape != want.shape or not torch.equal(got.cpu(), want.cpu()):
        raise AssertionError(f"{name}: the sharded result differs from the "
                             f"single-device result")


def dryrun_multichip(n_devices, device="cuda"):
    """Run the three sharded paths on small shapes over n_devices mesh
    entries: the first n_devices cards where there are that many, else
    ``device`` (the card unless given) n_devices times.  Each result must
    equal the single-device result bit for bit, or this raises.  Returns
    the mesh."""
    dev = fs._device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n_devices > 1:
        devices = [f"cuda:{i}" for i in range(n_devices)]
    else:
        devices = [dev] * n_devices
    fmesh = sweep.make_flat_mesh(devices)
    n, home = len(fmesh), fmesh[0]

    # 1) the flat sweep over the 1-D mesh (the halo crosses every shard
    #    boundary)
    streams = _load_streams(2) * max(1, (n + 1) // 2)
    arrays = fs.FlatSweep(streams).pack().compact_host_arrays()
    _require_equal("sharded_flat_sweep",
                   sweep.sharded_flat_sweep(fmesh, arrays),
                   fs.FlatPipeline(home)(**fs.packed_to_device(arrays,
                                                               home)))

    # 2) the padded model over a (tracks, frames) mesh
    frame_shards = 2 if n % 2 == 0 else 1
    mesh = sweep.make_mesh(devices, frame_shards=frame_shards)
    inputs = batched.SweepInputs(_load_streams(1)
                                 * max(2, n // frame_shards))
    _require_equal("sharded_sweep", sweep.sharded_sweep(mesh, inputs),
                   batched.batch_decode(*inputs.args(home)))

    # 3) sessions against a bank replicated over the mesh; the asset cut to
    #    4 frames (the count rides in its first two bytes)
    bank = pl.StreamBank(rd.OS94)
    mem = (4).to_bytes(2, "big") + streams[0][2:]
    bank.add(mem, 0)
    bank.decode_all(home)
    tracer = pl.ControlTracer()
    tracer.init_standalone(rd.OS94)
    tracer.soft_boot()
    tracer.load_audio_stream(0, mem, mixing_level=0x64)
    tracer.trace_frames(8)
    rows, mix, vol = pl.assemble_controls(tracer, bank)
    B = max(2, n // 2)
    one, _ = pl.device_decode(pl.session_decoder(bank), rows, mix, vol)
    _require_equal("sharded_sessions", sweep.sharded_sessions(
        fmesh, bank, *(np.broadcast_to(a, (B,) + a.shape)
                       for a in (rows, mix, vol))),
        one.expand((B,) + one.shape))
    return fmesh
