"""The per-layer metrics' counts of bytes and operations repeat exactly
from a job's inputs, agree with the program's own column count where it
has one, and read nothing where a cell has no such work."""

import os

import numpy as np
import pytest
import torch

from dcsbench import harness
from dcsbench.harness import trace as trace_mod
from dcsbench.reference.cache import IndexCache
from dcsbench_sizes import CELLS

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOFLINES = ("decode94_fb.roofline", "transform94_pcm.roofline",
             "session_mix94.roofline", "segments94.roofline",
             "decode93_pcm.roofline")


def _jobs(cell, seed):
    _, _, config, traffic = harness.load_spec(
        cell, overrides=CELLS[cell].get("overrides"),
        config_overrides=CELLS[cell].get("config_overrides"))
    return harness.KINDS[traffic["kind"]](config, traffic, seed,
                                          torch.device("cpu"),
                                          os.path.join(HERE, "data"))


def _inputs(cell, seed):
    torch.set_num_threads(1)
    jobs = _jobs(cell, seed)
    jobs.release()
    cache = IndexCache()
    if cell.endswith("sessions"):       # the 1993 counts read the traces
        jobs.check([], torch.device("cpu"), cache)
    return jobs.inputs(torch.device("cpu"), cache)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_counts_repeat_exactly(cell):
    a, b = _inputs(cell, 11), _inputs(cell, 11)
    assert a == b
    works = {m: harness.load_metric(m).work(a) for m in ROOFLINES}
    assert any(w is not None for w in works.values())
    for w in works.values():
        if w is not None:
            assert w[0] > 0 and w[1] > 0


def test_catalog_counts_are_the_streams():
    """The 1994+ catalog's symbols, counted from the reference's own walk,
    equal those of the program's slot controls on its packed columns."""
    from dcsexplorer_tpu_torch.models import flatsweep as fs
    from dcsexplorer_tpu_torch.ops import band_decode as bd
    inp = _inputs("os94.catalog", 3)["flat94"][0]
    streams = [open(os.path.join(HERE, "data", n), "rb").read()
               for n in ("music_a.dcs94", "music_b.dcs94")]
    a = fs.packed_to_device(fs.FlatSweep(streams).pack()
                            .compact_host_arrays(), "cpu")
    tabs = fs.codec_tables()
    cols = bd.unpack_columns(a["sid"], a["bt_u8"], a["hdr_tab"],
                             a["fmt_tab"], a["sub_tab"])
    packed, _, _ = bd.slot_controls(bd.band_controls_dyn(*cols[:5], tabs),
                                    tabs)
    assert inp["symbols"] == int((packed != 0).sum())
    assert inp["frames"] == a["sid"].numel()
    assert inp["streams"] == 2
    assert inp["stream_bytes"] == sum(len(s) for s in streams)


class _Ctx:
    def __init__(self, inputs, kernels, jobs=3):
        self.inputs, self.jobs = inputs, jobs
        self.summary = dict(kernels=kernels)

    def kernel_seconds(self, prefixes):
        return trace_mod.kernel_seconds(self.summary, prefixes)


def test_a_metric_reads_nothing_without_its_kernel_or_work():
    inp = _inputs("os94.catalog", 5)
    dec = harness.load_metric("decode94_fb.roofline")
    assert dec.read(_Ctx(inp, {})) is None
    assert dec.read(_Ctx({"sessions": None}, {
        "decode94_fb_kernel(int)": (3, 1e-3)})) is None
    got = dec.read(_Ctx(inp, {"decode94_fb_kernel(unsigned char const*)":
                              (3, 1e-3)}))
    n_bytes, n_ops = dec.work(inp)
    want = 100 * max(3 * n_bytes / 3.35e12, 3 * n_ops / 33.5e12) / 1e-3
    assert got == pytest.approx(want, rel=1e-12)
    assert harness.load_metric("session_mix94.roofline").read(
        _Ctx(inp, {"session_mix94_kernel": (1, 1.0)})) is None


def test_enqueue_and_idle_readers():
    enq = harness.load_metric("enqueue_ms")
    idle = harness.load_metric("device_idle")
    ctx = _Ctx({}, {})
    ctx.summary.update(spans={"dcsbench.enqueue": (4, 0.002)},
                       busy_s=0.9, window_s=1.0)
    assert enq.read(ctx) == pytest.approx(0.5)
    assert idle.read(ctx) == pytest.approx(10.0)
    ctx.summary["spans"] = {}
    assert enq.read(ctx) is None
    assert np.isfinite(idle.read(ctx))
