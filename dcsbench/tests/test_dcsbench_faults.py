"""A run with the timed path broken underneath, on the CPU at small sizes:
``correct`` has to come out false for each fault a cell can have (a step
that returns its state unchanged; half of the batch left out, the mean of
the rest in its place; an answer altered where it is produced, or its
words written in another order), and for
the control (the reference with the MAC's convergent rounding made
ordinary, in the program's place).  The cells run on one chip, so there is
no exchange between chips to leave out.  Sound runs come out correct."""

import pytest
import torch

from dcsbench import control, harness
from dcsbench_sizes import CELLS, FAMILY_KIND

SEED = 2 ** 31 + 101


def _entry(cell):
    """(class, method) whose output is the cell's PCM words, by its
    configuration's family and its traffic's kind."""
    from dcsexplorer_tpu_torch.models import catalogsweep as cs
    from dcsexplorer_tpu_torch.models import flatsweep as fs
    from dcsexplorer_tpu_torch.models import pipeline as pl
    return {("os94", "catalog"): (fs.FlatPipeline, "forward"),
            ("os93", "catalog"): (cs.Flat93Pipeline, "forward"),
            ("os94", "sessions"): (pl.SessionDecoder, "forward"),
            ("os93", "sessions"): (pl.SessionDecoder93, "forward")}[
                FAMILY_KIND[cell]]


def stale(words, memo, step):
    """The step hands back the state it had: its first output, again."""
    return memo.setdefault(id(step), words.clone())


def half(words, memo, step):
    """Half the batch left out: its frames hold the mean of the rest."""
    out = words.clone()
    h = out.shape[0] // 2
    out[h:] = out[:h].double().mean(0).round().to(out.dtype)
    return out


def altered(words, memo, step):
    """One word of one answer altered where it is produced."""
    out = words.clone()
    out.view(-1)[out.numel() // 3] ^= 1
    return out


def permuted(words, memo, step):
    """The word pairs of one frame written in another order, as a wrong
    extraction map would write them: each word keeps its parity."""
    out = words.clone()
    frames = out.view(-1, 240)
    moved = frames.view(-1, 120, 2).flip(1).reshape(-1, 240)
    k = (frames != moved).any(1).nonzero().flatten()
    k = int(k[k.numel() // 3])
    frames[k] = moved[k]
    return out


def _run(cell, monkeypatch=None, fault=None):
    torch.set_num_threads(1)
    if fault is not None:
        cls, name = _entry(cell)
        orig = getattr(cls, name)
        memo = {}

        def broken(self, *a, **k):
            return fault(orig(self, *a, **k), memo, self)
        monkeypatch.setattr(cls, name, broken)
    # long enough on the CPU for the window to hold a job of each variant
    # or batch (the warm-up leaves the loop at variant 0)
    r = harness.run_cell(cell, SEED, 4.0, 0, device="cpu", **CELLS[cell])
    assert r["attempted"] >= 2
    return r


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["mismatches"] == {"value": 0, "limit": 0}
    assert set(r["metrics"]) == {"audio_xrt", "setup_s"}
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", [stale, half, altered, permuted])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_broken_path_is_not_correct(cell, fault, monkeypatch):
    r = _run(cell, monkeypatch, fault)
    assert not r["correct"]
    assert r["checks"]["mismatches"]["value"] > 0


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_is_not_correct(cell):
    torch.set_num_threads(1)
    readings = control.control_readings(cell, [SEED, SEED + 1], "cpu",
                                        **CELLS[cell])
    assert all(n > harness.MISMATCH_LIMIT for _, n, _ in readings)
