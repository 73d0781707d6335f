"""The port's own host runtime against the JAX package's, on each of the six
.dcs94 assets: the native prescan (and the Python walker, called by name),
the native VM trace, the scan and dense totals and the scalar
ReferenceDecoder give
the same results.  Also: a failed build of the native runtime raises."""

import glob
import os

import numpy as np
import pytest

from dcsexplorer_tpu.ops import prescan as jpre
from dcsexplorer_tpu.refdec import decoder as jrd
from dcsexplorer_tpu.vm import native_tracer as jnt
from dcsexplorer_tpu_torch import native
from dcsexplorer_tpu_torch.models import flatsweep as tfs
from dcsexplorer_tpu_torch.ops import prescan as tpre
from dcsexplorer_tpu_torch.vm import native_tracer as tnt

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "assets", "streams")
PATHS = sorted(glob.glob(os.path.join(ASSETS, "*.dcs94")))
NAMES = [os.path.basename(p) for p in PATHS]
INDEX_FIELDS = ("n_frames", "header", "fmt_type", "sub_type", "start_bit",
                "band_type", "band_type_prev", "end_bit", "error_frame")


def _stream(name):
    with open(os.path.join(ASSETS, name), "rb") as f:
        return f.read()


def _same_index(want, got, fields):
    for k in fields:
        w, g = getattr(want, k), getattr(got, k)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, k
        assert np.array_equal(np.asarray(w), np.asarray(g)), k


def test_six_assets():
    assert len(NAMES) == 6


@pytest.mark.parametrize("name", NAMES)
def test_native_prescan_matches_jax(name):
    s = _stream(name)
    got = tpre.prescan94(s, 0)
    _same_index(jpre.prescan94(s, 0), got, INDEX_FIELDS)
    assert got.n_frames == (s[0] << 8) | s[1] and got.error_frame == -1


@pytest.mark.parametrize("name", NAMES)
def test_python_walker_matches_jax(name):
    s = _stream(name)
    _same_index(jpre.prescan94(s, 0, prefer_native=False),
                tpre.prescan94_python(s, 0), INDEX_FIELDS + ("n_symbols",))


@pytest.mark.parametrize("name", NAMES)
def test_scan_totals_match_jax(name):
    s = _stream(name)
    want = jpre.scan_totals(jpre.prescan94(s, 0))
    got = tpre.scan_totals(tpre.prescan94(s, 0))
    assert got.dtype == want.dtype and np.array_equal(want, got)
    assert 0 < got.max() <= 255


@pytest.mark.parametrize("name", NAMES)
def test_dense_totals_match_jax(name):
    idx = tpre.prescan94(_stream(name), 0)
    want = jpre.dense_totals(jpre.prescan94(_stream(name), 0))
    got = tpre.dense_totals(idx)
    assert got.dtype == want.dtype and np.array_equal(want, got)
    assert 0 < got.max() <= 256 and (got <= tpre.scan_totals(idx)).all()


@pytest.mark.parametrize("name", NAMES)
def test_native_trace_matches_jax(name):
    s = _stream(name)
    n = (s[0] << 8) | s[1]
    outs = []
    for mod, os94 in ((jnt, jrd.OS94), (tnt, tfs.rd.OS94)):
        tr = mod.NativeControlTracer(s, default_volume=tfs.MASTER_VOLUME,
                                     standalone_os=os94)
        tr.soft_boot()
        tr.load_audio_stream(0, 0, mixing_level=tfs.MIXING_LEVEL)
        outs.append(tr.trace_frames(n))
        tr.close()
    for w, g in zip(*outs):
        assert np.array_equal(w, g)
    # the (mix, vol) columns the sweep packs
    mix, vol = tfs.trace_standalone(s, n, os94, tfs.MIXING_LEVEL,
                                    tfs.MASTER_VOLUME)
    assert np.array_equal(mix, outs[0][2][:, 0]) and (mix > 0).any()
    assert np.array_equal(vol, outs[0][3])


@pytest.mark.parametrize("name", NAMES)
def test_reference_pcm_matches_jax_reference_decoder(name):
    s = _stream(name)
    n = 64
    dec = jrd.ReferenceDecoder()
    dec.default_volume = tfs.MASTER_VOLUME
    dec.init_standalone(jrd.OS94)
    dec.soft_boot()
    dec.load_audio_stream(0, s, mixing_level=tfs.MIXING_LEVEL)
    want = np.array(dec.next_samples(n * 240), dtype=np.int16)
    got = tfs.reference_pcm(s, n)
    assert got.dtype == np.int16 and np.array_equal(want, got)
    assert np.abs(got.astype(np.int32)).max() > 0


def test_failed_native_build_raises(tmp_path, monkeypatch):
    # a compiler error surfaces as an exception, never as a missing library
    monkeypatch.setattr(native, "LIB_PATH", str(tmp_path / "libdcs_host.so"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "GXX_FLAGS",
                        native.GXX_FLAGS + ("--no-such-option",))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not os.path.exists(native.LIB_PATH)
