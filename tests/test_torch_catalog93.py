"""Port parity for the flat 1993 catalog sweep (models/catalogsweep.py) on
the CPU, where the plain PyTorch versions of decode93_fb and
transform93_pcm run.  It mirrors tests/test_catalog_e2e.py:

- Flat93Sweep + run_flat93 on several streams of one flat axis (both format
  types of 93b, OS93a Type-1 of two selectors, the music assets) against
  per-stream scalar decode and against the JAX run_flat93;
- the compact wire (compact_host_arrays) field for field against the JAX
  Flat93Sweep's, on all four .dcs93* assets;
- the columns that packed93_to_device builds from that wire, unpacked,
  against the JAX prescan index the reference's flat pipeline derives;
- Flat93Pipeline's words against the JAX flat93*_pipeline_packed.
Every comparison is bit for bit on & $FFFF."""

import functools
import inspect
import os

import numpy as np
import pytest
import torch

import jax

from dcsexplorer_tpu.models import catalogsweep as jcs
from dcsexplorer_tpu.ops import decode93 as jd93
from dcsexplorer_tpu.ops import decode93a as jd93a
from dcsexplorer_tpu_torch.models import catalogsweep as tcs
from dcsexplorer_tpu_torch.ops import decode93 as td93
from dcsexplorer_tpu_torch.ops import kernels
from dcsexplorer_tpu_torch.refdec.decoder import (OS93A, OS93B,
                                                  ReferenceDecoder)

from .test_format93 import (build_stream93_fmt0, build_stream93_fmt1,
                            build_stream93a_type1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets", "streams")
WIRES = {False: ["music_a.dcs93b", "music_b.dcs93a"],
         True: ["dense_t1.dcs93a1", "dense_t1b.dcs93a1"]}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # the plain versions run many small ops; beside other test workers, a
    # thread pool per op costs more than it gives
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(name):
    with open(os.path.join(ASSETS, name), "rb") as f:
        return f.read()


def _scalar_pcm(stream, os_version, n_frames):
    dec = ReferenceDecoder()
    dec.default_volume = 255
    dec.init_standalone(os_version)
    dec.soft_boot()
    dec.load_audio_stream(0, bytes(stream), mixing_level=0x64)
    return np.array(dec.next_samples(n_frames * 240), dtype=np.int16)


def _check_streams(streams, os_version, got, n_frames=None):
    """got: the flat sweep's PCM; each stream's first n_frames (all when
    None) against the scalar decoder."""
    pos = 0
    for s in streams:
        nf = (s[0] << 8) | s[1]
        n = nf if n_frames is None else min(nf, n_frames)
        want = _scalar_pcm(s, os_version, n)
        seg = got[pos:pos + n * 240]
        mism = np.nonzero(want != seg)[0]
        assert mism.size == 0, (
            f"stream@{pos}: {mism.size} mismatches, first at {mism[0]}")
        assert np.abs(want).max() > 0
        pos += nf * 240
    assert pos == got.size


def test_flat93_multi_stream_bit_exact():
    # three 93b streams of both format types and different lengths
    streams = [build_stream93_fmt0(seed=7), build_stream93_fmt1(seed=8),
               build_stream93_fmt0(n_frames=5, seed=9)]
    sweep = tcs.Flat93Sweep(streams, t1=False)
    got = tcs.run_flat93(sweep, "cpu")
    assert got.dtype == np.int16
    _check_streams(streams, OS93B, got)
    assert np.array_equal(jcs.run_flat93(jcs.Flat93Sweep(streams, t1=False)),
                          got)


def test_flat93a_multi_stream_bit_exact():
    # two OS93a Type-1 streams of different selectors
    streams = [build_stream93a_type1(n_frames=10, n_bands=10, selector=0,
                                     seed=11),
               build_stream93a_type1(n_frames=7, n_bands=12, selector=2,
                                     seed=13)]
    got = tcs.run_flat93(tcs.Flat93Sweep(streams, t1=True), "cpu")
    _check_streams(streams, OS93A, got)
    assert np.array_equal(jcs.run_flat93(jcs.Flat93Sweep(streams, t1=True)),
                          got)


@pytest.mark.parametrize("t1", [False, True])
def test_flat93_asset_streams_bit_exact(t1):
    # the bench's corpora (93b + 93a Type-0 in one batch; the two OS93a
    # Type-1 streams) on one flat axis: every frame against the JAX sweep,
    # the first 150 frames of each stream against the scalar decoder
    streams = [_read(n) for n in WIRES[t1]]
    got = tcs.run_flat93(tcs.Flat93Sweep(streams, t1), "cpu")
    _check_streams(streams, OS93A if t1 else OS93B, got, n_frames=150)
    assert np.array_equal(jcs.run_flat93(jcs.Flat93Sweep(streams, t1)), got)


@pytest.mark.parametrize("t1", [False, True])
def test_compact_wire_matches_jax(t1):
    streams = [_read(n) for n in WIRES[t1]]
    want = jcs.Flat93Sweep(streams, t1).compact_host_arrays()
    sweep = tcs.Flat93Sweep(streams, t1)
    got = sweep.compact_host_arrays()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    assert sweep.n_frames_total == sum((s[0] << 8) | s[1] for s in streams)


@pytest.mark.parametrize("t1", [False, True])
def test_packed_columns_unpack_to_the_jax_index(t1):
    # the flat path's bank columns, unpacked, are the per-frame index the
    # reference's flat pipeline decodes from: the JAX prescan's
    # index_arrays at each stream's bit offset in the pool
    streams = [_read(n) for n in WIRES[t1]]
    cols = tcs.packed93_to_device(
        tcs.Flat93Sweep(streams, t1).compact_host_arrays(), "cpu")
    assert cols["kind_u8"].tolist() == [td93.ROW_93A if t1 else td93.ROW_93] \
        * cols["kind_u8"].shape[0]
    arrs93, arrs93a = td93.unpack_columns93(cols)
    got = arrs93a if t1 else arrs93
    pos, row = 0, 0
    for s in streams:
        idx = jd93a.prescan93a(s) if t1 else jd93.prescan93(s)
        want = (jd93a if t1 else jd93).index_arrays(idx, pos * 8)
        F = idx.n_frames
        if t1:
            read = np.asarray(want["bits"]) > 0
        else:
            kind = np.asarray(want["kind"])
            read = (kind >= jd93.K_DATA0) & (kind <= jd93.K_DATA2)
        for k, w in want.items():
            w = np.asarray(w).astype(np.int64)
            g = got[k][row:row + F].numpy()
            if k == "scale32":
                w &= 0xFFFFFFFF
            if k == "bit_start":            # only where a band reads bits
                w, g = w[read], g[read]
            if k == "out_inc":              # only bands of the header
                live = np.asarray(want["n_samp"]) > 0
                w, g = w[live], g[live]
            assert np.array_equal(w, g), k
        pos += len(s) + 8
        row += F
    assert row == cols["frame_word"].shape[0]


@pytest.mark.parametrize("t1", [False, True])
def test_flat93_pipeline_matches_jax_pipeline_packed(t1):
    streams = [_read(n) for n in WIRES[t1]]
    ca = jcs.Flat93Sweep(streams, t1).compact_host_arrays()
    nwords = jcs.Flat93Sweep(streams, t1).nwords
    # one jitted program, as jcs.run_flat93 runs it (op by op, the same
    # function took ~25 s of dispatch and small compiles)
    fn = jax.jit(functools.partial(jcs.run_flat93_pcm, t1=t1, nwords=nwords))
    want = np.asarray(fn(ca)) & 0xFFFF
    pipe = tcs.Flat93Pipeline("cpu")
    assert set(dict(pipe.named_buffers())) >= {"pair", "cos", "br93_half"}
    before = dict(kernels.LAUNCHES)
    got = pipe(**tcs.packed93_to_device(ca, "cpu"))
    assert kernels.LAUNCHES == before
    assert got.dtype == torch.int32 and np.array_equal(want, got.numpy())


def test_flat93_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for fn in (tcs.run_flat93, tcs.packed93_to_device):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    sweep = tcs.Flat93Sweep([build_stream93_fmt0(seed=7)], t1=False)
    for call in (lambda: tcs.run_flat93(sweep),
                 lambda: tcs.packed93_to_device(sweep.compact_host_arrays()),
                 lambda: tcs.Flat93Pipeline()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
