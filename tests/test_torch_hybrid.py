"""The host-decode hybrid of the port (models/batched.py hybrid_*,
native.decode_dense, band_decode.dequant_mix_dense) on the CPU, against the
JAX package's hybrid (dcsexplorer_tpu/models/batched.py:131-172) and the
port's scalar ReferenceDecoder.  Every comparison is bit for bit: frame
buffers as whole words, PCM as u16 storage (& $FFFF).

- the port's native dense decode against the JAX package's, every field,
  on the six .dcs94 assets, and the packed [S, F, 256] batch at the native
  widths against the JAX hybrid_host_stage;
- dequant_mix_dense_plain against the JAX dequant_mix_dense (one jit: the
  JAX side always gets fb_prev and active, zeros and all-true standing for
  absent, which its contract makes the same) on random slots from a numpy
  seed with duplicate indices, indices outside 0..511, fb_prev given and
  absent, active given and absent; and on a frame worked by hand;
- hybrid_batch_device (numpy inputs sent to the CPU, and CPU tensors) on
  three assets padded to the longest against the JAX hybrid_batch_device
  (one jit), pad frames included;
- each asset through hybrid_stage_device against the ReferenceDecoder at
  mixing $64 and volume $67 (tests/test_native.py's settings), and the
  hybrid's PCM against FlatPipeline on the CPU on the same streams;
- numpy inputs with no device named go to the card: without one they
  raise.  The kernel's wrapper refuses CPU tensors."""

import os

import numpy as np
import pytest
import torch

import jax

from dcsexplorer_tpu import native as jnative
from dcsexplorer_tpu.models import batched as jb
from dcsexplorer_tpu.ops import band_decode as jbd
from dcsexplorer_tpu_torch import native
from dcsexplorer_tpu_torch.models import batched as tb
from dcsexplorer_tpu_torch.models import flatsweep as tfs
from dcsexplorer_tpu_torch.ops import band_decode as bd
from dcsexplorer_tpu_torch.ops import kernels

from .torch_native_guard import reference_native_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets", "streams")
NAMES94 = ("chirpy", "music_a", "music_b", "noise_sweep", "sine_mix_1s",
           "tone_low")
PADDED = ("tone_low", "sine_mix_1s", "noise_sweep")      # 105, 131, 196 frames


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # the plain versions run many small ops; beside other test workers, a
    # thread pool per op costs more than it gives
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(name):
    with open(os.path.join(ASSETS, f"{name}.dcs94"), "rb") as f:
        return f.read()


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", NAMES94)
def test_decode_dense_matches_jax(name):
    reference_native_lib()
    s = _read(name)
    got, want = native.decode_dense(s), jnative.decode_dense(s)
    assert got.n_frames == want.n_frames == (s[0] << 8) | s[1]
    for field in native.NativeDecode.__slots__:
        a, b = getattr(got, field), getattr(want, field)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), field
        else:
            assert a == b, field
    assert got.valid.any() and got.error_frame < 0


def test_hybrid_host_stage_matches_jax():
    streams = [_read(n) for n in PADDED]
    got = tb.hybrid_host_stage(streams)
    want = jb.hybrid_host_stage(streams)
    assert got[4] == want[4] == [105, 131, 196]
    assert [a.dtype for a in got[:4]] == [np.int32, np.int32, np.int16,
                                          np.uint8]
    for a, b in zip(got[:4], want[:4]):
        assert a.shape == b.shape == (3, 196, 256)
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64))
    # the pad frames place nothing
    assert not got[3][0, 105:].any() and not got[0][0, 105:].any()


@pytest.fixture(scope="module")
def jax_dequant():
    """The JAX dequant_mix_dense, jitted once with fb_prev and active
    always given."""
    return jax.jit(lambda d, s, i, v, m, p, a: jbd.dequant_mix_dense(
        d, (s, i, v), m, p, a))


def _random_slots(seed, F=40):
    """Random slots at the native widths: values and scales over more
    than 16 bits, indices from -40 to 559 and, in a quarter of the slots,
    0..7 (duplicates, on words 0 and 1 too), one frame whose every slot
    names word 5, random mix and prior words over all 32 bits."""
    rng = np.random.default_rng(seed)
    d = rng.integers(-70000, 70000, (F, 256)).astype(np.int32)
    sc = rng.integers(-70000, 70000, (F, 256)).astype(np.int32)
    ix = rng.integers(-40, 560, (F, 256)).astype(np.int16)
    ix[:, :64] = rng.integers(0, 8, (F, 64))
    ix[3] = 5
    va = (rng.random((F, 256)) < 0.6).astype(np.uint8)
    va[3] = 1
    mx = rng.integers(0, 1 << 16, F).astype(np.int32)
    prev = rng.integers(-(1 << 31), 1 << 31, (F, 512),
                        dtype=np.int64).astype(np.int32)
    prev[::2] &= 0xFFFF
    active = rng.random(F) < 0.7
    active[3] = True
    return d, sc, ix, va, mx, prev, active


@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("with_active", [False, True])
def test_dequant_mix_dense_plain_matches_jax(jax_dequant, with_prev,
                                             with_active):
    d, sc, ix, va, mx, prev, active = _random_slots(2 * with_prev
                                                    + with_active)
    F = d.shape[0]
    prev = prev if with_prev else None
    active = active if with_active else None
    want = np.asarray(jax_dequant(
        d, sc, ix.astype(np.int32), va.astype(bool), mx,
        np.zeros((F, 512), np.int32) if prev is None else prev,
        np.ones(F, bool) if active is None else active))
    before = dict(kernels.LAUNCHES)
    got = bd.dequant_mix_dense(_t(d), (_t(sc), _t(ix), _t(va)), _t(mx),
                               _t(prev), _t(active))
    assert kernels.LAUNCHES == before            # the plain version ran
    assert got.dtype == torch.int32 and np.array_equal(want, got.numpy())
    # the duplicates summed past 16 bits: the words are compared whole
    assert want.max() > 0xFFFF
    # valid given as bool and the JAX widths give the same words
    wide = bd.dequant_mix_dense_plain(
        _t(d), (_t(sc), _t(ix.astype(np.int32)), _t(va.astype(bool))),
        _t(mx), _t(prev), _t(active))
    assert torch.equal(wide, got)


def test_dequant_mix_dense_plain_on_a_frame_worked_by_hand():
    # value 2 at scale 3, value -1 at scale 1 (mix 0: each slot's word is
    # its scaled sample's top half over the prior word, here the prior
    # word itself, since bits 16..31 of (old << 16) | scaled are old)
    F = 2
    d = np.zeros((F, 256), np.int32)
    sc = np.ones((F, 256), np.int32)
    ix = np.full((F, 256), 600, np.int16)        # out of range: dropped
    va = np.zeros((F, 256), np.uint8)
    d[:, :3] = [2, 0xFFFF, 7]
    sc[:, :3] = [3, 1, 1]
    ix[:, :3] = [9, 9, -1]                       # two slots name word 9
    va[:, :3] = 1
    prev = np.arange(F * 512, dtype=np.int32).reshape(F, 512) + 0x100
    mx = np.zeros(F, np.int32)
    got = bd.dequant_mix_dense_plain(_t(d), (_t(sc), _t(ix), _t(va)),
                                     _t(mx), _t(prev)).numpy()
    want = prev.copy()
    want[:, 9] = 2 * (prev[:, 9] & 0xFFFF)       # the two words' sum
    # fix-up: word 1 keeps its prior value, so the delta is 0 and word 0
    # saturates its own s16 value (already in range)
    assert np.array_equal(got, want)
    # silence: only word 9 is placed (0 + 0, the samples' top halves)
    got0 = bd.dequant_mix_dense_plain(_t(d), (_t(sc), _t(ix), _t(va)),
                                      _t(mx)).numpy()
    assert not got0.any()
    # with mix $FFFF the product s16(scaled) * $FFFF carries into the top
    # half: 6 + 6 * $FFFF = 6 << 16, and $FFFF + (-1) * $FFFF = 0
    mx1 = np.full(F, 0xFFFF, np.int32)
    got1 = bd.dequant_mix_dense_plain(_t(d), (_t(sc), _t(ix), _t(va)),
                                      _t(mx1)).numpy()
    w9 = ((6 + 6 * 0xFFFF) >> 16) + ((0xFFFF + (-1) * 0xFFFF) >> 16)
    assert (got1[:, 9] == w9).all() and not np.delete(got1, 9, 1).any()


@pytest.fixture(scope="module")
def padded():
    """(the port's hybrid_host_stage of three assets, mix and vol_shift
    [3, 196] from a numpy seed, the JAX hybrid_batch_device PCM)."""
    streams = [_read(n) for n in PADDED]
    host = tb.hybrid_host_stage(streams)
    rng = np.random.default_rng(16)
    S, F = host[0].shape[:2]
    mix = rng.integers(0, 1 << 16, (S, F)).astype(np.int32)
    vol = rng.integers(0, 4, (S, F)).astype(np.int32)
    want = np.asarray(jax.jit(jb.hybrid_batch_device)(
        host[0], host[1], host[2].astype(np.int32), host[3].astype(bool),
        mix, vol))
    return host, mix, vol, want


@pytest.mark.parametrize("inputs", ["numpy", "tensors"])
def test_hybrid_batch_device_matches_jax(padded, inputs):
    # numpy arrays go to the named device; CPU tensors stay on the CPU,
    # whatever the default device
    host, mix, vol, want = padded
    before = dict(kernels.LAUNCHES)
    if inputs == "numpy":
        got = tb.hybrid_batch_device(*host[:4], mix, vol, device="cpu")
    else:
        got = tb.hybrid_batch_device(*(_t(a) for a in host[:4]), _t(mix),
                                     _t(vol))
    assert kernels.LAUNCHES == before
    assert got.device.type == "cpu"
    assert got.shape == want.shape == (3, 196, 240)
    assert np.array_equal(want & 0xFFFF, got.numpy())


@pytest.mark.parametrize("name", NAMES94)
def test_hybrid_stage_matches_reference_decoder(name):
    s = _read(name)
    r = native.decode_dense(s)
    mix, vol = tfs.trace_standalone(s, r.n_frames, tfs.rd.OS94, 0x64, 0x67)
    pcm = tb.hybrid_stage_device(r.dense, r.scale, r.fb_idx, r.valid, mix,
                                 vol, device="cpu")
    assert pcm.shape == (r.n_frames, 240)
    want = tfs.reference_pcm(s, r.n_frames, tfs.rd.OS94, 0x64, 0x67)
    assert np.array_equal(want, pcm.numpy().astype(np.int16).reshape(-1))
    assert np.abs(want).max() > 0


def test_hybrid_equals_the_flat_sweep():
    # the same mix and volume columns (FlatSweep's trace) through both
    # paths: the hybrid's PCM equals the flat sweep's on every real frame
    streams = [_read(n) for n in PADDED]
    sw = tfs.FlatSweep(streams).pack()
    arrays = sw.compact_host_arrays()
    flat = tfs.FlatPipeline("cpu")(
        **tfs.packed_to_device(arrays, "cpu")).numpy()
    dense, scale, fb_idx, valid, n_frames = tb.hybrid_host_stage(streams)
    S, F = dense.shape[:2]
    mix = np.zeros((S, F), np.int32)
    vol = np.zeros((S, F), np.int32)
    starts = np.cumsum([0] + n_frames)
    for k, n in enumerate(n_frames):
        mix[k, :n] = arrays["mix_u16"][starts[k]:starts[k + 1]]
        vol[k, :n] = arrays["vol_u8"][starts[k]:starts[k + 1]]
    pcm = tb.hybrid_batch_device(dense, scale, fb_idx, valid, mix, vol,
                                 device="cpu").numpy()
    got = np.concatenate([pcm[k, :n] for k, n in enumerate(n_frames)])
    assert np.array_equal(flat, got)


def test_numpy_inputs_go_to_the_card():
    r = native.decode_dense(_read("tone_low"))
    F = r.n_frames
    args = (r.dense, r.scale, r.fb_idx, r.valid, np.zeros(F, np.int32),
            np.zeros(F, np.int32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tb.hybrid_stage_device(*args)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tb.hybrid_batch_device(*(a[None] for a in args))
    else:
        assert tb.hybrid_stage_device(*args).is_cuda
    # the kernel's wrapper takes CUDA tensors only
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.dequant_mix_dense(*(_t(a) for a in args[:5]))
