"""The port's device encoder (dcsexplorer_tpu_torch/encoder/device94.py) on
the CPU against the JAX package: each stage's plain version (analysis, the
slot tables, the decision tables, the scan/sizes/packed rows) and the whole
path, all bit for bit or byte for byte.  The JAX programs run on the CPU as
the JAX suite runs them (tests/test_encoder_device.py, whose helpers and
shapes these tests reuse).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcsexplorer_tpu.encoder import core94 as j_c94
from dcsexplorer_tpu.encoder import device94 as j_d94
from dcsexplorer_tpu.encoder import encoder as j_enc
from dcsexplorer_tpu_torch.encoder import core94 as t_c94
from dcsexplorer_tpu_torch.encoder import device94 as t_d94
from dcsexplorer_tpu_torch.encoder import encoder as t_enc
from tests.test_encoder_device import (PARAM_SETS, _adversarial_pcm, _ci,
                                       _corpus)

DEFAULT_SLOTS = ((0, 0), (1, 0), (1, 3))


def _port_params(params):
    return t_enc.CompressionParams(**dataclasses.asdict(params))


@pytest.fixture(scope="module")
def cis():
    return [_ci(p) for p in _corpus()]


@pytest.fixture(scope="module")
def encoders():
    """slots -> the port's module on the CPU (built from the port's own
    tables)."""
    cache = {}

    def get(slots):
        if slots not in cache:
            cache[slots] = t_d94.DeviceEncoder94.for_slots(list(slots), "cpu")
        return cache[slots]
    return get


def _batch_arrays(cis, params, slots):
    """The padded batch (numpy) as both packages' programs take it."""
    fmax = j_d94._bucket(max(c.shape[0] for c in cis))
    ci = np.zeros((len(cis), fmax, 255), np.int32)
    for i, c in enumerate(cis):
        ci[i, :c.shape[0]] = c
    nf = np.asarray([c.shape[0] for c in cis], np.int32)
    _, arrs = j_d94.setup_compact(cis, params, slots)
    return ci, nf, arrs


def _run_port(enc, x, nf, arrs):
    t = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in arrs.items() if k != "sil_max"}
    return enc(torch.from_numpy(x), torch.from_numpy(nf),
               int(arrs["sil_max"]), t["keep"], t["thr"], t["dlim"],
               t["cape"], t["hdr_scale"], t["wanted"]).numpy()


# ----------------------------------------------------------------------
# analysis

def test_analyze94_equals_the_device_and_host_analysis():
    pcms = _adversarial_pcm()
    fmax = max(j_enc.frames_from_pcm_raw(p).shape[0] for p in pcms)
    pad = np.zeros((len(pcms), fmax * 240 + 240), np.int16)
    for i, p in enumerate(pcms):
        pad[i, :p.size] = p
    fq = torch.from_numpy(t_enc.forward_matrix_q())
    got = t_d94.analyze94(torch.from_numpy(pad), fq).numpy()
    jax_ci = np.asarray(jax.jit(
        lambda x: j_d94._analyze_device(x, fmax))(jnp.asarray(pad)))
    np.testing.assert_array_equal(got, jax_ci)
    for i, p in enumerate(pcms):
        frames = j_enc.frames_from_pcm_raw(p)
        np.testing.assert_array_equal(
            got[i, :frames.shape[0]], j_enc.analyze_frames_canonical(frames),
            err_msg=f"adversarial input {i}")


@pytest.mark.parametrize("matrix", ["min", "max", "random"])
def test_analyze94_is_exact_for_any_int16_matrix(matrix):
    """The analysis's contract holds for every int16 matrix, -32768 entries
    included (the kernel's pair sums reach 2^31 there): against an int64
    numpy product of the same frames."""
    rng = np.random.default_rng(11)
    fq = {"min": np.full((256, 255), -32768),
          "max": np.full((256, 255), 32767),
          "random": rng.integers(-32768, 32768, size=(256, 255))}[matrix]
    fq = fq.astype(np.int16)
    fmax = 3
    pcm = np.concatenate([
        np.full((1, fmax * 240 + 240), -32768),
        np.full((1, fmax * 240 + 240), 32767),
        rng.integers(-32768, 32768, size=(2, fmax * 240 + 240))])
    pcm = pcm.astype(np.int16)
    got = t_d94.analyze94(torch.from_numpy(pcm),
                          torch.from_numpy(fq)).numpy()
    frames = np.stack([pcm[:, f * 240:f * 240 + 256] for f in range(fmax)],
                      axis=1).astype(np.int64)
    want = np.clip((frames @ fq.astype(np.int64) + (1 << 20)) >> 21,
                   -(1 << 20), 1 << 20)
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------------
# slot tables and decisions

@pytest.mark.parametrize("slots", [DEFAULT_SLOTS, ((0, 3), (1, 3))])
def test_derive_luts_equals_reference(encoders, slots):
    rng = np.random.default_rng(4)
    B, K = 3, len(slots)
    hdr = rng.integers(0, 256, size=(B, K, 16)).astype(np.uint8)
    keep = np.arange(16)[None] < np.asarray([[1], [9], [16]])
    tabs = dict(encoders(slots).named_buffers())
    got = t_d94.derive_luts(torch.from_numpy(hdr), torch.from_numpy(keep),
                            tabs)
    jtabs = j_d94._static_format_tables(list(slots))
    for b in range(B):
        want = j_d94._derive_luts(jnp.asarray(hdr[b]), jnp.asarray(keep[b]),
                                  jtabs)
        for g, w in zip(got, want[:4]):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))


@pytest.mark.parametrize("pi", range(len(PARAM_SETS)))
def test_decide94_equals_the_numpy_core(cis, encoders, pi):
    params = PARAM_SETS[pi]
    slots = j_d94._select_formats(params)
    ci, nf, arrs = _batch_arrays(cis, params, slots)
    tabs = dict(encoders(slots).named_buffers())
    t = {k: torch.from_numpy(np.ascontiguousarray(arrs[k]))
         for k in ("keep", "thr", "dlim", "cape", "hdr_scale")}
    out15, out14, silent = t_d94.decide94(
        torch.from_numpy(ci), int(arrs["sil_max"]), t["keep"], t["thr"],
        t["dlim"], t["cape"], t["hdr_scale"], tabs)
    assert out15.dtype == torch.uint8 and silent.dtype == torch.bool
    for i, c in enumerate(cis):
        F = c.shape[0]
        st = j_c94.setup94(c, params, wanted=list(slots))
        for k, fs in enumerate(st.formats):
            w15, w14, wsil = j_c94.decision_tables_np(c, st, fs)
            n_p = fs.n_p if fs.fmt_type == 1 else 1
            np.testing.assert_array_equal(
                out15[i, k, :F, :, :n_p].numpy(), w15[:, :, :n_p])
            np.testing.assert_array_equal(
                out14[i, k, :F, :, :n_p].numpy(), w14[:, :, :n_p])
            np.testing.assert_array_equal(silent[i, :F].numpy(), wsil)
    # past band 2 every column repeats column 0; out14 never holds 15
    assert torch.equal(out15[..., 3:, :],
                       out15[..., 3:, :1].expand_as(out15[..., 3:, :]))
    assert int(out14.max()) <= 14


# ----------------------------------------------------------------------
# scan, sizes and packed rows against the JAX program's whole rows

@pytest.mark.parametrize("pi", range(len(PARAM_SETS)))
def test_packed_rows_equal_the_jax_program(cis, encoders, pi):
    params = PARAM_SETS[pi]
    slots = j_d94._select_formats(params)
    ci, nf, arrs = _batch_arrays(cis, params, slots)
    if pi == 0:
        arrs["wanted"][1, 0] = False       # a slot the caller does not want
    want = np.asarray(j_d94._compiled(ci.shape[1], slots, False)(
        jnp.asarray(ci), jnp.asarray(nf), arrs["sil_max"],
        jnp.asarray(arrs["keep"]), jnp.asarray(arrs["thr"]),
        jnp.asarray(arrs["dlim"]), jnp.asarray(arrs["cape"]),
        jnp.asarray(arrs["hdr_scale"]), jnp.asarray(arrs["wanted"])))
    got = _run_port(encoders(slots), ci, nf, arrs)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_code_15_after_a_silent_frame(encoders):
    """A band silent in frame 0 and out of every window but code 15's in
    frame 1: after the 0 the scan takes the out14 row (14), so the delta
    stays inside the delta table (-16..14)."""
    # type 0 (the code is the width); every band up to 15 kept; a bit
    # budget so large that the header scale codes give scale factor 1
    params = j_enc.CompressionParams(stream_format_type=0,
                                     power_band_cutoff=1.0,
                                     target_bit_rate=10_000_000)
    slots = j_d94._select_formats(params)
    ci = np.zeros((4, 255), np.int32)
    b = 5
    s0 = int(j_c94.BAND_START[b])
    rng = np.random.default_rng(1)
    ci[:, :] = rng.integers(-300, 300, size=(4, 255))
    ci[0, s0:s0 + 16] = 7                  # silent
    ci[1, s0:s0 + 16] = np.where(np.arange(16) % 2, 1 << 20, -(1 << 20))
    ci[2, s0:s0 + 16] = ci[1, s0:s0 + 16]
    x, nf, arrs = _batch_arrays([ci], params, slots)
    enc = encoders(slots)
    t = {k: torch.from_numpy(np.ascontiguousarray(arrs[k]))
         for k in ("keep", "thr", "dlim", "cape", "hdr_scale", "wanted")}
    tabs = dict(enc.named_buffers())
    out15, out14, silent = t_d94.decide94(
        torch.from_numpy(x), int(arrs["sil_max"]), t["keep"], t["thr"],
        t["dlim"], t["cape"], t["hdr_scale"], tabs)
    assert bool(silent[0, 0, b]) and not bool(silent[0, 1, b])
    assert int(out15[0, 0, 1, b, 0]) == 15 and int(out14[0, 0, 1, b, 0]) == 14
    row = _run_port(enc, x, nf, arrs)[0]
    codes = row[4 * len(slots) + 1:][:x.shape[1] * 16].reshape(-1, 16)
    assert codes[0, b] == 0 and codes[1, b] == 14 and codes[2, b] == 15
    want = np.asarray(j_d94._compiled(x.shape[1], slots, False)(
        jnp.asarray(x), jnp.asarray(nf), arrs["sil_max"],
        jnp.asarray(arrs["keep"]), jnp.asarray(arrs["thr"]),
        jnp.asarray(arrs["dlim"]), jnp.asarray(arrs["cape"]),
        jnp.asarray(arrs["hdr_scale"]), jnp.asarray(arrs["wanted"])))
    np.testing.assert_array_equal(row, want[0])
    (got,) = t_d94.encode_batch([ci], _port_params(params), device="cpu")
    assert got == j_c94.encode_stream94_np(ci, params)


def test_from_reference_equals_the_ports_own_tables():
    fq = j_enc.forward_matrix_q()
    tabs = j_d94._static_format_tables(list(DEFAULT_SLOTS))
    ref = t_d94.DeviceEncoder94.from_reference(fq, tabs, "cpu")
    own = t_d94.DeviceEncoder94.for_slots(list(DEFAULT_SLOTS), "cpu")
    a, b = dict(ref.named_buffers()), dict(own.named_buffers())
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ----------------------------------------------------------------------
# the entry points

def test_encode_batch_mixed_lengths():
    rng = np.random.default_rng(3)
    cis = [rng.integers(-(1 << 14), 1 << 14, size=(nf, 255)).astype(np.int32)
           for nf in (1, 5, 63, 64, 65, 130)]
    params = j_enc.CompressionParams()
    got = t_d94.encode_batch(cis, _port_params(params), device="cpu")
    assert got == j_d94.encode_batch(cis, params)
    assert got == [j_c94.encode_stream94_np(ci, params) for ci in cis]
    assert got == [t_c94.encode_stream94(ci, _port_params(params))
                   for ci in cis]


def test_encode_files_device_end_to_end():
    rng = np.random.default_rng(5)
    t = np.arange(240 * 40) / 31250.0
    music = np.clip(8000 * np.sin(2 * np.pi * 440 * t)
                    + 4000 * np.sin(2 * np.pi * 659.3 * t)
                    + 200 * rng.standard_normal(t.size),
                    -32768, 32767).astype(np.int16)
    adv = _adversarial_pcm()
    jobs = [(music, 31250), (music[:240 * 7 + 3], 31250), (adv[3], 31250),
            (adv[4], 31250), (music[:240 * 33], 31250),
            (music[:4410].astype(np.float32), 44100)]
    want = j_enc.encode_files(jobs, j_enc.CompressionParams(), workers=1)
    got = t_enc.encode_files_device(jobs, device="cpu")
    assert got == want
    # chunks of 4 (two chunks, each its own bucket) give the same streams
    assert t_d94.encode_jobs_pcm(jobs, t_enc.CompressionParams(),
                                 device="cpu", chunk=4) == want


@pytest.mark.parametrize("call", ["encode_files_device", "encode_batch"])
def test_entry_points_default_to_the_card(call):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if call == "encode_files_device":
            t_enc.encode_files_device([(np.zeros(240, np.int16), 31250)])
        else:
            t_d94.encode_batch([np.zeros((1, 255), np.int32)],
                               t_enc.CompressionParams())


# ----------------------------------------------------------------------
# the coefficient range the kernels take (|ci| <= 2^20)

@pytest.mark.parametrize("bad", [(1 << 20) + 1, -(1 << 20) - 1])
def test_encoder_refuses_coefficients_outside_the_range(encoders, bad):
    rng = np.random.default_rng(4)
    ci = rng.integers(-300, 300, size=(20, 255)).astype(np.int32)
    ci[7, 100] = bad
    params = t_enc.CompressionParams()
    with pytest.raises(ValueError, match="2\\^20"):
        t_d94.encode_batch([np.zeros((3, 255), np.int32), ci], params,
                           device="cpu")
    slots = t_d94._select_formats(params)
    x, nf, arrs = _batch_arrays([ci], j_enc.CompressionParams(), slots)
    with pytest.raises(ValueError, match="2\\^20"):
        _run_port(encoders(slots), x, nf, arrs)


def test_encoder_takes_the_range_ends(encoders):
    """+-2^20 themselves (the reciprocal division's ends, rounding ties
    among them) encode as the native host search does, through
    encode_batch and through the module's int32 form."""
    rng = np.random.default_rng(5)
    ci = rng.integers(-300, 300, size=(20, 255)).astype(np.int32)
    ci[3:6, 40:80] = np.where(np.arange(40) % 2, 1 << 20, -(1 << 20))
    ci[9, :] = -(1 << 20)
    params = t_enc.CompressionParams()
    (got,) = t_d94.encode_batch([ci], params, device="cpu")
    assert got == t_c94.encode_stream94(ci, params)
    slots = t_d94._select_formats(params)
    x, nf, arrs = _batch_arrays([ci], j_enc.CompressionParams(), slots)
    row = _run_port(encoders(slots), x, nf, arrs)
    want = np.asarray(j_d94._compiled(x.shape[1], slots, False)(
        jnp.asarray(x), jnp.asarray(nf), arrs["sil_max"],
        jnp.asarray(arrs["keep"]), jnp.asarray(arrs["thr"]),
        jnp.asarray(arrs["dlim"]), jnp.asarray(arrs["cape"]),
        jnp.asarray(arrs["hdr_scale"]), jnp.asarray(arrs["wanted"])))
    np.testing.assert_array_equal(row, want)
