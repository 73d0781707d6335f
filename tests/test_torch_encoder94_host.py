"""The port's host copies for the 1994+ device encoder against the JAX
package: the analysis matrices, the inverted code tables, the slots' static
tables, the per-stream setup, and the native search and emission, each
equal element for element or byte for byte.  CPU only.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dcsexplorer_tpu.encoder import analysis as j_an
from dcsexplorer_tpu.encoder import core94 as j_c94
from dcsexplorer_tpu.encoder import device94 as j_d94
from dcsexplorer_tpu.encoder import encoder as j_enc
from dcsexplorer_tpu.encoder import resample as j_rs
from dcsexplorer_tpu_torch.encoder import analysis as t_an
from dcsexplorer_tpu_torch.encoder import core94 as t_c94
from dcsexplorer_tpu_torch.encoder import device94 as t_d94
from dcsexplorer_tpu_torch.encoder import encoder as t_enc
from dcsexplorer_tpu_torch.encoder import resample as t_rs
from tests.test_encoder_device import PARAM_SETS, _ci, _corpus

SLOT_LISTS = [((0, 0), (1, 0), (1, 3)), ((0, 0),), ((0, 3),), ((1, 0),),
              ((1, 3),), ((0, 3), (1, 3)), ((1, 0), (1, 3))]


def _port_params(params):
    return t_enc.CompressionParams(**dataclasses.asdict(params))


@pytest.fixture(scope="module")
def cis():
    return [_ci(p) for p in _corpus()]


def test_forward_matrix_q_equals_reference():
    got = t_enc.forward_matrix_q()
    want = j_enc.forward_matrix_q()
    assert got.dtype == np.int16 and got.shape == (256, 255)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["decoder_matrix", "forward_matrix"])
def test_analysis_matrices_equal_reference(name):
    np.testing.assert_array_equal(getattr(t_an, name)(),
                                  getattr(j_an, name)())


def test_encoder_window_equals_reference():
    np.testing.assert_array_equal(t_enc._encoder_window(),
                                  j_enc._encoder_window())


@pytest.mark.parametrize("name", [
    "CB_CODE", "CB_BITS", "TZ_CODE", "TZ_BITS", "BITS_B0", "BITS_T",
    "BITS_D", "DELTA_VAL", "DELTA_BITS", "DELTA_LO", "PMAX", "BAND_SIZES",
    "BAND_START", "BAND_OF", "POS_IN_BAND", "NOT_BAND_LAST", "WRAP_CMAX",
    "D_CLAMP", "FORMATS", "_SCALE64"])
def test_code_tables_equal_reference(name):
    got, want = getattr(t_c94, name), getattr(j_c94, name)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("slots", SLOT_LISTS)
def test_static_format_tables_equal_reference(slots):
    for got, want in zip(t_d94._static_format_tables(list(slots)),
                         j_d94._static_format_tables(list(slots)),
                         strict=True):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pi", range(len(PARAM_SETS)))
def test_select_formats_and_setup_equal_reference(cis, pi):
    params = PARAM_SETS[pi]
    slots = j_d94._select_formats(params)
    assert t_d94._select_formats(_port_params(params)) == slots
    for ci in cis:
        got = t_c94.setup94(ci, _port_params(params), wanted=list(slots))
        want = j_c94.setup94(ci, params, wanted=list(slots))
        for f in ("n_frames", "bands_keep", "sil_max"):
            assert getattr(got, f) == getattr(want, f), f
        np.testing.assert_array_equal(got.thr, want.thr)
        assert len(got.formats) == len(want.formats)
        for g, w in zip(got.formats, want.formats):
            for f in dataclasses.fields(w):
                a, b = getattr(g, f.name), getattr(w, f.name)
                if isinstance(b, np.ndarray):
                    assert a.dtype == b.dtype, f.name
                    np.testing.assert_array_equal(a, b, err_msg=f.name)
                else:
                    assert a == b, f.name
    # the compact device arrays of the whole batch
    _, got = t_d94.setup_compact(cis, _port_params(params), slots)
    _, want = j_d94.setup_compact(cis, params, slots)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("f", [1, 15, 16, 17, 261, 272, 273])
def test_bucket_equals_reference(f):
    assert t_d94._bucket(f) == j_d94._bucket(f)


def test_pcm_helpers_equal_reference():
    rng = np.random.default_rng(2)
    pcm = rng.normal(0, 8000, 44100 // 10).astype(np.float32)
    np.testing.assert_array_equal(t_rs.resample(pcm, 44100, 31250),
                                  j_rs.resample(pcm, 44100, 31250))
    for rate in (31250, 44100, 22050):
        got = t_enc.pcm_to_int16(pcm, rate)
        np.testing.assert_array_equal(got, j_enc.pcm_to_int16(pcm, rate))
        frames = t_enc.frames_from_pcm_raw(got)
        np.testing.assert_array_equal(frames, j_enc.frames_from_pcm_raw(got))
        np.testing.assert_array_equal(
            t_enc.analyze_frames_canonical(frames),
            j_enc.analyze_frames_canonical(frames))


@pytest.mark.parametrize("pi", range(len(PARAM_SETS)))
def test_native_search_and_emit_equal_reference(cis, pi):
    from dcsexplorer_tpu import native as j_native
    from dcsexplorer_tpu_torch import native as t_native
    params = PARAM_SETS[pi]
    for ci in cis:
        st = j_c94.setup94(ci, params)
        formats = j_c94.skip_dup_format(st.formats)
        want = j_native.encode94_search(ci, formats, st.bands_keep, st.thr,
                                        st.sil_max)
        got = t_native.encode94_search(ci, formats, st.bands_keep, st.thr,
                                       st.sil_max)
        assert got == want
        assert (t_c94.encode_stream94(ci, _port_params(params))
                == j_c94.encode_stream94_np(ci, params))
        # emission of every candidate from the numpy core's own codes
        for fs in formats:
            b15, b14, silent = j_c94.decision_tables_np(ci, st, fs)
            codes, pidx = j_c94.scan_codes_np(b15, b14, silent, st, fs)
            assert (t_native.emit94_with_codes(ci, fs, codes, pidx,
                                               st.bands_keep)
                    == j_native.emit94_with_codes(ci, fs, codes, pidx,
                                                  st.bands_keep))


def test_select_kernel_delta_origin_equals_the_delta_table():
    """csrc/encode94_select.cu indexes the delta table by delta - kDeltaLo:
    its constant is the table's first delta."""
    import os
    import re
    src = os.path.join(os.path.dirname(t_d94.__file__), os.pardir, "csrc",
                       "encode94_select.cu")
    with open(src) as f:
        m = re.search(r"constexpr int kDeltaLo = (-?\d+);", f.read())
    assert m and int(m.group(1)) == t_c94.DELTA_LO == j_c94.DELTA_LO


def test_native_emit_raises_on_a_delta_outside_the_table():
    from dcsexplorer_tpu_torch import native as t_native
    ci = np.zeros((2, 255), np.int32)
    st = t_c94.setup94(ci, t_enc.CompressionParams())
    codes = np.zeros((2, 16), np.int8)
    codes[1, 0] = 15                       # +15 after a 0: not in the table
    with pytest.raises(RuntimeError, match="native emit failed"):
        t_native.emit94_with_codes(ci, st.formats[0], codes,
                                   np.zeros_like(codes), 16)


def test_integer_rdiv_equals_the_canonical_float32_form():
    """device94.rdiv_int (the plain versions' and the kernels' integer
    quantizer) against core94.rdiv (the exact-floor float32 form) over
    |a| <= 2^20 and every scale factor the decoder's rule gives."""
    rng = np.random.default_rng(6)
    a = np.concatenate([np.arange(-4096, 4097),
                        rng.integers(-(1 << 20), (1 << 20) + 1, 20000),
                        [-(1 << 20), 1 << 20]]).astype(np.int32)
    for s in sorted(set(int(x) for x in t_c94._SCALE64)):
        want = t_c94.rdiv(a, np.int32(s))
        np.testing.assert_array_equal(want, j_c94.rdiv(a, np.int32(s)))
        got = t_d94.rdiv_int(torch.from_numpy(a), torch.tensor(s)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"s = {s}")
