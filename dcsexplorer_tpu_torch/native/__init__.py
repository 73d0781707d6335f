"""Native host runtime of the port: the C++ stream indexer and dense
symbol decode, VM tracer, 1994+ encoder core and 1993 stream encoder.

At first use, g++ builds ``build/torch_native/libdcs_host.so`` from
``src/dcs_native.cpp`` (the stream indexers of the 1994+ and the 1993
families, and the 1994+ dense symbol decode of the host-decode hybrid,
``decode_dense``), ``src/tracer.cpp`` (the runtime VM tracer) and
``src/encoder94.cpp`` (the 1994+ format search and symbol emission) and
``src/encoder93.cpp`` (the 1993 stream encoder), with a table header that ``gen_tables`` writes from
the port's own ``format/tables.py``.  It rebuilds when a source is newer
than the library.  The flags are plain ``-O3`` without ``-march``, so one
build runs on any x86-64 host, and ``-ffp-contract=off``, so the 1993
encoder's double error sums round as the JAX package's numpy does.  A failed build raises: there is no Python
fallback behind this module.
"""

import ctypes as C
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import gen_tables

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(os.path.dirname(_HERE))
BUILD_DIR = os.path.join(_REPO, "build", "torch_native")
LIB_PATH = os.path.join(BUILD_DIR, "libdcs_host.so")
SOURCES = ("dcs_native.cpp", "tracer.cpp", "encoder94.cpp", "encoder93.cpp")
GXX_FLAGS = ("-O3", "-ffp-contract=off", "-fPIC", "-shared", "-std=c++17")

_P, _I, _LL = C.c_void_p, C.c_int, C.c_longlong
_SIGNATURES = {
    "dcs94_frame_count": (C.c_int, [C.c_char_p, _I, _I]),
    "dcs94_decode_dense": (C.c_int, [C.c_char_p, _I, _I] + [_P] * 10),
    "dcs93_index": (C.c_int, [C.c_char_p, _I, _I] + [_P] * 11),
    "dcs93a_index": (C.c_int, [C.c_char_p, _I, _I] + [_P] * 5),
    "dcstr_create": (_P, [_I] * 5),
    "dcstr_destroy": (None, [_P]),
    "dcstr_add_chip": (None, [_P, _I, C.c_char_p, C.c_int64]),
    "dcstr_set_catalog": (None, [_P, C.c_int64, C.c_int64, _I, _I]),
    "dcstr_soft_boot": (None, [_P]),
    "dcstr_full_reset": (None, [_P]),
    "dcstr_load_stream": (None, [_P, _I, C.c_uint, _I, _I]),
    "dcstr_write_port": (None, [_P, _I]),
    "dcstr_trace": (C.c_int, [_P, _I, _P, _P, _I] + [_P] * 4),
    "dcstr_trace_segs": (C.c_int, [_P, _I, _P, _P, _I, _P, _P, _I, _I, _I]
                         + [_P] * 5),
    "dcstr_trace_segs_batch": (C.c_int, [_P, _I, _I, _P, _P, _P, _P, _P, _I,
                                         _I, _I] + [_P] * 5),
    # ci, F, NF, PMAX, w_lut, sf_lut, amin, amax, pip, dep, n_p, thr,
    # bands_keep, sil_max, band_sizes, delta_lo, delta_len, delta_val,
    # delta_bits, cb_code, cb_bits, tz_code, tz_bits, out, out_cap, winner
    "dcs94_encode_search": (_LL, [_P, _I, _I, _I] + [_P] * 7
                            + [_P, _I, _I, _P, _I, _I] + [_P] * 6
                            + [_P, _LL, _P]),
    # ci, F, PMAX, w_lut, sf_lut, codes, pidx, bands_keep, band_sizes,
    # delta_lo, delta_len, delta_val, delta_bits, cb_code, cb_bits,
    # tz_code, tz_bits, out, out_cap
    "dcs94_emit_with_codes": (_LL, [_P, _I, _I] + [_P] * 4
                              + [_I, _P, _I, _I] + [_P] * 6 + [_P, _LL]),
    # tx, F, fmt_type, bands_keep, counts, bstart, scales, max_err,
    # huff_cw, huff_nb, out, out_cap
    "dcs93_encode_stream": (_LL, [_P, _I, _I, _I] + [_P] * 3 + [C.c_double]
                            + [_P] * 2 + [_P, _LL]),
}

_lib = None


def build():
    """Compile the library unless it is newer than every source and the
    table generator.  Returns True when it compiled.  Raises on failure."""
    srcs = [os.path.join(_HERE, "src", f) for f in SOURCES]
    deps = srcs + [gen_tables.__file__, gen_tables.T.__file__]
    if (os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= max(map(os.path.getmtime, deps))):
        return False
    inc = os.path.join(BUILD_DIR, "inc")
    gen_tables.emit(os.path.join(inc, "dcs_tables.h"))
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    r = subprocess.run(["g++", *GXX_FLAGS, f"-I{inc}", *srcs, "-o", tmp],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, LIB_PATH)
    return True


def get_lib():
    """Build the library if needed and load it (once per process)."""
    global _lib
    if _lib is None:
        build()
        lib = C.CDLL(LIB_PATH)
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
    return _lib


def _codec_arrays():
    """The 1994+ encoder's inverted code tables, as the C entries take
    them (int32, contiguous)."""
    from ..encoder import core94 as c94
    return [np.ascontiguousarray(a, dtype=np.int32)
            for a in (c94.BAND_SIZES, c94.DELTA_VAL, c94.DELTA_BITS,
                      c94.CB_CODE, c94.CB_BITS, c94.TZ_CODE, c94.TZ_BITS)]


def encode94_search(ci, formats, bands_keep, thr, sil_max):
    """The native stream-format search (src/encoder94.cpp): the whole
    decision pipeline for every FormatSetup candidate, keeping the
    smallest.  ci [F, 255] int32; formats: list of core94.FormatSetup;
    thr [16].  Returns (winner index, body bytes); raises on failure."""
    from ..encoder import core94 as c94
    ci = np.ascontiguousarray(ci, dtype=np.int32)
    F = ci.shape[0]

    def stack(key):
        return np.ascontiguousarray(
            np.stack([getattr(fs, key) for fs in formats]), dtype=np.int32)

    luts = [stack(k) for k in ("w_lut", "sf_lut", "amin_lut", "amax_lut",
                               "pidx_of_prev")]
    dep = np.asarray([fs.fmt_type == 1 for fs in formats], dtype=np.int32)
    n_p = np.asarray([fs.n_p for fs in formats], dtype=np.int32)
    thr = np.ascontiguousarray(thr, dtype=np.int32)
    bsz, dval, dbits, cbc, cbb, tzc, tzb = _codec_arrays()
    cap = F * 600 + 64
    out = np.zeros(cap, dtype=np.uint8)
    winner = np.zeros(1, dtype=np.int32)

    def p(a):
        return a.ctypes.data_as(C.c_void_p)

    n = get_lib().dcs94_encode_search(
        p(ci), F, len(formats), int(c94.PMAX), *[p(a) for a in luts],
        p(dep), p(n_p), p(thr), int(bands_keep), int(sil_max), p(bsz),
        int(c94.DELTA_LO), int(dval.size), p(dval), p(dbits), p(cbc),
        p(cbb), p(tzc), p(tzb), p(out), cap, p(winner))
    if n < 0:
        raise RuntimeError(f"native encode failed: {n}")
    return int(winner[0]), out[:n].tobytes()


def emit94_with_codes(ci, fs, codes, pidx, bands_keep):
    """Emit and pack one stream of the winning format from its per-frame
    band-type codes (the device encoder's result, encoder/device94.py).
    ci [F, 255] int32; fs: core94.FormatSetup; codes/pidx [F, 16].
    Returns the body bytes; raises on failure."""
    from ..encoder import core94 as c94
    ci = np.ascontiguousarray(ci, dtype=np.int32)
    F = ci.shape[0]
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    pidx = np.ascontiguousarray(pidx, dtype=np.int8)
    wl = np.ascontiguousarray(fs.w_lut, dtype=np.int32)
    sl = np.ascontiguousarray(fs.sf_lut, dtype=np.int32)
    bsz, dval, dbits, cbc, cbb, tzc, tzb = _codec_arrays()
    cap = F * 600 + 64
    out = np.zeros(cap, dtype=np.uint8)

    def p(a):
        return a.ctypes.data_as(C.c_void_p)

    n = get_lib().dcs94_emit_with_codes(
        p(ci), F, int(c94.PMAX), p(wl), p(sl), p(codes), p(pidx),
        int(bands_keep), p(bsz), int(c94.DELTA_LO), int(dval.size),
        p(dval), p(dbits), p(cbc), p(cbb), p(tzc), p(tzb), p(out), cap)
    if n < 0:
        raise RuntimeError(f"native emit failed: {n}")
    return out[:n].tobytes()


def encode93_stream(tx, fmt_type, bands_keep, counts, bstart, scales,
                    max_err, huff_cw, huff_nb):
    """The native 1993 stream encode (src/encoder93.cpp): quantization, the
    subtype-0 width search and the body emission in one call.  tx [F, 256]
    float64 transmit-position coefficients; counts, bstart [16]; scales
    [16] float64; huff_cw, huff_nb [64].  Returns the body bytes; raises on
    failure."""
    tx = np.ascontiguousarray(tx, dtype=np.float64)
    F = tx.shape[0]
    arrs = [np.ascontiguousarray(counts, dtype=np.int32),
            np.ascontiguousarray(bstart, dtype=np.int32),
            np.ascontiguousarray(scales, dtype=np.float64)]
    tail = [np.ascontiguousarray(huff_cw, dtype=np.int32),
            np.ascontiguousarray(huff_nb, dtype=np.int32)]
    cap = F * 600 + 64
    out = np.zeros(cap, dtype=np.uint8)

    def p(a):
        return a.ctypes.data_as(C.c_void_p)

    n = get_lib().dcs93_encode_stream(
        p(tx), F, int(fmt_type), int(bands_keep), *[p(a) for a in arrs],
        float(max_err), *[p(a) for a in tail], p(out), cap)
    if n < 0:
        raise RuntimeError(f"native 93 encode failed: {n}")
    return out[:n].tobytes()


class NativeDecode:
    """Result arrays of a native dense decode."""

    __slots__ = ("n_frames", "header", "fmt_type", "sub_type", "error_frame",
                 "max_symbols", "start_bit", "end_bit", "band_type",
                 "band_type_prev", "dense", "scale", "fb_idx", "valid")


def decode_dense(stream):
    """Index + densely decode a 1994+ stream with the native runtime: the
    host half of the host-decode hybrid (models/batched.py).  Per frame,
    256 slots of sample value (int32, u16 storage), scale (int32),
    frame-buffer index (int16) and valid flag (uint8), beside the stream
    index.  Returns a NativeDecode; raises on failure.  (The index alone:
    ops/prescan.prescan94.)"""
    lib = get_lib()
    buf = bytes(stream)
    F = lib.dcs94_frame_count(buf, len(buf), 0)
    if F < 0:
        raise ValueError("stream too short")
    r = NativeDecode()
    r.n_frames = F
    r.header = np.zeros(16, dtype=np.uint8)
    meta = np.zeros(4, dtype=np.int32)
    r.start_bit = np.zeros(F, dtype=np.int64)
    r.end_bit = np.zeros(F, dtype=np.int64)
    r.band_type = np.zeros((F, 16), dtype=np.int32)
    r.band_type_prev = np.zeros((F, 16), dtype=np.int32)
    r.dense = np.zeros((F, 256), dtype=np.int32)
    r.scale = np.zeros((F, 256), dtype=np.int32)
    r.fb_idx = np.zeros((F, 256), dtype=np.int16)
    r.valid = np.zeros((F, 256), dtype=np.uint8)

    def p(a):
        return a.ctypes.data_as(C.c_void_p)

    rc = lib.dcs94_decode_dense(
        buf, len(buf), 0, p(r.header), p(meta),
        p(r.start_bit), p(r.end_bit), p(r.band_type), p(r.band_type_prev),
        p(r.dense), p(r.scale), p(r.fb_idx), p(r.valid))
    if rc != 0:
        raise RuntimeError(f"native decode failed: {rc}")
    r.fmt_type, r.sub_type, r.error_frame, r.max_symbols = (
        int(meta[0]), int(meta[1]), int(meta[2]), int(meta[3]))
    return r


def decode_dense_batch(streams):
    """decode_dense of many streams in parallel host threads (the C calls
    drop the GIL; min(16, cores) of them).  Returns a list of
    NativeDecode."""
    get_lib()                   # build or raise once, before the threads
    workers = min(16, os.cpu_count() or 4)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(decode_dense, streams))
