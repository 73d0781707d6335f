"""Native host runtime of the port: the C++ stream indexer and dense
symbol decode, VM tracer, 1994+ encoder core, 1993 stream encoder, the
FLAC / MP3 / Ogg Vorbis input decoders and the ADSP-2105 emulator core.

At first use, g++ builds ``build/torch_native/libdcs_host.so`` from
``src/dcs_native.cpp`` (the stream indexers of the 1994+ and the 1993
families, and the 1994+ dense symbol decode of the host-decode hybrid,
``decode_dense``), ``src/tracer.cpp`` (the runtime VM tracer),
``src/encoder94.cpp`` (the 1994+ format search and symbol emission),
``src/encoder93.cpp`` (the 1993 stream encoder), ``src/flac.cpp``,
``src/mp3.cpp`` and ``src/vorbis.cpp`` (the audio readers of
``utils/audioio.py``, with their committed table headers
``src/mp3_tables.h`` and ``src/vorbis_tables.h``) and ``src/adsp2105.cpp``
(the emulator's CPU core with the DCS board map, ``emu/native_cpu.py``),
with a table header that ``gen_tables`` writes from the port's own
``format/tables.py``.  The audio decoders and the emulator core are
byte-identical copies of the JAX package's sources.  One g++ compiles
each source, all started together, and one links them.  It rebuilds when
a source is newer than the library.  The flags are plain ``-O3`` without
``-march``, so one build runs on any x86-64 host, and
``-ffp-contract=off``, so the 1993 encoder's double error sums round as
the JAX package's numpy does.  A failed build raises: there is no Python
fallback behind this module.
"""

import ctypes as C
import fcntl
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import gen_tables

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(os.path.dirname(_HERE))
BUILD_DIR = os.path.join(_REPO, "build", "torch_native")
LIB_PATH = os.path.join(BUILD_DIR, "libdcs_host.so")
SOURCES = ("dcs_native.cpp", "tracer.cpp", "encoder94.cpp", "encoder93.cpp",
           "flac.cpp", "mp3.cpp", "vorbis.cpp", "adsp2105.cpp")
HEADERS = ("mp3_tables.h", "vorbis_tables.h")
GXX_FLAGS = ("-O3", "-ffp-contract=off", "-fPIC", "-shared", "-std=c++17")

_P, _I, _LL = C.c_void_p, C.c_int, C.c_longlong
# the emulator board's callbacks: read the data port, write it, set the bank
READ_PORT = C.CFUNCTYPE(C.c_uint16)
WRITE_PORT = C.CFUNCTYPE(None, C.c_uint16)
SET_BANK = C.CFUNCTYPE(None, C.c_uint32)
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
    "dcstr_trace_rows": (C.c_int, [_P, _I, _P, _P, _I, _P, _P, _I]
                         + [_P] * 3),
    "dcstr_read_host": (C.c_int, [_P, _P, _I]),
    "dcstr_trace_segs": (C.c_int, [_P, _I, _P, _P, _I, _P, _P, _I, _I, _I]
                         + [_P] * 5),
    "dcstr_trace_segs_batch": (C.c_int, [_P, _I, _I, _P, _P, _P, _P, _P, _I,
                                         _I, _I] + [_P] * 5),
    # the wide wire's batch: base uint32, the arguments as the one above
    "dcstr_trace_segs32_batch": (C.c_int, [_P, _I, _I, _P, _P, _P, _P, _P,
                                           _I, _I, _I] + [_P] * 5),
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
    # data, len, meta[4] (rate, channels, bits, -), total[1]
    "flac_info": (_I, [C.c_char_p, C.c_int64, _P, _P]),
    "flac_decode": (C.c_int64, [C.c_char_p, C.c_int64, _P, C.c_int64]),
    # data, len, meta[4] (rate, channels, frames, -)
    "mp3_info": (_I, [C.c_char_p, C.c_int64, _P]),
    "mp3_decode": (C.c_int64, [C.c_char_p, C.c_int64, _P, C.c_int64]),
    # data, len, meta[4] (rate, channels, -, -)
    "vorbis_probe": (_I, [C.c_char_p, C.c_int64, _P]),
    "vorbis_decode": (C.c_int64, [C.c_char_p, C.c_int64, _P, C.c_int64]),
    "vorbis_imdct_selftest": (C.c_double, [_I, _P, _P, _P]),
    # the ADSP-2105 core with the DCS board map (emu/native_cpu.py)
    "adsp_new": (_P, []),
    "adsp_free": (None, [_P]),
    "adsp_reset": (None, [_P]),
    "adsp_get_state": (None, [_P, _P]),
    "adsp_set_state": (None, [_P, _P]),
    "adsp_config_board": (None, [_P, _I, READ_PORT, WRITE_PORT, SET_BANK]),
    "adsp_set_bank_window": (None, [_P, _P, C.c_int64]),
    "adsp_get_pm": (C.c_uint32, [_P, _I]),
    "adsp_set_pm": (None, [_P, _I, C.c_uint32]),
    "adsp_read_pm_block": (None, [_P, _I, _I, _P]),
    "adsp_write_pm_block": (None, [_P, _I, _I, _P]),
    "adsp_get_dm": (C.c_uint16, [_P, _I]),
    "adsp_set_dm": (None, [_P, _I, C.c_uint32]),
    "adsp_read_dm_block": (None, [_P, _I, _I, _P]),
    "adsp_write_dm_block": (None, [_P, _I, _I, _P]),
    "adsp_read_dm_strided": (None, [_P, _I, _I, _I, _P]),
    "adsp_run": (C.c_int64, [_P, C.c_int64]),
    "adsp_step": (_I, [_P]),
    "adsp_stopped": (_I, [_P]),
    "adsp_set_stopped": (None, [_P, _I]),
    "adsp_take_reset_request": (_I, [_P]),
    "adsp_get_pc": (C.c_uint32, [_P]),
    "adsp_set_pc": (None, [_P, C.c_uint32]),
    "adsp_invoke_irq": (C.c_int64, [_P, _I, _I, C.c_int64]),
    "adsp_get_autobuffer": (None, [_P, _P]),
    "adsp_set_autobuffer": (None, [_P, C.c_int32, C.c_int32, C.c_int32]),
    "adsp_rword_pgm": (C.c_uint32, [_P, C.c_uint32]),
    "adsp_set_speedup": (None, [_P, _I, _I, _I, _P, _I]),
    "adsp_accel_run": (None, [_P, _I, _P, _I]),
}

_lib = None


def build():
    """Compile the library unless it is newer than every source and the
    table generator.  Returns True when it compiled.  Raises on failure.
    One process builds at a time (a lock file beside the library); one
    that waited finds the library fresh and returns."""
    srcs = [os.path.join(_HERE, "src", f) for f in SOURCES]
    deps = srcs + [os.path.join(_HERE, "src", f) for f in HEADERS] + [
        gen_tables.__file__, gen_tables.T.__file__]

    def fresh():
        return (os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH)
                >= max(map(os.path.getmtime, deps)))

    if fresh():
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if fresh():
            return False
        inc = os.path.join(BUILD_DIR, "inc")
        gen_tables.emit(os.path.join(inc, "dcs_tables.h"))
        tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
        obj_dir = f"{tmp}.o"
        os.makedirs(obj_dir, exist_ok=True)
        objs = [os.path.join(obj_dir, f + ".o") for f in SOURCES]
        try:
            procs = [subprocess.Popen(
                ["g++", *GXX_FLAGS, f"-I{inc}", "-c", s, "-o", o],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for s, o in zip(srcs, objs)]
            errs = [p.communicate()[1] for p in procs]
            for p, err in zip(procs, errs):
                if p.returncode != 0:
                    raise RuntimeError(f"g++ failed ({p.returncode}):\n{err}")
            r = subprocess.run(["g++", *GXX_FLAGS, *objs, "-o", tmp],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(
                    f"g++ failed ({r.returncode}):\n{r.stderr}")
        finally:
            shutil.rmtree(obj_dir, ignore_errors=True)
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


def flac_decode(data):
    """Decode a FLAC file (src/flac.cpp).  Returns (samples [N, channels]
    int32, rate, bits).  Raises ValueError on malformed input."""
    lib = get_lib()
    buf = bytes(data)
    meta = np.zeros(4, dtype=np.int32)
    total = np.zeros(1, dtype=np.int64)
    rc = lib.flac_info(buf, len(buf), meta.ctypes.data_as(C.c_void_p),
                       total.ctypes.data_as(C.c_void_p))
    if rc != 0:
        raise ValueError(f"malformed FLAC file (error {rc})")
    rate, nch, bits, _ = (int(x) for x in meta)
    cap = int(total[0]) * nch if total[0] else 0
    if cap == 0:
        cap = max(len(buf) * 4, 1 << 20)   # unknown length: generous bound
    for _ in range(4):
        out = np.zeros(cap, dtype=np.int32)
        n = lib.flac_decode(buf, len(buf), out.ctypes.data_as(C.c_void_p),
                            cap)
        if n == -3:
            cap *= 4
            continue
        if n < 0:
            raise ValueError(f"malformed FLAC file (error {n})")
        # the frame walker stops at the first bad sync; if STREAMINFO
        # recorded a length, a short decode means corruption, not EOF
        if total[0] and n != int(total[0]) * nch:
            raise ValueError(
                f"truncated or corrupt FLAC: decoded {n // max(nch, 1)} of "
                f"{int(total[0])} samples")
        return out[:n].reshape(-1, nch), rate, bits
    raise ValueError("FLAC decode exceeded the output bound")


def mp3_decode(data):
    """Decode an MPEG-1 Layer III file (src/mp3.cpp).  Returns (samples
    [N, channels] int16, rate).  Raises ValueError on malformed or
    unsupported input."""
    lib = get_lib()
    buf = bytes(data)
    meta = np.zeros(4, dtype=np.int32)
    rc = lib.mp3_info(buf, len(buf), meta.ctypes.data_as(C.c_void_p))
    if rc == -2:
        raise ValueError("unsupported MPEG flavor (MPEG-1 Layer III only)")
    if rc != 0:
        raise ValueError(f"malformed MP3 file (error {rc})")
    rate, nch, frames, _ = (int(x) for x in meta)
    cap = (frames + 2) * 1152 * nch
    out = np.zeros(cap, dtype=np.int16)
    n = lib.mp3_decode(buf, len(buf), out.ctypes.data_as(C.c_void_p), cap)
    if n < 0:
        raise ValueError(f"malformed MP3 file (error {n})")
    return out[:n].reshape(-1, nch), rate


def vorbis_decode(data):
    """Decode an Ogg Vorbis file (src/vorbis.cpp).  Returns (samples
    [N, channels] float32, rate).  Raises ValueError on malformed
    input."""
    lib = get_lib()
    buf = bytes(data)
    meta = np.zeros(4, dtype=np.int32)
    rc = lib.vorbis_probe(buf, len(buf), meta.ctypes.data_as(C.c_void_p))
    if rc != 0:
        raise ValueError("malformed Ogg Vorbis file")
    rate, nch = int(meta[0]), int(meta[1])
    total = lib.vorbis_decode(buf, len(buf), None, 0)
    if total < 0:
        raise ValueError("malformed Ogg Vorbis file")
    out = np.zeros(int(total) * nch, dtype=np.float32)
    n = lib.vorbis_decode(buf, len(buf), out.ctypes.data_as(C.c_void_p),
                          total)
    if n < 0:
        raise ValueError("malformed Ogg Vorbis file")
    return out[:int(n) * nch].reshape(-1, nch), rate
