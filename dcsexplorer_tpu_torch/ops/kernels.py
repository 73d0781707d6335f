"""Build, bind and launch the hand-written CUDA kernels (``csrc/*.cu``).

At first use, nvcc compiles every source of ``csrc/`` for Hopper
(``sm_90a``), one process per source, all at once, and links the objects
into one shared library with a plain C interface,
``build/torch_kernels/libdcs_torch.so``; it rebuilds when a source is newer
than the library.  ctypes loads it; each C entry launches one kernel
on the caller's stream and returns ``cudaGetLastError()``.

Each wrapper checks device, dtype, shape and contiguity, allocates its
output with ``torch.empty``, launches, raises on a non-zero error code, and
counts the launch in ``LAUNCHES``.  The wrappers take CUDA tensors only:
the plain PyTorch versions beside each caller (``ops/band_decode.py``,
``ops/transform.py``) serve CPU tensors.  Nothing is compiled or loaded
until ``build``, ``load`` or a wrapper runs, so the module imports without
nvcc or a card.
"""

import ctypes
import os
import shutil
import subprocess

import torch

from ..utils.profiling import span


_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("decode94_fb.cu", "decode94_bank.cu", "dequant_mix.cu",
           "dequant_mix_dense.cu", "segments94.cu", "session_mix94.cu",
           "transform94.cu", "transform94_pcm.cu", "decode93_fb.cu",
           "transform93_pcm.cu", "decode93_pcm.cu", "decode93_bank.cu",
           "encode94_analyze.cu", "encode94_decide.cu", "encode94_select.cu")
HEADERS = ("dcs_fixmath.cuh", "decode94_walk.cuh", "decode93_bank.cuh",
           "encode94_scale.cuh")
LIB_PATH = os.path.join(_REPO, "build", "torch_kernels", "libdcs_torch.so")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")

# launches per kernel; each wrapper adds one where it launches its kernel
# (x_carry: kernel x's instance with a carried overlap state;
# segments94_rows32: segments94's instance for the wide wire; decode93_pcm
# counts both the columns' instance (the flat sweep) and the session
# instance, decode93_pcm_carry the session instance with a carried state)
LAUNCHES = {"decode94_fb": 0, "decode94_bank": 0, "dequant_mix": 0,
            "dequant_mix_dense": 0, "segments94": 0,
            "segments94_rows32": 0, "session_mix94": 0,
            "transform94_planar": 0, "transform94_pcm": 0, "transform94_pcm_carry": 0,
            "decode93_fb": 0, "transform93_pcm": 0,
            "transform93_pcm_carry": 0, "decode93_pcm": 0,
            "decode93_pcm_carry": 0, "decode93_bank": 0,
            "encode94_analyze": 0,
            "encode94_decide": 0, "encode94_select": 0}

# frames per block of csrc/transform94_pcm.cu, transform93_pcm.cu and
# decode93_pcm.cu (their kTile): a block transforms (and decodes) the frame
# before its tile again for the overlap carry
TRANSFORM94_PCM_TILE = TRANSFORM93_PCM_TILE = 64
DECODE93_PCM_TILE = 63          # with the halo, 8 frames for each of 8 warps
# format slots of the encoder kernels (at most (0,0), (1,0), (1,3))
ENCODE94_MAX_SLOTS = 3
# the encoder kernels' coefficient range (their reciprocal division's)
ENCODE94_CI_LIMIT = 1 << 20

_lib = None

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # pool, pool_len, sid, start_bit, bt_u8, mix, hdr_tab, fmt_tab,
    # sub_tab, n_streams, tables (_FB_TABLES order), out, n_frames,
    # n_steps, stream
    "dcs_decode94_fb": [_P, _LL, _P, _P, _P, _P, _P, _P, _P, _I,
                        *[_P] * 8, _P, _I, _I, _P],
    # pool, pool_len, sid, start_bit, bt_u8, hdr_tab, fmt_tab, sub_tab,
    # n_streams, tables (_FB_TABLES order), out, n_frames, n_steps, stream
    "dcs_decode94_bank": [_P, _LL, _P, _P, _P, _P, _P, _P, _I,
                          *[_P] * 8, _P, _I, _I, _P],
    # wire, n_sessions, n_frames, n_ch, n_seg, rows, mix, vol, stream
    "dcs_segments94": [_P, _I, _I, _I, _I, _P, _P, _P, _P],
    # the same on the wide wire (u32 base)
    "dcs_segments94_rows32": [_P, _I, _I, _I, _I, _P, _P, _P, _P],
    # bank, n_rows, rows, mix, out, n_frames, n_ch, stream
    "dcs_session_mix94": [_P, _I, _P, _P, _P, _I, _I, _P],
    # pos_vals, scale, total, mix, fb_prev (nullable), out,
    # n_frames, n_slots, stream
    "dcs_dequant_mix": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    # dense, scale, fb_idx, valid, mix, fb_prev (nullable), active
    # (nullable), out, n_frames, stream
    "dcs_dequant_mix_dense": [*[_P] * 8, _I, _P],
    # fb, vol_shift, p2_c0, p2_c1, cos, sin, out_re, out_im, n_frames, stream
    "dcs_transform94_planar": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    # fb, vol_shift, sid, tables (_PCM_TABLES order), overlap0 (nullable),
    # last_ov (nullable), n_groups, pcm, n_frames, stream
    "dcs_transform94_pcm": [_P, _P, _P, *[_P] * 8, _P, _P, _I, _P, _I, _P],
    # pool, pool_len, frame_word, sid, kind_u8, kw_u8, bit_rel, prv,
    # code_u8, band_tab, n_streams, pair, inputs, rows (nullable), mix, out,
    # n_frames, n_ch, n_rows, stream
    "dcs_decode93_fb": [_P, _LL, *[_P] * 8, _I, _P, _P, _P, _P, _P, _I, _I,
                        _I, _P],
    # fb, vol_shift, sid, tables (_PCM93_TABLES order), overlap0 (nullable),
    # last_ov (nullable), n_groups, pcm, n_frames, stream
    "dcs_transform93_pcm": [_P, _P, _P, *[_P] * 5, _P, _P, _I, _P, _I, _P],
    # the columns as dcs_decode93_fb (pool .. pair, inputs), mix,
    # vol_shift, sid (of each output frame), tables (_DECODE93_PCM_TABLES
    # order), pcm, n_frames, stream
    "dcs_decode93_pcm": [_P, _LL, *[_P] * 8, _I, _P, _P, _P, _P, _P,
                         *[_P] * 4, _P, _I, _P],
    # words93, kind93, n_rows, inputs, rows, mix, vol_shift, sid, tables
    # (_DECODE93_PCM_TABLES order), overlap0 (nullable), last_ov
    # (nullable), n_groups, pcm, n_frames, n_ch, stream
    "dcs_decode93_pcm_bank": [_P, _P, _I, *[_P] * 5, *[_P] * 4, _P, _P, _I,
                              _P, _I, _I, _P],
    # the columns as dcs_decode93_fb (pool .. pair, inputs), words93,
    # kind93, n_rows, stream
    "dcs_decode93_bank": [_P, _LL, *[_P] * 8, _I, _P, _P, _P, _P, _I, _P],
    # mismatch count (uint64 on the card), stream
    "dcs_normalize93_check": [_P, _P],
    # pcm, fq, ci, n_streams, fmax, stream
    "dcs_encode94_analyze": [_P, _P, _P, _I, _I, _P],
    # eight ints out (encode94_analyze_geometry's keys)
    "dcs_encode94_analyze_geometry": [_P],
    # ci, hdr_scale, keep, tables (_check_encoder_tables' first five), thr,
    # dlim, cape,
    # sil_max, out15, out14, silent, n_streams, K, fmax, stream
    "dcs_encode94_decide": [_P, _P, _P, *[_P] * 5, _P, _P, _P, _I, _P, _P,
                            _P, _I, _I, _I, _P],
    # six ints out (frames and threads a block, static shared bytes,
    # registers, resident blocks an SM, SMs)
    "dcs_encode94_decide_geometry": [_P],
    # scale_mant, mismatch count (uint64 on the card), stream
    "dcs_encode94_rdiv_check": [_P, _P, _P],
    # ci, out15, out14, silent, nf, keep, hdr_scale, wanted, tables
    # (_check_encoder_tables' ten), delta_len, codes, pidx, nbits, done,
    # packed, n_streams, K, fmax, stream
    "dcs_encode94_select": [*[_P] * 8, *[_P] * 10, _I, *[_P] * 5, _I, _I, _I,
                            _P],
    # the same, then parts (1: the scan launch, 2: the size launch), stream
    "dcs_encode94_select_parts": [*[_P] * 8, *[_P] * 10, _I, *[_P] * 5, _I,
                                  _I, _I, _I, _P],
    # eleven ints out (encode94_select_geometry's keys)
    "dcs_encode94_select_geometry": [_P],
    # two ints out (encode94_select_layout's)
    "dcs_encode94_select_layout": [_P],
}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build():
    """Compile csrc/ into LIB_PATH unless the library is newer than every
    source: one nvcc per source, run in parallel, then one link.  Returns
    nvcc's report (ptxas registers and shared memory per kernel), or ""
    when the library was up to date.  Raises on failure."""
    srcs = [os.path.join(CSRC, f) for f in SOURCES]
    deps = srcs + [os.path.join(CSRC, f) for f in HEADERS]
    if (os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= max(map(os.path.getmtime, deps))):
        return ""
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [f"{LIB_PATH[:-3]}_{os.path.basename(src)[:-3]}.{tag}.o"
            for src in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(srcs, objs)]
    report, failed = [], []
    for src, p in zip(srcs, procs):
        out, _ = p.communicate()
        report.append(out)
        if p.returncode != 0:
            failed.append(f"{os.path.basename(src)} ({p.returncode}):\n{out}")
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = f"{LIB_PATH}.{tag}"
        r = subprocess.run([nvcc, *ARCH, "-shared", "-o", tmp, *objs],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{r.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return "".join(report)


def load():
    """Build the library if needed and load it (once per process)."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(LIB_PATH)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name, t, dtype, shape, device=None):
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel takes a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(kernel, c_name, device, *args):
    fn = getattr(load(), c_name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch")
    LAUNCHES[kernel] += 1


# the largest byte pool of decode94_fb and decode94_bank (a 32-bit cursor)
MAX_POOL_BYTES = 1 << 28

# the codec tables decode94_fb and decode94_bank read, in the order of their
# C arguments
_FB_TABLES = (("out_count", (16,)), ("xt_by_band", (16, 16)),
              ("xa_by_band", (16, 16)), ("preadj", (2, 16)), ("maxw", (7,)),
              ("cb_base", (7,)), ("scale_mant", (4,)), ("cb_flat", (940,)))


def _check_columns(pool_u8, sid, start_bit, bt_u8, hdr_tab, fmt_tab,
                   sub_tab, n_steps, tabs):
    """The compact decode columns and tables of decode94_fb and
    decode94_bank (decode94_walk.cuh's inputs)."""
    N = sid.shape[0]
    S = hdr_tab.shape[0]
    dev = pool_u8.device
    _check("pool_u8", pool_u8, torch.uint8, (pool_u8.numel(),))
    _check("sid", sid, torch.int32, (N,), dev)
    _check("start_bit", start_bit, torch.int32, (N,), dev)
    _check("bt_u8", bt_u8, torch.uint8, (N, 16), dev)
    _check("hdr_tab", hdr_tab, torch.uint8, (S, 16), dev)
    _check("fmt_tab", fmt_tab, torch.uint8, (S,), dev)
    _check("sub_tab", sub_tab, torch.uint8, (S,), dev)
    for name, shape in _FB_TABLES:
        _check(name, tabs[name], torch.int32, shape, dev)
    # the walk loads 4-byte pool words and 16-byte header/band-type rows
    for name, t, align in (("pool_u8", pool_u8, 4), ("bt_u8", bt_u8, 16),
                           ("hdr_tab", hdr_tab, 16)):
        if t.data_ptr() % align:
            raise ValueError(f"{name}: not {align}-byte aligned")
    if n_steps < 0:
        raise ValueError(f"n_steps {n_steps}")
    # the walk's bit cursor is 32-bit
    if pool_u8.numel() >= MAX_POOL_BYTES:
        raise ValueError(f"pool of {pool_u8.numel()} bytes; the kernels take "
                         f"fewer than 2^28")


def decode94_fb(pool_u8, sid, start_bit, bt_u8, mix, hdr_tab, fmt_tab,
                sub_tab, n_steps, tabs):
    """Compact columns -> frame buffers on the card (csrc/decode94_fb.cu);
    see band_decode.decode94_fb_plain for the contract."""
    with span("dcs.kernel.decode94_fb"):
        _check_columns(pool_u8, sid, start_bit, bt_u8, hdr_tab, fmt_tab,
                       sub_tab, n_steps, tabs)
        N = sid.shape[0]
        S = hdr_tab.shape[0]
        dev = pool_u8.device
        _check("mix", mix, torch.int32, (N,), dev)
        out = torch.empty((N, 512), dtype=torch.int32, device=dev)
        if N:
            _launch("decode94_fb", "dcs_decode94_fb", dev,
                    pool_u8.data_ptr(), pool_u8.numel(), sid.data_ptr(),
                    start_bit.data_ptr(), bt_u8.data_ptr(), mix.data_ptr(),
                    hdr_tab.data_ptr(), fmt_tab.data_ptr(),
                    sub_tab.data_ptr(), S,
                    *[tabs[name].data_ptr() for name, _ in _FB_TABLES],
                    out.data_ptr(), N, min(n_steps, 256))
        return out


def dequant_mix(pos_vals, scale, total, mix, fb_prev=None):
    """Dequant/mix on the card (csrc/dequant_mix.cu); see
    band_decode.dequant_mix_plain for the contract.  fb_prev None means
    silence and is never materialized."""
    with span("dcs.kernel.dequant_mix"):
        F, S = pos_vals.shape
        dev = pos_vals.device
        _check("pos_vals", pos_vals, torch.int32, (F, S))
        if not 1 <= S <= 511:
            raise ValueError(f"{S} positions per frame; expected 1..511")
        _check("scale", scale, torch.int32, (F, S), dev)
        _check("total", total, torch.int32, (F,), dev)
        _check("mix", mix, torch.int32, (F,), dev)
        if fb_prev is not None:
            _check("fb_prev", fb_prev, torch.int32, (F, 512), dev)
        out = torch.empty((F, 512), dtype=torch.int32, device=dev)
        if F:
            _launch("dequant_mix", "dcs_dequant_mix", dev,
                    pos_vals.data_ptr(), scale.data_ptr(), total.data_ptr(),
                    mix.data_ptr(),
                    None if fb_prev is None else fb_prev.data_ptr(),
                    out.data_ptr(), F, S)
        return out


def _flags(name, t, shape, device):
    """A bool or uint8 flag tensor as uint8 (the same bytes)."""
    if isinstance(t, torch.Tensor) and t.dtype == torch.bool:
        t = t.view(torch.uint8)
    _check(name, t, torch.uint8, shape, device)
    return t


def dequant_mix_dense(dense, scale, fb_idx, valid, mix, fb_prev=None,
                      active=None):
    """Dense-slot dequant/mix on the card (csrc/dequant_mix_dense.cu); see
    band_decode.dequant_mix_dense_plain for the contract.  The native host
    decode's widths: dense and scale int32, fb_idx int16, valid uint8 or
    bool, all [F, 256]; mix [F] int32; fb_prev [F, 512] int32 and active
    [F] (uint8 or bool) may each be None."""
    with span("dcs.kernel.dequant_mix_dense"):
        F = dense.shape[0]
        dev = dense.device
        _check("dense", dense, torch.int32, (F, 256))
        _check("scale", scale, torch.int32, (F, 256), dev)
        _check("fb_idx", fb_idx, torch.int16, (F, 256), dev)
        valid = _flags("valid", valid, (F, 256), dev)
        _check("mix", mix, torch.int32, (F,), dev)
        if fb_prev is not None:
            _check("fb_prev", fb_prev, torch.int32, (F, 512), dev)
        if active is not None:
            active = _flags("active", active, (F,), dev)
        out = torch.empty((F, 512), dtype=torch.int32, device=dev)
        if F:
            _launch("dequant_mix_dense", "dcs_dequant_mix_dense", dev,
                    dense.data_ptr(), scale.data_ptr(), fb_idx.data_ptr(),
                    valid.data_ptr(), mix.data_ptr(),
                    None if fb_prev is None else fb_prev.data_ptr(),
                    None if active is None else active.data_ptr(),
                    out.data_ptr(), F)
        return out


def transform94_planar(fb, vol_shift, p2_c0, p2_c1, cos, sin):
    """Inverse transform on the card (csrc/transform94.cu); see
    transform.transform94_planar_plain for the contract."""
    with span("dcs.kernel.transform94_planar"):
        F = fb.shape[0]
        dev = fb.device
        _check("fb", fb, torch.int32, (F, 512))
        _check("vol_shift", vol_shift, torch.int32, (F,), dev)
        for name, t, n in (("p2_c0", p2_c0, 64), ("p2_c1", p2_c1, 64),
                           ("cos", cos, 128), ("sin", sin, 128)):
            _check(name, t, torch.int32, (n,), dev)
        re = torch.empty((F, 128), dtype=torch.int32, device=dev)
        im = torch.empty((F, 128), dtype=torch.int32, device=dev)
        if F:
            _launch("transform94_planar", "dcs_transform94_planar", dev,
                    fb.data_ptr(), vol_shift.data_ptr(), p2_c0.data_ptr(),
                    p2_c1.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                    re.data_ptr(), im.data_ptr(), F)
        return re, im


# the codec tables transform94_pcm reads, in the order of its C arguments
_PCM_TABLES = (("p2_c0", 64), ("p2_c1", 64), ("cos", 128), ("sin", 128),
               ("ovl_new", 16), ("ovl_old", 16), ("ext_half", 120),
               ("save_half", 8))


def transform94_pcm(fb, vol_shift, sid, tabs, overlap0=None):
    """Frame buffers -> PCM on the card (csrc/transform94_pcm.cu): the
    transform, overlap resolve and extraction in one launch; see
    transform.transform94_pcm_plain for the contract.  With overlap0
    [G, 16] the carry at a run's start is overlap0[sid], and the result is
    (pcm, last_ov [G, 16])."""
    kernel = "transform94_pcm" if overlap0 is None else "transform94_pcm_carry"
    with span(f"dcs.kernel.{kernel}"):
        F = fb.shape[0]
        dev = fb.device
        _check("fb", fb, torch.int32, (F, 512))
        _check("vol_shift", vol_shift, torch.int32, (F,), dev)
        _check("sid", sid, torch.int32, (F,), dev)
        for name, n in _PCM_TABLES:
            _check(name, tabs[name], torch.int32, (n,), dev)
        pcm = torch.empty((F, 240), dtype=torch.int32, device=dev)
        aligned = [("fb", fb), ("pcm", pcm)]
        last_ov = None
        if overlap0 is not None:
            _check("overlap0", overlap0, torch.int32, (overlap0.shape[0], 16),
                   dev)
            last_ov = overlap0.clone()        # ids with no frame keep theirs
            aligned += [("overlap0", overlap0), ("last_ov", last_ov)]
        # the kernel loads and stores 16-byte words of each row
        for name, t in aligned:
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: not 16-byte aligned")
        if F:
            _launch(kernel, "dcs_transform94_pcm", dev,
                    fb.data_ptr(), vol_shift.data_ptr(), sid.data_ptr(),
                    *[tabs[name].data_ptr() for name, _ in _PCM_TABLES],
                    None if overlap0 is None else overlap0.data_ptr(),
                    None if last_ov is None else last_ov.data_ptr(),
                    0 if overlap0 is None else overlap0.shape[0],
                    pcm.data_ptr(), F)
        return pcm if overlap0 is None else (pcm, last_ov)


def decode94_bank(pool_u8, sid, start_bit, bt_u8, hdr_tab, fmt_tab, sub_tab,
                  n_steps, tabs):
    """A session bank's rows on the card (csrc/decode94_bank.cu); see
    band_decode.decode94_bank_plain for the contract."""
    with span("dcs.kernel.decode94_bank"):
        _check_columns(pool_u8, sid, start_bit, bt_u8, hdr_tab, fmt_tab,
                       sub_tab, n_steps, tabs)
        N = sid.shape[0]
        S = hdr_tab.shape[0]
        dev = pool_u8.device
        if not N:
            return torch.zeros((1, 256), dtype=torch.int16, device=dev)
        out = torch.empty((N + 1, 256), dtype=torch.int16, device=dev)
        _launch("decode94_bank", "dcs_decode94_bank", dev,
                pool_u8.data_ptr(), pool_u8.numel(), sid.data_ptr(),
                start_bit.data_ptr(), bt_u8.data_ptr(), hdr_tab.data_ptr(),
                fmt_tab.data_ptr(), sub_tab.data_ptr(), S,
                *[tabs[name].data_ptr() for name, _ in _FB_TABLES],
                out.data_ptr(), N, min(n_steps, 256))
        return out


# the largest segment table: 8 channels of 255 segments
MAX_CHANNELS, MAX_SEGMENTS = 8, 255


def wire_base_bytes(n_wire, S, T, C, E):
    """The bytes of a segment's first bank row on a control wire of n_wire
    bytes for S sessions x T frames x C channels x E segments: 2 on the u16
    wire (7 bytes a segment entry), 4 on the wide wire (9), None on a
    length of neither."""
    for width in (2, 4):
        if n_wire == (5 + width) * S * C * E + S * T:
            return width
    return None


def segments94(wire, S, T, C, E):
    """The control wire -> dense rows, mix [S*T, C] and vol [S*T], int32, on
    the card (csrc/segments94.cu; the wide wire, told by its length, through
    its segments94_rows32 instance); see romplay.segments94_plain for the
    contract."""
    kernel = ("segments94_rows32"
              if wire_base_bytes(wire.numel(), S, T, C, E) == 4
              else "segments94")
    with span(f"dcs.kernel.{kernel}"):
        if not (1 <= C <= MAX_CHANNELS and 1 <= E <= MAX_SEGMENTS):
            raise ValueError(f"{C} channels of {E} segments; expected 1..8 "
                             "and 1..255")
        n_wire = (9 if kernel == "segments94_rows32" else 7) * S * C * E \
            + S * T
        if not (S >= 0 and 0 <= T < 0xFFFF and S * T * C < 1 << 31
                and n_wire < 1 << 31):
            raise ValueError(f"{S} sessions of {T} frames")
        dev = wire.device
        _check("wire", wire, torch.uint8, (n_wire,))
        rows = torch.empty((S * T, C), dtype=torch.int32, device=dev)
        mix = torch.empty((S * T, C), dtype=torch.int32, device=dev)
        vol = torch.empty((S * T,), dtype=torch.int32, device=dev)
        if S and T:
            _launch(kernel, f"dcs_{kernel}", dev, wire.data_ptr(), S, T, C, E,
                    rows.data_ptr(), mix.data_ptr(), vol.data_ptr())
        return rows, mix, vol


def session_mix94(scaled, rows, mix):
    """Multi-voice dequant/mix on the card (csrc/session_mix94.cu); see
    band_decode.session_mix94_plain for the contract."""
    with span("dcs.kernel.session_mix94"):
        R = scaled.shape[0]
        F, C = rows.shape
        dev = scaled.device
        _check("scaled", scaled, torch.int16, (R, 256))
        _check("rows", rows, torch.int32, (F, C), dev)
        _check("mix", mix, torch.int32, (F, C), dev)
        if not 1 <= C <= MAX_CHANNELS:
            raise ValueError(f"{C} channels; expected 1..8")
        out = torch.empty((F, 512), dtype=torch.int32, device=dev)
        for name, t in (("scaled", scaled), ("out", out)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: not 16-byte aligned")
        if F:
            _launch("session_mix94", "dcs_session_mix94", dev,
                    scaled.data_ptr(), R, rows.data_ptr(), mix.data_ptr(),
                    out.data_ptr(), F, C)
        return out


def _check_columns93(pool_u8, frame_word, sid, kind_u8, kw_u8, bit_rel, prv,
                     code_u8, band_tab, pair, inputs):
    """The 1993 bank columns and tables of decode93_fb, decode93_pcm and
    decode93_bank; returns the number of rows."""
    R = frame_word.shape[0]
    S = band_tab.shape[0]
    dev = pool_u8.device
    _check("pool_u8", pool_u8, torch.uint8, (pool_u8.numel(),))
    _check("frame_word", frame_word, torch.int32, (R,), dev)
    _check("sid", sid, torch.int32, (R,), dev)
    _check("kind_u8", kind_u8, torch.uint8, (R,), dev)
    _check("kw_u8", kw_u8, torch.uint8, (R, 18), dev)
    _check("bit_rel", bit_rel, torch.int32, (R, 18), dev)
    _check("prv", prv, torch.int32, (R, 16), dev)
    _check("code_u8", code_u8, torch.uint8, (R, 18), dev)
    _check("band_tab", band_tab, torch.int32, (S, 16, 8), dev)
    _check("pair", pair, torch.int32, (2048,), dev)
    _check("inputs", inputs, torch.int32, (18,), dev)
    # the kernels load 4-byte pool words and 16-byte band-table rows
    for name, t, align in (("pool_u8", pool_u8, 4), ("band_tab", band_tab, 16)):
        if t.data_ptr() % align:
            raise ValueError(f"{name}: not {align}-byte aligned")
    return R


def _check_rows93(rows, mix, R, dev):
    """The rows [F, C] and mixes of a 1993 decode over R bank rows (rows
    None: the flat sweep, row f for frame f, mix [R]); returns (F, C)."""
    if rows is None:
        _check("mix", mix, torch.int32, (R,), dev)
        return R, 1
    F, C = rows.shape
    _check("rows", rows, torch.int32, (F, C), dev)
    _check("mix", mix, torch.int32, (F, C), dev)
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"{C} channels; expected 1..8")
    return F, C


def decode93_fb(pool_u8, frame_word, sid, kind_u8, kw_u8, bit_rel, prv,
                code_u8, band_tab, rows, mix, pair, inputs):
    """1993-family frame buffers on the card (csrc/decode93_fb.cu): the bank
    columns (ops/decode93.py) and rows [F, C] of them per output frame and
    voice (None: the flat sweep, row f for frame f, mix [F]) with their
    mixes -> [F, 512] int32; see decode93.decode93_fb_plain."""
    with span("dcs.kernel.decode93_fb"):
        R = _check_columns93(pool_u8, frame_word, sid, kind_u8, kw_u8,
                             bit_rel, prv, code_u8, band_tab, pair, inputs)
        F, C = _check_rows93(rows, mix, R, pool_u8.device)
        out = torch.empty((F, 512), dtype=torch.int32, device=pool_u8.device)
        if F:
            _launch("decode93_fb", "dcs_decode93_fb", pool_u8.device,
                    pool_u8.data_ptr(), pool_u8.numel(), frame_word.data_ptr(),
                    sid.data_ptr(), kind_u8.data_ptr(), kw_u8.data_ptr(),
                    bit_rel.data_ptr(), prv.data_ptr(), code_u8.data_ptr(),
                    band_tab.data_ptr(), band_tab.shape[0], pair.data_ptr(),
                    inputs.data_ptr(),
                    None if rows is None else rows.data_ptr(),
                    mix.data_ptr(), out.data_ptr(), F, C, frame_word.shape[0])
        return out


# the codec tables transform93_pcm reads, in the order of its C arguments
_PCM93_TABLES = (("cos", 128), ("sin", 128), ("ovl_new", 16), ("ovl_old", 16),
                 ("br93_half", 256))


def transform93_pcm(fb, vol_shift, sid, tabs, overlap0=None):
    """1993 frame buffers -> PCM on the card (csrc/transform93_pcm.cu): the
    transform, overlap resolve and collection in one launch; see
    transform.transform93_pcm_plain for the contract.  With overlap0
    [G, 16] the carry at a run's start is overlap0[sid], and the result is
    (pcm, last_ov [G, 16])."""
    kernel = "transform93_pcm" if overlap0 is None else "transform93_pcm_carry"
    with span(f"dcs.kernel.{kernel}"):
        F = fb.shape[0]
        dev = fb.device
        _check("fb", fb, torch.int32, (F, 512))
        _check("vol_shift", vol_shift, torch.int32, (F,), dev)
        _check("sid", sid, torch.int32, (F,), dev)
        for name, n in _PCM93_TABLES:
            _check(name, tabs[name], torch.int32, (n,), dev)
        pcm = torch.empty((F, 240), dtype=torch.int32, device=dev)
        aligned = [("fb", fb), ("pcm", pcm)]
        last_ov = None
        if overlap0 is not None:
            _check("overlap0", overlap0, torch.int32, (overlap0.shape[0], 16),
                   dev)
            last_ov = overlap0.clone()        # ids with no frame keep theirs
            aligned.append(("overlap0", overlap0))
        # the kernel loads 16-byte words of fb and overlap0, stores them to pcm
        for name, t in aligned:
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: not 16-byte aligned")
        if F:
            _launch(kernel, "dcs_transform93_pcm", dev,
                    fb.data_ptr(), vol_shift.data_ptr(), sid.data_ptr(),
                    *[tabs[name].data_ptr() for name, _ in _PCM93_TABLES],
                    None if overlap0 is None else overlap0.data_ptr(),
                    None if last_ov is None else last_ov.data_ptr(),
                    0 if overlap0 is None else overlap0.shape[0],
                    pcm.data_ptr(), F)
        return pcm if overlap0 is None else (pcm, last_ov)


# the codec tables decode93_pcm reads after the columns' pair and inputs,
# in the order of its C arguments
_DECODE93_PCM_TABLES = (("cos", 128), ("sin", 128), ("ovl_new", 16),
                        ("ovl_old", 16))


def _pcm93_out(F, dev, vol_shift, frame_sid, tabs, overlap0):
    """Check what both instances of decode93_pcm take beside their rows
    (vol_shift, frame_sid, the codec tables, overlap0); allocate pcm
    [F, 240] and, with overlap0, last_ov (its copy: ids with no frame keep
    theirs)."""
    _check("vol_shift", vol_shift, torch.int32, (F,), dev)
    _check("frame_sid", frame_sid, torch.int32, (F,), dev)
    for name, n in _DECODE93_PCM_TABLES:
        _check(name, tabs[name], torch.int32, (n,), dev)
    pcm = torch.empty((F, 240), dtype=torch.int32, device=dev)
    aligned = [("pcm", pcm)]
    last_ov = None
    if overlap0 is not None:
        _check("overlap0", overlap0, torch.int32, (overlap0.shape[0], 16),
               dev)
        last_ov = overlap0.clone()
        aligned.append(("overlap0", overlap0))
    # the kernel loads 16-byte words of overlap0 and stores them to pcm
    for name, t in aligned:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: not 16-byte aligned")
    return pcm, last_ov


def decode93_pcm(pool_u8, frame_word, sid, kind_u8, kw_u8, bit_rel, prv,
                 code_u8, band_tab, mix, vol_shift, frame_sid, tabs):
    """1993-family PCM of the flat sweep on the card (csrc/decode93_pcm.cu,
    its columns' instance): the bank columns, each row one frame of one
    voice with its mix [R], vol_shift [R] and frame_sid [R] (each frame's
    stream) -> pcm [R, 240] int32, the frame buffers kept on chip; see
    decode93.decode93_pcm_plain with rows None.  Sessions mix the session
    bank instead (decode93_pcm_bank)."""
    with span("dcs.kernel.decode93_pcm"):
        pair, inputs = tabs["pair"], tabs["inputs"]
        R = _check_columns93(pool_u8, frame_word, sid, kind_u8, kw_u8,
                             bit_rel, prv, code_u8, band_tab, pair, inputs)
        dev = pool_u8.device
        _check("mix", mix, torch.int32, (R,), dev)
        pcm, _ = _pcm93_out(R, dev, vol_shift, frame_sid, tabs, None)
        if R:
            _launch("decode93_pcm", "dcs_decode93_pcm", dev,
                    pool_u8.data_ptr(), pool_u8.numel(),
                    frame_word.data_ptr(), sid.data_ptr(), kind_u8.data_ptr(),
                    kw_u8.data_ptr(), bit_rel.data_ptr(), prv.data_ptr(),
                    code_u8.data_ptr(), band_tab.data_ptr(), band_tab.shape[0],
                    pair.data_ptr(), inputs.data_ptr(), mix.data_ptr(),
                    vol_shift.data_ptr(), frame_sid.data_ptr(),
                    *[tabs[name].data_ptr()
                      for name, _ in _DECODE93_PCM_TABLES],
                    pcm.data_ptr(), R)
        return pcm


# int32 words a row of the 1993 session bank (csrc/decode93_bank.cuh)
BANK93_WORDS = 160


def decode93_bank(pool_u8, frame_word, sid, kind_u8, kw_u8, bit_rel, prv,
                  code_u8, band_tab, pair, inputs):
    """The 1993 session bank on the card (csrc/decode93_bank.cu), once per
    ROM: the bank columns -> (words93 [R, 160] int32, kind93 [R] uint8);
    see decode93.decode93_bank_plain."""
    with span("dcs.kernel.decode93_bank"):
        R = _check_columns93(pool_u8, frame_word, sid, kind_u8, kw_u8,
                             bit_rel, prv, code_u8, band_tab, pair, inputs)
        dev = pool_u8.device
        words = torch.empty((R, BANK93_WORDS), dtype=torch.int32, device=dev)
        kind93 = torch.empty(R, dtype=torch.uint8, device=dev)
        if R:
            _launch("decode93_bank", "dcs_decode93_bank", dev,
                    pool_u8.data_ptr(), pool_u8.numel(),
                    frame_word.data_ptr(), sid.data_ptr(), kind_u8.data_ptr(),
                    kw_u8.data_ptr(), bit_rel.data_ptr(), prv.data_ptr(),
                    code_u8.data_ptr(), band_tab.data_ptr(), band_tab.shape[0],
                    pair.data_ptr(), inputs.data_ptr(), words.data_ptr(),
                    kind93.data_ptr(), R)
        return words, kind93


def decode93_pcm_bank(words93, kind93, rows, mix, vol_shift, frame_sid, tabs,
                      overlap0=None):
    """1993-family session PCM on the card (csrc/decode93_pcm.cu, its
    session instance): the session bank (decode93_bank's words93 [R, 160]
    and kind93 [R]), rows [F, C] of it per output frame and voice and their
    mixes, vol_shift [F] and frame_sid [F] -> pcm [F, 240] int32; see
    decode93.session93_pcm_plain.  Counted and spanned as decode93_pcm (or
    decode93_pcm_carry with overlap0, as there)."""
    kernel = "decode93_pcm" if overlap0 is None else "decode93_pcm_carry"
    with span(f"dcs.kernel.{kernel}"):
        R = kind93.shape[0]
        dev = words93.device
        _check("words93", words93, torch.int32, (R, BANK93_WORDS))
        _check("kind93", kind93, torch.uint8, (R,), dev)
        _check("inputs", tabs["inputs"], torch.int32, (18,), dev)
        if rows is None:
            raise ValueError("rows: the session bank's instance takes rows")
        F, C = _check_rows93(rows, mix, R, dev)
        pcm, last_ov = _pcm93_out(F, dev, vol_shift, frame_sid, tabs,
                                  overlap0)
        # the kernel loads 8-byte words of each bank row
        if words93.data_ptr() % 8:
            raise ValueError("words93: not 8-byte aligned")
        if F:
            _launch(kernel, "dcs_decode93_pcm_bank", dev, words93.data_ptr(),
                    kind93.data_ptr(), R, tabs["inputs"].data_ptr(),
                    rows.data_ptr(), mix.data_ptr(), vol_shift.data_ptr(),
                    frame_sid.data_ptr(),
                    *[tabs[name].data_ptr()
                      for name, _ in _DECODE93_PCM_TABLES],
                    None if overlap0 is None else overlap0.data_ptr(),
                    None if last_ov is None else last_ov.data_ptr(),
                    0 if overlap0 is None else overlap0.shape[0],
                    pcm.data_ptr(), F, C)
        return pcm if overlap0 is None else (pcm, last_ov)


def normalize93_check(device):
    """The number of the 2^32 inputs on which decode93_pcm.cu's closed-form
    normalize (__clz) and the reference's 31-step loop disagree, counted on
    the card (``device``).  Not a kernel of any path: no launch count."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("normalize93_check runs on a CUDA device")
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    fn = load().dcs_normalize93_check
    with torch.cuda.device(dev):
        err = fn(bad.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"normalize93_check: CUDA error {err} at launch")
    return int(bad.item())


def _check_encoder_tables(tabs, K, dev, n):
    """The first n of the encoder's tables, in the order of the C arguments
    (decide takes five, select all ten); returns their pointers."""
    spec = (("w_tab", torch.int32, (K, 16, 16)),
            ("xa_tab", torch.int32, (K, 16, 16)),
            ("peff_tab", torch.int32, (K, 16, 5)),
            ("is1", torch.bool, (K,)), ("scale_mant", torch.int32, (4,)),
            ("pip", torch.int32, (K, 16)), ("dep", torch.bool, (K, 16)),
            ("cb_bits", torch.int32, (7, 64)), ("tz_bits", torch.int32, (7,)),
            ("delta_bits", torch.int32, (tabs["delta_bits"].numel(),)))
    for name, dtype, shape in spec[:n]:
        _check(name, tabs[name], dtype, shape, dev)
    return [tabs[name].data_ptr() for name, _, _ in spec[:n]]


def _check_batch(ci, hdr_scale, keep):
    """(B, Fmax, K) of an encoder batch: ci [B, Fmax, 255] int32,
    hdr_scale [B, K, 16] uint8, keep [B, 16] bool."""
    B, F = ci.shape[:2]
    K = hdr_scale.shape[1]
    dev = ci.device
    _check("ci", ci, torch.int32, (B, F, 255))
    _check("hdr_scale", hdr_scale, torch.uint8, (B, K, 16), dev)
    _check("keep", keep, torch.bool, (B, 16), dev)
    if not 1 <= K <= ENCODE94_MAX_SLOTS:
        raise ValueError(f"{K} format slots; expected 1..3")
    if not (1 <= B < 65536 and F >= 1):
        raise ValueError(f"{B} streams of {F} frames")
    return B, F, K


def encode94_analyze(pcm, fq):
    """int16 PCM [B, Fmax*240 + 240] -> coefficients [B, Fmax, 255] int32
    on the card (csrc/encode94_analyze.cu); see
    encoder.device94.analyze94_plain for the contract."""
    with span("dcs.kernel.encode94_analyze"):
        B, L = pcm.shape
        F = (L - 240) // 240
        dev = pcm.device
        _check("pcm", pcm, torch.int16, (B, F * 240 + 240))
        _check("fq", fq, torch.int16, (256, 255), dev)
        if not (1 <= B < 65536 and F >= 1):
            raise ValueError(f"{B} streams of {F} frames")
        # the kernel copies each tile's span of a row in 16-byte chunks
        if pcm.data_ptr() % 16:
            raise ValueError("pcm: not 16-byte aligned")
        ci = torch.empty((B, F, 255), dtype=torch.int32, device=dev)
        _launch("encode94_analyze", "dcs_encode94_analyze", dev,
                pcm.data_ptr(), fq.data_ptr(), ci.data_ptr(), B, F)
        return ci


def encode94_decide(ci, sil_max, keep, thr, dlim, cape, hdr_scale, tabs):
    """The encoder's decision tables on the card (csrc/encode94_decide.cu):
    (out15, out14 [B, K, Fmax, 16, 5] uint8, silent [B, Fmax, 16] bool); see
    encoder.device94.decide94_plain for the contract.  Precondition:
    |ci| <= ENCODE94_CI_LIMIT (2^20), where its reciprocal division and its
    int32 error sums are exact; the callers (encoder.device94's
    encode_batch and DeviceEncoder94.forward) refuse other input, and the
    analysis clips to it.  Not checked here: that would cost a device
    reduction and a synchronisation on every call."""
    with span("dcs.kernel.encode94_decide"):
        B, F, K = _check_batch(ci, hdr_scale, keep)
        dev = ci.device
        for name, t in (("thr", thr), ("dlim", dlim), ("cape", cape)):
            _check(name, t, torch.int32, (16,), dev)
        tables = _check_encoder_tables(tabs, K, dev, 5)
        out15 = torch.empty((B, K, F, 16, 5), dtype=torch.uint8, device=dev)
        out14 = torch.empty_like(out15)
        silent = torch.empty((B, F, 16), dtype=torch.bool, device=dev)
        _launch("encode94_decide", "dcs_encode94_decide", dev, ci.data_ptr(),
                hdr_scale.data_ptr(), keep.data_ptr(), *tables,
                thr.data_ptr(), dlim.data_ptr(), cape.data_ptr(), int(sil_max),
                out15.data_ptr(), out14.data_ptr(), silent.data_ptr(), B, K, F)
        return out15, out14, silent


def encode94_analyze_geometry(device):
    """encode94_analyze's launch geometry on the card: a dict of its frames
    and columns a block, threads a block, dynamic shared bytes, registers
    and local (spilled) bytes a thread, resident blocks an SM and the
    card's SMs.  Launches nothing."""
    out = (ctypes.c_int * 8)()
    fn = load().dcs_encode94_analyze_geometry
    with torch.cuda.device(torch.device(device)):
        err = fn(ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"encode94_analyze_geometry: CUDA error {err}")
    keys = ("tile_frames", "tile_cols", "threads", "shared_bytes",
            "registers", "local_bytes", "blocks_per_sm", "sms")
    return dict(zip(keys, list(out)))


def encode94_decide_geometry(device):
    """encode94_decide's launch geometry on the card: a dict of its frames
    and threads a block, static shared bytes, registers a thread, resident
    blocks an SM and the card's SMs.  Launches nothing."""
    out = (ctypes.c_int * 6)()
    fn = load().dcs_encode94_decide_geometry
    with torch.cuda.device(torch.device(device)):
        err = fn(ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"encode94_decide_geometry: CUDA error {err}")
    keys = ("tile_frames", "threads", "shared_bytes", "registers",
            "blocks_per_sm", "sms")
    return dict(zip(keys, list(out)))


def encode94_rdiv_check(scale_mant):
    """The number of (a, scale table entry) pairs, over every |a| <= 2^20
    and the 65 entries, on which encode94_decide.cu's reciprocal rdiv
    differs from the integer division, counted on scale_mant's card.  Not a
    kernel of any path: no launch count."""
    _check("scale_mant", scale_mant, torch.int32, (4,))
    dev = scale_mant.device
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    fn = load().dcs_encode94_rdiv_check
    with torch.cuda.device(dev):
        err = fn(scale_mant.data_ptr(), bad.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"encode94_rdiv_check: CUDA error {err} at launch")
    return int(bad.item())


def encode94_select_layout(lib=None):
    """(sums, max_delta) of csrc/encode94_select.cu: the int32 size sums
    its scratch holds a (stream, slot), and the most delta codes it
    stages; from lib (a build of that source) or the package's library."""
    out = (ctypes.c_int * 2)()
    (lib or load()).dcs_encode94_select_layout(
        ctypes.cast(out, ctypes.c_void_p))
    return tuple(out)


def _select_args(ci, out15, out14, silent, nf, keep, hdr_scale, wanted,
                 tabs):
    """encode94_select's checked arguments and fresh buffers: (the C
    arguments before the stream, packed, the scratch tensors)."""
    B, F, K = _check_batch(ci, hdr_scale, keep)
    dev = ci.device
    if F % 16:
        raise ValueError(f"{F} frames: the kernel takes multiples of 16")
    _check("out15", out15, torch.uint8, (B, K, F, 16, 5), dev)
    _check("out14", out14, torch.uint8, (B, K, F, 16, 5), dev)
    _check("silent", silent, torch.bool, (B, F, 16), dev)
    _check("nf", nf, torch.int32, (B,), dev)
    _check("wanted", wanted, torch.bool, (B, K), dev)
    tables = _check_encoder_tables(tabs, K, dev, 10)
    sums, max_delta = encode94_select_layout()
    if not 1 <= tabs["delta_bits"].numel() <= max_delta:
        raise ValueError(f"{tabs['delta_bits'].numel()} delta codes; the "
                         f"kernel takes 1..{max_delta}")
    # the kernels load and store 4-byte words of the decisions and flags
    for name, t in (("out15", out15), ("out14", out14), ("silent", silent)):
        if t.data_ptr() % 4:
            raise ValueError(f"{name}: not 4-byte aligned")
    codes = torch.empty((B, K, F, 16), dtype=torch.uint8, device=dev)
    pidx = torch.empty_like(codes)
    nbits = torch.empty((B, K, sums), dtype=torch.int32, device=dev)
    done = torch.empty((B,), dtype=torch.int32, device=dev)
    packed = torch.empty((B, 4 * K + 1 + 32 * F), dtype=torch.uint8,
                         device=dev)
    args = [ci.data_ptr(), out15.data_ptr(), out14.data_ptr(),
            silent.data_ptr(), nf.data_ptr(), keep.data_ptr(),
            hdr_scale.data_ptr(), wanted.data_ptr(), *tables,
            tabs["delta_bits"].numel(), codes.data_ptr(), pidx.data_ptr(),
            nbits.data_ptr(), done.data_ptr(), packed.data_ptr(), B, K, F]
    # the scratch lives as long as the arguments
    return args, packed, (codes, pidx, nbits, done)


def encode94_select(ci, out15, out14, silent, nf, keep, hdr_scale, wanted,
                    tabs):
    """The encoder's scan, sizes, winner and packed rows on the card
    (csrc/encode94_select.cu: two kernels from one entry) -> uint8
    [B, 4K + 1 + 32 Fmax]; see encoder.device94.select94_plain for the
    contract.  Fmax is a multiple of 16 (the frame bucket).  Precondition:
    |ci| <= ENCODE94_CI_LIMIT (2^20), where its reciprocal division is
    exact (see encode94_decide)."""
    with span("dcs.kernel.encode94_select"):
        args, packed, _scratch = _select_args(ci, out15, out14, silent, nf,
                                              keep, hdr_scale, wanted, tabs)
        _launch("encode94_select", "dcs_encode94_select", ci.device, *args)
        return packed


def encode94_select_parts(ci, out15, out14, silent, nf, keep, hdr_scale,
                          wanted, tabs):
    """Launchers of encode94_select's two kernels apart, for timing them:
    (scan, size, packed), each launcher a function of no argument that
    launches one kernel on the same arguments and scratch (the size launch
    reads what the last scan launch left, and writes packed).  Neither is
    a path's launch: no count."""
    args, packed, scratch = _select_args(ci, out15, out14, silent, nf,
                                          keep, hdr_scale, wanted, tabs)
    dev = ci.device
    fn = load().dcs_encode94_select_parts

    def part(p):
        def run(_keep=scratch):
            with torch.cuda.device(dev):
                err = fn(*args, p,
                         torch.cuda.current_stream(dev).cuda_stream)
            if err != 0:
                raise RuntimeError(f"encode94_select part {p}: CUDA error "
                                   f"{err} at launch")
        return run
    return part(1), part(2), packed


def encode94_select_geometry(device):
    """encode94_select's two kernels on the card: a dict of the scan's
    blocks a (stream, slot), threads a block, static shared bytes,
    registers a thread and resident blocks an SM, the same for the size
    kernel with frames a block in place of the first, and the card's SMs.
    Launches nothing."""
    out = (ctypes.c_int * 11)()
    fn = load().dcs_encode94_select_geometry
    with torch.cuda.device(torch.device(device)):
        err = fn(ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"encode94_select_geometry: CUDA error {err}")
    keys = ("scan_blocks", "scan_threads", "scan_shared_bytes",
            "scan_registers", "scan_blocks_per_sm", "size_tile_frames",
            "size_threads", "size_shared_bytes", "size_registers",
            "size_blocks_per_sm", "sms")
    return dict(zip(keys, list(out)))
