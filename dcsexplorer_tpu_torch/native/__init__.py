"""Native host runtime of the port: the C++ stream indexer and VM tracer.

At first use, g++ builds ``build/torch_native/libdcs_host.so`` from
``src/dcs_native.cpp`` (the stream indexers of the 1994+ and the 1993
families) and ``src/tracer.cpp``
(the runtime VM tracer), with a table header that ``gen_tables`` writes from
the port's own ``format/tables.py``.  It rebuilds when a source is newer
than the library.  The flags are plain ``-O3`` without ``-march``, so one
build runs on any x86-64 host.  A failed build raises: there is no Python
fallback behind this module.
"""

import ctypes as C
import os
import subprocess

from . import gen_tables

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(os.path.dirname(_HERE))
BUILD_DIR = os.path.join(_REPO, "build", "torch_native")
LIB_PATH = os.path.join(BUILD_DIR, "libdcs_host.so")
SOURCES = ("dcs_native.cpp", "tracer.cpp")
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_P, _I = C.c_void_p, C.c_int
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
