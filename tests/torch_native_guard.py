"""Recovery of the JAX package's native library for the port's tests.

The reference builds ``build/libdcsnative.so`` at its first ``get_lib()``
straight into the final path, and caches a failed load for the life of the
process (``_lib`` None, ``_tried`` True).  Under pytest-xdist every worker
imports ``tests/test_native_tracer.py`` and ``tests/test_encoder_native.py``
at collection, and those call ``get_lib()`` at module level: on a tree
without a build, all workers start g++ at once, and a worker whose
``ctypes.CDLL`` meets another's half-written file keeps None.
``reference_native_lib`` undoes that state and loads the library again,
waiting while another process is still writing it.  It edits nothing of
the JAX package: it resets the module's cache and calls its ``get_lib``.
``tests/test_torch_compiler.py`` calls it at import, so every worker has
run it before the first test runs.
"""

import ctypes
import time


def reference_native_lib(timeout=120.0, pause=0.5):
    """The JAX package's loaded native library.  Where the process cached a
    failed load, clear ``_tried`` and call ``get_lib()`` again, every
    ``pause`` seconds for up to ``timeout`` seconds; then raise
    RuntimeError with the last load error."""
    from dcsexplorer_tpu import native as jnative
    deadline = time.monotonic() + timeout
    while True:
        if jnative._lib is None:
            jnative._tried = False
        lib = jnative.get_lib()
        if lib is not None:
            return lib
        try:
            ctypes.CDLL(jnative._LIB_PATH)
            last = None
        except OSError as e:
            last = e
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"the JAX package's native library did not load within "
                f"{timeout} s: {last}") from last
        time.sleep(pause)
