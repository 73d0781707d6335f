"""Time the host runtime's build from a clean directory, in one process or
in several started together, as pytest-xdist workers start.

Run:  python -m dcsexplorer_tpu_torch.native.time_build [--procs N] [--single]

Each process points ``native.BUILD_DIR`` at one fresh temporary directory
(so the library under ``build/`` is left alone) and times ``native.build()``:
one g++ a source, all started together, then the link, one process at a
time under the lock file.  ``--single`` times instead what each process ran
before the lock: every source in one g++ call, no lock, each process into a
temp name of its own.  Prints each process's seconds, whether it compiled,
and the wall time from the common start.
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time

_CHILD = """
import os, subprocess, sys, time
from dcsexplorer_tpu_torch import native
from dcsexplorer_tpu_torch.native import gen_tables
d, start, single = sys.argv[1], float(sys.argv[2]), sys.argv[3] == "1"
native.BUILD_DIR, native.LIB_PATH = d, os.path.join(d, "libdcs_host.so")
time.sleep(max(0.0, start - time.time()))
t0 = time.time()
if single:
    inc = os.path.join(d, "inc")
    gen_tables.emit(os.path.join(inc, "dcs_tables.h"))
    srcs = [os.path.join(os.path.dirname(native.__file__), "src", f)
            for f in native.SOURCES]
    tmp = f"{native.LIB_PATH}.{os.getpid()}.tmp"
    subprocess.run(["g++", *native.GXX_FLAGS, f"-I{inc}", *srcs, "-o", tmp],
                   check=True)
    os.replace(tmp, native.LIB_PATH)
    built = True
else:
    built = native.build()
print(f"{time.time() - t0:.2f} {built}")
"""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=1)
    ap.add_argument("--single", action="store_true",
                    help="one g++ call for every source, no lock")
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory() as d:
        start = time.time() + 3.0           # past every child's imports
        procs = [subprocess.Popen(
            [sys.executable, "-c", _CHILD, d, str(start),
             "1" if args.single else "0"],
            cwd=root, stdout=subprocess.PIPE, text=True)
            for _ in range(args.procs)]
        outs = [p.communicate()[0].split() for p in procs]
        wall = time.time() - start
    if any(p.returncode for p in procs):
        sys.exit("a build failed")
    mode = "single g++, no lock" if args.single else "one g++ a source, lock"
    print(f"{mode}, {args.procs} process(es): "
          + ", ".join(f"{s} s (compiled: {b})" for s, b in outs)
          + f"; wall {wall:.2f} s")


if __name__ == "__main__":
    main()
