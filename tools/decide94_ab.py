#!/usr/bin/env python3
"""Time variants of csrc/encode94_decide.cu side by side on one GPU.

    python3 tools/decide94_ab.py NAME=SOURCE.cu[:NVCC_FLAGS] ...

Each variant (a copy of the kernel's source: an earlier version from a
``git archive``, or one cut down by hand to time a part of it) is built by
nvcc into its own shared library, all at once, and bound with the
wrapper's C signature.  Each is run at the first chunk of chip_smoke.py's
enc94_dev encoder cell (16 files, Fmax 272, slots (0,0), (1,0), (1,3))
under the default params and under the wrap-refinement params, and timed
three times by chip_smoke's device timer (20 launches queued behind a
device sleep).  A variant whose name contains "full" must equal
decide94_plain bit for bit.  Prints the card's name and power limit, each
build's nvcc report and one line per (params, variant).
"""

import os
import sys

import torch

import encode94_ab as ab

OUT = os.path.join(ab.REPO, "build", "decide94_ab")
TABLES = ("w_tab", "xa_tab", "peff_tab", "is1", "scale_mant")


def main(argv):
    if not torch.cuda.is_available():
        print("decide94_ab: no CUDA device", file=sys.stderr)
        return 1
    libs = ab.build([ab.variant(s) for s in argv], OUT, "decide_kernel")
    fns = {name: ab.bind(lib, "dcs_encode94_decide",
                         ab.kernels._SIGNATURES["dcs_encode94_decide"])
           for name, lib in libs.items()}
    dev = torch.device("cuda", 0)
    print(ab.card())
    stream = torch.cuda.current_stream(dev).cuda_stream
    for label, x in ab.chunks(dev):
        ci, tabs = x["ci"], x["tabs"]
        B, F = ci.shape[:2]
        K = x["hdr_scale"].shape[1]
        want = ab.d94.decide94_plain(ci, x["sil_max"], x["keep"], x["thr"],
                                     x["dlim"], x["cape"], x["hdr_scale"],
                                     tabs)
        for name, fn in fns.items():
            got = (torch.zeros((B, K, F, 16, 5), dtype=torch.uint8,
                               device=dev),
                   torch.zeros((B, K, F, 16, 5), dtype=torch.uint8,
                               device=dev),
                   torch.zeros((B, F, 16), dtype=torch.bool, device=dev))

            def run(fn=fn, got=got, name=name):
                err = fn(ci.data_ptr(), x["hdr_scale"].data_ptr(),
                         x["keep"].data_ptr(),
                         *[tabs[n].data_ptr() for n in TABLES],
                         x["thr"].data_ptr(), x["dlim"].data_ptr(),
                         x["cape"].data_ptr(), int(x["sil_max"]),
                         *[g.data_ptr() for g in got], B, K, F, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            run()
            torch.cuda.synchronize()
            exact = ""
            if "full" in name:
                if not all(torch.equal(a, b) for a, b in zip(want, got)):
                    raise AssertionError(f"{name} != decide94_plain")
                exact = " bit-exact"
            print(f"{label} B={B} F={F} K={K} {name}: {ab.times(run)} "
                  f"ms{exact}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
