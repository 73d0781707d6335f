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

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
from dcsexplorer_tpu_torch.encoder import device94 as d94  # noqa: E402
from dcsexplorer_tpu_torch.encoder import encoder as enc  # noqa: E402
from dcsexplorer_tpu_torch.ops import kernels  # noqa: E402

OUT = os.path.join(REPO, "build", "decide94_ab")
TABLES = ("w_tab", "xa_tab", "peff_tab", "is1", "scale_mant")


def build(variants):
    """{name: the variant's dcs_encode94_decide}; prints each report."""
    os.makedirs(OUT, exist_ok=True)
    nvcc = kernels._nvcc()
    procs = [subprocess.Popen(
        [nvcc, *kernels.NVCC_FLAGS, "-shared", *flags, src, "-o",
         os.path.join(OUT, f"{name}.so")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, src, flags in variants]
    fns = {}
    for (name, _, _), p in zip(variants, procs):
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        print(f"build {name}: "
              + " | ".join(chip_smoke._ptxas_lines(out, "decide_kernel")))
        fn = ctypes.CDLL(os.path.join(OUT, f"{name}.so")).dcs_encode94_decide
        fn.argtypes = kernels._SIGNATURES["dcs_encode94_decide"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main(argv):
    if not torch.cuda.is_available():
        print("decide94_ab: no CUDA device", file=sys.stderr)
        return 1
    variants = []
    for spec in argv:
        name, rest = spec.split("=", 1)
        src, _, flags = rest.partition(":")
        variants.append((name, src, flags.split()))
    fns = build(variants)
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    jobs, _ = chip_smoke.enc_jobs(16)
    slots = d94._select_formats(enc.CompressionParams())
    tabs = dict(d94.DeviceEncoder94.for_slots(list(slots), dev)
                .named_buffers())
    wrap = enc.CompressionParams(target_bit_rate=48000,
                                 maximum_quantization_error=40 / 32768,
                                 minimum_dynamic_range=60 / 32768)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for label, prm in (("default", enc.CompressionParams()), ("wrap", wrap)):
        _, _, pcm, _, arrs = d94.prepare_chunk(jobs, prm, slots)
        t = {k: torch.tensor(np.asarray(v), device=dev)
             for k, v in arrs.items() if k != "sil_max"}
        ci = d94.analyze94_plain(torch.tensor(pcm, device=dev), tabs["fq"])
        B, F = ci.shape[:2]
        K = len(slots)
        args = (ci, arrs["sil_max"], t["keep"], t["thr"], t["dlim"],
                t["cape"], t["hdr_scale"])
        want = d94.decide94_plain(*args, tabs)
        for name, fn in fns.items():
            got = (torch.zeros((B, K, F, 16, 5), dtype=torch.uint8,
                               device=dev),
                   torch.zeros((B, K, F, 16, 5), dtype=torch.uint8,
                               device=dev),
                   torch.zeros((B, F, 16), dtype=torch.bool, device=dev))

            def run(fn=fn, got=got):
                err = fn(ci.data_ptr(), t["hdr_scale"].data_ptr(),
                         t["keep"].data_ptr(),
                         *[tabs[n].data_ptr() for n in TABLES],
                         t["thr"].data_ptr(), t["dlim"].data_ptr(),
                         t["cape"].data_ptr(), int(arrs["sil_max"]),
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
            ms = [chip_smoke._device_ms(run, 20, torch) for _ in range(3)]
            print(f"{label} B={B} F={F} K={K} {name}: "
                  + ", ".join(f"{m:.4f}" for m in ms) + f" ms{exact}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
