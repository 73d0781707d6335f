"""What tools/analyze94_ab.py, decide94_ab.py and select94_ab.py share:
the parallel nvcc build of a kernel's source variants, the card's name
and power limit, the encoder chunk they time, and the device timer.

A variant is (name, source.cu, extra nvcc flags), from the command line's
NAME=SOURCE.cu[:NVCC_FLAGS].  Each builds into its own shared library
under build/<tool>/ with the package's nvcc flags, finding the package's
headers (csrc/) unless its own directory holds a copy.
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

# the package's kernel sources: a variant's source finds their headers here
# unless its own directory holds a copy
CSRC = os.path.join(REPO, "dcsexplorer_tpu_torch", "csrc")
# the wrap-refinement params of the encoder's tests
WRAP = dict(target_bit_rate=48000, maximum_quantization_error=40 / 32768,
            minimum_dynamic_range=60 / 32768)


def variant(spec):
    """NAME=SOURCE.cu[:NVCC_FLAGS] -> (name, source, [flags])."""
    name, rest = spec.split("=", 1)
    src, _, flags = rest.partition(":")
    return name, src, flags.split()


def build(variants, out_dir, kernel):
    """{name: its loaded library}: one nvcc a variant, all at once; prints
    the -Xptxas -v lines of each build's kernels whose names contain
    ``kernel``."""
    os.makedirs(out_dir, exist_ok=True)
    nvcc = kernels._nvcc()
    procs = [subprocess.Popen(
        [nvcc, *kernels.NVCC_FLAGS, "-shared", "-I", CSRC, *flags, src, "-o",
         os.path.join(out_dir, f"{name}.so")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, src, flags in variants]
    libs = {}
    for (name, _, _), p in zip(variants, procs):
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        print(f"build {name}: "
              + " | ".join(chip_smoke._ptxas_lines(out, kernel)))
        libs[name] = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
    return libs


def bind(lib, entry, argtypes):
    """lib's C entry with its argument types, returning an int."""
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def card():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def chunks(dev):
    """chip_smoke.py's first enc94_dev chunk (16 files, Fmax 272, slots
    (0,0), (1,0), (1,3)) under the default and the wrap-refinement params:
    yields (label, a dict of the chunk's tensors on dev: ci, nf, the
    prepared arrays' (keep, thr, ..., wanted), sil_max, tabs)."""
    jobs, _ = chip_smoke.enc_jobs(16)
    slots = d94._select_formats(enc.CompressionParams())
    tabs = dict(d94.DeviceEncoder94.for_slots(list(slots), dev)
                .named_buffers())
    for label, prm in (("default", enc.CompressionParams()),
                       ("wrap", enc.CompressionParams(**WRAP))):
        _, _, pcm, nf, arrs = d94.prepare_chunk(jobs, prm, slots)
        x = {k: torch.tensor(np.asarray(v), device=dev)
             for k, v in arrs.items() if k != "sil_max"}
        x["sil_max"] = arrs["sil_max"]
        x["ci"] = d94.analyze94_plain(torch.tensor(pcm, device=dev),
                                      tabs["fq"])
        x["nf"] = torch.tensor(nf, device=dev)
        x["tabs"] = tabs
        yield label, x


def first_pcm(dev):
    """The first enc94_dev chunk's PCM as the analysis takes it (16 files,
    int16 [16, 272*240 + 240]) and the analysis matrix, on dev."""
    jobs, _ = chip_smoke.enc_jobs(16)
    params = enc.CompressionParams()
    slots = d94._select_formats(params)
    _, _, pcm, _, _ = d94.prepare_chunk(jobs, params, slots)
    return (torch.tensor(pcm, device=dev),
            torch.tensor(enc.forward_matrix_q(), device=dev))


def times(run):
    """Three device times of run, ms: chip_smoke's timer (20 launches
    queued behind a device sleep), as text."""
    return ", ".join(f"{chip_smoke._device_ms(run, 20, torch):.4f}"
                     for _ in range(3))
