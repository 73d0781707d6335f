#!/usr/bin/env python3
"""Time variants of csrc/encode94_select.cu side by side on one GPU.

    python3 tools/select94_ab.py NAME=SOURCE.cu[:NVCC_FLAGS] ...
    python3 tools/select94_ab.py --cut NAME=SOURCE.cu ...

Each variant (a copy of the kernel's source: an earlier version from a
``git archive``, or the same source under other -D flags) is built by nvcc
into its own shared library, all at once, and bound with the wrapper's C
signature.  Each is run at the first chunk of chip_smoke.py's enc94_dev
encoder cell (16 files, Fmax 272, slots (0,0), (1,0), (1,3)) under the
default params and under the wrap-refinement params, on the decisions of
decide94_plain, and timed three times by chip_smoke's device timer (20
launches queued behind a device sleep).  A variant whose name contains
"full" must equal select94_plain bit for bit.  Where a variant's library
exports dcs_encode94_select_parts (the scan launch and the size launch
apart), its two launches are timed alone too, each after a whole run has
left its inputs in the scratch.

--cut takes the first cut's source (two kernels, one C entry) and adds
three variants of it, cut by #if guards inserted at its launch lines:
NAME_scan (the size launch removed: the scan alone), NAME_size (the scan
replaced by a kernel that only clears the size sums: the codes a whole run
left in the scratch are the known codes; the sizes, winner and packing)
and NAME_sizenp (the same without the winner and the packed row), with
"full" in NAME read as "cut".

Prints the card's name and power limit, each build's nvcc report and one
line per (params, variant).
"""

import os
import sys

import torch

import encode94_ab as ab

OUT = os.path.join(ab.REPO, "build", "select94_ab")
TABLES = ("w_tab", "xa_tab", "peff_tab", "is1", "scale_mant", "pip", "dep",
          "cb_bits", "tz_bits", "delta_bits")
SIGNATURE = ab.kernels._SIGNATURES["dcs_encode94_select"]
PARTS = ab.kernels._SIGNATURES["dcs_encode94_select_parts"]
# the first cut's guards: each anchor (once in its source) and its
# replacement
_CUTS = (
    ("    encode94_size_kernel<<<",
     "#ifndef SELECT_NO_SIZE\n    encode94_size_kernel<<<"),
    ("        nbits, done, packed, K, fmax);\n",
     "        nbits, done, packed, K, fmax);\n#endif\n"),
    ("    if (tid == 0) done[b] = 0;\n",
     "    if (tid == 0) done[b] = 0;\n#ifdef SELECT_NO_SCAN\n    return;\n"
     "#endif\n"),
    ("    if (!s_last) return;\n",
     "    if (!s_last) return;\n#ifdef SELECT_NO_PACK\n    return;\n"
     "#endif\n"),
)


def cut(name, src):
    """The first cut's source with the guards; its three variants."""
    with open(src) as f:
        text = f.read()
    for anchor, repl in _CUTS:
        if text.count(anchor) != 1:
            raise ValueError(f"{src}: not the first cut's source ({anchor!r})")
        text = text.replace(anchor, repl)
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, f"{name}_cut.cu")
    with open(path, "w") as f:
        f.write(text)
    base = name.replace("full", "cut")
    return [(f"{base}_scan", path, ["-DSELECT_NO_SIZE"]),
            (f"{base}_size", path, ["-DSELECT_NO_SCAN"]),
            (f"{base}_sizenp", path, ["-DSELECT_NO_SCAN", "-DSELECT_NO_PACK"])]


def bind(lib):
    """(dcs_encode94_select, dcs_encode94_select_parts or None, the size
    sums a (stream, slot) of its scratch) of a variant's library: the
    layout its source reports, or the first cut's one sum."""
    parts = None
    if hasattr(lib, "dcs_encode94_select_parts"):
        parts = ab.bind(lib, "dcs_encode94_select_parts", PARTS)
    sums = 1
    if hasattr(lib, "dcs_encode94_select_layout"):
        sums = ab.kernels.encode94_select_layout(lib)[0]
    return ab.bind(lib, "dcs_encode94_select", SIGNATURE), parts, sums


def main(argv):
    if not torch.cuda.is_available():
        print("select94_ab: no CUDA device", file=sys.stderr)
        return 1
    variants = []
    cut_next = False
    for spec in argv:
        if spec == "--cut":
            cut_next = True
            continue
        variants.append(ab.variant(spec))
        if cut_next:
            variants += cut(*variants[-1][:2])
            cut_next = False
    fns = {name: bind(lib)
           for name, lib in ab.build(variants, OUT, "encode94_").items()}
    dev = torch.device("cuda", 0)
    print(ab.card())
    stream = torch.cuda.current_stream(dev).cuda_stream
    for label, x in ab.chunks(dev):
        ci, tabs = x["ci"], x["tabs"]
        B, F = ci.shape[:2]
        K = x["hdr_scale"].shape[1]
        dec = ab.d94.decide94_plain(ci, x["sil_max"], x["keep"], x["thr"],
                                    x["dlim"], x["cape"], x["hdr_scale"],
                                    tabs)
        sel = (ci, *dec, x["nf"], x["keep"], x["hdr_scale"], x["wanted"])
        want = ab.d94.select94_plain(*sel, tabs)
        # scratch as the wrapper allocates it, reused dirty from run to run
        codes = torch.empty((B, K, F, 16), dtype=torch.uint8, device=dev)
        pidx = torch.empty_like(codes)
        done = torch.empty((B,), dtype=torch.int32, device=dev)
        packed = torch.zeros_like(want)
        for name, (fn, parts, sums) in fns.items():
            nbits = torch.empty((B, K, sums), dtype=torch.int32, device=dev)
            args = ([t.data_ptr() for t in sel]
                    + [tabs[n].data_ptr() for n in TABLES]
                    + [tabs["delta_bits"].numel()]
                    + [t.data_ptr() for t in (codes, pidx, nbits, done,
                                              packed)]
                    + [B, K, F])

            def run(fn=fn, name=name, args=args):
                err = fn(*args, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            packed.zero_()
            run()
            torch.cuda.synchronize()
            exact = ""
            if "full" in name:
                if not torch.equal(packed, want):
                    raise AssertionError(f"{name} != select94_plain")
                exact = " bit-exact"
            line = (f"{label} B={B} F={F} K={K} {name}: {ab.times(run)} "
                    f"ms{exact}")
            if parts is not None:
                for part, what in ((1, "scan"), (2, "size")):
                    def run_part(part=part, args=args, parts=parts,
                                 name=name):
                        err = parts(*args, part, stream)
                        if err:
                            raise RuntimeError(f"{name}: CUDA error {err}")
                    run()
                    line += f"; {what} alone {ab.times(run_part)}"
                run()
                torch.cuda.synchronize()
                if "full" in name and not torch.equal(packed, want):
                    raise AssertionError(f"{name}: parts left a wrong row")
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
