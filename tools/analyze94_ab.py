#!/usr/bin/env python3
"""Time variants of csrc/encode94_analyze.cu side by side on one GPU.

    python3 tools/analyze94_ab.py NAME=SOURCE.cu[:NVCC_FLAGS] ...
    python3 tools/analyze94_ab.py --cut NAME=SOURCE.cu ...

Each variant (a copy of the kernel's source: an earlier version from a
``git archive``, or the same source under other -D flags) is built by nvcc
into its own shared library, all at once, and bound with the wrapper's C
signature.  Each is run at the first chunk of chip_smoke.py's enc94_dev
encoder cell (16 files, Fmax 272) and timed three times by chip_smoke's
device timer (20 launches queued behind a device sleep).  A variant whose
name contains "full" must equal analyze94_plain as whole int32 words;
one that does not is reported, the others still run, and the exit code
is 1.  The float64 torch.matmul yardstick of chip_smoke.py phase 13 is
timed beside them.

--cut takes a source and adds variants of it cut by #if guards inserted
at fixed lines, with "full" in NAME read as "cut": NAME_nostore, the
coefficients' global stores behind a test that never holds (the products
and the rounding stay), for the first cut (one column a thread on the
CUDA cores) and for the tensor-core source; and for the tensor-core source
also NAME_nofq (the matrix planes left zero, fq not read), NAME_nopcm
(the span left zero, the PCM not read), NAME_nomma (no products: the
span and the planes staged, zeros stored) and NAME_empty (every block
returns at once: the launch of the grid).

Prints the card's name and power limit, each build's nvcc report and one
line per variant.
"""

import os
import sys

import torch

import encode94_ab as ab

OUT = os.path.join(ab.REPO, "build", "analyze94_ab")
SIGNATURE = ab.kernels._SIGNATURES["dcs_encode94_analyze"]
# never true: the coefficients are clipped to +-2^20 and fmax >= 1
_NEVER = "fmax + (1 << 30)"
# each source form's guards: (variant, -D flag, [(anchor, replacement)])
_CUTS = {
    "first cut": [
        ("nostore", "ANALYZE_NO_STORE", [
            ("        ci[(static_cast<size_t>(b) * fmax + f0 + f) * kCols"
             " + c] =\n",
             "#ifdef ANALYZE_NO_STORE\n"
             f"        if (v == {_NEVER})\n#endif\n"
             "        ci[(static_cast<size_t>(b) * fmax + f0 + f) * kCols"
             " + c] =\n")])],
    "tensor cores": [
        ("nostore", "ANALYZE_NO_STORE", [
            ("            dst[r * kCols + col] = stage[r * kORow + col];\n",
             "#ifdef ANALYZE_NO_STORE\n"
             f"            if (stage[r * kORow + col] == {_NEVER})\n#endif\n"
             "            dst[r * kCols + col] = stage[r * kORow + col];\n")]),
        ("nofq", "ANALYZE_NO_FQ", [
            ("        if (n0 + n < kCols) {\n",
             "#ifdef ANALYZE_NO_FQ\n        if (n0 + n < 0) {\n#else\n"
             "        if (n0 + n < kCols) {\n#endif\n")]),
        ("nopcm", "ANALYZE_NO_PCM", [
            ("        if (i < live)\n            cp_async16",
             "#ifdef ANALYZE_NO_PCM\n        if (i < 0)\n#else\n"
             "        if (i < live)\n#endif\n            cp_async16")]),
        ("nomma", "ANALYZE_NO_MMA", [
            ("    {   // first pass: p11 into acc2\n",
             "#ifndef ANALYZE_NO_MMA\n    {   // first pass: p11 into acc2\n"),
            ("    __syncthreads();\n\n    // 5. round",
             "#endif\n    __syncthreads();\n\n    // 5. round")]),
        ("empty", "ANALYZE_EMPTY", [
            ("    const int tid = threadIdx.x;\n",
             "#ifdef ANALYZE_EMPTY\n    if (fmax > 0) return;\n#endif\n"
             "    const int tid = threadIdx.x;\n")]),
    ],
}


def cut(name, src):
    """The source with the guards of its form; its cut variants."""
    with open(src) as f:
        text = f.read()
    for form, cuts in _CUTS.items():
        if all(text.count(a) == 1 for _, _, reps in cuts for a, _ in reps):
            break
    else:
        raise ValueError(f"{src}: no known source form to cut")
    for _, _, reps in cuts:
        for anchor, repl in reps:
            text = text.replace(anchor, repl)
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, f"{name}_cut.cu")
    with open(path, "w") as f:
        f.write(text)
    base = name.replace("full", "cut")
    print(f"{name}: cut as the {form} source")
    return [(f"{base}_{tag}", path, [f"-D{flag}"]) for tag, flag, _ in cuts]


def main(argv):
    if not torch.cuda.is_available():
        print("analyze94_ab: no CUDA device", file=sys.stderr)
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
    fns = {name: ab.bind(lib, "dcs_encode94_analyze", SIGNATURE)
           for name, lib in ab.build(variants, OUT,
                                     "encode94_analyze").items()}
    dev = torch.device("cuda", 0)
    print(ab.card())
    stream = torch.cuda.current_stream(dev).cuda_stream
    pcm, fq = ab.first_pcm(dev)
    B, L = pcm.shape
    F = (L - 240) // 240
    want = ab.d94.analyze94_plain(pcm, fq)
    wrong = []
    for name, fn in fns.items():
        ci = torch.full((B, F, 255), -1, dtype=torch.int32, device=dev)

        def run(fn=fn, ci=ci, name=name):
            err = fn(pcm.data_ptr(), fq.data_ptr(), ci.data_ptr(), B, F,
                     stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        run()
        torch.cuda.synchronize()
        exact = ""
        if "full" in name:
            if not torch.equal(ci, want):
                bad = (ci != want).nonzero()
                print(f"{name} != analyze94_plain at {bad.shape[0]} words, "
                      f"first {bad[:4].tolist()}")
                wrong.append(name)
                continue
            exact = " equal as int32 words"
        print(f"first chunk B={B} F={F} {name}: {ab.times(run)} ms{exact}")
    head = pcm[:, :F * 240].reshape(B, F, 240)
    tail = pcm[:, 240:240 + F * 240].reshape(B, F, 240)[:, :, :16]
    frames64 = torch.cat([head, tail], 2).double()
    fq64 = fq.double()

    def library():
        p = torch.matmul(frames64, fq64)
        return torch.floor((p + 2.0 ** 20) * 2.0 ** -21).clamp(
            -(1 << 20), 1 << 20).int()

    if not torch.equal(library(), want):
        raise AssertionError("float64 torch.matmul != analyze94_plain")
    print(f"first chunk B={B} F={F} float64 torch.matmul yardstick: "
          f"{ab.times(library)} ms")
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
