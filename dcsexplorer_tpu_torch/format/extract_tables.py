"""Extract the DCS format's constant tables from the reference implementation.

The DCS audio format is defined by a set of constant tables (Huffman codebooks,
band-translation tables, IFFT twiddle factors, bit-reversal permutation, overlap
window, scale factors).  These are *format constants* — facts of the bitstream
format, normatively documented in the reference's format spec
(reference: DCSDecoder/Doc/DCS_format_reference.html) and embodied in
DCSDecoder/DCSDecoderNative.cpp — and must be reproduced exactly for bit-exact
decode.  This script parses them out of the reference source (read-only, at
the root the caller names) and regenerates ``tables_data.npz``.

Run:  python -m dcsexplorer_tpu_torch.format.extract_tables ref_root [out.npz]

The port's copy of ``dcsexplorer_tpu/format/extract_tables.py``; its default
output is the port's own ``format/tables_data.npz``.  The reference root has
no default: without it the CLI exits with its usage, and without the
reference source under it it raises FileNotFoundError naming the path it
looked for; it writes nothing in either case.  tests/test_torch_tools_rest.py holds it against the JAX extractor
on a source rendered from the npz, and re-runs the real extraction when the
reference tree is available.
"""

import os
import re
import sys

import numpy as np

REF_NATIVE = "DCSDecoder/DCSDecoderNative.cpp"
USAGE = ("usage: python -m dcsexplorer_tpu_torch.format.extract_tables "
         "ref_root [out.npz]")


def _read(path):
    with open(path, "r", errors="replace") as f:
        return f.read()


def _parse_ints(body):
    """Parse a C initializer body into a list of ints (handles 0x hex)."""
    out = []
    for tok in re.findall(r"-?(?:0x[0-9a-fA-F]+|\d+)", body):
        out.append(int(tok, 0))
    return out


def _array_body(src, name):
    """Find `name[...] = { ... };` and return the initializer text."""
    m = re.search(re.escape(name) + r"\s*\[[^\]]*\]\s*=\s*\{", src)
    if not m:
        raise KeyError(f"array {name} not found")
    start = m.end()
    depth = 1
    i = start
    while depth > 0:
        c = src[i]
        if c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
        i += 1
    return src[start:i - 1]


def _strip_comments(text):
    text = re.sub(r"//[^\n]*", "", text)
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return text


def extract(ref_root):
    path = os.path.join(ref_root, REF_NATIVE)
    if not os.path.exists(path):
        raise FileNotFoundError(f"reference source not found: {path}")
    src = _read(path)

    def ints(name, n=None, dtype=np.int64):
        vals = _parse_ints(_strip_comments(_array_body(src, name)))
        if n is not None and len(vals) != n:
            raise ValueError(f"{name}: expected {n} values, got {len(vals)}")
        return np.array(vals, dtype=dtype)

    t = {}
    # transform tables (reference: DCSDecoderNative.cpp:314-383)
    t["overlap_coeff"] = ints("overlapCoefficients", 16, np.uint16)
    t["bitrev9"] = ints("bitRev9", 512, np.int32)
    t["ifft_coeff"] = ints("ifftCoefficients", 256, np.uint16)

    # 94x band-type delta Huffman tree (reference: DCSDecoderNative.cpp:1804-1813)
    t["hufftree94"] = ints("huffTree", None, np.uint16)

    # 94x pre-adjustment maps and band translation tables (:1744-1761, 1926-1954)
    t["preadj0"] = ints("preAdjMap0", 16, np.uint16)
    t["preadj3"] = ints("preAdjMap3", 16, np.uint16)
    for nm, key in (("xlatBand02", "xlat02"), ("xlatBand35", "xlat35"),
                    ("xlatBand6F", "xlat6f")):
        vals = _parse_ints(_strip_comments(_array_body(src, nm)))
        t[key] = np.array(vals, dtype=np.int32).reshape(16, 2)

    # per-band output counts and codebook max widths (:1848-1850, 2005)
    t["band_output_count"] = ints("outputCountTab", 16, np.int32)
    t["max_bit_width"] = ints("maxBitWidthTab", 7, np.int32)

    # sample codebooks 1..6 (:2046-2175); entry = (nbits<<8) | value
    for i, size in ((1, 4), (2, 8), (3, 32), (4, 128), (5, 256), (6, 512)):
        t[f"codebook{i}"] = ints(f"codebook{i}", size, np.uint16)

    # scale factor mantissas (:1978, :2342)
    t["scale_mantissa"] = ints("scalingFactorTable", 4, np.uint16)

    # 93 band-type Huffman tree (:2633-2650) — note entries are full ints
    t["hufftree93"] = ints("huffTree", None, np.uint16)  # first match is 94x!

    # the two trees share the local name "huffTree"; disambiguate by finding
    # the second occurrence
    first = re.search(r"huffTree\s*\[\]\s*=\s*\{", src)
    second = re.search(r"huffTree\s*\[\]\s*=\s*\{", src[first.end():])
    body_start = first.end() + second.end()
    depth, i = 1, body_start
    while depth > 0:
        c = src[i]
        if c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
        i += 1
    t["hufftree93"] = np.array(
        _parse_ints(_strip_comments(src[body_start:i - 1])), dtype=np.uint16)

    # OS93a Type-1 tables (:2698-2902)
    t["os93a_pair_table"] = ints("os93a_type1_samplePairTable", 2048, np.uint16)
    t["os93a_inputs_per_band"] = ints("inputsPerBand", 18, np.int32)
    bb = _parse_ints(_strip_comments(_array_body(src, "bandBitsCodebooks")))
    t["os93a_band_bits_codebooks"] = np.array(bb, dtype=np.int64).reshape(64, 2)
    sc = _parse_ints(_strip_comments(_array_body(src, "scaleCodebook")))
    t["os93a_scale_codebook"] = np.array(sc, dtype=np.int64).reshape(80, 3)

    return t


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit(USAGE)
    ref_root = argv[0]
    out = argv[1] if len(argv) > 1 else os.path.join(
        os.path.dirname(__file__), "tables_data.npz")
    t = extract(ref_root)
    np.savez_compressed(out, **t)
    for k, v in sorted(t.items()):
        print(f"{k}: shape={v.shape} dtype={v.dtype}")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
