"""Generate vorbis_tables.h from the reference tree.

The only literal constant block the from-scratch Vorbis decoder needs is
FLOOR1_fromdB_LOOKUP — the 256-entry floor-1 amplitude-to-linear table the
Vorbis I specification publishes verbatim (spec §10; also present in the
reference's vendored libvorbis, floor1.c).  Like format/extract_tables.py
and gen_mp3_tables.py, the table is extracted by this transparent script
rather than retyped.

The port's copy of ``dcsexplorer_tpu/native/gen_vorbis_tables.py``.  The
committed header (byte-identical with the JAX package's) is the build's only
input.

Run:  python -m dcsexplorer_tpu_torch.native.gen_vorbis_tables <floor1.c path>
where the path is the reference's libnyquist/third_party/libvorbis/src/floor1.c.
"""

import os
import re
import sys

HEADER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src",
                      "vorbis_tables.h")


def generate(floor1_path):
    """Return the header text extracted from the reference's floor1.c."""
    src = open(floor1_path).read()
    m = re.search(r"FLOOR1_fromdB_LOOKUP\[256\]=\{(.*?)\};", src, re.S)
    if not m:
        raise RuntimeError("FLOOR1_fromdB_LOOKUP not found in reference")
    vals = re.findall(r"([0-9.eE+-]+)F", m.group(1))
    if len(vals) != 256:
        raise RuntimeError(f"expected 256 entries, found {len(vals)}")
    lines = ["// Generated by native/gen_vorbis_tables.py — do not edit.",
             "// FLOOR1_fromdB_LOOKUP: the Vorbis I floor-1 dB-to-linear",
             "// table (spec sect. 10), extracted from the reference tree.",
             "#pragma once", "",
             "static const float kFloor1FromDb[256] = {"]
    for i in range(0, 256, 4):
        row = ", ".join(f"{v}f" for v in vals[i:i + 4])
        lines.append(f"    {row},")
    lines.append("};")
    return "\n".join(lines) + "\n"


def emit(floor1_path, path=HEADER):
    text = generate(floor1_path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return path


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit("usage: python -m dcsexplorer_tpu_torch.native."
                 "gen_vorbis_tables <floor1.c path>")
    print(emit(sys.argv[1]))
