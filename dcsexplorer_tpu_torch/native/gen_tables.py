"""Generate the C header of DCS format tables for the native runtime, from
the port's own ``format/tables.py`` (the tables ``src/dcs_native.cpp``
reads)."""

import os

import numpy as np

from ..format import tables as T


def emit(path):
    def arr(name, a, ctype="int32_t"):
        vals = ", ".join(str(int(v)) for v in np.asarray(a).reshape(-1))
        return f"static const {ctype} {name}[] = {{ {vals} }};\n"

    cb_flat = np.concatenate([np.asarray(T.CODEBOOKS[i]) for i in range(1, 7)])
    cb_base = [0, 0, 4, 12, 44, 172, 428]
    out = ["// generated by dcsexplorer_tpu_torch.native.gen_tables"
           " — do not edit\n",
           "#pragma once\n#include <stdint.h>\n"]
    out.append(arr("kHuffTree94", T.HUFFTREE94))
    out.append(arr("kCodebookFlat", cb_flat))
    out.append(arr("kCodebookBase", np.asarray(cb_base)))
    out.append(arr("kMaxBitWidth", T.MAX_BIT_WIDTH))
    out.append(arr("kBandOutputCount", T.BAND_OUTPUT_COUNT))
    out.append(arr("kScaleMantissa", T.SCALE_MANTISSA))
    out.append(arr("kPreAdj0", T.PREADJ0))
    out.append(arr("kPreAdj3", T.PREADJ3))
    out.append(arr("kXlat02", T.XLAT02))
    out.append(arr("kXlat35", T.XLAT35))
    out.append(arr("kXlat6F", T.XLAT6F))
    out.append(arr("kHuffTree93", T.HUFFTREE93))
    out.append(arr("kOs93aInputsPerBand", T.OS93A_INPUTS_PER_BAND))
    out.append(arr("kOs93aBandBitsBooks", T.OS93A_BAND_BITS_CODEBOOKS))
    out.append(arr("kOs93aScaleBook", T.OS93A_SCALE_CODEBOOK))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write("".join(out))
    os.replace(tmp, path)
    return path
