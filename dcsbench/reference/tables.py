"""DCS format constant tables.

Loaded from ``tables_data.npz``, the benchmark's frozen copy of the port's
tables (extracted from the normative reference decoder).  These are
facts of the bitstream format — Huffman codebooks, band translation tables,
IFFT twiddles, the bit-reversal permutation, the overlap-add window, and the
scale-factor mantissas — required verbatim for bit-exact decode.

Reference anchors: DCSDecoder/DCSDecoderNative.cpp:314-383 (transform tables),
:1744-1954 (band maps), :2046-2183 (codebooks), :2633-2650 (93 tree),
:2698-2902 (OS93a Type-1 tables).
"""

import os

import numpy as np

_npz = np.load(os.path.join(os.path.dirname(__file__), "tables_data.npz"))

# overlap-add window coefficients, 16 × uint16 (1.15 unsigned fractions)
OVERLAP_COEFF = _npz["overlap_coeff"].astype(np.int64)

# 9-bit bit-reversal permutation, 512 entries
BITREV9 = _npz["bitrev9"].astype(np.int64)

# IFFT twiddles: [0:128] = sin bank, [128:256] = cos bank, 1.15 signed,
# stored in the transform's bit-reversed access order
IFFT_COEFF = _npz["ifft_coeff"].astype(np.int64)

# 94x band-type delta Huffman tree (binary tree; $8000 marks terminals,
# terminal value excess $2E)
HUFFTREE94 = _npz["hufftree94"].astype(np.int64)

# 94x per-band scaling pre-adjustment maps (by previous frame's band type)
PREADJ0 = _npz["preadj0"].astype(np.int64)
PREADJ3 = _npz["preadj3"].astype(np.int64)

# 94x Type-1 band translation tables: [band type code] -> (type, scale adj)
XLAT02 = _npz["xlat02"].astype(np.int64)   # bands 0..2
XLAT35 = _npz["xlat35"].astype(np.int64)   # bands 3..5
XLAT6F = _npz["xlat6f"].astype(np.int64)   # bands 6..15

# outputs per band (94x): 7, 8, 16×13, 32
BAND_OUTPUT_COUNT = _npz["band_output_count"].astype(np.int64)

# max codeword length per codebook index (1..6); index 0 unused
MAX_BIT_WIDTH = _npz["max_bit_width"].astype(np.int64)

# sample codebooks, flat max-width lookup: entry = (nbits << 8) | value;
# value bit $80 = "emit two zeros"
CODEBOOKS = [None] + [_npz[f"codebook{i}"].astype(np.int64) for i in range(1, 7)]

# scale factor mantissas for 2-bit mantissa codes
SCALE_MANTISSA = _npz["scale_mantissa"].astype(np.int64)  # 8000 9838 B505 D745

# 93 band-type Huffman tree (lo byte = '0' child, hi byte = '1' child,
# $8000 marks terminals)
HUFFTREE93 = _npz["hufftree93"].astype(np.int64)

# OS93a Type-1 tables
OS93A_PAIR_TABLE = _npz["os93a_pair_table"].astype(np.int64)          # 1024 pairs
OS93A_INPUTS_PER_BAND = _npz["os93a_inputs_per_band"].astype(np.int64)  # 18
OS93A_BAND_BITS_CODEBOOKS = _npz["os93a_band_bits_codebooks"].astype(np.int64)  # 64×(bandBits, prefixBits)
OS93A_SCALE_CODEBOOK = _npz["os93a_scale_codebook"].astype(np.int64)  # 80×(value, nBits, subTable)

# fixed format constants
SAMPLE_RATE = 31250        # Hz (reference: DCSDecoder.h:123)
FRAME_SAMPLES = 240        # PCM samples per frame (7.68 ms)
FRAME_BUFFER_SIZE = 512    # frequency-domain working buffer
MAX_CHANNELS = 8           # mixer voices (reference: DCSDecoderNative.h:305)
