"""Extract the MPEG-1 Layer III format constants into mp3_tables.h.

The MP3 Huffman codebooks, scalefactor-band edges, and the synthesis-
filterbank window are normative constants of ISO/IEC 11172-3 — facts of
the bitstream format, required verbatim for a correct decoder.  Like the
DCS format tables (format/extract_tables.py), they are extracted from the
reference tree by this transparent script rather than retyped by hand:
the packed lookup tables in libnyquist's vendored minimp3
(reference: libnyquist/third_party/minimp3/minimp3.h) are *decoded* back
into canonical (value, codeword, length) lists, verified for prefix-code
consistency, and emitted in this repo's own representation.  The decoder
in native/src/mp3.cpp is written from the ISO decoding model and shares
no structure with minimp3 beyond these constants.

Run:  python -m dcsexplorer_tpu_torch.native.gen_mp3_tables <minimp3.h path>
Regenerates native/src/mp3_tables.h from the reference's minimp3.h
(libnyquist/third_party/minimp3/minimp3.h), which must be given.

The port's copy of ``dcsexplorer_tpu/native/gen_mp3_tables.py``.  The
committed header is the build's only input; it is byte-identical with the
JAX package's (tests/test_torch_audio_readers.py), so the generator writes
the same first line as the JAX package's.
"""

import os
import re
import sys

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "src", "mp3_tables.h")


def _parse_array(text, name, dtype=int):
    m = re.search(
        r"(?:int16_t|uint8_t|float)\s+" + re.escape(name) +
        r"\s*\[[^\]]*\]\s*(?:\[[^\]]*\]\s*)*=\s*\{(.*?)\};",
        text, re.DOTALL)
    if not m:
        raise ValueError(f"array {name} not found")
    body = re.sub(r"[{}\s]", "", m.group(1))
    vals = [v for v in body.split(",") if v]
    if dtype is float:
        return [float(v.rstrip("f")) for v in vals]
    return [int(v) for v in vals]


def recover_bigvalue_table(tabs, index):
    """Walk the packed two-level lookup back to canonical codes.

    Returns {(x, y): (length, codeword)}; verified consistent."""
    out = {}

    def explore(prefix, plen, rel, width):
        for q in range(1 << width):
            leaf = tabs[index + rel + q]
            if leaf < 0:
                # sub-table offsets are relative to the table's own base
                explore((prefix << width) | q, plen + width,
                        -(leaf >> 3), leaf & 7)
            else:
                clen = leaf >> 8
                if clen == 0:
                    continue          # unused slot (incomplete code space)
                # the packed leaf stores the first decoded value (ISO "x")
                # in the LOW nibble
                x, y = leaf & 15, (leaf >> 4) & 15
                code = (((prefix << width) | q) >> (width - clen))
                val = (plen + clen, code)
                prev = out.setdefault((x, y), val)
                if prev != val:
                    raise ValueError(
                        f"inconsistent entry ({x},{y}): {prev} vs {val}")

    explore(0, 0, 0, 5)
    # prefix-code sanity: no codeword is a prefix of another
    codes = sorted((l, c) for (l, c) in out.values())
    for i, (l1, c1) in enumerate(codes):
        for (l2, c2) in codes[i + 1:]:
            if l2 >= l1 and (c2 >> (l2 - l1)) == c1 and (l1, c1) != (l2, c2):
                raise ValueError("prefix violation")
    return out


def recover_count1_a(tab32):
    """Canonical quad codes for count1 table A."""
    out = {}
    for p in range(16):
        leaf = tab32[p]
        if leaf & 8:
            tot = leaf & 7
            val = (leaf >> 4) & 15
            code = p >> (4 - tot)
            prev = out.setdefault(val, (tot, code))
            if prev != (tot, code):
                raise ValueError("count1A inconsistency")
        else:
            base, w2 = leaf >> 3, leaf & 3
            for q in range(1 << w2):
                leaf2 = tab32[base + q]
                tot = leaf2 & 7
                val = (leaf2 >> 4) & 15
                code = ((p << w2) | q) >> (4 + w2 - tot)
                prev = out.setdefault(val, (tot, code))
                if prev != (tot, code):
                    raise ValueError("count1A inconsistency")
    assert len(out) == 16
    return out


_PROBE_C = r"""
// Probe: recover the composite synthesis-filterbank impulse response
// (matrixing + windowed overlap, a normative constant of the format) by
// driving the reference implementation with unit impulses.
#define MINIMP3_IMPLEMENTATION
#define MINIMP3_FLOAT_OUTPUT
#define MINIMP3_NO_SIMD
#include "minimp3.h"
#include <stdio.h>
#include <string.h>

int main() {
    static float qmf[15*64], grbuf[2][576], lins[2*1152 + 15*64];
    static float pcm[2*1152];
    for (int sb = 0; sb < 32; sb++) {
        memset(qmf, 0, sizeof qmf);
        memset(grbuf, 0, sizeof grbuf);
        grbuf[0][sb*18 + 0] = 1.0f;          // impulse at (subband, t=0)
        mp3d_synth_granule(qmf, grbuf[0], 18, 2, (mp3d_sample_t*)pcm, lins);
        for (int j = 0; j < 16; j++)
            for (int i = 0; i < 32; i++)
                printf("%.9g\n", pcm[(j*32 + i)*2]);
        // verify the response is dead beyond 16 steps
        for (int j = 16; j < 18; j++)
            for (int i = 0; i < 32; i++)
                if (pcm[(j*32 + i)*2] != 0.0f) { printf("TAIL\n"); return 1; }
        memset(grbuf, 0, sizeof grbuf);
        mp3d_synth_granule(qmf, grbuf[0], 18, 2, (mp3d_sample_t*)pcm, lins);
        for (int j = 0; j < 18; j++)
            for (int i = 0; i < 32; i++)
                if (pcm[(j*32 + i)*2] != 0.0f) { printf("TAIL2\n"); return 1; }
    }
    return 0;
}
"""


def probe_synth(src_path):
    """Compile and run the impulse probe → H[32][16][32] floats."""
    import subprocess
    import tempfile
    with tempfile.TemporaryDirectory() as td:
        cpath = os.path.join(td, "probe.c")
        with open(cpath, "w") as f:
            f.write(_PROBE_C)
        exe = os.path.join(td, "probe")
        subprocess.run(["gcc", "-O1", f"-I{os.path.dirname(src_path)}",
                        cpath, "-lm", "-o", exe], check=True)
        out = subprocess.run([exe], check=True, capture_output=True,
                             text=True).stdout.split()
    assert "TAIL" not in out and "TAIL2" not in out
    vals = [float(v) for v in out]
    assert len(vals) == 32 * 16 * 32
    return vals


def generate(src_path):
    text = open(src_path).read()
    tabs = _parse_array(text, "tabs")
    tabindex = _parse_array(text, "tabindex")
    tab32 = _parse_array(text, "tab32")
    linbits = _parse_array(text, "g_linbits")
    scf_long = _parse_array(text, "g_scf_long")
    scf_short = _parse_array(text, "g_scf_short")
    scf_mixed = _parse_array(text, "g_scf_mixed")

    lines = []
    w = lines.append
    w("// Generated by dcsexplorer_tpu/native/gen_mp3_tables.py — do not edit.")
    w("// MPEG-1 Layer III normative constants (ISO/IEC 11172-3): Huffman")
    w("// codebooks in canonical (x, y, length, codeword) form, scalefactor")
    w("// band tables, and the synthesis window.  See the generator for")
    w("// provenance.")
    w("#pragma once")
    w("#include <cstdint>")
    w("")
    w("namespace mp3tab {")
    w("")
    w("struct HuffEntry { uint8_t x, y, len; uint32_t code; };")
    w("")

    # big-value tables (0..31; 0/4/14 carry no codes)
    sizes = []
    entries = []
    for t in range(32):
        idx = tabindex[t]
        table = recover_bigvalue_table(tabs, idx) if (idx or t == 0) else {}
        if t == 0:
            table = {}
        items = sorted(table.items())
        sizes.append(len(items))
        entries.append(items)
    w("static const HuffEntry kBigValue[] = {")
    for t in range(32):
        for ((x, y), (l, c)) in entries[t]:
            w(f"    {{{x}, {y}, {l}, 0x{c:x}u}},")
    w("};")
    offs = [0]
    for t in range(32):
        offs.append(offs[-1] + sizes[t])
    w(f"static const int kBigValueOffset[33] = {{{', '.join(map(str, offs))}}};")
    w("static const uint8_t kLinbits[32] = {" + ",".join(map(str, linbits)) + "};")
    w("")

    c1 = recover_count1_a(tab32)
    w("static const HuffEntry kCount1A[16] = {")
    for val in range(16):
        l, c = c1[val]
        w(f"    {{{val}, 0, {l}, 0x{c:x}u}},")
    w("};")
    w("")

    def emit_u8(name, vals, per):
        w(f"static const uint8_t {name}[] = {{")
        for i in range(0, len(vals), per):
            w("    " + ",".join(map(str, vals[i:i + per])) + ",")
        w("};")

    emit_u8("kScfLong", scf_long, 23)      # [8][23]
    emit_u8("kScfShort", scf_short, 40)    # [8][40]
    emit_u8("kScfMixed", scf_mixed, 40)    # [8][40]
    w("")
    # composite synthesis response: PCM(t,i) = sum_{sb,j} H[sb][j][i]·X[sb][t-j]
    # (matrixing + D-window overlap folded together; scale = float PCM in
    # [-1,1]).  Recovered by impulse probing the reference filterbank.
    synth = probe_synth(src_path)

    def flit(v):
        s = f"{v:.9g}"
        if "e" not in s and "." not in s:
            s += ".0"
        return s + "f"

    w("static const float kSynthH[32*16*32] = {")
    for i in range(0, len(synth), 8):
        w("    " + ",".join(flit(v) for v in synth[i:i + 8]) + ",")
    w("};")
    w("")
    w("}  // namespace mp3tab")
    w("")
    return "\n".join(lines)


def main():
    if len(sys.argv) != 2:
        sys.exit("usage: python -m dcsexplorer_tpu_torch.native."
                 "gen_mp3_tables <minimp3.h path>")
    out = generate(sys.argv[1])
    with open(OUT, "w") as f:
        f.write(out)
    print(f"wrote {OUT} ({len(out)} bytes)")


if __name__ == "__main__":
    main()
