"""Wildcard ADSP-2105 opcode pattern search with variable capture.

The benchmark's frozen copy of the port's ROM loader.

ROM programs store 24-bit opcodes big-endian in 4-byte units.  Patterns are
strings of 6-hex-digit opcodes separated by spaces; '*' is a wildcard nibble
and letters outside A-F name capture variables spanning consecutive nibbles.

Semantics mirror the reference's detector (DCSDecoder.cpp:1734-1908), which
the HW/OS/channel-count detection relies on.
"""


def _parse_pattern(pattern):
    ops = []          # (opcode, mask)
    varspecs = []     # (name, op_offset, shift, mask)
    ofs = 0
    i = 0
    p = pattern
    n = len(p)
    while i < n:
        while i < n and p[i] == " ":
            i += 1
        if i >= n:
            break
        opcode = 0
        mask = 0
        cur = None  # (name, shift, mask)
        digits = 0
        while i < n and p[i] != " " and digits < 6:
            c = p[i]
            if c in "0123456789abcdefABCDEF":
                opcode = (opcode << 4) | int(c, 16)
                mask = (mask << 4) | 0xF
                if cur:
                    varspecs.append((cur[0], ofs, cur[1], cur[2]))
                    cur = None
            elif c == "*":
                opcode <<= 4
                mask <<= 4
                if cur:
                    varspecs.append((cur[0], ofs, cur[1], cur[2]))
                    cur = None
            else:
                if cur and cur[0] != c:
                    varspecs.append((cur[0], ofs, cur[1], cur[2]))
                    cur = None
                # shift tracks the LAST nibble of the span; mask accumulates
                shift = 20 - digits * 4
                if cur is None:
                    cur = (c, shift, 0xF)
                else:
                    cur = (c, shift, (cur[2] << 4) | 0xF)
                opcode <<= 4
                mask <<= 4
            i += 1
            digits += 1
        if cur:
            varspecs.append((cur[0], ofs, cur[1], cur[2]))
        ops.append((opcode, mask))
        ofs += 1
    return ops, varspecs


def search_opcodes_words(pattern, words, start=0):
    """Search a 24-bit opcode word array (e.g. emulator PM space).

    Mirrors the reference's PM-space SearchForOpcodes
    (DCSDecoderEmu.cpp:593-597).  Returns (word_index, vars) or (-1, None).
    """
    ops, varspecs = _parse_pattern(pattern)
    n = len(words)
    for addr in range(start, n - len(ops) + 1):
        matched = True
        for j, (op, mask) in enumerate(ops):
            if (words[addr + j] & mask) != op:
                matched = False
                break
        if matched:
            out = {}
            for (name, ofs, shift, mask) in varspecs:
                out[name] = (words[addr + ofs] >> shift) & mask
            return addr, out
    return -1, None


def search_opcodes(pattern, rom_data, start=0):
    """Search raw ROM bytes for the opcode pattern.

    rom_data: byte buffer (opcodes at 4-byte strides, big-endian 24-bit).
    start: starting BYTE offset.  Returns (byte_offset, vars) or (-1, None).
    """
    ops, varspecs = _parse_pattern(pattern)
    n_ops = len(rom_data) // 4

    def fetch(k):
        b = rom_data[k * 4:k * 4 + 3]
        return (b[0] << 16) | (b[1] << 8) | b[2]

    for addr in range(start // 4, n_ops - len(ops)):
        matched = True
        for j, (op, mask) in enumerate(ops):
            if (fetch(addr + j) & mask) != op:
                matched = False
                break
        if matched:
            out = {}
            for (name, ofs, shift, mask) in varspecs:
                # later spans of the same variable replace earlier ones,
                # matching the reference's map semantics
                out[name] = (fetch(addr + ofs) >> shift) & mask
            return addr * 4, out
    return -1, None
