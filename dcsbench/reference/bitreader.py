"""MSB-first packed-bit reader over ROM/stream bytes.

Semantics match the reference's ROMBitPointer (DCSDecoder/DCSDecoderNative.h:229-289):
a 32-bit lookahead buffer filled a byte at a time, with peek/get of 1..24 bits.
"""

M32 = 0xFFFFFFFF


class BitReader:
    """Bit cursor over a byte buffer (bytes, bytearray, or np.uint8 array)."""

    __slots__ = ("mem", "pos", "buf", "nbits")

    def __init__(self, mem, pos=0):
        self.mem = mem
        self.pos = pos      # index of the next byte to pull into the lookahead
        self.buf = 0        # 32-bit lookahead, bits left-justified
        self.nbits = 0      # valid bits in the lookahead

    def clone(self):
        r = BitReader(self.mem, self.pos)
        r.buf = self.buf
        r.nbits = self.nbits
        return r

    def peek(self, n):
        while self.nbits <= n:
            self.buf |= int(self.mem[self.pos]) << (24 - self.nbits)
            self.buf &= M32
            self.pos += 1
            self.nbits += 8
        return (self.buf >> (32 - n)) & ((1 << n) - 1)

    def get(self, n):
        v = self.peek(n)
        self.nbits -= n
        self.buf = (self.buf << n) & M32
        return v

    def get_signed(self, n):
        v = self.get(n)
        if v & (1 << (n - 1)):
            v -= 1 << n
        return v


class PaddedView:
    """Byte view returning $FF past the end — mirrors the hardware's behavior
    of reading $FF from unpopulated ROM space (reference: DCSDecoder.cpp:267-283).
    The bit reader's lookahead may prefetch a few bytes past a stream's final
    bit; this keeps standalone (non-ROM) buffers safe to overread."""

    __slots__ = ("mem", "n")

    def __init__(self, mem):
        self.mem = mem
        self.n = len(mem)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.mem[i] if i < self.n else 0xFF
