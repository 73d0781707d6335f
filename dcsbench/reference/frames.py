"""Scalar frame decompressors for the three DCS stream format families.

Each function decodes one frame from a channel's bitstream and accumulates the
scaled frequency-domain samples into the shared 512-entry frame buffer (uint16
values carried as Python ints), exactly reproducing the reference decoder's
fixed-point arithmetic.

Format semantics anchors (reference files, for parity checking):
- 1994+ family: DCSDecoder/DCSDecoderNative.cpp:1679-2261
- 1993 family (OS93a Type 0, OS93b Type 0/1): :2293-2615, ReadHuff93 :2618-2684
- OS93a Type 1 (Judge Dredd): :2831-3032
"""

from . import tables as T
from .fixed import M16, M64, mr1, round_mr, s16, sat16


class StreamState:
    """Per-channel audio-stream decode state (header copy, band-type deltas,
    frame/loop counters, bit cursor).  Mirrors Channel::AudioStream
    (reference: DCSDecoderNative.h:364-454)."""

    __slots__ = ("mem", "header_pos", "header_len", "start_pos", "bit",
                 "header", "band_type", "frame_counter", "num_frames",
                 "loop_counter")

    def __init__(self):
        self.mem = None          # byte buffer holding the stream
        self.header_pos = 0      # offset of the 16-byte stream header
        self.header_len = 16
        self.start_pos = 0       # offset of the first bit-stream byte
        self.bit = None          # BitReader, or None when not playing
        self.header = [0] * 16   # local header copy (set at playback init)
        self.band_type = [0] * 16  # differential band-type accumulator
        self.frame_counter = 0
        self.num_frames = 0
        self.loop_counter = 0

    @property
    def playing(self):
        return self.bit is not None


def _accum(frame_buf, idx, sample, scale, mix):
    """Scale-and-mix one band sample into the frame buffer.

    Replicates (reference: DCSDecoderNative.cpp:2244-2250):
      scaled = low16(int16(sample) * uint16(scale))
      prod   = (int16(out[idx]) << 16) | scaled
      prod  += int16(scaled) * uint16(mix)
      out[idx] = bits 16..31 of prod
    """
    scaled = (s16(sample) * (scale & M16)) & M16
    prod = (s16(frame_buf[idx]) << 16) | scaled
    prod += s16(scaled) * (mix & M16)
    frame_buf[idx] = (prod >> 16) & M16


def decompress_frame_94x(stream: StreamState, frame_buf, mix):
    """Decode one 1994+ frame into frame_buf.  Returns False on stream error
    (caller must stop the channel), True otherwise."""
    hdr = stream.header
    bit = stream.bit

    outbuf1 = frame_buf[1]

    fmt_type = (hdr[0] & 0x80) >> 7
    sub_type = ((hdr[1] & 0x80) >> 6) | ((hdr[2] & 0x80) >> 7)
    preadj_map = T.PREADJ0 if sub_type == 0 else T.PREADJ3

    # pre-adjustments for bands 0..2 from the PREVIOUS frame's band types
    preadj = [int(preadj_map[stream.band_type[i]]) for i in range(3)]

    # frame header: per-band Huffman-coded deltas to the band-type accumulator
    tree = T.HUFFTREE94
    for i in range(16):
        if (hdr[i] & 0x7F) == 0x7F:
            break
        node = 0
        while True:
            b = bit.get(1)
            node += int(tree[node]) if b else 1
            if tree[node] & 0x8000:
                break
        stream.band_type[i] = (stream.band_type[i] + (int(tree[node]) & 0xFF) - 0x2E) & M16

    ok = True
    out_idx = 1
    for band in range(16):
        cur_hdr = hdr[band] & 0x7F
        if cur_hdr == 0x7F:
            break

        out_count = int(T.BAND_OUTPUT_COUNT[band])
        out_inc = 1
        if cur_hdr & 0x40:
            out_inc = 2
            out_count //= 2

        band_type = stream.band_type[band]
        if band_type == 0:
            out_idx += out_count
            continue

        scale_code = cur_hdr
        if fmt_type != 0:
            if band < 3:
                cur_hdr += preadj[band]
                xlat = T.XLAT02
            elif band < 6:
                xlat = T.XLAT35
            else:
                xlat = T.XLAT6F
            if band_type > 15:
                # out-of-range accumulated band type: only possible on
                # garbage input (the original reads out of its tables
                # here); flag the error and mask, same as ops/prescan.py
                ok = False
                band_type &= 0xF
            band_type = int(xlat[band_type][0])
            scale_code = cur_hdr + int(xlat[stream.band_type[band] & 0xF][1])

        scale = (int(T.SCALE_MANTISSA[scale_code & 3])
                 >> (15 - ((scale_code >> 2) & 0xF)))

        samples = []
        if band_type == 0:
            ok = False
        elif band_type <= 6:
            ref_val = 1 << (band_type - 1)
            maxw = int(T.MAX_BIT_WIDTH[band_type])
            book = T.CODEBOOKS[band_type]
            i = out_count
            while i != 0:
                look = bit.peek(maxw)
                entry = int(book[look])
                val = entry & 0xFF
                bit.get(entry >> 8)
                if val & 0x80:
                    if i >= 2:
                        samples.append(0)
                        samples.append(0)
                        i -= 1
                    else:
                        ok = False
                        i = 1
                else:
                    samples.append((val - ref_val) & M16)
                i -= 1
        else:
            w = band_type if band_type <= 17 else 17
            if w != band_type:
                ok = False      # garbage width (same clamp as the prescan)
            for _ in range(out_count):
                samples.append(bit.get_signed(w) & M16)

        if not ok:
            samples = [0] * out_count
        # pad (an error path can leave the list short)
        while len(samples) < out_count:
            samples.append(0)

        for i in range(out_count):
            _accum(frame_buf, out_idx, samples[i], scale, mix)
            out_idx += out_inc

    # first-sample delta fixup (reference: DCSDecoderNative.cpp:2254-2257)
    delta = sat16(s16(frame_buf[1]) - s16(outbuf1))
    frame_buf[0] = sat16(s16(delta) + s16(frame_buf[0]))
    frame_buf[1] = outbuf1
    return ok


def _read_huff93(bit, band_sub_type):
    """Read a 93-format band-type delta; may invert the band subtype.
    Returns (delta, new_sub_type)."""
    tree = T.HUFFTREE93
    ele = int(tree[0])
    while True:
        b = bit.get(1)
        idx = (ele >> 8) & 0x7F if b else ele & 0xFF
        ele = int(tree[idx])
        if ele & 0x8000:
            break
    val = ele & 0x3F
    if val < 0x1E:
        val -= 0x0F
    else:
        val -= 0x2E
        band_sub_type = 0 if band_sub_type != 0 else 1
    return val, band_sub_type


def decompress_frame_93(stream: StreamState, frame_buf, mix):
    """Decode one 1993-format frame (OS93a Type 0 / OS93b Type 0 and 1)."""
    bit = stream.bit
    mem = stream.mem
    hdr_pos = stream.header_pos

    outbuf1 = frame_buf[1]

    fmt_type = (int(mem[hdr_pos]) & 0x80) >> 7
    band_sub_type = 0 if fmt_type == 1 else 2

    is_first_band = True
    prv_input = 0
    prv_delta = 0
    reuse_type = False
    cur_type = 0
    out_idx = 1

    for band in range(16):
        if hdr_pos >= stream.header_pos + 16:
            break
        cur_hdr = int(mem[hdr_pos]) & 0x7F
        hdr_pos += 1
        if cur_hdr == 0x7F:
            break

        sf_index = cur_hdr & 3
        sf_shift = ((cur_hdr >> 2) & 0xF) - 0xF   # negative or zero
        stride_code = cur_hdr >> 6

        mant = int(T.SCALE_MANTISSA[sf_index]) & 0xFFFFFFFF
        if sf_shift >= 0:
            scale = (mant << sf_shift) & M16
        else:
            scale = (mant >> -sf_shift) & M16

        if fmt_type == 0:
            if stride_code == 0:
                n_samples, out_inc, out_fix, out_stride = 16, 1, 0, 16
            else:
                out_idx += 1
                n_samples, out_inc, out_fix, out_stride = 16, 2, -1, 31
        else:
            if stride_code == 0:
                n_samples = out_stride = 15 if is_first_band else 16
                out_inc, out_fix = 1, 0
            else:
                n_samples = out_stride = 8
                out_inc, out_fix = 2, 0

        if reuse_type:
            reuse_type = bit.get(1) != 0

        if not reuse_type:
            if fmt_type == 0:
                if bit.get(1) != 0:
                    if bit.get(1) != 0:
                        band_sub_type = (0x0001, 0x0002, 0x0000)[band_sub_type]
                    else:
                        band_sub_type = (0x0002, 0x0000, 0x0001)[band_sub_type]
                cur_type = bit.get(4)
            else:
                delta, band_sub_type = _read_huff93(bit, band_sub_type)
                stream.band_type[band] = (stream.band_type[band] + delta) & M16
                cur_type = stream.band_type[band]

        if cur_type == 0:
            # no new inputs: zeros / repeat / ramp, depending on subtype
            reuse_type = True
            if band_sub_type == 0:
                out_idx += out_stride
                prv_input = 0
                prv_delta = 0
            elif band_sub_type == 1:
                # NOTE: replicates the original ROM's rounding anomaly — the
                # product's low word carries across loop iterations
                # (reference: DCSDecoderNative.cpp:2470-2534)
                prod = s16(prv_input) * (scale & M16)
                prod_low = s16(prod & M16)
                for _ in range(n_samples):
                    prod = (prod & M16) | (s16(frame_buf[out_idx]) << 16)
                    prod += prod_low * (mix & M16)
                    frame_buf[out_idx] = (prod >> 16) & M16
                    out_idx += out_inc
                prv_delta = 0
                out_idx += out_fix
            else:
                for _ in range(n_samples):
                    prv_input = (prv_input + prv_delta) & M16
                    _accum(frame_buf, out_idx, prv_input, scale, mix)
                    out_idx += out_inc
                out_idx += out_fix
        else:
            bit_width = cur_type + (1 if fmt_type == 0 else 0)
            inputs = [bit.get_signed(bit_width) & M16 for _ in range(n_samples)]

            if band_sub_type == 0:
                for v in inputs:
                    _accum(frame_buf, out_idx, v, scale, mix)
                    out_idx += out_inc
                prv_input = inputs[-1]
                prv_delta = (inputs[-1] - inputs[-2]) & M16
            elif band_sub_type == 1:
                for v in inputs:
                    prv_delta = v
                    prv_input = (prv_input + v) & M16
                    _accum(frame_buf, out_idx, prv_input, scale, mix)
                    out_idx += out_inc
            else:
                for v in inputs:
                    prv_delta = (prv_delta + v) & M16
                    prv_input = (prv_input + prv_delta) & M16
                    _accum(frame_buf, out_idx, prv_input, scale, mix)
                    out_idx += out_inc
            out_idx += out_fix

        is_first_band = False

    delta = sat16(s16(frame_buf[1]) - s16(outbuf1))
    frame_buf[0] = sat16(s16(delta) + s16(frame_buf[0]))
    frame_buf[1] = outbuf1
    return True


def decompress_frame_93a_type1(stream: StreamState, frame_buf, mix):
    """Decode one OS93a Type-1 frame (Judge Dredd's unique format)."""
    bit = stream.bit
    hdr_byte = int(stream.mem[stream.header_pos])

    prv_scale_code = 0x1A
    selector = hdr_byte & 0x60
    num_bands = hdr_byte & 0x1F

    band_books = T.OS93A_BAND_BITS_CODEBOOKS  # 64×(bandBits, prefixBits)
    scale_book = T.OS93A_SCALE_CODEBOOK       # 80×(value, nBits, subTable)
    pair_table = T.OS93A_PAIR_TABLE

    book_base = selector >> 1  # 16 entries per group, selector ∈ {0,0x20,0x40,0x60}
    out_idx = 0
    for band in range(num_bands):
        n_inputs = int(T.OS93A_INPUTS_PER_BAND[band])

        ele = band_books[book_base + bit.peek(4)]
        band_bits = int(ele[0]) & M16
        bit.get(int(ele[1]))
        if band_bits == 0xFFFF:
            break

        if band_bits != 0:
            sc = scale_book[bit.peek(4)]
            bit.get(int(sc[1]))
            if (int(sc[0]) & M16) == 0xFFFF:
                sc = scale_book[int(sc[2]) + bit.peek(4)]
                bit.get(int(sc[1]) - 4)

            scale_code = prv_scale_code + int(sc[0]) - 1 + band_bits * 2
            if scale_code > 0x39:
                scale_code -= 0x36
            prv_scale_code = scale_code - band_bits * 2

            shift = scale_code >> 2
            exponent = scale_code & 3
            scale = 0x8000
            for _ in range(exponent):
                scale = (scale * 0x9838) >> 15
            scale = (scale << shift) & M64  # uint32 in reference; shifts < 16
            scale &= 0xFFFFFFFF
            scale = ((scale >> 16) * (mix & M16)) >> 15

            base = 2 << band_bits
            for _ in range(n_inputs):
                sample = bit.get(band_bits)
                p = base + sample * 2
                for k in range(2):
                    mr = (frame_buf[out_idx] << 16) & M64
                    prod = (s16(int(pair_table[p + k])) * s16(scale)) << 1
                    mr = (mr + prod) & M64
                    v, _ = round_mr(mr, prod)
                    frame_buf[out_idx] = v
                    out_idx += 1
        else:
            out_idx += n_inputs * 2
    return True
