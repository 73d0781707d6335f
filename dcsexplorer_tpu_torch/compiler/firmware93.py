"""Synthesized OS93 (1993-format) decoding firmware for generated ROM sets.

The 1993 counterpart of compiler/firmware94.py: a complete ADSP-2105
implementation of the OS93b decoder runtime.  The board contract, boot
block, byte/bit readers, IRQ2 data-port protocol, track byte-code VM
(with the 1993 grammar's operand-free $06), volume fold, and mixing
update are shared with the 94 firmware (firmware94's emitters, via the
``_variant`` hook); this module contributes the 1993 frame decompressor
and the 1993 inverse transform, which differ from the 94x family exactly
where bit-exactness is hardest:

- frame decode:  refdec/frames.py::decompress_frame_93
  (reference: DCSDecoderNative.cpp:2293-2615) — per-band subtype state
  machine (independent / differential / doubly-differential), reuse bit,
  4-bit or Huffman band types with subtype-inverting tree values
  (ReadHuff93, :2618-2684), and the deliberately replicated rounding
  anomaly of the subtype-1 repeat loop (:2470-2534): the MAC's low
  product word carries across loop iterations.
- transform:     refdec/transform.py::transform_frame_93  (:614-813) —
  5-term Taylor sqrt magnitude fixup of element 0 in 1.15 arithmetic,
  256→512 expansion, 7-iteration IFFT (unsaturated), bit-reversed
  volume-shift extraction into the odd slots, 16-sample overlap-add.

A generated OS93b ROM carrying this firmware decodes audio through the
emulator backend (emu/board.py) bit-identically to the native scalar
decoder — closing the two-backend validation loop (reference:
DCSDecoderEmu.cpp:359-395) for the 1993 format family.

The port's copy of ``dcsexplorer_tpu/compiler/firmware93.py``.
"""

import struct

from ..format import tables as T
from . import firmware94 as f94
from .asm import (ADD, AF, AR, ASHIFT_HI, AX0, AX1, AY0, AY1, CNTR, EQ,
                  EXP_HI,
                  EXP_LO, GE, LSHIFT_LO, LSHIFT_LO_OR, LT, M0, M1, M2, M3,
                  M6, MAC_RND, MAC_SS, MAC_SU, MF, MR, MR0, MR1, MSUB_RND,
                  MUL_RND, MUL_SS, MUL_SU, MUL_UU, MX0, MX1, MY0, MY1, NE,
                  NEG_Y,
                  NORM_HI, NORM_LO_OR, NOT_AC, I0, I1, I2, I3, I4, PASS,
                  RSUB, SE, SI, SR0, SR1, SUB, Y_DEC, Y_INC)
from .firmware94 import SYM, S_BT, S_HDR

OVERLAY_ROM_ADDR = f94.OVERLAY_ROM_ADDR
TABLES_ROM_ADDR = f94.TABLES_ROM_ADDR
OVERLAY_PM = f94.OVERLAY_PM
overlay_blob = f94.overlay_blob

TAB93 = 0x0400              # hw2 table base (the 93 firmware is hw2-only)


def _table_words():
    words = []
    layout = {}

    def put(name, vals):
        layout[name] = TAB93 + len(words)
        words.extend(int(v) & 0xFFFF for v in vals)

    put("T_SIN", T.IFFT_COEFF[:128])
    put("T_COS", T.IFFT_COEFF[128:256])
    put("T_BR", T.BITREV9[:256])
    put("T_OVLC", T.OVERLAP_COEFF)
    put("T_MANT", T.SCALE_MANTISSA)
    put("T_HUFF93", T.HUFFTREE93)
    assert TAB93 + len(words) < 0x0E00, len(words)
    return words, layout


TABLE_WORDS, TLAY = _table_words()
FW_RESERVE = (OVERLAY_ROM_ADDR, TABLES_ROM_ADDR + 2 * len(TABLE_WORDS))


def _table_words_93a():
    """The 93 tables plus the OS93a Type-1 codebooks (appended, so the
    shared tables keep their 93 offsets).  The 2048-entry pair table does
    NOT fit the DM table window; it stays in ROM (PAIR_ROM_ADDR_93A) and
    the decoder reads entries through the byte-reader cursor."""
    words, layout = list(TABLE_WORDS), dict(TLAY)

    def put(name, vals):
        layout[name] = TAB93 + len(words)
        words.extend(int(v) & 0xFFFF for v in vals)

    put("T_A_BB", [int(v) & 0xFFFF
                   for row in T.OS93A_BAND_BITS_CODEBOOKS for v in row])
    put("T_A_SB", [int(v) & 0xFFFF
                   for row in T.OS93A_SCALE_CODEBOOK for v in row])
    put("T_A_IN", T.OS93A_INPUTS_PER_BAND)
    assert TAB93 + len(words) < 0x0E00, len(words)
    return words, layout


TABLE_WORDS_93A, TLAY_93A = _table_words_93a()
PAIR_ROM_ADDR_93A = TABLES_ROM_ADDR + 2 * len(TABLE_WORDS_93A)
FW_RESERVE_93A = (OVERLAY_ROM_ADDR,
                  PAIR_ROM_ADDR_93A + 2 * len(T.OS93A_PAIR_TABLE))


def table_blob():
    """The ROM byte image of the 93 decoder tables (big-endian words)."""
    return b"".join(struct.pack(">H", w) for w in TABLE_WORDS)


def table_blob_93a():
    """93a ROM tables: the DM-loaded words plus the ROM-resident
    Type-1 pair table."""
    return (b"".join(struct.pack(">H", w) for w in TABLE_WORDS_93A)
            + b"".join(struct.pack(">H", int(v) & 0xFFFF)
                       for v in T.OS93A_PAIR_TABLE))


def build_decoder_firmware(catalog_ofs=0x3000, reported_version=0x0106,
                           default_volume=0x67, os93a=False):
    """Assemble the OS93b (or, with ``os93a``, the OS93a) decoding
    firmware (DCS audio board, hw 2).

    Returns (boot_words, overlay_words, symbols) — same contract as
    firmware94.build_decoder_firmware.  The 93a variant adds the Type-1
    (Judge Dredd) frame decompressor, 1-byte Type-1 stream headers, the
    1993a op $04 host-event-timer grammar, and the fixed $7FFF mixing
    base (reference: DCSDecoderNative.cpp:2687-2781, :1089-1116)."""
    return f94.build_decoder_firmware(
        catalog_ofs=catalog_ofs, hw_version=2,
        reported_version=reported_version, default_volume=default_volume,
        _variant={
            "table_words": TABLE_WORDS_93A if os93a else TABLE_WORDS,
            "tlay": TLAY_93A if os93a else TLAY,
            "emit_decode": _emit_decode93a if os93a else _emit_decode93,
            "emit_transform": _emit_transform93,
            "os93": True,
            "os93a": os93a,
        })


# ----------------------------------------------------------------------
# frame decompressor (refdec/frames.py::decompress_frame_93)

def _emit_decode93(a):
    f94._emit_decode_driver(a)
    _emit_dec_frame93(a)


def _emit_decode93a(a):
    """OS93a decode: dispatch each frame on the stream's header bit 7 —
    set selects the Type-1 decompressor (refdec _decompress_frame)."""
    f94._emit_decode_driver(a)
    a.label("dec_frame")
    a.lds(AX0, "STB")
    a.add_imm(AX0, S_HDR)
    a.mov(I1, AR)
    a.ld_i(AX1, I1, M0)                 # hdr[0]
    a.and_imm(AX1, 0x80)
    a.cmp_imm(AR, 0)
    a.jump("dec_t1", NE)
    a.jump("dec_f93")
    _emit_dec_frame93(a, label="dec_f93")
    _emit_dec_frame93a_t1(a)


def _emit_dec_frame93(a, label="dec_frame"):
    """One 1993-format frame for the current channel.  Entry state (set
    by the shared decode driver): MY1 = mixing multiplier, STB/CHB point
    at the stream/channel blocks, bit-reader scalars loaded."""
    FB = f94.FB

    a.label(label)
    a.ena_int()                         # integer MAC mode (no product <<1)
    a.c16(AR, 0)
    a.sts("ERRF", AR)
    a.sts("PRV_IN", AR)
    a.sts("PRV_DL", AR)
    a.sts("REUSE", AR)
    a.sts("BTYPE", AR)                  # cur_type
    a.sts("BANDNO", AR)
    a.c16(AR, 1)
    a.sts("FBAND", AR)                  # is_first_band
    a.ld(AX0, FB + 1)
    a.sts("OUTB1", AX0)
    a.c16(AR, FB + 1)
    a.sts("OUTIDX", AR)
    # fmt_type = hdr[0] >> 7; band_sub_type = 0 (type 1) / 2 (type 0)
    a.lds(AX0, "STB")
    a.add_imm(AX0, S_HDR)
    a.mov(I1, AR)
    a.ld_i(SI, I1, M0)
    a.shift_imm(LSHIFT_LO, SI, -7)
    a.sts("FMT", SR0)
    a.mov(AX0, SR0)
    a.cmp_imm(AX0, 0)
    a.c16(AR, 0)                        # type 1 → subtype 0
    a.c16(AY0, 2)
    a.alu(AR, PASS, None, AY0, EQ)      # type 0 → subtype 2
    a.sts("BSUB", AR)

    # ------------------------------------------------------------------
    a.label("b93_loop")
    a.lds(AX0, "BANDNO")
    a.cmp_imm(AX0, 16)
    a.jump("b93_done", EQ)
    # cur_hdr = hdr[band] & 0x7F; 0x7F terminates
    a.lds(AX0, "STB")
    a.add_imm(AX0, S_HDR)
    a.ld(AY1, SYM["BANDNO"])
    a.alu(AR, ADD, AR, AY1)
    a.mov(I1, AR)
    a.ld_i(AX0, I1, M0)
    a.and_imm(AX0, 0x7F)
    a.sts("CURHDR", AR)
    a.cmp_imm(AR, 0x7F)
    a.jump("b93_done", EQ)

    # scale = mant[hdr&3] shifted by ((hdr>>2)&0xF) − 15  → MY0
    a.lds(SI, "CURHDR")
    a.shift_imm(LSHIFT_LO, SI, -2)
    a.mov(AX0, SR0)
    a.and_imm(AX0, 0xF)
    a.c16(AY0, 15)
    a.alu(AR, SUB, AR, AY0)
    a.mov(SE, AR)
    a.lds(AX0, "CURHDR")
    a.and_imm(AX0, 3)
    a.add_imm(AR, TLAY["T_MANT"])
    a.mov(I1, AR)
    a.ld_i(SI, I1, M0)
    a.shift_se(LSHIFT_LO, SI)
    a.mov(MY0, SR0)                     # scale (invariant per band)

    # sample count / output stepping from fmt_type × stride_code
    # (refdec: n_samples, out_inc, out_fix, out_stride)
    a.lds(SI, "CURHDR")
    a.shift_imm(LSHIFT_LO, SI, -6)
    a.mov(AX1, SR0)                     # stride_code
    a.lds(AX0, "FMT")
    a.cmp_imm(AX0, 0)
    a.jump("b93_p1", NE)
    # --- type 0
    a.cmp_imm(AX1, 0)
    a.jump("b93_p0s", NE)
    a.c16(AR, 16)
    a.sts("OUTCNT", AR)
    a.sts("OSTR", AR)
    a.c16(AR, 1)
    a.sts("OUTINC", AR)
    a.c16(AR, 0)
    a.sts("OUTFIX", AR)
    a.jump("b93_pd")
    a.label("b93_p0s")                  # type 0, interleaved
    a.lds(AY0, "OUTIDX")
    a.alu(AR, Y_INC, None, AY0)
    a.sts("OUTIDX", AR)                 # out_idx += 1 first
    a.c16(AR, 16)
    a.sts("OUTCNT", AR)
    a.c16(AR, 31)
    a.sts("OSTR", AR)
    a.c16(AR, 2)
    a.sts("OUTINC", AR)
    a.c16(AR, -1)
    a.sts("OUTFIX", AR)
    a.jump("b93_pd")
    a.label("b93_p1")                   # --- type 1
    a.cmp_imm(AX1, 0)
    a.jump("b93_p1s", NE)
    a.c16(AR, 16)                       # 15 on the first band
    a.lds(AX0, "FBAND")
    a.cmp_imm(AX0, 0)
    a.c16(AY0, 15)
    a.alu(AR, PASS, None, AY0, NE)
    a.sts("OUTCNT", AR)
    a.sts("OSTR", AR)
    a.c16(AR, 1)
    a.sts("OUTINC", AR)
    a.c16(AR, 0)
    a.sts("OUTFIX", AR)
    a.jump("b93_pd")
    a.label("b93_p1s")                  # type 1, interleaved
    a.c16(AR, 8)
    a.sts("OUTCNT", AR)
    a.sts("OSTR", AR)
    a.c16(AR, 2)
    a.sts("OUTINC", AR)
    a.c16(AR, 0)
    a.sts("OUTFIX", AR)
    a.label("b93_pd")

    # reuse bit: a set flag re-arms only if the stream says so
    a.lds(AX0, "REUSE")
    a.cmp_imm(AX0, 0)
    a.jump("b93_rd", EQ)
    a.call("get1")
    a.sts("REUSE", AR)
    a.label("b93_rd")
    a.lds(AX0, "REUSE")
    a.cmp_imm(AX0, 0)
    a.jump("b93_body", NE)
    # read a fresh band type
    a.lds(AX0, "FMT")
    a.cmp_imm(AX0, 0)
    a.jump("b93_ht", NE)
    # type 0: optional subtype rotation, then 4 raw bits
    a.call("get1")
    a.cmp_imm(AR, 0)
    a.jump("b93_t4", EQ)
    a.call("get1")
    a.cmp_imm(AR, 0)
    a.c16(AR, 1)                        # second bit set → +1 mod 3
    a.c16(AY0, 2)
    a.alu(AR, PASS, None, AY0, EQ)      # clear → +2 mod 3
    a.lds(AY0, "BSUB")
    a.alu(AR, ADD, AR, AY0)
    a.cmp_imm(AR, 3)
    a.c16(AY0, 3)
    a.alu(AR, SUB, AR, AY0, GE)
    a.sts("BSUB", AR)
    a.label("b93_t4")
    a.c16(AX0, 4)
    a.call("getu")
    a.sts("BTYPE", AR)
    a.jump("b93_body")
    a.label("b93_ht")
    # type 1: Huffman delta accumulates into the per-band type state
    a.call("h93")                       # AR = delta (may flip BSUB)
    a.mov(AX1, AR)
    a.lds(AX0, "STB")
    a.add_imm(AX0, S_BT)
    a.ld(AY1, SYM["BANDNO"])
    a.alu(AR, ADD, AR, AY1)
    a.mov(I1, AR)
    a.ld_i(AY1, I1, M0)
    a.alu(AR, ADD, AX1, AY1)
    a.st_i(I1, M0, AR)
    a.sts("BTYPE", AR)

    # ------------------------------------------------------------------
    a.label("b93_body")
    a.lds(AX0, "BTYPE")
    a.cmp_imm(AX0, 0)
    a.jump("b93_data", NE)
    # --- cur_type == 0: zeros / repeat / ramp by subtype --------------
    a.c16(AR, 1)
    a.sts("REUSE", AR)
    a.lds(AX0, "BSUB")
    a.cmp_imm(AX0, 1)
    a.jump("b93_z1", EQ)
    a.cmp_imm(AX0, 2)
    a.jump("b93_z2", EQ)
    # subtype 0: skip out_stride outputs, reset predictors
    a.lds(AX0, "OUTIDX")
    a.ld(AY1, SYM["OSTR"])
    a.alu(AR, ADD, AX0, AY1)
    a.sts("OUTIDX", AR)
    a.c16(AR, 0)
    a.sts("PRV_IN", AR)
    a.sts("PRV_DL", AR)
    a.jump("b93_next")
    a.label("b93_z1")
    # subtype 1 repeat: replicated rounding anomaly — the MAC's low
    # product word (MR0) carries across iterations while MR1 is replaced
    # by each output word (reference: DCSDecoderNative.cpp:2470-2534)
    a.lds(AR, "PRV_IN")
    a.mac(MR, MUL_SU, AR, MY0)          # prod = prv·scale (integer)
    a.mov(MX0, MR0)                     # prod_low, fixed for the loop
    a.lds(AR, "OUTIDX")
    a.mov(I0, AR)
    a.lds(AR, "OUTINC")
    a.mov(M3, AR)
    a.lds(AR, "OUTCNT")
    a.mov(CNTR, AR)
    with a.loop_ce():
        a.ld_i(AY1, I0, M0)
        a.mov(MR1, AY1)                 # replace high word, keep MR0
        a.mac(MR, MAC_SU, MX0, MY1)     # += prod_low·mix
        a.st_i(I0, M3, MR1)
    a.mov(AR, I0)
    a.sts("OUTIDX", AR)
    a.c16(AR, 0)
    a.sts("PRV_DL", AR)
    a.jump("b93_fix")
    a.label("b93_z2")
    # subtype 2 ramp: prv_input += prv_delta each output
    a.lds(AR, "OUTIDX")
    a.mov(I0, AR)
    a.lds(AR, "OUTINC")
    a.mov(M3, AR)
    a.lds(AR, "OUTCNT")
    a.mov(CNTR, AR)
    with a.loop_ce():
        a.lds(AX0, "PRV_IN")
        a.lds(AY0, "PRV_DL")
        a.alu(AR, ADD, AX0, AY0)
        a.sts("PRV_IN", AR)
        a.call("acc93")
    a.mov(AR, I0)
    a.sts("OUTIDX", AR)
    a.jump("b93_fix")

    # --- data band ----------------------------------------------------
    a.label("b93_data")
    a.lds(AX0, "FMT")
    a.cmp_imm(AX0, 0)
    a.jump("b93_w1", NE)
    a.lds(AY0, "BTYPE")
    a.alu(AR, Y_INC, None, AY0)         # type 0: width = cur_type + 1
    a.jump("b93_wd")
    a.label("b93_w1")
    a.lds(AR, "BTYPE")                  # type 1: width = cur_type
    a.label("b93_wd")
    a.sts("MW", AR)
    a.lds(AR, "OUTIDX")
    a.mov(I0, AR)
    a.lds(AR, "OUTINC")
    a.mov(M3, AR)
    a.lds(AX0, "BSUB")
    a.cmp_imm(AX0, 1)
    a.jump("b93_d1", EQ)
    a.cmp_imm(AX0, 2)
    a.jump("b93_d2", EQ)
    # subtype 0: independent samples; predictors from the last two
    a.c16(AR, 0)
    a.sts("TMP1", AR)
    a.sts("TMP2", AR)
    a.lds(AR, "OUTCNT")
    a.mov(CNTR, AR)
    with a.loop_ce():
        a.lds(AX0, "MW")
        a.call("gets")
        a.lds(AY0, "TMP1")
        a.sts("TMP2", AY0)
        a.sts("TMP1", AR)
        a.call("acc93")
    a.lds(AR, "TMP1")
    a.sts("PRV_IN", AR)
    a.lds(AX0, "TMP1")
    a.lds(AY0, "TMP2")
    a.alu(AR, SUB, AX0, AY0)
    a.sts("PRV_DL", AR)
    a.jump("b93_dd")
    a.label("b93_d1")
    # subtype 1: differential
    a.lds(AR, "OUTCNT")
    a.mov(CNTR, AR)
    with a.loop_ce():
        a.lds(AX0, "MW")
        a.call("gets")
        a.sts("PRV_DL", AR)
        a.lds(AY0, "PRV_IN")
        a.alu(AR, ADD, AR, AY0)
        a.sts("PRV_IN", AR)
        a.call("acc93")
    a.jump("b93_dd")
    a.label("b93_d2")
    # subtype 2: doubly differential
    a.lds(AR, "OUTCNT")
    a.mov(CNTR, AR)
    with a.loop_ce():
        a.lds(AX0, "MW")
        a.call("gets")
        a.lds(AY0, "PRV_DL")
        a.alu(AR, ADD, AR, AY0)
        a.sts("PRV_DL", AR)
        a.lds(AY0, "PRV_IN")
        a.alu(AR, ADD, AR, AY0)
        a.sts("PRV_IN", AR)
        a.call("acc93")
    a.label("b93_dd")
    a.mov(AR, I0)
    a.sts("OUTIDX", AR)

    a.label("b93_fix")
    a.lds(AX0, "OUTIDX")
    a.ld(AY1, SYM["OUTFIX"])
    a.alu(AR, ADD, AX0, AY1)
    a.sts("OUTIDX", AR)
    a.label("b93_next")
    a.c16(AR, 0)
    a.sts("FBAND", AR)
    a.lds(AY0, "BANDNO")
    a.alu(AR, Y_INC, None, AY0)
    a.sts("BANDNO", AR)
    a.imm(M3, 0)
    a.jump("b93_loop")

    # ------------------------------------------------------------------
    a.label("b93_done")
    a.imm(M3, 0)
    # first-sample delta fixup (two saturating steps, refdec :141-144)
    a.ena_ar_sat()
    a.ld(AX0, FB + 1)
    a.lds(AY0, "OUTB1")
    a.alu(AR, SUB, AX0, AY0)
    a.ld(AY1, FB)
    a.alu(AR, ADD, AR, AY1)
    a.st(FB, AR)
    a.lds(AR, "OUTB1")
    a.st(FB + 1, AR)
    a.ena_ar_sat(False)
    a.ena_int(False)
    a.rts()

    # ------------------------------------------------------------------
    # acc93: scale-and-mix AR into the frame buffer at I0 (step M3)
    # — same MAC sequence as the 94 decoder's accumulate (integer mode)
    a.label("acc93")
    a.mac(MR, MUL_SU, AR, MY0)
    a.ld_i(AY1, I0, M0)
    a.mov(MR1, AY1)
    a.mac(MR, MAC_SU, MR0, MY1)
    a.st_i(I0, M3, MR1)
    a.rts()

    # h93: read one band-type delta through the 93 Huffman tree;
    # values ≥ $1E invert the band subtype (refdec _read_huff93)
    a.label("h93")
    a.imm(I1, TLAY["T_HUFF93"])
    a.ld_i(AX1, I1, M0)                 # ele = tree[0]
    a.label("h93_bit")
    a.call("get1")
    a.cmp_imm(AR, 0)
    a.jump("h93_b0", EQ)
    a.mov(SI, AX1)
    a.shift_imm(LSHIFT_LO, SI, -8)
    a.mov(AX0, SR0)
    a.and_imm(AX0, 0x7F)                # '1' child
    a.jump("h93_t")
    a.label("h93_b0")
    a.mov(AX0, AX1)
    a.and_imm(AX0, 0xFF)                # '0' child
    a.label("h93_t")
    a.add_imm(AR, TLAY["T_HUFF93"])
    a.mov(I1, AR)
    a.ld_i(AX1, I1, M0)
    a.cmp_imm(AX1, 0x8000)
    a.jump("h93_bit", NOT_AC)           # not terminal
    a.mov(AX0, AX1)
    a.and_imm(AX0, 0x3F)
    a.cmp_imm(AR, 0x1E)
    a.jump("h93_hi", GE)
    a.c16(AY0, 0x0F)
    a.alu(AR, SUB, AR, AY0)
    a.rts()
    a.label("h93_hi")
    a.c16(AY0, 0x2E)
    a.alu(AR, SUB, AR, AY0)
    a.sts("TMP0", AR)
    # invert subtype: 0 if nonzero else 1
    a.lds(AX0, "BSUB")
    a.cmp_imm(AX0, 0)
    a.c16(AY0, 1)
    a.c16(AR, 0)
    a.alu(AR, PASS, None, AY0, EQ)
    a.sts("BSUB", AR)
    a.lds(AR, "TMP0")
    a.rts()


# ----------------------------------------------------------------------
# OS93a Type-1 frame decompressor
# (refdec/frames.py::decompress_frame_93a_type1)

def _emit_dec_frame93a_t1(a):
    """One OS93a Type-1 (Judge Dredd) frame: per band, a 4-bit-prefix
    band-bits codebook in one of four selector groups, a two-level scale
    codebook feeding the running scale-code chain, then per input sample
    TWO outputs from the ROM-resident pair table, each accumulated into
    the frame buffer with one rounding MAC (fractional mode — the MAC's
    convergent-rounding quirk IS the reference's round_mr).  Reference:
    DCSDecoderNative.cpp:2687-2781."""
    FB = f94.FB

    a.label("dec_t1")
    a.c16(AR, 0)
    a.sts("ERRF", AR)
    a.sts("BANDNO", AR)
    a.c16(AR, 0x1A)
    a.sts("SCODE", AR)                  # prv_scale_code
    a.c16(AR, FB)
    a.sts("OUTIDX", AR)
    # hdr[0]: num_bands = &$1F, codebook group base = (&$60)>>1
    a.lds(AX0, "STB")
    a.add_imm(AX0, S_HDR)
    a.mov(I1, AR)
    a.ld_i(SI, I1, M0)
    a.mov(AX0, SI)
    a.and_imm(AX0, 0x1F)
    a.sts("NPART", AR)                  # num_bands
    a.shift_imm(LSHIFT_LO, SI, -1)
    a.mov(AX0, SR0)
    a.and_imm(AX0, 0x30)
    a.sts("CBB", AR)                    # book base (0/16/32/48)

    a.label("t1_loop")
    a.lds(AX0, "BANDNO")
    a.lds(AY0, "NPART")
    a.alu(AF, SUB, AX0, AY0)
    a.jump("t1_done", EQ)
    # inputs for this band
    a.c16(AR, TLAY_93A["T_A_IN"])
    a.ld(AY1, SYM["BANDNO"])
    a.alu(AR, ADD, AR, AY1)
    a.mov(I1, AR)
    a.ld_i(AR, I1, M0)
    a.sts("ICNT", AR)
    # band bits: ele = books[base + peek(4)]; consume(ele.nbits)
    a.c16(AX0, 4)
    a.call("peek")
    a.lds(AY0, "CBB")
    a.alu(AR, ADD, AR, AY0)
    a.mov(SI, AR)
    a.shift_imm(LSHIFT_LO, SI, 1)
    a.mov(AR, SR0)
    a.add_imm(AR, TLAY_93A["T_A_BB"])
    a.mov(I1, AR)
    a.ld_i(AR, I1, M1)                  # band_bits
    a.sts("MW", AR)
    a.ld_i(AX0, I1, M0)                 # prefix length
    a.call("consume")
    a.lds(AX0, "MW")
    a.cmp_imm(AX0, 0xFFFF)
    a.jump("t1_done", EQ)               # terminator
    a.cmp_imm(AX0, 0)
    a.jump("t1_zero", EQ)

    # ---- scale code: two-level 4-bit-prefix codebook ------------------
    a.c16(AX0, 4)
    a.call("peek")
    a.mov(AY1, AR)
    a.mov(SI, AR)
    a.shift_imm(LSHIFT_LO, SI, 1)
    a.alu(AR, ADD, SR0, AY1)            # 3·idx
    a.add_imm(AR, TLAY_93A["T_A_SB"])
    a.mov(I1, AR)
    a.ld_i(AR, I1, M1)                  # value
    a.sts("TMP0", AR)
    a.ld_i(AX0, I1, M1)                 # prefix length
    a.ld_i(AX1, I1, M0)                 # escape subtable base
    a.call("consume")
    a.lds(AX0, "TMP0")
    a.cmp_imm(AX0, 0xFFFF)
    a.jump("t1_scd", NE)
    # escape: sc = book[sub + peek(4)], consume(nbits - 4)
    a.c16(AX0, 4)
    a.call("peek")                      # preserves AX1 (the subtable)
    a.mov(AY0, AX1)
    a.alu(AR, ADD, AR, AY0)
    a.mov(AY1, AR)
    a.mov(SI, AR)
    a.shift_imm(LSHIFT_LO, SI, 1)
    a.alu(AR, ADD, SR0, AY1)            # 3·(sub+idx)
    a.add_imm(AR, TLAY_93A["T_A_SB"])
    a.mov(I1, AR)
    a.ld_i(AR, I1, M1)                  # value
    a.sts("TMP0", AR)
    a.ld_i(AX0, I1, M0)                 # prefix length
    a.c16(AY0, 4)
    a.alu(AR, SUB, AX0, AY0)
    a.mov(AX0, AR)
    a.call("consume")
    a.label("t1_scd")
    # scale_code = prv + value - 1 + 2·band_bits; wrap > $39 by -$36
    a.lds(AX0, "TMP0")
    a.lds(AY0, "SCODE")
    a.alu(AR, ADD, AX0, AY0)
    a.add_imm(AR, 0xFFFF)               # -1
    a.lds(SI, "MW")
    a.shift_imm(LSHIFT_LO, SI, 1)
    a.mov(AY0, SR0)
    a.alu(AR, ADD, AR, AY0)
    a.cmp_imm(AR, 0x3A)
    a.jump("t1_nw", LT)
    a.add_imm(AR, -0x36 & 0xFFFF)
    a.label("t1_nw")
    a.sts("TMP1", AR)                   # scale_code
    a.lds(SI, "MW")
    a.shift_imm(LSHIFT_LO, SI, 1)
    a.mov(AY0, SR0)
    a.alu(AR, SUB, AR, AY0)
    a.sts("SCODE", AR)                  # prv = code - 2·band_bits
    # scale = $8000 · $9838^(code&3)  (1.15 unsigned fractional muls).
    # CNTR loads push the counter stack; only load it when the loop will
    # actually run and pop it, or the stack leaks one slot per skip.
    a.lds(AX0, "TMP1")
    a.and_imm(AX0, 3)
    a.sts("TMP2", AR)
    a.cmp_imm(AR, 0)
    a.jump("t1_exp0", EQ)
    a.lds(AR, "TMP2")
    a.mov(CNTR, AR)
    a.c16(AR, 0x8000)
    a.c16(MY0, 0x9838)
    with a.loop_ce():
        a.mac(MR, MUL_UU, AR, MY0)
        a.mov(AR, MR1)
    a.jump("t1_sh")
    a.label("t1_exp0")
    a.c16(AR, 0x8000)
    a.label("t1_sh")
    a.sts("TMP3", AR)                   # mantissa
    # MY0 = ((mant << shift) >> 16) · mix >> 15   (shift = code>>2)
    a.lds(SI, "TMP1")
    a.shift_imm(LSHIFT_LO, SI, -2)
    a.mov(AR, SR0)
    a.add_imm(AR, -16 & 0xFFFF)
    a.mov(SE, AR)
    a.lds(SI, "TMP3")
    a.shift_se(LSHIFT_LO, SI)           # mant >> (16-shift), logical
    a.mac(MR, MUL_UU, SR0, MY1)
    a.mov(MY0, MR1)                     # band scale, mixed

    # ---- samples: 2 outputs per input from the ROM pair table ---------
    a.lds(AR, "OUTIDX")
    a.mov(I0, AR)
    a.lds(AR, "ICNT")
    a.mov(CNTR, AR)
    with a.loop_ce():
        a.lds(AX0, "MW")
        a.call("getu")                  # AR = raw sample (unsigned)
        a.mov(SI, AR)
        a.shift_imm(LSHIFT_LO, SI, 2)   # sample·2 entries·2 bytes
        a.mov(AY1, SR0)
        a.lds(AR, "MW")
        a.add_imm(AR, 2)
        a.mov(SE, AR)
        a.c16(SI, 1)
        a.shift_se(LSHIFT_LO, SI)       # (2<<bits)·2 bytes
        a.alu(AR, ADD, SR0, AY1)
        a.add_imm(AR, PAIR_ROM_ADDR_93A)
        a.sts("P_LO", AR)
        a.c16(AR, 0)
        a.sts("P_HI", AR)
        for _ in range(2):
            a.call("rd16")              # pair entry (big-endian)
            a.mov(MX0, AR)
            a.c16(AX1, 0)
            a.ld_i(AY1, I0, M0)
            a.mov(MR1, AY1)             # mr = fb << 16
            a.mov(MR0, AX1)
            a.mac(MR, MAC_RND, MX0, MY0)  # += pair·scale, MAC rounding
            a.st_i(I0, M1, MR1)
    a.mov(AR, I0)
    a.sts("OUTIDX", AR)
    a.jump("t1_next")

    a.label("t1_zero")                  # empty band: skip 2·n_inputs
    a.lds(SI, "ICNT")
    a.shift_imm(LSHIFT_LO, SI, 1)
    a.mov(AY0, SR0)
    a.lds(AX0, "OUTIDX")
    a.alu(AR, ADD, AX0, AY0)
    a.sts("OUTIDX", AR)
    a.label("t1_next")
    a.lds(AY0, "BANDNO")
    a.alu(AR, Y_INC, None, AY0)
    a.sts("BANDNO", AR)
    a.jump("t1_loop")
    a.label("t1_done")
    a.rts()


# ----------------------------------------------------------------------
# inverse transform (refdec/transform.py::transform_frame_93)

def _emit_transform93(a):
    FB = f94.FB
    OVLB = f94.OVLB

    a.label("transform")
    # --- sqrt magnitude fixup of element 0 (1.15 Taylor, refdec :146-183)
    a.ld(AX0, FB)
    a.c16(AR, 0)
    a.sts("TMP1", AR)                   # as_flag
    a.cmp_imm(AX0, 0)
    a.jump("t93_pos", GE)
    a.c16(AR, 1)
    a.sts("TMP1", AR)
    a.mov(AY0, AX0)
    a.alu(AR, NEG_Y, None, AY0)
    a.mov(AX0, AR)
    a.label("t93_pos")
    a.ld(MX0, FB + 1)
    a.mov(MY0, MX0)
    a.mac(MR, MUL_SS, MX0, MY0)         # (fb1²)<<1
    a.mov(AR, AX0)
    a.mov(MY1, AR)
    a.mac(MR, MAC_SS, AR, MY1)          # += (ar²)<<1
    # normalize32: exponent → TMP0, normalized mantissa → SR
    a.shift_se(EXP_HI, MR1)
    a.shift_se(EXP_LO, MR0)
    a.mov(AY0, SE)
    a.sts("TMP0", AY0)
    a.shift_se(NORM_HI, MR1)
    a.shift_se(NORM_LO_OR, MR0)
    a.mov(AR, SR1)
    a.cmp_imm(AR, 0)
    a.jump("t93_sq0", EQ)
    a.mov(MY1, AR)                      # normalized ar
    # MR = 0x0D490000 + Σ cᵢ·arⁱ  (five rounded power terms)
    a.imm(MR0, 0)
    a.imm(MR1, 0x0D49)                  # also clears MR2
    a.c16(MY0, 0x5D1D)
    a.mac(MR, MAC_SS, AR, MY0)
    a.mac(MF, MUL_RND, AR, MY1)         # mf = round(ar²)
    a.c16(MX0, -22035)
    a.mac(MR, MAC_SS, MX0, MF)
    a.mac(MF, MUL_RND, AR, MF)
    a.c16(MX0, 0x46D6)
    a.mac(MR, MAC_SS, MX0, MF)
    a.mac(MF, MUL_RND, AR, MF)
    a.c16(MX0, -8790)
    a.mac(MR, MAC_SS, MX0, MF)
    a.mac(MF, MUL_RND, AR, MF)
    a.c16(MX0, 0x072D)
    a.mac(MR, MAC_SS, MX0, MF)
    # odd exponent: one more ×1/√2 rounded multiply
    a.lds(AX0, "TMP0")
    a.and_imm(AX0, 1)
    a.cmp_imm(AR, 0)
    a.jump("t93_even", EQ)
    a.c16(MY0, 0x5A82)
    a.mac(MR, MUL_RND, MR1, MY0)
    a.lds(AY0, "TMP0")
    a.alu(AR, Y_INC, None, AY0)
    a.sts("TMP0", AR)
    a.label("t93_even")
    # shift MR by exponent/2 + 1 (even exponent: trunc = arithmetic >> 1)
    a.lds(SI, "TMP0")
    a.shift_imm(ASHIFT_HI, SI, -1)
    a.mov(AR, SR1)
    a.c16(AY0, 1)
    a.alu(AR, ADD, AR, AY0)
    a.mov(SE, AR)
    a.shift_se(ASHIFT_HI, MR1)
    a.shift_se(LSHIFT_LO_OR, MR0)
    a.mov(AR, SR1)
    a.lds(AX0, "TMP1")
    a.cmp_imm(AX0, 0)
    a.jump("t93_sq0", EQ)
    a.mov(AY0, AR)
    a.alu(AR, NEG_Y, None, AY0)
    a.label("t93_sq0")
    a.st(FB, AR)
    a.st(FB + 0x100, AR)
    a.c16(AR, 0)
    a.st(FB + 1, AR)
    a.st(FB + 0x101, AR)

    # --- expand 256 → 512 samples (refdec :190-207) --------------------
    a.imm(I0, FB + 0x002)
    a.imm(I1, FB + 0x0FE)
    a.imm(I2, FB + 0x102)
    a.imm(I3, FB + 0x1FE)
    a.imm(M3, -3)
    with a.loop_ce(n=0x40):
        a.ld_i(AX0, I0, M1)             # xr
        a.ld_i(AX1, I0, M2)             # xi (back at i0)
        a.ld_i(AY0, I1, M1)             # yr
        a.ld_i(AY1, I1, M2)             # yi (back at i1)
        a.alu(AR, ADD, AX0, AY0)        # xr+yr
        a.st_i(I0, M1, AR)
        a.st_i(I1, M1, AR)
        a.alu(AR, SUB, AX0, AY0)        # xr−yr
        a.st_i(I2, M1, AR)
        a.alu(AR, RSUB, AX0, AY0)       # yr−xr
        a.st_i(I3, M1, AR)
        a.alu(AR, ADD, AX1, AY1)        # xi+yi
        a.st_i(I2, M1, AR)              # i2 net +2
        a.st_i(I3, M3, AR)              # i3 net −2
        a.alu(AR, SUB, AX1, AY1)        # xi−yi
        a.st_i(I0, M1, AR)              # i0 net +2
        a.alu(AR, RSUB, AX1, AY1)       # yi−xi
        a.st_i(I1, M3, AR)              # i1 net −2
    # --- 7-iteration IFFT over 512 entries, unsaturated (refdec :209-234)
    a.c16(AR, 2)
    a.sts("NPART", AR)
    a.c16(AR, 0x80)
    a.sts("PSIZE", AR)
    a.c16(AR, 7)
    a.sts("LVLC", AR)
    a.label("t93_level")
    a.imm(I0, FB)                       # p0
    a.lds(AR, "PSIZE")
    a.mov(M3, AR)                       # partition skip
    a.add_imm(AR, FB)
    a.mov(I1, AR)                       # p1 = FB + partition size
    a.lds(SI, "PSIZE")
    a.shift_imm(LSHIFT_LO, SI, -1)
    a.sts("HALF", SR0)
    a.imm(I2, TLAY["T_SIN"])
    a.imm(I4, TLAY["T_COS"])
    a.lds(AR, "NPART")
    a.mov(CNTR, AR)
    with a.loop_ce():                   # partitions
        a.ld_i(MY0, I2, M1)             # c_sin
        a.ld_i(MY1, I4, M6)             # c_cos
        a.lds(AR, "HALF")
        a.mov(CNTR, AR)
        with a.loop_ce():               # butterflies
            a.ld_i(MX0, I1, M1)         # a_re
            a.ld_i(MX1, I1, M2)         # a_im (back at p1)
            a.mac(MR, MUL_SS, MX0, MY1)
            a.mac(MR, MSUB_RND, MX1, MY0)   # t_re
            a.mov(AX0, MR1)
            a.mac(MR, MUL_SS, MX1, MY1)
            a.mac(MR, MAC_RND, MX0, MY0)    # t_im
            a.ld_i(AY0, I0, M1)         # u_re
            a.ld_i(AY1, I0, M2)         # u_im (back at p0)
            a.alu(AR, RSUB, AX0, AY0)   # u_re − t_re
            a.st_i(I0, M1, AR)
            a.alu(AR, RSUB, MR1, AY1)   # u_im − t_im
            a.st_i(I0, M1, AR)          # p0 += 2
            a.alu(AR, ADD, AX0, AY0)    # u_re + t_re
            a.st_i(I1, M1, AR)
            a.alu(AR, ADD, MR1, AY1)    # u_im + t_im
            a.st_i(I1, M1, AR)          # p1 += 2
        a.modify(I0, M3)                # skip the partner partition
        a.modify(I1, M3)
    a.lds(SI, "NPART")
    a.shift_imm(LSHIFT_LO, SI, 1)
    a.sts("NPART", SR0)
    a.lds(SI, "PSIZE")
    a.shift_imm(LSHIFT_LO, SI, -1)
    a.sts("PSIZE", SR0)
    a.lds(AY0, "LVLC")
    a.alu(AR, Y_DEC, None, AY0)
    a.sts("LVLC", AR)
    a.cmp_imm(AR, 0)
    a.jump("t93_level", NE)

    # --- volume shift + bit-reversed extraction into the odd slots
    # (in place, sequential — the aliasing is part of the semantics,
    # refdec :236-240)
    a.lds(AY0, "VSHIFT")
    a.alu(AR, NEG_Y, None, AY0)
    a.mov(SE, AR)
    a.imm(I1, TLAY["T_BR"])
    a.imm(I2, FB + 1)
    a.imm(M3, 2)
    with a.loop_ce(n=0x100):
        a.ld_i(AR, I1, M1)
        if FB:
            a.add_imm(AR, FB)
        a.mov(I0, AR)
        a.ld_i(SI, I0, M0)
        a.shift_se(ASHIFT_HI, SI)
        a.st_i(I2, M3, SR1)
    # --- overlap-add the first 16 outputs (refdec :242-251) ------------
    a.imm(I0, FB + 1)
    a.imm(I2, TLAY["T_OVLC"])           # coefficients forward
    a.imm(I3, TLAY["T_OVLC"] + 15)      # coefficients backward
    a.imm(I4, OVLB)
    a.lds(AR, "WPTR")
    a.mov(I1, AR)
    with a.loop_ce(n=16):
        a.ld_i(MX1, I4, M6)             # overlap sample
        a.ld_i(MY0, I3, M2)             # coeff (bwd)
        a.mac(MR, MUL_SU, MX1, MY0)
        a.ld_i(MX0, I0, M3)             # fb odd slot; += 2
        a.ld_i(MY0, I2, M1)             # coeff (fwd)
        a.mac(MR, MAC_SU, MX0, MY0)
        a.mac(MR, MAC_RND, MX0, None)   # round (adds 0·0)
        a.st_i(I1, M1, MR1)
    # --- 224 direct outputs -------------------------------------------
    with a.loop_ce(n=0xE0):
        a.ld_i(AX0, I0, M3)
        a.st_i(I1, M1, AX0)
    # --- last 16 → overlap buffer -------------------------------------
    a.imm(I4, OVLB)
    with a.loop_ce(n=16):
        a.ld_i(AX0, I0, M3)
        a.st_i(I4, M6, AX0)
    a.imm(M3, 0)
    a.rts()
