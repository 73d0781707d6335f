"""Synthesized boot firmware for generated ROMs.

Original DCS ROMs carry the real ADSP-2105 decoder program; compiled ROM
sets from this framework can't include that (it isn't redistributable), but
they can carry a minimal, runnable firmware so the emulator backend
(emu/board.py) boots them: vectors, SPORT1 autobuffer setup, the
autobuffer-sync wait loop and main-loop shapes the emulator's patch-point
search expects (the same opcode sequences all real DCS programs share),
the master-volume routine signature, and an IRQ2 handler that services the
data port.  Each main-loop pass emits one frame of silence — the synthetic
firmware boots and runs everywhere, but real decoding still needs original
firmware, exactly as with the reference's emulator.

The port's copy of ``dcsexplorer_tpu/compiler/firmware.py``.
"""

NOP = 0x000000
RTI = 0x0A001F
RTS = 0x0A000F

AX0, AX1, AY0, AY1, SI, AR, SR0, SR1 = 0, 1, 4, 5, 8, 10, 14, 15
BUF = 0x1000            # autobuffer DM base
BUF_MID = BUF + 0xF0
WPTR = 0x0803           # autobuffer write-pointer variable
LAST_PORT = 0x0810      # last data-port byte received
N_BYTES = 0x0820        # data-port protocol state machine position
CMD_WORD = 0x0821       # assembling 16-bit word
LAST_CMD = 0x0823       # last complete track command received
VOL_VAR = 0x0900        # master volume variable (found by signature search)


def jump(t, cond=0xF):
    return 0x180000 | ((t & 0x3FFF) << 4) | cond


def imm_ndr(grp, reg, val):
    return ((0x30 | (grp << 2)) << 16) | ((val & 0x3FFF) << 4) | reg


def imm_dr(reg, val):
    return 0x400000 | ((val & 0xFFFF) << 4) | reg


def rd_dm(grp, reg, addr):
    return 0x800000 | (grp << 18) | ((addr & 0x3FFF) << 4) | reg


def wr_dm(grp, reg, addr):
    return 0x900000 | (grp << 18) | ((addr & 0x3FFF) << 4) | reg


def build_firmware(hw_version):
    """Mini firmware word list (entry at word 8, IRQ2 vector at word 4).

    hw_version: 2 = original DCS board (data port at PM($3000)),
    3 = DCS-95 (data port at DM($3300)).
    """
    MAIN, IRQ2 = 0x08, 0x40
    w = {}
    w[0x00] = jump(MAIN)                     # RESET vector
    w[0x04] = jump(IRQ2)                     # IRQ2 vector

    a = MAIN
    def emit(op):
        nonlocal a
        w[a] = op
        a += 1

    # autobuffer: I3=BUF, L3=480, M3=1; $3FEF control word names ireg/mreg 3
    emit(imm_ndr(1, 3, BUF))
    emit(imm_ndr(1, 11, 480))
    emit(imm_ndr(1, 7, 1))
    emit(imm_dr(AX0, 0x0002 | (3 << 9) | (3 << 7)))
    emit(wr_dm(0, AX0, 0x3FEF))
    emit(imm_ndr(3, 3, 0x20))                # IMASK: IRQ2
    emit(imm_ndr(1, 4, 1))                   # M0 = 1
    emit(imm_dr(AR, BUF))
    emit(wr_dm(0, AR, WPTR))
    if hw_version == 2:
        emit(imm_ndr(2, 1, 0x3000))          # I5 = $3000 (PM data port)
        emit(imm_ndr(2, 5, 0))               # M5 = 0
    # master-volume routine signature: 8xxxxF 2E7FEF 1yyyy0
    emit(rd_dm(0, SR1, VOL_VAR))
    emit(0x2E7FEF)
    emit(jump(a + 1, cond=0))
    TOP = a
    # main loop entry signature: 3C1025 3xxxx0 1xxxxE
    emit(0x3C1025)                           # CNTR = $0102
    emit(imm_ndr(1, 0, 0x0800))              # I0 = $0800
    emit(0x140000 | ((a + 1) << 4) | 14)     # DO . UNTIL CE
    emit(NOP)
    # fill one frame of silence at the write pointer
    emit(rd_dm(1, 0, WPTR))                  # I0 = write pointer
    emit(imm_dr(AR, 0))                      # AR = 0 (silence)
    emit(imm_ndr(3, 5, 240))                 # CNTR = 240
    emit(0x140000 | ((a + 1) << 4) | 14)     # DO . UNTIL CE
    emit(0x680000 | (AR << 4))               # DM(I0,M0) = AR (MAC no-op)
    # autobuffer sync wait loop: 0D02A3 4xxxx4 26E20F 1yyyy4
    sync = a
    emit(0x0D02A3)                           # AR = I7
    emit(imm_dr(AY0, BUF_MID))
    emit(0x26E20F)                           # AF = AR - AY0
    emit(jump(sync, cond=4))                 # IF LT JUMP sync
    emit(imm_dr(AR, BUF))                    # 4xxxxA (write-pointer resets)
    emit(wr_dm(0, AR, WPTR))                 # 9zzzzA
    emit(imm_dr(AR, BUF_MID))                # 4yyyyA
    emit(wr_dm(0, AR, WPTR))                 # 9zzzzA
    emit(jump(TOP))                          # main loop jump (gets trapped)

    assert a <= IRQ2, f"main program overran the IRQ2 handler ({a:#x})"

    # ------------------------------------------------------------------
    # IRQ2: the real byte-at-a-time data-port protocol — assemble 2-byte
    # track commands (latched at LAST_CMD), the 4-byte $55AA master-volume
    # command (with ~complement check, updating VOL_VAR), and the $55C2/C3
    # version queries (replying $01/$06 on the port).
    a = IRQ2

    def alu_ar(sel, xsel, ysel):
        return 0x220000 | (sel << 13) | (ysel << 11) | (xsel << 8) | 0xF

    def alu_af(sel, xsel, ysel):
        return 0x260000 | (sel << 13) | (ysel << 11) | (xsel << 8) | 0xF

    def port_write_ar():
        if hw_version == 2:
            # pgm memory write via DAG2 (I5/M5): PM($3000) is the port
            return 0x580000 | (AR << 4) | 0x05
        return wr_dm(0, AR, 0x3300)

    L = {}                                    # forward labels
    fix = []                                  # (addr, label, cond)

    def jmp(label, cond=0xF):
        fix.append((a, label, cond))
        return 0

    if hw_version == 2:
        emit(0x500000 | (AX1 << 4) | 0x05)    # AX1 = PM port (MAC no-op)
    else:
        emit(rd_dm(0, AX1, 0x3300))           # AX1 = port byte
    emit(wr_dm(0, AX1, LAST_PORT))
    emit(rd_dm(0, AY1, N_BYTES))              # AY1 = protocol position
    emit(imm_dr(AX0, 1))
    emit(alu_ar(7, 0, 1))                     # AR = 1 - N
    emit(jmp("case1", cond=0))                # IF EQ
    emit(imm_dr(AX0, 2))
    emit(alu_ar(7, 0, 1))
    emit(jmp("case2", cond=0))
    emit(imm_dr(AX0, 3))
    emit(alu_ar(7, 0, 1))
    emit(jmp("case3", cond=0))
    # case 0: WORD = byte << 8; N = 1
    emit(0x0D0000 | (0 << 10) | (0 << 8) | (SI << 4) | AX1)   # SI = AX1
    emit(0x0F0000 | (0x2 << 11) | (0 << 8) | 8)   # SR = LSHIFT SI (LO) by 8
    emit(wr_dm(0, SR0, CMD_WORD))
    emit(imm_dr(AR, 1))
    emit(wr_dm(0, AR, N_BYTES))
    emit(RTI)

    L["case1"] = a                            # second byte: complete word
    emit(rd_dm(0, AY0, CMD_WORD))
    emit(alu_ar(0xD, 1, 0))                   # AR = AX1 OR AY0  (the word)
    emit(wr_dm(0, AR, CMD_WORD))
    emit(imm_dr(AY0, 0x55AA))
    emit(alu_af(7, 2, 0))                     # AF = AR - AY0
    emit(jmp("volume", cond=0))
    emit(imm_dr(AY0, 0x55C2))
    emit(alu_af(7, 2, 0))
    emit(jmp("verhi", cond=0))
    emit(imm_dr(AY0, 0x55C3))
    emit(alu_af(7, 2, 0))
    emit(jmp("verlo", cond=0))
    emit(wr_dm(0, AR, LAST_CMD))              # a plain track command
    emit(jmp("reset"))
    L["volume"] = a
    emit(imm_dr(AR, 2))
    emit(wr_dm(0, AR, N_BYTES))
    emit(RTI)
    L["verhi"] = a
    emit(imm_dr(AR, 0x01))
    emit(port_write_ar())
    emit(jmp("reset"))
    L["verlo"] = a
    emit(imm_dr(AR, 0x06))
    emit(port_write_ar())
    emit(jmp("reset"))

    L["case2"] = a                            # volume value byte
    emit(wr_dm(0, AX1, CMD_WORD))
    emit(imm_dr(AR, 3))
    emit(wr_dm(0, AR, N_BYTES))
    emit(RTI)

    L["case3"] = a                            # ~complement check byte
    emit(imm_dr(AY0, 0x00FF))
    emit(alu_ar(0xE, 1, 0))                   # AR = AX1 XOR $FF
    emit(rd_dm(0, AY0, CMD_WORD))
    emit(alu_af(7, 2, 0))                     # AF = AR - WORD
    emit(jmp("reset", cond=1))                # IF NE: bad check, drop
    emit(alu_ar(0, 0, 0))                     # AR = PASS AY0 (the volume)
    emit(wr_dm(0, AR, VOL_VAR))
    L["reset"] = a
    emit(imm_dr(AR, 0))
    emit(wr_dm(0, AR, N_BYTES))
    emit(RTI)

    for (addr, label, cond) in fix:
        w[addr] = jump(L[label], cond)

    n = max(w) + 1
    return [w.get(k, NOP) for k in range(n)]


def encode_boot_block(words):
    """Words → 4-byte ROM groups with the auto-boot length in byte 3 of the
    first group (8*(b3+1) words loaded)."""
    n = (len(words) + 7) // 8 * 8
    words = words + [NOP] * (n - len(words))
    out = bytearray()
    for k, word in enumerate(words):
        out += bytes([(word >> 16) & 0xFF, (word >> 8) & 0xFF,
                      word & 0xFF, n // 8 - 1 if k == 0 else 0xFF])
    return bytes(out)
