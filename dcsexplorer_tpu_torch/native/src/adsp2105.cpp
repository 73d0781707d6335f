// ADSP-2105 interpreter + DCS board model, native host runtime.
//
// C++ port of this framework's own CPU core (emu/adsp2105.py) fused with
// the board memory maps (emu/board.py) so the emulator backend runs at
// native speed — the counterpart of the reference's C++ emulator layer
// (reference: DCSDecoder/adsp2100/ + DCSDecoderEmu.cpp:397-591 for the
// board maps).  Semantics are validated per-instruction against the
// reference interpreter compiled into the test oracle (tests/test_adsp_cpu.py
// runs the same differential fuzz against this core), and the state-vector
// layout (STATE_LEN = 125) is shared with the Python core so the two are
// interchangeable mid-session.
//
// Host callbacks (rare events only):
//   read_port()        data-port read  (DM $3300 on DCS-95, PM $3000 on DCS93)
//   write_port(v)      data-port write (host receives a byte)
//   set_bank(linear)   bank-select write; host resolves the linear ROM
//                      address and pushes the window via adsp_set_bank_window
// Everything else — including the SPORT1 autobuffer capture at DM($3FEF)
// and the $3FFF ResetError bit — is handled natively.

#include <stdint.h>
#include <string.h>

namespace {

typedef uint16_t (*ReadPortFn)(void);
typedef void (*WritePortFn)(uint16_t);
typedef void (*SetBankFn)(uint32_t);

const uint32_t M16 = 0xFFFF;
const uint32_t M32 = 0xFFFFFFFF;

// ASTAT flags
enum { FSS = 0x80, FMV = 0x40, FQ = 0x20, FS = 0x10,
       FC = 0x08, FV = 0x04, FN = 0x02, FZ = 0x01 };
// MSTAT flags
enum { M_BANK = 0x01, M_REVERSE = 0x02, M_STICKYV = 0x04, M_SATURATE = 0x08,
       M_INTEGER = 0x10, M_TIMER = 0x20, M_GOMODE = 0x40 };
// SSTAT flags
enum { PC_EMPTY = 0x01, PC_OVER = 0x02, COUNT_EMPTY = 0x04, COUNT_OVER = 0x08,
       STATUS_EMPTY = 0x10, STATUS_OVER = 0x20,
       LOOP_EMPTY = 0x40, LOOP_OVER = 0x80 };

enum { HW_PORT_ONLY = 1, HW_DCS93 = 2, HW_DCS95 = 3 };

// decoder-accelerator kinds (emu/speedup.py mirrors these)
enum { ACCEL_SYNTH94 = 1, ACCEL_SYNTH93 = 2,
       ACCEL_ORIG94 = 3, ACCEL_ORIG93 = 4 };

inline int32_t s16(int64_t v) {
    v &= M16;
    return v & 0x8000 ? static_cast<int32_t>(v) - 0x10000
                      : static_cast<int32_t>(v);
}

inline int32_t s8(int64_t v) {
    v &= 0xFF;
    return v & 0x80 ? static_cast<int32_t>(v) - 0x100
                    : static_cast<int32_t>(v);
}

int32_t maskForL(int l) {
    if (l > 0x2000) return 0;
    int m = 0x3FFF, size = 1;
    while (size < l) { size <<= 1; m = (m << 1) & 0x3FFF; }
    return m & 0x3FFF;
}

struct Tables {
    uint16_t reverse[0x4000];
    uint16_t masks[0x4000];
    Tables() {
        for (int i = 0; i < 0x4000; ++i) {
            int r = 0;
            for (int b = 0; b < 14; ++b)
                if (i & (1 << b)) r |= 1 << (13 - b);
            reverse[i] = static_cast<uint16_t>(r);
            masks[i] = static_cast<uint16_t>(maskForL(i));
        }
    }
};
const Tables T;

struct Core {
    uint32_t ax0, ax1, ay0, ay1, ar, af;
    uint32_t mx0, mx1, my0, my1;
    uint64_t mr;
    uint32_t mf, si, se, sb, sr;
};

struct Adsp {
    Core core, alt;
    uint32_t i[8];
    int32_t m[8];
    uint32_t l[8], lmask[8], base[8];
    uint32_t px, pc, ppc, loop, loop_condition, cntr;
    uint32_t astat, sstat, mstat, astat_clear, idle;
    uint32_t loop_stack[4], cntr_stack[4], pc_stack[16];
    uint32_t stat_stack[4][3];
    int pc_sp, cntr_sp, stat_sp, loop_sp;
    uint32_t flagout, flagin, fl0, fl1, fl2;
    uint32_t imask, icntl, ifc;
    uint32_t irq_latch[5], irq_state[5];
    bool stopped;

    uint32_t pm[0x4000];
    uint16_t dm[0x4000];

    // board model
    int hw;                      // 0 = bare CPU, HW_DCS93/HW_DCS95
    const uint8_t* bank;         // current ROM window
    int64_t bank_len;
    int32_t ab_base;             // autobuffer (base < 0 = unset)
    int32_t ab_length, ab_step;
    bool reset_request;
    ReadPortFn cb_read_port;
    WritePortFn cb_write_port;
    SetBankFn cb_set_bank;

    // decoder accelerator ("speedup" fast mode): when pc reaches su_pc,
    // the firmware's inverse-transform region executes natively and pc
    // jumps to su_exit.  Counterpart of the reference's PinMame speedup
    // patches (reference: DCSDecoderEmu.cpp:289-325, 644-889), except the
    // replacement code here reuses this framework's bit-exact transform
    // semantics (refdec/transform.py) rather than a hand translation.
    int32_t su_pc;               // entry pc (-1 = disabled)
    int32_t su_exit;
    int32_t su_kind;             // ACCEL_* below
    uint16_t su_geom[8];

    // ------------------------------------------------------------------
    void init() {
        memset(this, 0, sizeof(*this));
        sstat = 0x55;
        loop = 0xFFFF;
        astat_clear = ~(FC | FV | FN | FZ) & 0xFF;
        for (int k = 0; k < 8; ++k) lmask[k] = 0x3FFF;
        hw = 0;
        ab_base = -1;
        ab_step = 1;
        su_pc = -1;
        su_exit = -1;
        su_kind = 0;
    }

    void reset() {
        for (int k = 0; k < 8; ++k) {
            lmask[k] = T.masks[l[k] & 0x3FFF];
            base[k] = i[k] & lmask[k];
        }
        pc = 0;
        ppc = 0xFFFFFFFF;
        loop = 0xFFFF;
        loop_condition = 0;
        astat_clear = ~(FC | FV | FN | FZ) & 0xFF;
        mstat = 0;
        sstat = 0x55;
        idle = 0;
        pc_sp = cntr_sp = stat_sp = loop_sp = 0;
        flagout = flagin = 0;
        fl0 = fl1 = fl2 = 0;
        imask = 0;
        memset(irq_latch, 0, sizeof(irq_latch));
        memset(irq_state, 0, sizeof(irq_state));
    }

    // ------------------------------------------------------------------
    // board memory (emu/board.py _read_dm/_write_dm/_read_pm_port/...)

    inline uint16_t romByte(int64_t off) const {
        return (bank && off >= 0 && off < bank_len) ? bank[off] : 0xFF;
    }

    uint16_t readDm(uint32_t addr) {
        addr &= 0x3FFF;
        if (hw == HW_DCS93) {
            if (addr >= 0x2000 && addr <= 0x2FFF)
                return romByte(static_cast<int64_t>(addr) - 0x2000);
        } else if (hw == HW_DCS95) {
            if (addr <= 0x07FF) return romByte(addr);
            if (addr == 0x3300) return cb_read_port ? cb_read_port() : 0;
        }
        return dm[addr];
    }

    void writeDm(uint32_t addr, uint32_t data) {
        addr &= 0x3FFF;
        data &= M16;
        dm[addr] = static_cast<uint16_t>(data);
        if (hw == HW_DCS93) {
            if (addr == 0x3000 && cb_set_bank) cb_set_bank(data << 12);
        } else if (hw == HW_DCS95) {
            if (addr == 0x3000 || addr == 0x3100) {
                uint32_t chip = (dm[0x3100] >> 2) & 0x07;
                uint32_t offset = ((dm[0x3100] & 0x01) << 19)
                    + ((dm[0x3000] & 0xFF) << 11);
                if (cb_set_bank) cb_set_bank((chip << 21) | offset);
            } else if (addr == 0x3300) {
                if (cb_write_port) cb_write_port(data & 0xFF);
            }
        }
        if (hw >= HW_DCS93) {
            if (addr == 0x3FEF) {
                if (data & 0x0002) {
                    int ireg = (data >> 9) & 7;
                    int mreg = ((data >> 7) & 3) | (ireg & 0x04);
                    ab_base = static_cast<int32_t>(i[ireg]);
                    ab_length = static_cast<int32_t>(l[ireg]);
                    ab_step = m[mreg];
                }
            } else if (addr == 0x3FFF) {
                if (data & 0x0200) { reset_request = true; stopped = true; }
            }
        }
    }

    uint32_t rwordPgm(uint32_t addr) {
        if (addr == 0x3000 && hw != 0) {
            // PM($3000) is the data port on the original boards (and in the
            // port-only fuzz mode); plain-but-low-byte-masked on DCS-95
            if (hw == HW_DCS95)
                return (((pm[addr & 0x3FFF] >> 8) & M16) << 8) & 0xFFFFFF;
            return ((cb_read_port ? cb_read_port() : 0) << 8) & 0xFFFFFF;
        }
        return pm[addr & 0x3FFF];
    }

    void wwordPgm(uint32_t addr, uint32_t val) {
        if (addr == 0x3000 && hw != 0 && hw != HW_DCS95 && cb_write_port)
            cb_write_port((val >> 8) & M16);
        pm[addr & 0x3FFF] = val & 0xFFFFFF;
    }

    // ------------------------------------------------------------------
    // status / stacks (emu/adsp2105.py lines 145-283)

    void setMstat(uint32_t nw) {
        if ((nw ^ mstat) & M_BANK) { Core t = core; core = alt; alt = t; }
        astat_clear = (nw & M_STICKYV) ? (~(FC | FN | FZ) & 0xFF)
                                       : (~(FC | FV | FN | FZ) & 0xFF);
        mstat = nw;
    }

    void cntrStackPop() {
        if (cntr_sp > 0) {
            --cntr_sp;
            if (cntr_sp == 0) sstat |= COUNT_EMPTY;
        }
        cntr = cntr_stack[cntr_sp];
    }

    bool condition(int c) {
        bool az = astat & FZ, an = astat & FN, av = astat & FV;
        bool ac = astat & FC, mv = astat & FMV, as_ = astat & FS;
        switch (c) {
            case 0: return az;
            case 1: return !az;
            case 2: return !((an != av) || az);
            case 3: return (an != av) || az;
            case 4: return an != av;
            case 5: return !(an != av);
            case 6: return av;
            case 7: return !av;
            case 8: return ac;
            case 9: return !ac;
            case 10: return as_;
            case 11: return !as_;
            case 12: return mv;
            case 13: return !mv;
            case 14: {
                cntr = (cntr - 1) & M32;
                if (static_cast<int32_t>(cntr) > 0) return true;
                cntrStackPop();
                return false;
            }
            default: return true;
        }
    }

    uint32_t pcStackTop() const {
        return pc_stack[pc_sp > 0 ? pc_sp - 1 : 0];
    }
    void pcStackPush(uint32_t val) {
        if (pc_sp < 16) {
            pc_stack[pc_sp++] = val;
            sstat &= ~PC_EMPTY;
        } else {
            sstat |= PC_OVER;
        }
    }
    void pcStackPop() {
        if (pc_sp > 0) { --pc_sp; if (pc_sp == 0) sstat |= PC_EMPTY; }
        pc = pc_stack[pc_sp];
    }
    uint32_t pcStackPopVal() {
        if (pc_sp > 0) { --pc_sp; if (pc_sp == 0) sstat |= PC_EMPTY; }
        return pc_stack[pc_sp];
    }
    void cntrStackPush() {
        if (cntr_sp < 4) {
            cntr_stack[cntr_sp++] = cntr;
            sstat &= ~COUNT_EMPTY;
        } else {
            sstat |= COUNT_OVER;
        }
    }
    void loopStackPush(uint32_t value) {
        if (loop_sp < 4) {
            loop_stack[loop_sp++] = value;
            loop = value >> 4;
            loop_condition = value & 15;
            sstat &= ~LOOP_EMPTY;
        } else {
            sstat |= LOOP_OVER;
        }
    }
    void loopStackPop() {
        if (loop_sp > 0) {
            --loop_sp;
            if (loop_sp == 0) {
                loop = 0xFFFF;
                loop_condition = 0;
                sstat |= LOOP_EMPTY;
            } else {
                loop = loop_stack[loop_sp - 1] >> 4;
                loop_condition = loop_stack[loop_sp - 1] & 15;
            }
        }
    }
    void statStackPush() {
        if (stat_sp < 4) {
            stat_stack[stat_sp][0] = mstat;
            stat_stack[stat_sp][1] = imask;
            stat_stack[stat_sp][2] = astat;
            ++stat_sp;
            sstat &= ~STATUS_EMPTY;
        } else {
            sstat |= STATUS_OVER;
        }
    }
    void statStackPop() {
        if (stat_sp > 0) { --stat_sp; if (stat_sp == 0) sstat |= STATUS_EMPTY; }
        setMstat(stat_stack[stat_sp][0]);
        imask = stat_stack[stat_sp][1];
        astat = stat_stack[stat_sp][2];
        checkIrqs();
    }

    // ------------------------------------------------------------------
    // interrupts (2101-family path)

    bool generateIrq(int which, int indx) {
        if (!(imask & (0x20 >> indx))) return false;
        irq_latch[which] = 0;
        pcStackPush(pc);
        statStackPush();
        pc = 0x04 + indx * 4;
        idle = 0;
        if (icntl & 0x10) imask &= ~(0x3F >> indx) & 0xFF;
        else imask &= ~0x3F & 0xFF;
        return true;
    }

    void checkIrqs() {
        uint32_t check = (icntl & 4) ? irq_latch[2] : irq_state[2];
        if (check && generateIrq(2, 0)) return;
        if (irq_latch[4] && generateIrq(4, 1)) return;
        if (irq_latch[3] && generateIrq(3, 2)) return;
        check = (icntl & 2) ? irq_latch[1] : irq_state[1];
        if (check && generateIrq(1, 3)) return;
        check = (icntl & 1) ? irq_latch[0] : irq_state[0];
        if (check && generateIrq(0, 4)) return;
    }

    // ------------------------------------------------------------------
    // register file

    int64_t readReg(int grp, int reg) {
        Core& c = core;
        if (grp == 0) {
            uint32_t v;
            switch (reg) {
                case 0: v = c.ax0; break;
                case 1: v = c.ax1; break;
                case 2: v = c.mx0; break;
                case 3: v = c.mx1; break;
                case 4: v = c.ay0; break;
                case 5: v = c.ay1; break;
                case 6: v = c.my0; break;
                case 7: v = c.my1; break;
                case 8: v = c.si; break;
                case 9: v = c.se; break;
                case 10: v = c.ar; break;
                case 11: v = c.mr & M16; break;
                case 12: v = (c.mr >> 16) & M16; break;
                case 13: v = (c.mr >> 32) & M16; break;
                case 14: v = c.sr & M16; break;
                default: v = (c.sr >> 16) & M16; break;
            }
            return s16(v);
        }
        if (grp == 1 || grp == 2) {
            int b = grp == 1 ? 0 : 4;
            if (reg < 4) return i[b + reg];
            if (reg < 8) return m[b + reg - 4];
            if (reg < 12) return l[b + reg - 8];
            return 0;
        }
        switch (reg) {
            case 0: return astat;
            case 1: return mstat;
            case 2: return sstat;
            case 3: return imask;
            case 4: return icntl;
            case 5: return cntr;
            case 6: return s16(((core.sb & 0x1F) ^ 0x10) - 0x10);
            case 7: return px;
            case 8: case 10: return 0;
            case 15: return pcStackPopVal();
            default: return 0;
        }
    }

    void writeReg(int grp, int reg, int64_t val) {
        Core& c = core;
        if (grp == 0) {
            uint32_t v = val & M16;
            switch (reg) {
                case 0: c.ax0 = v; break;
                case 1: c.ax1 = v; break;
                case 2: c.mx0 = v; break;
                case 3: c.mx1 = v; break;
                case 4: c.ay0 = v; break;
                case 5: c.ay1 = v; break;
                case 6: c.my0 = v; break;
                case 7: c.my1 = v; break;
                case 8: c.si = v; break;
                case 9: c.se = s8(val) & M16; break;
                case 10: c.ar = v; break;
                case 11: c.mr = (c.mr & ~static_cast<uint64_t>(M16)) | v;
                         break;
                case 12: {
                    // writing MR1 sign-extends into MR2 (mrzero preserved)
                    uint64_t sign = (v & 0x8000) ? 0xFFFF : 0;
                    c.mr = (c.mr & ~((1ull << 48) - 1)) | (c.mr & M16)
                        | (static_cast<uint64_t>(v) << 16) | (sign << 32);
                    break;
                }
                case 13:
                    c.mr = (c.mr & ~(static_cast<uint64_t>(M16) << 32))
                        | (static_cast<uint64_t>(s8(val) & M16) << 32);
                    break;
                case 14: c.sr = (c.sr & ~M16) | v; break;
                default: c.sr = (c.sr & M16) | (v << 16); break;
            }
            return;
        }
        if (grp == 1 || grp == 2) {
            int b = grp == 1 ? 0 : 4;
            if (reg < 4) {
                int k = b + reg;
                i[k] = val & 0x3FFF;
                base[k] = i[k] & lmask[k];
            } else if (reg < 8) {
                int k = b + reg - 4;
                m[k] = static_cast<int32_t>((val & 0x3FFF) ^ 0x2000) - 0x2000;
            } else if (reg < 12) {
                int k = b + reg - 8;
                l[k] = val & 0x3FFF;
                lmask[k] = T.masks[l[k]];
                base[k] = i[k] & lmask[k];
            }
            return;
        }
        switch (reg) {
            case 0: astat = val & 0xFF; break;
            case 1: setMstat(val & 0x7F); break;
            case 2: break;                      // SSTAT read-only
            case 3: imask = val & 0x3F; checkIrqs(); break;
            case 4: icntl = val & 0x1F; checkIrqs(); break;
            case 5: cntrStackPush(); cntr = val & 0x3FFF; break;
            case 6: core.sb = (((val & 0x1F) ^ 0x10) - 0x10) & M16; break;
            case 7: px = val & 0xFF; break;
            case 12: {
                ifc = val & M16;
                static const struct { uint32_t bit; int latch, lv; } tab[] = {
                    {0x002, 0, 0}, {0x004, 1, 0}, {0x008, 3, 0},
                    {0x010, 4, 0}, {0x020, 2, 0}, {0x080, 0, 1},
                    {0x100, 1, 1}, {0x200, 3, 1}, {0x400, 4, 1},
                    {0x800, 2, 1}};
                for (const auto& t : tab)
                    if (val & t.bit) irq_latch[t.latch] = t.lv;
                checkIrqs();
                break;
            }
            case 13: cntr = val & 0x3FFF; break;
            case 15: pcStackPush(val & 0x3FFF); break;
            default: break;
        }
    }

    // ------------------------------------------------------------------
    // DAGs

    void postModify(int ireg, int mreg) {
        uint32_t b = base[ireg];
        int32_t ii = (static_cast<int32_t>(i[ireg]) + m[mreg]) & 0x3FFF;
        int32_t ll = static_cast<int32_t>(l[ireg]);
        if (ii < static_cast<int32_t>(b)) ii += ll;
        else if (ii >= static_cast<int32_t>(b) + ll) ii -= ll;
        i[ireg] = ii & 0x3FFF;
    }

    uint16_t dataReadDag1(uint32_t op) {
        int ireg = (op >> 2) & 3, mreg = op & 3;
        uint32_t a = (mstat & M_REVERSE) ? T.reverse[i[ireg] & 0x3FFF]
                                         : i[ireg];
        uint16_t res = readDm(a);
        postModify(ireg, mreg);
        return res;
    }
    void dataWriteDag1(uint32_t op, uint32_t val) {
        int ireg = (op >> 2) & 3, mreg = op & 3;
        uint32_t a = (mstat & M_REVERSE) ? T.reverse[i[ireg] & 0x3FFF]
                                         : i[ireg];
        writeDm(a, val);
        postModify(ireg, mreg);
    }
    uint16_t dataReadDag2(uint32_t op) {
        int ireg = 4 + ((op >> 2) & 3), mreg = 4 + (op & 3);
        uint16_t res = readDm(i[ireg]);
        postModify(ireg, mreg);
        return res;
    }
    void dataWriteDag2(uint32_t op, uint32_t val) {
        int ireg = 4 + ((op >> 2) & 3), mreg = 4 + (op & 3);
        writeDm(i[ireg], val);
        postModify(ireg, mreg);
    }
    uint16_t pgmReadDag2(uint32_t op) {
        int ireg = 4 + ((op >> 2) & 3), mreg = 4 + (op & 3);
        uint32_t word = rwordPgm(i[ireg]);
        px = word & 0xFF;
        postModify(ireg, mreg);
        return (word >> 8) & M16;
    }
    void pgmWriteDag2(uint32_t op, uint32_t val) {
        int ireg = 4 + ((op >> 2) & 3), mreg = 4 + (op & 3);
        wwordPgm(i[ireg], ((val & M16) << 8) | px);
        postModify(ireg, mreg);
    }

    // ------------------------------------------------------------------
    // ALU / MAC / shifter

    uint32_t aluX(int sel) {
        Core& c = core;
        switch (sel) {
            case 0: return c.ax0;
            case 1: return c.ax1;
            case 2: return c.ar;
            case 3: return c.mr & M16;
            case 4: return (c.mr >> 16) & M16;
            case 5: return (c.mr >> 32) & M16;
            case 6: return c.sr & M16;
            default: return (c.sr >> 16) & M16;
        }
    }
    uint32_t aluY(int sel) {
        switch (sel) {
            case 0: return core.ay0;
            case 1: return core.ay1;
            case 2: return core.af;
            default: return 0;
        }
    }
    uint32_t macXRaw(int sel) {
        Core& c = core;
        switch (sel) {
            case 0: return c.mx0;
            case 1: return c.mx1;
            case 2: return c.ar;
            case 3: return c.mr & M16;
            case 4: return (c.mr >> 16) & M16;
            case 5: return (c.mr >> 32) & M16;
            case 6: return c.sr & M16;
            default: return (c.sr >> 16) & M16;
        }
    }
    uint32_t macYRaw(int sel) {
        switch (sel) {
            case 0: return core.my0;
            case 1: return core.my1;
            case 2: return core.mf;
            default: return 0;
        }
    }
    int32_t shiftX(int sel, bool sign) {
        Core& c = core;
        uint32_t v;
        switch (sel) {
            case 0: case 1: v = c.si; break;
            case 2: v = c.ar; break;
            case 3: v = c.mr & M16; break;
            case 4: v = (c.mr >> 16) & M16; break;
            case 5: v = (c.mr >> 32) & M16; break;
            case 6: v = c.sr & M16; break;
            default: v = (c.sr >> 16) & M16; break;
        }
        return sign ? s16(v) : static_cast<int32_t>(v & M16);
    }

    inline void clrFlags() { astat &= astat_clear; }
    inline void calcNZ(uint32_t r) {
        clrFlags();
        if ((r & M16) == 0) astat |= FZ;
        astat |= (r >> 14) & 0x02;
    }
    inline void calcV(uint32_t s, uint32_t d, uint32_t r) {
        astat |= ((s ^ d ^ r ^ (r >> 1)) >> 13) & 0x04;
    }

    void aluOp(uint32_t op, bool toAf) {
        int xsel = (op >> 8) & 7, ysel = (op >> 11) & 3, sel = (op >> 13) & 15;
        uint32_t res = 0, xop, yop;
        switch (sel) {
            case 0x0:
                res = aluY(ysel);
                calcNZ(res);
                break;
            case 0x1:
                yop = aluY(ysel);
                res = yop + 1;
                calcNZ(res);
                if (yop == 0x7FFF) astat |= FV;
                else if (yop == 0xFFFF) astat |= FC;
                break;
            case 0x2:
                xop = aluX(xsel);
                yop = aluY(ysel) + ((astat & FC) >> 3);
                res = xop + yop;
                calcNZ(res);
                calcV(xop, yop, res);
                astat |= (res >> 13) & 0x08;
                break;
            case 0x3:
                xop = aluX(xsel);
                yop = aluY(ysel);
                res = xop + yop;
                calcNZ(res);
                calcV(xop, yop, res);
                astat |= (res >> 13) & 0x08;
                break;
            case 0x4:
                res = aluY(ysel) ^ 0xFFFF;
                calcNZ(res);
                break;
            case 0x5:
                yop = aluY(ysel);
                res = static_cast<uint32_t>(-static_cast<int64_t>(yop));
                calcNZ(res);
                if (yop == 0x8000) astat |= FV;
                if (yop == 0x0000) astat |= FC;
                break;
            case 0x6:
                xop = aluX(xsel);
                yop = aluY(ysel);
                res = xop - yop + ((astat & FC) >> 3) - 1;
                calcNZ(res);
                calcV(xop, yop, res);
                astat |= ((~res) >> 13) & 0x08;
                break;
            case 0x7:
                xop = aluX(xsel);
                yop = aluY(ysel);
                res = xop - yop;
                calcNZ(res);
                calcV(xop, yop, res);
                astat |= ((~res) >> 13) & 0x08;
                break;
            case 0x8:
                yop = aluY(ysel);
                res = yop - 1;
                calcNZ(res);
                if (yop == 0x8000) astat |= FV;
                else if (yop == 0x0000) astat |= FC;
                break;
            case 0x9:
                xop = aluX(xsel);
                yop = aluY(ysel);
                res = yop - xop;
                calcNZ(res);
                calcV(yop, xop, res);
                astat |= ((~res) >> 13) & 0x08;
                break;
            case 0xA:
                xop = aluX(xsel);
                yop = aluY(ysel);
                res = yop - xop + ((astat & FC) >> 3) - 1;
                calcNZ(res);
                calcV(yop, xop, res);
                astat |= ((~res) >> 13) & 0x08;
                break;
            case 0xB:
                res = aluX(xsel) ^ 0xFFFF;
                calcNZ(res);
                break;
            case 0xC:
                res = aluX(xsel) & aluY(ysel);
                calcNZ(res);
                break;
            case 0xD:
                res = aluX(xsel) | aluY(ysel);
                calcNZ(res);
                break;
            case 0xE:
                res = aluX(xsel) ^ aluY(ysel);
                calcNZ(res);
                break;
            default:
                xop = aluX(xsel);
                res = (xop & 0x8000)
                    ? static_cast<uint32_t>(-static_cast<int64_t>(xop)) : xop;
                clrFlags();
                astat &= ~FS;
                if (xop == 0) astat |= FZ;
                if (xop == 0x8000) astat |= FN | FV;
                if (xop & 0x8000) astat |= FS;
                break;
        }
        if (toAf) {
            core.af = res & M16;
        } else {
            if ((mstat & M_SATURATE) && (astat & FV))
                res = (astat & FC) ? static_cast<uint32_t>(-32768) : 32767;
            core.ar = res & M16;
        }
    }

    void macOp(uint32_t op, bool toMf) {
        int shift = ((mstat & M_INTEGER) >> 4) ^ 1;
        int xsel = (op >> 8) & 7, ysel = (op >> 11) & 3, sel = (op >> 13) & 15;
        if (sel == 0) return;

        bool xs = sel == 1 || sel == 2 || sel == 3 || sel == 4 || sel == 5
            || sel == 8 || sel == 9 || sel == 12 || sel == 13;
        bool ys = sel == 1 || sel == 2 || sel == 3 || sel == 4 || sel == 6
            || sel == 8 || sel == 10 || sel == 12 || sel == 14;
        int64_t xop = xs ? s16(macXRaw(xsel)) : macXRaw(xsel);
        int64_t yop = ys ? s16(macYRaw(ysel)) : macYRaw(ysel);

        int64_t mrs = static_cast<int64_t>(core.mr);
        int32_t t32 = static_cast<int32_t>(
            static_cast<uint32_t>((xop * yop) << shift));

        uint64_t res;
        if (sel == 1 || sel == 2 || sel == 3) {
            if (sel == 1) res = static_cast<uint64_t>(
                static_cast<int64_t>(t32));
            else if (sel == 2) res = static_cast<uint64_t>(mrs)
                + static_cast<uint64_t>(static_cast<int64_t>(t32));
            else res = static_cast<uint64_t>(mrs)
                - static_cast<uint64_t>(static_cast<int64_t>(t32));
            // convergent rounding quirk: exact-half products keep bit 16
            res += 0x8000;
            if ((static_cast<uint32_t>(t32) & M16) == 0x8000)
                res &= ~0x10000ull;
        } else if (sel >= 4 && sel <= 7) {
            res = static_cast<uint64_t>(static_cast<int64_t>(t32));
        } else if (sel >= 8 && sel <= 11) {
            res = static_cast<uint64_t>(mrs)
                + static_cast<uint64_t>(static_cast<int64_t>(t32));
        } else {
            res = static_cast<uint64_t>(mrs)
                - static_cast<uint64_t>(static_cast<int64_t>(t32));
        }

        if (toMf) {
            core.mf = (res >> 16) & M16;
        } else {
            uint32_t t = (res >> 31) & 0x1FF;
            astat &= ~FMV;
            if (t != 0x000 && t != 0x1FF) astat |= FMV;
            core.mr = res;
        }
    }

    void expOp(int xsel) {
        uint32_t xop = static_cast<uint32_t>(shiftX(xsel, true)) << 16;
        uint32_t res = 0;
        if (xop & 0x80000000u) {
            astat |= FSS;
            while (xop & 0x40000000u) { ++res; xop <<= 1; }
        } else {
            astat &= ~FSS;
            xop |= 0x8000;
            while (!(xop & 0x40000000u)) { ++res; xop <<= 1; }
        }
        core.se = static_cast<uint32_t>(-static_cast<int32_t>(res)) & M16;
    }

    void shiftOp(uint32_t op, int sc, bool imm) {
        int xsel = (op >> 8) & 7, sel = (op >> 11) & 15;
        Core& c = core;
        if (imm && sel >= 0xC) return;      // shift_op_imm: sels 0x0-0xB only

        auto lshift32 = [](uint32_t v, int n) -> uint32_t {
            if (n > 0) return n < 32 ? v << n : 0;
            return -n < 32 ? v >> -n : 0;
        };
        auto ashift32 = [](int32_t v, int n) -> uint32_t {
            if (n > 0)
                return n < 32 ? static_cast<uint32_t>(
                    static_cast<int64_t>(v) << n) : 0;
            if (-n < 32) return static_cast<uint32_t>(v >> -n);
            return static_cast<uint32_t>(v >> 31);
        };

        switch (sel) {
            case 0x0:
                c.sr = lshift32(static_cast<uint32_t>(shiftX(xsel, false))
                                << 16, sc);
                break;
            case 0x1:
                c.sr |= lshift32(static_cast<uint32_t>(shiftX(xsel, false))
                                 << 16, sc);
                break;
            case 0x2:
                c.sr = lshift32(static_cast<uint32_t>(shiftX(xsel, false)),
                                sc);
                break;
            case 0x3:
                c.sr |= lshift32(static_cast<uint32_t>(shiftX(xsel, false)),
                                 sc);
                break;
            case 0x4:
                c.sr = ashift32(shiftX(xsel, true) << 16, sc);
                break;
            case 0x5:
                c.sr |= ashift32(shiftX(xsel, true) << 16, sc);
                break;
            case 0x6:
                c.sr = ashift32(shiftX(xsel, true), sc);
                break;
            case 0x7:
                c.sr |= ashift32(shiftX(xsel, true), sc);
                break;
            case 0x8: case 0x9: {
                int32_t xop = shiftX(xsel, true) << 16;
                uint32_t res;
                if (sc > 0) {
                    // carry-in lands on bit 31 of a SIGNED int32 in the
                    // reference, so the shift is arithmetic; its compiled
                    // x86 shift also wraps the count mod 32
                    uint32_t x = (static_cast<uint32_t>(xop) >> 1)
                        | ((astat & FC) << 28);
                    int32_t xsg = static_cast<int32_t>(x);
                    res = static_cast<uint32_t>(xsg >> ((sc - 1) & 31));
                } else {
                    res = -sc < 32 ? static_cast<uint32_t>(
                        static_cast<int64_t>(xop) << -sc) : 0;
                }
                if (sel == 0x8) c.sr = res;
                else c.sr |= res;
                break;
            }
            case 0xA: case 0xB: {
                uint32_t xop = static_cast<uint32_t>(shiftX(xsel, false));
                uint32_t res;
                if (sc > 0) res = sc < 32 ? xop >> sc : 0;
                else res = -sc < 32 ? xop << -sc : 0;
                if (sel == 0xA) c.sr = res;
                else c.sr |= res;
                break;
            }
            case 0xC:
                expOp(xsel);
                break;
            case 0xD:
                if (astat & FV) {
                    int32_t xop = shiftX(xsel, true);
                    c.se = 1;
                    if (xop < 0) astat &= ~FSS;
                    else astat |= FSS;
                } else {
                    expOp(xsel);
                }
                break;
            case 0xE:
                if (s16(c.se) == -15) {
                    uint32_t xop = static_cast<uint32_t>(shiftX(xsel, true))
                        & M16;
                    uint32_t res = 15;
                    if (astat & FSS) {
                        while (xop & 0x8000) { ++res; xop = (xop << 1) & M16; }
                    } else {
                        xop = ((xop << 1) | 1) & 0x1FFFF;
                        while (!(xop & 0x10000)) {
                            ++res;
                            xop = (xop << 1) & 0x1FFFF;
                        }
                    }
                    c.se = static_cast<uint32_t>(
                        -static_cast<int32_t>(res)) & M16;
                }
                break;
            default: {
                uint32_t xop = static_cast<uint32_t>(shiftX(xsel, true)) << 16;
                int32_t res = 0;
                if (xop & 0x80000000u) {
                    while (xop & 0x40000000u) { ++res; xop <<= 1; }
                } else {
                    xop |= 0x8000;
                    while (!(xop & 0x40000000u)) { ++res; xop <<= 1; }
                }
                if (res < -s16(c.sb))
                    c.sb = static_cast<uint32_t>(-res) & M16;
                break;
            }
        }
    }

    // ------------------------------------------------------------------
    // execution (one-to-one with emu/adsp2105.py step())

    bool step() {
        ppc = pc;
        uint32_t op = rwordPgm(pc);

        if (pc != loop) {
            pc = (pc + 1) & M16;
        } else if (condition(loop_condition)) {
            pc = pcStackTop();
        } else {
            loopStackPop();
            pcStackPopVal();
            pc = (pc + 1) & M16;
        }

        uint32_t hi = (op >> 16) & 0xFF;
        if (hi == 0x00) {
        } else if (hi == 0x01) {
            stopped = true;
            return false;
        } else if (hi == 0x02) {
            if (op & 0x008000) { idle = 1; return false; }
            if (condition(op & 15)) {
                if (op & 0x020) flagout = 0;
                if (op & 0x010) flagout ^= 1;
                if (op & 0x080) fl0 = 0;
                if (op & 0x040) fl0 ^= 1;
                if (op & 0x200) fl1 = 0;
                if (op & 0x100) fl1 ^= 1;
                if (op & 0x800) fl2 = 0;
                if (op & 0x400) fl2 ^= 1;
            }
        } else if (hi == 0x03) {
            bool go = (op & 2) ? flagin != 0 : flagin == 0;
            if (go) {
                if (op & 1) pcStackPush(pc);
                pc = ((op >> 4) & 0x0FFF) | ((op << 10) & 0x3000);
            }
        } else if (hi == 0x04) {
            if (op & 0x10) pcStackPopVal();
            if (op & 0x08) loopStackPop();
            if (op & 0x04) cntrStackPop();
            if (op & 0x02) {
                if (op & 0x01) statStackPop();
                else statStackPush();
            }
        } else if (hi == 0x05) {
            if (astat & FMV) {
                if (core.mr & (1ull << 39))
                    core.mr = (core.mr & ~((1ull << 48) - 1))
                        | (0xFFFFull << 32) | (0x8000ull << 16);
                else
                    core.mr = (core.mr & ~((1ull << 48) - 1))
                        | (0x7FFFull << 16) | 0xFFFFull;
            }
        } else if (hi == 0x06) {
            uint32_t xop = aluX((op >> 8) & 7);
            uint32_t yop = aluY((op >> 11) & 3);
            uint32_t temp = xop ^ yop;
            astat = (astat & ~FQ) | ((temp >> 10) & FQ);
            core.af = ((yop << 1) | (core.ay0 >> 15)) & M16;
            core.ay0 = ((core.ay0 << 1) | (temp >> 15)) & M16;
        } else if (hi == 0x07) {
            uint32_t xop = aluX((op >> 8) & 7);
            uint32_t res = (astat & FQ) ? (core.af + xop)
                                        : (core.af - xop);
            uint32_t temp = res ^ xop;
            astat = (astat & ~FQ) | ((temp >> 10) & FQ);
            core.af = ((res << 1) | (core.ay0 >> 15)) & M16;
            core.ay0 = ((core.ay0 << 1) | ((~temp >> 15) & 1)) & M16;
        } else if (hi == 0x08) {
        } else if (hi == 0x09) {
            int b = (op >> 2) & 4;
            postModify(b + ((op >> 2) & 3), b + (op & 3));
        } else if (hi == 0x0A) {
            if (condition(op & 15)) {
                pcStackPop();
                if (op & 0x10) statStackPop();
                if (pc == 0xFFFF) { stopped = true; return false; }
            }
        } else if (hi == 0x0B) {
            if (condition(op & 15)) {
                if (op & 0x10) pcStackPush(pc);
                pc = i[4 + ((op >> 6) & 3)] & 0x3FFF;
            }
        } else if (hi == 0x0C) {
            uint32_t temp = mstat;
            if (op & 0x000008) temp = (temp & ~M_GOMODE) | ((op << 5) & M_GOMODE);
            if (op & 0x002000) temp = (temp & ~M_INTEGER) | ((op >> 8) & M_INTEGER);
            if (op & 0x008000) temp = (temp & ~M_TIMER) | ((op >> 9) & M_TIMER);
            if (op & 0x000020) temp = (temp & ~M_BANK) | ((op >> 4) & M_BANK);
            if (op & 0x000080) temp = (temp & ~M_REVERSE) | ((op >> 5) & M_REVERSE);
            if (op & 0x000200) temp = (temp & ~M_STICKYV) | ((op >> 6) & M_STICKYV);
            if (op & 0x000800) temp = (temp & ~M_SATURATE) | ((op >> 7) & M_SATURATE);
            setMstat(temp);
        } else if (hi == 0x0D) {
            writeReg((op >> 10) & 3, (op >> 4) & 15,
                     readReg((op >> 8) & 3, op & 15));
        } else if (hi == 0x0E) {
            if (condition(op & 15)) shiftOp(op, s8(core.se), false);
        } else if (hi == 0x0F) {
            shiftOp(op, s8(op), true);
        } else if (hi == 0x10) {
            shiftOp(op, s8(core.se), false);
            writeReg(0, (op >> 4) & 15, readReg(0, op & 15));
        } else if (hi == 0x11) {
            if (op & 0x8000) {
                pgmWriteDag2(op, readReg(0, (op >> 4) & 15) & M16);
                shiftOp(op, s8(core.se), false);
            } else {
                shiftOp(op, s8(core.se), false);
                writeReg(0, (op >> 4) & 15, pgmReadDag2(op));
            }
        } else if (hi == 0x12 || hi == 0x13) {
            bool d1 = hi == 0x12;
            if (op & 0x8000) {
                uint32_t v = readReg(0, (op >> 4) & 15) & M16;
                if (d1) dataWriteDag1(op, v);
                else dataWriteDag2(op, v);
                shiftOp(op, s8(core.se), false);
            } else {
                shiftOp(op, s8(core.se), false);
                writeReg(0, (op >> 4) & 15,
                         d1 ? dataReadDag1(op) : dataReadDag2(op));
            }
        } else if (hi >= 0x14 && hi <= 0x17) {
            loopStackPush(op & 0x3FFFF);
            pcStackPush(pc);
        } else if (hi >= 0x18 && hi <= 0x1B) {
            if (condition(op & 15)) {
                pc = (op >> 4) & 0x3FFF;
                if (pc == ppc) { stopped = true; return false; }
            }
        } else if (hi >= 0x1C && hi <= 0x1F) {
            if (condition(op & 15)) {
                pcStackPush(pc);
                pc = (op >> 4) & 0x3FFF;
            }
        } else if (hi >= 0x20 && hi <= 0x27) {
            int which = (hi >> 1) & 3;
            if (condition(op & 15)) {
                if (which == 0) macOp(op, false);
                else if (which == 1) aluOp(op, false);
                else if (which == 2) macOp(op, true);
                else aluOp(op, true);
            }
        } else if (hi >= 0x28 && hi <= 0x2F) {
            int which = (hi >> 1) & 3;
            int64_t temp = readReg(0, op & 15);
            if (which == 0) macOp(op, false);
            else if (which == 1) aluOp(op, false);
            else if (which == 2) macOp(op, true);
            else aluOp(op, true);
            writeReg(0, (op >> 4) & 15, temp);
        } else if (hi >= 0x30 && hi <= 0x3F) {
            int grp = (hi >> 2) & 3;
            int32_t val = static_cast<int32_t>(op << 14) >> 18;
            writeReg(grp, op & 15, val);
        } else if (hi >= 0x40 && hi <= 0x4F) {
            writeReg(0, op & 15, (op >> 4) & 0xFFFF);
        } else if (hi >= 0x50 && hi <= 0x5F) {
            int which = (hi >> 1) & 3;
            bool wr = hi & 0x08;
            if (wr) pgmWriteDag2(op, readReg(0, (op >> 4) & 15) & M16);
            if (which == 0) macOp(op, false);
            else if (which == 1) aluOp(op, false);
            else if (which == 2) macOp(op, true);
            else aluOp(op, true);
            if (!wr) writeReg(0, (op >> 4) & 15, pgmReadDag2(op));
        } else if (hi >= 0x60 && hi <= 0x7F) {
            int which = (hi >> 1) & 3;
            bool wr = hi & 0x08;
            bool d1 = hi < 0x70;
            if (wr) {
                uint32_t v = readReg(0, (op >> 4) & 15) & M16;
                if (d1) dataWriteDag1(op, v);
                else dataWriteDag2(op, v);
                if (which == 0) macOp(op, false);
                else if (which == 1) aluOp(op, false);
                else if (which == 2) macOp(op, true);
                else aluOp(op, true);
            } else {
                if (which == 0) macOp(op, false);
                else if (which == 1) aluOp(op, false);
                else if (which == 2) macOp(op, true);
                else aluOp(op, true);
                writeReg(0, (op >> 4) & 15,
                         d1 ? dataReadDag1(op) : dataReadDag2(op));
            }
        } else if (hi >= 0x80 && hi <= 0x8F) {
            int grp = (hi >> 2) & 3;
            writeReg(grp, op & 15, readDm((op >> 4) & 0x3FFF));
        } else if (hi >= 0x90 && hi <= 0x9F) {
            int grp = (hi >> 2) & 3;
            writeDm((op >> 4) & 0x3FFF, readReg(grp, op & 15) & M16);
        } else if (hi >= 0xA0 && hi <= 0xAF) {
            dataWriteDag1(op, (op >> 4) & 0xFFFF);
        } else if (hi >= 0xB0 && hi <= 0xBF) {
            dataWriteDag2(op, (op >> 4) & 0xFFFF);
        } else {
            bool isAlu = hi & 0x02;
            if (isAlu) aluOp(op, false);
            else macOp(op, false);
            int xreg = (op >> 18) & 3, yreg = (op >> 20) & 3;
            uint16_t dval = dataReadDag1(op);
            uint16_t pval = pgmReadDag2(op >> 4);
            Core& c = core;
            if (xreg == 0) c.ax0 = dval;
            else if (xreg == 1) c.ax1 = dval;
            else if (xreg == 2) c.mx0 = dval;
            else c.mx1 = dval;
            if (yreg == 0) c.ay0 = pval;
            else if (yreg == 1) c.ay1 = pval;
            else if (yreg == 2) c.my0 = pval;
            else c.my1 = pval;
        }
        return !(hw >= HW_DCS93 && reset_request);
    }

    // ------------------------------------------------------------------
    // decoder accelerator ("speedup" fast mode)
    //
    // Native execution of the firmware's inverse-transform region, the
    // overwhelming share of the decode loop's instruction count.  The
    // replacement reproduces the region's net DM effect bit-for-bit
    // (asserted end-to-end against strict mode by tests/test_emu_speedup.py
    // and differentially against the Python handlers in emu/speedup.py).
    //
    // Fixed-point semantics mirror refdec/fixed.py: 1.15 products <<1 into
    // a 64-bit accumulator, +0x8000 rounding with the chip's convergent-
    // rounding quirk (bit 16 cleared when the just-added product's low
    // word is exactly $8000), wrap or AR-saturation per region.

    // round((a*b)<<1 ± (c*d)<<1) high word — mulss_mr + multiply_round_*
    static inline int32_t accMulRound(int32_t a, int32_t b, int32_t c,
                                      int32_t d, bool sub) {
        uint64_t mr = static_cast<uint64_t>(
            static_cast<int64_t>(a * b) << 1);
        int64_t prod = static_cast<int64_t>(c * d) << 1;
        mr = sub ? mr - static_cast<uint64_t>(prod)
                 : mr + static_cast<uint64_t>(prod);
        mr += 0x8000;
        if ((prod & 0xFFFF) == 0x8000) mr &= ~0x10000ull;
        return s16(mr >> 16);
    }

    // round((a*b)<<1) — multiply_and_round (MUL_RND), high word
    static inline int32_t accMulRnd(int32_t a, int32_t b) {
        int64_t prod = static_cast<int64_t>(a * b) << 1;
        uint64_t mr = static_cast<uint64_t>(prod) + 0x8000;
        if ((prod & 0xFFFF) == 0x8000) mr &= ~0x10000ull;
        return s16(mr >> 16);
    }

    static inline uint16_t accSat16(int32_t v) {
        return static_cast<uint16_t>(v < -32768 ? -32768
                                                : v > 32767 ? 32767 : v);
    }

    // in-place decimation IFFT shared by every region: `iters` halving
    // iterations over dm[buf..], partition size starting at psz0, twiddles
    // from csin/ccos[part].  saturate selects AR-saturating u-updates
    // (the 94x family) vs wrapping (1993 family / original-ROM regions).
    // refdec/transform.py:78-103 (94) and :203-228 (93).
    void accelIFFT(uint32_t buf, int iters, uint32_t psz0,
                   const int32_t* csin, const int32_t* ccos, bool saturate) {
        int nPart = 2;
        uint32_t psz = psz0;
        for (int it = 0; it < iters; ++it) {
            uint32_t p0 = buf, p1 = buf + psz;
            for (int part = 0; part < nPart; ++part) {
                int32_t cs = csin[part], cc = ccos[part];
                for (uint32_t k = 0; k < psz / 2; ++k) {
                    int32_t are = s16(dm[p1 & 0x3FFF]);
                    int32_t aim = s16(dm[(p1 + 1) & 0x3FFF]);
                    int32_t tre = accMulRound(are, cc, aim, cs, true);
                    int32_t tim = accMulRound(aim, cc, are, cs, false);
                    int32_t ure = s16(dm[p0 & 0x3FFF]);
                    int32_t uim = s16(dm[(p0 + 1) & 0x3FFF]);
                    if (saturate) {
                        dm[p0 & 0x3FFF] = accSat16(ure - tre);
                        dm[(p0 + 1) & 0x3FFF] = accSat16(uim - tim);
                        dm[p1 & 0x3FFF] = accSat16(ure + tre);
                        dm[(p1 + 1) & 0x3FFF] = accSat16(uim + tim);
                    } else {
                        dm[p0 & 0x3FFF] = static_cast<uint16_t>(ure - tre);
                        dm[(p0 + 1) & 0x3FFF] = static_cast<uint16_t>(uim - tim);
                        dm[p1 & 0x3FFF] = static_cast<uint16_t>(ure + tre);
                        dm[(p1 + 1) & 0x3FFF] = static_cast<uint16_t>(uim + tim);
                    }
                    p0 += 2;
                    p1 += 2;
                }
                p0 += psz;
                p1 += psz;
            }
            nPart <<= 1;
            psz >>= 1;
        }
    }

    // synthesized OS94/OS95 firmware: the whole `transform` prologue —
    // center fold, three pre-passes, 6-iteration IFFT, volume shift
    // (compiler/firmware94.py _emit_transform; semantics
    // refdec/transform.py:27-107).  geom: fb, vshift, t_sin, t_cos, t_br.
    void accelSynth94() {
        uint32_t fb = su_geom[0], vsa = su_geom[1];
        uint32_t ts = su_geom[2], tc = su_geom[3], tb = su_geom[4];
        // fold fb[$80]/fb[$81]: ×(−1) via ×$8000 (unsaturated negate)
        int32_t half = -32768;
        dm[(fb + 0x80) & 0x3FFF] = static_cast<uint16_t>(
            (static_cast<int64_t>(s16(dm[(fb + 0x80) & 0x3FFF]) * half) << 1)
            >> 16);
        int32_t neg = -s16(dm[(fb + 0x81) & 0x3FFF]);
        dm[(fb + 0x81) & 0x3FFF] = static_cast<uint16_t>(
            (static_cast<int64_t>(s16(neg) * half) << 1) >> 16);
        // pre-pass 1: center/ends fold, scaled by $8000 (AR saturating)
        uint32_t p0 = fb, p1 = fb + 0x100;
        for (int k = 0; k < 0x40; ++k) {
            int32_t x0 = s16(dm[p0 & 0x3FFF]), x1 = s16(dm[(p0 + 1) & 0x3FFF]);
            int32_t y0 = s16(dm[p1 & 0x3FFF]), y1 = s16(dm[(p1 + 1) & 0x3FFF]);
            dm[p0 & 0x3FFF] = static_cast<uint16_t>(
                (static_cast<int64_t>(s16(accSat16(x0 + y0)) * half) << 1) >> 16);
            dm[p1 & 0x3FFF] = static_cast<uint16_t>(
                (static_cast<int64_t>(s16(accSat16(x0 - y0)) * half) << 1) >> 16);
            dm[(p0 + 1) & 0x3FFF] = static_cast<uint16_t>(
                (static_cast<int64_t>(s16(accSat16(x1 - y1)) * half) << 1) >> 16);
            dm[(p1 + 1) & 0x3FFF] = static_cast<uint16_t>(
                (static_cast<int64_t>(s16(accSat16(x1 + y1)) * half) << 1) >> 16);
            p0 += 2;
            p1 -= 2;
        }
        // pre-pass 2: complex twiddle fold with bit-reversed coefficients
        uint32_t i0 = 2, i1 = 0;
        uint32_t p4 = fb, p5 = fb + 0x100;
        for (int k = 0; k < 0x40; ++k) {
            int32_t c0 = s16(dm[(ts + dm[(tb + i0) & 0x3FFF]) & 0x3FFF]);
            int32_t c1 = s16(dm[(ts + dm[(tb + i1) & 0x3FFF]) & 0x3FFF]);
            int32_t x0 = s16(dm[p4 & 0x3FFF]), x1 = s16(dm[(p4 + 1) & 0x3FFF]);
            int32_t xn0 = s16(dm[p5 & 0x3FFF]), xn1 = s16(dm[(p5 + 1) & 0x3FFF]);
            int32_t prod0 = accMulRound(xn1, c1, xn0, c0, true);
            int32_t prod1 = accMulRound(xn1, c0, xn0, c1, false);
            dm[p4 & 0x3FFF] = accSat16(prod1 + x0);
            dm[(p4 + 1) & 0x3FFF] = accSat16(prod0 + x1);
            dm[p5 & 0x3FFF] = accSat16(x0 - prod1);
            dm[(p5 + 1) & 0x3FFF] = accSat16(prod0 - x1);
            p4 += 2;
            p5 -= 2;
            i0 += 4;
            i1 += 4;
        }
        // pre-pass 3: butterfly halves (saturating)
        p0 = fb;
        p1 = fb + 0x80;
        for (int k = 0; k < 0x40; ++k) {
            int32_t x0 = s16(dm[p0 & 0x3FFF]), x1 = s16(dm[(p0 + 1) & 0x3FFF]);
            int32_t y0 = s16(dm[p1 & 0x3FFF]), y1 = s16(dm[(p1 + 1) & 0x3FFF]);
            dm[p0 & 0x3FFF] = accSat16(x0 + y0);
            dm[(p0 + 1) & 0x3FFF] = accSat16(x1 + y1);
            dm[p1 & 0x3FFF] = accSat16(x0 - y0);
            dm[(p1 + 1) & 0x3FFF] = accSat16(x1 - y1);
            p0 += 2;
            p1 += 2;
        }
        int32_t csin[64], ccos[64];
        for (int k = 0; k < 64; ++k) {
            csin[k] = s16(dm[(ts + k) & 0x3FFF]);
            ccos[k] = s16(dm[(tc + k) & 0x3FFF]);
        }
        accelIFFT(fb, 6, 0x40, csin, ccos, true);
        // volume normalization: fb[i] >>= volShift (arithmetic)
        int32_t vs = s16(dm[vsa & 0x3FFF]);
        for (int k = 0; k < 0x100; ++k) {
            uint32_t a = (fb + k) & 0x3FFF;
            dm[a] = static_cast<uint16_t>(s16(dm[a]) >> vs);
        }
        // the region's register exit contract, which downstream firmware
        // may consume before rewriting: M3 = last IFFT partition size,
        // M7 = −3 (pre-pass 2), SE = −volShift; AR saturation netted off
        m[3] = 2;
        m[7] = -3;
        core.se = static_cast<uint32_t>(-vs) & M16;
        setMstat(mstat & ~M_SATURATE);
    }

    // synthesized OS93a/OS93b firmware: sqrt magnitude fixup, 256→512
    // expansion, 7-iteration IFFT, volume shift + bit-reversed extraction
    // (compiler/firmware93.py _emit_transform93; semantics
    // refdec/transform.py:145-234).  geom: fb, vshift, t_sin, t_cos, t_br.
    void accelSynth93() {
        uint32_t fb = su_geom[0], vsa = su_geom[1];
        uint32_t ts = su_geom[2], tc = su_geom[3], tb = su_geom[4];
        // --- sqrt magnitude fixup of element 0 (refdec :145-184)
        int32_t ar = s16(dm[fb & 0x3FFF]);
        bool asFlag = ar < 0;
        if (asFlag) ar = s16(-ar);
        int32_t f1 = s16(dm[(fb + 1) & 0x3FFF]);
        uint64_t mr = static_cast<uint64_t>(
            (static_cast<int64_t>(f1 * f1) << 1)
            + (static_cast<int64_t>(ar * ar) << 1));
        uint32_t sr = static_cast<uint32_t>(mr & M32);
        // normalize32: EXP + NORM (refdec/fixed.py)
        int exponent = 0;
        {
            uint32_t x = sr;
            if (x & 0x80000000u) {
                while (x & 0x40000000u) { --exponent; x = (x << 1) & M32; }
            } else {
                while (exponent > -31 && !(x & 0x40000000u)) {
                    --exponent;
                    x = (x << 1) & M32;
                }
            }
            if (exponent <= -32) sr = 0;
            else if (exponent < 0) sr = (sr << -exponent) & M32;
        }
        ar = s16(sr >> 16);
        if (ar != 0) {
            mr = 0x0D490000ull;
            mr += static_cast<uint64_t>(static_cast<int64_t>(0x5D1D * ar) << 1);
            int32_t mf = accMulRnd(ar, ar);
            mr += static_cast<uint64_t>(static_cast<int64_t>(-22035 * mf) << 1);
            mf = accMulRnd(ar, mf);
            mr += static_cast<uint64_t>(static_cast<int64_t>(0x46D6 * mf) << 1);
            mf = accMulRnd(ar, mf);
            mr += static_cast<uint64_t>(static_cast<int64_t>(-8790 * mf) << 1);
            mf = accMulRnd(ar, mf);
            mr += static_cast<uint64_t>(static_cast<int64_t>(0x072D * mf) << 1);
            if (exponent & 1) {
                int64_t prod = static_cast<int64_t>(
                    s16(mr >> 16) * 0x5A82) << 1;
                mr = static_cast<uint64_t>(prod) + 0x8000;
                if ((prod & 0xFFFF) == 0x8000) mr &= ~0x10000ull;
                exponent += 1;
            }
            exponent = exponent / 2 + 1;   // even here: trunc == floor
            int32_t v32 = static_cast<int32_t>(mr & M32);
            uint32_t shifted = exponent >= 0
                ? (static_cast<uint32_t>(v32) << exponent) & M32
                : (exponent > -32
                       ? static_cast<uint32_t>(v32 >> -exponent)
                       : (v32 < 0 ? M32 : 0));
            ar = s16(shifted >> 16);
            if (asFlag) ar = s16(-ar);
        }
        dm[fb & 0x3FFF] = static_cast<uint16_t>(ar);
        dm[(fb + 0x100) & 0x3FFF] = static_cast<uint16_t>(ar);
        dm[(fb + 1) & 0x3FFF] = 0;
        dm[(fb + 0x101) & 0x3FFF] = 0;
        // --- expand 256 → 512 (refdec :187-201), wrapping adds
        uint32_t i0 = fb + 2, i1 = fb + 0xFE, i2 = fb + 0x102, i3 = fb + 0x1FE;
        for (int k = 0; k < 0x40; ++k) {
            int32_t xr = s16(dm[i0 & 0x3FFF]), xi = s16(dm[(i0 + 1) & 0x3FFF]);
            int32_t yr = s16(dm[i1 & 0x3FFF]), yi = s16(dm[(i1 + 1) & 0x3FFF]);
            dm[i0 & 0x3FFF] = static_cast<uint16_t>(xr + yr);
            dm[i1 & 0x3FFF] = static_cast<uint16_t>(xr + yr);
            dm[i2 & 0x3FFF] = static_cast<uint16_t>(xr - yr);
            dm[i3 & 0x3FFF] = static_cast<uint16_t>(yr - xr);
            dm[(i2 + 1) & 0x3FFF] = static_cast<uint16_t>(xi + yi);
            dm[(i3 + 1) & 0x3FFF] = static_cast<uint16_t>(xi + yi);
            dm[(i0 + 1) & 0x3FFF] = static_cast<uint16_t>(xi - yi);
            dm[(i1 + 1) & 0x3FFF] = static_cast<uint16_t>(yi - xi);
            i0 += 2;
            i1 -= 2;
            i2 += 2;
            i3 -= 2;
        }
        // --- 7-iteration IFFT over 512 entries, unsaturated
        int32_t csin[128], ccos[128];
        for (int k = 0; k < 128; ++k) {
            csin[k] = s16(dm[(ts + k) & 0x3FFF]);
            ccos[k] = s16(dm[(tc + k) & 0x3FFF]);
        }
        accelIFFT(fb, 7, 0x80, csin, ccos, false);
        // --- volume shift + bit-reversed extraction into the odd slots,
        // in place and sequential (the aliasing is part of the semantics)
        int32_t vs = s16(dm[vsa & 0x3FFF]);
        uint32_t i4 = fb + 1;
        for (int k = 0; k < 0x100; ++k) {
            uint32_t src = (fb + dm[(tb + k) & 0x3FFF]) & 0x3FFF;
            dm[i4 & 0x3FFF] = static_cast<uint16_t>(s16(dm[src]) >> vs);
            i4 += 2;
        }
        // register exit contract: the overlap-add that follows walks the
        // odd fb slots with M3 = 2 (set before the extraction loop)
        m[3] = 2;
        core.se = static_cast<uint32_t>(-vs) & M16;
    }

    // original 1994+ ROM firmware: butterfly halves + 6-iteration IFFT +
    // volume multiply, all wrapping — the region the reference's
    // DCSSpeedup1994 replaces (reference: DCSDecoderEmu.cpp:644-757).
    // geom: ram1 (twiddles: sin at +0, cos at +$80), ram2 (the 256-word
    // work buffer), volume variable address.
    void accelOrig94() {
        uint32_t r1 = su_geom[0], r2 = su_geom[1], va = su_geom[2];
        uint32_t p0 = r2, p1 = r2 + 0x80;
        for (int k = 0; k < 0x40; ++k) {
            int32_t x0 = s16(dm[p0 & 0x3FFF]), x1 = s16(dm[(p0 + 1) & 0x3FFF]);
            int32_t y0 = s16(dm[p1 & 0x3FFF]), y1 = s16(dm[(p1 + 1) & 0x3FFF]);
            dm[p0 & 0x3FFF] = static_cast<uint16_t>(x0 + y0);
            dm[(p0 + 1) & 0x3FFF] = static_cast<uint16_t>(x1 + y1);
            dm[p1 & 0x3FFF] = static_cast<uint16_t>(x0 - y0);
            dm[(p1 + 1) & 0x3FFF] = static_cast<uint16_t>(x1 - y1);
            p0 += 2;
            p1 += 2;
        }
        int32_t csin[64], ccos[64];
        for (int k = 0; k < 64; ++k) {
            csin[k] = s16(dm[(r1 + k) & 0x3FFF]);
            ccos[k] = s16(dm[(r1 + 0x80 + k) & 0x3FFF]);
        }
        accelIFFT(r2, 6, 0x40, csin, ccos, false);
        int32_t vol = dm[va & 0x3FFF];
        if (vol > 0x8000) vol = 0x8000;
        for (int k = 0; k < 0x100; ++k) {
            uint32_t a = (r2 + k) & 0x3FFF;
            dm[a] = static_cast<uint16_t>((s16(dm[a]) * vol) >> 15);
        }
    }

    // original 1993 ROM firmware: 256→512 expansion + 7-iteration IFFT
    // (twiddles from PM, top 16 bits) + bit-reversed volume-multiplied
    // extraction — the region the reference's DCSSpeedup1993 replaces
    // (reference: DCSDecoderEmu.cpp:759-889).  geom: work buffer base,
    // volume variable address, PM sin base, PM cos base.
    void accelOrig93() {
        uint32_t fb = su_geom[0], va = su_geom[1];
        uint32_t ps = su_geom[2], pc_ = su_geom[3];
        // region prologue: mirror the center elements, zero the imaginaries
        dm[(fb + 0x100) & 0x3FFF] = dm[fb & 0x3FFF];
        dm[(fb + 1) & 0x3FFF] = 0;
        dm[(fb + 0x101) & 0x3FFF] = 0;
        uint32_t i0 = fb + 2, i1 = fb + 0xFE, i2 = fb + 0x102, i3 = fb + 0x1FE;
        for (int k = 0; k < 0x40; ++k) {
            int32_t xr = s16(dm[i0 & 0x3FFF]), xi = s16(dm[(i0 + 1) & 0x3FFF]);
            int32_t yr = s16(dm[i1 & 0x3FFF]), yi = s16(dm[(i1 + 1) & 0x3FFF]);
            dm[i0 & 0x3FFF] = static_cast<uint16_t>(xr + yr);
            dm[i1 & 0x3FFF] = static_cast<uint16_t>(xr + yr);
            dm[i2 & 0x3FFF] = static_cast<uint16_t>(xr - yr);
            dm[i3 & 0x3FFF] = static_cast<uint16_t>(yr - xr);
            dm[(i2 + 1) & 0x3FFF] = static_cast<uint16_t>(xi + yi);
            dm[(i3 + 1) & 0x3FFF] = static_cast<uint16_t>(xi + yi);
            dm[(i0 + 1) & 0x3FFF] = static_cast<uint16_t>(xi - yi);
            dm[(i1 + 1) & 0x3FFF] = static_cast<uint16_t>(yi - xi);
            i0 += 2;
            i1 -= 2;
            i2 += 2;
            i3 -= 2;
        }
        setMstat(0);                     // the region's own MSTAT reset
        int32_t csin[128], ccos[128];
        for (int k = 0; k < 128; ++k) {
            csin[k] = s16(pm[(ps + k) & 0x3FFF] >> 8);
            ccos[k] = s16(pm[(pc_ + k) & 0x3FFF] >> 8);
        }
        accelIFFT(fb, 7, 0x80, csin, ccos, false);
        // bit-reversed, volume-multiplied extraction into the odd slots
        // (reads land on even slots only, so order cannot alias)
        int32_t vol = dm[va & 0x3FFF];
        if (vol > 0x8000) vol = 0x8000;
        uint32_t i4 = fb + 1;
        for (int k = 0; k < 0x100; ++k) {
            // 9-bit reversal of k via the 14-bit table: rev14(k << 5)
            uint32_t src = (fb + T.reverse[(k << 5) & 0x3FFF]) & 0x3FFF;
            dm[i4 & 0x3FFF] = static_cast<uint16_t>(
                (s16(dm[src]) * vol) >> 15);
            i4 += 2;
        }
    }

    void accelRun(int kind) {
        switch (kind) {
            case ACCEL_SYNTH94: accelSynth94(); break;
            case ACCEL_SYNTH93: accelSynth93(); break;
            case ACCEL_ORIG94: accelOrig94(); break;
            case ACCEL_ORIG93: accelOrig93(); break;
        }
    }

    int64_t run(int64_t max_steps) {
        stopped = false;
        int64_t n = 0;
        while (n < max_steps) {
            if (pc == static_cast<uint32_t>(su_pc)) {
                accelRun(su_kind);
                pc = static_cast<uint32_t>(su_exit) & M16;
            }
            if (!step()) break;
            ++n;
        }
        return n;
    }

    // ------------------------------------------------------------------
    // state vector (layout: emu/adsp2105.py state_vec, STATE_LEN = 125)

    void coreVec(const Core& c, uint64_t* v) const {
        v[0] = c.ax0; v[1] = c.ax1; v[2] = c.ay0; v[3] = c.ay1;
        v[4] = c.ar; v[5] = c.af; v[6] = c.mx0; v[7] = c.mx1;
        v[8] = c.my0; v[9] = c.my1; v[10] = c.mr; v[11] = c.mf;
        v[12] = c.si; v[13] = c.se; v[14] = c.sb; v[15] = c.sr;
    }
    void coreLoad(Core& c, const uint64_t* v) {
        c.ax0 = v[0]; c.ax1 = v[1]; c.ay0 = v[2]; c.ay1 = v[3];
        c.ar = v[4]; c.af = v[5]; c.mx0 = v[6]; c.mx1 = v[7];
        c.my0 = v[8]; c.my1 = v[9]; c.mr = v[10]; c.mf = v[11];
        c.si = v[12]; c.se = v[13]; c.sb = v[14]; c.sr = v[15];
    }

    void getState(uint64_t* v) const {
        coreVec(core, v);
        coreVec(alt, v + 16);
        for (int k = 0; k < 8; ++k) v[32 + k] = i[k];
        for (int k = 0; k < 8; ++k)
            v[40 + k] = static_cast<uint32_t>(m[k]);
        for (int k = 0; k < 8; ++k) v[48 + k] = l[k];
        v[56] = px; v[57] = pc; v[58] = ppc; v[59] = loop;
        v[60] = loop_condition; v[61] = cntr; v[62] = astat; v[63] = sstat;
        v[64] = mstat; v[65] = astat_clear & 0xFF; v[66] = idle;
        for (int k = 0; k < 4; ++k) v[67 + k] = loop_stack[k];
        for (int k = 0; k < 4; ++k) v[71 + k] = cntr_stack[k];
        for (int k = 0; k < 16; ++k) v[75 + k] = pc_stack[k];
        for (int k = 0; k < 4; ++k)
            for (int j = 0; j < 3; ++j) v[91 + 3 * k + j] = stat_stack[k][j];
        v[103] = pc_sp; v[104] = cntr_sp; v[105] = stat_sp; v[106] = loop_sp;
        v[107] = flagout; v[108] = flagin; v[109] = fl0; v[110] = fl1;
        v[111] = fl2; v[112] = imask; v[113] = icntl; v[114] = ifc;
        for (int k = 0; k < 5; ++k) v[115 + k] = irq_latch[k];
        for (int k = 0; k < 5; ++k) v[120 + k] = irq_state[k];
    }

    void setState(const uint64_t* v) {
        coreLoad(core, v);
        coreLoad(alt, v + 16);
        for (int k = 0; k < 8; ++k) i[k] = v[32 + k] & 0x3FFF;
        for (int k = 0; k < 8; ++k)
            m[k] = static_cast<int32_t>(static_cast<uint32_t>(v[40 + k]));
        for (int k = 0; k < 8; ++k) {
            l[k] = v[48 + k] & 0x3FFF;
            lmask[k] = T.masks[l[k]];
            base[k] = i[k] & lmask[k];
        }
        px = v[56]; pc = v[57]; ppc = v[58]; loop = v[59];
        loop_condition = v[60]; cntr = v[61]; astat = v[62]; sstat = v[63];
        mstat = v[64]; astat_clear = v[65] & 0xFF; idle = v[66];
        for (int k = 0; k < 4; ++k) loop_stack[k] = v[67 + k];
        for (int k = 0; k < 4; ++k) cntr_stack[k] = v[71 + k];
        for (int k = 0; k < 16; ++k) pc_stack[k] = v[75 + k];
        for (int k = 0; k < 4; ++k)
            for (int j = 0; j < 3; ++j) stat_stack[k][j] = v[91 + 3 * k + j];
        pc_sp = v[103]; cntr_sp = v[104]; stat_sp = v[105]; loop_sp = v[106];
        flagout = v[107]; flagin = v[108]; fl0 = v[109]; fl1 = v[110];
        fl2 = v[111]; imask = v[112]; icntl = v[113]; ifc = v[114];
        for (int k = 0; k < 5; ++k) irq_latch[k] = v[115 + k];
        for (int k = 0; k < 5; ++k) irq_state[k] = v[120 + k];
    }
};

}  // namespace

extern "C" {

void* adsp_new() {
    Adsp* a = new Adsp;
    a->init();
    return a;
}

void adsp_free(void* p) { delete static_cast<Adsp*>(p); }

void adsp_reset(void* p) { static_cast<Adsp*>(p)->reset(); }

void adsp_get_state(void* p, uint64_t* v) {
    static_cast<Adsp*>(p)->getState(v);
}
void adsp_set_state(void* p, const uint64_t* v) {
    static_cast<Adsp*>(p)->setState(v);
}

void adsp_config_board(void* p, int hw, ReadPortFn rp, WritePortFn wp,
                       SetBankFn sb) {
    Adsp* a = static_cast<Adsp*>(p);
    a->hw = hw;
    a->cb_read_port = rp;
    a->cb_write_port = wp;
    a->cb_set_bank = sb;
}

void adsp_set_bank_window(void* p, const uint8_t* mem, int64_t len) {
    Adsp* a = static_cast<Adsp*>(p);
    a->bank = mem;
    a->bank_len = len;
}

uint32_t adsp_get_pm(void* p, int addr) {
    return static_cast<Adsp*>(p)->pm[addr & 0x3FFF];
}
void adsp_set_pm(void* p, int addr, uint32_t val) {
    static_cast<Adsp*>(p)->pm[addr & 0x3FFF] = val & 0xFFFFFF;
}
void adsp_read_pm_block(void* p, int base, int n, uint32_t* out) {
    Adsp* a = static_cast<Adsp*>(p);
    for (int k = 0; k < n; ++k) out[k] = a->pm[(base + k) & 0x3FFF];
}
void adsp_write_pm_block(void* p, int base, int n, const uint32_t* in) {
    Adsp* a = static_cast<Adsp*>(p);
    for (int k = 0; k < n; ++k) a->pm[(base + k) & 0x3FFF] = in[k] & 0xFFFFFF;
}

uint16_t adsp_get_dm(void* p, int addr) {
    return static_cast<Adsp*>(p)->dm[addr & 0x3FFF];
}
void adsp_set_dm(void* p, int addr, uint32_t val) {
    static_cast<Adsp*>(p)->dm[addr & 0x3FFF] = val & 0xFFFF;
}
void adsp_read_dm_block(void* p, int base, int n, uint16_t* out) {
    Adsp* a = static_cast<Adsp*>(p);
    for (int k = 0; k < n; ++k) out[k] = a->dm[(base + k) & 0x3FFF];
}
void adsp_write_dm_block(void* p, int base, int n, const uint16_t* in) {
    Adsp* a = static_cast<Adsp*>(p);
    for (int k = 0; k < n; ++k) a->dm[(base + k) & 0x3FFF] = in[k];
}
void adsp_read_dm_strided(void* p, int base, int step, int n, uint16_t* out) {
    Adsp* a = static_cast<Adsp*>(p);
    for (int k = 0; k < n; ++k)
        out[k] = a->dm[(base + k * step) & 0x3FFF];
}

int64_t adsp_run(void* p, int64_t max_steps) {
    return static_cast<Adsp*>(p)->run(max_steps);
}
int adsp_step(void* p) {
    // matches the Python core: step() never clears `stopped`, only run()
    return static_cast<Adsp*>(p)->step() ? 1 : 0;
}
int adsp_stopped(void* p) {
    return static_cast<Adsp*>(p)->stopped ? 1 : 0;
}
void adsp_set_stopped(void* p, int s) {
    static_cast<Adsp*>(p)->stopped = s != 0;
}
int adsp_take_reset_request(void* p) {
    Adsp* a = static_cast<Adsp*>(p);
    int r = a->reset_request ? 1 : 0;
    a->reset_request = false;
    return r;
}

uint32_t adsp_get_pc(void* p) { return static_cast<Adsp*>(p)->pc; }
void adsp_set_pc(void* p, uint32_t pc) { static_cast<Adsp*>(p)->pc = pc; }

int64_t adsp_invoke_irq(void* p, int which, int indx, int64_t max_steps) {
    Adsp* a = static_cast<Adsp*>(p);
    a->pc = 0xFFFF;
    a->generateIrq(which, indx);
    a->checkIrqs();
    return a->run(max_steps);
}

// autobuffer capture: out = {base (-1 if unset), length, step}
void adsp_get_autobuffer(void* p, int32_t* out) {
    Adsp* a = static_cast<Adsp*>(p);
    out[0] = a->ab_base;
    out[1] = a->ab_length;
    out[2] = a->ab_step;
}
void adsp_set_autobuffer(void* p, int32_t base, int32_t length,
                         int32_t step) {
    Adsp* a = static_cast<Adsp*>(p);
    a->ab_base = base;
    a->ab_length = length;
    a->ab_step = step;
}

uint32_t adsp_rword_pgm(void* p, uint32_t addr) {
    return static_cast<Adsp*>(p)->rwordPgm(addr);
}

// decoder accelerator ("speedup") config: kind < 0 disables
void adsp_set_speedup(void* p, int kind, int entry_pc, int exit_pc,
                      const uint16_t* geom, int n_geom) {
    Adsp* a = static_cast<Adsp*>(p);
    if (kind <= 0) {
        a->su_pc = -1;
        a->su_kind = 0;
        return;
    }
    a->su_kind = kind;
    a->su_pc = entry_pc;
    a->su_exit = exit_pc;
    for (int k = 0; k < 8; ++k)
        a->su_geom[k] = k < n_geom ? geom[k] : 0;
}

// run one accelerator region directly on the current DM/PM state
// (unit-test entry: differential vs the Python handlers in emu/speedup.py)
void adsp_accel_run(void* p, int kind, const uint16_t* geom, int n_geom) {
    Adsp* a = static_cast<Adsp*>(p);
    for (int k = 0; k < 8; ++k)
        a->su_geom[k] = k < n_geom ? geom[k] : 0;
    a->accelRun(kind);
}

}  // extern "C"
