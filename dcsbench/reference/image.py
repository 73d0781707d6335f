"""ROM set model: chip registry, catalog, checksums, version/game detection.

The benchmark's frozen copy of the port's ROM loader.

Host-side mirror of the reference's ROM handling (DCSDecoder.cpp:26-669):
U2..U9 chip images, 24-bit linear-address→pointer mapping (which differs by
hardware generation), catalog discovery at U2 $3000/$4000/$6000, the POST
checksum algorithm, HW/OS version detection via opcode-pattern search
(including the embedded 1.03-1.05 version extraction), game identification
from the U2 signature, and channel-count detection.
"""

import re

import numpy as np

from .bitreader import PaddedView
from .decoder import OS93A, OS93B, OS94, OS95, Pointer
from .opsearch import search_opcodes

HW_UNKNOWN, HW_INVALID, HW_DCS93, HW_DCS95 = 0, 1, 2, 3

# Known DCS titles: (game id, title, U2-signature regex)
# (recognition data per reference DCSDecoder.cpp:127-172)
GAME_TABLE = [
    ("AFM", "Attack from Mars", "Attack from Mars"),
    ("CC", "Cactus Canyon", "Cactus Canyon"),
    ("CP", "The Champion Pub", "Champion Pub"),
    ("CV", "Cirqus Voltaire", "Cirqus Voltaire"),
    ("Corvette", "Corvette", "Corvette Pinball"),
    ("DM", "Demolition Man", "Demolition Man"),
    ("DH", "Dirty Harry", "Dirty Harry"),
    ("FS", "The Flintstones", "WMS Gaming Stones Sounds"),
    ("IJ", "Indiana Jones: The Pinball Adventure", "Indiana Jones"),
    ("I500", "Indianapolis 500", "Indy 500"),
    ("JB", "Jack*bot", "Jackbot"),
    ("JM", "Johnny Mnemonic", "Johnny Mnemonic"),
    ("JD", "Judge Dredd", "Judge Dredd"),
    ("MM", "Medieval Madness", "Medieval Madness"),
    ("MB", "Monster Bash", "Monster Pinball"),
    ("NBAFB", "NBA Fastbreak", "Fastbreak Game Sounds"),
    ("NF", "No Fear Dangerous Sports", "No Fear Pinball"),
    ("NGG", "No Good Gofers", "Gofers Pinball"),
    ("Popeye", "Popeye Saves the Earth", "Popeye"),
    ("RS", "Red & Ted's Roadshow", "Roadshow"),
    ("SC", "Safe Cracker", "Safe Cracker"),
    ("SS", "Scared Stiff", "Elv2 AV Pinball"),
    ("TS", "The Shadow", "The Shadow"),
    ("STTNG", "Star Trek: The Next Generation", "Star Trek The Next Generation"),
    ("TOTAN", "Tales of the Arabian Nights", "Arabian Nights"),
    ("ToM", "Theatre of Magic", "Theatre of Magic"),
    ("WCS", "World Cup Soccer", "World Cup Soccer"),
    ("WDI", "Who Dunnit", "WDI Pinball"),
    ("KINST", "Killer Instinct", r"Killer Instinct \(c\)"),
    ("MK2", "Mortal Kombat 2", r"Mortal Kombat II \(c\) 1993 Williams - DWF"),
    ("MK3", "Mortal Kombat 3", r"Mortal Kombat III\(c\) 1994 Williams - DWF"),
    ("NBAHT", "NBA Hangtime", "NBA HANGTIME GAME SOUND ROMS"),
    ("NBAHT", "NBA Hangtime (Hack)", "NBA SUPER HANGTIME"),
    ("RMPGWT", "Rampage World Tour", "WMS Rampage II Video"),
    ("WWFW", "WWF Wrestlemania Arcade",
     r"WWF Video \(c\) 1993 Williams Electronics Games, Inc\."),
]


def checksum(data):
    """DCS POST checksum: low byte of even-offset sum in the high byte, low
    byte of odd-offset sum in the low byte (reference: DCSDecoder.cpp:653-669)."""
    a = np.frombuffer(bytes(data), dtype=np.uint8)
    if a.size % 2:
        a = a[:a.size - 1]
    even = int(a[0::2].astype(np.int64).sum()) & 0xFF
    odd = int(a[1::2].astype(np.int64).sum()) & 0xFF
    return (even << 8) | odd


def is_jump(b):
    """ADSP-2105 JUMP test: $18-1B xx xF (reference: DCSDecoder.cpp:79)."""
    return (b[0] & 0xFC) == 0x18 and (b[2] & 0x0F) == 0x0F


def get_signature(u2):
    """Validated human-readable signature at U2+4, or '' if not present."""
    if len(u2) < 128 or not is_jump(u2):
        return ""
    out = []
    for i in range(4, 124):
        c = u2[i]
        if c == 0:
            return "".join(out)
        if not (32 <= c < 127):
            return ""
        out.append(chr(c))
    return ""


def infer_game_id(signature):
    for gid, _, pat in GAME_TABLE:
        if re.search(pat, signature, re.IGNORECASE):
            return gid
    return None


def game_title(game_id):
    for gid, title, _ in GAME_TABLE:
        if gid == game_id:
            return title
    return "[Unknown]"


def find_catalog(u2):
    """Locate the catalog in U2 ($3000/$4000/$6000); 0 if absent.

    The catalog leads with U2's own index entry: size in 4KB units, bank
    select 0, checksum 0 (reference: DCSDecoder.cpp:207-234)."""
    for ofs in (0x3000, 0x4000, 0x6000):
        if ofs + 6 > len(u2):
            continue
        size = ((u2[ofs] << 8) | u2[ofs + 1]) * 4096
        chip_sel = u2[ofs + 2]
        cksum = (u2[ofs + 4] << 8) | u2[ofs + 5]
        if chip_sel == 0 and cksum == 0 and size == len(u2):
            return ofs
    return 0


class RomSet:
    """Loaded DCS ROM set with catalog + version/game metadata."""

    MISSING_PAGE = 0x2000

    def __init__(self):
        self.chips = [None] * 8          # byte buffers (PaddedView-wrapped)
        self.chip_sizes = [0] * 8
        self.is_dummy = [True] * 8
        self.catalog_ofs = 0
        self.n_tracks = 0
        self._track_index = 0            # byte offset in U2
        self._indirect_index = 0
        self.hw_version = HW_UNKNOWN
        self.os_version = 0
        self.nominal_version = 0
        self.game_id = None
        self._missing = bytes([0xFF]) * self.MISSING_PAGE

    # ------------------------------------------------------------------
    def add_rom(self, n, data):
        """Register chip Un (n = 2..9) (reference: DCSDecoder.cpp:26-65).

        Chip images are padded with $FF up to a power-of-2 size: real chips
        are power-of-2 and unprogrammed flash reads $FF, and the hardware's
        offset masking (make_pointer) requires it.  This also makes
        truncated images fail their checksums instead of crashing."""
        if not (2 <= n <= 9) or len(data) == 0:
            return
        # minimum 32 KB so the catalog probe offsets always exist
        size = 1 << max(15, (len(data) - 1).bit_length())
        if len(data) < size:
            data = bytes(data) + b"\xff" * (size - len(data))
        i = n - 2
        self.chips[i] = data
        self.chip_sizes[i] = len(data)
        self.is_dummy[i] = False
        if n == 2:
            self.catalog_ofs = find_catalog(data)
            if self.catalog_ofs:
                co = self.catalog_ofs
                self._track_index = self._u24(0, co + 0x40)
                self._indirect_index = self._u24(0, co + 0x43)
                self.n_tracks = (data[co + 0x46] << 8) | data[co + 0x47]
            self.game_id = infer_game_id(get_signature(data))

    def _u24(self, chip, ofs):
        d = self.chips[chip]
        return (d[ofs] << 16) | (d[ofs + 1] << 8) | d[ofs + 2]

    @property
    def u2(self):
        return self.chips[0]

    def signature(self):
        return get_signature(self.chips[0]) if self.chips[0] is not None else ""

    def soft_boot_offset(self):
        """$1000 or $2000, detected by the RESET-vector JUMP
        (reference: DCSDecoder.cpp:81-89)."""
        return 0x1000 if is_jump(self.chips[0][0x1000:0x1003]) else 0x2000

    # ------------------------------------------------------------------
    def make_pointer(self, linear):
        """24-bit linear ROM address → Pointer.  Chip select is bits 21-23
        (DCS-95) or 20-22 (original) (reference: DCSDecoder.cpp:67-76)."""
        shift = 21 if self.hw_version == HW_DCS95 else 20
        chip = (linear >> shift) & 0x07
        mem = self.chips[chip]
        size = self.chip_sizes[chip]
        return Pointer(mem, linear & (size - 1), chip)

    def track_index_u24(self, track_no):
        d = self.chips[0]
        o = self._track_index + track_no * 3
        return (d[o] << 16) | (d[o + 1] << 8) | d[o + 2]

    def indirect_index_u24(self, lo):
        d = self.chips[0]
        o = self._indirect_index + lo * 3
        return (d[o] << 16) | (d[o + 1] << 8) | d[o + 2]

    # ------------------------------------------------------------------
    def check(self):
        """POST: validate the chip index against computed checksums and
        detect HW/OS versions.  Returns the original status codes: 1 = OK,
        2..9 = ROM U2..U9 failed (reference: DCSDecoder.cpp:236-504)."""
        self.hw_version = HW_INVALID
        self.os_version = 0
        self.nominal_version = 0
        if self.chips[0] is None:
            return 2

        sums = [0] * 8
        n_populated = 0
        for i in range(8):
            if self.chips[i] is not None and not self.is_dummy[i]:
                sums[i] = checksum(self.chips[i])
                n_populated += 1
            else:
                self.chips[i] = self._missing
                self.chip_sizes[i] = self.MISSING_PAGE
                self.is_dummy[i] = True

        u2 = self.chips[0]
        for ofs in (0x3000, 0x4000, 0x6000):
            n_in_table = 0
            n_validated = 0
            first_failed = -1
            for entry in range(9):
                o = ofs + entry * 6
                size = ((u2[o] << 8) | u2[o + 1]) * 4096
                chip_sel = u2[o + 2]
                ck = (u2[o + 4] << 8) | u2[o + 5]
                if size == 0:
                    break
                n_in_table += 1
                if ofs == 0x6000:
                    chip_sel >>= 1
                if (chip_sel < 8 and self.chips[chip_sel] is not None
                        and self.chip_sizes[chip_sel] == size
                        and not self.is_dummy[chip_sel]
                        and sums[chip_sel] == ck):
                    n_validated += 1
                else:
                    first_failed = entry
                    break
            if n_validated == 0:
                continue

            if ofs == 0x6000:
                self.hw_version = HW_DCS95
                self.os_version = OS95
                # embedded 1.03-1.05 version number from the 55C2/C3 handler
                # opcodes (reference: DCSDecoder.cpp:384-412)
                start = 0x2000 + 0x0300 * 4
                addr, v = search_opcodes(
                    "4vvvvE 0F16F8 93300E 18***F 4wwwwE 0F1608 0F16F8 93300E 18***F",
                    bytes(u2[start:start + 0x180 * 4]))
                if addr >= 0:
                    self.nominal_version = v["v"] & 0xFFFF
            else:
                self.hw_version = HW_DCS93
                self.os_version = OS94
                # 1993 software detection (reference: DCSDecoder.cpp:414-463)
                start = 0x1000 + 0x0100 * 4
                addr, _ = search_opcodes(
                    "380026 3C1005 0C00C0", bytes(u2[start:start + 0x180 * 4]))
                if addr >= 0:
                    self.os_version = OS93B
                    start = 0x2000 + 0x0200 * 4
                    addr, _ = search_opcodes(
                        "47FFF2 47C946", bytes(u2[start:start + 0x100 * 4]))
                    if addr >= 0:
                        self.os_version = OS93A

            if n_validated == n_populated and n_populated == n_in_table:
                return 1
            return first_failed + 2

        return 2

    def version_number(self):
        """Nominal version word (reference: DCSDecoder.cpp:506-512)."""
        if self.nominal_version:
            return self.nominal_version
        if self.os_version in (OS93A, OS93B):
            return 0x0100
        if self.os_version == OS94:
            return 0x0101
        return 0

    def version_info(self):
        """Human-readable version description
        (reference: DCSDecoder.cpp:514-607)."""
        hw = {HW_DCS93: "DCS audio board", HW_DCS95: "DCS-95 A/V board",
              HW_INVALID: "Hardware type not detected"}.get(
                  self.hw_version, "Unknown hardware type")
        if self.nominal_version:
            year = {0x0103: "1995", 0x0104: "1997", 0x0105: "1997"}.get(
                self.nominal_version, "1995+")
            sw = (f"Software {self.nominal_version >> 8}."
                  f"{self.nominal_version & 0xFF:02d} ({year})")
        else:
            sw = {OS93A: "Software 1.0a (1993)", OS93B: "Software 1.0b (1993)",
                  OS94: "Software 1.01 (1993)",
                  OS95: "Software 1.02 (1995)"}.get(self.os_version,
                                                    "Unknown")
        return f"{hw}, {sw}"

    def num_channels(self):
        """Channel count from the track-execution-loop opcode signature
        (reference: DCSDecoder.cpp:609-651)."""
        if self.chips[0] is None:
            return 0
        addr, v = search_opcodes(
            "22200F 4000n4 26E20F 221800 9****A 8****A 400mm4 26E20F 18***1",
            bytes(self.chips[0][:0x6000]))
        if addr >= 0:
            n = v["n"]
            if v["m"] == (1 << n) - 1:
                return n
        return 0
