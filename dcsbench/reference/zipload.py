"""PinMame ROM zip loading (reference: DCSDecoderZipLoader.cpp:61-207).

The benchmark's frozen copy of the port's ROM loader.

Identifies U2 heuristically (ADSP-2105 JUMP opcode at offset 0 plus a '2' in
the file name) and U3-U9 by the internal "[SU]<n> ... MM/DD/YY" signature,
with the Cactus Canyon U7-labeled-U6 special case.
"""

import io
import re
import zipfile

from .image import RomSet, is_jump

_SIG_RE = re.compile(rb"[SU]([^\d]*)(\d).*?\s+\d\d/\d\d/\d\d", re.DOTALL)


def load_zip_data(data, explicit_u2=None, zip_name=""):
    """Load a ROM set from zip bytes.  Returns (RomSet, files) where files is
    {name: chip_number_or_None}.  Raises ValueError if U2 can't be found."""
    zf = zipfile.ZipFile(io.BytesIO(data))
    entries = []
    for info in zf.infolist():
        if info.is_dir():
            continue
        entries.append((info.filename, zf.read(info)))

    rs = RomSet()
    assigned = {name: None for name, _ in entries}

    u2 = None
    for name, blob in entries:
        if ((len(blob) >= 4 and is_jump(blob) and "2" in name)
                or (explicit_u2 is not None
                    and name.lower() == explicit_u2.lower())):
            u2 = (name, blob)
            break
    if u2 is None:
        raise ValueError("no file identifiable as ROM U2")
    assigned[u2[0]] = 2
    rs.add_rom(2, u2[1])

    base = re.sub(r"^([A-Za-z]:)?(.*[/\\])?", "", zip_name)
    is_cc = re.match(r"^cc_\d.*", base, re.IGNORECASE) is not None

    for n in range(3, 10):
        want = str(n).encode()
        for name, blob in entries:
            if assigned[name] is not None or str(n) not in name:
                continue
            # the reference full-matches the content as a C string (up to the
            # first NUL): the signature must end with the MM/DD/YY date
            cstr = blob[:256].split(b"\0", 1)[0]
            m = _SIG_RE.fullmatch(cstr)
            sig_digit = m.group(2) if m else None
            load = sig_digit == want
            # Cactus Canyon U7 is internally labeled U6
            if is_cc and m and n == 7 and sig_digit == b"6":
                load = True
            if load:
                rs.add_rom(n, blob)
                assigned[name] = n
                break
    return rs, assigned


def load_zip_file(path, explicit_u2=None):
    with open(path, "rb") as f:
        return load_zip_data(f.read(), explicit_u2=explicit_u2, zip_name=path)
