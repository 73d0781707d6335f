"""Decoder backend registry with prefix matching.

Counterpart of the reference's Registration/factory system
(reference: DCSDecoder.cpp:1955-1974) and the explorer's `--decoder`
selection logic (reference: DCSExplorer/DCSExplorer.cpp:458-537): backends
register under a name, and a caller selects one by exact name or unique
leading prefix (case-insensitive).

The port's copy of ``dcsexplorer_tpu/refdec/registry.py``; its emulator
backends run the port's ``emu/`` (tests/test_torch_emu.py).

Like the reference, three backends register: the native decoder, the
strict-mode emulator, and the emulator with the "speedup" fast mode
(the reference's counterpart: PinMame-derived native IFFT inner loops,
DCSDecoderEmu.cpp:644-889; ours: signature-detected transform regions
executed by the CPU core's accelerator, emu/speedup.py).  The fast mode
is verifiable in-repo because the synthesized decoding firmware carries
detectable transform code — tests/test_emu_speedup.py asserts fast ≡
strict ≡ native PCM.  Validation paths keep using strict mode, exactly
as the reference does (DCSExplorer.cpp:1033-1036).
"""


class Registration:
    def __init__(self, name, description, factory):
        self.name = name
        self.description = description
        self.factory = factory


_REGISTRY = {}


def register(name, description, factory):
    _REGISTRY[name] = Registration(name, description, factory)


def registrations():
    """All registered backends, sorted by name."""
    _ensure_builtin()
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


class AmbiguousBackendError(ValueError):
    pass


def resolve(prefix):
    """Find a backend by exact name or unique leading prefix.

    Raises KeyError (no match) or AmbiguousBackendError (several matches).
    """
    _ensure_builtin()
    p = prefix.lower()
    matches = []
    for name, reg in sorted(_REGISTRY.items()):
        if name.lower() == p:
            return reg
        if name.lower().startswith(p):
            matches.append(reg)
    if len(matches) == 1:
        return matches[0]
    if not matches:
        raise KeyError(prefix)
    raise AmbiguousBackendError(
        f"'{prefix}' matches {[m.name for m in matches]}")


def create(prefix, host=None):
    """Instantiate the backend selected by name/prefix."""
    return resolve(prefix).factory(host)


def _ensure_builtin():
    if "native" in _REGISTRY:
        return
    from ..emu.board import EmulatedDecoder
    from .decoder import ReferenceDecoder
    register("native", "bit-exact scalar decoder (runtime reference)",
             lambda host=None: ReferenceDecoder(host))
    register("emulator-strict",
             "ADSP-2105 interpreter running original ROM firmware",
             lambda host=None: EmulatedDecoder(host))
    register("emulator-fast",
             "ADSP-2105 interpreter with native transform speedup",
             lambda host=None: EmulatedDecoder(host, enable_speedup=True))
