"""Decoder backend registry with prefix matching.

The port's copy of ``dcsexplorer_tpu/refdec/registry.py``.

Counterpart of the reference's Registration/factory system
(reference: DCSDecoder.cpp:1955-1974) and the explorer's `--decoder`
selection logic (reference: DCSExplorer/DCSExplorer.cpp:458-537): backends
register under a name, and a caller selects one by exact name or unique
leading prefix (case-insensitive).

The port registers one backend, the native scalar decoder.  The JAX
package's two emulator backends run the original ROM firmware on its
ADSP-2105 interpreter (``emu/``), which the port does not carry: their
names resolve here as unknown backends.
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
    from .decoder import ReferenceDecoder
    register("native", "bit-exact scalar decoder (runtime reference)",
             lambda host=None: ReferenceDecoder(host))
