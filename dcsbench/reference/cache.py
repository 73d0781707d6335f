"""The reference's own cache of stream indexes.

The scalar walkers take ~0.35 ms a frame, so indexing a title-sized ROM
(~62,640 frames) takes ~20 s.  An index depends only on the frozen bytes it
was walked from, so the reference keeps each one it walks in
``build/dcsbench/prescan/`` of the checkout, keyed by the walker, the
stream's position and the SHA-256 of the image that holds it; the walk runs
once a checkout.  Nothing of the program under test is cached here.
"""

import dataclasses
import hashlib
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DIR = os.path.join(ROOT, "build", "dcsbench", "prescan")


class IndexCache:
    def __init__(self, directory=DIR):
        self.directory = directory
        self._sha = {}               # id(image) -> (image, its SHA-256)

    def _image_sha(self, mem):
        hit = self._sha.get(id(mem))
        if hit is None or hit[0] is not mem:
            hit = self._sha[id(mem)] = (mem, hashlib.sha256(
                bytes(mem)).hexdigest())
        return hit[1]

    def index(self, walker, mem, pos):
        """``walker(mem, pos)`` (a scalar walker returning a dataclass), or
        its stored result for the same image and position."""
        key = hashlib.sha256(f"{walker.__module__}.{walker.__qualname__}:"
                             f"{pos}:{self._image_sha(mem)}".encode())
        path = os.path.join(self.directory, f"{key.hexdigest()}.npz")
        idx = walker(mem, pos) if not os.path.exists(path) else None
        if idx is None:
            with np.load(path, allow_pickle=False) as z:
                cls = _CLASSES[str(z["__class__"])]
                return cls(**{f.name: (z[f.name] if z[f.name].ndim
                                       else int(z[f.name]))
                              for f in dataclasses.fields(cls)})
        os.makedirs(self.directory, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        fields = {f.name: np.asarray(-1 if getattr(idx, f.name) is None
                                     else getattr(idx, f.name))
                  for f in dataclasses.fields(idx)}
        np.savez(tmp, __class__=np.asarray(type(idx).__name__), **fields)
        os.replace(tmp, path)
        return idx


_CLASSES = {}


def register(cls):
    _CLASSES[cls.__name__] = cls
    return cls
