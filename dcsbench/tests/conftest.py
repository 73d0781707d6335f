"""The benchmark's own tests (CPU, small sizes; ``gpu``-marked ones run on
the card): ``python -m pytest dcsbench/tests -q`` from the repository's
root."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")
