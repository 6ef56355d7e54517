"""The benchmark's own tests: ``python -m pytest portbench/tests -q``
from the repository's root. They run on the CPU at small sizes; those
marked ``chip`` need a CUDA device and skip without one (the check is
made inside each test)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device (skips without one)")
