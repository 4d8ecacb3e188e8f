"""Tests of the port's benchmark harness: ``python -m pytest
portbench/tests -q`` from the repository's root. Tests that need a CUDA
card carry the ``chip`` marker and skip without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skipped without one")
