"""CPU tests of the benchmark (portbench/): run from the root of the
checkout with ``python -m pytest portbench/tests -q``. They import the
port, never the JAX package."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips where there is none)")
