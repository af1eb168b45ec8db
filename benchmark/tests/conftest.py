"""CPU tests of the benchmark; the ``gpu`` test runs a cell on a card and
skips without one."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device (skips without one)")
