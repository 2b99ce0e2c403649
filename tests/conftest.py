"""Shared fixtures.  NOTE: no XLA_FLAGS here — unit tests run on the plain
1-device CPU backend; multi-device coverage lives in subprocess scripts
under ``tests/md_scripts/`` (see ``test_multidevice.py``)."""

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "multidevice: 8-device subprocess integration scenario")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (CUDA kernels of repro_torch)")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
