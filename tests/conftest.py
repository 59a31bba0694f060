import os

# Kernel tests execute the Pallas bodies in interpret mode on CPU; the rest
# of the suite uses the jnp reference path (ops._mode default on CPU).
# NOTE: do NOT set xla_force_host_platform_device_count here — smoke tests
# and benches must see 1 device (the dry-run sets it itself).

import numpy as np
import pytest


@pytest.fixture()
def rng():
    # function-scoped: every test sees the same deterministic stream
    # regardless of which other tests ran (order-independence)
    return np.random.RandomState(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; the test skips without one")
