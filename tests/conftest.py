import os

# Smoke tests / benches must see exactly ONE device (the dry-run sets its own
# 512-device flag as the very first thing in launch/dryrun.py, never here).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# The property tests use hypothesis when available; offline containers fall
# back to the seeded-parametrize shim (tests/_hypothesis_compat.py).
try:
    import hypothesis  # noqa: F401
    _HYP_SHIM = False
except ImportError:
    import _hypothesis_compat
    _hypothesis_compat.install()
    _HYP_SHIM = True


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running MapReduce/straggler tests; "
        "deselect with -m 'not slow' for the fast lane")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


def pytest_generate_tests(metafunc):
    if _HYP_SHIM:
        _hypothesis_compat.generate(metafunc)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
