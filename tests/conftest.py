"""Test configuration: an 8-device virtual CPU platform.

Unit tests run on the CPU; multi-device sharding tests use the virtual
device mesh (xla_force_host_platform_device_count). The card tests
(marker `gpu`, tests/test_gpu.py) run only when chip_smoke.py runs
pytest in its own process on the card (SPGEMM_CARD_TESTS=1); then the
platform is left alone. Whether a card is present is decided inside
the `gpu` fixture, never at import.
"""

import os

CARD_RUN = os.environ.get("SPGEMM_CARD_TESTS") == "1"
if not CARD_RUN:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if not CARD_RUN:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # fp64 golden-path tests

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs the GPU; run on the card by chip_smoke.py")


@pytest.fixture
def gpu():
    """The GPU device, or a skip: card tests run only on the card."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs the GPU (runs on the card via chip_smoke.py)")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def random_csr(rng, m, n, density, dtype=np.float64, integer_vals=True):
    """Random CSR with exactly-representable values (integer-valued by
    default so fp32 accumulation is exact in tests)."""
    from spgemm_tpu.models.csr import CSR

    nnz = max(1, int(m * n * density))
    rows = rng.integers(0, m, size=nnz)
    cols = rng.integers(0, n, size=nnz)
    if integer_vals:
        vals = rng.integers(1, 10, size=nnz).astype(dtype)
    else:
        vals = rng.standard_normal(nnz).astype(dtype)
    return CSR.from_coo(rows, cols, vals, (m, n))


@pytest.fixture
def make_random_csr(rng):
    import functools

    return functools.partial(random_csr, rng)
