import numpy as np
import jax.numpy as jnp
import pytest

from spgemm_tpu.models.tile import csr_to_tiles
from spgemm_tpu.ops.spmm import spmm, spmv


@pytest.mark.parametrize("k", [1, 32, 128])
def test_spmm_vs_dense(make_random_csr, rng, k):
    a = make_random_csr(100, 130, 0.05)
    x = rng.integers(0, 5, size=(130, k)).astype(np.float64)
    t = csr_to_tiles(a, 16, 16)
    y = np.asarray(spmm(t, x))
    np.testing.assert_allclose(y, a.to_dense() @ x, rtol=1e-6)


def test_spmv_vector(make_random_csr, rng):
    a = make_random_csr(90, 60, 0.08)
    x = rng.integers(0, 5, size=60).astype(np.float64)
    t = csr_to_tiles(a, 16, 16)
    y = np.asarray(spmv(t, x))
    assert y.shape == (90,)
    np.testing.assert_allclose(y, a.to_dense() @ x, rtol=1e-6)


def test_spmm_ragged_edge(make_random_csr, rng):
    a = make_random_csr(37, 41, 0.15)
    x = rng.standard_normal((41, 8))
    t = csr_to_tiles(a, 16, 16)
    y = np.asarray(spmm(t, x, dtype=jnp.float64))
    np.testing.assert_allclose(y, a.to_dense() @ x, rtol=1e-12)


def test_spmm_empty(rng):
    from spgemm_tpu.models.csr import CSR

    a = CSR.from_coo(np.zeros(0), np.zeros(0), np.zeros(0), (32, 32))
    t = csr_to_tiles(a, 16, 16)
    y = np.asarray(spmm(t, np.ones((32, 4))))
    np.testing.assert_array_equal(y, np.zeros((32, 4)))


def test_spmm_shape_mismatch(make_random_csr):
    a = make_random_csr(32, 32, 0.1)
    t = csr_to_tiles(a, 16, 16)
    with pytest.raises(ValueError):
        spmm(t, np.ones((31, 4)))


def test_spmm_chunked(make_random_csr, rng):
    a = make_random_csr(200, 200, 0.05)
    t = csr_to_tiles(a, 16, 16)
    x = rng.integers(0, 5, size=(200, 16)).astype(np.float64)
    from spgemm_tpu.ops.spmm import _spmm_tiles
    import jax.numpy as jnp

    pad = t.gn * t.tn - t.n
    xb = np.pad(x, ((0, pad), (0, 0))).reshape(t.gn, t.tn, 16)
    y = _spmm_tiles(
        jnp.asarray(t.dense(), dtype=jnp.float32),
        jnp.asarray(t.trow), jnp.asarray(t.tcol),
        jnp.asarray(xb, dtype=jnp.float32),
        gm=t.gm, chunk=8,  # force the scan path
    )
    y = np.asarray(y).reshape(t.gm * t.tm, 16)[: t.m]
    np.testing.assert_allclose(y, a.to_dense() @ x, rtol=1e-6)


def test_spmm_gather_unstructured(make_random_csr):
    """Gather SpMM: the unstructured path (dense tile paths blow HBM on
    ~1M near-empty tiles; this one works from raw CSR)."""
    import numpy as np

    from spgemm_tpu.ops.spmm import spmm_gather

    rng = np.random.default_rng(9)
    m, n, k = 700, 600, 96
    a = make_random_csr(m, n, 0.01)
    x = rng.standard_normal((n, k)).astype(np.float32)
    y = spmm_gather(a, x)
    ref = a.to_dense() @ x.astype(np.float64)
    assert np.allclose(y, ref, rtol=1e-4, atol=1e-5)
    # skewed row wider than the product budget (sibling groups)
    r = np.concatenate([np.zeros(5000, np.int64),
                        rng.integers(1, m, 500)])
    c = np.concatenate([rng.integers(0, n, 5000),
                        rng.integers(0, n, 500)])
    aw = type(a).from_coo(r, c, rng.standard_normal(r.size), (m, n))
    yw = spmm_gather(aw, x)
    refw = aw.to_dense() @ x.astype(np.float64)
    assert np.allclose(yw, refw, rtol=1e-4, atol=1e-4)
