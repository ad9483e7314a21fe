import jax.numpy as jnp
import numpy as np
import pytest

from spgemm_tpu.models.csr import CSR
from spgemm_tpu.models.tile import csr_to_tiles
from spgemm_tpu.ops import golden
from spgemm_tpu.ops.spgemm import spgemm, spgemm_csr
from spgemm_tpu.ops.symbolic import build_pair_schedule


def test_pair_schedule_matches_grid_product(make_random_csr):
    a = make_random_csr(64, 48, 0.05)
    b = make_random_csr(48, 80, 0.05)
    at, bt = csr_to_tiles(a, 16, 16), csr_to_tiles(b, 16, 16)
    sched = build_pair_schedule(at, bt)
    # candidate C tiles == nnz of the boolean grid product
    ga = np.zeros((at.gm, at.gn))
    ga[at.trow, at.tcol] = 1
    gb = np.zeros((bt.gm, bt.gn))
    gb[bt.trow, bt.tcol] = 1
    gc = ga @ gb
    assert sched.nt_c == int((gc > 0).sum())
    # pair count == total grid products
    assert sched.num_pairs == int(gc.sum())
    # segments sorted, pair_ptr consistent
    assert np.all(np.diff(sched.seg) >= 0)
    assert np.array_equal(
        np.diff(sched.pair_ptr), np.bincount(sched.seg, minlength=sched.nt_c)
    )
    # k ascending within each segment
    ks = at.tcol[sched.pa]
    for s in range(min(sched.nt_c, 40)):
        lo, hi = sched.pair_ptr[s], sched.pair_ptr[s + 1]
        assert np.all(np.diff(ks[lo:hi]) > 0)


@pytest.mark.parametrize("tm,tn", [(16, 16), (8, 32)])
def test_spgemm_square_vs_oracle(make_random_csr, tm, tn):
    a = make_random_csr(150, 150, 0.03)
    c, res = spgemm_csr(a, tm=tm, tn=tn)
    ref = golden.spgemm_dense_row(a, a)
    assert c.pattern_equal(ref)
    np.testing.assert_allclose(c.data, ref.data, rtol=1e-6)


def test_spgemm_rectangular(make_random_csr):
    a = make_random_csr(90, 120, 0.04)
    b = make_random_csr(120, 70, 0.04)
    c, _ = spgemm_csr(a, b)
    ref = golden.spgemm_esc(a, b)
    assert c.pattern_equal(ref)
    np.testing.assert_allclose(c.data, ref.data, rtol=1e-6)


def test_spgemm_aat(make_random_csr):
    a = make_random_csr(80, 60, 0.06)
    c, res = spgemm_csr(a, aat=True)
    ref = golden.spgemm_scipy(a, a.transpose())
    assert golden.drop_explicit_zeros(c).allclose(ref, rtol=1e-6)
    assert "gflops" in res.stats


def test_spgemm_fp64(make_random_csr):
    a = make_random_csr(100, 100, 0.03, integer_vals=False)
    c, _ = spgemm_csr(a, compute_dtype=jnp.float64)
    ref = golden.spgemm_dense_row(a, a)
    assert c.pattern_equal(ref)
    np.testing.assert_allclose(c.data, ref.data, rtol=1e-12)


def test_spgemm_chunked_path(make_random_csr):
    # force the lax.scan chunked path with a tiny chunk
    a = make_random_csr(120, 120, 0.05)
    c, _ = spgemm_csr(a, chunk=64)
    ref = golden.spgemm_dense_row(a, a)
    assert c.pattern_equal(ref)
    np.testing.assert_allclose(c.data, ref.data, rtol=1e-6)


def test_spgemm_cancellation_keeps_structure():
    a = CSR.from_dense(np.array([[1.0, -1.0], [0.0, 2.0]]))
    b = CSR.from_dense(np.array([[1.0, 0.0], [1.0, 0.0]]))
    at, bt = csr_to_tiles(a, 2, 2), csr_to_tiles(b, 2, 2)
    res = spgemm(at, bt)
    c = res.c.to_csr()
    ref = golden.spgemm_dense_row(a, b)
    assert c.pattern_equal(ref)  # C[0,0]=0 structural, C[1,0]=2
    np.testing.assert_allclose(c.data, ref.data)


def test_spgemm_empty_result():
    # A's occupied columns never meet B's occupied rows
    a = CSR.from_coo([0], [0], [1.0], (4, 4))
    b = CSR.from_coo([3], [3], [1.0], (4, 4))
    at, bt = csr_to_tiles(a, 2, 2), csr_to_tiles(b, 2, 2)
    res = spgemm(at, bt)
    assert res.c.nnz == 0 and res.c.nt == 0


def test_spgemm_grid_false_positive_pruned():
    # tiles intersect at grid level but not at element level
    a = CSR.from_coo([0], [0], [1.0], (4, 4))   # tile (0,0), element (0,0)
    b = CSR.from_coo([1], [1], [1.0], (4, 4))   # tile (0,0), element (1,1)
    at, bt = csr_to_tiles(a, 2, 2), csr_to_tiles(b, 2, 2)
    sched = build_pair_schedule(at, bt)
    assert sched.nt_c == 1  # grid-level candidate
    res = spgemm(at, bt)
    assert res.c.nt == 0    # pruned after numeric/structural pass


def test_spgemm_sequential_values_exact(make_random_csr):
    # the reference driver's synthetic i%10 values: fp32 must be exact
    a = make_random_csr(200, 200, 0.02).with_sequential_values()
    c, _ = spgemm_csr(a)
    ref = golden.spgemm_dense_row(a, a)
    assert c.pattern_equal(ref)
    np.testing.assert_array_equal(c.data, ref.data)


def test_auto_backend(make_random_csr):
    a = make_random_csr(100, 100, 0.05)
    c, res = spgemm_csr(a, backend="auto")
    ref = golden.spgemm_scipy(a, a)
    assert golden.drop_explicit_zeros(c).allclose(ref, rtol=1e-6)


def test_selfcheck_mode(make_random_csr, monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_SELFCHECK", "1")
    a = make_random_csr(80, 80, 0.06)
    c, res = spgemm_csr(a, backend="strip")
    ref = golden.spgemm_scipy(a, a)
    assert golden.drop_explicit_zeros(c).allclose(ref, rtol=1e-6)


def test_gustavson_backend_matches_oracle(make_random_csr):
    a = make_random_csr(110, 90, 0.06)
    b = make_random_csr(90, 70, 0.08)
    at, bt = csr_to_tiles(a, 8, 16), csr_to_tiles(b, 16, 16)
    res = spgemm(at, bt, backend="gustavson")
    ref = golden.spgemm_dense_row(a, b)
    got = res.c.to_csr()
    assert got.pattern_equal(ref)
    np.testing.assert_allclose(got.data, ref.data, rtol=1e-6)
    assert res.stats["backend"].startswith("gustavson")


def test_xla_backend_rectangular(make_random_csr):
    a = make_random_csr(70, 120, 0.05)
    b = make_random_csr(120, 50, 0.07)
    at, bt = csr_to_tiles(a, 8, 16), csr_to_tiles(b, 16, 16)
    res = spgemm(at, bt, backend="xla")
    ref = golden.spgemm_dense_row(a, b)
    got = res.c.to_csr()
    assert got.pattern_equal(ref)
    np.testing.assert_allclose(got.data, ref.data, rtol=1e-6)


def test_dense_backend_matches_oracle(make_random_csr):
    a = make_random_csr(90, 110, 0.05)
    b = make_random_csr(110, 70, 0.06)
    at, bt = csr_to_tiles(a, 8, 16), csr_to_tiles(b, 16, 16)
    res = spgemm(at, bt, backend="dense")
    ref = golden.spgemm_dense_row(a, b)
    got = res.c.to_csr()
    assert got.pattern_equal(ref)
    np.testing.assert_allclose(got.data, ref.data, rtol=1e-6)
    assert res.stats["backend"].startswith("dense")


def test_dense_backend_structural_zeros():
    # cancellation must keep structural entries (cnt>0, value 0)
    a = CSR.from_coo([0, 0], [0, 1], [1.0, -1.0], (2, 2))
    b = CSR.from_coo([0, 1], [0, 0], [1.0, 1.0], (2, 2))
    at, bt = csr_to_tiles(a, 2, 2), csr_to_tiles(b, 2, 2)
    res = spgemm(at, bt, backend="dense")
    c = res.c.to_csr()
    assert c.nnz == 1 and c.data[0] == 0.0  # structural zero kept


@pytest.mark.parametrize("backend", ["strip", "gustavson", "dense", "xla"])
def test_stored_zero_inputs_are_structural(backend):
    """The reference overwrites values with i%10, which INCLUDES zeros
    (main.cu:111-112): a stored zero is a structural nonzero and must
    contribute to C's pattern on every backend."""
    a = CSR.from_coo([0, 1], [0, 0], [0.0, 2.0], (2, 2))
    b = CSR.from_coo([0], [0], [3.0], (2, 2))
    at, bt = csr_to_tiles(a, 2, 2), csr_to_tiles(b, 2, 2)
    res = spgemm(at, bt, backend=backend)
    c = res.c.to_csr()
    # row 0: structural (0*3 = 0, kept); row 1: 2*3 = 6
    assert c.nnz == 2, f"{backend}: stored-zero row lost ({c.nnz=})"
    d = c.to_dense()
    assert d[1, 0] == 6.0 and d[0, 0] == 0.0


def test_auto_routes_low_reuse_to_esc():
    """Routing refinement: moderate-occupancy, low-reuse patterns
    (block-diagonal: occ ~265, reuse ~17) route auto to the scan engine;
    high-reuse structured patterns (banded: reuse ~65) stay tiled."""
    from spgemm_tpu.ops.spgemm import (ESC_OCCUPANCY_TH,
                                       ESC_STRUCTURED_OCC_TH, ESC_REUSE_TH,
                                       _tile_reuse, tile_occupancy_estimate)
    from spgemm_tpu.utils.generators import banded, block_diag

    rng = np.random.default_rng(7)
    bd = block_diag(rng, 2048)
    occ = tile_occupancy_estimate(bd, 16, 128)
    assert occ >= ESC_OCCUPANCY_TH  # not caught by the unstructured gate
    assert occ < ESC_STRUCTURED_OCC_TH
    assert _tile_reuse(bd, None, False) < ESC_REUSE_TH
    c, res = spgemm_csr(bd, backend="auto")
    assert res.stats["backend"] == "esc"
    ref = golden.spgemm_scipy(bd, bd)
    assert golden.drop_explicit_zeros(c).allclose(ref, rtol=1e-5)

    bn = banded(rng, 2048, 64)
    assert _tile_reuse(bn, None, False) >= ESC_REUSE_TH
    c2, res2 = spgemm_csr(bn, backend="auto")
    assert res2.stats["backend"] != "esc"
    ref2 = golden.spgemm_scipy(bn, bn)
    assert golden.drop_explicit_zeros(c2).allclose(ref2, rtol=1e-5)


def test_f64_auto_routes_without_x64():
    """spgemm_csr(compute_dtype=f64) with x64 off must not raise.
    Routing, best path first: integer data provably exact in f32 runs
    the FULL-SPEED f32 pipeline ('f64-exact-int'); structured
    non-integer data runs the Ozaki-slice engine; unstructured
    non-integer data runs the double-double scan — all f64-correct on
    f32-only hardware."""
    import jax as _jax
    import jax.numpy as _jnp

    from spgemm_tpu.utils.generators import banded

    rng = np.random.default_rng(3)
    a = banded(rng, 1024, 64)
    a = type(a)(a.indptr, a.indices,
                ((np.arange(a.nnz) % 9) + 1).astype(np.float64), a.shape)
    _jax.config.update("jax_enable_x64", False)  # conftest turns it on
    try:
        c, res = spgemm_csr(a, compute_dtype=_jnp.float64, backend="auto")
        # structured, non-integer -> ozaki
        a2 = type(a)(a.indptr, a.indices, a.data + 0.5, a.shape)
        c2, res2 = spgemm_csr(a2, compute_dtype=_jnp.float64,
                              backend="auto")
        # unstructured, non-integer -> double-double scan
        au = _rand_unstructured(rng)
        cu, resu = spgemm_csr(au, compute_dtype=_jnp.float64,
                              backend="auto")
    finally:
        _jax.config.update("jax_enable_x64", True)
    assert "f64-exact-int" in str(res.stats["backend"])
    ref = golden.spgemm_scipy(a, a)
    got = golden.drop_explicit_zeros(c)
    assert got.pattern_equal(ref)
    np.testing.assert_array_equal(got.data, ref.data)
    assert str(res2.stats["backend"]).startswith("ozaki")
    ref2 = golden.spgemm_scipy(a2, a2)
    got2 = golden.drop_explicit_zeros(c2)
    assert got2.pattern_equal(ref2)
    np.testing.assert_allclose(got2.data, ref2.data, rtol=1e-13)
    assert resu.stats["backend"] == "esc"
    refu = golden.spgemm_scipy(au, au)
    gotu = golden.drop_explicit_zeros(cu)
    assert gotu.pattern_equal(refu)
    np.testing.assert_allclose(gotu.data, refu.data, rtol=1e-12)


def _rand_unstructured(rng):
    """Sparse enough that tile occupancy falls below the ESC threshold
    (~1 nnz per occupied 16x128 tile); +0.5 dodges the integer-exact
    fast route so the DD scan is exercised."""
    from spgemm_tpu.models.csr import CSR

    n = 4096
    r = rng.integers(0, n, 4000)
    c = rng.integers(0, n, 4000)
    return CSR.from_coo(
        r, c, rng.integers(1, 10, 4000).astype(np.float64) + 0.5, (n, n))
