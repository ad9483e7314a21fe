"""Device-resident executor (ops/executor.py)."""

import numpy as np
import pytest

from spgemm_tpu.models.tile import csr_to_tiles
from spgemm_tpu.ops import golden
from spgemm_tpu.ops.executor import StripExecutor


def test_executor_run_compact(make_random_csr):
    a = make_random_csr(90, 90, 0.07)
    at = csr_to_tiles(a, 8, 16)
    bt = csr_to_tiles(a, 16, 16)
    ex = StripExecutor(at, bt)
    ref = golden.spgemm_dense_row(a, a)
    for _ in range(2):  # repeated dispatch, resident operands
        c = ex.run_compact().to_csr()
        assert c.pattern_equal(ref)
        np.testing.assert_allclose(c.data, ref.data, rtol=1e-5)


def test_executor_update_values(make_random_csr, rng):
    a = make_random_csr(64, 64, 0.08)
    at = csr_to_tiles(a, 8, 16)
    bt = csr_to_tiles(a, 16, 16)
    ex = StripExecutor(at, bt)
    ex.run_compact()

    # same pattern, new values
    a2 = a.copy_with_values(rng.integers(1, 9, a.nnz).astype(np.float64)) \
        if hasattr(a, "copy_with_values") else None
    if a2 is None:
        from spgemm_tpu.models.csr import CSR
        a2 = CSR(a.indptr, a.indices,
                 rng.integers(1, 9, a.nnz).astype(np.float64), a.shape)
    at2 = csr_to_tiles(a2, 8, 16)
    ex.update_values(at2)
    # NB: B still holds the old values — compare against A2 @ A1
    ref = golden.spgemm_dense_row(a2, a)
    c = ex.run_compact().to_csr()
    assert c.pattern_equal(ref)
    np.testing.assert_allclose(c.data, ref.data, rtol=1e-5)

    # structure mismatch rejected
    a3 = make_random_csr(64, 64, 0.2)
    with pytest.raises(ValueError, match="same tile structure"):
        ex.update_values(csr_to_tiles(a3, 8, 16))


def test_time_numeric(make_random_csr):
    a = make_random_csr(64, 64, 0.1)
    at = csr_to_tiles(a, 8, 16)
    bt = csr_to_tiles(a, 16, 16)
    ex = StripExecutor(at, bt)
    ms = ex.time_numeric(loop=2, repeats=1)
    assert ms >= 0


def test_esc_executor_premul_and_update(make_random_csr, rng):
    from spgemm_tpu.models.csr import CSR
    from spgemm_tpu.ops.esc import build_esc_scan_plan
    from spgemm_tpu.ops.executor import EscExecutor

    a = make_random_csr(200, 200, 0.05)
    plan = build_esc_scan_plan(a, a, keep_sources=True)
    ex = EscExecutor(plan)
    c = ex.run_csr()
    ref = golden.spgemm_scipy(a, a)
    got = golden.drop_explicit_zeros(c)
    assert got.pattern_equal(ref)
    np.testing.assert_allclose(got.data, ref.data, rtol=1e-5, atol=1e-7)

    # pattern-fixed value refresh: one plane upload, same structure
    a2 = CSR(a.indptr, a.indices,
             rng.standard_normal(a.nnz), a.shape)
    ex.update_values(a2.data, a2.data)
    c2 = ex.run_csr()
    ref2 = golden.spgemm_scipy(a2, a2)
    got2 = golden.drop_explicit_zeros(c2)
    assert got2.pattern_equal(ref2)
    np.testing.assert_allclose(got2.data, ref2.data, rtol=1e-5, atol=1e-7)


def test_esc_executor_mul_mode(make_random_csr, rng):
    from spgemm_tpu.models.csr import CSR
    from spgemm_tpu.ops.esc import build_esc_scan_plan
    from spgemm_tpu.ops.executor import EscExecutor

    a = make_random_csr(150, 150, 0.06)
    plan = build_esc_scan_plan(a, a, keep_sources=True)
    ex = EscExecutor(plan, mode="mul")
    c = ex.run_csr()
    ref = golden.spgemm_scipy(a, a)
    got = golden.drop_explicit_zeros(c)
    assert got.pattern_equal(ref)
    np.testing.assert_allclose(got.data, ref.data, rtol=1e-4, atol=1e-6)

    a2 = CSR(a.indptr, a.indices, rng.standard_normal(a.nnz), a.shape)
    ex.update_values(a2.data, a2.data)
    got2 = golden.drop_explicit_zeros(ex.run_csr())
    ref2 = golden.spgemm_scipy(a2, a2)
    assert got2.pattern_equal(ref2)
    np.testing.assert_allclose(got2.data, ref2.data, rtol=1e-4, atol=1e-6)


def test_esc_executor_errors(make_random_csr):
    from spgemm_tpu.ops.esc import build_esc_plan, build_esc_scan_plan
    from spgemm_tpu.ops.executor import EscExecutor

    a = make_random_csr(64, 64, 0.1)
    digit_plan = build_esc_plan(a, a)
    with pytest.raises(TypeError, match="ScanPlan"):
        EscExecutor(digit_plan)
    plan_nosrc = build_esc_scan_plan(a, a, keep_sources=False)
    # mul mode without sources is allowed (av=qv, bv=ones split) and
    # must produce the same results
    exm = EscExecutor(plan_nosrc, mode="mul")
    ref = golden.spgemm_scipy(a, a)
    gm = golden.drop_explicit_zeros(exm.run_csr())
    assert gm.pattern_equal(ref)
    np.testing.assert_allclose(gm.data, ref.data, rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="keep_sources"):
        exm.update_values(np.ones(a.nnz), np.ones(a.nnz))
    ex = EscExecutor(plan_nosrc)  # premul without sources: run-only
    with pytest.raises(ValueError, match="keep_sources"):
        ex.update_values(np.ones(a.nnz), np.ones(a.nnz))
    with pytest.raises(ValueError, match="premul"):
        EscExecutor(build_esc_scan_plan(a, a), mode="bogus")


def test_esc_executor_time_numeric(make_random_csr):
    from spgemm_tpu.ops.esc import build_esc_scan_plan
    from spgemm_tpu.ops.executor import EscExecutor

    a = make_random_csr(96, 96, 0.08)
    for mode in ("premul", "mul"):
        ex = EscExecutor(build_esc_scan_plan(a, a), mode=mode) \
            if mode == "premul" else \
            EscExecutor(build_esc_scan_plan(a, a, keep_sources=True),
                        mode=mode)
        ms = ex.time_numeric(loop=2, repeats=1)
        assert ms >= 0


def test_ozaki_executor_run_many_and_update_values():
    """OzakiExecutor: resident run-many + pattern-fixed f64 value
    refresh (re-slice + upload only; Sa/Sb may adapt to new values)."""
    import scipy.sparse as sp

    from spgemm_tpu.models.csr import CSR
    from spgemm_tpu.models.tile import csr_to_tiles
    from spgemm_tpu.ops.executor import OzakiExecutor
    from spgemm_tpu.ops.ozaki import build_ozaki_plan

    rng = np.random.default_rng(21)
    n = 400
    offs = np.arange(-5, 6)
    r = np.repeat(np.arange(n), offs.size)
    c = r + np.tile(offs, n)
    keep = (c >= 0) & (c < n)
    r, c = r[keep], c[keep]

    def multiply(vals):
        a = CSR.from_coo(r, c, vals, (n, n))
        return a

    a1 = multiply(rng.integers(1, 10, r.size).astype(np.float64))
    at = csr_to_tiles(a1, 16, 128)
    bt = csr_to_tiles(a1, 128, 128)
    plan = build_ozaki_plan(at, bt)
    ex = OzakiExecutor(plan, at, bt)
    out = ex.run()
    cube = ex.assemble(out)

    def oracle(a):
        A = sp.csr_matrix((a.data, a.indices, a.indptr), shape=(n, n))
        return (A @ A).toarray()

    def collect(cube, cnt):
        G = np.zeros((at.gm * 16, bt.gn * 128))
        for i, (tr, tc) in enumerate(zip(np.asarray(plan.ctrow),
                                         np.asarray(plan.ctcol))):
            G[tr * 16:(tr + 1) * 16, tc * 128:(tc + 1) * 128] += cube[i]
        return G[:n, :n]

    assert np.array_equal(collect(cube, out[2]), oracle(a1))
    assert plan.sa == 1  # integer model

    # same pattern, new general-f64 values -> S adapts, values correct
    a2 = multiply(rng.standard_normal(r.size))
    at2 = csr_to_tiles(a2, 16, 128)
    bt2 = csr_to_tiles(a2, 128, 128)
    ex.update_values(at2, bt2)
    assert plan.sa == 8
    out2 = ex.run()
    cube2 = ex.assemble(out2)
    ref2 = oracle(a2)
    assert np.abs(collect(cube2, out2[2]) - ref2).max() <= \
        1e-13 * np.abs(ref2).max()

    # pattern mismatch must be rejected
    a3 = CSR.from_coo(np.array([0]), np.array([0]), np.array([1.0]),
                      (n, n))
    with pytest.raises(ValueError):
        ex.update_values(csr_to_tiles(a3, 16, 128),
                         csr_to_tiles(a3, 128, 128))


def test_ozaki_executor_time_numeric_runs():
    """time_numeric must dispatch (the chain carries all 7 resident
    arrays incl. the combine permutation) — regression for the
    perm/bounds plumbing."""
    from spgemm_tpu.models.csr import CSR
    from spgemm_tpu.models.tile import csr_to_tiles
    from spgemm_tpu.ops.executor import OzakiExecutor
    from spgemm_tpu.ops.ozaki import build_ozaki_plan

    rng = np.random.default_rng(5)
    n = 300
    r = rng.integers(0, n, 2500)
    c = rng.integers(0, n, 2500)
    a = CSR.from_coo(r, c, rng.standard_normal(2500), (n, n))
    at = csr_to_tiles(a, 16, 128)
    bt = csr_to_tiles(a, 128, 128)
    ex = OzakiExecutor(build_ozaki_plan(at, bt), at, bt)
    ms = ex.time_numeric(loop=2, repeats=1)
    assert ms >= 0.0
