"""Tests for the digit-ESC unstructured engine (ops/esc.py) — the
nsparse-replacement path (`src/spgemm_nsparse_kernel.h`).
All run on CPU (conftest forces jax_platforms=cpu); the engine is pure
XLA ops, so CPU execution exercises the same computation graph as the
GPU."""

import numpy as np
import pytest

import jax

from spgemm_tpu.models.csr import CSR
from spgemm_tpu.ops import golden
from spgemm_tpu.ops.esc import (
    build_esc_plan,
    esc_numeric,
    esc_trim,
    spgemm_esc,
    time_esc,
)
from spgemm_tpu.ops.spgemm import spgemm_csr, tile_occupancy_estimate

rng = np.random.default_rng(42)


def rand_csr(m, n, nnz, seed=None):
    r = np.random.default_rng(seed if seed is not None else rng.integers(1 << 30))
    return CSR.from_coo(
        r.integers(0, m, nnz), r.integers(0, n, nnz),
        r.standard_normal(nnz), (m, n),
    )


def assert_matches_oracle(a, b, rtol=1e-4):
    # both numeric formulations must agree with the oracle
    for mode in ("scan", "digit"):
        c, tms, plan = spgemm_esc(a, b, mode=mode)
        ref = golden.spgemm_scipy(a, b)
        got = golden.drop_explicit_zeros(c)
        assert got.pattern_equal(ref), mode
        assert np.allclose(got.data, ref.data, rtol=rtol, atol=1e-6), mode
    return c, plan


def test_random_square():
    a = rand_csr(300, 300, 4000, seed=1)
    b = rand_csr(300, 300, 4000, seed=2)
    c, plan = assert_matches_oracle(a, b)
    assert plan.num_products > 0
    assert c.nnz == plan.nnz_c


def test_rectangular():
    a = rand_csr(100, 250, 1500, seed=3)
    b = rand_csr(250, 80, 1200, seed=4)
    assert_matches_oracle(a, b)


def test_wide_c_row_slot_range_split():
    # one A row with thousands of nnz -> C row wider than the 2048-slot
    # group space, exercising the slot-range subgroup path
    m, k, n = 32, 3000, 5000
    r = np.concatenate([np.zeros(3000, np.int64),
                        np.arange(1, m, dtype=np.int64)])
    c_ = np.concatenate([np.arange(3000),
                         np.arange(1, m, dtype=np.int64)])
    a = CSR.from_coo(r, c_, np.random.default_rng(5).standard_normal(r.size),
                     (m, k))
    b = rand_csr(k, n, 25000, seed=6)
    _, plan = assert_matches_oracle(a, b)
    assert max(np.diff(plan.c_indptr)) > 2048  # wider than a digit group


def test_dup_heavy_flop_split_siblings():
    # dense band: ~60 products per output, forcing sibling groups over
    # the same slot interval whose padded outputs the trim pass sums
    nb = 256
    offs = np.arange(-30, 31)
    rr = np.repeat(np.arange(nb), offs.size)
    cc = rr + np.tile(offs, nb)
    keep = (cc >= 0) & (cc < nb)
    vals = np.random.default_rng(7).standard_normal(int(keep.sum()))
    a = CSR.from_coo(rr[keep], cc[keep], vals, (nb, nb))
    assert_matches_oracle(a, a, rtol=1e-3)


def test_structural_zeros_kept():
    r = np.array([0, 0, 5, 9])
    c_ = np.array([1, 3, 3, 9])
    v = np.array([2.0, 0.0, 1.0, 3.0])  # explicit zero is structural
    a = CSR.from_coo(r, c_, v, (10, 10))
    c, _, _ = spgemm_esc(a, a)
    ref = golden.spgemm_esc(a, a)
    assert c.pattern_equal(ref)
    assert np.allclose(c.data, ref.data)


def test_empty_and_disjoint():
    a = CSR.from_coo(np.array([1]), np.array([2]), np.array([5.0]), (4, 8))
    b = CSR.from_coo(np.array([7]), np.array([0]), np.array([3.0]), (8, 3))
    c, _, plan = spgemm_esc(a, b)
    assert c.nnz == 0 and plan.num_products == 0
    e = CSR.from_coo(np.zeros(0, np.int64), np.zeros(0, np.int64),
                     np.zeros(0), (5, 5))
    c2, _, _ = spgemm_esc(e, e)
    assert c2.nnz == 0


def test_f64_exact():
    if not jax.config.jax_enable_x64:
        jax.config.update("jax_enable_x64", True)
    a = rand_csr(128, 128, 900, seed=8)
    c, _, _ = spgemm_esc(a, a, dtype=np.float64)
    ref = golden.spgemm_scipy(a, a)
    got = golden.drop_explicit_zeros(c)
    assert got.pattern_equal(ref)
    assert np.allclose(got.data, ref.data, rtol=1e-12)


def test_plan_refresh_values():
    a = rand_csr(150, 150, 1500, seed=9)
    plan = build_esc_plan(a, a)
    new = CSR(a.indptr, a.indices,
              np.random.default_rng(10).standard_normal(a.nnz), a.shape)
    plan.refresh_values(new.data, new.data)
    c = esc_trim(plan, esc_numeric(plan))
    ref = golden.spgemm_scipy(new, new)
    got = golden.drop_explicit_zeros(c)
    assert got.pattern_equal(ref)
    assert np.allclose(got.data, ref.data, rtol=1e-4)


def test_spgemm_csr_esc_backend_and_auto():
    n = 4096
    a = rand_csr(n, n, n * 6, seed=11)
    assert tile_occupancy_estimate(a) < 8.0
    c, res = spgemm_csr(a, backend="auto")
    assert res.stats["backend"] == "esc"
    ref = golden.spgemm_scipy(a, a)
    assert golden.drop_explicit_zeros(c).allclose(ref, rtol=1e-4, atol=1e-6)
    # aat
    c2, res2 = spgemm_csr(a, aat=True, backend="esc")
    ref2 = golden.spgemm_scipy(a, a.transpose())
    assert golden.drop_explicit_zeros(c2).allclose(ref2, rtol=1e-4, atol=1e-6)
    # structured high-reuse input keeps the strip path (a 65-wide band:
    # reuse ~65 — narrow bands with reuse < ESC_REUSE_TH now route to
    # the scan engine by design, see test_auto_routes_low_reuse_to_esc)
    nb, offs = 512, np.arange(-32, 33)
    rr = np.repeat(np.arange(nb), offs.size)
    cc = rr + np.tile(offs, nb)
    keep = (cc >= 0) & (cc < nb)
    band = CSR.from_coo(rr[keep], cc[keep],
                        np.ones(int(keep.sum())), (nb, nb))
    _, res3 = spgemm_csr(band, backend="auto")
    assert not str(res3.stats["backend"]).startswith("esc")


def test_spgemm_csr_esc_errors():
    a = rand_csr(4, 8, 6, seed=12)
    with pytest.raises(ValueError, match="square"):
        spgemm_csr(a, backend="esc")
    sq = rand_csr(8, 8, 6, seed=13)
    with pytest.raises(ValueError, match="either b or aat"):
        spgemm_csr(sq, b=sq, aat=True, backend="esc")


def test_time_esc_runs():
    a = rand_csr(256, 256, 2000, seed=14)
    plan = build_esc_plan(a, a)
    ms = time_esc(plan, loop=3, repeats=1)
    assert ms >= 0.0


def test_scan_plan_refresh_and_trim():
    from spgemm_tpu.ops.esc import (build_esc_scan_plan, esc_scan_numeric,
                                    esc_scan_trim)

    a = rand_csr(200, 200, 2400, seed=15)
    plan = build_esc_scan_plan(a, a)
    new = CSR(a.indptr, a.indices,
              np.random.default_rng(16).standard_normal(a.nnz), a.shape)
    plan.refresh_values(new.data, new.data)
    c = esc_scan_trim(plan, esc_scan_numeric(plan))
    ref = golden.spgemm_scipy(new, new)
    got = golden.drop_explicit_zeros(c)
    assert got.pattern_equal(ref)
    assert np.allclose(got.data, ref.data, rtol=1e-4, atol=1e-6)


def test_scan_numpy_fallback_matches_native():
    import os

    from spgemm_tpu.ops.esc import (build_esc_scan_plan, esc_scan_numeric,
                                    esc_scan_trim)

    a = rand_csr(150, 150, 2000, seed=17)
    plans = {}
    for native in ("1", "0"):
        os.environ["SPGEMM_TPU_NATIVE"] = native
        try:
            plans[native] = build_esc_scan_plan(a, a)
        finally:
            os.environ.pop("SPGEMM_TPU_NATIVE", None)
    ca = esc_scan_trim(plans["1"], esc_scan_numeric(plans["1"]))
    cb = esc_scan_trim(plans["0"], esc_scan_numeric(plans["0"]))
    assert ca.pattern_equal(cb)
    assert np.allclose(ca.data, cb.data, rtol=1e-6)


@pytest.mark.parametrize("keep_sources,group_rows",
                         [(True, 1), (False, 1), (True, 8), (False, 4)])
def test_scan_native_plan_arrays_exact(keep_sources, group_rows):
    """The native symbolic (esc_scan_sym1 + esc_scan_fill2, including the
    per-row radix and bitmap-extraction paths) must reproduce the NumPy
    fallback's plan arrays BIT-FOR-BIT: same padded layout, same
    product order within a run (stable A-order), same run-start marks."""
    from spgemm_tpu.utils.native import esc_scan_symbolic_native
    from spgemm_tpu.ops.esc import _esc_scan_symbolic_numpy

    r = np.random.default_rng(99)
    n = 500
    # hub structure: a few rows with >4096 products (radix path) and
    # >=64 distinct cols (bitmap path); the rest tiny (direct path)
    rows = np.concatenate([
        np.zeros(900, np.int64),                  # hub row 0: >4096 products
        r.integers(0, n, 8000),
    ])
    cols = np.concatenate([
        r.integers(0, n, 900),
        r.integers(0, n, 8000),
    ])
    a = CSR.from_coo(rows, cols, r.standard_normal(rows.size), (n, n))
    blen = np.diff(a.indptr)
    f_row0 = int(blen[a.indices[: a.indptr[1]]].sum())
    assert f_row0 > 4096  # hub row must take the radix path
    native = esc_scan_symbolic_native(a, a, keep_sources=keep_sources,
                                      group_rows=group_rows)
    if native is None:
        pytest.skip("native library unavailable")
    ref = _esc_scan_symbolic_numpy(a, a, group_rows=group_rows)
    (ci_n, cx_n, f_n, qv_n, mt_n, wr_n, as_n, bs_n, mr_n) = native
    (ci_r, cx_r, f_r, qv_r, mt_r, wr_r, as_r, bs_r, mr_r) = ref
    assert f_n == f_r and mr_n == mr_r
    np.testing.assert_array_equal(ci_n, ci_r)
    np.testing.assert_array_equal(cx_n, cx_r)
    np.testing.assert_array_equal(wr_n, wr_r)
    # fallback is always ROW_ALIGN-padded like the native path
    assert qv_n.shape == qv_r.shape
    np.testing.assert_array_equal(qv_n, qv_r)
    np.testing.assert_array_equal(mt_n, mt_r)
    if keep_sources:
        np.testing.assert_array_equal(as_n, as_r)
        np.testing.assert_array_equal(bs_n, bs_r)
    else:
        assert as_n is None and bs_n is None


@pytest.mark.parametrize("group_rows", [2, 8])
def test_scan_group_rows_oracle(group_rows):
    """G-row in-kernel window reduction (output traffic / G) must be
    value-correct for both the f32 scan and the double-double kernel."""
    from spgemm_tpu.ops.esc import (build_esc_scan_plan, esc_scan_dd,
                                    esc_scan_numeric, esc_scan_trim)

    a = rand_csr(200, 200, 4000, seed=33)
    plan = build_esc_scan_plan(a, a, keep_sources=True,
                               group_rows=group_rows)
    assert plan.group_rows == group_rows
    assert np.all(np.diff(plan.win_rowptr) % group_rows == 0)
    c = esc_scan_trim(plan, esc_scan_numeric(plan))
    ref = golden.spgemm_scipy(a, a)
    got = golden.drop_explicit_zeros(c)
    assert got.pattern_equal(ref)
    # f32 bar (same as assert_matches_oracle): one seed-dependent
    # heavy-cancellation element sits at ~4e-5 rel even with G=1
    assert np.allclose(got.data, ref.data, rtol=1e-4, atol=1e-6)
    # double-double through the same grouped plan: f64-accurate
    cdd = esc_scan_dd(plan, a.data, a.data)
    gdd = golden.drop_explicit_zeros(cdd)
    assert gdd.pattern_equal(ref)
    assert np.allclose(gdd.data, ref.data, rtol=1e-12, atol=1e-13)


def test_choose_group_rows():
    from spgemm_tpu.ops.esc import choose_group_rows

    # dup-heavy band -> large G; sparse random -> G == 1
    nb = 512
    offs = np.arange(-20, 21)
    rr = np.repeat(np.arange(nb), offs.size)
    cc = rr + np.tile(offs, nb)
    keep = (cc >= 0) & (cc < nb)
    band = CSR.from_coo(rr[keep], cc[keep],
                        np.ones(int(keep.sum())), (nb, nb))
    assert choose_group_rows(band, band) == 8
    sparse = rand_csr(4096, 4096, 8192, seed=5)
    assert choose_group_rows(sparse, sparse) == 1


def test_scan_dd_f64_accuracy():
    """Double-double scan kernel: f64-accurate results from f32 hardware
    (exact on the reference's integer value model; ~1e-14 on wide
    positive magnitudes; cancellation bounded by term magnitude)."""
    from spgemm_tpu.ops.esc import build_esc_scan_plan, esc_scan_dd

    r = np.random.default_rng(21)
    n = 300
    a = CSR.from_coo(r.integers(0, n, 4000), r.integers(0, n, 4000),
                     r.integers(1, 10, 4000).astype(np.float64), (n, n))
    plan = build_esc_scan_plan(a, a)
    c = esc_scan_dd(plan, a.data, a.data)
    ref = golden.spgemm_scipy(a, a)
    got = golden.drop_explicit_zeros(c)
    assert got.pattern_equal(ref)
    assert np.array_equal(got.data, ref.data)  # integer sums: exact

    vals = np.abs(r.standard_normal(4000)) * np.exp(
        r.uniform(-15, 15, 4000)) + 0.1
    aw = CSR.from_coo(r.integers(0, n, 4000), r.integers(0, n, 4000),
                      vals, (n, n))
    pw = build_esc_scan_plan(aw, aw)
    cw = esc_scan_dd(pw, aw.data, aw.data)
    refw = golden.spgemm_scipy(aw, aw)
    gw = golden.drop_explicit_zeros(cw)
    assert gw.pattern_equal(refw)
    assert np.allclose(gw.data, refw.data, rtol=1e-12)

    an = CSR.from_coo(r.integers(0, n, 4000), r.integers(0, n, 4000),
                      r.standard_normal(4000), (n, n))
    pn = build_esc_scan_plan(an, an)
    cn = esc_scan_dd(pn, an.data, an.data)
    refn = golden.spgemm_scipy(an, an)
    gn = golden.drop_explicit_zeros(cn)
    assert gn.pattern_equal(refn)
    assert np.allclose(gn.data, refn.data, rtol=1e-10, atol=1e-11)


def test_digit_mode_f64():
    if not jax.config.jax_enable_x64:
        jax.config.update("jax_enable_x64", True)
    a = rand_csr(128, 128, 900, seed=22)
    c, _, plan = spgemm_esc(a, a, dtype=np.float64, mode="digit")
    ref = golden.spgemm_scipy(a, a)
    got = golden.drop_explicit_zeros(c)
    assert got.pattern_equal(ref)
    assert np.allclose(got.data, ref.data, rtol=1e-12)


def test_f64_csr_without_x64():
    """spgemm_csr f64 routes through the double-double scan — works
    without jax_enable_x64 (f32 device arithmetic)."""
    import jax.numpy as jnp

    from spgemm_tpu.ops.spgemm import spgemm_csr

    a = rand_csr(4096, 4096, 4096 * 4, seed=23)
    c, res = spgemm_csr(a, backend="esc", compute_dtype=jnp.float64)
    ref = golden.spgemm_scipy(a, a)
    got = golden.drop_explicit_zeros(c)
    assert got.pattern_equal(ref)
    assert np.allclose(got.data, ref.data, rtol=1e-10, atol=1e-11)


def test_meta16_matches_meta32():
    """The int16 meta plane (6 B/product scan stream) must decode to the
    same (idx, present, dist) fields and produce bit-identical kernel
    output as the int32 plane it compresses."""
    import spgemm_tpu.ops.esc as esc_mod
    from spgemm_tpu.ops.esc import (build_esc_scan_plan, esc_scan_reduce,
                                    esc_scan_trim, meta16_plane)

    a = rand_csr(180, 180, 2200, seed=44)
    plan = build_esc_scan_plan(a, a)
    m16 = meta16_plane(plan.meta)
    assert m16.dtype == np.int16 and np.all(m16 >= 0)
    # field-level round trip vs the documented int32 layout
    np.testing.assert_array_equal(m16 & 127, (plan.meta >> 7) & 127)
    np.testing.assert_array_equal((m16 >> 7) & 1, (plan.meta >> 14) & 1)
    np.testing.assert_array_equal(m16 >> 8, plan.meta >> 15)
    import jax.numpy as jnp
    out32 = esc_scan_reduce(jnp.asarray(plan.qv), jnp.asarray(plan.meta),
                            passes=plan.passes)
    out16 = esc_scan_reduce(jnp.asarray(plan.qv), jnp.asarray(m16),
                            passes=plan.passes)
    np.testing.assert_array_equal(np.asarray(out32), np.asarray(out16))
    ref = golden.spgemm_scipy(a, a)
    got = golden.drop_explicit_zeros(esc_scan_trim(plan, out16))
    assert got.pattern_equal(ref)
    assert np.allclose(got.data, ref.data, rtol=1e-4, atol=1e-6)


def test_device_combine_matches_host_trim():
    """The device-side window combine (class row-gathers + reshape-sums,
    tall-window tail finished on host) must reproduce the host reduceat
    trim, including plans with group_rows>1 and windows taller than
    COMBINE_K rows."""
    from spgemm_tpu.ops.esc import (COMBINE_K, build_esc_scan_plan,
                                    esc_scan_numeric,
                                    esc_scan_numeric_combined,
                                    esc_scan_trim, esc_scan_trim_combined)

    rng = np.random.default_rng(91)
    # dup-heavy: a dense-ish band gives windows tens of rows tall (and
    # with group_rows=1 some exceed COMBINE_K -> tail path)
    n = 512
    offs = np.arange(-40, 41)
    r = np.repeat(np.arange(n), offs.size)
    c = r + np.tile(offs, n)
    keep = (c >= 0) & (c < n)
    a = CSR.from_coo(r[keep], c[keep],
                     rng.standard_normal(int(keep.sum())), (n, n))
    for g in (1, 4):
        plan = build_esc_scan_plan(a, a, group_rows=g)
        wr = np.diff(plan.win_rowptr) // g
        if g == 1:
            assert (wr > COMBINE_K).any()  # the tail path is exercised
        c_host = esc_scan_trim(plan, esc_scan_numeric(plan))
        res, tail = esc_scan_numeric_combined(plan)
        c_dev = esc_scan_trim_combined(plan, res, tail)
        assert c_dev.pattern_equal(c_host)
        np.testing.assert_allclose(c_dev.data, c_host.data,
                                   rtol=1e-5, atol=1e-7)
        ref = golden.spgemm_scipy(a, a)
        got = golden.drop_explicit_zeros(c_dev)
        assert got.pattern_equal(ref)
        np.testing.assert_allclose(got.data, ref.data, rtol=1e-4,
                                   atol=1e-5)


def test_device_combine_unstructured_and_executor():
    from spgemm_tpu.ops.esc import spgemm_esc
    from spgemm_tpu.ops.executor import EscExecutor
    from spgemm_tpu.ops.esc import build_esc_scan_plan

    a = rand_csr(300, 300, 3600, seed=92)
    c, _, plan = spgemm_esc(a, a)  # combined path is the default
    ref = golden.spgemm_scipy(a, a)
    got = golden.drop_explicit_zeros(c)
    assert got.pattern_equal(ref)
    assert np.allclose(got.data, ref.data, rtol=1e-4, atol=1e-6)
    ex = EscExecutor(build_esc_scan_plan(a, a))
    got2 = golden.drop_explicit_zeros(ex.run_csr())
    assert got2.pattern_equal(ref)
    assert np.allclose(got2.data, ref.data, rtol=1e-4, atol=1e-6)


def test_device_combine_dd_exactness():
    """The compensated DD combine must preserve the double-double error
    bound: exact on the integer value model, through tall windows."""
    from spgemm_tpu.ops.esc import (COMBINE_K, build_esc_scan_plan,
                                    esc_scan_dd)

    n = 384
    offs = np.arange(-40, 41)
    r = np.repeat(np.arange(n), offs.size)
    cc = r + np.tile(offs, n)
    keep = (cc >= 0) & (cc < n)
    vals = ((r[keep] * 7 + cc[keep] * 13) % 9 + 1).astype(np.float64)
    a = CSR.from_coo(r[keep], cc[keep], vals, (n, n))
    plan = build_esc_scan_plan(a, a, keep_sources=True)
    assert (np.diff(plan.win_rowptr) > COMBINE_K).any()
    c = esc_scan_dd(plan, a.data, a.data)  # device combine on by default
    ref = golden.spgemm_scipy(a, a)
    got = golden.drop_explicit_zeros(c)
    assert got.pattern_equal(ref)
    np.testing.assert_array_equal(got.data, ref.data)  # EXACT


@pytest.mark.parametrize("group_rows", [1, 2, 8])
def test_jnp_scan_matches_numpy_plan(group_rows):
    """The plain-jnp scan (esc_scan_reduce) on a NumPy-built plan: the
    sibling-row sums of its (R/G, 128) output equal an independent f64
    reduction of the plan's product plane by destination slot."""
    import jax.numpy as jnp

    from spgemm_tpu.ops.esc import (SCAN_WIN, _esc_scan_symbolic_numpy,
                                    esc_scan_reduce)

    a = rand_csr(150, 150, 1800, seed=5 + group_rows)
    (c_indptr, _, total, qv, meta, win_rowptr, _, _,
     max_run) = _esc_scan_symbolic_numpy(a, a, group_rows=group_rows)
    passes = max(0, int(max_run - 1).bit_length())
    out = np.asarray(esc_scan_reduce(jnp.asarray(qv), jnp.asarray(meta),
                                     passes=passes, group_rows=group_rows),
                     np.float64)
    assert out.shape == (qv.shape[0] // group_rows, SCAN_WIN)
    nnz_c = int(c_indptr[-1])
    got = np.add.reduceat(out, win_rowptr[:-1] // group_rows,
                          axis=0).reshape(-1)[:nnz_c]
    # independent reference: every product lane adds into its slot
    slot = meta & 127
    win_of_row = np.repeat(np.arange(win_rowptr.size - 1),
                           np.diff(win_rowptr))
    dest = (win_of_row[:, None] * SCAN_WIN + slot[: win_of_row.size])
    ref = np.zeros(nnz_c + SCAN_WIN)
    np.add.at(ref, dest.reshape(-1),
              qv[: win_of_row.size].astype(np.float64).reshape(-1))
    np.testing.assert_allclose(got, ref[:nnz_c], rtol=1e-5, atol=1e-5)
    assert total > 0
