"""Ozaki-slice f64 engine (ops/ozaki.py): exactness, adaptivity,
routing, and fallbacks. The reference computes all of SpGEMM in double
(src/common.h:22); this engine is the structured-path
answer on f32/int8 hardware."""

import numpy as np
import pytest
import scipy.sparse as sp

from spgemm_tpu.models.csr import CSR
from spgemm_tpu.models.tile import csr_to_tiles
from spgemm_tpu.ops import ozaki
from spgemm_tpu.ops.ozaki import (OzakiOverflow, build_ozaki_plan,
                                  ozaki_assemble, ozaki_numeric,
                                  spgemm_ozaki)
from spgemm_tpu.ops.spgemm import spgemm, spgemm_csr


def _banded(n, half, vals, rng):
    offs = np.arange(-half, half + 1)
    r = np.repeat(np.arange(n), offs.size)
    c = r + np.tile(offs, n)
    keep = (c >= 0) & (c < n)
    r, c = r[keep], c[keep]
    return CSR.from_coo(r, c, vals(r.size, rng), (n, n))


def _scipy(a):
    return sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape)


def _check(a, b=None, aat=False, rtol=0.0, expect="ozaki"):
    cc, res = spgemm_csr(a, b, aat=aat, compute_dtype=np.float64)
    assert expect in str(res.stats["backend"]), res.stats["backend"]
    A = _scipy(a)
    B = A.T if aat else (_scipy(b) if b is not None else A)
    ref = (A @ B).tocsr()
    ref.sort_indices()
    got = sp.csr_matrix((cc.data, cc.indices, cc.indptr), shape=ref.shape)
    got.sort_indices()
    # pattern may contain extra explicit (structural) zeros; values of
    # shared entries must match
    diff = np.abs((got - ref).toarray())
    if rtol == 0.0:
        assert diff.max() == 0.0
    else:
        assert diff.max() <= rtol * max(np.abs(ref.toarray()).max(), 1e-300)
    return res


def test_integer_model_bit_exact():
    """The reference's synthetic value model (main.cu:111-112 style small
    integers) satisfies the f32-exactness bound, so f64 auto routes to
    the FULL-SPEED f32 pipeline and must still reproduce scipy's f64
    bit-for-bit. The explicit ozaki backend slices it to S=1."""
    rng = np.random.default_rng(0)
    a = _banded(700, 6, lambda k, r: r.integers(1, 10, k).astype(np.float64),
                rng)
    _check(a, expect="f64-exact-int")
    at = csr_to_tiles(a, 16, 128)
    bt = csr_to_tiles(a, 128, 128)
    res = spgemm(at, bt, backend="ozaki")
    assert res.schedule.sa == 1 and res.schedule.sb == 1
    ref = (_scipy(a) @ _scipy(a)).tocsr()
    ref.sort_indices()
    got = res.c.to_csr()
    got_t = sp.csr_matrix((got.data, got.indices, got.indptr),
                          shape=ref.shape)
    assert np.abs((got_t - ref).toarray()).max() == 0.0


def test_wide_integers_exact_values():
    """31-bit integers: products exceed f64's 53-bit significand, so the
    scipy oracle itself rounds — compare at f64 eps scale."""
    rng = np.random.default_rng(1)
    a = _banded(500, 4,
                lambda k, r: r.integers(-2**30, 2**30, k).astype(np.float64),
                rng)
    res = _check(a, rtol=1e-14)
    assert res.schedule.sa == 5  # ceil(31 / 7)


def test_general_f64():
    rng = np.random.default_rng(2)
    a = _banded(600, 5, lambda k, r: r.standard_normal(k), rng)
    res = _check(a, rtol=1e-13)
    assert res.schedule.sa == ozaki.MAX_SLICES


def test_wild_exponents():
    """Per-row/column power-of-two scales must carry the full f64
    exponent range (the device only ever sees int8 slices and int32
    sums; scaling happens on the host in f64)."""
    rng = np.random.default_rng(3)

    def vals(k, r):
        return r.standard_normal(k) * np.exp2(
            r.integers(-300, 300, k).astype(np.float64))

    a = _banded(400, 3, vals, rng)
    _check(a, rtol=1e-13)


def test_aat_and_rectangular():
    rng = np.random.default_rng(4)
    a = _banded(500, 4, lambda k, r: r.standard_normal(k), rng)
    _check(a, aat=True, rtol=1e-13)
    # rectangular A @ B through the TileMat API
    m, k, n = 330, 500, 270
    ra = rng.integers(0, m, 3000)
    ca = rng.integers(0, k, 3000)
    am = CSR.from_coo(ra, ca, rng.standard_normal(3000), (m, k))
    rb = rng.integers(0, k, 3000)
    cb = rng.integers(0, n, 3000)
    bm = CSR.from_coo(rb, cb, rng.standard_normal(3000), (k, n))
    at = csr_to_tiles(am, 16, 128)
    bt = csr_to_tiles(bm, 128, 128)
    res = spgemm(at, bt, backend="ozaki")
    ref = (_scipy(am) @ _scipy(bm)).toarray()
    got = res.c.to_csr()
    G = sp.csr_matrix((got.data, got.indices, got.indptr),
                      shape=(m, n)).toarray()
    assert np.abs(G - ref).max() <= 1e-13 * np.abs(ref).max()


def test_structural_zeros_kept():
    """Cancellation must leave an explicit zero (cuSPARSE semantics,
    matching every other backend)."""
    # A = [[1, 1], [0, 0]], B = [[1], [-1]] -> C[0,0] = 0 but structural
    a = CSR.from_coo(np.array([0, 0]), np.array([0, 1]),
                     np.array([1.0, 1.0]), (2, 2))
    b = CSR.from_coo(np.array([0, 1]), np.array([0, 0]),
                     np.array([1.0, -1.0]), (2, 1))
    at = csr_to_tiles(a, 16, 128)
    bt = csr_to_tiles(b, 128, 128)
    res = spgemm(at, bt, backend="ozaki")
    c = res.c.to_csr()
    assert c.nnz == 1 and c.data[0] == 0.0


def test_plan_arrays_and_assemble_roundtrip():
    """Slices must reconstruct the operands exactly: sum_s q_s * 2^(E-7(s+1))
    == value, per element."""
    rng = np.random.default_rng(5)
    a = _banded(300, 3, lambda k, r: r.standard_normal(k), rng)
    at = csr_to_tiles(a, 16, 128)
    plan = build_ozaki_plan(at, at if at.tm == at.tn
                            else csr_to_tiles(a, 128, 128))
    # reconstruct the A slabs from slices and compare against a f64 pack
    sa = plan.sa
    rec = np.zeros(plan.a_sl.shape[1:], np.float64)
    for s in range(sa):
        rec += plan.a_sl[s].astype(np.float64) * 2.0 ** (-7 * s)
    # rec is value * 2^(7 - Ea_r) per row; spot-check one dense row
    # against the tile values via the exactness of the full multiply
    # (covered above) — here just confirm slices are within int8 range
    assert plan.a_sl.dtype == np.int8 and plan.b_sl.dtype == np.int8
    assert np.abs(plan.a_sl.astype(np.int32)).max() <= 127


def test_overflow_falls_back_to_dd(monkeypatch):
    """When the int32 bound fails, the auto route must land on the
    double-double scan engine, not crash."""
    monkeypatch.setattr(ozaki, "_INT32_HEADROOM", 2 ** 40)
    rng = np.random.default_rng(6)
    # +0.5 so the data dodges the f32-exact-integer fast route and the
    # auto router reaches the (here, forced-failing) ozaki branch
    a = _banded(400, 3,
                lambda k, r: r.integers(1, 10, k).astype(np.float64) + 0.5,
                rng)
    with pytest.raises(OzakiOverflow):
        build_ozaki_plan(csr_to_tiles(a, 16, 128), csr_to_tiles(a, 128, 128))
    cc, res = spgemm_csr(a, None, compute_dtype=np.float64)
    assert res.stats["backend"] == "esc"
    ref = (_scipy(a) @ _scipy(a)).tocsr()
    ref.sort_indices()
    got = sp.csr_matrix((cc.data, cc.indices, cc.indptr), shape=ref.shape)
    diff = np.abs((got - ref).toarray()).max()
    assert diff <= 1e-12 * np.abs(ref.toarray()).max()


def test_53bit_results_exact():
    """The device triple-float combine must carry full f64 significands:
    a 53-bit result (1e30) reconstructs bit-exactly — a double-float
    (2x f32) output held only ~48 bits and rounded it."""
    rng = np.random.default_rng(9)
    n = 200
    rr = np.zeros(100, np.int64)
    cc = np.arange(100)
    vv = np.concatenate([[1e30], rng.standard_normal(99)])
    a = CSR.from_coo(rr, cc, vv, (n, n))
    b = CSR.from_coo(cc, cc, np.ones(100), (n, n))
    res = spgemm_ozaki(csr_to_tiles(a, 16, 128), csr_to_tiles(b, 128, 128))
    g = res.c.to_csr()
    assert g.data[0] == 1e30


def test_empty_and_zero_rows():
    a = CSR.from_coo(np.array([0]), np.array([0]), np.array([3.0]),
                     (200, 200))
    at = csr_to_tiles(a, 16, 128)
    bt = csr_to_tiles(a, 128, 128)
    res = spgemm_ozaki(at, bt)
    c = res.c.to_csr()
    assert c.nnz == 1 and c.data[0] == 9.0


def test_wide_span_auto_routes_to_dd():
    """Per-row significand span beyond the 56-bit slice window: strict
    plan build raises and the auto route falls back to the
    double-double scan (per-product accuracy beats the blocked bound
    there); explicit backend='ozaki' still runs with the documented
    blocked-accuracy truncation."""
    rng = np.random.default_rng(12)
    n = 300

    # 1e+15/1e-15 mix: >120-bit per-row span, but products stay inside
    # f32's exponent range so the DD scan is viable (1e+-30 mixes would
    # overflow the DD hi/lo planes and must STAY on ozaki's scaled path)
    def vals(k, r):
        return r.standard_normal(k) * np.where(
            r.random(k) < 0.5, 1e15, 1e-15)

    a = _banded(n, 3, vals, rng)
    with pytest.raises(OzakiOverflow):
        build_ozaki_plan(csr_to_tiles(a, 16, 128),
                         csr_to_tiles(a, 128, 128), strict=True)
    cc, res = spgemm_csr(a, None, compute_dtype=np.float64)
    assert res.stats["backend"] == "esc"
    # explicit engine still runs (non-strict)
    res2 = spgemm(csr_to_tiles(a, 16, 128), csr_to_tiles(a, 128, 128),
                  backend="ozaki")
    assert str(res2.stats["backend"]).startswith("ozaki")


def test_combine_modes_bit_identical(monkeypatch):
    """The scatter and the scatter-free permute+cumsum combines must
    produce BIT-identical (h, m, l, cnt) — the wrapping-int32 boundary
    differences are exact whenever the per-segment bound holds."""
    from spgemm_tpu.ops.ozaki import ozaki_numeric

    rng = np.random.default_rng(31)
    n = 350
    r = rng.integers(0, n, 4000)
    c = rng.integers(0, n, 4000)
    a = CSR.from_coo(r, c, rng.standard_normal(4000), (n, n))
    plan = build_ozaki_plan(csr_to_tiles(a, 16, 128),
                            csr_to_tiles(a, 128, 128))
    outs = {}
    for mode in ("scatter", "cumsum"):
        monkeypatch.setenv("SPGEMM_OZAKI_COMBINE", mode)
        out, _ = ozaki_numeric(plan)
        outs[mode] = tuple(np.asarray(x) for x in out)
    assert all(np.array_equal(outs["scatter"][i], outs["cumsum"][i])
               for i in range(4))


def test_f64_route_escape_hatch(monkeypatch):
    """SPGEMM_F64_ROUTE=dd pins the f64 auto route to the double-double
    scan (hardware-triage knob)."""
    monkeypatch.setenv("SPGEMM_F64_ROUTE", "dd")
    rng = np.random.default_rng(17)
    a = _banded(300, 3, lambda k, r: r.standard_normal(k), rng)
    cc, res = spgemm_csr(a, None, compute_dtype=np.float64)
    assert res.stats["backend"] == "esc"
