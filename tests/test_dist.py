"""Multi-chip SpGEMM tests on the 8-device virtual CPU mesh."""

import jax
import numpy as np
import pytest

from spgemm_tpu.models.tile import csr_to_tiles, tiles_to_csr
from spgemm_tpu.ops import golden
from spgemm_tpu.parallel.dist import (make_mesh, plan_row_partition, spgemm_sharded, spgemm_sharded_pairs)


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_matches_golden(make_random_csr, ndev):
    a = make_random_csr(200, 200, 0.03)
    at = csr_to_tiles(a, 16, 16)
    mesh = make_mesh(ndev)
    c = spgemm_sharded(at, at, mesh)
    ref = golden.spgemm_dense_row(a, a)
    got = tiles_to_csr(c)
    assert got.pattern_equal(ref)
    np.testing.assert_allclose(got.data, ref.data, rtol=1e-6)


def test_sharded_rectangular(make_random_csr):
    a = make_random_csr(150, 100, 0.04)
    b = make_random_csr(100, 120, 0.04)
    at = csr_to_tiles(a, 16, 16)
    bt = csr_to_tiles(b, 16, 16)
    c = spgemm_sharded(at, bt, make_mesh(8))
    ref = golden.spgemm_esc(a, b)
    got = tiles_to_csr(c)
    assert got.pattern_equal(ref)
    np.testing.assert_allclose(got.data, ref.data, rtol=1e-6)


def test_plan_load_balance(make_random_csr):
    a = make_random_csr(400, 400, 0.02)
    at = csr_to_tiles(a, 16, 16)
    plan = plan_row_partition(at, at, 8)
    # every real pair appears exactly once across devices
    total_real = sum(
        int((plan.seg[d] < plan.s_max).sum()) for d in range(8)
    )
    assert total_real == plan.schedule.num_pairs
    # segments partition the candidate C tiles
    assert plan.seg_counts.sum() == plan.schedule.nt_c


def test_sharded_empty(make_random_csr):
    from spgemm_tpu.models.csr import CSR

    a = CSR.from_coo([0], [0], [1.0], (64, 64))
    b = CSR.from_coo([63], [63], [1.0], (64, 64))
    at, bt = csr_to_tiles(a, 16, 16), csr_to_tiles(b, 16, 16)
    c = spgemm_sharded(at, bt, make_mesh(4))
    assert c.nnz == 0


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_pairs_matches_golden(make_random_csr, ndev):
    a = make_random_csr(200, 200, 0.03)
    at = csr_to_tiles(a, 16, 16)
    c = spgemm_sharded_pairs(at, at, make_mesh(ndev))
    ref = golden.spgemm_dense_row(a, a)
    got = tiles_to_csr(c)
    assert got.pattern_equal(ref)
    np.testing.assert_allclose(got.data, ref.data, rtol=1e-6)


def test_sharded_gustavson_wide_tiles(make_random_csr):
    a = make_random_csr(300, 300, 0.02)
    at = csr_to_tiles(a, 16, 128)
    bt = csr_to_tiles(a, 128, 128)
    c = spgemm_sharded(at, bt, make_mesh(8))
    ref = golden.spgemm_dense_row(a, a)
    got = tiles_to_csr(c)
    assert got.pattern_equal(ref)
    np.testing.assert_allclose(got.data, ref.data, rtol=1e-6)


def test_sharded_strip_matches_golden(make_random_csr):
    from spgemm_tpu.parallel.dist import make_mesh, spgemm_sharded_strip

    a = make_random_csr(96, 96, 0.07)
    at = csr_to_tiles(a, 8, 16)
    bt = csr_to_tiles(a, 16, 16)
    mesh = make_mesh(4)
    c = spgemm_sharded_strip(at, bt, mesh)
    ref = golden.spgemm_dense_row(a, a)
    got = tiles_to_csr(c)
    assert got.pattern_equal(ref)
    np.testing.assert_allclose(got.data, ref.data, rtol=1e-5)


def test_strip_partition_balances_pairs(make_random_csr):
    # skewed matrix: heavy band in the first rows
    import numpy as np
    from spgemm_tpu.models.csr import CSR

    n = 512
    rng = np.random.default_rng(3)
    r1 = rng.integers(0, n // 4, 4000)           # heavy top quarter
    r2 = rng.integers(n // 4, n, 1000)
    r = np.concatenate([r1, r2])
    c = rng.integers(0, n, r.size)
    a = CSR.from_coo(r, c, np.ones(r.size), (n, n))
    at = csr_to_tiles(a, 8, 16)
    bt = csr_to_tiles(a, 16, 16)
    ndev = 4
    plan = plan_row_partition(at, bt, ndev)
    # pairs per device: the real (non-padding) pairs of each shard
    per_dev = [int((plan.seg[d] < plan.s_max).sum()) for d in range(ndev)]
    total = sum(per_dev)
    assert total == plan.schedule.num_pairs
    # every shard's pairs stay grouped by segment, real pairs first
    for d in range(ndev):
        assert np.all(np.diff(plan.seg[d]) >= 0)
        assert np.all(plan.seg[d, : per_dev[d]] < plan.seg_counts[d])
    # no device should carry more than ~2x the fair share (tile-row
    # granularity limits precision on tiny inputs)
    assert max(per_dev) <= 2.2 * total / ndev


def test_sharded_ring_matches_golden(make_random_csr):
    from spgemm_tpu.parallel.dist import make_mesh, spgemm_sharded_ring

    a = make_random_csr(96, 96, 0.08)
    at = csr_to_tiles(a, 8, 16)
    bt = csr_to_tiles(a, 16, 16)
    c = spgemm_sharded_ring(at, bt, make_mesh(4))
    ref = golden.spgemm_dense_row(a, a)
    got = tiles_to_csr(c)
    assert got.pattern_equal(ref)
    np.testing.assert_allclose(got.data, ref.data, rtol=1e-5)


def test_sharded_ring_8dev(make_random_csr):
    from spgemm_tpu.parallel.dist import make_mesh, spgemm_sharded_ring

    a = make_random_csr(64, 80, 0.1)
    b = make_random_csr(80, 48, 0.1)
    at = csr_to_tiles(a, 8, 16)
    bt = csr_to_tiles(b, 16, 16)
    c = spgemm_sharded_ring(at, bt, make_mesh(8))
    ref = golden.spgemm_dense_row(a, b)
    got = tiles_to_csr(c)
    assert got.pattern_equal(ref)
    np.testing.assert_allclose(got.data, ref.data, rtol=1e-5)


def test_sharded_strip_windowed(make_random_csr):
    """The strip numeric phase under shard_map on a banded matrix,
    against scipy."""
    import numpy as np

    from spgemm_tpu.models.csr import CSR
    from spgemm_tpu.ops import golden
    from spgemm_tpu.parallel.dist import make_mesh, spgemm_sharded_strip

    n, band = 256, 6
    offs = np.arange(-band, band + 1)
    r = np.repeat(np.arange(n), offs.size)
    c = r + np.tile(offs, n)
    keep = (c >= 0) & (c < n)
    a = CSR.from_coo(r[keep], c[keep],
                     np.random.default_rng(5).standard_normal(int(keep.sum())),
                     (n, n))
    at = csr_to_tiles(a, 16, 32)
    bt = csr_to_tiles(a, 32, 32)
    ct = spgemm_sharded_strip(at, bt, make_mesh(4))
    ref = golden.spgemm_scipy(a, a)
    got = golden.drop_explicit_zeros(ct.to_csr())
    assert got.pattern_equal(ref)
    assert np.allclose(got.data, ref.data, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_esc_matches_golden(make_random_csr, ndev):
    """The unstructured ESC engine shards with zero collectives (row
    slabs own disjoint C windows)."""
    from spgemm_tpu.parallel.dist import make_mesh, spgemm_sharded_esc

    a = make_random_csr(300, 300, 0.03)
    c = spgemm_sharded_esc(a, a, make_mesh(ndev))
    ref = golden.spgemm_scipy(a, a)
    got = golden.drop_explicit_zeros(c)
    assert got.pattern_equal(ref)
    assert np.allclose(got.data, ref.data, rtol=1e-4, atol=1e-6)


def test_sharded_esc_rect_and_dup(make_random_csr):
    from spgemm_tpu.models.csr import CSR
    from spgemm_tpu.parallel.dist import make_mesh, spgemm_sharded_esc

    a = make_random_csr(100, 250, 0.05)
    b = make_random_csr(250, 80, 0.05)
    c = spgemm_sharded_esc(a, b, make_mesh(4))
    ref = golden.spgemm_scipy(a, b)
    got = golden.drop_explicit_zeros(c)
    assert got.pattern_equal(ref)
    assert np.allclose(got.data, ref.data, rtol=1e-4, atol=1e-6)
    # dup-heavy band (long runs, sibling rows) across 4 devices
    nb, offs = 192, np.arange(-20, 21)
    rr = np.repeat(np.arange(nb), offs.size)
    cc = rr + np.tile(offs, nb)
    keep = (cc >= 0) & (cc < nb)
    ab = CSR.from_coo(rr[keep], cc[keep],
                      np.random.default_rng(3).standard_normal(int(keep.sum())),
                      (nb, nb))
    c2 = spgemm_sharded_esc(ab, ab, make_mesh(4))
    ref2 = golden.spgemm_scipy(ab, ab)
    got2 = golden.drop_explicit_zeros(c2)
    assert got2.pattern_equal(ref2)
    assert np.allclose(got2.data, ref2.data, rtol=1e-3, atol=1e-5)


def test_place_strip_partition_lazy(make_random_csr):
    """Decentralized staging: shard-at-a-time device placement gives the
    same result as the stacked-host-array path, with a host peak far
    below it (no (D, ...) host stacks kept or built)."""
    import tracemalloc

    from spgemm_tpu.models.csr import CSR
    from spgemm_tpu.models.tile import csr_to_tiles
    from spgemm_tpu.ops import golden
    from spgemm_tpu.parallel.dist import (make_mesh, place_strip_partition,
                                          plan_row_partition,
                                          spgemm_sharded_pairs,
                                          spgemm_sharded_strip)

    nb = 512
    offs = np.arange(-24, 25)
    rr = np.repeat(np.arange(nb), offs.size)
    cc = rr + np.tile(offs, nb)
    keep = (cc >= 0) & (cc < nb)
    a = CSR.from_coo(rr[keep], cc[keep],
                     np.random.default_rng(3).integers(
                         1, 9, int(keep.sum())).astype(np.float64),
                     (nb, nb))
    at = csr_to_tiles(a, 16, 128)
    bt = csr_to_tiles(a, 128, 128)
    mesh = make_mesh(8)

    tracemalloc.start()
    arrays, plan = place_strip_partition(at, bt, mesh)
    _, lazy_peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert plan.a_val is None  # no stacked host copies retained

    tracemalloc.start()
    plan_row_partition(at, bt, 8)
    _, stack_peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    # the lazy path holds at most one padded shard at a time
    assert lazy_peak < 0.7 * stack_peak, (lazy_peak, stack_peak)

    for arr, d in zip(arrays[0].addressable_shards, mesh.devices.flat):
        assert arr.device == d and arr.data.shape[0] == 1
    ct = spgemm_sharded_strip(at, bt, mesh, placed=(arrays, plan))
    ref = golden.spgemm_scipy(a, a)
    got = golden.drop_explicit_zeros(ct.to_csr())
    assert got.pattern_equal(ref)
    np.testing.assert_allclose(got.data, ref.data, rtol=1e-5, atol=1e-7)
    stacked = golden.drop_explicit_zeros(
        spgemm_sharded_pairs(at, bt, mesh).to_csr())
    assert stacked.pattern_equal(got)
    np.testing.assert_array_equal(stacked.data, got.data)


def test_init_multihost_single_process():
    from spgemm_tpu.parallel.dist import init_multihost

    assert init_multihost() == 1  # no coordinator: single-process no-op


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_ozaki_exact_f64(make_random_csr, ndev):
    """Distributed Ozaki f64: integer value model must be BIT-exact
    across shards (per-shard local row scales, global column scales)."""
    import scipy.sparse as sp

    from spgemm_tpu.parallel.dist import spgemm_sharded_ozaki

    rng = np.random.default_rng(77)
    n = 300
    offs = np.arange(-4, 5)
    r = np.repeat(np.arange(n), offs.size)
    cc = r + np.tile(offs, n)
    keep = (cc >= 0) & (cc < n)
    r, cc = r[keep], cc[keep]
    from spgemm_tpu.models.csr import CSR

    a = CSR.from_coo(r, cc, rng.integers(1, 10, r.size).astype(np.float64),
                     (n, n))
    at = csr_to_tiles(a, 16, 128)
    bt = csr_to_tiles(a, 128, 128)
    c = spgemm_sharded_ozaki(at, bt, make_mesh(ndev))
    got = tiles_to_csr(c)
    A = sp.csr_matrix((a.data, a.indices, a.indptr), shape=(n, n))
    ref = (A @ A).tocsr()
    ref.sort_indices()
    got_t = golden.drop_explicit_zeros(got)
    assert got_t.nnz == ref.nnz
    np.testing.assert_array_equal(got_t.indices, ref.indices)
    np.testing.assert_array_equal(got_t.data, ref.data)


def test_sharded_ozaki_general_values(make_random_csr):
    """General f64 significands + wide exponents through the sharded
    path (slice-count unification across shards, zero-padded slices)."""
    import scipy.sparse as sp

    from spgemm_tpu.models.csr import CSR
    from spgemm_tpu.parallel.dist import spgemm_sharded_ozaki

    rng = np.random.default_rng(78)
    n = 260
    offs = np.arange(-3, 4)
    r = np.repeat(np.arange(n), offs.size)
    cc = r + np.tile(offs, n)
    keep = (cc >= 0) & (cc < n)
    r, cc = r[keep], cc[keep]
    # first rows integer-valued, later rows gaussian: per-shard Sa differs
    vals = rng.standard_normal(r.size)
    vals[r < n // 2] = rng.integers(1, 8, int((r < n // 2).sum()))
    a = CSR.from_coo(r, cc, vals, (n, n))
    at = csr_to_tiles(a, 16, 128)
    bt = csr_to_tiles(a, 128, 128)
    c = spgemm_sharded_ozaki(at, bt, make_mesh(4))
    got = tiles_to_csr(c)
    A = sp.csr_matrix((a.data, a.indices, a.indptr), shape=(n, n))
    ref = (A @ A).toarray()
    G = np.zeros((n, n))
    gd = golden.drop_explicit_zeros(got)
    G[np.repeat(np.arange(n), np.diff(gd.indptr)), gd.indices] = gd.data
    assert np.abs(G - ref).max() <= 1e-13 * np.abs(ref).max()
