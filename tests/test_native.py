"""Native C++ converter vs NumPy reference implementation."""

import numpy as np
import pytest

from spgemm_tpu.models.tile import csr_to_tiles, tiles_to_csr
from spgemm_tpu.utils.native import get_lib


needs_native = pytest.mark.skipif(
    get_lib() is None, reason="native library unavailable"
)


@needs_native
@pytest.mark.parametrize("tm,tn", [(16, 16), (16, 128), (8, 32), (5, 7)])
def test_native_matches_numpy(make_random_csr, tm, tn):
    a = make_random_csr(300, 250, 0.03, integer_vals=False)
    tn_ = csr_to_tiles(a, tm, tn, use_native=True)
    tp = csr_to_tiles(a, tm, tn, use_native=False)
    for field in ["trow", "tcol", "tptr", "tnnz_ptr", "rc", "mask", "rowptr"]:
        np.testing.assert_array_equal(
            getattr(tn_, field), getattr(tp, field), err_msg=field
        )
    np.testing.assert_array_equal(tn_.val, tp.val)


@needs_native
def test_native_roundtrip(make_random_csr):
    a = make_random_csr(200, 170, 0.05, integer_vals=False)
    t = csr_to_tiles(a, 16, 16, use_native=True)
    back = tiles_to_csr(t, use_native=True)
    assert a.allclose(back)
    back_np = tiles_to_csr(t, use_native=False)
    assert back.pattern_equal(back_np)
    np.testing.assert_array_equal(back.data, back_np.data)


@needs_native
def test_native_empty():
    from spgemm_tpu.models.csr import CSR

    a = CSR.from_coo(np.zeros(0), np.zeros(0), np.zeros(0), (64, 64))
    t = csr_to_tiles(a, 16, 16, use_native=True)
    assert t.nt == 0
    assert tiles_to_csr(t, use_native=True).nnz == 0


@needs_native
def test_native_f32_values(make_random_csr):
    a = make_random_csr(100, 100, 0.05)
    a = a.with_data(a.data.astype(np.float32))
    t = csr_to_tiles(a, 16, 16, use_native=True)
    assert t.val.dtype == np.float32


def test_pool_prewarm_part_cap_covers_requests():
    """pool_prewarm(part_cap=...) must create buffers whose CAPACITY
    covers later larger-than-faulted requests — the round-3 fix for the
    first plan build allocating fresh unfaulted buffers when the 2 GB
    parts missed ~2.1 GB plane requests."""
    from spgemm_tpu.utils import native as nv

    nv.pool_prewarm(1 << 22, parts=2, part_cap=(1 << 24) + 1)
    if nv._arena_attach() is not False:
        # arena path: prewarm populates pages; any later request carves
        # from the (warm) arena, so the part_cap capacity contract is
        # moot — just check a part_cap-sized request is served
        arr = nv.pool_array(((1 << 24),), np.uint8)
        del arr
        return
    # anon-fallback path: after prewarm, enough buffers with capacity
    # >= part_cap exist (created fresh or reused from the pool — both
    # satisfy the contract) that a request bigger than the faulted
    # prefix but below capacity REUSES one instead of allocating fresh
    assert sum(b.nbytes >= (1 << 24) + 1 for b in nv._POOL) >= 2
    n_pool = len(nv._POOL)
    arr = nv.pool_array(((1 << 24),), np.uint8)
    assert len(nv._POOL) == n_pool
    del arr


def test_esc_plan_request_bytes_covers_build():
    """The computed largest-request bound must be >= every plane request
    the native build actually makes (r_ub * 512 dominates)."""
    from spgemm_tpu.models.csr import CSR
    from spgemm_tpu.utils.native import esc_plan_request_bytes

    rng = np.random.default_rng(4)
    n = 500
    a = CSR.from_coo(rng.integers(0, n, 5000), rng.integers(0, n, 5000),
                     rng.standard_normal(5000), (n, n))
    bound = esc_plan_request_bytes(a, a)
    blen = np.diff(a.indptr)
    flops = int(blen[a.indices].sum())
    assert bound >= (flops // 128) * 128 * 4  # at least the plane size


def test_arena_needs_free_tmpfs_space(monkeypatch, tmp_path):
    """The arena is off unless SPGEMM_POOL_FILE names it, and a file
    system smaller than the arena cap must not be used: touching a page
    past its size would kill the process with SIGBUS."""
    from spgemm_tpu.utils import native

    monkeypatch.setattr(native, "_ARENA_PATH", "")
    assert not native._arena_fits()
    monkeypatch.setattr(native, "_ARENA_PATH", str(tmp_path / "arena"))
    monkeypatch.setattr(native, "_ARENA_MAX", 1 << 62)
    assert not native._arena_fits()
    monkeypatch.setattr(native, "_ARENA_MAX", 1 << 20)
    assert native._arena_fits()
