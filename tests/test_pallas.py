"""Strip route tests (ops/strip.py): packed tiles, the pair schedule,
the XLA pair products and the bit-packed occupancy download, against the
golden. tests/test_gpu.py checks the same phase on the card at cant
size."""

import numpy as np
import pytest

from spgemm_tpu.models.csr import CSR
from spgemm_tpu.models.tile import csr_to_tiles
from spgemm_tpu.ops import golden
from spgemm_tpu.ops.strip import build_strip_plan, strip_numeric
from spgemm_tpu.ops.spgemm import _compact_to_tilemat, spgemm, spgemm_csr


def _strip_product(a: CSR, b: CSR, tm: int, tn: int) -> CSR:
    at, bt = csr_to_tiles(a, tm, tn), csr_to_tiles(b, tn, tn)
    plan = build_strip_plan(at, bt)
    c_val, c_occ = strip_numeric(plan)
    return _compact_to_tilemat(plan.ctrow, plan.ctcol,
                               c_val.astype(np.float64), c_occ,
                               (a.m, b.n), tm, tn).to_csr()


@pytest.mark.parametrize("shape", ["square", "rect"])
@pytest.mark.parametrize("tm,tn", [(16, 16), (16, 128), (64, 128)])
def test_tile_pair_kernel_interpret(make_random_csr, tm, tn, shape):
    """The strip numeric phase against the golden: A² and a rectangular
    A·B, at the tile shapes the GPU route takes."""
    a = make_random_csr(150, 140 if shape == "rect" else 150, 0.05,
                        integer_vals=False)
    b = (make_random_csr(140, 170, 0.05, integer_vals=False)
         if shape == "rect" else a)
    got = _strip_product(a, b, tm, tn)
    ref = golden.spgemm_dense_row(a, b)
    assert got.pattern_equal(ref)
    np.testing.assert_allclose(got.data, ref.data, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("block", [1, 5])
def test_strip_numeric_c_tile_blocks(make_random_csr, monkeypatch, block):
    """C tiles processed in several equal blocks (the last one padded)
    give the same result as the golden."""
    from spgemm_tpu.ops import strip

    tm, tn = 16, 32
    monkeypatch.setattr(strip, "SLOT_BLOCK_BYTES",
                        block * ((tm * tn + tn * tn) * 6 + tm * tn * 16))
    assert strip.c_tile_block(tm, tn, tn) == block
    a = make_random_csr(120, 120, 0.05, integer_vals=False)
    plan = build_strip_plan(csr_to_tiles(a, tm, tn), csr_to_tiles(a, tn, tn))
    sa = plan.device_args()[4]
    assert sa.shape[0] * sa.shape[2] >= plan.nt_c and sa.shape[2] <= block
    got = _strip_product(a, a, tm, tn)
    ref = golden.spgemm_dense_row(a, a)
    assert got.pattern_equal(ref)
    np.testing.assert_allclose(got.data, ref.data, rtol=1e-5, atol=1e-6)


def test_tile_pair_kernel_empty_c_tile():
    """A candidate C tile whose pairs carry no structural product (A's
    nonzeros meet only empty B rows) comes out of compaction empty."""
    a = CSR.from_coo([0], [0], [1.0], (32, 32))
    b = CSR.from_coo([1], [1], [1.0], (32, 32))
    at, bt = csr_to_tiles(a, 16, 16), csr_to_tiles(b, 16, 16)
    plan = build_strip_plan(at, bt)
    assert plan.nt_c == 1
    c_val, c_occ = strip_numeric(plan)
    assert not c_occ.any() and not c_val.any()
    c = _compact_to_tilemat(plan.ctrow, plan.ctcol, c_val, c_occ,
                            (32, 32), 16, 16)
    assert c.nt == 0


def test_tile_pair_kernel_cancellation():
    """Values that cancel to zero keep their structural entry."""
    a = CSR.from_dense(np.array([[1.0, -1.0], [0.0, 2.0]]))
    b = CSR.from_dense(np.array([[1.0, 0.0], [1.0, 0.0]]))
    pad = lambda m: CSR(np.concatenate([m.indptr, np.full(30, m.nnz)]),
                        m.indices, m.data, (32, 32))
    got = _strip_product(pad(a), pad(b), 16, 16)
    ref = golden.spgemm_dense_row(pad(a), pad(b))
    assert got.pattern_equal(ref)
    assert got.nnz == 2 and got.data[0] == 0.0
    np.testing.assert_allclose(got.data, ref.data)


def test_strip_backend_matches_oracle(make_random_csr):
    a = make_random_csr(150, 150, 0.04)
    c_s, res = spgemm_csr(a, backend="strip")
    ref = golden.spgemm_dense_row(a, a)
    assert c_s.pattern_equal(ref)
    np.testing.assert_allclose(c_s.data, ref.data, rtol=1e-6)


def test_strip_backend_rectangular(make_random_csr):
    a = make_random_csr(100, 70, 0.06)
    b = make_random_csr(70, 120, 0.06)
    c_s, _ = spgemm_csr(a, b, backend="strip", tm=16, tn=16)
    ref = golden.spgemm_dense_row(a, b)
    assert c_s.pattern_equal(ref)
    np.testing.assert_allclose(c_s.data, ref.data, rtol=1e-6)


def test_strip_backend_cancellation():
    a = CSR.from_dense(np.array([[1.0, -1.0], [0.0, 2.0]]))
    b = CSR.from_dense(np.array([[1.0, 0.0], [1.0, 0.0]]))
    at, bt = csr_to_tiles(a, 2, 2), csr_to_tiles(b, 2, 2)
    res = spgemm(at, bt, backend="strip")
    ref = golden.spgemm_dense_row(a, b)
    got = res.c.to_csr()
    assert got.pattern_equal(ref)
    np.testing.assert_allclose(got.data, ref.data)


def test_strip_multiblock_interpret(make_random_csr):
    """Many C tiles with several pairs each: every pair lands in its own
    C tile."""
    a = make_random_csr(96, 96, 0.08)
    got = _strip_product(a, a, 16, 16)
    ref = golden.spgemm_dense_row(a, a)
    assert got.pattern_equal(ref)
    np.testing.assert_allclose(got.data, ref.data, rtol=1e-5)


def test_native_tile_packer_matches_numpy(make_random_csr):
    from spgemm_tpu.utils.native import pack_tiles_native

    a = make_random_csr(128, 128, 0.06)
    at = csr_to_tiles(a, 16, 32)
    nat = pack_tiles_native(at)
    if nat is None:
        pytest.skip("native library unavailable")
    np.testing.assert_array_equal(nat[0], at.dense(np.float32))
    np.testing.assert_array_equal(np.asarray(nat[1], np.float32),
                                  at.occ().astype(np.float32))


def test_strip_banded_interpret():
    """A banded matrix (the structured route's own regime) through the
    strip numeric phase against the golden."""
    n = 96
    offs = np.arange(-3, 4)
    r = np.repeat(np.arange(n), offs.size)
    c = r + np.tile(offs, n)
    keep = (c >= 0) & (c < n)
    a = CSR.from_coo(r[keep], c[keep],
                     (r[keep] % 7 + 1).astype(np.float64), (n, n))
    got = _strip_product(a, a, 16, 32)
    ref = golden.spgemm_dense_row(a, a)
    assert got.pattern_equal(ref)
    np.testing.assert_allclose(got.data, ref.data, rtol=1e-5)
