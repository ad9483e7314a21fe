"""Card tests: the structured route's numeric phase compiled for the card
at the smoke run's size and compared once with an f64 reference — the
precision XLA picks for f32 products is the card's own. They skip on the
CPU (the `gpu` fixture decides); chip_smoke.py runs them on the card
with `pytest -m gpu`."""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _cant_tiles(tm, tn, gaussian):
    from spgemm_tpu.models.csr import CSR
    from spgemm_tpu.models.tile import csr_to_tiles
    from spgemm_tpu.utils.generators import cantlike

    a = cantlike()
    if gaussian:
        a = CSR(a.indptr, a.indices,
                np.random.default_rng(1).standard_normal(a.nnz), a.shape)
    return a, csr_to_tiles(a, tm, tn), csr_to_tiles(a, tn, tn)


@pytest.mark.parametrize("tm", [16, 64])
def test_strip_numeric_on_card(gpu, tm):
    """The strip numeric phase compiled for the card at cant size, on
    Gaussian values, against f64 products of sampled C tiles: IEEE f32
    precision (a TF32 product keeps ~1e-3), and the structural counts
    against the host pattern."""
    import jax

    from spgemm_tpu.ops.strip import build_strip_plan, run_strip

    _, at, bt = _cant_tiles(tm, 128, gaussian=True)
    plan = build_strip_plan(at, bt)
    dev = jax.device_put(plan.device_args(), gpu)
    c_val, c_cnt = jax.block_until_ready(run_strip(dev, plan.nt_c))
    cv = np.asarray(c_val, np.float64)
    occ = np.asarray(c_cnt) > 0
    s = plan.sched
    ad, bd = at.dense(np.float64), bt.dense(np.float64)
    ao, bo = at.occ().astype(np.float64), bt.occ().astype(np.float64)
    for c in range(0, s.nt_c, max(1, s.nt_c // 64)):
        pairs = range(s.pair_ptr[c], s.pair_ptr[c + 1])
        ref = sum(ad[s.pa[p]] @ bd[s.pb[p]] for p in pairs)
        ref_occ = sum(ao[s.pa[p]] @ bo[s.pb[p]] for p in pairs) > 0
        np.testing.assert_array_equal(occ[c], ref_occ)
        tol = 1e-5 * max(np.abs(ref).max(), 1e-30)
        assert np.abs(cv[c] - ref).max() <= tol, c
