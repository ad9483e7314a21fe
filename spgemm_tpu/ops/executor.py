"""Device-resident SpGEMM executors: build once, run many.

`spgemm()` is stateless — every call re-uploads operands, which is the
right shape for one-shot use but wasteful for serving loops (iterative
solvers, repeated C = A·B with changing values on a fixed sparsity
pattern). The executors keep the packed operands resident on the device
and re-dispatch only the numeric phase, the analogue of the reference's
REPEAT_NUM timing loop (`src/common.h:91`, `src/tilespgemm-cuda.h:2352`)
where the uploaded tiled matrices stay on the GPU across repeats.

`update_values` repacks and re-uploads only the value planes for
workloads where the pattern is fixed and values change (the reference's
step-4-only re-run, `tilespgemm-cuda.h:2649-2728`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from spgemm_tpu.models.tile import TileMat
from spgemm_tpu.ops.strip import StripPlan, build_strip_plan


class StripExecutor:
    """Resident-operand executor for the structured route: the pair
    schedule and packed tiles stay on the device; each run is one
    dispatch of the strip numeric phase (ops/strip.py)."""

    def __init__(self, a: TileMat, b: TileMat):
        # structural identity of A (exact: pattern arrays kept by ref)
        self.a_struct = (a.tm, a.tn, a.trow, a.tcol, a.tnnz_ptr, a.rc)
        self.shape = (a.m, b.n)
        self._setup(build_strip_plan(a, b))

    def _setup(self, plan: StripPlan) -> None:
        self.plan = plan
        self._dev = jax.device_put(plan.device_args())
        jax.block_until_ready(self._dev)

    @classmethod
    def from_plan(cls, plan: StripPlan,
                  shape: tuple[int, int]) -> "StripExecutor":
        """Wrap an existing StripPlan (e.g. SpGEMMResult.schedule of the
        strip backend) for a C of `shape` without rebuilding it.
        update_values is unavailable on instances built this way (the A
        pattern arrays are not retained)."""
        self = cls.__new__(cls)
        self.a_struct = None
        self.shape = shape
        self._setup(plan)
        return self

    @property
    def nt_c(self) -> int:
        return self.plan.nt_c

    def _numeric(self, dev):
        from spgemm_tpu.ops.strip import run_strip

        return run_strip(dev, self.plan.nt_c)

    def run(self) -> tuple[jax.Array, jax.Array]:
        """One numeric dispatch. Returns device (c_val, c_cnt), each
        (nt_c, tm, tn) in candidate order."""
        return self._numeric(self._dev)

    def run_compact(self) -> TileMat:
        """run() + packed-occupancy download + TileMat assembly."""
        from spgemm_tpu.ops.strip import download_tiles
        from spgemm_tpu.ops.spgemm import _compact_to_tilemat

        c_val, c_occ = download_tiles(*self.run())
        return _compact_to_tilemat(
            self.plan.ctrow, self.plan.ctcol, c_val.astype(np.float64),
            c_occ, self.shape, self.plan.a_val.shape[1],
            self.plan.b_val.shape[2],
        )

    def update_values(self, a: TileMat) -> None:
        """Re-upload A's value plane for a new matrix with the SAME
        sparsity structure (pattern-fixed iterative workloads)."""
        if self.a_struct is None:
            raise ValueError(
                "update_values is unavailable on executors built with "
                "from_plan (A pattern arrays were not retained)"
            )
        tm0, tn0, trow0, tcol0, tnnz0, rc0 = self.a_struct
        same = (
            a.tm == tm0 and a.tn == tn0
            and np.array_equal(a.trow, trow0)
            and np.array_equal(a.tcol, tcol0)
            and np.array_equal(a.tnnz_ptr, tnnz0)
            and np.array_equal(a.rc, rc0)
        )
        if not same:
            raise ValueError(
                "update_values requires the exact same tile structure "
                f"(got nt={a.nt} nnz={a.nnz}, built with nt={trow0.size} "
                f"nnz={rc0.size})"
            )
        a_val = a.dense(np.float32)
        self.plan.a_val = a_val
        dev = list(self._dev)
        dev[0] = jax.device_put(a_val)
        jax.block_until_ready(dev[0])
        self._dev = tuple(dev)

    def time_numeric(self, loop: int = 50, repeats: int = 3) -> float:
        """Amortized per-dispatch numeric time (ms): `loop` dispatches
        chained on the device through a data dependency, timed to
        block_until_ready (utils/timing.chained_device_ms)."""
        from spgemm_tpu.utils.timing import chained_device_ms

        @jax.jit
        def chain(av, *rest):
            def body(i, acc):
                cv, _ = self._numeric(
                    (av + acc.astype(av.dtype) * 1e-30,) + tuple(rest))
                return acc + jnp.sum(cv).astype(jnp.float32)
            return jax.lax.fori_loop(0, loop, body, jnp.float32(0))

        return chained_device_ms(chain, *self._dev, repeats=repeats,
                                 loop=loop)


class EscExecutor:
    """Resident-operand executor for the ESC scan backend (unstructured
    patterns) — the ESC half of the reference's build-once/run-many
    serving shape (`src/tilespgemm-cuda.h:2352` REPEAT_NUM loop with
    resident operands; step-4-only value re-run `:2649-2728`).

    The meta plane (run structure) and value plane(s) stay in HBM;
    `update_values` refreshes only the value plane via the native fused
    gather-multiply (stream bandwidth — milliseconds at n=65536) and
    re-uploads it, so a pattern-fixed rerun is one upload + one dispatch.

    mode="premul" (production): the device holds the host-premultiplied
    qv plane — 6 B/product HBM traffic (f32 value + int16 meta),
    product rounded once from f64.
    mode="mul": separate (av, bv) planes multiplied on the device — 10
    B/product, but the device performs the multiplies, giving a
    device-GFLOPS accounting comparable with the strip route's and the
    reference's numeric phases.
    """

    def __init__(self, plan, *, mode: str = "premul", device=None):
        from spgemm_tpu.ops.esc import ScanPlan

        if not isinstance(plan, ScanPlan):
            raise TypeError("EscExecutor wraps a ScanPlan (scan mode); "
                            "build with build_esc_scan_plan")
        if mode not in ("premul", "mul"):
            raise ValueError(f"mode must be 'premul' or 'mul': {mode!r}")
        self.plan = plan
        self.mode = mode
        self.device = device
        from spgemm_tpu.ops import esc as _esc
        mt = _esc.meta16_plane(plan.meta, cache_on=plan) if _esc.META16 \
            else plan.meta
        self._meta = self._put(jnp.asarray(mt))
        if mode == "premul":
            self._vals = (self._put(jnp.asarray(plan.qv)),)
        else:
            av, bv = self._gather_planes(None, None)
            self._vals = (self._put(jnp.asarray(av)),
                          self._put(jnp.asarray(bv)))
        jax.block_until_ready((self._meta,) + self._vals)

    def _put(self, arr):
        return jax.device_put(arr, self.device) if self.device is not None \
            else jax.device_put(arr)

    def _gather_planes(self, a_data, b_data):
        from spgemm_tpu.utils.native import esc_gather_planes_native

        plan = self.plan
        if a_data is None:
            # initial build without fresh input values: split the
            # premultiplied plane as (qv, ones) — identical products and
            # identical kernel traffic/compute shape (padding lanes have
            # qv == 0, so no mask is needed), and the device still
            # performs one multiply per product.
            return plan.qv, np.ones_like(plan.qv)
        res = esc_gather_planes_native(plan.a_src, plan.b_src,
                                       a_data, b_data)
        if res is not None:
            return res
        ok = plan.a_src >= 0
        av = np.where(ok, a_data[np.maximum(plan.a_src, 0)], 0.0)
        bv = np.where(ok, b_data[np.maximum(plan.b_src, 0)], 0.0)
        return av.astype(np.float32), bv.astype(np.float32)

    def run(self):
        """One numeric dispatch; returns the padded (R, 128) device
        output in window-major CSR slot order."""
        from spgemm_tpu.ops.esc import esc_scan_reduce, esc_scan_reduce_mul

        if self.mode == "premul":
            return esc_scan_reduce(self._vals[0], self._meta,
                                   passes=self.plan.passes,
                                   group_rows=self.plan.group_rows)
        return esc_scan_reduce_mul(self._vals[0], self._vals[1],
                                   self._meta, passes=self.plan.passes,
                                   group_rows=self.plan.group_rows)

    def run_csr(self):
        """run() + trim to the final CSR. With the device combine on
        (default), the sibling-row reduction happens on device and the
        download is ~4*nnzC bytes; SPGEMM_DEVICE_COMBINE=0 falls back to
        the host reduceat over the full product-row planes."""
        from spgemm_tpu.ops import esc as _esc

        if _esc.DEVICE_COMBINE:
            out = self.run()
            res, tail = _esc._combine_apply(self.plan, out)
            jax.block_until_ready(res)
            return _esc.esc_scan_trim_combined(self.plan, res, tail)
        out = self.run()
        jax.block_until_ready(out)
        return _esc.esc_scan_trim(self.plan, out)

    def update_values(self, a_data: np.ndarray, b_data: np.ndarray):
        """Pattern-fixed value refresh: native fused gather(+multiply)
        into the value plane(s), upload, done — no symbolic work."""
        plan = self.plan
        if plan.a_src is None:
            raise ValueError(
                "update_values needs a plan built with keep_sources=True")
        if a_data.size and int(plan.a_src.max()) >= a_data.size:
            raise ValueError("a_data is smaller than the plan's A pattern")
        if self.mode == "premul":
            # refresh into a FRESH buffer: mutating plan.qv in place
            # would silently change every other executor (or future
            # device_arrays upload) built from the same plan
            from spgemm_tpu.utils.native import esc_refresh_qv_native

            out = esc_refresh_qv_native(plan.a_src, plan.b_src,
                                        a_data, b_data)
            if out is None:
                ok = plan.a_src >= 0
                out = (np.where(ok, a_data[np.maximum(plan.a_src, 0)], 0.)
                       * np.where(ok, b_data[np.maximum(plan.b_src, 0)],
                                  0.)).astype(np.float32)
            self._vals = (self._put(jnp.asarray(out)),)
        else:
            av, bv = self._gather_planes(a_data, b_data)
            self._vals = (self._put(jnp.asarray(av)),
                          self._put(jnp.asarray(bv)))
        jax.block_until_ready(self._vals)

    def time_numeric(self, loop: int = 20, repeats: int = 2) -> float:
        """Amortized per-dispatch device time (ms), chained like
        StripExecutor.time_numeric."""
        from spgemm_tpu.ops.esc import esc_scan_reduce, esc_scan_reduce_mul
        from spgemm_tpu.utils.timing import chained_device_ms

        passes = self.plan.passes
        grows = self.plan.group_rows
        if self.mode == "premul":
            @jax.jit
            def chain(qv, meta):
                def body(i, acc):
                    out = esc_scan_reduce(qv + acc * 1e-30, meta,
                                          passes=passes, group_rows=grows)
                    return acc + jnp.sum(out)
                return jax.lax.fori_loop(0, loop, body, jnp.float32(0))
        else:
            @jax.jit
            def chain(av, bv, meta):
                def body(i, acc):
                    out = esc_scan_reduce_mul(av + acc * 1e-30, bv, meta,
                                              passes=passes,
                                              group_rows=grows)
                    return acc + jnp.sum(out)
                return jax.lax.fori_loop(0, loop, body, jnp.float32(0))

        return chained_device_ms(chain, *self._vals, self._meta,
                                 repeats=repeats, loop=loop)


class OzakiExecutor:
    """Resident-operand executor for the Ozaki-slice f64 engine
    (ops/ozaki.py) — the structured-f64 third of the build-once/run-many
    serving triad (reference REPEAT_NUM resident loop `common.h:91`;
    step-4-only value re-run `tilespgemm-cuda.h:2649-2728`).

    The int8 slice planes, int8 occupancy slabs and the seg map stay in
    HBM. `update_values(a, b)` re-slices new f64 values for the SAME
    tile pattern (the geometry/base plan and its C-tile dictionary are
    reused; only ops/ozaki.py:slice_and_pack reruns) and uploads the new
    slice planes — the adaptive slice counts may change with the values,
    in which case the jitted core recompiles for the new (Sa, Sb).
    """

    def __init__(self, plan, a: TileMat, b: TileMat, *, device=None):
        from spgemm_tpu.ops.ozaki import OzakiPlan

        if not isinstance(plan, OzakiPlan):
            raise TypeError("OzakiExecutor wraps an OzakiPlan "
                            "(build with build_ozaki_plan)")
        self.plan = plan
        self.device = device
        # pattern identity for update_values (exact arrays, like
        # StripExecutor.a_struct)
        self._struct = (a.tm, a.tn, a.trow.copy(), b.tcol.copy(),
                        a.tnnz_ptr.copy(), b.tnnz_ptr.copy())
        self._a, self._b = a, b
        self._put = (lambda x: jax.device_put(x, device)) if device \
            else jax.device_put
        self._dev = [self._put(x) for x in
                     (plan.a_sl, plan.b_sl, plan.a_occ, plan.b_occ,
                      jnp.asarray(plan.base.seg),
                      jnp.asarray(plan.perm), jnp.asarray(plan.bounds))]
        jax.block_until_ready(self._dev)

    def _kw(self):
        from spgemm_tpu.ops.ozaki import combine_mode

        base = self.plan.base
        return dict(gk=base.gk, max_a=base.max_a, max_b=base.max_b,
                    tm=base.tm, tn=base.tn, nt_c=base.nt_c,
                    sa=self.plan.sa, sb=self.plan.sb,
                    combine=combine_mode())

    def run(self, sync: bool = True):
        """One dispatch; returns device (c_h, c_m, c_l, c_cnt)."""
        from spgemm_tpu.ops.ozaki import _ozaki_jit

        out = _ozaki_jit(*self._dev, **self._kw())
        if sync:
            jax.block_until_ready(out)
        return out

    def assemble(self, out) -> np.ndarray:
        """Host epilogue: full-range f64 scaling (ozaki_assemble)."""
        from spgemm_tpu.ops.ozaki import ozaki_assemble

        return ozaki_assemble(self.plan, *out, (self._a.m, self._b.n))

    def update_values(self, a: TileMat, b: TileMat) -> None:
        """Pattern-fixed f64 value refresh: re-slice + upload only."""
        from spgemm_tpu.ops.ozaki import slice_and_pack

        tm0, tn0, trow0, tcol0, annz0, bnnz0 = self._struct
        if not (a.tm == tm0 and a.tn == tn0
                and np.array_equal(a.trow, trow0)
                and np.array_equal(b.tcol, tcol0)
                and np.array_equal(a.tnnz_ptr, annz0)
                and np.array_equal(b.tnnz_ptr, bnnz0)):
            raise ValueError(
                "update_values requires the exact same tile structure")
        a_sl, b_sl, ea, eb, sa, sb = slice_and_pack(a, b, self.plan.base)
        self.plan.a_sl, self.plan.b_sl = a_sl, b_sl
        self.plan.ea, self.plan.eb = ea, eb
        self.plan.sa, self.plan.sb = sa, sb
        self._a, self._b = a, b
        self._dev[0] = self._put(a_sl)
        self._dev[1] = self._put(b_sl)
        jax.block_until_ready((self._dev[0], self._dev[1]))

    def time_numeric(self, loop: int = 20, repeats: int = 2) -> float:
        """Amortized per-dispatch device time (ms), chained like
        StripExecutor.time_numeric."""
        from spgemm_tpu.ops.ozaki import ozaki_core
        from spgemm_tpu.utils.timing import chained_device_ms

        kw = self._kw()

        @jax.jit
        def chain(a_sl, b_sl, ao, bo, seg, perm, bounds):
            # all operands are integer: the loop-carried f32 acc casts
            # to an int8 zero added to the slice plane for the data
            # dependency (the usual acc*1e-30 float noise term would
            # not type-check)
            def body(i, acc):
                dep = (acc * jnp.float32(1e-30)).astype(jnp.int8)
                h, _m, _l, c = ozaki_core(a_sl + dep, b_sl, ao, bo,
                                          seg, perm, bounds, **kw)
                return (acc + jnp.sum(h)
                        + jnp.sum(c).astype(jnp.float32))
            return jax.lax.fori_loop(0, loop, body, jnp.float32(0))

        return chained_device_ms(chain, *self._dev,
                                 repeats=repeats, loop=loop)
