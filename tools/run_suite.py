#!/usr/bin/env python
"""Benchmark suite runner — the analogue of the reference's
`data/run18.sh` / `data/run142.sh` loops (SuiteSparse is unreachable in
this zero-egress environment, so the suite is a family of deterministic
synthetic matrices spanning the same structural regimes: banded FEM-like,
block-diagonal, random uniform, power-law rows).

For each (matrix, config) it runs C=A^2, C=AA^T, and SpMM k=128 through
the library API and appends the four CSV sinks plus a suite summary.

Usage:
  python tools/run_suite.py [--outdir data_out] [--quick] [--mtx FILE ...]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def suite(quick: bool, n: int | None = None):
    from spgemm_tpu.utils.generators import (banded, block_diag, power_law,
                                             random_uniform, rmat)

    rng = np.random.default_rng(7)
    n = n or (8192 if quick else 65536)
    return {
        f"banded{n}": banded(rng, n, 64),
        f"blockdiag{n}": block_diag(rng, n),
        f"random{n}": random_uniform(rng, n),
        f"powerlaw{n}": power_law(rng, n),
        f"rmat{n}": rmat(rng, n),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="data_out")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--mtx", nargs="*", default=[],
                    help="additional Matrix Market files")
    ap.add_argument("--n", type=int, default=None, help="matrix dimension")
    ap.add_argument("--only", default=None, help="substring filter on names")
    ap.add_argument("--tm", type=int, default=16)
    ap.add_argument("--tn", type=int, default=128)
    ap.add_argument("--backend", default="auto",
                    help="spgemm_csr backend (auto: the router decides "
                         "per platform and pattern)")
    ap.add_argument("--dtype", default="f32", choices=["f32", "f64"],
                    help="f64 runs the f64 auto route (native x64 on a "
                         "GPU, the Ozaki engine elsewhere; unstructured "
                         "patterns take the double-double scan)")
    ap.add_argument("--configs", default="A2,AAT,SpMM128",
                    help="comma-set of A2,AAT,SpMM128 to run (e.g. a "
                         "single huge A2 row to exercise the sampled "
                         "oracle without paying its AAT/SpMM twins)")
    ap.add_argument("--resume", action="store_true",
                    help="skip (matrix, config) rows already in the summary")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save/load converted tile formats as .npz")
    ap.add_argument("--no-prewarm", action="store_true",
                    help="skip the startup memory-arena prewarm")
    args = ap.parse_args(argv)

    import jax

    from spgemm_tpu.utils.platform import enable_compile_cache

    enable_compile_cache()

    from spgemm_tpu.io.mmio import read_mtx
    from spgemm_tpu.models.csr import flop_count_spgemm
    from spgemm_tpu.models.tile import csr_to_tiles
    from spgemm_tpu.ops import golden
    from spgemm_tpu.ops.spgemm import spgemm_csr
    from spgemm_tpu.ops.spmm import spmm
    from spgemm_tpu.utils import csv_sink

    mats = suite(args.quick, args.n)
    if args.only:
        mats = {k: v for k, v in mats.items() if args.only in k}
    for path in args.mtx:
        name = os.path.basename(path).removesuffix(".mtx")
        mats[name], _ = read_mtx(path)

    if not args.no_prewarm:
        # Startup arena provisioning: hosts that back fresh memory
        # slowly would otherwise pay one-time page-fault cost inside the
        # first large plan build's timed region. Sized from the largest
        # flop count in the suite (12 B/product build footprint, capped
        # at 12 GB); use --no-prewarm to include provisioning in the
        # first row.
        from spgemm_tpu.utils.native import (esc_plan_request_bytes,
                                             pool_prewarm)

        worst = max((flop_count_spgemm(m_, m_) for m_ in mats.values()),
                    default=0)
        need = min(int(worst) * 12 + (1 << 30), 12 << 30)
        # part CAPACITY must cover the largest single plan-array request
        # or the first build allocates fresh unfaulted buffers (round-2
        # prewarm missed the ~2.1 GB cant plane requests with 2 GB
        # parts); 6 parts = 4 planes + c_indices + headroom
        cap = max((esc_plan_request_bytes(m_, m_) for m_ in mats.values()),
                  default=0)
        t0 = time.perf_counter()
        pool_prewarm(need, parts=6, part_cap=cap)
        print(f"arena prewarm: {need / 1e9:.1f} GB in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    os.makedirs(args.outdir, exist_ok=True)
    summary = os.path.join(args.outdir, "suite_summary.csv")

    done: set[tuple[str, str]] = set()
    if args.resume and os.path.exists(summary):
        import csv as _csv

        with open(summary) as f:
            reader = _csv.DictReader(f)
            header = reader.fieldnames or []
            for row in reader:
                done.add((row["matrix"], row["config"]))
        print(f"resume: {len(done)} completed rows in {summary}")
        if ("device_ms" not in header or "backend" not in header
                or "plan_ms" not in header):
            # pre-device-timing format: rotate so new rows get a fresh
            # header instead of silently misaligning columns; clear `done`
            # so the rotated rows are re-measured into the active file
            # (otherwise they would be permanently absent from it)
            legacy = summary + ".legacy"
            os.replace(summary, legacy)
            done.clear()
            print(f"resume: rotated old-format summary to {legacy}; "
                  "its rows will be re-measured")

    for name, a in mats.items():
        print(f"=== {name}: m={a.m} nnz={a.nnz}", flush=True)
        want = {c.strip() for c in args.configs.split(",") if c.strip()}
        for cfg, aat in [("A2", False), ("AAT", True)]:
            if cfg not in want:
                continue
            if (name, cfg) in done:
                print(f"  {cfg}: skipped (resume)", flush=True)
                continue
            nnz_cub = flop_count_spgemm(
                a, a.transpose() if aat else a
            )
            kw_dt = ({"compute_dtype": np.float64}
                     if args.dtype == "f64" else {})
            # warm-up dispatch populates the jit cache (first-call numbers
            # measure compilation, not the kernel)
            spgemm_csr(a, aat=aat, tm=args.tm, tn=args.tn,
                       backend=args.backend, **kw_dt)
            t0 = time.perf_counter()
            c, res = spgemm_csr(a, aat=aat, tm=args.tm, tn=args.tn,
                                backend=args.backend, **kw_dt)
            wall_ms = (time.perf_counter() - t0) * 1e3
            rt = (res.timings_ms.get("symbolic_ms", 0)
                  + res.timings_ms.get("numeric_ms", 0))
            gflops = 2 * nnz_cub / (rt * 1e6) if rt else 0
            # value check vs oracle. Every run is verified (the
            # reference checks every run, main.cu:325-350): full scipy
            # compare up to 4e9 flops, exact deterministic row-sample
            # compare beyond (512 rows through the same oracle).
            b_chk = a.transpose() if aat else a
            if nnz_cub < 4_000_000_000:
                ref = golden.spgemm_scipy(a, b_chk)
                ok = golden.drop_explicit_zeros(c).allclose(ref, rtol=1e-5)
                verdict = "PASSED" if ok else "NOT PASSED"
            else:
                rows = np.unique(np.random.default_rng(0).integers(
                    0, a.m, 512))
                ok = golden.rows_match_oracle(c, a, b_chk, rows, rtol=1e-5)
                verdict = "PASSED(sample)" if ok else "NOT PASSED"
            # amortized on-device numeric time (resident operands, chained
            # dispatches) — the per-call wall time above includes the
            # host<->device transfers
            dev_ms = dev_gflops = mul_ms = ""
            plan_ms = round(res.timings_ms.get("symbolic_ms", 0), 3)
            from spgemm_tpu.ops.strip import StripPlan

            if (str(res.stats.get("backend", "")).startswith("strip")
                    and isinstance(res.schedule, StripPlan)):
                from spgemm_tpu.ops.executor import StripExecutor

                try:
                    # reuse the plan spgemm just built and ran
                    ex = StripExecutor.from_plan(res.schedule, c.shape)
                    ms = ex.time_numeric(loop=20, repeats=2)
                    ms += res.timings_ms.get("symbolic_ms", 0)
                    dev_ms = round(ms, 3)
                    dev_gflops = (round(2 * nnz_cub / (ms * 1e6), 2)
                                  if ms else "")
                except ValueError as e:
                    print(f"  (device timing skipped: {e})", flush=True)
            elif str(res.stats.get("backend", "")).startswith("ozaki"):
                from spgemm_tpu.ops.ozaki import time_ozaki

                try:
                    # the ozaki device performs EVERY multiply (int8
                    # slice-pair matmuls), so 2*nnzCub/ms is the same
                    # accounting as the strip/reference kernels
                    ms = time_ozaki(res.schedule, loop=20, repeats=2)
                    dev_ms = round(ms, 3)
                    dev_gflops = (round(2 * nnz_cub / (ms * 1e6), 2)
                                  if ms else "")
                except (ValueError, RuntimeError) as e:
                    print(f"  (device timing skipped: {str(e)[:120]})",
                          flush=True)
            elif str(res.stats.get("backend", "")).startswith("esc"):
                from spgemm_tpu.ops.esc import ScanPlan, time_esc_any

                try:
                    # tiny kernels need a longer chain to rise above the
                    # per-dispatch overhead
                    loop = 20
                    if (isinstance(res.schedule, ScanPlan)
                            and res.schedule.qv.shape[0] <= 32768):
                        loop = 200
                    ms = time_esc_any(res.schedule, loop=loop, repeats=2)
                    dev_ms = round(ms, 3)
                    # honest device-FLOPS accounting: the premultiplied
                    # production kernel only ADDS on device, so GFLOPS
                    # for esc rows is computed from the in-kernel-
                    # multiply variant (EscExecutor mode="mul") whose
                    # arithmetic matches the strip/reference accounting
                    if isinstance(res.schedule, ScanPlan):
                        from spgemm_tpu.ops.executor import EscExecutor

                        exm = EscExecutor(res.schedule, mode="mul")
                        mul_ms_v = exm.time_numeric(loop=loop, repeats=2)
                        mul_ms = round(mul_ms_v, 3)
                        dev_gflops = (round(2 * nnz_cub /
                                            (mul_ms_v * 1e6), 2)
                                      if mul_ms_v else "")
                    else:
                        dev_gflops = (round(2 * nnz_cub / (ms * 1e6), 2)
                                      if ms else "")
                except (ValueError, RuntimeError) as e:
                    print(f"  (device timing skipped: {str(e)[:120]})",
                          flush=True)
            elif str(res.stats.get("backend", "")).startswith("dense"):
                from spgemm_tpu.models.tile import csr_to_tiles as c2t
                from spgemm_tpu.ops.spgemm import time_dense

                try:
                    a_t = c2t(a, args.tm, args.tn)
                    b_t = (c2t(a.transpose(), args.tn, args.tn) if aat
                           else (a_t if args.tm == args.tn
                                 else c2t(a, args.tn, args.tn)))
                    ms = time_dense(a_t, b_t)
                    dev_ms = round(ms, 3)
                    dev_gflops = (round(2 * nnz_cub / (ms * 1e6), 2)
                                  if ms else "")
                except (ValueError, RuntimeError) as e:
                    print(f"  (device timing skipped: {str(e)[:120]})",
                          flush=True)
            csv_sink.append_row(
                summary,
                ["matrix", "config", "m", "nnzA", "nnzC", "nnzCub",
                 "runtime_ms", "plan_ms", "wall_ms", "gflops",
                 "device_ms", "mul_ms", "device_gflops", "check",
                 "backend"],
                [name, cfg, a.m, a.nnz, c.nnz, nnz_cub,
                 round(rt, 3), plan_ms, round(wall_ms, 1),
                 round(gflops, 2), dev_ms, mul_ms, dev_gflops, verdict,
                 str(res.stats.get("backend", args.backend))],
            )
            print(f"  {cfg}: nnzC={c.nnz} runtime={rt:.2f}ms "
                  f"gflops={gflops:.2f} device_ms={dev_ms} "
                  f"device_gflops={dev_gflops} {verdict}", flush=True)
        # SpMM k=128
        if "SpMM128" not in want:
            continue
        if (name, "SpMM128") in done:
            print("  SpMM128: skipped (resume)", flush=True)
            continue
        if args.checkpoint_dir:
            from spgemm_tpu.io import checkpoint

            os.makedirs(args.checkpoint_dir, exist_ok=True)
            ck = os.path.join(args.checkpoint_dir,
                              f"{name}_t{args.tm}x{args.tn}.npz")
            if os.path.exists(ck):
                at = checkpoint.load(ck)
            else:
                at = csr_to_tiles(a, args.tm, args.tn)
                checkpoint.save(ck, at)
        else:
            at = csr_to_tiles(a, args.tm, args.tn)
        x = np.ones((a.n, 128), np.float32)
        jax.block_until_ready(spmm(at, x))  # warm-up (compile)
        t0 = time.perf_counter()
        y = spmm(at, x)
        jax.block_until_ready(y)
        spmm_ms = (time.perf_counter() - t0) * 1e3
        spmm_dev_ms = spmm_dev_gf = ""
        from spgemm_tpu.ops.spmm import time_spmm, time_spmm_gather

        # huge unstructured tile sets: time the gather SpMM spmm() takes
        if at.nt * at.tm * at.tn * 4 > 1 << 30:
            dms = time_spmm_gather(a, x.astype(np.float32))
        else:
            dms = time_spmm(at, x)
        spmm_dev_ms = round(dms, 3)
        spmm_dev_gf = round(2 * 128 * a.nnz / (dms * 1e6), 2) if dms else ""
        csv_sink.append_row(
            summary,
            ["matrix", "config", "m", "nnzA", "nnzC", "nnzCub",
             "runtime_ms", "plan_ms", "wall_ms", "gflops", "device_ms",
             "mul_ms", "device_gflops", "check", "backend"],
            [name, "SpMM128", a.m, a.nnz, "", 128 * a.nnz,
             round(spmm_ms, 3), "", round(spmm_ms, 1),
             round(2 * 128 * a.nnz / (spmm_ms * 1e6), 2),
             spmm_dev_ms, "", spmm_dev_gf, "", "spmm"],
        )
        print(f"  SpMM128: {spmm_ms:.2f} ms", flush=True)
    print(f"summary -> {summary}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
