"""Benchmark harness. Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Workload: C = A^2 on the deterministic cant-like matrix
(utils/generators.py:cantlike — 62,451^2, ~4.06 M nnz, half-filled +-64
band, nnzCub ~2.6e8, close to cant.mtx's 2.69e8 from BASELINE.md),
through spgemm_csr's own route, on one GPU.

Metric: GFLOPS = 2*nnzCub / runtime, the reference's formula
(`src/tilespgemm-cuda.h:2808`), runtime = per-run symbolic phase (host)
+ numeric phase (device, amortized over chained dispatches with
resident operands). e2e_ms is the best wall time of one whole
spgemm_csr call, CSR in to CSR out. f64_gflops uses the same formula
over the f64 auto route's symbolic + numeric time on Gaussian values.

Baseline: 52.63 GFLOPS (the reference's best cant run, BASELINE.md).
Needs a GPU; it exits non-zero elsewhere.

Env knobs: BENCH_ROWS, BENCH_BAND, BENCH_REPEATS, BENCH_TM/BENCH_TN,
BENCH_LOOP (chained on-device iterations).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROWS = int(os.environ.get("BENCH_ROWS", 62451))
BAND = int(os.environ.get("BENCH_BAND", 64))
REPEATS = int(os.environ.get("BENCH_REPEATS", 5))
LOOP = int(os.environ.get("BENCH_LOOP", 50))
TM = int(os.environ.get("BENCH_TM", 16))
TN = int(os.environ.get("BENCH_TN", 128))
BASELINE_GFLOPS = 52.63


def main() -> int:
    import jax
    import jax.numpy as jnp

    from spgemm_tpu.models.csr import CSR, flop_count_spgemm
    from spgemm_tpu.models.tile import csr_to_tiles
    from spgemm_tpu.ops.executor import StripExecutor
    from spgemm_tpu.ops.spgemm import spgemm_csr
    from spgemm_tpu.utils.generators import cantlike
    from spgemm_tpu.utils.platform import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"# card: {smi}  device_kind: {dev.device_kind}", file=sys.stderr)

    a = cantlike(ROWS, BAND)
    nnz_cub = flop_count_spgemm(a, a)
    print(f"# matrix {ROWS}x{ROWS} nnz={a.nnz} nnzCub={nnz_cub} "
          f"tiles={TM}x{TN}", file=sys.stderr)

    convert_ms = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        at = csr_to_tiles(a, TM, TN)
        bt = at if TM == TN else csr_to_tiles(a, TN, TN)
        convert_ms = min(convert_ms, (time.perf_counter() - t0) * 1e3)

    spgemm_csr(a, tm=TM, tn=TN)  # compile
    e2e_ms = float("inf")
    res = None
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        c, res = spgemm_csr(a, tm=TM, tn=TN)
        e2e_ms = min(e2e_ms, (time.perf_counter() - t0) * 1e3)
    backend = str(res.stats["backend"])
    symbolic_ms = res.timings_ms["symbolic_ms"]
    if backend.startswith("strip"):
        numeric_ms = StripExecutor(at, bt).time_numeric(loop=LOOP,
                                                        repeats=REPEATS)
    else:
        numeric_ms = res.timings_ms["numeric_ms"]
    runtime_ms = symbolic_ms + numeric_ms
    gflops = 2.0 * nnz_cub / (runtime_ms * 1e6)
    print(f"# backend={backend} convert_ms={convert_ms:.1f} "
          f"symbolic_ms={symbolic_ms:.2f} numeric_ms={numeric_ms:.3f} "
          f"e2e_ms={e2e_ms:.1f} nnzC={c.nnz} phases="
          f"{ {k: round(v, 2) for k, v in res.timings_ms.items()} }",
          file=sys.stderr)

    az = CSR(a.indptr, a.indices,
             np.random.default_rng(11).standard_normal(a.nnz), a.shape)
    spgemm_csr(az, tm=TM, tn=TN, compute_dtype=jnp.float64)  # compile
    _, r64 = spgemm_csr(az, tm=TM, tn=TN, compute_dtype=jnp.float64)
    f64_ms = r64.timings_ms["symbolic_ms"] + r64.timings_ms["numeric_ms"]
    f64_gflops = 2.0 * nnz_cub / (f64_ms * 1e6)
    print(f"# f64 (gaussian, {r64.stats['backend']}): {f64_ms:.3f} ms = "
          f"{f64_gflops:.1f} f64-GFLOPS", file=sys.stderr)

    print(json.dumps({
        "metric": "spgemm_cantlike_gflops",
        "value": round(gflops, 2),
        "unit": "GFLOPS",
        "vs_baseline": round(gflops / BASELINE_GFLOPS, 3),
        "e2e_ms": round(e2e_ms, 1),
        "f64_gflops": round(f64_gflops, 1),
        "f64_vs_baseline": round(f64_gflops / BASELINE_GFLOPS, 3),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
