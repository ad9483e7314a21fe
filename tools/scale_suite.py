#!/usr/bin/env python
"""Multi-device scaling measurement of the sharded structured route
(parallel/dist.py:spgemm_sharded_strip) on a banded cant-like matrix.

For each device count D (up to the devices present) it reports the
partition's load balance (max/mean pairs per device), the warm wall
time of one sharded multiply, and a value check against scipy. On the
CPU, `--cpu` gives 8 virtual devices: the wall times then measure the
CPU, and only the balance and check columns carry over.

Usage:
  python tools/scale_suite.py [--n 8192] [--band 64] [--devs 1,2,4]
      [--out scale_suite.csv] [--cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--band", type=int, default=64)
    ap.add_argument("--tm", type=int, default=16)
    ap.add_argument("--tn", type=int, default=128)
    ap.add_argument("--out", default="scale_suite.csv")
    ap.add_argument("--devs", default="1,2,4,8")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend with 8 virtual devices")
    args = ap.parse_args(argv)

    if args.cpu:
        os.environ.setdefault(
            "XLA_FLAGS", "--xla_force_host_platform_device_count=8")
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    from spgemm_tpu.models.csr import CSR, flop_count_spgemm
    from spgemm_tpu.models.tile import csr_to_tiles
    from spgemm_tpu.ops import golden
    from spgemm_tpu.parallel.dist import (make_mesh, plan_row_partition,
                                          spgemm_sharded_strip)
    from spgemm_tpu.utils import csv_sink
    from spgemm_tpu.utils.platform import current, enable_compile_cache

    enable_compile_cache()
    rng = np.random.default_rng(7)
    n, band = args.n, args.band
    offs = np.arange(-band, band + 1, dtype=np.int64)
    r = np.repeat(np.arange(n, dtype=np.int64), offs.size)
    c = r + np.tile(offs, n)
    keep = (c >= 0) & (c < n) & (rng.random(r.size) < 0.5)
    keep |= r == c
    a = CSR.from_coo(r[keep], c[keep],
                     rng.integers(1, 10, int(keep.sum())).astype(np.float64),
                     (n, n))
    nnz_cub = flop_count_spgemm(a, a)
    at = csr_to_tiles(a, args.tm, args.tn)
    bt = at if args.tm == args.tn else csr_to_tiles(a, args.tn, args.tn)
    ref = golden.spgemm_scipy(a, a)
    ndev_avail = len(jax.devices())
    print(f"matrix n={n} band={band} nnz={a.nnz} nnzCub={nnz_cub} "
          f"platform={current()} devices={ndev_avail}")

    for d in [int(x) for x in args.devs.split(",")]:
        if d > ndev_avail:
            print(f"D={d}: skipped ({ndev_avail} devices present)")
            continue
        plan = plan_row_partition(at, bt, d)
        per_dev = (plan.seg < plan.s_max).sum(axis=1)
        balance = float(per_dev.max() / max(per_dev.mean(), 1))
        mesh = make_mesh(d)
        spgemm_sharded_strip(at, bt, mesh)  # compile
        t0 = time.perf_counter()
        ct = spgemm_sharded_strip(at, bt, mesh)
        wall_ms = (time.perf_counter() - t0) * 1e3
        got = golden.drop_explicit_zeros(ct.to_csr())
        ok = got.pattern_equal(ref) and np.allclose(got.data, ref.data,
                                                    rtol=1e-5)
        check = "PASSED" if ok else "NOT PASSED"
        csv_sink.append_row(
            args.out,
            ["n", "band", "platform", "devices", "balance", "wall_ms",
             "check"],
            [n, band, current(), d, round(balance, 3), round(wall_ms, 2),
             check])
        print(f"D={d}: balance={balance:.3f} wall_ms={wall_ms:.2f} {check}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
