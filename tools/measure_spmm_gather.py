#!/usr/bin/env python
"""A/B the gather-SpMM variants on the device.

Times spmm_gather's device computation in both forms at several
unstructured regimes: the fused broadcast-multiply-reduce (XLA fuses the
X row gather into the reduction loop) and the barrier+matmul form
(standalone row gather feeding a batched (1,c)x(c,k) contraction).
Prints per-variant device ms, useful GFLOPS, and the fraction of
3.35 TB/s (the H100's device-memory rate) the traffic model reaches
(see spmm_gather's docstring).

Usage: python tools/measure_spmm_gather.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    from spgemm_tpu.ops.spmm import spmm_gather, time_spmm_gather
    from spgemm_tpu.utils.generators import power_law, random_uniform, rmat

    rng = np.random.default_rng(7)
    k = 128
    cases = {
        "random8192": random_uniform(rng, 8192),
        "powerlaw8192": power_law(rng, 8192),
        "random65536": random_uniform(rng, 65536),
        "powerlaw65536": power_law(rng, 65536),
        "rmat65536": rmat(rng, 65536),
    }
    for name, a in cases.items():
        x = rng.standard_normal((a.n, k)).astype(np.float32)
        flops = 2.0 * a.nnz * k
        # value-check BOTH variants against the scipy oracle (the fused
        # reduce is the default; the matmul form is the A/B — checking
        # only one would leave the other unexercised)
        import scipy.sparse as sp

        ref = sp.csr_matrix((a.data, a.indices, a.indptr),
                            shape=a.shape) @ x
        rel = 0.0
        for fuse_chk in ("1", "0"):
            os.environ["SPGEMM_SPMM_FUSE"] = fuse_chk
            y = spmm_gather(a, x)
            rel = max(rel, float(np.abs(y - ref).max() /
                                 max(np.abs(ref).max(), 1e-30)))
        ok = rel < 1e-5
        row = [f"{name:14s} nnz={a.nnz:>9}"]
        for tag, fuse in (("matmul", "0"), ("fused", "1")):
            os.environ["SPGEMM_SPMM_FUSE"] = fuse
            ms = time_spmm_gather(a, x, loop=20, repeats=2)
            gf = flops / (ms * 1e6)
            # traffic: one k_pad*4B X row + 8B of (val,col) per stored
            # nonzero; output amortized (small)
            sol_ms = a.nnz * (k * 4 + 8) / 3.35e12 * 1e3
            row.append(f"{tag}: {ms:8.3f} ms {gf:7.1f} GF"
                       f" ({100 * sol_ms / ms:5.1f}% of 3.35 TB/s)")
        row.append(f"check={'PASS' if ok else f'FAIL rel={rel:.2e}'}")
        print("  ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
