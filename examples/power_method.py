#!/usr/bin/env python
"""Power iteration (dominant eigenvalue) driven by the framework's SpMV —
the classic iterative-solver pattern SpMM/SpMV kernels exist for. A is
packed and uploaded ONCE; each iteration is a single jitted dispatch of
the XLA tile SpMM that `spmm` runs, whose input and output vectors stay
on device (only the final eigenvalue reaches the host).

Usage: python examples/power_method.py [n] [band]
"""

import sys

import numpy as np

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from spgemm_tpu.models.csr import CSR
from spgemm_tpu.models.tile import csr_to_tiles


def banded_spd(n: int, band: int, seed: int = 0) -> CSR:
    rng = np.random.default_rng(seed)
    offs = np.arange(-band, band + 1)
    r = np.repeat(np.arange(n), offs.size)
    c = r + np.tile(offs, n)
    keep = (c >= 0) & (c < n)
    r, c = r[keep], c[keep]
    v = rng.standard_normal(r.size)
    v = np.where(r == c, np.abs(v) + band, 0.1 * v)  # diagonally dominant
    # symmetrize
    a = CSR.from_coo(np.concatenate([r, c]), np.concatenate([c, r]),
                     np.concatenate([v, v]) / 2, (n, n))
    return a


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    band = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    a = banded_spd(n, band)
    t = csr_to_tiles(a, 16, 128)
    print(f"A: {n}x{n}, nnz={a.nnz}")

    # upload A's tiles once; build a jitted device-resident step around
    # the XLA tile SpMM
    from spgemm_tpu.ops.spmm import _spmm_tiles

    dev = jax.device_put((jnp.asarray(t.dense(np.float32)),
                          jnp.asarray(t.trow), jnp.asarray(t.tcol)))
    n_pad = t.gn * t.tn

    @jax.jit
    def step(x):
        xb = jnp.zeros((n_pad,), jnp.float32).at[:n].set(x)
        y = _spmm_tiles(*dev, xb.reshape(t.gn, t.tn, 1), gm=t.gm)
        y = y.reshape(-1)[:n]
        lam = jnp.vdot(x, y)
        return y / jnp.linalg.norm(y), lam

    x = jnp.ones(n, jnp.float32) / np.sqrt(n)
    lam = 0.0
    for it in range(150):
        x, lam_d = step(x)                  # one dispatch; x stays on device
        lam = lam_d
    lam = float(lam)
    print(f"dominant eigenvalue (power iteration): {lam:.6f}")

    # dense reference for moderate n
    if n <= 8192:
        ref = float(np.linalg.eigvalsh(a.to_dense())[-1])
        print(f"dense reference: {ref:.6f}  "
              f"(rel err {abs(lam-ref)/abs(ref):.2e})")


if __name__ == "__main__":
    main()
