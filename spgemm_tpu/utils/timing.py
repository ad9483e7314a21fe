"""Wall-clock timing helpers (the reference's TIMING instrumentation,
`src/common.h:93-95`, gettimeofday bracketing)."""

from __future__ import annotations

import contextlib
import time


class StepTimer:
    """Collects named step durations in milliseconds."""

    def __init__(self) -> None:
        self.ms: dict[str, float] = {}

    @contextlib.contextmanager
    def step(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.ms[name] = self.ms.get(name, 0.0) + (
                time.perf_counter() - t0
            ) * 1e3

    def total(self) -> float:
        return sum(self.ms.values())


def best_of(fn, repeats: int = 3) -> tuple[float, object]:
    """Run fn() `repeats` times, return (best_ms, last_result) — the
    reference's REPEAT_NUM best-of loop (`common.h:91`,
    `tilespgemm-cuda.h:2800-2808`)."""
    best = float("inf")
    result = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        result = fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best, result


@contextlib.contextmanager
def device_trace(label: str = "spgemm"):
    """Optional profiler capture: set SPGEMM_TPU_TRACE=<dir> to dump a
    trace of everything inside the context (the framework's analogue of
    the reference's DEBUG/TIMING gates, `src/common.h:72-104`)."""
    import os

    trace_dir = os.environ.get("SPGEMM_TPU_TRACE")
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(trace_dir):
        with jax.profiler.TraceAnnotation(label):
            yield


def chained_device_ms(chain_fn, *chain_args, repeats: int = 3,
                      loop: int = 1) -> float:
    """Amortized per-dispatch time of a jitted `chain_fn` that chains
    `loop` dispatches on the device through a data dependency: wall time
    to block_until_ready around the whole chain, best of `repeats`, over
    `loop`. The first call compiles and is not timed. Each step of the
    chain must consume its WHOLE output (e.g. a full sum): XLA drops the
    work behind an output slice it can see through."""
    import jax

    jax.block_until_ready(chain_fn(*chain_args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(chain_fn(*chain_args))
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best / loop


def host_mem_calibration(size_mb: int = 256) -> dict[str, float]:
    """Measure this host's WARM sequential fill (GB/s) and random-4B
    write (M/s) rates — the two rates every native plan build is bound
    by (native/csr2tile.cpp's host-memory model). The container's VM
    host drifts boot to boot (measured 5.6 vs 10 GB/s seq, 29 vs 49 M/s
    random across round-3/4 sessions), so plan_ms evidence should carry
    this calibration line: plan times scale with it, kernel times do
    not. Arrays are touched once before timing so VMM first-touch
    backing (~0.1 GB/s here) stays out of the measurement."""
    import numpy as np

    n = size_mb << 18  # f32 elements
    x = np.zeros(n, np.float32)
    x[:] = 1.0
    seq = []
    for _ in range(3):
        t0 = time.perf_counter()
        x[:] = 2.0
        seq.append((n * 4 / 1e9) / (time.perf_counter() - t0))
    idx = np.random.default_rng(0).integers(0, n, 4_000_000)
    x[idx] = 3.0
    rnd = []
    for _ in range(3):
        t0 = time.perf_counter()
        x[idx] = 4.0
        rnd.append(4.0 / (time.perf_counter() - t0))
    return {"seq_fill_gbs": round(max(seq), 2),
            "rand_write_mops": round(max(rnd), 1)}
