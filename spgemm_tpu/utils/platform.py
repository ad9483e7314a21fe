"""The one place that knows which device the process runs on.

Every decision that depends on the platform is made here: whether the
auto router takes the structured strip route, which f64 route it takes,
and where the persistent compile cache lives. No other module asks JAX
for its backend. Every device path is plain XLA; there is no
hand-written kernel and no interpret mode.
"""

from __future__ import annotations

import os

import jax

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def current() -> str:
    """The default JAX backend of this process: "gpu", "cpu", ..."""
    return jax.default_backend()


def prefers_strip(platform: str | None = None) -> bool:
    """Whether the auto router sends f32 tiled products to the strip
    route (ops/strip.py) before the dense and slab routes: on a GPU,
    where the measurement in PERF.md found it fastest end to end (its
    host plan is a pair schedule over natively packed tiles)."""
    return (platform or current()) == "gpu"


def f64_native(platform: str | None = None) -> bool:
    """Whether the f64 auto route runs native float64 arithmetic (the
    XLA slab in x64) instead of the f32-hardware emulations (Ozaki int8
    slices, double-double scan). True on a GPU, whose FP64 units the
    measurement in PERF.md found fastest of the three."""
    return (platform or current()) == "gpu"


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at a fixed directory and
    return it. An explicit JAX_COMPILATION_CACHE_DIR wins and nothing is
    set; otherwise the cache is `<repo>/.jax_cache` (git-ignored). The
    path holds no temp name, pid or time, so a later process hits it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(_REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
