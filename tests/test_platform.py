"""utils/platform.py and the routing it drives, decided for a named
platform without touching a device; the compile-cache location; and
chip_smoke.py's refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spgemm_tpu.models.csr import CSR
from spgemm_tpu.models.tile import csr_to_tiles
from spgemm_tpu.ops.spgemm import _resolve_backend, csr_route
from spgemm_tpu.utils import platform as plat
from spgemm_tpu.utils.generators import banded, cantlike, random_uniform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gaussian(a: CSR, seed=0) -> CSR:
    return CSR(a.indptr, a.indices,
               np.random.default_rng(seed).standard_normal(a.nnz), a.shape)


@pytest.mark.parametrize("platform,expect", [("gpu", "strip"),
                                             ("cpu", "dense")])
def test_banded_routes_to_tile_kernel_on_gpu(platform, expect):
    a = banded(np.random.default_rng(1), 2048, 64)
    assert csr_route(a, platform=platform) == "tiled"
    at, bt = csr_to_tiles(a, 16, 128), csr_to_tiles(a, 128, 128)
    assert _resolve_backend(at, bt, "auto", platform=platform)[0] == expect


def test_random_routes_to_esc_on_gpu():
    a = random_uniform(np.random.default_rng(2), 4096)
    assert csr_route(a, platform="gpu") == "esc"


@pytest.mark.parametrize("platform,expect", [("gpu", "f64-native"),
                                             ("cpu", "ozaki")])
def test_f64_structured_route(platform, expect):
    a = _gaussian(cantlike(2048, 64))
    assert csr_route(a, compute_dtype=jnp.float64,
                     platform=platform) == expect


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_f64_integer_and_unstructured_routes(platform):
    a = cantlike(2048, 64)
    assert csr_route(a, compute_dtype=jnp.float64,
                     platform=platform) == "f64-exact-int"
    u = _gaussian(random_uniform(np.random.default_rng(3), 4096))
    assert csr_route(u, compute_dtype=jnp.float64,
                     platform=platform) == "esc-dd"


def test_tile_kernel_needs_f32_and_power_of_two_tiles():
    """The strip route takes f32 at any tile shape on any platform when
    asked; f64 falls back to the slab route."""
    a = banded(np.random.default_rng(4), 1024, 32)
    at, bt = csr_to_tiles(a, 16, 128), csr_to_tiles(a, 128, 128)
    assert _resolve_backend(at, bt, "auto", jnp.float64,
                            platform="gpu")[0] != "strip"
    backend, note = _resolve_backend(at, bt, "strip", jnp.float64,
                                     platform="gpu")
    assert backend == "gustavson" and note.startswith("strip-fallback")
    at, bt = csr_to_tiles(a, 8, 16), csr_to_tiles(a, 16, 16)
    for platform in ("gpu", "cpu"):
        assert _resolve_backend(at, bt, "strip",
                                platform=platform) == ("strip", "")


def test_platform_answers():
    assert plat.prefers_strip("gpu") and not plat.prefers_strip("cpu")
    assert plat.f64_native("gpu") and not plat.f64_native("cpu")
    assert plat.current() == "cpu"


def test_compile_cache_env_set(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert plat.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_env_unset(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = plat.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """On the CPU, and in a directory holding chip_smoke.py and nothing
    else of the repo, the smoke run exits non-zero and prints no
    result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = str(tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, script], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
