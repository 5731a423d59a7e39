"""The device policy (config.device_policy), the compile-cache location
(utils/cache.py) and chip_smoke.py's refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from slam_plus_plus_tpu import config
from slam_plus_plus_tpu.utils import cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,x64,dtype,precision", [
    ("cpu", True, jnp.float64, None),
    ("cpu", False, jnp.float32, None),
    ("gpu", True, jnp.float32, "highest"),
    ("gpu", False, jnp.float32, "highest"),
])
def test_device_policy(platform, x64, dtype, precision):
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", x64)
    try:
        policy = config.device_policy(platform)
    finally:
        jax.config.update("jax_enable_x64", before)
    assert policy.platform == platform
    assert policy.dtype == dtype
    assert policy.matmul_precision == precision
    assert policy.dense_limit > 0


@pytest.mark.parametrize("platform", ["rocm", "metal", ""])
def test_device_policy_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="no device policy"):
        config.device_policy(platform)


def test_default_policy_follows_backend():
    assert config.device_policy().platform == jax.default_backend() == "cpu"
    assert config.default_dtype() == jnp.float64   # tests run with x64


def test_apply_matmul_precision():
    before = jax.config.jax_default_matmul_precision
    try:
        config.apply_matmul_precision(config.device_policy("cpu"))
        assert jax.config.jax_default_matmul_precision == before
        config.apply_matmul_precision(config.device_policy("gpu"))
        assert jax.config.jax_default_matmul_precision == "highest"
    finally:
        jax.config.update("jax_default_matmul_precision", before)


def _record_cache_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(cache, "_enabled", False)
    monkeypatch.setattr(jax.config, "update",
                        lambda name, val: calls.__setitem__(name, val))
    return calls


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record_cache_updates(monkeypatch)
    assert cache.enable_compilation_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in calls   # JAX reads the env


def test_compile_cache_fixed_repo_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_cache_updates(monkeypatch)
    assert cache.enable_compilation_cache() == os.path.join(ROOT,
                                                            ".jax_cache")
    assert calls["jax_compilation_cache_dir"] == os.path.join(ROOT,
                                                              ".jax_cache")
    # idempotent: a second call sets nothing
    calls.clear()
    cache.enable_compilation_cache()
    assert calls == {}


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    """On a CPU-only host (and with none of the repository beside it) the
    smoke test exits non-zero and never prints a result."""
    script = os.path.join(ROOT, "chip_smoke.py")
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "not a GPU" in out.stdout
