"""The one platform decision (utils/platform.py) and the compile-cache
directory (cli.compile_cache_dir)."""

import os

import jax
import pytest

from buildingsegment_tpu import cli
from buildingsegment_tpu.utils.platform import (
    GPU_KERNELS,
    backend_platform,
    op_impl,
)


@pytest.mark.parametrize("op", ["stats_sweep", "window_sweep", "segsum"])
def test_cpu_runs_plain_xla(op):
    assert op_impl(op, "cpu") == "xla"


def test_gpu_gets_the_kept_kernel_else_xla():
    assert op_impl("stats_sweep", "gpu") == GPU_KERNELS["stats_sweep"]
    assert op_impl("stats_sweep", "gpu") == "triton"
    assert op_impl("window_sweep", "gpu") == "xla"


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_unknown_platform_raises(platform):
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        op_impl("stats_sweep", platform)


def test_default_is_this_backend():
    assert backend_platform() == jax.devices()[0].platform == "cpu"
    assert op_impl("stats_sweep") == "xla"


def test_default_device_decides():
    with jax.default_device(jax.devices("cpu")[0]):
        assert backend_platform() == "cpu"
    with jax.default_device("cpu"):
        assert backend_platform() == "cpu"


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cli.compile_cache_dir() == str(tmp_path)


def test_cache_dir_default_is_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(cli.__file__)))
    assert cli.compile_cache_dir() == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enable_cache_sets_no_dir_when_env_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", str(tmp_path))
        cli._enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_enable_cache_uses_checkout_dir_when_env_unset(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        cli._enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == cli.DEFAULT_CACHE_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
