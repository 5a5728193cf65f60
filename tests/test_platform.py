"""The platform capability function, the one compile cache, and the
bench's refusal to record a device metric without a card."""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from monte_carlo_localization_tpu.utils.platform import (
    backend_platform,
    on_accelerator,
)

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("platform,accel", [("cpu", False), ("gpu", True)])
def test_accelerator_only_on_gpu(platform, accel):
    assert backend_platform(platform) == platform
    assert on_accelerator(platform) is accel


@pytest.mark.parametrize("platform", ["rocm", "metal"])
def test_unknown_platform_raises(platform):
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        on_accelerator(platform)


def test_default_backend_is_cpu_here():
    assert backend_platform() == "cpu"
    assert on_accelerator() is False


def _cache_dir_in_subprocess(env_value):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu');"
        "from monte_carlo_localization_tpu.utils.compile_cache import "
        "enable_compile_cache;"
        "p = enable_compile_cache();"
        "print(p, jax.config.jax_compilation_cache_dir)"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, check=True)
    return out.stdout.split()


def test_compile_cache_honours_env(tmp_path):
    got, jax_dir = _cache_dir_in_subprocess(str(tmp_path / "cc"))
    assert got == jax_dir == str(tmp_path / "cc")


def test_compile_cache_defaults_to_repo_root():
    got, jax_dir = _cache_dir_in_subprocess(None)
    assert got == jax_dir == str(REPO / ".jax_cache")


def test_bench_refuses_without_gpu():
    """On a CPU-only backend the bench exits non-zero and prints no
    metric line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "bench.py", "--quick"], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert not any(ln.startswith("{") for ln in out.stdout.splitlines())
    assert "no GPU" in out.stderr


def test_bench_line_names_its_device(monkeypatch):
    sys.path.insert(0, str(REPO))
    import bench
    from monte_carlo_localization_tpu.utils import platform

    monkeypatch.setattr(platform, "card_name_and_power_limit",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    fields = bench.device_fields([dev, dev])
    assert fields == dict(
        platform="gpu", device_kind="NVIDIA H100 80GB HBM3", device_count=2,
        card="NVIDIA H100 80GB HBM3, 700.00 W",
    )
    json.dumps(fields)
