"""No fallback hides the device: mesh size, device memory, cache place."""

import os
import subprocess
import sys

import jax
import pytest

from tests.conftest import REPO
from goldrush_jax.parallel.mesh import make_mesh
from goldrush_jax.path import engine


def test_make_mesh_raises_when_short_of_devices():
    assert len(jax.devices()) == 8            # the virtual tier-1 mesh
    with pytest.raises(ValueError, match="16 devices requested"):
        make_mesh(16)


def test_make_mesh_shapes():
    mesh = make_mesh(8, model=2)
    assert mesh.devices.shape == (4, 2)
    assert mesh.axis_names == ("data", "model")
    with pytest.raises(ValueError, match="data"):
        make_mesh(8, data=3, model=2)


def test_device_memory_bytes_on_cpu_is_host_memory():
    want = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert engine._device_memory_bytes() == want


class _Dev:
    platform, device_kind = "gpu", "Fake GPU"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 1}])
def test_device_memory_bytes_raises_without_stats(monkeypatch, stats):
    monkeypatch.setattr(engine.jax, "devices", lambda: [_Dev(stats)])
    with pytest.raises(RuntimeError, match="reports no bytes_limit"):
        engine._device_memory_bytes()


def test_device_memory_bytes_uses_bytes_limit(monkeypatch):
    monkeypatch.setattr(engine.jax, "devices",
                        lambda: [_Dev({"bytes_limit": 60 << 30})])
    assert engine._device_memory_bytes() == 60 << 30


def _cache_dir(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    r = subprocess.run(
        [sys.executable, "-c",
         "import goldrush_jax, jax; print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120,
        check=True)
    return r.stdout.strip()


@pytest.mark.parametrize("env_dir", [None, "/elsewhere/jax-cache"])
def test_compile_cache_placement(env_dir):
    got = _cache_dir(env_dir)
    if env_dir is None:
        assert got == str(REPO / ".jax_cache")
    else:
        assert got == env_dir           # the package sets no other
