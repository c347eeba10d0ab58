"""Compile-cache location (ops/jax_env.py): JAX_COMPILATION_CACHE_DIR when
it is set, else a fixed `.jax_cache` directory in the checkout."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = (
    "import jax; import flacenc_tpu.ops.jax_env as e; "
    "print(jax.config.jax_compilation_cache_dir); print(e.CACHE_DIR)"
)


@pytest.mark.parametrize("env_dir", ["set", "unset"])
def test_compile_cache_location(env_dir, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    if env_dir == "set":
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], env=env, cwd=str(tmp_path),
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout.split()
    fallback = os.path.join(REPO, ".jax_cache")
    assert out[1] == fallback
    if env_dir == "set":
        assert out[0] == str(tmp_path / "cc")
    else:
        assert out[0] == fallback
