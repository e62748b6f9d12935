"""Persistent compile-cache placement (utils/runtime.py)."""
import os
import subprocess
import sys

import pytest

from kit4b_tpu.utils import runtime

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def test_cache_dir_honours_environment():
    env = {"JAX_COMPILATION_CACHE_DIR": "/some/where/else"}
    assert runtime.compile_cache_dir(env) == "/some/where/else"


def test_cache_dir_default_is_fixed_inside_checkout():
    assert runtime.compile_cache_dir({}) == os.path.join(REPO, ".jax_cache")
    assert runtime.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")


PROBE = """
import sys
sys.path.insert(0, {repo!r})
import jax
from kit4b_tpu.utils.runtime import enable_compile_cache
print(enable_compile_cache())
print(jax.config.jax_compilation_cache_dir)
"""


def _probe(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    r = subprocess.run([sys.executable, "-c", PROBE.format(repo=REPO)],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.split()[-2:]


@pytest.mark.parametrize("use_env", [True, False])
def test_enable_compile_cache_places_cache(tmp_path, use_env):
    want = str(tmp_path / "xla") if use_env else os.path.join(REPO,
                                                             ".jax_cache")
    returned, configured = _probe(want if use_env else None)
    assert returned == want
    assert configured == want
