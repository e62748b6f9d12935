"""Test config: force JAX onto a virtual 8-device CPU mesh.

Must run before any jax import (SURVEY.md §4: multi-host tests fake a pod via
xla_force_host_platform_device_count).
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
prev = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in prev:
    os.environ["XLA_FLAGS"] = (
        prev + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

# Tests run on the CPU even where a GPU is present; the config setting holds
# even if a plugin or the environment would pick another platform.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
