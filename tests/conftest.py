"""Test harness config: force an 8-device virtual CPU mesh.

Multi-device logic is tested without several GPUs via XLA's host-platform
device-count override, the standard JAX stand-in for distributed tests
(SURVEY.md section 4).  The tests always run on the CPU: jax_platforms is
set in config as well as in the environment, before any backend starts.
"""
import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu", jax.devices()
assert jax.device_count() == 8, jax.devices()
