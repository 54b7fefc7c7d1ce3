"""Test configuration: force a virtual 8-device CPU mesh for JAX tests.

Tests run on XLA's CPU backend whatever accelerator the host has: the
device coders run their CPU target (ops/coder.py), and multi-device
sharding is validated on the virtual 8-device CPU mesh here (and by
__graft_entry__.dryrun_multichip). No test depends on a GPU; chip_smoke.py
drives the GPU path.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
