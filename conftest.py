"""Test harness configuration.

Tests run on the CPU, on a virtual 8-device mesh so that sharding logic is
exercised without accelerators; Pallas kernels run in interpret mode.  The
GPU path is checked by ``python chip_smoke.py`` on a machine with a card.
XLA_FLAGS is read lazily at CPU client init, so setting it here works.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
