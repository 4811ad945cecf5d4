"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The suite runs on the CPU backend (JAX_PLATFORMS=cpu, set here before JAX
initializes); multi-device sharding logic is validated on 8 virtual CPU
devices.  What needs the GPU is checked by chip_smoke.py on the card.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()
os.environ["JAX_PLATFORMS"] = "cpu"
