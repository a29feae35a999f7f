"""Test configuration: run everything on a virtual 8-device CPU mesh so that
sharding tests exercise real multi-device paths without TPU hardware.

Note: a pytest plugin imports jax before this conftest runs, so setting
JAX_PLATFORMS in os.environ alone is too late — we must also update the jax
config directly (the backend itself initializes lazily, so this works as long
as no jax computation ran yet).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernels); skips without one")
