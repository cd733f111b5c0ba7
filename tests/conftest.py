"""Test env: the CPU with 8 virtual devices, so numerics tests are
f32-exact and multi-device sharding tests run without a GPU.

The program itself runs on the GPU through ``python chip_smoke.py``; the
unit suite runs here on the CPU.

The CPU is not a device :mod:`textgcn.device` prices, so tests that reach
the ``auto`` format choice get an explicit model: the H100 entry, keyed as
the CPU (:func:`cpu_device_model`, autouse). Entry points that turn on the
compile cache find ``JAX_COMPILATION_CACHE_DIR`` set and leave JAX alone
(:func:`no_repo_compile_cache`, autouse).
"""
import dataclasses
import os
import sys

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from textgcn import device as _device  # noqa: E402

H100_KIND = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def cpu_device_model(monkeypatch):
    """Price the CPU test host as an H100 while a test runs."""
    model = dataclasses.replace(_device.DEVICES[H100_KIND], kind="cpu")
    monkeypatch.setitem(_device.DEVICES, "cpu", model)
    return model


@pytest.fixture(autouse=True)
def no_repo_compile_cache(monkeypatch, tmp_path):
    """Entry points called by tests (cli.main, the YAML runner) leave JAX's
    config alone and write no compile cache into the repository: the
    variable is read by JAX only when it starts, so naming a directory
    here turns no cache on."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
