import os
import sys

# EXAADMM_TEST_PLATFORM selects the JAX platform of a test run:
#   cpu (default) — fp64 correctness testing with 8 virtual devices for the
#                   sharding tests;
#   gpu           — the GPU subset (``-m gpu``, tests/test_gpu_device.py) in
#                   the production fp32 configuration, one process per card.
_PLATFORM = os.environ.get("EXAADMM_TEST_PLATFORM", "cpu")
if _PLATFORM not in ("cpu", "gpu"):
    raise ValueError(f"EXAADMM_TEST_PLATFORM={_PLATFORM!r}: use cpu or gpu")
if _PLATFORM == "cpu":
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_enable_x64", _PLATFORM == "cpu")
jax.config.update("jax_platforms", "cuda" if _PLATFORM == "gpu" else "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def case9_path():
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "data", "case9.m")
