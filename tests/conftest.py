"""Test harness setup: hermetic CPU-only JAX with an 8-device virtual mesh.

Tests must be fast and deterministic on any machine, so we pin JAX to CPU
*in-process* before any backend initializes, with 8 virtual devices --
the standard JAX trick for testing multi-device sharding without hardware
(SURVEY.md section 4).  Kernels run in Pallas interpret mode; tests that
need the compiled GPU kernel are marked ``gpu`` and skip here
(chip_smoke.py runs those paths on the card).
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# repo root on sys.path so `oracle` and `libsrcnn_tpu` import from source
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
