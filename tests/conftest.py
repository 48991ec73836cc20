"""Test setup: CPU JAX with 8 virtual devices (multi-device sharding is
validated on a host-device mesh, the standard JAX fake-backend pattern).

The platform is switched through jax.config as well as the environment, so
the switch holds even where jax was imported before this file runs.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kaamer_jax.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
