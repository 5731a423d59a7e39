"""Test configuration: CPU backend, float64, 8 virtual devices for the
multi-chip sharding tests.

The tests run on the CPU: ``jax.config.update('jax_platforms', 'cpu')``
holds even where a GPU is present, so they are hermetic on CPU/f64.  Tests
that need the card are marked ``gpu`` and skip without one; on a GPU host
``SLAMPP_TEST_PLATFORMS=cpu,cuda python -m pytest -m gpu tests/`` runs them
(CPU stays the default backend), and ``python chip_smoke.py`` checks the
solve path.
"""

import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms",
                  os.environ.get("SLAMPP_TEST_PLATFORMS", "cpu"))
jax.config.update("jax_enable_x64", True)
