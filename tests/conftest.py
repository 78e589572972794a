"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-device hardware is not needed for correctness tests; sharding tests
exercise the same ``shard_map`` program on 8 virtual CPU devices (the CI
analog of the reference's ``mpiexec -n {2,3,4}`` sweeps,
reference ``.github/workflows/test_package.yml:33-45``).

The backend is pinned through ``jax.config``, which takes effect at (lazy)
backend initialisation.  ``chip_smoke.py`` runs the card-only tests
(``-m gpu``) inside its own process after the GPU backend is up; it sets
``NXFX_TESTS_ON_DEVICE=1`` so the backend is left as it is.
"""

import os

import jax

if not os.environ.get("NXFX_TESTS_ON_DEVICE"):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", int(os.environ.get("NXFX_CPU_DEVICES", "8")))
jax.config.update("jax_enable_x64", True)
