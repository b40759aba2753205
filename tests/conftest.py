"""Test configuration: run everything on a virtual 8-device CPU backend so
the data-parallel/collective paths are exercised without accelerator hardware
(SURVEY.md §4: multi-host tests via JAX's multi-process CPU backend).

The platform is forced via jax.config (which takes effect at lazy backend
initialization), so the tests run on the CPU even on a machine whose JAX
would pick a GPU.  No test decides at import time whether a GPU exists;
checks that need the card are phases of chip_smoke.py.
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
