"""Test harness: force JAX onto a virtual 8-device CPU mesh.

The reference repo had no CPU-runnable tests at all (everything needed a real
CUDA GPU — SURVEY.md §4); this conftest is the fake-backend layer it lacked.
On the CPU the platform binding is the plain reference ops
(compile.PLATFORM_BINDINGS); the GPU backends are tested through their
``implementation="xla"`` path, and tests marked ``gpu`` need a card.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# chip_smoke.py runs the ``gpu``-marked tests inside its own process, which
# already holds the card; everywhere else the suite runs on the CPU.
if os.environ.get("STABLETRITON_GPU_TESTS") != "1":
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")
