"""stabletriton-jax: an SDXL inference-acceleration framework in JAX.

Capability target: everything `StableTriton` (the CUDA/Triton reference) does —
a one-call ``compile(model)`` that substitutes fused kernels for the hot ops of
an SDXL UNet and replays the whole forward without host round-trips — rebuilt
on JAX / XLA:

  * the torch.fx rewrite-pass pipeline (reference ``src/stabletriton/optimization.py:10-25``)
    becomes an *op registry* with per-op backend binding (``stabletriton_jax.ops``);
  * the Triton kernels (reference ``src/stabletriton/kernels/``) become a
    per-platform binding: cuDNN's fused attention on the GPU (``ops/gpu.py``),
    XLA's own fusion and cuDNN/cuBLAS for the rest;
  * CUDA-graph capture/replay (reference ``src/stabletriton/optimizers/cuda/graphs.py``)
    becomes a jitted ``lax.scan`` denoising loop with donated buffers and a
    shape-keyed compile cache (``stabletriton_jax.runtime``).
"""

__version__ = "0.1.0"

from stabletriton_jax.compile import compile_unet, CompileConfig  # noqa: F401
from stabletriton_jax import ops  # noqa: F401
