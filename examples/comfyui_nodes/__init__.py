"""ComfyUI custom-node package: symlink or copy this directory into
ComfyUI/custom_nodes/ (with stabletriton_jax on PYTHONPATH) and the two nodes
appear under the "stabletriton_jax" category. The reference shipped only an
empty stub here (implementations/ComfyUI/example.py, 0 bytes)."""

from stabletriton_jax.frontends.comfyui import (  # noqa: F401
    NODE_CLASS_MAPPINGS,
    NODE_DISPLAY_NAME_MAPPINGS,
)
