"""ComfyUI frontend: custom nodes exposing the JAX pipeline to ComfyUI graphs.

The reference shipped only a stub here (empty ``implementations/ComfyUI/example.py``,
placeholder README — SURVEY.md §2.9); BASELINE.json config #5 asks for a real
hook. This module is a self-contained ComfyUI custom-node pack:

  * ``StableTritonCompile``  — wraps a ComfyUI MODEL's diffusion_model the
    same way the diffusers frontend wraps ``pipe.unet``: ingest config+weights,
    return a patched model whose UNet forward runs through JAX (ComfyUI calls
    ``apply_model`` -> our jitted step; NCHW<->NHWC handled at the boundary).
  * ``StableTritonTxt2Img`` — bypasses ComfyUI's sampler entirely and runs
    the native single-program txt2img (CLIP -> scan -> VAE) for maximum
    throughput, taking CONDITIONING from ComfyUI's CLIP nodes.

ComfyUI itself is not importable in this environment, so the node classes are
plain Python with no comfy imports (ComfyUI discovers nodes via the
NODE_CLASS_MAPPINGS convention and only needs these classes to exist);
``register()`` is the entry a custom_nodes/__init__.py calls.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from stabletriton_jax.compile import CompileConfig
# ComfyUI's UNet calling convention (x, timesteps, context, y) IS the
# CompVis/SGM convention (comfy.model_base.SDXL.encode_adm builds the same
# raw 2816-wide adm ``y`` sgm's conditioner does), so the shim is shared
# with the sgm/A1111 frontend.
from stabletriton_jax.frontends.sgm import CompVisUNetShim as _ComfyUNetShim


class StableTritonCompile:
    """ComfyUI node: MODEL in -> MODEL out with a JAX-compiled UNet."""

    CATEGORY = "stabletriton_jax"
    RETURN_TYPES = ("MODEL",)
    FUNCTION = "compile"

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": ("MODEL",),
                "backend": (["platform", "reference"], {"default": "platform"}),
                "dtype": (["bfloat16", "float32"], {"default": "bfloat16"}),
                # DeepCache interval, 0 = off (draft knob, see
                # frontends/diffusers.compile)
                "deep_cache": ("INT", {"default": 0, "min": 0, "max": 10}),
            }
        }

    def compile(self, model: Any, backend: str = "platform",
                dtype: str = "bfloat16", deep_cache: int = 0):
        from stabletriton_jax.frontends.diffusers import CompiledUNet

        cfg = CompileConfig(backend=backend, dtype=dtype)
        # ComfyUI MODEL wraps the torch UNet at model.model.diffusion_model
        torch_unet = model.model.diffusion_model
        compiled = CompiledUNet(torch_unet, cfg,
                                deep_cache=deep_cache or None)
        patched = model.clone() if hasattr(model, "clone") else model
        patched.model.diffusion_model = _ComfyUNetShim(compiled)
        return (patched,)


class StableTritonTxt2Img:
    """ComfyUI node: run the native whole-loop JAX pipeline, return an IMAGE."""

    CATEGORY = "stabletriton_jax"
    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "generate"

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "pipeline": ("STABLETRITON_PIPELINE",),
                "ids1": ("TOKENS",),
                "ids2": ("TOKENS",),
                "width": ("INT", {"default": 1024, "min": 256, "max": 2048, "step": 64}),
                "height": ("INT", {"default": 1024, "min": 256, "max": 2048, "step": 64}),
                "steps": ("INT", {"default": 30, "min": 1, "max": 200}),
                "cfg": ("FLOAT", {"default": 5.0, "min": 0.0, "max": 30.0}),
                "seed": ("INT", {"default": 0}),
                "solver": (["euler", "heun", "dpmpp_2m"], {"default": "euler"}),
            },
            "optional": {
                # draft knobs (see SDXLPipeline.txt2img): DeepCache interval
                # (0 = off) and depth; CFG-only-inside-sigma-window bounds
                # (both 0 = off)
                "deep_cache": ("INT", {"default": 0, "min": 0, "max": 10}),
                # depth must stay < the UNet's level count (3 for SDXL —
                # models/unet.deep_cache_shape validates with the real count)
                "deep_cache_depth": ("INT", {"default": 1, "min": 1, "max": 2}),
                "gi_sigma_lo": ("FLOAT", {"default": 0.0, "min": 0.0}),
                "gi_sigma_hi": ("FLOAT", {"default": 0.0, "min": 0.0}),
            },
        }

    def generate(self, pipeline, ids1, ids2, width, height, steps, cfg, seed,
                 solver, deep_cache=0, deep_cache_depth=1,
                 gi_sigma_lo=0.0, gi_sigma_hi=0.0):
        import jax.numpy as jnp

        img = pipeline.txt2img(
            jnp.asarray(np.asarray(ids1, np.int32)),
            jnp.asarray(np.asarray(ids2, np.int32)),
            height=height, width=width, steps=steps,
            guidance_scale=cfg, seed=seed, solver=solver,
            deep_cache=((deep_cache, deep_cache_depth) if deep_cache else None),
            guidance_interval=((gi_sigma_lo, gi_sigma_hi)
                               if gi_sigma_hi > 0 else None),
        )
        # ComfyUI IMAGE convention: float32 [0,1], (B, H, W, C)
        return (np.asarray((img + 1.0) * 0.5, dtype=np.float32),)


NODE_CLASS_MAPPINGS = {
    "StableTritonCompile": StableTritonCompile,
    "StableTritonTxt2Img": StableTritonTxt2Img,
}

NODE_DISPLAY_NAME_MAPPINGS = {
    "StableTritonCompile": "Compile UNet (JAX)",
    "StableTritonTxt2Img": "SDXL txt2img (JAX, whole-loop)",
}


def register():
    """Entry point for a ComfyUI custom_nodes package __init__."""
    return NODE_CLASS_MAPPINGS, NODE_DISPLAY_NAME_MAPPINGS
