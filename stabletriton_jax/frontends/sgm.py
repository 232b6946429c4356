"""SGM / A1111 frontend: splice the JAX-compiled UNet into a CompVis-style
sampler loop.

The reference shipped only a non-functional driver for the external ``sgm``
package (reference ``implementations/sgm_/example.py:1-20`` + config.yaml);
this module is the working equivalent for BOTH surfaces that speak the
CompVis/SGM UNet calling convention ``unet(x, timesteps, context=..., y=...)``:
Stability's ``sgm`` (``SamplingPipeline`` / ``DiffusionEngine``) and
AUTOMATIC1111's stable-diffusion-webui, whose ldm/sgm backends call the inner
UNet the same way.

Entry points (top-down):

  * ``splice(pipeline_or_engine)`` — locate the torch UNet inside an sgm
    ``SamplingPipeline`` (``.model`` is the DiffusionEngine) or a bare
    ``DiffusionEngine`` (``.model`` is the OpenAIWrapper holding
    ``.diffusion_model``), ingest its SGM-keyed weights once, and replace it
    in place with a JAX shim. The surrounding sampler loop (sgm's EDM
    samplers, A1111's KDiffusion) keeps running untouched — the analog of
    ``pipe.unet = frontends.diffusers.compile(pipe.unet)`` for this stack.
  * ``compile_sgm_unet(torch_unet)`` — the one-module version: SGM-keyed
    ``state_dict`` -> HF keys (io.single_file.convert_sgm_unet) -> framework
    layout -> compiled step, wrapped in the calling-convention shim.

The shim accepts SGM's ``y`` directly: the pre-projected adm vector
``concat(pooled_text, fourier(time_ids))`` built by sgm's
``ConcatTimestepEmbedderND`` conditioner — models/unet.unet_apply's SGM
branch consumes it without re-deriving diffusers-style time_ids (the same
5-slot refiner / 6-slot base conditioning path the ComfyUI shim uses).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from stabletriton_jax.compile import CompileConfig


class CompVisUNetShim:
    """Adapts the CompVis/SGM UNet calling convention
    ``(x, timesteps, context, y)`` (NCHW torch tensors) to the compiled JAX
    step. Shared verbatim by the ComfyUI frontend — ComfyUI inherited the
    same convention from ldm/sgm.

    SGM passes ``y``: the raw adm vector ``concat(pooled_text,
    fourier(time_ids))`` — 2816-wide for the SDXL base (6 time-id slots),
    2560-wide for the refiner (pooled 1280 + 5 slots: size/crop/aesthetic,
    no target-size pair) — NOT diffusers' separate text_embeds/time_ids.
    The compiled UNet accepts this pre-projected form directly
    (models/unet.unet_apply's SGM branch); the fourier layout ([cos, sin],
    freq_shift 0) is identical between the two stacks."""

    def __init__(self, compiled):
        self.compiled = compiled
        self.dtype = compiled.dtype

    def __call__(self, x, timesteps=None, context=None, y=None, **kwargs):
        added = kwargs.get("added_cond_kwargs")
        if added is None:
            if "text_embeds" in kwargs and "time_ids" in kwargs:
                # diffusers-style kwargs routed through transformer_options
                added = {"text_embeds": kwargs["text_embeds"],
                         "time_ids": kwargs["time_ids"]}
            elif y is not None:
                # SGM convention: y IS the full add-embedding input
                added = {"y": y}
        out = self.compiled(
            x, timesteps, context, added_cond_kwargs=added, return_dict=False
        )
        return out[0]

    # sgm's OpenAIWrapper calls the UNet as a plain callable, but some loops
    # (and A1111's hijack layers) probe nn.Module-ish attributes; keep the
    # cheap ones honest without importing torch at module import time.
    def parameters(self):
        return iter(())

    def eval(self):
        return self

    def to(self, *_, **__):
        return self


def compile_sgm_unet(
    torch_unet: Any,
    unet_config=None,
    compile_config: CompileConfig | None = None,
    deep_cache: int | None = None,
) -> CompVisUNetShim:
    """SGM-keyed torch UNetModel -> JAX-compiled drop-in (CompVis convention).

    ``unet_config`` defaults to the SDXL-base topology (UNetConfig()) — sgm's
    UNetModel carries no introspectable config object, so non-base variants
    (refiner, SD2.x) must pass theirs explicitly (models/unet has the
    constructors). Weight flow: SGM names -> HF names
    (io.single_file.convert_sgm_unet, the single-file checkpoint path's own
    table) -> framework layout (io.safetensors_io.convert_state_dict)."""
    from stabletriton_jax.frontends.diffusers import CompiledUNet
    from stabletriton_jax.io.safetensors_io import convert_state_dict
    from stabletriton_jax.io.single_file import convert_sgm_unet
    from stabletriton_jax.models.unet import UNetConfig

    cfg = unet_config or UNetConfig()
    sd = {k: v.detach().cpu().numpy()
          for k, v in torch_unet.state_dict().items()}
    hf_sd = convert_sgm_unet(sd, cfg)
    np_params = convert_state_dict(hf_sd, dtype=np.float32)
    compiled = CompiledUNet.from_params(cfg, np_params, compile_config,
                                        deep_cache=deep_cache)
    return CompVisUNetShim(compiled)


def _find_wrapper(pipeline_or_engine: Any):
    """The module holding ``.diffusion_model``: sgm's OpenAIWrapper.

    SamplingPipeline.model is the DiffusionEngine; DiffusionEngine.model is
    the wrapper. Accept either level (A1111's sd_model nests the same way
    via ``.model.diffusion_model``)."""
    obj = pipeline_or_engine
    for _ in range(3):
        if hasattr(obj, "diffusion_model"):
            return obj
        obj = getattr(obj, "model", None)
        if obj is None:
            break
    raise ValueError(
        "no .diffusion_model found (expected an sgm SamplingPipeline / "
        "DiffusionEngine or an A1111 sd_model)"
    )


def splice(
    pipeline_or_engine: Any,
    unet_config=None,
    compile_config: CompileConfig | None = None,
    deep_cache: int | None = None,
):
    """Replace the UNet inside an sgm/A1111 object with the JAX shim, in
    place, and return the object (reference analog:
    implementations/sgm_/example.py wanted this but never wired it).

    Everything else — conditioner, samplers, VAE — keeps running in torch;
    only the per-step UNet forward moves to JAX. For whole-loop
    throughput use the native pipeline (runtime/pipeline.py) with the same
    checkpoint via io.single_file.load_single_file instead."""
    wrapper = _find_wrapper(pipeline_or_engine)
    wrapper.diffusion_model = compile_sgm_unet(
        wrapper.diffusion_model, unet_config, compile_config,
        deep_cache=deep_cache,
    )
    return pipeline_or_engine
