"""SGM (generative-models) sampler-splice example — the working version of
the reference's non-functional sgm driver (reference
``implementations/sgm_/example.py:1-20``): load Stability's
``SamplingPipeline`` from a single-file SDXL checkpoint, swap the UNet inside
its DiffusionEngine for the JAX-compiled one, and sample — sgm's own
conditioner, EDM sampler loop, and VAE keep running untouched in torch.

Requires the external ``sgm`` package + torch + a checkpoint (none bundled);
the same splice works on an AUTOMATIC1111 ``sd_model`` (same CompVis UNet
convention). For whole-loop throughput load the same checkpoint natively
instead: ``io.single_file.load_single_file`` + ``runtime/pipeline.py``
(see native_txt2img.py).
"""

import time

CKPT = "models/sd_xl_base_1.0.safetensors"
CONFIG = "configs/sd_xl_base.yaml"


def main():
    from sgm.inference.api import (
        ModelArchitecture,
        SamplingParams,
        SamplingPipeline,
    )

    from stabletriton_jax import CompileConfig
    from stabletriton_jax.frontends.sgm import splice

    pipeline = SamplingPipeline(
        ModelArchitecture("stable-diffusion-xl-v1-base", None), CKPT, CONFIG
    )
    # the one-call splice: pipeline.model (DiffusionEngine) .model
    # (OpenAIWrapper) .diffusion_model now runs through JAX
    splice(pipeline, compile_config=CompileConfig(
                                                  dtype="bfloat16"))

    prompt = "a professional photograph of an astronaut riding a pig"
    params = SamplingParams(steps=30)
    t0 = time.perf_counter()
    pipeline.text_to_image(params=params, prompt=prompt,
                           negative_prompt="", samples=1)
    print(f"warm-up generation: {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    out = pipeline.text_to_image(params=params, prompt=prompt,
                                 negative_prompt="", samples=1)
    dt = time.perf_counter() - t0
    print(f"steady-state generation: {dt:.2f}s ({30 / dt:.2f} it/s)")
    assert out is not None


if __name__ == "__main__":
    main()
