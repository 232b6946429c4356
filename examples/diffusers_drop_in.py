"""Diffusers drop-in example — analog of the reference's headline demo
(reference ``implementations/Diffusers/load_sdxl_pipeline.py``): load the
stock SDXL pipeline with torch, swap its UNet for the JAX-compiled one, and
run the two-generation measurement protocol (first = warm-up/compile,
second = measured).

Requires torch + diffusers + an SDXL checkpoint (none are bundled here);
for the torch-free maximum-throughput path see native_txt2img.py.
"""

import time

MODEL = "stabilityai/stable-diffusion-xl-base-1.0"


def main():
    import torch
    from diffusers import StableDiffusionXLPipeline

    from stabletriton_jax import CompileConfig
    from stabletriton_jax.frontends.diffusers import compile as st_compile

    pipe = StableDiffusionXLPipeline.from_pretrained(MODEL, use_safetensors=True)
    # the one-call splice (the reference's optimize_model analog)
    pipe.unet = st_compile(pipe.unet, CompileConfig(dtype="bfloat16"))

    prompt = "a photo of an astronaut riding a horse on mars"
    t0 = time.perf_counter()
    pipe(prompt, num_inference_steps=30)  # warm-up: compiles every signature
    print(f"warm-up generation: {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    image = pipe(prompt, num_inference_steps=30).images[0]
    dt = time.perf_counter() - t0
    print(f"steady-state generation: {dt:.2f}s ({30 / dt:.2f} it/s)")
    image.save("out.png")


if __name__ == "__main__":
    main()
