"""Dump per-step Diffusers SDXL latents as the fidelity-gate reference.

Run this wherever stock Diffusers runs (any GPU/CPU box with torch+diffusers —
this framework's own host does not need it):

    python benchmarks/dump_reference_latents.py /path/to/sdxl out.npz \
        --prompt "a photo of an astronaut" --steps 30 --size 1024

It saves everything benchmarks/fidelity.py needs to replay the identical
denoise trajectory here: the initial noise, the encoder outputs (so CLIP
differences don't confound the UNet gate), and the latents after every
scheduler step. The fidelity gate (BASELINE.md) is per-step latent MSE < 1e-3.
"""

import argparse

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("model")
    ap.add_argument("out")
    ap.add_argument("--prompt", default="a photo of an astronaut riding a horse")
    ap.add_argument("--negative", default="")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--guidance", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="float16")
    args = ap.parse_args()

    import torch
    from diffusers import StableDiffusionXLPipeline

    dtype = getattr(torch, args.dtype)
    pipe = StableDiffusionXLPipeline.from_pretrained(
        args.model, torch_dtype=dtype, use_safetensors=True
    )

    trajectory = []

    def cb(pipe_, step, timestep, kwargs):
        trajectory.append(kwargs["latents"].detach().float().cpu().numpy())
        return kwargs

    generator = torch.Generator("cpu").manual_seed(args.seed)
    lat_size = args.size // 8
    init_latents = torch.randn(
        (1, 4, lat_size, lat_size), generator=generator, dtype=torch.float32
    )

    (pe, npe, ppe, nppe) = pipe.encode_prompt(
        prompt=args.prompt, negative_prompt=args.negative, do_classifier_free_guidance=True
    )

    pipe(
        prompt_embeds=pe, negative_prompt_embeds=npe,
        pooled_prompt_embeds=ppe, negative_pooled_prompt_embeds=nppe,
        num_inference_steps=args.steps, guidance_scale=args.guidance,
        height=args.size, width=args.size,
        latents=init_latents.to(dtype),
        callback_on_step_end=cb,
        callback_on_step_end_tensor_inputs=["latents"],
    )

    np.savez_compressed(
        args.out,
        init_latents=init_latents.numpy(),            # unscaled randn, NCHW
        prompt_embeds=pe.float().cpu().numpy(),
        negative_prompt_embeds=npe.float().cpu().numpy(),
        pooled=ppe.float().cpu().numpy(),
        negative_pooled=nppe.float().cpu().numpy(),
        latents_per_step=np.stack(trajectory),        # (steps, 1, 4, h, w)
        steps=args.steps, guidance=args.guidance, size=args.size,
        scheduler=type(pipe.scheduler).__name__,
    )
    print(f"wrote {args.out}: {len(trajectory)} steps")


if __name__ == "__main__":
    main()
