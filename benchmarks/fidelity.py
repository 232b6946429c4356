"""Fidelity gate: per-step latent MSE vs a recorded Diffusers trajectory.

    python benchmarks/fidelity.py /path/to/sdxl-checkpoint reference.npz

Replays the exact denoise trajectory (same initial noise, same encoder
outputs — recorded by dump_reference_latents.py) through this framework's
UNet + Euler scheduler, stepping outside of scan so every intermediate latent
can be compared. Passes when every step's MSE < 1e-3 (BASELINE.md gate,
formalizing the reference repo's ad-hoc 1e-3 asserts).

Exit code 0 = gate passed.
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np


def run_gate(pipe, ref, *, backend_label="", tol=1e-3) -> bool:
    import jax.numpy as jnp

    from stabletriton_jax.compile import compile_unet
    from stabletriton_jax.runtime import scheduler as sched

    steps = int(ref["steps"])
    guidance = float(ref["guidance"])
    size = int(ref["size"])

    schedule = sched.make_schedule(pipe.scheduler_config, steps)
    fn = compile_unet(pipe.unet_config, pipe.compile_config)
    dtype = pipe.compile_config.jnp_dtype

    # conditioning exactly as recorded (uncond first)
    ctx = jnp.asarray(
        np.concatenate([ref["negative_prompt_embeds"], ref["prompt_embeds"]]), dtype
    )
    pooled = jnp.asarray(np.concatenate([ref["negative_pooled"], ref["pooled"]]), dtype)
    tid = np.array([size, size, 0, 0, size, size], np.float32)
    time_ids = jnp.asarray(np.tile(tid, (2, 1)))

    lat = jnp.asarray(ref["init_latents"].transpose(0, 2, 3, 1), jnp.float32)
    lat = lat * schedule.init_noise_sigma

    ref_steps = ref["latents_per_step"]
    worst = 0.0
    ok = True
    for i in range(steps):
        sigma, sigma_next = schedule.sigmas[i], schedule.sigmas[i + 1]
        t = jnp.full((2,), float(schedule.timesteps[i]))
        inp = sched.scale_model_input(lat, sigma).astype(dtype)
        inp2 = jnp.concatenate([inp, inp], axis=0)
        eps = fn(pipe.params["unet"], inp2, t, ctx, pooled, time_ids)
        eps_u, eps_c = jnp.split(eps.astype(jnp.float32), 2, axis=0)
        eps_g = eps_u + guidance * (eps_c - eps_u)
        lat = sched.euler_step(lat, eps_g, sigma, sigma_next)

        expected = ref_steps[i].transpose(0, 2, 3, 1)  # NCHW -> NHWC
        mse = float(np.mean((np.asarray(lat, np.float32) - expected) ** 2))
        worst = max(worst, mse)
        status = "ok" if mse < tol else "FAIL"
        print(f"step {i:3d} t={float(schedule.timesteps[i]):7.1f} "
              f"mse={mse:.3e} {status}", flush=True)
        ok = ok and mse < tol

    print(f"{backend_label} worst per-step latent MSE: {worst:.3e} "
          f"({'PASS' if ok else 'FAIL'} @ {tol})")
    return ok


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint")
    ap.add_argument("reference_npz")
    ap.add_argument("--backend", default="platform", choices=["platform", "reference"])
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--tol", type=float, default=1e-3)
    args = ap.parse_args()

    from stabletriton_jax.compile import CompileConfig
    from stabletriton_jax.io.pretrained import load_sdxl

    pipe, _, _ = load_sdxl(
        args.checkpoint,
        compile_config=CompileConfig(backend=args.backend, dtype=args.dtype),
    )
    ref = np.load(args.reference_npz)
    ok = run_gate(pipe, ref, backend_label=args.backend, tol=args.tol)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
