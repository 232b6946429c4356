"""Headline benchmark: SDXL-base UNet denoise throughput on one GPU.

Replicates the reference's measurement protocol (SURVEY.md §6: warm up fully —
compilation excluded — then measure steady-state it/s) for the rebuild's
headline metric: UNet denoising steps/second at 1024x1024, CFG batch 2, bf16.

  baseline  = stock XLA binding (CompileConfig(backend="reference"))
  optimized = the platform binding (compile.PLATFORM_BINDINGS["gpu"]) with
              fused projections and the hoisted cross-attention K/V cache,
              i.e. the step as the pipeline's scan runs it

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}
where vs_baseline = optimized_it_s / baseline_it_s. Refuses to run without a
GPU: a number from another platform is not this metric.

Env knobs: BENCH_LATENT (default 128 = 1024² images), BENCH_STEPS (timed
steps per window, default 12), BENCH_SOLO=<binding> to run a single binding,
where <binding> is "reference", "platform" or "platform:op=backend,..."
(per-op overrides of the platform binding, e.g.
"platform:attention_qkv=reference").
"""

import json
import os
import sys

import numpy as np


def _config(binding: str):
    from stabletriton_jax.compile import CompileConfig

    if binding == "reference":
        return CompileConfig(backend="reference", dtype="bfloat16")
    name, _, spec = binding.partition(":")
    if name != "platform":
        raise ValueError(f"unknown binding {binding!r}")
    overrides = tuple(
        (op, bk) for item in spec.split(",") if item
        for op, _, bk in (item.partition("="),)
    )
    return CompileConfig(backend="platform", overrides=overrides, dtype="bfloat16")


def _build(binding: str, lat: int):
    """(fn(params, sample, t, ehs, te, tid), params, args) for one binding."""
    import jax
    import jax.numpy as jnp

    from stabletriton_jax.compile import (
        compile_unet,
        compile_unet_kv,
        fuse_attention_projections,
    )
    from stabletriton_jax.models.unet import init_unet_params, sdxl_base_unet_config

    cfg = sdxl_base_unet_config()
    ccfg = _config(binding)
    params = init_unet_params(cfg, 0, dtype=jnp.bfloat16)
    rng = np.random.default_rng(0)
    b = 2
    args = (
        jnp.asarray(rng.standard_normal((b, lat, lat, 4), dtype=np.float32), jnp.bfloat16),
        jnp.full((b,), 500.0, jnp.float32),
        jnp.asarray(rng.standard_normal((b, 77, 2048), dtype=np.float32), jnp.bfloat16),
        jnp.asarray(rng.standard_normal((b, 1280), dtype=np.float32), jnp.bfloat16),
        jnp.asarray(np.tile([lat * 8, lat * 8, 0, 0, lat * 8, lat * 8], (b, 1)).astype(np.float32)),
    )
    if binding == "reference":
        # the stock (unfused, uncached) XLA program of the standard UNet step
        return compile_unet(cfg, ccfg), params, args
    # the optimized leg measures the step exactly as the pipeline's scan
    # runs it: fused projections, cross-attention K/V computed once per
    # generation (outside the timed step)
    params = fuse_attention_projections(params)
    pre, _pre_t, step = compile_unet_kv(cfg, ccfg)
    kv = jax.block_until_ready(pre(params, args[2]))

    def fn(p, sample, t, ehs, te, tid):
        return step(p, sample, t, kv, te, tid)

    return fn, params, args


def _measure(binding: str, lat: int, steps: int) -> float:
    """Steady-state seconds/step for one binding."""
    from stabletriton_jax.runtime.profiling import bench_fn

    fn, params, args = _build(binding, lat)
    reps = max(1, int(os.environ.get("BENCH_REPS", "3")))
    return bench_fn(fn, params, *args, iters=steps, reps=reps)


def device_info() -> dict:
    """The device as JAX reports it, plus the card's name and power limit
    from nvidia-smi (read in a child process that stays off JAX)."""
    import subprocess

    import jax

    dev = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card}


def main():
    import jax

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {jax.devices()[0].platform!r}")
    from stabletriton_jax.compile import enable_persistent_compile_cache

    enable_persistent_compile_cache()
    device = device_info()
    lat = int(os.environ.get("BENCH_LATENT", "128"))
    steps = int(os.environ.get("BENCH_STEPS", "12"))
    solo = os.environ.get("BENCH_SOLO")

    if solo:
        s = _measure(solo, lat, steps)
        print(json.dumps({
            "metric": f"sdxl_unet_step_it_s_{solo}",
            "value": 1.0 / s, "unit": "it/s", "vs_baseline": 1.0,
            "device": device,
        }))
        return

    t_ref = _measure("reference", lat, steps)
    t_opt = _measure("platform", lat, steps)
    print(json.dumps({
        "metric": "sdxl_unet_1024_denoise_throughput",
        "value": 1.0 / t_opt,
        "unit": "it/s",
        "vs_baseline": t_ref / t_opt,
        "device": device,
    }))


if __name__ == "__main__":
    main()
