"""Per-component cost breakdown of one SDXL UNet step on the GPU.

Times each building block (resnet / transformer stack / conv / up-
and downsample) at its real SDXL shape and multiplies by its occurrence count,
giving an additive model of the 1024x1024 step. Points the optimization effort
at the biggest bucket instead of guessing.

    python benchmarks/breakdown.py [platform|reference]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np


def main(backend="platform"):
    import jax
    import jax.numpy as jnp

    from stabletriton_jax import ops
    from stabletriton_jax.compile import CompileConfig, resolve_binding
    from stabletriton_jax.models.unet import (
        _resnet, _transformer2d, init_unet_params, sdxl_base_unet_config,
    )
    from stabletriton_jax.runtime.profiling import bench_fn

    cfg = sdxl_base_unet_config()
    params = init_unet_params(cfg, 0, dtype=jnp.bfloat16)
    binding = resolve_binding(CompileConfig(backend=backend, dtype="bfloat16"))
    rng = np.random.default_rng(0)

    def arr(*shape):
        return jnp.asarray(rng.standard_normal(shape, dtype=np.float32)).astype(jnp.bfloat16)

    temb = arr(2, 1280)
    ctx = arr(2, 77, 2048)

    rows = []

    def add(label, count, fn, x):
        f = jax.jit(lambda v: fn(v))
        t = bench_fn(f, x)
        rows.append((label, count, t * 1e3))
        print(f"[measured] {label:34s} x{count}  {t*1e3:8.3f} ms", flush=True)

    B = 2
    # resnets: (key, shape, count) — counts from the SDXL topology
    resnet_cases = [
        ("down_blocks.0.resnets.0", (B, 128, 128, 320), 2),   # level0 down
        ("down_blocks.1.resnets.1", (B, 64, 64, 640), 1),     # level1 down same-ch
        ("down_blocks.2.resnets.1", (B, 32, 32, 1280), 1),    # level2 down same-ch
        ("mid_block.resnets.0", (B, 32, 32, 1280), 2),
    ]
    for key, shape, count in resnet_cases:
        x = arr(*shape)
        with ops.use_backends(binding):
            add(f"resnet {shape[3]}ch @{shape[1]}", count,
                lambda v, key=key: _resnet(params, key, v, temb, cfg), x)

    # channel-changing + concat-input resnets approximated by nearest same-ch
    # (shortcut conv adds ~1x1 conv; counted separately below)

    tf_cases = [
        ("down_blocks.1.attentions.0", (B, 64, 64, 640), 2, 2),
        ("down_blocks.2.attentions.0", (B, 32, 32, 1280), 10, 2),
        ("mid_block.attentions.0", (B, 32, 32, 1280), 10, 1),
        ("up_blocks.0.attentions.0", (B, 32, 32, 1280), 10, 3),
        ("up_blocks.1.attentions.0", (B, 64, 64, 640), 2, 3),
    ]
    for key, shape, layers, count in tf_cases:
        x = arr(*shape)
        with ops.use_backends(binding):
            add(f"tf2d {shape[3]}ch @{shape[1]} x{layers}L", count,
                lambda v, key=key, layers=layers: _transformer2d(
                    params, key, v, ctx, cfg, layers), x)

    # up-path resnets with concat inputs (9 of them, channel-reducing)
    up_cases = [
        ("up_blocks.0.resnets.0", (B, 32, 32, 2560), 2),
        ("up_blocks.0.resnets.2", (B, 32, 32, 1920), 1),
        ("up_blocks.1.resnets.0", (B, 64, 64, 1920), 1),
        ("up_blocks.1.resnets.1", (B, 64, 64, 1280), 1),
        ("up_blocks.1.resnets.2", (B, 64, 64, 960), 1),
        ("up_blocks.2.resnets.0", (B, 128, 128, 960), 1),
        ("up_blocks.2.resnets.1", (B, 128, 128, 640), 2),
    ]
    for key, shape, count in up_cases:
        x = arr(*shape)
        with ops.use_backends(binding):
            add(f"up-resnet {shape[3]}->{params[key + '.conv1.weight'].shape[-1]} @{shape[1]}",
                count, lambda v, key=key: _resnet(params, key, v, temb, cfg), x)

    # samplers + in/out convs
    with ops.use_backends(binding):
        add("downsample 320@128", 1, lambda v: ops.conv2d(
            v, params["down_blocks.0.downsamplers.0.conv.weight"],
            params["down_blocks.0.downsamplers.0.conv.bias"], stride=2), arr(B, 128, 128, 320))
        add("downsample 640@64", 1, lambda v: ops.conv2d(
            v, params["down_blocks.1.downsamplers.0.conv.weight"],
            params["down_blocks.1.downsamplers.0.conv.bias"], stride=2), arr(B, 64, 64, 640))
        add("conv_in+conv_out", 1, lambda v: ops.conv2d(
            v, params["conv_in.weight"], params["conv_in.bias"]), arr(B, 128, 128, 4))

    total = sum(c * t for _, c, t in rows)
    print(f"--- breakdown ({backend}) ---")
    for label, count, t in sorted(rows, key=lambda r: -r[1] * r[2]):
        print(f"{label:34s} x{count}  {t:8.3f} ms  -> {count * t:8.3f} ms "
              f"({100 * count * t / total:4.1f}%)")
    print(f"modeled step total: {total:.1f} ms ({1000 / total:.2f} it/s)")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "platform")
