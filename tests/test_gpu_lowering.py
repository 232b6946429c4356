"""GPU lowering gate on a CPU host: ``jax.export(..., platforms=["cuda"])``.

The default-binding programs (UNet step at the entry and 1024² shapes, the
cross-K/V precompute, the DeepCache pair, the VAE decode, whole txt2img) must
lower to StableHLO for CUDA with no platform-specific custom call. cuDNN
attention cannot lower without a card ("cuDNN is not detected"), so here the
attention ops take their XLA composition; ``chip_smoke.py`` phase 3 checks
cuDNN attention on the card.
"""

import jax
import jax.numpy as jnp
import pytest
from jax import export

from stabletriton_jax import ops
from stabletriton_jax.compile import (
    CompileConfig,
    compile_unet,
    compile_unet_deepcache,
    compile_unet_kv,
    fuse_attention_projections,
    resolve_binding,
)
from stabletriton_jax.models import clip as clip_mod
from stabletriton_jax.models import vae as vae_mod
from stabletriton_jax.models.unet import init_unet_params, sdxl_base_unet_config
from stabletriton_jax.runtime.pipeline import SDXLPipeline, make_tiny_pipeline

S = jax.ShapeDtypeStruct
BF16 = jnp.bfloat16

# the GPU platform binding, minus the cuDNN attention a CPU host cannot lower
GPU_BINDING = {
    op: ("reference" if backend == "cudnn" else backend)
    for op, backend in resolve_binding(CompileConfig(), platform="gpu").items()
}


def _export_cuda(fn, *args):
    """Trace under the GPU binding (the compiled programs' own binding is the
    CPU one here, which adds nothing on top) and export for CUDA."""
    with ops.use_backends(GPU_BINDING):
        exp = export.export(jax.jit(fn), platforms=["cuda"])(*args)
    text = exp.mlir_module()
    assert exp.platforms == ("cuda",)
    assert "custom_call" not in text, "platform-specific custom call"
    return text


@pytest.fixture(scope="module")
def sdxl():
    cfg = sdxl_base_unet_config()
    params = jax.eval_shape(
        lambda: fuse_attention_projections(init_unet_params(cfg, 0, dtype=BF16)))
    return cfg, params


def _step_args(lat, b=2):
    return (S((b, lat, lat, 4), BF16), S((b,), jnp.float32),
            S((b, 77, 2048), BF16), S((b, 1280), BF16), S((b, 6), jnp.float32))


@pytest.mark.parametrize("lat", [64, 128], ids=["entry-512", "1024"])
def test_unet_kv_step_exports_for_cuda(sdxl, lat):
    cfg, params = sdxl
    pre, _pre_t, step = compile_unet_kv(cfg, CompileConfig())
    sample, t, ehs, te, tid = _step_args(lat)
    kv = jax.eval_shape(pre, params, ehs)
    text = _export_cuda(step, params, sample, t, kv, te, tid)
    assert "stablehlo.convolution" in text


def test_unet_step_exports_for_cuda(sdxl):
    cfg, params = sdxl
    fn = compile_unet(cfg, CompileConfig())
    assert "stablehlo.convolution" in _export_cuda(fn, params, *_step_args(64))


def test_cross_kv_precompute_exports_for_cuda(sdxl):
    cfg, params = sdxl
    pre, _pre_t, _step = compile_unet_kv(cfg, CompileConfig())
    _export_cuda(pre, params, S((2, 77, 2048), BF16))


def test_deepcache_pair_exports_for_cuda(sdxl):
    cfg, params = sdxl
    full, shallow = compile_unet_deepcache(cfg, CompileConfig())
    args = _step_args(64)
    _eps, cache = jax.eval_shape(full, params, *args)
    _export_cuda(full, params, *args)
    _export_cuda(shallow, params, *args, cache)


def test_vae_decode_exports_for_cuda():
    vcfg = vae_mod.sdxl_vae_config()
    params = jax.eval_shape(lambda: vae_mod.init_vae_params(vcfg, 0))
    text = _export_cuda(lambda p, z: vae_mod.vae_decode(vcfg, p, z), params,
                        S((1, 128, 128, 4), jnp.float32))
    assert "stablehlo.convolution" in text


def _txt2img_args(pipe, batch):
    mp1 = pipe.clip_config.max_position_embeddings
    mp2 = pipe.clip2_config.max_position_embeddings
    return (S((batch, mp1), jnp.int32), S((batch, mp2), jnp.int32),
            S((batch, mp1), jnp.int32), S((batch, mp2), jnp.int32),
            S((batch,), jnp.uint32))


def test_tiny_txt2img_program_exports_for_cuda():
    pipe = make_tiny_pipeline(CompileConfig(dtype="bfloat16"))
    fn = pipe._txt2img_program(2, 32, 32, 2, 5.0, "euler", False, None, None)
    params = jax.tree.map(lambda a: S(a.shape, a.dtype), pipe.params)
    _export_cuda(fn, params, *_txt2img_args(pipe, 2))


def test_sdxl_txt2img_program_exports_for_cuda(sdxl):
    cfg, unet_params = sdxl
    c1 = clip_mod.sdxl_text_encoder_config()
    c2 = clip_mod.sdxl_text_encoder_2_config()
    vcfg = vae_mod.sdxl_vae_config()
    params = {
        "unet": unet_params,
        "text_encoder": jax.eval_shape(lambda: clip_mod.init_clip_params(c1, 1)),
        "text_encoder_2": jax.eval_shape(lambda: clip_mod.init_clip_params(c2, 2)),
        "vae": jax.eval_shape(lambda: vae_mod.init_vae_params(vcfg, 3)),
    }
    pipe = SDXLPipeline(unet_config=cfg, clip_config=c1, clip2_config=c2,
                        vae_config=vcfg, params=params)
    fn = pipe._txt2img_program(1, 1024, 1024, 2, 5.0, "euler", False, None, None)
    _export_cuda(fn, pipe.params, *_txt2img_args(pipe, 1))
