"""Fused attention-projection transform: exact numeric parity with unfused."""

import jax.numpy as jnp
import numpy as np

from stabletriton_jax.compile import CompileConfig, compile_unet, fuse_attention_projections
from stabletriton_jax.models.unet import init_unet_params, tiny_unet_config, unet_apply


def test_fused_projections_exact_parity():
    cfg = tiny_unet_config()
    params = init_unet_params(cfg, 0)
    fused = fuse_attention_projections(params)

    # structure: qkv fused for self-attn, kv for cross; originals removed
    some_attn = "down_blocks.1.attentions.0.transformer_blocks.0"
    assert f"{some_attn}.attn1.to_qkv.weight" in fused
    assert f"{some_attn}.attn1.to_q.weight" not in fused
    assert f"{some_attn}.attn2.to_kv.weight" in fused
    assert f"{some_attn}.attn2.to_q.weight" in fused  # q keeps its own input
    # base params untouched
    assert f"{some_attn}.attn1.to_q.weight" in params

    rng = np.random.default_rng(0)
    inputs = (
        jnp.asarray(rng.standard_normal((2, 16, 16, 4), dtype=np.float32)),
        jnp.full((2,), 500.0),
        jnp.asarray(rng.standard_normal((2, 7, cfg.cross_attention_dim), dtype=np.float32)),
        jnp.asarray(rng.standard_normal((2, 16), dtype=np.float32)),
        jnp.zeros((2, 6)),
    )
    a = unet_apply(cfg, params, *inputs)
    b = unet_apply(cfg, fused, *inputs)
    # identical math reassociated only by concatenation -> tight tolerance
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_pipeline_applies_fusion_for_optimized_backend():
    from stabletriton_jax.runtime.pipeline import make_tiny_pipeline

    pipe = make_tiny_pipeline(CompileConfig(dtype="float32"))
    assert any(k.endswith(".to_qkv.weight") for k in pipe.params["unet"])
    ref_pipe = make_tiny_pipeline(CompileConfig(backend="reference", dtype="float32"))
    assert not any(k.endswith(".to_qkv.weight") for k in ref_pipe.params["unet"])
