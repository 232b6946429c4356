"""UNet structural tests: shapes, jittability, SDXL param-shape parity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stabletriton_jax.compile import CompileConfig, compile_unet
from stabletriton_jax.models.unet import (
    UNetConfig,
    init_unet_params,
    sdxl_base_unet_config,
    tiny_unet_config,
    unet_apply,
    unet_param_shapes,
)


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_unet_config()
    params = init_unet_params(cfg, 0)
    return cfg, params


def tiny_inputs(cfg, b=2, hw=16, seq=7):
    rng = np.random.default_rng(0)
    sample = jnp.asarray(rng.standard_normal((b, hw, hw, cfg.in_channels), dtype=np.float32))
    t = jnp.full((b,), 500.0, jnp.float32)
    ehs = jnp.asarray(rng.standard_normal((b, seq, cfg.cross_attention_dim), dtype=np.float32))
    text_embeds = jnp.asarray(rng.standard_normal((b, 16), dtype=np.float32))
    time_ids = jnp.asarray(rng.standard_normal((b, 6), dtype=np.float32))
    return sample, t, ehs, text_embeds, time_ids


def test_tiny_unet_forward_shape(tiny):
    cfg, params = tiny
    inputs = tiny_inputs(cfg)
    out = unet_apply(cfg, params, *inputs)
    assert out.shape == inputs[0].shape
    assert np.isfinite(np.asarray(out)).all()


def test_tiny_unet_jit_and_determinism(tiny):
    cfg, params = tiny
    inputs = tiny_inputs(cfg)
    fn = compile_unet(cfg, CompileConfig(backend="reference", dtype="float32"))
    out1 = fn(params, *inputs)
    out2 = fn(params, *inputs)
    np.testing.assert_array_equal(np.asarray(out1), np.asarray(out2))
    eager = unet_apply(cfg, params, *inputs)
    np.testing.assert_allclose(np.asarray(out1), np.asarray(eager), atol=1e-5)


def test_sdxl_param_inventory():
    """The SDXL-base param table must match the HF checkpoint's inventory:
    key count and total parameter count of diffusers' UNet2DConditionModel
    (2_567_463_684 params — the well-known 2.57B SDXL-base UNet)."""
    shapes = unet_param_shapes(sdxl_base_unet_config())
    total = sum(int(np.prod(s)) for s in shapes.values())
    assert total == 2_567_463_684, total
    # spot-check signature keys/shapes against the HF state_dict (our layout:
    # linear (in,out), conv HWIO)
    assert shapes["add_embedding.linear_1.weight"] == (2816, 1280)
    assert shapes["conv_in.weight"] == (3, 3, 4, 320)
    assert shapes["down_blocks.2.attentions.1.transformer_blocks.9.attn2.to_k.weight"] == (2048, 1280)
    assert shapes["up_blocks.0.resnets.0.conv_shortcut.weight"] == (1, 1, 2560, 1280)
    assert shapes["mid_block.attentions.0.proj_in.weight"] == (1280, 1280)
    assert shapes["up_blocks.2.resnets.2.norm1.weight"] == (640,)
    assert "down_blocks.0.attentions.0.norm.weight" not in shapes  # DownBlock2D has no attn


def test_skip_concat_channel_bookkeeping():
    """Up-path resnet input channels must equal prev + popped skip channels;
    indirectly validated by the forward running without shape errors for an
    asymmetric config."""
    cfg = UNetConfig(
        block_out_channels=(8, 16, 32),
        down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
        layers_per_block=2,
        transformer_layers_per_block=(1, 1, 2),
        attention_head_dim=8,
        cross_attention_dim=16,
        norm_num_groups=4,
        addition_time_embed_dim=8,
        projection_class_embeddings_input_dim=8 * 6 + 8,
    )
    params = init_unet_params(cfg, 1)
    rng = np.random.default_rng(1)
    sample = jnp.asarray(rng.standard_normal((1, 16, 16, 4), dtype=np.float32))
    out = unet_apply(
        cfg, params, sample, jnp.array([10.0]),
        jnp.zeros((1, 5, 16)), jnp.zeros((1, 8)), jnp.zeros((1, 6)),
    )
    assert out.shape == (1, 16, 16, 4)
