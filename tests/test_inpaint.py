"""Inpainting pipeline test (tiny 9-channel UNet, CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest

from stabletriton_jax.compile import CompileConfig
from stabletriton_jax.models import clip as clip_mod
from stabletriton_jax.models import vae as vae_mod
from stabletriton_jax.models.unet import UNetConfig, init_unet_params
from stabletriton_jax.runtime.pipeline import SDXLPipeline, make_tiny_pipeline


def _tiny_inpaint_pipeline():
    base = make_tiny_pipeline()
    ucfg = UNetConfig(
        in_channels=9,  # 4 noisy + 1 mask + 4 masked-image latents
        block_out_channels=base.unet_config.block_out_channels,
        down_block_types=base.unet_config.down_block_types,
        layers_per_block=base.unet_config.layers_per_block,
        transformer_layers_per_block=base.unet_config.transformer_layers_per_block,
        attention_head_dim=base.unet_config.attention_head_dim,
        cross_attention_dim=base.unet_config.cross_attention_dim,
        norm_num_groups=base.unet_config.norm_num_groups,
        addition_time_embed_dim=base.unet_config.addition_time_embed_dim,
        projection_class_embeddings_input_dim=base.unet_config.projection_class_embeddings_input_dim,
    )
    params = dict(base.params)
    params["unet"] = init_unet_params(ucfg, 5)
    vae = dict(params["vae"])
    vae.update(vae_mod.init_vae_encoder_params(base.vae_config, 6))
    params["vae"] = vae
    return SDXLPipeline(
        unet_config=ucfg, clip_config=base.clip_config,
        clip2_config=base.clip2_config, vae_config=base.vae_config,
        params=params, compile_config=CompileConfig(backend="reference", dtype="float32"),
    )


def test_inpaint_end_to_end():
    pipe = _tiny_inpaint_pipeline()
    rng = np.random.default_rng(0)
    b, hw = 1, 32
    image = jnp.asarray(rng.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32))
    mask = jnp.zeros((b, hw, hw, 1)).at[:, 8:24, 8:24].set(1.0)
    ids = np.full((b, 16), 5, np.int32)
    ids[:, -1] = 99
    out = pipe.inpaint(image, mask, jnp.asarray(ids), jnp.asarray(ids), steps=2)
    assert out.shape == image.shape
    assert np.isfinite(np.asarray(out)).all()


def test_inpaint_rejects_non_inpaint_unet():
    pipe = make_tiny_pipeline()
    with pytest.raises(ValueError, match="9-channel"):
        pipe.inpaint(
            jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 32, 32, 1)),
            jnp.zeros((1, 16), jnp.int32), jnp.zeros((1, 16), jnp.int32),
        )
