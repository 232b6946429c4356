"""SD1.x/2.x model-family tests: configs, forward, single-encoder pipeline."""

import jax.numpy as jnp
import numpy as np

from stabletriton_jax.models.unet import (
    init_unet_params,
    sd15_unet_config,
    sd21_unet_config,
    unet_apply,
    unet_param_shapes,
)
from stabletriton_jax.runtime.pipeline import make_tiny_sd15_pipeline


def test_sd15_param_inventory():
    shapes = unet_param_shapes(sd15_unet_config())
    total = sum(int(np.prod(s)) for s in shapes.values())
    assert total == 859_520_964  # the known SD1.5 UNet parameter count
    assert "add_embedding.linear_1.weight" not in shapes
    assert shapes["down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k.weight"] == (768, 320)


def test_sd21_param_inventory():
    shapes = unet_param_shapes(sd21_unet_config())
    total = sum(int(np.prod(s)) for s in shapes.values())
    assert total == 865_910_724  # the known SD2.1 UNet parameter count


def test_sd15_style_forward_no_added_conditioning():
    cfg = make_tiny_sd15_pipeline().unet_config
    params = init_unet_params(cfg, 0)
    rng = np.random.default_rng(0)
    out = unet_apply(
        cfg, params,
        jnp.asarray(rng.standard_normal((1, 16, 16, 4), dtype=np.float32)),
        jnp.array([500.0]),
        jnp.asarray(rng.standard_normal((1, 7, cfg.cross_attention_dim), dtype=np.float32)),
        jnp.zeros((1, 0)),   # no pooled conditioning
        jnp.zeros((1, 0)),   # no time_ids
    )
    assert out.shape == (1, 16, 16, 4)
    assert np.isfinite(np.asarray(out)).all()


def test_sd15_pipeline_txt2img():
    pipe = make_tiny_sd15_pipeline()
    ids = np.full((1, 16), 5, np.int32)
    ids[:, -1] = 99
    img = pipe.txt2img(jnp.asarray(ids), jnp.asarray(ids), height=32, width=32,
                       steps=2, seed=3)
    assert img.shape == (1, 32, 32, 3)
    assert np.isfinite(np.asarray(img)).all()


def test_sd21_clip_skip_changes_output():
    a = make_tiny_sd15_pipeline()
    ids = np.full((1, 16), 5, np.int32)
    ids[:, -1] = 99
    img1 = a.txt2img(jnp.asarray(ids), jnp.asarray(ids), height=32, width=32, steps=2)
    b = make_tiny_sd15_pipeline()
    b.clip_skip = 2
    img2 = b.txt2img(jnp.asarray(ids), jnp.asarray(ids), height=32, width=32, steps=2)
    assert not np.allclose(np.asarray(img1), np.asarray(img2))


def test_sd15_pipeline_img2img():
    """SD1.x img2img must work (round-1 bug: `5 * None` TypeError computing
    five_ids for configs with addition_time_embed_dim=None)."""
    pipe = make_tiny_sd15_pipeline()
    ids = np.full((1, 16), 5, np.int32)
    ids[:, -1] = 99
    rng = np.random.default_rng(1)
    latents = jnp.asarray(rng.standard_normal((1, 4, 4, 4), dtype=np.float32))
    img = pipe.img2img(latents, jnp.asarray(ids), jnp.asarray(ids),
                       steps=4, strength=0.5, seed=7)
    assert img.shape == (1, 8, 8, 3)  # tiny VAE: spatial_scale_factor == 2
    assert np.isfinite(np.asarray(img)).all()
    # single-ids convention (ids1=None) also works
    lat = pipe.img2img(latents, None, jnp.asarray(ids), steps=4, strength=0.5,
                       decode=False)
    assert lat.shape == latents.shape


def test_sd15_config_from_diffusers_dict():
    from stabletriton_jax.io.torch_ingest import unet_config_from_diffusers

    # the relevant subset of runwayml/stable-diffusion-v1-5 unet/config.json
    cfg = unet_config_from_diffusers({
        "in_channels": 4, "out_channels": 4,
        "block_out_channels": [320, 640, 1280, 1280],
        "down_block_types": ["CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
                             "CrossAttnDownBlock2D", "DownBlock2D"],
        "layers_per_block": 2, "attention_head_dim": 8,
        "cross_attention_dim": 768, "addition_embed_type": None,
    })
    assert cfg.fixed_num_heads == 8
    assert not cfg.has_addition_embedding
    assert cfg.num_heads(320) == 8 and cfg.num_heads(1280) == 8
    total = sum(int(np.prod(s)) for s in unet_param_shapes(cfg).values())
    assert total == 859_520_964
