"""VAE encoder tests (tiny config, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np

from stabletriton_jax.models import vae as vae_mod


def test_encoder_shapes_and_roundtrip():
    cfg = vae_mod.tiny_vae_config()
    enc = vae_mod.init_vae_encoder_params(cfg, 0)
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32))
    lat = vae_mod.vae_encode(cfg, enc, img)
    # tiny vae: 2 levels -> one stride-2 downsample
    assert lat.shape == (2, 8, 8, 4)
    assert np.isfinite(np.asarray(lat)).all()
    # sampled encoding differs from the mean but stays close
    lat_s = vae_mod.vae_encode(cfg, enc, img, rng=jax.random.PRNGKey(0))
    assert not np.allclose(np.asarray(lat), np.asarray(lat_s))
    # decoder accepts encoder output (full autoencoder roundtrip runs)
    dec = vae_mod.init_vae_params(cfg, 1)
    out = vae_mod.vae_decode(cfg, dec, lat)
    assert out.shape == img.shape


def test_sdxl_encoder_param_inventory():
    shapes = vae_mod.vae_encoder_param_shapes(vae_mod.sdxl_vae_config())
    total = sum(int(np.prod(s)) for s in shapes.values())
    # HF SDXL VAE encoder is ~34M params
    assert 3.0e7 < total < 4.0e7, total
    assert shapes["encoder.conv_out.weight"] == (3, 3, 512, 8)
    assert shapes["quant_conv.weight"] == (1, 1, 8, 8)
    assert shapes["encoder.down_blocks.1.resnets.0.conv_shortcut.weight"] == (1, 1, 128, 256)
