"""Refiner / img2img / two-stage pipeline tests (CPU, tiny configs)."""

import jax.numpy as jnp
import numpy as np
import pytest

from stabletriton_jax.models.unet import (
    init_unet_params,
    sdxl_refiner_unet_config,
    unet_param_shapes,
)
from stabletriton_jax.runtime.pipeline import (
    TwoStageSDXL,
    make_tiny_pipeline,
    make_tiny_refiner_pipeline,
)


def test_refiner_config_structure():
    cfg = sdxl_refiner_unet_config()
    shapes = unet_param_shapes(cfg)
    total = sum(int(np.prod(s)) for s in shapes.values())
    assert 2.2e9 < total < 2.35e9  # ~2.3B refiner UNet
    # conv-only innermost down level, but the mid block still has transformers
    assert "down_blocks.3.attentions.0.norm.weight" not in shapes
    assert "mid_block.attentions.0.transformer_blocks.3.attn1.to_q.weight" in shapes
    assert cfg.mid_transformer_layers == 4
    # refiner conditions on bigG alone
    assert shapes["down_blocks.1.attentions.0.transformer_blocks.0.attn2.to_k.weight"] == (1280, 768)


@pytest.fixture(scope="module")
def refiner():
    return make_tiny_refiner_pipeline()


def _ids(b=1):
    ids = np.full((b, 16), 5, np.int32)
    ids[:, -1] = 99
    return jnp.asarray(ids)


def test_img2img_refine(refiner):
    rng = np.random.default_rng(0)
    latents = jnp.asarray(rng.standard_normal((1, 4, 4, 4), dtype=np.float32))
    img = refiner.img2img(latents, None, _ids(), steps=4, strength=0.5, seed=3)
    assert img.shape == (1, 8, 8, 3)  # decode upsamples 4x4 latents once (x2)
    assert np.isfinite(np.asarray(img)).all()


def test_img2img_strength_truncates_schedule(refiner):
    rng = np.random.default_rng(1)
    latents = jnp.asarray(rng.standard_normal((1, 4, 4, 4), dtype=np.float32))
    refiner.img2img(latents, None, _ids(), steps=8, strength=0.25, seed=0, decode=False)
    sigs = [s for s in refiner.cache_signatures() if s[0] == "i2i"]
    # strength 0.25 of 8 steps -> start index 6 (2 steps run)
    assert any(s[4] == 8 and s[5] == 6 for s in sigs)


def test_two_stage_pipeline():
    base = make_tiny_pipeline()
    refiner = make_tiny_refiner_pipeline()
    two = TwoStageSDXL(base=base, refiner=refiner)
    ids = _ids()
    img = two.txt2img(ids, ids, height=32, width=32, steps=3, refiner_strength=0.34)
    # base latents are 16x16 (tiny vae factor 2); refiner decode doubles them
    assert img.shape == (1, 32, 32, 3)
    assert np.isfinite(np.asarray(img)).all()


def test_img2img_from_image():
    from stabletriton_jax.models import vae as vae_mod
    from stabletriton_jax.runtime.pipeline import make_tiny_pipeline

    pipe = make_tiny_pipeline()
    vae = dict(pipe.params["vae"])
    vae.update(vae_mod.init_vae_encoder_params(pipe.vae_config, 9))
    pipe.params["vae"] = vae
    rng = np.random.default_rng(3)
    img_in = jnp.asarray(rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32))
    ids = _ids()
    out = pipe.img2img_image(img_in, ids, ids, steps=3, strength=0.6, seed=1)
    assert out.shape == (1, 32, 32, 3)
    assert np.isfinite(np.asarray(out)).all()


def test_img2img_image_requires_encoder():
    from stabletriton_jax.runtime.pipeline import make_tiny_pipeline
    import pytest as _pytest

    pipe = make_tiny_pipeline()
    with _pytest.raises(ValueError, match="encoder"):
        pipe.img2img_image(jnp.zeros((1, 32, 32, 3)), _ids(), _ids(), steps=2)
