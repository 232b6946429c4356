"""End-to-end pipeline tests on the tiny model stack (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest

from stabletriton_jax.models import clip as clip_mod
from stabletriton_jax.models import vae as vae_mod
from stabletriton_jax.runtime.pipeline import make_tiny_pipeline


@pytest.fixture(scope="module")
def pipe():
    return make_tiny_pipeline()


def _ids(pipe, b=1):
    s = pipe.clip_config.max_position_embeddings
    ids = np.full((b, s), 5, np.int32)
    ids[:, 0] = 1
    ids[:, -1] = 99  # eos
    return jnp.asarray(ids), jnp.asarray(ids.copy())


def test_clip_shapes(pipe):
    ids1, ids2 = _ids(pipe, 2)
    pen, final, pooled = clip_mod.clip_apply(
        pipe.clip2_config, pipe.params["text_encoder_2"], ids2
    )
    d = pipe.clip2_config.hidden_size
    assert pen.shape == (2, 16, d)
    assert final.shape == (2, 16, d)
    assert pooled.shape == (2, pipe.clip2_config.projection_dim)
    ctx, pooled2 = clip_mod.encode_sdxl_prompts(
        pipe.clip_config, pipe.params["text_encoder"],
        pipe.clip2_config, pipe.params["text_encoder_2"],
        ids1, ids2,
    )
    assert ctx.shape == (2, 16, pipe.unet_config.cross_attention_dim)
    assert pooled2.shape == (2, 16)


def test_clip_causality(pipe):
    """Changing a later token must not affect earlier positions' features."""
    ids1, _ = _ids(pipe, 1)
    pen_a, _, _ = clip_mod.clip_apply(pipe.clip_config, pipe.params["text_encoder"], ids1)
    ids_b = np.asarray(ids1).copy()
    ids_b[:, 10] = 7  # mutate a later token
    pen_b, _, _ = clip_mod.clip_apply(
        pipe.clip_config, pipe.params["text_encoder"], jnp.asarray(ids_b)
    )
    np.testing.assert_allclose(
        np.asarray(pen_a)[:, :10], np.asarray(pen_b)[:, :10], atol=1e-5
    )
    assert not np.allclose(np.asarray(pen_a)[:, 10:], np.asarray(pen_b)[:, 10:])


def test_vae_decode_shape(pipe):
    rng = np.random.default_rng(0)
    lat = jnp.asarray(rng.standard_normal((1, 8, 8, 4), dtype=np.float32))
    img = vae_mod.vae_decode(pipe.vae_config, pipe.params["vae"], lat)
    # tiny vae has 2 levels -> one 2x upsample
    assert img.shape == (1, 16, 16, 3)
    assert np.isfinite(np.asarray(img)).all()


def test_txt2img_end_to_end(pipe):
    ids1, ids2 = _ids(pipe)
    img = pipe.txt2img(ids1, ids2, height=32, width=32, steps=3, seed=7)
    # tiny vae scale factor is 2 -> latents 16x16 -> output back at 32x32
    assert img.shape == (1, 32, 32, 3)
    assert np.isfinite(np.asarray(img)).all()
    assert np.asarray(img).min() >= -1.0 and np.asarray(img).max() <= 1.0


def test_txt2img_determinism_and_seed_sensitivity(pipe):
    ids1, ids2 = _ids(pipe)
    a = pipe.txt2img(ids1, ids2, height=32, width=32, steps=2, seed=1)
    b = pipe.txt2img(ids1, ids2, height=32, width=32, steps=2, seed=1)
    c = pipe.txt2img(ids1, ids2, height=32, width=32, steps=2, seed=2)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert not np.array_equal(np.asarray(a), np.asarray(c))


def test_jit_cache_signatures(pipe):
    ids1, ids2 = _ids(pipe)
    pipe.txt2img(ids1, ids2, height=32, width=32, steps=2, seed=0)
    pipe.txt2img(ids1, ids2, height=32, width=32, steps=2, seed=3)  # cache hit
    n = len(pipe.cache_signatures())
    pipe.txt2img(ids1, ids2, height=32, width=32, steps=2, seed=9)  # cache hit
    assert len(pipe.cache_signatures()) == n
    pipe.txt2img(ids1, ids2, height=32, width=32, steps=4, seed=0)  # new sig
    assert len(pipe.cache_signatures()) == n + 1


def test_warmup_precompiles_signature(pipe):
    """warmup() AOT-compiles a signature without generating; the later real
    request reuses the cached program entry (serving cold-start path)."""
    pipe.warmup(batch=1, height=32, width=32, steps=5)
    n = len(pipe.cache_signatures())
    assert any(s[3] == 5 for s in pipe.cache_signatures())
    ids1, ids2 = _ids(pipe)
    img = pipe.txt2img(ids1, ids2, height=32, width=32, steps=5, seed=3)
    assert len(pipe.cache_signatures()) == n  # no new program entry
    assert img.shape == (1, 32, 32, 3)
    assert np.isfinite(np.asarray(img)).all()


def test_txt2img_latents_path(pipe):
    ids1, ids2 = _ids(pipe)
    lat = pipe.txt2img(ids1, ids2, height=32, width=32, steps=2, seed=0,
                       return_latents=True)
    assert lat.shape == (1, 16, 16, 4)


def test_txt2img_multi_resolution(pipe):
    """Non-square and different resolutions compile and run (multi-res serving)."""
    ids1, ids2 = _ids(pipe)
    img = pipe.txt2img(ids1, ids2, height=48, width=32, steps=2, seed=0)
    assert img.shape == (1, 48, 32, 3)


def test_txt2img_rejects_bad_resolution(pipe):
    import pytest as _pytest

    ids1, ids2 = _ids(pipe)
    with _pytest.raises(ValueError, match="multiples"):
        pipe.txt2img(ids1, ids2, height=30, width=32, steps=2)


def test_long_prompt_chunking(pipe):
    """ids wider than max_position_embeddings encode as 77-token windows and
    the UNet cross-attends over the full concatenated sequence."""
    from stabletriton_jax.models import clip as clip_mod

    mp = pipe.clip_config.max_position_embeddings
    ids = np.full((1, mp * 2), 5, np.int32)
    ids[:, mp - 1] = 99
    ids[:, -1] = 99
    pen, final, _ = clip_mod.clip_apply_chunked(
        pipe.clip_config, pipe.params["text_encoder"], jnp.asarray(ids)
    )
    assert pen.shape == (1, 2 * mp, pipe.clip_config.hidden_size)
    # first window must equal the standalone encoding of the same window
    pen1, _, _ = clip_mod.clip_apply(
        pipe.clip_config, pipe.params["text_encoder"], jnp.asarray(ids[:, :mp])
    )
    np.testing.assert_allclose(np.asarray(pen[:, :mp]), np.asarray(pen1), atol=1e-5)

    # end-to-end: long prompts run through txt2img
    img = pipe.txt2img(jnp.asarray(ids), jnp.asarray(ids),
                       height=32, width=32, steps=2, seed=0)
    assert img.shape == (1, 32, 32, 3)


def test_empty_prompt_ids_structure():
    """Default negative prompt == tokenization of "" (BOS, EOS, pad), per
    77-token window, honoring each encoder's pad convention."""
    from stabletriton_jax.models import clip as clip_mod

    c1 = clip_mod.sdxl_text_encoder_config()
    ids = c1.empty_prompt_ids(2, 154)
    assert ids.shape == (2, 154)
    assert ids[0, 0] == 49406 and ids[0, 77] == 49406   # BOS each window
    assert ids[0, 1] == 49407 and ids[0, 78] == 49407   # EOS each window
    assert ids[0, 2] == 49407                           # enc-1 pads with EOS
    c2 = clip_mod.sdxl_text_encoder_2_config()
    ids2 = c2.empty_prompt_ids(1)
    assert ids2[0, 0] == 49406 and ids2[0, 1] == 49407
    assert (ids2[0, 2:] == 0).all()                     # enc-2 pads with 0


def test_default_negative_is_empty_prompt(pipe):
    """txt2img with neg=None must equal explicit empty-prompt negatives, and
    differ from the round-1 all-zeros default (EOS argmax mis-pooling)."""
    mp = pipe.clip_config.max_position_embeddings
    ids = np.full((1, mp), 5, np.int32)
    ids[:, -1] = 99
    ids = jnp.asarray(ids)
    empty1 = jnp.asarray(pipe.clip_config.empty_prompt_ids(1, mp))
    empty2 = jnp.asarray(pipe.clip2_config.empty_prompt_ids(1, mp))
    a = pipe.txt2img(ids, ids, height=32, width=32, steps=2, seed=0)
    b = pipe.txt2img(ids, ids, neg_ids1=empty1, neg_ids2=empty2,
                     height=32, width=32, steps=2, seed=0)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
    z = pipe.txt2img(ids, ids, neg_ids1=jnp.zeros_like(ids),
                     neg_ids2=jnp.zeros_like(ids),
                     height=32, width=32, steps=2, seed=0)
    assert not np.allclose(np.asarray(a), np.asarray(z))
