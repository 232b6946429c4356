"""Guidance-interval CFG (draft knob): apply CFG only inside a sigma window.

Outside the window the loop runs the *conditional branch alone* (half the
UNet batch) — "Applying Guidance in a Limited Interval" (Kynkaanniemi et
al. 2024) semantics. Like the int8 turbo modes this changes sampling
semantics, so it ships opt-in and outside the exactness gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from stabletriton_jax.runtime import scheduler as sched
from stabletriton_jax.runtime.denoise import make_denoise_loop


def _fake_unet(params, sample, t, ctx, text_embeds, time_ids):
    """eps = 0.1*sample + per-batch mean of ctx (so cond/uncond differ)."""
    mu = ctx.mean(axis=(1, 2)).reshape(-1, 1, 1, 1)
    return 0.1 * sample + mu


def _manual_loop(lat, sigmas, mu_u, mu_c, g, lo, hi):
    lat = np.asarray(lat, np.float64)
    for i in range(len(sigmas) - 1):
        s, sn = float(sigmas[i]), float(sigmas[i + 1])
        inp = lat / np.sqrt(s**2 + 1.0)
        if lo <= s <= hi:
            eps_u = 0.1 * inp + mu_u
            eps_c = 0.1 * inp + mu_c
            eps = eps_u + g * (eps_c - eps_u)
        else:
            eps = 0.1 * inp + mu_c
        lat = lat + eps * (sn - s)
    return lat


@pytest.mark.parametrize("interval", [(2.0, 8.0), (0.0, 100.0), (50.0, 60.0)])
def test_interval_semantics_vs_manual(interval):
    sigmas = np.asarray([10.0, 5.0, 1.0, 0.0], np.float32)
    schedule = sched.Schedule(
        timesteps=np.asarray([900.0, 500.0, 100.0], np.float32),
        sigmas=sigmas,
        init_noise_sigma=float(np.sqrt(100.0 + 1.0)),
    )
    g = 3.0
    loop = make_denoise_loop(
        _fake_unet, schedule, guidance_scale=g, solver="euler",
        guidance_interval=interval,
    )
    rng = np.random.default_rng(0)
    lat = jnp.asarray(rng.standard_normal((1, 4, 4, 4)), jnp.float32)
    ctx = jnp.asarray(rng.standard_normal((2, 3, 5)), jnp.float32)
    out = loop({}, lat, ctx, None, None)
    mu_u = float(np.asarray(ctx)[0].mean())
    mu_c = float(np.asarray(ctx)[1].mean())
    want = _manual_loop(lat, sigmas, mu_u, mu_c, g, *interval)
    np.testing.assert_allclose(np.asarray(out), want, atol=1e-5)


def test_full_interval_equals_default():
    """A window covering every sigma must reproduce classic CFG exactly."""
    schedule = sched.make_schedule(sched.SchedulerConfig(), 4)
    rng = np.random.default_rng(1)
    lat = jnp.asarray(rng.standard_normal((2, 4, 4, 4)), jnp.float32)
    ctx = jnp.asarray(rng.standard_normal((4, 3, 5)), jnp.float32)
    base = make_denoise_loop(_fake_unet, schedule, guidance_scale=5.0)
    gated = make_denoise_loop(
        _fake_unet, schedule, guidance_scale=5.0,
        guidance_interval=(0.0, 1e9),
    )
    a = base({}, lat, ctx, None, None)
    b = gated({}, lat, ctx, None, None)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_no_cfg_fast_path_semantics():
    """guidance_scale <= 1 runs the conditional branch alone (diffusers'
    do_classifier_free_guidance convention) — same math as g=1 CFG."""
    sigmas = np.asarray([10.0, 5.0, 1.0, 0.0], np.float32)
    schedule = sched.Schedule(
        timesteps=np.asarray([900.0, 500.0, 100.0], np.float32),
        sigmas=sigmas,
        init_noise_sigma=float(np.sqrt(100.0 + 1.0)),
    )
    rng = np.random.default_rng(2)
    lat = jnp.asarray(rng.standard_normal((1, 4, 4, 4)), jnp.float32)
    ctx = jnp.asarray(rng.standard_normal((2, 3, 5)), jnp.float32)
    loop = make_denoise_loop(_fake_unet, schedule, guidance_scale=1.0)
    out = loop({}, lat, ctx, None, None)
    mu_c = float(np.asarray(ctx)[1].mean())
    # cond-only manual loop == interval never active
    want = _manual_loop(lat, sigmas, 0.0, mu_c, 1.0, -2.0, -1.0)
    np.testing.assert_allclose(np.asarray(out), want, atol=1e-5)


def test_txt2img_no_cfg():
    """guidance_scale=1.0 end-to-end: single-branch UNet, valid output."""
    from stabletriton_jax.runtime.pipeline import make_tiny_pipeline

    pipe = make_tiny_pipeline()
    s = pipe.clip_config.max_position_embeddings
    ids = np.full((1, s), 5, np.int32)
    ids[:, 0] = 1
    ids[:, -1] = 99
    ids = jnp.asarray(ids)
    a = pipe.txt2img(ids, ids, height=32, width=32, steps=3, seed=7,
                     guidance_scale=1.0)
    b = pipe.txt2img(ids, ids, height=32, width=32, steps=3, seed=7,
                     guidance_scale=1.0)
    c = pipe.txt2img(ids, ids, height=32, width=32, steps=3, seed=7,
                     guidance_scale=5.0)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert not np.array_equal(np.asarray(a), np.asarray(c))
    assert np.isfinite(np.asarray(a)).all()


def test_txt2img_guidance_interval():
    """End-to-end: the knob threads through SDXLPipeline's cache + builder."""
    from stabletriton_jax.runtime.pipeline import make_tiny_pipeline

    pipe = make_tiny_pipeline()
    s = pipe.clip_config.max_position_embeddings
    ids = np.full((1, s), 5, np.int32)
    ids[:, 0] = 1
    ids[:, -1] = 99
    ids = jnp.asarray(ids)

    a = pipe.txt2img(ids, ids, height=32, width=32, steps=3, seed=7)
    # window covering all sigmas (init sigma ~14.6) == classic CFG
    b = pipe.txt2img(ids, ids, height=32, width=32, steps=3, seed=7,
                     guidance_interval=(0.0, 1e9))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
    # a mid-range window changes the result but stays valid; distinct cache sig
    c = pipe.txt2img(ids, ids, height=32, width=32, steps=3, seed=7,
                     guidance_interval=(0.3, 5.0))
    assert not np.array_equal(np.asarray(a), np.asarray(c))
    assert np.isfinite(np.asarray(c)).all()
    assert len(pipe.cache_signatures()) == 3
