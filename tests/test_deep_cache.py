"""DeepCache draft mode (Ma et al. 2023): full UNet every N-th step, only
the outermost level (splicing a carried deep-feature cache) in between.

Three layers under test: the model split (unet_apply return_cache /
unet_apply_shallow — bit-parity when the cache comes from the same inputs),
the loop semantics (make_denoise_loop deep_cache vs a manual mirror), and
the pipeline surface (txt2img(deep_cache=N)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stabletriton_jax.models.unet import (
    deep_cache_shape,
    init_unet_params,
    tiny_unet_config,
    unet_apply,
    unet_apply_shallow,
)
from stabletriton_jax.runtime import scheduler as sched
from stabletriton_jax.runtime.denoise import make_denoise_loop


def _tiny_inputs(b=2, hw=16, seed=0):
    cfg = tiny_unet_config()
    params = init_unet_params(cfg, 7)
    rng = np.random.default_rng(seed)
    sample = jnp.asarray(rng.standard_normal((b, hw, hw, 4)), jnp.float32)
    t = jnp.full((b,), 400.0, jnp.float32)
    ctx = jnp.asarray(
        rng.standard_normal((b, 7, cfg.cross_attention_dim)), jnp.float32)
    te = jnp.asarray(rng.standard_normal((b, 16)), jnp.float32)
    tid = jnp.asarray(np.tile([hw * 2, hw * 2, 0, 0, hw * 2, hw * 2], (b, 1)),
                      jnp.float32)
    return cfg, params, sample, t, ctx, te, tid


def test_shallow_parity_with_full_pass():
    """shallow(cache from a full pass on identical inputs) == that pass."""
    cfg, params, sample, t, ctx, te, tid = _tiny_inputs()
    eps_full, cache = unet_apply(cfg, params, sample, t, ctx, te, tid,
                                 return_cache=True)
    assert cache.shape == deep_cache_shape(cfg, sample.shape[0],
                                           sample.shape[1], sample.shape[2])
    eps_shallow = unet_apply_shallow(cfg, params, sample, t, ctx, te, tid,
                                     cache)
    np.testing.assert_allclose(np.asarray(eps_shallow), np.asarray(eps_full),
                               atol=1e-6)


def test_shallow_parity_depth2():
    """cache_depth=2 on a 3-level UNet: the split point moves one level
    deeper (shallow pass keeps the middle level's attention live)."""
    from stabletriton_jax.models.unet import UNetConfig

    cfg = UNetConfig(
        block_out_channels=(32, 48, 64),
        down_block_types=("DownBlock2D", "CrossAttnDownBlock2D",
                          "CrossAttnDownBlock2D"),
        layers_per_block=1,
        transformer_layers_per_block=(1, 1, 1),
        attention_head_dim=16,
        cross_attention_dim=32,
        norm_num_groups=8,
        addition_time_embed_dim=8,
        projection_class_embeddings_input_dim=8 * 6 + 16,
    )
    params = init_unet_params(cfg, 5)
    rng = np.random.default_rng(9)
    b, hw = 2, 16
    sample = jnp.asarray(rng.standard_normal((b, hw, hw, 4)), jnp.float32)
    t = jnp.full((b,), 300.0, jnp.float32)
    ctx = jnp.asarray(rng.standard_normal((b, 7, 32)), jnp.float32)
    te = jnp.asarray(rng.standard_normal((b, 16)), jnp.float32)
    tid = jnp.asarray(np.tile([hw * 2, hw * 2, 0, 0, hw * 2, hw * 2], (b, 1)),
                      jnp.float32)
    for depth in (1, 2):
        eps_full, cache = unet_apply(cfg, params, sample, t, ctx, te, tid,
                                     return_cache=True, cache_depth=depth)
        assert cache.shape == deep_cache_shape(cfg, b, hw, hw, depth)
        eps_shallow = unet_apply_shallow(cfg, params, sample, t, ctx, te,
                                         tid, cache, cache_depth=depth)
        np.testing.assert_allclose(np.asarray(eps_shallow),
                                   np.asarray(eps_full), atol=1e-6)


def test_txt2img_deep_cache_tuple_form():
    """deep_cache=(N, 1) is the same knob as deep_cache=N (shared program)."""
    from stabletriton_jax.runtime.pipeline import make_tiny_pipeline

    pipe = make_tiny_pipeline()
    s = pipe.clip_config.max_position_embeddings
    ids = np.full((1, s), 5, np.int32)
    ids[:, 0] = 1
    ids[:, -1] = 99
    ids = jnp.asarray(ids)
    a = pipe.txt2img(ids, ids, height=32, width=32, steps=3, seed=7,
                     deep_cache=2)
    n = len(pipe.cache_signatures())
    b = pipe.txt2img(ids, ids, height=32, width=32, steps=3, seed=7,
                     deep_cache=(2, 1))
    assert len(pipe.cache_signatures()) == n  # cache hit, not a new program
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_shallow_reuses_stale_cache():
    """A cache from a different timestep gives a different (finite) eps —
    the DeepCache approximation, not a crash or a silent zero."""
    cfg, params, sample, t, ctx, te, tid = _tiny_inputs()
    eps_full, cache = unet_apply(cfg, params, sample, t, ctx, te, tid,
                                 return_cache=True)
    t2 = jnp.full_like(t, 800.0)
    eps_stale = unet_apply_shallow(cfg, params, sample, t2, ctx, te, tid,
                                   cache)
    assert np.isfinite(np.asarray(eps_stale)).all()
    assert not np.allclose(np.asarray(eps_stale), np.asarray(eps_full))


def _fake_pair():
    """(full_fn, shallow_fn) with analytically mirrorable semantics.
    eps = 0.1*inp + mean(ctx per sample); full refreshes cache := inp,
    shallow adds 0.01*cache."""

    def mu(ctx):
        return ctx.mean(axis=(1, 2)).reshape(-1, 1, 1, 1)

    def full_fn(params, inp, t, ctx, te, tid, tc=None):
        return 0.1 * inp + mu(ctx), inp

    def shallow_fn(params, inp, t, ctx, te, tid, tc, cache):
        return 0.1 * inp + mu(ctx) + 0.01 * cache

    return full_fn, shallow_fn


@pytest.mark.parametrize("interval", [1, 2, 3])
def test_loop_semantics_vs_manual(interval):
    sig = np.asarray([10.0, 6.0, 3.0, 1.0, 0.0], np.float32)
    schedule = sched.Schedule(
        timesteps=np.asarray([900.0, 700.0, 400.0, 100.0], np.float32),
        sigmas=sig,
        init_noise_sigma=float(np.sqrt(100.0 + 1.0)),
    )
    g = 3.0
    full_fn, shallow_fn = _fake_pair()

    def plain_unet(params, inp, t, ctx, te, tid, tc=None):
        return full_fn(params, inp, t, ctx, te, tid, tc)[0]

    rng = np.random.default_rng(3)
    lat = jnp.asarray(rng.standard_normal((1, 4, 4, 4)), jnp.float32)
    ctx = jnp.asarray(rng.standard_normal((2, 3, 5)), jnp.float32)
    loop = make_denoise_loop(
        plain_unet, schedule, guidance_scale=g,
        deep_cache=(interval, full_fn, shallow_fn, (4, 4, 4)),
    )
    out = loop({}, lat, ctx, None, None)

    # manual mirror
    mu = np.asarray(ctx).mean(axis=(1, 2)).reshape(-1, 1, 1, 1)
    cur = np.asarray(lat, np.float64)
    cache = np.zeros((2, 4, 4, 4))
    for i in range(len(sig) - 1):
        s, sn = float(sig[i]), float(sig[i + 1])
        inp = cur / np.sqrt(s**2 + 1.0)
        inp2 = np.concatenate([inp, inp], axis=0)
        if i % interval == 0:
            eps2 = 0.1 * inp2 + mu
            cache = inp2
        else:
            eps2 = 0.1 * inp2 + mu + 0.01 * cache
        eps = eps2[:1] + g * (eps2[1:] - eps2[:1])
        cur = cur + eps * (sn - s)
    np.testing.assert_allclose(np.asarray(out), cur, atol=1e-5)


def test_loop_interval_one_matches_baseline():
    """interval=1 == full UNet every step == the classic CFG loop."""
    schedule = sched.make_schedule(sched.SchedulerConfig(), 4)
    full_fn, shallow_fn = _fake_pair()

    def plain_unet(params, inp, t, ctx, te, tid, tc=None):
        return full_fn(params, inp, t, ctx, te, tid, tc)[0]

    rng = np.random.default_rng(4)
    lat = jnp.asarray(rng.standard_normal((1, 4, 4, 4)), jnp.float32)
    ctx = jnp.asarray(rng.standard_normal((2, 3, 5)), jnp.float32)
    base = make_denoise_loop(plain_unet, schedule, guidance_scale=5.0)
    dc = make_denoise_loop(plain_unet, schedule, guidance_scale=5.0,
                           deep_cache=(1, full_fn, shallow_fn, (4, 4, 4)))
    np.testing.assert_allclose(
        np.asarray(dc({}, lat, ctx, None, None)),
        np.asarray(base({}, lat, ctx, None, None)), atol=1e-6)


@pytest.mark.parametrize("interval,window", [
    (2, (2.0, 8.0)),    # mixed: in/out-of-window full and shallow steps
    (3, (0.0, 100.0)),  # window covers everything == plain deep_cache
    (2, (50.0, 60.0)),  # window never active == cond-only deep_cache
])
def test_deep_cache_composes_guidance_interval(interval, window):
    """deep_cache x guidance_interval vs a manual mirror: outside the window
    only the cond branch runs; a full step there refreshes only the cond
    half of the carried cache (the uncond half stays stale)."""
    sig = np.asarray([10.0, 6.0, 3.0, 1.0, 0.0], np.float32)
    schedule = sched.Schedule(
        timesteps=np.asarray([900.0, 700.0, 400.0, 100.0], np.float32),
        sigmas=sig,
        init_noise_sigma=float(np.sqrt(100.0 + 1.0)),
    )
    g = 3.0
    lo, hi = window
    full_fn, shallow_fn = _fake_pair()

    def plain_unet(params, inp, t, ctx, te, tid, tc=None):
        return full_fn(params, inp, t, ctx, te, tid, tc)[0]

    rng = np.random.default_rng(5)
    lat = jnp.asarray(rng.standard_normal((1, 4, 4, 4)), jnp.float32)
    ctx = jnp.asarray(rng.standard_normal((2, 3, 5)), jnp.float32)
    loop = make_denoise_loop(
        plain_unet, schedule, guidance_scale=g, guidance_interval=window,
        deep_cache=(interval, full_fn, shallow_fn, (4, 4, 4)),
    )
    out = loop({}, lat, ctx, None, None)

    # manual mirror
    mu = np.asarray(ctx).mean(axis=(1, 2)).reshape(-1, 1, 1, 1)
    cur = np.asarray(lat, np.float64)
    cache = np.zeros((2, 4, 4, 4))
    for i in range(len(sig) - 1):
        s, sn = float(sig[i]), float(sig[i + 1])
        inp = cur / np.sqrt(s**2 + 1.0)
        full = i % interval == 0
        if lo <= s <= hi:
            inp2 = np.concatenate([inp, inp], axis=0)
            if full:
                eps2 = 0.1 * inp2 + mu
                cache = inp2
            else:
                eps2 = 0.1 * inp2 + mu + 0.01 * cache
            eps = eps2[:1] + g * (eps2[1:] - eps2[:1])
        else:
            if full:
                eps = 0.1 * inp + mu[1:]
                cache = np.concatenate([cache[:1], inp], axis=0)
            else:
                eps = 0.1 * inp + mu[1:] + 0.01 * cache[1:]
        cur = cur + eps * (sn - s)
    np.testing.assert_allclose(np.asarray(out), cur, atol=1e-5)


@pytest.mark.parametrize("solver", ["euler", "heun", "dpmpp_2m", "euler_a"])
def test_deep_cache_guidance_interval_every_solver(solver):
    """The composed knobs through SDXLPipeline for every solver: an
    all-covering window + interval=1 equals the exact path; a real window +
    interval=2 runs, differs, and stays finite."""
    from stabletriton_jax.runtime.pipeline import make_tiny_pipeline

    pipe = make_tiny_pipeline()
    s = pipe.clip_config.max_position_embeddings
    ids = np.full((1, s), 5, np.int32)
    ids[:, 0] = 1
    ids[:, -1] = 99
    ids = jnp.asarray(ids)
    kw = dict(height=32, width=32, steps=3, seed=7, solver=solver)
    base = pipe.txt2img(ids, ids, **kw)
    both1 = pipe.txt2img(ids, ids, deep_cache=1,
                         guidance_interval=(0.0, 1e9), **kw)
    # identical math, but the lax.cond changes XLA's fusion; euler_a's
    # per-step noise additions amplify last-ulp drift to ~1e-6 over 3 steps
    np.testing.assert_allclose(np.asarray(both1), np.asarray(base), atol=2e-5)
    both2 = pipe.txt2img(ids, ids, deep_cache=2,
                         guidance_interval=(0.3, 5.0), **kw)
    assert np.isfinite(np.asarray(both2)).all()
    assert not np.array_equal(np.asarray(both2), np.asarray(base))


def test_txt2img_deep_cache():
    """End-to-end through SDXLPipeline: runs, differs from the exact path,
    stays finite, and composes with no-CFG sampling."""
    from stabletriton_jax.runtime.pipeline import make_tiny_pipeline

    pipe = make_tiny_pipeline()
    s = pipe.clip_config.max_position_embeddings
    ids = np.full((1, s), 5, np.int32)
    ids[:, 0] = 1
    ids[:, -1] = 99
    ids = jnp.asarray(ids)

    base = pipe.txt2img(ids, ids, height=32, width=32, steps=4, seed=7)
    dc1 = pipe.txt2img(ids, ids, height=32, width=32, steps=4, seed=7,
                       deep_cache=1)
    # every step full == the exact path
    np.testing.assert_allclose(np.asarray(dc1), np.asarray(base), atol=1e-6)
    dc2 = pipe.txt2img(ids, ids, height=32, width=32, steps=4, seed=7,
                       deep_cache=2)
    assert np.isfinite(np.asarray(dc2)).all()
    assert not np.array_equal(np.asarray(dc2), np.asarray(base))
    # deterministic
    dc2b = pipe.txt2img(ids, ids, height=32, width=32, steps=4, seed=7,
                        deep_cache=2)
    np.testing.assert_array_equal(np.asarray(dc2), np.asarray(dc2b))
    # composes with the no-CFG fast path
    nc = pipe.txt2img(ids, ids, height=32, width=32, steps=4, seed=7,
                      guidance_scale=1.0, deep_cache=2)
    assert np.isfinite(np.asarray(nc)).all()


@pytest.mark.parametrize("solver", ["euler", "heun", "dpmpp_2m", "euler_a"])
def test_deep_cache_every_solver(solver):
    """interval=1 must equal the exact path for EVERY solver — this pins the
    cache-carry threading (incl. heun's double eval sharing the step's
    branch); interval=2 must run, differ, and stay finite."""
    from stabletriton_jax.runtime.pipeline import make_tiny_pipeline

    pipe = make_tiny_pipeline()
    s = pipe.clip_config.max_position_embeddings
    ids = np.full((1, s), 5, np.int32)
    ids[:, 0] = 1
    ids[:, -1] = 99
    ids = jnp.asarray(ids)
    kw = dict(height=32, width=32, steps=3, seed=7, solver=solver)
    base = pipe.txt2img(ids, ids, **kw)
    dc1 = pipe.txt2img(ids, ids, deep_cache=1, **kw)
    np.testing.assert_allclose(np.asarray(dc1), np.asarray(base), atol=1e-6)
    dc2 = pipe.txt2img(ids, ids, deep_cache=2, **kw)
    assert np.isfinite(np.asarray(dc2)).all()
    assert not np.array_equal(np.asarray(dc2), np.asarray(base))


@pytest.mark.parametrize("solver", ["euler", "heun", "dpmpp_2m", "euler_a"])
def test_no_cfg_hoist_every_solver(solver):
    """g=1 (cond-only, conditioning pre-halved before the scan) must match
    the doubled-batch CFG path at g=1+eps for every solver — pins the
    hoist_cond slicing against the classic path."""
    schedule = sched.make_schedule(sched.SchedulerConfig(), 3)
    full_fn, _ = _fake_pair()

    def plain_unet(params, inp, t, ctx, te, tid, tc=None):
        return full_fn(params, inp, t, ctx, te, tid, tc)[0]

    rng = np.random.default_rng(6)
    lat = jnp.asarray(rng.standard_normal((1, 4, 4, 4)), jnp.float32)
    ctx = jnp.asarray(rng.standard_normal((2, 3, 5)), jnp.float32)
    noise = (jnp.asarray(rng.standard_normal((3, 1, 4, 4, 4)), jnp.float32)
             if solver == "euler_a" else None)
    kw = {} if noise is None else {"noise": noise}
    a = make_denoise_loop(plain_unet, schedule, guidance_scale=1.0,
                          solver=solver)({}, lat, ctx, None, None, **kw)
    b = make_denoise_loop(plain_unet, schedule, guidance_scale=1.0 + 1e-7,
                          solver=solver)({}, lat, ctx, None, None, **kw)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)


def test_img2img_deep_cache():
    """The knob also threads through the img2img/refiner surface."""
    from stabletriton_jax.runtime.pipeline import make_tiny_refiner_pipeline

    refiner = make_tiny_refiner_pipeline()
    rng = np.random.default_rng(0)
    latents = jnp.asarray(rng.standard_normal((1, 4, 4, 4)), jnp.float32)
    ids = np.full((1, 16), 5, np.int32)
    ids[:, -1] = 99
    ids = jnp.asarray(ids)
    base = refiner.img2img(latents, None, ids, steps=4, strength=0.5, seed=3,
                           decode=False)
    dc = refiner.img2img(latents, None, ids, steps=4, strength=0.5, seed=3,
                         decode=False, deep_cache=2)
    assert np.isfinite(np.asarray(dc)).all()
    assert not np.array_equal(np.asarray(dc), np.asarray(base))
