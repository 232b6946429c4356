"""Scheduler + denoise-loop tests (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stabletriton_jax.runtime import scheduler as sched
from stabletriton_jax.runtime.denoise import make_denoise_loop


def test_schedule_shapes_and_monotonicity():
    s = sched.make_schedule(sched.SchedulerConfig(), 30)
    assert s.timesteps.shape == (30,)
    assert s.sigmas.shape == (31,)
    assert s.sigmas[-1] == 0.0
    assert np.all(np.diff(s.sigmas) < 0)       # strictly decreasing
    assert np.all(np.diff(s.timesteps) < 0)
    # "leading" spacing at 30 steps starts at t=958 -> sigma ~ 11.5 (the 14.6
    # sigma_max of the scaled-linear schedule only occurs at t=999)
    assert 11.0 < s.sigmas[0] < 12.0
    full = sched._training_sigmas(sched.SchedulerConfig())
    assert 14.0 < full[-1] < 15.0
    assert abs(s.init_noise_sigma - np.sqrt(s.sigmas[0] ** 2 + 1)) < 1e-6
    # leading spacing with offset 1: last timestep is 1, first is 1000-1000//30*1+...
    assert s.timesteps[-1] == 1.0


def test_schedule_leading_spacing_values():
    s = sched.make_schedule(sched.SchedulerConfig(), 10)
    # ratio 100: timesteps 901, 801, ..., 1
    np.testing.assert_array_equal(s.timesteps, np.arange(901, 0, -100, dtype=np.float32))


def test_euler_step_exact_denoise_at_zero_sigma():
    x = jnp.ones((1, 2, 2, 1)) * 3.0
    eps = jnp.ones_like(x) * 0.5
    out = sched.euler_step(x, eps, jnp.float32(2.0), jnp.float32(0.0))
    # x + eps*(0-2) = 3 - 1 = 2 == x - sigma*eps = pred_x0
    np.testing.assert_allclose(np.asarray(out), 2.0)


def test_dpmpp_first_step_exact_for_exact_eps():
    """With the *exact* noise estimate eps = (x - x0)/sigma, the DPM++ update
    must land exactly on x0 + sigma_next * eps (the true solution of the
    sigma-space probability-flow ODE for a constant data prediction).
    This is solver semantics, not a formula echo: the old VP-space update
    produced 10.94 here instead of 6.0."""
    x0 = jnp.ones((1, 2, 2, 1))
    eps = jnp.ones_like(x0)
    sigma, sigma_next = 10.0, 5.0
    x = x0 + sigma * eps  # 11.0
    out, x0_pred = sched.dpmpp_2m_step(
        x, eps, jnp.float32(sigma), jnp.float32(sigma_next),
        jnp.zeros_like(x), jnp.bool_(False), jnp.float32(sigma),
    )
    np.testing.assert_allclose(np.asarray(x0_pred), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out), 6.0, atol=1e-4)


def test_dpmpp_trajectory_exact_on_analytic_ode():
    """Full multistep trajectory with exact eps: x(sigma) = x0 + sigma*c is the
    closed-form solution; 2M (like Euler) must track it to float precision at
    every step, including the multistep-extrapolation steps. Ensures noise
    actually anneals (the round-1 VP-space bug made sigma *grow*)."""
    schedule = sched.make_schedule(sched.SchedulerConfig(), 12)
    x0 = np.float32(2.5)
    c = np.float32(-1.25)
    x = jnp.full((1, 2, 2, 1), x0 + schedule.sigmas[0] * c)
    prev_x0 = jnp.zeros_like(x)
    have_prev = jnp.bool_(False)
    for i in range(12):
        s, s_next = schedule.sigmas[i], schedule.sigmas[i + 1]
        s_prev = schedule.sigmas[i - 1] if i > 0 else schedule.sigmas[0]
        eps = (x - x0) / s  # exact noise estimate
        x, px0 = sched.dpmpp_2m_step(
            x, eps, jnp.float32(s), jnp.float32(s_next),
            prev_x0, have_prev, jnp.float32(s_prev),
        )
        prev_x0, have_prev = px0, jnp.bool_(True)
        np.testing.assert_allclose(
            np.asarray(x), x0 + s_next * c, rtol=2e-5, atol=2e-5
        )
    np.testing.assert_allclose(np.asarray(x), x0, rtol=2e-5)


def test_dpmpp_loop_anneals_noise():
    """End-to-end scan with a fake eps-predictor that returns the scaled input
    (a contraction): the final sample must be *small* relative to the init
    noise — i.e. the solver actually denoises. Catches sign/space errors that
    elementwise formula checks miss."""
    schedule = sched.make_schedule(sched.SchedulerConfig(), 20)

    def fake_unet(params, sample2, t, ctx, te, ti):
        return sample2  # eps := scaled input => x0_pred shrinks every step

    loop = make_denoise_loop(fake_unet, schedule, guidance_scale=1.0,
                             solver="dpmpp_2m")
    lat0 = jnp.full((1, 4, 4, 4), float(schedule.init_noise_sigma))
    out = loop({}, lat0, jnp.zeros((2, 3, 8)), jnp.zeros((2, 8)),
               jnp.zeros((2, 6)))
    assert float(jnp.abs(out).max()) < 0.25 * schedule.init_noise_sigma


def test_dpmpp_final_step_returns_x0():
    x = jnp.ones((1, 2, 2, 1)) * 4.0
    eps = jnp.ones_like(x)
    out, _ = sched.dpmpp_2m_step(
        x, eps, jnp.float32(2.0), jnp.float32(0.0),
        jnp.zeros_like(x), jnp.bool_(True), jnp.float32(4.0),
    )
    np.testing.assert_allclose(np.asarray(out), 2.0, atol=1e-5)


def test_heun_trajectory_exact_on_analytic_ode():
    """With exact eps, the sigma-space ODE has solution x = x0 + sigma*c and
    a constant derivative field, so Heun (trapezoid of two equal slopes) must
    track it exactly and finish at x0."""
    schedule = sched.make_schedule(sched.SchedulerConfig(), 8)
    x0, c = np.float32(1.5), np.float32(0.75)

    def exact_unet(params, sample2, t, ctx, te, ti):
        # invert the euler pre-scaling to recover x, then exact eps
        i = jnp.argmin(jnp.abs(jnp.asarray(schedule.timesteps) - t[0]))
        sigma = jnp.asarray(schedule.sigmas)[i]
        x = sample2 * jnp.sqrt(sigma**2 + 1.0)
        return (x - x0) / jnp.maximum(sigma, 1e-6)

    loop = make_denoise_loop(exact_unet, schedule, guidance_scale=1.0,
                             solver="heun")
    lat0 = jnp.full((1, 2, 2, 1), x0 + schedule.sigmas[0] * c)
    out = loop({}, lat0, jnp.zeros((2, 3, 8)), jnp.zeros((2, 8)),
               jnp.zeros((2, 6)))
    np.testing.assert_allclose(np.asarray(out), x0, rtol=1e-4, atol=1e-4)


def test_heun_final_step_collapses_to_x0():
    x = jnp.full((1, 2, 2, 1), 4.0)
    eps = jnp.ones_like(x)
    out = sched.heun_step(x, eps, jnp.zeros_like(x), jnp.float32(2.0),
                          jnp.float32(0.0))
    np.testing.assert_allclose(np.asarray(out), 2.0, atol=1e-6)


@pytest.mark.parametrize("solver", ["euler", "heun", "dpmpp_2m"])
def test_denoise_loop_with_linear_model(solver):
    """Run the scan loop with a fake 'UNet' whose eps = latents/ (sigma²+1)^-½...
    Use eps = scaled input itself; just checks the loop runs, shapes hold, and
    guidance combine is applied (g=1 -> conditional branch only)."""
    schedule = sched.make_schedule(sched.SchedulerConfig(), 8)

    def fake_unet(params, sample2, t, ctx, text_embeds, time_ids):
        # returns the input as the noise estimate
        return sample2 * params["k"]

    loop = make_denoise_loop(fake_unet, schedule, guidance_scale=1.0, solver=solver)
    latents = jnp.ones((2, 4, 4, 4)) * schedule.init_noise_sigma
    out = jax.jit(loop)(
        {"k": jnp.float32(0.1)}, latents,
        jnp.zeros((4, 7, 8)), jnp.zeros((4, 8)), jnp.zeros((4, 6)),
    )
    assert out.shape == latents.shape
    assert np.isfinite(np.asarray(out)).all()


def test_denoise_loop_euler_matches_manual_loop():
    """scan-based loop == hand-rolled python loop over the same math."""
    schedule = sched.make_schedule(sched.SchedulerConfig(), 5)

    def fake_unet(params, sample2, t, ctx, te, ti):
        return 0.05 * sample2 + 0.01 * t[:, None, None, None]

    loop = make_denoise_loop(fake_unet, schedule, guidance_scale=3.0)
    lat0 = jnp.full((1, 2, 2, 4), 7.0)
    ctx, te, ti = jnp.zeros((2, 3, 8)), jnp.zeros((2, 8)), jnp.zeros((2, 6))
    got = loop({}, lat0, ctx, te, ti)

    lat = lat0
    for i in range(5):
        sigma, sigma_next = schedule.sigmas[i], schedule.sigmas[i + 1]
        t = schedule.timesteps[i]
        inp = lat / np.sqrt(sigma**2 + 1)
        inp2 = jnp.concatenate([inp, inp], 0)
        eps = 0.05 * inp2 + 0.01 * t
        eps_u, eps_c = jnp.split(eps, 2, 0)
        eps = eps_u + 3.0 * (eps_c - eps_u)
        lat = lat + eps * (sigma_next - sigma)
    np.testing.assert_allclose(np.asarray(got), np.asarray(lat), rtol=1e-5)


def test_karras_sigmas():
    s = sched.make_schedule(
        sched.SchedulerConfig(use_karras_sigmas=True), 10
    )
    assert s.sigmas.shape == (11,)
    assert np.all(np.diff(s.sigmas) < 0)
    assert s.sigmas[-1] == 0.0
    # karras rho-7 spacing: interior sigma follows the closed form
    smax, smin = s.sigmas[0], s.sigmas[-2]
    ramp = np.linspace(0, 1, 10)
    expected = (smax ** (1 / 7) + ramp * (smin ** (1 / 7) - smax ** (1 / 7))) ** 7
    np.testing.assert_allclose(s.sigmas[:-1], expected, rtol=1e-5)


def test_karras_timesteps_match_sigmas():
    """Karras mode must recompute timesteps so t_i corresponds to sigma_i on
    the training sigma table (diffusers' _sigma_to_t): conditioning the UNet on
    the original leading-spacing timesteps silently degrades quality."""
    cfg = sched.SchedulerConfig(use_karras_sigmas=True)
    s = sched.make_schedule(cfg, 10)
    train = sched._training_sigmas(sched.SchedulerConfig())
    # invert: sigma at (fractional) timestep t_i == sigma_i
    back = np.exp(np.interp(s.timesteps, np.arange(1000), np.log(train)))
    np.testing.assert_allclose(back, s.sigmas[:-1], rtol=1e-4)
    assert np.all(np.diff(s.timesteps) < 0)
    # and non-Karras timesteps are NOT what Karras mode should condition on
    plain = sched.make_schedule(sched.SchedulerConfig(), 10)
    assert not np.allclose(plain.timesteps, s.timesteps)


def test_ancestral_sigmas_variance_split():
    """sigma_down^2 + sigma_up^2 == sigma_next^2 (the ancestral step's
    deterministic part + fresh noise restore the target marginal), and both
    vanish at sigma_next == 0 so the last step is exact denoising."""
    sigma, sigma_next = jnp.float32(10.0), jnp.float32(5.0)
    down, up = sched.ancestral_sigmas(sigma, sigma_next)
    np.testing.assert_allclose(float(down**2 + up**2), float(sigma_next**2),
                               rtol=1e-6)
    assert 0.0 < float(up) < float(sigma_next)
    down0, up0 = sched.ancestral_sigmas(sigma, jnp.float32(0.0))
    assert float(down0) == 0.0 and float(up0) == 0.0


def test_euler_ancestral_step_semantics():
    """With noise == 0 the step is the Euler step to sigma_down; at
    sigma_next == 0 it collapses to pred_x0 regardless of noise."""
    x0 = jnp.ones((1, 2, 2, 1))
    eps = jnp.ones_like(x0) * 0.5
    sigma, sigma_next = jnp.float32(4.0), jnp.float32(2.0)
    x = x0 + sigma * eps
    down, up = sched.ancestral_sigmas(sigma, sigma_next)
    out = sched.euler_ancestral_step(x, eps, sigma, sigma_next,
                                     jnp.zeros_like(x))
    np.testing.assert_allclose(np.asarray(out),
                               np.asarray(x + eps * (down - sigma)), atol=1e-6)
    out0 = sched.euler_ancestral_step(x, eps, sigma, jnp.float32(0.0),
                                      jnp.ones_like(x) * 9.0)
    np.testing.assert_allclose(np.asarray(out0), np.asarray(x0), atol=1e-6)


def test_denoise_loop_euler_a():
    """euler_a loop runs with per-step noise, requires it, and the noise
    actually reaches the trajectory (different noise -> different output)."""
    schedule = sched.make_schedule(sched.SchedulerConfig(), 6)

    def fake_unet(params, sample2, t, ctx, text_embeds, time_ids):
        return sample2 * params["k"]

    loop = make_denoise_loop(fake_unet, schedule, guidance_scale=1.0,
                             solver="euler_a")
    latents = jnp.ones((2, 4, 4, 4)) * schedule.init_noise_sigma
    cond = (jnp.zeros((4, 7, 8)), jnp.zeros((4, 8)), jnp.zeros((4, 6)))
    p = {"k": jnp.float32(0.1)}
    with pytest.raises(ValueError):
        loop(p, latents, *cond)
    nz = jax.random.normal(jax.random.PRNGKey(0), (6,) + latents.shape)
    out = jax.jit(loop)(p, latents, *cond, noise=nz)
    assert out.shape == latents.shape
    assert np.isfinite(np.asarray(out)).all()
    out2 = jax.jit(loop)(p, latents, *cond, noise=nz * 0.5)
    assert not np.allclose(np.asarray(out), np.asarray(out2))


def test_pipeline_euler_a_txt2img():
    """Tiny end-to-end txt2img with the ancestral solver: runs, finite,
    deterministic per seed, and seed-sensitive."""
    from stabletriton_jax.compile import CompileConfig
    from stabletriton_jax.runtime.pipeline import make_tiny_pipeline

    pipe = make_tiny_pipeline(CompileConfig(backend="reference", dtype="float32"))
    ids = jnp.zeros((1, 16), jnp.int32)
    a = pipe.txt2img(ids, ids, height=32, width=32, steps=3, seed=7,
                     solver="euler_a")
    b = pipe.txt2img(ids, ids, height=32, width=32, steps=3, seed=7,
                     solver="euler_a")
    c = pipe.txt2img(ids, ids, height=32, width=32, steps=3, seed=8,
                     solver="euler_a")
    assert a.shape == (1, 32, 32, 3)
    assert np.isfinite(np.asarray(a)).all()
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert not np.allclose(np.asarray(a), np.asarray(c))
