"""The whole-loop replay runtime: jitted ``lax.scan`` denoising.

This is the replacement for the reference's CUDA-graphs layer
(reference ``src/stabletriton/optimizers/cuda/graphs.py`` — capture the whole
forward once, replay per step; plus the host-side ~50-step scheduler loop,
SURVEY.md §3.3-3.4). Design mapping:

  CUDA graph capture          -> one jit trace of scan(step) (XLA executable)
  graph.replay() per step     -> zero: all steps live inside one dispatch
  static input/output buffers -> donated latents (donate_argnums)
  hash_arg signature cache    -> shape-keyed memo over (res, steps, batch, cfg)
                                 on top of jax's own jit cache (runtime/pipeline.py)

Classifier-free guidance runs as batch-2 *inside* the step (uncond/cond
stacked), so the UNet always sees one static batch shape.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from stabletriton_jax.runtime import scheduler as sched


def make_denoise_loop(
    unet_step: Callable,
    schedule: sched.Schedule,
    *,
    guidance_scale: float = 5.0,
    solver: str = "euler",
    unroll: int = 1,
    precompute: Callable | None = None,
    precompute_time: Callable | None = None,
    guidance_interval: tuple[float, float] | None = None,
    deep_cache: tuple | None = None,
):
    """Build fn(params, latents, ctx, text_embeds, time_ids) -> final latents.

    ``solver``: "euler" (also DDIM — eta=0 DDIM is the identical update in
    sigma-space), "euler_a" (ancestral, takes per-step ``noise``), "heun"
    (2 NFE/step), or "dpmpp_2m".

    ``unet_step(params, sample2, t, ctx, text_embeds, time_ids)`` is the
    (already backend-bound) UNet forward; ``sample2`` is the CFG-doubled batch.
    ``latents``: (B, H, W, C) *already scaled* by init_noise_sigma.
    ``ctx``/``text_embeds``/``time_ids``: CFG-doubled (2B, ...) conditioning,
    uncond first.

    ``precompute(params, ctx) -> cond`` (optional) hoists loop-invariant
    conditioning work out of the scan — it runs ONCE before the loop and its
    result replaces ``ctx`` in every ``unet_step`` call (the cross-attention
    K/V cache: the text conditioning never changes across steps, so XLA
    re-reading its projection weights every step is pure waste — the analog
    of what CUDA-graph capture could never do for the reference, which
    re-ran those GEMMs inside every replay).

    ``precompute_time(params, timesteps, text_embeds, time_ids) -> pytree``
    (optional) batches the per-step time-conditioning projections over all T
    steps before the loop (models/unet.precompute_time_cond); each leaf is
    (T, ...) and rides the scan's xs, so step i's slice reaches ``unet_step``
    as a 7th argument.

    ``guidance_interval=(sigma_lo, sigma_hi)`` (optional, draft-mode knob):
    apply CFG only while sigma_lo <= sigma <= sigma_hi and run the
    *conditional branch alone* (half the UNet batch) outside it — guidance
    mostly matters at mid-range noise levels ("Applying Guidance in a Limited
    Interval", Kynkaanniemi et al. 2024), so the skipped steps run ~2x
    faster. Changes sampling semantics (like the int8 turbo modes, it is
    outside the exactness gate and reported separately); None (default)
    keeps classic every-step CFG.

    ``guidance_scale <= 1`` disables CFG entirely (the diffusers
    ``do_classifier_free_guidance = guidance_scale > 1`` convention —
    SDXL-Turbo/LCM-style sampling): every step runs the conditional branch
    alone at half the UNet batch. At g == 1 this is the same math
    (eps_u + 1*(eps_c - eps_u) == eps_c) minus the wasted uncond forward.

    ``deep_cache=(interval, full_fn, shallow_fn, cache_hwc)`` (optional,
    draft-mode knob — DeepCache, Ma et al. 2023): every ``interval``-th step
    runs ``full_fn`` (a ``unet_step`` that ALSO returns the deep-feature
    cache, models/unet.unet_apply ``return_cache``); the steps in between run
    ``shallow_fn`` (models/unet.unet_apply_shallow bound the same way),
    which recomputes only the outermost UNet level and splices the carried
    cache in — ~20x less work on SDXL. ``cache_hwc`` is the cache's static
    (H, W, C) from models/unet.deep_cache_shape; the cache rides the scan
    carry. Composes with ``guidance_scale <= 1`` and with
    ``guidance_interval``: outside the guidance window only the conditional
    branch runs (half batch), so a full step there refreshes only the cond
    half of the carried cache — the uncond half stays as of the last
    in-window full step (DeepCache's reuse-stale-features approximation,
    applied per CFG branch). If the first in-window step is a shallow one
    before any in-window full step ran, the uncond cache it splices is the
    zeros init — pick the window/interval so an in-window step lands on a
    full step early (step 0 is always full).

    Returned fn is pure; wrap in jit (pipeline.py does, with donation).
    """
    sigmas = jnp.asarray(schedule.sigmas)      # (steps+1,)
    timesteps = jnp.asarray(schedule.timesteps)  # (steps,)
    num_steps = len(schedule.timesteps)
    g = float(guidance_scale)
    no_cfg = g <= 1.0
    if deep_cache is not None and int(deep_cache[0]) < 1:
        raise ValueError(f"deep_cache interval must be >= 1: {deep_cache[0]}")

    def _half(tree, b):
        return (None if tree is None
                else jax.tree.map(lambda a: a[b:], tree))

    def _prep(lat, t, sigma, extra, doubled: bool):
        """Scaled UNet input (+optional inpaint channels) and its timestep
        vector; ``doubled`` stacks the CFG pair. ``extra`` (inpainting-style
        mask + masked-image latents, concatenated *unscaled*) must match the
        output batch: CFG-doubled when doubling, cond-half otherwise."""
        inp = sched.scale_model_input(lat, sigma)
        if doubled:
            inp = jnp.concatenate([inp, inp], axis=0)
        if extra is not None:
            inp = jnp.concatenate([inp, extra.astype(inp.dtype)], axis=-1)
        return inp, jnp.broadcast_to(t, (inp.shape[0],))

    def _combine(eps):
        """CFG combine for a doubled batch (uncond first); identity for the
        cond-only modes."""
        if no_cfg:
            return eps
        eps_u, eps_c = jnp.split(eps, 2, axis=0)
        return eps_u + g * (eps_c - eps_u)

    def _call(params, inp, tt, ctx, text_embeds, time_ids, tc):
        if tc is None:
            return unet_step(params, inp, tt, ctx, text_embeds, time_ids)
        return unet_step(params, inp, tt, ctx, text_embeds, time_ids, tc)

    def guided_eps(params, lat, t, ctx, text_embeds, time_ids, sigma, extra,
                   tc=None):
        inp2, t2 = _prep(lat, t, sigma, extra, True)
        eps = _call(params, inp2, t2, ctx, text_embeds, time_ids, tc)
        eps_u, eps_c = jnp.split(eps, 2, axis=0)
        return eps_u + g * (eps_c - eps_u)

    def cond_eps(params, lat, t, ctx, text_embeds, time_ids, sigma, extra,
                 tc=None):
        """Single-branch eps. ALL conditioning (ctx/text_embeds/time_ids/
        extra/tc) must already be the cond half — the loops pre-slice it
        once before the scan for no-CFG mode (hoist, not per-step), and the
        guidance-interval branch slices at its call site."""
        inp, t1 = _prep(lat, t, sigma, extra, False)
        return _call(params, inp, t1, ctx, text_embeds, time_ids, tc)

    def cfg_eps(params, lat, t, ctx, text_embeds, time_ids, sigma, extra,
                tc=None):
        if no_cfg:
            # conditioning arrives pre-halved (see hoist_cond)
            return cond_eps(params, lat, t, ctx, text_embeds, time_ids,
                            sigma, extra, tc)
        if guidance_interval is None:
            return guided_eps(params, lat, t, ctx, text_embeds, time_ids,
                              sigma, extra, tc)
        lo, hi = guidance_interval
        b = lat.shape[0]
        return jax.lax.cond(
            (sigma >= lo) & (sigma <= hi),
            lambda _: guided_eps(params, lat, t, ctx, text_embeds, time_ids,
                                 sigma, extra, tc),
            lambda _: cond_eps(params, lat, t, _half(ctx, b),
                               _half(text_embeds, b), _half(time_ids, b),
                               sigma, None if extra is None else extra[b:],
                               _half(tc, b)),
            operand=None,
        )

    def eps_step(params, lat, t, ctx, text_embeds, time_ids, sigma, extra,
                 tc, cache, idx):
        """cfg_eps plus the DeepCache carry: returns (eps, cache')."""
        if deep_cache is None:
            return cfg_eps(params, lat, t, ctx, text_embeds, time_ids,
                           sigma, extra, tc), cache
        interval, full_fn, shallow_fn, _ = deep_cache
        # no-CFG conditioning arrives pre-halved (hoist_cond), so both modes
        # pass their inputs straight through
        inp, tt = _prep(lat, t, sigma, extra, not no_cfg)

        def full(_):
            eps, new_cache = full_fn(params, inp, tt, ctx, text_embeds,
                                     time_ids, tc)
            return _combine(eps), new_cache.astype(cache.dtype)

        def fast(_):
            eps = shallow_fn(params, inp, tt, ctx, text_embeds, time_ids,
                             tc, cache)
            return _combine(eps), cache

        if guidance_interval is not None and not no_cfg:
            # composed draft knobs: the interval cond picks doubled-vs-cond
            # batch, the DeepCache cond picks full-vs-shallow — 4 branches.
            # The carried cache stays CFG-doubled (uncond rows first); the
            # cond-only branches read/refresh only its cond half.
            lo, hi = guidance_interval
            b = lat.shape[0]
            inp1, tt1 = _prep(lat, t, sigma,
                              None if extra is None else extra[b:], False)
            ctx_c, te_c, tid_c, tc_c = (_half(ctx, b), _half(text_embeds, b),
                                        _half(time_ids, b), _half(tc, b))

            def full_cond(_):
                eps, nc = full_fn(params, inp1, tt1, ctx_c, te_c, tid_c, tc_c)
                return eps, jnp.concatenate(
                    [cache[:b], nc.astype(cache.dtype)], axis=0)

            def fast_cond(_):
                eps = shallow_fn(params, inp1, tt1, ctx_c, te_c, tid_c, tc_c,
                                 cache[b:])
                return eps, cache

            in_window = (sigma >= lo) & (sigma <= hi)
            if int(interval) == 1:
                return jax.lax.cond(in_window, full, full_cond, operand=None)
            is_full = idx % int(interval) == 0
            return jax.lax.cond(
                in_window,
                lambda _: jax.lax.cond(is_full, full, fast, operand=None),
                lambda _: jax.lax.cond(is_full, full_cond, fast_cond,
                                       operand=None),
                operand=None,
            )

        if int(interval) == 1:
            return full(None)
        return jax.lax.cond(idx % int(interval) == 0, full, fast,
                            operand=None)

    def hoist_cond(latents, cond, text_embeds, time_ids, extra, tc_all):
        """For cond-only sampling (g <= 1) slice every conditioning tree to
        its cond half ONCE before the scan — the ~70-leaf cross-KV cache in
        particular must not be re-sliced per step. tc_all leaves are
        (T, 2B, C): the batch lives on axis 1."""
        if not no_cfg:
            return cond, text_embeds, time_ids, extra, tc_all
        b = latents.shape[0]
        return (_half(cond, b), _half(text_embeds, b), _half(time_ids, b),
                None if extra is None else extra[b:],
                None if tc_all is None
                else jax.tree.map(lambda a: a[:, b:], tc_all))

    def init_cache(latents):
        """Scan-carry init: () when DeepCache is off (free), else a zeros
        placeholder — step 0 is always a full step, so it never reads it."""
        if deep_cache is None:
            return ()
        ch, cw, cc = deep_cache[3]
        bfac = 1 if no_cfg else 2
        return jnp.zeros((bfac * latents.shape[0], ch, cw, cc),
                         latents.dtype)

    step_ids = jnp.arange(num_steps)

    def time_cache(params, text_embeds, time_ids):
        if precompute_time is None:
            return None
        return precompute_time(params, timesteps, text_embeds, time_ids)

    if solver == "euler":

        def loop(params, latents, ctx, text_embeds, time_ids, extra=None):
            cond = precompute(params, ctx) if precompute is not None else ctx
            tc_all = time_cache(params, text_embeds, time_ids)
            cond, text_embeds, time_ids, extra, tc_all = hoist_cond(
                latents, cond, text_embeds, time_ids, extra, tc_all)

            def step(carry, xs):
                lat, cache = carry
                sigma, sigma_next, t, idx, tc = xs
                eps, cache = eps_step(params, lat, t, cond, text_embeds,
                                      time_ids, sigma, extra, tc, cache, idx)
                return (sched.euler_step(lat, eps, sigma, sigma_next),
                        cache), None

            xs = (sigmas[:-1], sigmas[1:], timesteps, step_ids, tc_all)
            (final, _), _ = jax.lax.scan(step, (latents, init_cache(latents)),
                                         xs, unroll=unroll)
            return final

    elif solver == "heun":

        def loop(params, latents, ctx, text_embeds, time_ids, extra=None):
            cond = precompute(params, ctx) if precompute is not None else ctx
            tc_all = time_cache(params, text_embeds, time_ids)
            cond, text_embeds, time_ids, extra, tc_all = hoist_cond(
                latents, cond, text_embeds, time_ids, extra, tc_all)
            # timestep for the correction eval at sigma_next (last entry is a
            # dummy — that step's trapezoid is masked out at sigma_next == 0)
            t_nexts = jnp.concatenate([timesteps[1:], timesteps[-1:]])
            tc_nexts = (None if tc_all is None else jax.tree.map(
                lambda a: jnp.concatenate([a[1:], a[-1:]]), tc_all))

            def step(carry, xs):
                lat, cache = carry
                sigma, sigma_next, t, t_next, idx, tc, tc_next = xs
                eps, cache = eps_step(params, lat, t, cond, text_embeds,
                                      time_ids, sigma, extra, tc, cache, idx)
                proposal = sched.euler_step(lat, eps, sigma, sigma_next)
                # the correction eval shares the step's full/shallow choice
                eps2, cache = eps_step(params, proposal, t_next, cond,
                                       text_embeds, time_ids, sigma_next,
                                       extra, tc_next, cache, idx)
                return (sched.heun_step(lat, eps, eps2, sigma, sigma_next),
                        cache), None

            xs = (sigmas[:-1], sigmas[1:], timesteps, t_nexts, step_ids,
                  tc_all, tc_nexts)
            (final, _), _ = jax.lax.scan(step, (latents, init_cache(latents)),
                                         xs, unroll=unroll)
            return final

    elif solver == "dpmpp_2m":

        def loop(params, latents, ctx, text_embeds, time_ids, extra=None):
            cond = precompute(params, ctx) if precompute is not None else ctx
            tc_all = time_cache(params, text_embeds, time_ids)
            cond, text_embeds, time_ids, extra, tc_all = hoist_cond(
                latents, cond, text_embeds, time_ids, extra, tc_all)
            # sigma_prev[i] = sigmas[i-1] (self for i=0; h_prev=0 is unused then)
            sigma_prevs = jnp.concatenate([sigmas[:1], sigmas[:-2]])

            def step(carry, xs):
                lat, prev_x0, have_prev, cache = carry
                sigma, sigma_next, sigma_prev, t, idx, tc = xs
                eps, cache = eps_step(params, lat, t, cond, text_embeds,
                                      time_ids, sigma, extra, tc, cache, idx)
                lat, x0 = sched.dpmpp_2m_step(
                    lat, eps, sigma, sigma_next, prev_x0, have_prev, sigma_prev
                )
                return (lat, x0, jnp.bool_(True), cache), None

            xs = (sigmas[:-1], sigmas[1:], sigma_prevs, timesteps, step_ids,
                  tc_all)
            init = (
                latents,
                jnp.zeros_like(latents, jnp.float32),
                jnp.bool_(False),
                init_cache(latents),
            )
            (final, _, _, _), _ = jax.lax.scan(step, init, xs, unroll=unroll)
            return final

    elif solver == "euler_a":

        def loop(params, latents, ctx, text_embeds, time_ids, extra=None,
                 noise=None):
            # ancestral sampling needs fresh per-step gaussian noise: a
            # (steps, B, H, W, C) tensor riding the scan's xs (the pipeline
            # derives it from the per-image seeds, so batching a request
            # still never changes its image)
            if noise is None:
                raise ValueError("euler_a needs per-step noise (steps, *latents)")
            cond = precompute(params, ctx) if precompute is not None else ctx
            tc_all = time_cache(params, text_embeds, time_ids)
            cond, text_embeds, time_ids, extra, tc_all = hoist_cond(
                latents, cond, text_embeds, time_ids, extra, tc_all)

            def step(carry, xs):
                lat, cache = carry
                sigma, sigma_next, t, nz, idx, tc = xs
                eps, cache = eps_step(params, lat, t, cond, text_embeds,
                                      time_ids, sigma, extra, tc, cache, idx)
                return (sched.euler_ancestral_step(lat, eps, sigma, sigma_next,
                                                   nz), cache), None

            xs = (sigmas[:-1], sigmas[1:], timesteps, noise, step_ids, tc_all)
            (final, _), _ = jax.lax.scan(step, (latents, init_cache(latents)),
                                         xs, unroll=unroll)
            return final

    else:
        raise ValueError(f"unknown solver {solver!r}")

    loop.num_steps = num_steps
    return loop
