"""End-to-end SDXL txt2img pipeline as a single jitted XLA program.

The reference's benchmarked path (SURVEY.md §3.4) was: host Python scheduler
loop -> CUDA-graph replay per UNet step, with text encoders, CFG combine and
VAE decode all eager *outside* the optimization envelope. Here the entire
txt2img — dual CLIP encode, noise init, the full ``lax.scan`` denoise loop,
and VAE decode — is one XLA executable per (resolution, steps, guidance,
batch, solver) signature, cached exactly like the reference's dynamic
CUDA-graph cache keyed on input signature
(reference ``optimizers/cuda/graphs.py:19-30,193-209``).

Tokenization is the only host-side step (token ids in, images out).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from stabletriton_jax import ops
from stabletriton_jax.compile import (
    CompileConfig,
    enable_persistent_compile_cache,
    fuse_attention_projections,
    resolve_binding,
)
from stabletriton_jax.models import clip as clip_mod
from stabletriton_jax.models import vae as vae_mod
from stabletriton_jax.models.unet import (
    UNetConfig,
    deep_cache_shape,
    precompute_cross_kv,
    precompute_time_cond,
    unet_apply,
    unet_apply_shallow,
)
from stabletriton_jax.runtime import scheduler as sched
from stabletriton_jax.runtime.denoise import make_denoise_loop
from stabletriton_jax.runtime.profiling import logger as _logger


def _ancestral_noise(keys, steps: int, shape) -> jnp.ndarray:
    """(steps, B, *shape) fresh per-step gaussian noise for ancestral solvers.

    One independent key chain per image (fold_in(k, 1), disjoint from the
    init-noise draw on k itself), so batching a request never changes its
    image — the same serving-determinism contract as the init noise.
    """
    def per_image(k):
        return jax.random.normal(
            jax.random.fold_in(k, 1), (steps,) + tuple(shape), jnp.float32
        )

    return jnp.swapaxes(jax.vmap(per_image)(keys), 0, 1)


def _decode_images(vae_config, vae_params, latents, chunk: int = 1) -> jnp.ndarray:
    """VAE decode (fp32 for stability), clipped to [-1, 1].

    For batch > chunk the decode runs ``chunk`` images at a time under
    ``lax.map``: the decoder's full-resolution feature maps cost ~GBs of HBM
    per 1024² image, so a fully batched decode scales peak memory linearly
    with batch. Chunked decode keeps the chunk-sized peak (the decode is a
    brief bandwidth-bound tail of independent images); whether batched
    decode fits and wins on the GPU is not measured yet.

    ``chunk`` is the data-parallel mesh axis size (1 off-mesh): a sharded
    batch holds batch/chunk images PER DEVICE, so each lax.map iteration
    decodes one image per device concurrently — mapping per-image there
    would serialize work the mesh runs in parallel."""
    lat = latents.astype(jnp.float32)
    b = lat.shape[0]
    if b > chunk and b % chunk != 0:
        # a non-divisible batch must NOT fall back to the fully batched
        # decode (exactly the peak-memory blowup chunking exists to avoid);
        # per-image decode is always memory-safe
        chunk = 1
    if b <= chunk:
        img = vae_mod.vae_decode(vae_config, vae_params, lat)
    else:
        # iteration i decodes image i of every device's contiguous slice
        # (images i, i + b/chunk, ...), so no iteration needs another
        # device's latents
        per = b // chunk
        img = jax.lax.map(
            lambda z: vae_mod.vae_decode(vae_config, vae_params, z),
            jnp.swapaxes(lat.reshape(chunk, per, *lat.shape[1:]), 0, 1),
        )
        img = jnp.swapaxes(img, 0, 1).reshape(b, *img.shape[2:])
    return jnp.clip(img, -1.0, 1.0)


def _seed_vector(seed, batch: int) -> jnp.ndarray:
    """int -> (batch,) uint32 seeds (seed+i per image); arrays pass through."""
    arr = np.asarray(seed)
    if arr.ndim == 0:
        arr = int(arr) + np.arange(batch)
    return jnp.asarray(np.asarray(arr, np.uint32))


@dataclass
class SDXLPipeline:
    """Holds configs + params; compiles & caches one program per signature."""

    unet_config: UNetConfig
    clip_config: clip_mod.CLIPTextConfig
    clip2_config: clip_mod.CLIPTextConfig
    vae_config: vae_mod.VAEConfig
    params: dict[str, dict[str, jax.Array]]  # keys: unet, text_encoder, text_encoder_2, vae
    compile_config: CompileConfig = field(default_factory=CompileConfig)
    scheduler_config: sched.SchedulerConfig = field(default_factory=sched.SchedulerConfig)
    # SD2.x conventionally conditions on the penultimate encoder layer
    clip_skip: int = 1
    # multi-chip: a ("data", "model") mesh (runtime/mesh.make_mesh). Params
    # are sharded at construction (head-aligned column/row-parallel tables;
    # with model > 1 the attention projections stay unfused — see
    # __post_init__), token-id batches are sharded over "data" per call, and
    # XLA partitions the rest — scaling out is a config change, not a
    # rewrite (SURVEY §2.7).
    mesh: Any = None
    _cache: dict[Any, Any] = field(default_factory=dict, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def __post_init__(self):
        # persist XLA executables across processes — the cross-process
        # upgrade of the reference's in-memory CUDA-graph/autotune caches
        # (compile.compile_cache_dir says where)
        enable_persistent_compile_cache()
        self.params = dict(self.params)
        if self.compile_config.backend != "reference" and self._tp_size() == 1:
            # tensor-parallel meshes keep the projections UNFUSED: a
            # contiguous "model" split of the fused [q|k|v] channel concat is
            # not head-aligned, so fusing would force channel replication
            # (an all-gather) at every attention. Unfused column-parallel
            # projections shard by whole heads and attention runs
            # collective-free.
            self.params["unet"] = fuse_attention_projections(self.params["unet"])
        if self.compile_config.quantize:
            from stabletriton_jax.compile import quantize_linear_weights

            self.params["unet"] = quantize_linear_weights(
                self.params["unet"],
                min_dim=self.compile_config.quantize_min_dim,
                conv=self.compile_config.quantize == "int8_conv",
                ff_only=self.compile_config.quantize == "int8_ff",
            )
        if self.mesh is not None:
            from stabletriton_jax.runtime import mesh as mesh_mod

            self.params = {
                group: mesh_mod.shard_params(p, self.mesh)
                for group, p in self.params.items()
            }

    def _tp_size(self) -> int:
        """Size of the tensor-parallel ("model") mesh axis; 1 off-mesh."""
        if self.mesh is None:
            return 1
        from stabletriton_jax.runtime import mesh as mesh_mod

        return int(self.mesh.shape.get(mesh_mod.MODEL_AXIS, 1))

    def _decode_chunk(self) -> int:
        """Images decoded per lax.map iteration: the data-axis size (each
        device decodes its one local image per iteration); 1 off-mesh."""
        if self.mesh is None:
            return 1
        from stabletriton_jax.runtime import mesh as mesh_mod

        return int(self.mesh.shape[mesh_mod.DATA_AXIS])

    def _shard_batch(self, *arrays):
        """device_put call inputs with leading-axis ("data") sharding."""
        if self.mesh is None:
            return arrays if len(arrays) > 1 else arrays[0]
        from stabletriton_jax.runtime import mesh as mesh_mod

        bs = mesh_mod.batch_sharding(self.mesh)
        out = tuple(None if a is None else jax.device_put(a, bs) for a in arrays)
        return out if len(out) > 1 else out[0]

    def _unet_step_fns(self):
        """(unet_step, precompute, precompute_time) for make_denoise_loop.
        With cache_cross_kv (default) the step consumes the precomputed
        cross-attention K/V cache instead of the raw context; with
        cache_time_cond (opt-in — it measured OUT at the step level, see
        CompileConfig) the per-step time-conditioning projections ride the
        scan's xs, batched over all steps up front. Both are numerically
        identical to the inline computation — loop-invariant /
        step-batchable work just runs once per generation."""
        ucfg = self.unet_config
        use_kv = self.compile_config.cache_cross_kv
        use_tc = self.compile_config.cache_time_cond

        def unet_step(unet_params, sample, t, cond, text_embeds, time_ids,
                      tc=None):
            ctx, kv = (None, cond) if use_kv else (cond, None)
            return unet_apply(ucfg, unet_params, sample, t, ctx,
                              text_embeds, time_ids, cross_kv=kv,
                              time_cond=tc)

        def kv_pre(unet_params, ctx):
            return precompute_cross_kv(ucfg, unet_params, ctx)

        def time_pre(unet_params, timesteps, text_embeds, time_ids):
            return precompute_time_cond(ucfg, unet_params, timesteps,
                                        text_embeds, time_ids)

        return unet_step, (kv_pre if use_kv else None), (
            time_pre if use_tc else None)

    @staticmethod
    def _norm_gi(guidance_interval, guidance_scale):
        """Normalize the guidance-interval knob for the program-cache
        signature: a float 2-tuple, or None — including when
        ``guidance_scale <= 1`` (the no-CFG branch wins in the loop and the
        interval is inert; normalizing keeps inert-knob requests from
        compiling duplicate identical programs)."""
        if guidance_interval is None or float(guidance_scale) <= 1.0:
            return None
        return (float(guidance_interval[0]), float(guidance_interval[1]))

    @staticmethod
    def _norm_deep_cache(deep_cache):
        """Normalize the user knob to (interval, depth) or None.

        ``deep_cache=N`` caches at depth 1 (the classic DeepCache split —
        shallow steps are attention-free on SDXL); ``deep_cache=(N, d)``
        recomputes the outermost ``d`` levels instead (more quality, less
        speedup — d=2 keeps SDXL's 640-channel attention level live)."""
        if deep_cache is None:
            return None
        if isinstance(deep_cache, (tuple, list)):
            interval, depth = deep_cache
            return (int(interval), int(depth))
        return (int(deep_cache), 1)

    def _deep_cache_tuple(self, deep_cache, lat_h, lat_w):
        """make_denoise_loop's ``deep_cache`` arg for a normalized
        (interval, depth) knob: unet_step-shaped full/shallow fns plus the
        cache's static (H, W, C)."""
        if deep_cache is None:
            return None
        interval, depth = deep_cache
        ucfg = self.unet_config
        use_kv = self.compile_config.cache_cross_kv

        def full_fn(unet_params, sample, t, cond, text_embeds, time_ids,
                    tc=None):
            ctx, kv = (None, cond) if use_kv else (cond, None)
            return unet_apply(ucfg, unet_params, sample, t, ctx, text_embeds,
                              time_ids, cross_kv=kv, time_cond=tc,
                              return_cache=True, cache_depth=depth)

        def shallow_fn(unet_params, sample, t, cond, text_embeds, time_ids,
                       tc, cache):
            ctx, kv = (None, cond) if use_kv else (cond, None)
            return unet_apply_shallow(ucfg, unet_params, sample, t, ctx,
                                      text_embeds, time_ids, cache,
                                      cross_kv=kv, time_cond=tc,
                                      cache_depth=depth)

        hwc = deep_cache_shape(ucfg, 1, lat_h, lat_w, cache_depth=depth)[1:]
        return (interval, full_fn, shallow_fn, hwc)

    # ------------------------------------------------------------------
    def _build(self, *, batch, height, width, steps, guidance_scale, solver,
               return_latents, guidance_interval=None, deep_cache=None):
        """Trace+jit the full txt2img program for one signature."""
        binding = resolve_binding(self.compile_config)
        dtype = self.compile_config.jnp_dtype
        schedule = sched.make_schedule(self.scheduler_config, steps)
        ucfg = self.unet_config
        f = self.vae_config.spatial_scale_factor
        lat_h, lat_w = height // f, width // f

        unet_step, kv_pre, time_pre = self._unet_step_fns()

        loop = make_denoise_loop(
            unet_step, schedule, guidance_scale=guidance_scale, solver=solver,
            precompute=kv_pre, precompute_time=time_pre,
            guidance_interval=guidance_interval,
            deep_cache=self._deep_cache_tuple(deep_cache, lat_h, lat_w),
        )

        def program(params, ids1, ids2, neg_ids1, neg_ids2, seed):
            with ops.use_backends(binding):
                # --- text encoding (cond + uncond), fp32 encoders ---
                ids1_all = jnp.concatenate([neg_ids1, ids1], axis=0)
                if ucfg.has_addition_embedding:
                    # SDXL: dual encoders, penultimate states + pooled bigG
                    ids2_all = jnp.concatenate([neg_ids2, ids2], axis=0)
                    ctx, pooled = clip_mod.encode_sdxl_prompts(
                        self.clip_config, params["text_encoder"],
                        self.clip2_config, params["text_encoder_2"],
                        ids1_all, ids2_all,
                    )
                    ctx = ctx.astype(dtype)
                    pooled = pooled.astype(dtype)
                    # SDXL micro-conditioning: [oh, ow, ct, cl, th, tw]
                    tid = jnp.asarray(
                        [height, width, 0, 0, height, width], jnp.float32
                    )
                    time_ids = jnp.broadcast_to(tid, (2 * batch, 6))
                else:
                    # SD1.x/2.x: one encoder, final (or clip-skipped) states,
                    # no added conditioning
                    pen, final, _ = clip_mod.clip_apply_chunked(
                        self.clip_config, params["text_encoder"], ids1_all
                    )
                    ctx = (pen if self.clip_skip >= 2 else final).astype(dtype)
                    pooled = jnp.zeros((2 * batch, 0), dtype)
                    time_ids = jnp.zeros((2 * batch, 0), jnp.float32)

                # --- noise init on device, one key per image: batching a
                # request never changes its image (serving determinism) ---
                keys = jax.vmap(jax.random.PRNGKey)(seed)
                noise = jax.vmap(
                    lambda k: jax.random.normal(
                        k, (lat_h, lat_w, ucfg.in_channels), jnp.float32
                    )
                )(keys)
                latents = (noise * schedule.init_noise_sigma).astype(dtype)

                # --- the whole denoise loop, one scan ---
                if solver == "euler_a":
                    latents = loop(params["unet"], latents, ctx, pooled, time_ids,
                                   noise=_ancestral_noise(keys, loop.num_steps,
                                                          latents.shape[1:]))
                else:
                    latents = loop(params["unet"], latents, ctx, pooled, time_ids)

                if return_latents:
                    return latents
                return _decode_images(self.vae_config, params["vae"], latents,
                                      chunk=self._decode_chunk())

        return jax.jit(program)

    # ------------------------------------------------------------------
    def txt2img(
        self,
        ids1: jax.Array,          # (B, 77) token ids, encoder 1
        ids2: jax.Array,          # (B, 77) token ids, encoder 2
        *,
        neg_ids1: jax.Array | None = None,
        neg_ids2: jax.Array | None = None,
        height: int = 1024,
        width: int = 1024,
        steps: int = 30,
        guidance_scale: float = 5.0,
        solver: str = "euler",
        seed: int = 0,
        return_latents: bool = False,
        guidance_interval: tuple[float, float] | None = None,
        deep_cache: int | tuple[int, int] | None = None,
    ):
        """Generate images; returns (B, height, width, 3) in [-1, 1]
        (or final latents if return_latents).

        ``guidance_interval=(sigma_lo, sigma_hi)`` (draft knob): CFG only
        inside the sigma window; outside it the uncond UNet branch is skipped
        entirely (~2x faster on those steps). See make_denoise_loop.

        ``deep_cache=N`` (draft knob — DeepCache, Ma et al. 2023): run the
        full UNet every N-th step and only the outermost level (splicing the
        carried deep-feature cache) in between. N=2/3 keep quality close;
        ``deep_cache=(N, depth)`` recomputes the outermost ``depth`` levels
        instead (more quality, less speedup). Composes with
        guidance_interval and with ``guidance_scale <= 1`` (see
        make_denoise_loop)."""
        self._check_resolution(height, width)
        batch = int(ids1.shape[0])
        # missing negative prompt == the empty prompt "" (BOS/EOS/pad), exactly
        # as diffusers tokenizes it — NOT all-zero ids (which would mis-pool the
        # EOS argmax and diverge from the reference)
        if neg_ids1 is None:
            neg_ids1 = jnp.asarray(
                self.clip_config.empty_prompt_ids(batch, int(ids1.shape[1]))
            )
        if neg_ids2 is None:
            neg_ids2 = jnp.asarray(
                self.clip2_config.empty_prompt_ids(batch, int(ids2.shape[1]))
            )
        gi = self._norm_gi(guidance_interval, guidance_scale)
        dc = self._norm_deep_cache(deep_cache)
        fn = self._txt2img_program(batch, height, width, steps,
                                   float(guidance_scale), solver,
                                   return_latents, gi, dc)
        ids1, ids2, neg_ids1, neg_ids2, seeds = self._shard_batch(
            ids1, ids2, neg_ids1, neg_ids2, _seed_vector(seed, batch)
        )
        return fn(self.params, ids1, ids2, neg_ids1, neg_ids2, seeds)

    def _txt2img_program(self, batch, height, width, steps, guidance_scale,
                         solver, return_latents, gi, dc):
        """Get-or-build the jitted txt2img program for one signature."""
        sig = (batch, height, width, steps, guidance_scale, solver,
               return_latents, gi, dc)
        fn = self._cache.get(sig)
        if fn is None:
            # double-checked lock: concurrent servers must not double-compile
            # (the reference locked its capture cache identically,
            # graphs.py:22-30; the INFO line mirrors its per-capture log)
            with self._lock:
                fn = self._cache.get(sig)
                if fn is None:
                    _logger.info("compiling txt2img program for signature %s", sig)
                    fn = self._build(
                        batch=batch, height=height, width=width, steps=steps,
                        guidance_scale=guidance_scale, solver=solver,
                        return_latents=return_latents, guidance_interval=gi,
                        deep_cache=dc,
                    )
                    self._cache[sig] = fn
        return fn

    def warmup(
        self,
        *,
        batch: int = 1,
        height: int = 1024,
        width: int = 1024,
        steps: int = 30,
        guidance_scale: float = 5.0,
        solver: str = "euler",
        guidance_interval: tuple[float, float] | None = None,
        deep_cache: int | tuple[int, int] | None = None,
        prompt_len: int | None = None,
    ) -> None:
        """Ahead-of-time compile one txt2img signature (serving cold-start
        elimination: a new signature otherwise pays its trace+compile on the
        first request).

        Traces and compiles via jax AOT (``lower().compile()``) WITHOUT
        executing a generation; the executable lands in the persistent
        compile cache, which jit's normal call path then hits on the first
        real request."""
        self._check_resolution(height, width)
        gi = self._norm_gi(guidance_interval, guidance_scale)
        dc = self._norm_deep_cache(deep_cache)
        fn = self._txt2img_program(batch, height, width, steps,
                                   float(guidance_scale), solver, False,
                                   gi, dc)
        mp1 = prompt_len or self.clip_config.max_position_embeddings
        mp2 = prompt_len or self.clip2_config.max_position_embeddings
        ids1 = jnp.zeros((batch, mp1), jnp.int32)
        ids2 = jnp.zeros((batch, mp2), jnp.int32)
        seeds = jnp.zeros((batch,), jnp.uint32)
        args = self._shard_batch(ids1, ids2, ids1, ids2, seeds)
        fn.lower(self.params, *args).compile()

    def inpaint(
        self,
        image: jax.Array,          # (B, H, W, 3) in [-1, 1]
        mask: jax.Array,           # (B, H, W, 1), 1 = repaint
        ids1: jax.Array,
        ids2: jax.Array,
        *,
        neg_ids1: jax.Array | None = None,
        neg_ids2: jax.Array | None = None,
        steps: int = 30,
        guidance_scale: float = 5.0,
        solver: str = "euler",
        seed: int = 0,
        guidance_interval: tuple[float, float] | None = None,
        deep_cache: int | tuple[int, int] | None = None,
    ):
        """Inpainting with a 9-channel SDXL-inpaint UNet (in_channels = 4 noisy +
        1 mask + 4 masked-image latents). Requires encoder params under
        ``params["vae"]`` ("encoder.*" / "quant_conv.*" keys) — see
        models/vae.vae_encode. The whole program (encode -> scan -> decode) jits
        as one executable, like txt2img."""
        if self.unet_config.in_channels != 9:
            raise ValueError(
                f"inpaint needs a 9-channel inpaint UNet; this model has "
                f"in_channels={self.unet_config.in_channels}"
            )
        batch, height, width, _ = image.shape
        if neg_ids1 is None:
            neg_ids1 = jnp.asarray(
                self.clip_config.empty_prompt_ids(batch, int(ids1.shape[1]))
            )
        if neg_ids2 is None:
            neg_ids2 = jnp.asarray(
                self.clip2_config.empty_prompt_ids(batch, int(ids2.shape[1]))
            )
        gi = self._norm_gi(guidance_interval, guidance_scale)
        dc = self._norm_deep_cache(deep_cache)
        sig = ("inpaint", batch, height, width, steps, float(guidance_scale),
               solver, gi, dc)
        fn = self._cache.get(sig)
        if fn is None:
            with self._lock:
                fn = self._cache.get(sig)
                if fn is None:
                    _logger.info("compiling inpaint program for signature %s", sig)
                    fn = self._build_inpaint(
                        batch=batch, height=height, width=width, steps=steps,
                        guidance_scale=float(guidance_scale), solver=solver,
                        guidance_interval=gi, deep_cache=dc,
                    )
                    self._cache[sig] = fn
        image, mask, ids1, ids2, neg_ids1, neg_ids2, seeds = self._shard_batch(
            image, mask, ids1, ids2, neg_ids1, neg_ids2, _seed_vector(seed, batch)
        )
        return fn(self.params, image, mask, ids1, ids2, neg_ids1, neg_ids2, seeds)

    def _build_inpaint(self, *, batch, height, width, steps,
                                guidance_scale, solver, guidance_interval=None,
                                deep_cache=None):
        binding = resolve_binding(self.compile_config)
        dtype = self.compile_config.jnp_dtype
        schedule = sched.make_schedule(self.scheduler_config, steps)
        ucfg = self.unet_config
        f = self.vae_config.spatial_scale_factor
        lat_h, lat_w = height // f, width // f

        unet_step, kv_pre, time_pre = self._unet_step_fns()

        loop = make_denoise_loop(
            unet_step, schedule, guidance_scale=guidance_scale, solver=solver,
            precompute=kv_pre, precompute_time=time_pre,
            guidance_interval=guidance_interval,
            deep_cache=self._deep_cache_tuple(deep_cache, height // f,
                                              width // f),
        )

        def program(params, image, mask, ids1, ids2, neg_ids1, neg_ids2, seed):
            with ops.use_backends(binding):
                ids1_all = jnp.concatenate([neg_ids1, ids1], axis=0)
                ids2_all = jnp.concatenate([neg_ids2, ids2], axis=0)
                ctx, pooled = clip_mod.encode_sdxl_prompts(
                    self.clip_config, params["text_encoder"],
                    self.clip2_config, params["text_encoder_2"],
                    ids1_all, ids2_all,
                )
                ctx = ctx.astype(dtype)
                pooled = pooled.astype(dtype)
                tid = jnp.asarray([height, width, 0, 0, height, width], jnp.float32)
                time_ids = jnp.broadcast_to(tid, (2 * batch, 6))

                # conditioning channels: downsampled mask + masked-image latents
                maskf = mask.astype(jnp.float32)
                masked = image.astype(jnp.float32) * (maskf < 0.5)
                masked_lat = vae_mod.vae_encode(self.vae_config, params["vae"], masked)
                mask_lat = jax.image.resize(maskf, (batch, lat_h, lat_w, 1), "nearest")
                extra1 = jnp.concatenate([mask_lat, masked_lat], axis=-1)
                extra = jnp.concatenate([extra1, extra1], axis=0)  # CFG-doubled

                keys = jax.vmap(jax.random.PRNGKey)(seed)
                noise = jax.vmap(
                    lambda k: jax.random.normal(k, (lat_h, lat_w, 4), jnp.float32)
                )(keys)
                latents = (noise * schedule.init_noise_sigma).astype(dtype)

                if solver == "euler_a":
                    latents = loop(params["unet"], latents, ctx, pooled,
                                   time_ids, extra,
                                   noise=_ancestral_noise(keys, loop.num_steps,
                                                          latents.shape[1:]))
                else:
                    latents = loop(params["unet"], latents, ctx, pooled,
                                   time_ids, extra)
                return _decode_images(self.vae_config, params["vae"], latents,
                                      chunk=self._decode_chunk())

        return jax.jit(program)

    def _check_resolution(self, height: int, width: int) -> None:
        """Latents must survive the UNet's downsampling levels cleanly."""
        f = self.vae_config.spatial_scale_factor
        unet_div = 2 ** (len(self.unet_config.block_out_channels) - 1)
        step = f * unet_div
        if height % step or width % step:
            raise ValueError(
                f"height/width must be multiples of {step} "
                f"(VAE x{f} latents, UNet /{unet_div} downsampling); "
                f"got {height}x{width}"
            )

    def img2img_image(
        self,
        image: jax.Array,  # (B, H, W, 3) in [-1, 1]
        ids1: jax.Array | None,
        ids2: jax.Array,
        *,
        encode_seed: int | None = None,
        **kwargs,
    ):
        """img2img from pixels: VAE-encode the image (posterior mean, or a
        sample when encode_seed is given), then refine via img2img(). Requires
        encoder params ("encoder.*"/"quant_conv.*") in params["vae"]."""
        if "encoder.conv_in.weight" not in self.params["vae"]:
            raise ValueError(
                "params['vae'] has no encoder weights; load the full VAE "
                "(vae_encoder_param_shapes) to use image-input img2img"
            )
        rng = None if encode_seed is None else jax.random.PRNGKey(encode_seed)
        latents = vae_mod.vae_encode(
            self.vae_config, self.params["vae"], image.astype(jnp.float32), rng=rng
        )
        return self.img2img(latents, ids1, ids2, **kwargs)

    def cache_signatures(self):
        """Compiled-program signatures (the hash_arg cache-key analog)."""
        # keys mix str/float/None fields (e.g. guidance_interval) — sort by
        # repr for a stable order without cross-type comparisons
        return sorted(self._cache, key=repr)

    # ------------------------------------------------------------------
    # img2img / refinement
    # ------------------------------------------------------------------
    def _build_img2img(self, *, batch, lat_h, lat_w, steps, start, guidance_scale,
                       solver, aesthetic_scores, decode,
                       guidance_interval=None, deep_cache=None):
        """Jit an img2img program: noise the input latents to sigma[start],
        run the truncated schedule, optionally decode."""
        binding = resolve_binding(self.compile_config)
        dtype = self.compile_config.jnp_dtype
        full = sched.make_schedule(self.scheduler_config, steps)
        part = sched.Schedule(
            timesteps=full.timesteps[start:],
            sigmas=full.sigmas[start:],
            init_noise_sigma=float(np.sqrt(full.sigmas[start] ** 2 + 1)),
        )
        ucfg = self.unet_config
        # refiner-style 5-slot micro-conditioning ([oh, ow, ct, cl, aesthetic]);
        # guard the arithmetic: SD1.x/2.x have addition_time_embed_dim = None
        five_ids = (
            ucfg.addition_time_embed_dim is not None
            and ucfg.projection_class_embeddings_input_dim
            == (self.clip2_config.projection_dim or 0)
            + 5 * ucfg.addition_time_embed_dim
        )

        unet_step, kv_pre, time_pre = self._unet_step_fns()

        loop = make_denoise_loop(
            unet_step, part, guidance_scale=guidance_scale, solver=solver,
            precompute=kv_pre, precompute_time=time_pre,
            guidance_interval=guidance_interval,
            deep_cache=self._deep_cache_tuple(deep_cache, lat_h, lat_w),
        )

        def program(params, latents_in, ids1, ids2, neg_ids1, neg_ids2, seed):
            with ops.use_backends(binding):
                f = self.vae_config.spatial_scale_factor
                height, width = lat_h * f, lat_w * f
                if ucfg.addition_time_embed_dim is None:
                    # SD1.x/2.x img2img: single encoder, no micro-conditioning
                    ids = ids2 if ids1 is None else ids1
                    negs = neg_ids2 if ids1 is None else neg_ids1
                    ids_all = jnp.concatenate([negs, ids], axis=0)
                    pen, final, _ = clip_mod.clip_apply_chunked(
                        self.clip_config, params["text_encoder"], ids_all
                    )
                    ctx = (pen if self.clip_skip >= 2 else final).astype(dtype)
                    pooled = jnp.zeros((2 * batch, 0), dtype)
                    time_ids = jnp.zeros((2 * batch, 0), jnp.float32)
                else:
                    ids2_all = jnp.concatenate([neg_ids2, ids2], axis=0)
                    h2, _, pooled = clip_mod.clip_apply(
                        self.clip2_config, params["text_encoder_2"], ids2_all
                    )
                    if ids1 is not None and "text_encoder" in params:
                        # dual-encoder conditioning (SDXL-base UNet as img2img)
                        ids1_all = jnp.concatenate([neg_ids1, ids1], axis=0)
                        h1, _, _ = clip_mod.clip_apply(
                            self.clip_config, params["text_encoder"], ids1_all
                        )
                        ctx = jnp.concatenate([h1, h2], axis=-1)
                    else:
                        # refiner conditions on the bigG encoder alone
                        ctx = h2
                    ctx = ctx.astype(dtype)
                    pooled = pooled.astype(dtype)

                    if five_ids:
                        # refiner micro-conditioning: [oh, ow, ct, cl, aesthetic]
                        tid = jnp.stack([
                            jnp.asarray([height, width, 0, 0, s], jnp.float32)
                            for s in aesthetic_scores
                        ])  # (2, 5): uncond, cond rows
                        time_ids = jnp.repeat(tid, batch, axis=0)
                    else:
                        tid = jnp.asarray(
                            [height, width, 0, 0, height, width], jnp.float32
                        )
                        time_ids = jnp.broadcast_to(tid, (2 * batch, 6))

                keys = jax.vmap(jax.random.PRNGKey)(seed)
                noise = jax.vmap(
                    lambda k: jax.random.normal(k, latents_in.shape[1:], jnp.float32)
                )(keys)
                sigma0 = part.sigmas[0]
                latents = (latents_in.astype(jnp.float32) + noise * sigma0).astype(dtype)

                if solver == "euler_a":
                    latents = loop(params["unet"], latents, ctx, pooled, time_ids,
                                   noise=_ancestral_noise(keys, loop.num_steps,
                                                          latents.shape[1:]))
                else:
                    latents = loop(params["unet"], latents, ctx, pooled, time_ids)
                if not decode:
                    return latents
                return _decode_images(self.vae_config, params["vae"], latents,
                                      chunk=self._decode_chunk())

        return jax.jit(program)

    def img2img(
        self,
        latents: jax.Array,       # (B, h, w, 4) clean (scaled) latents
        ids1: jax.Array | None,   # encoder-1 ids, or None for single-encoder models
        ids2: jax.Array,
        *,
        neg_ids1: jax.Array | None = None,
        neg_ids2: jax.Array | None = None,
        steps: int = 30,
        strength: float = 0.3,
        guidance_scale: float = 5.0,
        solver: str = "euler",
        seed: int = 0,
        aesthetic_scores: tuple[float, float] = (2.5, 6.0),  # (uncond, cond)
        decode: bool = True,
        guidance_interval: tuple[float, float] | None = None,
        deep_cache: int | tuple[int, int] | None = None,
    ):
        """Refine existing latents (SDXL refiner / img2img): re-noise to the
        strength point of the schedule and denoise the remaining steps.
        ``guidance_interval`` / ``deep_cache``: see txt2img."""
        batch, lat_h, lat_w, _ = latents.shape
        start = min(max(steps - int(round(steps * strength)), 0), steps - 1)
        if neg_ids1 is None and ids1 is not None:
            neg_ids1 = jnp.asarray(
                self.clip_config.empty_prompt_ids(batch, int(ids1.shape[1]))
            )
        if neg_ids2 is None:
            neg_ids2 = jnp.asarray(
                self.clip2_config.empty_prompt_ids(batch, int(ids2.shape[1]))
            )
        gi = self._norm_gi(guidance_interval, guidance_scale)
        dc = self._norm_deep_cache(deep_cache)
        sig = ("i2i", batch, lat_h, lat_w, steps, start, float(guidance_scale),
               solver, aesthetic_scores, decode, gi, dc)
        fn = self._cache.get(sig)
        if fn is None:
            with self._lock:
                fn = self._cache.get(sig)
                if fn is None:
                    _logger.info("compiling img2img program for signature %s", sig)
                    fn = self._build_img2img(
                        batch=batch, lat_h=lat_h, lat_w=lat_w, steps=steps,
                        start=start, guidance_scale=float(guidance_scale),
                        solver=solver, aesthetic_scores=aesthetic_scores,
                        decode=decode, guidance_interval=gi, deep_cache=dc,
                    )
                    self._cache[sig] = fn
        latents, ids1, ids2, neg_ids1, neg_ids2, seeds = self._shard_batch(
            latents, ids1, ids2, neg_ids1, neg_ids2, _seed_vector(seed, batch)
        )
        return fn(self.params, latents, ids1, ids2, neg_ids1, neg_ids2, seeds)


@dataclass
class TwoStageSDXL:
    """Base + refiner expert-ensemble (BASELINE config #4): the base model
    denoises the first (1 - strength) of the schedule, the refiner finishes
    the tail from the base's latents and decodes. Both stages are whole-loop
    jitted programs; the hand-off is one on-device latent tensor."""

    base: SDXLPipeline
    refiner: SDXLPipeline

    def txt2img(
        self,
        ids1: jax.Array,
        ids2: jax.Array,
        *,
        neg_ids1: jax.Array | None = None,
        neg_ids2: jax.Array | None = None,
        height: int = 1024,
        width: int = 1024,
        steps: int = 30,
        refiner_strength: float = 0.25,
        guidance_scale: float = 5.0,
        solver: str = "euler",
        seed: int = 0,
    ):
        latents = self.base.txt2img(
            ids1, ids2, neg_ids1=neg_ids1, neg_ids2=neg_ids2,
            height=height, width=width, steps=steps,
            guidance_scale=guidance_scale, solver=solver, seed=seed,
            return_latents=True,
        )
        return self.refiner.img2img(
            latents, None, ids2, neg_ids2=neg_ids2, steps=steps,
            strength=refiner_strength, guidance_scale=guidance_scale,
            solver=solver, seed=seed + 1,
        )


def make_tiny_pipeline(compile_config: CompileConfig | None = None,
                       mesh=None) -> SDXLPipeline:
    """A structurally complete but tiny pipeline (CPU tests)."""
    from stabletriton_jax.models.unet import init_unet_params, tiny_unet_config

    ucfg = tiny_unet_config()
    # encoder widths must sum to cross_attention_dim; encoder 2 provides pooled
    c1 = clip_mod.CLIPTextConfig(
        vocab_size=100, hidden_size=ucfg.cross_attention_dim // 2,
        num_layers=2, num_heads=4, intermediate_size=32,
        max_position_embeddings=16, eos_token_id=99, bos_token_id=98,
    )
    c2 = clip_mod.CLIPTextConfig(
        vocab_size=100, hidden_size=ucfg.cross_attention_dim - c1.hidden_size,
        num_layers=2, num_heads=4, intermediate_size=32,
        max_position_embeddings=16, projection_dim=16, eos_token_id=99, bos_token_id=98,
    )
    vcfg = vae_mod.tiny_vae_config()
    params = {
        "unet": init_unet_params(ucfg, 0),
        "text_encoder": clip_mod.init_clip_params(c1, 1),
        "text_encoder_2": clip_mod.init_clip_params(c2, 2),
        "vae": vae_mod.init_vae_params(vcfg, 3),
    }
    return SDXLPipeline(
        unet_config=ucfg, clip_config=c1, clip2_config=c2, vae_config=vcfg,
        params=params, mesh=mesh,
        compile_config=compile_config or CompileConfig(backend="reference", dtype="float32"),
    )


def make_tiny_sd15_pipeline(
    compile_config: CompileConfig | None = None,
) -> SDXLPipeline:
    """Tiny SD1.x-style pipeline: single text encoder (final-layer states),
    fixed head count, no added conditioning."""
    from stabletriton_jax.models.unet import UNetConfig, init_unet_params

    c1 = clip_mod.CLIPTextConfig(
        vocab_size=100, hidden_size=32, num_layers=2, num_heads=4,
        intermediate_size=32, max_position_embeddings=16, eos_token_id=99, bos_token_id=98,
    )
    ucfg = UNetConfig(
        block_out_channels=(32, 64),
        down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
        layers_per_block=1,
        transformer_layers_per_block=(1, 1),
        fixed_num_heads=4,
        cross_attention_dim=c1.hidden_size,
        norm_num_groups=8,
        addition_time_embed_dim=None,
        projection_class_embeddings_input_dim=None,
        mid_block_layers=1,
    )
    vcfg = vae_mod.tiny_vae_config()
    params = {
        "unet": init_unet_params(ucfg, 20),
        "text_encoder": clip_mod.init_clip_params(c1, 21),
        "vae": vae_mod.init_vae_params(vcfg, 22),
    }
    return SDXLPipeline(
        unet_config=ucfg, clip_config=c1, clip2_config=c1, vae_config=vcfg,
        params=params,
        compile_config=compile_config or CompileConfig(backend="reference", dtype="float32"),
    )


def make_tiny_refiner_pipeline(
    compile_config: CompileConfig | None = None,
) -> SDXLPipeline:
    """Tiny refiner-shaped pipeline: single text encoder, 5-slot time_ids
    (aesthetic-score conditioning), conv-only innermost level."""
    from stabletriton_jax.models.unet import UNetConfig, init_unet_params

    c2 = clip_mod.CLIPTextConfig(
        vocab_size=100, hidden_size=32, num_layers=2, num_heads=4,
        intermediate_size=32, max_position_embeddings=16, projection_dim=16,
        eos_token_id=99, bos_token_id=98,
    )
    ucfg = UNetConfig(
        block_out_channels=(32, 64, 64),
        down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D"),
        layers_per_block=1,
        transformer_layers_per_block=(1, 1, 1),
        attention_head_dim=16,
        cross_attention_dim=32,          # bigG features alone
        norm_num_groups=8,
        addition_time_embed_dim=8,
        projection_class_embeddings_input_dim=16 + 5 * 8,  # pooled + 5 time_ids
        mid_block_layers=1,
    )
    vcfg = vae_mod.tiny_vae_config()
    params = {
        "unet": init_unet_params(ucfg, 10),
        "text_encoder_2": clip_mod.init_clip_params(c2, 11),
        "vae": vae_mod.init_vae_params(vcfg, 12),
    }
    return SDXLPipeline(
        unet_config=ucfg, clip_config=c2, clip2_config=c2, vae_config=vcfg,
        params=params,
        compile_config=compile_config or CompileConfig(backend="reference", dtype="float32"),
    )
