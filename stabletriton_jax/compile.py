"""The one-call compile API — analog of the reference's ``optimize_model``.

Reference flow (``src/stabletriton/optimization.py:27-38``): symbolic-trace the
torch UNet, run the rewrite-pass pipeline, wrap the forward in a cached CUDA
graph. Flow here: pick an op->backend *binding* (the pass list) for the JAX
platform the program runs on, trace the functional UNet once under
``jax.jit`` with that binding active, and let XLA produce the replayable
executable (XLA's compile cache plays the role of the CUDA-graph cache keyed
by input signature, reference ``optimizers/cuda/graphs.py:193-209``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from stabletriton_jax import ops
from stabletriton_jax.models.unet import (
    UNetConfig,
    precompute_cross_kv,
    precompute_time_cond,
    unet_apply,
    unet_apply_shallow,
)

# The binding each JAX platform compiles with ("platform" backend). Ops not
# listed run their plain "reference" implementation, which XLA compiles
# itself: on the GPU it hands GEMMs to cuBLAS and the NHWC/HWIO convs, with
# their bias/residual/SiLU epilogue, to cuDNN.
#   gpu — attention through cuDNN's fused flash attention where cuDNN takes
#         the shape (ops/gpu.py); GroupNorm/LayerNorm with f32 moments and
#         the normalize applied in the activation dtype;
#   cpu — the plain reference ops (the test platform).
PLATFORM_BINDINGS: dict[str, dict[str, str]] = {
    "gpu": {
        "attention": "cudnn",
        "attention_qkv": "cudnn",
        "attention_kv": "cudnn",
        "group_norm": "bf16apply",
        "layer_norm": "bf16apply",
    },
    "cpu": {},
}


@dataclass(frozen=True)
class CompileConfig:
    """Options for compile_unet (frozen → usable as a jit static arg)."""

    # "platform": the running platform's binding (PLATFORM_BINDINGS);
    # "reference": the plain ops on every platform (the stock-XLA baseline)
    backend: str = "platform"
    # per-op overrides, e.g. (("attention", "reference"),) to A/B one op
    overrides: tuple[tuple[str, str], ...] = ()
    dtype: str = "bfloat16"
    donate_sample: bool = False
    # opt-in "turbo" quantization: "int8" pre-quantizes eligible linear
    # weights (quantize_linear_weights) and binds linear->int8. Breaks the
    # 1e-3 fidelity gate by design; report its numbers separately.
    quantize: str | None = None
    quantize_min_dim: int = 256  # smallest weight dim worth quantizing
    # hoist the cross-attention K/V projections out of the denoise loop
    # (precompute_cross_kv): numerically identical, saves ~680 MB/step of
    # loop-invariant weight traffic. Off => recompute per step (A/B).
    cache_cross_kv: bool = True
    # batch the per-step time-conditioning projections over all steps before
    # the loop (precompute_time_cond): same numbers, ~50 MB/step of weight
    # re-reads and ~27 small GEMM dispatches hoisted. Opt-in until measured.
    cache_time_cond: bool = False

    @property
    def jnp_dtype(self):
        return jnp.dtype(self.dtype)


# Fixed default cache location inside the checkout: the path is part of the
# cache's identity, so it must not depend on the user, a temp name or time.
DEFAULT_COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def compile_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else the checkout's
    ``.jax_cache/``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_COMPILE_CACHE_DIR


def enable_persistent_compile_cache() -> str:
    """Persist XLA executables to disk so recompiles are warm across processes.

    The reference pays its (re)capture/autotune cost once per *process*
    (CUDA-graph cache + Triton autotune cache are in-memory,
    ``optimizers/cuda/graphs.py:193-209``); XLA's persistent compilation
    cache carries the compiled program across processes too — the second
    process with the same (topology, program) signature deserializes instead
    of recompiling. The directory is ``compile_cache_dir()``. Safe to call
    repeatedly. Returns the cache directory in use.
    """
    path = compile_cache_dir()
    if jax.config.jax_compilation_cache_dir != path:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
        # cache everything that took XLA real work; tiny programs stay uncached
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path


def resolve_binding(config: CompileConfig,
                    platform: str | None = None) -> dict[str, str]:
    """Build the op->backend binding for ``platform`` (default: the running
    JAX backend). An unknown platform is an error, never a fallback."""
    if config.backend == "platform":
        platform = platform or jax.default_backend()
        if platform not in PLATFORM_BINDINGS:
            raise RuntimeError(
                f"no op binding for JAX platform {platform!r}; supported: "
                f"{sorted(PLATFORM_BINDINGS)} (or CompileConfig("
                f"backend='reference') for the plain ops)"
            )
        binding = dict(PLATFORM_BINDINGS[platform])
    elif config.backend == "reference":
        binding = {}
    else:
        raise ValueError(f"unknown backend {config.backend!r}; "
                         "expected 'platform' or 'reference'")
    registered = ops.registered_ops()
    if config.quantize in ("int8", "int8_ff"):
        binding["linear"] = "int8"
    elif config.quantize == "int8_conv":
        binding["linear"] = "int8"
        binding["conv2d"] = "int8"
    elif config.quantize is not None:
        raise ValueError(f"unknown quantize mode {config.quantize!r}")
    for op, backend in config.overrides:
        if backend != "reference" and backend not in registered.get(op, []):
            raise ValueError(f"override {op}->{backend}: backend not registered")
        binding[op] = backend
    return binding


def compile_unet(
    unet_config: UNetConfig,
    config: CompileConfig = CompileConfig(),
):
    """Return a jitted UNet step: fn(params, sample, t, ehs, text_embeds, time_ids).

    The binding is applied at trace time, so the returned executable has the
    bound implementations baked in — re-compiling with a different binding is the analog
    of re-running the reference's pass pipeline with passes toggled.
    """
    binding = resolve_binding(config)
    dtype = config.jnp_dtype

    def step(params, sample, timesteps, encoder_hidden_states, text_embeds, time_ids):
        with ops.use_backends(binding):
            return unet_apply(
                unet_config, params, sample.astype(dtype), timesteps,
                encoder_hidden_states, text_embeds, time_ids,
            )

    donate = (1,) if config.donate_sample else ()
    return jax.jit(step, donate_argnums=donate)


def compile_unet_kv(
    unet_config: UNetConfig,
    config: CompileConfig = CompileConfig(),
):
    """compile_unet with the hoisted-conditioning caches split out.

    Returns ``(precompute, precompute_time, step)``:

      precompute(params, encoder_hidden_states) -> cross_kv
      precompute_time(params, timesteps, text_embeds, time_ids) -> time_cond
          (leaves are (T, B, C); slice step i before calling step)
      step(params, sample, t, cross_kv, text_embeds, time_ids,
           time_cond=None) -> eps

    The text conditioning is constant across every denoise step, so its K/V
    projections are loop-invariant, and the time-conditioning projections
    batch over all T steps at once; ``precompute*`` run once per generation
    and ``step`` consumes the caches instead of re-reading ~730 MB of
    projection weights per step (SDXL-base). Numerically identical to
    ``compile_unet`` — the same ops on the same dtype-cast inputs, just
    hoisted. The pipeline's scan loop and the headline bench both use this
    form; ``compile_unet`` remains the single-call drop-in surface.
    """
    binding = resolve_binding(config)
    dtype = config.jnp_dtype

    def precompute(params, encoder_hidden_states):
        with ops.use_backends(binding):
            return precompute_cross_kv(
                unet_config, params, encoder_hidden_states.astype(dtype)
            )

    def precompute_time(params, timesteps, text_embeds, time_ids):
        with ops.use_backends(binding):
            return precompute_time_cond(
                unet_config, params, timesteps, text_embeds, time_ids,
                dtype=dtype,
            )

    def step(params, sample, timesteps, cross_kv, text_embeds, time_ids,
             time_cond=None):
        with ops.use_backends(binding):
            return unet_apply(
                unet_config, params, sample.astype(dtype), timesteps,
                None, text_embeds, time_ids, cross_kv=cross_kv,
                time_cond=time_cond,
            )

    donate = (1,) if config.donate_sample else ()
    return (jax.jit(precompute), jax.jit(precompute_time),
            jax.jit(step, donate_argnums=donate))


def compile_unet_deepcache(
    unet_config: UNetConfig,
    config: CompileConfig = CompileConfig(),
):
    """The DeepCache pair for step-at-a-time callers (the torch drop-in
    frontend): ``(full, shallow)`` where

      full(params, sample, t, ehs, text_embeds, time_ids) -> (eps, cache)
      shallow(params, sample, t, ehs, text_embeds, time_ids, cache) -> eps

    ``cache`` is the deep-feature tensor entering the last up block
    (models/unet.unet_apply ``return_cache`` / ``unet_apply_shallow``). The
    native pipeline keeps the cache inside its scan carry instead
    (runtime/denoise.make_denoise_loop ``deep_cache``); this form is for
    frontends that own the step loop, like the reference's per-step
    CUDA-graph replay surface."""
    binding = resolve_binding(config)
    dtype = config.jnp_dtype

    def full(params, sample, timesteps, encoder_hidden_states, text_embeds,
             time_ids):
        with ops.use_backends(binding):
            return unet_apply(
                unet_config, params, sample.astype(dtype), timesteps,
                encoder_hidden_states, text_embeds, time_ids,
                return_cache=True,
            )

    def shallow(params, sample, timesteps, encoder_hidden_states, text_embeds,
                time_ids, cache):
        with ops.use_backends(binding):
            return unet_apply_shallow(
                unet_config, params, sample.astype(dtype), timesteps,
                encoder_hidden_states, text_embeds, time_ids, cache,
            )

    donate = (1,) if config.donate_sample else ()
    return (jax.jit(full, donate_argnums=donate),
            jax.jit(shallow, donate_argnums=donate))


def cast_params(params, config: CompileConfig):
    """Pre-cast a param pytree to the compile dtype (done once, not per step)."""
    dtype = config.jnp_dtype
    return jax.tree.map(lambda a: a.astype(dtype), params)


def quantize_linear_weights(params: dict, *, min_dim: int = 256,
                            conv: bool = False, ff_only: bool = False) -> dict:
    """Pre-quantize eligible weights to (int8, per-out-channel f32 scale)
    pairs for the int8 turbo bindings.

    Eligible: 2D ``*.weight`` with both dims >= min_dim — the transformer
    projections and MLPs where the FLOPs are — and, when ``conv=True``, 4D
    HWIO conv weights whose in/out channels both reach min_dim (conv_in /
    conv_out stay exact via their 4-channel side). Conditioning-critical
    small stacks (time/add embeddings) and everything else stay exact; the
    int8 backends pass un-quantized arrays through to the exact path. Run
    AFTER fuse_attention_projections so fused qkv/kv weights quantize as one
    tensor. Returns a new dict; originals are not mutated.

    ``ff_only`` restricts to the GEGLU up-projections (``.net.0.proj``), the
    widest GEMMs, where an int8 product has the most to gain over the
    dynamic activation-quant overhead; it also keeps the numerics deviation
    smaller than quantizing every projection.
    """
    out = {}
    for key, w in params.items():
        ndim = getattr(w, "ndim", 0)
        eligible = (
            key.endswith(".weight")
            and "time_embedding" not in key
            and "add_embedding" not in key
            and (not ff_only or ".net.0.proj." in key)
            and (
                (ndim == 2 and min(w.shape) >= min_dim)
                or (conv and ndim == 4 and min(w.shape[2], w.shape[3]) >= min_dim)
            )
        )
        if eligible:
            wf = jnp.asarray(w, jnp.float32)
            red = tuple(range(ndim - 1))  # all but the output-channel axis
            scale = jnp.maximum(jnp.max(jnp.abs(wf), axis=red), 1e-12) / 127.0
            wq = jnp.clip(jnp.round(wf / scale), -127, 127).astype(jnp.int8)
            out[key] = (wq, scale)
        else:
            out[key] = w
    return out


def fuse_attention_projections(params: dict) -> dict:
    """Fold each attention's separate projections into one wide matmul.

    Self-attention q/k/v (same input) concatenate to ``to_qkv.weight``
    (in, 3C); cross-attention k/v (same context input) to ``to_kv.weight``.
    The model detects the fused keys (models/unet._attention_layer). This is
    the working version of the reference's *planned* QKV fusion (its
    ``kernels/attention_proj.py`` existed but was never wired —
    SURVEY.md §2.5): one wide (in, 3C) dot instead of three narrow (in, C)
    dots. Returns a new dict; originals are not mutated.
    """
    out = dict(params)
    for key in list(params):
        if key.endswith(".attn1.to_q.weight"):
            base = key[: -len(".to_q.weight")]
            names = [f"{base}.to_{x}.weight" for x in ("q", "k", "v")]
            if all(n in out for n in names):
                out[f"{base}.to_qkv.weight"] = jnp.concatenate(
                    [out.pop(n) for n in names], axis=1
                )
        elif key.endswith(".attn2.to_k.weight"):
            base = key[: -len(".to_k.weight")]
            names = [f"{base}.to_{x}.weight" for x in ("k", "v")]
            if all(n in out for n in names):
                out[f"{base}.to_kv.weight"] = jnp.concatenate(
                    [out.pop(n) for n in names], axis=1
                )
    return out
