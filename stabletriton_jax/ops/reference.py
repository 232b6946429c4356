"""Reference (pure jax.numpy / lax) implementations of every framework op.

These are the "eager torch" analog: correct, simple, XLA-fused baselines. Every
other backend of an op is parity-tested against these — the same gate the
reference repo applies between its Triton kernels and eager torch (e.g.
reference ``src/stabletriton/kernels/geglu.py:37-43``).

Layout conventions (not the reference's NCHW):
  * images are NHWC (channels-last, the layout cuDNN's tensor-core convs
    take without transposes);
  * conv weights are HWIO;
  * linear weights are (in, out) so ``x @ w`` needs no transpose;
  * norms/softmax accumulate in fp32 regardless of activation dtype.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from stabletriton_jax.ops.registry import register

# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

_ACTIVATIONS = {
    None: lambda x: x,
    "silu": jax.nn.silu,
    "gelu": partial(jax.nn.gelu, approximate=False),
    "relu": jax.nn.relu,
    "mish": lambda x: x * jnp.tanh(jax.nn.softplus(x)),
}


def apply_activation(x: jax.Array, act: str | None) -> jax.Array:
    try:
        return _ACTIVATIONS[act](x)
    except KeyError:
        raise ValueError(f"unknown activation {act!r}; known: {list(_ACTIVATIONS)}")


# ---------------------------------------------------------------------------
# attention — reference analog: the 8-node unfused SDPA pattern that
# StableTriton's fuse_attention matches (reference
# src/stabletriton/optimizers/replace_attention.py:76-86)
# ---------------------------------------------------------------------------


@register("attention", "reference")
def attention(
    q: jax.Array, k: jax.Array, v: jax.Array,
    *, num_heads: int = 1, scale: float | None = None,
):
    """Multi-head scaled dot-product attention, non-causal.

    q: (B, Sq, H*D); k, v: (B, Sk, H*D) — channel-packed heads (the model's
    natural layout; the cudnn backend reshapes it to (B, S, H, D) for free).
    Softmax in fp32. Returns (B, Sq, H*D).
    """
    b, sq, c = q.shape
    sk = k.shape[1]
    d = c // num_heads
    if scale is None:
        scale = 1.0 / np.sqrt(d)

    def split(x, s):
        return x.reshape(b, s, num_heads, d).transpose(0, 2, 1, 3)

    qh, kh, vh = split(q, sq), split(k, sk), split(v, sk)
    logits = jnp.einsum(
        "bhqd,bhkd->bhqk", qh, kh, preferred_element_type=jnp.float32
    ) * jnp.float32(scale)
    weights = jax.nn.softmax(logits, axis=-1)
    out = jnp.einsum(
        "bhqk,bhkd->bhqd", weights.astype(vh.dtype), vh,
        preferred_element_type=jnp.float32,
    ).astype(q.dtype)
    return out.transpose(0, 2, 1, 3).reshape(b, sq, c)


@register("attention_qkv", "reference")
def attention_qkv(qkv: jax.Array, *, num_heads: int = 1,
                  scale: float | None = None):
    """Self-attention over the fused QKV projection output (B, S, 3*H*D)
    (compile.fuse_attention_projections). The reference backend splits and
    runs the plain math — identical HLO to slicing at the call site, so the
    stock-XLA baseline is unchanged."""
    q, k, v = jnp.split(qkv, 3, axis=-1)
    return attention(q, k, v, num_heads=num_heads, scale=scale)


@register("attention_kv", "reference")
def attention_kv(q: jax.Array, kv: jax.Array, *, num_heads: int = 1,
                 scale: float | None = None):
    """Cross-attention over the fused KV projection output (B, Sk, 2*H*D)."""
    k, v = jnp.split(kv, 2, axis=-1)
    return attention(q, k, v, num_heads=num_heads, scale=scale)


# ---------------------------------------------------------------------------
# group norm (+ optional fused activation) — reference kernel:
# src/stabletriton/kernels/groupnorm.py (one program per (batch, group));
# here moments reduce over the NHWC spatial axes and XLA fuses the apply.
# ---------------------------------------------------------------------------


@register("group_norm", "reference")
def group_norm(
    x: jax.Array,
    gamma: jax.Array,
    beta: jax.Array,
    *,
    num_groups: int = 32,
    eps: float = 1e-5,
    act: str | None = None,
):
    """GroupNorm over NHWC input; moments in fp32; optional fused activation."""
    n, h, w, c = x.shape
    assert c % num_groups == 0, (c, num_groups)
    xg = x.reshape(n, h * w, num_groups, c // num_groups).astype(jnp.float32)
    mean = jnp.mean(xg, axis=(1, 3), keepdims=True)
    var = jnp.mean(jnp.square(xg - mean), axis=(1, 3), keepdims=True)
    xn = (xg - mean) * jax.lax.rsqrt(var + eps)
    xn = xn.reshape(n, h, w, c)
    out = xn * gamma.astype(jnp.float32) + beta.astype(jnp.float32)
    return apply_activation(out, act).astype(x.dtype)


@register("group_norm", "bf16apply")
def group_norm_bf16apply(
    x: jax.Array,
    gamma: jax.Array,
    beta: jax.Array,
    *,
    num_groups: int = 32,
    eps: float = 1e-5,
    act: str | None = None,
):
    """GroupNorm with f32 moments but the normalize+activation applied in the
    input dtype (bf16 on the default GPU path): half the traffic for the
    apply pass. Outside the strict 1e-3 elementwise kernel contract
    (bf16 rounding ~0.4% relative on the normalized values); the GPU
    binding's default, held to the full-UNet MSE<1e-3 gate instead."""
    n, h, w, c = x.shape
    assert c % num_groups == 0, (c, num_groups)
    per = c // num_groups
    xf = x.astype(jnp.float32)
    s1 = jnp.sum(xf, axis=(1, 2))
    s2 = jnp.sum(jnp.square(xf), axis=(1, 2))
    cnt = h * w * per
    mean = s1.reshape(n, num_groups, per).sum(-1) / cnt
    ex2 = s2.reshape(n, num_groups, per).sum(-1) / cnt
    rstd = jax.lax.rsqrt(jnp.maximum(ex2 - jnp.square(mean), 0.0) + eps)
    scale = jnp.repeat(rstd, per, axis=1) * gamma.astype(jnp.float32)
    shift = beta.astype(jnp.float32) - jnp.repeat(mean, per, axis=1) * scale
    out = (x * scale[:, None, None, :].astype(x.dtype)
           + shift[:, None, None, :].astype(x.dtype))
    return apply_activation(out, act).astype(x.dtype)


@register("group_norm", "barrier")
def group_norm_barrier(
    x: jax.Array,
    gamma: jax.Array,
    beta: jax.Array,
    *,
    num_groups: int = 32,
    eps: float = 1e-5,
    act: str | None = None,
):
    """One-pass GroupNorm behind an optimization barrier — identical
    numerics; keeps the GN stats reductions out of the producing conv's
    epilogue (same rationale as layer_norm 'barrier')."""
    return group_norm_onepass(jax.lax.optimization_barrier(x), gamma, beta,
                              num_groups=num_groups, eps=eps, act=act)


@register("group_norm", "onepass")
def group_norm_onepass(
    x: jax.Array,
    gamma: jax.Array,
    beta: jax.Array,
    *,
    num_groups: int = 32,
    eps: float = 1e-5,
    act: str | None = None,
):
    """One-pass channel-major GroupNorm: E[x]/E[x²] via a spatial reduce in
    the natural NHWC layout (C innermost), group pooling on the tiny (N, C)
    stats, then a single per-channel affine normalize pass. Avoids the
    (N, HW, G, C/G) reshape of the two-pass form, whose narrow last dim C/G
    (=10 for SDXL) lays out badly if XLA materializes it. A/B-able via
    CompileConfig.overrides (("group_norm", "onepass"),)."""
    n, h, w, c = x.shape
    assert c % num_groups == 0, (c, num_groups)
    per = c // num_groups
    xf = x.astype(jnp.float32)
    s1 = jnp.sum(xf, axis=(1, 2))                    # (N, C)
    s2 = jnp.sum(jnp.square(xf), axis=(1, 2))
    cnt = h * w * per
    mean = s1.reshape(n, num_groups, per).sum(-1) / cnt   # (N, G)
    ex2 = s2.reshape(n, num_groups, per).sum(-1) / cnt
    rstd = jax.lax.rsqrt(jnp.maximum(ex2 - jnp.square(mean), 0.0) + eps)
    scale = jnp.repeat(rstd, per, axis=1) * gamma.astype(jnp.float32)   # (N, C)
    shift = beta.astype(jnp.float32) - jnp.repeat(mean, per, axis=1) * scale
    out = xf * scale[:, None, None, :] + shift[:, None, None, :]
    return apply_activation(out, act).astype(x.dtype)


# ---------------------------------------------------------------------------
# layer norm — reference kernel: src/stabletriton/kernels/layer_norm.py
# (Welford single-pass Triton); XLA fuses the two-pass formulation fine.
# ---------------------------------------------------------------------------


@register("layer_norm", "reference")
def layer_norm(
    x: jax.Array,
    gamma: jax.Array | None,
    beta: jax.Array | None,
    *,
    eps: float = 1e-5,
):
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(xf - mean), axis=-1, keepdims=True)
    out = (xf - mean) * jax.lax.rsqrt(var + eps)
    if gamma is not None:
        out = out * gamma.astype(jnp.float32)
    if beta is not None:
        out = out + beta.astype(jnp.float32)
    return out.astype(x.dtype)


@register("layer_norm", "bf16apply")
def layer_norm_bf16apply(
    x: jax.Array,
    gamma: jax.Array | None,
    beta: jax.Array | None,
    *,
    eps: float = 1e-5,
):
    """LayerNorm with f32 moments but the normalize+affine applied in the
    input dtype — same rationale and fidelity argument as group_norm
    'bf16apply' (half the traffic on the apply pass; bit-exact
    vs `layer_norm` on f32 inputs, ~0.4% relative rounding on bf16). Variance
    is the two-pass E[(x-mean)^2] form, matching `layer_norm` — the one-pass
    E[x^2]-mean^2 form cancels catastrophically for large-mean rows; the
    moments are f32 either way, the apply dtype is the actual optimization."""
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(xf - mean), axis=-1, keepdims=True)
    rstd = jax.lax.rsqrt(var + eps)
    out = (x - mean.astype(x.dtype)) * rstd.astype(x.dtype)
    if gamma is not None:
        out = out * gamma.astype(x.dtype)
    if beta is not None:
        out = out + beta.astype(x.dtype)
    return out


@register("rms_norm", "reference")
def rms_norm(
    x: jax.Array,
    gamma: jax.Array | None,
    beta: jax.Array | None = None,
    *,
    eps: float = 1e-5,
):
    """RMSNorm over the last axis: x / sqrt(mean(x^2) + eps) * gamma (+beta).

    Capability parity with the reference's dual-mode norm kernel (reference
    ``src/stabletriton/kernels/layer_norm.py:75,129`` ``IS_RMSNORM`` — same
    Triton kernel, mean subtraction skipped). No SD-family model uses it;
    it exists for SD3/Flux-class models whose norms are RMS. f32 moments,
    apply in f32 then cast back (mirroring `layer_norm`)."""
    xf = x.astype(jnp.float32)
    ms = jnp.mean(jnp.square(xf), axis=-1, keepdims=True)
    out = xf * jax.lax.rsqrt(ms + eps)
    if gamma is not None:
        out = out * gamma.astype(jnp.float32)
    if beta is not None:
        out = out + beta.astype(jnp.float32)
    return out.astype(x.dtype)


@register("layer_norm", "barrier")
def layer_norm_barrier(
    x: jax.Array,
    gamma: jax.Array | None,
    beta: jax.Array | None,
    *,
    eps: float = 1e-5,
):
    """LayerNorm behind an optimization barrier — identical numerics.

    Without it XLA may fuse the LN *stats reductions* into the producing
    GEMM's epilogue, which then emits a second f32[B,S] output. The barrier
    forces the stats into a separate memory-bound pass over the activation.
    Opt-in via overrides; not measured on the GPU."""
    return layer_norm(jax.lax.optimization_barrier(x), gamma, beta, eps=eps)


# ---------------------------------------------------------------------------
# GEGLU — reference kernel: src/stabletriton/kernels/geglu.py:11-35
# (elementwise state * gelu(gate), erf-based gelu)
# ---------------------------------------------------------------------------


@register("geglu", "reference")
def geglu(state: jax.Array, gate: jax.Array):
    """state * gelu(gate), exact (erf) gelu like the reference kernel."""
    return state * jax.nn.gelu(gate, approximate=False).astype(state.dtype)


# ---------------------------------------------------------------------------
# linear (+ optional fused bias/activation) — reference kernel:
# src/stabletriton/kernels/linear.py `sdxl_forward` (GEMM + bias + SiLU).
# XLA's dot (cuBLAS on the GPU) with a fused epilogue is the default; the op
# exists so the binding can A/B variants such as int8 (the reference's own
# plain-linear pass was a *regression* and is disabled —
# optimization.py:18-21).
# ---------------------------------------------------------------------------


@register("linear", "reference")
def linear(
    x: jax.Array,
    w: jax.Array,
    b: jax.Array | None = None,
    *,
    act: str | None = None,
):
    """x: (..., in), w: (in, out) — or a quantized (w_int8, scale) pair
    (compile.quantize_linear_weights), dequantized here for exact-path runs."""
    if isinstance(w, tuple):
        wq, scale = w
        w = wq.astype(jnp.float32) * scale
    out = jnp.dot(x, w.astype(x.dtype), preferred_element_type=jnp.float32)
    if b is not None:
        out = out + b.astype(jnp.float32)
    out = apply_activation(out, act)
    return out.astype(x.dtype)


@register("linear", "int8")
def linear_int8(
    x: jax.Array,
    w,
    b: jax.Array | None = None,
    *,
    act: str | None = None,
):
    """W8A8 dynamic-quantized linear — the opt-in "turbo" binding.

    Weights arrive pre-quantized per output channel as an (int8, (out,) f32
    scale) pair (compile.quantize_linear_weights); activations quantize
    per-token at runtime (abs-max symmetric). The int8xint8->int32 dot can
    run on tensor cores at twice the bf16 rate; whether XLA's GPU program
    does so is not measured. Breaks the 1e-3 fidelity gate by design —
    report turbo numbers separately.
    """
    if not isinstance(w, tuple):
        # un-quantized stragglers (time/add embeddings) take the exact path
        return linear(x, w, b, act=act)
    wq, scale = w
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
    sx = jnp.maximum(amax, 1e-8) * (1.0 / 127.0)
    xq = jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(
        xq, wq, (((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    out = acc.astype(jnp.float32) * (sx * scale.astype(jnp.float32))
    if b is not None:
        out = out + b.astype(jnp.float32)
    out = apply_activation(out, act)
    return out.astype(x.dtype)


# ---------------------------------------------------------------------------
# timestep sinusoidal embedding — reference kernel:
# src/stabletriton/kernels/timestep.py (inductor-generated sin/cos pointwise).
# Semantics follow the Diffusers `Timesteps` module SDXL uses.
# ---------------------------------------------------------------------------


@register("time_embed", "reference")
def time_embed(
    t: jax.Array,
    *,
    dim: int,
    max_period: float = 10000.0,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
):
    """Sinusoidal embedding of (B,) timesteps -> (B, dim). fp32 output."""
    half = dim // 2
    exponent = -np.log(max_period) * jnp.arange(half, dtype=jnp.float32)
    exponent = exponent / (half - downscale_freq_shift)
    freqs = jnp.exp(exponent)
    args = t.astype(jnp.float32)[:, None] * freqs[None, :]
    sin, cos = jnp.sin(args), jnp.cos(args)
    if flip_sin_to_cos:
        return jnp.concatenate([cos, sin], axis=-1)
    return jnp.concatenate([sin, cos], axis=-1)


# ---------------------------------------------------------------------------
# conv2d (+ bias + optional residual add) — the reference left conv on cuDNN
# (its Triton convs were ~40x slower, Conv_Kernels/README.md:2). Here too XLA
# hands the conv to cuDNN; the fused residual-add variant closes the
# reference's documented gap at the op-boundary level (XLA fuses the epilogue).
# ---------------------------------------------------------------------------


@register("conv2d", "reference")
def conv2d(
    x: jax.Array,
    w: jax.Array,
    b: jax.Array | None = None,
    *,
    stride: int = 1,
    padding: int | tuple = 1,
    residual: jax.Array | None = None,
    act: str | None = None,
):
    """NHWC conv with HWIO weights; optional bias, residual add, activation.

    ``padding``: int (symmetric) or ((top, bottom), (left, right)) — the VAE
    encoder's downsamplers use the asymmetric (0,1)x(0,1) form. Quantized
    (w_int8, scale) pairs are dequantized here (exact-path fallback).
    """
    if isinstance(w, tuple):
        wq, scale = w
        w = wq.astype(jnp.float32) * scale
    if isinstance(padding, int):
        padding = [(padding, padding), (padding, padding)]
    out = jax.lax.conv_general_dilated(
        x,
        w.astype(x.dtype),
        window_strides=(stride, stride),
        padding=list(padding),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32,
    )
    if b is not None:
        bb = b.astype(jnp.float32)
        out = out + (bb[:, None, None, :] if bb.ndim == 2 else bb)
    if residual is not None:
        out = out + residual.astype(jnp.float32)
    out = apply_activation(out, act)
    return out.astype(x.dtype)


@register("gn_conv2d", "reference")
def gn_conv2d(
    x: jax.Array,
    gamma: jax.Array,
    beta: jax.Array,
    w: jax.Array,
    b: jax.Array | None = None,
    *,
    num_groups: int = 32,
    eps: float = 1e-5,
    gn_act: str | None = "silu",
    stride: int = 1,
    padding: int | tuple = 1,
    residual: jax.Array | None = None,
    act: str | None = None,
):
    """GroupNorm(+gn_act) followed by conv2d — the resnet hot pair as ONE op
    so a backend can fuse the GN apply into the conv's input read. This
    reference form composes through the ACTIVE binding of each half, so
    binding gn_conv2d to "reference" reproduces the unfused pipeline exactly
    (including the bf16apply GN default). ``b`` may be (Cout,) or (B, Cout) — the
    per-batch form folds the resnet time-embedding into conv1's bias."""
    from stabletriton_jax.ops.registry import dispatch

    h = dispatch("group_norm", x, gamma, beta, num_groups=num_groups,
                 eps=eps, act=gn_act)
    return dispatch("conv2d", h, w, b, stride=stride, padding=padding,
                    residual=residual, act=act)


@register("conv2d", "int8")
def conv2d_int8(
    x: jax.Array,
    w,
    b: jax.Array | None = None,
    *,
    stride: int = 1,
    padding: int | tuple = 1,
    residual: jax.Array | None = None,
    act: str | None = None,
):
    """W8A8 dynamic-quantized conv (turbo mode, quantize='int8_conv').

    Weights pre-quantized per output channel (HWIO last axis); activations
    quantize per sample (abs-max symmetric over HWC). int8 conv accumulates
    in int32; bias/residual/activation epilogue stays f32.
    """
    if not isinstance(w, tuple):
        return conv2d(x, w, b, stride=stride, padding=padding,
                      residual=residual, act=act)
    wq, scale = w
    if isinstance(padding, int):
        padding = [(padding, padding), (padding, padding)]
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=(1, 2, 3), keepdims=True)
    sx = jnp.maximum(amax, 1e-8) * (1.0 / 127.0)
    xq = jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8)
    acc = jax.lax.conv_general_dilated(
        xq, wq,
        window_strides=(stride, stride),
        padding=list(padding),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32,
    )
    out = acc.astype(jnp.float32) * (sx * scale.astype(jnp.float32))
    if b is not None:
        bb = b.astype(jnp.float32)
        out = out + (bb[:, None, None, :] if bb.ndim == 2 else bb)
    if residual is not None:
        out = out + residual.astype(jnp.float32)
    out = apply_activation(out, act)
    return out.astype(x.dtype)
