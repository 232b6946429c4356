"""GPU backends of the attention ops ("cudnn" in the binding).

Every attention op goes through ``jax.nn.dot_product_attention``, a JAX
library call that XLA hands to cuDNN's fused flash attention on Hopper: the
(B, Sq, Sk) score tensor never reaches device memory. Its (B, T, N, H)
layout is a free reshape of the model's channel-packed (B, S, H*D)
activations, so no head transposes surround the call. cuDNN takes bf16/fp16
operands with a head dim that is a multiple of 8 and at most 256; any other
shape (the fp32 VAE decoder, its d=512 mid-block attention) keeps the plain
XLA composition of ``ops/reference.py``.

``implementation`` is exposed so the wrapper (reshapes, scale, fused
projection slicing) is testable on the CPU with ``implementation="xla"``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from stabletriton_jax.ops import reference
from stabletriton_jax.ops.registry import register

CUDNN_DTYPES = (jnp.bfloat16, jnp.float16)
CUDNN_MAX_HEAD_DIM = 256  # Hopper; 128 before it


def cudnn_supports(dtype, head_dim: int) -> bool:
    """Whether cuDNN's flash attention takes this operand dtype / head dim."""
    return (jnp.dtype(dtype) in [jnp.dtype(d) for d in CUDNN_DTYPES]
            and head_dim % 8 == 0 and head_dim <= CUDNN_MAX_HEAD_DIM)


@register("attention", "cudnn")
def attention(q: jax.Array, k: jax.Array, v: jax.Array, *, num_heads: int = 1,
              scale: float | None = None, implementation: str = "cudnn"):
    """Same contract as ``reference.attention``: q (B, Sq, H*D), k/v
    (B, Sk, H*D) -> (B, Sq, H*D)."""
    b, sq, c = q.shape
    sk = k.shape[1]
    d = c // num_heads
    if implementation == "cudnn" and not cudnn_supports(q.dtype, d):
        return reference.attention(q, k, v, num_heads=num_heads, scale=scale)
    out = jax.nn.dot_product_attention(
        q.reshape(b, sq, num_heads, d),
        k.reshape(b, sk, num_heads, d),
        v.reshape(b, sk, num_heads, d),
        scale=scale,
        implementation=implementation,
    )
    return out.reshape(b, sq, c)


@register("attention_qkv", "cudnn")
def attention_qkv(qkv: jax.Array, *, num_heads: int = 1,
                  scale: float | None = None, implementation: str = "cudnn"):
    """Self-attention over the fused (B, S, 3*H*D) projection output."""
    q, k, v = jnp.split(qkv, 3, axis=-1)
    return attention(q, k, v, num_heads=num_heads, scale=scale,
                     implementation=implementation)


@register("attention_kv", "cudnn")
def attention_kv(q: jax.Array, kv: jax.Array, *, num_heads: int = 1,
                 scale: float | None = None, implementation: str = "cudnn"):
    """Cross-attention over the fused (B, Sk, 2*H*D) K/V projection output."""
    k, v = jnp.split(kv, 2, axis=-1)
    return attention(q, k, v, num_heads=num_heads, scale=scale,
                     implementation=implementation)
