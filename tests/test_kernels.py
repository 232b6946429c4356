"""GPU attention backends (ops/gpu.py) vs the float32 reference op, on the CPU.

The "cudnn" backends hand attention to ``jax.nn.dot_product_attention``. cuDNN
itself runs only on a card (tests/test_gpu.py, chip_smoke.py phase 3); here
the wrapper around it — the (B, S, H*D) <-> (B, S, N, D) reshapes, the scale,
the fused q/k/v and k/v slicing, odd and padded lengths — runs with
``implementation="xla"`` over the shape matrix the attention path must cover,
and the choice between cuDNN and the XLA composition is checked as a table.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stabletriton_jax import ops
from stabletriton_jax.ops import gpu, reference

# (b, heads, sq, sk, head_dim)
SHAPES = [
    (1, 2, 64, 64, 16),      # multi-block self
    (2, 3, 100, 100, 32),    # non-multiple-of-8 sequence
    (1, 2, 64, 77, 64),      # SDXL cross kv=77
    (1, 1, 16, 16, 64),      # tiny sequence
    (1, 4, 96, 300, 32),     # long, odd kv
    (1, 2, 256, 256, 64),
    (2, 2, 256, 256, 64),
    (2, 2, 160, 200, 64),    # both lengths odd multiples
    (2, 2, 100, 77, 64),     # cross with odd query length
    (1, 3, 256, 256, 64),    # odd head count
    (1, 2, 192, 192, 80),    # head dim not a power of two
    (1, 8, 256, 256, 64),
    (2, 8, 160, 160, 64),
    (2, 8, 128, 77, 64),
    (1, 8, 64, 77, 64),
    (2, 4, 100, 100, 32),
    (1, 1, 64, 64, 512),     # VAE mid-block head dim
    (2, 10, 64, 77, 64),     # SDXL level-1 head count, cross
    (1, 20, 32, 32, 64),     # SDXL level-2 head count, self
    (2, 5, 33, 77, 64),      # odd everything
]

# bf16 operands round to 8 bits of mantissa before the products; the f32
# reference sees the same rounded values, so the gap is the bf16 output
# rounding and the bf16 probabilities fed to the second product
TOL = {jnp.float32: 2e-5, jnp.bfloat16: 2e-2}


def _qkv(rng, b, h, sq, sk, d, dtype):
    q = rng.standard_normal((b, sq, h * d), dtype=np.float32)
    k = rng.standard_normal((b, sk, h * d), dtype=np.float32)
    v = rng.standard_normal((b, sk, h * d), dtype=np.float32)
    return tuple(jnp.asarray(a).astype(dtype) for a in (q, k, v))


def _ref(q, k, v, h, scale=None):
    """The plain reference op in float32 at full precision, on the same
    (possibly bf16-rounded) inputs."""
    with jax.default_matmul_precision("highest"):
        return reference.attention(q.astype(jnp.float32), k.astype(jnp.float32),
                                   v.astype(jnp.float32), num_heads=h,
                                   scale=scale)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,sq,sk,d", SHAPES)
def test_attention_wrapper_matches_reference(b, h, sq, sk, d, dtype):
    q, k, v = _qkv(np.random.default_rng(0), b, h, sq, sk, d, dtype)
    out = gpu.attention(q, k, v, num_heads=h, implementation="xla")
    assert out.shape == q.shape and out.dtype == q.dtype
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(_ref(q, k, v, h)), atol=TOL[dtype])


@pytest.mark.parametrize("b,h,s,d", [
    (1, 2, 256, 64), (2, 4, 100, 32), (1, 3, 64, 64), (2, 2, 96, 40),
    (2, 10, 64, 64),
])
def test_attention_qkv_wrapper_slices_fused_projection(b, h, s, d):
    rng = np.random.default_rng(7)
    qkv = jnp.asarray(rng.standard_normal((b, s, 3 * h * d), dtype=np.float32))
    out = gpu.attention_qkv(qkv, num_heads=h, implementation="xla")
    q, k, v = jnp.split(qkv, 3, axis=-1)
    np.testing.assert_allclose(np.asarray(out), np.asarray(_ref(q, k, v, h)),
                               atol=TOL[jnp.float32])


@pytest.mark.parametrize("b,h,sq,sk,d", [
    (2, 2, 128, 77, 64), (1, 4, 96, 300, 32), (1, 1, 64, 77, 64),
    (2, 20, 16, 77, 64),
])
def test_attention_kv_wrapper_slices_fused_projection(b, h, sq, sk, d):
    rng = np.random.default_rng(8)
    q = jnp.asarray(rng.standard_normal((b, sq, h * d), dtype=np.float32))
    kv = jnp.asarray(rng.standard_normal((b, sk, 2 * h * d), dtype=np.float32))
    out = gpu.attention_kv(q, kv, num_heads=h, implementation="xla")
    k, v = jnp.split(kv, 2, axis=-1)
    np.testing.assert_allclose(np.asarray(out), np.asarray(_ref(q, k, v, h)),
                               atol=TOL[jnp.float32])


@pytest.mark.parametrize("scale", [0.05, 1.0])
def test_attention_wrapper_passes_scale(scale):
    q, k, v = _qkv(np.random.default_rng(3), 2, 2, 48, 77, 32, jnp.float32)
    out = gpu.attention(q, k, v, num_heads=2, scale=scale, implementation="xla")
    np.testing.assert_allclose(np.asarray(out),
                               np.asarray(_ref(q, k, v, 2, scale=scale)),
                               atol=TOL[jnp.float32])


@pytest.mark.parametrize("dtype,d,ok", [
    (jnp.bfloat16, 64, True),
    (jnp.float16, 128, True),
    (jnp.bfloat16, 256, True),
    (jnp.bfloat16, 8, True),
    (jnp.bfloat16, 512, False),   # VAE mid-block
    (jnp.bfloat16, 20, False),    # not a multiple of 8
    (jnp.float32, 64, False),     # cuDNN's flash attention is 16-bit only
])
def test_cudnn_supports_table(dtype, d, ok):
    assert gpu.cudnn_supports(dtype, d) is ok


@pytest.mark.parametrize("dtype,d", [
    (jnp.float32, 64), (jnp.bfloat16, 512), (jnp.bfloat16, 20),
])
def test_cudnn_backend_keeps_xla_where_cudnn_refuses(dtype, d):
    """Shapes cuDNN does not take never reach it: the cudnn backend returns
    exactly the plain reference composition (so this runs on the CPU)."""
    q, k, v = _qkv(np.random.default_rng(5), 1, 2, 32, 40, d, dtype)
    out = gpu.attention(q, k, v, num_heads=2)
    want = reference.attention(q, k, v, num_heads=2)
    np.testing.assert_array_equal(np.asarray(out, np.float32),
                                  np.asarray(want, np.float32))


def test_gpu_backends_registered():
    reg = ops.registered_ops()
    for op in ("attention", "attention_qkv", "attention_kv"):
        assert "cudnn" in reg[op], op
    assert "conv2d" in reg and "reference" in reg["conv2d"]


def test_fused_attention_ops_dispatch():
    """The public ops route to the bound backend: under the cudnn binding
    the fp32 tiny shapes take its XLA branch and agree with the reference
    binding bit for bit."""
    q, k, v = _qkv(np.random.default_rng(9), 1, 2, 16, 16, 16, jnp.float32)
    qkv = jnp.concatenate([q, k, v], axis=-1)
    kv = jnp.concatenate([k, v], axis=-1)
    want = (ops.attention(q, k, v, num_heads=2),
            ops.attention_qkv(qkv, num_heads=2),
            ops.attention_kv(q, kv, num_heads=2))
    with ops.use_backends({"attention": "cudnn", "attention_qkv": "cudnn",
                           "attention_kv": "cudnn"}):
        got = (ops.attention(q, k, v, num_heads=2),
               ops.attention_qkv(qkv, num_heads=2),
               ops.attention_kv(q, kv, num_heads=2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
