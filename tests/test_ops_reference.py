"""Unit tests of the reference (jnp) op implementations against NumPy/torch math.

Mirrors the reference repo's per-kernel eager-vs-kernel 1e-3 asserts
(e.g. reference kernels/geglu.py:37-43), but as a real pytest suite.
torch (CPU) is used only as an independent oracle for norm/activation math.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletriton_jax import ops
from stabletriton_jax.ops.registry import registered_ops


def to_t(x):
    return torch.from_numpy(np.asarray(x).copy())


def test_registry_lists_all_ops():
    reg = registered_ops()
    for op in ["attention", "group_norm", "layer_norm", "geglu", "linear",
               "time_embed", "conv2d"]:
        assert "reference" in reg[op], op


def test_attention_matches_torch_sdpa():
    rng = np.random.default_rng(0)
    h, d = 3, 8
    q = rng.standard_normal((2, 16, h * d), dtype=np.float32)
    k = rng.standard_normal((2, 24, h * d), dtype=np.float32)
    v = rng.standard_normal((2, 24, h * d), dtype=np.float32)
    out = ops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_heads=h)

    def split(x, s):
        return to_t(x).reshape(2, s, h, d).permute(0, 2, 1, 3)

    ref = torch.nn.functional.scaled_dot_product_attention(
        split(q, 16), split(k, 24), split(v, 24)
    ).permute(0, 2, 1, 3).reshape(2, 16, h * d)
    np.testing.assert_allclose(np.asarray(out), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_matches_torch(act):
    rng = np.random.default_rng(1)
    n, h, w, c, g = 2, 5, 7, 16, 4
    x = rng.standard_normal((n, h, w, c), dtype=np.float32)
    gamma = rng.standard_normal(c, dtype=np.float32)
    beta = rng.standard_normal(c, dtype=np.float32)
    out = ops.group_norm(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                         num_groups=g, eps=1e-5, act=act)
    # torch group_norm is NCHW
    ref = torch.nn.functional.group_norm(
        to_t(x).permute(0, 3, 1, 2), g, to_t(gamma), to_t(beta), eps=1e-5
    )
    if act == "silu":
        ref = torch.nn.functional.silu(ref)
    np.testing.assert_allclose(
        np.asarray(out), ref.permute(0, 2, 3, 1).numpy(), atol=1e-5
    )


def test_layer_norm_matches_torch():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 11, 32), dtype=np.float32)
    gamma = rng.standard_normal(32, dtype=np.float32)
    beta = rng.standard_normal(32, dtype=np.float32)
    out = ops.layer_norm(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), eps=1e-5)
    ref = torch.nn.functional.layer_norm(to_t(x), (32,), to_t(gamma), to_t(beta), eps=1e-5)
    np.testing.assert_allclose(np.asarray(out), ref.numpy(), atol=1e-5)


def test_geglu_matches_torch():
    rng = np.random.default_rng(3)
    state = rng.standard_normal((4, 17), dtype=np.float32)
    gate = rng.standard_normal((4, 17), dtype=np.float32)
    out = ops.geglu(jnp.asarray(state), jnp.asarray(gate))
    ref = to_t(state) * torch.nn.functional.gelu(to_t(gate))
    np.testing.assert_allclose(np.asarray(out), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("act", [None, "silu"])
def test_linear_matches_torch(act):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 12), dtype=np.float32)
    w = rng.standard_normal((12, 7), dtype=np.float32)
    b = rng.standard_normal(7, dtype=np.float32)
    out = ops.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), act=act)
    ref = to_t(x) @ to_t(w) + to_t(b)
    if act == "silu":
        ref = torch.nn.functional.silu(ref)
    np.testing.assert_allclose(np.asarray(out), ref.numpy(), atol=1e-5)


def test_time_embed_matches_diffusers_semantics():
    """Independent numpy re-derivation of the Diffusers Timesteps math
    (sin/cos of t * exp(-ln(1e4) * i / half)), flip_sin_to_cos=True."""
    t = np.array([0.0, 1.0, 999.0], dtype=np.float32)
    dim = 16
    half = dim // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / half).astype(np.float32)
    args = t[:, None] * freqs[None, :]
    expected = np.concatenate([np.cos(args), np.sin(args)], axis=-1)
    out = ops.time_embed(jnp.asarray(t), dim=dim)
    np.testing.assert_allclose(np.asarray(out), expected, atol=1e-5)


@pytest.mark.parametrize("stride,padding,kernel", [(1, 1, 3), (2, 1, 3), (1, 0, 1)])
def test_conv2d_matches_torch(stride, padding, kernel):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, 3), dtype=np.float32)
    w = rng.standard_normal((kernel, kernel, 3, 6), dtype=np.float32)
    b = rng.standard_normal(6, dtype=np.float32)
    out = ops.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                     stride=stride, padding=padding)
    ref = torch.nn.functional.conv2d(
        to_t(x).permute(0, 3, 1, 2), to_t(w).permute(3, 2, 0, 1), to_t(b),
        stride=stride, padding=padding,
    ).permute(0, 2, 3, 1)
    np.testing.assert_allclose(np.asarray(out), ref.numpy(), atol=1e-4)


def test_conv2d_residual_fusion():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 4, 4, 2), dtype=np.float32)
    w = rng.standard_normal((3, 3, 2, 2), dtype=np.float32)
    res = rng.standard_normal((1, 4, 4, 2), dtype=np.float32)
    fused = ops.conv2d(jnp.asarray(x), jnp.asarray(w), residual=jnp.asarray(res))
    plain = ops.conv2d(jnp.asarray(x), jnp.asarray(w)) + jnp.asarray(res)
    np.testing.assert_allclose(np.asarray(fused), np.asarray(plain), atol=1e-6)


def test_use_backends_binding():
    calls = []

    @ops.register("geglu", "probe")
    def probe_geglu(state, gate):
        calls.append("probe")
        return state

    try:
        with ops.use_backends(geglu="probe"):
            ops.geglu(jnp.ones((2, 2)), jnp.ones((2, 2)))
        assert calls == ["probe"]
        # binding restored
        out = ops.geglu(jnp.zeros((2, 2)), jnp.zeros((2, 2)))
        assert calls == ["probe"]
        assert np.all(np.asarray(out) == 0)
    finally:
        from stabletriton_jax.ops.registry import _REGISTRY
        _REGISTRY["geglu"].pop("probe", None)


def test_group_norm_onepass_matches_two_pass():
    """The one-pass channel-major GN variant must match the two-pass reference
    (it is A/B-able as a binding override)."""
    import jax.numpy as jnp
    import numpy as np

    from stabletriton_jax.ops.reference import group_norm, group_norm_onepass

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 8, 8, 64), dtype=np.float32) * 3 + 1)
    g = jnp.asarray(rng.standard_normal(64, dtype=np.float32))
    b = jnp.asarray(rng.standard_normal(64, dtype=np.float32))
    a1 = group_norm(x, g, b, num_groups=8, act="silu")
    a2 = group_norm_onepass(x, g, b, num_groups=8, act="silu")
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a2), atol=2e-5)
    # bf16 input path
    xb = x.astype(jnp.bfloat16)
    a1 = group_norm(xb, g, b, num_groups=8)
    a2 = group_norm_onepass(xb, g, b, num_groups=8)
    np.testing.assert_allclose(np.asarray(a1, np.float32),
                               np.asarray(a2, np.float32), atol=2e-2)


def test_group_norm_bf16apply_close():
    """The turbo bf16-apply GN stays close to the f32 reference (draft-mode
    bound, looser than the 1e-3 exact contract)."""
    import jax.numpy as jnp
    import numpy as np

    from stabletriton_jax.ops.reference import group_norm, group_norm_bf16apply

    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((2, 8, 8, 64), dtype=np.float32) * 2
                    ).astype(jnp.bfloat16)
    g = jnp.asarray(rng.standard_normal(64, dtype=np.float32))
    b = jnp.asarray(rng.standard_normal(64, dtype=np.float32))
    a1 = group_norm(x, g, b, num_groups=8, act="silu")
    a2 = group_norm_bf16apply(x, g, b, num_groups=8, act="silu")
    np.testing.assert_allclose(np.asarray(a1, np.float32),
                               np.asarray(a2, np.float32),
                               atol=5e-2, rtol=5e-2)


def test_layer_norm_bf16apply_close():
    """bf16-apply LN: BIT-identical to the f32 reference on f32 inputs (both
    use the two-pass variance and the apply dtype is then f32 too), close at
    the draft-mode bound on bf16 inputs — including rows with a large mean
    relative to std, where a one-pass E[x^2]-mean^2 variance would cancel."""
    import jax.numpy as jnp
    import numpy as np

    from stabletriton_jax.ops.reference import layer_norm, layer_norm_bf16apply

    rng = np.random.default_rng(6)
    xf_np = rng.standard_normal((2, 64, 96), dtype=np.float32) * 2
    # large-mean rows: |mean|/std ~ 300 — the one-pass variance loses ~half
    # its f32 mantissa here; the two-pass form does not care.
    xf_np[1] += 600.0
    xf = jnp.asarray(xf_np)
    g = jnp.asarray(rng.standard_normal(96, dtype=np.float32))
    b = jnp.asarray(rng.standard_normal(96, dtype=np.float32))
    np.testing.assert_array_equal(np.asarray(layer_norm(xf, g, b)),
                                  np.asarray(layer_norm_bf16apply(xf, g, b)))
    # bf16 leg on the zero-mean rows only: at mean ~600 the bf16-cast mean
    # quantizes at ~1 std, which is the inherent (documented) draft-mode cost
    # of applying in bf16, not a variance-formula artifact.
    xb = jnp.asarray(xf_np[:1]).astype(jnp.bfloat16)
    np.testing.assert_allclose(np.asarray(layer_norm(xb, g, b), np.float32),
                               np.asarray(layer_norm_bf16apply(xb, g, b), np.float32),
                               atol=5e-2, rtol=5e-2)


def test_barrier_variants_identical():
    """The 'barrier' norm variants only insert an optimization barrier — the
    numerics must be BIT-identical to their base impls (they stay inside the
    1e-3 exact path, unlike turbo)."""
    import jax.numpy as jnp
    import numpy as np

    from stabletriton_jax.ops.reference import (
        group_norm_barrier,
        group_norm_onepass,
        layer_norm,
        layer_norm_barrier,
    )

    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((2, 8, 8, 64), dtype=np.float32))
    g = jnp.asarray(rng.standard_normal(64, dtype=np.float32))
    b = jnp.asarray(rng.standard_normal(64, dtype=np.float32))
    np.testing.assert_array_equal(
        np.asarray(group_norm_barrier(x, g, b, num_groups=8, act="silu")),
        np.asarray(group_norm_onepass(x, g, b, num_groups=8, act="silu")))
    x2 = jnp.asarray(rng.standard_normal((2, 16, 64), dtype=np.float32))
    np.testing.assert_array_equal(
        np.asarray(layer_norm_barrier(x2, g, b)),
        np.asarray(layer_norm(x2, g, b)))
