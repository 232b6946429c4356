"""The plain reference ops against independent oracles.

On the GPU the default binding leaves convs, norms, GEGLU and the time
embedding on these reference implementations (XLA hands the convs to cuDNN),
so they carry the model's numerics. Convs are checked against a separately
laid-out ``lax.conv_general_dilated`` (NCHW/OIHW, float32, HIGHEST) with the
epilogue in numpy; norms, GEGLU and the time embedding against float64 numpy.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stabletriton_jax.ops import reference

# ---------------------------------------------------------------------------
# conv2d
# ---------------------------------------------------------------------------


def _conv_oracle(x, w, b, *, stride, padding, residual, act):
    """NCHW/OIHW float32 HIGHEST conv + numpy float64 epilogue."""
    xc = jnp.asarray(np.asarray(x, np.float32).transpose(0, 3, 1, 2))
    wc = jnp.asarray(np.asarray(w, np.float32).transpose(3, 2, 0, 1))
    if isinstance(padding, int):
        padding = ((padding, padding), (padding, padding))
    out = jax.lax.conv_general_dilated(
        xc, wc, (stride, stride), padding,
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=jax.lax.Precision.HIGHEST)
    out = np.asarray(out, np.float64).transpose(0, 2, 3, 1)
    if b is not None:
        bb = np.asarray(b, np.float64)
        out = out + (bb[:, None, None, :] if bb.ndim == 2 else bb)
    if residual is not None:
        out = out + np.asarray(residual, np.float64)
    if act == "silu":
        out = out / (1.0 + np.exp(-out))
    return out


# (label, b, size, cin, cout, k, stride, padding, bias, residual, act)
CONV_CASES = [
    ("3x3", 2, 8, 8, 16, 3, 1, 1, "vec", False, None),
    ("1x1", 2, 8, 8, 16, 1, 1, 0, "vec", False, None),
    ("3x3 stride2", 2, 8, 8, 16, 3, 2, 1, "vec", False, None),
    ("3x3 stride2 asym pad", 1, 8, 8, 8, 3, 2, ((0, 1), (0, 1)), "vec", False, None),
    ("residual", 2, 8, 8, 16, 3, 1, 1, "vec", True, None),
    ("silu", 2, 8, 8, 16, 3, 1, 1, "vec", False, "silu"),
    ("per-batch bias", 2, 8, 8, 16, 3, 1, 1, "batch", False, None),
    ("per-batch bias + residual + silu", 2, 6, 16, 8, 3, 1, 1, "batch", True, "silu"),
    ("no bias", 1, 5, 8, 8, 3, 1, 1, None, False, None),
    ("inpaint conv_in 9->320", 1, 8, 9, 320, 3, 1, 1, "vec", False, None),
    ("conv_in 4->320", 1, 4, 4, 320, 3, 1, 1, "vec", False, None),
    ("conv_out 320->4", 1, 4, 320, 4, 3, 1, 1, "vec", False, None),
    ("320->320", 1, 4, 320, 320, 3, 1, 1, "batch", True, None),
    ("320->640", 1, 4, 320, 640, 3, 1, 1, "batch", False, None),
    ("640->640", 1, 4, 640, 640, 3, 1, 1, "vec", True, None),
    ("640->1280", 1, 4, 640, 1280, 3, 1, 1, "batch", False, None),
    ("1280->1280", 1, 4, 1280, 1280, 3, 1, 1, "vec", True, None),
    ("2560->1280 shortcut 1x1", 1, 4, 2560, 1280, 1, 1, 0, "vec", False, None),
    ("1920->640", 1, 4, 1920, 640, 3, 1, 1, "batch", False, None),
    ("960->320", 1, 4, 960, 320, 3, 1, 1, "batch", False, None),
]


@pytest.mark.parametrize(
    "label,b,size,cin,cout,k,stride,padding,bias,res,act", CONV_CASES,
    ids=[c[0] for c in CONV_CASES])
def test_conv2d_reference_matches_lax_oracle(label, b, size, cin, cout, k,
                                             stride, padding, bias, res, act):
    rng = np.random.default_rng(sum(map(ord, label)))
    x = jnp.asarray(rng.standard_normal((b, size, size, cin), dtype=np.float32))
    w = jnp.asarray(rng.standard_normal((k, k, cin, cout), dtype=np.float32)
                    / math.sqrt(k * k * cin))
    bb = {None: None,
          "vec": jnp.asarray(rng.standard_normal(cout, dtype=np.float32)),
          "batch": jnp.asarray(rng.standard_normal((b, cout), dtype=np.float32)),
          }[bias]
    out_hw = (size + 2 * (padding if isinstance(padding, int) else 0)
              + (sum(padding[0]) if not isinstance(padding, int) else 0)
              - k) // stride + 1
    residual = (jnp.asarray(rng.standard_normal((b, out_hw, out_hw, cout),
                                                dtype=np.float32))
                if res else None)
    with jax.default_matmul_precision("highest"):
        out = reference.conv2d(x, w, bb, stride=stride, padding=padding,
                               residual=residual, act=act)
    want = _conv_oracle(x, w, bb, stride=stride, padding=padding,
                        residual=residual, act=act)
    assert out.shape == want.shape
    np.testing.assert_allclose(np.asarray(out, np.float64), want, atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("groups,gn_act,res", [
    (4, "silu", False), (8, "silu", True), (4, None, False),
])
def test_gn_conv2d_reference_matches_oracle(groups, gn_act, res):
    rng = np.random.default_rng(groups)
    x = rng.standard_normal((2, 6, 6, 16)) * 2 + 0.5
    gamma, beta = rng.standard_normal(16), rng.standard_normal(16)
    w = rng.standard_normal((3, 3, 16, 8)) / 12
    b = rng.standard_normal((2, 8))
    residual = rng.standard_normal((2, 6, 6, 8)) if res else None
    f32 = lambda a: None if a is None else jnp.asarray(a, jnp.float32)  # noqa: E731
    with jax.default_matmul_precision("highest"):
        out = reference.gn_conv2d(f32(x), f32(gamma), f32(beta), f32(w), f32(b),
                                  num_groups=groups, gn_act=gn_act,
                                  residual=f32(residual))
    h = _group_norm_oracle(x, gamma, beta, groups, gn_act)
    want = _conv_oracle(h.astype(np.float32), w.astype(np.float32), b,
                        stride=1, padding=1, residual=residual, act=None)
    np.testing.assert_allclose(np.asarray(out, np.float64), want, atol=1e-4)


# ---------------------------------------------------------------------------
# norms, GEGLU, time embedding (float64 numpy oracles)
# ---------------------------------------------------------------------------


def _silu(x):
    return x / (1.0 + np.exp(-x))


def _group_norm_oracle(x, gamma, beta, groups, act, eps=1e-5):
    n, h, w, c = x.shape
    xg = np.asarray(x, np.float64).reshape(n, h * w, groups, c // groups)
    mean = xg.mean(axis=(1, 3), keepdims=True)
    var = ((xg - mean) ** 2).mean(axis=(1, 3), keepdims=True)
    out = ((xg - mean) / np.sqrt(var + eps)).reshape(n, h, w, c)
    out = out * np.asarray(gamma, np.float64) + np.asarray(beta, np.float64)
    return _silu(out) if act == "silu" else out


def _layer_norm_oracle(x, gamma, beta, eps=1e-5):
    x = np.asarray(x, np.float64)
    mean = x.mean(-1, keepdims=True)
    var = ((x - mean) ** 2).mean(-1, keepdims=True)
    return ((x - mean) / np.sqrt(var + eps)) * np.asarray(gamma, np.float64) \
        + np.asarray(beta, np.float64)


@pytest.mark.parametrize("impl", ["reference", "bf16apply"])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 16), 4), ((1, 9, 7, 24), 8)])
def test_group_norm_matches_float64_oracle(shape, groups, act, impl):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape) * 3 + 1.0
    gamma, beta = rng.standard_normal(shape[-1]), rng.standard_normal(shape[-1])
    fn = {"reference": reference.group_norm,
          "bf16apply": reference.group_norm_bf16apply}[impl]
    out = fn(jnp.asarray(x, jnp.float32), jnp.asarray(gamma, jnp.float32),
             jnp.asarray(beta, jnp.float32), num_groups=groups, act=act)
    np.testing.assert_allclose(np.asarray(out, np.float64),
                               _group_norm_oracle(x, gamma, beta, groups, act),
                               atol=1e-4)


@pytest.mark.parametrize("impl", ["reference", "bf16apply"])
@pytest.mark.parametrize("shape", [(6, 32), (3, 11, 48)])
def test_layer_norm_matches_float64_oracle(shape, impl):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape) * 2 + 5.0  # large mean: no cancellation
    gamma, beta = rng.standard_normal(shape[-1]), rng.standard_normal(shape[-1])
    fn = {"reference": reference.layer_norm,
          "bf16apply": reference.layer_norm_bf16apply}[impl]
    out = fn(jnp.asarray(x, jnp.float32), jnp.asarray(gamma, jnp.float32),
             jnp.asarray(beta, jnp.float32))
    np.testing.assert_allclose(np.asarray(out, np.float64),
                               _layer_norm_oracle(x, gamma, beta), atol=1e-4)


@pytest.mark.parametrize("shape", [(6, 32), (3, 11, 48)])
def test_rms_norm_matches_float64_oracle(shape):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape) * 3 + 1.5
    gamma = rng.standard_normal(shape[-1])
    out = reference.rms_norm(jnp.asarray(x, jnp.float32),
                             jnp.asarray(gamma, jnp.float32))
    want = x / np.sqrt((x ** 2).mean(-1, keepdims=True) + 1e-5) * gamma
    np.testing.assert_allclose(np.asarray(out, np.float64), want, atol=1e-4)


@pytest.mark.parametrize("shape", [(5, 13, 32), (2, 77, 40)])
def test_geglu_matches_float64_oracle(shape):
    from scipy.special import erf

    rng = np.random.default_rng(4)
    state, gate = rng.standard_normal(shape), rng.standard_normal(shape)
    out = reference.geglu(jnp.asarray(state, jnp.float32),
                          jnp.asarray(gate, jnp.float32))
    want = state * 0.5 * gate * (1.0 + erf(gate / np.sqrt(2.0)))
    np.testing.assert_allclose(np.asarray(out, np.float64), want, atol=1e-5)


@pytest.mark.parametrize("dim,flip", [(16, True), (320, True), (256, False)])
def test_time_embed_matches_float64_oracle(dim, flip):
    t = np.asarray([0.0, 1.0, 500.0, 999.0])
    out = reference.time_embed(jnp.asarray(t, jnp.float32), dim=dim,
                               flip_sin_to_cos=flip)
    half = dim // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / half)
    args = t[:, None] * freqs[None, :]
    parts = [np.cos(args), np.sin(args)] if flip else [np.sin(args), np.cos(args)]
    # fp32 sin/cos of arguments up to ~1e3 carry ~1e-4 absolute error
    np.testing.assert_allclose(np.asarray(out, np.float64),
                               np.concatenate(parts, -1), atol=5e-4)
