"""Opt-in int8 turbo mode: quantization prepass, binding, end-to-end quality.

The turbo path intentionally breaks the 1e-3 fidelity gate (its numbers are
reported separately); these tests pin the contract: eligible weights
quantize, exact paths remain for the rest, and the quantized UNet stays
*close* to the float model (draft-quality bound)."""

import jax.numpy as jnp
import numpy as np

from stabletriton_jax.compile import (
    CompileConfig,
    compile_unet,
    fuse_attention_projections,
    quantize_linear_weights,
    resolve_binding,
)
from stabletriton_jax.models.unet import init_unet_params, tiny_unet_config, unet_apply


def test_quantize_selects_eligible_weights():
    cfg = tiny_unet_config()
    params = fuse_attention_projections(init_unet_params(cfg, 0))
    q = quantize_linear_weights(params, min_dim=16)
    quantized = [k for k, v in q.items() if isinstance(v, tuple)]
    assert any(".to_qkv.weight" in k for k in quantized)
    assert any(".ff.net.0.proj.weight" in k for k in quantized)
    assert not any("time_embedding" in k for k in quantized)
    for k in quantized:
        wq, scale = q[k]
        assert wq.dtype == jnp.int8 and scale.shape == (wq.shape[1],)
        # dequantized weight within half a quantization step of the original
        back = np.asarray(wq, np.float32) * np.asarray(scale)
        err = np.abs(back - np.asarray(params[k], np.float32)).max()
        assert err <= 0.51 * float(np.asarray(scale).max())
    # conv / norm / bias untouched
    assert not isinstance(q["conv_in.weight"], tuple)


def test_int8_binding_resolution():
    binding = resolve_binding(CompileConfig(quantize="int8"))
    assert binding["linear"] == "int8"
    binding = resolve_binding(CompileConfig(backend="reference", quantize="int8"))
    assert binding["linear"] == "int8"
    binding = resolve_binding(CompileConfig(quantize="int8_ff"), platform="gpu")
    assert binding["linear"] == "int8"


def test_quantize_ff_only_selects_geglu_ups():
    """int8_ff quantizes ONLY the GEGLU up-projections, the widest GEMMs
    (compile.quantize_linear_weights)."""
    cfg = tiny_unet_config()
    params = fuse_attention_projections(init_unet_params(cfg, 0))
    q = quantize_linear_weights(params, min_dim=16, ff_only=True)
    quantized = [k for k, v in q.items() if isinstance(v, tuple)]
    assert quantized, "no GEGLU up-projections found"
    assert all(".net.0.proj." in k for k in quantized)
    assert not any(".to_qkv." in k for k in quantized)


def test_int8_linear_matches_dequant_reference():
    from stabletriton_jax.ops.reference import linear, linear_int8

    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.standard_normal((64, 96), dtype=np.float32) * 0.3)
    scale = jnp.maximum(jnp.max(jnp.abs(w), axis=0), 1e-12) / 127.0
    wq = jnp.clip(jnp.round(w / scale), -127, 127).astype(jnp.int8)
    x = jnp.asarray(rng.standard_normal((4, 64), dtype=np.float32))
    b = jnp.asarray(rng.standard_normal(96, dtype=np.float32) * 0.1)
    got = linear_int8(x, (wq, scale), b, act="silu")
    want = linear(x, (wq, scale), b, act="silu")  # exact dot on dequant weights
    # activation quantization error only: per-token 8-bit symmetric
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert err < 0.05, err
    # un-quantized weight passes through to the exact path bit-for-bit
    np.testing.assert_allclose(
        np.asarray(linear_int8(x, w, b)), np.asarray(linear(x, w, b)), atol=1e-6
    )


def test_turbo_unet_close_to_float():
    """Full tiny-UNet forward, turbo vs exact: draft-quality bound (the output
    is a noise prediction with O(1) scale; relative error must stay small
    even though it exceeds the 1e-3 exact gate)."""
    from stabletriton_jax import ops

    cfg = tiny_unet_config()
    params = fuse_attention_projections(init_unet_params(cfg, 0))
    qparams = quantize_linear_weights(params, min_dim=16)

    rng = np.random.default_rng(1)
    args = (
        jnp.asarray(rng.standard_normal((2, 16, 16, 4), dtype=np.float32)),
        jnp.full((2,), 500.0),
        jnp.asarray(rng.standard_normal((2, 7, cfg.cross_attention_dim), dtype=np.float32)),
        jnp.asarray(rng.standard_normal((2, 16), dtype=np.float32)),
        jnp.zeros((2, 6)),
    )
    exact = unet_apply(cfg, params, *args)
    with ops.use_backends({"linear": "int8"}):
        turbo = unet_apply(cfg, qparams, *args)
    exact, turbo = np.asarray(exact), np.asarray(turbo)
    rel = np.abs(turbo - exact).max() / max(np.abs(exact).max(), 1e-6)
    assert rel < 0.15, rel                       # draft mode, not garbage
    assert not np.allclose(turbo, exact, atol=1e-4)  # and actually quantized


def test_turbo_pipeline_txt2img_runs():
    from stabletriton_jax.runtime.pipeline import make_tiny_pipeline

    pipe = make_tiny_pipeline(
        CompileConfig(dtype="float32", quantize="int8",
                      quantize_min_dim=16)
    )
    assert any(isinstance(v, tuple) for v in pipe.params["unet"].values())
    ids = np.full((1, 16), 5, np.int32)
    ids[:, -1] = 99
    img = pipe.txt2img(jnp.asarray(ids), jnp.asarray(ids), height=32, width=32,
                       steps=2, seed=0)
    assert img.shape == (1, 32, 32, 3)
    assert np.isfinite(np.asarray(img)).all()


def test_int8_conv_matches_dequant_reference():
    from stabletriton_jax.ops.reference import conv2d, conv2d_int8

    rng = np.random.default_rng(2)
    w = jnp.asarray(rng.standard_normal((3, 3, 32, 48), dtype=np.float32) * 0.2)
    scale = jnp.maximum(jnp.max(jnp.abs(w), axis=(0, 1, 2)), 1e-12) / 127.0
    wq = jnp.clip(jnp.round(w / scale), -127, 127).astype(jnp.int8)
    x = jnp.asarray(rng.standard_normal((2, 8, 8, 32), dtype=np.float32))
    b = jnp.asarray(rng.standard_normal(48, dtype=np.float32) * 0.1)
    res = jnp.asarray(rng.standard_normal((2, 8, 8, 48), dtype=np.float32))
    got = conv2d_int8(x, (wq, scale), b, residual=res, act="silu")
    want = conv2d(x, (wq, scale), b, residual=res, act="silu")
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert err < 0.15, err  # per-tensor activation quant over a 288-term sum
    # un-quantized weights pass through exactly
    np.testing.assert_allclose(
        np.asarray(conv2d_int8(x, w, b)), np.asarray(conv2d(x, w, b)), atol=1e-6
    )


def test_int8_conv_mode_selection():
    cfg = tiny_unet_config()
    params = init_unet_params(cfg, 0)
    q = quantize_linear_weights(params, min_dim=16, conv=True)
    conv_q = [k for k, v in q.items()
              if isinstance(v, tuple) and v[0].ndim == 4]
    assert any("resnets" in k and ".conv1." in k for k in conv_q)
    assert not isinstance(q["conv_in.weight"], tuple)   # 4-ch side stays exact
    assert not isinstance(q["conv_out.weight"], tuple)
    binding = resolve_binding(CompileConfig(quantize="int8_conv"))
    assert binding["conv2d"] == "int8" and binding["linear"] == "int8"


def test_turbo_conv_unet_close_to_float():
    from stabletriton_jax import ops

    cfg = tiny_unet_config()
    params = fuse_attention_projections(init_unet_params(cfg, 0))
    qparams = quantize_linear_weights(params, min_dim=16, conv=True)
    rng = np.random.default_rng(3)
    args = (
        jnp.asarray(rng.standard_normal((2, 16, 16, 4), dtype=np.float32)),
        jnp.full((2,), 500.0),
        jnp.asarray(rng.standard_normal((2, 7, cfg.cross_attention_dim), dtype=np.float32)),
        jnp.asarray(rng.standard_normal((2, 16), dtype=np.float32)),
        jnp.zeros((2, 6)),
    )
    exact = unet_apply(cfg, params, *args)
    with ops.use_backends({"linear": "int8", "conv2d": "int8"}):
        turbo = unet_apply(cfg, qparams, *args)
    exact, turbo = np.asarray(exact), np.asarray(turbo)
    rel = np.abs(turbo - exact).max() / max(np.abs(exact).max(), 1e-6)
    assert rel < 0.25, rel  # draft mode with quantized convs: looser bound
