"""Frontend tests: diffusers drop-in wrapper (duck-typed torch UNet), ComfyUI nodes."""

import numpy as np
import torch

from stabletriton_jax.compile import CompileConfig
from stabletriton_jax.models.unet import (
    init_unet_params,
    tiny_unet_config,
    unet_apply,
    unet_param_shapes,
)


class FakeTorchUNet:
    """Duck-types the two things ingestion needs: .config and .state_dict()."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.config = {
            "in_channels": cfg.in_channels,
            "out_channels": cfg.out_channels,
            "block_out_channels": list(cfg.block_out_channels),
            "down_block_types": list(cfg.down_block_types),
            "layers_per_block": cfg.layers_per_block,
            "transformer_layers_per_block": list(cfg.transformer_layers_per_block),
            "attention_head_dim": [c // cfg.attention_head_dim for c in cfg.block_out_channels],
            "cross_attention_dim": cfg.cross_attention_dim,
            "norm_num_groups": cfg.norm_num_groups,
            "addition_time_embed_dim": cfg.addition_time_embed_dim,
            "projection_class_embeddings_input_dim": cfg.projection_class_embeddings_input_dim,
        }
        rng = np.random.default_rng(0)
        self._sd = {}
        for name, shape in sorted(unet_param_shapes(cfg).items()):
            # generate in *torch* layout (inverse of our transposes)
            if name.endswith(".weight") and len(shape) == 2:
                t_shape = (shape[1], shape[0])
            elif len(shape) == 4:
                t_shape = (shape[3], shape[2], shape[0], shape[1])
            else:
                t_shape = shape
            self._sd[name] = torch.from_numpy(
                (rng.standard_normal(t_shape) * 0.05).astype(np.float32)
            )

    def state_dict(self):
        return self._sd


def test_diffusers_compile_drop_in_matches_native():
    """frontends.diffusers.compile(torch_unet) must equal unet_apply on the
    ingested params — the whole capture+convert+execute chain, end to end."""
    from stabletriton_jax.frontends import diffusers as fe
    from stabletriton_jax.io.torch_ingest import state_dict_to_params

    import jax.numpy as jnp

    cfg = tiny_unet_config()
    fake = FakeTorchUNet(cfg)
    compiled = fe.compile(fake, CompileConfig(backend="reference", dtype="float32"))
    assert compiled.unet_config == cfg

    rng = np.random.default_rng(1)
    b, hw = 2, 16
    sample_t = torch.from_numpy(rng.standard_normal((b, 4, hw, hw)).astype(np.float32))
    ehs_t = torch.from_numpy(
        rng.standard_normal((b, 7, cfg.cross_attention_dim)).astype(np.float32)
    )
    te_t = torch.from_numpy(rng.standard_normal((b, 16)).astype(np.float32))
    ti_t = torch.from_numpy(rng.standard_normal((b, 6)).astype(np.float32))

    out = compiled(
        sample_t, 500, ehs_t,
        added_cond_kwargs={"text_embeds": te_t, "time_ids": ti_t},
    )
    assert out.sample.shape == (b, 4, hw, hw)

    # native path on the same ingested params
    params = {k: jnp.asarray(v) for k, v in
              state_dict_to_params(fake, dtype=np.float32).items()}
    native = unet_apply(
        cfg, params,
        jnp.asarray(np.asarray(sample_t).transpose(0, 2, 3, 1)),
        jnp.full((b,), 500.0),
        jnp.asarray(np.asarray(ehs_t)),
        jnp.asarray(np.asarray(te_t)),
        jnp.asarray(np.asarray(ti_t)),
    )
    np.testing.assert_allclose(
        out.sample.numpy(),
        np.asarray(native).transpose(0, 3, 1, 2),
        atol=1e-4,
    )


def test_diffusers_wrapper_return_dict_false():
    from stabletriton_jax.frontends import diffusers as fe

    cfg = tiny_unet_config()
    compiled = fe.compile(FakeTorchUNet(cfg), CompileConfig(backend="reference", dtype="float32"))
    rng = np.random.default_rng(2)
    out = compiled(
        torch.from_numpy(rng.standard_normal((1, 4, 16, 16)).astype(np.float32)),
        torch.tensor([10.0]),
        torch.zeros(1, 7, cfg.cross_attention_dim),
        added_cond_kwargs={"text_embeds": torch.zeros(1, 16), "time_ids": torch.zeros(1, 6)},
        return_dict=False,
    )
    assert isinstance(out, tuple) and out[0].shape == (1, 4, 16, 16)


def test_diffusers_drop_in_deep_cache():
    """compile(unet, deep_cache=N) on the step-at-a-time surface: the first
    (full) step matches the exact wrapper; cached steps reuse the carried
    deep feature; a timestep jump back up resets (new generation)."""
    from stabletriton_jax.frontends import diffusers as fe

    cfg = tiny_unet_config()
    fake = FakeTorchUNet(cfg)
    ccfg = CompileConfig(backend="reference", dtype="float32",
                         donate_sample=False)
    exact = fe.compile(fake, ccfg)
    dc = fe.compile(fake, ccfg, deep_cache=2)
    rng = np.random.default_rng(3)
    kw = dict(
        added_cond_kwargs={"text_embeds": torch.zeros(1, 16),
                           "time_ids": torch.zeros(1, 6)},
    )

    def sample():
        return torch.from_numpy(
            rng.standard_normal((1, 4, 16, 16)).astype(np.float32))

    s0, s1 = sample(), sample()
    # step 0 (full) must equal the exact wrapper bit-for-bit
    a = dc(s0.clone(), 500, torch.zeros(1, 7, cfg.cross_attention_dim), **kw)
    e = exact(s0.clone(), 500, torch.zeros(1, 7, cfg.cross_attention_dim), **kw)
    np.testing.assert_allclose(a.sample.numpy(), e.sample.numpy(), atol=1e-5)
    # step 1 (shallow, stale cache) differs from the exact forward
    b = dc(s1.clone(), 400, torch.zeros(1, 7, cfg.cross_attention_dim), **kw)
    e1 = exact(s1.clone(), 400, torch.zeros(1, 7, cfg.cross_attention_dim), **kw)
    assert not np.allclose(b.sample.numpy(), e1.sample.numpy())
    assert np.isfinite(b.sample.numpy()).all()
    # timestep jumps back up -> new generation -> full step again
    c = dc(s0.clone(), 500, torch.zeros(1, 7, cfg.cross_attention_dim), **kw)
    np.testing.assert_allclose(c.sample.numpy(), e.sample.numpy(), atol=1e-5)


def test_diffusers_deep_cache_multi_call_per_step():
    """Frontends may run cond and uncond as SEPARATE UNet calls at the same
    timestep (ComfyUI's two-pass CFG): the step index must advance on
    timestep CHANGE, and each call position within a step must carry its own
    cache slot — never splicing one stream's cache into the other."""
    from stabletriton_jax.compile import compile_unet_deepcache
    from stabletriton_jax.frontends import diffusers as fe

    cfg = tiny_unet_config()
    fake = FakeTorchUNet(cfg)
    ccfg = CompileConfig(backend="reference", dtype="float32",
                         donate_sample=False)
    dc = fe.compile(fake, ccfg, deep_cache=2)
    full, shallow = compile_unet_deepcache(cfg, ccfg)
    import jax.numpy as jnp
    params = dc.params

    rng = np.random.default_rng(4)
    ctx = torch.zeros(1, 7, cfg.cross_attention_dim)
    kw = dict(added_cond_kwargs={"text_embeds": torch.zeros(1, 16),
                                 "time_ids": torch.zeros(1, 6)})

    def s():
        return torch.from_numpy(
            rng.standard_normal((1, 4, 16, 16)).astype(np.float32))

    def to_jax(x):
        return jnp.asarray(np.asarray(x).transpose(0, 2, 3, 1))

    zeros = (jnp.zeros((1, 7, cfg.cross_attention_dim)), jnp.zeros((1, 16)),
             jnp.zeros((1, 6)))
    # step 0 at t=500: two calls (streams A and B), both full
    a0, b0 = s(), s()
    dc(a0.clone(), 500, ctx, **kw)
    dc(b0.clone(), 500, ctx, **kw)
    _, cache_a = full(params, to_jax(a0), jnp.full((1,), 500.0), *zeros)
    _, cache_b = full(params, to_jax(b0), jnp.full((1,), 500.0), *zeros)
    # step 1 at t=400: two shallow calls, each must use ITS OWN stream's cache
    a1, b1 = s(), s()
    out_a = dc(a1.clone(), 400, ctx, **kw)
    out_b = dc(b1.clone(), 400, ctx, **kw)
    want_a = shallow(params, to_jax(a1), jnp.full((1,), 400.0), *zeros, cache_a)
    want_b = shallow(params, to_jax(b1), jnp.full((1,), 400.0), *zeros, cache_b)
    np.testing.assert_allclose(
        out_a.sample.numpy(),
        np.asarray(want_a).transpose(0, 3, 1, 2), atol=1e-5)
    np.testing.assert_allclose(
        out_b.sample.numpy(),
        np.asarray(want_b).transpose(0, 3, 1, 2), atol=1e-5)
    # a cross-wired implementation would have used cache_a for stream B
    wrong_b = shallow(params, to_jax(b1), jnp.full((1,), 400.0), *zeros, cache_a)
    assert not np.allclose(out_b.sample.numpy(),
                           np.asarray(wrong_b).transpose(0, 3, 1, 2))

    # invalid intervals are rejected up front, not at step 2
    import pytest as _pytest
    with _pytest.raises(ValueError, match="deep_cache"):
        fe.compile(fake, ccfg, deep_cache=0)


def test_comfyui_node_registry_importable():
    from stabletriton_jax.frontends import comfyui

    nodes, names = comfyui.register()
    assert "StableTritonCompile" in nodes
    assert "StableTritonTxt2Img" in nodes
    assert set(names) == set(nodes)
    # INPUT_TYPES contracts exist without comfy installed
    for cls in nodes.values():
        spec = cls.INPUT_TYPES()
        assert "required" in spec


def test_comfyui_shim_sgm_y_convention_matches_native():
    """Feed SGM-convention (x, t, context, y) through _ComfyUNetShim: y is the
    raw 2816-style adm vector concat(pooled, fourier(time_ids)) that ComfyUI's
    SDXL.encode_adm builds. Output must equal the native step that computes the
    fourier embedding itself from raw time_ids."""
    import jax.numpy as jnp

    from stabletriton_jax import ops
    from stabletriton_jax.frontends import diffusers as fe
    from stabletriton_jax.frontends.comfyui import _ComfyUNetShim
    from stabletriton_jax.io.torch_ingest import state_dict_to_params

    cfg = tiny_unet_config()
    fake = FakeTorchUNet(cfg)
    compiled = fe.compile(fake, CompileConfig(backend="reference", dtype="float32"))
    shim = _ComfyUNetShim(compiled)

    rng = np.random.default_rng(3)
    b, hw = 2, 16
    x = torch.from_numpy(rng.standard_normal((b, 4, hw, hw)).astype(np.float32))
    ctx = torch.from_numpy(
        rng.standard_normal((b, 7, cfg.cross_attention_dim)).astype(np.float32)
    )
    pooled = rng.standard_normal((b, 16)).astype(np.float32)
    time_ids = np.tile([32.0, 32.0, 0.0, 0.0, 32.0, 32.0], (b, 1)).astype(np.float32)

    # build y exactly as ComfyUI does: fourier-embed the flattened ids with the
    # [cos, sin] layout and concat after the pooled text embedding
    four = np.asarray(ops.time_embed(
        jnp.asarray(time_ids.reshape(-1)), dim=cfg.addition_time_embed_dim,
        flip_sin_to_cos=True, downscale_freq_shift=0.0,
    )).reshape(b, -1)
    y = torch.from_numpy(np.concatenate([pooled, four], axis=-1))
    assert y.shape[-1] == cfg.projection_class_embeddings_input_dim

    got = shim(x, timesteps=torch.tensor([500.0]), context=ctx, y=y)

    params = {k: jnp.asarray(v) for k, v in
              state_dict_to_params(fake, dtype=np.float32).items()}
    want = unet_apply(
        cfg, params,
        jnp.asarray(np.asarray(x).transpose(0, 2, 3, 1)),
        jnp.full((b,), 500.0),
        jnp.asarray(np.asarray(ctx)),
        jnp.asarray(pooled),
        jnp.asarray(time_ids),
    )
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want).transpose(0, 3, 1, 2), atol=1e-4
    )


def test_sgm_splice_refiner_y_convention():
    """frontends.sgm.splice on a mock sgm SamplingPipeline
    (pipeline.model.model.diffusion_model holds an SGM-keyed torch UNet):
    the spliced shim must equal the native step, driven through the
    refiner-style 5-slot y = concat(pooled, fourier(5 time_ids)) adm path
    (reference implementations/sgm_/example.py wanted this splice)."""
    import dataclasses
    import types

    import jax.numpy as jnp

    from stabletriton_jax import ops
    from stabletriton_jax.frontends import sgm as fe_sgm
    from stabletriton_jax.io.torch_ingest import state_dict_to_params
    from test_single_file import _RESNET_INV, _invert_unet_names

    cfg = dataclasses.replace(
        tiny_unet_config(),
        projection_class_embeddings_input_dim=8 * 5 + 16,  # 5-slot refiner adm
    )
    fake_hf = FakeTorchUNet(cfg)
    # rename the HF-keyed torch-layout state_dict to SGM keys (the inverse of
    # io.single_file.convert_sgm_unet, via the same tables)
    inv = _invert_unet_names(cfg)
    sgm_sd = {}
    for name, tensor in fake_hf.state_dict().items():
        mod, leaf = name.rsplit(".", 1)
        best = None
        for dpre, spre in inv.items():
            if (mod == dpre or mod.startswith(dpre + ".")) and (
                    best is None or len(dpre) > len(best[0])):
                best = (dpre, spre)
        assert best, name
        dpre, spre = best
        rest = mod[len(dpre):].lstrip(".")
        for dmod, smod in _RESNET_INV.items():
            if rest == dmod or rest.startswith(dmod + "."):
                rest = smod + rest[len(dmod):]
                break
        sgm_sd[f"{spre}.{rest}.{leaf}" if rest else f"{spre}.{leaf}"] = tensor

    class _FakeSGMUNet:
        def state_dict(self):
            return sgm_sd

    # sgm object shape: SamplingPipeline.model = DiffusionEngine,
    # DiffusionEngine.model = OpenAIWrapper(.diffusion_model)
    wrapper = types.SimpleNamespace(diffusion_model=_FakeSGMUNet())
    engine = types.SimpleNamespace(model=wrapper)
    pipeline = types.SimpleNamespace(model=engine)

    out_obj = fe_sgm.splice(
        pipeline, unet_config=cfg,
        compile_config=CompileConfig(backend="reference", dtype="float32"),
    )
    assert out_obj is pipeline
    shim = wrapper.diffusion_model
    assert isinstance(shim, fe_sgm.CompVisUNetShim)

    rng = np.random.default_rng(13)
    b, hw = 2, 16
    x = torch.from_numpy(rng.standard_normal((b, 4, hw, hw)).astype(np.float32))
    ctx = torch.from_numpy(
        rng.standard_normal((b, 7, cfg.cross_attention_dim)).astype(np.float32))
    pooled = rng.standard_normal((b, 16)).astype(np.float32)
    # refiner adm slots: orig_size (2) + crop (2) + aesthetic_score (1)
    time_ids = np.tile([32.0, 32.0, 0.0, 0.0, 6.0], (b, 1)).astype(np.float32)
    four = np.asarray(ops.time_embed(
        jnp.asarray(time_ids.reshape(-1)), dim=cfg.addition_time_embed_dim,
        flip_sin_to_cos=True, downscale_freq_shift=0.0,
    )).reshape(b, -1)
    y = torch.from_numpy(np.concatenate([pooled, four], axis=-1))
    assert y.shape[-1] == cfg.projection_class_embeddings_input_dim

    got = shim(x, timesteps=torch.tensor([500.0]), context=ctx, y=y)

    params = {k: jnp.asarray(v) for k, v in
              state_dict_to_params(fake_hf, dtype=np.float32).items()}
    want = unet_apply(
        cfg, params,
        jnp.asarray(np.asarray(x).transpose(0, 2, 3, 1)),
        jnp.full((b,), 500.0),
        jnp.asarray(np.asarray(ctx)),
        jnp.asarray(pooled),
        jnp.asarray(time_ids),
    )
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want).transpose(0, 3, 1, 2), atol=1e-4)


def test_sgm_splice_rejects_unrecognized_object():
    import pytest as _pytest

    from stabletriton_jax.frontends import sgm as fe_sgm

    with _pytest.raises(ValueError, match="diffusion_model"):
        fe_sgm.splice(object())
