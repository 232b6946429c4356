"""Single-file (SGM/A1111) checkpoint conversion tests.

Spot-checks literal name pairs against the well-known SGM<->diffusers
correspondence, then does a full synthetic round-trip: fabricate an SGM-named
state dict covering every expected parameter, convert, and validate against
the models' exact shape tables.
"""

import numpy as np
import pytest

from stabletriton_jax.io import single_file as sf
from stabletriton_jax.io.safetensors_io import validate_against_shapes
from stabletriton_jax.models.clip import clip_param_shapes, sdxl_text_encoder_2_config
from stabletriton_jax.models.unet import sdxl_base_unet_config, unet_param_shapes
from stabletriton_jax.models.vae import sdxl_vae_config, vae_decoder_param_shapes


def test_unet_literal_name_pairs():
    cfg = sdxl_base_unet_config()
    in_map, out_map = sf._unet_block_tables(cfg)
    # known correspondences from the standard SGM<->diffusers conversion
    assert in_map["input_blocks.1.0"] == "down_blocks.0.resnets.0"
    assert in_map["input_blocks.3.0.op"] == "down_blocks.0.downsamplers.0.conv"
    assert in_map["input_blocks.4.1"] == "down_blocks.1.attentions.0"
    assert in_map["input_blocks.8.0"] == "down_blocks.2.resnets.1"
    assert out_map["output_blocks.0.0"] == "up_blocks.0.resnets.0"
    assert out_map["output_blocks.2.2.conv"] == "up_blocks.0.upsamplers.0.conv"
    assert out_map["output_blocks.5.2.conv"] == "up_blocks.1.upsamplers.0.conv"
    assert out_map["output_blocks.8.0"] == "up_blocks.2.resnets.2"
    assert "output_blocks.8.1" not in out_map  # last level is conv-only


def _torch_layout(name, shape):
    """our (framework) shape -> torch-layout shape for fabrication."""
    if name.endswith(".weight") and len(shape) == 2:
        return (shape[1], shape[0])
    if len(shape) == 4:
        return (shape[3], shape[2], shape[0], shape[1])
    return shape


def _invert_unet_names(cfg):
    """diffusers module path -> sgm module path (via the same tables)."""
    in_map, out_map = sf._unet_block_tables(cfg)
    inv = {v: k for k, v in {**in_map, **out_map}.items()}
    inv.update({
        "time_embedding.linear_1": "time_embed.0",
        "time_embedding.linear_2": "time_embed.2",
        "add_embedding.linear_1": "label_emb.0.0",
        "add_embedding.linear_2": "label_emb.0.2",
        "conv_in": "input_blocks.0.0",
        "mid_block.resnets.0": "middle_block.0",
        "mid_block.attentions.0": "middle_block.1",
        "mid_block.resnets.1": "middle_block.2",
        "conv_norm_out": "out.0",
        "conv_out": "out.2",
    })
    return inv


_RESNET_INV = {v: k for k, v in sf._RESNET_INNER.items()}


def test_unet_full_synthetic_roundtrip():
    cfg = sdxl_base_unet_config()
    expected = unet_param_shapes(cfg)
    inv = _invert_unet_names(cfg)

    sgm_sd = {}
    for name, shape in expected.items():
        # split "module.leaf"
        mod, leaf = name.rsplit(".", 1)
        # find the longest diffusers prefix in inv
        best = None
        for dpre, spre in inv.items():
            if mod == dpre or mod.startswith(dpre + "."):
                if best is None or len(dpre) > len(best[0]):
                    best = (dpre, spre)
        assert best, name
        dpre, spre = best
        rest = mod[len(dpre):].lstrip(".")
        # resnet inner renames (diffusers -> sgm)
        for dmod, smod in _RESNET_INV.items():
            if rest == dmod or rest.startswith(dmod + "."):
                rest = smod + rest[len(dmod):]
                break
        sgm_name = f"{spre}.{rest}.{leaf}" if rest else f"{spre}.{leaf}"
        sgm_sd[sgm_name] = np.zeros(_torch_layout(name, shape), np.float32)

    converted = sf.convert_sgm_unet(sgm_sd, cfg)
    from stabletriton_jax.io.safetensors_io import convert_state_dict

    params = convert_state_dict(converted)
    validate_against_shapes(params, expected)


def test_vae_decoder_synthetic_roundtrip():
    vcfg = sdxl_vae_config()
    expected = vae_decoder_param_shapes(vcfg)

    sgm_sd = {}
    rev = list(reversed(vcfg.block_out_channels))  # execution order channels
    for name, shape in expected.items():
        t_shape = _torch_layout(name, shape)
        if name.startswith("post_quant_conv."):
            sgm_sd[name] = np.zeros(t_shape, np.float32)
            continue
        rest = name[len("decoder."):]
        mod, leaf = rest.rsplit(".", 1)
        if mod.startswith("conv_in") or mod.startswith("conv_out"):
            sgm_name = f"decoder.{mod}.{leaf}"
        elif mod == "conv_norm_out":
            sgm_name = f"decoder.norm_out.{leaf}"
        elif mod.startswith("mid_block.resnets."):
            j = int(mod.split(".")[2])
            inner = mod.split(".", 3)[3]
            inner = {"conv_shortcut": "nin_shortcut"}.get(inner, inner)
            sgm_name = f"decoder.mid.block_{j + 1}.{inner}.{leaf}"
        elif mod.startswith("mid_block.attentions.0."):
            inner = mod[len("mid_block.attentions.0."):]
            ren = {"to_q": "q", "to_k": "k", "to_v": "v",
                   "to_out.0": "proj_out", "group_norm": "norm"}[inner]
            if inner.startswith("to_") and leaf == "weight":
                # SGM stores these as 1x1 convs
                sgm_sd[f"decoder.mid.attn_1.{ren}.{leaf}"] = np.zeros(
                    (shape[1], shape[0], 1, 1), np.float32
                )
                continue
            sgm_name = f"decoder.mid.attn_1.{ren}.{leaf}"
        elif mod.startswith("up_blocks."):
            parts = mod.split(".")
            level = int(parts[1])
            sgm_level = len(rev) - 1 - level
            if parts[2] == "resnets":
                inner = ".".join(parts[4:])
                inner = {"conv_shortcut": "nin_shortcut"}.get(inner, inner)
                sgm_name = f"decoder.up.{sgm_level}.block.{parts[3]}.{inner}.{leaf}"
            else:  # upsamplers
                sgm_name = f"decoder.up.{sgm_level}.upsample.conv.{leaf}"
        else:
            raise AssertionError(name)
        sgm_sd[sgm_name] = np.zeros(t_shape, np.float32)

    converted = sf.convert_sgm_vae_decoder(sgm_sd)
    from stabletriton_jax.io.safetensors_io import convert_state_dict

    params = convert_state_dict(converted)
    validate_against_shapes(params, expected)


def test_openclip_conversion():
    cfg = sdxl_text_encoder_2_config()
    d = cfg.hidden_size
    sd = {
        "token_embedding.weight": np.zeros((cfg.vocab_size, d), np.float32),
        "positional_embedding": np.zeros((cfg.max_position_embeddings, d), np.float32),
        "ln_final.weight": np.zeros((d,), np.float32),
        "ln_final.bias": np.zeros((d,), np.float32),
        "text_projection": np.zeros((d, cfg.projection_dim), np.float32),
    }
    for i in range(cfg.num_layers):
        pre = f"transformer.resblocks.{i}"
        sd[f"{pre}.ln_1.weight"] = np.zeros((d,), np.float32)
        sd[f"{pre}.ln_1.bias"] = np.zeros((d,), np.float32)
        sd[f"{pre}.ln_2.weight"] = np.zeros((d,), np.float32)
        sd[f"{pre}.ln_2.bias"] = np.zeros((d,), np.float32)
        sd[f"{pre}.attn.in_proj_weight"] = np.zeros((3 * d, d), np.float32)
        sd[f"{pre}.attn.in_proj_bias"] = np.zeros((3 * d,), np.float32)
        sd[f"{pre}.attn.out_proj.weight"] = np.zeros((d, d), np.float32)
        sd[f"{pre}.attn.out_proj.bias"] = np.zeros((d,), np.float32)
        sd[f"{pre}.mlp.c_fc.weight"] = np.zeros((cfg.intermediate_size, d), np.float32)
        sd[f"{pre}.mlp.c_fc.bias"] = np.zeros((cfg.intermediate_size,), np.float32)
        sd[f"{pre}.mlp.c_proj.weight"] = np.zeros((d, cfg.intermediate_size), np.float32)
        sd[f"{pre}.mlp.c_proj.bias"] = np.zeros((d,), np.float32)

    converted = sf.convert_openclip_text(sd)
    from stabletriton_jax.io.safetensors_io import convert_state_dict

    params = convert_state_dict(converted)
    # resolve the pretransposed marker like load_single_file does
    params = {
        (k[: -len("@pretransposed")] if k.endswith("@pretransposed") else k): (
            converted[k] if k.endswith("@pretransposed") else v
        )
        for k, v in params.items()
    }
    validate_against_shapes(params, clip_param_shapes(cfg))


def test_openclip_qkv_split_values():
    """in_proj rows must land in q/k/v in order."""
    d = 4
    w = np.arange(3 * d * d, dtype=np.float32).reshape(3 * d, d)
    out = sf.convert_openclip_text({"transformer.resblocks.0.attn.in_proj_weight": w})
    np.testing.assert_array_equal(
        out["text_model.encoder.layers.0.self_attn.q_proj.weight"], w[:d]
    )
    np.testing.assert_array_equal(
        out["text_model.encoder.layers.0.self_attn.v_proj.weight"], w[2 * d:]
    )


def test_detect_family():
    assert sf.detect_family(["conditioner.embedders.1.model.ln_final.weight",
                             "model.diffusion_model.out.0.weight"]) == "sdxl"
    assert sf.detect_family(["cond_stage_model.model.ln_final.weight"]) == "sd2"
    assert sf.detect_family(["cond_stage_model.transformer.text_model.x"]) == "sd1"


def test_sd15_unet_synthetic_single_file_roundtrip():
    """SGM-named SD1.5 UNet tensors convert to the exact SD1.5 shape table."""
    from stabletriton_jax.models.unet import sd15_unet_config

    cfg = sd15_unet_config()
    expected = unet_param_shapes(cfg)
    inv = _invert_unet_names(cfg)
    sgm_sd = {}
    for name, shape in expected.items():
        mod, leaf = name.rsplit(".", 1)
        best = None
        for dpre, spre in inv.items():
            if mod == dpre or mod.startswith(dpre + "."):
                if best is None or len(dpre) > len(best[0]):
                    best = (dpre, spre)
        assert best, name
        dpre, spre = best
        rest = mod[len(dpre):].lstrip(".")
        for dmod, smod in _RESNET_INV.items():
            if rest == dmod or rest.startswith(dmod + "."):
                rest = smod + rest[len(dmod):]
                break
        sgm_name = f"{spre}.{rest}.{leaf}" if rest else f"{spre}.{leaf}"
        sgm_sd[sgm_name] = np.zeros(_torch_layout(name, shape), np.float32)

    converted = sf.convert_sgm_unet(sgm_sd, cfg)
    from stabletriton_jax.io.safetensors_io import convert_state_dict

    validate_against_shapes(convert_state_dict(converted), expected)
